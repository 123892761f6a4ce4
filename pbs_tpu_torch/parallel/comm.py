"""Collectives with their transposes: the port's ``jax.lax.{psum,
ppermute, all_to_all}``.

Port-only. The reference's manual regions (``shard_map``) call
``lax.psum``, ``lax.ppermute`` and ``lax.all_to_all`` and let autodiff
transpose them; its annotated regions let XLA insert the same exchanges.
Here each exchange is a ``torch.autograd.Function`` over one process
group whose backward is the exchange's transpose:

- :func:`psum` (sum onto every member) transposes to itself;
- :func:`all_gather` transposes to :func:`reduce_scatter`, and back;
- :func:`shard` (this member's block of a tensor every member holds)
  transposes to zero-padding: no exchange;
- :func:`ppermute` transposes to the reverse permutation;
- :func:`all_to_all` transposes to the inverse all-to-all;
- :func:`send` and :func:`recv` (a pipeline stage's hand-off) send the
  cotangent back to the stage it came from.

That is the convention of ``shard_map`` without replication checks:
every rank's graph is its own piece of one global graph, so a value
that n ranks compute alike carries 1/n of its cotangent on each. The
trainers in ``parallel/`` divide a loss by the number of ranks that
compute it alike and sum each parameter's gradient over every mesh axis
that does not shard it (:func:`pbs_tpu_torch.parallel.sharding.reduce_grads`).

Transport. NCCL carries CUDA tensors; gloo carries CPU tensors. A gloo
group given CUDA tensors (two rank processes sharing one card, where
NCCL refuses two ranks on one device) has every exchange staged through
pinned host memory: the caller chose that by picking ``backend="gloo"``
for CUDA tensors. Each staged send and receive uses a pinned buffer kept
per (slot, shape, dtype) across steps; :func:`release` frees them. An NCCL failure raises; nothing falls back to the
host. A group of one member exchanges nothing.

:func:`stats` counts the exchanges, the bytes staged through the host
(both directions) and the host seconds spent inside exchanges: a staged
exchange first waits for the card's queued work, so its seconds are its
own copies and transport, not the kernels before it.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_STATS = {"exchanges": 0, "staged_bytes": 0, "seconds": 0.0}
_PINNED: dict = {}


def stats() -> dict:
    """{"exchanges", "staged_bytes", "seconds"} since the last
    :func:`reset_stats`."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(exchanges=0, staged_bytes=0, seconds=0.0)


@contextlib.contextmanager
def _timed(t: torch.Tensor, group):
    if _stages(t, group):
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STATS["seconds"] += time.perf_counter() - t0
        _STATS["exchanges"] += 1


def group_size(group) -> int:
    """Members of ``group``; None is a group of one (the axes of a
    world-free one-rank mesh, :func:`pbs_tpu_torch.parallel.mesh.one_rank_mesh`)."""
    return 1 if group is None else dist.get_world_size(group)


def group_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _stages(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype: torch.dtype, slot: str) -> torch.Tensor:
    """The pinned host buffer of (slot, shape, dtype): every staged send
    and receive goes through one, allocated once and reused by later
    steps until :func:`release`."""
    key = (slot, tuple(shape), dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(tuple(shape), dtype=dtype,
                                         pin_memory=True)
    return buf


def _host(t: torch.Tensor, slot: str) -> torch.Tensor:
    """``t`` copied into its slot's pinned buffer."""
    buf = _pinned(t.shape, t.dtype, slot)
    buf.copy_(t)
    _STATS["staged_bytes"] += t.numel() * t.element_size()
    return buf


def release() -> None:
    """Drop the pinned staging buffers and hand their pages back (a rank
    calls it between schedules, whose shapes differ)."""
    _PINNED.clear()
    if torch.cuda.is_available():
        # the caching host allocator keeps freed pinned blocks otherwise
        empty = getattr(torch._C, "_host_emptyCache", None)
        if empty is not None:
            empty()


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    _STATS["staged_bytes"] += h.numel() * h.element_size()
    return h.to(like.device)


def _global(group, index: int) -> int:
    return dist.get_global_rank(group, index)


# -- the exchanges, outside autograd ------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (returned)."""
    if group_size(group) == 1:
        return t
    with _timed(t, group):
        return _all_reduce(t, group, op)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if _stages(t, group):
        h = _host(t, "ar")
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        _STATS["staged_bytes"] += h.numel() * h.element_size()
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    with _timed(x, group):
        return _gather(x, group, dim, n)


def _gather(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    src = x.contiguous()
    if _stages(src, group):
        h = _host(src, "ag")
        out = _pinned((n, *h.shape), h.dtype, "ag-out")
        dist.all_gather(list(out.unbind(0)), h, group=group)
        return torch.cat(_back(out, x).unbind(0), dim=dim)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"not divisible by the group's {n} members")
    with _timed(x, group):
        return _scatter(x, group, dim, n)


def _scatter(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    shape = (src.shape[0] // n, *src.shape[1:])
    # reduce_scatter_tensor's newer name, where the installed torch has it
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    if _stages(src, group):
        out = _pinned(shape, src.dtype, "rs-out")
        scatter(out, _host(src, "rs"), group=group)
        return _back(out, x).movedim(0, dim).contiguous()
    out = torch.empty(shape, dtype=src.dtype, device=src.device)
    scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: split ``split_dim`` into n
    blocks, block j to member j, received blocks concatenated along
    ``concat_dim`` in member order."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"not divisible by the group's {n} members")
    with _timed(x, group):
        return _exchange(x, group, split_dim, concat_dim, n)


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int,
              n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[split_dim:split_dim + 1] = [n, shape[split_dim] // n]
    src = x.reshape(shape).movedim(split_dim, 0).contiguous()
    if _stages(src, group):
        h = _host(src, "a2a")
        got = _pinned(h.shape, h.dtype, "a2a-out")
        dist.all_to_all_single(got, h, group=group)
        got = _back(got, x)
    else:
        got = torch.empty_like(src)
        dist.all_to_all_single(got, src, group=group)
    # got[j] is member j's block: concatenate along concat_dim.
    got = got.movedim(0, concat_dim)
    shape = list(got.shape)
    shape[concat_dim:concat_dim + 2] = [n * shape[concat_dim + 1]]
    return got.reshape(shape).contiguous()


def _p2p(ops: list) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _ppermute(x: torch.Tensor, group, pairs) -> torch.Tensor:
    """``lax.ppermute``: member s sends to d for each (s, d) in
    ``pairs``; a member that receives nothing gets zeros."""
    n = group_size(group)
    me = group_index(group)
    if n == 1:
        return x if (0, 0) in pairs else torch.zeros_like(x)
    with _timed(x, group):
        return _permute(x, group, pairs, me)


def _permute(x: torch.Tensor, group, pairs, me: int) -> torch.Tensor:
    dsts = [d for s, d in pairs if s == me]
    srcs = [s for s, d in pairs if d == me]
    src = x.contiguous()
    staged = _stages(src, group)
    if staged:
        send = _host(src, "pp-send") if dsts else None
        out = _pinned(src.shape, src.dtype, "pp-recv") if srcs else None
    else:
        send, out = src, torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, send, _global(group, d), group)
           for d in dsts]
    ops += [dist.P2POp(dist.irecv, out, _global(group, s), group)
            for s in srcs]
    _p2p(ops)
    if not srcs:
        return torch.zeros_like(x)
    return _back(out, x) if staged else out


def _send(x: torch.Tensor, group, dst: int, tag: int) -> None:
    src = x.contiguous()
    with _timed(src, group):
        if _stages(src, group):
            src = _host(src, "send")
        _p2p([dist.P2POp(dist.isend, src, _global(group, dst), group, tag)])


def _recv(shape, dtype, device, group, src: int, tag: int) -> torch.Tensor:
    like = torch.empty(shape, dtype=dtype, device=device)
    with _timed(like, group):
        if _stages(like, group):
            h = _pinned(shape, dtype, "recv")
            _p2p([dist.P2POp(dist.irecv, h, _global(group, src), group,
                             tag)])
            return _back(h, like)
        _p2p([dist.P2POp(dist.irecv, like, _global(group, src), group,
                         tag)])
        return like


# -- the autograd functions ---------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, me = group_size(group), group_index(group)
        ctx.dim, ctx.n, ctx.me, ctx.full = dim, n, me, x.shape[dim]
        return x.chunk(n, dim=dim)[me].contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.full
        out = g.new_zeros(shape)
        out.narrow(ctx.dim, ctx.me * g.shape[ctx.dim],
                   g.shape[ctx.dim]).copy_(g)
        return out, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _ppermute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.pairs)
        return _ppermute(g, ctx.group, back), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split, ctx.concat = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat, ctx.split),
                None, None, None)


class _Send(torch.autograd.Function):
    """Forward: send ``x`` to member ``dst``; returns a zero scalar the
    caller adds to its loss so the backward reaches this node. Backward:
    receive ``x``'s cotangent from ``dst``."""

    @staticmethod
    def forward(ctx, x, group, dst, tag):
        ctx.group, ctx.dst, ctx.tag = group, dst, tag
        ctx.meta = (x.shape, x.dtype, x.device)
        _send(x, group, dst, tag)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device = ctx.meta
        g = _recv(shape, dtype, device, ctx.group, ctx.dst, ctx.tag)
        return g, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor from member ``src`` (``anchor`` is a
    scalar that requires grad, so the backward reaches this node).
    Backward: send the cotangent back to ``src``."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, group, src, tag):
        ctx.group, ctx.src, ctx.tag = group, src, tag
        return _recv(shape, dtype, anchor.device, group, src, tag)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.group, ctx.src, ctx.tag)
        return None, None, None, None, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum over ``group`` on every member."""
    return x if group_size(group) == 1 else _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' blocks concatenated along ``dim`` on every member."""
    return x if group_size(group) == 1 else _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This member's block along ``dim`` of the sum over ``group``."""
    if group_size(group) == 1:
        return x
    return _ReduceScatter.apply(x, group, dim)


def shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This member's block along ``dim`` of ``x``, which every member
    holds (no exchange)."""
    return x if group_size(group) == 1 else _Shard.apply(x, group, dim)


def ppermute(x: torch.Tensor, group, pairs) -> torch.Tensor:
    """``lax.ppermute`` over ``group`` with (source, destination) member
    pairs; a member no pair sends to receives zeros."""
    return _Ppermute.apply(x, group, tuple(pairs))


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def send(x: torch.Tensor, group, dst: int, tag: int = 0) -> torch.Tensor:
    """Send ``x`` to member ``dst`` of ``group``; add the returned zero
    scalar to the loss so the backward receives ``x``'s cotangent."""
    return _Send.apply(x, group, dst, tag)


def recv(anchor: torch.Tensor, shape, dtype, group, src: int,
         tag: int = 0) -> torch.Tensor:
    """Receive a ``shape``/``dtype`` tensor from member ``src`` onto
    ``anchor``'s device; its cotangent goes back to ``src``. ``anchor``
    is a scalar that requires grad; ask for its gradient too, or the
    backward never reaches this node."""
    return _Recv.apply(anchor, tuple(shape), dtype, group, src, tag)
