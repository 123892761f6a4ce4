"""Rank-side bodies of the parallel twins, and the port-only parts of
``pbs_tpu_torch.parallel`` that need no reference: the collectives'
transposes, the rank pool, the mesh's guards.

The ``rank_*`` functions run inside the rank processes of a
:class:`pbs_tpu_torch.parallel.launch.RankPool` (``pool.run(
"test_torch_parallel_ranks:rank_train", ...)``), so this module imports
torch and the port only — never JAX — and the twins that compare with
the reference (``tests/test_torch_parallel_*.py``) import it. Every rank
runs the same body on its own shard; rank 0 gathers the global arrays
and returns them as numpy, the other ranks return None. All fp32.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pbs_tpu_torch.parallel import comm
from pbs_tpu_torch.parallel.launch import RankPool
from pbs_tpu_torch.parallel.mesh import PartitionSpec as P, shard_array

TESTS = str(Path(__file__).resolve().parent)


def rank_pool(n: int = 4) -> RankPool:
    """n CPU rank processes over gloo that can import this module."""
    return RankPool(n, backend="gloo", device="cpu",
                    env={"PYTHONPATH": TESTS})


def _mesh(axes, kind: str = "make"):
    if kind == "hybrid":
        from pbs_tpu_torch.parallel.multihost import hybrid_mesh

        ici, dcn = axes
        return hybrid_mesh(ici, dcn, device="cpu")
    from pbs_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


def _gather_spec(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    from pbs_tpu_torch.parallel.sharding import gather_tree

    return gather_tree({"x": t.detach()}, mesh, {"x": spec})["x"]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _rank0(value):
    return value if dist.get_rank() == 0 else None


# -- rank bodies -----------------------------------------------------------


def rank_attention(kind: str, axes: dict, q, k, v, w, block_impl: str,
                   causal: bool = True):
    """``ring_attention`` or ``ulysses_attention`` on this rank's chunk
    of the global q/k/v (sequence over sp, batch over dp); returns the
    global output and the gradients of sum(out * w) for q, k, v."""
    from pbs_tpu_torch.parallel import ring_attention, ulysses_attention

    mesh = _mesh(axes)
    spec = P("dp", "sp", None, None)
    from pbs_tpu_torch.parallel.sharding import _mesh_spec

    spec = _mesh_spec(mesh, spec)
    qs, ks, vs = (shard_array(t, mesh, spec).requires_grad_()
                  for t in (q, k, v))
    fn = ring_attention if kind == "ring" else ulysses_attention
    out = fn(qs, ks, vs, mesh, causal=causal, block_impl=block_impl)
    (out * shard_array(w, mesh, spec)).sum().backward()
    got = [_gather_spec(t, mesh, spec).numpy()
           for t in (out, qs.grad, ks.grad, vs.grad)]
    return _rank0(got)


def _cfg(family: str, cfg_kw: dict):
    if family in ("moe", "pipe_moe"):
        from pbs_tpu_torch.models.moe import MoEConfig

        return MoEConfig(**cfg_kw, dtype=torch.float32)
    from pbs_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**cfg_kw, dtype=torch.float32)


def _trainer(family, cfg, mesh, params, lr, n_micro):
    from pbs_tpu_torch import parallel
    from pbs_tpu_torch.parallel import pipeline

    if family == "dense":
        state, step = parallel.make_sharded_train(cfg, mesh, lr,
                                                  params=params)
        return state, step, parallel.batch_sharding(mesh)
    if family == "moe":
        state, step = parallel.make_sharded_moe_train(cfg, mesh, lr,
                                                      params=params)
        return state, step, parallel.moe_batch_sharding(mesh)
    make = (pipeline.make_pipelined_moe_train if family == "pipe_moe"
            else pipeline.make_pipelined_train)
    state, step = make(cfg, mesh, n_micro=n_micro, learning_rate=lr,
                       params=params)
    return state, step, pipeline.pipeline_batch_sharding(mesh)


def rank_train(family: str, cfg_kw: dict, axes, tokens, params_np,
               steps: int, lr: float, n_micro: int = 2,
               mesh_kind: str = "make", grads: bool = False):
    """``steps`` train steps of ``family`` ("dense", "moe", "pipe",
    "pipe_moe") from the full ``params_np`` tree on this rank's block of
    ``tokens``. Returns the metrics of every step, the global params
    after the first and (``grads``) the summed gradients of the first."""
    from pbs_tpu_torch.models.transformer import params_from_numpy
    from pbs_tpu_torch.parallel.sharding import gather_tree

    cfg = _cfg(family, cfg_kw)
    mesh = _mesh(axes, mesh_kind)
    params = params_from_numpy(params_np, device="cpu")
    state, step, sharding = _trainer(family, cfg, mesh, params, lr, n_micro)
    trainer = step.__self__
    block = sharding.shard(tokens)
    out = {"axis_names": mesh.axis_names}
    if grads:
        _, g = trainer.loss_and_grads(state[0], block)
        out["grads"] = _np_tree(gather_tree(g, mesh, trainer.specs))
    metrics = []
    for i in range(steps):
        state, m = step(state, block)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["params1"] = _np_tree(gather_tree(state[0], mesh,
                                                  trainer.specs))
    out["metrics"] = metrics
    return _rank0(out)


def rank_loss(family: str, cfg_kw: dict, axes, tokens, params_np,
              n_micro: int = 2):
    """The pipelined loss (``make_pipelined_loss``) on this rank's block:
    every rank returns the global loss."""
    from pbs_tpu_torch.models.transformer import params_from_numpy
    from pbs_tpu_torch.parallel import pipeline

    cfg = _cfg(family, cfg_kw)
    mesh = _mesh(axes)
    params = pipeline.shard_pipeline_params(
        params_from_numpy(params_np, device="cpu"), mesh, cfg)
    loss = pipeline.make_pipelined_loss(cfg, mesh, n_micro)
    block = pipeline.pipeline_batch_sharding(mesh).shard(tokens)
    return float(loss(params, block))


def rank_error(what: str, axes, cfg_kw: dict | None = None, **kw):
    """Run one guarded call on this rank; returns (exception type name,
    message), or None when nothing was raised."""
    from pbs_tpu_torch import parallel
    from pbs_tpu_torch.models.transformer import causal_attention
    from pbs_tpu_torch.parallel import pipeline

    mesh = _mesh(axes) if axes is not None else None
    family = kw.pop("family", "dense")
    cfg = _cfg(family, cfg_kw) if cfg_kw is not None else None
    try:
        if what == "make_sharded_train":
            parallel.make_sharded_train(cfg, mesh)
        elif what == "make_sharded_moe_train":
            parallel.make_sharded_moe_train(cfg, mesh)
        elif what == "pipe_blocks":
            pipeline._pipe_blocks(cfg, mesh, kw["n_micro"])
        elif what == "moe_pipe_blocks":
            pipeline._moe_pipe_blocks(cfg, mesh, kw["n_micro"])
        elif what == "pipelined_loss":
            from pbs_tpu_torch.models.transformer import params_from_numpy

            params = pipeline.shard_pipeline_params(
                params_from_numpy(kw["params_np"], device="cpu"), mesh, cfg)
            loss = pipeline.make_pipelined_loss(cfg, mesh, kw["n_micro"])
            loss(params, pipeline.pipeline_batch_sharding(mesh).shard(
                kw["tokens"]))
        elif what in ("ring_attention", "ulysses_attention"):
            q = torch.zeros(kw["q_shape"])
            kv = torch.zeros(kw["kv_shape"])
            getattr(parallel, what)(q, kv, kv, mesh, **kw.get("opts", {}))
        elif what == "causal_attention":
            q = torch.zeros(kw["q_shape"])
            kv = torch.zeros(kw["kv_shape"])
            causal_attention(q, kv, kv, cfg)
        elif what == "make_mesh":
            parallel.make_mesh(kw["mesh_axes"], device="cpu")
        else:
            raise KeyError(what)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


_COLLECTIVES = ("psum", "all_gather", "reduce_scatter", "shard",
                "ppermute", "all_to_all", "send_recv")


def _apply(name: str, x: torch.Tensor, group, anchor):
    n, me = comm.group_size(group), comm.group_index(group)
    if name == "psum":
        return comm.psum(x, group), None
    if name == "all_gather":
        return comm.all_gather(x, group, 1), None
    if name == "reduce_scatter":
        return comm.reduce_scatter(x, group, 1), None
    if name == "shard":
        return comm.shard(x, group, 1), None
    if name == "ppermute":  # a non-cyclic shift: the last sends nowhere
        return comm.ppermute(x, group, [(i, i + 1) for i in range(n - 1)]), None
    if name == "all_to_all":
        return comm.all_to_all(x, group, 1, 0), None
    # send_recv: each rank hands x to the next; the first receives nothing.
    dummy = (comm.send(x, group, me + 1) if me + 1 < n
             else x.new_zeros(()))
    y = (comm.recv(anchor, x.shape, x.dtype, group, me - 1) if me > 0
         else torch.zeros_like(x))
    return y, dummy


def rank_transposes(seed: int):
    """For each collective A over the world: this rank's share of
    <A x, y> and of <x, A^T y>, A^T applied by autograd. Their sums
    over the ranks agree exactly when the backward is A's transpose."""
    group = dist.group.WORLD
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(seed * 100 + rank)
    out = {}
    for name in _COLLECTIVES:
        x = torch.randn((4, 8, 3), generator=gen, dtype=torch.float64)
        x.requires_grad_()
        anchor = torch.zeros((), dtype=torch.float64, requires_grad=True)
        y, dummy = _apply(name, x, group, anchor)
        ct = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        f = (y * ct).sum()
        if dummy is not None:
            f = f + dummy
        (gx, _) = torch.autograd.grad(f, [x, anchor], allow_unused=True)
        gx = torch.zeros_like(x) if gx is None else gx
        out[name] = (float((y * ct).sum()), float((x * gx).sum()))
    return out


def rank_roundtrip(axes, tree_np, specs):
    """shard_tree then gather_tree of a full tree: the tree back."""
    from pbs_tpu_torch.parallel.sharding import gather_tree, shard_tree

    mesh = _mesh(axes)
    tree = {k: torch.from_numpy(v) for k, v in tree_np.items()}
    local = shard_tree(tree, mesh, specs)
    shapes = {k: tuple(v.shape) for k, v in local.items()}
    return shapes, _np_tree(gather_tree(local, mesh, specs))


def rank_hybrid(ici: dict, dcn: dict, local_world: int):
    """``hybrid_mesh`` with LOCAL_WORLD_SIZE set: its axis names, this
    rank's coordinates, or the error."""
    from pbs_tpu_torch.parallel.multihost import dp_over_dcn, hybrid_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    try:
        mesh = hybrid_mesh(ici, dcn, device="cpu")
        std = dp_over_dcn(tp=2, device="cpu")
    except ValueError as e:
        return "ValueError", str(e)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return (mesh.axis_names, {a: mesh.index(a) for a in mesh.axis_names},
            std.axis_names, std.shape)


def rank_params_roundtrip(axes: dict, cfg_kw: dict):
    """``shard_params`` then ``gather_params`` of a full tree: the tree
    back on every rank, and this rank's wq shard shape."""
    from pbs_tpu_torch.models.transformer import init_params
    from pbs_tpu_torch.parallel import gather_params, shard_params

    mesh = _mesh(axes)
    cfg = _cfg("dense", cfg_kw)
    full = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    local = shard_params(full, mesh, cfg)
    back = gather_params(local, mesh, cfg)
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(back), _leaves(full)))
    return same, tuple(local["layers"]["wq"].shape)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def rank_raise():
    raise ValueError(f"rank {dist.get_rank()} refuses")


def rank_raise_in_an_exchange():
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails before the exchange")
    comm.all_reduce_(torch.ones(1), dist.group.WORLD)


def rank_hang():
    import time

    time.sleep(600)


# -- tests that need no reference -----------------------------------------


@pytest.fixture(scope="module")
def pool():
    p = rank_pool(4)
    yield p
    p.close()


def test_every_collective_backward_is_its_transpose(pool):
    """<A x, y> == <x, A^T y> summed over the ranks, for psum, all-gather,
    reduce-scatter, shard, a non-cyclic ppermute, all-to-all and a
    pipeline hand-off (fp64): no factor of the group size anywhere."""
    for seed in (0, 1):
        shares = pool.run("test_torch_parallel_ranks:rank_transposes", seed)
        for name in _COLLECTIVES:
            lhs = sum(s[name][0] for s in shares)
            rhs = sum(s[name][1] for s in shares)
            assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12), name


def test_shard_and_gather_round_trip(pool):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 6)).astype(np.float32),
            "b": rng.normal(size=(4, 4, 8)).astype(np.float32),
            "c": rng.normal(size=(6,)).astype(np.float32)}
    specs = {"a": P("tp", None), "b": P(None, "dp", "tp"),
             "c": P(None)}
    shapes, back = pool.run("test_torch_parallel_ranks:rank_roundtrip",
                            {"dp": 2, "tp": 2}, tree, specs)[0]
    assert shapes == {"a": (4, 6), "b": (4, 2, 4), "c": (6,)}
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])


def test_shard_params_and_gather_params_round_trip(pool):
    cfg_kw = dict(vocab=128, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=128, max_seq=64)
    got = pool.run("test_torch_parallel_ranks:rank_params_roundtrip",
                   {"dp": 2, "tp": 2}, cfg_kw)
    assert got == [(True, (2, 64, 32))] * 4


def test_make_mesh_guards(pool):
    def err(axes):
        return pool.run("test_torch_parallel_ranks:rank_error",
                        "make_mesh", None, mesh_axes=axes)[0]

    assert err({"dp": -1, "tp": -1}) == (
        "ValueError", "at most one axis size may be -1")
    assert err({"dp": 3, "tp": -1}) == (
        "ValueError", "4 devices not divisible by 3")
    assert err({"dp": 2, "tp": 4}) == (
        "ValueError", "mesh {'dp': 2, 'tp': 4} needs 8 devices, have 4")
    assert err({"dp": -1, "sp": 2}) is None


def test_hybrid_mesh_keeps_intra_host_axes_on_one_host(pool):
    """Ranks are host-major (rank // LOCAL_WORLD_SIZE): two hosts of two
    ranks hold an sp2 granule each under dp2, laid out dcn-first; a
    granule that would span hosts is refused."""
    got = pool.run("test_torch_parallel_ranks:rank_hybrid", {"sp": 2},
                   {"dp": 2}, 2)
    assert [g[1] for g in got] == [{"dp": r // 2, "sp": r % 2}
                                   for r in range(4)]
    assert got[0][0] == ("dp", "sp")
    assert got[0][2:] == (("dp", "tp"), {"dp": 2, "tp": 2})
    err = pool.run("test_torch_parallel_ranks:rank_hybrid", {"sp": 4},
                   {"dp": 1}, 2)[0]
    assert err[0] == "ValueError" and "span hosts [0, 1]" in err[1]


def test_rank_pool_reports_failures_and_kills_a_hung_rank():
    with rank_pool(2) as p:
        with pytest.raises(RuntimeError, match="rank 1 refuses"):
            p.run("test_torch_parallel_ranks:rank_raise")
        # The pool survives a raising task.
        assert p.run("pbs_tpu_torch.parallel.launch:_ready") == [0, 1]
        with pytest.raises(TimeoutError, match="no answer"):
            p.run("test_torch_parallel_ranks:rank_hang", timeout_s=2)
        assert p._procs == []
    with rank_pool(2) as p:  # a failure reported while a peer waits on it
        with pytest.raises(RuntimeError, match="rank 1 fails before"):
            p.run("test_torch_parallel_ranks:rank_raise_in_an_exchange",
                  timeout_s=120)
        assert p._procs == []


def test_rank_pool_listener_has_room_for_every_rank(tmp_path):
    """Every rank connects at once, before the pool's thread accepts
    any: with a timeout on the socket (as the ranks' sockets have once
    torch.distributed is up) a connect that finds the backlog full fails
    at once with EAGAIN, so the backlog holds the whole world (8 ranks
    on the card host lost two this way with the default backlog)."""
    import socket

    from pbs_tpu_torch.parallel.launch import listen

    address = str(tmp_path / "pool.sock")
    listener = listen(address, b"key", 8)
    socks = []
    try:
        for _ in range(8):
            s = socket.socket(socket.AF_UNIX)
            s.settimeout(2.0)
            s.connect(address)
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        listener.close()
    assert len(socks) == 8


def test_rank_bodies_import_no_reference():
    import subprocess
    import sys

    code = ("import sys, test_torch_parallel_ranks\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pbs_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [TESTS, str(Path(TESTS).parent)]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
