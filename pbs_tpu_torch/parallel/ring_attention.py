"""Ring attention: sequence-parallel exact attention over a mesh axis.

The port of ``pbs_tpu.parallel.ring_attention``. The sequence is
sharded across a mesh axis; each rank holds its q/k/v chunk; k/v chunks
rotate around the ring (:func:`pbs_tpu_torch.parallel.comm.ppermute`)
while every rank folds each visiting chunk into its local online-softmax
state (running max / normalizer / accumulator — the flash kernel's
recurrence, lifted one level to the ring). After ``ring_size`` chunks
every q has attended to every k exactly once. Communication is
neighbor-only.

Causality across chunks: a visiting chunk is fully visible (source
index < mine), fully masked (source > mine), or diagonal (source ==
mine, intra-chunk causal mask). The dense body masks it arithmetically,
as the reference does; the flash body, where the reference picks
between its blocks with ``lax.cond``, takes the branch in Python, so a
fully masked block launches nothing.

SPMD by rank: :func:`ring_attention` takes and returns this rank's
chunk (B, S/n, H, hd); the reference's takes the global arrays and maps
its per-device body with ``shard_map``. k and v rotate as one stacked
tensor, one exchange a step, and the last step's rotation (whose result
the reference's scan discards) is not sent.

Gang-scheduling note (SURVEY.md §7): one ring step stalls if any member
is preempted — ring jobs must be gang-dispatched; the scheduler treats
multi-context ring jobs as gangs and the GangMonitor converts ring skew
into the contention hint.
"""

from __future__ import annotations

import functools
import math

import torch

from pbs_tpu_torch.parallel import comm

NEG_INF = -1e30


def _repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def _local_block(q, k, v, sm_scale, mask):
    """One chunk-vs-chunk attention block. q:(B,Sq,H,hd) k,v:(B,Sk,Hkv,hd).
    mask: (Sq, Sk) bool or None. Returns (m, l, acc) contributions."""
    group = q.shape[2] // k.shape[2]
    kr = _repeat_kv(k, group)  # (B, Sk, H, hd)
    vr = _repeat_kv(v, group)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * sm_scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)  # (B,H,Sq,1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vr.float())
    return m, l, acc


def _ring_steps(k, v, group, n):
    """Yield (k_cur, v_cur, step) for the n ring steps, rotating the
    stacked k/v one rank down the ring between steps."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = torch.stack([k, v])
    for t in range(n):
        yield kv[0], kv[1], t
        if t + 1 < n:
            kv = comm.ppermute(kv, group, perm)


def _tie(o: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """``o`` with a zero-valued dependence on ``kv``: a rank whose last
    visiting chunk was fully masked still runs every rotation's
    backward, which its ring neighbours wait on."""
    return o + kv.float().sum() * 0.0


def _ring_attention_local_flash(q, k, v, group, causal: bool):
    """Per-rank ring body with the flash kernel as the chunk-vs-chunk
    block: each visiting k/v chunk contributes a normalized partial
    (o_b, lse_b) from the flash kernels, folded in fp32 with the
    logsumexp combiner lse' = logaddexp(lse, lse_b),
    o' = o·e^{lse−lse'} + o_b·e^{lse_b−lse'}. Differentiable end to end:
    the kernels' backward carries the lse cotangent the combiner
    introduces.

    The partial o_b comes back in the compute dtype (the reference's
    ``flash_attention_lse`` returns it in fp32), so its cotangent is in
    that dtype too and a bf16 ring's backward launches stay on the
    tensor-core route; the fold itself runs in fp32."""
    from pbs_tpu_torch.ops.attention import flash_attention_lse

    B, Sq, H, hd = q.shape
    n = comm.group_size(group)
    my = comm.group_index(group)

    o = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Sq, H, 1), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for k_cur, v_cur, t in _ring_steps(k, v, group, n):
        src = (my - t) % n
        if causal and src > my:
            # Fully masked: the identity under the combiner.
            if t == n - 1:
                o = _tie(o, k_cur)  # k_cur is a view of the rotated k/v
            continue
        o_b, lse_b = flash_attention_lse(
            q, k_cur, v_cur, causal=causal and src == my, out_f32=False)
        lse_new = torch.logaddexp(lse, lse_b)
        o = (o * torch.exp(lse - lse_new)
             + o_b.float() * torch.exp(lse_b - lse_new))
        lse = lse_new
    return o.to(q.dtype)


def _ring_attention_local(q, k, v, group, causal: bool, sm_scale: float):
    """Per-rank body. q/k/v are local chunks (B, S_local, H|Hkv, hd)."""
    B, Sq, H, hd = q.shape
    n = comm.group_size(group)
    my = comm.group_index(group)

    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)

    pos = torch.arange(Sq, device=q.device)
    diag_mask = pos[None, :] <= pos[:, None]
    full = torch.ones((Sq, Sq), dtype=torch.bool, device=q.device)
    none = torch.zeros((Sq, Sq), dtype=torch.bool, device=q.device)
    for k_cur, v_cur, t in _ring_steps(k, v, group, n):
        src = (my - t) % n
        if causal:
            # src < my: fully visible; src == my: diagonal; src > my:
            # masked out (its terms multiply in as exp(-inf) = 0).
            mask = full if src < my else diag_mask if src == my else none
        else:
            mask = None
        bm, bl, bacc = _local_block(q, k_cur, v_cur, sm_scale, mask)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = alpha * l + beta * bl
        acc = alpha * acc + beta * bacc
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)  # (B,H,Sq,hd)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # (B, S/n, H, hd): this rank's chunk along ``axis``
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = True,
    batch_axis: str | None = None,
    head_axis: str | None = None,
    block_impl: str = "dense",
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``mesh[axis]``.

    Matches dense causal attention bit-for-near (fp32 accumulation);
    memory per rank is O(S/n · S/n) per block instead of O(S·S).

    ``batch_axis``/``head_axis`` name further mesh axes the batch and
    head dimensions are sharded over (dp / tp composition): this rank
    already holds its block of those, so only ``axis`` carries the k/v
    rotation. Axes absent from the mesh are ignored so callers can pass
    their full layout unconditionally.

    ``block_impl`` picks the intra-chunk block computation: ``"dense"``
    (einsum, one (S/n)² block at a time) or ``"flash"`` (the flash
    kernels per chunk — long local chunks never materialize
    probabilities).
    """
    hd = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(hd)
    if block_impl == "flash":
        fn = functools.partial(_ring_attention_local_flash, causal=causal)
    elif block_impl == "dense":
        fn = functools.partial(_ring_attention_local, causal=causal,
                               sm_scale=sm_scale)
    else:
        raise ValueError(
            f"unknown block_impl {block_impl!r}; expected 'dense' or "
            "'flash'")
    return fn(q, k, v, mesh.group(axis))
