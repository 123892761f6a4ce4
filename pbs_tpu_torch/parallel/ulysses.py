"""Ulysses-style all-to-all sequence parallelism.

The port of ``pbs_tpu.parallel.ulysses``: the second of the two
long-context strategies (ring attention in ``ring_attention.py`` is
the neighbor-exchange one). Ulysses re-partitions instead of rotating:
the sequence arrives sharded over the ``sp`` axis; one all-to-all
scatters *heads* and gathers the full sequence, each rank runs exact
attention over the whole sequence for its head subset, and a second
all-to-all restores sequence sharding. Communication is two
all-to-alls of the activation size, independent of sequence length —
cheaper than a ring when the head count covers the axis, at the cost of
requiring ``H % n == 0`` (and ``Hkv % n == 0`` for GQA).

Both strategies share the intra-rank block choice: ``"dense"`` (einsum)
or ``"flash"`` (the flash kernels — here over the *full* sequence per
rank). Differentiable end to end: the all-to-all's backward is the
inverse all-to-all (:mod:`pbs_tpu_torch.parallel.comm`). SPMD by rank:
:func:`ulysses_attention` takes and returns this rank's sequence chunk.
"""

from __future__ import annotations

import math

import torch

from pbs_tpu_torch.parallel import comm

NEG_INF = -1e30


def _dense_block(q, k, v, causal: bool, sm_scale: float):
    """Exact attention, full sequence, local heads. q:(B,S,H,hd)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * sm_scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def _ulysses_local(q, k, v, group, causal: bool, sm_scale: float,
                   block_impl: str):
    """Per-rank body. q/k/v: (B, S/n, H|Hkv, hd)."""
    # Scatter heads, gather sequence: (B, S/n, H, hd) -> (B, S, H/n, hd),
    # contiguous, so the flash kernels take their tensor-core route.
    qh = comm.all_to_all(q, group, split_dim=2, concat_dim=1)
    kh = comm.all_to_all(k, group, split_dim=2, concat_dim=1)
    vh = comm.all_to_all(v, group, split_dim=2, concat_dim=1)
    if block_impl == "flash":
        from pbs_tpu_torch.ops.attention import flash_attention

        o = flash_attention(qh, kh, vh, causal=causal)
    else:
        o = _dense_block(qh, kh, vh, causal, sm_scale)
    # Scatter sequence, gather heads back.
    return comm.all_to_all(o, group, split_dim=1, concat_dim=2)


def ulysses_attention(
    q: torch.Tensor,  # (B, S/n, H, hd): this rank's chunk along ``axis``
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "sp",
    causal: bool = True,
    batch_axis: str | None = None,
    block_impl: str = "dense",
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``mesh[axis]``,
    via head-scattering all-to-alls (DeepSpeed-Ulysses style).

    Requires the (kv) head counts to be divisible by the axis size;
    rejects loudly otherwise (use ring attention there — it has no head
    constraint). ``batch_axis`` names a dp axis to compose with; this
    rank already holds its batch block, so it is ignored either way.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    n = mesh.shape[axis]
    if H % n or Hkv % n:
        raise ValueError(
            f"ulysses needs H ({H}) and Hkv ({Hkv}) divisible by the "
            f"'{axis}' axis size ({n}); use ring attention for this shape"
        )
    if "tp" in mesh.axis_names and mesh.shape["tp"] > 1:
        # Heads are the resource ulysses scatters over sp; a tp axis
        # sharding the same heads would silently all-gather them here
        # (undoing tp's memory/compute savings) — reject instead.
        raise ValueError(
            "ulysses does not compose with tensor parallelism (both "
            "shard heads); use ring attention on tp meshes"
        )
    if block_impl not in ("dense", "flash"):
        raise ValueError(
            f"unknown block_impl {block_impl!r}; expected 'dense' or "
            "'flash'")
    sm_scale = 1.0 / math.sqrt(hd)
    return _ulysses_local(q, k, v, mesh.group(axis), causal, sm_scale,
                          block_impl)
