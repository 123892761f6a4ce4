"""The port's flash attention against ``pbs_tpu.ops.attention``.

The same inputs, drawn with numpy from a seed, go through the JAX
package's Pallas kernel (interpret mode on the CPU, as its own tests
run it) and through ``pbs_tpu_torch.ops.attention`` on CPU tensors (the
plain PyTorch version the CUDA kernel is held against on the card), at
the shapes of ``tests/test_attention.py``. fp32, atol = rtol = 2e-5,
the reference's own bound.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

from pbs_tpu.ops import attention as ref  # noqa: E402
from pbs_tpu_torch.ops import attention as port  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def qkv(B=2, S=256, H=4, Hkv=2, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, hd)).astype(np.float32)
                 for h in (H, Hkv, Hkv))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize(
    "S,causal,H,Hkv",
    [(256, True, 4, 2), (256, False, 4, 2),  # causal and full
     (256, True, 4, 4), (256, True, 4, 1),   # MHA and wide GQA
     (64, True, 4, 2),                       # S under the default block
     (130, True, 4, 2), (255, True, 4, 2), (255, False, 4, 2)])  # ragged
def test_flash_matches_reference(S, causal, H, Hkv):
    q, k, v = qkv(S=S, H=H, Hkv=Hkv)
    want = np.asarray(ref.flash_attention(q, k, v, causal=causal))
    got = port.flash_attention(*_torch(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("S,causal", [(256, True), (130, False)])
def test_flash_lse_matches_reference(S, causal):
    q, k, v = qkv(S=S, hd=32, seed=3)
    want_o, want_lse = ref.flash_attention_lse(q, k, v, causal=causal)
    o, lse = port.flash_attention_lse(*_torch(q, k, v), causal=causal)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert lse.shape == (2, S, 4, 1) == np.asarray(want_lse).shape
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


def test_flash_lse_returns_fp32_for_bf16_inputs():
    q, k, v = (t.bfloat16() for t in _torch(*qkv(S=64)))
    o, lse = port.flash_attention_lse(q, k, v)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert port.flash_attention(q, k, v).dtype == torch.bfloat16


def test_flash_gqa_grouping():
    """Distinct kv heads route to the right query groups."""
    q, k, v = qkv(H=4, Hkv=4)
    mha = port.flash_attention(*_torch(q, k, v)).numpy()
    k2, v2 = k[:, :, :2].copy(), v[:, :, :2].copy()
    gqa = port.flash_attention(*_torch(q, k2, v2)).numpy()
    np.testing.assert_allclose(
        gqa, np.asarray(ref.flash_attention(q, k2, v2)), **TOL)
    assert not np.allclose(mha, gqa, atol=1e-3)


def test_flash_rejects_bad_shapes():
    q, k, v = qkv(H=4, Hkv=3)
    with pytest.raises(ValueError):
        ref.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        port.flash_attention(*_torch(q, k, v))
    with pytest.raises(ValueError, match="block_q"):
        port.flash_attention(*_torch(*qkv(S=64)), block_q=0)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse"])
def test_backward_raises_until_the_kernels_are_ported(fn):
    """No silent differentiation of the plain version: the backward
    names the missing kernels 2.2 and 2.3."""
    q, k, v = (t.requires_grad_() for t in _torch(*qkv(S=64)))
    out = getattr(port, fn)(q, k, v)
    loss = (out if fn == "flash_attention" else out[0]).sum()
    with pytest.raises(NotImplementedError, match=r"2\.2.*2\.3"):
        loss.backward()
