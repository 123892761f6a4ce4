"""The port's flash attention against ``pbs_tpu.ops.attention``.

The same inputs, drawn with numpy from a seed, go through the JAX
package's Pallas kernels (interpret mode on the CPU, as its own tests
run them; gradients by ``jax.grad`` through its ``custom_vjp``) and
through ``pbs_tpu_torch.ops.attention`` on CPU tensors (the plain
PyTorch versions the CUDA kernels are held against on the card), at the
shapes of ``tests/test_attention.py``. fp32, atol = rtol = 2e-5, the
reference's own bound; gradients at atol 2e-5 after scaling by
max|ref|, as there.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

from pbs_tpu.ops import attention as ref  # noqa: E402
from pbs_tpu_torch.ops import attention as port  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

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


def _assert_grads_close(got, want):
    for name, a, b in zip("qkv", got, want):
        b = np.asarray(b)
        scale = float(np.max(np.abs(b))) + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=2e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("S,causal,Hkv", [(256, True, 2), (255, True, 2),
                                          (130, False, 4)])
def test_flash_grad_matches_reference(S, causal, Hkv):
    """The port's backward against the Pallas backward (dq pass and
    GQA-reducing dk/dv pass), including a ragged S."""
    q, k, v = qkv(S=S, Hkv=Hkv)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda q, k, v: jax.numpy.sum(
            ref.flash_attention(q, k, v, causal=causal) * w),
        argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    (port.flash_attention(tq, tk, tv, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    _assert_grads_close((tq.grad, tk.grad, tv.grad), want)


@pytest.mark.parametrize("S,causal", [(256, True), (130, False)])
def test_flash_lse_grad_matches_reference(S, causal):
    """A loss on both o and lse: the lse cotangent enters ds (ring
    attention's fold depends on it)."""
    q, k, v = qkv(S=S, hd=32, seed=5)
    rng = np.random.default_rng(8)
    w = rng.standard_normal(q.shape).astype(np.float32)
    wl = rng.standard_normal((2, S, 4, 1)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = ref.flash_attention_lse(q, k, v, causal=causal)
        return jax.numpy.sum(o * w) + jax.numpy.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    o, lse = port.flash_attention_lse(tq, tk, tv, causal=causal)
    ((o * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(wl)).sum()).backward()
    _assert_grads_close((tq.grad, tk.grad, tv.grad), want)


@pytest.mark.parametrize("causal,Hkv", [(True, 2), (False, 1), (True, 4)])
def test_plain_backward_equals_autograd_through_plain_forward(causal, Hkv):
    """An independent check of the plain backward's arithmetic: torch
    autograd through flash_attention_plain (dense, masked softmax) on a
    loss of o and lse."""
    q, k, v = _torch(*qkv(S=77, Hkv=Hkv, hd=32, seed=9))
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    wl = torch.from_numpy(
        rng.standard_normal((2, 77, 4, 1)).astype(np.float32))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = port.flash_attention_plain(tq, tk, tv, causal, out_f32=True)
    ((o * w).sum() + (lse * wl).sum()).backward()
    got = port.flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(),
                                         w, wl, causal)
    for a, b in zip(got, (tq.grad, tk.grad, tv.grad)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_flash_grads_come_back_in_the_input_dtype():
    q, k, v = (t.bfloat16().requires_grad_() for t in _torch(*qkv(S=64)))
    port.flash_attention(q, k, v).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    o, lse = port.flash_attention_lse(*(t.detach().requires_grad_()
                                        for t in (q, k, v)))
    assert o.dtype == torch.float32 and lse.requires_grad


@pytest.mark.parametrize("hd", port.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
def test_forward_route_rule(hd, dtype, route):
    """The stated rule that picks the forward kernel's route: bf16 q, k,
    v that TMA can address go to the tensor cores, the rest to the CUDA
    cores."""
    q, k, v = (t.to(dtype) for t in _torch(*qkv(S=16, hd=hd)))
    assert port.forward_route(q, k, v) == route


def test_forward_route_of_an_unaligned_view():
    B, S, H, hd = 2, 16, 4, 64
    flat = torch.zeros(B * S * H * hd + 8, dtype=torch.bfloat16)
    q = flat[1:1 + B * S * H * hd].view(B, S, H, hd)
    k, v = (torch.zeros((B, S, 2, hd), dtype=torch.bfloat16) for _ in "kv")
    assert q.is_contiguous() and port.forward_route(q, k, v) == "simt"
    q = flat[8:8 + B * S * H * hd].view(B, S, H, hd)
    assert port.forward_route(q, k, v) == "wgmma"


@pytest.mark.parametrize("hd", port.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype,do_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "wgmma"),
    (torch.float32, torch.float32, "simt"),
    (torch.bfloat16, torch.float32, "simt")],  # the lse variant's fp32 do
    ids=["bf16-bf16", "fp32-fp32", "bf16-fp32"])
def test_backward_route_rule(hd, dtype, do_dtype, route):
    """The stated rule that picks the backward kernels' route: bf16 q, k,
    v and a bf16 do that TMA can address go to the tensor cores, the rest
    to the CUDA cores."""
    q, k, v = (t.to(dtype) for t in _torch(*qkv(S=16, hd=hd)))
    do = torch.zeros(q.shape, dtype=do_dtype)
    assert port.backward_route(q, k, v, do) == route


def test_backward_route_of_an_unaligned_view():
    B, S, H, hd = 2, 16, 4, 64
    flat = torch.zeros(B * S * H * hd + 8, dtype=torch.bfloat16)
    do = flat[1:1 + B * S * H * hd].view(B, S, H, hd)
    q = torch.zeros((B, S, H, hd), dtype=torch.bfloat16)
    k, v = (torch.zeros((B, S, 2, hd), dtype=torch.bfloat16) for _ in "kv")
    assert do.is_contiguous() and port.backward_route(q, k, v, do) == "simt"
    do = flat[8:8 + B * S * H * hd].view(B, S, H, hd)
    assert port.backward_route(q, k, v, do) == "wgmma"
