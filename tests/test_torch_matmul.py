"""The port's instrumented matmul against ``pbs_tpu.ops.matmul``.

Same inputs (numpy, seeded) through the JAX Pallas kernel in interpret
mode and through ``pbs_tpu_torch.ops.matmul`` on CPU tensors (the plain
version the CUDA kernel is held against on the card), at the cases of
``tests/test_matmul.py``. The counter vectors must be EXACTLY equal;
products agree within the reference's fp32 bound (rtol 2e-5, atol
2e-4: the two sum in different orders). Then the port's twin of the
reference's kernel-counters-land-in-the-ledger test, on
``CudaBackend(device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu.ops import matmul as ref  # noqa: E402
from pbs_tpu_torch.ops import matmul as port  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)


def _both(a, b, blocks, bf16=False):
    """(ref out, ref stats, port out, port stats) as numpy."""
    if bf16:
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        # bf16 -> fp32 -> bf16 is exact, so both sides see equal bits
        ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
        tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    else:
        ja, jb, ta, tb = a, b, torch.from_numpy(a), torch.from_numpy(b)
    r_out, r_raw = ref.instrumented_matmul(ja, jb, *blocks)
    p_out, p_raw = port.instrumented_matmul(ta, tb, *blocks)
    assert p_out.dtype == torch.float32 and p_raw.dtype == torch.int32
    return (np.asarray(r_out), np.asarray(r_raw), p_out.numpy(),
            p_raw.numpy())


@pytest.mark.parametrize(
    "M,K,N,blocks",
    [(256, 512, 384, (128, 128, 128)),   # correctness vs XLA case
     (512, 768, 256, (128, 128, 128)),   # tile and traffic counting case
     (128, 256, 128, (256, 256, 256)),   # blocks clamp to the dims
     (256, 512, 256, (128, 256, 64))])   # unequal blocks
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_matmul_and_stats_match_reference(M, K, N, blocks, bf16):
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    r_out, r_raw, p_out, p_raw = _both(a, b, blocks, bf16)
    np.testing.assert_array_equal(p_raw, r_raw)
    np.testing.assert_allclose(p_out, r_out, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_zero_tile_counter_matches_reference(bf16):
    """The data-derived event: all-zero A tiles count once per column
    block j, exactly as the sequential TPU grid counts them — including
    a tile that is zero only in its upper half (not counted) and -0.0
    (counted as zero)."""
    M, K, N, blk = 384, 256, 256, 128
    a = np.ones((M, K), np.float32)
    a[:128] = 0.0                  # row-block 0: both its A tiles zero
    a[128:192, :128] = 0.0         # half a tile: not an all-zero tile
    a[256:, 128:] = -0.0           # one more all-zero tile
    b = np.ones((K, N), np.float32)
    _, r_raw, _, p_raw = _both(a, b, (blk, blk, blk), bf16)
    np.testing.assert_array_equal(p_raw, r_raw)
    assert p_raw[port.STAT_A_ZERO_TILES] == 3 * (N // blk)


def test_scaled_stats_and_metrics():
    M, K, N, blk = 512, 768, 256, 128
    a = torch.ones((M, K))
    _, raw = port.instrumented_matmul(a, torch.ones((K, N)), blk, blk, blk)
    assert raw.shape == (port.N_STATS,)
    st = port.scale_stats(raw, blk, blk, blk)
    grid = (M // blk) * (N // blk) * (K // blk)
    assert st.mxu_tiles == grid
    assert st.flops == grid * 2 * blk ** 3 == 2 * M * N * K
    assert st.hbm_read_bytes == grid * 2 * (blk * blk * 4)
    assert st.hbm_write_bytes == (M // blk) * (N // blk) * (blk * blk * 4)
    assert st.metrics() == {
        "device_flops": st.flops,
        "hbm_bytes": st.hbm_read_bytes + st.hbm_write_bytes}
    # same fields and values as the reference's host-side scaling
    assert vars(st) == vars(ref.scale_stats(raw.numpy(), blk, blk, blk))


@pytest.mark.parametrize("shape", [((100, 128), (128, 128)),
                                   ((128, 128), (64, 128))])
def test_shape_validation_matches_reference(shape):
    a, b = (np.ones(s, np.float32) for s in shape)
    with pytest.raises(ValueError):
        ref.instrumented_matmul(a, b, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError):
        port.instrumented_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 64, 64, 64)


def test_kernel_counters_land_in_ledger():
    """A job built on the instrumented matmul feeds its counters into
    DEVICE_FLOPS / HBM_BYTES — with no ``compiled`` handle the static
    estimate is zero, so the ledger values can only come from the
    kernel's own counting (the twin of the reference test)."""
    from pbs_tpu_torch.runtime import Job, Partition
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    blk = 128
    a = torch.ones((256, 256))

    def step_fn(state):
        out, raw = port.instrumented_matmul(state, a, blk, blk, blk)
        st = port.scale_stats(raw, blk, blk, blk)
        return out / 256.0, st.metrics()

    be = CudaBackend(device="cpu")
    part = Partition("p", source=be)
    job = part.add_job(Job("mm", step_fn=step_fn, state=a, max_steps=3))
    part.run(max_rounds=10)
    ctx = job.contexts[0]
    assert int(ctx.counters[Counter.DEVICE_FLOPS]) == 3 * 2 * 256 ** 3
    assert int(ctx.counters[Counter.HBM_BYTES]) > 0
    assert int(ctx.counters[Counter.STEPS_RETIRED]) == 3
    assert int(ctx.counters[Counter.HBM_STALL_NS]) > 0  # roofline estimate
    np.testing.assert_array_equal(part.ledger.snapshot(ctx.ledger_slot),
                                  ctx.counters)


@pytest.mark.parametrize("M,K,N,dtype,route", [
    (64, 64, 64, torch.bfloat16, "wgmma"),
    (384, 256, 384, torch.bfloat16, "wgmma"),
    (8, 12, 8, torch.bfloat16, "simt"),  # A's rows are 24 bytes
    (8, 16, 12, torch.bfloat16, "simt"),  # B's rows are 24 bytes
    (64, 64, 64, torch.float32, "simt"),
])
def test_kernel_route_rule(M, K, N, dtype, route):
    """The stated rule that picks the kernel's route: bf16 operands TMA
    can address go to the tensor cores, the rest to the CUDA cores."""
    a = torch.zeros((M, K), dtype=dtype)
    b = torch.zeros((K, N), dtype=dtype)
    assert port.kernel_route(a, b) == route


def test_kernel_route_of_an_unaligned_view():
    flat = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16)
    a = flat[1:1 + 64 * 64].view(64, 64)  # 2 bytes past an aligned base
    b = torch.zeros((64, 64), dtype=torch.bfloat16)
    assert a.is_contiguous() and port.kernel_route(a, b) == "simt"
    assert port.kernel_route(flat[8:8 + 64 * 64].view(64, 64), b) == "wgmma"
