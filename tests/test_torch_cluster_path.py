"""Phase 3d of ``chip_smoke.py`` (the cluster control plane) on the host.

The card phase boots the flagship training image through two agents
behind one controller, migrates it live, pages it out and snapshots it
over RPC, replicates it with Remus, kills the holder and recovers, then
runs the process federation and the agent chaos harness. This twin
runs the same code — ``chip_smoke.cluster_run`` and
``process_federation_checks`` — with the same checks, at toy width:
``CudaBackend(device="cpu")``, a toy warm image built by
``chip_smoke.build_images(device="cpu")`` and a small matmul tenant.
Every check raises ``chip_smoke.Failed``.
"""

from __future__ import annotations

import math

import torch

import chip_smoke
from test_torch_procfed import time_limit

torch.set_num_threads(2)


def toy_images(tmp_path):
    from pbs_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq=64,
                            dtype=torch.float32, remat=True,
                            remat_policy="dots", attn_impl="pallas")
    paths, digest, nbytes, _ = chip_smoke.build_images(
        torch, cfg, str(tmp_path), device="cpu", corpus_tokens=4096,
        batch=2, seq=32)
    return paths, digest, nbytes


def toy_mm():
    from pbs_tpu_torch.ops.matmul import instrumented_matmul, scale_stats

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=gen)
    b = torch.randn(64, 64, generator=gen)

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, 32, 32, 32)
        return out, scale_stats(raw, 32, 32, 32).metrics()

    return mm_fn


@time_limit(300)
def test_cluster_run_on_the_host(tmp_path):
    """(a)-(c) at toy width: every check of the card phase passes, the
    numbers it prints are there, and ``train`` ends at its max_steps
    with finite losses."""
    paths, digest, _ = toy_images(tmp_path)
    out = chip_smoke.cluster_run(
        torch, "cpu", paths["warm"], digest, toy_mm(), str(tmp_path),
        lambda s: chip_smoke.state_digest(torch, s, "cpu"))
    assert out["steps"] == chip_smoke.CLUSTER_TRAIN_STEPS
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["epochs"] >= chip_smoke.CLUSTER_EPOCHS
    assert out["record_bytes"] > 0 and out["telemetry_words"] > 0
    m = out["migrate_ms"]
    assert m["total"] >= m["restore"] >= m["boot"] > 0
    p50, p99 = out["ping_us"]
    assert 0 < p50 <= p99
    chip_smoke.cluster_lines(out, "host")


@time_limit(300)
def test_process_federation_checks_on_the_host(tmp_path):
    """(d): the SIGKILLed member recovers from its journal, two disarmed
    runs give the pinned digest, the chaos smoke its golden."""
    out = chip_smoke.process_federation_checks(str(tmp_path))
    assert out["spawn_ms"] > 0 and out["recover_ms"] > 0
    assert len(out["disarmed_s"]) == 2


@time_limit(120)
def test_pinned_digests_are_the_references(tmp_path):
    """The digests 3d holds the port to are the reference's: the chaos
    smoke golden is ``tests/test_chaos_smoke.py``'s, and the disarmed
    process run's is what ``pbs_tpu``'s harness gives for the same
    arguments."""
    import test_chaos_smoke

    from pbs_tpu.gateway.procfed import run_process_chaos

    assert chip_smoke.GOLDEN_SMOKE_DIGEST == \
        test_chaos_smoke.GOLDEN_SMOKE_DIGEST
    r = run_process_chaos(**chip_smoke.PROCFED_DISARMED_KW,
                          workdir=str(tmp_path))
    assert r["ok"] and r["digest"] == chip_smoke.PROCFED_DISARMED_DIGEST
