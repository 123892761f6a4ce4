"""Phase 3n of ``chip_smoke.py`` (the native runtime under the main path)
on the host.

The card phase runs 3c's tenants under credit in a Partition on the C
ledger, rings and histograms, with a monitor process across the ledger
file and a doorbell, times the runtime calls on each tier, runs the
native sim core and the native gather. This twin runs the same code —
``chip_smoke.native_runtime_run``, ``tier_costs``, ``native_sim`` and
``native_gather`` — with the same checks, at toy width:
``CudaBackend(device="cpu")`` (the plain kernels), a scoring tenant, a
matmul tenant and a ``ContinuousBatcher`` engine on a seeded script.
Every check raises ``chip_smoke.Failed``; these cases also hold what the
phase returned together.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import torch

import chip_smoke
from pbs_tpu_torch.runtime import native

torch.set_num_threads(2)

WEIGHTS = {"score": 256, "mm": 512, "engine": 256}


def toy_tenants():
    """score, mm and a small engine on a seeded script, as Jobs shaped
    like chip_smoke's ``control_tenants``: (jobs, engine, tick record)."""
    from pbs_tpu_torch.models import (ContinuousBatcher, TransformerConfig,
                                      forward, init_params,
                                      make_continuous_serve_step)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul, scale_stats
    from pbs_tpu_torch.runtime import Job, SchedParams

    cfg = TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq=64,
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    score_cfg = dataclasses.replace(cfg, attn_impl="pallas")

    @torch.no_grad()
    def score_fn(state):
        logits = forward(score_cfg, params, tokens)
        return logits[:, -1].argmax(dim=-1), {"tokens": tokens.numel()}

    a = torch.randn(64, 64, generator=gen)
    b = torch.randn(64, 64, generator=gen)

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, 32, 32, 32)
        return out, scale_stats(raw, 32, 32, 32).metrics()

    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))).astype(
        np.int32), int(rng.integers(3, 8))) for _ in range(8)]
    arrivals = {0: [0, 1, 2], 1: [3, 4], 2: [5], 4: [6, 7]}
    n_ticks = chip_smoke.engine_ticks([n for _, n in reqs], arrivals, 2)
    eng = ContinuousBatcher(cfg, params, n_slots=2, prompt_bucket=16,
                            max_len=32, prefix_cache_size=4, device="cpu")
    step = make_continuous_serve_step(
        eng, next_requests=lambda t: [reqs[i] for i in arrivals.get(t, [])])
    ticks = []

    def engine_fn(state):
        out = step(state)
        ticks.append((1.0, len(eng._admitted)))
        return out

    jobs = {
        "score": Job("score", step_fn=score_fn,
                     params=SchedParams(weight=WEIGHTS["score"]),
                     max_steps=3),
        "mm": Job("mm", step_fn=mm_fn,
                  params=SchedParams(weight=WEIGHTS["mm"]), max_steps=4),
        "engine": Job("engine", step_fn=engine_fn,
                      state={"step": 0, "completed": 0},
                      params=SchedParams(weight=WEIGHTS["engine"],
                                         tslice_us=100, boost_on_wake=True),
                      max_steps=n_ticks),
    }
    return jobs, eng, ticks


@pytest.fixture(autouse=True, scope="module")
def _native():
    """The phase needs the native runtime: skip, naming why, without it
    (decided here, never while the module is imported)."""
    if not native.available():
        pytest.skip(f"native runtime unavailable: "
                    f"{native.unavailable_reason()}")


@pytest.fixture(scope="module")
def run(_native, tmp_path_factory, monkeypatch_module):
    # A few served tokens per virq, so the toy engine raises several.
    monkeypatch_module.setattr(chip_smoke, "NATIVE_SAMPLE_PERIOD", 4)
    tmp = str(tmp_path_factory.mktemp("native"))
    return chip_smoke.native_runtime_run(toy_tenants, "cpu", tmp,
                                         "host CPU, no card")


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_native_runtime_run_runs_every_check(run):
    """Every check of (b) and (c) passed inside the run; what it
    returned holds together."""
    want = native.tier()
    assert run["tiers"] == {"ledger": want, "rings": [want]}
    assert set(run["jobs"]) == set(WEIGHTS)
    assert run["quanta"] > 0 and run["wall"] > 0
    mon = run["monitor"]
    assert mon["torn"] == 0 and mon["stopped"]
    assert mon["virqs"] >= 2 and mon["wakeups"] >= 1
    assert len(mon["sums"]) == run["n_slots"]
    # One resume and one suspend per quantum, a pick and a desched on
    # the ring (plus the policy's own records).
    assert run["per_q"]["ledger.resume"] == 1.0
    assert run["per_q"]["ledger.suspend"] == 1.0
    assert run["per_q"]["ring.emit"] >= 2.0
    assert 0 < run["per_q"]["hist.record_many"] <= 1.0
    assert run["per_q"]["emit_batch.flush"] > 0


def test_tier_costs_cover_every_call_on_every_tier(run):
    costs = chip_smoke.tier_costs(run["slots"], run["per_q"], ops=200,
                                  rounds=2)
    tiers = ["python", "ctypes"] + (["fastcall"]
                                    if native.tier() == "fastcall" else [])
    assert list(costs) == tiers
    keys = {"ledger.resume", "ledger.suspend", "ledger.add_many",
            "ledger.snapshot_many", "ring.emit", "emit_batch.flush",
            "hist.record_many", "per_quantum_us"}
    for t in tiers:
        assert set(costs[t]) == keys
        assert all(v > 0 for v in costs[t].values()), (t, costs[t])
    chip_smoke.print_tier_costs(costs, run["per_q"], run["slots"], "host")


def test_native_sim_replays_the_profiles_and_a_recorded_workload(run):
    """(e) on a workload built by ``recorded_workload`` from the run's own
    device time, as 3r's is on the card."""
    from pbs_tpu_torch.telemetry import Counter

    own = {n: j.contexts[0].counters.copy() for n, j in run["jobs"].items()}
    for c in own.values():  # the host has no stall: give it some
        c[Counter.HBM_STALL_NS] = c[Counter.DEVICE_TIME_NS] // 4
    start = {n: dict(weight=WEIGHTS[n], cap=0, tslice_us=1_000,
                     boost_on_wake=False) for n in own}
    _, build = chip_smoke.recorded_workload({"own": own, "start": start},
                                            "(e)")
    runs = chip_smoke.native_sim(build, horizon_ns=2 * 10 ** 9)
    assert runs["native"]["used"] in ("fastcall", "ctypes")
    assert runs["python"]["used"] == "python"
    assert json.dumps(runs["python"]["report"], sort_keys=True) == \
        json.dumps(runs["native"]["report"], sort_keys=True)
    assert runs["native"]["report"]["quanta"] > 0


def test_native_gather_matches_numpy_through_the_loader(tmp_path):
    out = chip_smoke.native_gather("cpu", str(tmp_path), 50_000, 200_000,
                                   4, 128, 8, n_batches=3, card="host")
    assert out["batches"] == 3
    assert out["native_ms"] > 0 and out["numpy_ms"] > 0


def test_a_python_tier_partition_fails_the_check(monkeypatch):
    """``check_native`` is fatal when a partition falls back."""
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.telemetry import SimBackend

    monkeypatch.setattr(native, "load", lambda: None)
    part = Partition("fallback", source=SimBackend())
    with pytest.raises(chip_smoke.Failed, match="python"):
        chip_smoke.check_native(part)
