"""Phase 3r of ``chip_smoke.py`` (record, replay and tune) on the host.

The card phase records 3c's tenants live through ``HwCounterSource``
over ``CudaBackend``, replays the run offline under credit, credit2 and
SEDF, tunes the feedback policy on a simulator workload built from the
recorded step times and arms the winner. This twin runs the same code,
``chip_smoke.record_replay_tune``, with the same checks, at toy width:
``CudaBackend(device="cpu")`` (the plain kernels), a scoring tenant, a
matmul tenant and a ``ContinuousBatcher`` engine on a seeded script, and
a scripted counter tier in place of the host ladder. Then the recorded
trace replays in ``pbs_tpu`` to the port's totals, and the tune search
on the recorded workload gives the reference's frontier.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pbs_tpu_torch.hwtelem.sources import CounterTier  # noqa: E402

torch.set_num_threads(2)

WEIGHTS = {"score": 256, "mm": 512, "engine": 256}


class ScriptedTier(CounterTier):
    """A counter tier that supplies every declared event, each read a
    fixed step further than the last: host counters made deterministic."""

    name = "scripted"
    STEP = {"instructions": 90_000, "cycles": 120_000,
            "cache-references": 700, "cache-misses": 140,
            "task-clock": 40_000}

    def __init__(self):
        super().__init__()
        self._reason = None
        self._events = tuple(self.STEP)
        self._n = 0

    def read(self):
        self._n += 1
        return {ev: step * self._n for ev, step in self.STEP.items()}


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
        np.int32), int(rng.integers(3, 8))) for _ in range(6)]
    arrivals = {0: [0, 1, 2], 1: [3, 4], 2: [5]}
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


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("record"))
    out = chip_smoke.record_replay_tune(
        toy_tenants, "cpu", ScriptedTier, tmp, "host CPU, no card")
    out["tmp"] = tmp
    return out


def test_record_replay_tune_runs_every_check(phase):
    """Every check of (a)-(d) passed inside the run (each raises
    ``chip_smoke.Failed``); what it returned holds together."""
    live, armed = phase["live"], phase["armed"]
    for run in (live, armed):
        assert set(run["own"]) == set(WEIGHTS)
        assert run["window"].tier == "scripted"
        assert len(run["window"].samples) > 0
        kinds = {r["kind"] for r in run["recs"]}
        assert kinds == {"meta", "quantum", "tick"}
    assert set(phase["shares"]) == {"credit", "credit2", "sedf"}
    assert all(set(s) == set(WEIGHTS) for s in phase["shares"].values())
    # The scripted tier supplies cache events, so no axis is absent.
    assert phase["fidelity"]["axes"]["miss_rate"]["absent"] is False
    win = phase["tuned"]["frontier"]["winner"]["params"]
    from pbs_tpu_torch.sched import tune

    assert win in tune.QUICK_SPACE["feedback"]
    assert set(phase["tuned"]["scores"]) == {"winner", "reference",
                                             "serving profile"}
    print("check-horizon scores", phase["tuned"]["scores"])
    # The search promises the order on its own last rung, not on the
    # check horizon the scores above come from: the winner heads the
    # last rung's leaderboard.
    frontier = phase["tuned"]["frontier"]
    board = frontier["leaderboard"]
    assert board[0] == {"params": frontier["winner"]["params"],
                        "score_x1e6": frontier["winner"]["score_x1e6"]}
    assert all(row["score_x1e6"] <= board[0]["score_x1e6"] for row in board)
    assert phase["engine"]["a"]["engine"]["completed"] == 6
    assert phase["engine"]["d"]["engine"]["completed"] == 6


def test_overlay_replaces_the_inner_device_time(phase):
    """The hwtelem overlay writes the tier's task-clock where
    CudaBackend's device time was, and the card's own numbers are kept
    beside it: steps and tokens are CudaBackend's, device time the
    tier's."""
    from pbs_tpu_torch.telemetry import Counter

    for name, job in phase["live"]["jobs"].items():
        own = phase["live"]["own"][name]
        got = job.contexts[0].counters
        assert int(got[Counter.STEPS_RETIRED]) == \
            int(own[Counter.STEPS_RETIRED])
        assert int(got[Counter.TOKENS]) == int(own[Counter.TOKENS])
        quanta = job.contexts[0].sched_count
        assert int(got[Counter.DEVICE_TIME_NS]) == \
            ScriptedTier.STEP["task-clock"] * quanta
        assert int(own[Counter.DEVICE_TIME_NS]) > 0


def test_recorded_trace_replays_in_the_reference(phase):
    """The trace the port recorded replays through ``pbs_tpu``'s
    ``replay_partition`` to the port's totals under every scheduler."""
    ref = importlib.import_module("pbs_tpu.sim")
    port = importlib.import_module("pbs_tpu_torch.sim")
    recs = phase["live"]["recs"]
    for sched in ("credit", "credit2", "sedf"):
        got = []
        for P in (ref, port):
            part = P.replay_partition(recs, scheduler=sched)
            part.run()
            got.append({j.name: j.contexts[0].counters.tolist()
                        for j in part.jobs})
        assert got[1] == got[0]


def test_tune_on_the_recorded_workload_equals_the_reference(phase):
    """The workload (c) built from the recorded numbers, registered in
    both packages: the quick halving frontier and the scores of the
    three param sets are the reference's."""
    tuned = phase["tuned"]
    start = phase["live"]["start"]
    out = []
    for root in ("pbs_tpu", "pbs_tpu_torch"):
        wl = importlib.import_module(f"{root}.sim.workload")
        rt = importlib.import_module(f"{root}.runtime")
        tel = importlib.import_module(f"{root}.telemetry")
        tune = importlib.import_module(f"{root}.sched.tune")

        def build(seed, n, horizon_ns, wl=wl, rt=rt, tel=tel):
            return [wl.TenantSpec(
                name=name, params=rt.SchedParams(**start[name]),
                profile=tel.SimProfile.steady(
                    step_time_ns=step_ns, stall_frac=frac,
                    collective_wait_ns=0, jitter=chip_smoke.RECORD_JITTER))
                for name, step_ns, frac in tuned["tenants"]]

        wl.register_workload(chip_smoke.RECORD_WORKLOAD, build)
        try:
            frontier = tune.successive_halving(
                chip_smoke.RECORD_WORKLOAD, "feedback",
                configs=tune.QUICK_SPACE["feedback"],
                rungs=tune.QUICK_RUNGS)
            scores = tune.evaluate_params(
                chip_smoke.RECORD_WORKLOAD, "feedback",
                list(tuned["params"].values()))
        finally:
            wl.unregister_workload(chip_smoke.RECORD_WORKLOAD)
        out.append(json.dumps([frontier, scores], sort_keys=True))
    assert out[1] == out[0]
    assert json.loads(out[1])[0] == tuned["frontier"]


def test_written_profile_stays_out_of_the_package(phase):
    """(c) writes the winner into the phase's scratch directory, never
    beside the five copied profiles."""
    import os

    from pbs_tpu_torch.sched import tune

    assert chip_smoke.RECORD_WORKLOAD not in tune.tuned_workloads()
    path = tune.profile_path(chip_smoke.RECORD_WORKLOAD, phase["tmp"])
    assert os.path.exists(path)
    prof = tune.load_profile(chip_smoke.RECORD_WORKLOAD, phase["tmp"])
    assert prof["params"] == phase["tuned"]["frontier"]["winner"]["params"]
    from pbs_tpu_torch.sim import native_core

    # Sweep-mode scoring rides the native sim core where it builds.
    assert prof["check"]["tier"] == (native_core.available_tier()
                                     or "python")


def test_a_check_that_fails_stops_the_phase(tmp_path):
    """A phase failure is fatal: a tenant whose step raises is contained
    by the partition (its faulted quantum never reaches SCHED_DESCHED),
    and the live run's first check fails."""

    def broken():
        jobs, eng, ticks = toy_tenants()
        fn = jobs["mm"].step_fn

        def flaky(state, n=[0]):
            n[0] += 1
            if n[0] == 2:
                raise RuntimeError("tenant fault")
            return fn(state)

        jobs["mm"].step_fn = flaky
        return jobs, eng, ticks

    with pytest.raises(chip_smoke.Failed, match=r"^\(a\) the run drained"):
        chip_smoke.record_replay_tune(
            broken, "cpu", ScriptedTier, str(tmp_path),
            "host CPU, no card")
