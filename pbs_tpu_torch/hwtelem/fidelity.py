"""Sim-vs-real fidelity scoring: record a live counter window on the
serving path, shadow-replay it through the sim stack, score the gap.

The port of ``pbs_tpu.hwtelem.fidelity``, report byte for report byte.

The "Fake Runs, Real Fixes" discipline (arXiv 2503.14781): a simulator
that steers production knobs must carry a tracked model-fidelity
metric — sim-predicted vs real-measured response on the axes the
policy actually steers by. Here that is three axes:

- ``util`` — predicted executor utilization (SimEngine busy/elapsed)
  vs the host's measured on-CPU share while pumping the same serving
  workload (window task-clock total / window span).
- ``miss_rate`` — predicted memory-pressure proxy (sim HBM stall
  share of device time) vs the measured cache-miss rate; flagged
  ``absent`` when the recording tier could not supply cache events
  (no PMU, as in most containers) and excluded from the margin rather
  than scored against a hole.
- ``tslice_us`` — predicted steady-state quantum (mean final tslice
  across sim tenants) vs the tslice a real ``FeedbackPolicy`` lands
  on when fed the RECORDED window through ``ReplaySource``.

``record_serving_window`` is the live half (drives the gateway pump
under virtual time while sampling the real ladder — the declared
seam). ``fidelity_report`` is a pure function of (window bytes, seed,
knob values): same inputs ⇒ byte-identical report, off a checked-in
window.
"""

from __future__ import annotations

from typing import Any

from pbs_tpu_torch import knobs
from pbs_tpu_torch.hwtelem.sources import HwCounterSource
from pbs_tpu_torch.hwtelem.window import (
    CounterWindow,
    HwRecorder,
    ReplaySource,
)

#: Recording stamps samples with the live monotonic clock carried by
#: ``HwCounterSource`` while the pump itself runs under virtual time;
#: replay and scoring never touch this seam (fidelity_report is a pure
#: function of the recorded bytes).
REAL_CLOCK_SEAM = (
    "record_serving_window stamps live ladder samples with the "
    "HwCounterSource monotonic clock; fidelity_report replays the "
    "recorded window and reads no real clock"
)

FIDELITY_SCHEMA_VERSION = 1

#: x1e6 fixed-point scale for every ratio in the report — the report
#: is canonical-JSON digestable, so floats never enter it.
_SCALE = 1_000_000


def record_serving_window(
    seed: int = 0,
    ticks: int = 200,
    tick_ns: int = 1_000_000,
    n_backends: int = 2,
    n_tenants: int = 4,
    hw_source: HwCounterSource | None = None,
    capacity: int | None = None,
    sample_every: int = 1,
) -> tuple[CounterWindow, dict]:
    """Drive the gateway serving pump (the reference's
    ``run_gateway_chaos`` shape minus the fault plan) under virtual
    time while sampling the live hardware-counter ladder, and return
    the recorded window plus a small pump report.

    The pump is fully deterministic in ``seed`` — arming the recorder
    moves none of its decisions (observer-only). Only the window's timestamps and deltas carry real-host
    signal. ``hw_source=None`` probes the ladder fresh; tests inject a
    forced-tier source instead.
    """
    from pbs_tpu_torch.gateway.backends import SimServeBackend
    from pbs_tpu_torch.gateway.chaos import (
        build_workload,
        catalog_arrivals,
        draw_arrival,
        quota_for,
    )
    from pbs_tpu_torch.gateway.gateway import Gateway
    from pbs_tpu_torch.utils.clock import VirtualClock

    src = hw_source if hw_source is not None else HwCounterSource(probe=True)
    tier_name = src.tier.name if src.tier is not None else "none"
    rec = HwRecorder(tier=tier_name, capacity=capacity)

    clock = VirtualClock()
    backends = [
        SimServeBackend(f"b{i}", n_slots=2, service_ns_per_cost=tick_ns,
                        seed=seed + i)
        for i in range(max(1, int(n_backends)))
    ]
    tenants = build_workload("mixed", seed=seed, n_tenants=n_tenants)
    gw = Gateway(backends, clock=clock, max_queued=64 * len(tenants),
                 name="hwfid")
    for t in tenants:
        gw.register_tenant(t.name, quota_for(t.name, t.slo, t.params.weight))
    arrivals = catalog_arrivals(tenants, seed, tag=7)

    every = max(1, int(sample_every))
    admitted = shed = completed = 0
    # Prime the delta baseline HERE, after construction: sample 0 must
    # charge the pump, not the gateway/workload build.
    src.sample()
    for tick in range(int(ticks)):
        for t in tenants:
            fire, cost = draw_arrival(t, arrivals[t.name])
            if not fire:
                continue
            r = gw.submit(t.name, {"tick": tick}, cost=cost)
            if r.admitted:
                admitted += 1
            else:
                shed += 1
        completed += len(gw.tick())
        clock.advance(tick_ns)
        if tick % every == 0:
            rec.sample(src.clock.now_ns(), src.sample())
    # Drain (bounded) so the window covers the whole serving episode.
    for i in range(int(ticks) * 4):
        if not gw.busy():
            break
        completed += len(gw.tick())
        clock.advance(tick_ns)
        if i % every == 0:
            rec.sample(src.clock.now_ns(), src.sample())

    window = rec.window()
    report = {
        "seed": int(seed),
        "ticks": int(ticks),
        "tick_ns": int(tick_ns),
        "admitted": admitted,
        "shed": shed,
        "completed": completed,
        "drained": not gw.busy(),
        "tier": tier_name,
        "samples": window and len(window.samples) or 0,
    }
    return window, report


def _replay_tslice(window: CounterWindow, seed: int,
                   knob_values: dict | None) -> dict:
    """Feed the recorded window back through a real ``FeedbackPolicy``
    on a one-job partition and return the tslice trajectory it steers.
    Deterministic: ReplaySource + virtual time, no live ladder."""
    from pbs_tpu_torch.runtime.job import Job
    from pbs_tpu_torch.runtime.partition import Partition
    from pbs_tpu_torch.sched.feedback import FeedbackPolicy

    src = ReplaySource(window)
    part = Partition(f"hwfid-replay-{seed}", source=src,
                     scheduler="credit")
    if knob_values:
        policy = FeedbackPolicy.from_knobs(part, knob_values)
    else:
        policy = FeedbackPolicy(part)
    job = part.add_job(Job("replayed", max_steps=1 << 30))
    traj: list[int] = []
    rounds = min(max(16, 2 * len(window.samples)), 256)
    for _ in range(rounds):
        if part.run(max_rounds=1) == 0:
            break
        traj.append(int(job.params.tslice_us))
    policy.timer.stop()
    if not traj:
        traj = [int(job.params.tslice_us)]
    # Steady state = back third of the trajectory (the front is the
    # adaptation transient, same warmup idea as SimEngine warmup_frac).
    tail = traj[-max(1, len(traj) // 3):]
    return {
        "rounds": len(traj),
        "final_us": traj[-1],
        "steady_us": sum(tail) // len(tail),
        "trajectory_us": traj[:: max(1, len(traj) // 32)][:32],
    }


def _predict_sim(seed: int, knob_values: dict | None,
                 horizon_ns: int) -> dict:
    """The sim's prediction for the same workload family: utilization,
    memory-pressure share, and steady tslice from a seeded SimEngine
    run with the same knob profile armed."""
    from pbs_tpu_torch.sim.engine import SimEngine

    policy_params = None
    if knob_values:
        from pbs_tpu_torch.knobs import profile as knob_profile
        from pbs_tpu_torch.sched.feedback import FeedbackPolicy

        policy_params = {
            p: v for p, v in knob_profile.knobs_to_params(
                FeedbackPolicy.KNOB_POLICY, knob_values).items()
            if p in FeedbackPolicy.TUNABLE_PARAMS
        }
    eng = SimEngine(workload="mixed", policy="feedback", seed=seed,
                    horizon_ns=int(horizon_ns), record=False,
                    policy_params=policy_params or None, native=False)
    rep = eng.run()
    tenants = rep.get("tenants", {})
    tsl = [int(t.get("tslice_us", 0)) for t in tenants.values()]
    dev = sum(int(t.get("device_ns", 0)) for t in tenants.values())
    stall = sum(int(t.get("stall_ns", 0)) for t in tenants.values())
    return {
        "util_x1e6": int(round(float(rep.get("utilization", 0.0))
                               * _SCALE)),
        "stall_share_x1e6": (stall * _SCALE) // max(1, dev),
        "tslice_us": (sum(tsl) // len(tsl)) if tsl else 0,
    }


def _rel_err_x1e6(pred: int, meas: int) -> int:
    """|pred - meas| / max(|meas|, 1) in x1e6 fixed point."""
    return abs(int(pred) - int(meas)) * _SCALE // max(1, abs(int(meas)))


def fidelity_report(window: CounterWindow, seed: int = 0,
                    knob_values: dict | None = None,
                    horizon_ns: int = 500_000_000,
                    floor: float | None = None) -> dict[str, Any]:
    """Score sim-predicted vs window-measured response per axis and
    return the canonical fidelity report.

    Pure in (window bytes, seed, knob_values, horizon, floor): every
    value is an int or string, so ``dumps_canonical`` over the report
    is digest-stable — the reproducibility contract tests pin. Axes
    the recording tier could not measure are marked ``absent`` and
    excluded from the margin instead of scored against zero.
    """
    if floor is None:
        floor = float(knobs.get("hwtelem.fidelity_margin_floor"))
    totals = window.totals()
    span = max(1, window.span_ns())

    measured_util = (int(totals.get("task-clock", 0)) * _SCALE) // span
    refs = int(totals.get("cache-references", 0))
    misses = int(totals.get("cache-misses", 0))
    miss_absent = refs <= 0
    measured_miss = 0 if miss_absent else (misses * _SCALE) // refs

    replay = _replay_tslice(window, seed, knob_values)
    pred = _predict_sim(seed, knob_values, horizon_ns)

    axes: dict[str, dict] = {
        "util": {
            "predicted_x1e6": pred["util_x1e6"],
            "measured_x1e6": measured_util,
            "rel_err_x1e6": _rel_err_x1e6(pred["util_x1e6"],
                                          measured_util),
        },
        "miss_rate": {
            "predicted_x1e6": pred["stall_share_x1e6"],
            "measured_x1e6": measured_miss,
            "absent": miss_absent,
            "rel_err_x1e6": (0 if miss_absent else
                             _rel_err_x1e6(pred["stall_share_x1e6"],
                                           measured_miss)),
        },
        "tslice_us": {
            "predicted": pred["tslice_us"],
            "measured": replay["steady_us"],
            "rel_err_x1e6": _rel_err_x1e6(pred["tslice_us"],
                                          replay["steady_us"]),
        },
    }
    scored = [a["rel_err_x1e6"] for a in axes.values()
              if not a.get("absent")]
    worst = max(scored) if scored else 0
    fidelity = max(0, _SCALE - worst)
    floor_x1e6 = int(round(float(floor) * _SCALE))
    margin = fidelity - floor_x1e6
    return {
        "v": FIDELITY_SCHEMA_VERSION,
        "seed": int(seed),
        "window": {
            "digest": window.digest(),
            "tier": window.tier,
            "span_ns": window.span_ns(),
            "samples": len(window.samples),
            "dropped": int(window.dropped),
        },
        "replay": replay,
        "axes": axes,
        "worst_rel_err_x1e6": worst,
        "fidelity_x1e6": fidelity,
        "floor_x1e6": floor_x1e6,
        "margin_x1e6": margin,
        "ok": margin >= 0,
    }


def render_report(report: dict) -> str:
    """Human-readable rendering of a fidelity report (``pbst-torch hw
    report``)."""
    lines = [
        f"fidelity report v{report.get('v')}  seed={report.get('seed')}",
        f"  window: tier={report['window']['tier']} "
        f"samples={report['window']['samples']} "
        f"span={report['window']['span_ns'] / 1e6:.1f}ms "
        f"digest={report['window']['digest'][:16]}…",
    ]
    for name, ax in report.get("axes", {}).items():
        pred = ax.get("predicted_x1e6", ax.get("predicted"))
        meas = ax.get("measured_x1e6", ax.get("measured"))
        tag = " (absent — excluded)" if ax.get("absent") else ""
        lines.append(
            f"  {name:>10}: predicted={pred} measured={meas} "
            f"rel_err={ax['rel_err_x1e6'] / _SCALE:.4f}{tag}")
    lines.append(
        f"  fidelity={report['fidelity_x1e6'] / _SCALE:.4f} "
        f"floor={report['floor_x1e6'] / _SCALE:.2f} "
        f"margin={report['margin_x1e6'] / _SCALE:+.4f} "
        f"ok={report['ok']}")
    return "\n".join(lines)
