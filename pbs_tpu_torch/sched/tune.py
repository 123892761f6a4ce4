"""``pbst-torch tune`` — simulation-driven policy autotuning.

The port of ``pbs_tpu.sched.tune``: the same search spaces, rungs,
scores, frontiers, profiles and check digests. It searches the
feedback/atc policies' hand-picked constants (the tslice band, the
stability-window length, the grow step, the gateway queue-delay
threshold and BOOST trigger) over the sim workload catalog with
**successive halving**: every surviving config re-scores on a longer
horizon with more seeds, losers are culled by a factor of ``eta`` per
rung. Scoring balances the three quantities the reference trades
against each other: Jain fairness (up), p99 runqueue wait (down), and
context-switch overhead (down).

The output is a **tuned profile** per workload class
(``sched/tuned/<workload>.json``) that ``FeedbackPolicy.from_profile``
loads, plus a ``check`` block — a tiny deterministic grid and the
sha256 digest of its per-cell reports and score. ``pbst-torch tune
--check`` replays that grid and fails when the digest no longer
reproduces. The five checked-in profiles are the reference's, copied
byte for byte; their blocks were recorded on the reference's native
sim tier, and the port's native and Python tiers both reproduce their
digests (the tier is provenance only, ``sim.sweep.META_KEYS``). Their bands are the
reference simulator's frontier, none tuned on or for an H100:
``chip_smoke.py``'s phase 3r tunes on a workload built from the card's
own step times and stall fractions (``PERF.md``).

Everything is deterministic by construction: cells seed via sha256
(sim/sweep.py), floats are pre-rounded, ties break on the canonical
param encoding — so the winner and every score digest are byte-stable
across runs AND across worker counts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Sequence

from pbs_tpu_torch.sim.sweep import SweepCell, sweep, sweep_digest
from pbs_tpu_torch.utils.clock import MS

TUNED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tuned")

PROFILE_VERSION = 1

#: Workload classes that get a checked-in profile.
TUNED_WORKLOADS = ("stable", "contended", "phases", "serving", "mixed")

#: Score weights: jain is [0..1]; p99 wait converts at 0.05/ms (a 2 ms
#: tail costs as much as a 0.10 jain drop); switch overhead at 1e-5
#: per switch/s (5k switches/s ≈ 0.05). Chosen so each term moves the
#: score at the same order of magnitude on the catalog.
P99_WEIGHT_PER_MS = 0.05
SWITCH_WEIGHT_PER_S = 1e-5


def score_cell(rep: dict) -> float:
    """Higher is better; 6-decimal rounded so aggregation is stable."""
    s = (rep["jain_fairness"]
         - P99_WEIGHT_PER_MS * (rep["wait_p99_us"] / 1000.0)
         - SWITCH_WEIGHT_PER_S * rep["switches_per_s"])
    return round(s, 6)


def score_reports(reports: Sequence[dict]) -> float:
    """Config score = mean of its cell scores (rounded: determinism)."""
    if not reports:
        return 0.0
    return round(sum(score_cell(r) for r in reports) / len(reports), 6)


# -- search space ------------------------------------------------------------


def _space(bands, windows, grows, qdelays, hots) -> list[dict]:
    return [
        {"min_us": a, "max_us": b, "window": w, "grow_step_us": g,
         "qdelay_threshold_ns": q, "gw_hot_after": h}
        for (a, b) in bands
        for w in windows
        for g in grows
        for q in qdelays
        for h in hots
    ]


#: Full search space per policy. The first entry of every axis is the
#: reference constant, so the default config is always on the frontier
#: and tuning can never regress below it. The queue-delay knobs are
#: searched for profile completeness but are inert under pure-sim
#: scoring (no gateway in the loop) — deterministic tie-breaking parks
#: them on the reference values.
SEARCH_SPACE: dict[str, list[dict]] = {
    "feedback": _space(
        bands=[(100, 1_100), (100, 700), (200, 2_000)],
        windows=[5, 3, 8],
        grows=[100, 50, 200],
        qdelays=[2 * MS, 1 * MS],
        hots=[3],
    ),
    "atc": _space(
        bands=[(300, 30_000), (300, 10_000)],
        windows=[5, 3],
        grows=[100],
        qdelays=[2 * MS],
        hots=[3],
    ),
}

#: Reduced space for --quick (the tier-1/self-test path).
QUICK_SPACE: dict[str, list[dict]] = {
    "feedback": _space(bands=[(100, 1_100), (100, 700)],
                       windows=[5, 3], grows=[100],
                       qdelays=[2 * MS], hots=[3]),
    "atc": _space(bands=[(300, 30_000), (300, 10_000)],
                  windows=[5], grows=[100],
                  qdelays=[2 * MS], hots=[3]),
}


@dataclasses.dataclass(frozen=True)
class Rung:
    horizon_ns: int
    n_reps: int


#: Successive-halving schedule: survivors re-score on longer horizons
#: with more independent seeds.
RUNGS = (Rung(100 * MS, 1), Rung(250 * MS, 2), Rung(500 * MS, 3))
QUICK_RUNGS = (Rung(50 * MS, 1), Rung(100 * MS, 1))

#: Cull factor per rung.
ETA = 3

#: The deterministic grid a profile's `check` block replays — small
#: enough that `pbst-torch tune --check` over every profile stays
#: inside a few seconds.
CHECK_HORIZON_NS = 120 * MS
CHECK_REPS = 2
CHECK_TENANTS = 4


def _cells_for(workload: str, policy: str, params: dict,
               horizon_ns: int, n_reps: int,
               n_tenants: int = CHECK_TENANTS) -> list[SweepCell]:
    return [SweepCell.make(workload, policy, rep=rep, params=params,
                           n_tenants=n_tenants, horizon_ns=horizon_ns)
            for rep in range(n_reps)]


def successive_halving(
    workload: str,
    policy: str = "feedback",
    configs: Sequence[dict] | None = None,
    rungs: Sequence[Rung] = RUNGS,
    base_seed: int = 0,
    workers: int = 1,
    eta: int = ETA,
) -> dict:
    """Run the halving schedule; returns the frontier document:
    ``{"winner": {...}, "rungs": [...], "leaderboard": [...]}``."""
    # Survivors carry their position in the original space: ties break
    # toward the EARLIER config, and the space lists the reference
    # constants first on every axis — so "no measurable difference"
    # resolves to the reference value, never to an arbitrary neighbor.
    survivors = list(enumerate(dict(c) for c in
                               (configs or SEARCH_SPACE[policy])))
    rung_logs = []
    leaderboard: list[tuple[float, int, dict]] = []
    for i, rung in enumerate(rungs):
        cells: list[SweepCell] = []
        spans: list[tuple[int, dict, int, int]] = []
        for pos, cfg in survivors:
            cs = _cells_for(workload, policy, cfg,
                            rung.horizon_ns, rung.n_reps)
            spans.append((pos, cfg, len(cells), len(cells) + len(cs)))
            cells.extend(cs)
        reports = sweep(cells, base_seed=base_seed, workers=workers)
        scored = [(score_reports(reports[lo:hi]), pos, cfg)
                  for pos, cfg, lo, hi in spans]
        scored.sort(key=lambda t: (-t[0], t[1]))
        rung_logs.append({
            "rung": i, "horizon_ns": rung.horizon_ns,
            "n_reps": rung.n_reps, "configs": len(survivors),
            "best_score_x1e6": int(round(scored[0][0] * 1e6)),
        })
        leaderboard = scored
        if i + 1 < len(rungs):
            keep = max(1, math.ceil(len(scored) / eta))
            survivors = [(pos, cfg) for _, pos, cfg in scored[:keep]]
    best_score, _, best_cfg = leaderboard[0]
    return {
        "workload": workload,
        "policy": policy,
        "winner": {"params": best_cfg,
                   "score_x1e6": int(round(best_score * 1e6))},
        "rungs": rung_logs,
        "leaderboard": [
            {"params": cfg, "score_x1e6": int(round(s * 1e6))}
            for s, _, cfg in leaderboard[:10]
        ],
    }


def evaluate_params(workload: str, policy: str,
                    param_sets: Sequence[dict], base_seed: int = 0,
                    workers: int = 1,
                    horizon_ns: int = CHECK_HORIZON_NS,
                    n_reps: int = CHECK_REPS,
                    n_tenants: int = CHECK_TENANTS) -> list[float]:
    """Paired head-to-head scoring: every param set scores on the
    IDENTICAL workload realization (cell seeds derive from the
    workload identity only — ``SweepCell.workload_identity``), so a
    score difference is pure policy signal and an inert difference
    ties exactly. Returns scores in input order; 6-dp rounded like
    every tune score."""
    cells: list[SweepCell] = []
    spans: list[tuple[int, int]] = []
    for params in param_sets:
        cs = _cells_for(workload, policy, dict(params), horizon_ns,
                        n_reps, n_tenants=n_tenants)
        spans.append((len(cells), len(cells) + len(cs)))
        cells.extend(cs)
    reports = sweep(cells, base_seed=base_seed, workers=workers)
    return [score_reports(reports[lo:hi]) for lo, hi in spans]


# -- tuned profiles ----------------------------------------------------------


def check_block(workload: str, policy: str, params: dict,
                base_seed: int = 0, workers: int = 1,
                horizon_ns: int = CHECK_HORIZON_NS,
                n_reps: int = CHECK_REPS,
                n_tenants: int = CHECK_TENANTS,
                native: bool | str | None = None) -> dict:
    """Deterministic re-scoring grid + its digest: what `--check`
    replays. The digest covers every per-cell report AND the score, so
    any behavioral drift in the policy/engine/scoring shows up. The
    grid parameters are recorded in the block so a LATER change to the
    module defaults replays old profiles on THEIR grid, not the new
    one. ``native`` is the sweep's sim-tier request (None = auto: the
    native core where it builds); the port's addition, so one grid can
    be replayed on each tier."""
    cells = _cells_for(workload, policy, params, horizon_ns, n_reps,
                       n_tenants=n_tenants)
    reports = sweep(cells, base_seed=base_seed, workers=workers,
                    native=native)
    score = score_reports(reports)
    h = hashlib.sha256()
    h.update(sweep_digest(reports).encode())
    h.update(f"|score={score:.6f}".encode())
    return {
        "base_seed": base_seed,
        "horizon_ns": horizon_ns,
        "n_reps": n_reps,
        "n_tenants": n_tenants,
        "score_x1e6": int(round(score * 1e6)),
        "digest": h.hexdigest(),
        # Provenance only — which sim tier produced this block (the
        # native core's binding tier when it ran). The digest
        # deliberately excludes it (sweep.META_KEYS): every tier
        # re-verifies the SAME digest, so real drift fails on each.
        "tier": (reports[0].get("native_tier", "python") if reports
                 else "python"),
    }


def profile_path(workload: str, tuned_dir: str | None = None) -> str:
    return os.path.join(tuned_dir or TUNED_DIR, f"{workload}.json")


def load_profile(workload: str, tuned_dir: str | None = None) -> dict:
    with open(profile_path(workload, tuned_dir)) as f:
        prof = json.load(f)
    if prof.get("version") != PROFILE_VERSION:
        raise ValueError(
            f"tuned profile {workload!r}: version "
            f"{prof.get('version')!r} != {PROFILE_VERSION}")
    return prof


def tuned_workloads(tuned_dir: str | None = None) -> list[str]:
    d = tuned_dir or TUNED_DIR
    if not os.path.isdir(d):
        return []
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))


def write_profile(workload: str, frontier: dict, base_seed: int = 0,
                  tuned_dir: str | None = None) -> str:
    """Emit the tuned profile for a workload from a halving frontier
    (atomic write, stable key order — profiles are checked in). The
    ``note`` is the reference's own words, so a profile written by
    either package is byte-identical."""
    prof = {
        "version": PROFILE_VERSION,
        "workload": workload,
        "policy": frontier["policy"],
        "params": frontier["winner"]["params"],
        "score_x1e6": frontier["winner"]["score_x1e6"],
        "rungs": frontier["rungs"],
        "check": check_block(workload, frontier["policy"],
                             frontier["winner"]["params"],
                             base_seed=base_seed),
        "note": ("emitted by `pbst tune --write` (docs/TUNE.md); "
                 "regenerate in the same PR as any change that moves "
                 "the tuned frontier — `pbst tune --check` gates it"),
    }
    path = profile_path(workload, tuned_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(prof, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def check_profile(workload: str, tuned_dir: str | None = None,
                  workers: int = 1,
                  native: bool | str | None = None) -> dict:
    """Replay a profile's check grid; returns the comparison verdict.

    ``ok`` is digest equality — scores are deterministic, so ANY
    mismatch means the policy/engine/scoring behavior changed. The
    score delta says which way: negative = the tuned frontier
    regressed; positive = it improved and the profile is stale — both
    require re-running the search with ``--write``. ``native`` picks
    the sim tier the grid replays on (:func:`check_block`).
    """
    prof = load_profile(workload, tuned_dir)
    chk = prof["check"]
    # THE knob-file load path (knobs/profile.py): map the params onto
    # the registry (validating safe ranges + band pairs), map back,
    # and replay the grid on the round-tripped values. Digest equality
    # therefore ALSO witnesses that loading a profile as a knob file
    # is lossless — a profile outside the declared safe ranges fails
    # here, loudly, before it can reach a live system.
    from pbs_tpu_torch.knobs.profile import roundtrip_params

    params = roundtrip_params(prof["policy"], dict(prof["params"]))
    got = check_block(workload, prof["policy"], params,
                      base_seed=chk["base_seed"], workers=workers,
                      horizon_ns=chk["horizon_ns"],
                      n_reps=chk["n_reps"],
                      n_tenants=chk["n_tenants"], native=native)
    return {
        "workload": workload,
        "policy": prof["policy"],
        "ok": got["digest"] == chk["digest"],
        "expected_digest": chk["digest"],
        "got_digest": got["digest"],
        "expected_score_x1e6": chk["score_x1e6"],
        "got_score_x1e6": got["score_x1e6"],
        "score_delta_x1e6": got["score_x1e6"] - chk["score_x1e6"],
        # Tier provenance: a mismatch here is informational (digests
        # are tier-invariant); "recorded_tier" is absent from profiles
        # written before the native core existed.
        "recorded_tier": chk.get("tier"),
        "verified_tier": got["tier"],
    }


def policy_from_profile(partition, workload: str,
                        tuned_dir: str | None = None):
    """Arm the tuned policy for a workload class on a partition — the
    load path a deployment uses. Routes through the knob registry
    (knobs/profile.py): the profile's params are validated against the
    declared safe ranges exactly like a knob push, so a hand-edited
    profile outside the bands fails at load."""
    from pbs_tpu_torch.knobs.profile import roundtrip_params
    from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy
    from pbs_tpu_torch.sched.feedback import FeedbackPolicy

    prof = load_profile(workload, tuned_dir)
    cls = AtcFeedbackPolicy if prof["policy"] == "atc" else FeedbackPolicy
    params = roundtrip_params(prof["policy"], dict(prof["params"]))
    return cls.from_profile(partition, {"params": params})
