"""Stress scorer: how hard a scenario genome leans on the invariants.

The port of ``pbs_tpu.scenarios.score``: the same axes, rounding and
gate, so a genome scores and replays at the reference's digests.

One candidate evaluation runs the genome through THREE harnesses
("Fake Runs, Real Fixes", PAPERS.md — thousands of simulated
tenant-hours hunting defects before production traffic does):

- the **sim** harness (``sim/sweep.run_cell``; native C dispatch core
  when the toolchain is present, the Python witness otherwise — the
  usual tier contract, digests tier-invariant) → Jain fairness
  collapse under the scheduler;
- the **gateway** harness (``run_gateway_chaos`` with the genome's
  arrival shape and admission faults) → shed asymmetry at one front
  door;
- the **federation** harness (``run_federation_chaos`` with the
  genome's arrival shape AND its fault plan) → SLO burn, lease-audit
  slack, span-gap proximity, plus the run's golden
  ``trace_digest``/``report_digest`` pair.

The axes are normalized to [0, 1], weighted by the ``scenarios.score.*``
registry knobs into one stress score, and discretized into a behavior
signature (the hunt archive's MAP-Elites key). Everything is rounded
before aggregation, so a stress report — and the archive built from
it — is byte-stable across runs, hosts, and worker counts.

The **invariant gate** (:func:`gate`) is what stands between a
frontier candidate and the archive: the federation leg re-runs and
must (a) hold every chaos invariant (no-job-lost, the piecewise mint
bound, span continuity — ``report["ok"]``) and (b) reproduce the
recorded digests exactly (same-seed-same-digest). A candidate whose
own replay drifts is rejected — an unreproducible pathology is not a
regression test.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from pbs_tpu_torch.scenarios.genome import Genome, derive_seed
from pbs_tpu_torch.utils.clock import MS

_ROUND = 6

#: Axis order everywhere (signature strings, weights, reports).
AXES = ("burn", "fairness", "slack", "gap", "shed")


@dataclasses.dataclass(frozen=True)
class StressConfig:
    """Harness shape one evaluation runs under — part of every corpus
    entry, so a promoted scenario replays on ITS grid, not whatever
    the module defaults became later."""

    base_seed: int = 0
    ticks: int = 240
    tick_ns: int = 1 * MS
    n_gateways: int = 3
    backends_per_gateway: int = 2
    gw_ticks: int = 160
    gw_backends: int = 3
    sim_policy: str = "feedback"
    sim_horizon_ns: int = 100 * MS

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StressConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown stress-config keys {unknown}")
        return cls(**d)

    @classmethod
    def demo(cls, base_seed: int = 0) -> "StressConfig":
        """The tier-1 smoke shape (`pbst-torch scenarios hunt --demo`):
        small enough that a whole hunt fits the 5 s budget on a
        loaded 1-vCPU host."""
        return cls(base_seed=base_seed, ticks=120, gw_ticks=80,
                   sim_horizon_ns=40 * MS)


def eval_seed(genome: Genome, cfg: StressConfig) -> int:
    """The evaluation seed: a pure function of (genome, base seed) —
    the same genome always replays the same realization, which is
    what makes archive entries and corpus goldens reproducible."""
    return derive_seed("eval", genome.digest(), cfg.base_seed)


def _norm(x: float) -> float:
    """Unbounded-ratio squash into [0, 1): x/(1+x)."""
    x = max(0.0, float(x))
    return round(x / (1.0 + x), _ROUND)


def _federation_axes(rep: dict) -> dict[str, float]:
    burn = 0.0
    for t in rep["slo"]["tenants"].values():
        burn = max(burn, float(t["burn_rate"]))
    leased = conservative = 0.0
    for a in rep["lease_audit"].values():
        leased += float(a["leased_spent"])
        conservative += float(a["conservative_spent"])
    slack = conservative / max(1.0, leased + conservative)
    transfers = int(rep["spans"]["handoff_events"])
    for t in rep["slo"]["tenants"].values():
        transfers += int(t["requeues"])
    gap = transfers / max(1, int(rep["stats"]["admitted"]))
    return {
        "burn": _norm(burn),
        "slack": round(min(1.0, slack), _ROUND),
        "gap": _norm(gap),
    }


def resolve_scoring() -> dict:
    """Snapshot the ``scenarios.score.w_*`` weights and the signature
    bucket count from the knob registry IN THIS PROCESS. ``evaluate``
    takes the snapshot as an argument so ``evaluate_many`` can resolve
    it once in the parent and ship it to spawn workers — a process-
    local knob overlay (``knobs.set_local``) would otherwise be
    invisible to fresh worker processes and break the 1-vs-N
    worker-count digest parity the hunt pins."""
    from pbs_tpu_torch import knobs

    return {
        "weights": {a: float(knobs.get(f"scenarios.score.w_{a}"))
                    for a in AXES},
        "buckets": int(knobs.get("scenarios.hunt.archive_buckets")),
    }


def evaluate(genome: Genome, cfg: StressConfig,
             scoring: dict | None = None) -> dict:
    """One full candidate evaluation → the canonical stress report
    (axes, weighted score, behavior signature, per-harness summaries,
    and the federation run's golden digests). Pure function of
    (genome, cfg, scoring); every float pre-rounded. ``scoring=None``
    resolves :func:`resolve_scoring` in-process."""
    from pbs_tpu_torch.gateway.chaos import (
        run_federation_chaos,
        run_gateway_chaos,
    )
    from pbs_tpu_torch.sim.sweep import SweepCell, run_cell
    from pbs_tpu_torch.sim.workload import unregister_workload

    seed = eval_seed(genome, cfg)
    n_tenants = int(genome["n_tenants"])
    name = genome.register()
    try:
        sim_rep = run_cell(
            SweepCell.make(name, cfg.sim_policy, rep=0,
                           n_tenants=n_tenants,
                           horizon_ns=cfg.sim_horizon_ns),
            base_seed=cfg.base_seed)

        gw_tenants = genome.build_tenants(seed, n_tenants,
                                          cfg.gw_ticks * cfg.tick_ns)
        gw_model = genome.arrival_model(gw_tenants, cfg.gw_ticks, seed,
                                        n_gateways=1)
        gw_rep = run_gateway_chaos(
            workload=name, seed=seed, n_backends=cfg.gw_backends,
            n_tenants=n_tenants, ticks=cfg.gw_ticks,
            tick_ns=cfg.tick_ns, plan=genome.gateway_fault_plan(seed),
            arrival_model=gw_model)

        fed_tenants = genome.build_tenants(seed, n_tenants,
                                           cfg.ticks * cfg.tick_ns)
        fed_model = genome.arrival_model(fed_tenants, cfg.ticks, seed,
                                         n_gateways=cfg.n_gateways)
        fed_rep = run_federation_chaos(
            workload=name, seed=seed, n_gateways=cfg.n_gateways,
            backends_per_gateway=cfg.backends_per_gateway,
            n_tenants=n_tenants, ticks=cfg.ticks, tick_ns=cfg.tick_ns,
            plan=genome.fault_plan(seed), arrival_model=fed_model,
            # Crash genes -> journal-recovered kill-9s; None (both
            # genes zero) arms no journal and keeps the recorded
            # goldens byte-identical (docs/DURABILITY.md).
            crash_plan=genome.crash_plan(cfg.ticks))
    finally:
        unregister_workload(name)

    axes = {
        "fairness": round(
            max(0.0, 1.0 - float(sim_rep["jain_fairness"])), _ROUND),
        "shed": round(gw_model.shed_asymmetry(), _ROUND),
        **_federation_axes(fed_rep),
    }
    scoring = scoring or resolve_scoring()
    weights = scoring["weights"]
    buckets = int(scoring["buckets"])
    score = round(sum(weights[a] * axes[a] for a in AXES), _ROUND)
    signature = "-".join(
        str(min(buckets - 1, int(axes[a] * buckets))) for a in AXES)
    return {
        "genome": genome.as_dict(),
        "seed": seed,
        "axes": {a: axes[a] for a in AXES},
        "score": score,
        "signature": signature,
        "ok": bool(sim_rep is not None and gw_rep["ok"]
                   and fed_rep["ok"]),
        "problems": list(gw_rep["problems"]) + list(fed_rep["problems"]),
        "sim": {
            "jain_fairness": sim_rep["jain_fairness"],
            "wait_p99_us": sim_rep["wait_p99_us"],
            "switches_per_s": sim_rep["switches_per_s"],
        },
        "gateway": {
            "admitted": gw_rep["stats"]["admitted"],
            "shed": gw_rep["stats"]["shed"],
            "trace_digest": gw_rep["trace_digest"],
        },
        "federation": {
            "admitted": fed_rep["stats"]["admitted"],
            "completed": fed_rep["stats"]["completed"],
            "handoffs": fed_rep["stats"]["handoffs"],
            "lease_refusals": fed_rep["stats"]["lease_refusals"],
            "worst_burn": max(
                [float(t["burn_rate"])
                 for t in fed_rep["slo"]["tenants"].values()] or [0.0]),
        },
        "golden": {
            "trace_digest": fed_rep["trace_digest"],
            "report_digest": fed_rep["report_digest"],
        },
    }


def run_gate(genome: Genome, cfg: StressConfig,
             expect: dict | None = None) -> dict:
    """THE chaos invariant gate: re-run the federation leg and demand
    (a) every invariant held (no-job-lost, mint bound, span
    continuity) and (b) — when ``expect`` carries recorded digests —
    byte-identical replay (same-seed-same-digest). Used both at
    archive admission (hunt.py) and at corpus replay
    (``pbst-torch scenarios replay --check``)."""
    from pbs_tpu_torch.gateway.chaos import run_federation_chaos
    from pbs_tpu_torch.sim.workload import unregister_workload

    seed = eval_seed(genome, cfg)
    n_tenants = int(genome["n_tenants"])
    name = genome.register()
    try:
        tenants = genome.build_tenants(seed, n_tenants,
                                       cfg.ticks * cfg.tick_ns)
        model = genome.arrival_model(tenants, cfg.ticks, seed,
                                     n_gateways=cfg.n_gateways)
        rep = run_federation_chaos(
            workload=name, seed=seed, n_gateways=cfg.n_gateways,
            backends_per_gateway=cfg.backends_per_gateway,
            n_tenants=n_tenants, ticks=cfg.ticks, tick_ns=cfg.tick_ns,
            plan=genome.fault_plan(seed), arrival_model=model,
            crash_plan=genome.crash_plan(cfg.ticks))
    finally:
        unregister_workload(name)
    problems = list(rep["problems"])
    if expect is not None:
        for key in ("trace_digest", "report_digest"):
            if rep[key] != expect[key]:
                problems.append(
                    f"{key} drift: recorded {expect[key][:16]}… "
                    f"replayed {rep[key][:16]}… — the scenario is not "
                    "reproducible at this tree")
    return {
        "ok": not problems,
        "problems": problems,
        "trace_digest": rep["trace_digest"],
        "report_digest": rep["report_digest"],
        "admitted": rep["stats"]["admitted"],
        "completed": rep["stats"]["completed"],
    }


def _evaluate_star(payload: tuple[dict, dict, dict]) -> dict:
    genome_d, cfg_d, scoring = payload
    return evaluate(Genome.from_dict(genome_d),
                    StressConfig.from_dict(cfg_d), scoring=scoring)


def evaluate_many(genomes, cfg: StressConfig,
                  workers: int = 1) -> list[dict]:
    """Evaluate a population; results in input order on ANY worker
    count (the sweep substrate's rule — pool.map preserves order, and
    every evaluation is shared-nothing: each worker registers the
    genome's workload in its own process). The scoring knobs are
    resolved HERE, in the parent, and shipped to workers — see
    :func:`resolve_scoring`."""
    genomes = list(genomes)
    scoring = resolve_scoring()
    if workers <= 1 or len(genomes) <= 1:
        return [evaluate(g, cfg, scoring=scoring) for g in genomes]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    payloads = [(g.as_dict(), cfg.as_dict(), scoring)
                for g in genomes]
    with ctx.Pool(min(workers, len(genomes))) as pool:
        return pool.map(_evaluate_star, payloads)
