"""Synthetic tenant workload catalog for the scheduler simulator.

The port of ``pbs_tpu.sim.workload``: the same generators, seeds and
draw order, so a build equals the reference's tenant for tenant.

Each generator emits a :class:`TenantSpec` — a name, a ``SimProfile``
(the same phase description ``telemetry.source.SimBackend`` executes for
every policy test), scheduling parameters, and an optional arrival
schedule (sleep/wake points for bursty serving traffic). All randomness
is drawn from per-tenant ``np.random.Generator`` instances seeded from
the engine seed, so a workload build is a pure function of
``(name, seed, n_tenants, horizon_ns)``.

Catalog (the mixes the harness sweeps):

- ``stable``    — HBM-stall-heavy steady tenants: the feedback policy
                  must grow every slice toward the 1.1 ms cap.
- ``contended`` — collective-contended, compute-bound tenants that start
                  with a fat 900 µs slice: feedback must shrink toward
                  the 100 µs floor, and p99 wait must beat plain credit.
- ``phases``    — tenants alternating memory-bound and compute-bound
                  phases of randomized length (the reference's
                  cache-friendly/cache-thrashing guest).
- ``serving``   — one always-on training tenant plus bursty
                  wake/sleep serving tenants (boost-on-wake path).
- ``mixed``     — round-robin over all four tenant types.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from pbs_tpu_torch.runtime.job import SchedParams
from pbs_tpu_torch.telemetry.source import SimPhase, SimProfile
from pbs_tpu_torch.utils.clock import MS, SEC


@dataclasses.dataclass
class TenantSpec:
    """One simulated tenant: who it is, how it behaves, when it's awake."""

    name: str
    profile: SimProfile
    params: SchedParams
    max_steps: int | None = None
    # [(t_ns, awake)] state flips relative to sim start; None = always on.
    arrival: list[tuple[int, bool]] | None = None
    # Serving-gateway SLO class ("interactive" | "batch"): which front
    # door queue this tenant's requests ride (pbs_tpu_torch.gateway).
    # Batch by default; latency-sensitive generators override.
    slo: str = "batch"
    # End-to-end latency target the SLO burn-rate report measures this
    # tenant against (pbs_tpu_torch.obs.spans). None = the class
    # default (DEFAULT_SLO_TARGET_NS).
    slo_target_ns: int | None = None


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(salt)])


# -- tenant generators ------------------------------------------------------


def compute_bound(i: int, rng: np.random.Generator) -> TenantSpec:
    """Steady compute phase: low stall, light contention."""
    return TenantSpec(
        name=f"compute{i}",
        profile=SimProfile.steady(
            step_time_ns=int(rng.integers(80, 120)) * 1000,
            stall_frac=0.02,
            collective_wait_ns=500,
            jitter=0.05,
        ),
        params=SchedParams(weight=256, tslice_us=300),
        slo="interactive",  # short-step latency tenant at the gateway
    )


def hbm_stall_heavy(i: int, rng: np.random.Generator) -> TenantSpec:
    """Memory-bound steady phase: stall ≥ 10% of device time, so the
    feedback threshold (stall_rate ≥ 100) reads LOW_PHASE → grow."""
    return TenantSpec(
        name=f"hbm{i}",
        profile=SimProfile.steady(
            step_time_ns=int(rng.integers(120, 180)) * 1000,
            stall_frac=float(rng.uniform(0.45, 0.6)),
            collective_wait_ns=2_000,
            jitter=0.05,
        ),
        params=SchedParams(weight=256, tslice_us=200),
    )


def collective_contended(i: int, rng: np.random.Generator) -> TenantSpec:
    """Compute-bound with heavy but steady collective waits: the stable
    HIGH_PHASE that must shrink the slice to bound co-tenant latency.
    Starts with a deliberately fat slice so the shrink is observable."""
    return TenantSpec(
        name=f"coll{i}",
        profile=SimProfile.steady(
            step_time_ns=int(rng.integers(40, 60)) * 1000,
            stall_frac=0.03,
            collective_wait_ns=int(rng.integers(15, 25)) * 1000,
            jitter=0.05,
        ),
        params=SchedParams(weight=256, tslice_us=900),
    )


def phase_alternating(i: int, rng: np.random.Generator) -> TenantSpec:
    """Alternating memory-bound / compute-bound phases of random length
    (500–1500 steps), ending in a steady compute tail."""
    phases: list[SimPhase] = []
    for k in range(8):
        memory = k % 2 == 0
        phases.append(SimPhase(
            steps=int(rng.integers(500, 1500)),
            step_time_ns=100_000,
            stall_frac=0.5 if memory else 0.02,
            collective_wait_ns=1_000,
            jitter=0.05,
        ))
    phases.append(SimPhase(steps=-1, step_time_ns=100_000,
                           stall_frac=0.02, collective_wait_ns=1_000))
    return TenantSpec(
        name=f"alt{i}",
        profile=SimProfile(phases),
        params=SchedParams(weight=256, tslice_us=400),
    )


def bursty_serving(i: int, rng: np.random.Generator,
                   horizon_ns: int) -> TenantSpec:
    """Short-step serving tenant with exponential on/off bursts: arrives
    (wakes), serves a burst, idles (sleeps) — exercising the wake-boost
    path under every policy."""
    arrival: list[tuple[int, bool]] = []
    t = int(rng.exponential(10 * MS))
    awake = True
    while True:
        # The first wake is emitted even when it lands past the horizon:
        # a tenant whose first burst never arrives must stay asleep, not
        # degrade into an always-on competitor (the engine pre-sleeps
        # only when a wake flip exists).
        arrival.append((t, awake))
        if t >= horizon_ns:
            break
        mean = 20 * MS if awake else 30 * MS
        t += max(1 * MS, int(rng.exponential(mean)))
        awake = not awake
    return TenantSpec(
        name=f"serve{i}",
        profile=SimProfile.steady(
            step_time_ns=int(rng.integers(15, 25)) * 1000,
            stall_frac=0.01,
            collective_wait_ns=200,
            jitter=0.1,
        ),
        params=SchedParams(weight=128, tslice_us=100, boost_on_wake=True),
        arrival=arrival,
        slo="interactive",  # the gateway's TTFT-protected class
    )


# -- mixes ------------------------------------------------------------------

#: Tenant-generator vocabulary of :func:`make_mix` — the kind names a
#: mix (or a scenario genome) composes tenants from. ``serve`` is the
#: only generator that consumes the horizon (its wake/sleep schedule
#: must cover the run).
TENANT_KINDS = ("hbm", "coll", "compute", "alt", "serve")

_MAKERS = {
    "hbm": hbm_stall_heavy,
    "coll": collective_contended,
    "compute": compute_bound,
    "alt": phase_alternating,
}


def make_mix(kinds, seed: int, horizon_ns: int) -> list[TenantSpec]:
    """THE parameterized mix constructor: one tenant per entry of
    ``kinds`` (each a :data:`TENANT_KINDS` name), tenant ``i`` seeded
    from ``_rng(seed, i)`` exactly like the hand-written catalog always
    did. The catalog mixes below and registered workloads (the
    reference's scenario genomes) build through here, so a generator
    tweak moves every consumer together instead of forking two
    diverging copies."""
    out: list[TenantSpec] = []
    for i, kind in enumerate(kinds):
        if kind == "serve":
            out.append(bursty_serving(i, _rng(seed, i), horizon_ns))
        else:
            try:
                maker = _MAKERS[kind]
            except KeyError:
                raise KeyError(
                    f"unknown tenant kind {kind!r}; "
                    f"available: {list(TENANT_KINDS)}") from None
            out.append(maker(i, _rng(seed, i)))
    return out


def _mix_stable(seed, n, horizon_ns):
    return make_mix(["hbm"] * n, seed, horizon_ns)


def _mix_contended(seed, n, horizon_ns):
    return make_mix(["coll"] * n, seed, horizon_ns)


def _mix_phases(seed, n, horizon_ns):
    return make_mix(["alt"] * n, seed, horizon_ns)


def _mix_serving(seed, n, horizon_ns):
    # The always-on trainer keeps the partition busy between bursts so
    # the run loop never drains (and it is the victim whose quanta the
    # serving tenants' wake latency depends on).
    return make_mix(["hbm"] + ["serve"] * (max(2, n) - 1),
                    seed, horizon_ns)


def _mix_mixed(seed, n, horizon_ns):
    cycle = ("hbm", "coll", "compute", "alt")
    return make_mix([cycle[i % len(cycle)] for i in range(n)],
                    seed, horizon_ns)


WORKLOADS = {
    "stable": _mix_stable,
    "contended": _mix_contended,
    "phases": _mix_phases,
    "serving": _mix_serving,
    "mixed": _mix_mixed,
}

#: Dynamically registered workload builders (scenario genomes, test
#: rigs). Deliberately NOT part of :func:`workload_names` — the
#: catalog is the stable sweep/parametrization surface; registered
#: workloads are transient, process-local bridges into the harnesses.
_DYNAMIC: dict[str, Any] = {}


def register_workload(name: str, builder) -> str:
    """Register a transient workload builder (signature
    ``builder(seed, n_tenants, horizon_ns) -> list[TenantSpec]``) so
    the sim engine and chaos harnesses can run it by name. Catalog
    names are reserved; re-registering the same name replaces it
    (a genome's name embeds its content digest, so a replacement is
    byte-identical by construction). Returns the name."""
    if name in WORKLOADS:
        raise KeyError(f"workload {name!r} is a catalog mix; "
                       "registered workloads must not shadow it")
    _DYNAMIC[name] = builder
    return name


def unregister_workload(name: str) -> None:
    _DYNAMIC.pop(name, None)


def workload_names() -> list[str]:
    return sorted(WORKLOADS)


def build_workload(name: str, seed: int = 0, n_tenants: int = 4,
                   horizon_ns: int = 2 * SEC) -> list[TenantSpec]:
    mix = WORKLOADS.get(name)
    if mix is None:
        mix = _DYNAMIC.get(name)
    if mix is None:
        raise KeyError(
            f"unknown workload {name!r}; available: {workload_names()} "
            f"(+{len(_DYNAMIC)} registered)")
    return mix(seed, max(1, int(n_tenants)), int(horizon_ns))
