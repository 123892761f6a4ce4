"""Parallel sweep substrate: shared-nothing fan-out over sim grids.

The port of ``pbs_tpu.sim.sweep``: the same cells, seeds, reports and
digests. It evaluates (workload, policy, seed, policy-param-overrides)
grids fast and bit-reproducibly. Three design rules:

- **Shared-nothing cells.** Every cell builds its own ``SimEngine``
  (sweep mode: ``record=False``) from its :class:`SweepCell` spec
  alone. Workers share no state, so a cell's result is a pure function
  of the cell — the same property that makes the single-process and
  N-worker paths interchangeable.
- **sha256-derived per-cell seeds.** A cell's engine seed is derived
  from the canonical cell identity (:func:`cell_seed`), not from a
  shared counter: adding or reordering cells never changes any other
  cell's stream, and distinct cells get independent streams from one
  base seed.
- **Deterministic ordering.** Results always come back in grid order
  regardless of worker count or completion order, and every float in a
  cell report is pre-rounded — ``json.dumps`` of a sweep result is
  byte-stable.

Workers use the ``spawn`` start method: children import only the
torch-free sim stack (a fork of a process whose torch or CUDA state is
initialized would inherit its threads).

Cells ride the native sim core where it builds and the configuration
allows (``SimEngine``'s contract); :func:`native_stamp` says which tier.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Iterable, Sequence

from pbs_tpu_torch.utils.clock import MS

#: Engine-seed space: sha256-derived, truncated to keep seeds readable
#: in reports while leaving collisions ~2^-32 for any realistic grid.
_SEED_BITS = 63


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid point. ``params`` are policy-constructor overrides
    (sorted key/value pairs so the cell is hashable and canonical);
    ``rep`` distinguishes repeat-seed cells of an otherwise identical
    configuration."""

    workload: str
    policy: str
    rep: int = 0
    params: tuple[tuple[str, Any], ...] = ()
    n_tenants: int = 4
    horizon_ns: int = 200 * MS

    @staticmethod
    def make(workload: str, policy: str, rep: int = 0,
             params: dict | None = None, n_tenants: int = 4,
             horizon_ns: int = 200 * MS) -> "SweepCell":
        return SweepCell(
            workload=workload, policy=policy, rep=int(rep),
            params=tuple(sorted((params or {}).items())),
            n_tenants=int(n_tenants), horizon_ns=int(horizon_ns))

    def canonical(self) -> str:
        """The full identity string (report labels, sweep digests)."""
        return json.dumps({
            "workload": self.workload, "policy": self.policy,
            "rep": self.rep, "params": list(self.params),
            "n_tenants": self.n_tenants, "horizon_ns": self.horizon_ns,
        }, sort_keys=True, separators=(",", ":"))

    def workload_identity(self) -> str:
        """The seed-deriving subset: everything that shapes the tenant
        behavior stream, and NOTHING about the policy under test. Two
        cells differing only in (policy, params) replay the identical
        workload realization — paired comparison, so a config
        difference in the scores is policy signal, not noise, and a
        truly inert parameter ties exactly (the tuner's position
        tie-break then keeps the reference constant)."""
        return json.dumps({
            "workload": self.workload, "rep": self.rep,
            "n_tenants": self.n_tenants, "horizon_ns": self.horizon_ns,
        }, sort_keys=True, separators=(",", ":"))


def seed_from_digest(digest_hex: str, salt: int = 0) -> int:
    """Fold an existing sha256 hex digest into the sweep seed space, so
    a search seeded from a recorded window's digest is a pure function
    of the recorded traffic — same window ⇒ same paired realization ⇒
    same winner."""
    return (int(digest_hex[:15], 16) ^ int(salt)) \
        & ((1 << _SEED_BITS) - 1)


def cell_seed(cell: SweepCell, base_seed: int = 0) -> int:
    """Engine seed for a cell: sha256 over (base_seed, the cell's
    workload identity). Stable across processes/platforms (sha256 and
    canonical JSON are); independent across reps/workloads; shared —
    deliberately — across the policies/params competing on the same
    workload realization (see ``SweepCell.workload_identity``)."""
    h = hashlib.sha256(
        f"{int(base_seed)}|{cell.workload_identity()}".encode()).digest()
    return int.from_bytes(h[:8], "big") & ((1 << _SEED_BITS) - 1)


def build_grid(
    workloads: Iterable[str],
    policies: Iterable[str],
    n_reps: int = 1,
    param_sets: Sequence[dict] | None = None,
    n_tenants: int = 4,
    horizon_ns: int = 200 * MS,
) -> list[SweepCell]:
    """Cartesian grid in deterministic order: workload-major, then
    policy, then param set, then rep."""
    cells: list[SweepCell] = []
    for wl in workloads:
        for pol in policies:
            for params in (param_sets or [None]):
                for rep in range(max(1, int(n_reps))):
                    cells.append(SweepCell.make(
                        wl, pol, rep=rep, params=params,
                        n_tenants=n_tenants, horizon_ns=horizon_ns))
    return cells


#: Result-metadata keys stamped by run_cell but kept OUTSIDE the
#: sweep_digest payload: which binding tier executed a cell is host
#: provenance, not behavior — the cross-tier equivalence gate
#: (tests/test_torch_native_sim.py) is what makes stripping it sound,
#: and golden digests (tuned-profile check blocks) verify byte-stably on
#: any tier, with or without a toolchain.
META_KEYS = ("native_tier", "native_available")


def native_stamp() -> dict:
    """The sweep-level native provenance block (``pbst-torch tune``
    reports, ``pbst-torch sim`` output): availability + binding tier of
    the native sim core, with the cached failure reason when it's
    off."""
    from pbs_tpu_torch.sim import native_core

    return native_core.stamp()


def run_cell(cell: SweepCell, base_seed: int = 0,
             native: bool | str | None = None) -> dict:
    """One sweep cell: a sweep-mode (``record=False``) engine run
    reduced to the score-relevant metrics. Every float is pre-rounded,
    so the report is byte-stable under ``json.dumps``. ``native``
    follows the SimEngine contract (None = auto: ride the C dispatch
    core when available, Python witness otherwise); the tier that
    actually ran is stamped into the report's ``META_KEYS``."""
    from pbs_tpu_torch.sim.engine import SimEngine

    seed = cell_seed(cell, base_seed)
    eng = SimEngine(
        workload=cell.workload, policy=cell.policy, seed=seed,
        n_tenants=cell.n_tenants, horizon_ns=cell.horizon_ns,
        record=False, policy_params=dict(cell.params) or None,
        native=native,
    )
    r = eng.run()
    switches_per_s = r["switches"] * 1e9 / max(1, r["elapsed_ns"])
    return {
        "cell": cell.canonical(),
        "seed": seed,
        "jain_fairness": r["jain_fairness"],
        "wait_p50_us": r["wait_p50_us"],
        "wait_p99_us": r["wait_p99_us"],
        "switches": r["switches"],
        "switches_per_s": round(switches_per_s, 2),
        "quanta": r["quanta"],
        "utilization": r["utilization"],
        "elapsed_ns": r["elapsed_ns"],
        "native_tier": eng.native_tier_used or "python",
        "native_available": eng.native_tier_used is not None,
    }


def _run_cell_star(args: tuple[SweepCell, int, "bool | str | None"]) -> dict:
    return run_cell(args[0], args[1], native=args[2])


def sweep(cells: Sequence[SweepCell], base_seed: int = 0,
          workers: int = 1, native: bool | str | None = None) -> list[dict]:
    """Run every cell; results in grid order regardless of worker
    count. ``workers <= 1`` runs inline (no pool, no spawn cost — the
    tune-check path); larger fans out over a spawn-context
    ``multiprocessing.Pool``."""
    cells = list(cells)
    if workers <= 1 or len(cells) <= 1:
        return [run_cell(c, base_seed, native=native) for c in cells]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(min(workers, len(cells))) as pool:
        # pool.map preserves input order — completion order is free to
        # race, the result list is not.
        return pool.map(_run_cell_star,
                        [(c, base_seed, native) for c in cells])


def sweep_digest(reports: Sequence[dict]) -> str:
    """sha256 over the canonical report stream — the determinism
    witness a sweep prints next to its results (same grid + same base
    seed ⇒ same digest, on any worker count and any sim tier:
    ``META_KEYS`` provenance is excluded from the hashed payload)."""
    h = hashlib.sha256()
    for rep in reports:
        payload = {k: v for k, v in rep.items() if k not in META_KEYS}
        h.update(json.dumps(payload, sort_keys=True,
                            separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


def simulated_per_wall(reports: Sequence[dict], wall_ns: int) -> float:
    """The headline number: simulated-ns per wall-ns across a sweep
    (sum of cell horizons over the wall clock that produced them)."""
    sim_ns = sum(r["elapsed_ns"] for r in reports)
    return round(sim_ns / max(1, wall_ns), 2)
