"""Policy-comparison harness: same workload, same seed, every policy.

The port of ``pbs_tpu.sim.harness``, report for report.

The offline regression gate for scheduling PRs: run the identical
(workload, seed) through each policy and put the numbers that matter
side by side — Jain fairness over per-tenant device time, p50/p99
runqueue wait, context switches, adapted-quantum range, and the trace
digest (the determinism witness). ``pbst-torch sim --policy all`` is a
thin wrapper over :func:`compare`.
"""

from __future__ import annotations

from pbs_tpu_torch.sim.engine import POLICIES, SimEngine
from pbs_tpu_torch.utils.clock import SEC

# Derived from the adapter table so a newly registered policy is
# automatically inside the regression gate.
DEFAULT_POLICIES = tuple(POLICIES)

#: Policies the native dispatch core implements — the sweep-hot
#: subset. compare() resolves a table-wide ``native`` request per policy
#: against this list, so ``pbst-torch sim --policy all --native``
#: accelerates the hot rows instead of refusing the whole table over
#: credit2/sedf/arinc653.
NATIVE_POLICIES = ("credit", "feedback", "atc")


def run_policy(
    workload: str,
    policy: str,
    seed: int = 0,
    n_tenants: int = 4,
    n_executors: int = 1,
    horizon_ns: int = 2 * SEC,
    trace_path: str | None = None,
    keep_lines: bool = True,
    native: bool | str | None = None,
) -> dict:
    """One simulated run; returns the engine's metrics report.
    ``keep_lines=False`` streams the trace (digest + optional file only)
    to bound memory on long horizons. ``native`` follows the SimEngine
    contract; the tier that ran is stamped into
    the report as ``native_tier`` — provenance the trace digest
    deliberately does not cover."""
    eng = SimEngine(
        workload=workload, policy=policy, seed=seed, n_tenants=n_tenants,
        n_executors=n_executors, horizon_ns=horizon_ns,
        trace_path=trace_path, keep_lines=keep_lines, native=native)
    report = eng.run()
    report["native_tier"] = eng.native_tier_used or "python"
    return report


def compare(
    workload: str,
    policies=DEFAULT_POLICIES,
    seed: int = 0,
    n_tenants: int = 4,
    n_executors: int = 1,
    horizon_ns: int = 2 * SEC,
    trace_prefix: str | None = None,
    native: bool | str | None = None,
) -> dict:
    """Run every policy against the identical workload build.

    ``trace_prefix`` writes one JSONL per policy to
    ``<prefix>.<policy>.jsonl``. A truthy ``native`` applies to the
    policies the C core implements (``NATIVE_POLICIES``); the rest run
    the witness engine — their reports are what they always were, and
    the hot rows' digests are tier-invariant by the equivalence gate.
    """
    return {
        "workload": workload,
        "seed": seed,
        "n_tenants": n_tenants,
        "n_executors": n_executors,
        "horizon_ns": horizon_ns,
        "policies": {
            p: run_policy(
                workload, p, seed=seed, n_tenants=n_tenants,
                n_executors=n_executors, horizon_ns=horizon_ns,
                trace_path=(f"{trace_prefix}.{p}.jsonl"
                            if trace_prefix else None),
                native=(native if native is None or not native
                        or p in NATIVE_POLICIES else False))
            for p in policies
        },
    }


def _tslice_range(report: dict) -> str:
    los, his = [], []
    for t in report["tenants"].values():
        qs = [q for _, q in t["quantum_timeline_us"]] or [t["tslice_us"]]
        los.append(min(qs))
        his.append(max(qs))
    if not los:
        return "-"
    return f"{min(los)}-{max(his)}"


def format_report(cmp: dict) -> str:
    """Aligned text table over a :func:`compare` result."""
    lines = [
        f"workload={cmp['workload']} seed={cmp['seed']} "
        f"tenants={cmp['n_tenants']} "
        f"horizon_ms={cmp['horizon_ns'] // 1_000_000}",
        f"{'policy':<10} {'jain':>6} {'p50_us':>8} {'p99_us':>9} "
        f"{'switches':>8} {'quanta':>8} {'util':>6} {'q_us':>11} "
        f"{'digest':<12}",
    ]
    for name, r in cmp["policies"].items():
        lines.append(
            f"{name:<10} {r['jain_fairness']:>6.3f} {r['wait_p50_us']:>8.1f} "
            f"{r['wait_p99_us']:>9.1f} {r['switches']:>8} {r['quanta']:>8} "
            f"{r['utilization']:>6.2f} {_tslice_range(r):>11} "
            f"{r.get('trace_digest', '')[:12]:<12}")
    return "\n".join(lines)
