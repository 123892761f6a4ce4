"""Chaos harness: controller + agents under a seeded FaultPlan.

The ``pbst-torch chaos --plan chaos|rpc|none`` engine — the robustness
twin of ``sim`` (policy behavior under clean conditions): it drives a
real controller and real agents (real sockets, real threads) over the
sim workload catalog while the installed
:class:`~pbs_tpu_torch.faults.plan.FaultPlan` attacks every
instrumented seam, then asserts the end-state invariants that define
"the control plane survived":

- **no job lost** — every controller job record's members exist on the
  agent the controller maps them to;
- **step counters monotonic** — per-member retired steps never decrease
  across rounds (telemetry travels with jobs; faults may stall
  progress, never un-make it);
- **replicas recoverable** — each committed Remus replica restores into
  a scratch partition with the step count it advertised;
- **exactly-once mutations** — per-op server execution counts equal the
  number of ops the controller issued: retries + idempotency dedup
  absorbed every duplicate/drop/reset without re-executing anything;
- **determinism** — same (plan, workload, seed) ⇒ identical fault-trace
  digest (``pbst-torch chaos --selfcheck`` runs the scenario twice).

Design notes for determinism: agents never get declared dead by chance
(``dead_after_missed`` is effectively infinite — injected probe drops
must not turn a placement-invariant run into a recovery run; recovery
under faults has its own tests), and replication pumps use an hour-long
period so the only epochs shipped are the synchronous first ones —
wall-clock-driven background ticks would make stream consultation
counts, and therefore the trace digest, timing-dependent.

The port of ``pbs_tpu.faults.chaos``: the same consultation order, so a
seeded scenario gives the reference's trace digest
(``tests/test_torch_chaos_smoke.py`` pins ``GOLDEN_SMOKE_DIGEST``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from pbs_tpu_torch.faults import injector as faults_mod
from pbs_tpu_torch.faults.plan import FaultPlan
from pbs_tpu_torch.sim.workload import TenantSpec, build_workload


def tenant_spec_dict(t: TenantSpec) -> dict:
    """A workload-catalog tenant as a ``create_job`` wire spec (the
    same SimProfile the simulator executes, now behind the RPC seam)."""
    spec: dict[str, Any] = {
        "phases": [dataclasses.asdict(ph) for ph in t.profile.phases],
        "sched": {
            "weight": t.params.weight,
            "cap": t.params.cap,
            "tslice_us": t.params.tslice_us,
            "boost_on_wake": t.params.boost_on_wake,
        },
    }
    if t.max_steps is not None:
        spec["max_steps"] = t.max_steps
    return spec


#: Mutating ops whose server-side execution counts the harness audits
#: against what the controller actually issued (the exactly-once
#: evidence; ``run`` is excluded — it legitimately repeats).
_AUDITED_OPS = ("create_job", "remove_job", "replicate_start",
                "push_replica")


def run_chaos(workload: str = "mixed", seed: int = 0, n_agents: int = 3,
              n_tenants: int = 4, rounds: int = 5, max_rounds: int = 8,
              plan: FaultPlan | None = None, trace_path: str | None = None,
              replicate: bool = True) -> dict:
    """One seeded chaos scenario; returns the report dict (``ok`` is
    the conjunction of every invariant). Installs the plan process-wide
    for the duration — callers must not have their own plan armed."""
    from pbs_tpu_torch.dist.agent import Agent
    from pbs_tpu_torch.dist.controller import Controller

    plan = plan if plan is not None else FaultPlan.chaos(seed)
    inj = faults_mod.install(plan, trace_path=trace_path)
    agents = []
    ctl = None
    issued = {op: 0 for op in _AUDITED_OPS}
    problems: list[str] = []
    report: dict[str, Any] = {
        "workload": workload, "seed": seed, "agents": n_agents,
        "tenants": n_tenants, "rounds": rounds,
        "plan": plan.as_dict(),
    }
    try:
        agents = [Agent(f"a{i}").start() for i in range(n_agents)]
        # Fault-injected probe drops must never escalate to host death:
        # this scenario asserts placement invariants, and a "dead" host
        # would legitimately move jobs (recovery has dedicated tests).
        ctl = Controller(dead_after_missed=1 << 30)
        for a in agents:
            ctl.add_agent(a.name, a.address)

        tenants = build_workload(workload, seed=seed, n_tenants=n_tenants)
        created: list[str] = []
        create_errors: list[str] = []
        for t in tenants:
            try:
                ctl.create_job(t.name, "sim", tenant_spec_dict(t))
                issued["create_job"] += 1
                created.append(t.name)
            except Exception as e:  # noqa: BLE001 — rolled back by
                create_errors.append(  # create_job; audit skipped below
                    f"{t.name}: {type(e).__name__}: {e}")
        report["created"] = created
        report["create_errors"] = create_errors

        replicated: list[str] = []
        if replicate and n_agents >= 2:
            for name in created:
                try:
                    # Hour-long period: only the synchronous first epoch
                    # ships (determinism note in the module docstring).
                    ctl.enable_replication(name, period_s=3600.0)
                    issued["replicate_start"] += 1
                    issued["push_replica"] += 1  # sync first epoch
                    replicated.append(name)
                except Exception as e:  # noqa: BLE001 — unprotected is
                    problems.append(  # legal, silent would not be
                        f"replication failed for {name}: "
                        f"{type(e).__name__}: {e}")
        report["replicated"] = replicated

        # -- the chaos rounds -------------------------------------------
        steps_seen: dict[str, int] = {}
        round_errors = 0
        telemetry_errors = 0
        for _ in range(rounds):
            ctl.heartbeat()
            ctl.run_round(max_rounds=max_rounds, strict=False)
            round_errors += len(ctl.last_round_errors)
            for name in created:
                try:
                    for member, n in ctl.job_steps(name).items():
                        prev = steps_seen.get(member, 0)
                        if n < prev:
                            problems.append(
                                f"step counter went backwards for "
                                f"{member}: {prev} -> {n}")
                        steps_seen[member] = max(prev, n)
                except Exception:  # noqa: BLE001 — transport gave up;
                    telemetry_errors += 1  # observation skipped, not
                    # an invariant violation (steps re-checked next
                    # round against the same floor)
        report["round_errors"] = round_errors
        report["telemetry_errors"] = telemetry_errors
        report["steps"] = dict(sorted(steps_seen.items()))

        # -- end-state invariants ---------------------------------------
        # (1) No job lost: each member lives where the controller says.
        for name in created:
            rec = ctl.jobs.get(name)
            if rec is None:
                problems.append(f"job record lost: {name}")
                continue
            for m in rec.members:
                h = ctl.agents[m.agent]
                try:
                    present = {j["job"] for j in h.client.call("list_jobs")}
                except Exception as e:  # noqa: BLE001 — end state must
                    problems.append(  # be readable
                        f"list_jobs failed on {m.agent}: "
                        f"{type(e).__name__}: {e}")
                    continue
                if m.job not in present:
                    problems.append(
                        f"job lost: {name}/{m.job} missing on {m.agent}")

        # (2) Replicas recoverable: restore each committed replica into
        # a scratch partition and check it carries its advertised steps.
        scratch = Agent("chaos-scratch")
        try:
            for name in replicated:
                rec = ctl.jobs.get(name)
                if rec is None:
                    continue
                for member, peer in rec.replica_peers.items():
                    try:
                        r = ctl.agents[peer].client.call(
                            "get_replica", job=member, subject=ctl.subject)
                    except Exception as e:  # noqa: BLE001
                        problems.append(
                            f"get_replica({member}) on {peer} failed: "
                            f"{type(e).__name__}: {e}")
                        continue
                    if r is None:
                        problems.append(
                            f"no committed replica for {member} on {peer}")
                        continue
                    want = sum(c["counters"][0] for c in
                               r["saved"].get("contexts", ()))
                    got = scratch.op_restore_job(
                        job=f"restored.{member}", saved=r["saved"])
                    if got["steps"] != want:
                        problems.append(
                            f"replica restore of {member} lost steps: "
                            f"{got['steps']} != {want}")
        finally:
            scratch.server.stop()

        # (3) Exactly-once: server execution counts == ops issued. Only
        # auditable when setup had no failures — a failed create rolls
        # back with remove_job calls this ledger doesn't model (and a
        # partially-failed setup already shows up in the report).
        executed = {op: 0 for op in _AUDITED_OPS}
        for a in agents:
            for op in _AUDITED_OPS:
                executed[op] += a.server.op_executions.get(op, 0)
        audit_ok = not create_errors and not problems
        if audit_ok:
            for op in _AUDITED_OPS:
                if executed[op] != issued[op]:
                    problems.append(
                        f"exactly-once violated for {op}: issued "
                        f"{issued[op]}, executed {executed[op]}")
        report["ops"] = {"issued": issued, "executed": executed,
                         "audited": audit_ok}
        report["idem_hits"] = sum(a.server.idem_hits for a in agents)
        report["client_retries"] = sum(
            h.client.retries + h.probe.retries
            for h in ctl.agents.values())
        report["breakers"] = {h.name: h.breaker
                              for h in ctl.agents.values()}
    finally:
        faults_mod.uninstall()
        if ctl is not None:
            ctl.close()
        for a in agents:
            try:
                a.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    fault_counts: dict[str, int] = {}
    for r in inj.records:
        k = f"{r['point']}:{r['fault']}"
        fault_counts[k] = fault_counts.get(k, 0) + 1
    report["faults_fired"] = dict(sorted(fault_counts.items()))
    report["trace_digest"] = inj.trace_digest()
    if trace_path is not None:
        inj.write_trace()
    report["problems"] = problems
    report["ok"] = not problems
    return report
