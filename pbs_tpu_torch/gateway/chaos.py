"""Gateway chaos harnesses: the front door (and the front-door TIER)
under a seeded FaultPlan.

The port of ``pbs_tpu.gateway.chaos``: the same arrival streams, fault
consultations, schedules and books, so a seeded run gives the
reference's report and golden digests (``tests/test_torch_gateway_chaos.py``,
``tests/test_torch_federation.py``, ``tests/test_torch_recovery.py``).

``run_gateway_chaos`` is the ``pbst-torch chaos --plan gateway``
engine: the attack surface is the front door itself — injected
admission sheds, stalled admissions and misroutes, plus a deterministic
backend kill mid-run. ``run_federation_chaos`` is the ``--plan
federation`` engine: N gateways behind consistent-hash placement with
leased admission (gateway/federation.py), attacked with gateway DEATH,
partitions and lease expiries from the plan plus a seeded drain +
rejoin schedule, and, under ``crash_plan`` (``--plan crash``), kill-9s
of the whole process state recovered from the write-ahead journal
alone. Everything runs on a :class:`VirtualClock` with seeded arrivals,
so each run — and therefore its fault-trace digest — is a pure function
of ``(workload, seed, plan, shape)``.

The invariants these harnesses exist to gate (docs/GATEWAY.md):

- **no admitted request lost** — at every point, ``admitted ==
  completed + queued + inflight``; after the drain phase with a live
  backend (federation: a live gateway) remaining, ``admitted ==
  completed`` exactly. Sheds are only ever explicit (retry-after
  attached) and only at admission.
- **no rate inflation** (federation) — per tenant, every admitted cost
  unit is token-backed, so spraying N gateways never yields N× the
  global rate.
- **determinism** — same seed ⇒ same digest AND same books.

``process_mode=True`` delegates to the process federation's harness
(``procfed.run_process_chaos``). ``autopilot=`` arms the closed tuning
loop (``pbs_tpu_torch.autopilot``) over the federation and gates its
rollback.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np

from pbs_tpu_torch.faults import injector as faults_mod
from pbs_tpu_torch.faults.plan import FaultPlan, FaultSpec
from pbs_tpu_torch.gateway.admission import INTERACTIVE, TenantQuota
from pbs_tpu_torch.gateway.backends import SimServeBackend
from pbs_tpu_torch.gateway.federation import FederatedGateway
from pbs_tpu_torch.gateway.gateway import Gateway
from pbs_tpu_torch.gateway.journal import (
    GatewayJournal,
    JournalError,
    ProcessKill,
    read_journal,
)
from pbs_tpu_torch.obs.spans import SpanAssembler, SpanRecorder
from pbs_tpu_torch.sim.workload import build_workload
from pbs_tpu_torch.utils.clock import MS, SEC, VirtualClock


def quota_for(tenant_name: str, slo: str, weight: int) -> TenantQuota:
    """Admission contract derived from a workload-catalog tenant:
    interactive tenants get high rate / small burst (latency traffic),
    batch tenants lower rate / big burst (throughput traffic)."""
    if slo == INTERACTIVE:
        return TenantQuota(rate=600.0, burst=60.0, weight=weight,
                           slo=slo, max_queued=64)
    return TenantQuota(rate=300.0, burst=120.0, weight=weight,
                       slo=slo, max_queued=128)


def catalog_arrivals(tenants, seed: int, tag: int) -> dict:
    """One independent seeded arrival stream per catalog tenant
    (``tag`` separates the harnesses' stream families)."""
    return {t.name: np.random.default_rng([int(seed), int(tag), i])
            for i, t in enumerate(tenants)}


def draw_arrival(t, rng) -> tuple[bool, int]:
    """This tick's (fire, cost) for one tenant — the shared arrival
    model both chaos harnesses pin goldens on (interactive: frequent
    small requests; batch: rare big ones). Draw ORDER is part of the
    determinism contract: the cost is drawn whether or not it fires."""
    u = float(rng.random())
    if t.slo == INTERACTIVE:
        return u < 0.35, 1 + int(rng.integers(0, 3))
    return u < 0.15, 4 + int(rng.integers(0, 9))


class ArrivalModel:
    """Pluggable per-tick arrival shape for the chaos harnesses
    (``arrival_model=``). The default (None) is :func:`draw_arrival`,
    byte-identical to the pre-hook harnesses; a custom model (the
    reference's scenario-genome traffic shapes) owns its
    tenants' rng streams and MUST consume a fixed number of draws per
    ``draw`` call so its decision stream is a pure function of the
    seed. ``note_result`` closes the loop for reactive shapes (retry
    storms re-submitting after a shed)."""

    def draw(self, t, tick: int, rng) -> tuple[bool, int]:
        return draw_arrival(t, rng)

    def note_result(self, tenant: str, tick: int,
                    admitted: bool) -> None:
        pass


def _tenant_slo_info(tenants) -> dict:
    return {t.name: {"slo": t.slo, "slo_target_ns": t.slo_target_ns}
            for t in tenants}


def _span_continuity(recorder: SpanRecorder, admitted_rids: list[str],
                     problems: list[str],
                     aborted: "set[str] | None" = None
                     ) -> tuple[SpanAssembler, Any]:
    """The span-continuity invariant both harnesses gate on
    (docs/TRACING.md): every admitted rid has a COMPLETE, GAP-FREE
    chain (admit → terminal complete) in the recorder's ring — across
    backend loss, gateway death, partitions, drains, and rejoins — and
    the ring dropped nothing (a lost record would be an unverifiable
    gap, so it is a failure, not a shrug). Purely an observer: the
    recorder consumes no randomness, so arming it never moves the
    run's digests."""
    if recorder.ring.lost:
        problems.append(
            f"span ring dropped {int(recorder.ring.lost)} record(s); "
            "chains unverifiable (size the ring for the run)")
    if recorder.dropped_spans:
        problems.append(
            f"span recorder dropped {recorder.dropped_spans} new "
            "span(s) at the intern bound; chains unverifiable (raise "
            "max_spans for the run)")
    recs = recorder.drain()
    asm = SpanAssembler(recs, recorder.rid_table(),
                        recorder.member_table(),
                        recorder.tenant_table())
    chain_problems = asm.validate(admitted_rids, aborted=aborted)
    # Cap the spew: one run with a systemic gap would otherwise emit
    # thousands of identical lines.
    problems.extend(chain_problems[:20])
    if len(chain_problems) > 20:
        problems.append(
            f"... and {len(chain_problems) - 20} more span-chain "
            "problem(s)")
    return asm, recs


def _export_obs(recorder: SpanRecorder, recs, obs_dir: str | None,
                tenants, run_meta: dict) -> None:
    if obs_dir is None:
        return
    recorder.export(
        obs_dir, run_meta=run_meta,
        tenants=_tenant_slo_info(tenants),
        recs=recs)


def run_gateway_chaos(workload: str = "mixed", seed: int = 0,
                      n_backends: int = 3, n_tenants: int = 4,
                      ticks: int = 400, tick_ns: int = 1 * MS,
                      plan: FaultPlan | None = None,
                      trace_path: str | None = None,
                      ledger_path: str | None = None,
                      kill_backend: bool = True,
                      obs_dir: str | None = None,
                      arrival_model: ArrivalModel | None = None,
                      serve=None) -> dict:
    """One seeded gateway chaos scenario; returns the report dict
    (``ok`` = every invariant held). Installs the plan process-wide for
    the duration — callers must not have their own plan armed.
    ``arrival_model=None`` keeps the stock :func:`draw_arrival`
    stream — and therefore every golden digest — byte-identical.

    ``serve`` (docs/SERVING.md) swaps the LAST simulated backend for a
    real serving backend built by ``serve(name, seed) -> Backend`` — a
    factory returning a duck-typed backend (ShardedServeBackend /
    DisaggServeBackend constructed with ``clock="virtual"`` so the
    engine reads this harness's VirtualClock). ``backends[0]`` stays
    simulated, so the mid-run kill still exercises the drain/requeue
    path; the serve backend's stats land additively under
    ``report["serve"]``. ``serve=None`` builds the all-sim pool and
    keeps every golden byte-identical."""
    plan = plan if plan is not None else FaultPlan.gateway(seed)
    inj = faults_mod.install(plan, trace_path=trace_path)
    problems: list[str] = []
    try:
        clock = VirtualClock()
        # Service time of one cost unit = one tick: batch requests
        # (cost 4-12) occupy a slot for many ticks, so queues form,
        # fairness matters, and the mid-run kill reliably catches
        # in-flight work (the drain/requeue path under test).
        backends = [
            SimServeBackend(f"b{i}", n_slots=2,
                            service_ns_per_cost=tick_ns,
                            seed=seed + i)
            for i in range(max(1, int(n_backends)))
        ]
        serve_backend = None
        if serve is not None:
            serve_backend = serve(f"b{len(backends) - 1}", seed)
            backends[-1] = serve_backend
        tenants = build_workload(workload, seed=seed, n_tenants=n_tenants)
        spans = SpanRecorder(capacity=1 << 16)
        gw = Gateway(backends, clock=clock, max_queued=64 * len(tenants),
                     trace_capacity=8192, ledger_path=ledger_path,
                     spans=spans)
        for t in tenants:
            gw.register_tenant(
                t.name, quota_for(t.name, t.slo, t.params.weight))
        arrivals = catalog_arrivals(tenants, seed, tag=7)

        kill_at = ticks // 3 if kill_backend and len(backends) > 1 else -1
        shed_results = 0
        completions: list[tuple[str, dict]] = []
        seen_rids: set[str] = set()
        admitted_rids: list[str] = []

        def _check_books(where: str) -> None:
            acct = gw.completed + gw.queue.depth() + len(gw.inflight)
            if gw.admitted != acct:
                problems.append(
                    f"{where}: admitted {gw.admitted} != completed "
                    f"{gw.completed} + queued {gw.queue.depth()} + "
                    f"inflight {len(gw.inflight)}")

        for tick in range(int(ticks)):
            if tick == kill_at:
                backends[0].fail()
            for t in tenants:
                if arrival_model is None:
                    fire, cost = draw_arrival(t, arrivals[t.name])
                else:
                    fire, cost = arrival_model.draw(
                        t, tick, arrivals[t.name])
                if not fire:
                    continue
                r = gw.submit(t.name, {"tick": tick}, cost=cost)
                if arrival_model is not None:
                    arrival_model.note_result(t.name, tick, r.admitted)
                if r.admitted:
                    admitted_rids.append(r.rid)
                else:
                    shed_results += 1
                    if r.retry_after_ns <= 0:
                        problems.append(
                            f"shed of {t.name} at tick {tick} carries "
                            f"no retry-after ({r.reason})")
            completions.extend(gw.tick())
            if tick % 50 == 0:
                _check_books(f"tick {tick}")
            clock.advance(tick_ns)

        # Drain: no new arrivals; pump until idle (bounded).
        for _ in range(int(ticks) * 4):
            if not gw.busy():
                break
            completions.extend(gw.tick())
            clock.advance(tick_ns)

        _check_books("end")
        if gw.busy():
            problems.append(
                f"drain did not converge: queued {gw.queue.depth()}, "
                f"inflight {len(gw.inflight)}")
        elif gw.admitted != gw.completed:
            problems.append(
                f"admitted requests lost: admitted {gw.admitted}, "
                f"completed {gw.completed}")
        for rid, _ in completions:
            if rid in seen_rids:
                problems.append(f"request {rid} completed twice")
            seen_rids.add(rid)
        st = gw.stats()
        shed_books = sum(st["shed"].values())
        if shed_results != shed_books:
            problems.append(
                f"shed accounting drift: {shed_results} shed results, "
                f"{shed_books} in the admission books")
        asm, span_recs = _span_continuity(spans, admitted_rids, problems)
        _export_obs(spans, span_recs, obs_dir, tenants, {
            "harness": "gateway", "workload": workload, "seed": seed,
            "backends": n_backends, "tenants": n_tenants, "ticks": ticks,
        })
    finally:
        faults_mod.uninstall()

    fault_counts: dict[str, int] = {}
    for rec in inj.records:
        k = f"{rec['point']}:{rec['fault']}"
        fault_counts[k] = fault_counts.get(k, 0) + 1
    if trace_path is not None:
        inj.write_trace()
    report: dict[str, Any] = {
        "workload": workload, "seed": seed, "backends": n_backends,
        "tenants": n_tenants, "ticks": ticks,
        "plan": plan.as_dict(),
        "killed_backend": backends[0].name if kill_at >= 0 else None,
        "stats": st,
        "spans": asm.summary(),
        # Per-tenant SLO view off the SAME span chains the continuity
        # invariant just validated — the stress scorer's burn-rate
        # input (the reference's scenarios/score.py). Report-only: digests
        # never cover it.
        "slo": asm.slo_report(tenants=_tenant_slo_info(tenants)),
        "faults_fired": dict(sorted(fault_counts.items())),
        "trace_digest": inj.trace_digest(),
        "problems": problems,
        "ok": not problems,
    }
    if serve_backend is not None:
        # Additive: serve=None runs never carry the key, so their
        # report shape (and every golden) is untouched.
        report["serve"] = serve_backend.stats()
    return report


# -- the federated tier under fire -------------------------------------------


def _federation_member(name: str, salt: int, clock, tick_ns: int,
                       seed: int, n_backends: int,
                       n_tenants: int, serve=None) -> Gateway:
    """One federation member with its own backend pool. Backend seeds
    derive from (seed, salt, index) so every member's service jitter is
    an independent, replayable stream. Service runs SLOWER than the
    tick (3 ticks per cost unit) so queues and in-flight work actually
    form at the members — a gateway death must reliably catch
    casualties for the failover path to be under test at all.

    ``serve`` (docs/SERVING.md): same factory contract as
    :func:`run_gateway_chaos` — replaces this member's LAST backend
    with a real serving backend; the leading Sim backends keep the
    queue-forming service profile the failover gates rely on."""
    backends = [
        SimServeBackend(f"{name}b{j}", n_slots=2,
                        service_ns_per_cost=3 * tick_ns,
                        seed=seed * 1009 + salt * 31 + j)
        for j in range(max(1, int(n_backends)))
    ]
    if serve is not None:
        j = len(backends) - 1
        backends[j] = serve(f"{name}b{j}", seed * 1009 + salt * 31 + j)
    return Gateway(backends, clock=clock, max_queued=64 * max(1, n_tenants),
                   name=name)


def stock_crash_plan(ticks: int) -> list[dict]:
    """The ``pbst-torch chaos --plan crash`` schedule: one mid-frame
    journal-commit kill (torn tail on disk) early, one tick-boundary
    kill-9 after the rejoin. Pure function of ``ticks``."""
    return [
        {"record": 360, "cut": 11},
        {"tick": (2 * int(ticks)) // 3 + 7},
    ]


def _crash_specs(crash_plan: list[dict]) -> tuple[FaultSpec, ...]:
    """crash_plan entries -> FaultSpecs on the two process-death
    points (docs/DURABILITY.md):

    - ``{"record": K, "cut": B}`` — kill the process mid-commit with
      exactly K records durable and the next frame torn B bytes into
      the offending record (``journal.crash``; ``after`` counts the
      journal's cumulative record positions);
    - ``{"tick": T}`` — kill-9 at the top of harness tick T, a clean
      frame boundary (``gateway.process.kill``);
    - ``{"p": x, "times": n}`` — seeded probabilistic tick kills (the
      scenario genome's crash gene).
    """
    specs: list[FaultSpec] = []
    for e in crash_plan:
        if "record" in e:
            specs.append(FaultSpec(
                "journal.crash", "crash", p=1.0,
                after=int(e["record"]), times=1,
                args={"cut_bytes": int(e.get("cut", 12))}))
        elif "tick" in e:
            specs.append(FaultSpec(
                "gateway.process.kill", "kill", p=1.0,
                after=int(e["tick"]), times=1))
        elif "p" in e:
            specs.append(FaultSpec(
                "gateway.process.kill", "kill", p=float(e["p"]),
                after=int(e.get("after", 20)),
                times=int(e.get("times", 2))))
        else:
            raise ValueError(f"crash_plan entry {e!r} names none of "
                             "record/tick/p")
    return tuple(specs)


def run_federation_chaos(workload: str = "mixed", seed: int = 0,
                         n_gateways: int = 3,
                         backends_per_gateway: int = 2,
                         n_tenants: int = 4,
                         ticks: int = 400, tick_ns: int = 1 * MS,
                         plan: FaultPlan | None = None,
                         trace_path: str | None = None,
                         drain_rejoin: bool = True,
                         obs_dir: str | None = None,
                         knob_plan: list[dict] | None = None,
                         autopilot: "bool | dict | None" = None,
                         arrival_model: ArrivalModel | None = None,
                         crash_plan: list[dict] | None = None,
                         serve=None,
                         process_mode: bool = False) -> dict:
    """One seeded federated-gateway chaos scenario; returns the report
    dict (``ok`` = every invariant held). Gateway deaths, partitions,
    and lease expiries come from the armed plan; a drain of a seeded
    victim at ``ticks/3`` and a fresh-member rejoin at ``2·ticks/3``
    come from the harness schedule (both pure functions of ``seed``).
    Installs the plan process-wide for the duration.

    ``knob_plan`` injects mid-run hot-reloads over a real file-backed
    knob channel (docs/KNOBS.md): each entry is ``{"tick": T, "set":
    {knob: value}}`` plus optional ``"expect": "rejected"`` for a
    malformed/out-of-range push the channel must refuse ATOMICALLY
    (generation unmoved, books untouched). The federation adopts
    applied pushes at the top of its ``tick()`` pump — BEFORE that
    round's lease renewals, so a push at a renewal tick genuinely
    races the renewal path. The no-job-lost and no-rate-inflation
    invariants must hold across every push; the mint bound integrates
    the rate-scale timeline piecewise. With ``knob_plan=None`` the
    run — and both digests — are byte-identical to the pre-knob
    harness.

    ``process_mode=True`` runs the members as REAL OS processes: it
    delegates to :func:`~pbs_tpu_torch.gateway.procfed.run_process_chaos`,
    and ``crash_plan`` tick entries become literal SIGKILLs to member
    pids.

    ``autopilot`` (True, or an ``AutopilotConfig`` kwargs dict) arms
    the FULL closed loop (docs/AUTOPILOT.md): shadow capture at the
    submit surface, a quick shadow search, and an SLO-burn-guarded
    canary rollout over a real knob channel — under the
    ``FaultPlan.autopilot`` plan by default, whose deterministic
    ``autopilot.candidate`` injection replaces the first proposal with
    an adversarially bad (in-range!) profile. The gate this proves:
    the pathological candidate ROLLS BACK to the reference profile
    within the guard window, every member ends on the reference
    values, and no-job-lost + the piecewise mint bound hold
    throughout; the loop's every decision and member adoption is
    keyed into the report digest. ``autopilot=None`` keeps the digest
    payload byte-identical to the pre-autopilot harness.

    ``arrival_model`` swaps the stock :func:`draw_arrival` stream for
    a custom :class:`ArrivalModel` (the scenario-genome traffic
    shapes, docs/SCENARIOS.md); ``None`` keeps every golden digest
    byte-identical.

    ``crash_plan`` (docs/DURABILITY.md) arms the write-ahead intent
    journal on a real file and KILLS THE WHOLE PROCESS STATE at the
    seeded positions — every in-memory object dropped, only journal
    bytes (and the span ring, the durable observability store) kept —
    including mid-frame (a ``record`` entry tears the commit with a
    byte cut inside a record). Recovery rebuilds the federation via
    :func:`~pbs_tpu_torch.gateway.recovery.recover_federation` and the run
    continues; the harness reconciles its client-side books to the
    durable truth (requests whose ADMIT frame never committed were
    never durably acked — their client saw a connection reset, not a
    loss). The gate: no durably-admitted request lost, recovered mint
    odometers under the piecewise bound, span chains stitched across
    every restart by SPAN_RECOVER events, same seed ⇒ same digests.
    ``crash_plan=None`` arms no journal and keeps every golden
    byte-identical.

    ``serve`` (docs/SERVING.md) puts a real serving backend behind
    member ``gw0`` — the last of its backends is built by
    ``serve(name, seed) -> Backend`` instead of a SimServeBackend
    (same factory contract as :func:`run_gateway_chaos`; construct it
    with ``clock="virtual"``). Its stats land in ``report["serve"]``
    and key into the report digest, so same-seed-same-digest pins the
    serving tier's response too. Mutually exclusive with
    ``crash_plan`` (recovery rebuilds members from journal bytes; a
    serving engine cannot be resurrected from them). ``serve=None``
    keeps every golden byte-identical."""
    if process_mode:
        # Members as REAL OS processes: delegate to the procfed
        # harness — ``crash_plan`` tick entries become literal SIGKILLs
        # to member pids. Record-positioned cuts (``{"record": N}``)
        # are an in-process-only instrument: a byte-precise tear needs
        # the harness holding the journal fd, and a real SIGKILL cannot
        # be aimed at a byte offset. The in-process knob/autopilot/
        # serve control planes don't cross the process boundary either.
        if any("tick" not in e for e in (crash_plan or [])):
            raise ValueError(
                "process_mode realizes only tick-positioned kills: "
                "record-positioned torn-write cuts need the "
                "in-process harness (crash_plan without "
                "process_mode)")
        if knob_plan or (autopilot is not None and autopilot is not
                         False) or serve is not None or plan is not None:
            raise ValueError(
                "process_mode is mutually exclusive with plan/"
                "knob_plan/autopilot/serve: those control planes "
                "live in the harness process, not in the members")
        from pbs_tpu_torch.gateway.procfed import run_process_chaos

        return run_process_chaos(
            workload=workload, seed=seed, n_gateways=n_gateways,
            n_tenants=n_tenants, ticks=ticks, tick_ns=tick_ns,
            backends_per_gateway=backends_per_gateway,
            kill_plan=[{"tick": int(e["tick"]),
                        **({"member": e["member"]} if "member" in e
                           else {})}
                       for e in (crash_plan or [])])
    # Armed on any non-None, non-False value: autopilot={} means "the
    # default-configured loop", not "off" (truthiness would silently
    # disarm it).
    ap_armed = autopilot is not None and autopilot is not False
    if knob_plan and ap_armed:
        # Each arms its own knob channel and the federation holds
        # exactly one (attach_knobs refuses a second — a silently
        # orphaned channel would validate pushes nobody adopts).
        raise ValueError(
            "knob_plan and autopilot are mutually exclusive: both "
            "own the federation's knob channel")
    if crash_plan and (knob_plan or ap_armed):
        # Recovery reconciles queues and lease books; the knob channel
        # and autopilot loop carry additional process state the
        # journal deliberately does not cover (docs/DURABILITY.md
        # "Scope").
        raise ValueError(
            "crash_plan is mutually exclusive with knob_plan/"
            "autopilot: the journal covers gateway state, not the "
            "knob control plane")
    if crash_plan and serve is not None:
        raise ValueError(
            "crash_plan is mutually exclusive with serve: recovery "
            "rebuilds members from journal bytes, which cannot "
            "resurrect a jitted serving engine's slot state")
    if plan is None:
        plan = (FaultPlan.autopilot(seed) if ap_armed
                else FaultPlan.federation(seed))
    if crash_plan:
        plan = FaultPlan(seed=plan.seed,
                         specs=tuple(plan.specs)
                         + _crash_specs(crash_plan)).validate()
    inj = faults_mod.install(plan, trace_path=trace_path)
    problems: list[str] = []
    knob_events: list[dict] = []
    knob_dir = None
    ap_dir = None
    jr_dir = None
    journal = None
    pilot = None
    try:
        clock = VirtualClock()

        serve_backends: list = []

        def _member_factory(name: str):
            salt = 97 if name.startswith("gwr") else int(name[2:])
            sv = serve if (serve is not None and name == "gw0") else None
            m = _federation_member(name, salt, clock, tick_ns, seed,
                                   backends_per_gateway, n_tenants,
                                   serve=sv)
            if sv is not None:
                serve_backends.append(m.backends[-1])
            return m

        members = [
            _member_factory(f"gw{i}")
            for i in range(max(1, int(n_gateways)))
        ]
        spans = SpanRecorder(capacity=1 << 16)
        if crash_plan:
            import tempfile

            jr_dir = tempfile.mkdtemp(prefix="pbst-journal-")
            jr_path = f"{jr_dir}/gateway.jrnl"
            journal = GatewayJournal.create(jr_path)
        fed = FederatedGateway(members, clock=clock,
                               renew_period_ns=4 * tick_ns,
                               lease_ttl_ns=6 * tick_ns,
                               spans=spans, journal=journal)
        tenants = build_workload(workload, seed=seed, n_tenants=n_tenants)
        quotas: dict[str, TenantQuota] = {}
        for t in tenants:
            quotas[t.name] = quota_for(t.name, t.slo, t.params.weight)
            fed.register_tenant(t.name, quotas[t.name])
        arrivals = catalog_arrivals(tenants, seed, tag=11)
        sched_rng = np.random.default_rng([int(seed), 13])
        drain_at = ticks // 3 if drain_rejoin else -1
        rejoin_at = (2 * ticks) // 3 if drain_rejoin else -1

        start_ns = clock.now_ns()
        # Rate-scale timeline for the piecewise mint bound:
        # [(t_ns, scale)] segments; scale 1.0 from the start.
        scale_timeline: list[tuple[int, float]] = [(start_ns, 1.0)]
        knob_writer = None
        pushes_by_tick: dict[int, list[dict]] = {}
        if knob_plan:
            import tempfile

            from pbs_tpu_torch.knobs.channel import KnobChannel
            from pbs_tpu_torch.knobs.registry import KnobError

            knob_dir = tempfile.mkdtemp(prefix="pbst-knobs-")
            ch_path = f"{knob_dir}/knobs.led"
            knob_writer = KnobChannel.create(ch_path)
            fed.attach_knobs(KnobChannel.attach(ch_path))
            for entry in knob_plan:
                pushes_by_tick.setdefault(int(entry["tick"]),
                                          []).append(entry)

        if ap_armed:
            import tempfile

            from pbs_tpu_torch.autopilot import Autopilot, AutopilotConfig
            from pbs_tpu_torch.knobs.channel import KnobChannel

            ap_dir = tempfile.mkdtemp(prefix="pbst-autopilot-")
            ap_writer = KnobChannel.create(f"{ap_dir}/knobs.led")
            overrides = dict(autopilot) if isinstance(autopilot, dict) \
                else {}
            # Loop cadence sized to the run: record a third, guard a
            # third — the guard must exceed the tightest SLO target
            # (50 ms interactive) with real margin, or in-window
            # requests cannot age past it and every verdict collapses
            # to no-evidence; the whole decision still lands well
            # inside the horizon, rollback included.
            overrides.setdefault("min_record_ns", (ticks // 3) * tick_ns)
            overrides.setdefault("guard_window_ns",
                                 (ticks // 3) * tick_ns)
            pilot = Autopilot(fed, ap_writer,
                              config=AutopilotConfig(**overrides))

        def _push_knobs(tick: int) -> None:
            for entry in pushes_by_tick.get(tick, ()):
                expect_reject = entry.get("expect") == "rejected"
                gen_before = knob_writer.generation
                try:
                    gen = knob_writer.push(dict(entry["set"]))  # pbst: ignore[rollout-push] -- chaos harness IS the adversary: the knob plan injects raw mid-run pushes to prove the consumers survive them; production writers go through autopilot/canary.py
                    applied, errors = True, []
                except KnobError as e:
                    applied, errors = False, list(e.problems)
                    gen = knob_writer.generation
                if applied and not expect_reject and \
                        "gateway.admission.rate_scale" in entry["set"]:
                    # Adoption happens at the top of THIS tick's pump.
                    scale_timeline.append(
                        (clock.now_ns(),
                         float(entry["set"]
                               ["gateway.admission.rate_scale"])))
                if expect_reject and applied:
                    problems.append(
                        f"knob push at tick {tick} expected rejected "
                        f"but applied: {entry['set']!r}")
                if not expect_reject and not applied:
                    problems.append(
                        f"knob push at tick {tick} unexpectedly "
                        f"rejected: {errors}")
                if not applied and gen != gen_before:
                    problems.append(
                        f"REJECTED push at tick {tick} moved the "
                        f"channel generation {gen_before}->{gen} — "
                        "rejection was not atomic")
                knob_events.append({
                    "tick": tick, "applied": applied,
                    "generation": gen,
                    "set": {k: str(v) for k, v in
                            sorted(entry["set"].items())},
                    "errors": errors,
                })
        admitted_cost: dict[str, float] = {}
        admitted_rids: list[str] = []
        shed_results = 0
        completions: list[tuple[str, dict]] = []

        def _check_books(where: str) -> None:
            acct = fed.completed + fed.queued() + fed.inflight_count()
            if fed.admitted != acct:
                problems.append(
                    f"{where}: admitted {fed.admitted} != completed "
                    f"{fed.completed} + queued {fed.queued()} + "
                    f"inflight {fed.inflight_count()}")

        #: Crash-harness client-side books: rid -> (tenant, cost) so a
        #: recovery can roll back the unacked suffix exactly.
        rid_books: dict[str, tuple[str, int]] = {}
        unacked_rids: set[str] = set()
        crash_events: list[dict] = []

        def _cold_boot(err: JournalError):
            """Recovery when NOT EVEN the topology image is durable:
            the crash tore the journal's very first frame (position 0
            of the soak — zero sealed records on disk), so there is no
            state to replay. Reboot exactly as at start — same member
            names, same tenant registration order — on the reopened
            journal (torn tail truncated, generation bumped), and let
            the caller roll back every client-side book: nothing was
            ever durably acked. Returns ``(fed, RecoveryInfo)`` like
            recover_federation."""
            from pbs_tpu_torch.gateway.recovery import (
                RecoveryInfo,
                replay,
                state_digest,
            )

            view = read_journal(jr_path)
            st = replay(view.records, lease_ttl_ns=6 * tick_ns)
            if st.live_members():
                raise err  # a different JournalError: surface it
            jr = GatewayJournal.reopen(jr_path, view=view)
            boot = FederatedGateway(
                [_member_factory(f"gw{i}")
                 for i in range(max(1, int(n_gateways)))],
                clock=clock, renew_period_ns=4 * tick_ns,
                lease_ttl_ns=6 * tick_ns, spans=spans, journal=jr)
            for t in tenants:
                boot.register_tenant(t.name, quotas[t.name])
            # Fresh rid namespace, same as recover_federation: the
            # unacked pre-crash rids left records in the durable span
            # ring, and a rebooted gw0-0 must never collide with them.
            import itertools

            for name in sorted(boot.members):
                boot.members[name].rid_generation = jr.generation
                boot.members[name]._rids = itertools.count()
            now = clock.now_ns()
            boot.events.append({"now_ns": now, "event": "recover",
                                "gateway": f"g{jr.generation}"})
            jr.recover_mark(now, 0, 0)
            try:
                jr.commit()
            except Exception:
                jr.abandon()  # same contract as recover_federation
                raise
            return boot, RecoveryInfo(
                generation=jr.generation, rids=set(st.reqs),
                done=st.done_rids(), recovered=[],
                requeued_inflight=[], shed_total=st.shed_total(),
                state_digest=state_digest(st),
                torn_bytes=view.torn_bytes)

        def _recover_now():
            """The kill-9 handler: drop every in-memory object (the
            dead process), keep only journal bytes + the span ring
            (the durable observability store, its in-process staging
            batch dropped like any dying process buffer), recover,
            and reconcile the harness's client-side books to the
            durable truth. Returns the resolving RecoveryInfo +
            unacked count (the caller records the crash events)."""
            nonlocal fed, journal, shed_results, completions, \
                admitted_rids
            from pbs_tpu_torch.gateway.journal import JournalCorrupt
            from pbs_tpu_torch.gateway.recovery import recover_federation

            spans.batch.drop_pending()
            if journal is not None:
                journal.abandon()
            fed = None  # the process is dead; only bytes remain
            journal = None
            try:
                fed, info = recover_federation(
                    jr_path, member_factory=_member_factory, clock=clock,
                    spans=spans, renew_period_ns=4 * tick_ns,
                    lease_ttl_ns=6 * tick_ns)
            except JournalCorrupt:
                raise  # bit rot is never recoverable-by-reboot
            except JournalError as err:
                fed, info = _cold_boot(err)
            journal = fed.journal
            lost = [rid for rid in admitted_rids
                    if rid not in info.rids]
            for rid in lost:
                tname, rcost = rid_books.pop(rid)
                admitted_cost[tname] = admitted_cost.get(tname, 0.0) \
                    - rcost
                unacked_rids.add(rid)
            admitted_rids = [rid for rid in admitted_rids
                             if rid in info.rids]
            # Completions whose frame never committed re-deliver
            # after recovery (at-least-once across a crash).
            completions = [c for c in completions if c[0] in info.done]
            shed_results = info.shed_total
            return info, len(lost)

        def _kill9(pk: ProcessKill) -> ProcessKill:
            """Handle a process death, retrying when recovery's own
            commit is the next crash victim (recovery is idempotent;
            each deterministic spec fires once). EVERY fired kill gets
            its own crash event — a kill that lands inside a
            recovery's commit still fired, and the fired-vs-planned
            gate must count it — all stamped with the recovery that
            finally resolved them. Returns the FIRST kill: its kind,
            not the last retry's, decides resume semantics."""
            first = pk
            fired = [pk]
            while True:
                try:
                    info, unacked = _recover_now()
                    break
                except ProcessKill as again:
                    fired.append(again)
            for each in fired:
                crash_events.append({
                    "kind": each.kind, "position": each.position,
                    "generation": info.generation,
                    "unacked": unacked,
                    "torn_bytes": info.torn_bytes,
                    "requeued_inflight": len(info.requeued_inflight),
                    "recovered": len(info.recovered),
                    "state_digest": info.state_digest,
                })
            if len(crash_events) > 16:
                raise RuntimeError(
                    "crash plan produced >16 recoveries; runaway")
            return first

        tick = 0
        #: Last tick whose kill consult already happened: a tick
        #: re-entered after its own process kill must NOT consult
        #: again — the extra draw would advance the fault stream and
        #: shift every later deterministic {"tick": T} position to
        #: T-1 (one consult per tick index is the plan contract).
        consulted_kill_tick = -1
        while tick < int(ticks):
            try:
                if crash_plan and tick != consulted_kill_tick:
                    consulted_kill_tick = tick
                    f = faults_mod.consult("gateway.process.kill",
                                           "proc")
                    if f is not None:
                        raise ProcessKill("process", tick)
                if knob_writer is not None:
                    _push_knobs(tick)
                if tick == drain_at and len(fed.members) > 1:
                    candidates = [n for n in sorted(fed.members)
                                  if n not in fed._draining]
                    if len(candidates) > 1:
                        victim = candidates[
                            int(sched_rng.integers(0, len(candidates)))]
                        fed.drain(victim)
                if tick == rejoin_at:
                    fed.add(_member_factory("gwr0"))
                for t in tenants:
                    if arrival_model is None:
                        fire, cost = draw_arrival(t, arrivals[t.name])
                    else:
                        fire, cost = arrival_model.draw(
                            t, tick, arrivals[t.name])
                    if not fire:
                        continue
                    r = fed.submit(t.name, {"tick": tick}, cost=cost)
                    if arrival_model is not None:
                        arrival_model.note_result(t.name, tick,
                                                  r.admitted)
                    if r.admitted:
                        admitted_cost[t.name] = \
                            admitted_cost.get(t.name, 0.0) + cost
                        admitted_rids.append(r.rid)
                        if crash_plan:
                            rid_books[r.rid] = (t.name, cost)
                    else:
                        shed_results += 1
                        if r.retry_after_ns <= 0:
                            problems.append(
                                f"shed of {t.name} at tick {tick} "
                                f"carries no retry-after ({r.reason})")
                completions.extend(fed.tick())
                if pilot is not None:
                    pilot.tick()
                if tick % 50 == 0:
                    _check_books(f"tick {tick}")
            except ProcessKill as pk:
                if _kill9(pk).kind == "process":
                    # Tick-boundary kill: nothing of tick T ran yet;
                    # re-enter it (the times-capped spec won't
                    # re-fire). A mid-commit kill instead happened
                    # inside fed.tick() — tick T's arrivals were
                    # already submitted, so the run resumes at T+1.
                    continue
            clock.advance(tick_ns)
            tick += 1

        # Drain: no new arrivals; pump until idle (bounded — partitions
        # heal on the same clock, so convergence only needs ticks). A
        # leftover crash position can still fire inside a drain-phase
        # commit; recovery continues the drain.
        for _ in range(int(ticks) * 6):
            if not fed.busy():
                break
            try:
                completions.extend(fed.tick())
                if pilot is not None:
                    pilot.tick()
            except ProcessKill as pk:
                _kill9(pk)
            clock.advance(tick_ns)

        _check_books("end")
        if fed.busy():
            problems.append(
                f"drain did not converge: queued {fed.queued()}, "
                f"inflight {fed.inflight_count()}")
        elif fed.admitted != fed.completed:
            problems.append(
                f"admitted requests lost across gateway death: "
                f"admitted {fed.admitted}, completed {fed.completed}")
        seen_rids: set[str] = set()
        for rid, _ in completions:
            if rid in seen_rids:
                problems.append(f"request {rid} completed twice")
            seen_rids.add(rid)

        # No-rate-inflation: every admitted cost unit is token-backed.
        elapsed_s = (clock.now_ns() - start_ns) / SEC
        # Piecewise ∫scale·dt for the mint bound: a mid-run rate-scale
        # push re-rates the banks settle-then-switch
        # (LeaseBroker.set_rate_scale), so minted tokens must stay
        # under burst + rate·Σ scaleᵢ·dtᵢ. No pushes ⇒ this is exactly
        # the old burst + rate·elapsed bound.
        end_ns = clock.now_ns()
        scaled_elapsed_s = 0.0
        for i, (t0, sc) in enumerate(scale_timeline):
            t1 = (scale_timeline[i + 1][0]
                  if i + 1 < len(scale_timeline) else end_ns)
            scaled_elapsed_s += sc * max(0, t1 - t0) / SEC
        audit = fed.lease_audit()
        for tname, a in sorted(audit.items()):
            q = quotas.get(tname)
            if q is None:  # default-quota tenant (not in this harness)
                continue
            eps = 1e-6 * max(1.0, a["granted"])
            # Deposited tokens legitimately cycle back out (drain →
            # deposit → re-grant), so the issue bound is gross:
            # everything granted traces to a mint or a return.
            if a["granted"] > a["minted"] + a["deposited"] + eps:
                problems.append(
                    f"{tname}: bank over-issued (granted "
                    f"{a['granted']:.3f} > minted {a['minted']:.3f} "
                    f"+ deposited {a['deposited']:.3f})")
            if a["minted"] > q.burst + q.rate * scaled_elapsed_s + 1e-6:
                problems.append(
                    f"{tname}: minted {a['minted']:.3f} beyond "
                    f"burst + rate*∫scale·dt = "
                    f"{q.burst + q.rate * scaled_elapsed_s:.3f}")
            accounted = (a["leased_spent"] + a["held"] + a["deposited"]
                         + a["destroyed"])
            if accounted > a["granted"] + eps:
                problems.append(
                    f"{tname}: token conservation violated "
                    f"(spent+held+deposited+destroyed {accounted:.3f} "
                    f"> granted {a['granted']:.3f})")
            cost = admitted_cost.get(tname, 0.0)
            backed = a["leased_spent"] + a["conservative_spent"]
            if abs(cost - backed) > 1e-6 * max(1.0, cost):
                problems.append(
                    f"{tname}: admitted cost {cost:.3f} not token-"
                    f"backed (leased+conservative = {backed:.3f})")
            # The bounded lease slack: conservative fraction is at most
            # 1/(2N) per member, so even every member degraded at once
            # stays under half the global budget.
            slack_bound = 0.5 * (q.rate * elapsed_s + q.burst) + 1e-6
            if a["conservative_spent"] > slack_bound:
                problems.append(
                    f"{tname}: conservative slack "
                    f"{a['conservative_spent']:.3f} exceeds bound "
                    f"{slack_bound:.3f}")
        st = fed.stats()
        shed_books = sum(st["shed"].values())
        if shed_results != shed_books:
            problems.append(
                f"shed accounting drift: {shed_results} shed results, "
                f"{shed_books} in the books")

        if pilot is not None:
            # THE autopilot gate: a pathological (injected) candidate
            # must degrade to the reference profile inside the guard
            # window — never ride out the run, never cause an outage
            # (the no-job-lost check above already covers "outage").
            injected = [e for e in pilot.history
                        if e["event"] == "propose" and e.get("injected")]
            rollbacks = [e for e in pilot.history
                         if e["event"] == "rollback"]
            canaries = [e for e in pilot.history
                        if e["event"] == "canary"]
            if injected and not rollbacks:
                problems.append(
                    "autopilot: injected pathological candidate was "
                    f"never rolled back (history: "
                    f"{[e['event'] for e in pilot.history]})")
            if injected and rollbacks and canaries:
                window = pilot.config.guard_window_ns + 2 * tick_ns
                if rollbacks[0]["t_ns"] - canaries[0]["t_ns"] > window:
                    problems.append(
                        "autopilot: rollback landed "
                        f"{rollbacks[0]['t_ns'] - canaries[0]['t_ns']}"
                        f" ns after the canary — outside the guard "
                        f"window ({window} ns)")
            promoted_after = [e for e in pilot.history
                              if e["event"] == "promote"
                              and rollbacks
                              and e["t_ns"] > rollbacks[-1]["t_ns"]]
            if rollbacks and not promoted_after:
                # Degraded-to-reference means every member's adopted
                # profile IS the reference again.
                ref = pilot.canary.reference
                for name in sorted(fed.members):
                    adopted = fed.members[name].applied_knobs
                    drift = {k: (adopted.get(k), v)
                             for k, v in ref.items()
                             if adopted.get(k) != v}
                    if drift:
                        problems.append(
                            f"autopilot: member {name} not on the "
                            f"reference profile after rollback: "
                            f"{drift}")

        if crash_plan:
            # The crash gate's own checks: every deterministic crash
            # position fired, and recovery actually recovered work.
            planned = sum(1 for e in crash_plan if "p" not in e)
            if len(crash_events) < planned:
                problems.append(
                    f"crash plan scheduled {planned} deterministic "
                    f"kill(s) but only {len(crash_events)} fired")
        # THE federation span invariant: one continuous, gap-free
        # chain per admitted rid even across gateway.death /
        # gateway.partition / drain+rejoin — custody transfers stitch,
        # they do not restart — and, under a crash plan, across every
        # PROCESS death (SPAN_RECOVER re-anchors; unacked rids are the
        # reconciled suffix, excluded from the universe).
        asm, span_recs = _span_continuity(
            spans, admitted_rids, problems,
            aborted=unacked_rids if crash_plan else None)
        _export_obs(spans, span_recs, obs_dir, tenants, {
            "harness": "federation", "workload": workload, "seed": seed,
            "gateways": n_gateways, "tenants": n_tenants, "ticks": ticks,
        })
    finally:
        faults_mod.uninstall()
        if journal is not None:
            journal.abandon()
        if knob_dir is not None or ap_dir is not None or \
                jr_dir is not None:
            import shutil

            for d in (knob_dir, ap_dir, jr_dir):
                if d is not None:
                    shutil.rmtree(d, ignore_errors=True)

    fault_counts: dict[str, int] = {}
    for rec in inj.records:
        k = f"{rec['point']}:{rec['fault']}"
        fault_counts[k] = fault_counts.get(k, 0) + 1
    if trace_path is not None:
        inj.write_trace()
    events = [{"tick_ns": e["now_ns"], "event": e["event"],
               "gateway": e["gateway"]} for e in fed.events]
    # The scenario digest: a second determinism witness over the BOOKS
    # (the fault-trace digest only proves the injector replayed; this
    # proves the federation's response did too).
    digest_payload = {
        "admitted": fed.admitted, "completed": fed.completed,
        "handoffs": fed.handoffs, "events": events,
        "admitted_cost": {k: round(v, 6)
                          for k, v in sorted(admitted_cost.items())},
        "shed": st["shed"],
    }
    if knob_plan is not None:
        # Knob-armed runs witness the RECONFIGURATION RESPONSE too:
        # every push (applied or atomically rejected) and what the
        # federation adopted. Keyed in only when a knob plan is armed,
        # so plain runs keep their pre-knob digests byte-identical.
        digest_payload["knob_events"] = knob_events
        digest_payload["applied_knobs"] = {
            k: round(float(v), 6)
            for k, v in sorted(fed.applied_knobs.items())}
    if crash_plan is not None:
        # Crash-armed runs witness the RECOVERY RESPONSE: every kill
        # (kind, journal position, generation, unacked suffix size,
        # torn bytes, replayed-state digest) keys into the digest, so
        # same-seed-same-digest pins the recovery itself. Keyed in
        # only when a crash plan is armed — plain runs keep their
        # pre-journal digests byte-identical.
        digest_payload["crash"] = {
            "events": crash_events,
            "unacked": sorted(unacked_rids),
        }
    if serve is not None:
        # Serve-armed runs witness the SERVING TIER'S RESPONSE: the
        # engine counters (tokens, completions, prefix traffic) key
        # into the digest, so same-seed-same-digest pins the sharded
        # engine's behaviour behind gw0. Keyed in only when armed —
        # plain runs keep their digests byte-identical.
        digest_payload["serve"] = [sb.stats() for sb in serve_backends]
    if pilot is not None:
        # Autopilot-armed runs witness the LOOP'S RESPONSE: every
        # decision (candidate, scores, margin, guard verdict) and
        # every member adoption — same-seed-same-digest therefore
        # pins the rollback itself. Keyed in only when armed, so
        # plain runs keep their pre-autopilot digests byte-identical.
        digest_payload["autopilot_events"] = [
            {k: (dict(sorted(v.items()))
                 if isinstance(v, dict) else v)
             for k, v in sorted(e.items())}
            for e in pilot.history]
        digest_payload["knob_adoptions"] = [
            {"now_ns": a["now_ns"], "member": a["member"],
             "knobs": {k: round(float(v), 6)
                       for k, v in sorted(a["knobs"].items())}}
            for a in fed.knob_adoptions]
    digest_src = json.dumps(digest_payload, sort_keys=True,
                            separators=(",", ":"))
    report: dict[str, Any] = {
        "workload": workload, "seed": seed, "gateways": n_gateways,
        "tenants": n_tenants, "ticks": ticks,
        "plan": plan.as_dict(),
        "events": events,
        "stats": st,
        "spans": asm.summary(),
        # Report-only SLO view (never digest-covered) — see
        # run_gateway_chaos.
        "slo": asm.slo_report(tenants=_tenant_slo_info(tenants)),
        "lease_audit": {t: {k: round(v, 6) for k, v in a.items()}
                        for t, a in sorted(audit.items())},
        "faults_fired": dict(sorted(fault_counts.items())),
        "trace_digest": inj.trace_digest(),
        "report_digest": hashlib.sha256(digest_src.encode()).hexdigest(),
        "problems": problems,
        "ok": not problems,
    }
    if knob_plan is not None:
        report["knob_events"] = knob_events
        report["applied_knobs"] = {
            k: round(float(v), 6)
            for k, v in sorted(fed.applied_knobs.items())}
    if crash_plan is not None:
        report["crash"] = {
            "plan": list(crash_plan),
            "events": crash_events,
            "unacked": len(unacked_rids),
            "recoveries": len(crash_events),
            "final_generation": (crash_events[-1]["generation"]
                                 if crash_events else 0),
        }
    if pilot is not None:
        report["autopilot"] = pilot.report()
    if serve is not None:
        report["serve"] = [sb.stats() for sb in serve_backends]
    return report
