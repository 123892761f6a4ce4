"""``pbs_tpu_torch.gateway`` against ``pbs_tpu.gateway``, in one process.

The same seeded arrivals go through both packages' admission, fair
queue and gateway on ``VirtualClock``s, and everything is compared
exactly: submit results, completion sequences, ``stats()``, trace-ring
words, class-ledger bytes. Then the port's ``BatcherBackend`` and
``ContinuousBatcher`` behind the port's gateway against the JAX engine
behind the reference gateway (tokens per request, completion order,
counts; never the engines' host-clock times), the queue-delay feedback
into each package's ``FeedbackPolicy``, the ``serve-demo`` command, and
the seams the port leaves for later, which must raise.
"""

from __future__ import annotations

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pbs_tpu
import pbs_tpu_torch
from pbs_tpu import models as ref_models
from pbs_tpu.cli import pbst as ref_cli
from pbs_tpu.faults import FaultPlan as RefPlan
from pbs_tpu.faults import injector as ref_faults
from pbs_tpu_torch import models as port_models
from pbs_tpu_torch.cli import pbst as port_cli
from pbs_tpu_torch.faults import FaultPlan as PortPlan
from pbs_tpu_torch.faults import injector as port_faults

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

MS = 1_000_000


def _pkg(root):
    """One package's gateway-side modules, by the same names."""
    import importlib

    name = root.__name__
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        gw=mod("gateway"), admission=mod("gateway.admission"),
        fairqueue=mod("gateway.fairqueue"), clock=mod("utils.clock"),
        runtime=mod("runtime"), fb=mod("sched.feedback"),
        telemetry=mod("telemetry"), obs=mod("obs.spans"))


PORT, REF = _pkg(pbs_tpu_torch), _pkg(pbs_tpu)
BOTH = (PORT, REF)


def _shed(s):
    return None if s is None else (s.reason, s.retry_after_ns, s.reason_code)


# -- admission ----------------------------------------------------------


def test_constants_match():
    for name in ("SLO_CLASSES", "DEFAULT_RATE", "DEFAULT_BURST",
                 "DEFAULT_WEIGHT", "DEFAULT_MAX_QUEUED",
                 "DEFAULT_MAX_QUEUED_TOTAL", "SHED_RETRY_NS",
                 "PERMANENT_RETRY_NS", "SHED_REASON_CODES"):
        assert getattr(PORT.admission, name) == getattr(REF.admission, name)
    for name in ("DEFAULT_CLASS_CYCLE", "DEFAULT_QUANTUM"):
        assert getattr(PORT.fairqueue, name) == getattr(REF.fairqueue, name)
    assert PORT.gw.GW_LEDGER_SLOTS == REF.gw.GW_LEDGER_SLOTS
    assert (PORT.gw.gateway.DEFAULT_FEEDBACK_PERIOD_NS
            == REF.gw.gateway.DEFAULT_FEEDBACK_PERIOD_NS)


def _bucket_run(pkg, seed):
    rng = np.random.default_rng(seed)
    b = pkg.admission.TokenBucket(rate=float(rng.uniform(5, 500)),
                                  burst=float(rng.uniform(2, 40)),
                                  now_ns=int(rng.integers(0, MS)))
    out, now = [], 0
    for _ in range(200):
        now += int(rng.integers(-MS, 30 * MS))  # clock may step back
        cost = float(rng.uniform(0.5, 50))
        out.append((b.take(cost, now), b.retry_after_ns(cost, now),
                    b.level, b._last_ns))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_refill_and_retry_after(seed):
    assert _bucket_run(PORT, seed) == _bucket_run(REF, seed)


def _admission_run(pkg, seed):
    rng = np.random.default_rng(seed)
    a = pkg.admission
    ctl = a.AdmissionController(
        max_queued_total=int(rng.integers(5, 30)),
        default_quota=(a.TenantQuota(rate=50.0, burst=20.0)
                       if seed % 2 else None))
    for i in range(3):
        ctl.register(f"t{i}", a.TenantQuota(
            rate=float(rng.uniform(10, 300)), burst=float(rng.uniform(5, 60)),
            weight=int(rng.integers(1, 1024)), slo=a.SLO_CLASSES[i % 2],
            max_queued=int(rng.integers(1, 10))), now_ns=0)
    out, now = [], 0
    for _ in range(300):
        now += int(rng.integers(0, 20 * MS))
        tenant = f"t{int(rng.integers(0, 5))}"  # t3, t4: unregistered
        out.append(_shed(ctl.admit(
            tenant, float(rng.uniform(1, 70)), now,
            tenant_queued=int(rng.integers(0, 10)),
            total_queued=int(rng.integers(0, 30)))))
        if rng.random() < 0.05:
            out.append(_shed(ctl.record_shed("injected-shed",
                                             int(rng.integers(-5, MS)))))
    return out, dict(ctl.sheds), ctl.quota_of("t9")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_controller_decisions(seed):
    port, ref = _admission_run(PORT, seed), _admission_run(REF, seed)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert (port[2] is None) == (ref[2] is None)
    assert len(port[1]) >= 3  # several gates fired
    with pytest.raises(ValueError, match="SLO class"):
        PORT.admission.TenantQuota(slo="bulk")


def _drr_run(pkg, seed):
    fq = pkg.fairqueue
    rng = np.random.default_rng(seed)
    q = fq.DeficitRoundRobin(quantum=int(rng.integers(4, 40)))
    for i in range(4):
        q.set_weight(f"t{i}", int(rng.integers(1, 1024)))
    out, popped, n = [], [], 0
    for step in range(400):
        r = rng.random()
        if r < 0.5:
            tenant = f"t{int(rng.integers(0, 5))}"
            q.push(fq.Request(rid=str(n), tenant=tenant,
                              slo=fq.SLO_CLASSES[int(rng.integers(0, 2))],
                              cost=int(rng.integers(1, 200)), payload=None,
                              submit_ns=step))
            n += 1
        elif r < 0.9:
            req = q.pop()
            out.append(None if req is None else
                       (req.rid, round(q.last_deficit, 9)))
            if req is not None:
                popped.append(req)
        elif popped:
            q.requeue_front(popped.pop(int(rng.integers(0, len(popped)))))
        old = q.oldest("interactive")
        out.append((q.depth(), q.depth("batch"), q.depth("interactive", "t1"),
                    None if old is None else old.rid))
    while (req := q.pop()) is not None:
        out.append(req.rid)
    return out, [r.rid for r in q.pending()], q.tenants("batch")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_order_with_class_cycle_and_requeue_front(seed):
    port, ref = _drr_run(PORT, seed), _drr_run(REF, seed)
    assert port == ref
    assert port[1] == [] and port[2] == []


def test_drr_rejects_a_foreign_class_cycle():
    with pytest.raises(ValueError, match="class_cycle"):
        PORT.fairqueue.DeficitRoundRobin(class_cycle=("bulk",))


@pytest.mark.parametrize("seed", [0, 1])
def test_pending_order_and_service_scale_match(seed):
    """``DeficitRoundRobin.pending`` (every queued request, the view
    crash recovery's checks read) and ``SimServeBackend.set_service_scale``
    (service times re-rated from the next dispatch on; the port lacked
    it until member knob adoption needed it)."""
    out = []
    for P in BOTH:
        rng = np.random.default_rng(seed)
        q = P.fairqueue.DeficitRoundRobin(quantum=4)
        be = P.gw.SimServeBackend("b0", n_slots=2, seed=seed,
                                  service_ns_per_cost=MS)
        log = []
        for i in range(30):
            cls = ("interactive", "batch")[int(rng.integers(0, 2))]
            req = P.fairqueue.Request(
                rid=f"r{i}", tenant=f"t{int(rng.integers(0, 3))}", slo=cls,
                cost=int(rng.integers(1, 6)), payload=None, submit_ns=i)
            q.push(req)
            if i % 7 == 6:
                q.pop()
            if i == 10:
                be.set_service_scale(1.75)
            be.dispatch_request(req, i * MS)
        log.append([r.rid for r in q.pending()])
        log.append([(r.rid, info) for t in range(0, 200 * MS, MS)
                    for r, info in be.poll(t)])
        out.append(log)
    assert out[0] == out[1]


# -- the gateway over simulated backends --------------------------------


def _quotas(pkg):
    Q = pkg.admission.TenantQuota
    return {"chat": Q(rate=2000.0, burst=60.0, weight=512,
                      slo="interactive", max_queued=12),
            "bulk": Q(rate=800.0, burst=80.0, weight=256, slo="batch",
                      max_queued=10),
            "tiny": Q(rate=5.0, burst=4.0, slo="batch", max_queued=1)}


def _sim_run(pkg, seed, ledger_path=None, hw=None, steps=260,
             controller=None, shadow=None):
    """Seeded two-class arrivals over two simulated backends, one of
    which dies mid-run with requests in flight; then drain. With a
    ``controller`` its health view turns before every tick; with a
    ``shadow`` recorder a late tenant registers a quarter in."""
    clock = pkg.clock.VirtualClock()
    bes = [pkg.gw.SimServeBackend("b0", n_slots=2, seed=seed,
                                  service_ns_per_cost=MS // 4),
           pkg.gw.SimServeBackend("b1", n_slots=3, seed=seed,
                                  service_ns_per_cost=MS // 3)]
    gw = pkg.gw.Gateway(bes, quotas=_quotas(pkg), clock=clock,
                        trace_capacity=16384, ledger_path=ledger_path,
                        feedback_period_ns=5 * MS, max_queued=20,
                        hw_source=hw, controller=controller)
    if shadow is not None:
        gw.attach_shadow(shadow)
    rng = np.random.default_rng(seed)
    subs, comps = [], []
    for t in range(steps):
        if shadow is not None and t == steps // 4:
            gw.register_tenant("late", pkg.admission.TenantQuota(
                rate=100.0, burst=30.0, slo="interactive"))
            subs.append(dataclasses.astuple(gw.submit("late", None, cost=3)))
        if t % (steps // 2) == 0:  # the second finds tiny's queue full
            subs += [dataclasses.astuple(gw.submit("tiny", {"t": t}))
                     for _ in range(2)]
        for _ in range(int(rng.integers(0, 4))):
            tenant = ("chat", "bulk", "tiny")[int(rng.choice(3, p=[.5, .4,
                                                                   .1]))]
            slo = "batch" if rng.random() < 0.1 else None
            cost = int(rng.integers(1, 30)) if rng.random() < 0.97 else 99
            r = gw.submit(tenant, {"t": t}, cost=cost, slo=slo)
            subs.append(dataclasses.astuple(r))
        if t == steps // 3:
            bes[1].fail()
        if controller is not None:
            controller.turn()
        comps += gw.tick()
        clock.advance(int(rng.integers(1, 5)) * MS // 2)
    if controller is not None:
        controller.view = {}  # the cluster settles: drain on liveness
    while gw.busy():
        comps += gw.tick()
        clock.advance(MS)
    stats = gw.stats()
    words = gw.trace.consume(1 << 20)
    view = dict(subs=subs, comps=comps, stats=stats, words=words.tolist(),
                lost=gw.trace.lost,
                ledger=(bytes(gw._ledger.raw()) if gw._ledger else None),
                hist=bytes(gw.hist.ledger.raw()), keys=gw.hist.keys(),
                delays={c: list(d) for c, d in gw._delays.items()},
                rids=gw.spans.rid_table(),
                tenants=gw.spans.tenant_table())
    return view, gw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gateway_over_sim_backends_matches_and_loses_nothing(seed):
    port, gw = _sim_run(PORT, seed)
    ref, _ = _sim_run(REF, seed)
    assert port == ref
    st = port["stats"]
    # never lost: every admitted request completed, once
    assert st["admitted"] == st["completed"] > 0
    assert st["inflight"] == st["queued"] == 0
    done = [rid for rid, _ in port["comps"]]
    assert sorted(done) == sorted(r[1] for r in port["subs"] if r[0])
    assert len(set(done)) == len(done)
    assert st["requeued"] > 0  # the dead backend's casualties came back
    assert {"quota", "tenant-queue-full", "cost-over-burst"} <= set(
        st["shed"])
    assert not st["backends"]["b1"]["alive"]
    # one gapless chain per admitted rid, none for a shed
    asm = PORT.obs.SpanAssembler(np.array(port["words"], dtype="<u8"),
                                 port["rids"], tenant_table=port["tenants"])
    assert asm.validate(done) == []
    assert asm.summary()["shed_events"] == sum(st["shed"].values())


@pytest.mark.parametrize("seed", [0, 1])
def test_gateway_under_the_fault_plan(seed):
    """Injected sheds, phantom admission delay and misroutes through
    each package's injector: the same decisions and the same records."""
    views = []
    for pkg, inj, plan in ((PORT, port_faults, PortPlan),
                           (REF, ref_faults, RefPlan)):
        inj.uninstall()
        inj.install(plan.gateway(seed))
        try:
            view, _ = _sim_run(pkg, seed, steps=160)
        finally:
            views.append((view, inj.uninstall().trace_digest()))
    assert views[0] == views[1]
    st = views[0][0]["stats"]
    assert st["shed"].get("injected-shed", 0) > 0
    assert st["admitted"] == st["completed"]


class _Shadow:
    """A recording stand-in for the autopilot's shadow-trace recorder."""

    def __init__(self):
        self.events = []

    def note_tenant(self, tenant, quota):
        self.events.append(("tenant", tenant,
                            dataclasses.astuple(quota)))

    def on_submit(self, now_ns, tenant, cls, cost):
        self.events.append(("submit", now_ns, tenant, cls, cost))


@pytest.mark.parametrize("seed", [0, 1])
def test_shadow_recorder_sees_every_arrival(seed):
    """``attach_shadow`` describes the tenants known so far, then every
    later registration and arrival, sheds included, in order."""
    views = []
    for pkg in BOTH:
        shadow = _Shadow()
        view, _ = _sim_run(pkg, seed, steps=160, shadow=shadow)
        views.append((view, shadow.events))
    assert views[0] == views[1]
    view, events = views[0]
    assert [e[1] for e in events[:3]] == ["bulk", "chat", "tiny"]
    assert [e[1] for e in events if e[0] == "tenant"][3:] == ["late"]
    submits = [e for e in events if e[0] == "submit"]
    assert len(submits) == len(view["subs"])
    assert sum(not ok for ok, *_ in view["subs"]) > 0  # sheds seen too
    assert ("late", "interactive", 3) in [e[2:] for e in submits]


class _Controller:
    """A duck-typed cluster controller: a seeded health view per backend
    (missing, dead, breaker open or half-open, stale) that turns over
    every tick, and the service p99s the gateway reports back."""

    def __init__(self, names, seed):
        self.names = names
        self.rng = np.random.default_rng(seed)
        self.view = {}
        self.noted = []

    def turn(self):
        self.view = {}
        for name in self.names:
            if self.rng.random() < 0.2:
                continue  # the controller knows no agent of this name
            self.view[name] = {
                "alive": bool(self.rng.random() < 0.8),
                "breaker": ("closed", "open", "half-open")[
                    int(self.rng.integers(0, 3))],
                "stale": bool(self.rng.random() < 0.3)}

    def backend_health(self):
        return self.view

    def note_backend_service(self, name, p99_ns):
        self.noted.append((name, p99_ns))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_health_vetoes_and_ranks_the_same(seed):
    views = []
    for pkg in BOTH:
        ctl = _Controller(["b0", "b1"], seed)
        view, gw = _sim_run(pkg, seed, steps=200, controller=ctl)
        views.append((view, ctl.noted))
    assert views[0] == views[1]
    view, noted = views[0]
    assert view["stats"]["admitted"] == view["stats"]["completed"]
    assert {name for name, _ in noted} == {"b0", "b1"}


def test_eligible_skips_vetoed_and_ranks_stale_last():
    """Dead or breaker-open agents never take dispatches; a stale entry
    neither vetoes nor vouches and ranks behind every fresh view; then
    least loaded first, by name."""
    fresh = {"alive": True, "breaker": "closed", "stale": False}
    health = {"b0": {"alive": False, "breaker": "open", "stale": True},
              "b1": {**fresh, "breaker": "open"},
              "b2": {**fresh, "alive": False},
              "b3": fresh, "b5": {**fresh, "breaker": "half-open"}}
    ranked = []
    for pkg in BOTH:
        ctl = types.SimpleNamespace(backend_health=lambda: health)
        bes = [pkg.gw.SimServeBackend(f"b{i}", n_slots=4) for i in range(6)]
        gw = pkg.gw.Gateway(bes, controller=ctl,
                            clock=pkg.clock.VirtualClock())
        bes[3].dispatch_request(pkg.fairqueue.Request(
            rid="x", tenant="t", slo="batch", cost=1, payload=None,
            submit_ns=0), 0)
        ranked.append([b.name for b in gw._eligible()])
    assert ranked[0] == ranked[1] == ["b4", "b5", "b3", "b0"]


def _custody_run(pkg, seed, steps=200):
    """Two federated members on one clock and one span recorder, both
    taking arrivals, so both carry DRR credit; ``a`` dies mid-run and
    ``b`` adopts its queued FIFOs (``adopt_tenant``, deficits carried)
    and its in-flight casualties (``adopt``), the way the reference
    federation's member loss hands them over."""
    clock = pkg.clock.VirtualClock()
    rec = pkg.obs.SpanRecorder(capacity=16384)
    gws = {name: pkg.gw.Gateway(
        [pkg.gw.SimServeBackend(f"{name}.b0", n_slots=2, seed=seed,
                                service_ns_per_cost=MS // 2)],
        name=name, quotas=_quotas(pkg), clock=clock, spans=rec,
        trace_capacity=8192, max_queued=40) for name in ("a", "b")}
    rng = np.random.default_rng(seed)
    subs, comps, moved = [], [], []
    live = ["a", "b"]
    for t in range(steps):
        for _ in range(int(rng.integers(0, 6))):
            gw = gws[live[int(rng.integers(0, len(live)))]]
            tenant = ("chat", "bulk")[int(rng.integers(0, 2))]
            r = gw.submit(tenant, {"t": t}, cost=int(rng.integers(1, 12)))
            subs.append(dataclasses.astuple(r))
        for name in live:
            comps += gws[name].tick()
        clock.advance(MS)
        if t == steps // 2:
            a, b, now = gws["a"], gws["b"], clock.now_ns()
            a.backends[0].fail()
            for cls in PORT.admission.SLO_CLASSES:
                for tenant in a.queue.tenants(cls):
                    reqs, deficit = a.queue.take_tenant(cls, tenant)
                    for r in reqs:
                        rec.handoff(now, r.rid, "a", "b")
                    b.adopt_tenant(cls, tenant, reqs, deficit,
                                   from_member="a")
                    moved.append(("queued", cls, tenant, deficit,
                                  [r.rid for r in reqs]))
            casualties = sorted(a.inflight.values(),
                                key=lambda r: (r.submit_ns, r.rid),
                                reverse=True)
            a.inflight.clear()
            for req in casualties:
                rec.handoff(now, req.rid, "a", "b")
                b.adopt(req)
                moved.append(("inflight", req.rid, req.requeues))
            live = ["b"]
    while gws["b"].busy():
        comps += gws["b"].tick()
        clock.advance(MS)
    for gw in gws.values():
        gw.flush_trace()
    rec.batch.flush()
    return dict(subs=subs, comps=comps, moved=moved,
                stats={n: gw.stats() for n, gw in gws.items()},
                words=rec.ring.consume(1 << 20).tolist(),
                rids=rec.rid_table(), members=rec.member_table(),
                tenants=rec.tenant_table())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_custody_transfer_matches_and_loses_nothing(seed):
    port, ref = _custody_run(PORT, seed), _custody_run(REF, seed)
    assert port == ref
    a, b = port["stats"]["a"], port["stats"]["b"]
    kinds = {m[0] for m in port["moved"]}
    assert kinds == {"queued", "inflight"}  # both custody paths ran
    n_moved = sum(len(m[4]) if m[0] == "queued" else 1
                  for m in port["moved"])
    assert b["adopted"] == n_moved > 0
    # never lost: every rid admitted at either member completed once
    admitted = sorted(r[1] for r in port["subs"] if r[0])
    done = [rid for rid, _ in port["comps"]]
    assert sorted(done) == admitted and len(set(done)) == len(done)
    assert a["completed"] + b["completed"] == len(admitted)
    asm = PORT.obs.SpanAssembler(np.array(port["words"], dtype="<u8"),
                                 port["rids"], port["members"],
                                 port["tenants"])
    assert asm.validate(done) == []
    assert asm.summary()["handoff_events"] == n_moved


def _pool_backend(pkg, name, seed):
    """A simulated backend with two internal pools: each request runs on
    the prefill pool, is handed to the decode pool at the next poll and
    runs on there — the seam a disaggregated backend drives through
    ``handoff_hook``."""

    class PoolBackend(pkg.gw.SimServeBackend):
        def __init__(self):
            super().__init__(name, n_slots=3, seed=seed,
                             service_ns_per_cost=MS // 2)
            self.handed = set()

        def poll(self, now_ns):
            for _, _, req in self._running:
                if req.rid not in self.handed:
                    self.handed.add(req.rid)
                    self.handoff_hook(req, now_ns, f"{name}/prefill",
                                      f"{name}/decode")
                    self.exec_hook(req, now_ns)
            return super().poll(now_ns)

    return PoolBackend()


@pytest.mark.parametrize("seed", [0, 1])
def test_pool_handoff_hook_stitches_the_span_chain(seed):
    views = []
    for pkg in BOTH:
        clock = pkg.clock.VirtualClock()
        gw = pkg.gw.Gateway([_pool_backend(pkg, f"p{i}", seed)
                             for i in range(2)],
                            quotas=_quotas(pkg), clock=clock,
                            trace_capacity=16384)
        rng = np.random.default_rng(seed)
        subs, comps = [], []
        for t in range(120):
            for _ in range(int(rng.integers(0, 3))):
                r = gw.submit(("chat", "bulk")[int(rng.integers(0, 2))],
                              None, cost=int(rng.integers(1, 10)))
                subs.append(dataclasses.astuple(r))
            comps += gw.tick()
            clock.advance(MS)
        while gw.busy():
            comps += gw.tick()
            clock.advance(MS)
        st = gw.stats()
        views.append(dict(subs=subs, comps=comps, stats=st,
                          words=gw.trace.consume(1 << 20).tolist(),
                          rids=gw.spans.rid_table(),
                          members=gw.spans.member_table(),
                          tenants=gw.spans.tenant_table()))
    assert views[0] == views[1]
    port = views[0]
    done = [rid for rid, _ in port["comps"]]
    assert port["stats"]["admitted"] == len(done) > 0
    asm = PORT.obs.SpanAssembler(np.array(port["words"], dtype="<u8"),
                                 port["rids"], port["members"],
                                 port["tenants"])
    assert asm.validate(done) == []
    assert asm.summary()["handoff_events"] == len(done)
    assert {"p0/prefill", "p0/decode", "p1/decode"} <= set(port["members"])


def test_watermark_exports_each_wait_once():
    """A request waiting many feedback periods and then dispatching
    pushes its queue delay into the sink exactly once."""
    seen = []
    for pkg in BOTH:
        reported = []
        clock = pkg.clock.VirtualClock()
        be = pkg.gw.SimServeBackend("b0", n_slots=1, jitter=0.0,
                                    service_ns_per_cost=40 * MS)
        gw = pkg.gw.Gateway(
            [be], clock=clock,
            quotas={"chat": pkg.admission.TenantQuota(
                rate=1e6, burst=1e6, slo="interactive")},
            feedback_sink=lambda cls, w, e, r=reported: r.append((cls, w, e)),
            feedback_period_ns=5 * MS)
        assert gw.submit("chat", None).admitted
        gw.tick()
        clock.advance(MS)
        for _ in range(3):
            assert gw.submit("chat", None).admitted
        for _ in range(200):
            gw.tick()
            clock.advance(MS)
        assert gw.completed == 4 and not gw.busy()
        assert sum(w for _, w, _ in reported) == sum(
            gw._delays["interactive"])
        assert len(reported) > 8  # the sentinel exported while queued
        seen.append(reported)
    assert seen[0] == seen[1]


def _feedback_rig(pkg, tslice_us=600):
    be = pkg.telemetry.SimBackend()
    part = pkg.runtime.Partition("gwfb", source=be, scheduler="credit")
    fb = pkg.fb.FeedbackPolicy(part)
    be.register("serve", pkg.telemetry.SimProfile.steady(
        step_time_ns=50_000, stall_frac=0.02, collective_wait_ns=500))
    job = pkg.runtime.Job("serve", params=pkg.runtime.SchedParams(
        tslice_us=tslice_us, boost_on_wake=False))
    part.add_job(job)
    return fb, job


def test_feedback_sink_drives_each_feedback_policy_the_same():
    views = []
    for pkg in BOTH:
        fb, job = _feedback_rig(pkg)
        clock = pkg.clock.VirtualClock()
        be = pkg.gw.SimServeBackend("b0", n_slots=1,
                                    service_ns_per_cost=8 * MS)
        slices = []
        sink = pkg.gw.sched_feedback_sink(fb, job)

        def recording_sink(cls, w, e, sink=sink, job=job):
            before = job.params.tslice_us
            sink(cls, w, e)
            slices.append((before, job.params.tslice_us, w, e))

        gw = pkg.gw.Gateway(
            [be], clock=clock,
            quotas={"chat": pkg.admission.TenantQuota(
                rate=1e6, burst=1e6, slo="interactive", max_queued=128),
                "bulk": pkg.admission.TenantQuota(rate=1e6, burst=1e6)},
            feedback_sink=recording_sink, feedback_period_ns=5 * MS)
        for i in range(30):
            gw.submit("chat" if i % 3 else "bulk", None, cost=2)
        for _ in range(300):
            gw.tick()
            clock.advance(MS)
        st = fb.state_of(job)
        views.append(dict(dump=fb.dump(), tslice=job.params.tslice_us,
                          boost=job.params.boost_on_wake, slices=slices,
                          contention=job.take_contention(),
                          gw=(st.gw_reports, st.gw_boosts, st.gw_hot)))
    assert views[0] == views[1]
    port = views[0]
    assert port["gw"][0] > 0 and port["gw"][1] >= 1 and port["boost"]
    assert port["tslice"] < 600
    first_boost = next(s for s in port["slices"] if s[1] < s[0])
    assert first_boost[0] == 600


class _FakeHw:
    """The duck-typed hardware-counter source ``attach_hw`` takes."""

    def __init__(self, clock):
        self.clock = clock
        self.n = 0

    def sample(self):
        self.n += 1
        return {"cycles": 1000 * self.n, "stalls": self.n % 3}

    def describe(self):
        return {"tier": "fake", "events": ["cycles", "stalls"]}


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw"])
def test_ledger_path_files_are_byte_identical(tmp_path, hw):
    files = []
    for name, pkg in (("port", PORT), ("ref", REF)):
        path = str(tmp_path / name / "gw.ledger")
        (tmp_path / name).mkdir()
        src = _FakeHw(pkg.clock.VirtualClock()) if hw else None
        view, gw = _sim_run(pkg, 0, ledger_path=path, hw=src, steps=120)
        gw.flush_trace()
        files.append([open(path + s, "rb").read()
                      for s in ("", ".meta.json", ".hist",
                                ".hist.meta.json")] + [view["stats"]])
    assert files[0] == files[1]
    meta = json.loads(files[0][1])
    assert ("source" in meta) == hw
    assert ("hw" in files[0][4]) == hw
    led = PORT.telemetry.Ledger.file_backed(str(tmp_path / "port/gw.ledger"),
                                            readonly=True)
    assert led.num_slots == 2
    done = led.snapshot(PORT.gw.GW_LEDGER_SLOTS["interactive"])
    assert int(done[PORT.telemetry.Counter.STEPS_RETIRED]) > 0


# -- the engine behind the gateway --------------------------------------

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=128)


class FakeClock:
    """Seconds that advance a fixed step on every read."""

    def __init__(self, step: float = 0.125):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def engines():
    jcfg = ref_models.TransformerConfig(**TINY, dtype=jnp.float32)
    tcfg = port_models.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = port_models.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(n_slots=2, prompt_bucket=8, max_len=32, prefix_cache_size=2)
    return {
        "ref": lambda: ref_models.ContinuousBatcher(jcfg, jparams,
                                                    clock=FakeClock(), **kw),
        "port": lambda: port_models.ContinuousBatcher(
            tcfg, tparams, clock=FakeClock(), device="cpu", **kw)}


def _engine_run(pkg, eng):
    """Two tenants in both classes through the gateway, one submission
    around it, then requests pulled back by ``drain``."""
    clock = pkg.clock.VirtualClock()
    be = pkg.gw.BatcherBackend("engine", eng)
    Q = pkg.admission.TenantQuota
    gw = pkg.gw.Gateway(
        [be], clock=clock, trace_capacity=4096,
        quotas={"chat": Q(rate=1e4, burst=64.0, weight=512,
                          slo="interactive", max_queued=8),
                "bulk": Q(rate=1e4, burst=64.0, slo="batch", max_queued=8)})
    rng = np.random.default_rng(5)
    subs, comps = [], []
    for i in range(12):
        prompt = [int(x) for x in rng.integers(1, 64, int(rng.integers(1, 9)))]
        n = int(rng.integers(1, 9))
        tenant = "chat" if n <= 4 else "bulk"
        r = gw.submit(tenant, {"prompt": prompt, "max_new": n}, cost=n)
        subs.append(dataclasses.astuple(r))
        if i == 3:
            eng.submit([9, 9], 2)  # around the gateway
        if i % 2:
            comps += gw.tick()
            clock.advance(MS)
    while gw.busy():
        comps += gw.tick()
        clock.advance(MS)
    # requests still in the engine queue come back on drain
    reqs = [pkg.fairqueue.Request(rid=f"late{i}", tenant="chat",
                                  slo="interactive", cost=1,
                                  payload={"prompt": [i + 1], "max_new": 2},
                                  submit_ns=0) for i in range(3)]
    for r in reqs:
        be.dispatch_request(r, clock.now_ns())
    drained = [r.rid for r in be.drain()]
    st = gw.stats()
    for cls in st["classes"].values():  # host-clock service times
        for k in ("latency_p50_ns", "latency_p95_ns", "latency_p99_ns"):
            cls.pop(k)
    st["backends"]["engine"].pop("service_p99_ns")
    return dict(
        subs=subs,
        comps=[(rid, info["tokens"], info["tenant"], info["slo"],
                info["queue_delay_ns"]) for rid, info in comps],
        stats=st, bypass=be.bypass_submits, drained=drained,
        depth=be.depth(), queued=len(eng.queue),
        engine={k: v for k, v in eng.stats().items()
                if not k.endswith("_s")})


def test_port_engine_behind_port_gateway_matches_the_reference(engines):
    port = _engine_run(PORT, engines["port"]())
    ref = _engine_run(REF, engines["ref"]())
    assert port == ref
    assert port["bypass"] == port["stats"]["bypass_submits"] == 1
    assert port["stats"]["admitted"] == port["stats"]["completed"] == 12
    assert port["drained"] == ["late0", "late1", "late2"]
    assert port["depth"] == port["queued"] == 0
    # the engine served every gateway request, plus the bypass
    assert port["engine"]["completed"] == 13


def test_port_engine_tokens_match_the_reference(engines):
    """Token for token, per request, through the two gateways."""
    out = []
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        eng = engines[key]()
        gw = pkg.gw.Gateway([pkg.gw.BatcherBackend("e", eng)],
                            clock=pkg.clock.VirtualClock(),
                            quotas={"t": pkg.admission.TenantQuota(
                                rate=1e4, burst=64.0)})
        by_rid = {}
        orig = eng.step

        def step(orig=orig, by_rid=by_rid):
            done = orig()
            for c in done:
                by_rid[c.request_id] = list(map(int, c.tokens))
            return done

        eng.step = step
        for i in range(5):
            gw.submit("t", {"prompt": [i + 1, 2 * i + 3], "max_new": 3 + i})
        while gw.busy():
            gw.tick()
        out.append(by_rid)
    assert out[0] == out[1] and len(out[0]) == 5


# -- the serve-demo command ---------------------------------------------


def _demo(main, argv, capsys):
    assert main(["serve-demo", *argv]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("argv", [["--requests", "5", "--slots", "2",
                                   "--prefix-cache", "0"]], ids=["5x2"])
def test_serve_demo_matches_the_reference_command(argv, capsys):
    port = _demo(port_cli.main, argv + ["--device", "cpu"], capsys)
    ref = _demo(ref_cli.main, argv, capsys)
    assert set(port) == set(ref)
    assert set(port["gateway"]) == set(ref["gateway"])
    assert set(port["sample_completion"]) == set(ref["sample_completion"])
    for k in ("completions", "shed", "completed", "tokens_emitted",
              "prefix_hits", "prefix_misses"):
        assert port[k] == ref[k], k
    assert port["completions"] == 5 and port["shed"] == 0
    assert port["gateway"]["admitted"] == port["gateway"]["completed"] == 5


def test_serve_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["serve-demo", "--requests", "1"])


# -- the journal seam and the names left for later ----------------------


def test_journal_is_refused_not_ignored(tmp_path):
    """A gateway given a journal journals into it, as the reference's
    does, and one given something that is not a journal refuses it at
    construction, before any state moves."""
    be = PORT.gw.SimServeBackend("b0")
    with pytest.raises(AttributeError, match="member_event"):
        PORT.gw.Gateway([be], journal=object())
    with pytest.raises(AttributeError, match="member_event"):
        PORT.gw.Gateway([be]).attach_journal(object())
    views = []
    for P in BOTH:
        path = str(tmp_path / f"{P.gw.__name__}.jrnl")
        journal = P.gw.GatewayJournal.create(path)
        gw = P.gw.Gateway([P.gw.SimServeBackend("b0", seed=1)],
                          clock=P.clock.VirtualClock(), journal=journal)
        gw.register_tenant("t", P.gw.TenantQuota(rate=100.0, burst=10.0))
        gw.submit("t", None, cost=2)
        gw.tick()
        journal.close()
        views.append(P.gw.read_journal(path).records)
    assert views[0] == views[1]
    ops = {rec[1] for rec in views[0]}
    assert {0x02, 0x03, 0x10, 0x11} <= ops  # MEMBER TENANT ADMIT DISPATCH
    from pbs_tpu.gateway import journal as ref_journal
    from pbs_tpu_torch.gateway import journal as port_journal

    for args in (("gw", 0, 7), ("m1", 3, 0)):
        assert (port_journal.rid_string(*args)
                == ref_journal.rid_string(*args))
    for name in ("SPEND_NONE", "SPEND_LEASED", "SPEND_CONSERVATIVE"):
        assert getattr(port_journal, name) == getattr(ref_journal, name)


@pytest.mark.parametrize("name", ["FederatedGateway", "LeaseBroker",
                                  "GatewayJournal", "recover_gateway",
                                  "run_gateway_chaos", "ProcessFederation",
                                  "MemberSupervisor"])
def test_unported_names_raise_naming_the_item(name):
    """Every name of the reference's gateway resolves in the port by
    the same name, from the same module (the process federation too,
    since it was ported): the port's gateway exports all of them."""
    import pbs_tpu_torch.gateway as port_gateway

    assert name in pbs_tpu.gateway.__all__
    assert not hasattr(port_gateway, "NOT_PORTED")
    assert sorted(port_gateway.__all__) == sorted(pbs_tpu.gateway.__all__)
    assert name in port_gateway.__all__
    got, want = getattr(port_gateway, name), getattr(pbs_tpu.gateway, name)
    assert got.__name__ == want.__name__
    assert got.__module__ == want.__module__.replace("pbs_tpu.",
                                                     "pbs_tpu_torch.")
