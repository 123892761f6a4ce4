"""Out-of-process federation: members as real OS processes.

The in-process :class:`~pbs_tpu_torch.gateway.federation.FederatedGateway`
is the deterministic witness — N member objects on one thread, one
virtual timeline, byte-reproducible goldens. This module is the
deployment-shaped twin: each member is a REAL spawned process hosting
one :class:`~pbs_tpu_torch.gateway.gateway.Gateway` pump plus its own
write-ahead intent journal, and every parent↔member interaction rides
``dist/rpc`` — idempotency tokens on every mutating op, a whole-call
deadline from the ``federation.proc.rpc_deadline_ns`` knob on every
client, so a slow or dead member sheds with retry-after instead of
hanging the parent pump.

Topology:

- the PARENT owns the durable routing/lease authority: the consistent-
  hash ring, the :class:`~pbs_tpu_torch.gateway.federation.LeaseBroker`
  banks, the tenant contracts, and one
  :class:`~pbs_tpu_torch.gateway.supervisor.MemberSupervisor` per member
  (heartbeats over rpc, miss budget, restart-with-backoff, drain on
  restart exhaustion);
- each CHILD owns exactly what dies with a real box: its fair queue,
  its admission slice (:class:`~pbs_tpu_torch.gateway.federation
  .LeasedBucket` per tenant), its backends, and its OWN journal file —
  the single durable truth for that member. ``gateway.process.kill``
  is a literal ``SIGKILL`` to the member pid; the restarted child
  rebuilds itself from its journal bytes alone
  (:func:`~pbs_tpu_torch.gateway.recovery.recover_gateway`, load-bearing
  cross-process) and reports the recovery books back over rpc.

Determinism contract: children run on parent-driven virtual time (the
``m.tick`` op carries ``now_ns``), so admission books, queue orders,
and backend service draws are a pure function of the op sequence —
a disarmed (no-kill) process run digests identically run-to-run. What
is NOT deterministic cross-process: wall-clock facts (pids, spawn
latency, which parent tick first observes a death) and therefore the
restart timeline. The chaos harness digests only the deterministic
legs and reports the rest.

Graceful degradation at every seam: a member that misses its lease
renewal (real scheduling delay now, not an injected fault) drops to
its conservative bucket by the existing ``LeasedBucket`` semantics;
an rpc timeout sheds the submit with a retry-after hint; a member that
exhausts ``federation.proc.max_restarts`` is drained from the ring and
its journaled queue handed off to survivors.

The port of ``pbs_tpu.gateway.procfed``, op for op and book for book,
so a disarmed run digests as the reference's does for the same seed
and workload (``tests/test_torch_procfed.py``). The member process
imports no torch: everything it loads (the gateway plane, the journal,
the RPC) is device-free, so a spawn costs an interpreter and the
gateway's modules, never a device runtime.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import threading
import time

from pbs_tpu_torch import knobs
from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.gateway.admission import SLO_CLASSES, TenantQuota
from pbs_tpu_torch.gateway.fairqueue import Request
from pbs_tpu_torch.gateway.federation import HashRing, LeaseBroker, LeasedBucket
from pbs_tpu_torch.gateway.supervisor import MemberSupervisor, ProcessHandle
from pbs_tpu_torch.utils.clock import MS, SEC, VirtualClock

#: Spawn handshakes, heartbeat probes, and reaps are wall-clock facts;
#: everything book-keeping consumes the parent clock's now_ns.
REAL_CLOCK_SEAM = (
    "cross-process supervision rides the host scheduler: spawn "
    "latency, kill delivery and rpc round-trips are real time")

HEARTBEAT_NS = knobs.default("federation.proc.heartbeat_ns")
MISS_BUDGET = knobs.default("federation.proc.miss_budget")
RESTART_BACKOFF_NS = knobs.default("federation.proc.restart_backoff_ns")
MAX_RESTARTS = knobs.default("federation.proc.max_restarts")
RPC_DEADLINE_NS = knobs.default("federation.proc.rpc_deadline_ns")

DEFAULT_RENEW_PERIOD_NS = knobs.default(
    "gateway.federation.renew_period_ns")
DEFAULT_LEASE_TTL_NS = knobs.default("gateway.federation.lease_ttl_ns")

#: Transport failures a parent->member call sheds on (never in-band
#: RpcError: the member executed and answered — that is a bug, not an
#: outage).
_TRANSPORT_ERRORS = (ConnectionError, socket.timeout, OSError)


# -- the member process ------------------------------------------------------


def _member_main(spec: dict) -> None:
    """Child entry point (spawn context: a fresh interpreter). Hosts
    one Gateway + its journal + an RpcServer; everything stateful is
    driven by parent ops — the child never reads a wall clock into its
    books."""
    from pbs_tpu_torch.gateway.backends import SimServeBackend
    from pbs_tpu_torch.gateway.gateway import Gateway
    from pbs_tpu_torch.gateway.journal import GatewayJournal, read_journal
    from pbs_tpu_torch.gateway.recovery import recover_gateway, replay
    from pbs_tpu_torch.obs.spans import SpanRecorder

    name = spec["name"]
    clock = VirtualClock(int(spec["start_ns"]))
    backends = [
        SimServeBackend(
            f"{name}b{j}", n_slots=int(spec["n_slots"]),
            service_ns_per_cost=int(spec["service_ns_per_cost"]),
            seed=int(spec["seed"]) * 1009 + int(spec["salt"]) * 31 + j)
        for j in range(int(spec["n_backends"]))
    ]
    spans = SpanRecorder()
    jp = spec["journal_path"]
    replayed: dict[str, dict] = {}
    recover_info: dict | None = None
    if spec["recover"]:
        # recover_gateway restores queues/counters/tenants but not
        # admission slices (that is recover_federation's job for the
        # shared-journal layout); in the per-member-journal layout the
        # slice books live HERE, so fold them out of the same bytes.
        view = read_journal(jp)
        st = replay(view.records,
                    lease_ttl_ns=int(spec["lease_ttl_ns"]))
        for (_m, tenant), s in sorted(st.slices.items()):
            book = replayed.setdefault(tenant, {
                "level": 0.0, "leased_spent": 0.0,
                "conservative_spent": 0.0, "expires_ns": 0})
            book["level"] += s.level
            book["leased_spent"] += s.leased_spent
            book["conservative_spent"] += s.conservative_spent
            book["expires_ns"] = max(book["expires_ns"], s.expires_ns)
        gw, info = recover_gateway(jp, backends, clock=clock,
                                   spans=spans)
        recover_info = {
            "generation": info.generation,
            "n_rids": len(info.rids), "n_done": len(info.done),
            "recovered": list(info.recovered),
            "requeued_inflight": list(info.requeued_inflight),
            # recover_gateway emits one SPAN_RECOVER stitch per
            # recovered rid into the recorder passed above.
            "span_recovers": len(info.recovered),
            "torn_bytes": info.torn_bytes,
            "state_digest": info.state_digest,
        }
        journal = gw._journal
    else:
        gw = Gateway(backends, clock=clock, name=name, spans=spans)
        journal = GatewayJournal.create(jp)
        gw.attach_journal(journal, autocommit=True)
    host = _MemberHost(spec, clock, gw, journal, replayed, recover_info)
    host.serve()


class _MemberHost:
    """The child's op surface. Every op runs under the RpcServer's
    single dispatch lock, so gateway state sees a serial op stream —
    the same single-threaded-pump discipline as the in-process tier."""

    def __init__(self, spec, clock, gw, journal, replayed,
                 recover_info):
        from pbs_tpu_torch.dist.rpc import RpcServer

        self.spec = spec
        self.clock = clock
        self.gw = gw
        self.journal = journal
        self.replayed = replayed
        self.recover_info = recover_info
        self.slice_params: dict[str, tuple[float, float, float]] = {}
        self.stop = threading.Event()
        self.srv = RpcServer()
        r = self.srv.register
        r("m.hb", self._op_hb)
        r("m.register_tenant", self._op_register_tenant)
        r("m.credit", self._op_credit)
        r("m.lease_state", self._op_lease_state)
        r("m.submit", self._op_submit)
        r("m.tick", self._op_tick)
        r("m.audit", self._op_audit)
        r("m.adopt_tenant", self._op_adopt_tenant)
        r("m.export_tenant", self._op_export_tenant)
        r("m.drain_books", self._op_drain_books)
        r("m.note_deposit", self._op_note_deposit)
        r("m.recover_info", self._op_recover_info)
        r("m.shutdown", self._op_shutdown)

    # -- ops -------------------------------------------------------------

    def _op_hb(self) -> dict:
        """Pump-health heartbeat. Deliberately NOT lockfree: it rides
        the same dispatch lock as every state op, so a wedged op
        stream shows up as missed heartbeats — which is the condition
        the supervisor exists to repair."""
        return {"now_ns": self.clock.now_ns(),
                "queued": self.gw.queue.depth(),
                "inflight": len(self.gw.inflight)}

    def _make_bucket(self, tenant: str, quota: TenantQuota,
                     now_ns: int) -> LeasedBucket:
        cap, cons_rate, cons_burst = self.slice_params[tenant]
        return LeasedBucket(
            tenant, self.gw.name, quota, capacity=cap,
            conservative_rate=cons_rate, conservative_burst=cons_burst,
            renew_period_ns=int(self.spec["renew_period_ns"]),
            now_ns=now_ns)

    def _op_register_tenant(self, tenant: str, quota: dict,
                            capacity: float, cons_rate: float,
                            cons_burst: float) -> dict:
        """Install/refresh one tenant contract with its slice params.
        Idempotent: a re-push after a membership change (or after this
        member recovered) reslices the live bucket; a bucket that is
        still a plain post-recovery TokenBucket is swapped for a
        LeasedBucket carrying the journal-replayed books."""
        now = self.clock.now_ns()
        q = TenantQuota(**quota)
        self.slice_params[tenant] = (float(capacity), float(cons_rate),
                                     float(cons_burst))
        if tenant not in self.gw.admission.quotas:
            self.gw.admission.bucket_factory = self._make_bucket
            self.gw.register_tenant(tenant, q, now_ns=now)
        b = self.gw.admission._buckets.get(tenant)
        if not isinstance(b, LeasedBucket):
            nb = self._make_bucket(tenant, q, now)
            book = self.replayed.get(tenant)
            if book is not None:
                # The journal's slice books: prepaid level survives
                # the crash (granted tokens are never re-minted), the
                # spend odometers keep the no-rate-inflation identity,
                # and the stale expiry leaves the bucket degraded
                # until the parent's next renewal lands — degradation
                # by real elapsed time, not by the restart itself.
                nb.level = max(0.0, book["level"])
                nb.leased_spent = book["leased_spent"]
                nb.conservative_spent = book["conservative_spent"]
                nb.expires_ns = int(book["expires_ns"])
            self.gw.admission._buckets[tenant] = nb
            b = nb
        else:
            b.reslice(float(capacity), float(cons_rate),
                      float(cons_burst))
        return {"held": b.level}

    def _op_credit(self, tenant: str, tokens: float, ttl_ns: int,
                   bank_minted: float, bank_level: float) -> dict:
        """A broker grant lands: journal the intent FIRST (the grant
        record carries the bank's post-grant odometers — recovery's
        mini-checkpoint), then credit the live bucket."""
        now = self.clock.now_ns()
        b = self.gw.admission._buckets[tenant]
        self.journal.grant(now, tenant, self.gw.name, float(tokens),
                           float(bank_minted), float(bank_level))
        b.credit(float(tokens), now, int(ttl_ns))
        return {"level": b.level}

    def _op_lease_state(self) -> dict:
        out = {}
        for tenant in sorted(self.gw.admission._buckets):
            b = self.gw.admission._buckets[tenant]
            if isinstance(b, LeasedBucket):
                out[tenant] = {"level": b.level,
                               "pending_need": b.pending_need,
                               "capacity": b.capacity}
        return out

    def _op_submit(self, tenant: str, cost: int, slo=None) -> dict:
        r = self.gw.submit(tenant, None, cost=int(cost), slo=slo)
        return {"admitted": r.admitted, "rid": r.rid,
                "reason": r.reason,
                "retry_after_ns": r.retry_after_ns}

    def _op_tick(self, now_ns: int) -> dict:
        delta = int(now_ns) - self.clock.now_ns()
        if delta > 0:
            self.clock.advance(delta)
        done = self.gw.tick()  # autocommit: seals this round's frame
        return {"done": [rid for rid, _info in done],
                "queued": self.gw.queue.depth(),
                "inflight": len(self.gw.inflight)}

    def _op_audit(self) -> dict:
        tenants = {}
        for tenant in sorted(self.gw.admission._buckets):
            b = self.gw.admission._buckets[tenant]
            if isinstance(b, LeasedBucket):
                tenants[tenant] = {
                    "leased_spent": b.leased_spent,
                    "conservative_spent": b.conservative_spent,
                    "held": b.level,
                    "degraded_takes": b.degraded_takes,
                }
        return {"tenants": tenants, "admitted": self.gw.admitted,
                "completed": self.gw.completed,
                "queued": self.gw.queue.depth(),
                "inflight": len(self.gw.inflight)}

    def _op_adopt_tenant(self, cls: str, tenant: str, reqs: list,
                         deficit: float, from_member: str) -> dict:
        """Custody transfer IN (survivor side of a failed member's
        drain): the adopting gateway journals the ADOPT_TENANT intent
        itself before its queue mutates. Payloads arrive as None —
        the journal persists scheduling state, not tenant data."""
        objs = [Request(rid=r["rid"], tenant=r["tenant"], slo=r["slo"],
                        cost=int(r["cost"]), payload=None,
                        submit_ns=int(r["submit_ns"]),
                        requeues=int(r["requeues"]))
                for r in reqs]
        self.gw.adopt_tenant(cls, tenant, objs, float(deficit),
                             from_member=from_member)
        return {"adopted": len(objs)}

    def _op_export_tenant(self, cls: str, tenant: str) -> dict:
        """Custody transfer OUT (graceful drain of a live member):
        hand this tenant's FIFO back to the parent, deficit carried."""
        reqs, deficit = self.gw.queue.take_tenant(cls, tenant)
        return {"reqs": [{"rid": r.rid, "tenant": r.tenant,
                          "slo": r.slo, "cost": r.cost,
                          "submit_ns": r.submit_ns,
                          "requeues": r.requeues} for r in reqs],
                "deficit": deficit}

    def _op_drain_books(self) -> dict:
        """Graceful drain, phase 1: zero every prepaid slice and hand
        the levels back for bank deposit; the lease is released."""
        now = self.clock.now_ns()
        out = {}
        for tenant in sorted(self.gw.admission._buckets):
            b = self.gw.admission._buckets[tenant]
            if isinstance(b, LeasedBucket) and b.level > 0:
                out[tenant] = b.level
                b.level = 0.0
                b.expires_ns = now
        return out

    def _op_note_deposit(self, tenant: str, accepted: float,
                         bank_minted: float, bank_level: float) -> dict:
        """Journal the deposit the parent's bank just accepted, with
        its post-deposit odometers (the recovery checkpoint pair of
        m.drain_books)."""
        self.journal.deposit(self.clock.now_ns(), tenant, self.gw.name,
                             float(accepted), float(bank_minted),
                             float(bank_level))
        return {"ok": True}

    def _op_recover_info(self) -> dict:
        return self.recover_info or {}

    def _op_shutdown(self) -> str:
        self.stop.set()
        return "bye"

    # -- lifecycle -------------------------------------------------------

    def serve(self) -> None:
        self.srv.start()
        host, port = self.srv.address
        # Atomic handshake: the parent polls for this file; a torn
        # write must never hand it half an address.
        tmp = self.spec["port_file"] + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host} {port} {os.getpid()}\n")
        os.replace(tmp, self.spec["port_file"])
        self.stop.wait()
        try:
            self.journal.commit()
        except Exception:  # noqa: BLE001 — best-effort final seal
            pass
        self.srv.stop()


# -- the parent --------------------------------------------------------------


@dataclasses.dataclass
class _MemberLink:
    """Parent-side state for one member process."""

    name: str
    spec: dict
    handle: ProcessHandle
    client: object
    probe: object
    pid: int
    #: rids acked to callers whose journal frame is not yet sealed
    #: (sealed by the member's next m.tick): torn if the member dies.
    pending_acks: list[str] = dataclasses.field(default_factory=list)
    last_depth: int = 0
    recovered_from_journal: bool = False
    recoveries: list[dict] = dataclasses.field(default_factory=list)


class ProcessFederation:
    """N member processes behind one submit surface, supervised.

    The parent is single-threaded: ``submit`` routes over the ring and
    rides rpc with a whole-call deadline; ``tick`` is the supervision +
    renewal + pump round. All knobs default to the registry row
    (``federation.proc.*``)."""

    def __init__(self, workdir: str, member_names: list[str], *,
                 clock=None, seed: int = 0, n_backends: int = 1,
                 n_slots: int = 2, service_ns_per_cost: int = 3 * MS,
                 renew_period_ns: int | None = None,
                 lease_ttl_ns: int | None = None,
                 heartbeat_ns: int | None = None,
                 miss_budget: int | None = None,
                 restart_backoff_ns: int | None = None,
                 max_restarts: int | None = None,
                 rpc_deadline_ns: int | None = None,
                 vnodes: int = 16):
        if not member_names:
            raise ValueError("process federation needs >= 1 member")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.clock = clock if clock is not None else VirtualClock()
        self.seed = int(seed)
        self.n_backends = int(n_backends)
        self.n_slots = int(n_slots)
        self.service_ns_per_cost = int(service_ns_per_cost)
        self.renew_period_ns = int(renew_period_ns
                                   if renew_period_ns is not None
                                   else DEFAULT_RENEW_PERIOD_NS)
        self.lease_ttl_ns = int(lease_ttl_ns if lease_ttl_ns is not None
                                else DEFAULT_LEASE_TTL_NS)
        self.heartbeat_ns = int(heartbeat_ns if heartbeat_ns is not None
                                else HEARTBEAT_NS)
        self.miss_budget = int(miss_budget if miss_budget is not None
                               else MISS_BUDGET)
        self.restart_backoff_ns = int(
            restart_backoff_ns if restart_backoff_ns is not None
            else RESTART_BACKOFF_NS)
        self.max_restarts = int(max_restarts if max_restarts is not None
                                else MAX_RESTARTS)
        self.rpc_deadline_ns = int(
            rpc_deadline_ns if rpc_deadline_ns is not None
            else RPC_DEADLINE_NS)
        self.ring = HashRing(vnodes)
        self.broker = LeaseBroker()
        self.quotas: dict[str, TenantQuota] = {}
        self.sups: dict[str, MemberSupervisor] = {}
        self.links: dict[str, _MemberLink] = {}
        self.failed: set[str] = set()
        self.admitted = 0
        self.completed = 0
        self.handoffs = 0
        self.fed_sheds: dict[str, int] = {}
        self.torn_acks = 0
        self.destroyed: dict[str, float] = {}
        self._recovered_spent: dict[str, tuple[float, float]] = {}
        self.durable_rids: set[str] = set()
        self.completed_rids: set[str] = set()
        self.events: list[dict] = []
        self._last_renew_ns: int | None = None
        self._audit_cache: dict[str, dict] = {}
        self._member_names = list(member_names)
        for name in member_names:
            self.ring.add(name)

    # -- spawn / handshake -----------------------------------------------

    def _spec(self, name: str, recover: bool) -> dict:
        salt = 97 if not name[2:].isdigit() else int(name[2:])
        return {
            "name": name,
            "journal_path": os.path.join(self.workdir,
                                         f"{name}.journal"),
            "port_file": os.path.join(self.workdir, f"{name}.port"),
            "recover": bool(recover),
            "n_backends": self.n_backends,
            "n_slots": self.n_slots,
            "service_ns_per_cost": self.service_ns_per_cost,
            "seed": self.seed,
            "salt": salt,
            "start_ns": self.clock.now_ns(),
            "renew_period_ns": self.renew_period_ns,
            "lease_ttl_ns": self.lease_ttl_ns,
        }

    @staticmethod
    def _await_port(port_file: str, handle: ProcessHandle,
                    timeout_s: float = 30.0) -> tuple[str, int, int]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                with open(port_file) as f:
                    line = f.read()
                if line.endswith("\n"):
                    host, port, pid = line.split()
                    return host, int(port), int(pid)
            except FileNotFoundError:
                pass
            if not handle.alive():
                raise RuntimeError(
                    f"member died during spawn (exit "
                    f"{handle.reap(timeout_s=1.0)}); see {port_file}")
            time.sleep(0.01)
        raise TimeoutError(f"member never wrote {port_file}")

    def _spawn(self, name: str, recover: bool) -> _MemberLink:
        from pbs_tpu_torch.dist.rpc import RpcClient

        spec = self._spec(name, recover)
        try:
            os.unlink(spec["port_file"])
        except FileNotFoundError:
            pass
        handle = ProcessHandle(target=_member_main, args=(spec,))
        handle.start()
        host, port, pid = self._await_port(spec["port_file"], handle)
        deadline_s = self.rpc_deadline_ns / SEC
        client = RpcClient((host, port), fault_key=name,
                           deadline_s=deadline_s, max_retries=3)
        probe = RpcClient((host, port), fault_key=f"{name}/probe",
                          max_retries=0, timeout_s=deadline_s,
                          deadline_s=deadline_s)
        link = _MemberLink(name=name, spec=spec, handle=handle,
                           client=client, probe=probe, pid=pid)
        self.links[name] = link
        return link

    def start(self) -> None:
        now = self.clock.now_ns()
        for name in self._member_names:
            self.sups[name] = MemberSupervisor(
                name, heartbeat_ns=self.heartbeat_ns,
                miss_budget=self.miss_budget,
                restart_backoff_ns=self.restart_backoff_ns,
                max_restarts=self.max_restarts, now_ns=now)
            link = self._spawn(name, recover=False)
            self.sups[name].spawned(link.pid, now)
            self.events.append({"now_ns": now, "event": "spawn",
                                "gateway": name, "pid": link.pid})

    # -- membership views ------------------------------------------------

    def _active(self) -> list[str]:
        """Members that hold admission slices: everything not failed
        (a down-but-restarting member keeps its slice — its journal
        still owns its books)."""
        return [n for n in sorted(self.links) if n not in self.failed]

    def _reachable(self) -> list[str]:
        return [n for n in sorted(self.links)
                if self.sups[n].state in ("live", "suspect")]

    # -- tenants + leases ------------------------------------------------

    def register_tenant(self, tenant: str, quota: TenantQuota) -> None:
        now = self.clock.now_ns()
        self.quotas[tenant] = quota
        self.broker.register(tenant, quota, now)
        for name in self._reachable():
            self._push_tenant(name, tenant)
            self._renew_member(name, only_tenant=tenant)

    def _slice_args(self, quota: TenantQuota) -> dict:
        n = max(1, len(self._active()))
        frac = 1.0 / (2.0 * n)
        return {"capacity": quota.burst / n,
                "cons_rate": quota.rate * frac,
                "cons_burst": max(1.0, quota.burst * frac)}

    def _push_tenant(self, name: str, tenant: str) -> bool:
        quota = self.quotas[tenant]
        try:
            self.links[name].client.call(
                "m.register_tenant", tenant=tenant,
                quota=dataclasses.asdict(quota),
                **self._slice_args(quota))
            return True
        except _TRANSPORT_ERRORS:
            return False  # lease lapse covers it; supervisor repairs

    def _renew_member(self, name: str,
                      only_tenant: str | None = None) -> None:
        """One member's renewal round: read its slice levels, grant
        the top-up from the bank, push the credit. A push that fails
        in transport deposits the grant straight back — the bank never
        leaks tokens to a dead wire."""
        now = self.clock.now_ns()
        link = self.links[name]
        try:
            state = link.client.call("m.lease_state")
        except _TRANSPORT_ERRORS:
            return  # unreachable: its leases lapse, degraded mode
        for tenant in sorted(state):
            if only_tenant is not None and tenant != only_tenant:
                continue
            s = state[tenant]
            want = max(s["capacity"], s["pending_need"]) - s["level"]
            lease = self.broker.grant(tenant, name, max(0.0, want),
                                      now, self.lease_ttl_ns)
            if lease is None:
                continue
            bank = self.broker.banks[tenant]
            try:
                link.client.call(
                    "m.credit", tenant=tenant, tokens=lease.tokens,
                    ttl_ns=self.lease_ttl_ns,
                    bank_minted=bank.minted, bank_level=bank.level)
            except _TRANSPORT_ERRORS:
                self.broker.deposit(tenant, name, lease.tokens, now)

    # -- intake ----------------------------------------------------------

    def _shed(self, reason: str, retry_after_ns: int) -> dict:
        self.fed_sheds[reason] = self.fed_sheds.get(reason, 0) + 1
        return {"admitted": False, "rid": None, "reason": reason,
                "retry_after_ns": int(retry_after_ns)}

    def route(self, tenant: str) -> str | None:
        live = self._reachable()
        if not live:
            return None
        home = self.ring.lookup(tenant)
        if home in live:
            return home
        return min(live,
                   key=lambda n: (self.links[n].last_depth, n))

    def submit(self, tenant: str, cost: int = 1,
               slo: str | None = None) -> dict:
        target = self.route(tenant)
        if target is None:
            return self._shed("no-gateway", self.rpc_deadline_ns)
        link = self.links[target]
        try:
            r = link.client.call("m.submit", tenant=tenant,
                                 cost=int(cost), slo=slo)
        except _TRANSPORT_ERRORS:
            # Shed with retry-after, never hang the caller: the
            # deadline already bounded the whole retry loop.
            return self._shed("rpc-timeout", self.rpc_deadline_ns)
        if r["admitted"]:
            self.admitted += 1
            link.pending_acks.append(r["rid"])
        return r

    # -- supervision + pump ----------------------------------------------

    def kill9(self, name: str) -> None:
        """Literal SIGKILL to the member pid (the realized
        ``gateway.process.kill`` fault point). Detection, restart and
        recovery ride the normal supervision path on later ticks."""
        link = self.links[name]
        self.events.append({"now_ns": self.clock.now_ns(),
                            "event": "sigkill", "gateway": name,
                            "pid": link.pid})
        link.handle.kill9()

    def _on_death(self, name: str, now: int, why: str) -> None:
        link = self.links[name]
        link.handle.reap(timeout_s=2.0)
        if link.pending_acks:
            # The unacked suffix: admitted acks whose journal frame
            # never sealed. Their callers hold a non-durable ack — the
            # cross-process at-least-once contract (RecoveryInfo).
            self.torn_acks += len(link.pending_acks)
            link.pending_acks.clear()
        self.events.append({"now_ns": now, "event": "death",
                            "gateway": name, "why": why})
        verdict = self.sups[name].died(now)
        if verdict == "drain":
            self._drain_failed(name, now)

    def _respawn(self, name: str, now: int) -> None:
        try:
            link = self._spawn(name, recover=True)
        except (RuntimeError, TimeoutError):
            verdict = self.sups[name].died(now)
            if verdict == "drain":
                self._drain_failed(name, now)
            return
        self.sups[name].spawned(link.pid, now)
        link.recovered_from_journal = True
        try:
            link.recoveries.append(
                link.client.call("m.recover_info"))
        except _TRANSPORT_ERRORS:
            pass
        self._audit_cache.pop(name, None)
        self.events.append({"now_ns": now, "event": "recover",
                            "gateway": name, "pid": link.pid})
        # Re-push every tenant: the register op swaps post-recovery
        # plain buckets for LeasedBuckets carrying the journal books,
        # then the renewal re-leases them.
        for tenant in sorted(self.quotas):
            self._push_tenant(name, tenant)
        self._renew_member(name)

    def _drain_failed(self, name: str, now: int) -> None:
        """Restart budget exhausted: remove the member from the ring
        and hand its JOURNALED queue to survivors (its journal is the
        only truth left — the process is gone). Held tokens die with
        the box (destroyed, never re-minted); its spend odometers fold
        into the federation books so every lease_audit identity
        survives."""
        from pbs_tpu_torch.gateway.journal import read_journal
        from pbs_tpu_torch.gateway.recovery import (
            apply_recover_transform,
            replay,
        )

        self.failed.add(name)
        self.ring.remove(name)
        self.broker.revoke(name)
        self._audit_cache.pop(name, None)
        self.events.append({"now_ns": now, "event": "drain-failed",
                            "gateway": name})
        jp = self.links[name].spec["journal_path"]
        try:
            st = replay(read_journal(jp).records,
                        lease_ttl_ns=self.lease_ttl_ns)
        except Exception:  # noqa: BLE001 — journal gone: nothing to hand off
            return
        apply_recover_transform(st)
        for (_m, tenant), s in sorted(st.slices.items()):
            if s.level > 0:
                self.destroyed[tenant] = (
                    self.destroyed.get(tenant, 0.0) + s.level)
            prev = self._recovered_spent.get(tenant, (0.0, 0.0))
            self._recovered_spent[tenant] = (
                prev[0] + s.leased_spent,
                prev[1] + s.conservative_spent)
        targets = self._reachable()
        if not targets:
            return  # queued work stays journaled; nobody can adopt
        for (member, cls, tenant), rids in sorted(st.queues.items()):
            if not rids:
                continue
            reqs = [{"rid": rid, "tenant": st.reqs[rid].tenant,
                     "slo": st.reqs[rid].cls,
                     "cost": st.reqs[rid].cost,
                     "submit_ns": st.reqs[rid].submit_ns,
                     "requeues": st.reqs[rid].requeues}
                    for rid in rids]
            target = min(targets,
                         key=lambda n: (self.links[n].last_depth, n))
            try:
                self.links[target].client.call(
                    "m.adopt_tenant", cls=cls, tenant=tenant,
                    reqs=reqs,
                    deficit=st.deficits.get((member, cls, tenant),
                                            0.0),
                    from_member=name)
                self.handoffs += len(reqs)
            except _TRANSPORT_ERRORS:
                continue  # adopter unreachable; rids stay journaled

    def drain(self, name: str) -> None:
        """Graceful removal of a LIVE member: collect + deposit its
        prepaid tokens, hand its queues off, retire it from the ring."""
        now = self.clock.now_ns()
        link = self.links[name]
        try:
            books = link.client.call("m.drain_books")
            for tenant in sorted(books):
                accepted = self.broker.deposit(tenant, name,
                                               books[tenant], now)
                bank = self.broker.banks[tenant]
                link.client.call("m.note_deposit", tenant=tenant,
                                 accepted=accepted,
                                 bank_minted=bank.minted,
                                 bank_level=bank.level)
            for cls in SLO_CLASSES:
                for tenant in sorted(self.quotas):
                    out = link.client.call("m.export_tenant", cls=cls,
                                           tenant=tenant)
                    if not out["reqs"]:
                        continue
                    targets = [n for n in self._reachable()
                               if n != name]
                    if not targets:
                        break
                    target = min(
                        targets,
                        key=lambda n: (self.links[n].last_depth, n))
                    self.links[target].client.call(
                        "m.adopt_tenant", cls=cls, tenant=tenant,
                        reqs=out["reqs"], deficit=out["deficit"],
                        from_member=name)
                    self.handoffs += len(out["reqs"])
        except _TRANSPORT_ERRORS:
            pass  # fall through: supervision will declare it dead
        self.ring.remove(name)
        self.broker.revoke(name)
        self.events.append({"now_ns": now, "event": "drain",
                            "gateway": name})

    def tick(self) -> list[str]:
        """One parent round: detect deaths, heartbeat, restart due
        members, renew leases, pump every reachable member. Returns
        this round's completed rids."""
        now = self.clock.now_ns()
        # 1. exits the kernel already knows about
        for name in sorted(self.links):
            sup = self.sups[name]
            if (sup.state in ("live", "suspect")
                    and not self.links[name].handle.alive()):
                self._on_death(name, now, "exit")
        # 2. heartbeats (rpc, no retries: a missed ping must stay
        #    a missed ping)
        for name in self._reachable():
            sup = self.sups[name]
            if not sup.beat_due(now):
                continue
            try:
                self.links[name].probe.call("m.hb")
                sup.beat_ok(now)
            except _TRANSPORT_ERRORS:
                if sup.beat_missed(now) == "dead":
                    # Half-dead is worse than dead: a wedged child
                    # still holds its journal fd. Kill for real, then
                    # run the death path.
                    self.links[name].handle.kill9()
                    self._on_death(name, now, "heartbeat")
        # 3. restarts that cleared their backoff
        for name in sorted(self.links):
            if self.sups[name].restart_due(now):
                self._respawn(name, now)
        # 4. renewals
        if (self._last_renew_ns is None
                or now - self._last_renew_ns >= self.renew_period_ns):
            self._last_renew_ns = now
            for name in self._reachable():
                self._renew_member(name)
        # 5. pump
        done: list[str] = []
        for name in self._reachable():
            link = self.links[name]
            try:
                r = link.client.call("m.tick", now_ns=now)
            except _TRANSPORT_ERRORS:
                continue  # heartbeat machinery owns the verdict
            link.last_depth = r["queued"] + r["inflight"]
            # The tick op sealed this member's journal frame: every
            # ack issued before it is now durable.
            if link.pending_acks:
                self.durable_rids.update(link.pending_acks)
                link.pending_acks.clear()
            fresh = [rid for rid in r["done"]
                     if rid not in self.completed_rids]
            self.completed_rids.update(fresh)
            self.completed += len(fresh)
            done.extend(fresh)
        return done

    # -- observability ---------------------------------------------------

    def queued(self) -> int:
        return sum(link.last_depth for link in self.links.values())

    def busy(self) -> bool:
        return self.queued() > 0

    def lease_audit(self) -> dict[str, dict[str, float]]:
        """The no-rate-inflation witness across processes: parent bank
        odometers joined with each member's rpc-reported spend books
        (last-known snapshot for members currently down — their truth
        is in their journal and comes back with them)."""
        audits: dict[str, dict] = {}
        for name in self._reachable():
            try:
                audits[name] = self.links[name].client.call("m.audit")
                self._audit_cache[name] = audits[name]
            except _TRANSPORT_ERRORS:
                pass
        for name in sorted(self.links):
            if name in self.failed or name in audits:
                continue
            cached = self._audit_cache.get(name)
            if cached is not None:
                audits[name] = cached
        out: dict[str, dict[str, float]] = {}
        for tenant, bank in self.broker.audit().items():
            leased = conservative = held = 0.0
            extra = self._recovered_spent.get(tenant)
            if extra is not None:
                leased, conservative = extra
            for name in sorted(audits):
                t = audits[name]["tenants"].get(tenant)
                if t is None:
                    continue
                leased += t["leased_spent"]
                conservative += t["conservative_spent"]
                held += t["held"]
            out[tenant] = {
                **bank,
                "leased_spent": leased,
                "conservative_spent": conservative,
                "held": held,
                "destroyed": self.destroyed.get(tenant, 0.0),
            }
        return out

    def stats(self) -> dict:
        members = {}
        for name in sorted(self.links):
            link = self.links[name]
            sup = self.sups[name]
            members[name] = {
                "state": sup.state,
                "pid": link.pid,
                "restarts": sup.restarts,
                "recovered_from_journal": link.recovered_from_journal,
                "depth": link.last_depth,
            }
        return {
            "admitted": self.admitted,
            "completed": self.completed,
            "handoffs": self.handoffs,
            "torn_acks": self.torn_acks,
            "shed": dict(sorted(self.fed_sheds.items())),
            "ring": self.ring.nodes(),
            "members": members,
        }

    def stop(self) -> None:
        for name in sorted(self.links):
            link = self.links[name]
            try:
                link.client.call("m.shutdown", _deadline=2.0)
            except Exception:  # noqa: BLE001 — dead members can't bow out
                pass
            link.handle.reap(timeout_s=5.0)
            for c in (link.client, link.probe):
                try:
                    c.close()
                except Exception:  # noqa: BLE001
                    pass


# -- the process-mode chaos harness ------------------------------------------


def stock_process_kill_plan(ticks: int) -> list[dict]:
    """The canonical process-mode kill schedule: one SIGKILL to the
    first member a third of the way in — early enough that recovery
    carries real load, late enough that books exist to recover."""
    return [{"tick": max(1, ticks // 3)}]


def run_process_chaos(workload: str = "mixed", seed: int = 0,
                      n_gateways: int = 2, n_tenants: int = 4,
                      ticks: int = 240, tick_ns: int = 1 * MS,
                      kill_plan: list[dict] | None = None,
                      workdir: str | None = None,
                      backends_per_gateway: int = 1,
                      heartbeat_ns: int | None = None,
                      miss_budget: int | None = None,
                      restart_backoff_ns: int | None = None,
                      max_restarts: int | None = None,
                      rpc_deadline_ns: int | None = None,
                      drain_budget: int | None = None) -> dict:
    """One seeded process-mode federation scenario; returns the report
    dict (``ok`` = every invariant held). Members are real processes;
    ``kill_plan`` entries ``{"tick": T[, "member": name]}`` become
    literal SIGKILLs realized through the ``gateway.process.kill``
    fault point. The killed member recovers from its journal bytes
    alone while survivors keep serving (its tenants route to them
    through the ring fallback for the whole down window).

    Deterministic legs (digest-covered): the arrival schedule is a
    pure function of ``(workload, seed)``; a DISARMED run (no kills)
    additionally digests the full end-state books — same seed, same
    digest. Armed runs report the kill/restart timeline instead of
    digesting it: which parent tick observes a SIGKILL is a host-
    scheduler fact."""
    import tempfile

    from pbs_tpu_torch.faults import FaultPlan, FaultSpec
    from pbs_tpu_torch.gateway.chaos import (
        catalog_arrivals,
        draw_arrival,
        quota_for,
    )
    from pbs_tpu_torch.sim.workload import build_workload

    tenants = build_workload(workload, seed=seed, n_tenants=n_tenants)
    arrivals = catalog_arrivals(tenants, seed, tag=13)
    member_names = [f"gw{i}" for i in range(n_gateways)]
    armed = kill_plan is not None and len(kill_plan) > 0
    specs = []
    kill_ticks: dict[str, int] = {}
    for e in (kill_plan or []):
        victim = e.get("member", member_names[0])
        kill_ticks[victim] = int(e["tick"])
        specs.append(FaultSpec("gateway.process.kill", "kill",
                               p=1.0, key=victim,
                               after=int(e["tick"]), times=1))
    owns_plan = False
    if specs:
        _faults.install(FaultPlan(seed=seed, specs=tuple(specs)))
        owns_plan = True
    tmp = None
    if workdir is None:
        tmp = tempfile.TemporaryDirectory(prefix="pbst-procfed-")
        workdir = tmp.name
    problems: list[str] = []
    kills: list[dict] = []
    clock = VirtualClock()
    fed = ProcessFederation(
        workdir, member_names, clock=clock, seed=seed,
        n_backends=backends_per_gateway,
        service_ns_per_cost=3 * tick_ns,
        renew_period_ns=4 * tick_ns, lease_ttl_ns=6 * tick_ns,
        heartbeat_ns=(heartbeat_ns if heartbeat_ns is not None
                      else 8 * tick_ns),
        miss_budget=miss_budget,
        restart_backoff_ns=(restart_backoff_ns
                            if restart_backoff_ns is not None
                            else 4 * tick_ns),
        max_restarts=max_restarts,
        rpc_deadline_ns=rpc_deadline_ns)
    try:
        fed.start()
        for t in tenants:
            fed.register_tenant(
                t.name, quota_for(t.name, t.slo, t.params.weight))
        for tick in range(ticks):
            clock.advance(tick_ns)
            for t in tenants:
                fire, cost = draw_arrival(t, arrivals[t.name])
                if fire:
                    fed.submit(t.name, cost=cost, slo=t.slo)
            for name in sorted(fed.links):
                if name in fed.failed:
                    continue
                f = _faults.consult("gateway.process.kill", name)
                if f is not None:
                    kills.append({"tick": tick, "member": name,
                                  "pid": fed.links[name].pid})
                    fed.kill9(name)
            fed.tick()
        # Drain: pump until every member reports empty (recovered
        # members finish their journaled backlog here).
        budget = drain_budget if drain_budget is not None else 4 * ticks
        for _ in range(budget):
            clock.advance(tick_ns)
            fed.tick()
            if not fed.busy() and not any(
                    link.pending_acks for link in fed.links.values()):
                break
        audit = fed.lease_audit()
        elapsed_s = clock.now_ns() / SEC
        for tenant, a in sorted(audit.items()):
            quota = fed.quotas[tenant]
            bound = quota.burst + quota.rate * elapsed_s + 1e-6
            if a["minted"] > bound:
                problems.append(
                    f"mint bound: {tenant} minted {a['minted']:.3f} "
                    f"> burst + rate*t = {bound:.3f}")
            if a["granted"] > a["minted"] + 1e-6:
                problems.append(
                    f"lease audit: {tenant} granted {a['granted']:.3f}"
                    f" > minted {a['minted']:.3f}")
            backed = (a["leased_spent"] + a["held"] + a["deposited"]
                      + a["destroyed"])
            if backed > a["granted"] + 1e-6:
                problems.append(
                    f"lease audit: {tenant} spent+held+deposited+"
                    f"destroyed {backed:.3f} > granted "
                    f"{a['granted']:.3f}")
        # No job lost: every durably-acked rid completed (the drain
        # loop above ran the tier to empty).
        lost = fed.durable_rids - fed.completed_rids
        if lost:
            problems.append(
                f"no-job-lost: {len(lost)} durable rid(s) never "
                f"completed, e.g. {sorted(lost)[:3]}")
        if fed.busy():
            problems.append(
                f"drain: {fed.queued()} request(s) still queued "
                f"after the drain budget")
        for name, at in sorted(kill_ticks.items()):
            link = fed.links[name]
            sup = fed.sups[name]
            if name in fed.failed:
                continue  # budget exhaustion IS a legal outcome
            if not link.recovered_from_journal:
                problems.append(
                    f"recovery: {name} was SIGKILLed at tick {at} "
                    f"but never recovered from its journal")
            elif not link.recoveries:
                problems.append(
                    f"recovery: {name} restarted without reporting "
                    f"recovery books")
            else:
                info = link.recoveries[-1]
                if info.get("span_recovers", 0) != len(
                        info.get("recovered", [])):
                    problems.append(
                        f"spans: {name} stitched "
                        f"{info.get('span_recovers')} SPAN_RECOVER "
                        f"chains for {len(info.get('recovered', []))}"
                        f" recovered rids")
            if sup.restarts < 1:
                problems.append(
                    f"supervision: {name} shows no restart after "
                    f"SIGKILL")
        stats = fed.stats()
        report = {
            "harness": "procfed", "workload": workload, "seed": seed,
            "gateways": n_gateways, "tenants": n_tenants,
            "ticks": ticks, "tick_ns": tick_ns,
            "stats": stats,
            "audit": {t: {k: round(v, 6) for k, v in sorted(a.items())}
                      for t, a in sorted(audit.items())},
            "process": {
                "members": stats["members"],
                "kills": kills,
                "torn_acks": fed.torn_acks,
                "recoveries": [
                    {"member": name,
                     "generation": info.get("generation"),
                     "recovered": len(info.get("recovered", [])),
                     "requeued_inflight": len(
                         info.get("requeued_inflight", [])),
                     "torn_bytes": info.get("torn_bytes")}
                    for name in sorted(fed.links)
                    for info in fed.links[name].recoveries],
            },
            "problems": problems,
            "ok": not problems,
        }
        sched = hashlib.sha256(json.dumps(
            {"workload": workload, "seed": seed, "ticks": ticks,
             "tenants": [t.name for t in tenants]},
            sort_keys=True).encode()).hexdigest()
        report["arrivals_digest"] = sched
        if not armed:
            # The deterministic leg: disarmed lockstep runs digest
            # their full end-state books.
            doc = {"arrivals": sched, "audit": report["audit"],
                   "admitted": fed.admitted,
                   "completed": fed.completed,
                   "shed": stats["shed"]}
            report["digest"] = hashlib.sha256(json.dumps(
                doc, sort_keys=True,
                separators=(",", ":")).encode()).hexdigest()
        return report
    finally:
        fed.stop()
        if owns_plan:
            _faults.uninstall()
        if tmp is not None:
            tmp.cleanup()
