"""Journal replay: a fresh front door from journal bytes alone.

The port of ``pbs_tpu.gateway.recovery``, fold for fold: the inverse of
:mod:`pbs_tpu_torch.gateway.journal`. :func:`replay` folds a validated
record stream into a :class:`ReplayState` (the pure state machine — no
live objects), and :func:`recover_gateway` / :func:`recover_federation`
materialize a fresh :class:`~pbs_tpu_torch.gateway.gateway.Gateway` /
:class:`~pbs_tpu_torch.gateway.federation.FederatedGateway` from it:

- queued FIFOs rebuilt **in admission order** per (member, class,
  tenant), custody transfers (REQUEUE/ADOPT/ADOPT_TENANT) replayed so
  requests live where the journal last put them;
- DRR deficits restored to the last journaled post-dispatch value and
  carried through ``restore_tenant`` — recovery IS a handoff from the
  dead process to the new one;
- requests **inflight at the crash** requeued to the front of their
  custody member's queue, oldest first, with no second admission
  charge (their backends died with the box);
- :class:`~pbs_tpu_torch.gateway.federation.LeaseBroker` books
  reconciled against the last **sealed** CKPT group, then rolled
  forward through the post-checkpoint GRANT/DEPOSIT/DESTROY records and
  the per-ADMIT spend kinds, so every ``lease_audit()`` identity holds
  on the recovered books;
- recovery **re-arms** the journal (torn tail truncated, header
  generation bumped atomically) and writes a RECOVER record, so a
  second crash replays through the first recovery; rids issued after
  recovery live in a fresh ``-r<generation>-`` namespace;
- when a span recorder is supplied, every recovered request gets a
  SPAN_RECOVER stitch event re-anchoring its chain across the restart.

What is deliberately NOT recovered (docs/DURABILITY.md): request
payloads (the journal persists scheduling state, not tenant data —
callers resend them by rid through ``payloads=``), feedback watermarks,
and plain local TokenBucket levels in the single-gateway path.
"""

from __future__ import annotations

import dataclasses
import itertools

from pbs_tpu_torch.gateway import journal as _jr
from pbs_tpu_torch.gateway.admission import (
    SHED_REASON_CODES,
    SLO_CLASSES,
    TenantQuota,
)
from pbs_tpu_torch.gateway.fairqueue import Request
from pbs_tpu_torch.gateway.journal import (
    MEMBER_EVENT_NAMES,
    GatewayJournal,
    JournalError,
    Jr,
    read_journal,
)

_REASON_NAMES = {v: k for k, v in SHED_REASON_CODES.items()}


@dataclasses.dataclass
class _Req:
    rid: str
    tenant: str
    cls: str
    cost: int
    submit_ns: int
    custody: str
    state: str = "queued"  # queued | inflight | done
    requeues: int = 0


@dataclasses.dataclass
class _Bank:
    minted: float
    granted: float = 0.0
    deposited: float = 0.0
    level: float = 0.0


@dataclasses.dataclass
class _Slice:
    level: float = 0.0
    leased_spent: float = 0.0
    conservative_spent: float = 0.0
    expires_ns: int = 0


class ReplayState:
    """The folded journal: every book the recovered objects need."""

    def __init__(self, lease_ttl_ns: int):
        self.lease_ttl_ns = int(lease_ttl_ns)
        self.names: dict[int, str] = {}
        self.member_order: list[str] = []  # add order, dead included
        self.alive: dict[str, bool] = {}
        self.draining: set[str] = set()
        self.quotas: dict[str, TenantQuota] = {}
        self.reqs: dict[str, _Req] = {}
        #: (member, cls, tenant) -> rids, FIFO order (head first).
        self.queues: dict[tuple[str, str, str], list[str]] = {}
        self.deficits: dict[tuple[str, str, str], float] = {}
        self.banks: dict[str, _Bank] = {}
        self.slices: dict[tuple[str, str], _Slice] = {}
        self.destroyed: dict[str, float] = {}
        self.sheds: dict[str, dict[str, int]] = {}
        self.member_admits: dict[str, int] = {}
        self.member_completes: dict[str, int] = {}
        self.member_dispatches: dict[str, int] = {}
        self.member_requeued: dict[str, int] = {}
        self.member_adopted: dict[str, int] = {}
        self.admitted = 0
        self.completed = 0
        self.handoffs = 0
        self.events: list[dict] = []
        self.last_ts = 0
        self._ckpt_pending: dict[str, dict[str, float]] = {}

    # -- helpers ---------------------------------------------------------

    def live_members(self) -> list[str]:
        return [m for m in self.member_order if self.alive.get(m)]

    def shed_total(self) -> int:
        return sum(n for d in self.sheds.values() for n in d.values())

    def done_rids(self) -> set[str]:
        return {r.rid for r in self.reqs.values() if r.state == "done"}

    def live_rids(self) -> list[str]:
        """Recovered (not done) rids in deterministic queue order."""
        out: list[str] = []
        for m in self.live_members():
            for cls in SLO_CLASSES:
                for key in sorted(k for k in self.queues
                                  if k[0] == m and k[1] == cls):
                    out.extend(self.queues[key])
        return out

    def _queue(self, member: str, cls: str, tenant: str) -> list[str]:
        return self.queues.setdefault((member, cls, tenant), [])

    def _remove_queued(self, req: _Req) -> None:
        key = (req.custody, req.cls, req.tenant)
        q = self.queues.get(key)
        if q and req.rid in q:
            q.remove(req.rid)

    # -- the fold --------------------------------------------------------

    def apply(self, rec: tuple[int, ...]) -> None:
        ts, op = int(rec[0]), int(rec[1])
        a = [int(w) for w in rec[2:]]
        self.last_ts = max(self.last_ts, ts)
        if op == Jr.INTERN:
            return  # the table is prebuilt by iter_interned
        if op == Jr.MEMBER:
            name = self.names[a[0]]
            event = MEMBER_EVENT_NAMES.get(a[1], "?")
            if event == "add":
                if not self.alive.get(name):
                    if name not in self.member_order:
                        self.member_order.append(name)
                    self.alive[name] = True
                    self.events.append({"now_ns": ts, "event": "add",
                                        "gateway": name})
                return  # re-adds (recovery topology image) idempotent
            if event == "drain":
                if name in self.draining:
                    return  # recovery's re-mark: idempotent
                self.draining.add(name)
            else:  # kill | retire
                if not self.alive.get(name):
                    return
                self.alive[name] = False
                self.draining.discard(name)
            self.events.append(
                {"now_ns": ts,
                 "event": "remove" if event == "retire" else event,
                 "gateway": name})
            return
        if op == Jr.TENANT:
            name = self.names[a[0]]
            quota = TenantQuota(
                rate=_jr._w2f(a[1]), burst=_jr._w2f(a[2]),
                weight=a[3], slo=SLO_CLASSES[a[4]], max_queued=a[5])
            self.quotas[name] = quota
            if name not in self.banks:  # re-registration is idempotent
                self.banks[name] = _Bank(minted=quota.burst,
                                         level=quota.burst)
            return
        if op == Jr.ADMIT:
            member, rid, tenant = (self.names[a[0]], self.names[a[1]],
                                   self.names[a[2]])
            cls = SLO_CLASSES[a[3]]
            req = _Req(rid=rid, tenant=tenant, cls=cls, cost=a[4],
                       submit_ns=ts, custody=member)
            self.reqs[rid] = req
            self._queue(member, cls, tenant).append(rid)
            self.admitted += 1
            self.member_admits[member] = \
                self.member_admits.get(member, 0) + 1
            s = self.slices.setdefault((member, tenant), _Slice())
            if a[5] == _jr.SPEND_LEASED:
                s.leased_spent += a[4]
                s.level -= a[4]
            elif a[5] == _jr.SPEND_CONSERVATIVE:
                s.conservative_spent += a[4]
            return
        if op == Jr.DISPATCH:
            member, rid = self.names[a[0]], self.names[a[1]]
            req = self.reqs[rid]
            self._remove_queued(req)
            req.custody = member
            req.state = "inflight"
            self.deficits[(member, req.cls, req.tenant)] = a[2] / 1e6
            self.member_dispatches[member] = \
                self.member_dispatches.get(member, 0) + 1
            return
        if op == Jr.COMPLETE:
            member, rid = self.names[a[0]], self.names[a[1]]
            req = self.reqs[rid]
            req.state = "done"
            req.custody = member
            self.completed += 1
            self.member_completes[member] = \
                self.member_completes.get(member, 0) + 1
            return
        if op == Jr.SHED:
            member, tenant = self.names[a[0]], self.names[a[1]]
            reason = _REASON_NAMES.get(a[3], "unknown")
            per = self.sheds.setdefault(member, {})
            per[reason] = per.get(reason, 0) + 1
            return
        if op in (Jr.REQUEUE, Jr.ADOPT):
            member, rid = self.names[a[0]], self.names[a[1]]
            req = self.reqs[rid]
            if req.state == "queued":
                self._remove_queued(req)
            req.custody = member
            req.state = "queued"
            req.requeues += 1
            self._queue(member, req.cls, req.tenant).insert(0, rid)
            if op == Jr.REQUEUE:
                self.member_requeued[member] = \
                    self.member_requeued.get(member, 0) + 1
            else:
                self.member_adopted[member] = \
                    self.member_adopted.get(member, 0) + 1
                self.handoffs += 1
            return
        if op == Jr.ADOPT_TENANT:
            to, frm, tenant = (self.names[a[0]], self.names[a[1]],
                               self.names[a[2]])
            cls = SLO_CLASSES[a[3]]
            moved = self.queues.pop((frm, cls, tenant), [])
            dst = self._queue(to, cls, tenant)
            dst[:0] = moved  # front, order preserved (restore_tenant)
            for rid in moved:
                self.reqs[rid].custody = to
            key = (to, cls, tenant)
            self.deficits[key] = max(self.deficits.get(key, 0.0),
                                     a[4] / 1e6)
            self.handoffs += len(moved)
            self.member_adopted[to] = \
                self.member_adopted.get(to, 0) + len(moved)
            return
        if op == Jr.GRANT:
            tenant, member = self.names[a[0]], self.names[a[1]]
            tokens = _jr._w2f(a[2])
            bank = self.banks[tenant]
            bank.minted = _jr._w2f(a[3])
            bank.level = _jr._w2f(a[4])
            bank.granted += tokens
            s = self.slices.setdefault((member, tenant), _Slice())
            s.level += tokens
            s.expires_ns = ts + self.lease_ttl_ns
            return
        if op == Jr.DEPOSIT:
            tenant, member = self.names[a[0]], self.names[a[1]]
            bank = self.banks[tenant]
            bank.minted = _jr._w2f(a[3])
            bank.level = _jr._w2f(a[4])
            bank.deposited += _jr._w2f(a[2])
            s = self.slices.setdefault((member, tenant), _Slice())
            s.level = 0.0
            s.expires_ns = ts
            return
        if op == Jr.DESTROY:
            tenant, member = self.names[a[0]], self.names[a[1]]
            self.destroyed[tenant] = \
                self.destroyed.get(tenant, 0.0) + _jr._w2f(a[2])
            s = self.slices.setdefault((member, tenant), _Slice())
            s.level = 0.0
            return
        if op == Jr.CKPT:
            self._ckpt_pending[self.names[a[0]]] = {
                "minted": _jr._w2f(a[1]), "granted": _jr._w2f(a[2]),
                "deposited": _jr._w2f(a[3]), "level": _jr._w2f(a[4]),
            }
            return
        if op == Jr.CKPT_SEAL:
            # A SEALED group is the reconciliation authority: bank
            # odometers snap to the checkpoint, post-checkpoint
            # records roll forward from there.
            for tenant, b in self._ckpt_pending.items():
                bank = self.banks.setdefault(tenant,
                                             _Bank(minted=b["minted"]))
                bank.minted = b["minted"]
                bank.granted = b["granted"]
                bank.deposited = b["deposited"]
                bank.level = b["level"]
            self._ckpt_pending = {}
            return
        if op == Jr.RECOVER:
            # The previous recovery's transform, replayed: what that
            # recovery did to the state, this replay does too.
            apply_recover_transform(self)
            self.events.append({"now_ns": ts, "event": "recover",
                                "gateway": f"g{a[0]}"})
            return
        raise JournalError(f"unknown journal op 0x{op:04x}")


def apply_recover_transform(st: ReplayState) -> list[str]:
    """What recovery does to live state — inflight-at-crash requeued
    to the FRONT of their custody member's tenant FIFO, oldest first
    (the federation's kill-repair ordering), no second admission
    charge. Shared by :func:`replay` (replaying a previous recovery's
    RECOVER record) and the recover_* entry points (performing one),
    so a twice-crashed journal replays bit-identically. Returns the
    requeued rids, oldest first."""
    inflight = sorted(
        (r for r in st.reqs.values() if r.state == "inflight"),
        key=lambda r: (r.submit_ns, r.rid), reverse=True)
    for req in inflight:
        req.state = "queued"
        req.requeues += 1
        st._queue(req.custody, req.cls, req.tenant).insert(0, req.rid)
    # Dangling checkpoint groups (CKPT without its SEAL in a sealed
    # frame) are discarded — only sealed groups reconcile.
    st._ckpt_pending = {}
    return [r.rid for r in reversed(inflight)]


def replay(records, lease_ttl_ns: int) -> ReplayState:
    st = ReplayState(lease_ttl_ns)
    for name, sid in _jr.iter_interned(records):
        st.names[sid] = name
    for rec in records:
        st.apply(rec)
    return st


def state_digest(st: ReplayState) -> str:
    """Canonical digest of a replayed state — the recovery-idempotence
    witness (recover twice ⇒ identical digest)."""
    import hashlib
    import json

    doc = {
        "members": st.live_members(),
        "draining": sorted(st.draining),
        "quotas": {t: dataclasses.asdict(q)
                   for t, q in sorted(st.quotas.items())},
        "queues": {f"{m}/{c}/{t}": rids for (m, c, t), rids
                   in sorted(st.queues.items()) if rids},
        "deficits": {f"{m}/{c}/{t}": round(d, 6) for (m, c, t), d
                     in sorted(st.deficits.items())},
        "reqs": {rid: [r.tenant, r.cls, r.cost, r.submit_ns,
                       r.custody, r.state, r.requeues]
                 for rid, r in sorted(st.reqs.items())},
        "banks": {t: {k: round(v, 6)
                      for k, v in dataclasses.asdict(b).items()}
                  for t, b in sorted(st.banks.items())},
        "slices": {f"{m}/{t}": {k: round(v, 6) if isinstance(v, float)
                                else v
                                for k, v in dataclasses.asdict(s).items()}
                   for (m, t), s in sorted(st.slices.items())},
        "destroyed": {t: round(v, 6)
                      for t, v in sorted(st.destroyed.items())},
        "sheds": {m: dict(sorted(d.items()))
                  for m, d in sorted(st.sheds.items())},
        "counters": [st.admitted, st.completed, st.handoffs],
    }
    src = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(src.encode()).hexdigest()


@dataclasses.dataclass
class RecoveryInfo:
    """What recovery knew — the reconciliation surface for callers
    holding client-side books across the crash (the chaos harness):
    everything NOT in ``rids`` was never durably admitted (the unacked
    suffix: its client never got a durable ack), and completions not
    in ``done`` will be re-delivered (at-least-once across a crash;
    rid-level dedup is the client's job, like RPC idempotency)."""

    generation: int
    rids: set[str]  # every durably admitted rid
    done: set[str]  # durably completed rids
    recovered: list[str]  # live rids re-materialized, queue order
    requeued_inflight: list[str]  # subset that was inflight at crash
    shed_total: int
    state_digest: str
    torn_bytes: int


def _restore_queues(st: ReplayState, members: dict,
                    payloads: dict | None = None) -> None:
    """Rebuild each member's fair queue from the replayed FIFOs via
    ``restore_tenant`` — admission order preserved, deficits carried,
    no admission charge (the custody-transfer surface, which is what
    recovery is)."""
    for (m, cls, tenant), rids in sorted(st.queues.items()):
        if not rids or m not in members:
            continue
        gw = members[m]
        reqs = []
        for rid in rids:
            r = st.reqs[rid]
            reqs.append(Request(
                rid=rid, tenant=r.tenant, slo=r.cls, cost=r.cost,
                payload=(payloads or {}).get(rid),
                submit_ns=r.submit_ns, requeues=r.requeues))
        gw.queue.restore_tenant(
            cls, tenant, reqs,
            deficit=st.deficits.get((m, cls, tenant), 0.0))


def _restore_member_counters(st: ReplayState, name: str, gw) -> None:
    gw.admitted = st.member_admits.get(name, 0)
    gw.completed = st.member_completes.get(name, 0)
    gw.dispatched = st.member_dispatches.get(name, 0)
    gw.requeued = st.member_requeued.get(name, 0)
    gw.adopted = st.member_adopted.get(name, 0)
    gw.admission.sheds = dict(st.sheds.get(name, {}))


def recover_gateway(path: str, backends, clock=None, spans=None,
                    payloads: dict | None = None,
                    **gw_kwargs):
    """Materialize a fresh single :class:`Gateway` from a journal.
    ``backends`` are NEW objects (the old ones died with the box);
    everything the journal knows — tenants, queued FIFOs in admission
    order, inflight-at-crash requeues, shed books, counters — is
    restored, and the returned gateway appends to the reopened
    journal (generation bumped). Returns ``(gateway, RecoveryInfo)``.
    """
    from pbs_tpu_torch.gateway.gateway import Gateway

    view = read_journal(path)
    st = replay(view.records, lease_ttl_ns=0)
    live = st.live_members()
    if len(live) != 1:
        raise JournalError(
            f"journal holds {len(live)} live members {live}; use "
            "recover_federation for a federation journal")
    name = live[0]
    requeued = apply_recover_transform(st)
    digest = state_digest(st)
    journal = GatewayJournal.reopen(path, view=view)
    gw = Gateway(backends, clock=clock, name=name, spans=spans,
                 **gw_kwargs)
    now = gw.clock.now_ns()
    for tenant, quota in sorted(st.quotas.items()):
        gw.register_tenant(tenant, quota, now_ns=now)
    _restore_queues(st, {name: gw}, payloads)
    _restore_member_counters(st, name, gw)
    gw.rid_generation = journal.generation
    gw._rids = itertools.count()
    recovered = st.live_rids()
    if gw.spans is not None:
        for rid in recovered:
            gw.spans.recover(now, rid, st.reqs[rid].custody,
                             journal.generation)
        gw.spans.flush()
    gw.attach_journal(journal, autocommit=True)
    journal.recover_mark(now, len(recovered) - len(requeued),
                         len(requeued))
    try:
        journal.commit()
    except Exception:
        # Same contract as recover_federation: a crash CAN land
        # inside recovery's own commit; recovery is idempotent, but
        # this attempt's descriptor must not leak.
        journal.abandon()
        raise
    return gw, RecoveryInfo(
        generation=journal.generation,
        rids=set(st.reqs), done=st.done_rids(), recovered=recovered,
        requeued_inflight=requeued, shed_total=st.shed_total(),
        state_digest=digest, torn_bytes=view.torn_bytes)


def recover_federation(path: str, member_factory, clock,
                       controller=None, spans=None,
                       renew_period_ns=None, lease_ttl_ns=None,
                       conservative_frac=None, vnodes: int = 64,
                       payloads: dict | None = None):
    """Materialize a fresh :class:`FederatedGateway` — members, ring,
    tenants, queues, inflight requeues, lease books, destroyed-token
    accounting, membership event history — from journal bytes alone,
    re-armed on the reopened journal. ``member_factory(name)`` builds
    one bare member gateway (fresh backends, shared ``clock``).
    Returns ``(federation, RecoveryInfo)``.

    A journal whose sealed frames hold NO live members — the crash
    tore the very first frame, before even the topology image was
    durable — raises :class:`JournalError`: there is nothing to
    recover, and only the caller knows the boot topology. Treat it as
    a cold boot (reopen the journal to bump the generation, rebuild
    the tier as at first start, roll back every client-side book —
    nothing was ever durably acked); the chaos harness's
    ``_cold_boot`` is the reference implementation."""
    from pbs_tpu_torch.gateway.federation import (
        DEFAULT_LEASE_TTL_NS,
        DEFAULT_RENEW_PERIOD_NS,
        FederatedGateway,
    )

    renew_period_ns = (DEFAULT_RENEW_PERIOD_NS if renew_period_ns is None
                       else int(renew_period_ns))
    lease_ttl_ns = (DEFAULT_LEASE_TTL_NS if lease_ttl_ns is None
                    else int(lease_ttl_ns))
    view = read_journal(path)
    st = replay(view.records, lease_ttl_ns=lease_ttl_ns)
    requeued = apply_recover_transform(st)
    digest = state_digest(st)
    journal = GatewayJournal.reopen(path, view=view)
    live = st.live_members()
    if not live:
        raise JournalError("journal holds no live members to recover")
    members = [member_factory(name) for name in live]
    fed = FederatedGateway(
        members, controller=controller, clock=clock, vnodes=vnodes,
        renew_period_ns=renew_period_ns, lease_ttl_ns=lease_ttl_ns,
        conservative_frac=conservative_frac, spans=spans)
    now = clock.now_ns()
    # Draining state FIRST: slice capacities derive from the
    # non-draining member count at bucket creation, and a draining
    # member already left the ring before the crash.
    fed._draining = set(st.draining)
    for name in sorted(st.draining):
        fed.ring.remove(name)
    # Manual tenant registration — the normal register_tenant path
    # would mint fresh initial grants AND consume lease.expire fault
    # stream draws recovery has no right to; every book it would
    # build is overwritten from the journal below.
    for tenant, quota in sorted(st.quotas.items()):
        fed.quotas[tenant] = quota
        fed.broker.register(tenant, quota, now)
        for name in sorted(fed.members):
            fed.members[name].register_tenant(tenant, quota, now_ns=now)
    # Lease books: banks from the reconciled replay odometers...
    for tenant, book in sorted(st.banks.items()):
        bank = fed.broker.banks.get(tenant)
        if bank is None:
            continue
        bank.minted = book.minted
        bank.granted = book.granted
        bank.deposited = book.deposited
        bank.level = max(0.0, book.level)
        # Mint resumes from the recovery instant: the gap between the
        # last journaled refill and the crash is FORFEITED, never
        # back-minted — conservative under the piecewise bound.
        bank._last_ns = now
    # ...and member slices from grants minus journaled spends. A
    # member that no longer exists as an object (killed/retired
    # before the crash) folds its spend odometers into the
    # federation-level recovered-spend books, so the lease-audit
    # "admitted cost is token-backed" identity survives the restart.
    for (name, tenant), s in sorted(st.slices.items()):
        gw = fed.members.get(name)
        if gw is None:
            prev = fed._recovered_spent.get(tenant, (0.0, 0.0))
            fed._recovered_spent[tenant] = (
                prev[0] + s.leased_spent,
                prev[1] + s.conservative_spent)
            continue
        b = gw.admission._buckets.get(tenant)
        if b is None:
            continue
        b.level = max(0.0, s.level)
        b.leased_spent = s.leased_spent
        b.conservative_spent = s.conservative_spent
        b.expires_ns = s.expires_ns
    fed.destroyed = dict(st.destroyed)
    _restore_queues(st, fed.members, payloads)
    for name in sorted(fed.members):
        _restore_member_counters(st, name, fed.members[name])
        fed.members[name].rid_generation = journal.generation
        fed.members[name]._rids = itertools.count()
    fed.admitted = st.admitted
    fed.completed = st.completed
    fed.handoffs = st.handoffs
    # Federation-level sheds PLUS the books of members that no longer
    # exist as objects — dead boxes' shed history must stay in the
    # aggregate books (stats() folds fed_sheds in), or the client-side
    # shed count would drift from the recovered truth.
    fed.fed_sheds = dict(st.sheds.get("@fed", {}))
    live_names = set(fed.members)
    for mname, per in sorted(st.sheds.items()):
        if mname == "@fed" or mname in live_names:
            continue
        for reason, n in sorted(per.items()):
            fed.fed_sheds[reason] = fed.fed_sheds.get(reason, 0) + n
    fed.events = [dict(e) for e in st.events]
    fed.events.append({"now_ns": now, "event": "recover",
                       "gateway": f"g{journal.generation}"})
    recovered = st.live_rids()
    if spans is not None:
        # The chain stitch: every recovered request re-anchors in the
        # new recovery epoch at its custody member.
        for rid in recovered:
            spans.recover(now, rid, st.reqs[rid].custody,
                          journal.generation)
        spans.flush()
    # Re-arm: topology image + drain marks + the RECOVER record,
    # committed immediately so the recovery itself is durable.
    fed.attach_journal(journal)
    for name in sorted(fed._draining):
        journal.member_event(now, name, "drain")
    journal.recover_mark(now, len(recovered) - len(requeued),
                         len(requeued))
    try:
        journal.commit()
    except Exception:
        # A crash CAN land inside recovery's own commit (the chaos
        # harness's journal.crash positions don't care whose commit
        # it is). Recovery is idempotent — the torn recovery frame is
        # discarded and the retry replays to the identical state —
        # but this attempt's descriptor must not leak.
        journal.abandon()
        raise
    return fed, RecoveryInfo(
        generation=journal.generation,
        rids=set(st.reqs), done=st.done_rids(), recovered=recovered,
        requeued_inflight=requeued, shed_total=st.shed_total(),
        state_digest=digest, torn_bytes=view.torn_bytes)
