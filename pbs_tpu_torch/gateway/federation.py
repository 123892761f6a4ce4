"""Federated gateway tier: N front doors, one global admission contract.

The port of ``pbs_tpu.gateway.federation``, decision for decision: the
same ring, lease arithmetic, fault-seam order and handoff order, so a
seeded run gives the reference's books and digests
(``tests/test_torch_federation.py``). Per-tenant policy (admission
state, SLO, queue credit) travels with the *tenant*, never dies with
the *box*.

- **Placement** — consistent-hash tenant→gateway placement
  (:class:`HashRing`, sha256 virtual nodes). A membership change
  (add/drain/death) remaps only the arcs the changed node owned.
- **Replicated admission** — per-tenant token-bucket levels are leased
  through one authority (:class:`LeaseBroker`, or a duck-typed
  controller's ``admission_lease`` when one is attached). Tokens are
  *minted* only at the bank (global rate × time, capped by the global
  burst) and reach a gateway only through a lease grant, so a tenant
  spraying requests across N gateways cannot get N× its global rate;
  ``lease_audit()`` proves it. When a lease lapses, admission
  *degrades* to a conservative local bucket (:class:`LeasedBucket`)
  whose scrip is accounted separately (``conservative_spent``).
- **Failover** — "admitted ⇒ completed-or-requeued, never lost" holds
  across *gateway* death: a killed member's requests hand off to the
  survivors per the new ring (``Gateway.adopt`` / ``adopt_tenant``,
  FIFO order preserved, DRR deficits carried), and a *draining* member
  additionally deposits its unspent lease tokens back to the bank. A
  dead member's unspent tokens die with it (``destroyed``).

Single-threaded like the member gateways: the owner pumps ``tick()``.
The fault seams (``gateway.death``, ``gateway.partition``,
``lease.expire``) are consulted in sorted member order, so a seeded
:class:`~pbs_tpu_torch.faults.plan.FaultPlan` replays exactly
(``pbst-torch chaos --plan federation``; docs/GATEWAY.md).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib

from pbs_tpu_torch import knobs
from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.gateway.admission import (
    SHED_REASON_CODES,
    SLO_CLASSES,
    TenantQuota,
    TokenBucket,
)
from pbs_tpu_torch.gateway.gateway import Gateway, SubmitResult
from pbs_tpu_torch.utils.clock import SEC

#: Default lease cadence: renew every period, die after ttl. The ttl is
#: deliberately < 2 renew periods, so ONE refused renewal opens a short
#: degraded window — lease loss is a condition the tier lives with, not
#: an edge case. Declared in the knob registry (gateway.federation.*).
DEFAULT_RENEW_PERIOD_NS = knobs.default("gateway.federation.renew_period_ns")
DEFAULT_LEASE_TTL_NS = knobs.default("gateway.federation.lease_ttl_ns")
#: Retry-after when no front door can serve at all.
NO_GATEWAY_RETRY_NS = knobs.default("gateway.federation.no_gateway_retry_ns")
#: Default gateway.partition fault duration before the heal fires.
PARTITION_HEAL_NS = knobs.default("gateway.federation.partition_heal_ns")
#: Sealed lease-book checkpoint cadence of an armed journal
#: (docs/DURABILITY.md; knob registry journal.checkpoint_period_ns).
JOURNAL_CKPT_PERIOD_NS = knobs.default("journal.checkpoint_period_ns")
#: Pseudo-member sid for federation-level journal records (no-gateway
#: sheds happen before any member is chosen).
FED_MEMBER = "@fed"


def _hash64(key: str) -> int:
    """Stable 64-bit point on the ring. sha256, never ``hash()`` — str
    hashing is salted per process and would silently reshuffle every
    placement on restart (the injector's rule)."""
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash placement with virtual nodes.

    Each node owns ``vnodes`` points on a 2^64 ring; a key maps to the
    first node point at or after its hash (wrapping). Disruption on
    membership change is therefore bounded to the changed node's own
    arcs: removal remaps exactly the keys it owned (~K/N), and an add
    steals keys only for itself.
    """

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._nodes: set[str] = set()
        self._points: list[int] = []
        self._owners: list[str] = []

    def _rebuild(self) -> None:
        pairs = sorted(
            (_hash64(f"{node}#{i}"), node)
            for node in self._nodes for i in range(self.vnodes))
        self._points = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]

    def add(self, node: str) -> None:
        if node in self._nodes:
            raise ValueError(f"ring already has node {node!r}")
        self._nodes.add(node)
        self._rebuild()

    def remove(self, node: str) -> None:
        """Remove if present (idempotent: a drained member has already
        left the ring when its death is reported)."""
        if node in self._nodes:
            self._nodes.discard(node)
            self._rebuild()

    def nodes(self) -> list[str]:
        return sorted(self._nodes)

    def lookup(self, key: str) -> str | None:
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, _hash64(key))
        if i == len(self._points):
            i = 0  # wrap
        return self._owners[i]


# -- the lease protocol ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lease:
    """One grant: ``tokens`` left the bank for ``gateway``'s slice of
    ``tenant``'s bucket, valid until ``expires_ns``. A lease with 0
    tokens is still a lease — validity means the authority answered;
    the token count is just the allowance it could afford."""

    tenant: str
    gateway: str
    tokens: float
    expires_ns: int


class GlobalBucket:
    """The bank: a tenant's one true token supply.

    Tokens are *minted* here only — ``rate`` per second, capped by the
    ``burst`` headroom — and only leave through :meth:`grant`. The
    mint/grant/deposit odometers never reset, so conservation is
    checkable after any run: ``granted <= minted`` and
    ``spent + held + deposited + destroyed <= granted``.
    """

    def __init__(self, rate: float, burst: float, now_ns: int):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self.minted = float(burst)
        self.granted = 0.0
        self.deposited = 0.0
        self._last_ns = int(now_ns)

    def _refill(self, now_ns: int) -> None:
        dt_ns = max(0, int(now_ns) - self._last_ns)
        self._last_ns = max(self._last_ns, int(now_ns))
        mint = min(self.rate * dt_ns / SEC, self.burst - self.level)
        if mint > 0:
            self.level += mint
            self.minted += mint

    def grant(self, want: float, now_ns: int) -> float:
        self._refill(now_ns)
        x = min(float(want), self.level)
        if x <= 0:
            return 0.0
        self.level -= x
        self.granted += x
        return x

    def deposit(self, tokens: float, now_ns: int) -> float:
        """Accept returned tokens up to the burst headroom; the excess
        is destroyed (conservative — a deposit must never let the bank
        exceed the burst it advertises). Returns the accepted amount."""
        self._refill(now_ns)
        x = min(float(tokens), self.burst - self.level)
        if x <= 0:
            return 0.0
        self.level += x
        self.deposited += x
        return x


class LeaseBroker:
    """The lease authority: one :class:`GlobalBucket` per tenant plus
    the active lease table. In clustered deployments this attaches to
    the dist Controller (``Controller.attach_admission_broker``) so
    grants ride the controller surface; standalone federations own one
    directly. All methods are driven from the federation's
    single-threaded pump."""

    def __init__(self) -> None:
        self.banks: dict[str, GlobalBucket] = {}
        self.quotas: dict[str, TenantQuota] = {}
        self.leases: dict[tuple[str, str], Lease] = {}
        #: Live multiplier on every tenant's mint rate — the
        #: hot-reloadable global throttle (knob
        #: ``gateway.admission.rate_scale``).
        self.rate_scale = 1.0

    def register(self, tenant: str, quota: TenantQuota,
                 now_ns: int) -> None:
        if tenant not in self.banks:
            self.banks[tenant] = GlobalBucket(
                quota.rate * self.rate_scale, quota.burst, now_ns)
            self.quotas[tenant] = quota

    def set_rate_scale(self, scale: float, now_ns: int) -> None:
        """Atomic live re-rate of every bank: settle each bucket's mint
        at the OLD rate up to ``now_ns``, then switch. Settling first
        keeps the mint odometer a true piecewise integral — a scale
        change can never mint retroactively, so the no-rate-inflation
        audit bound (minted <= burst + Σ scaleᵢ·rate·dtᵢ) holds across
        any number of mid-run pushes."""
        scale = float(scale)
        if not (scale > 0.0):
            from pbs_tpu_torch.knobs.registry import KnobError

            raise KnobError([f"rate_scale {scale!r} must be > 0"])
        for tenant in sorted(self.banks):
            bank = self.banks[tenant]
            bank._refill(now_ns)  # settle the old-rate interval
            bank.rate = self.quotas[tenant].rate * scale
        self.rate_scale = scale

    def grant(self, tenant: str, gateway: str, want: float,
              now_ns: int, ttl_ns: int) -> Lease | None:
        bank = self.banks.get(tenant)
        if bank is None:
            return None
        tokens = bank.grant(want, now_ns)
        lease = Lease(tenant, gateway, tokens, int(now_ns) + int(ttl_ns))
        self.leases[(tenant, gateway)] = lease
        return lease

    def deposit(self, tenant: str, gateway: str, tokens: float,
                now_ns: int) -> float:
        bank = self.banks.get(tenant)
        if bank is None:
            return 0.0
        self.leases.pop((tenant, gateway), None)
        return bank.deposit(tokens, now_ns)

    def revoke(self, gateway: str) -> None:
        """Forget a retired gateway's leases — its tokens either came
        back through deposits (drain) or died with the box (death);
        either way the active-lease table must not keep advertising a
        dead member as a holder."""
        for k in [k for k in self.leases if k[1] == gateway]:
            del self.leases[k]

    def audit(self) -> dict[str, dict[str, float]]:
        """Per-tenant odometers — one half of the no-rate-inflation
        witness (the federation's ``lease_audit`` joins the gateway
        half)."""
        return {
            t: {"minted": b.minted, "granted": b.granted,
                "deposited": b.deposited, "bank_level": b.level}
            for t, b in sorted(self.banks.items())
        }


class LeasedBucket:
    """A gateway's slice of one tenant's global bucket. Duck-types
    :class:`~pbs_tpu_torch.gateway.admission.TokenBucket`'s
    ``take``/``retry_after_ns`` surface, so the admission controller
    is unchanged — only the token *source* differs:

    - **leased** — ``level`` holds prepaid tokens that arrived through
      :meth:`credit` (a broker grant). No local minting: sustained
      rate is whatever the bank can afford, which is the tenant's
      global rate split across its gateways.
    - **degraded** — the lease lapsed (authority unreachable, or an
      injected ``lease.expire`` refused the renewal). Prepaid tokens
      remain spendable (they were genuinely granted — the bank never
      reclaims granted tokens, so spending them cannot double-issue),
      and beyond them a conservative emergency bucket mints scrip at a
      small fraction of the fair share, *starting empty* — degradation
      mints by time spent degraded, never by the transition itself.
      Successful renewal drops the emergency bucket (unspent scrip
      expires) and resumes the leased mode.

    ``leased_spent`` / ``conservative_spent`` are the odometers the
    no-rate-inflation audit reads: every admitted cost unit is one or
    the other.
    """

    def __init__(self, tenant: str, gateway: str, quota: TenantQuota,
                 capacity: float, conservative_rate: float,
                 conservative_burst: float, renew_period_ns: int,
                 now_ns: int):
        self.tenant = tenant
        self.gateway = gateway
        self.quota = quota
        self.capacity = float(capacity)  # slice cap; re-sliced on N change
        self.level = 0.0  # prepaid tokens (grants only)
        #: A legal request bigger than the slice (cost in (capacity,
        #: burst]) cannot be covered by capacity-bounded top-ups alone —
        #: without this it would shed "quota" with a retry hint that can
        #: never come true. A failed oversized take records the need and
        #: the next renewals borrow toward it (never past the global
        #: burst, and still only what the bank can afford), exactly what
        #: the one-gateway bucket would have held anyway.
        self.pending_need = 0.0
        self.expires_ns = int(now_ns)  # no lease yet
        self.renew_period_ns = int(renew_period_ns)
        self.leased_spent = 0.0
        self.conservative_spent = 0.0
        self.degraded_takes = 0
        self._cons_rate = float(conservative_rate)
        self._cons_burst = float(conservative_burst)
        self._cons: TokenBucket | None = None

    def leased(self, now_ns: int) -> bool:
        return int(now_ns) < self.expires_ns

    def reslice(self, capacity: float, conservative_rate: float,
                conservative_burst: float) -> None:
        """Membership changed: both the slice cap AND the degraded-mode
        floor re-split, so Σ slice caps ≤ global burst and Σ emergency
        rates stay ≤ half the global rate whatever N becomes (a floor
        pinned at creation time would sum past the bound after
        add/remove cycles). A live emergency bucket re-rates in place,
        its level clamped to the new burst — never minted by the
        change."""
        self.capacity = float(capacity)
        self._cons_rate = float(conservative_rate)
        self._cons_burst = float(conservative_burst)
        if self._cons is not None:
            self._cons.rate = self._cons_rate
            self._cons.burst = self._cons_burst
            self._cons.level = min(self._cons.level, self._cons_burst)

    def credit(self, tokens: float, now_ns: int, ttl_ns: int) -> None:
        """The lease path: a broker grant lands here, and ONLY here —
        this is the sole writer of leased level besides ``take`` (the
        ``gw-lease-bypass`` check flags any other)."""
        self.level += float(tokens)
        self.expires_ns = int(now_ns) + int(ttl_ns)
        self._cons = None  # recovery: unspent emergency scrip expires

    def _emergency(self, now_ns: int) -> TokenBucket:
        if self._cons is None:
            cons = TokenBucket(self._cons_rate, self._cons_burst, now_ns)
            cons.level = 0.0  # scrip accrues with degraded TIME only
            self._cons = cons
        return self._cons

    def take(self, cost: float, now_ns: int) -> bool:
        if self.level >= cost:
            self.level -= cost
            self.leased_spent += cost
            if cost >= self.pending_need:
                # The starving request (or a bigger one) got served.
                # A SMALLER take must not clear the flag — interleaved
                # small traffic would forever reset the borrow target
                # before a renewal could reach it.
                self.pending_need = 0.0
            return True
        if cost > self.capacity:
            # Oversized-but-legal (leased OR degraded): flag the borrow
            # target so the renewal loop — resuming renewals counts —
            # can accumulate past the slice cap.
            self.pending_need = max(self.pending_need,
                                    min(float(cost), self.quota.burst))
        if self.leased(now_ns):
            return False  # in-lease exhaustion: wait for the next top-up
        self.degraded_takes += 1
        if self._emergency(now_ns).take(cost, now_ns):
            self.conservative_spent += cost
            return True
        return False

    def retry_after_ns(self, cost: float, now_ns: int) -> int:
        if self.leased(now_ns):
            return max(1, self.renew_period_ns)
        if cost > self._cons_burst:
            # The emergency bucket can NEVER cover this request; its
            # refill horizon would be a retry hint that cannot come
            # true (the admission module's cost-over-burst lesson).
            # The honest hint is the lease-recovery cadence.
            return max(1, self.renew_period_ns)
        return self._emergency(now_ns).retry_after_ns(cost, now_ns)


# -- the federation ----------------------------------------------------------


class FederatedGateway:
    """N member gateways behind one submit surface.

    Members arrive fully built (each with its own backends) and MUST
    share the federation's clock — placement, leases, and the fault
    schedule are all functions of one timeline. The federation routes
    ``submit`` by consistent hash (falling back to the least-loaded
    serviceable member when the home is dead, draining, partitioned,
    or has no routable backend under a FRESH controller health view),
    pumps every live member in ``tick``, renews admission leases, and
    repairs membership changes with requeue handoff.
    """

    def __init__(self, members: list[Gateway], controller=None,
                 clock=None, vnodes: int = 64,
                 renew_period_ns: int = DEFAULT_RENEW_PERIOD_NS,
                 lease_ttl_ns: int = DEFAULT_LEASE_TTL_NS,
                 conservative_frac: float | None = None,
                 spans=None, journal=None):
        if not members:
            raise ValueError("federation needs at least one gateway")
        self.clock = clock if clock is not None else members[0].clock
        #: ONE SpanRecorder shared by every member (obs/spans.py):
        #: all members pump on this federation's single thread, so a
        #: shared ring keeps each request's chain in emission order
        #: even when custody moves between members — the stitched
        #: timeline is a property of construction, not of a merge.
        self.spans = spans
        self.controller = controller
        self.broker = LeaseBroker()
        if controller is not None and hasattr(controller,
                                              "attach_admission_broker"):
            controller.attach_admission_broker(self.broker)
        self.ring = HashRing(vnodes)
        self.renew_period_ns = int(renew_period_ns)
        self.lease_ttl_ns = int(lease_ttl_ns)
        #: Emergency-bucket share of the fair share when a lease lapses;
        #: None = 1/(2·N) at bucket-creation time, so even every member
        #: degrading at once stays under half the global rate.
        self.conservative_frac = conservative_frac
        self.members: dict[str, Gateway] = {}
        self.quotas: dict[str, TenantQuota] = {}
        self._draining: set[str] = set()
        self._partitioned: dict[str, int] = {}  # name -> heal deadline
        self._retired: list[Gateway] = []  # dead/removed, kept for audit
        self.admitted = 0
        self.completed = 0
        self.handoffs = 0
        self.remaps = 0  # membership changes (ring epochs)
        self.lease_refusals = 0
        self.fed_sheds: dict[str, int] = {}
        self.destroyed: dict[str, float] = {}  # tokens dead boxes took down
        self.events: list[dict] = []
        #: Live-knob bridge (attach_knobs): polled once per tick, so
        #: application points are a deterministic function of the
        #: federation's own timeline.
        self._knob_watcher = None
        self.applied_knobs: dict[str, float | int] = {}
        #: Per-member knob bridges (attach_knobs(per_member=True), the
        #: canary path): one member-keyed watcher each, so a scoped push
        #: reaches exactly its canary set. Adoptions are recorded in
        #: ``knob_adoptions``.
        self._knob_channel = None
        self._member_watchers: dict[str, object] = {}
        self.knob_adoptions: list[dict] = []
        #: Shadow-trace capture (a recorder's ``record``): arrivals
        #: recorded at the federation's submit surface. None = zero cost.
        self.shadow = None
        self._last_renew_ns: int | None = None
        self._health_cache: tuple[int, dict] = (-1, {})
        #: Write-ahead intent journal (gateway/journal.py,
        #: docs/DURABILITY.md): ONE journal shared by every member —
        #: membership, tenant contracts, lease grant/deposit/destroy
        #: odometer records, and sealed lease-book checkpoints are
        #: journaled here, members stage their request intents into
        #: it, and the federation group-commits ONE frame per
        #: ``tick()``. None = zero cost.
        self.journal = None
        self._last_ckpt_ns: int | None = None
        #: Spend odometers of members that no longer exist as objects
        #: (killed/retired before a crash): recovery folds them in
        #: here so ``lease_audit``'s "admitted cost is token-backed"
        #: identity survives the restart. tenant -> (leased,
        #: conservative). Empty on a never-recovered federation.
        self._recovered_spent: dict[str, tuple[float, float]] = {}
        for gw in members:
            self._attach(gw)
        if journal is not None:
            self.attach_journal(journal)

    # -- journal (docs/DURABILITY.md) ------------------------------------

    def attach_journal(self, journal) -> None:
        """Arm the shared write-ahead journal: every current and
        future member stages its request intents into it (each
        journals its own identity image on attach; commit stays with
        the federation — one frame per ``tick()``), and membership
        deaths, custody transfers, lease odometer records, and sealed
        lease-book checkpoints are journaled from here."""
        if self.journal is not None:
            raise ValueError(
                "federation already has a journal attached; one "
                "durable record owns the front door")
        self.journal = journal
        for name in sorted(self.members):
            self.members[name].attach_journal(journal, autocommit=False)

    # -- membership ------------------------------------------------------

    def _attach(self, gw: Gateway) -> None:
        if gw.name in self.members:
            raise ValueError(f"duplicate gateway name {gw.name!r}")
        if gw.clock is not self.clock:
            raise ValueError(
                f"gateway {gw.name!r} does not share the federation "
                "clock; placement and leases need one timeline")
        if gw.admission.quotas or gw.admission._buckets:
            # A member arriving with its OWN registered tenants holds
            # plain local buckets that mint at the full tenant rate —
            # an invisible bypass of the federation's global-rate
            # contract (absent from lease_audit, N× for a sprayer).
            raise ValueError(
                f"gateway {gw.name!r} has locally registered tenants "
                f"({sorted(gw.admission.quotas) or sorted(gw.admission._buckets)}); "
                "members join bare — register tenants through "
                "FederatedGateway.register_tenant, the lease path")
        if self.journal is not None:
            gw.attach_journal(self.journal, autocommit=False)
        self.members[gw.name] = gw
        gw.admission.bucket_factory = self._bucket_factory(gw.name)
        if self.spans is not None:
            gw.attach_spans(self.spans)
        if self._knob_channel is not None:
            # Per-member adoption armed: a late joiner (rejoin path)
            # gets its own member-keyed watcher, primed so it starts
            # from the channel's current applicable state instead of a
            # gap (a scoped canary value stays foreign to it).
            self._member_watchers[gw.name] = \
                self._make_member_watcher(gw.name)
        self.ring.add(gw.name)

    def _bucket_factory(self, gw_name: str):
        def make(tenant: str, quota: TenantQuota,
                 now_ns: int) -> LeasedBucket:
            n = self._slice_count()
            frac = self._conservative_share(n)
            return LeasedBucket(
                tenant, gw_name, quota,
                capacity=quota.burst / n,
                conservative_rate=quota.rate * frac,
                conservative_burst=max(1.0, quota.burst * frac),
                renew_period_ns=self.renew_period_ns, now_ns=now_ns)
        return make

    def _slice_count(self) -> int:
        """Members that hold admission slices: active and not draining
        (a draining member deposited its tokens back and takes no new
        submissions)."""
        return max(1, len([n for n in self.members
                           if n not in self._draining]))

    def _conservative_share(self, n: int) -> float:
        return (self.conservative_frac
                if self.conservative_frac is not None
                else 1.0 / (2.0 * n))

    def _reslice(self) -> None:
        """Recompute slice capacities AND degraded-mode floors after a
        membership change: the global burst stays split across the
        members that can admit (Σ caps ≤ burst), and the conservative
        emergency rates re-split too (Σ ≤ rate/2) — a floor pinned at
        bucket-creation N would sum past the global rate after enough
        add/remove cycles."""
        n = self._slice_count()
        frac = self._conservative_share(n)
        for gw in self.members.values():
            for b in gw.admission._buckets.values():
                if isinstance(b, LeasedBucket):
                    b.reslice(b.quota.burst / n, b.quota.rate * frac,
                              max(1.0, b.quota.burst * frac))

    def add(self, gw: Gateway) -> None:
        """Live membership add (scale-out or rejoin): the new member
        takes over only its own ring arcs (~K/N tenants remap to it),
        learns every known tenant, and gets initial leases."""
        now = self.clock.now_ns()
        self._attach(gw)
        for tenant, quota in sorted(self.quotas.items()):
            gw.register_tenant(tenant, quota, now_ns=now)
        self._reslice()
        self.remaps += 1
        self.events.append({"now_ns": now, "event": "add",
                            "gateway": gw.name})
        self._renew_all(now, force=True)

    def drain(self, name: str) -> None:
        """Graceful removal, phase 1: leave the ring (new placements
        remap immediately), hand queued requests off NOW — FIFO order
        and DRR deficits carried — and deposit unspent lease tokens
        back to the bank. The member keeps pumping until its inflight
        requests complete; ``tick`` retires it at zero."""
        gw = self.members[name]
        if name in self._draining:
            return
        now = self.clock.now_ns()
        if self.journal is not None:
            self.journal.member_event(now, name, "drain")
        self.events.append({"now_ns": now, "event": "drain",
                            "gateway": name})
        self.ring.remove(name)
        self._draining.add(name)
        for tenant in sorted(gw.admission._buckets):
            b = gw.admission._buckets[tenant]
            if isinstance(b, LeasedBucket) and b.level > 0:
                accepted = self._deposit(tenant, name, b.level, now)
                if self.journal is not None:
                    bank = self.broker.banks.get(tenant)
                    self.journal.deposit(
                        now, tenant, name, accepted,
                        bank.minted if bank else 0.0,
                        bank.level if bank else 0.0)
                b.level = 0.0
                b.expires_ns = now  # lease released
        self._handoff_queued(gw)
        self._reslice()
        self.remaps += 1

    def kill(self, name: str) -> None:
        """Gateway death: the front door dies with requests queued,
        requests inflight on its backends, and unspent lease tokens.
        The federation — the authoritative record of every member's
        state, the controller's view of the box — repairs it: queued
        FIFOs hand off with their deficits, inflight casualties requeue
        at the survivors' front (oldest first), the dead box's backends
        are fenced, and its unspent tokens are accounted ``destroyed``
        (never re-minted: death is conservative, not inflationary)."""
        gw = self.members.pop(name)  # no longer an adoption target
        self._member_watchers.pop(name, None)
        now = self.clock.now_ns()
        if self.journal is not None:
            self.journal.member_event(now, name, "kill")
        self.events.append({"now_ns": now, "event": "kill",
                            "gateway": name})
        self.ring.remove(name)
        self._draining.discard(name)
        self._partitioned.pop(name, None)
        for b in gw.backends:
            fail = getattr(b, "fail", None)
            if fail is not None:
                fail()
        for tenant in sorted(gw.admission._buckets):
            b = gw.admission._buckets[tenant]
            if isinstance(b, LeasedBucket) and b.level > 0:
                if self.journal is not None:
                    self.journal.destroy(now, tenant, name, b.level)
                self.destroyed[tenant] = (
                    self.destroyed.get(tenant, 0.0) + b.level)
                b.level = 0.0
        self._reslice()
        self.remaps += 1
        self._handoff_queued(gw)
        # Inflight casualties: requeue_front per request, so iterate
        # newest-first — the oldest casualty must end up at the head.
        casualties = sorted(gw.inflight.values(),
                            key=lambda r: (r.submit_ns, r.rid),
                            reverse=True)
        gw.inflight.clear()
        for req in casualties:
            target = self._handoff_target(req.tenant)
            if self.spans is not None:
                self.spans.handoff(now, req.rid, name, target.name)
            target.adopt(req)
            self.handoffs += 1
        self.broker.revoke(name)
        self._retired.append(gw)

    def _handoff_queued(self, gw: Gateway) -> None:
        now = self.clock.now_ns()
        for cls in SLO_CLASSES:
            for tenant in gw.queue.tenants(cls):
                reqs, deficit = gw.queue.take_tenant(cls, tenant)
                if not reqs:
                    continue
                target = self._handoff_target(tenant)
                if self.spans is not None:
                    for r in reqs:
                        self.spans.handoff(now, r.rid, gw.name,
                                           target.name)
                # The custody-move intent is journaled by the adopting
                # member itself, before its queue mutates.
                target.adopt_tenant(cls, tenant, reqs, deficit,
                                    from_member=gw.name)
                self.handoffs += len(reqs)

    def _handoff_target(self, tenant: str) -> Gateway:
        """The adopting member for a casualty: the tenant's new home if
        routable, else the least-loaded unpartitioned member, else ANY
        remaining member (a draining or partitioned member adopting
        work delays its exit — never-lost beats drain latency)."""
        home = self.ring.lookup(tenant)
        if home is not None and home in self.members \
                and home not in self._partitioned:
            return self.members[home]
        ranked = sorted(self.members.items())
        pool = ([g for n, g in ranked if n not in self._partitioned
                 and n not in self._draining]
                or [g for n, g in ranked if n not in self._draining]
                or [g for _, g in ranked])
        if not pool:
            raise RuntimeError("no gateway left to adopt casualties")
        return min(pool, key=lambda g: (self._member_load(g), g.name))

    def _retire(self, name: str) -> None:
        if self.journal is not None:
            self.journal.member_event(self.clock.now_ns(), name,
                                      "retire")
        gw = self.members.pop(name)
        self._member_watchers.pop(name, None)
        self._draining.discard(name)
        self._partitioned.pop(name, None)
        self.ring.remove(name)
        self.broker.revoke(name)
        self._retired.append(gw)

    # -- shadow capture ---------------------------------------------------

    def attach_shadow(self, recorder) -> None:
        """Install a shadow-trace recorder at the federation's submit
        surface: every arrival across every member is captured into
        one bounded ring (time, tenant, class, cost) with the tenant
        contracts needed to replay a window stand-alone. Purely an
        observer — no randomness, no digest movement."""
        self.shadow = recorder
        for tenant, quota in sorted(self.quotas.items()):
            recorder.note_tenant(tenant, quota)

    # -- tenants ---------------------------------------------------------

    def register_tenant(self, tenant: str, quota: TenantQuota) -> None:
        now = self.clock.now_ns()
        self.quotas[tenant] = quota
        if self.shadow is not None:
            self.shadow.note_tenant(tenant, quota)
        self.broker.register(tenant, quota, now)
        for name in sorted(self.members):
            self.members[name].register_tenant(tenant, quota, now_ns=now)
        # Initial grants for THIS tenant only — a full renewal round
        # here would be O(T²·N) over a registration loop and would
        # consume other tenants' lease.expire fault streams before the
        # run starts.
        for name in sorted(self.members):
            if name in self._partitioned or name in self._draining:
                continue
            b = self.members[name].admission._buckets.get(tenant)
            if isinstance(b, LeasedBucket):
                self._renew_one(name, tenant, b, now)

    # -- routing + intake ------------------------------------------------

    def _member_load(self, gw: Gateway) -> int:
        return gw.queue.depth() + len(gw.inflight)

    def _member_serviceable(self, gw: Gateway, health: dict) -> bool:
        """At least one backend could take a dispatch: alive, and not
        vetoed by a FRESH controller health entry (stale entries are
        unknown, not verdicts — the staleness satellite's rule)."""
        for b in gw.backends:
            if not b.alive():
                continue
            h = health.get(b.name)
            if (h is not None and not h.get("stale", False)
                    and (not h["alive"] or h["breaker"] == "open")):
                continue
            return True
        return False

    def _health(self) -> dict:
        """The controller view, snapshotted once per clock instant —
        submit bursts within a tick reuse it instead of rebuilding the
        per-agent dict per request (the member pumps' once-per-tick
        discipline, applied to intake)."""
        if self.controller is None:
            return {}
        now = self.clock.now_ns()
        stamp, view = self._health_cache
        if stamp != now:
            view = self.controller.backend_health()
            self._health_cache = (now, view)
        return view

    def route(self, tenant: str) -> Gateway | None:
        """The tenant's home member per the ring, or — when the home is
        dead, draining, partitioned, or has no routable backend — the
        least-loaded serviceable member (cross-gateway least-loaded
        routing over the same ``Controller.backend_health()`` view the
        member pumps use). None = no front door can serve at all."""
        health = self._health()
        live = [self.members[n] for n in sorted(self.members)
                if n not in self._partitioned and n not in self._draining]
        live = [g for g in live if self._member_serviceable(g, health)]
        if not live:
            return None
        home = self.ring.lookup(tenant)
        for g in live:
            if g.name == home:
                return g
        return min(live, key=lambda g: (self._member_load(g), g.name))

    def submit(self, tenant: str, payload, cost: int = 1,
               slo: str | None = None) -> SubmitResult:
        if self.shadow is not None:
            q = self.quotas.get(tenant)
            cls = slo or (q.slo if q is not None else "batch")
            self.shadow.on_submit(self.clock.now_ns(), tenant, cls,
                                  max(1, int(cost)))
        target = self.route(tenant)
        if target is None:
            # Every front door is dead/partitioned: an explicit shed
            # with a backoff hint, never a hang or a silent drop.
            if self.journal is not None:
                q = self.quotas.get(tenant)
                cls = slo or (q.slo if q is not None else "batch")
                self.journal.shed(
                    self.clock.now_ns(), FED_MEMBER, tenant,
                    SLO_CLASSES.index(cls)
                    if cls in SLO_CLASSES else 0,
                    SHED_REASON_CODES["no-gateway"])
            self.fed_sheds["no-gateway"] = \
                self.fed_sheds.get("no-gateway", 0) + 1
            return SubmitResult(False, None, "no-gateway",
                                NO_GATEWAY_RETRY_NS)
        r = target.submit(tenant, payload, cost=cost, slo=slo)
        if r.admitted:
            self.admitted += 1
        return r

    # -- live knobs -------------------------------------------------------

    def attach_knobs(self, channel, per_member: bool = False) -> None:
        """Subscribe this federation to a knob channel
        (knobs/channel.py). Pushes are adopted at the next ``tick()``
        — one poll per pump round, so mid-run reconfiguration lands at
        a deterministic point of the run's own timeline (virtual-clock
        chaos runs replay bit-identically). A push the channel
        REJECTED (malformed/out-of-range) never moves the generation,
        so it is invisible here by construction — atomicity end to
        end.

        ``per_member=True`` (the canary path) additionally creates one
        member-keyed watcher per gateway: a push scoped to a member
        subset is adopted by exactly that subset, members joining later
        get primed watchers, and every member adoption is recorded in
        ``knob_adoptions``. The default keeps the single federation-
        level watcher — bit-identical to the pre-canary behavior."""
        from pbs_tpu_torch.knobs.channel import KnobWatcher

        if self._knob_watcher is not None:
            # A second attach would silently orphan the first channel:
            # its pushes would keep validating and moving generations
            # while the federation adopts nothing — the worst kind of
            # misconfiguration (looks armed, does nothing). One
            # federation, one knob channel.
            raise ValueError(
                "federation already has a knob channel attached; "
                "one control plane owns the knob surface")
        watcher = KnobWatcher(channel)
        watcher.add(self._apply_knobs)
        self._knob_watcher = watcher
        if per_member:
            self._knob_channel = channel
            for name in sorted(self.members):
                self._member_watchers[name] = \
                    self._make_member_watcher(name)

    def _make_member_watcher(self, name: str):
        """One member-keyed watcher: scoped pushes reach exactly their
        canary set, and what the member adopted is recorded with the
        federation's own timestamp."""
        from pbs_tpu_torch.knobs.channel import KnobWatcher

        gw = self.members[name]

        def _adopt(changed: dict, values: dict,
                   _gw=gw, _name=name) -> None:
            adopted = _gw.apply_member_knobs(changed, values)
            if adopted:
                self.knob_adoptions.append({
                    "now_ns": self.clock.now_ns(),
                    "member": _name,
                    "knobs": {k: values[k] for k in adopted},
                })

        watcher = KnobWatcher(self._knob_channel, member=name)
        watcher.add(_adopt)
        # Current-state-first: the member adopts the channel's present
        # applicable truth at attach (a canary-scoped value stays
        # foreign to it), so every member carries the same reference
        # baseline before any canary starts — and a later rollback
        # restores the canary member to exactly its peers' state.
        watcher.prime()
        return watcher

    def _apply_knobs(self, changed: dict, values: dict) -> None:
        now = self.clock.now_ns()
        if "gateway.admission.rate_scale" in changed:
            # The live throttle: settle-then-switch on every bank (see
            # LeaseBroker.set_rate_scale for the audit argument).
            self.broker.set_rate_scale(
                float(changed["gateway.admission.rate_scale"]), now)
        self.applied_knobs.update(changed)
        # Digest-covered adoption record: the scenario digest proves
        # WHEN the federation adopted WHAT (gateway/chaos.py).
        self.events.append({
            "now_ns": now, "event": "knobs",
            "gateway": ",".join(f"{k}={values[k]}"
                                for k in sorted(changed)) or "-",
        })

    # -- leases ----------------------------------------------------------

    def _grant(self, tenant: str, gateway: str, want: float,
               now_ns: int) -> Lease | None:
        if self.controller is not None and hasattr(self.controller,
                                                   "admission_lease"):
            return self.controller.admission_lease(
                tenant, gateway, want, now_ns, self.lease_ttl_ns)
        return self.broker.grant(tenant, gateway, want, now_ns,
                                 self.lease_ttl_ns)

    def _deposit(self, tenant: str, gateway: str, tokens: float,
                 now_ns: int) -> float:
        if self.controller is not None and hasattr(self.controller,
                                                   "admission_deposit"):
            return self.controller.admission_deposit(
                tenant, gateway, tokens, now_ns)
        return self.broker.deposit(tenant, gateway, tokens, now_ns)

    def _renew_all(self, now_ns: int, force: bool = False) -> None:
        """One renewal round: every reachable member tops every leased
        bucket back up to its slice capacity and extends its lease.
        The ``lease.expire`` fault sits exactly where a real authority
        timeout would: the renewal simply does not happen, and the
        bucket degrades at expiry. Partitioned members cannot renew —
        their leases lapse naturally, which is the degraded-mode story,
        not a special case."""
        if (not force and self._last_renew_ns is not None
                and now_ns - self._last_renew_ns < self.renew_period_ns):
            return
        self._last_renew_ns = now_ns
        for name in sorted(self.members):
            if name in self._partitioned or name in self._draining:
                continue
            gw = self.members[name]
            for tenant in sorted(gw.admission._buckets):
                b = gw.admission._buckets[tenant]
                if isinstance(b, LeasedBucket):
                    self._renew_one(name, tenant, b, now_ns)

    def _renew_one(self, name: str, tenant: str, b: LeasedBucket,
                   now_ns: int) -> None:
        f = _faults.consult("lease.expire", f"{name}:{tenant}")
        if f is not None:
            self.lease_refusals += 1
            return
        # Top up to the slice cap — or past it toward a recorded
        # oversized-request need (bounded by the global burst; the bank
        # still only grants what it holds).
        want = max(b.capacity, b.pending_need) - b.level
        lease = self._grant(tenant, name, max(0.0, want), now_ns)
        if lease is not None:
            if self.journal is not None:
                # The grant record carries the bank's post-grant
                # odometers — each one is a sealed mini-checkpoint of
                # the mint/level state recovery rebuilds from.
                bank = self.broker.banks.get(tenant)
                self.journal.grant(
                    now_ns, tenant, name, lease.tokens,
                    bank.minted if bank else 0.0,
                    bank.level if bank else 0.0)
            b.credit(lease.tokens, now_ns, self.lease_ttl_ns)

    # -- the pump --------------------------------------------------------

    def tick(self) -> list[tuple[str, dict]]:
        """One federation round: fire membership fault seams, heal due
        partitions, renew leases, pump every reachable member, retire
        drained members that emptied. Returns this tick's completions
        across all members."""
        now = self.clock.now_ns()
        if self._knob_watcher is not None:
            self._knob_watcher.poll()
        if self._member_watchers:
            # Per-member adoption, one poll per live member per tick —
            # skipping partitioned members (a partition IS network
            # isolation; they catch up at heal through the same poll).
            for name in sorted(self._member_watchers):
                if name in self.members and name not in self._partitioned:
                    self._member_watchers[name].poll()
        for name in sorted(self.members):
            if name in self._partitioned:
                continue
            f = _faults.consult("gateway.partition", name)
            if f is not None:
                self._partitioned[name] = now + int(
                    f.args.get("duration_ns", PARTITION_HEAL_NS))
                self.events.append({"now_ns": now, "event": "partition",
                                    "gateway": name})
        for name in sorted(self.members):
            if len(self.members) <= 1:
                break  # quorum guard: never fence the last front door
            f = _faults.consult("gateway.death", name)
            if f is not None:
                self.kill(name)
        for name in sorted(self._partitioned):
            if now >= self._partitioned[name]:
                del self._partitioned[name]
                self.events.append({"now_ns": now, "event": "heal",
                                    "gateway": name})
        self._renew_all(now)
        if self.journal is not None and (
                self._last_ckpt_ns is None
                or now - self._last_ckpt_ns >= JOURNAL_CKPT_PERIOD_NS):
            # Sealed lease-book checkpoint: the bank odometers land as
            # a CKPT group recovery reconciles against
            # (docs/DURABILITY.md "Checkpoints").
            self._last_ckpt_ns = now
            self.journal.checkpoint(now, self.broker.audit())
        done: list[tuple[str, dict]] = []
        for name in sorted(self.members):
            if name in self._partitioned:
                continue
            done.extend(self.members[name].tick())
        self.completed += len(done)
        for name in sorted(self._draining):
            gw = self.members.get(name)
            if gw is not None and not gw.busy():
                self.events.append({"now_ns": now, "event": "remove",
                                    "gateway": name})
                self._retire(name)
        if self.spans is not None:
            self.spans.flush()
        if self.journal is not None:
            # ONE group-commit frame per federation round, AFTER the
            # span flush: the span ring is always a superset of the
            # committed journal, so a mid-commit crash leaves only
            # EXTRA span records (the unacked suffix), never a
            # committed intent without its span.
            self.journal.commit()
        return done

    # -- observability ---------------------------------------------------

    def queued(self) -> int:
        return sum(gw.queue.depth() for gw in self.members.values())

    def inflight_count(self) -> int:
        return sum(len(gw.inflight) for gw in self.members.values())

    def busy(self) -> bool:
        return bool(self.queued() or self.inflight_count())

    def stats(self) -> dict:
        shed: dict[str, int] = dict(self.fed_sheds)
        for gw in list(self.members.values()) + self._retired:
            for k, v in gw.admission.sheds.items():
                shed[k] = shed.get(k, 0) + v
        members = {}
        for name in sorted(self.members):
            gw = self.members[name]
            members[name] = {
                "draining": name in self._draining,
                "partitioned": name in self._partitioned,
                "queued": gw.queue.depth(),
                "inflight": len(gw.inflight),
                "admitted": gw.admitted,
                "adopted": gw.adopted,
            }
        return {
            "admitted": self.admitted,
            "completed": self.completed,
            "queued": self.queued(),
            "inflight": self.inflight_count(),
            "handoffs": self.handoffs,
            "remaps": self.remaps,
            "lease_refusals": self.lease_refusals,
            "shed": dict(sorted(shed.items())),
            "ring": self.ring.nodes(),
            "members": members,
            "retired": sorted(g.name for g in self._retired),
        }

    def lease_audit(self) -> dict[str, dict[str, float]]:
        """The no-rate-inflation witness, per tenant: bank odometers
        (minted/granted/deposited) joined with the gateway-side spend
        odometers, unspent ``held`` tokens, and tokens ``destroyed`` by
        gateway death. The chaos harness asserts the conservation laws
        over this view; see docs/GATEWAY.md."""
        out: dict[str, dict[str, float]] = {}
        everyone = list(self.members.values()) + self._retired
        for tenant, bank in self.broker.audit().items():
            leased_spent = conservative_spent = held = 0.0
            extra = self._recovered_spent.get(tenant)
            if extra is not None:
                leased_spent, conservative_spent = extra
            for gw in everyone:
                b = gw.admission._buckets.get(tenant)
                if isinstance(b, LeasedBucket):
                    leased_spent += b.leased_spent
                    conservative_spent += b.conservative_spent
                    held += b.level
            out[tenant] = {
                **bank,
                "leased_spent": leased_spent,
                "conservative_spent": conservative_spent,
                "held": held,
                "destroyed": self.destroyed.get(tenant, 0.0),
            }
        return out
