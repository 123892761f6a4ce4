"""Admission control: per-tenant token buckets + global backpressure.

A copy of ``pbs_tpu.gateway.admission``: the same gates in the same
order, the same shed reasons and codes, the same arithmetic.

The front door's first job is saying *no* early: an overloaded serving
tier that queues unboundedly converts overload into unbounded tail
latency for everyone (the serving-tier form of the runqueue the
reference's BOOST class exists to jump). Admission therefore happens
at submit time, against three independent gates, and a rejection is an
explicit :class:`Shed` with a computed ``retry_after_ns`` — clients
get a backoff hint instead of a silently growing queue:

- **per-tenant token bucket** — ``rate`` cost-units/second with a
  ``burst`` bucket, so a tenant's sustained throughput is capped while
  short bursts ride the bucket (the classic shaper);
- **per-tenant queue depth** — even an in-quota tenant may not park
  more than ``max_queued`` requests at the gateway (quota describes
  throughput, not the right to hoard queue slots);
- **global queue depth** — the gateway-wide bound that keeps the fair
  queue's memory and latency finite under any tenant mix.

The ``gateway.admit`` fault point lives here (docs/FAULTS.md): ``shed``
forces a rejection (capacity lies), ``delay`` charges phantom queue
delay to an admitted request (a stalled admission path) — both keyed by
tenant name, so chaos streams are logical and replayable.
"""

from __future__ import annotations

import dataclasses

from pbs_tpu_torch import knobs
from pbs_tpu_torch.utils.clock import SEC

#: SLO classes the fair queue schedules between (docs/GATEWAY.md).
INTERACTIVE = "interactive"
BATCH = "batch"
SLO_CLASSES = (INTERACTIVE, BATCH)

# Admission defaults + shed retry-after hints, declared in the knob
# registry (gateway.admission.*, docs/KNOBS.md).
DEFAULT_RATE = knobs.default("gateway.admission.default_rate")
DEFAULT_BURST = knobs.default("gateway.admission.default_burst")
DEFAULT_WEIGHT = knobs.default("gateway.admission.default_weight")
DEFAULT_MAX_QUEUED = knobs.default("gateway.admission.default_max_queued")
DEFAULT_MAX_QUEUED_TOTAL = knobs.default("gateway.admission.max_queued_total")
#: Retry-after for transient pressure (queue slots drain in ~this).
SHED_RETRY_NS = knobs.default("gateway.admission.shed_retry_ns")
#: Retry-after for permanent conditions (no contract, cost can never
#: fit the bucket) — long, so contract-following clients stop hammering.
PERMANENT_RETRY_NS = knobs.default("gateway.admission.permanent_retry_ns")


@dataclasses.dataclass
class TenantQuota:
    """One tenant's admission contract."""

    rate: float = DEFAULT_RATE  # sustained cost-units per second
    burst: float = DEFAULT_BURST  # bucket capacity (peak debt)
    weight: int = DEFAULT_WEIGHT  # fair-queue share (SchedParams scale)
    slo: str = BATCH  # SLO class: "interactive" | "batch"
    max_queued: int = DEFAULT_MAX_QUEUED  # per-tenant queue-slot bound

    def __post_init__(self) -> None:
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {self.slo!r}; known: {SLO_CLASSES}")
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError("rate and burst must be > 0")


class TokenBucket:
    """Deterministic token bucket in integer-ns time, float tokens."""

    def __init__(self, rate: float, burst: float, now_ns: int = 0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self._last_ns = int(now_ns)

    def _refill(self, now_ns: int) -> None:
        dt_ns = max(0, int(now_ns) - self._last_ns)
        self._last_ns = max(self._last_ns, int(now_ns))
        self.level = min(self.burst, self.level + self.rate * dt_ns / SEC)

    def take(self, cost: float, now_ns: int) -> bool:
        self._refill(now_ns)
        if self.level >= cost:
            self.level -= cost
            return True
        return False

    def retry_after_ns(self, cost: float, now_ns: int) -> int:
        """When the bucket could cover ``cost`` (refill horizon); the
        shed hint clients back off on. 0 means "already affordable"."""
        self._refill(now_ns)
        deficit = min(cost, self.burst) - self.level
        if deficit <= 0:
            return 0
        return int(deficit / self.rate * SEC) + 1


#: Shed reasons -> stable small ints for trace args (GW_SHED and
#: SPAN_SHED records carry the code, never the string). Lives next to
#: :class:`Shed` so the taxonomy and its wire encoding stay in one
#: place; 0 is reserved for "unknown reason".
SHED_REASON_CODES = {
    "quota": 1, "tenant-queue-full": 2, "queue-full": 3,
    "unknown-tenant": 4, "injected-shed": 5, "cost-over-burst": 6,
    "no-gateway": 7,  # federation-level: every front door unreachable
}


@dataclasses.dataclass(frozen=True)
class Shed:
    """An explicit rejection: why, and when to come back."""

    reason: str  # "quota" | "tenant-queue-full" | "queue-full" |
    # "cost-over-burst" | "unknown-tenant" | "injected-shed"
    retry_after_ns: int

    @property
    def reason_code(self) -> int:
        return SHED_REASON_CODES.get(self.reason, 0)


class AdmissionController:
    """The three admission gates, consulted in deterministic order.

    Gate order matters for accounting: the global bound is checked
    before the tenant bucket so a full gateway never *charges* the
    tenant's bucket for a request it cannot take anyway.
    """

    def __init__(self, max_queued_total: int = DEFAULT_MAX_QUEUED_TOTAL,
                 default_quota: TenantQuota | None = None,
                 bucket_factory=None):
        self.max_queued_total = int(max_queued_total)
        #: Quota applied to tenants never registered explicitly; None =
        #: unknown tenants are shed outright (closed-world gateways).
        self.default_quota = default_quota
        #: The lease path's constructor hook (gateway/federation.py):
        #: ``(tenant, quota, now_ns) -> bucket`` returning anything with
        #: TokenBucket's ``take``/``retry_after_ns`` surface. A
        #: federated gateway installs a factory that builds
        #: :class:`~pbs_tpu_torch.gateway.federation.LeasedBucket` slices
        #: of the tenant's GLOBAL bucket; None = plain local TokenBucket.
        self.bucket_factory = bucket_factory
        self.quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self.sheds: dict[str, int] = {}  # reason -> count

    def _make_bucket(self, tenant: str, quota: TenantQuota,
                     now_ns: int) -> TokenBucket:
        if self.bucket_factory is not None:
            return self.bucket_factory(tenant, quota, now_ns)
        return TokenBucket(quota.rate, quota.burst, now_ns)

    def register(self, tenant: str, quota: TenantQuota,
                 now_ns: int = 0) -> None:
        self.quotas[tenant] = quota
        self._buckets[tenant] = self._make_bucket(tenant, quota, now_ns)

    def quota_of(self, tenant: str) -> TenantQuota | None:
        q = self.quotas.get(tenant)
        if q is None and self.default_quota is not None:
            return self.default_quota
        return q

    def record_shed(self, reason: str, retry_after_ns: int) -> Shed:
        """Account a shed decided elsewhere (e.g. an injected
        ``gateway.admit``/``shed`` fault) in the same books."""
        return self._shed(reason, retry_after_ns)

    def _shed(self, reason: str, retry_after_ns: int) -> Shed:
        self.sheds[reason] = self.sheds.get(reason, 0) + 1
        return Shed(reason, max(1, int(retry_after_ns)))

    def admit(self, tenant: str, cost: float, now_ns: int,
              tenant_queued: int, total_queued: int) -> Shed | None:
        """None = admitted. ``tenant_queued``/``total_queued`` are the
        fair queue's current depths (the gateway passes them in; the
        controller owns no queue state of its own)."""
        quota = self.quota_of(tenant)
        if quota is None:
            # No contract at all: permanent condition, long retry-after.
            return self._shed("unknown-tenant", PERMANENT_RETRY_NS)
        if total_queued >= self.max_queued_total:
            # Global backpressure: retry when a slot plausibly drains.
            return self._shed("queue-full", SHED_RETRY_NS)
        if tenant_queued >= quota.max_queued:
            return self._shed("tenant-queue-full", SHED_RETRY_NS)
        if cost > quota.burst:
            # The bucket can NEVER cover this request (level <= burst):
            # shedding with a finite bucket-refill hint would send a
            # contract-following client into a retry livelock. Permanent
            # condition, long retry-after — like unknown-tenant.
            return self._shed("cost-over-burst", PERMANENT_RETRY_NS)
        bucket = self._buckets.get(tenant)
        if bucket is None:  # default-quota tenant: lazily materialize
            bucket = self._buckets[tenant] = self._make_bucket(
                tenant, quota, now_ns)
        if not bucket.take(cost, now_ns):
            return self._shed("quota", bucket.retry_after_ns(cost, now_ns))
        return None
