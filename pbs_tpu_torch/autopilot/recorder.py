"""Shadow-trace capture: live gateway traffic as a replayable asset.

The port of ``pbs_tpu.autopilot.recorder``: the same ring and canonical
bytes, so a window saved by either package loads in the other with an
equal digest (``tests/test_torch_autopilot.py``).

The autopilot loop's first stage (docs/AUTOPILOT.md): continuously
record what the serving tier is actually being asked to do — arrival
times, tenant, SLO class, cost — into a bounded ring, cheap enough to
leave on forever. A captured **window** is then a pure value: it
replays in background sim (autopilot/shadow.py) under any candidate
knob setting, byte-stably, because the capture carries everything a
stand-alone re-schedule needs (the tenant admission contracts ride
along) and nothing host-dependent.

Design rules, inherited from the trace/sweep substrate:

- **Observer only.** ``on_submit`` is four scalar stores into
  preallocated arrays; the recorder draws no randomness and consults
  no fault streams, so arming it moves no digest.
- **Bounded ring retention.** A long-lived gateway overwrites its
  oldest capture instead of growing; ``dropped`` counts what aged out
  (the same graceful degradation as a full trace ring).
- **Canonical bytes.** Windows serialize through the sim trace's
  canonical JSON (``sim/trace.dumps_canonical``) — sorted keys, no
  whitespace, ints only — so ``digest()`` is stable across hosts and
  the record→replay roundtrip test can pin byte equality.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from pbs_tpu_torch.sim.trace import dumps_canonical

SHADOW_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ShadowWindow:
    """One captured traffic window, self-contained and replayable.

    ``arrivals`` are ``(t_rel_ns, tenant, cls, cost)`` tuples in
    capture order, times relative to ``t0_ns``. ``tenants`` maps
    tenant name -> admission contract (``rate``/``burst``/``weight``/
    ``slo``/``max_queued``) — the quota the live tier enforced, so the
    replay admits under the same law.
    """

    t0_ns: int
    t1_ns: int
    arrivals: tuple[tuple[int, str, str, int], ...]
    tenants: dict[str, dict]
    dropped: int = 0

    def lines(self) -> list[str]:
        """Canonical JSONL encoding (meta line first, then one line
        per arrival) — what ``save`` writes and ``digest`` hashes."""
        out = [dumps_canonical({
            "kind": "shadow-meta", "v": SHADOW_SCHEMA_VERSION,
            "t0_ns": int(self.t0_ns), "t1_ns": int(self.t1_ns),
            "dropped": int(self.dropped),
            "tenants": {t: dict(sorted(m.items()))
                        for t, m in sorted(self.tenants.items())},
        })]
        out.extend(dumps_canonical({
            "kind": "arrival", "t": int(t), "tenant": tenant,
            "cls": cls, "cost": int(cost)})
            for t, tenant, cls, cost in self.arrivals)
        return out

    def digest(self) -> str:
        h = hashlib.sha256()
        for ln in self.lines():
            h.update(ln.encode())
            h.update(b"\n")
        return h.hexdigest()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for ln in self.lines():
                f.write(ln + "\n")

    @classmethod
    def load(cls, path: str) -> "ShadowWindow":
        import json

        meta = None
        arrivals: list[tuple[int, str, str, int]] = []
        with open(path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                rec = json.loads(ln)
                if rec.get("kind") == "shadow-meta":
                    meta = rec
                elif rec.get("kind") == "arrival":
                    arrivals.append((int(rec["t"]), rec["tenant"],
                                     rec["cls"], int(rec["cost"])))
        if meta is None:
            raise ValueError(f"{path}: no shadow-meta record")
        if meta.get("v") != SHADOW_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: shadow schema v{meta.get('v')!r} != "
                f"{SHADOW_SCHEMA_VERSION}")
        return cls(t0_ns=int(meta["t0_ns"]), t1_ns=int(meta["t1_ns"]),
                   arrivals=tuple(arrivals),
                   tenants={t: dict(m)
                            for t, m in meta["tenants"].items()},
                   dropped=int(meta.get("dropped", 0)))


class ShadowRecorder:
    """Bounded ring of live arrivals + the tenant contracts to replay
    them. Attach with ``Gateway.attach_shadow`` /
    ``FederatedGateway.attach_shadow``; the submit seam calls
    :meth:`on_submit` once per arrival (admitted or shed — sheds are an
    admission *outcome*; the workload is arrivals)."""

    def __init__(self, capacity: int = 1 << 15):
        if capacity < 1:
            raise ValueError("ShadowRecorder needs capacity >= 1")
        self.capacity = int(capacity)
        self._t = np.zeros(self.capacity, dtype=np.int64)
        self._tenant = np.zeros(self.capacity, dtype=np.int32)
        self._cls = np.zeros(self.capacity, dtype=np.int8)
        self._cost = np.zeros(self.capacity, dtype=np.int32)
        self._n = 0  # total ever recorded; head = n % capacity
        self._tenant_ix: dict[str, int] = {}
        self._tenant_names: list[str] = []
        self.tenant_meta: dict[str, dict] = {}
        #: SLO-class interning is fixed (two classes), index matches
        #: gateway.admission.SLO_CLASSES order for trace-friendliness.
        self._cls_ix = {"interactive": 0, "batch": 1}
        self._cls_names = ("interactive", "batch")

    # -- producers -------------------------------------------------------

    def note_tenant(self, tenant: str, quota) -> None:
        """Capture the admission contract a replay must enforce. Duck-
        typed on the TenantQuota surface; idempotent (last write
        wins, matching live re-registration)."""
        self.tenant_meta[tenant] = {
            "rate": float(quota.rate),
            "burst": float(quota.burst),
            "weight": int(quota.weight),
            "slo": str(quota.slo),
            "max_queued": int(quota.max_queued),
        }

    def on_submit(self, now_ns: int, tenant: str, cls: str,
                  cost: int) -> None:
        i = self._n % self.capacity
        self._t[i] = now_ns
        ti = self._tenant_ix.get(tenant)
        if ti is None:
            ti = self._tenant_ix[tenant] = len(self._tenant_names)
            self._tenant_names.append(tenant)
        self._tenant[i] = ti
        self._cls[i] = self._cls_ix.get(cls, 1)
        self._cost[i] = cost
        self._n += 1

    # -- consumers -------------------------------------------------------

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        """Arrivals that aged out of the ring (bounded retention)."""
        return max(0, self._n - self.capacity)

    def window(self, t0_ns: int | None = None,
               t1_ns: int | None = None) -> ShadowWindow:
        """The retained arrivals in capture order, optionally clipped
        to ``[t0_ns, t1_ns)``. Self-contained: the result carries the
        tenant contracts seen so far."""
        n = min(self._n, self.capacity)
        if n == 0:
            return ShadowWindow(t0_ns=0, t1_ns=0, arrivals=(),
                                tenants=dict(self.tenant_meta),
                                dropped=self.dropped)
        if self._n > self.capacity:
            head = self._n % self.capacity
            order = np.concatenate([np.arange(head, self.capacity),
                                    np.arange(0, head)])
        else:
            order = np.arange(0, n)
        ts = self._t[order]
        keep = np.ones(n, dtype=bool)
        if t0_ns is not None:
            keep &= ts >= int(t0_ns)
        if t1_ns is not None:
            keep &= ts < int(t1_ns)
        order = order[keep]
        ts = self._t[order]
        lo = int(ts[0]) if len(ts) else int(t0_ns or 0)
        lo = int(t0_ns) if t0_ns is not None else lo
        hi = int(t1_ns) if t1_ns is not None else \
            (int(ts[-1]) + 1 if len(ts) else lo)
        arrivals = tuple(
            (int(self._t[i]) - lo,
             self._tenant_names[int(self._tenant[i])],
             self._cls_names[int(self._cls[i])],
             int(self._cost[i]))
            for i in order.tolist())
        return ShadowWindow(t0_ns=lo, t1_ns=hi, arrivals=arrivals,
                            tenants=dict(self.tenant_meta),
                            dropped=self.dropped)
