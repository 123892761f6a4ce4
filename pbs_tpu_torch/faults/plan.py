"""Declarative fault plans: which point, which fault, when, how often.

The "simulate the failure before the chip sees it" thesis (*Fake Runs,
Real Fixes*, PAPERS.md) applied to the control plane: instead of
poking failures ad hoc per test, a :class:`FaultPlan` names the
injection point, the fault kind, and a schedule, and the process-global
:class:`~pbs_tpu_torch.faults.injector.FaultInjector` consults the plan at
every seam. Everything is seeded — two runs of the same plan produce
the same decision stream and therefore the same fault trace digest
(the determinism witness ``pbst chaos`` gates on).

Known injection points and their fault kinds (the seams live in the
named modules; adding a point = add the seam + extend this table +
document it in docs/FAULTS.md):

====================  ==========================================  ==============
point                 fault kinds                                 seam
====================  ==========================================  ==============
``rpc.client``        drop_request, drop_reply, duplicate,        dist/rpc.py
                      garble, reset, delay                        (client side)
``rpc.server``        crash, delay                                dist/rpc.py
                                                                  (reply path)
``agent.op``          crash, slow                                 dist/agent.py
``telemetry.counters``  stall, spike                              telemetry/source.py
``ckpt.write``        torn, delay                                 ckpt/checkpoint.py
``gateway.admit``     shed, delay                                 gateway/gateway.py
``gateway.route``     misroute                                    gateway/gateway.py
``gateway.death``     kill                                        gateway/federation.py
``gateway.partition``  partition                                  gateway/federation.py
``lease.expire``      expire                                      gateway/federation.py
``autopilot.candidate``  pathological                             autopilot/pilot.py
``journal.crash``     crash                                       gateway/journal.py
                                                                  (mid-commit torn frame)
``gateway.process.kill``  kill                                    gateway/chaos.py
                                                                  (tick-boundary kill-9)
====================  ==========================================  ==============

The port's copy of ``pbs_tpu.faults.plan``, word for word, so a plan
validates and serialises the same in both packages. The port hosts the
``telemetry.counters`` seam only; the other points are declared so a
plan written for the JAX package loads here unchanged.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any

#: point -> fault kinds a plan may request there (validated up front so
#: a typo'd plan fails at install time, not silently never-fires).
POINTS: dict[str, tuple[str, ...]] = {
    "rpc.client": ("drop_request", "drop_reply", "duplicate", "garble",
                   "reset", "delay"),
    "rpc.server": ("crash", "delay"),
    "agent.op": ("crash", "slow"),
    "telemetry.counters": ("stall", "spike"),
    "ckpt.write": ("torn", "delay"),
    "gateway.admit": ("shed", "delay"),
    "gateway.route": ("misroute",),
    "gateway.death": ("kill",),
    "gateway.partition": ("partition",),
    "lease.expire": ("expire",),
    "autopilot.candidate": ("pathological",),
    "journal.crash": ("crash",),
    "gateway.process.kill": ("kill",),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    ``p`` is the per-consultation fire probability, drawn from the
    stream's own seeded generator. ``key`` restricts the rule to one
    stream key (exact, or an ``fnmatch`` glob like ``"*:run"``);
    ``None`` matches every key at the point. ``after`` skips the first
    N consultations of a stream (let the system warm up first);
    ``times`` caps fires per stream (``None`` = unlimited). ``args``
    are passed through to the seam (``delay_s``, ``factor``, ...).
    """

    point: str
    fault: str
    p: float = 1.0
    key: str | None = None
    after: int = 0
    times: int | None = None
    args: dict[str, Any] = dataclasses.field(default_factory=dict)

    def matches_key(self, key: str) -> bool:
        if self.key is None:
            return True
        if any(ch in self.key for ch in "*?["):
            return fnmatch.fnmatchcase(key, self.key)
        return key == self.key

    def as_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"point": self.point, "fault": self.fault,
                             "p": self.p}
        if self.key is not None:
            d["key"] = self.key
        if self.after:
            d["after"] = self.after
        if self.times is not None:
            d["times"] = self.times
        if self.args:
            d["args"] = dict(self.args)
        return d


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered tuple of :class:`FaultSpec` rules.

    Rule order matters: at each consultation the first matching rule
    that fires wins, so put rarer/sharper rules first.
    """

    seed: int = 0
    specs: tuple[FaultSpec, ...] = ()

    def validate(self) -> "FaultPlan":
        for i, s in enumerate(self.specs):
            kinds = POINTS.get(s.point)
            if kinds is None:
                raise ValueError(
                    f"spec[{i}]: unknown injection point {s.point!r}; "
                    f"known: {sorted(POINTS)}")
            if s.fault not in kinds:
                raise ValueError(
                    f"spec[{i}]: point {s.point!r} has no fault "
                    f"{s.fault!r}; known: {kinds}")
            if not 0.0 <= s.p <= 1.0:
                raise ValueError(f"spec[{i}]: p={s.p} outside [0, 1]")
        return self

    def as_dict(self) -> dict[str, Any]:
        return {"seed": self.seed, "specs": [s.as_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        specs = tuple(
            FaultSpec(
                point=s["point"], fault=s["fault"], p=s.get("p", 1.0),
                key=s.get("key"), after=s.get("after", 0),
                times=s.get("times"), args=dict(s.get("args", {})),
            )
            for s in d.get("specs", ()))
        return cls(seed=int(d.get("seed", 0)), specs=specs).validate()

    # -- stock plans -----------------------------------------------------

    @classmethod
    def rpc_chaos(cls, seed: int = 0, drop: float = 0.04,
                  drop_reply: float = 0.03, reset: float = 0.03,
                  duplicate: float = 0.0, garble: float = 0.0) -> "FaultPlan":
        """Transport-only adversity (the acceptance-criteria plan shape:
        ``rpc_chaos(drop=0.04, drop_reply=0.03, reset=0.03)`` is a 10 %
        drop/reset mix)."""
        specs = []
        for fault, p in (("drop_request", drop), ("drop_reply", drop_reply),
                         ("reset", reset), ("duplicate", duplicate),
                         ("garble", garble)):
            if p > 0:
                specs.append(FaultSpec("rpc.client", fault, p=p))
        return cls(seed=seed, specs=tuple(specs)).validate()

    @classmethod
    def chaos(cls, seed: int = 0) -> "FaultPlan":
        """The default ``pbst chaos`` plan: a little of everything.

        Agent-op crashes are scoped to the long ``run`` op (``*:run``)
        — lifecycle ops see transport faults (absorbed by retries +
        idempotency dedup) rather than clean op failures, which keeps a
        chaos run's setup phase convergent while still exercising every
        seam.
        """
        return cls(seed=seed, specs=(
            FaultSpec("rpc.client", "drop_request", p=0.03),
            FaultSpec("rpc.client", "drop_reply", p=0.03),
            FaultSpec("rpc.client", "duplicate", p=0.03),
            FaultSpec("rpc.client", "reset", p=0.02),
            FaultSpec("rpc.client", "garble", p=0.02),
            FaultSpec("rpc.server", "crash", p=0.02),
            FaultSpec("agent.op", "crash", p=0.04, key="*:run"),
            FaultSpec("agent.op", "slow", p=0.04, key="*:run",
                      args={"delay_s": 0.002}),
            FaultSpec("telemetry.counters", "stall", p=0.05),
            FaultSpec("telemetry.counters", "spike", p=0.02,
                      args={"factor": 50.0}),
        )).validate()

    @classmethod
    def gateway(cls, seed: int = 0) -> "FaultPlan":
        """The ``pbst chaos --plan gateway`` plan: front-door seams
        only — admission sheds capacity that exists, admission stalls
        charge phantom queue delay, and routing picks the worst live
        backend instead of the best. Streams are keyed by tenant name
        (logical, replayable). The invariant under this plan: admitted
        ⇒ completed-or-requeued, never lost (docs/GATEWAY.md)."""
        return cls(seed=seed, specs=(
            FaultSpec("gateway.admit", "shed", p=0.03,
                      args={"retry_after_ns": 10_000_000}),
            FaultSpec("gateway.admit", "delay", p=0.05,
                      args={"delay_ns": 2_000_000}),
            FaultSpec("gateway.route", "misroute", p=0.10),
        )).validate()

    @classmethod
    def federation(cls, seed: int = 0) -> "FaultPlan":
        """The ``pbst chaos --plan federation`` plan: the front-door
        TIER under fire. Gateways die outright (at most once each —
        streams are keyed by gateway name, and the federation's quorum
        guard never fences the last front door), partitions come and
        go, admission-lease renewals are refused (keyed
        ``gateway:tenant``), and the single-gateway admission/routing
        faults ride along at reduced rates. The invariants under this
        plan (docs/GATEWAY.md "Federation"): no admitted request lost
        across a GATEWAY death, global admitted cost bounded by the
        global bucket plus the accounted conservative lease slack, and
        same seed ⇒ same digest."""
        return cls(seed=seed, specs=(
            FaultSpec("gateway.death", "kill", p=0.004, after=30,
                      times=1),
            FaultSpec("gateway.partition", "partition", p=0.004, times=2,
                      args={"duration_ns": 25_000_000}),
            FaultSpec("lease.expire", "expire", p=0.10),
            FaultSpec("gateway.admit", "shed", p=0.01,
                      args={"retry_after_ns": 10_000_000}),
            FaultSpec("gateway.route", "misroute", p=0.05),
        )).validate()

    @classmethod
    def autopilot(cls, seed: int = 0) -> "FaultPlan":
        """The autopilot chaos plan (docs/AUTOPILOT.md): the full
        federation attack PLUS an adversarially bad candidate injected
        at the ``autopilot.candidate`` seam — deterministically, on
        the first proposal (p=1, once). Every pathological value is
        inside the registry's declared safe ranges, so nothing but the
        SLO-burn canary guard stands between it and the fleet; the
        invariant the chaos gate pins is that the guard ROLLS IT BACK
        to the reference profile within the guard window while
        no-job-lost and the piecewise mint bound keep holding."""
        base = cls.federation(seed)
        return cls(seed=seed, specs=(
            FaultSpec("autopilot.candidate", "pathological", p=1.0,
                      times=1),
            *base.specs,
        )).validate()
