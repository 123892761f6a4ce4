"""SLO-guarded canary knob rollout: the only door to production.

The port of ``pbs_tpu.autopilot.canary``: the same member pick, burn
arithmetic, pushes and span events, decision for decision.

A shadow-search candidate (autopilot/shadow.py) never touches every
member at once. It rolls out through the knob channel as a **scoped
push** to a canary subset of federation members
(``KnobChannel.push(..., scope=members)``; the per-member adoption
filter in ``KnobWatcher`` keeps it off everyone else), then the
controller watches **per-tenant SLO burn rate** at the canary members
over a guard window:

- every watched tenant stays under the burn limit → **promote**: one
  global push of the candidate values clears the scope and converges
  every member;
- any tenant burns past the limit (or a canary member disappears) →
  **rollback**: one global push of the *reference* values restores the
  canary members — non-canary members never adopted the candidate, so
  the same push is a no-op for them — and production is back on the
  profile it trusted.

Burn is measured delta-style from the canary members' own completion
records (``Gateway.completions`` — exact per-request e2e latencies,
not log2 buckets: a rollback tripwire must not let a pathology hide
inside the histogram bucket the target shares; the members' log2
histograms remain the cheap always-on surface, and
``LatencyHistograms.over_target`` its bucket-conservative reader).
The guard snapshots each member's completion count at rollout and
judges only what completed inside the window. Everything is
deterministic under a virtual clock: same seed ⇒ same burns ⇒ same
verdict, which is what lets the chaos harness pin rollback decisions
with golden digests.

This module is the sanctioned writer the ``rollout-discipline`` check
pass (docs/ANALYSIS.md) enforces: production code pushing knobs
anywhere else is a CI finding.
"""

from __future__ import annotations

from pbs_tpu_torch import knobs
from pbs_tpu_torch.knobs.profile import PARAM_KNOBS, params_to_knobs
from pbs_tpu_torch.obs.spans import DEFAULT_SLO_TARGET_NS, SLO_OBJECTIVE
from pbs_tpu_torch.obs.trace import Ev

#: Rollback reason codes (the AP_ROLLBACK trace arg).
ROLLBACK_BURN = 1
ROLLBACK_MEMBER_LOST = 2
ROLLBACK_NO_EVIDENCE = 3
_REASON_CODES = {"burn": ROLLBACK_BURN,
                 "member-lost": ROLLBACK_MEMBER_LOST,
                 "no-evidence": ROLLBACK_NO_EVIDENCE}

#: The adversarially bad profile the chaos gate injects through the
#: ``autopilot.candidate`` fault point: a collapsed 10 µs band (maximum
#: switch overhead under the member profile model — the paper's
#: short-slice pathology) with a hair-trigger window. Every value is
#: INSIDE the registry's declared safe ranges on purpose: the knob
#: registry cannot reject it, only the guarded rollout can.
PATHOLOGICAL_PARAMS = {
    "min_us": 10, "max_us": 10, "window": 1, "grow_step_us": 1,
    "qdelay_threshold_ns": 2_000_000, "gw_hot_after": 3,
}


class CanaryRollout:
    """One rollout at a time: ``start`` → guard window → ``poll``
    returns the promote/rollback decision. Owned and pumped by the
    :class:`~pbs_tpu_torch.autopilot.pilot.Autopilot` on the federation's
    own timeline."""

    def __init__(self, fed, channel, policy: str = "feedback",
                 guard_window_ns: int | None = None,
                 burn_limit: float | None = None,
                 min_guard_samples: int | None = None,
                 canary_members: int | None = None):
        self.fed = fed
        self.channel = channel  # the WRITER end
        self.policy = policy
        self.guard_window_ns = int(
            guard_window_ns if guard_window_ns is not None
            else knobs.default("autopilot.guard_window_ns"))
        self.burn_limit = float(
            burn_limit if burn_limit is not None
            else knobs.default("autopilot.burn_limit"))
        self.min_guard_samples = int(
            min_guard_samples if min_guard_samples is not None
            else knobs.default("autopilot.min_guard_samples"))
        self.n_canary = int(
            canary_members if canary_members is not None
            else knobs.default("autopilot.canary_members"))
        #: The reference profile this rollout degrades to: the channel's
        #: profile-knob values at construction (what every member was
        #: primed with), captured ONCE so a mid-canary observer cannot
        #: move the rollback target.
        _, values = channel.snapshot()
        names = sorted(set(PARAM_KNOBS[self.policy].values()))
        self.reference = {n: values[n] for n in names if n in values}
        self.state = "idle"  # idle | canary
        self.members: list[str] = []
        self.candidate: dict = {}
        self._candidate_knobs: dict = {}
        self._guard_start_ns = 0
        self._guard_end_ns = 0
        self._baseline: dict[str, int] = {}

    # -- rollout ---------------------------------------------------------

    def _pick_members(self) -> list[str]:
        """The canary subset: live, unpartitioned members ranked by
        how many INTERACTIVE tenants the ring homes on them (name-
        tiebroken) — the guard judges SLO burn, so the canary must sit
        where the latency-sensitive traffic actually lands; a canary
        serving only batch tenants could never show a tight-target
        violation inside a short guard window. Deterministic function
        of membership + placement: same seed ⇒ same canary set."""
        live = [n for n in sorted(self.fed.members)
                if n not in self.fed._draining
                and n not in self.fed._partitioned]
        homes: dict[str, int] = {n: 0 for n in live}
        for tenant in sorted(self.fed.quotas):
            if self.fed.quotas[tenant].slo != "interactive":
                continue
            home = self.fed.ring.lookup(tenant)
            if home in homes:
                homes[home] += 1
        live.sort(key=lambda n: (-homes[n], n))
        return live[:max(1, self.n_canary)]

    def _tenant_target_ns(self, tenant: str) -> int:
        q = self.fed.quotas.get(tenant)
        cls = q.slo if q is not None else "batch"
        return DEFAULT_SLO_TARGET_NS.get(
            cls, DEFAULT_SLO_TARGET_NS["batch"])

    def _snapshot(self) -> dict[str, int]:
        """Per canary member completion count — the guard's delta
        baseline: only requests that complete INSIDE the window are
        evidence."""
        return {name: self.fed.members[name].completed
                for name in self.members if name in self.fed.members}

    def start(self, candidate_params: dict, now_ns: int) -> dict | None:
        """Push the candidate scoped to the canary subset and open the
        guard window. Returns the canary event record — or None when
        NO live, unpartitioned member exists to host the canary
        (chaos can drain/partition everyone at once): the rollout is
        deferred, nothing is pushed, production stays untouched."""
        if self.state != "idle":
            raise RuntimeError(f"canary already {self.state}")
        members = self._pick_members()
        if not members:
            return None
        self.candidate = dict(candidate_params)
        self._candidate_knobs = params_to_knobs(self.policy,
                                                self.candidate)
        self.members = members
        self.channel.push(dict(self._candidate_knobs),
                          scope=list(self.members))
        self._guard_start_ns = int(now_ns)
        self._guard_end_ns = int(now_ns) + self.guard_window_ns
        self._baseline = self._snapshot()
        self.state = "canary"
        self._emit(now_ns, Ev.AP_CANARY, len(self.members),
                   self.guard_window_ns)
        return {
            "event": "canary", "t_ns": int(now_ns),
            "members": list(self.members),
            "params": dict(self.candidate),
            "guard_end_ns": self._guard_end_ns,
        }

    # -- the guard -------------------------------------------------------

    def _burns(self, now_ns: int) -> dict[str, float]:
        """Per-tenant burn rate over the guard window at the canary
        members, normalized by the 1 % error budget, from EXACT
        per-request latencies — two evidence sources:

        - completions inside the window OF requests submitted inside
          the window (the member's completion records; each
          ``Gateway.completions`` deque holds 4096 entries, far
          beyond a guard window's worth), judged on their e2e
          latency — a pre-canary backlog request completing late
          inside the window carries pre-rollout queueing the
          candidate did not cause;
        - requests still queued or in flight at the member whose AGE
          already exceeds the tenant's target — they have provably
          missed it whether or not they ever complete. Without this a
          candidate that STRANGLES a tenant (the collapsed-band
          pathology: requests admitted, never finished) would leave
          no completion evidence while some healthier tenant's clean
          completions vouch for promotion. Only requests submitted
          INSIDE the guard window count: backlog predating the
          rollout (say, behind a just-healed partition) is not the
          candidate's doing and must not convict it.

        Stuck requests younger than the target are undecided and
        count as nothing. Tenants below ``min_guard_samples`` total
        judged requests carry no verdict."""
        agg: dict[str, tuple[int, int]] = {}

        def _judge(tenant: str | None, over: bool) -> None:
            if tenant is None:
                return
            ao, at = agg.get(tenant, (0, 0))
            agg[tenant] = (ao + int(over), at + 1)

        for name in self.members:
            gw = self.fed.members.get(name)
            if gw is None:
                continue
            fresh = gw.completed - self._baseline.get(name, 0)
            if fresh > 0:
                recent = list(gw.completions)[
                    -min(fresh, len(gw.completions)):]
                for _, info in recent:
                    tenant = info.get("tenant")
                    if tenant is None:
                        continue
                    if int(info.get("submit_ns", 0)) \
                            < self._guard_start_ns:
                        continue  # pre-canary backlog: not evidence
                    _judge(tenant,
                           int(info.get("latency_ns", 0))
                           > self._tenant_target_ns(tenant))
            stuck = list(gw.queue.pending()) + list(gw.inflight.values())
            for req in stuck:
                if req.submit_ns < self._guard_start_ns:
                    continue  # pre-canary backlog: not our evidence
                age = int(now_ns) - req.submit_ns + req.penalty_ns
                if age > self._tenant_target_ns(req.tenant):
                    _judge(req.tenant, True)
        # The SAME objective the SLO observability surface reports
        # against (the reference's `pbst slo report`) — guard
        # verdicts and dashboards must measure one thing.
        budget = 1.0 - SLO_OBJECTIVE
        return {
            tenant: round((do / dt) / budget, 4)
            for tenant, (do, dt) in sorted(agg.items())
            if dt >= self.min_guard_samples
        }

    def poll(self, now_ns: int) -> dict | None:
        """Advance the guard; returns the decision event when the
        window closes (or a canary member vanished), else None."""
        if self.state != "canary":
            return None
        if any(n not in self.fed.members for n in self.members):
            # The canary box died mid-guard (chaos is allowed to do
            # that): the experiment is void — degrade to reference.
            return self._rollback(now_ns, reason="member-lost",
                                  burns={})
        if int(now_ns) < self._guard_end_ns:
            return None
        burns = self._burns(now_ns)
        if not burns:
            # Promotion requires AFFIRMATIVE evidence of health: a
            # canary window in which no tenant completed enough
            # requests to judge is itself an alarm — the candidate may
            # have strangled throughput (the collapsed-band pathology
            # does exactly this), or chaos starved the member. Either
            # way the conservative verdict is the reference profile.
            return self._rollback(now_ns, reason="no-evidence",
                                  burns=burns)
        worst = max(burns.values())
        if worst > self.burn_limit:
            return self._rollback(now_ns, reason="burn", burns=burns)
        return self._promote(now_ns, burns)

    def _promote(self, now_ns: int, burns: dict) -> dict:
        # One global push: clears the canary scope and delivers the
        # candidate to every non-canary member (their last-adopted
        # view never saw it); the canary members are already there.
        self.channel.push(dict(self._candidate_knobs), scope=None)
        # The promoted candidate IS the new trusted profile: a later
        # round's rollback must degrade to it, not silently un-promote
        # a measured win back to the construction-time reference.
        self.reference.update(self._candidate_knobs)
        self.state = "idle"
        ev = {
            "event": "promote", "t_ns": int(now_ns),
            "members": list(self.members),
            "params": dict(self.candidate),
            "burns": burns,
        }
        self._emit(now_ns, Ev.AP_PROMOTE, len(self.members), 0)
        self.members = []
        return ev

    def _rollback(self, now_ns: int, reason: str, burns: dict) -> dict:
        # One global push of the REFERENCE values: clears the scope and
        # re-delivers reference to the canary members (their adopted
        # view moved to the candidate); everyone else never moved, so
        # it is a no-op there. Production degrades to the profile it
        # trusted — never to an outage.
        self.channel.push(dict(self.reference), scope=None)
        self.state = "idle"
        worst = max(burns.values(), default=0.0)
        ev = {
            "event": "rollback", "t_ns": int(now_ns),
            "members": list(self.members),
            "params": dict(self.candidate),
            "reason": reason,
            "burns": burns,
        }
        self._emit(now_ns, Ev.AP_ROLLBACK,
                   _REASON_CODES.get(reason, 0), int(worst * 1000))
        self.members = []
        return ev

    def _emit(self, now_ns: int, ev: int, *args: int) -> None:
        if self.fed.spans is not None:
            self.fed.spans.emit_event(int(now_ns), ev, *args)
