"""The autopilot orchestrator: record → search → canary → converge.

The port of ``pbs_tpu.autopilot.pilot``: a seeded ``run_autopilot_demo``
reports what the reference's does, byte for byte.

Composes the three mechanisms into the paper's closed loop at serving
scale (MaLV-OS arXiv 2508.03676 — background simulation as
the decision substrate, production only ever sees guarded deltas):

1. a :class:`~pbs_tpu_torch.autopilot.recorder.ShadowRecorder` captures the
   federation's live traffic;
2. after ``min_record_ns`` of capture, :func:`~pbs_tpu_torch.autopilot
   .shadow.shadow_search` proposes a candidate knob profile (tuned-
   profile space, paired seeds, margin against the live config);
3. a candidate clearing the margin gate rolls out through
   :class:`~pbs_tpu_torch.autopilot.canary.CanaryRollout` — scoped push to a
   member subset, SLO-burn guard window, promote or automatic
   rollback.

The pilot is pumped from the owner's loop (``tick()`` after each
federation pump round), holds no thread, and consumes no randomness of
its own — every decision is a pure function of (captured traffic,
knob state, fault plan), which is what lets the chaos harness pin the
whole loop's response with golden digests. The **adversarial seam**
sits exactly where a buggy or compromised scorer would: after the
shadow search, the ``autopilot.candidate`` fault point may replace the
proposal with :data:`~pbs_tpu_torch.autopilot.canary.PATHOLOGICAL_PARAMS`
claiming a winning margin — the registry cannot reject it (every value
is in-range), so the canary guard is the line that must hold, and the
chaos gate proves it does.
"""

from __future__ import annotations

import dataclasses

from pbs_tpu_torch import knobs
from pbs_tpu_torch.autopilot.canary import PATHOLOGICAL_PARAMS, CanaryRollout
from pbs_tpu_torch.autopilot.recorder import ShadowRecorder
from pbs_tpu_torch.autopilot.shadow import shadow_search
from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.knobs.channel import KnobChannel
from pbs_tpu_torch.knobs.profile import PARAM_KNOBS, knobs_to_params
from pbs_tpu_torch.obs.trace import Ev


@dataclasses.dataclass
class AutopilotConfig:
    """Loop constants; defaults are the declared registry knobs
    (``autopilot.*``, docs/KNOBS.md) so a deployment retunes the loop
    the same way it retunes anything else."""

    policy: str = "feedback"
    # None = the declared registry default. None (not <=0) on purpose:
    # 0 is a VALID declared value for switch_cost_ns ("model off") and
    # burn_limit (strictest guard), and must stay reachable.
    min_record_ns: int | None = None
    guard_window_ns: int | None = None
    burn_limit: float | None = None
    score_margin_x1e6: int | None = None
    canary_members: int | None = None
    min_guard_samples: int | None = None
    switch_cost_ns: int | None = None
    quick: bool = True
    max_rounds: int = 1

    def __post_init__(self) -> None:
        d = knobs.default
        for field in ("min_record_ns", "guard_window_ns", "burn_limit",
                      "score_margin_x1e6", "canary_members",
                      "min_guard_samples", "switch_cost_ns"):
            if getattr(self, field) is None:
                setattr(self, field, d(f"autopilot.{field}"))


class Autopilot:
    """One self-tuning loop over one federation.

    ``channel`` is the WRITER end of the knob channel this loop owns —
    the only process allowed to push (the ``rollout-discipline`` pass
    enforces that every production push lives in the canary path).
    Arming wires the whole stack: shadow capture at the submit
    surface, per-member knob watchers (scoped canary adoption), and
    the member profile model.
    """

    def __init__(self, fed, channel: KnobChannel,
                 config: AutopilotConfig | None = None,
                 recorder: ShadowRecorder | None = None):
        self.fed = fed
        self.channel = channel
        self.config = config or AutopilotConfig()
        self.recorder = recorder or ShadowRecorder()
        fed.attach_shadow(self.recorder)
        # Members adopt through their own member-keyed watchers; the
        # profile model re-rates their backends on adoption.
        for gw in fed.members.values():
            gw.profile_switch_cost_ns = self.config.switch_cost_ns
        reader = KnobChannel.attach(channel.path)
        fed.attach_knobs(reader, per_member=True)
        self.canary = CanaryRollout(
            fed, channel, policy=self.config.policy,
            guard_window_ns=self.config.guard_window_ns,
            burn_limit=self.config.burn_limit,
            min_guard_samples=self.config.min_guard_samples,
            canary_members=self.config.canary_members)
        self.state = "recording"  # recording | canary | done
        self.rounds = 0
        self.history: list[dict] = []
        self._t0 = fed.clock.now_ns()

    # -- the pump --------------------------------------------------------

    def tick(self) -> dict | None:
        """One loop step on the federation's timeline; returns the
        decision event it produced this step (if any). Call after the
        federation's own ``tick()`` — candidates then see a settled
        pump round, and pushed knobs adopt at the members' next round
        (the KnobWatcher determinism contract)."""
        now = self.fed.clock.now_ns()
        # Late joiners (the rejoin path) must speak the profile model:
        # their watcher primed at attach, BEFORE this pilot could arm
        # the switch cost, so the prime adoption skipped the backend
        # re-rate. Arm the constant and re-apply the already-adopted
        # profile so the joiner carries the same overhead as its peers
        # from this tick on — otherwise it serves measurably faster
        # and skews any later guard evidence it hosts.
        for gw in self.fed.members.values():
            if gw.profile_switch_cost_ns != self.config.switch_cost_ns:
                gw.profile_switch_cost_ns = self.config.switch_cost_ns
                if gw.applied_knobs:
                    gw.apply_member_knobs(dict(gw.applied_knobs),
                                          dict(gw.applied_knobs))
        if self.state == "recording":
            if now - self._t0 < self.config.min_record_ns:
                return None
            return self._propose(now)
        if self.state == "canary":
            decision = self.canary.poll(now)
            if decision is None:
                return None
            self.history.append(decision)
            self.rounds += 1
            if self.rounds >= self.config.max_rounds:
                self.state = "done"
            else:
                self.state = "recording"
                self._t0 = now
            return decision
        return None

    def _live_params(self) -> dict:
        """What production currently runs: the channel's profile-knob
        values mapped back to constructor params."""
        _, values = self.channel.snapshot()
        names = set(PARAM_KNOBS[self.config.policy].values())
        return knobs_to_params(
            self.config.policy,
            {n: v for n, v in values.items() if n in names})

    def _propose(self, now: int) -> dict:
        window = self.recorder.window()
        proposal = shadow_search(
            window, live_params=self._live_params(),
            policy=self.config.policy, quick=self.config.quick)
        injected = False
        f = _faults.consult("autopilot.candidate", proposal["workload"])
        if f is not None and f.fault == "pathological":
            # The adversarial seam: a compromised scorer recommends a
            # catastrophic profile and LIES about its margin. Every
            # value is inside the registry's safe ranges — only the
            # canary guard stands between this and the fleet.
            injected = True
            claimed = (proposal["live_score_x1e6"]
                       + self.config.score_margin_x1e6 + 1)
            proposal = {
                **proposal,
                "candidate": dict(PATHOLOGICAL_PARAMS),
                "candidate_score_x1e6": claimed,
                "margin_x1e6": claimed - proposal["live_score_x1e6"],
            }
        event = {"event": "propose", "t_ns": int(now),
                 "injected": injected, **proposal}
        self.history.append(event)
        if self.fed.spans is not None:
            # Scores can be negative: the args ride the ring's u64
            # words as i64 two's complement (the EmitBatch mask), so
            # a decoder reading them signed recovers the real margin
            # — a losing candidate must not audit as a huge win.
            self.fed.spans.emit_event(
                int(now), Ev.AP_PROPOSE,
                proposal["candidate_score_x1e6"],
                proposal["live_score_x1e6"],
                proposal["margin_x1e6"],
                int(injected))
        if proposal["margin_x1e6"] <= self.config.score_margin_x1e6:
            # No measured win worth a rollout: stay on the live config
            # (the tuner's ties-to-reference discipline, applied live).
            self.history.append({"event": "hold", "t_ns": int(now),
                                 "margin_x1e6":
                                     proposal["margin_x1e6"]})
            self.rounds += 1
            self.state = ("done" if self.rounds >= self.config.max_rounds
                          else "recording")
            self._t0 = now
            return self.history[-1]
        canary_ev = self.canary.start(proposal["candidate"], now)
        if canary_ev is None:
            # No live member can host the canary (chaos drained or
            # partitioned everyone): defer — nothing was pushed,
            # production stays on the live config.
            self.history.append({"event": "hold", "t_ns": int(now),
                                 "reason": "no-canary-member"})
            self.rounds += 1
            self.state = ("done" if self.rounds >= self.config.max_rounds
                          else "recording")
            self._t0 = now
            return self.history[-1]
        self.history.append(canary_ev)
        self.state = "canary"
        return canary_ev

    # -- observability ---------------------------------------------------

    def report(self) -> dict:
        """Full loop report (the ``pbst-torch autopilot run`` artifact):
        status + the decision history + per-member adopted knobs.
        Stable key order, ints and 4-dp floats only — byte-stable
        under ``json.dumps(sort_keys=True)`` for a seeded run."""
        return {
            "version": 1,
            "status": self.status(),
            "history": [dict(e) for e in self.history],
            "knob_adoptions": [dict(a) for a in
                               self.fed.knob_adoptions],
            "members": {
                name: dict(sorted(gw.applied_knobs.items()))
                for name, gw in sorted(self.fed.members.items())
            },
        }

    def status(self) -> dict:
        """Stable summary (the ``pbst-torch autopilot status`` surface)."""
        decisions = [e["event"] for e in self.history]
        return {
            "state": self.state,
            "rounds": self.rounds,
            "recorded_arrivals": self.recorder.recorded,
            "dropped_arrivals": self.recorder.dropped,
            "decisions": decisions,
            "canary_members": list(self.canary.members),
            "reference": dict(self.canary.reference),
            "adoptions": len(self.fed.knob_adoptions),
        }


# -- the demo loop (pbst-torch autopilot run --demo) -------------------------------


def run_autopilot_demo(seed: int = 0, ticks: int = 260,
                       tick_ns: int = 1_000_000,
                       pathological: bool = False) -> dict:
    """One self-contained, seeded end-to-end loop on a virtual clock:
    3-member federation, catalog-derived arrivals, shadow capture →
    quick search → canary → promote/hold (or, with ``pathological``,
    an injected bad candidate → guarded rollback). Deterministic:
    same args ⇒ byte-identical report. The tier-1 CLI smoke budget is
    ≤ 5 s; the quick search dominates (~1 s on the Python witness)."""
    import shutil
    import tempfile

    from pbs_tpu_torch.faults import injector as faults_mod
    from pbs_tpu_torch.faults.plan import FaultPlan, FaultSpec
    from pbs_tpu_torch.gateway.chaos import (
        _federation_member,
        catalog_arrivals,
        draw_arrival,
        quota_for,
    )
    from pbs_tpu_torch.gateway.federation import FederatedGateway
    from pbs_tpu_torch.sim.workload import build_workload
    from pbs_tpu_torch.utils.clock import VirtualClock

    plan = FaultPlan(seed=seed, specs=(
        (FaultSpec("autopilot.candidate", "pathological", p=1.0,
                   times=1),) if pathological else ()))
    faults_mod.install(plan)
    knob_dir = tempfile.mkdtemp(prefix="pbst-autopilot-demo-")
    try:
        clock = VirtualClock()
        members = [_federation_member(f"gw{i}", i, clock, tick_ns,
                                      seed, n_backends=2, n_tenants=4)
                   for i in range(3)]
        fed = FederatedGateway(members, clock=clock,
                               renew_period_ns=4 * tick_ns,
                               lease_ttl_ns=6 * tick_ns)
        tenants = build_workload("mixed", seed=seed, n_tenants=4)
        for t in tenants:
            fed.register_tenant(t.name,
                                quota_for(t.name, t.slo,
                                          t.params.weight))
        arrivals = catalog_arrivals(tenants, seed, tag=17)
        writer = KnobChannel.create(f"{knob_dir}/knobs.led")
        # The guard-sizing rule (docs/AUTOPILOT.md): the window must
        # exceed the tightest SLO target with real margin, or
        # in-window requests cannot age past it and burn evidence
        # starves.
        cfg = AutopilotConfig(
            min_record_ns=(ticks // 3) * tick_ns,
            guard_window_ns=(ticks // 3) * tick_ns,
            quick=True, max_rounds=1)
        pilot = Autopilot(fed, writer, config=cfg)
        for tick in range(int(ticks)):
            for t in tenants:
                fire, cost = draw_arrival(t, arrivals[t.name])
                if fire:
                    fed.submit(t.name, {"tick": tick}, cost=cost)
            fed.tick()
            pilot.tick()
            clock.advance(tick_ns)
        for _ in range(int(ticks) * 6):
            if not fed.busy():
                break
            fed.tick()
            pilot.tick()
            clock.advance(tick_ns)
        report = pilot.report()
        report["stats"] = {
            "admitted": fed.admitted, "completed": fed.completed,
            "drained": not fed.busy(),
        }
        report["pathological"] = bool(pathological)
        report["seed"] = int(seed)
        report["ticks"] = int(ticks)
        return report
    finally:
        faults_mod.uninstall()
        shutil.rmtree(knob_dir, ignore_errors=True)
