"""Cluster controller: placement, gang coordination, failure recovery.

Reference mapping: the controller is the cluster-wide analog of the
toolstack brain — ``xl``/xend issuing domain lifecycle and scheduler
ops (``tools/libxl/xl_cmdimpl.c:4805-4896``), plus the pieces the
reference only has in single-host form, generalized across hosts:

- *Placement* re-expresses the atc variant's least-loaded, anti-stacking
  vCPU placement (``sched_credit_atc.c:545-570``): gang members are
  never co-located on one host, because a gang spanning hosts dies by
  lock-holder preemption if any one host stalls.
- *Gang rounds* are barrier-coordinated lockstep quanta across agents —
  the distributed form of "never split a ring across a preemption
  boundary".
- *Failure detection* is the xenwatchdogd / heartbeat analog
  (``tools/misc/xenwatchdogd.c``): agents that miss pings are declared
  dead and their jobs re-placed on live hosts (recovery = restore
  elsewhere, exactly the reference's Remus model, ``tools/remus``).

The port of ``pbs_tpu.dist.controller``, decision for decision:
placement order, breaker transitions, the reconcile fence, the round
barrier, migration's abort path and the persisted ``/cluster`` map are
the reference's, so a port controller drives reference agents and the
reverse with equal job maps (``tests/test_torch_dist.py``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

from pbs_tpu_torch.dist.rpc import RpcClient, RpcError
from pbs_tpu_torch.utils.clock import SEC, MonotonicClock


class ClusterRoundError(RuntimeError):
    """One or more agents failed during a lockstep round."""

    def __init__(self, errors: dict[str, Exception], quanta: dict[str, int]):
        super().__init__(
            "round failed on " + ", ".join(sorted(errors)))
        self.errors = errors
        self.quanta = quanta


@dataclasses.dataclass
class AgentHandle:
    name: str
    client: RpcClient  # control ops (may be busy for a whole round)
    probe: RpcClient  # liveness pings only — never blocked behind ops
    address: tuple[str, int] = ("", 0)
    alive: bool = True
    missed: int = 0
    info: dict = dataclasses.field(default_factory=dict)
    # Circuit breaker (degraded-mode quarantine): a host that answers
    # pings but keeps faulting ops is ALIVE-but-untrustworthy — killing
    # it would re-place jobs that are fine; keeping it in rounds burns
    # every round on its failures. 'open' = quarantined (no ops, no
    # placement), 'half_open' = one probe round decides.
    consecutive_faults: int = 0
    breaker: str = "closed"  # closed | open | half_open
    breaker_cooldown: int = 0
    #: When the controller last OBSERVED this agent (heartbeat answered
    #: or missed, op completed or faulted — any interaction that
    #: informed alive/breaker state). 0 = never observed. The
    #: backend_health() staleness stamp derives from this.
    observed_ns: int = 0
    #: Backend attribution: observed service-time p99
    #: for the co-named serving backend, published by a gateway's
    #: histogram export (``note_backend_service``). 0 = never reported.
    service_p99_ns: int = 0


@dataclasses.dataclass
class MemberRef:
    agent: str
    job: str  # job name on that agent


@dataclasses.dataclass
class JobRecord:
    """Controller-side record of a (possibly multi-host) job."""

    name: str
    workload: str
    spec: dict
    members: list[MemberRef]
    gang: bool = False
    # Remus: member job name -> backup agent name (replication enabled)
    replica_peers: dict[str, str] = dataclasses.field(default_factory=dict)
    replica_period_s: float = 0.5


class Controller:
    def __init__(self, dead_after_missed: int = 2,
                 subject: str = "controller",
                 auth_token: str | None = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown: int = 2,
                 clock=None,
                 health_ttl_ns: int | None = None):
        self.agents: dict[str, AgentHandle] = {}
        self.jobs: dict[str, JobRecord] = {}
        self.dead_after_missed = dead_after_missed
        #: Consecutive op faults before an agent is quarantined, and how
        #: many healthy heartbeats an open breaker waits before the
        #: half-open probe round.
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        #: Observation-time source (injectable for deterministic tests).
        self.clock = clock if clock is not None else MonotonicClock()
        #: Staleness bound on the backend_health() view: an agent not
        #: observed within this window reads "stale" and the gateway
        #: treats its entry as unknown instead of trusting it. Default:
        #: the breaker's half-open window — ``breaker_cooldown``
        #: heartbeats at the nominal 1 Hz heartbeat cadence.
        self.health_ttl_ns = (int(health_ttl_ns) if health_ttl_ns is not None
                              else max(1, int(breaker_cooldown)) * SEC)
        #: Lease authority for the federated gateway tier — attached by
        #: FederatedGateway (gateway/federation.py) so per-tenant
        #: token-bucket levels are leased through the controller.
        self.admission_broker = None
        self.last_round_errors: dict[str, Exception] = {}
        # XSM identity presented on every job-mutating agent op; under
        # an enforcing agent policy, grant this label (or pass your own).
        # Privileged subjects additionally require ``auth_token`` to
        # match the agents' token (connection-level trust, rpc.py).
        self.subject = subject
        self.auth_token = auth_token

    # -- membership ------------------------------------------------------

    @staticmethod
    def _check_name(kind: str, name: str) -> None:
        # Names become Store path segments in save_state; a '/' would
        # silently splinter the persisted record (and an empty name is
        # unaddressable everywhere).
        if not name or "/" in name:
            raise ValueError(f"invalid {kind} name {name!r}: must be "
                             "non-empty and contain no '/'")

    def add_agent(self, name: str, address: tuple[str, int]) -> AgentHandle:
        self._check_name("agent", name)
        # fault_key: LOGICAL labels (ports are ephemeral — chaos streams
        # keyed by them would reseed every run). Probes never retry: a
        # missed ping must stay a missed ping or dead-host detection
        # stretches by the whole retry budget.
        # deadline_s bounds the WHOLE retry loop (retries included) —
        # a flaky agent must shed a control op, not pin the controller.
        h = AgentHandle(name, RpcClient(address, auth_token=self.auth_token,
                                        fault_key=name, deadline_s=30.0),
                        probe=RpcClient(address, timeout_s=2.0,
                                        auth_token=self.auth_token,
                                        fault_key=f"{name}/probe",
                                        max_retries=0, deadline_s=2.0),
                        address=(address[0], int(address[1])))
        h.info = h.client.call("info")
        h.observed_ns = self.clock.now_ns()
        self.agents[name] = h
        return h

    def live_agents(self) -> list[AgentHandle]:
        return [h for h in self.agents.values() if h.alive]

    def available_agents(self) -> list[AgentHandle]:
        """Live agents not quarantined by the circuit breaker.
        Half-open agents are included — they carry the probe op that
        decides whether the breaker closes."""
        return [h for h in self.live_agents() if h.breaker != "open"]

    # -- circuit breaker (degraded-mode quarantine) ----------------------

    def _op_fault(self, h: AgentHandle) -> None:
        """An op on ``h`` failed (in-band error or transport gave up
        after retries). Enough consecutive faults — or one fault on a
        half-open probe — quarantines the host."""
        h.consecutive_faults += 1
        h.observed_ns = self.clock.now_ns()  # a fault IS an observation
        if (h.breaker == "half_open"
                or h.consecutive_faults >= self.breaker_threshold):
            h.breaker = "open"
            h.breaker_cooldown = self.breaker_cooldown

    def _op_ok(self, h: AgentHandle) -> None:
        h.consecutive_faults = 0
        h.breaker = "closed"
        h.observed_ns = self.clock.now_ns()

    def _op(self, h: AgentHandle, op: str, **kwargs: Any) -> Any:
        """A mutating agent op with breaker bookkeeping: EVERY op path
        feeds the quarantine, not just run_round — a host whose
        create_job/migrate/replicate keep faulting must stop taking
        placements just like one whose rounds fault. Re-raises
        unchanged, so call-site error semantics are untouched."""
        try:
            r = h.client.call(op, **kwargs)
        except Exception:
            self._op_fault(h)
            raise
        self._op_ok(h)
        return r

    # -- failure detection (xenwatchdogd analog) -------------------------

    def heartbeat(self) -> dict[str, bool]:
        """Ping every agent once (concurrently — a hung host must not
        delay detection of the others); mark dead after N consecutive
        misses. Pings ride each handle's dedicated probe connection and
        the server answers them lock-free, so a host busy in a long
        ``run`` op still reads alive. Returns {agent: alive}."""

        def _beat(h: AgentHandle) -> None:
            # Either outcome is an observation: the view's freshness is
            # about how recently we LOOKED, not about what we saw.
            h.observed_ns = self.clock.now_ns()
            if h.probe.try_ping():
                if not h.alive and not self._reconcile(h):
                    # Fence failed: keep it dead; a later heartbeat
                    # retries the fence before readmission.
                    return
                h.missed = 0
                h.alive = True
                if h.breaker == "open":
                    # Healthy transport ticks the quarantine down; at
                    # zero the breaker half-opens and the next round
                    # carries the probe op.
                    h.breaker_cooldown -= 1
                    if h.breaker_cooldown <= 0:
                        h.breaker = "half_open"
            else:
                h.missed += 1
                if h.missed >= self.dead_after_missed:
                    h.alive = False

        self._fanout(list(self.agents.values()), _beat)
        return {name: h.alive for name, h in self.agents.items()}

    def _reconcile(self, h: AgentHandle) -> bool:
        """Remove jobs on ``h`` the controller no longer maps there.
        Returns True only if the host is verifiably clean — an agent
        declared dead may have had its jobs re-placed by recover(), and
        readmitting it with a stale member still running is split-brain
        (the failure mode Remus fences with its commit protocol,
        tools/remus)."""
        expected = {m.job for rec in self.jobs.values()
                    for m in rec.members if m.agent == h.name}
        try:
            present = {j["job"] for j in h.client.call("list_jobs")}
            stale = present - expected
            if stale:
                results = h.client.multicall(
                    [("remove_job", {"job": j, "subject": self.subject})
                     for j in sorted(stale)])
                if not all(r.get("ok") for r in results):
                    return False
        except Exception:  # noqa: BLE001 — it may have died again
            h.missed += 1
            return False
        return True

    # -- placement -------------------------------------------------------

    def _load(self, h: AgentHandle) -> tuple[int, int]:
        """Placement heuristic only — a failed info read ranks the host
        last but NEVER counts toward liveness. Rides the probe
        connection (short timeout, never queued behind a long ``run`` op
        on the shared control connection) and the server answers info
        lock-free, so one busy host cannot stall place()/recover()."""
        try:
            info = h.probe.call("info")
            h.info = info
            return (info["n_contexts"], info["n_jobs"])
        except Exception:  # noqa: BLE001 — rank last, don't condemn
            return (1 << 30, 1 << 30)

    def _ranked_live(self, candidates: list[AgentHandle]) -> list[AgentHandle]:
        # Collect loads concurrently (one wedged probe adds its timeout
        # once, not once per comparison in a serial sorted(key=...)).
        loads: dict[str, tuple[int, int]] = {}

        def _collect(h: AgentHandle) -> None:
            loads[h.name] = self._load(h)

        self._fanout(candidates, _collect)
        ranked = sorted(candidates, key=lambda h: loads[h.name])
        return [h for h in ranked if h.alive]

    @staticmethod
    def _fanout(handles: list[AgentHandle], fn) -> None:
        threads = [threading.Thread(target=fn, args=(h,), daemon=True)
                   for h in handles]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def place(self, n: int, distinct: bool = False) -> list[AgentHandle]:
        """Pick n target agents, least-loaded first. ``distinct`` forces
        n different hosts (gang anti-stacking); otherwise hosts repeat in
        load order. Quarantined (breaker-open) hosts never take new
        placements."""
        live = self.available_agents()
        if not live:
            raise RuntimeError("no live agents")
        ranked = self._ranked_live(live)
        if not ranked:
            raise RuntimeError("no live agents")
        if distinct:
            if len(ranked) < n:
                raise RuntimeError(
                    f"gang of {n} needs {n} live hosts, have {len(ranked)}")
            return ranked[:n]
        return [ranked[i % len(ranked)] for i in range(n)]

    # -- job lifecycle ---------------------------------------------------

    def create_job(
        self,
        name: str,
        workload: str = "sim",
        spec: dict | None = None,
        n_members: int = 1,
        gang: bool = False,
    ) -> JobRecord:
        """Create a job with ``n_members`` member jobs placed across
        agents; gang members land on distinct hosts."""
        self._check_name("job", name)
        if name in self.jobs:
            raise ValueError(f"job {name!r} already exists")
        spec = dict(spec or {})
        targets = self.place(n_members, distinct=gang and n_members > 1)
        members: list[MemberRef] = []
        try:
            for i, h in enumerate(targets):
                member_name = name if n_members == 1 else f"{name}.{i}"
                self._op(h, "create_job", job=member_name,
                         workload=workload, spec=spec,
                         subject=self.subject)
                members.append(MemberRef(h.name, member_name))
        except Exception:
            # Roll back already-placed members so a failed fan-out
            # leaves no orphans and the name stays retryable.
            for m in members:
                try:
                    self._op(self.agents[m.agent],
                             "remove_job", job=m.job, subject=self.subject)
                except Exception:  # noqa: BLE001 — host may be dead too
                    pass
            raise
        rec = JobRecord(name, workload, spec, members, gang=gang)
        self.jobs[name] = rec
        return rec

    def remove_job(self, name: str) -> None:
        if self.jobs.get(name) is not None and self.jobs[name].replica_peers:
            self.disable_replication(name)  # stop pumps, drop replicas
        rec = self.jobs.pop(name)
        for m in rec.members:
            h = self.agents.get(m.agent)
            if h is None or not h.alive:
                continue
            try:
                self._op(h, "remove_job", job=m.job, subject=self.subject)
            except Exception:  # noqa: BLE001 — host may have just died
                pass

    def sched_setparams(self, name: str, **params: Any) -> None:
        """One batched multicall per agent (the multicall.c pattern)."""
        rec = self.jobs[name]
        by_agent: dict[str, list] = {}
        for m in rec.members:
            by_agent.setdefault(m.agent, []).append(
                ("sched_setparams",
                 {"job": m.job, "subject": self.subject, **params}))
        for agent, calls in by_agent.items():
            for call, r in zip(
                    calls, self.agents[agent].client.multicall(calls)):
                if not r.get("ok"):
                    raise RpcError(f"{agent}:{call[0]}",
                                   r.get("error", "?"), r.get("message", ""))

    def migrate_job(self, name: str, to: str | None = None) -> dict[str, str]:
        """Live-migrate a job's members off their current hosts (``xl
        migrate``: save on source, ship over DCN, restore on target,
        tear down source). Telemetry counters travel with each member —
        fixing the reference's silent PMU-state reset.

        ``to`` pins every member to one named agent; otherwise each
        member goes to the least-loaded *other* live host (gang members
        keep anti-stacking). On restore failure the source copy is
        unpaused and keeps running — migration never destroys the only
        good copy."""
        rec = self.jobs[name]
        if to is not None and rec.gang and len(rec.members) > 1:
            # create_job enforces distinct hosts per gang member
            # (place(distinct=True)); a pin-everything migrate would
            # silently co-locate the gang and break the barrier model.
            raise ValueError(
                f"gang job {name!r} has {len(rec.members)} members; "
                "cannot pin them all to one host — migrate without 'to'")
        moved: dict[str, str] = {}
        for m in rec.members:
            src = self.agents[m.agent]
            if to is not None:
                dst = self.agents[to]
                if not dst.alive:
                    raise RuntimeError(f"target agent {to!r} is dead")
            else:
                exclude = {m.agent}
                if rec.gang:
                    exclude |= {mm.agent for mm in rec.members}
                ranked = self._ranked_live(
                    [h for h in self.available_agents()
                     if h.name not in exclude])
                if not ranked:
                    raise RuntimeError(f"no live migration target for "
                                       f"{rec.name}/{m.job}")
                dst = ranked[0]
            if dst.name == m.agent:
                continue
            saved = self._op(src, "save_job", job=m.job,
                             subject=self.subject)
            try:
                self._op(dst, "restore_job", job=m.job,
                         workload=rec.workload, spec=rec.spec,
                         saved=saved, subject=self.subject)
            except Exception:
                # Abort: resume the source copy (xl migrate's abort path
                # leaves the domain running at the source).
                src.client.call("unpause_job", job=m.job,
                                subject=self.subject)
                raise
            try:
                self._op(src, "remove_job", job=m.job,
                         subject=self.subject)
            except Exception:  # noqa: BLE001 — source may have died; the
                pass  # reconcile fence removes the stale copy later
            m.agent = dst.name
            moved[m.job] = dst.name
            # Replication does not survive the source teardown
            # (remove_job stops the pump): drop the now-stale replica —
            # a failover must never restore pre-migration state — and
            # re-arm from the new home so protection continues.
            self._drop_and_rearm(rec, m)
        return moved

    def _drop_and_rearm(self, rec: JobRecord, m: MemberRef) -> None:
        """After a member changed homes: retire the old (now stale)
        replica and restart replication from the new home. Best-effort
        on both legs; failure leaves the member VISIBLY unprotected
        (absent from replica_peers, replicate_status == [])."""
        old_peer = rec.replica_peers.pop(m.job, None)
        if old_peer is None:
            return
        ph = self.agents.get(old_peer)
        if ph is not None and ph.alive:
            try:
                ph.client.call("drop_replica", job=m.job,
                               subject=self.subject)
            except Exception:  # noqa: BLE001 — backup may be dead
                pass
        try:
            self._replicate_member(rec, m, rec.replica_period_s)
        except Exception:  # noqa: BLE001 — no eligible backup host
            pass

    # -- Remus replication (tools/remus: continuous backup) --------------

    def enable_replication(self, name: str, period_s: float = 0.5,
                           to: str | None = None) -> dict[str, str]:
        """Continuously replicate each member of ``name`` to a backup
        host (``to`` pins one; default: least-loaded live host that is
        neither the member's home nor, for gangs, a sibling's home).
        Returns {member job: backup agent}. The first epoch ships
        synchronously, so on return every member has a committed
        replica somewhere else."""
        rec = self.jobs[name]
        peers: dict[str, str] = {}
        for m in rec.members:
            peers[m.job] = self._replicate_member(rec, m, period_s, to)
        rec.replica_period_s = period_s
        return peers

    def _replicate_member(self, rec: JobRecord, m: MemberRef,
                          period_s: float, to: str | None = None) -> str:
        src = self.agents[m.agent]
        if to is not None:
            dst = self.agents[to]
            if dst.name == m.agent:
                raise ValueError(
                    f"backup host {to!r} is {m.job}'s own home")
            if not dst.alive:
                raise RuntimeError(f"backup agent {to!r} is dead")
        else:
            exclude = {m.agent}
            if rec.gang:
                # Anti-stacking extends to the backups: siblings' homes
                # AND siblings' backup peers, else one double failure
                # funnels two gang members onto the same host.
                exclude |= {mm.agent for mm in rec.members}
                exclude |= {p for j, p in rec.replica_peers.items()
                            if j != m.job}
            ranked = self._ranked_live(
                [h for h in self.available_agents()
                 if h.name not in exclude])
            if not ranked:
                raise RuntimeError(
                    f"no live backup host for {rec.name}/{m.job}")
            dst = ranked[0]
        self._op(src, "replicate_start", job=m.job, peer_host=dst.address[0],
                 peer_port=dst.address[1], period_s=period_s,
                 subject=self.subject)
        rec.replica_peers[m.job] = dst.name
        return dst.name

    def disable_replication(self, name: str) -> None:
        rec = self.jobs[name]
        for m in rec.members:
            h = self.agents.get(m.agent)
            if h is not None and h.alive and m.job in rec.replica_peers:
                try:
                    h.client.call("replicate_stop", job=m.job,
                                  subject=self.subject)
                except Exception:  # noqa: BLE001 — source may be dead
                    pass
            peer = rec.replica_peers.pop(m.job, None)
            ph = self.agents.get(peer) if peer else None
            if ph is not None and ph.alive:
                try:
                    ph.client.call("drop_replica", job=m.job,
                                   subject=self.subject)
                except Exception:  # noqa: BLE001 — backup may be dead
                    pass

    def _find_replica(self, job: str, preferred: str | None
                      ) -> tuple[AgentHandle, dict] | None:
        """Newest committed replica of ``job`` on a live host. Queries
        ride each handle's probe connection and fan out concurrently —
        recovery must not queue behind one busy host's control
        connection (the heartbeat/_load lesson: one wedged host adds
        its timeout once, not serially). The recorded backup wins ties
        so a split-brain pair of equal epochs restores predictably."""
        candidates = self.live_agents()
        found: dict[str, dict] = {}

        def _ask(h: AgentHandle) -> None:
            try:
                r = h.probe.call("get_replica", job=job,
                                 subject=self.subject)
            except Exception:  # noqa: BLE001 — host may be dying
                return
            if r is not None:
                found[h.name] = r

        self._fanout(candidates, _ask)
        best: tuple[AgentHandle, dict] | None = None
        for h in candidates:
            r = found.get(h.name)
            if r is None:
                continue
            if (best is None or r["epoch"] > best[1]["epoch"]
                    or (r["epoch"] == best[1]["epoch"]
                        and h.name == preferred)):
                best = (h, r)
        return best

    # -- gang rounds (barrier-coordinated lockstep) ----------------------

    def run_round(self, max_rounds: int = 64,
                  strict: bool = True) -> dict[str, int]:
        """One cluster round: every live agent runs up to ``max_rounds``
        scheduler rounds concurrently, with a barrier at the end — no
        agent starts round k+1 until all finished round k. This is the
        distributed gang-switch: a ring job spanning hosts advances in
        lockstep, so no member outruns a preempted peer.

        A failed agent breaks the lockstep guarantee, so with
        ``strict`` (default) the round raises :class:`ClusterRoundError`
        after the barrier; the caller heartbeats/recovers and retries.
        With ``strict=False`` errors are kept on ``self.last_round_errors``
        and surviving agents' quanta are returned."""
        quanta: dict[str, int] = {}
        errs: dict[str, Exception] = {}

        def _one(h: AgentHandle) -> None:
            try:
                quanta[h.name] = h.client.call(
                    "run", _timeout=600.0, max_rounds=max_rounds)
                self._op_ok(h)
            except RpcError as e:
                # The host ANSWERED: it is alive, the op faulted. Only
                # the breaker reacts — counting this toward liveness
                # would re-place jobs off a host that is still running
                # them (the split-brain the reconcile fence exists for).
                errs[h.name] = e
                self._op_fault(h)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs[h.name] = e
                self._op_fault(h)
                h.missed += 1
                if h.missed >= self.dead_after_missed:
                    h.alive = False

        # Quarantined agents sit rounds out (their jobs stall — the
        # degraded mode); half-open agents run as their own probe.
        self._fanout(self.available_agents(), _one)  # join = the barrier
        self.last_round_errors = errs
        if errs and strict:
            raise ClusterRoundError(errs, quanta)
        return quanta

    def run_rounds(self, n: int, max_rounds: int = 64,
                   strict: bool = True) -> int:
        total = 0
        for _ in range(n):
            total += sum(
                self.run_round(max_rounds=max_rounds, strict=strict).values())
        return total

    # -- recovery (Remus model: restore elsewhere) -----------------------

    def recover(self) -> list[str]:
        """Re-place member jobs stranded on dead agents. Returns the
        names of jobs that were moved.

        Replicated members fail over to their newest committed replica
        (``restore_job`` from the shipped record — steps, telemetry
        counters, and sched params survive, the full Remus promise);
        unreplicated members restart fresh from their spec, exactly
        what an unprotected domain loses on host death. Where possible
        replication is re-armed from the new home so the job isn't left
        permanently unprotected after one failover."""
        moved = []
        for rec in self.jobs.values():
            for m in rec.members:
                h = self.agents.get(m.agent)
                if h is not None and h.alive:
                    continue
                live = self.available_agents()
                if not live:
                    raise RuntimeError(f"no live host for {rec.name}/{m.job}")

                replica = self._find_replica(
                    m.job, rec.replica_peers.get(m.job))
                if replica is not None:
                    # Failover target = the host already holding the
                    # state (restoring elsewhere would copy it twice) —
                    # UNLESS gang anti-stacking forbids it: the saved
                    # record is portable, so a sibling-occupied holder
                    # ships it to a clean host instead of co-locating
                    # gang members (the invariant create_job and the
                    # from-spec branch both enforce).
                    holder, r = replica
                    target = holder
                    if rec.gang:
                        sibling_homes = {mm.agent for mm in rec.members
                                         if mm is not m}
                        if holder.name in sibling_homes:
                            ranked = self._ranked_live(
                                [a for a in live
                                 if a.name not in sibling_homes])
                            if not ranked:
                                raise RuntimeError(
                                    f"no anti-stacking host for "
                                    f"{rec.name}/{m.job}")
                            target = ranked[0]
                    self._op(target, "restore_job", job=m.job,
                             workload=rec.workload, spec=rec.spec,
                             saved=r["saved"], subject=self.subject)
                    holder.client.call("drop_replica", job=m.job,
                                       subject=self.subject)
                else:
                    # Prefer a host with no sibling (anti-stacking); fall
                    # back to least-loaded when the cluster has shrunk
                    # below the gang width — same fallback as
                    # anti_stack_pick returning None
                    # (sched_credit_atc.c:545-570).
                    exclude = {mm.agent for mm in rec.members if mm is not m}
                    candidates = [a for a in live
                                  if not (rec.gang and a.name in exclude)]
                    ranked = self._ranked_live(candidates or live)
                    if not ranked:
                        raise RuntimeError(
                            f"no live host for {rec.name}/{m.job}")
                    target = ranked[0]
                    self._op(target, "create_job", job=m.job,
                             workload=rec.workload, spec=rec.spec,
                             subject=self.subject)
                m.agent = target.name
                moved.append(m.job)
                self._drop_and_rearm(rec, m)
        return moved

    # -- persistence (xend-restart story) --------------------------------
    #
    # xend persisted its domain map in xenstore so a restarted daemon
    # rediscovered the world instead of orphaning every guest. Same
    # split here: durable intent (job records, membership, replication
    # topology) goes into the Store under /cluster; live state (which
    # hosts answer, what their load is) is re-learned by heartbeats.

    def save_state(self, store, prefix: str = "/cluster",
                   subject: str = "system") -> None:
        """Persist membership + job records; one transaction so a
        reader never sees a half-written cluster map."""
        tx = store.transaction(subject=subject)
        tx.rm(prefix)
        for name, h in self.agents.items():
            tx.write(f"{prefix}/agents/{name}",
                     {"host": h.address[0], "port": h.address[1]})
        for name, rec in self.jobs.items():
            tx.write(f"{prefix}/jobs/{name}", {
                "workload": rec.workload,
                "spec": rec.spec,
                "gang": rec.gang,
                "members": [{"agent": m.agent, "job": m.job}
                            for m in rec.members],
                "replica_peers": dict(rec.replica_peers),
                "replica_period_s": rec.replica_period_s,
            })
        tx.commit()

    @classmethod
    def load_state(cls, store, prefix: str = "/cluster",
                   store_subject: str = "system", **kw) -> "Controller":
        """Rebuild a controller from the persisted map. Agents are
        re-dialed CONCURRENTLY (N dead hosts cost one connect timeout,
        not N — the heartbeat lesson); unreachable hosts come up
        present-but-dead and surface through the normal heartbeat
        path, so a restarted daemon is usable even with half the fleet
        down. ``store_subject`` is the XSM label for the store reads;
        the controller's own RPC identity passes through ``**kw``
        (``subject=...``) untouched."""
        ctl = cls(**kw)
        names = store.ls(f"{prefix}/agents", subject=store_subject)
        addrs = {
            name: store.read(f"{prefix}/agents/{name}",
                             subject=store_subject)
            for name in names
        }

        def _dial(name: str) -> None:
            addr = addrs[name]
            try:
                ctl.add_agent(name, (addr["host"], addr["port"]))
            except Exception:  # noqa: BLE001 — host down: mark dead,
                h = AgentHandle(  # heartbeat/recover() handle the rest
                    name,
                    RpcClient((addr["host"], addr["port"]),
                              auth_token=ctl.auth_token,
                              deadline_s=30.0),
                    probe=RpcClient((addr["host"], addr["port"]),
                                    timeout_s=2.0,
                                    auth_token=ctl.auth_token,
                                    deadline_s=2.0),
                    address=(addr["host"], addr["port"]),
                    alive=False, missed=ctl.dead_after_missed)
                ctl.agents[name] = h

        cls._fanout(names, _dial)
        for name in store.ls(f"{prefix}/jobs", subject=store_subject):
            rec = store.read(f"{prefix}/jobs/{name}",
                             subject=store_subject)
            ctl.jobs[name] = JobRecord(
                name=name,
                workload=rec["workload"],
                spec=rec["spec"],
                members=[MemberRef(m["agent"], m["job"])
                         for m in rec["members"]],
                gang=rec.get("gang", False),
                replica_peers=dict(rec.get("replica_peers", {})),
                replica_period_s=rec.get("replica_period_s", 0.5),
            )
        return ctl

    # -- observability ---------------------------------------------------

    def backend_health(self) -> dict[str, dict[str, Any]]:
        """Routing view for the serving gateway (``gateway``): the
        controller's last-OBSERVED liveness, breaker state, and load
        per agent — no RPC here, so the gateway's dispatch loop can
        consult it every tick. The gateway vetoes backends whose names
        match agents that are dead or breaker-open, reusing exactly the
        health state ``place()``/``available_agents()`` rank on.

        Every entry carries its observation time and a ``stale`` flag
        (older than ``health_ttl_ns``, the breaker's half-open window):
        a view nobody has refreshed is NOT truth, and the gateway
        treats stale entries as unknown — no veto, ranked last —
        instead of trusting them."""
        now = self.clock.now_ns()
        return {
            name: {
                "alive": h.alive,
                "breaker": h.breaker,
                "load": int(h.info.get("n_jobs", 0)),
                "observed_ns": h.observed_ns,
                "stale": now - h.observed_ns > self.health_ttl_ns,
                "service_p99_ns": h.service_p99_ns,
            }
            for name, h in self.agents.items()
        }

    def note_backend_service(self, name: str, p99_ns: int) -> None:
        """Backend attribution from the serving tier: a gateway
        publishes the co-named backend's histogram-derived service p99
        (``obs.spans``) so the health view carries a *measured*
        service figure, not just a job-count load proxy. Unknown names
        are ignored — the gateway may front backends the cluster
        controller does not manage."""
        h = self.agents.get(name)
        if h is not None:
            h.service_p99_ns = int(p99_ns)

    # -- admission leasing (the federated gateway tier's authority) ------

    def attach_admission_broker(self, broker) -> None:
        """Install the lease authority for federated admission
        (gateway/federation.py): per-tenant token-bucket levels are
        minted in one global bank and reach a gateway only through a
        lease grant routed here, so a tenant spraying requests across N
        gateways cannot get N× its global rate."""
        self.admission_broker = broker

    def admission_lease(self, tenant: str, gateway: str, want: float,
                        now_ns: int, ttl_ns: int):
        """Grant ``gateway`` up to ``want`` tokens of ``tenant``'s
        global bucket (bounded by the bank's level) under a lease that
        expires at ``now_ns + ttl_ns``. Returns the Lease, or None for
        an unknown tenant."""
        if self.admission_broker is None:
            raise RuntimeError("no admission broker attached")
        return self.admission_broker.grant(tenant, gateway, want,
                                           now_ns, ttl_ns)

    def admission_deposit(self, tenant: str, gateway: str, tokens: float,
                          now_ns: int) -> float:
        """Return a draining gateway's unspent lease tokens to the
        bank (capped at the global burst; the excess is destroyed —
        conservative, never inflationary). Returns the amount the bank
        accepted."""
        if self.admission_broker is None:
            raise RuntimeError("no admission broker attached")
        return self.admission_broker.deposit(tenant, gateway, tokens,
                                             now_ns)

    def cluster_dump(self) -> dict[str, Any]:
        out: dict[str, Any] = {"agents": {}, "jobs": {}}
        for name, h in self.agents.items():
            if not h.alive:
                out["agents"][name] = {"alive": False}
                continue
            try:
                out["agents"][name] = {"alive": True, **h.client.call("dump")}
            except Exception as e:  # noqa: BLE001 — snapshot best-effort
                out["agents"][name] = {"alive": False, "error": str(e)}
        for jname, rec in self.jobs.items():
            out["jobs"][jname] = {
                "workload": rec.workload,
                "gang": rec.gang,
                "members": [{"agent": m.agent, "job": m.job}
                            for m in rec.members],
            }
        return out

    def job_steps(self, name: str) -> dict[str, int]:
        """Per-member retired steps (cluster progress view)."""
        rec = self.jobs[name]
        steps = {}
        for m in rec.members:
            tel = self.agents[m.agent].client.call("telemetry", job=m.job)
            steps[m.job] = sum(c["counters"]["steps_retired"]
                               for c in tel["contexts"])
        return steps

    def close(self) -> None:
        for h in self.agents.values():
            h.client.close()
            h.probe.close()
