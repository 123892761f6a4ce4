"""Per-host agent: exposes one host's partition over the control plane.

Reference mapping: the xend management daemon (``tools/python``, one per
host) plus the privcmd hypercall surface — every operation the ``xl``/
``xm`` toolstack performs on a host (create/destroy/pause/unpause a
domain, adjust scheduler parameters, read telemetry, dump state) becomes
a registered RPC op against the host's :class:`Partition`. Workload
*factories* stand in for domain images: the controller names a workload,
the agent instantiates it locally (like ``xl create`` building a guest
from a config).

The port of ``pbs_tpu.dist.agent``, op for op: the same op table, save
record, restore overlay, Remus replica store and ``agent.op`` fault
seam. One addition: ``Agent(device=)`` names the torch device the
``"image"`` workload boots on (``None``, the default, is the card; a
host without one raises at boot rather than falling back). The
reference binds its image factory with no device.
"""

from __future__ import annotations

import functools
import time as _time
from typing import Any, Callable

from pbs_tpu_torch.dist.rpc import RpcServer
from pbs_tpu_torch.faults import injector as faults
from pbs_tpu_torch.faults.injector import InjectedFault
from pbs_tpu_torch.runtime.xsm import XsmDenied, xsm_check
from pbs_tpu_torch.runtime.job import ContextState, Job, SchedParams
from pbs_tpu_torch.runtime.partition import Partition
from pbs_tpu_torch.telemetry.counters import counters_dict
from pbs_tpu_torch.telemetry.source import SimBackend, SimPhase, SimProfile

WorkloadFactory = Callable[[Partition, str, dict], Job]


def sim_workload(partition: Partition, job_name: str, spec: dict) -> Job:
    """Default workload: a synthetic SimBackend job.

    spec keys: phases=[{steps, step_time_ns, stall_frac, ...}] or flat
    SimPhase kwargs; sched={weight, cap, tslice_us, boost_on_wake};
    n_contexts; gang; max_steps.
    """
    if not isinstance(partition.source, SimBackend):
        raise TypeError("sim workload needs a SimBackend partition")
    if "phases" in spec:
        prof = SimProfile([SimPhase(**p) for p in spec["phases"]])
    else:
        keys = ("step_time_ns", "hbm_bytes", "stall_frac",
                "collective_wait_ns", "flops", "tokens")
        prof = SimProfile.steady(**{k: spec[k] for k in keys if k in spec})
    partition.source.register(job_name, prof)
    job = Job(
        job_name,
        params=SchedParams(**spec.get("sched", {})),
        n_contexts=int(spec.get("n_contexts", 1)),
        micro_per_step=int(spec.get("micro_per_step", 1)),
        gang=bool(spec.get("gang", False)),
        max_steps=spec.get("max_steps"),
        label=str(spec.get("label", "user")),
    )
    return partition.add_job(job)


class Agent:
    """One host's control-plane endpoint."""

    def __init__(
        self,
        name: str,
        partition: Partition | None = None,
        workloads: dict[str, WorkloadFactory] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        n_executors: int = 2,
        scheduler: str = "credit",
        auth_token: str | None = None,
        device: Any = None,
    ):
        self.name = name
        #: Torch device the "image" workload boots on (None = the card).
        self.device = device
        if partition is None:
            partition = Partition(
                f"{name}.pool", SimBackend(), scheduler=scheduler,
                n_executors=n_executors,
            )
        self.partition = partition
        from pbs_tpu_torch.runtime.image import image_workload

        self.workloads: dict[str, WorkloadFactory] = {
            "sim": sim_workload,
            # pygrub analog: boot a job from an on-disk image directory
            # (spec={"path": ...}) — `xl create <image>` over the wire.
            "image": functools.partial(image_workload, device=device),
        }
        self.workloads.update(workloads or {})
        self.server = RpcServer(host=host, port=port, auth_token=auth_token,
                                fault_key=name)
        self._auth_token = auth_token
        # Remus surfaces: replicas this host holds for OTHER hosts' jobs
        # (job -> {"epoch", "saved", "source", "received_at"}) and the
        # replication sessions pumping THIS host's jobs to peers.
        self.replicas: dict[str, dict] = {}
        self.remus: dict[str, Any] = {}
        for op in ("create_job", "remove_job", "sched_setparams",
                   "pause_job", "unpause_job", "run", "dump", "telemetry",
                   "list_jobs", "save_job", "restore_job", "push_replica",
                   "get_replica", "list_replicas", "drop_replica",
                   "replicate_start", "replicate_stop", "replicate_status",
                   "console"):
            self.server.register(op, self._faulted(op, getattr(self,
                                                               "op_" + op)))
        # info answers without the dispatch lock: it only reads counts
        # (torn reads are fine for a placement heuristic) and the
        # controller ranks hosts with it while long `run` ops hold the
        # lock — blocking would freeze placement cluster-wide.
        self.server.register("info", self.op_info, lockfree=True)

    def _faulted(self, op_name: str, fn: Callable[..., Any]):
        """Dispatch seam: the ``agent.op`` injection point (stream key
        ``<agent>:<op>``). 'crash' raises :class:`InjectedFault` out of
        the op mid-dispatch — marshalled to the caller exactly like a
        real agent failure; 'slow' stretches the op (the lock-holder
        preemption analog the controller's breaker must tolerate).
        ``info`` is registered unwrapped: liveness/placement probes
        must stay transport-only signals."""
        key = f"{self.name}:{op_name}"

        def dispatch(**kwargs: Any) -> Any:
            f = faults.consult("agent.op", key)
            if f is not None:
                if f.fault == "crash":
                    raise InjectedFault(f"injected agent crash in {key}")
                if f.fault == "slow":
                    _time.sleep(float(f.args.get("delay_s", 0.001)))
            return fn(**kwargs)

        dispatch.__name__ = f"op_{op_name}"
        return dispatch

    # -- ops (the per-host hypercall surface) ----------------------------

    def op_info(self) -> dict:
        part = self.partition
        return {
            "agent": self.name,
            "partition": part.name,
            "scheduler": part.scheduler.name,
            "n_executors": len(part.executors),
            "n_jobs": len(part.jobs),
            "n_contexts": sum(len(j.contexts) for j in part.jobs),
        }

    def op_create_job(self, job: str, workload: str = "sim",
                      spec: dict | None = None,
                      subject: str = "remote") -> dict:
        # XSM hook at the dispatch surface (do_domctl placement): the
        # subject is the caller's declared label, checked against the
        # policy like any other — but privileged subjects ("system",
        # which bypasses all policy rules) are stripped at the RPC
        # layer unless the connection authenticated with the agent's
        # token (RpcServer trust model; Xen derives dom0 identity from
        # the calling domain, never from hypercall payload).
        xsm_check(subject, "job.create", (spec or {}).get("label", "user"))
        factory = self.workloads.get(workload)
        if factory is None:
            raise LookupError(f"unknown workload {workload!r}")
        if any(j.name == job for j in self.partition.jobs):
            raise ValueError(f"job {job!r} already exists")
        j = factory(self.partition, job, spec or {})
        # Re-check against the label the factory ACTUALLY assigned — a
        # custom factory may ignore spec['label'], and the pre-check
        # must not be the last word. Denial rolls the job back.
        try:
            xsm_check(subject, "job.create", j.label)
        except XsmDenied:
            self.partition.remove_job(j)
            raise
        # Remember provenance so save records are self-contained and a
        # restore can't silently rebuild a different workload.
        j.workload_name = workload
        j.spec = dict(spec or {})
        return {"job": j.name, "n_contexts": len(j.contexts)}

    def op_remove_job(self, job: str, subject: str = "remote") -> bool:
        j = self.partition.job(job)
        xsm_check(subject, "job.destroy", j.label)
        sess = self.remus.pop(job, None)
        if sess is not None:  # dead job needs no protection pump
            sess.stop()
        self.partition.remove_job(j)
        return True

    def op_sched_setparams(self, job: str, weight: int | None = None,
                           cap: int | None = None,
                           tslice_us: int | None = None,
                           subject: str = "remote") -> dict:
        j = self.partition.job(job)
        xsm_check(subject, "job.sched_cntl", j.label)
        changes = {k: int(v) for k, v in
                   (("weight", weight), ("cap", cap), ("tslice_us", tslice_us))
                   if v is not None}
        # Through the scheduler's control-plane hook (csched_dom_cntl),
        # so policies that react to param changes see them.
        self.partition.scheduler.adjust_job(j, **changes)
        p = j.params
        return {"weight": p.weight, "cap": p.cap, "tslice_us": p.tslice_us}

    def op_pause_job(self, job: str, subject: str = "remote") -> bool:
        j = self.partition.job(job)
        xsm_check(subject, "job.pause", j.label)
        self.partition.sleep_job(j)
        return True

    def op_unpause_job(self, job: str, subject: str = "remote") -> bool:
        j = self.partition.job(job)
        xsm_check(subject, "job.unpause", j.label)
        self.partition.wake_job(j)
        return True

    # -- save/restore (xc_domain_save/restore over DCN) ------------------

    def _save_record(self, j: Job) -> dict:
        """Serialize one (already-quiesced) job: the xc_domain_save
        record body, shared by migration save and Remus snapshots."""
        p = j.params
        saved: dict = {
            "job": j.name,
            "label": j.label,
            # provenance (set by op_create_job/op_restore_job; None for
            # jobs added out-of-band) — restore defaults to these
            "workload": getattr(j, "workload_name", None),
            "spec": getattr(j, "spec", None),
            "max_steps": j.max_steps,
            "gang": j.gang,
            "sched": {"weight": p.weight, "cap": p.cap,
                      "tslice_us": p.tslice_us,
                      "boost_on_wake": p.boost_on_wake},
            "contexts": [
                {"sched_count": c.sched_count,
                 # Mid-accumulation position: must travel with the job
                 # or step retirement desyncs from the model's own
                 # micro cursor after a mid-step migration.
                 "micro_progress": c.micro_progress,
                 "counters": [int(x) for x in c.counters]}
                for c in j.contexts
            ],
            "contention": [j.contention_wait_ns, j.contention_events],
            "backend": {},
        }
        if isinstance(self.partition.source, SimBackend):
            saved["backend"]["sim_steps_done"] = (
                self.partition.source.position(j.name))
        return saved

    def op_save_job(self, job: str, subject: str = "remote") -> dict:
        """Quiesce and serialize one job for migration (``xl save``:
        pause, then extract state). Unlike the reference — where perfctr
        shared-page PMU state is NOT in the save records and counters
        silently reset on migration — the telemetry
        counters travel with the job."""
        j = self.partition.job(job)
        xsm_check(subject, "job.save", j.label)
        # stop-and-copy quiesce, not a lifecycle event (the job is
        # about to continue elsewhere; destroy hooks fire at remove)
        self.partition.sleep_job(j, notify=False)
        return self._save_record(j)

    def snapshot_record(self, job: str) -> dict:
        """Remus epoch capture: quiesce → record → resume. Unlike
        ``op_save_job`` the job keeps running afterwards — suspension
        lasts only the host-side record build (the reference's
        sub-second suspend/resume cycle, tools/remus/README). A job the
        user paused stays paused. Callers must hold ``dispatch_lock``
        (RemusSession does); this is not itself an RPC op."""
        j = self.partition.job(job)
        # 'paged' implies asleep too: the epoch capture must not wake
        # (and thereby page back in!) a parked/evicted tenant.
        was_asleep = self._job_state(j) in ("paused", "paged")
        self.partition.sleep_job(j, notify=False)  # epoch quiesce is
        saved = self._save_record(j)  # not a lifecycle event
        if not was_asleep:
            self.partition.wake_job(j, notify=False)
        return saved

    def op_restore_job(self, job: str, workload: str | None = None,
                       spec: dict | None = None, saved: dict | None = None,
                       subject: str = "remote") -> dict:
        """Recreate a saved job and overlay its runtime state
        (``xc_domain_restore``): scheduler params, per-context telemetry
        counters (into fresh ledger slots), contention accumulators, and
        the backend cursor. Workload/spec default to the save record's
        provenance so the restored job rebuilds the workload that was
        saved, not a default one."""
        import numpy as np

        if saved is None:
            raise ValueError("restore requires a 'saved' record")
        if workload is None:
            workload = saved.get("workload") or "sim"
        if spec is None:
            spec = saved.get("spec")
        xsm_check(subject, "job.restore", saved.get("label", "user"))
        factory = self.workloads.get(workload)
        if factory is None:
            raise LookupError(f"unknown workload {workload!r}")
        if any(j.name == job for j in self.partition.jobs):
            raise ValueError(f"job {job!r} already exists")
        j = factory(self.partition, job, spec or {})
        # Overlay + label re-check under rollback: a malformed wire
        # record or a denial must not leave a half-restored orphan
        # running (the migration retry would then always collide).
        try:
            j.label = saved.get("label", j.label)
            # Re-check the label the job ACTUALLY carries — wire dicts
            # are arbitrary and spec['label'] must not launder a target
            # the policy never authorized.
            xsm_check(subject, "job.restore", j.label)
            j.max_steps = saved.get("max_steps", j.max_steps)
            for k, v in saved.get("sched", {}).items():
                setattr(j.params, k, v)
            j.contention_wait_ns, j.contention_events = saved.get(
                "contention", (0, 0))
            for ctx, cstate in zip(j.contexts, saved.get("contexts", ())):
                ctx.sched_count = int(cstate.get("sched_count", 0))
                ctx.micro_progress = int(cstate.get("micro_progress", 0))
                ctrs = np.array(cstate.get("counters", []), dtype=np.uint64)
                if len(ctrs) == len(ctx.counters):
                    ctx.counters = ctrs
                    if ctx.ledger_slot >= 0:
                        # fresh slot is zeroed: adding restores the sums
                        self.partition.ledger.add_many(ctx.ledger_slot, ctrs)
            be = saved.get("backend", {})
            if ("sim_steps_done" in be
                    and isinstance(self.partition.source, SimBackend)):
                self.partition.source.seek(job, be["sim_steps_done"])
        except BaseException:
            self.partition.remove_job(j)
            raise
        j.workload_name = workload  # provenance survives re-migration
        j.spec = dict(spec or {})
        return {"job": j.name, "steps": j.steps_retired()}

    # -- Remus over the wire (tools/remus: continuous replication) -------

    def op_push_replica(self, job: str, epoch: int, saved: dict,
                        source: str = "?",
                        subject: str = "remote") -> dict:
        """Backup side of the Remus channel: store the newest epoch of a
        peer host's job. The reply IS the commit ack — the source only
        counts the epoch once this returns. Only newer epochs are
        accepted so a delayed duplicate can't roll the replica back."""
        xsm_check(subject, "job.replicate", saved.get("label", "user"))
        cur = self.replicas.get(job)
        if cur is not None:
            # Overwriting an existing replica is an operation on THAT
            # replica too: a subject allowed to replicate label "user"
            # must not be able to replace a "tenantA" replica by
            # shipping a crafted record with a label it controls.
            xsm_check(subject, "job.replicate",
                      cur["saved"].get("label", "user"))
        if cur is not None and int(epoch) < cur["epoch"]:
            return {"job": job, "epoch": cur["epoch"], "stale": True}
        self.replicas[job] = {
            "epoch": int(epoch),
            "saved": saved,
            "source": source,
            "received_at": _time.time(),
        }
        return {"job": job, "epoch": int(epoch), "stale": False}

    def op_get_replica(self, job: str,
                       subject: str = "remote") -> dict | None:
        r = self.replicas.get(job)
        if r is not None:
            # The record carries the job's full state (weights,
            # counters, sched params) — guard the read like the save op
            # guards the identical data.
            xsm_check(subject, "job.replicate",
                      r["saved"].get("label", "user"))
        return r

    def op_list_replicas(self, subject: str = "remote") -> list[dict]:
        from pbs_tpu_torch.runtime.xsm import get_policy

        now = _time.time()
        pol = get_policy()
        return [
            {"job": job, "epoch": r["epoch"], "source": r["source"],
             "age_s": round(now - r["received_at"], 3)}
            for job, r in sorted(self.replicas.items())
            # metadata only, but existence still leaks: filter to what
            # the subject could replicate
            if pol.check(subject, "job.replicate",
                         r["saved"].get("label", "user"))
        ]

    def op_drop_replica(self, job: str, subject: str = "remote") -> bool:
        r = self.replicas.get(job)
        if r is None:
            return False
        # Check BEFORE mutating: a denied request must not destroy what
        # may be the only surviving copy of the job's state.
        xsm_check(subject, "job.replicate",
                  r["saved"].get("label", "user"))
        del self.replicas[job]
        return True

    def op_replicate_start(self, job: str, peer_host: str, peer_port: int,
                           period_s: float = 0.5,
                           subject: str = "remote") -> dict:
        """Start a replication session pumping ``job`` to a peer agent
        (the remus daemon the reference runs in dom0 of the primary)."""
        from pbs_tpu_torch.dist.remus import RemusSession

        j = self.partition.job(job)
        xsm_check(subject, "job.replicate", j.label)
        old = self.remus.pop(job, None)
        if old is not None:
            old.stop()
        sess = RemusSession(
            self, job, (peer_host, int(peer_port)),
            period_s=float(period_s), subject=subject,
            auth_token=self._auth_token,
        )
        # First epoch ships synchronously so "replication enabled"
        # means "a committed replica exists", not "one is scheduled" —
        # a crash in the first period would otherwise lose everything.
        # NB: called under the dispatch lock, so ship directly (the
        # session's locked tick path would deadlock here).
        try:
            # Resume numbering past any replica the peer already holds
            # (a restarted session must not ship "epoch 0" into a
            # backup at epoch N — the stale-reject would freeze the
            # replica while the session reported healthy commits).
            existing = sess.client.call("get_replica", job=job,
                                        subject=subject)
            if existing is not None:
                sess.epochs_committed = int(existing["epoch"]) + 1
            saved = self.snapshot_record(job)
            sess.client.call("push_replica", job=job,
                             epoch=sess.epochs_committed, saved=saved,
                             source=self.name, subject=subject)
        except BaseException:
            sess.client.close()  # unreachable peer: no half-open session
            raise
        sess.epochs_committed += 1
        self.remus[job] = sess.start()
        return sess.status()

    def op_replicate_stop(self, job: str, subject: str = "remote") -> bool:
        sess = self.remus.get(job)
        if sess is None:
            return False
        try:
            label = self.partition.job(job).label
        except Exception:  # job already gone; session is an orphan
            label = "user"
        xsm_check(subject, "job.replicate", label)
        self.remus.pop(job).stop()
        return True

    def op_replicate_status(self, job: str | None = None,
                            subject: str = "remote") -> list[dict]:
        from pbs_tpu_torch.runtime.xsm import get_policy

        pol = get_policy()

        def _visible(name: str) -> bool:
            # Session status names jobs and peer topology — filter like
            # op_list_replicas (same information, one op over).
            try:
                label = self.partition.job(name).label
            except KeyError:
                label = "user"
            return pol.check(subject, "job.replicate", label)

        if job is not None:
            sess = self.remus.get(job)
            return ([sess.status()] if sess is not None and _visible(job)
                    else [])
        return [s.status() for name, s in sorted(self.remus.items())
                if _visible(name)]

    def op_run(self, max_rounds: int | None = None,
               for_us: int | None = None) -> int:
        until = None
        if for_us is not None:
            until = self.partition.clock.now_ns() + 1000 * int(for_us)
        return self.partition.run(until_ns=until, max_rounds=max_rounds)

    def op_dump(self) -> dict:
        return self.partition.dump()

    @staticmethod
    def _job_state(j: Job) -> str:
        if j.error is not None:
            return "failed"
        if j.finished():
            return "finished"
        if getattr(j, "paged", None) is not None:
            return "paged"  # evicted to host (xenpaging state)
        live = {c.state for c in j.contexts}
        if live and live <= {ContextState.BLOCKED, ContextState.DONE}:
            return "paused"
        return "running"

    def op_list_jobs(self) -> list[dict]:
        return [
            {
                "job": j.name,
                "state": self._job_state(j),
                "weight": j.params.weight,
                "cap": j.params.cap,
                "tslice_us": j.params.tslice_us,
                "gang": j.gang,
                "steps": j.steps_retired(),
                "finished": j.finished(),
            }
            for j in self.partition.jobs
        ]

    def op_console(self, job: str, since: int = 0, max_lines: int = 256,
                   subject: str = "remote") -> dict:
        """Stream a job's console ring (xenconsoled relay role): the
        reply carries lines from ``since`` plus the next cursor, so
        ``pbst console -f`` polls without duplication."""
        j = self.partition.job(job)
        # Console content is the guest's own output: gate like the
        # telemetry-grade save path.
        xsm_check(subject, "job.console", j.label)
        return {"job": j.name, **j.console.read(int(since), int(max_lines))}

    def op_telemetry(self, job: str) -> dict:
        j = self.partition.job(job)
        return {
            "job": j.name,
            "contexts": [
                {
                    "ctx": c.name,
                    "sched_count": c.sched_count,
                    "counters": counters_dict(c.counters),
                }
                for c in j.contexts
            ],
        }

    # -- lifecycle -------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        return self.server.address

    @property
    def dispatch_lock(self):
        """The server's op-serializing lock; non-RPC entry points that
        mutate the partition (RemusSession ticks) must hold it."""
        return self.server._lock

    def start(self) -> "Agent":
        self.server.start()
        return self

    def stop(self) -> None:
        for sess in list(self.remus.values()):
            sess.stop()
        self.remus.clear()
        self.server.stop()
