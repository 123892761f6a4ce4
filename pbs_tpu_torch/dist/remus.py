"""Remus over the wire: continuous checkpoint shipping to a peer host.

Reference: Remus (``tools/remus/README:1-4``) keeps a backup host
continuously up to date by repeatedly running the live-migration save
path (``tools/libxc/xc_domain_save.c``) against a *running* domain:
suspend at an epoch boundary, emit the dirty state, resume immediately,
ship the epoch to the backup, and only count it once the backup acks —
the commit handshake that makes failover consistent.

Re-expression: a job's scheduling state lives at step boundaries
(no mid-step device state), so epoch consistency is free — the session
quiesces the job under the agent's dispatch lock (sleep → record →
wake, microseconds of host work), then ships the save record to the
peer agent *outside* the lock over the ordinary control RPC. The peer
stores the newest acked epoch per job (`push_replica`); the controller's
``recover()`` restores from that replica on host death, so steps,
telemetry counters, and scheduler params survive the failure.

The port of ``pbs_tpu.dist.remus``, epoch for epoch. As in the
reference, the record carries no device state: a failed-over image job
re-boots from its image, with its counters and step count carried and
the image's weights.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING

from pbs_tpu_torch.dist.rpc import RpcClient

if TYPE_CHECKING:
    from pbs_tpu_torch.dist.agent import Agent


class RemusSession:
    """One job's replication pump on its source agent.

    Each period: snapshot the job (atomically, under the server dispatch
    lock so no RPC op sees a half-quiesced partition), ship to the peer,
    count the epoch only on ack. Peer loss doesn't kill the session —
    failures are counted and the next tick retries (the RpcClient
    reconnects transparently), matching Remus's behavior when the
    backup link drops: the primary keeps running unprotected.
    """

    def __init__(self, agent: "Agent", job_name: str,
                 peer: tuple[str, int], period_s: float = 0.5,
                 subject: str = "controller",
                 auth_token: str | None = None):
        self.agent = agent
        self.job_name = job_name
        self.peer_addr = (peer[0], int(peer[1]))
        self.period_s = period_s
        self.subject = subject
        # fault_key: logical (source agent + protected job), so each
        # replication channel owns its own deterministic fault stream —
        # a shared default key would interleave consultations across
        # sessions and make seeded chaos traces depend on pump timing.
        # deadline_s: a wedged peer must fail the epoch (failures+=1,
        # next period retries) — not pin the replication thread.
        self.client = RpcClient(self.peer_addr, auth_token=auth_token,
                                fault_key=f"{agent.name}.remus.{job_name}",
                                deadline_s=30.0)
        self.epochs_committed = 0
        self.failures = 0
        self.skipped = 0
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def tick_once(self) -> bool:
        """One epoch: snapshot + ship + ack. Returns True on commit."""
        # Snapshot under the dispatch lock — the same serialization
        # every RPC op gets, so a concurrent `run`/`migrate` op and
        # the quiesce can't interleave (stop-and-copy happens at a
        # quantum boundary because `run` holds the lock mid-round).
        # Time-bounded acquire: a long `run` op (or an op stopping this
        # very session under the lock) must not wedge this thread — a
        # missed epoch just means the previous one stays current.
        if not self.agent.dispatch_lock.acquire(timeout=1.0):
            self.skipped += 1
            return False
        try:
            if self._stop.is_set():
                self.skipped += 1
                return False
            saved = self.agent.snapshot_record(self.job_name)
        except Exception as e:  # noqa: BLE001 — job may be mid-removal
            self.failures += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        finally:
            self.agent.dispatch_lock.release()
        try:
            ack = self.client.call(
                "push_replica", job=self.job_name,
                epoch=self.epochs_committed, saved=saved,
                source=self.agent.name, subject=self.subject,
            )
            if ack.get("stale"):
                # The backup holds a NEWER epoch (ours restarted at 0,
                # or a duplicate was delayed): our push was discarded,
                # so nothing committed — resync past the backup's epoch
                # and let the next tick ship fresh state under it.
                self.epochs_committed = int(ack["epoch"]) + 1
                self.failures += 1
                self.last_error = (
                    f"stale epoch rejected by backup (it holds "
                    f"{ack['epoch']}); resynced")
                return False
            self.epochs_committed += 1  # commit = ack received
            self.last_error = None
            return True
        except Exception as e:  # noqa: BLE001 — protection is best-effort,
            self.failures += 1  # the primary must keep running
            self.last_error = f"{type(e).__name__}: {e}"
            return False

    def start(self) -> "RemusSession":
        def loop() -> None:
            while not self._stop.wait(self.period_s):
                self.tick_once()

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name=f"remus-{self.agent.name}-{self.job_name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.client.close()

    def status(self) -> dict:
        return {
            "job": self.job_name,
            "peer": list(self.peer_addr),
            "period_s": self.period_s,
            "epochs_committed": self.epochs_committed,
            "failures": self.failures,
            "skipped": self.skipped,
            "last_error": self.last_error,
            "running": self._thread is not None and self._thread.is_alive(),
        }
