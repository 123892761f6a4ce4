"""System-wide sampling profiler backend (xenoprof analog).

The port of ``pbs_tpu.obs.oprofile``: same reservation, state machine,
sample buffers and report. Reference: xenoprof
(``xen/common/xenoprof.c``, 921 LoC + ``arch/x86/oprofile/``) lets one
privileged domain drive system-wide PMU sampling: it *reserves* the PMU
(mutually exclusive with perfctr and the NMI watchdog —
``perfctr_glue.h:38``), walks a state machine (init → ready → start →
stop), collects samples into per-domain shared buffers with a
lost-sample counter, and supports **passive domains** — guests profiled
without their cooperation.

Device re-expression: one :class:`ProfileSession` per process may hold
the profiler reservation. It samples at a fixed period on the
partition's timer wheel (so sim/virtual-clock runs are deterministic),
folding per-context counter deltas into bounded per-job sample buffers.
Passive partitions — other processes' partitions that know nothing
about the profiler — are sampled through read-only attachment to their
file-backed telemetry ledgers, the same privileged-observer pattern as
xenoprof's passive-domain buffers.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import TYPE_CHECKING

from pbs_tpu_torch.telemetry.counters import Counter
from pbs_tpu_torch.telemetry.ledger import Ledger
from pbs_tpu_torch.utils.clock import MS

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.partition import Partition


class ProfilerBusy(RuntimeError):
    """The PMU-reservation analog: only one profiler at a time
    (``perfctr_cpu_reserve`` arbitration)."""


_res_lock = threading.Lock()
_owner: str | None = None


def reserve(owner: str) -> None:
    global _owner
    with _res_lock:
        if _owner is not None and _owner != owner:
            raise ProfilerBusy(f"profiler reserved by {_owner!r}")
        _owner = owner


def release(owner: str) -> None:
    global _owner
    with _res_lock:
        if _owner == owner:
            _owner = None


def current_owner() -> str | None:
    return _owner


class SessionState(enum.Enum):
    # xenoprof's lifecycle (xenoprof.c state machine)
    INIT = "init"
    READY = "ready"
    RUNNING = "running"
    STOPPED = "stopped"
    CLOSED = "closed"


@dataclasses.dataclass
class Sample:
    """One periodic observation of one context — the PC-sample analog:
    *where* a device job is, is its step index; *what it is doing* is the
    counter mix since the last sample."""

    ts_ns: int
    ctx: str
    step: int  # steps retired at sample time (the "program counter")
    device_dns: int  # device time delta since previous sample
    stall_dns: int  # HBM-stall delta
    coll_wait_dns: int  # collective-wait delta


class ProfileSession:
    """One system-wide sampling session over a partition.

    ``max_samples_per_job`` bounds memory like xenoprof's shared sample
    buffers; overflow increments ``lost`` instead of blocking (same
    contract as the trace rings).
    """

    def __init__(
        self,
        partition: "Partition | None",
        period_ns: int = 1 * MS,  # CSCHED_METRIC_TICK_PERIOD-class cadence
        max_samples_per_job: int = 4096,
    ):
        """``partition=None`` makes a passive-only MONITOR session
        (``pbst-torch oprofile``): no active domains, no timer — the
        caller drives :meth:`sample_once` with explicit timestamps."""
        self.partition = partition
        self.period_ns = period_ns
        self.max_samples = max_samples_per_job
        self.samples: dict[str, list[Sample]] = {}
        self.lost: dict[str, int] = {}
        self._last: dict[str, tuple[int, int, int]] = {}  # ctx -> prev ctrs
        self._last_cw: dict[str, int] = {}  # ctx -> prev collective-wait
        self._passive: list[tuple[str, Ledger, str, dict]] = []
        self._passive_last: dict[str, dict[int, tuple[int, int, int]]] = {}
        self._timer = None
        # Unique per session: two sessions over the same partition must
        # still exclude each other.
        self._token = (
            f"oprofile:{partition.name if partition else 'monitor'}:"
            f"{id(self)}")
        reserve(self._token)
        self.state = SessionState.INIT

    # -- passive domains (profiled without their cooperation) ------------

    @staticmethod
    def _read_meta(ledger_path: str) -> dict:
        import json

        try:
            with open(ledger_path + ".meta.json") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            # Missing or mid-rewrite: keep the previous slot view.
            return {}

    def add_passive(self, name: str, ledger_path: str) -> None:
        """Attach another process's partition read-only through its
        file-backed ledger (the xenoprof passive-domain buffer)."""
        if self.state not in (SessionState.INIT, SessionState.READY):
            raise RuntimeError("passive domains attach before start")
        led = Ledger.file_backed(ledger_path, readonly=True)
        meta = self._read_meta(ledger_path) or {"slots": {}}
        self._passive.append((name, led, ledger_path, meta))
        self._passive_last[name] = {}
        self.state = SessionState.READY

    def refresh_passive_meta(self) -> None:
        """Re-read each passive domain's meta sidecar so jobs the live
        producer admits AFTER attach get sampled too (the same
        reload-per-iteration contract as ``pbst-torch top``)."""
        for i, (name, led, path, meta) in enumerate(self._passive):
            fresh = self._read_meta(path)
            if fresh:
                self._passive[i] = (name, led, path, fresh)

    # -- lifecycle (xenoprof.c init/start/stop/close) --------------------

    def start(self) -> "ProfileSession":
        if self.state is SessionState.CLOSED:
            raise RuntimeError("session closed")
        if self.partition is None:
            raise RuntimeError(
                "passive-only monitor sessions have no timer wheel; "
                "drive them with sample_once()")
        self._prime()
        now = self.partition.clock.now_ns()
        self._timer = self.partition.timers.arm(
            now + self.period_ns, self._tick, period_ns=self.period_ns,
            name="oprofile")
        self.state = SessionState.RUNNING
        return self

    def _prime(self) -> None:
        """Capture counter baselines at start so the first sample covers
        only session time — never the job's whole pre-session history."""
        for job in (self.partition.jobs if self.partition else ()):
            for ctx in job.contexts:
                self._last[ctx.name] = (
                    int(ctx.counters[Counter.STEPS_RETIRED]),
                    int(ctx.counters[Counter.DEVICE_TIME_NS]),
                    int(ctx.counters[Counter.HBM_STALL_NS]),
                )
                self._last_cw[ctx.name] = int(
                    ctx.counters[Counter.COLLECTIVE_WAIT_NS])
        for name, led, _path, meta in self._passive:
            last = self._passive_last[name]
            slots = [int(s) for s in meta.get("slots", {})]
            snaps = led.snapshot_many(slots)
            for slot, snap in zip(slots, snaps):
                last[slot] = (
                    int(snap[Counter.STEPS_RETIRED]),
                    int(snap[Counter.DEVICE_TIME_NS]),
                    int(snap[Counter.HBM_STALL_NS]),
                )

    def sample_once(self, now_ns: int | None = None) -> None:
        """One manual sampling tick — the monitor-side path used by
        ``pbst-torch oprofile`` to profile PASSIVE ledgers in real time
        without arming any (virtual) timer wheel.  The first call
        primes counter baselines, so the first window starts at attach
        exactly like :meth:`start`; every call re-reads the producers'
        meta so later-admitted jobs are sampled too."""
        if self.state is SessionState.CLOSED:
            raise RuntimeError("session closed")
        if now_ns is None:
            if self.partition is None:
                raise ValueError(
                    "passive-only sessions need an explicit now_ns")
            now_ns = self.partition.clock.now_ns()
        if self.state is not SessionState.RUNNING:
            self._prime()
            self.state = SessionState.RUNNING
        self.refresh_passive_meta()
        self._tick(now_ns)

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.stop()
            self._timer = None
        if self.state is SessionState.RUNNING:
            self.state = SessionState.STOPPED

    def close(self) -> None:
        self.stop()
        release(self._token)
        self.state = SessionState.CLOSED

    def __enter__(self) -> "ProfileSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- sampling --------------------------------------------------------

    def _record(self, job: str, s: Sample) -> None:
        buf = self.samples.setdefault(job, [])
        if len(buf) >= self.max_samples:
            self.lost[job] = self.lost.get(job, 0) + 1
            return
        buf.append(s)

    @staticmethod
    def _reset(cur, prev) -> bool:
        """A producer restart zeroes its ledger slot (Partition.add_job
        resets at admission): any counter moving BACKWARD means the
        baseline belongs to a dead incarnation — re-baseline silently
        instead of recording a negative delta."""
        return any(c < p for c, p in zip(cur, prev))

    def _tick(self, now_ns: int) -> None:
        # Active domains: the hosting partition's own jobs.
        for job in (self.partition.jobs if self.partition else ()):
            for ctx in job.contexts:
                cur = (
                    int(ctx.counters[Counter.STEPS_RETIRED]),
                    int(ctx.counters[Counter.DEVICE_TIME_NS]),
                    int(ctx.counters[Counter.HBM_STALL_NS]),
                )
                cw = int(ctx.counters[Counter.COLLECTIVE_WAIT_NS])
                prev = self._last.get(ctx.name, (0, 0, 0))
                prev_cw = self._last_cw.get(ctx.name, 0)
                if cur == prev and cw == prev_cw:
                    # idle since last tick: no sample (unhalted cycles
                    # only, like PMU sampling). Baselines stay put so
                    # activity accrued across idle ticks lands on the
                    # next recorded sample rather than vanishing.
                    continue
                if self._reset(cur, prev) or cw < prev_cw:
                    self._last[ctx.name] = cur
                    self._last_cw[ctx.name] = cw
                    continue
                self._last[ctx.name] = cur
                self._last_cw[ctx.name] = cw
                self._record(job.name, Sample(
                    ts_ns=now_ns, ctx=ctx.name, step=cur[0],
                    device_dns=cur[1] - prev[1],
                    stall_dns=cur[2] - prev[2],
                    coll_wait_dns=cw - prev_cw,
                ))
        # Passive domains: lock-free ledger snapshots of foreign
        # partitions — one vectorized snapshot_many per domain per tick
        # (the sample-window fast path) instead of a per-slot loop.
        for name, led, _path, meta in self._passive:
            last = self._passive_last[name]
            slot_meta = meta.get("slots", {})
            snaps = led.snapshot_many([int(s) for s in slot_meta])
            for (slot_s, info), snap in zip(slot_meta.items(), snaps):
                slot = int(slot_s)
                cur = (
                    int(snap[Counter.STEPS_RETIRED]),
                    int(snap[Counter.DEVICE_TIME_NS]),
                    int(snap[Counter.HBM_STALL_NS]),
                )
                prev = last.get(slot, (0, 0, 0))
                if cur == prev:
                    continue
                last[slot] = cur
                if self._reset(cur, prev):
                    continue  # producer restarted: window discarded
                self._record(f"{name}/{info.get('job', slot)}", Sample(
                    ts_ns=now_ns, ctx=info.get("ctx", str(slot)),
                    step=cur[0],
                    device_dns=cur[1] - prev[1],
                    stall_dns=cur[2] - prev[2],
                    coll_wait_dns=0,
                ))

    # -- report ----------------------------------------------------------

    def report(self) -> dict:
        """Flat profile per job: sample counts and where device time
        went (the opreport analog)."""
        out = {}
        for job, samples in self.samples.items():
            dev = sum(s.device_dns for s in samples)
            stall = sum(s.stall_dns for s in samples)
            coll = sum(s.coll_wait_dns for s in samples)
            out[job] = {
                "samples": len(samples),
                "lost": self.lost.get(job, 0),
                "device_ms": round(dev / 1e6, 3),
                "stall_pct": round(100.0 * stall / dev, 2) if dev else 0.0,
                "collective_wait_ms": round(coll / 1e6, 3),
                "last_step": samples[-1].step if samples else 0,
            }
        return out
