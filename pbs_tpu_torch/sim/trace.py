"""JSONL trace record/replay for the scheduler simulator.

The port of ``pbs_tpu.sim.trace``, byte for byte: a trace either
package writes replays in the other to the same counter totals.

The record side is a lightweight recorder that a ``Partition`` exposes as
``partition.recorder``: ``runtime/executor.py`` appends one ``quantum``
record per dispatched quantum and ``sched/feedback.py`` appends one
``tick`` record per adaptation decision. Records are canonical JSON (one
object per line, sorted keys, no whitespace) so a whole run hashes to a
stable digest — the determinism gate of the ``pbst-torch sim`` CLI.

The replay side turns a recorded run back into a ``TelemetrySource``:
``ReplayBackend`` feeds the recorded per-quantum counter deltas to the
*real* scheduler stack on a virtual clock, so a run captured on live
hardware (``CudaBackend`` on the card) can be re-examined — or
re-scheduled under a different policy — offline, bit-for-bit on the
counter totals.

Schema (``v`` = 1):

    {"kind":"meta","v":1,"scheduler":...,"seed":...,"jobs":[...],...}
    {"kind":"quantum","t":ns,"end":ns,"ex":i,"job":name,"ctx":i,
     "q_ns":quantum,"n":units,"c":{counter_name:delta,...}}
    {"kind":"tick","t":ns,"job":name,"phase":...,"stall_x1000":...,
     "nspi_x1000":...,"tslice_us":...,"grows":...,"shrinks":...,
     "resets":...}

Floats are scaled to integers before serialization so the byte stream
never depends on float repr.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict, deque
from typing import IO, Any, Iterable

import numpy as np

from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter
from pbs_tpu_torch.utils.clock import VirtualClock

SCHEMA_VERSION = 1


def dumps_canonical(rec: dict) -> str:
    """Canonical record encoding every digest in this package hashes:
    sorted keys, no whitespace — one byte stream per value, on any
    host (the recorded counter windows of ``hwtelem`` share it)."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


_dumps = dumps_canonical


class TraceRecorder:
    """Appends canonical-JSON records; in memory and optionally to a file.

    Install with ``partition.recorder = TraceRecorder(...)`` — the
    executor and the feedback policy call :meth:`on_quantum` /
    :meth:`on_feedback`; anything else may call :meth:`emit` with its own
    record kind (forward-compatible: replay ignores unknown kinds).
    """

    def __init__(self, path: str | None = None, keep_lines: bool = True):
        self.path = path
        # The digest is incremental and the file (if any) is streamed, so
        # keep_lines=False bounds memory for long-horizon sweeps — only
        # in-memory records()/round-trip consumers need the line list.
        self.keep_lines = keep_lines
        self.lines: list[str] = []
        self.records_emitted = 0
        self._hash = hashlib.sha256()
        # Opened lazily on the first emit so a recorder that never
        # records (engine built but not run) leaks no fd and leaves no
        # empty file behind.
        self._fh: IO[str] | None = None

    # -- producers -------------------------------------------------------

    def emit(self, rec: dict) -> None:
        line = _dumps(rec)
        self.records_emitted += 1
        self._hash.update(line.encode())
        self._hash.update(b"\n")
        if self.keep_lines:
            self.lines.append(line)
        if self.path is not None:
            if self._fh is None:
                self._fh = open(self.path, "w")
            self._fh.write(line + "\n")

    def meta(self, **fields: Any) -> None:
        self.emit({"kind": "meta", "v": SCHEMA_VERSION, **fields})

    def on_quantum(self, ex_index: int, ctx, quantum_ns: int, n_units: int,
                   deltas: np.ndarray, t0_ns: int, t1_ns: int) -> None:
        self.emit({
            "kind": "quantum",
            "t": int(t0_ns),
            "end": int(t1_ns),
            "ex": int(ex_index),
            "job": ctx.job.name,
            "ctx": int(ctx.index),
            "q_ns": int(quantum_ns),
            "n": int(n_units),
            # Sparse dict keyed by counter name: zero slots are omitted so
            # records stay small and schema-stable across NUM_COUNTERS
            # growth.
            "c": {Counter(i).name.lower(): int(v)
                  for i, v in enumerate(deltas) if int(v)},
        })

    def on_feedback(self, now_ns: int, job, st) -> None:
        self.emit({
            "kind": "tick",
            "t": int(now_ns),
            "job": job.name,
            "phase": st.phase,
            "stall_x1000": int(job.stall_rate * 1000),
            "nspi_x1000": int(job.nspi * 1000),
            "tslice_us": int(job.params.tslice_us),
            "grows": int(st.grows),
            "shrinks": int(st.shrinks),
            "resets": int(st.resets),
        })

    # -- consumers -------------------------------------------------------

    def digest(self) -> str:
        return self._hash.copy().hexdigest()

    def records(self) -> list[dict]:
        if not self.keep_lines and self.records_emitted:
            raise RuntimeError(
                "records() needs keep_lines=True (lines were streamed "
                "out, not retained); read them back with load_trace()")
        return [json.loads(ln) for ln in self.lines]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def digest_of(lines: Iterable[str]) -> str:
    """sha256 over the canonical line stream (newline-joined)."""
    h = hashlib.sha256()
    for ln in lines:
        h.update(ln.encode())
        h.update(b"\n")
    return h.hexdigest()


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def trace_meta(records: list[dict]) -> dict:
    for r in records:
        if r.get("kind") == "meta":
            return r
    return {}


class ReplayError(RuntimeError):
    """Replay asked for more quanta than the trace holds — the replayed
    schedule diverged past the recorded horizon."""


class ReplayBackend:
    """TelemetrySource that replays recorded quantum deltas.

    Per job, quanta are replayed in recorded order: each ``execute`` call
    pops the next record, advances the virtual clock by the recorded
    duration, and returns the recorded counter deltas — so replaying a
    trace under the same policy reproduces every counter total exactly,
    while replaying under a *different* policy answers "what would this
    workload have seen under policy X" from real measurements.
    """

    def __init__(self, records: list[dict],
                 clock: VirtualClock | None = None):
        self.clock = clock or VirtualClock()
        self._queues: dict[str, deque] = defaultdict(deque)
        for r in records:
            if r.get("kind") == "quantum":
                self._queues[r["job"]].append(r)

    def remaining(self, job_name: str) -> int:
        return len(self._queues.get(job_name, ()))

    def execute(self, ctx: Any, n_steps: int) -> np.ndarray:
        q = self._queues.get(ctx.job.name)
        if not q:
            raise ReplayError(
                f"trace exhausted for job {ctx.job.name!r}")
        r = q.popleft()
        self.clock.advance(max(0, r["end"] - r["t"]))
        deltas = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        for name, v in r["c"].items():
            deltas[Counter[name.upper()]] = np.uint64(v)
        return deltas

    # A recorded quantum already embodies whatever micro-chunking the
    # original run did; replay treats both entry points identically.
    execute_micro = execute


def recorded_steps(records: list[dict]) -> dict[str, int]:
    """Total STEPS_RETIRED per job across the trace."""
    out: dict[str, int] = defaultdict(int)
    for r in records:
        if r.get("kind") == "quantum":
            out[r["job"]] += int(r["c"].get("steps_retired", 0))
    return dict(out)


def replay_partition(records: list[dict], scheduler: str | None = None,
                     name: str = "replay"):
    """Build a Partition + jobs that replays ``records``.

    Job parameters come from the trace's meta record when present
    (recorded by ``SimEngine``), else defaults. Each job's ``max_steps``
    is pinned to the recorded step total so the run ends exactly when
    the trace is consumed.
    """
    from pbs_tpu_torch.runtime.job import Job, SchedParams
    from pbs_tpu_torch.runtime.partition import Partition

    meta = trace_meta(records)
    steps = recorded_steps(records)
    be = ReplayBackend(records)
    part = Partition(name, source=be,
                     scheduler=scheduler or meta.get("scheduler") or "credit",
                     n_executors=int(meta.get("n_executors", 1)))
    job_meta = {j["name"]: j for j in meta.get("jobs", [])}
    for job_name in steps:
        jm = job_meta.get(job_name, {})
        params = SchedParams(
            weight=int(jm.get("weight", 256)),
            cap=int(jm.get("cap", 0)),
            tslice_us=int(jm.get("tslice_us", 100)),
        )
        job = Job(job_name, params=params, max_steps=steps[job_name],
                  n_contexts=int(jm.get("n_contexts", 1)))
        if jm.get("avg_step_ns"):
            for ctx in job.contexts:
                ctx.avg_step_ns = float(jm["avg_step_ns"])
        part.add_job(job)

    # A divergent replay (queue drained while the policy still
    # dispatches) raises ReplayError inside the executor, whose MCE
    # containment would swallow it into a quiet per-job FAULT; surface
    # it to the run() caller instead — truncated what-ifs must be loud.
    def _surface_divergence(job: "Job", exc: BaseException) -> None:
        if isinstance(exc, ReplayError):
            raise exc

    part.on_job_failure = _surface_divergence
    return part
