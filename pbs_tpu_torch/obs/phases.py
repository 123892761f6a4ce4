"""Phase spans below the quantum: where the host is inside a training
micro-step, an engine tick, an MoE layer and an executor trip.

A port-only layer on the trace substrate. The partition's rings say
which job held the device for a quantum (``SCHED_PICK`` /
``SCHED_DESCHED``); nothing there says what the host did inside the
quantum while the card waited. Each phase boundary in the program is a
``with phases.span(name):``; with a :class:`PhaseRecorder` attached it
writes a ``PHASE_BEGIN`` / ``PHASE_END`` pair into the recorder's own
ring (never a partition ring, so every reader of those is untouched).

- **One switch.** :func:`attach` installs one recorder for the process,
  :func:`detach` removes it. Detached, a boundary costs one check and
  emits nothing, reads no counter and registers no callback.
- **Records.** Timestamps are ``time.monotonic_ns`` (always, also under
  a partition's virtual clock: a phase times host work). Arguments:
  the interned phase id (:attr:`PhaseRecorder.names`), the owner (the
  engine request id of a prefill, else the ledger slot of the context
  the executor dispatched last, :func:`own`), and one count (tokens,
  slots, prompt length, timers fired).
- **Nesting.** Phases nest on the attaching thread; :func:`pair` turns
  a drained stream into spans, each with its parent and its self time
  (its duration less its children's). Boundaries on other threads
  (autograd's device thread recomputing a checkpointed layer) are not
  recorded.
- **GC pauses.** The end of each of :data:`STALL_PHASES` writes a
  ``PHASE_STALLS`` record: the pause time and count of Python's garbage
  collector over the span (a ``gc.callbacks`` hook registered only
  while attached).

The event words are the class ``0x0Axx`` of :class:`Ph`, outside
``obs.trace.Ev``, which keeps the reference's taxonomy word for word.
``pbst-torch trace FILE --chrome OUT`` draws a saved stream
(:meth:`PhaseRecorder.save`) through :func:`chrome_trace`, a track per
phase. docs/TRACING_TORCH.md lists every span of the program.
"""

from __future__ import annotations

import enum
import gc
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np

from pbs_tpu_torch.obs.trace import EmitBatch, TraceBuffer


#: The top byte of the phase class's event words.
PHASE_CLASS = 0x0A


class Ph(enum.IntEnum):
    """The port's phase class (0x0Axx)."""

    PHASE_BEGIN = 0x0A01  # args: phase, owner, count
    PHASE_END = 0x0A02  # args: phase, owner, count
    PHASE_STALLS = 0x0A03  # args: phase, owner, gc_pause_ns, gc_runs


#: Ring capacity in records: a traced 51 s window of the benchmark's
#: cells writes well under a tenth of it (docs/TRACING_TORCH.md).
WINDOW_RECORDS = 1 << 19
#: Phases whose end writes the GC's pause time and runs over the span.
STALL_PHASES = ("train.micro", "engine.tick")
#: The process a Chrome trace draws the phases under: their clock.
PROCESS_NAME = "phases (host time.monotonic_ns)"

_now = time.monotonic_ns
_rec: "PhaseRecorder | None" = None


class _Off:
    """The span of a detached recorder: does nothing, takes any count."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    @property
    def count(self) -> int:
        return 0

    @count.setter
    def count(self, _value: int) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "pid", "owner", "count", "snap")

    def __init__(self, rec: "PhaseRecorder", pid: int, owner: int,
                 count: int):
        self.rec, self.pid, self.owner, self.count = rec, pid, owner, count
        self.snap = None

    def __enter__(self):
        rec = self.rec
        rec.batch.emit(_now(), Ph.PHASE_BEGIN, self.pid, self.owner,
                       self.count)
        if self.pid in rec._stall_ids:
            self.snap = (rec.gc_ns, rec.gc_runs)
        return self

    def __exit__(self, et, ev, tb):
        rec = self.rec
        snap = self.snap
        if snap is not None:
            t = _now()
            rec.batch.emit(t, Ph.PHASE_STALLS, self.pid, self.owner,
                           rec.gc_ns - snap[0], rec.gc_runs - snap[1])
        else:
            t = _now()
        rec.batch.emit(t, Ph.PHASE_END, self.pid, self.owner, self.count)
        return False


class PhaseRecorder:
    """A ring, its staging batch, the interned phase names and the
    GC's pause counters. Attach it with :func:`attach`; read it with
    :meth:`drain` and :func:`pair`."""

    def __init__(self, capacity: int = WINDOW_RECORDS):
        self.ring = TraceBuffer(capacity)
        self.batch = EmitBatch(self.ring)
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self._stall_ids = frozenset(self.intern(n) for n in STALL_PHASES)
        self.owner = 0
        self._thread = threading.get_ident()
        self.gc_ns = 0
        self.gc_runs = 0
        self._gc_t0 = 0

    def intern(self, name: str) -> int:
        pid = self._ids.get(name)
        if pid is None:
            pid = self._ids[name] = len(self.names)
            self.names.append(name)
        return pid

    def span(self, name: str, owner: int | None = None, count: int = 0):
        if threading.get_ident() != self._thread:
            return _OFF
        pid = self._ids.get(name)
        if pid is None:
            pid = self.intern(name)
        return _Span(self, pid, self.owner if owner is None else owner,
                     count)

    # -- the GC's pauses, counted only while attached ---------------------

    def _on_gc(self, phase: str, _info: dict) -> None:
        if phase == "start":
            self._gc_t0 = _now()
        else:
            self.gc_ns += _now() - self._gc_t0
            self.gc_runs += 1

    def _start(self) -> None:
        self._thread = threading.get_ident()
        gc.callbacks.append(self._on_gc)

    def _stop(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    # -- the reader's side ----------------------------------------------

    def drain(self) -> np.ndarray:
        """Every record written so far, in emit order, as an (n, 8) u64
        array; the ring is left empty."""
        self.batch.flush()
        chunks = []
        while True:
            recs = self.ring.consume(1 << 16)
            if not len(recs):
                break
            chunks.append(recs)
        if not chunks:
            return np.empty((0, 8), dtype="<u8")
        return np.concatenate(chunks, axis=0)

    @property
    def lost(self) -> int:
        """Records the full ring dropped."""
        return int(self.ring.lost)

    def save(self, path: str) -> None:
        """Write the drained stream to ``path`` (.npy) and the phase names
        beside it (:func:`sidecar_path`), the form ``pbst-torch trace FILE
        --chrome OUT`` reads."""
        with open(path, "wb") as f:
            np.save(f, self.drain())
        with open(sidecar_path(path), "w") as f:
            json.dump({"names": self.names, "lost": self.lost}, f)


def sidecar_path(path: str) -> str:
    """The phase names of a saved stream: ``X.npy`` -> ``X.phases.json``."""
    return os.path.splitext(path)[0] + ".phases.json"


# -- the process-wide switch ---------------------------------------------


def attach(rec: PhaseRecorder | None = None) -> PhaseRecorder:
    """Install ``rec`` (a new recorder by default) for the process, on
    the calling thread. Raises if one is attached already."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a phase recorder is attached already")
    rec = rec or PhaseRecorder()
    rec._start()
    _rec = rec
    return rec


def detach() -> PhaseRecorder | None:
    """Remove the attached recorder (flushing its staged records into
    its ring) and return it; None if none was attached."""
    global _rec
    rec, _rec = _rec, None
    if rec is not None:
        rec._stop()
        rec.batch.flush()
    return rec


def attached() -> PhaseRecorder | None:
    return _rec


def span(name: str, owner: int | None = None, count: int = 0):
    """``with span(name):`` around one phase. ``owner`` defaults to the
    ledger slot :func:`own` set last; ``count`` may be set on the span
    before it ends."""
    rec = _rec
    if rec is None:
        return _OFF
    return rec.span(name, owner, count)


def own(owner: int) -> None:
    """The owner of the spans that name none: the executor sets the
    ledger slot of each context it dispatches."""
    rec = _rec
    if rec is not None:
        rec.owner = owner


# -- reading a stream ------------------------------------------------------


class PhaseSpan(NamedTuple):
    name: str
    owner: int
    count: int
    t0: int
    t1: int
    depth: int
    parent: int  # index into the list, -1 at the top
    self_ns: int
    gc_pause_ns: int
    gc_runs: int


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def pair(records: np.ndarray, names: list[str]) -> list[PhaseSpan]:
    """The closed spans of a drained stream, in begin order. A span the
    stream leaves open (its end lost or not yet written) is left out;
    its closed children keep it as their parent's index -1."""
    out: list[list] = []
    stack: list[int] = []
    for ts, ev, pid, owner, count, a3, _, _ in np.asarray(
            records).tolist():
        name = names[pid] if pid < len(names) else f"phase{pid}"
        if ev == Ph.PHASE_BEGIN:
            out.append([name, _signed(owner), count, ts, None, len(stack),
                        stack[-1] if stack else -1, 0, 0, 0])
            stack.append(len(out) - 1)
        elif ev == Ph.PHASE_END:
            if not any(out[k][0] == name for k in stack):
                continue  # its begin was drained before, or lost
            # spans opened inside it and never closed are abandoned
            while out[stack[-1]][0] != name:
                stack.pop()
            i = stack.pop()
            out[i][2], out[i][4] = count, ts
        elif ev == Ph.PHASE_STALLS and stack:
            out[stack[-1]][8:10] = count, a3
    closed = [i for i, s in enumerate(out) if s[4] is not None]
    index = {i: k for k, i in enumerate(closed)}
    spans = []
    for i in closed:
        s = out[i]
        p = s[6]
        while p >= 0 and p not in index:
            p = out[p][6]
        s[6] = index.get(p, -1)
        s[7] = s[4] - s[3]
        spans.append(s)
    for s in spans:
        if s[6] >= 0:
            spans[s[6]][7] -= s[4] - s[3]
    return [PhaseSpan(*s) for s in spans]


def chrome_trace(records: np.ndarray, names: list[str],
                 pid: int = 0) -> dict:
    """Chrome trace-event JSON (chrome://tracing, Perfetto) of a phase
    stream: each span a duration event on its phase's track, with its
    owner, count and self time; a track is named after its phase, and
    process ``pid`` :data:`PROCESS_NAME`, since a ring drawn beside it
    may keep another clock (a sim partition's virtual one)."""
    spans = pair(records, names)
    tracks: dict[str, int] = {}
    events: list[dict] = []
    for s in spans:
        tid = tracks.setdefault(s.name, len(tracks))
        args = {"owner": s.owner, "count": s.count,
                "self_us": s.self_ns / 1e3}
        if s.name in STALL_PHASES:
            args.update(gc_pause_us=s.gc_pause_ns / 1e3, gc_runs=s.gc_runs)
        events.append({"name": s.name, "ph": "X", "cat": "phase",
                       "ts": s.t0 / 1e3, "dur": max(s.t1 - s.t0, 1) / 1e3,
                       "pid": pid, "tid": tid, "args": args})
    events.append({"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": PROCESS_NAME}})
    for name, tid in tracks.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
