"""Scheduler-event digestion + live monitor (xenbaked / xenmon analog).

The port of ``pbs_tpu.obs.mon``: same windows, same rows. Reference:
``xenbaked`` (``tools/xenmon/xenbaked.c``) maps the hypervisor's per-CPU
trace rings dom0-side, consumes ``TRC_SCHED_*`` events, and folds them
into rotating per-domain history windows (gotten/blocked/waited time,
exec counts, I/O counts) in a shared-memory file that ``xenmon.py``
renders live (``tools/xenmon/README:1-25``).

Here the same two halves:

- :class:`SchedHistory` — folds trace records (``Ev.SCHED_PICK`` /
  ``SCHED_DESCHED`` / ``SCHED_WAKE``) into per-slot rotating windows of
  gotten-time, allocated-quantum, exec and wake counts.
- :class:`Monitor` — attaches to a partition's file-backed trace rings
  and ledger (``Partition(trace_dir=..., ledger_path=...)``), drains
  rings incrementally, and serves labeled rows for ``pbst-torch mon``.
  The rings and the meta sidecar have the reference's layout, so either
  package's monitor attaches to either package's partition.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os

import numpy as np

from pbs_tpu_torch.obs.trace import Ev, TraceBuffer

SEC = 1_000_000_000


@dataclasses.dataclass
class Window:
    """One history window for one slot (xenbaked ``struct cpu_history``
    row: gotten/allocated/blocked/waited per domain per period)."""

    gotten_ns: int = 0  # device time actually burned (DESCHED ran_ns)
    allocated_ns: int = 0  # quanta handed out (PICK quantum_ns)
    execs: int = 0  # times scheduled (DESCHED count)
    wakes: int = 0


class SchedHistory:
    """Rotating per-slot windows over a sched-event stream.

    Windows rotate on *trace* time (virtual or wall — whatever stamped
    the records), so digestion is deterministic and replayable from a
    saved trace dump, like xenbaked re-run over an xentrace log.
    """

    def __init__(self, window_ns: int = SEC, n_windows: int = 10):
        self.window_ns = window_ns
        self.n_windows = n_windows
        self._win_start: int | None = None  # start ts of current window
        self._cur: dict[int, Window] = collections.defaultdict(Window)
        self._hist: dict[int, collections.deque[Window]] = (
            collections.defaultdict(
                lambda: collections.deque(maxlen=n_windows)))
        self.records_seen = 0

    def _roll_to(self, ts: int) -> None:
        if self._win_start is None:
            self._win_start = ts - ts % self.window_ns
            return
        while ts >= self._win_start + self.window_ns:
            # close the current window for every slot ever seen
            for slot in set(self._hist) | set(self._cur):
                self._hist[slot].append(self._cur.get(slot, Window()))
            self._cur = collections.defaultdict(Window)
            self._win_start += self.window_ns

    def ingest(self, recs: np.ndarray) -> int:
        """Fold (n, 8) u64 trace records; returns records consumed."""
        if not len(recs):
            return 0
        # One bulk tolist() instead of 3-4 numpy scalar reads per
        # record: digestion is the monitor's hot loop (pbst-torch mon
        # polls tens of thousands of records per refresh).
        for row in np.asarray(recs).tolist():
            ts, ev = row[0], row[1]
            self._roll_to(ts)
            self.records_seen += 1
            if ev == Ev.SCHED_PICK:
                self._cur[row[2]].allocated_ns += row[3]
            elif ev == Ev.SCHED_DESCHED:
                w = self._cur[row[2]]
                w.gotten_ns += row[3]
                w.execs += 1
            elif ev == Ev.SCHED_WAKE:
                self._cur[row[2]].wakes += 1
        return len(recs)

    def slots(self) -> list[int]:
        return sorted(set(self._hist) | set(self._cur))

    def summary(self, slot: int, windows: int | None = None,
                include_open: bool = True) -> Window:
        """Aggregate over the last ``windows`` closed windows, plus the
        open one unless ``include_open=False`` (None = everything held)."""
        agg = Window()
        hist = list(self._hist.get(slot, ()))
        if windows is not None:
            # NB: hist[-0:] would be the whole list, not none of it; and
            # the start must clamp at 0 or windows > len(hist) wraps
            # negative and silently drops the oldest closed windows.
            hist = hist[max(0, len(hist) - windows):] if windows > 0 else []
        if include_open:
            hist = hist + [self._cur.get(slot, Window())]
        for w in hist:
            agg.gotten_ns += w.gotten_ns
            agg.allocated_ns += w.allocated_ns
            agg.execs += w.execs
            agg.wakes += w.wakes
        return agg

    def cpu_pct(self, slot: int, windows: int = 1) -> float:
        """Share of trace time the slot burned over the last windows —
        xenmon's headline per-domain CPU% column. Requires ≥1 window
        (the open window alone has no fixed denominator). Only closed
        windows count: the open window's partial gotten_ns over a
        full-window denominator would understate early and let the
        column drift above 100% late."""
        if windows < 1:
            raise ValueError("cpu_pct needs windows >= 1")
        span = windows * self.window_ns
        got = self.summary(slot, windows, include_open=False).gotten_ns
        return 100.0 * got / span


class Monitor:
    """Live attachment to a partition's observability artifacts.

    The consumer side of the shared-memory contract: trace rings are
    drained destructively (this is THE consumer, like xenbaked), the
    ledger is snapshot lock-free read-only."""

    def __init__(self, meta_path: str, window_ns: int = SEC,
                 n_windows: int = 10):
        with open(meta_path) as f:
            self.meta = json.load(f)
        trace_dir = self.meta.get("trace_dir")
        if not trace_dir:
            raise ValueError(
                "partition has no trace_dir; create it with "
                "Partition(trace_dir=...) for live monitoring")
        self.rings = [
            TraceBuffer.file_backed(
                os.path.join(trace_dir, f"trace{i}.ring"), attach=True)
            for i in range(int(self.meta.get("n_rings", 1)))
        ]
        self.history = SchedHistory(window_ns, n_windows)
        self._meta_path = meta_path

    def refresh_meta(self) -> None:
        with open(self._meta_path) as f:
            self.meta = json.load(f)

    def poll(self, max_records: int = 65536) -> int:
        """Drain all rings into the history; returns records consumed."""
        from pbs_tpu_torch.obs.trace import merge_records

        return self.history.ingest(
            merge_records([r.consume(max_records) for r in self.rings]))

    def rows(self, windows: int = 1) -> list[dict]:
        """Per-context rows labeled through the meta sidecar."""
        slot_meta = {int(k): v for k, v in self.meta.get("slots", {}).items()}
        out = []
        for slot in self.history.slots():
            info = slot_meta.get(slot, {})
            agg = self.history.summary(slot, windows)
            out.append({
                "slot": slot,
                "ctx": info.get("ctx", f"slot{slot}"),
                "job": info.get("job", "?"),
                "weight": info.get("weight"),
                "cpu_pct": round(self.history.cpu_pct(slot, windows), 2),
                "gotten_ms": round(agg.gotten_ns / 1e6, 3),
                "execs": agg.execs,
                "wakes": agg.wakes,
            })
        return out
