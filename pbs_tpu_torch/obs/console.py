"""Per-job consoles: the ``xl console`` analog.

Reference: every domain has a console ring the hypervisor relays to
dom0 (``xenconsoled``), and ``xl console <dom>`` attaches to stream it
— the primary "what is my guest saying" channel. The TPU-native
analog: every job owns a bounded line ring; the runtime writes
lifecycle events into it (admit, wake/sleep, fault containment with
the error), the workload itself can write via ``Job.log``, and
monitors stream it by sequence number — locally, or over the control
plane (``pbst console``), which mirrors xenconsoled's relay role.

Sequence-numbered reads make the stream resumable and loss-visible:
a reader that fell behind sees the gap (``first_seq`` > its cursor),
exactly like a console ring overwriting old lines.

Besides the per-job rings there is one *system* console — the analog of
the hypervisor's own ``xl dmesg`` ring: infrastructure that must report
a condition but has no job to attribute it to (a leaked RPC server
thread, a quarantined agent) writes here via :func:`log`.

The port of ``pbs_tpu.obs.console``, line for line; the agent's
``console`` op relays it (``pbst-torch console``).
"""

from __future__ import annotations

import collections
import threading
import time


class Console:
    """Bounded per-job line ring with monotone sequence numbers."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._lines: collections.deque[tuple[int, float, str]] = (
            collections.deque(maxlen=capacity))
        self._next_seq = 0
        self._lock = threading.Lock()

    def write(self, line: str) -> int:
        """Append one line; returns its sequence number."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._lines.append((seq, time.time(), str(line)))
            return seq

    def read(self, since: int = 0, max_lines: int = 256) -> dict:
        """Lines with seq >= ``since`` (up to ``max_lines``). The
        reply's ``next`` is the cursor for the following read;
        ``first_seq`` exposes ring loss to a lagging reader."""
        with self._lock:
            out = [(s, t, ln) for (s, t, ln) in self._lines if s >= since]
            first = self._lines[0][0] if self._lines else self._next_seq
            nxt = self._next_seq
        out = out[:max_lines]
        return {
            "lines": [
                {"seq": s, "time": t, "line": ln} for s, t, ln in out
            ],
            "next": out[-1][0] + 1 if out else nxt,
            "first_seq": first,
            "dropped": max(0, first - since) if since < first else 0,
        }


# -- system console (xl dmesg analog) ---------------------------------------

#: The one process-wide infrastructure ring. Bounded like every job
#: ring, so a wedged component that logs in a loop cannot grow memory.
_system = Console(capacity=1024)


def system_console() -> Console:
    return _system


def log(line: str) -> int:
    """Write one line to the system console ring. Returns its sequence
    number. This is where infrastructure reports conditions that have
    no owning job — operators read it with :func:`read_system`."""
    return _system.write(line)


def read_system(since: int = 0, max_lines: int = 256) -> dict:
    return _system.read(since, max_lines)
