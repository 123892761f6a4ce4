"""The program's phase spans on the device trace's clock.

The port records its own phases (``pbs_tpu_torch.obs.phases``: the
micro-step's feed, forward, backward, accumulation and optimizer, the
engine tick's admissions, prefills, decode, host read and emit loop, the
MoE layer's routing, experts and combine, the executor's timers, pick and
accounting) on the host's monotonic clock. ``torch.profiler`` stamps its
records on its own clock. This module joins the two and says where the
card's time and its idle went, phase by phase:

- **Clock.** :func:`anchor` reads the tightest of 5 (monotonic, wall)
  pairs; one at the session's start and one at its stop map a program
  timestamp onto the profiler's clock by linear interpolation
  (:class:`ClockMap`), and their difference is the drift.
- **Device time.** A device record (kernel, copy, set) belongs to the
  innermost phase whose span holds its launch: the runtime call with the
  same correlation id. A record whose launch is missing is placed by its
  own start on the card, and counted.
- **Idle.** The complement, over the window, of the union of the device
  records that start in it (``devtrace.summarize``'s busy union); each
  idle gap is split exactly over the innermost phases that cover it.

:func:`report` reads a stopped profiler session and a drained phase
stream; :func:`metric` and :func:`breakdown` read a report. A run
whose profiler saw no device record (a host rehearsal) has no report,
and each metric reads None.
"""

from __future__ import annotations

import bisect
import re
import time

from benchmark.devtrace import SPAN_ORDER, _annotation

ANCHOR_READS = 5
#: How far a phase span may lie outside the harness's span around the
#: same call, after the clocks are joined, before it counts as
#: misaligned.
ALIGN_NS = 20_000
#: Each program phase and the harness span that holds it.
HELD_BY = {"train.micro": "train_micro_step", "engine.tick": "engine_tick"}
#: Host records that queue device work: the CUDA API calls
#: (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` ...),
#: whose correlation ids are their records' on the card.
LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")
NO_PHASE = "no_phase"
TOP = 10

METRICS = ("micro_idle_ms", "backward_device_ms", "optimizer_device_ms",
           "tick_idle_ms")


def anchor(reads: int = ANCHOR_READS) -> tuple[int, int]:
    """(monotonic ns, wall ns) read together: of ``reads`` tries, the one
    whose two monotonic reads around the wall read lie closest, at their
    midpoint."""
    best = None
    for _ in range(reads):
        a = time.monotonic_ns()
        w = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


class ClockMap:
    """Monotonic ns -> the profiler's (wall) ns, linear between two
    anchors."""

    def __init__(self, start: tuple[int, int], stop: tuple[int, int]):
        (self.m0, self.w0), (self.m1, self.w1) = start, stop
        #: How far the wall clock moved against the monotonic one
        #: between the anchors.
        self.drift_ns = (self.w1 - self.m1) - (self.w0 - self.m0)

    def __call__(self, t: int) -> int:
        span = self.m1 - self.m0
        if span <= 0:
            return t + (self.w0 - self.m0)
        return self.w0 + (t - self.m0) * (self.w1 - self.w0) // span


def profiler_records(prof) -> tuple[list, dict, list]:
    """From a stopped ``torch.profiler.profile``: the device records
    [(name, start, end, correlation id)], the launches {correlation id:
    start} and the harness's spans [(name, start, end)], all on the
    profiler's clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, launches, harness = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == cuda:
            # the records devtrace.Session.events counts as work
            if name not in SPAN_ORDER and not _annotation(e):
                device.append((name, start, start + e.duration_ns(),
                               e.correlation_id()))
        elif name in SPAN_ORDER:
            harness.append((name, start, start + e.duration_ns()))
        elif LAUNCH_NAME.match(name) and e.correlation_id():
            launches[e.correlation_id()] = start
    return device, launches, harness


class _Innermost:
    """The innermost span at each instant: spans that nest (one host
    thread's) cut the timeline into segments, each held by one span."""

    def __init__(self, spans: list):
        events = []
        for i, (_, a, b, depth, _p) in enumerate(spans):
            events.append((a, 1, depth, i))
            events.append((b, 0, -depth, i))
        events.sort()
        self.starts: list[int] = []
        self.held: list[int] = []
        stack: list[int] = []
        for t, opens, _, i in events:
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            top = stack[-1] if stack else -1
            if self.starts and self.starts[-1] == t:
                self.held[-1] = top
            else:
                self.starts.append(t)
                self.held.append(top)

    def at(self, t: int) -> int:
        k = bisect.bisect_right(self.starts, t) - 1
        return self.held[k] if k >= 0 else -1

    def split(self, g0: int, g1: int):
        """(span, ns) over [g0, g1), exactly."""
        k = max(0, bisect.bisect_right(self.starts, g0) - 1)
        n = len(self.starts)
        if not n or g0 < self.starts[0]:
            end = min(g1, self.starts[0]) if n else g1
            yield -1, end - g0
            g0 = end
        while g0 < g1 and k < n:
            end = self.starts[k + 1] if k + 1 < n else g1
            end = min(end, g1)
            if end > g0:
                yield self.held[k], end - g0
                g0 = end
            k += 1


def attribute(spans: list, device: list, launches: dict, t0: int,
              t1: int) -> dict:
    """Idle and device time by span over the window [t0, t1), all on one
    clock. ``spans``: [(name, start, end, depth, parent index)] in begin
    order; ``device``: [(name, start, end, correlation id)]. Returns the
    self (innermost) and inclusive idle and device ns of each span, the
    window's busy ns, and the records placed by their own start."""
    where = _Innermost(spans)
    n = len(spans)
    idle, dev = [0] * n, [0] * n
    idle_out = dev_out = 0
    recs = sorted((s, min(e, t1), c) for _, s, e, c in device
                  if t0 <= s < t1)
    busy, last, unlaunched = 0, t0, 0
    for s, e, corr in recs:
        if s > last:
            for i, ns in where.split(last, s):
                if i < 0:
                    idle_out += ns
                else:
                    idle[i] += ns
        busy += max(0, e - max(s, last))
        last = max(last, e)
        at = launches.get(corr)
        if at is None:
            unlaunched += 1
            at = s
        i = where.at(at)
        if i < 0:
            dev_out += e - s
        else:
            dev[i] += e - s
    if t1 > last:
        for i, ns in where.split(last, t1):
            if i < 0:
                idle_out += ns
            else:
                idle[i] += ns
    idle_in, dev_in = list(idle), list(dev)
    for i in range(n - 1, -1, -1):
        p = spans[i][4]
        if p >= 0:
            idle_in[p] += idle_in[i]
            dev_in[p] += dev_in[i]
    return {"idle_self": idle, "device_self": dev, "idle_in": idle_in,
            "device_in": dev_in, "idle_outside": idle_out,
            "device_outside": dev_out, "busy_ns": busy,
            "window_ns": t1 - t0, "unlaunched": unlaunched,
            "n_device": len(recs)}


def _misaligned(spans: list, ends_in: list, harness: list) -> int:
    """Phase spans ending in the window that lie outside the harness span
    around the same call by more than ``ALIGN_NS``."""
    out = 0
    for name, held_by in HELD_BY.items():
        hs = sorted((a, b) for n, a, b in harness if n == held_by)
        starts = [a for a, _ in hs]
        for i, s in enumerate(spans):
            if s[0] != name or not ends_in[i]:
                continue
            k = bisect.bisect_right(starts, s[1] + ALIGN_NS) - 1
            if k < 0 or hs[k][1] < s[2] - ALIGN_NS:
                out += 1
    return out


def report_from(phase_spans: list, device: list, launches: dict,
                harness: list, clock: ClockMap, t0: int, t1: int,
                lost: int = 0, records: int = 0) -> dict | None:
    """The window's report from phase spans (``obs.phases.pair``, on the
    monotonic clock) and the profiler's records (on its own); ``t0``,
    ``t1`` monotonic. None without any device record."""
    if not device:
        return None
    w0, w1 = clock(t0), clock(t1)
    spans = [(s.name, clock(s.t0), clock(s.t1), s.depth, s.parent)
             for s in phase_spans]
    att = attribute(spans, device, launches, w0, w1)
    ends_in = [w0 <= s[2] <= w1 for s in spans]
    return {"spans": spans, "ends_in": ends_in, "window": (w0, w1),
            "gc": [(s.gc_pause_ns, s.gc_runs) for s in phase_spans],
            "att": att, "drift_ns": clock.drift_ns,
            "misaligned": _misaligned(spans, ends_in, harness),
            "lost": lost, "records": records}


def report(prof, records, names: list, lost: int, start: tuple[int, int],
           stop: tuple[int, int], t0: int, t1: int) -> dict | None:
    """The report of a traced window: ``prof`` a stopped profiler
    session, ``records`` / ``names`` / ``lost`` the phase recorder's
    drained stream, ``start`` / ``stop`` the anchors read at the
    session's start and stop, [t0, t1) the window on the monotonic
    clock."""
    from pbs_tpu_torch.obs.phases import pair

    device, launches, harness = profiler_records(prof)
    return report_from(pair(records, names), device, launches, harness,
                       ClockMap(start, stop), t0, t1, lost, len(records))


def _in_window(rep: dict, name: str) -> list[int]:
    return [i for i, s in enumerate(rep["spans"])
            if s[0] == name and rep["ends_in"][i]]


def _per(rep: dict, name: str, key: str):
    idx = _in_window(rep, name)
    if not idx:
        return None
    return sum(rep["att"][key][i] for i in idx) / len(idx) / 1e6


def metric(rep: dict | None, name: str):
    """One of :data:`METRICS` from a report (None without one, or
    without the phases it reads)."""
    if rep is None:
        return None
    if name == "micro_idle_ms":
        return _per(rep, "train.micro", "idle_in")
    if name == "tick_idle_ms":
        return _per(rep, "engine.tick", "idle_in")
    if name == "backward_device_ms":
        return _per(rep, "train.backward", "device_in")
    if name == "optimizer_device_ms":
        return _per(rep, "train.optimizer", "device_in")
    raise KeyError(name)


def _by_name(rep: dict, key: str, outside: str) -> list:
    tot: dict[str, int] = {}
    for s, ns in zip(rep["spans"], rep["att"][key]):
        if ns:
            tot[s[0]] = tot.get(s[0], 0) + ns
    if rep["att"][outside]:
        tot[NO_PHASE] = rep["att"][outside]
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n, v / 1e9] for n, v in top]


def breakdown(rep: dict | None) -> dict:
    """The result line's additions: idle and device time by innermost
    phase (top 10, seconds, ``idle_gaps``' shape), the clocks' join, and
    the GC's pauses over each stall phase in the window."""
    if rep is None:
        return {}
    stalls = {}
    for name in HELD_BY:
        idx = _in_window(rep, name)
        if idx:
            g, r = (sum(rep["gc"][i][k] for i in idx) for k in range(2))
            stalls[name] = {"spans": len(idx), "gc_pause_s": g / 1e9,
                            "gc_runs": r}
    return {"program_idle": _by_name(rep, "idle_self", "idle_outside"),
            "program_device": _by_name(rep, "device_self",
                                       "device_outside"),
            "program_clock": {"drift_ns": rep["drift_ns"],
                              "misaligned": rep["misaligned"],
                              "lost": rep["lost"],
                              "records": rep["records"],
                              "unlaunched": rep["att"]["unlaunched"]},
            "program_stalls": stalls}
