"""Recorded counter windows: live hardware telemetry as a replayable
asset.

The port of ``pbs_tpu.hwtelem.window``: a bounded ring of per-sample
declared-event deltas, serialized as canonical JSONL
(``sim/trace.dumps_canonical`` — sorted keys, no whitespace, ints only)
with a host-stable SHA-256 digest and a lossless save/load roundtrip.
The two recorded windows in ``windows/`` are the reference's, byte for
byte; every deterministic hwtelem test runs off them, and touching the
live ladder is ``slow``-only.

``ReplaySource`` feeds a recorded window back through the
``TelemetrySource`` protocol deterministically: same window ⇒ the
same counter-delta byte stream, twice, on any host. No wall clock
anywhere in this module — the recorder is HANDED timestamps by its
driver (whose sampling edge is the declared seam in
hwtelem/sources.py), and replay advances a VirtualClock by recorded
deltas.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from pbs_tpu_torch import knobs
from pbs_tpu_torch.hwtelem.sources import (
    DECLARED_EVENTS,
    event_deltas_to_counters,
)
from pbs_tpu_torch.sim.trace import dumps_canonical
from pbs_tpu_torch.utils.clock import VirtualClock

HW_SCHEMA_VERSION = 1

#: Default ring capacity (samples retained); KnobWatcher-adoptable via
#: hwtelem.window_len for live recorders.
DEFAULT_CAPACITY = knobs.default("hwtelem.window_len")


@dataclasses.dataclass(frozen=True)
class CounterWindow:
    """One recorded counter window, self-contained and replayable.

    ``samples`` are ``(t_rel_ns, (delta, ...))`` tuples in capture
    order: times relative to ``t0_ns``, one integer delta per entry of
    ``events`` (the declared events the recording tier supplied).
    ``tier`` names the rung that produced it; ``period_ns`` is the
    nominal sampling period the recorder was driven at.
    """

    t0_ns: int
    t1_ns: int
    tier: str
    events: tuple[str, ...]
    samples: tuple[tuple[int, tuple[int, ...]], ...]
    period_ns: int
    dropped: int = 0

    def lines(self) -> list[str]:
        """Canonical JSONL encoding (meta line first, then one line
        per sample) — what ``save`` writes and ``digest`` hashes."""
        out = [dumps_canonical({
            "kind": "hw-meta", "v": HW_SCHEMA_VERSION,
            "t0_ns": int(self.t0_ns), "t1_ns": int(self.t1_ns),
            "tier": self.tier, "events": list(self.events),
            "period_ns": int(self.period_ns),
            "dropped": int(self.dropped),
        })]
        out.extend(dumps_canonical({
            "kind": "sample", "t": int(t),
            "d": [int(v) for v in d]})
            for t, d in self.samples)
        return out

    def digest(self) -> str:
        h = hashlib.sha256()
        for ln in self.lines():
            h.update(ln.encode())
            h.update(b"\n")
        return h.hexdigest()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for ln in self.lines():
                f.write(ln + "\n")

    @classmethod
    def load(cls, path: str) -> "CounterWindow":
        meta = None
        samples: list[tuple[int, tuple[int, ...]]] = []
        with open(path) as f:
            for ln in f:
                if not ln.strip():
                    continue
                rec = json.loads(ln)
                if rec.get("kind") == "hw-meta":
                    meta = rec
                elif rec.get("kind") == "sample":
                    samples.append((int(rec["t"]),
                                    tuple(int(v) for v in rec["d"])))
        if meta is None:
            raise ValueError(f"{path}: no hw-meta record")
        if meta.get("v") != HW_SCHEMA_VERSION:
            raise ValueError(f"{path}: hw schema v{meta.get('v')!r} "
                             f"!= {HW_SCHEMA_VERSION}")
        events = tuple(str(e) for e in meta["events"])
        for t, d in samples:
            if len(d) != len(events):
                raise ValueError(
                    f"{path}: sample width {len(d)} != "
                    f"{len(events)} declared events")
        return cls(t0_ns=int(meta["t0_ns"]), t1_ns=int(meta["t1_ns"]),
                   tier=str(meta["tier"]), events=events,
                   samples=tuple(samples),
                   period_ns=int(meta["period_ns"]),
                   dropped=int(meta.get("dropped", 0)))

    # -- derived views ---------------------------------------------------

    def totals(self) -> dict[str, int]:
        """Summed deltas per event over the whole window."""
        out = dict.fromkeys(self.events, 0)
        for _, d in self.samples:
            for ev, v in zip(self.events, d):
                out[ev] += int(v)
        return out

    def span_ns(self) -> int:
        return max(0, int(self.t1_ns) - int(self.t0_ns))


class HwRecorder:
    """Bounded ring of per-sample event deltas (preallocated arrays,
    head = n % capacity, ``dropped`` counts what aged out). Observer
    only — :meth:`sample` is handed the timestamp and the delta dict; it
    draws no randomness and reads no clock, so arming a recorder moves
    no digest."""

    def __init__(self, events: tuple[str, ...] = DECLARED_EVENTS,
                 capacity: int | None = None, tier: str = "?",
                 period_ns: int | None = None):
        if capacity is None:
            capacity = int(knobs.get("hwtelem.window_len"))
        if capacity < 1:
            raise ValueError("HwRecorder needs capacity >= 1")
        self.events = tuple(events)
        self.capacity = int(capacity)
        self.tier = str(tier)
        self.period_ns = int(period_ns
                             if period_ns is not None else
                             knobs.get("hwtelem.sample_period_ns"))
        self._t = np.zeros(self.capacity, dtype=np.int64)
        self._d = np.zeros((self.capacity, len(self.events)),
                           dtype=np.int64)
        self._n = 0  # total ever recorded; head = n % capacity

    def sample(self, now_ns: int, deltas: dict[str, int]) -> None:
        i = self._n % self.capacity
        self._t[i] = int(now_ns)
        for j, ev in enumerate(self.events):
            self._d[i, j] = int(deltas.get(ev, 0))
        self._n += 1

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def window(self) -> CounterWindow:
        """The retained samples in capture order as a value."""
        n = min(self._n, self.capacity)
        if n == 0:
            return CounterWindow(t0_ns=0, t1_ns=0, tier=self.tier,
                                 events=self.events, samples=(),
                                 period_ns=self.period_ns,
                                 dropped=self.dropped)
        if self._n > self.capacity:
            head = self._n % self.capacity
            order = np.concatenate([np.arange(head, self.capacity),
                                    np.arange(0, head)])
        else:
            order = np.arange(0, n)
        t0 = int(self._t[order[0]])
        t1 = int(self._t[order[-1]]) + 1
        samples = tuple(
            (int(self._t[i]) - t0,
             tuple(int(v) for v in self._d[i]))
            for i in order.tolist())
        return CounterWindow(t0_ns=t0, t1_ns=t1, tier=self.tier,
                             events=self.events, samples=samples,
                             period_ns=self.period_ns,
                             dropped=self.dropped)


class ReplaySource:
    """A recorded window fed back through the ``TelemetrySource``
    protocol, deterministically.

    Each ``execute`` consumes the next recorded sample (cycling past
    the end — a long executor run on a short window replays the same
    counter weather periodically, the honest option that keeps replay
    total), advances a VirtualClock by the recorded inter-sample gap,
    and returns the translated counter deltas with progress
    (STEPS_RETIRED) from the quantum shape. Two fresh ReplaySources
    over the same window emit byte-identical streams (the pinned
    replay contract); :meth:`reset` rewinds one in place.
    """

    def __init__(self, window: CounterWindow,
                 clock: VirtualClock | None = None):
        if not window.samples:
            raise ValueError("cannot replay an empty CounterWindow")
        self.window = window
        self.clock = clock if clock is not None else VirtualClock()
        self._i = 0
        # Inter-sample gaps: sample i's timestamp delta to its
        # predecessor (first sample charges its own offset from t0,
        # with a one-period floor so a same-timestamp burst still
        # advances time).
        ts = [t for t, _ in window.samples]
        self._gaps = [max(1, ts[0] if ts[0] > 0 else window.period_ns)]
        self._gaps += [max(1, b - a) for a, b in zip(ts, ts[1:])]

    @property
    def position(self) -> int:
        """Samples consumed so far (monotone; cycling keeps counting)."""
        return self._i

    def reset(self) -> None:
        self._i = 0

    def _next(self) -> np.ndarray:
        k = self._i % len(self.window.samples)
        _, d = self.window.samples[k]
        self.clock.advance(self._gaps[k])
        self._i += 1
        deltas = dict(zip(self.window.events, d))
        return event_deltas_to_counters(deltas, n_steps=0)

    def execute(self, ctx, n_steps: int) -> np.ndarray:
        out = self._next()
        out[0] = np.uint64(n_steps)  # Counter.STEPS_RETIRED
        return out

    def execute_micro(self, ctx, n_micro: int) -> np.ndarray:
        from pbs_tpu_torch.telemetry.counters import Counter

        out = self._next()
        K = max(1, int(getattr(ctx.job, "micro_per_step", 1)))
        steps = 0
        for _ in range(n_micro):
            ctx.micro_progress += 1
            if ctx.micro_progress >= K:
                ctx.micro_progress = 0
                steps += 1
        out[int(Counter.STEPS_RETIRED)] = np.uint64(steps)
        if ctx.micro_progress:
            out[int(Counter.YIELDS)] = np.uint64(
                int(out[int(Counter.YIELDS)]) + 1)
        return out

    def stream_digest(self, n: int) -> str:
        """SHA-256 over the first ``n`` replayed counter-delta vectors
        (fresh cursor; the caller's cursor is preserved). The byte
        stream ``pbst-torch hw replay`` pins: same window ⇒ same digest,
        twice, anywhere."""
        saved, saved_now = self._i, None
        clk = self.clock
        if isinstance(clk, VirtualClock):
            saved_now = clk._now
        self._i = 0
        h = hashlib.sha256()
        try:
            for _ in range(int(n)):
                out = self._next()
                h.update(out.tobytes())
        finally:
            self._i = saved
            if saved_now is not None:
                clk._now = saved_now
        return h.hexdigest()
