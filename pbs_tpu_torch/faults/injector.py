"""Process-global deterministic fault injector.

One :class:`FaultInjector` owns a validated :class:`~pbs_tpu_torch.faults.plan
.FaultPlan` and is consulted by name at every instrumented seam
(``faults.consult(point, key)`` — the seams live in ``dist/rpc.py``,
``dist/agent.py``, ``telemetry/source.py``, ``ckpt/checkpoint.py``).
With no injector installed a consultation is a single global load — the
production hot paths pay nothing.

Determinism model: every ``(point, key)`` pair owns an independent
*stream* — its own ``random.Random`` seeded from ``sha256(plan.seed |
point | key)`` (never ``hash()``: that is salted per process) and its
own consultation counter. A stream's decision sequence is therefore a
pure function of (plan, its own consultation history); concurrent
streams cannot perturb each other no matter how threads interleave.
Callers keep keys *logical* (agent names, op names, job names — never
ephemeral ports or ids) so the same run consults the same streams.

The fault trace is the witness: every fired fault is recorded as a
``{point, key, seq, fault, args}`` record. The digest sorts the
canonical JSON lines before hashing, so it is independent of the
wall-clock interleaving of streams — two runs with the same seed and
the same per-stream histories produce the same digest even though their
threads raced differently (the gate ``pbst chaos`` asserts).

The port's copy of ``pbs_tpu.faults.injector``, word for word: the
same plan, seed and per-stream history give the same fault trace and
digest in either package. Of the seams named above the
port hosts one so far, ``telemetry.counters`` (``telemetry/source.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from typing import Any

from pbs_tpu_torch.faults.plan import FaultPlan
from pbs_tpu_torch.obs.lockprof import ProfiledLock


class InjectedFault(RuntimeError):
    """Raised by a seam when a 'crash'/'torn' fault fires — the
    distinguishable stand-in for the real failure (an agent dying
    mid-op, a checkpoint write torn by power loss). Marshalled across
    RPC like any remote error, so callers exercise their real
    error paths."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fired injection decision, handed to the seam to apply."""

    point: str
    key: str
    fault: str
    args: dict[str, Any]
    seq: int  # the stream's consultation index that fired


class _Stream:
    __slots__ = ("rng", "consults", "fired")

    def __init__(self, seed: int, point: str, key: str):
        digest = hashlib.sha256(f"{seed}|{point}|{key}".encode()).digest()
        self.rng = random.Random(int.from_bytes(digest[:8], "big"))
        self.consults = 0
        self.fired: dict[int, int] = {}  # spec index -> fire count


class FaultInjector:
    """The plan interpreter: consulted at each seam, records fires."""

    def __init__(self, plan: FaultPlan, trace_path: str | None = None):
        self.plan = plan.validate()
        self.trace_path = trace_path
        self._lock = ProfiledLock("fault_inject")
        self._streams: dict[tuple[str, str], _Stream] = {}
        self._by_point: dict[str, list[tuple[int, Any]]] = {}
        for i, s in enumerate(self.plan.specs):
            self._by_point.setdefault(s.point, []).append((i, s))
        self.records: list[dict] = []

    def consult(self, point: str, key: str) -> Fault | None:
        """One seam consultation. Returns the fault to apply (first
        matching rule that fires wins) or None. Streams that no rule
        can ever touch are never created, so an instrumented seam with
        no plan coverage costs one dict miss."""
        specs = self._by_point.get(point)
        if not specs:
            return None
        with self._lock:
            st = self._streams.get((point, key))
            if st is None:
                st = self._streams[(point, key)] = _Stream(
                    self.plan.seed, point, key)
            n = st.consults
            st.consults += 1
            for idx, spec in specs:
                if not spec.matches_key(key):
                    continue
                if n < spec.after:
                    continue
                fired = st.fired.get(idx, 0)
                if spec.times is not None and fired >= spec.times:
                    continue
                if st.rng.random() >= spec.p:
                    continue
                st.fired[idx] = fired + 1
                f = Fault(point=point, key=key, fault=spec.fault,
                          args=dict(spec.args), seq=n)
                self.records.append({
                    "point": point, "key": key, "seq": n,
                    "fault": spec.fault, "args": f.args,
                })
                return f
        return None

    # -- the witness -----------------------------------------------------

    def trace_lines(self) -> list[str]:
        """Canonical JSONL form of the fault trace, in fire order."""
        with self._lock:
            recs = [dict(r) for r in self.records]
        return [json.dumps(r, sort_keys=True, separators=(",", ":"))
                for r in recs]

    def trace_digest(self) -> str:
        """sha256 over the SORTED trace lines: per-stream sequences are
        deterministic but their wall-clock interleaving is not, so the
        reproducibility witness must not depend on append order."""
        h = hashlib.sha256()
        for line in sorted(self.trace_lines()):
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()

    def write_trace(self, path: str | None = None) -> str | None:
        path = path if path is not None else self.trace_path
        if path is None:
            return None
        with open(path, "w") as f:
            for line in self.trace_lines():
                f.write(line + "\n")
        return path


# -- process-global registry ------------------------------------------------

_active: FaultInjector | None = None
_install_lock = ProfiledLock("fault_install")


def install(plan: FaultPlan, trace_path: str | None = None) -> FaultInjector:
    """Arm a plan process-wide. Exactly one owner at a time: a second
    install without an uninstall raises — two overlapping plans would
    make both traces unreproducible."""
    global _active
    with _install_lock:
        if _active is not None:
            raise RuntimeError("a FaultPlan is already installed; "
                               "uninstall() it first")
        _active = FaultInjector(plan, trace_path=trace_path)
        return _active


def uninstall() -> FaultInjector | None:
    """Disarm; returns the (now inert) injector so callers can still
    read its trace. Idempotent."""
    global _active
    with _install_lock:
        inj, _active = _active, None
        return inj


def active() -> FaultInjector | None:
    return _active


def consult(point: str, key: str) -> Fault | None:
    """Module-level fast path for seams: None when nothing installed."""
    inj = _active
    return None if inj is None else inj.consult(point, key)
