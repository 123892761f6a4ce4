"""Real hardware-counter sources: the degradation ladder.

The port of ``pbs_tpu.hwtelem.sources``, tier for tier and slot for
slot. The counters are the host's: on the card host they measure the
CPU process that drives the card, never the card itself.

PBS's thesis is PMU telemetry driving quantum adaptation (PAPER.md §0),
and until this module every counter the feedback loop ate was simulated.
Here the repo grows the live plane: a ladder of real per-process counter
sources, each probing at construction and caching why it is unavailable
(the runtime/native.py loader pattern), mapped onto the **declared
event set** the paper's scheduler consumes — instructions, cycles,
cache-references, cache-misses (sched_credit.c:1965-1966) plus
task-clock for the time base. The mapping discipline follows the
perf counter-mapping literature (arXiv 2112.11767): every declared
event is either supplied by the active tier or *honestly absent* —
consumers see a flagged-stale counter slot, never a fabricated value,
so the stale-fallback machinery in ``sched/feedback.py`` (steps
advanced, device time didn't ⇒ stop steering) works unchanged.

The ladder, best first:

1. ``perf_event`` — ``perf_event_open(2)`` via ctypes syscall, one fd
   per declared event on the calling process. Hardware events need a
   PMU (absent in most VMs/containers: ENOENT) and are gated by
   ``/proc/sys/kernel/perf_event_paranoid`` (EACCES); software events
   (task-clock) usually survive both. Partial availability is normal
   and reported per event.
2. ``cgroup`` — cgroup-v2 ``cpu.stat`` (``usage_usec``) or v1
   ``cpuacct.usage``, plus ``/proc/self/schedstat``: cumulative CPU
   time only (task-clock), per-cgroup granularity.
3. ``rusage`` — ``resource.getrusage(RUSAGE_SELF)``: the last resort,
   available wherever CPython runs.

No torch, no numpy-optional paths: this module must import anywhere
``pbst-torch hw probe`` runs, including hosts with no accelerator
stack.
"""

from __future__ import annotations

import ctypes
import os
import platform
import struct

import numpy as np

from pbs_tpu_torch.telemetry.counters import NUM_COUNTERS, Counter
from pbs_tpu_torch.utils.clock import Clock, MonotonicClock

#: Sanctioned wall seam: hardware counters are cumulative reads off the
#: live kernel; sampling them is inherently a real-clock edge.
#: Everything downstream (CounterWindow, ReplaySource, fidelity
#: scoring) consumes recorded timestamps, never this seam.
REAL_CLOCK_SEAM = (
    "hardware-counter sampling reads the live kernel's cumulative "
    "counters and stamps samples with monotonic time; replay runs off "
    "the recorded window, not this seam")

#: The declared event set (the paper's four PMC events + the time
#: base). Order is the canonical window column order.
DECLARED_EVENTS = ("instructions", "cycles", "cache-references",
                   "cache-misses", "task-clock")

# perf_event_open(2) constants (linux/perf_event.h).
_PERF_TYPE_HARDWARE = 0
_PERF_TYPE_SOFTWARE = 1
_PERF_FLAG_FD_CLOEXEC = 1 << 3
#: event -> (perf type, perf config). task-clock is the software clock
#: (nanoseconds of on-CPU time for the measured task).
PERF_EVENT_MAP = {
    "cycles": (_PERF_TYPE_HARDWARE, 0),
    "instructions": (_PERF_TYPE_HARDWARE, 1),
    "cache-references": (_PERF_TYPE_HARDWARE, 2),
    "cache-misses": (_PERF_TYPE_HARDWARE, 3),
    "task-clock": (_PERF_TYPE_SOFTWARE, 1),
}
#: __NR_perf_event_open per machine (syscall(2) tables).
_SYSCALL_NR = {"x86_64": 298, "aarch64": 241, "arm64": 241,
               "riscv64": 241, "ppc64le": 319, "s390x": 331}

#: Modeled HBM/LLC line size for the cache-references -> bytes-moved
#: translation (the LLC_REFERENCES -> HBM_BYTES analog of
#: telemetry/counters.py).
CACHE_LINE_BYTES = 64

#: Tier names in ladder order (best first).
TIER_NAMES = ("perf_event", "cgroup", "rusage")

#: Kill switch for the golden byte-identity check and hermetic tests:
#: a comma-separated tier list in PBST_HWTELEM_DISABLE (or "all")
#: forces those tiers to probe unavailable.
DISABLE_ENV = "PBST_HWTELEM_DISABLE"


def _disabled_tiers() -> frozenset[str]:
    raw = os.environ.get(DISABLE_ENV, "")
    names = frozenset(t.strip() for t in raw.split(",") if t.strip())
    return frozenset(TIER_NAMES) if "all" in names else names


class CounterTier:
    """One rung of the ladder. Probes at construction; the result —
    which declared events it supplies, and why the rest (or the whole
    tier) are unavailable — is cached for the lifetime of the object,
    so ``pbst-torch hw probe`` can say WHY a tier is off without
    re-paying the probe."""

    name = "abstract"

    def __init__(self):
        self._reason: str | None = "not probed"
        self._events: tuple[str, ...] = ()
        self._event_reasons: dict[str, str] = {}

    def unavailable_reason(self) -> str | None:
        """None when the tier supplies at least one declared event;
        otherwise the cached probe failure (errno text, missing file,
        paranoid level...)."""
        return self._reason

    def events(self) -> tuple[str, ...]:
        """Declared events this tier supplies, in DECLARED_EVENTS
        order. Empty iff the tier is unavailable."""
        return self._events

    def event_reasons(self) -> dict[str, str]:
        """Per-event unavailability for the declared events this tier
        does NOT supply (the honest half of the mapping contract)."""
        return dict(self._event_reasons)

    def read(self) -> dict[str, int]:
        """Cumulative values for :meth:`events` (task-clock in ns).
        Callers delta successive reads; raising on an available tier
        is a bug."""
        raise NotImplementedError

    def close(self) -> None:  # fds, if any
        pass

    def describe(self) -> dict:
        """Stable probe record (``pbst-torch hw probe --json`` row)."""
        return {
            "tier": self.name,
            "available": self.unavailable_reason() is None,
            "reason": self.unavailable_reason(),
            "events": list(self._events),
            "degraded": dict(sorted(self._event_reasons.items())),
        }


class PerfEventTier(CounterTier):
    """Tier 1: ``perf_event_open(2)`` for the calling process.

    One fd per declared event (pid=0, cpu=-1, no grouping — a group
    leader dying takes the whole group; independent fds degrade per
    event instead). Counters start enabled; reads are 8-byte u64s.
    """

    name = "perf_event"

    # perf_event_attr: type u32, size u32, config u64, then the
    # sample/read/flags words we leave zero (counting mode, enabled).
    _ATTR_SIZE = 128

    def __init__(self, events: tuple[str, ...] = DECLARED_EVENTS):
        super().__init__()
        self._fds: dict[str, int] = {}
        if self.name in _disabled_tiers():
            self._reason = f"disabled via {DISABLE_ENV}"
            return
        nr = _SYSCALL_NR.get(platform.machine())
        if os.name != "posix" or nr is None:
            self._reason = (f"no perf_event_open syscall number for "
                            f"{os.name}/{platform.machine()}")
            return
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            syscall_fn = libc.syscall
        except (OSError, AttributeError) as e:
            self._reason = f"libc unavailable ({e})"
            return
        for ev in events:
            typ, cfg = PERF_EVENT_MAP[ev]
            attr = struct.pack("IIQQQQQ", typ, self._ATTR_SIZE, cfg,
                               0, 0, 0, 0)
            buf = ctypes.create_string_buffer(attr, self._ATTR_SIZE)
            fd = syscall_fn(nr, buf, 0, -1, -1, _PERF_FLAG_FD_CLOEXEC)
            if fd < 0:
                err = ctypes.get_errno()
                self._event_reasons[ev] = self._errno_reason(err)
            else:
                self._fds[ev] = fd
        if not self._fds:
            first = next(iter(self._event_reasons.values()),
                         "no events opened")
            self._reason = f"no declared event opened ({first})"
            return
        self._reason = None
        self._events = tuple(e for e in events if e in self._fds)

    @staticmethod
    def _errno_reason(err: int) -> str:
        base = os.strerror(err) if err else "unknown error"
        if err in (1, 13):  # EPERM / EACCES: the paranoid gate
            para = "?"
            try:
                with open("/proc/sys/kernel/perf_event_paranoid") as f:
                    para = f.read().strip()
            except OSError:
                pass
            return (f"{base} (perf_event_paranoid={para}; needs <= 2 "
                    "for per-process counters, or CAP_PERFMON)")
        if err == 2:  # ENOENT: the PMU itself is absent (VM guests)
            return f"{base} (no PMU exposed — typical in VMs/containers)"
        return base

    def read(self) -> dict[str, int]:
        out = {}
        for ev in self._events:
            data = os.read(self._fds[ev], 8)
            out[ev] = int(struct.unpack("q", data)[0])
        return out

    def close(self) -> None:
        for fd in self._fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()


#: cgroup CPU-time files, preference order: v2 cpu.stat (usage_usec),
#: a hybrid host's unified mount, then v1 cpuacct (cumulative ns).
CGROUP_PATHS = ("/sys/fs/cgroup/cpu.stat",
                "/sys/fs/cgroup/unified/cpu.stat",
                "/sys/fs/cgroup/cpuacct/cpuacct.usage")
SCHEDSTAT_PATH = "/proc/self/schedstat"


class CgroupTier(CounterTier):
    """Tier 2: cgroup CPU accounting + ``/proc/self/schedstat``.

    Supplies task-clock only — cumulative CPU nanoseconds, preferring
    the per-process schedstat over the per-cgroup (container-wide)
    cpu.stat when the kernel exports it with a live CONFIG_SCHEDSTATS.
    The four PMC events are honestly absent (no PMU access at this
    rung); their slots stay flagged-stale downstream.
    """

    name = "cgroup"

    def __init__(self):
        super().__init__()
        self._cg_path: str | None = None
        self._sched_ok = False
        if self.name in _disabled_tiers():
            self._reason = f"disabled via {DISABLE_ENV}"
            return
        errs = []
        # schedstat first: per-process beats per-container. Field 0 is
        # on-CPU ns; a kernel built without CONFIG_SCHEDSTATS pins it
        # at 0, which would read as a permanently-stale clock — treat
        # that as unavailable, not as a zero measurement.
        try:
            if int(self._read_schedstat_raw()) > 0:
                self._sched_ok = True
            else:
                errs.append(f"{SCHEDSTAT_PATH}: on-CPU time is 0 "
                            "(CONFIG_SCHEDSTATS off?)")
        except (OSError, ValueError, IndexError) as e:
            errs.append(f"{SCHEDSTAT_PATH}: {e}")
        for path in CGROUP_PATHS:
            try:
                self._read_cgroup_ns(path)
                self._cg_path = path
                break
            except (OSError, ValueError) as e:
                errs.append(f"{path}: {e}")
        if not self._sched_ok and self._cg_path is None:
            self._reason = ("no readable CPU accounting ("
                            + "; ".join(errs[:3]) + ")")
            return
        self._reason = None
        self._events = ("task-clock",)
        for ev in DECLARED_EVENTS:
            if ev != "task-clock":
                self._event_reasons[ev] = \
                    "cgroup/schedstat export CPU time only"

    @staticmethod
    def _read_schedstat_raw() -> int:
        with open(SCHEDSTAT_PATH) as f:
            return int(f.read().split()[0])

    @staticmethod
    def _read_cgroup_ns(path: str) -> int:
        with open(path) as f:
            text = f.read()
        if path.endswith("cpuacct.usage"):
            return int(text.strip())
        for ln in text.splitlines():
            k, _, v = ln.partition(" ")
            if k == "usage_usec":
                return int(v) * 1_000
        raise ValueError("no usage_usec line")

    def read(self) -> dict[str, int]:
        if self._sched_ok:
            try:
                return {"task-clock": self._read_schedstat_raw()}
            except (OSError, ValueError, IndexError):
                pass  # fall through to the cgroup file
        if self._cg_path is not None:
            return {"task-clock": self._read_cgroup_ns(self._cg_path)}
        return {"task-clock": 0}


class RusageTier(CounterTier):
    """Tier 3: ``resource.getrusage(RUSAGE_SELF)`` — microsecond
    user+system CPU time, available wherever CPython runs. Last
    resort; same honest single-event mapping as the cgroup tier."""

    name = "rusage"

    def __init__(self):
        super().__init__()
        self._resource = None
        if self.name in _disabled_tiers():
            self._reason = f"disabled via {DISABLE_ENV}"
            return
        try:
            import resource
        except ImportError as e:  # non-POSIX python
            self._reason = f"resource module unavailable ({e})"
            return
        self._resource = resource
        self._reason = None
        self._events = ("task-clock",)
        for ev in DECLARED_EVENTS:
            if ev != "task-clock":
                self._event_reasons[ev] = \
                    "getrusage exports CPU time only"

    def read(self) -> dict[str, int]:
        ru = self._resource.getrusage(self._resource.RUSAGE_SELF)
        return {"task-clock": int((ru.ru_utime + ru.ru_stime) * 1e9)}


def ladder() -> list[CounterTier]:
    """Construct (and probe) every tier, best first. Each call probes
    fresh — availability can change (e.g. a sysctl flip) and the probe
    is cheap; callers hold the instances to keep the cached reasons."""
    return [PerfEventTier(), CgroupTier(), RusageTier()]


def pick_tier(tiers: list[CounterTier] | None = None
              ) -> CounterTier | None:
    """First available rung of the ladder, or None when every tier is
    unavailable (all-forced-off CI, exotic hosts). Consumers MUST
    branch on None — the ladder is optional by contract, exactly like
    the reference's native runtime."""
    for tier in (ladder() if tiers is None else tiers):
        if tier.unavailable_reason() is None:
            return tier
    return None


def probe_report(tiers: list[CounterTier] | None = None) -> dict:
    """The full ladder, described: active tier + per-tier reasons —
    the ``pbst-torch hw probe`` surface."""
    tiers = ladder() if tiers is None else tiers
    active = pick_tier(tiers)
    return {
        "version": 1,
        "active": active.name if active is not None else None,
        "declared_events": list(DECLARED_EVENTS),
        "tiers": [t.describe() for t in tiers],
    }


# -- declared-event -> counter-slot translation -----------------------------

# The convention of telemetry/counters.py and sched/feedback.py:
# instructions -> useful forward progress, cycles/task-clock -> device
# time, LLC traffic -> HBM traffic, LLC miss share of time -> HBM
# stall. Integer arithmetic only: these deltas feed digest-pinned
# replay paths.
_I_STEPS = int(Counter.STEPS_RETIRED)
_I_DEV = int(Counter.DEVICE_TIME_NS)
_I_HBM = int(Counter.HBM_BYTES)
_I_STALL = int(Counter.HBM_STALL_NS)
_I_FLOPS = int(Counter.DEVICE_FLOPS)

#: Counter slots the hw overlay may write (everything else belongs to
#: the inner source / the executor).
HW_SLOTS = (Counter.DEVICE_TIME_NS, Counter.HBM_BYTES,
            Counter.HBM_STALL_NS, Counter.DEVICE_FLOPS)


def event_deltas_to_counters(deltas: dict[str, int],
                             n_steps: int = 0) -> np.ndarray:
    """Translate one sample of declared-event deltas into the u64
    counter-slot layout. Events absent from ``deltas`` leave their
    slots at 0 — with progress (STEPS_RETIRED) nonzero that is exactly
    the flagged-stale shape ``FeedbackPolicy`` detects, so a degraded
    tier degrades the POLICY gracefully instead of feeding it zeros it
    would mistake for measurements."""
    out = np.zeros(NUM_COUNTERS, dtype=np.uint64)
    if n_steps > 0:
        out[_I_STEPS] = n_steps
    clock_ns = int(deltas.get("task-clock", 0))
    if clock_ns > 0:
        out[_I_DEV] = clock_ns
    refs = int(deltas.get("cache-references", 0))
    misses = int(deltas.get("cache-misses", 0))
    if refs > 0:
        out[_I_HBM] = refs * CACHE_LINE_BYTES
        if misses > 0 and clock_ns > 0:
            # Miss share of the sample's CPU time: the LLC_MISSES ->
            # HBM-stall translation the roofline threshold consumes
            # (stall per mille = STALL_NS * 1000 / DEVICE_TIME_NS).
            out[_I_STALL] = clock_ns * min(misses, refs) // refs
    instr = int(deltas.get("instructions", 0))
    if instr > 0:
        out[_I_FLOPS] = instr
    return out


class HwCounterSource:
    """A :class:`~pbs_tpu_torch.telemetry.source.TelemetrySource` whose
    measured channels come from the live ladder.

    Wraps an optional ``inner`` source (the executor's real work —
    SimBackend on the host, ``CudaBackend`` on the card): ``execute``
    runs the inner quantum, samples the active tier around it, and
    OVERLAYS the hw-measured slots the tier supplies, exactly as the
    reference does over its TPU backend. Over ``CudaBackend`` that
    means a task-clock tier REPLACES the card's measured
    DEVICE_TIME_NS with the host process's CPU time for the quantum
    (and a cache-event tier replaces HBM_BYTES/HBM_STALL_NS with host
    cache traffic): host time spent waiting on the card is not device
    time, so callers that need the card's own numbers read the inner
    source's deltas before the overlay. With no tier available the
    inner deltas pass through untouched — arming hwtelem on a host
    with the ladder forced off is byte-invisible (the golden-digest
    acceptance gate), and with no inner source the progress counters
    come from the quantum shape itself (n_steps).
    """

    def __init__(self, inner=None, tier: CounterTier | None = None,
                 probe: bool = True, clock: Clock | None = None):
        self.inner = inner
        self.tier = tier if tier is not None else (
            pick_tier() if probe else None)
        if clock is not None:
            self.clock = clock
        elif inner is not None:
            self.clock = inner.clock
        else:
            self.clock = MonotonicClock()
        self._last: dict[str, int] = {}
        if self.tier is not None:
            self._last = self.tier.read()

    # -- sampling (also the HwRecorder feed) -----------------------------

    def sample(self) -> dict[str, int]:
        """Delta of every supplied event since the previous sample
        (cumulative-read semantics: first call after construction
        deltas against the construction-time read). Empty dict when no
        tier is available."""
        if self.tier is None:
            return {}
        now = self.tier.read()
        out = {ev: max(0, now[ev] - self._last.get(ev, 0))
               for ev in now}
        self._last = now
        return out

    def describe(self) -> dict:
        """Tier identity + degradation for the monitoring surfaces."""
        if self.tier is None:
            return {"tier": None, "events": [],
                    "reason": "no counter tier available"}
        d = self.tier.describe()
        return {"tier": d["tier"], "events": d["events"],
                "reason": None, "degraded": d["degraded"]}

    # -- TelemetrySource protocol ----------------------------------------

    def _overlay(self, base: np.ndarray, n_steps: int) -> np.ndarray:
        if self.tier is None:
            return base  # untouched: the byte-invisibility contract
        hw = event_deltas_to_counters(self.sample(), n_steps=0)
        supplied = set(self.tier.events())
        if "task-clock" in supplied:
            base[_I_DEV] = hw[_I_DEV]
        if "cache-references" in supplied:
            base[_I_HBM] = hw[_I_HBM]
            base[_I_STALL] = hw[_I_STALL]
        if "instructions" in supplied:
            base[_I_FLOPS] = hw[_I_FLOPS]
        return base

    def execute(self, ctx, n_steps: int) -> np.ndarray:
        if self.inner is not None:
            base = self.inner.execute(ctx, n_steps)
            if self.tier is not None and base.flags.writeable is False:
                base = base.copy()
        else:
            base = np.zeros(NUM_COUNTERS, dtype=np.uint64)
            base[_I_STEPS] = n_steps
        return self._overlay(base, n_steps)

    def execute_micro(self, ctx, n_micro: int) -> np.ndarray:
        if self.inner is not None:
            base = self.inner.execute_micro(ctx, n_micro)
            if self.tier is not None and base.flags.writeable is False:
                base = base.copy()
            return self._overlay(base, 0)
        base = np.zeros(NUM_COUNTERS, dtype=np.uint64)
        K = max(1, int(getattr(ctx.job, "micro_per_step", 1)))
        for _ in range(n_micro):
            ctx.micro_progress += 1
            if ctx.micro_progress >= K:
                ctx.micro_progress = 0
                base[_I_STEPS] += 1
        if ctx.micro_progress:
            base[int(Counter.YIELDS)] += 1
        return self._overlay(base, 0)

    def close(self) -> None:
        if self.tier is not None:
            self.tier.close()
