"""Per-job hardware-telemetry counter taxonomy.

Analog of the reference's per-vCPU PMC array: ``struct vcpu`` gains
``u64 tsc; u64 pmc[18]`` (``xen-4.2.1/xen/include/xen/sched.h:178-180``),
of which the adaptive scheduler consumes four events — INST_RETIRED,
CPU_CLK_UNHALTED, LLC_REFERENCES, LLC_MISSES
(``xen-4.2.1/xen/common/sched_credit.c:1965-1966``).

The port of ``pbs_tpu.telemetry.counters``, slot for slot. An
accelerator has no architectural per-tenant PMC file; the equivalents
are derived from step timing, static cost estimates (FLOPs / HBM bytes
per step), instrumented kernels' own counts, and in-graph
instrumentation (collective-wait skew —
the analog of the guest's spinlock-contention channel,
``linux-3.2.30/arch/x86/include/asm/spinlock.h:55-80``). We keep the
reference's fixed-width 18-slot layout so the ledger page format stays a
flat, seqlock-snapshottable array.
"""

from __future__ import annotations

import enum

# Number of counter slots per execution context. Mirrors pmc[18]
# (xen/include/xen/sched.h:179).
NUM_COUNTERS = 18


class Counter(enum.IntEnum):
    """Slot indices into a job's counter array.

    The first four map 1:1 onto the reference's tracked PMC events
    (sched_credit.c:1965-1966); the rest are TPU-native additions.
    """

    # "Instructions retired" -> model steps retired. The unit of useful
    # forward progress, used as the denominator of every rate metric.
    STEPS_RETIRED = 0
    # "CPU_CLK_UNHALTED" -> device-occupied nanoseconds.
    DEVICE_TIME_NS = 1
    # "LLC_REFERENCES" -> HBM bytes moved (reads+writes), from XLA cost
    # analysis per executed program.
    HBM_BYTES = 2
    # "LLC_MISSES" -> nanoseconds the program was stalled on HBM (est.:
    # bytes/bandwidth vs roofline) — the miss-rate analog that drives
    # phase detection (sched_credit.c:360-369).
    HBM_STALL_NS = 3
    # Spin-latency analog: time spent waiting at cross-device collectives
    # (barrier skew). Fed by the in-graph contention probe — the vcrd_op
    # channel (sched_credit.c:249-259) — but batched per step, not
    # per-event (SURVEY.md §3.5 note).
    COLLECTIVE_WAIT_NS = 4
    # Gang skew: max-min arrival spread observed at the last barrier.
    GANG_SKEW_NS = 5
    # XLA compilation activity (admission control input; no ref analog).
    COMPILES = 6
    COMPILE_TIME_NS = 7
    # Model FLOPs executed (from cost analysis).
    DEVICE_FLOPS = 8
    # Host<->device transfer volumes.
    H2D_BYTES = 9
    D2H_BYTES = 10
    # Checkpoint activity.
    CKPT_BYTES = 11
    CKPT_TIME_NS = 12
    # Preemption cooperation: times the job yielded early at a
    # micro-step boundary (the TPU analog of a voluntary context switch).
    YIELDS = 13
    # Scheduler-visible wait time (runnable but not running).
    RUNQ_WAIT_NS = 14
    # Number of schedule-ins; mirrors vcpu->sched_count
    # (xen/include/xen/sched.h:180, ++ at arch/x86/domain.c:1620).
    SCHED_COUNT = 15
    # Tokens processed (throughput numerator for LLM workloads).
    TOKENS = 16
    # Draft tokens proposed by speculative decoding; TOKENS /
    # SPEC_PROPOSED is the monitor-visible speculation efficiency
    # (emitted tokens per draft proposal — higher is better).
    SPEC_PROPOSED = 17


#: Events dumped by the 'z' console key analog (sched_credit.c:1944-1977).
DUMP_EVENTS = (
    Counter.STEPS_RETIRED,
    Counter.DEVICE_TIME_NS,
    Counter.HBM_BYTES,
    Counter.HBM_STALL_NS,
)

COUNTER_NAMES = {c: c.name for c in Counter}


def counters_dict(arr) -> dict[str, int]:
    """Render a counter array as {name: value} (telemetry RPC, crash
    dumps, CLI output all share this shape)."""
    return {Counter(i).name.lower(): int(v) for i, v in enumerate(arr)}
