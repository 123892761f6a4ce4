"""pbs_tpu_torch.sim — trace-driven discrete-event scheduler simulator.

The port of ``pbs_tpu.sim``, record for record. It runs the port's
*real* ``pbs_tpu_torch.sched`` policies against synthetic or recorded
workloads on a virtual clock: ``engine`` (event core + policy probes),
``workload`` (tenant generator catalog), ``trace`` (JSONL record/replay,
including runs recorded live on the card), ``harness`` (policy
regression comparisons), ``sweep`` (shared-nothing parallel grid
fan-out — the ``pbst-torch tune`` substrate). Reports, trace bytes and
digests equal the reference's.

Sweep-mode runs of the hot policies ride the native dispatch core
(``sim/native_core.py`` over the port's C runtime) when it builds; the
pure-Python engine is the witness, bit-identical on every tier.
"""

from pbs_tpu_torch.sim.engine import (
    POLICIES,
    ListSchedulerProbe,
    SchedulerProbe,
    SimEngine,
    jain_index,
    policy_names,
)
from pbs_tpu_torch.sim.harness import (
    DEFAULT_POLICIES,
    compare,
    format_report,
    run_policy,
)
from pbs_tpu_torch.sim.sweep import (
    SweepCell,
    build_grid,
    cell_seed,
    run_cell,
    sweep,
    sweep_digest,
)
from pbs_tpu_torch.sim.trace import (
    ReplayBackend,
    ReplayError,
    TraceRecorder,
    digest_of,
    load_trace,
    recorded_steps,
    replay_partition,
    trace_meta,
)
from pbs_tpu_torch.sim.workload import (
    TENANT_KINDS,
    WORKLOADS,
    TenantSpec,
    build_workload,
    make_mix,
    register_workload,
    unregister_workload,
    workload_names,
)

__all__ = [
    "POLICIES",
    "ListSchedulerProbe",
    "SchedulerProbe",
    "SweepCell",
    "build_grid",
    "cell_seed",
    "run_cell",
    "sweep",
    "sweep_digest",
    "SimEngine",
    "jain_index",
    "policy_names",
    "DEFAULT_POLICIES",
    "compare",
    "format_report",
    "run_policy",
    "ReplayBackend",
    "ReplayError",
    "TraceRecorder",
    "digest_of",
    "load_trace",
    "recorded_steps",
    "replay_partition",
    "trace_meta",
    "TENANT_KINDS",
    "WORKLOADS",
    "TenantSpec",
    "build_workload",
    "make_mix",
    "register_workload",
    "unregister_workload",
    "workload_names",
]
