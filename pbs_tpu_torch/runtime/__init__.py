"""The port's runtime: jobs, partitions, executors, the event channel,
admission (compile cache, device memory, paging, shared weights),
images, grants, hooks, watchdogs and the security labels.

The modules that touch torch (images, device memory, paging, shared
weights, and the partition, which reads tensor sizes) load on first
use of one of their names, so the device-free planes that only need
jobs, events or labels (the gateway, the process federation's member
processes) import no torch.
"""

import importlib

from pbs_tpu_torch.runtime.compile_gate import (
    CompileAdmission,
    CompileBudget,
    CompileBudgetExceeded,
)
from pbs_tpu_torch.runtime.doorbell import Doorbell, bridge_events
from pbs_tpu_torch.runtime.events import EventBus, EventChannel, Virq
from pbs_tpu_torch.runtime.executor import Executor, quantum_to_steps
from pbs_tpu_torch.runtime.grants import (
    GrantBusy,
    GrantDenied,
    GrantError,
    GrantMapping,
    GrantTable,
    SharedRegion,
    map_grant,
)
from pbs_tpu_torch.runtime.hooks import HookError, HookRegistry
from pbs_tpu_torch.runtime.job import ContextState, ExecutionContext, Job, SchedParams
from pbs_tpu_torch.runtime.timer import Timer, TimerWheel
from pbs_tpu_torch.runtime.watchdog import (
    WallWatchdog,
    Watchdog,
    install_crash_handler,
    write_crash_dump,
)
from pbs_tpu_torch.runtime.xsm import (
    DummyPolicy,
    LabelPolicy,
    XsmDenied,
    set_policy,
    xsm_check,
)

#: Names served from modules that import torch, by module; each loads
#: on first use.
_LAZY = {
    "image": ("boot_job", "image_workload", "save_image"),
    "memory": ("MemoryAccount", "MemoryManager", "OutOfDeviceMemory",
               "device_memory_stats", "nbytes_of"),
    "paging": ("PagingError", "page_in_job", "page_out_job",
               "register_paging_reclaim"),
    "partition": ("Partition",),
    "sharing": ("SharedWeights", "WeightsRegistry"),
}


def __getattr__(name: str):
    for module, names in _LAZY.items():
        if name in names:
            return getattr(
                importlib.import_module(f"pbs_tpu_torch.runtime.{module}"),
                name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CompileAdmission",
    "CompileBudget",
    "CompileBudgetExceeded",
    "ContextState",
    "DummyPolicy",
    "Doorbell",
    "EventBus",
    "EventChannel",
    "ExecutionContext",
    "Executor",
    "GrantBusy",
    "GrantDenied",
    "GrantError",
    "GrantMapping",
    "GrantTable",
    "HookError",
    "HookRegistry",
    "Job",
    "LabelPolicy",
    "MemoryAccount",
    "MemoryManager",
    "OutOfDeviceMemory",
    "PagingError",
    "Partition",
    "SchedParams",
    "SharedRegion",
    "SharedWeights",
    "Timer",
    "TimerWheel",
    "Virq",
    "WallWatchdog",
    "Watchdog",
    "WeightsRegistry",
    "XsmDenied",
    "boot_job",
    "bridge_events",
    "device_memory_stats",
    "image_workload",
    "install_crash_handler",
    "map_grant",
    "nbytes_of",
    "page_in_job",
    "page_out_job",
    "quantum_to_steps",
    "register_paging_reclaim",
    "save_image",
    "set_policy",
    "write_crash_dump",
    "xsm_check",
]
