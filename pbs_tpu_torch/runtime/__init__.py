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
from pbs_tpu_torch.runtime.image import boot_job, image_workload, save_image
from pbs_tpu_torch.runtime.job import ContextState, ExecutionContext, Job, SchedParams
from pbs_tpu_torch.runtime.memory import (
    MemoryAccount,
    MemoryManager,
    OutOfDeviceMemory,
    device_memory_stats,
    nbytes_of,
)
from pbs_tpu_torch.runtime.paging import (
    PagingError,
    page_in_job,
    page_out_job,
    register_paging_reclaim,
)
from pbs_tpu_torch.runtime.partition import Partition
from pbs_tpu_torch.runtime.sharing import SharedWeights, WeightsRegistry
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
