from pbs_tpu_torch.runtime.compile_gate import (
    CompileAdmission,
    CompileBudget,
    CompileBudgetExceeded,
)
from pbs_tpu_torch.runtime.events import EventBus, EventChannel, Virq
from pbs_tpu_torch.runtime.executor import Executor, quantum_to_steps
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

__all__ = [
    "CompileAdmission",
    "CompileBudget",
    "CompileBudgetExceeded",
    "ContextState",
    "EventBus",
    "EventChannel",
    "ExecutionContext",
    "Executor",
    "Job",
    "MemoryAccount",
    "MemoryManager",
    "OutOfDeviceMemory",
    "PagingError",
    "Partition",
    "SchedParams",
    "SharedWeights",
    "Timer",
    "TimerWheel",
    "Virq",
    "WeightsRegistry",
    "boot_job",
    "device_memory_stats",
    "image_workload",
    "nbytes_of",
    "page_in_job",
    "page_out_job",
    "quantum_to_steps",
    "register_paging_reclaim",
    "save_image",
]
