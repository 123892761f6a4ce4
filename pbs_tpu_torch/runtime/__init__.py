from pbs_tpu_torch.runtime.compile_gate import (
    CompileAdmission,
    CompileBudget,
    CompileBudgetExceeded,
)
from pbs_tpu_torch.runtime.events import EventBus, EventChannel, Virq
from pbs_tpu_torch.runtime.executor import Executor, quantum_to_steps
from pbs_tpu_torch.runtime.job import ContextState, ExecutionContext, Job, SchedParams
from pbs_tpu_torch.runtime.memory import nbytes_of
from pbs_tpu_torch.runtime.partition import Partition
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
    "Partition",
    "SchedParams",
    "Timer",
    "TimerWheel",
    "Virq",
    "nbytes_of",
    "quantum_to_steps",
]
