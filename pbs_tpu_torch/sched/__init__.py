from pbs_tpu_torch.sched.base import (
    Decision,
    Scheduler,
    make_scheduler,
    register_scheduler,
    scheduler_names,
)
from pbs_tpu_torch.sched.credit import CreditScheduler
from pbs_tpu_torch.sched.feedback import FeedbackPolicy

__all__ = [
    "CreditScheduler",
    "Decision",
    "FeedbackPolicy",
    "Scheduler",
    "make_scheduler",
    "register_scheduler",
    "scheduler_names",
]
