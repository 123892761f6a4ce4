from pbs_tpu_torch.sched.base import (
    Decision,
    Scheduler,
    make_scheduler,
    register_scheduler,
    scheduler_names,
)
from pbs_tpu_torch.sched.arinc653 import Arinc653Scheduler
from pbs_tpu_torch.sched.atc import AtcFeedbackPolicy
from pbs_tpu_torch.sched.credit import CreditScheduler
from pbs_tpu_torch.sched.credit2 import Credit2Scheduler
from pbs_tpu_torch.sched.feedback import FeedbackPolicy
from pbs_tpu_torch.sched.sedf import SedfScheduler

__all__ = [
    "Arinc653Scheduler",
    "AtcFeedbackPolicy",
    "CreditScheduler",
    "Credit2Scheduler",
    "Decision",
    "FeedbackPolicy",
    "Scheduler",
    "SedfScheduler",
    "make_scheduler",
    "register_scheduler",
    "scheduler_names",
]
