"""Deterministic, seeded fault injection (the port's copy).

``FaultPlan`` (plan.py) declares *what* goes wrong where and how often;
``FaultInjector`` (injector.py) is the process-global registry every
instrumented seam consults. The JAX package's chaos engine
(``run_chaos``) drives its distributed control plane, which the port
does not have yet (ROADMAP).
"""

from pbs_tpu_torch.faults.injector import (
    Fault,
    FaultInjector,
    InjectedFault,
    active,
    consult,
    install,
    uninstall,
)
from pbs_tpu_torch.faults.plan import POINTS, FaultPlan, FaultSpec

__all__ = [
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "POINTS",
    "active",
    "consult",
    "install",
    "uninstall",
]
