"""Deterministic, seeded fault injection (the port's copy).

``FaultPlan`` (plan.py) declares *what* goes wrong where and how often;
``FaultInjector`` (injector.py) is the process-global registry every
instrumented seam consults; ``chaos.py`` drives controller + agents
over the sim workload catalog under a plan and checks end-state
invariants (the ``pbst-torch chaos`` engine).
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


def __getattr__(name: str):
    # chaos.py pulls in sim/ and dist/, which import the very modules
    # that host injection seams (telemetry, runtime) — an eager import
    # here is a cycle. The seams import ``faults.injector`` directly;
    # the chaos engine loads only when someone asks for it.
    if name in ("run_chaos", "tenant_spec_dict"):
        from pbs_tpu_torch.faults import chaos

        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    "run_chaos",
    "tenant_spec_dict",
    "uninstall",
]
