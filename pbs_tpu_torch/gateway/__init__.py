"""Multi-tenant serving front door: the port of ``pbs_tpu.gateway``.

SLO-aware admission (token buckets + explicit shed with retry-after),
weighted deficit-round-robin fair queueing across tenants with
interactive/batch SLO classes, least-loaded routing with drain/requeue
on backend loss, and queue-delay feedback into the scheduler — the
paper's performance-feedback loop applied at the request-queue layer.
Beside it the durability and federation plane: the write-ahead intent
journal, crash recovery from journal bytes alone, the federated tier
(leased admission, consistent-hash placement, handoff), the member
supervisor, the process federation (members as real OS processes) and
the chaos harnesses.

Device-free by construction: backends arrive already built (the port's
``ContinuousBatcher`` via :class:`BatcherBackend`, or the simulated
:class:`SimServeBackend`); the gateway itself imports no torch, so
admission/fairness/routing test and run anywhere.
"""

from pbs_tpu_torch.gateway.admission import (
    BATCH,
    INTERACTIVE,
    SLO_CLASSES,
    AdmissionController,
    Shed,
    TenantQuota,
    TokenBucket,
)
from pbs_tpu_torch.gateway.backends import (
    Backend,
    BatcherBackend,
    SimServeBackend,
)
from pbs_tpu_torch.gateway.fairqueue import DeficitRoundRobin, Request
from pbs_tpu_torch.gateway.federation import (
    FederatedGateway,
    HashRing,
    Lease,
    LeaseBroker,
    LeasedBucket,
)
from pbs_tpu_torch.gateway.feedback import sched_feedback_sink
from pbs_tpu_torch.gateway.gateway import (
    GW_LEDGER_SLOTS,
    Gateway,
    SubmitResult,
)

#: Lazily imported surfaces, by module: the chaos harnesses pull in the
#: sim workload catalog, and serving callers without a journal pay for
#: none of the durability plane.
_LAZY = {
    "chaos": ("run_gateway_chaos", "run_federation_chaos", "quota_for",
              "stock_crash_plan"),
    "journal": ("GatewayJournal", "JournalCorrupt", "ProcessKill",
                "read_journal"),
    "procfed": ("ProcessFederation", "run_process_chaos",
                "stock_process_kill_plan"),
    "recovery": ("recover_gateway", "recover_federation"),
    "supervisor": ("MemberSupervisor", "ProcessHandle"),
}


def __getattr__(name: str):
    import importlib

    for module, names in _LAZY.items():
        if name in names:
            return getattr(
                importlib.import_module(f"pbs_tpu_torch.gateway.{module}"),
                name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "BATCH",
    "Backend",
    "BatcherBackend",
    "DeficitRoundRobin",
    "FederatedGateway",
    "GW_LEDGER_SLOTS",
    "Gateway",
    "GatewayJournal",
    "HashRing",
    "INTERACTIVE",
    "JournalCorrupt",
    "Lease",
    "LeaseBroker",
    "LeasedBucket",
    "MemberSupervisor",
    "ProcessFederation",
    "ProcessHandle",
    "ProcessKill",
    "Request",
    "SLO_CLASSES",
    "Shed",
    "SimServeBackend",
    "SubmitResult",
    "TenantQuota",
    "TokenBucket",
    "quota_for",
    "read_journal",
    "recover_federation",
    "recover_gateway",
    "run_federation_chaos",
    "run_gateway_chaos",
    "run_process_chaos",
    "sched_feedback_sink",
    "stock_crash_plan",
    "stock_process_kill_plan",
]
