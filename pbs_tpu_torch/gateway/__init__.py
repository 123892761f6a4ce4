"""Multi-tenant serving front door: the port of ``pbs_tpu.gateway``.

SLO-aware admission (token buckets + explicit shed with retry-after),
weighted deficit-round-robin fair queueing across tenants with
interactive/batch SLO classes, least-loaded routing with drain/requeue
on backend loss, and queue-delay feedback into the scheduler — the
paper's performance-feedback loop applied at the request-queue layer.

Device-free by construction: backends arrive already built (the port's
``ContinuousBatcher`` via :class:`BatcherBackend`, or the simulated
:class:`SimServeBackend`); the gateway itself imports no torch, so
admission/fairness/routing test and run anywhere.

The chaos harnesses' admission contract per catalog tenant,
``quota_for``, resolves lazily from ``gateway.chaos`` (as the
reference's does), with the arrival model the hardware-counter plane's
serving pump drives. Not ported yet (ROADMAP queue 1 item 12): the
federation, the gateway chaos harnesses themselves, the write-ahead
journal beyond the rid namespace, crash recovery, process federation
and its supervisor. Looking up one of their names here raises
``AttributeError`` naming that item.
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
from pbs_tpu_torch.gateway.feedback import sched_feedback_sink
from pbs_tpu_torch.gateway.gateway import (
    GW_LEDGER_SLOTS,
    Gateway,
    SubmitResult,
)

#: The reference's names this package does not have yet.
NOT_PORTED = frozenset({
    "FederatedGateway", "HashRing", "Lease", "LeaseBroker", "LeasedBucket",
    "run_gateway_chaos", "run_federation_chaos",
    "stock_crash_plan", "GatewayJournal", "JournalCorrupt", "ProcessKill",
    "read_journal", "recover_gateway", "recover_federation",
    "ProcessFederation", "run_process_chaos", "stock_process_kill_plan",
    "MemberSupervisor", "ProcessHandle",
})


def __getattr__(name: str):
    if name == "quota_for":
        # The chaos module pulls in the sim workload catalog; keep that
        # off the gateway's import path.
        from pbs_tpu_torch.gateway import chaos

        return chaos.quota_for
    if name in NOT_PORTED:
        raise AttributeError(
            f"pbs_tpu_torch.gateway.{name} is not ported: the federation, "
            "gateway chaos, journal, recovery and process federation are "
            "ROADMAP queue 1 item 12")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "BATCH",
    "Backend",
    "BatcherBackend",
    "DeficitRoundRobin",
    "GW_LEDGER_SLOTS",
    "Gateway",
    "INTERACTIVE",
    "Request",
    "SLO_CLASSES",
    "Shed",
    "SimServeBackend",
    "SubmitResult",
    "TenantQuota",
    "TokenBucket",
    "quota_for",
    "sched_feedback_sink",
]
