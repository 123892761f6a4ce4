"""Distributed control plane: controller <-> per-host agents.

The data plane (tensors) never rides this package; it is only the
*control* plane — the toolstack surface (xend/xl, ``tools/python``,
``tools/libxl``) re-expressed as a framed-JSON RPC between one
controller and one agent per host, with multicall batching
(``xen/common/multicall.c``), heartbeat failure detection
(``tools/misc/xenwatchdogd.c``), and restore-elsewhere recovery
(``tools/remus``).

The port of ``pbs_tpu.dist``: the same names. They load on first use,
so a process that needs only the RPC (the process federation's member
processes) imports no agent, partition or torch.
"""

import importlib

#: Exported names, by module.
_EXPORTS = {
    "agent": ("Agent", "sim_workload"),
    "controller": ("ClusterRoundError", "Controller", "JobRecord",
                   "MemberRef"),
    "remus": ("RemusSession",),
    "rpc": ("RpcClient", "RpcError", "RpcServer"),
}


def __getattr__(name: str):
    for module, names in _EXPORTS.items():
        if name in names:
            return getattr(
                importlib.import_module(f"pbs_tpu_torch.dist.{module}"),
                name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Agent",
    "ClusterRoundError",
    "Controller",
    "JobRecord",
    "MemberRef",
    "RemusSession",
    "RpcClient",
    "RpcError",
    "RpcServer",
    "sim_workload",
]
