"""Multi-host SPMD: process-group bring-up + intra/inter-host meshes.

The port of ``pbs_tpu.parallel.multihost``. The mesh layout decides
which exchanges cross hosts (scaling-book recipe: put the
bandwidth-hungry axes — tp/sp/ep — inside a host, on its NVLink; put
dp, and only dp if possible, across the network).

Two layers here:

- :func:`initialize` — idempotent ``torch.distributed`` bring-up from
  explicit args or the standard environment (the controller/agent
  control plane hands each process its coordinator and rank).
- :func:`hybrid_mesh` — a Mesh whose axis order encodes the split:
  inter-host axes outermost over host granules, intra-host axes
  innermost within a host. Launchers number ranks host-major (rank r
  lives on host r // LOCAL_WORLD_SIZE), so a row-major mesh over the
  ranks is that layout; where the reference asks the topology helper
  for it, the port checks that every intra-host granule lies on one
  host. :func:`_reorder_hybrid` is the reference's reindexing of an
  elementwise-product layout, kept for layouts that come that way.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Sequence

import numpy as np
import torch.distributed as dist

from pbs_tpu_torch.parallel.mesh import Mesh, rank_device

_initialized = False


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up the process group once per process. Returns True if a
    multi-process world is active after the call.

    Args default from the standard environment (``PBST_COORDINATOR``
    or ``MASTER_ADDR:MASTER_PORT``, ``PBST_NUM_PROCESSES`` or
    ``WORLD_SIZE``, ``PBST_PROCESS_ID`` or ``RANK``) so agents can be
    launched by any cluster manager. Single-process (no coordinator
    anywhere) is a no-op returning False — the same code path then runs
    single-host. The backend is nccl with a card, gloo without."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return dist.get_world_size() > 1
    if coordinator is None:
        coordinator = os.environ.get("PBST_COORDINATOR")
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get(
            "PBST_NUM_PROCESSES", os.environ.get("WORLD_SIZE", "1")))
    if process_id is None:
        process_id = int(os.environ.get(
            "PBST_PROCESS_ID", os.environ.get("RANK", "0")))
    import torch

    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=600))
    _initialized = True
    return dist.get_world_size() > 1


def _host_index(rank: int) -> int | None:
    """The host of ``rank``: rank // LOCAL_WORLD_SIZE, or None when the
    launcher did not say how many ranks share a host."""
    per_host = os.environ.get("LOCAL_WORLD_SIZE")
    return rank // int(per_host) if per_host else None


def _reorder_hybrid(arr: np.ndarray, dcn_p: tuple[int, ...],
                    ici_p: tuple[int, ...]) -> np.ndarray:
    """(d1*i1, …, dk*ik) with DCN major per axis → (d1, …, dk, i1, …, ik).

    Splitting each product axis into its (dcn, ici) pair and moving all
    dcn dims to the front is the correct reindexing for any rank; a
    plain reshape is only correct when at most one axis on each side is
    nontrivial."""
    rank = len(dcn_p)
    interleaved = arr.reshape(
        tuple(x for pair in zip(dcn_p, ici_p) for x in pair))
    perm = tuple(range(0, 2 * rank, 2)) + tuple(range(1, 2 * rank, 2))
    return interleaved.transpose(perm).reshape(dcn_p + ici_p)


def hybrid_mesh(ici_axes: dict[str, int], dcn_axes: dict[str, int],
                devices: Sequence | None = None,
                device: Any = None) -> Mesh:
    """Mesh with ``dcn_axes`` crossing host granules (outermost) and
    ``ici_axes`` inside a granule (innermost).

    E.g. 2 hosts × 8 cards: ``hybrid_mesh({"tp": 8}, {"dp": 2})`` —
    the gradient sum over ``dp`` is the only inter-host traffic; every
    ``tp`` exchange stays on NVLink. Axis name order in the Mesh is
    dcn_axes then ici_axes, so spec code is layout-agnostic. ``devices``
    stands for the world's ranks, as in ``make_mesh``; ``device`` is
    this rank's device (None means the card)."""
    world = dist.get_world_size()
    devices = list(devices if devices is not None else range(world))
    n = len(devices)
    ici_n = math.prod(ici_axes.values()) if ici_axes else 1
    dcn_n = math.prod(dcn_axes.values()) if dcn_axes else 1
    if ici_n * dcn_n != n:
        raise ValueError(
            f"mesh {dcn_axes}x{ici_axes} needs {ici_n * dcn_n} devices, "
            f"have {n}")
    if n != world:
        raise ValueError(
            f"a mesh spans the whole world: {n} devices given, the world "
            f"has {world} ranks")
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    # Row-major over host-major ranks: the inter-host dims outermost,
    # each granule of ici_n consecutive ranks innermost, on one host.
    for start in range(0, n, ici_n):
        hosts = {_host_index(r) for r in range(start, start + ici_n)}
        if len(hosts) > 1:
            raise ValueError(
                f"intra-host axes {ici_axes} span hosts {sorted(hosts)}: "
                f"ranks {start}-{start + ici_n - 1} are not on one host "
                f"(LOCAL_WORLD_SIZE={os.environ.get('LOCAL_WORLD_SIZE')})")
    return Mesh(shape, names, rank_device(device))


def dp_over_dcn(tp: int = 1, devices: Sequence | None = None,
                device: Any = None) -> Mesh:
    """The standard recipe: tp inside the host, dp across everything
    else."""
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    n = len(devices)
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return hybrid_mesh({"tp": tp}, {"dp": n // tp}, devices, device)
