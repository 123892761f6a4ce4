"""Device meshes and slice partitions.

The port of ``pbs_tpu.parallel.mesh``. The reference multiplexes vCPUs
over pCPUs and hard-partitions pCPUs into cpupools
(``xen/common/cpupool.c``); here jobs run SPMD programs over a mesh of
rank processes, one device each, and partitions own disjoint device
sets. Mesh axes follow the scaling-book convention:

- ``dp`` — data parallel (batch sharding, gradient sums)
- ``tp`` — tensor parallel (heads/ff/vocab sharding + sequence-parallel
  residual streams between blocks)
- ``pp`` — pipeline stages (send/recv microbatching)
- ``ep`` — expert parallel (MoE expert buffers)
- ``sp`` — sequence parallel (ring attention, Ulysses)

Where the reference's ``Mesh`` holds devices of one process, the port's
:class:`Mesh` spans the ranks of an initialised ``torch.distributed``
world (``init_device_mesh`` over the default group, row-major over
ranks), and each axis's process group carries that axis's exchanges
(:mod:`pbs_tpu_torch.parallel.comm`). :class:`PartitionSpec` and
:class:`NamedSharding` keep the reference's spec vocabulary; a sharding
here cuts a full array down to this rank's block. A mesh of this
process alone, every axis of size 1 (:func:`one_rank_mesh`, the serving
tier's 1x1 mesh), needs no world.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dimension,
    each a mesh axis name, a tuple of names, or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over the ranks of the world, row-major.

    ``axis_names`` and ``shape`` (name -> size) are the reference's;
    ``devices`` is the array of global ranks in mesh layout (row-major:
    ``np.arange(world).reshape(sizes)``);
    ``device`` this rank's torch device; :meth:`group`, :meth:`index`
    and :meth:`size` an axis's process group, this rank's coordinate on
    it, and its size (1 for an axis the mesh lacks)."""

    def __init__(self, sizes: tuple, axis_names: tuple,
                 device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        devices = np.arange(math.prod(sizes)).reshape(sizes)
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device = device
        self.device_mesh = init_device_mesh(
            device.type, devices.shape, mesh_dim_names=self.axis_names)
        coords = np.argwhere(devices == dist.get_rank())[0]
        self._index = dict(zip(self.axis_names, (int(c) for c in coords)))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self._index.get(axis, 0)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class _OneRankMesh(Mesh):
    """A mesh of this process alone, every axis of size 1: it needs no
    ``torch.distributed`` world. Each axis's group is None, which
    :mod:`pbs_tpu_torch.parallel.comm` takes for a group of one member,
    so every exchange over it is skipped."""

    def __init__(self, axis_names: tuple, device: torch.device):
        self.axis_names = tuple(axis_names)
        self.devices = np.zeros((1,) * len(self.axis_names), dtype=int)
        self.shape = dict.fromkeys(self.axis_names, 1)
        self.device = device
        self.device_mesh = None
        self._index = dict.fromkeys(self.axis_names, 0)

    def group(self, axis: str):
        return None


def one_rank_mesh(axis_names: Sequence[str], device: Any = None) -> Mesh:
    """A mesh of this process alone whose axes all have size 1, built
    with or without an initialised world (a departure: the reference
    takes one of its process's devices, and the port's :func:`make_mesh`
    spans every rank of a world). ``device`` as for :func:`make_mesh`;
    "cuda" without an index means the current card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "explicitly to run on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _OneRankMesh(tuple(axis_names), dev)


def rank_device(device: Any = None) -> torch.device:
    """This rank's device: ``device`` as given, where "cuda" without an
    index means the card at ``rank % device_count`` (two ranks share the
    one card of a one-card host). None means the card, and raises
    without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "explicitly to run on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def make_mesh(
    axes: dict[str, int] | None = None,
    devices: Sequence | None = None,
    device: Any = None,
) -> Mesh:
    """Build a Mesh from an {axis: size} dict (row-major over ranks).

    With ``axes=None`` the full rank set becomes a 1-D ``dp`` mesh.
    Axis sizes of -1 are inferred from the rank count (at most one).
    ``devices`` (one entry per rank, as from :func:`split_devices`)
    stands for the world's ranks and must cover all of them: every rank
    of the default group calls this together. ``device`` is this rank's
    device (:func:`rank_device`: None means the card)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed world "
            "(init_process_group, or parallel.multihost.initialize)")
    world = dist.get_world_size()
    devices = list(devices if devices is not None else range(world))
    n = len(devices)
    if axes is None:
        axes = {"dp": n}
    names = list(axes)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
            f"devices, have {n}"
        )
    if n != world:
        raise ValueError(
            f"a mesh spans the whole world: {n} devices given, the world "
            f"has {world} ranks")
    return Mesh(tuple(sizes), tuple(names), rank_device(device))


def split_devices(n_partitions: int, devices: Sequence | None = None):
    """Partition the device set into equal contiguous pools (cpupool
    analog: contiguous so intra-pool exchanges stay on neighboring
    links). ``devices`` defaults to this host's cards."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n % n_partitions:
        raise ValueError(f"{n} devices not divisible into {n_partitions} pools")
    per = n // n_partitions
    return [devices[i * per:(i + 1) * per] for i in range(n_partitions)]


class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec. :meth:`shard`
    cuts a full array (numpy or torch) down to this rank's block and
    puts it on the mesh's device."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def shard(self, x) -> torch.Tensor:
        return shard_array(x, self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_array(x, mesh: Mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of the full array ``x`` under ``spec`` (axes the
    mesh lacks replicate), on the mesh's device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    for dim, entry in enumerate(spec):
        for axis in _axes_of(entry):
            if axis not in mesh.axis_names:
                continue
            n = mesh.size(axis)
            if t.shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} of {tuple(t.shape)} not divisible by "
                    f"mesh axis {axis!r} of size {n}")
            t = t.chunk(n, dim=dim)[mesh.index(axis)]
    return t.contiguous().to(mesh.device, copy=True)
