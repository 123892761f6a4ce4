"""The parallel schedules: mesh, sharding, ring attention, Ulysses,
expert parallelism, the GPipe pipeline, gang scheduling and multi-host
bring-up — the port of ``pbs_tpu.parallel`` on ``torch.distributed``.

SPMD by rank, the one structural departure: the reference takes global
arrays and maps its per-device bodies with ``jax.shard_map`` (or lets
XLA partition annotated arrays); here every rank process runs the same
body on its own shard. Each public function takes and returns this
rank's local shard — ``ring_attention`` and ``ulysses_attention`` their
sequence chunks, the train steps and losses this rank's token block
(``batch_sharding(mesh).shard(tokens)``) and parameter shards
(``shard_params``; ``gather_params`` reassembles them). The exchanges
XLA would insert are written out with their transposes in
:mod:`pbs_tpu_torch.parallel.comm`.

Beside the reference's ``__all__`` the port exports ``gather_params``,
``reduce_grads``, ``PartitionSpec`` and ``NamedSharding``, and
:mod:`pbs_tpu_torch.parallel.launch` spawns rank processes on one host.
"""

from pbs_tpu_torch.parallel.expert import (
    expert_constrainer,
    make_sharded_moe_train,
    moe_batch_sharding,
    moe_param_specs,
    shard_moe_params,
)
from pbs_tpu_torch.parallel.gang import GangMonitor, anti_stack_pick
from pbs_tpu_torch.parallel.mesh import (
    NamedSharding,
    PartitionSpec,
    make_mesh,
    split_devices,
)
from pbs_tpu_torch.parallel.ring_attention import ring_attention
from pbs_tpu_torch.parallel.ulysses import ulysses_attention
from pbs_tpu_torch.parallel.sharding import (
    activation_constrainer,
    batch_sharding,
    gather_params,
    make_sharded_train,
    param_specs,
    reduce_grads,
    shard_params,
)

__all__ = [
    "GangMonitor",
    "expert_constrainer",
    "make_sharded_moe_train",
    "moe_batch_sharding",
    "moe_param_specs",
    "shard_moe_params",
    "anti_stack_pick",
    "make_mesh",
    "ring_attention",
    "ulysses_attention",
    "split_devices",
    "activation_constrainer",
    "batch_sharding",
    "make_sharded_train",
    "param_specs",
    "shard_params",
]

#: Port-only names, beside the reference's ``__all__``.
PORT_ONLY = ["NamedSharding", "PartitionSpec", "gather_params",
             "reduce_grads"]
