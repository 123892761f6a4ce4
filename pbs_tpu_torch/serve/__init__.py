"""pbs_tpu_torch.serve — the sharded serving tier behind the gateway.

The port of ``pbs_tpu.serve``: a real partitioned transformer served
through the SAME front door (admission, DRR fair queue, journal, spans,
SLO histograms) the chaos/tune/autopilot arcs hardened against
simulated backends.

- :mod:`pbs_tpu_torch.serve.partition` — regex-rule parameter
  partitioning: an ordered (path regex -> positional PartitionSpec)
  table, scalars unpartitioned, unmatched leaf a hard error; shard and
  gather functions built on ``parallel/``.
- :mod:`pbs_tpu_torch.serve.backend` — :class:`ShardedServeBackend`:
  the rule-partitioned
  :class:`~pbs_tpu_torch.models.serving.ContinuousBatcher` as a
  duck-typed gateway backend with per-stage EXEC span coverage.
- :mod:`pbs_tpu_torch.serve.disagg` — :class:`DisaggServeBackend`:
  prefill/decode pool disaggregation with KV handoff over the prefix-
  cache install path and SPAN_HANDOFF-stitched chains.

Import shape: the package imports torch lazily (inside constructors)
except for partition.py, so ``pbst-torch check`` and the knob registry
can reason about it on a host with no device runtime; the knob surface
is declared in ``knobs/registry.py`` under the ``serve.*`` subsystem.
"""

from pbs_tpu_torch.serve.backend import ShardedServeBackend, synth_payload
from pbs_tpu_torch.serve.disagg import DisaggServeBackend, PrefillPool

__all__ = [
    "DisaggServeBackend",
    "PrefillPool",
    "ShardedServeBackend",
    "synth_payload",
]
