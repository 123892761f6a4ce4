"""The port's twins of the repository's root scripts.

Each module keeps the reference script's name, knobs and JSON keys, and
runs as ``python -m pbs_tpu_torch.drivers.<name>``:

- :mod:`~pbs_tpu_torch.drivers.bench` — the headline: flagship
  training tokens/s and MFU in a supervised child (``bench.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_common` — the shared helpers
  (``bench_common.py``);
- :mod:`~pbs_tpu_torch.drivers.graft_entry` — ``entry()`` and
  ``dryrun_multichip(n)`` (``__graft_entry__.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_sim` — every policy over every
  simulated workload (``bench_sim.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_serving` — prefill, decode and the
  eight-engine matrix (``bench_serving.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_longctx` — flagship training at
  S = 4096 and 8192, dense against flash attention (``bench_longctx.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_sweep` — remat x batch x attention
  at S = 1024 (``bench_sweep.py``);
- :mod:`~pbs_tpu_torch.drivers.bench_decompose` — the roofline
  decomposition of the flagship step (``bench_decompose.py``).

Every twin runs on the card unless its tiny mode or an explicit CPU
device is asked for, and raises without a card otherwise.
"""
