"""PBS-T on PyTorch and CUDA: the port of ``pbs_tpu`` to NVIDIA Hopper.

The performance-feedback scheduling loop (jobs in a partition, a
telemetry backend charging each quantum into a seqlock ledger, the
feedback policy resizing each job's time slice, the credit scheduler
dispatching within those slices) for tenants written in PyTorch. The
TPU kernels of the JAX package are hand-written CUDA kernels here
(``pbs_tpu_torch/ops/csrc``), each beside a plain PyTorch version of
the same function.

The package imports neither JAX nor ``pbs_tpu``; module paths and
public names mirror ``pbs_tpu`` so each counterpart is easy to find.
Entry points that touch a device default to ``cuda`` and raise when no
card is present; pass ``device="cpu"`` to run the plain versions.
"""
