"""The benchmark of the PyTorch/CUDA port (``pbs_tpu_torch``): cells of
co-located tenants on one H100 under the credit scheduler. Entry:
``python3 -m benchmark.run --workload NAME --seed N --seconds S
--trace 0|1`` from the root of a checkout."""
