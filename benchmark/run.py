"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Needs an NVIDIA H100 80GB HBM3, the card
whose peaks the shares divide by (exits 2 without one, or with fewer
cards than the cell asks for, printing no result). The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number the correctness check compared, beside
its limit); the same numbers and limits end standard error.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import flops, spec  # noqa: E402

CACHE = spec.ROOT / ".benchmark_cache"
#: Top-level module names that may not be loaded (compared whole:
#: ``pbs_tpu_torch`` is not ``pbs_tpu``).
FORBIDDEN = {"jax", "jaxlib", "flax", "pbs_tpu"}


def _cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout,
    so only the first run of a cell there builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"benchmark: the cell needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    if kind != flops.CARD:
        print(f"benchmark: the card is {kind!r}; the shares are of the "
              f"{flops.CARD}'s peaks, and it runs on no other",
              file=sys.stderr)
        return 2
    from benchmark.harness import run_cell

    result, run = run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    # the window has closed: whatever the port loaded is in sys.modules
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print("benchmark: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
