"""Readings for the correctness limits, many seeds in one process.

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds S] [--rate R]
        [--out NAME.calibrate.jsonl]

Runs the cell once per seed as ``benchmark.run`` would (without
printing its result line) and prints each number the check compares;
for the control seeds it also reads every number with the float8
reference in the program's place. ``--rate`` replaces the traffic's
rate (the rate sweep: ``--no-check`` then skips the reference and the
line carries the backlog instead). One JSON line per run.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault-seeds", default="",
                    help="also read the half-batch fault, planted in the "
                    "reference put in the program's place (training cells)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import run as entry
    from benchmark import spec

    entry._cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness import run_cell

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    mix = spec.traffic(wl["traffic"])
    if args.rate is not None:
        mix["rate_per_s"] = args.rate
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    t_start = T_START
    for s in args.seeds.split(","):
        seed = int(s)
        result, run = run_cell(bench, args.workload, seed, seconds,
                               bool(args.trace), "cuda", t_start,
                               mix_override=mix,
                               check_output=not args.no_check,
                               control=seed in controls)
        line = {"workload": args.workload, "seed": seed,
                "seconds": seconds, "rate": mix.get("rate_per_s"),
                "readings": run.readings, "control": run.control,
                "correct": result["correct"], "metrics": result["metrics"],
                "device": result["device"],
                "served_compared": getattr(run, "served_compared", None)}
        if run.backlog is not None:
            line["backlog"] = run.backlog
        if "breakdown" in result:
            line["breakdown"] = result["breakdown"]
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run, result
        t_start = time.monotonic()
    for s in args.fault_seeds.split(","):
        if s:
            line = half_batch(wl, mix, int(s))
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


def half_batch(wl: dict, mix: dict, seed: int) -> dict:
    """The training numbers of the reference that takes half of each
    micro-batch's tokens (the mean over the rest) against the whole
    reference, on the card at the cell's size."""
    import torch

    from benchmark import check, spec
    from benchmark import weights as W

    cfg = spec.config(wl["config"])
    tspec = mix["tenants"]["batch"]
    shape = tuple(tspec["micro_batch"])
    dev = torch.device("cuda")

    def rows(i):
        return W.token_rows(seed, "train", i, shape, cfg["vocab_size"], dev)

    n = tspec["check"]["steps"]
    ref = check.reference_train(cfg, tspec, seed, n, rows, dev)
    half = check.reference_train(
        cfg, tspec, seed, n, lambda i: rows(i)[:, : shape[1] // 2 + 1], dev)
    return {"workload": wl["name"], "seed": seed,
            "fault": "half_batch", "readings": check.train_gaps(half, ref)}


if __name__ == "__main__":
    sys.exit(main())
