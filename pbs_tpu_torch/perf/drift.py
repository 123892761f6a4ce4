"""How far the perf benches drift over time on one host.

``python -m pbs_tpu_torch.perf.drift [--seconds S] [--native]
[--bench NAME ...]`` runs the named benches (quick op counts, the
harness's own best-of-rounds method) in turn, again and again for S
seconds, and prints one JSON object. For each bench it gives the
samples' count, min, median and max ns/op, max/min, the share of
samples at ``--slow`` (default 2, the gate's default threshold) times
the min or more, and the longest stretch in seconds over which every
sample was that slow.

A host whose max/min reaches the gate's threshold flags a bench it has
not slowed; a stretch longer than the gap between two readings makes
the second reading no independent check of the first. The gate's
spaced re-measure (``report.main_check``) is sized from these two
numbers.

``--gate N [--tree DIR]`` instead runs the gate itself N times: each
trial records a quick matrix of the benches in one child, saves it as
the baseline, and runs ``pbst-torch perf --check --quick`` against it
in a second child, both from the checkout at DIR (default: this one),
so the gate of another commit can be run on the same host. It prints
each trial's exit code, the benches over threshold at the first reading
and those that failed. Torch-free; runs on the host's CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

from pbs_tpu_torch.perf.bench import run_bench

#: The benches the gate holds to its default threshold in both modes.
DEFAULT_BENCHES = ("trace.emit", "span.emit", "hist.record")


def summarize(samples: list[tuple[float, float]], slow: float) -> dict:
    """``samples`` are (seconds, ns/op) in time order."""
    ns = [v for _, v in samples]
    lo = min(ns)
    longest, start = 0.0, None
    for t, v in samples:
        if v >= slow * lo:
            start = t if start is None else start
            longest = max(longest, t - start)
        else:
            start = None
    return {
        "n": len(ns),
        "min": round(lo, 1),
        "median": round(statistics.median(ns), 1),
        "max": round(max(ns), 1),
        "max_over_min": round(max(ns) / lo, 3),
        "slow_share": round(sum(v >= slow * lo for v in ns) / len(ns), 3),
        "longest_slow_s": round(longest, 2),
    }


def sample(benches: list[str], seconds: float, native: bool = False,
           ) -> dict[str, list[tuple[float, float]]]:
    """(seconds since start, ns/op) per bench, each bench run in turn
    until ``seconds`` have passed (at least once each)."""
    out: dict[str, list[tuple[float, float]]] = {b: [] for b in benches}
    t0 = time.monotonic()
    while True:
        for b in benches:
            r = run_bench(b, quick=True, native=native)
            out[b].append((time.monotonic() - t0, r.ns_per_op))
        if time.monotonic() - t0 >= seconds:
            return out


def gate_trials(n: int, benches: list[str], tree: str,
                native: bool = False) -> list[dict]:
    """N record-then-check trials of the gate from the checkout at
    ``tree`` (see the module docstring)."""
    from pbs_tpu_torch.perf.report import save_baseline

    env = dict(os.environ, PYTHONPATH=tree)
    args = [a for b in benches for a in ("--bench", b)] + (
        ["--native"] if native else [])

    def pbst(*argv: str) -> subprocess.CompletedProcess:
        return subprocess.run(
            [sys.executable, "-m", "pbs_tpu_torch.cli.pbst", "perf", *argv,
             *args], cwd=tree, env=env, capture_output=True, text=True,
            timeout=600)

    rows = []
    for _ in range(n):
        t = time.monotonic()
        rec = pbst("--json", "--quick")
        doc = json.loads(rec.stdout)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "baseline.json")
            save_baseline({**doc, "quick": False}, path, quick_results=doc)
            chk = pbst("--check", "--quick", "--baseline", path)
        failed = re.findall(r"PERF REGRESSION (\S+)", chk.stderr)
        rows.append({
            "rc": chk.returncode, "failed": failed,
            "flagged": sorted(set(failed) | set(re.findall(
                r"perf: (\S+) over threshold once", chk.stderr))),
            "wall": round(time.monotonic() - t, 2)})
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--bench", action="append", default=None)
    ap.add_argument("--native", action="store_true")
    ap.add_argument("--slow", type=float, default=2.0,
                    help="a sample this many times the min or more is slow")
    ap.add_argument("--gate", type=int, default=0, metavar="N",
                    help="run N record-then-check trials of the gate")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose gate --gate runs")
    args = ap.parse_args(argv)
    benches = args.bench or list(DEFAULT_BENCHES)
    if args.gate:
        rows = gate_trials(args.gate, benches, args.tree, args.native)
        print(json.dumps({
            "tree": args.tree, "native": args.native, "benches": benches,
            "trials": rows, "failed": sum(r["rc"] != 0 for r in rows),
            "flagged": sum(bool(r["flagged"]) for r in rows)}))
        return 0
    runs = sample(benches, args.seconds, native=args.native)
    print(json.dumps({
        "seconds": args.seconds, "native": args.native, "slow": args.slow,
        "benches": {b: summarize(s, args.slow) for b, s in runs.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
