"""Simulator policy-regression bench: every policy over every workload.

The port of ``bench_sim.py``. Hardware-free and deterministic: the whole
run happens in virtual time on the ``pbs_tpu_torch.sim`` engine (a copy
of the reference's simulator), so its document equals the reference's
byte for byte. Prints one JSON document mapping workload -> policy ->
headline metrics (Jain fairness, p50/p99 runqueue wait, context
switches, trace digest) plus a ``headline`` line comparing feedback vs
plain credit p99 wait on the contended mix.

Usage: python -m pbs_tpu_torch.drivers.bench_sim [--seed 7]
       [--seconds 2.0] [--tenants 6]
       [--workloads contended,stable,serving] [--out BENCH_sim.json]
"""

from __future__ import annotations

import argparse
import json
import sys

# No device: pbs_tpu_torch.sim never imports torch — the whole run is
# host-side Python on a virtual clock.


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="virtual horizon per run")
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--workloads", default="contended,stable,serving")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    from pbs_tpu_torch.sim import compare

    horizon_ns = int(args.seconds * 1e9)
    doc: dict = {"bench": "sim_policy_regression", "seed": args.seed,
                 "horizon_ns": horizon_ns, "tenants": args.tenants,
                 "workloads": {}}
    for wl in [w for w in args.workloads.split(",") if w]:
        cmp = compare(wl, seed=args.seed, n_tenants=args.tenants,
                      horizon_ns=horizon_ns)
        doc["workloads"][wl] = {
            p: {k: r[k] for k in
                ("jain_fairness", "wait_p50_us", "wait_p99_us",
                 "switches", "quanta", "utilization", "trace_digest")}
            for p, r in cmp["policies"].items()
        }

    contended = doc["workloads"].get("contended", {})
    if "feedback" in contended and "credit" in contended:
        fb = contended["feedback"]["wait_p99_us"]
        cr = contended["credit"]["wait_p99_us"]
        doc["headline"] = {
            "metric": "contended_p99_wait_us",
            "feedback": fb,
            "credit": cr,
            # >1 means the adaptive quantum beat the static slice.
            "speedup": round(cr / fb, 3) if fb else None,
        }
    out = json.dumps(doc, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
