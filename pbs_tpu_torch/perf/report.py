"""Bench matrix driver, stable JSON reports, baseline regression gate.

The port of ``pbs_tpu.perf.report``: the same report, the same four
baseline maps, the same gate. Report shape (``pbst-torch perf --json``;
"version" gates schema changes):

    {"version": 1, "quick": false, "native": false,
     "native_available": true, "native_mode": "python",
     "benches": {"trace.emit": {"ops": ..., "ns_per_op": ..., ...}}}

``baseline.json`` (checked in next to this module; the port's own,
recorded on the card host's CPU, never the reference's numbers) holds
FOUR bench
maps — ``benches``/``quick_benches`` for the pure-Python mode and
``native_benches``/``native_quick_benches`` for ``--native`` —
because quick runs carry systematic per-call-overhead offsets and the
two modes measure different implementations; the gate always compares
like-with-like, so a native regression fails CI exactly like a Python
one. It compares ns/op ratios and fails only on LARGE regressions
(default ≥2×): microbench noise across CI hosts is real, a 2× cliff
on a hot path is not noise — the same philosophy as ``pbst-torch
selftest``'s order-of-magnitude canaries, but against refreshable
per-path numbers instead of fixed ceilings. ``--update-baseline``
refreshes it; :func:`save_baseline` stamps the file with the host it
was measured on (:func:`host_stamp`), so a number is never read
without its machine.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time

from pbs_tpu_torch.perf.bench import CHECK_THRESHOLDS, bench_names, run_bench

#: Fail --check only when ns/op worsens by at least this factor.
DEFAULT_THRESHOLD = 2.0

_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "baseline.json")


def baseline_path() -> str:
    return _BASELINE


def native_info() -> dict:
    """The mode/availability stamp every report carries, so reports
    stay comparable across machines with and without a toolchain. ``native_tier``
    says WHICH binding executed (fastcall needs Python.h at build
    time); ``native_error`` carries the cached build/load failure."""
    from pbs_tpu_torch.runtime import native

    avail = native.available()
    tier = None
    if avail:
        tier = "fastcall" if native.fastcall() is not None else "ctypes"
    info = {"native_available": avail, "native_tier": tier}
    # last_failure (not unavailable_reason): a fastcall-tier failure on
    # a host whose base library loads fine must surface too — "why am
    # I on the ctypes tier" deserves an answer in the report.
    reason = (native.unavailable_reason() if not avail
              else (native.last_failure() if tier == "ctypes" else None))
    if reason is not None:
        info["native_error"] = reason
    return info


def _cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo`` (else what
    ``platform`` knows), with the CPUs this process sees."""
    fields: dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, val = line.partition(":")
                if not sep:
                    break  # the first processor's block ends
                fields.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    name = fields.get("model name") or fields.get("cpu model")
    if name in (None, "", "unknown") and "vendor_id" in fields:
        # A host that hides the model name still gives its vendor,
        # family and model numbers.
        name = (f"{fields['vendor_id']} family "
                f"{fields.get('cpu family', '?')} model "
                f"{fields.get('model', '?')}")
    name = name or platform.processor() or "unknown"
    return f"{name} ({os.cpu_count()} CPUs)"


def _card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None on a host without one (the benches run on the host's CPU; the
    card names the machine)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def host_stamp() -> dict:
    """Where a baseline was measured: Python, machine, CPU model, the
    card beside it, torch's version (read from its metadata, without
    importing it) and the native tier."""
    from importlib import metadata

    try:
        torch_version = metadata.version("torch")
    except metadata.PackageNotFoundError:
        torch_version = None
    info = native_info()
    return {
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpu": _cpu_model(),
        "card": _card_line(),
        "torch": torch_version,
        "native_tier": info["native_tier"],
    }


def run_benches(names: list[str] | None = None, quick: bool = False,
                native: bool = False) -> dict:
    picked = list(names) if names else bench_names(native=native)
    unknown = set(picked) - set(bench_names(native=native))
    if unknown:
        raise KeyError(
            f"unknown bench(es) {sorted(unknown)}; "
            f"available: {bench_names(native=native)}")
    doc = {
        "version": 1,
        "quick": bool(quick),
        "native": bool(native),
        "native_mode": "native" if native else "python",
        **native_info(),
        "benches": {n: run_bench(n, quick=quick, native=native).as_dict()
                    for n in picked},
    }
    return doc


def load_baseline(path: str | None = None) -> dict:
    with open(path or _BASELINE) as f:
        base = json.load(f)
    if not isinstance(base.get("benches"), dict):
        raise ValueError("baseline holds no 'benches' map")
    return base


def _baseline_key(quick: bool, native: bool) -> str:
    key = "quick_benches" if quick else "benches"
    return f"native_{key}" if native else key


def save_baseline(results: dict, path: str | None = None,
                  quick_results: dict | None = None) -> str:
    """Merge ``results`` (and ``quick_results``) into the baseline at
    ``path``, stamped with :func:`host_stamp` as its ``host``."""
    path = path or _BASELINE
    native = bool(results.get("native"))
    # Merge over any existing baseline: a partial refresh
    # (`--bench X --update-baseline`, or a native-only refresh) must
    # update those numbers, not silently delete every other entry
    # (compare_to_baseline skips missing benches, so a dropped entry
    # stops being gated).
    maps: dict[str, dict] = {k: {} for k in (
        "benches", "quick_benches", "native_benches",
        "native_quick_benches")}
    try:
        old = load_baseline(path)
        for k in maps:
            maps[k].update(old.get(k, {}))
    except (OSError, ValueError):
        pass  # no (or unreadable) prior baseline: write fresh
    maps[_baseline_key(False, native)].update(results["benches"])
    if quick_results is not None:
        maps[_baseline_key(True, native)].update(
            quick_results["benches"])
    doc = {
        "version": 1,
        "note": ("refreshed via `pbst-torch perf --update-baseline`; "
                 "'benches'/'quick_benches' are the pure-Python "
                 "full/--quick numbers, 'native_*' the --native mode — "
                 "the gate compares like-with-like"),
        "host": host_stamp(),
        "benches": maps["benches"],
    }
    for k in ("quick_benches", "native_benches",
              "native_quick_benches"):
        if maps[k]:
            doc[k] = maps[k]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def baseline_benches_for(results: dict, baseline: dict) -> dict:
    """The like-with-like baseline map: quick results compare against
    the ``*quick_benches`` map when present (quick op counts carry
    systematic per-call-overhead offsets a full-matrix number would
    misjudge), and ``--native`` results only ever compare against the
    ``native_*`` maps."""
    key = _baseline_key(bool(results.get("quick")),
                        bool(results.get("native")))
    m = baseline.get(key)
    if isinstance(m, dict):
        return m
    if results.get("quick"):
        # No quick map for the mode: fall back to its full-matrix map
        # (the pre-dual-mode behavior; missing benches are skipped).
        m = baseline.get(_baseline_key(False, bool(results.get("native"))))
        if isinstance(m, dict):
            return m
    return {} if results.get("native") else baseline["benches"]


def compare_to_baseline(results: dict, baseline: dict,
                        threshold: float = DEFAULT_THRESHOLD) -> list[dict]:
    """Regressions only: benches whose ns/op worsened by >= threshold.
    Benches missing from either side are skipped (a new bench must be
    able to land before its baseline number does)."""
    out = []
    base_map = baseline_benches_for(results, baseline)
    for name, cur in results["benches"].items():
        base = base_map.get(name)
        if not base or not base.get("ns_per_op"):
            continue
        # Wall-clock-bound benches (CHECK_THRESHOLDS) get wider armor
        # than the CLI threshold — their run-to-run spread is OS
        # scheduler noise, not code.
        eff = max(threshold, CHECK_THRESHOLDS.get(name, 0.0))
        ratio = cur["ns_per_op"] / base["ns_per_op"]
        if ratio >= eff:
            out.append({
                "bench": name,
                "baseline_ns_per_op": base["ns_per_op"],
                "ns_per_op": cur["ns_per_op"],
                "ratio": round(ratio, 2),
                "threshold": eff,
            })
    return sorted(out, key=lambda r: -r["ratio"])


def format_report(results: dict, baseline: dict | None = None) -> str:
    lines = [
        f"{'bench':<18} {'ops':>8} {'ns/op':>10} {'ops/s':>12} "
        f"{'blk/op':>7} {'peak_kib':>9}" + ("   vs_base" if baseline else "")
    ]
    base_map = baseline_benches_for(results, baseline) if baseline else {}
    for name, r in results["benches"].items():
        row = (f"{name:<18} {r['ops']:>8} {r['ns_per_op']:>10.1f} "
               f"{r['ops_per_s']:>12.0f} {r['alloc_blocks_per_op']:>7.3f} "
               f"{r['alloc_peak_kib']:>9.1f}")
        if baseline:
            base = base_map.get(name, {})
            if base.get("ns_per_op"):
                row += f"   {r['ns_per_op'] / base['ns_per_op']:>7.2f}x"
            else:
                row += "        --"
        lines.append(row)
    return "\n".join(lines)


def main_check(results: dict, baseline_file: str | None,
               threshold: float) -> int:
    """Shared CLI/CI tail: print regressions, return the exit code.

    A bench over threshold is RE-MEASURED before it fails the gate: a
    real regression reproduces, a scheduler/GC spike on a shared host
    does not. The re-measure is up to :data:`RECHECK_ROUNDS` runs of the
    bench, :data:`RECHECK_GAP_S` apart, keeping its best ns/op; the
    bench fails only if that best is still over threshold. One
    immediate re-measure is not independent of the first reading on a
    host whose speed drifts in stretches of seconds: on the H100 card
    host a quick python bench alone swung up to 2.6x (max/min), above
    the default 2x, and stayed at 2x its best or more for up to 19.5 s
    in a 120 s sample (``python -m pbs_tpu_torch.perf.drift``). Runs
    spread over thirty seconds reach the host's fast state, and a
    genuine cliff stays over threshold in every one of them.

    All diagnostics go to stderr: ``--json --check`` must leave stdout
    holding exactly the JSON document for CI parsers.
    """
    stream = sys.stderr
    try:
        baseline = load_baseline(baseline_file)
    except (OSError, ValueError) as e:
        print(f"pbst-torch: bad perf baseline: {e}", file=sys.stderr)
        return 2
    regressions = compare_to_baseline(results, baseline, threshold)
    if regressions:
        confirmed = _remeasure(regressions, results, baseline, threshold)
        recovered = ({r["bench"] for r in regressions}
                     - {r["bench"] for r in confirmed})
        for name in sorted(recovered):
            print(f"perf: {name} over threshold once but fine on "
                  "re-measure — transient interference, not a "
                  "regression", file=stream)
        regressions = confirmed
    for r in regressions:
        print(f"PERF REGRESSION {r['bench']} (reproduced on "
              f"re-measure): {r['ns_per_op']:.1f} ns/op vs baseline "
              f"{r['baseline_ns_per_op']:.1f} "
              f"({r['ratio']}x >= {r['threshold']}x)", file=stream)
    return 1 if regressions else 0


#: The gate's re-measure: runs of each regressed bench, this many
#: seconds apart, until its best ns/op is under threshold (see
#: :func:`main_check`).
RECHECK_ROUNDS = 11
RECHECK_GAP_S = 3.0


def _remeasure(regressions: list[dict], results: dict, baseline: dict,
               threshold: float) -> list[dict]:
    """The regressions still over threshold at their best ns/op across
    up to :data:`RECHECK_ROUNDS` runs spaced :data:`RECHECK_GAP_S`."""
    quick = bool(results.get("quick"))
    native = bool(results.get("native"))
    best: dict[str, dict] = {}
    pending = [r["bench"] for r in regressions]
    confirmed = regressions
    for i in range(RECHECK_ROUNDS):
        if i:
            time.sleep(RECHECK_GAP_S)
        retry = run_benches(pending, quick=quick, native=native)
        for name, cur in retry["benches"].items():
            if name not in best or cur["ns_per_op"] < best[name]["ns_per_op"]:
                best[name] = cur
        confirmed = compare_to_baseline(
            {**retry, "benches": {n: best[n] for n in pending}}, baseline,
            threshold)
        pending = [r["bench"] for r in confirmed]
        if not pending:
            break
    return confirmed
