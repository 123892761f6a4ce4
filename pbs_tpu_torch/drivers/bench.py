"""Headline benchmark: flagship transformer training throughput on the H100.

The port of ``bench.py``: steady-state training throughput (tokens/s)
of the flagship decoder on one card, with ``vs_baseline`` normalised
against a fixed roofline-derived bar:

    bar = 40% MFU on a 989 TFLOP/s (bf16, H100 SXM) card
        = 0.4 * 989e12 / (6 * n_params) tokens/s

Prints exactly ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The benchmark runs in a child process (``--worker``) under a deadline;
the supervising parent imports no torch, so it cannot hang in the CUDA
runtime, and always prints the JSON line: the child's on success, an
``"error"`` payload naming the last stage reached on a crash or a
deadline. An ordinary crash is retried once; a worker whose error
:func:`~pbs_tpu_torch.drivers.bench_common.backend_unavailable` calls
fatal (no device, a poisoned context, a kernel that fails to build) is
not. Knobs, names, constants, stage markers and JSON keys are the
reference's. A chunk is ``STEPS_PER_CHUNK`` steps queued back to back
with one synchronise, at the read of its last loss
(``bench_common.TrainingChunks``), where the reference runs one
``lax.scan``.

Departures from the reference:

(a) On a deadline, or when no ``"backend init:"`` marker shows within
    ``PBST_BENCH_PROBE_S``, the supervisor kills the worker's process
    group (SIGTERM, then SIGKILL after ``KILL_GRACE_S``). The reference
    orphans it, because a TPU claim holder must never be signalled. A
    CUDA context dies with its process, and an orphan would hold the
    card for the next command. So there is no probe sentinel and no
    waiter watchdog: ``PBST_BENCH_PROBE_SENTINEL``,
    ``PBST_BENCH_SELF_EXIT_S``, ``PBST_BENCH_SELF_EXIT_GRACE_S`` and
    ``PBST_BENCH_PROBE_EXIT_GRACE_S`` have nothing to configure and are
    ignored.
(b) No automatic serving fallback: with no usable card the supervisor
    prints the ``flagship_train_throughput`` error row and exits 1 (the
    reference prints the CPU serving number in its place, and exits 0).
    The serving measurement runs only when ``--serving-fallback`` is
    asked for, on the card unless ``--device cpu`` or tiny mode is. The
    reference's ``PBST_BENCH_SERVING_FALLBACK``,
    ``PBST_BENCH_FALLBACK_CMD`` and ``PBST_BENCH_FALLBACK_TIMEOUT_S``
    have nothing to configure and are ignored.
(c) No ``setup_compilation_cache``: the kernels build once into
    ``pbs_tpu_torch/build/`` (``ops/cuda_build.py``).

Tiny mode (``PBST_BENCH_TINY`` = 1, true or yes) takes the tiny config,
batch 2, S 128 and 1/1/2 chunks on the host's CPU, as the reference
pins its CPU there.

Usage:
    python -m pbs_tpu_torch.drivers.bench                    # the card
    PBST_BENCH_TINY=1 python -m pbs_tpu_torch.drivers.bench  # CPU smoke
    python -m pbs_tpu_torch.drivers.bench --serving-fallback [--device cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from pbs_tpu_torch.drivers.bench_common import PEAK_FLOPS

TARGET_MFU = 0.40

WARMUP_CHUNKS = 2
BENCH_CHUNKS = 3
STEPS_PER_CHUNK = 10  # steps queued back to back: one synchronise a chunk
BATCH = 6
SEQ = 1024

# The reference's committed default config, all None: a run with no
# env measures the protocol above. Knobs come from the
# PBST_BENCH_* env alone until a cell commits a value here.
DEFAULTS = {"batch": None, "loss_chunks": None, "attn": None, "mu_dtype": None, "remat": None}  # noqa: E501

#: Seconds between SIGTERM and SIGKILL to a deadlined worker's group.
KILL_GRACE_S = 5.0

#: The stderr line a worker writes before it exits on an error that
#: :func:`backend_unavailable` calls fatal: the supervisor does not
#: retry it.
UNAVAILABLE_MARK = "[bench] backend unavailable:"

#: Fixed bar for the serving mode's ``vs_baseline``: the reference's
#: (~1.5x its first measured tiny-model CPU number), kept so the two
#: rows read on one scale.
SERVING_BAR_TOKENS_S = 5000.0

_T0 = time.perf_counter()


def _float_env(name: str, default: float) -> float:
    """Seconds knobs fail fast with a clean message, never a bare
    ValueError traceback."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        raise SystemExit(f"{name} must be a number (seconds): {raw!r}")
    if v < 0:
        raise SystemExit(f"{name} must be >= 0: {raw}")
    return v


def seconds_knobs() -> dict:
    """The supervisor's budgets (the reference's defaults), validated;
    raises SystemExit with the reference's message on a bad one."""
    return {
        # Per-attempt wall budget for the child.
        "timeout_s": _float_env("PBST_BENCH_TIMEOUT_S", 480.0),
        # The "backend init:" marker must show within this window.
        "probe_s": _float_env("PBST_BENCH_PROBE_S", 90.0),
        "retry_sleep_s": _float_env("PBST_BENCH_RETRY_SLEEP_S", 10.0),
    }


def _mark(msg: str) -> None:
    """Stage marker on stderr: when the worker hangs, the supervisor
    reports the LAST stage reached instead of a bare timeout."""
    sys.stderr.write(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}\n")
    sys.stderr.flush()


def tiny_mode() -> bool:
    return os.environ.get("PBST_BENCH_TINY", "").lower() in (
        "1", "true", "yes")


def parse_knobs(tiny: bool) -> dict:
    """The candidate-config knobs from the env, validated with the
    reference's messages (SystemExit) before any device is touched."""
    from pbs_tpu_torch.drivers.bench_common import parse_mu_dtype

    def _int_knob(name, minimum=1):
        raw = os.environ.get(name)
        if not raw:
            return None
        try:
            v = int(raw)
        except ValueError:
            raise SystemExit(f"{name} must be an int: {raw!r}")
        if v < minimum:
            raise SystemExit(f"{name} must be >= {minimum}: {v}")
        return v

    batch = _int_knob("PBST_BENCH_BATCH")
    # "0" is the explicit unchunked spelling.
    loss_chunks = (None if os.environ.get("PBST_BENCH_LOSS_CHUNKS") == "0"
                   else _int_knob("PBST_BENCH_LOSS_CHUNKS"))
    seq_planned = 128 if tiny else SEQ
    if loss_chunks and seq_planned % loss_chunks:
        raise SystemExit(f"PBST_BENCH_LOSS_CHUNKS={loss_chunks} must divide "
                         f"seq={seq_planned}")
    attn = os.environ.get("PBST_BENCH_ATTN") or None
    if attn and attn not in ("xla", "pallas"):
        raise SystemExit(f"PBST_BENCH_ATTN must be xla|pallas: {attn}")
    remat = os.environ.get("PBST_BENCH_REMAT") or None
    if remat and remat not in ("none", "dots", "full"):
        raise SystemExit(f"PBST_BENCH_REMAT must be none|dots|full: {remat}")
    try:
        mu_dtype, mu_label = parse_mu_dtype(
            os.environ.get("PBST_BENCH_MU_DTYPE") or None)
    except ValueError as e:
        raise SystemExit(f"PBST_BENCH_MU_DTYPE: {e}")
    return dict(batch=batch, loss_chunks=loss_chunks, attn=attn,
                remat=remat, mu_dtype=mu_dtype, mu_label=mu_label)


def headline(batch: int, seq: int, steps: int, dt: float, n_params: int,
             peak: float = PEAK_FLOPS) -> dict:
    """The JSON line's numbers from one timing: ``steps`` steps of
    batch x (seq - 1) predicted tokens in ``dt`` seconds, MFU and the
    bar at ``peak`` FLOP/s under the 6N convention."""
    tokens_per_s = batch * (seq - 1) * steps / dt
    flops_per_token = 6 * n_params
    bar = TARGET_MFU * peak / flops_per_token
    return {
        "value": round(tokens_per_s, 1),
        "vs_baseline": round(tokens_per_s / bar, 4),
        "mfu": round(tokens_per_s * flops_per_token / peak, 4),
        "step_ms": round(1e3 * dt / steps, 1),
    }


def _device_name(torch, dev) -> str:
    """The JSON line's ``device``: the card's name, or the host's."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _backend_init(torch, dev) -> str:
    """What the ``"backend init:"`` marker names: the card and its power
    limit (``nvidia-smi``), or the host."""
    if dev.type != "cuda":
        return str(dev)
    from pbs_tpu_torch.perf.report import _card_line

    name = _device_name(torch, dev)  # initialises the context
    return f"{name} ({_card_line() or 'power limit not read'})"


def measure(knobs: dict, tiny: bool = False, device=None,
            timeout_s: float = 480.0, t_start: float | None = None):
    """The worker's body: the flagship (tiny config in tiny mode) with
    ``knobs`` applied, trained under the reference's protocol, warm-up
    and the degraded-protocol probe included. ``t_start`` is when the
    attempt began (default: this module's import), against the 0.7 x
    ``timeout_s`` budget. Returns the JSON row and the first step's
    loss."""
    import dataclasses

    _mark("importing torch")
    import torch

    from pbs_tpu_torch.drivers.bench_common import (TrainingChunks,
                                                    bench_device)
    from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg

    dev = bench_device(tiny, device)
    t_start = _T0 if t_start is None else t_start
    cfg = _flagship_cfg(tiny=tiny)
    batch, seq = (2, 128) if tiny else (BATCH, SEQ)
    warm_chunks, bench_chunks, steps = (
        (1, 1, 2) if tiny else (WARMUP_CHUNKS, BENCH_CHUNKS, STEPS_PER_CHUNK))
    extras = {}
    if knobs["batch"]:
        batch = extras["batch"] = knobs["batch"]
    if knobs["loss_chunks"]:
        cfg = dataclasses.replace(cfg, loss_chunks=knobs["loss_chunks"])
        extras["loss_chunks"] = cfg.loss_chunks
    if knobs["attn"]:
        cfg = dataclasses.replace(cfg, attn_impl=knobs["attn"])
        extras["attn"] = knobs["attn"]
    if knobs["remat"] == "none":
        cfg = dataclasses.replace(cfg, remat=False)
        extras["remat"] = knobs["remat"]
    elif knobs["remat"]:
        cfg = dataclasses.replace(cfg, remat=True,
                                  remat_policy=knobs["remat"])
        extras["remat"] = knobs["remat"]
    n_params = cfg.num_params()
    _mark(f"backend init: {_backend_init(torch, dev)}")
    chunks = TrainingChunks(cfg, batch, seq, steps, dev,
                            mu_dtype=knobs["mu_dtype"])
    _mark(f"params initialized ({n_params / 1e6:.0f}M)")
    _mark("compiling train chunk")  # the first chunk builds the kernels
    chunks.run()
    _mark("warmup chunk 0 done")
    # Degraded protocol: if the remaining warm-up and timed chunks would
    # overrun the supervisor's deadline, shrink the protocol and say so
    # in the result. The post-build chunk below is both the second
    # warm-up and the timing probe; in the worst tier it IS the
    # measurement.
    n_warm = max(0, warm_chunks - 2)  # chunk 0 + probe already run
    n_bench = bench_chunks
    t_probe = time.perf_counter()
    probe_loss = chunks.run()
    chunk_s = time.perf_counter() - t_probe
    _mark(f"warmup chunk 1 done ({chunk_s:.1f}s/chunk)")
    degraded = False
    budget = 0.7 * timeout_s
    elapsed = time.perf_counter() - t_start
    if elapsed + chunk_s > budget:
        degraded, n_warm, n_bench = True, 0, 0
        dt, final_loss = chunk_s, probe_loss
        _mark("degraded protocol: probe chunk is the measurement")
    elif elapsed + chunk_s * (n_warm + n_bench) > budget:
        degraded, n_warm, n_bench = True, 0, 1
        _mark(f"degraded protocol: {chunk_s:.1f}s/chunk would overrun "
              f"the {timeout_s:.0f}s deadline; timing 1 chunk")
    for i in range(n_warm):
        chunks.run()
        _mark(f"warmup chunk {i + 2} done")
    if n_bench:
        _mark("warmup done; timing")
        t0 = time.perf_counter()
        for _ in range(n_bench):
            final_loss = chunks.run()
        dt = time.perf_counter() - t0
    h = headline(batch, seq, max(n_bench, 1) * steps, dt, n_params)
    row = {
        "metric": "flagship_train_throughput", "value": h["value"],
        "unit": "tokens/s", "vs_baseline": h["vs_baseline"],
        "mfu": h["mfu"], "n_params": n_params, "step_ms": h["step_ms"],
        "device": _device_name(torch, dev),
        "loss": round(final_loss, 4),
        "mu_dtype": knobs["mu_label"],
        **extras,
        **({"degraded_protocol": True, "bench_chunks": n_bench}
           if degraded else {}),
    }
    return row, chunks.first_loss


def _worker(device) -> int:
    """``--worker``: one JSON line on stdout, or the
    :data:`UNAVAILABLE_MARK` line on stderr and rc 3 on a fatal backend
    error."""
    from pbs_tpu_torch.drivers.bench_common import (backend_unavailable,
                                                    error_row)

    tiny = tiny_mode()
    # Knobs BEFORE the device: a typo must fail in milliseconds.
    knobs = parse_knobs(tiny)
    timeout_s = seconds_knobs()["timeout_s"]
    try:
        row, _ = measure(knobs, tiny, device, timeout_s=timeout_s)
    except Exception as e:  # noqa: BLE001 — classified, then re-raised
        if backend_unavailable(e):
            sys.stderr.write(f"{UNAVAILABLE_MARK} {error_row(e)}\n")
            sys.stderr.flush()
            return 3
        raise
    print(json.dumps(row), flush=True)
    return 0


def serving_measure(device=None, params=None) -> dict:
    """``--serving-fallback``'s row: the gateway in front of the sharded
    serving tier (``ShardedServeBackend`` on a 1x1 mesh) at the
    reference's tiny fp32 config, on ``device`` (None: the card).
    ``params`` defaults to ``init_params`` under a generator seeded
    with 0."""

    def _int_env(name: str, default: int) -> int:
        raw = os.environ.get(name)
        if not raw:
            return default
        try:
            v = int(raw)
        except ValueError:
            raise SystemExit(f"{name} must be an int: {raw!r}")
        if v < 1:
            raise SystemExit(f"{name} must be >= 1: {v}")
        return v

    requests = _int_env("PBST_BENCH_SERVING_REQUESTS", 32)
    max_new = _int_env("PBST_BENCH_SERVING_MAX_NEW", 8)
    slots = _int_env("PBST_BENCH_SERVING_SLOTS", 4)
    _mark("importing torch")
    import numpy as np
    import torch

    from pbs_tpu_torch.gateway import Gateway, TenantQuota
    from pbs_tpu_torch.models import TransformerConfig, init_params
    from pbs_tpu_torch.models.transformer import resolve_device
    from pbs_tpu_torch.perf import native_info
    from pbs_tpu_torch.serve import ShardedServeBackend

    dev = resolve_device(device)
    cfg = TransformerConfig(
        vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq=128, dtype=torch.float32)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    backend = ShardedServeBackend(
        "engine", cfg, params, tp=1, dp=1, n_slots=slots,
        prompt_bucket=16, max_len=64, device=dev)
    eng = backend.engine
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 128, size=6)) for _ in range(4)]
    # Warm-up directly on the engine, before the gateway exists: its
    # first calls must not land in the gateway's latency histograms.
    _mark("warmup decode (compiles)")
    eng.submit(prompts[0], 2)
    while eng.has_work():
        eng.step()
    gw = Gateway(
        [backend],
        quotas={"bench": TenantQuota(rate=1e9, burst=1e9,
                                     slo="interactive",
                                     max_queued=max(64, requests))})
    _mark(f"timing {requests} requests x {max_new} tokens")
    t0 = time.perf_counter()
    shed = 0
    for i in range(requests):
        r = gw.submit("bench", {"prompt": prompts[i % len(prompts)],
                                "max_new": max_new})
        if not r.admitted:
            shed += 1
    done = []
    while gw.busy():
        done += gw.tick()
    dt = time.perf_counter() - t0
    tokens = sum(i.get("tokens", 0) for _, i in done)
    toks_per_s = tokens / dt if dt > 0 else 0.0
    nat = native_info()
    return {
        "metric": "gateway_serving_throughput",
        "value": round(toks_per_s, 1),
        "unit": "tokens/s",
        "vs_baseline": round(toks_per_s / SERVING_BAR_TOKENS_S, 4),
        "native_available": nat["native_available"],
        "native_tier": nat["native_tier"],
        "native_mode": ("native" if nat["native_available"] else "python"),
        "p50_latency_ms": round(
            gw.hist.class_quantile("interactive", "e2e", 0.50) / 1e6, 3),
        "p99_latency_ms": round(
            gw.hist.class_quantile("interactive", "e2e", 0.99) / 1e6, 3),
        "requests": requests,
        "completions": len(done),
        "shed": shed,
        "tokens": int(tokens),
        "device": _device_name(torch, dev),
        "mesh": backend.stats()["mesh"],
        "sharded_param_leaves": backend.stats()["param_leaves"],
        "fallback_from": "flagship_train_throughput",
    }


def _last_stage(err_text: str) -> str:
    marks = [ln.strip() for ln in err_text.splitlines()
             if ln.startswith("[bench ")]
    return marks[-1] if marks else "<no stage reached>"


def _attempt(cmd: list, budgets: dict) -> tuple[str, str, str, int | None]:
    """One worker run: ("ok" | "deadline" | "probe" | "exit", stdout,
    stderr, rc). The child's stdio goes to files, so the stage markers
    written before a deadline survive it."""
    import tempfile

    from pbs_tpu_torch.gateway.supervisor import kill_group

    with tempfile.TemporaryDirectory(prefix="bench-") as d:
        outpath, errpath = (os.path.join(d, n) for n in ("out", "err"))
        with open(outpath, "w") as of, open(errpath, "w") as ef, \
                open(errpath, "rb") as tailf:
            proc = subprocess.Popen(
                cmd, stdout=of, stderr=ef, start_new_session=True,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
            how = "exit"
            try:
                t_start = time.monotonic()
                acquired = False
                tail_buf = b""  # overlap so a marker split across reads hits
                while proc.poll() is None:
                    elapsed = time.monotonic() - t_start
                    if elapsed >= budgets["timeout_s"]:
                        how = "deadline"
                        break
                    if acquired:
                        try:
                            proc.wait(timeout=budgets["timeout_s"] - elapsed)
                        except subprocess.TimeoutExpired:
                            pass
                        continue
                    # Bytes, not text: a torn multi-byte write must not
                    # break the always-one-JSON-line contract.
                    window = tail_buf + tailf.read()
                    tail_buf = window[-64:]
                    if b"backend init:" in window:
                        acquired = True
                        continue
                    if elapsed >= budgets["probe_s"]:
                        how = "probe"
                        break
                    time.sleep(min(1.0, budgets["probe_s"] - elapsed))
            finally:
                if proc.poll() is None:
                    kill_group(proc, KILL_GRACE_S)
        with open(outpath, errors="replace") as f:
            out = f.read()
        with open(errpath, errors="replace") as f:
            err = f.read()
    return how, out, err, proc.returncode


def _error_line(msg: str) -> int:
    print(json.dumps({"metric": "flagship_train_throughput", "value": 0.0,
                      "unit": "tokens/s", "vs_baseline": 0.0,
                      "error": msg}), flush=True)
    return 1


def _supervise(device) -> int:
    """Run the worker in a child under the deadline and print the one
    JSON line; 0 with the worker's line, 1 with an error row."""
    import shlex

    try:
        budgets = seconds_knobs()
    except SystemExit as e:
        return _error_line(str(e))
    # Test seam: a stub worker.
    worker_cmd = os.environ.get("PBST_BENCH_WORKER_CMD")
    cmd = (shlex.split(worker_cmd) if worker_cmd else
           [sys.executable, "-m", "pbs_tpu_torch.drivers.bench", "--worker"]
           + (["--device", device] if device else []))
    last_err = "unknown"
    for attempt in range(2):
        how, out, err, rc = _attempt(cmd, budgets)
        sys.stderr.write(err)
        stage = _last_stage(err)
        if how == "deadline":
            return _error_line(
                f"deadline after {budgets['timeout_s']:.0f}s; last stage: "
                f"{stage} (the worker's process group was killed)")
        if how == "probe":
            return _error_line(
                f"claim-unavailable: no CUDA backend within "
                f"{budgets['probe_s']:.0f}s; last stage: {stage} (the "
                "worker's process group was killed)")
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc == 0 and lines:
            print(lines[-1], flush=True)
            return 0
        unavailable = [ln for ln in err.splitlines()
                       if ln.startswith(UNAVAILABLE_MARK)]
        if unavailable:
            # Every further attempt would fail the same way: no retry.
            return _error_line(
                f"backend unavailable: "
                f"{unavailable[-1][len(UNAVAILABLE_MARK):].strip()}; last "
                f"stage: {stage}")
        tail = (err.strip().splitlines() or ["<no stderr>"])[-1]
        last_err = f"worker rc={rc}: {tail}; last stage: {stage}"
        if attempt == 0:
            time.sleep(budgets["retry_sleep_s"])
    return _error_line(last_err)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="run the measurement in this process")
    ap.add_argument("--serving-fallback", action="store_true",
                    help="measure the gateway serving tier instead")
    ap.add_argument("--device", default=None,
                    help="run here (default: the card; tiny mode: cpu)")
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.device)
    if args.serving_fallback:
        print(json.dumps(serving_measure(
            "cpu" if tiny_mode() and args.device is None else args.device)),
            flush=True)
        return 0
    return _supervise(args.device)


if __name__ == "__main__":
    sys.exit(main())
