"""One run of one cell: set-up, the measured window, the metrics, the
correctness check.

The window drives the system's own entry, ``Partition.run(until_ns=)``,
over the cell's jobs on one ``CudaBackend`` under the credit scheduler
with the feedback policy, every job at credit's default weight. An
open loop's requests are armed as partition timers at their due times.
After the window, arrivals have stopped; the partition runs on (the
batch tenant too) until every request due in the window has its first
token and the training tenant's first steps, which the check compares,
have retired, or the traffic's cap passes. Then the program's state is freed
and the reference checks what the timed path produced.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import arrivals, check, spec, tenants
from benchmark import weights as W
from benchmark.devtrace import Session, summarize
from benchmark.tenants import Spans, now_ns

RING_DRAIN_NS = 50_000_000


class Run:
    """What one run recorded; the metric readers take it whole."""

    def __init__(self, bench, workload, cfg, mix, seed, seconds, traced,
                 device):
        self.bench, self.workload, self.cfg, self.mix = (bench, workload,
                                                         cfg, mix)
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = device
        self.kind = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        self.serve = None
        self.batch = None
        self.ring: list = []
        self.trace = None
        self.readings: dict[str, float] = {}


def run_cell(bench: dict, workload_name: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             cfg_override: dict | None = None,
             mix_override: dict | None = None, check_output: bool = True,
             control: bool = False) -> tuple[dict, Run]:
    """Run one cell once. Returns (the result line, the run's record).
    ``cfg_override`` / ``mix_override`` replace the named files (the CPU
    rehearsals pass tiny ones). ``check_output=False`` skips the
    reference (the rate sweep); ``control=True`` also reads every number
    with the float8 reference in the program's place, into
    ``run.control``."""
    t_start = time.monotonic() if t_start is None else t_start
    device = torch.device(device)
    wl = spec.workload(bench, workload_name)
    cfg = cfg_override or spec.config(wl["config"])
    mix = mix_override or spec.traffic(wl["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(bench, wl, cfg, mix, seed, seconds, traced, device)
    spans = Spans(traced)

    # -- set-up ---------------------------------------------------------
    from pbs_tpu_torch.runtime import Partition
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import CudaBackend

    roles = mix["tenants"]
    batch_spec = roles["batch"]
    if device.type == "cuda" and any(
            t.get("attn_impl") == "pallas" for t in roles.values()):
        from pbs_tpu_torch.ops import cuda_build

        cuda_build.build(("flash_fwd", "flash_bwd"))
    part = Partition("bench", source=CudaBackend(device=device),
                     scheduler="credit")
    fb = FeedbackPolicy(part)
    shared = None
    if "serve" in roles or batch_spec["kind"] == "score":
        shared = W.make_tree(cfg, seed, "serve",
                             getattr(torch, cfg["torch_dtype"]), device)
    if batch_spec["kind"] == "train":
        run.batch = tenants.TrainTenant(cfg, batch_spec, seed, spans, device)
    else:
        run.batch = tenants.ScoreTenant(cfg, batch_spec, shared, seed, spans,
                                        device)
    run.batch.warm()
    part.add_job(run.batch.job)
    reqs = []
    if "serve" in roles:
        sspec = roles["serve"]
        run.serve = tenants.ServeTenant(cfg, sspec, shared, part, fb, spans,
                                        seed, device)
        part.add_job(run.serve.job)
        part.sleep_job(run.serve.job, notify=False)
        reqs = arrivals.open_loop(sspec, mix["rate_per_s"], seconds, seed,
                                  cfg["vocab_size"])
    ring = part.traces[0]
    ring.consume(1 << 16)

    def drain_ring(_now=None):
        recs = ring.consume(1 << 16)
        if len(recs):
            run.ring.append(recs)

    session = Session(device) if traced and device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if session is not None:
        session.start()

    # -- the window -----------------------------------------------------
    t0 = now_ns()
    setup_s = time.monotonic() - t_start
    t_end = t0 + int(seconds * 1e9)
    if run.serve is not None:
        run.serve.arm(reqs, t0)
    part.timers.arm(t0 + RING_DRAIN_NS, drain_ring, period_ns=RING_DRAIN_NS,
                    name="bench_ring")
    run.ledger0 = _ledger(part)
    part.run(until_ns=t_end)
    run.ledger1 = _ledger(part)
    t_closed = now_ns()
    if session is not None:
        session.stop()
    # every request due in the window gets its first token, the check
    # has finished requests to sample and the training steps it compares
    # have retired, or the cap passes
    wait = [roles["serve"]["drain_cap_s"]] if run.serve is not None else []
    need = 0
    if check_output and run.serve is not None:
        need = roles["serve"]["check"]["requests"]
    train_check = check_output and batch_spec["kind"] == "train"
    if train_check:
        wait.append(batch_spec["check"]["wait_s"])
    cap = t_end + int(max(wait, default=0) * 1e9)

    def waiting() -> bool:
        if run.serve is not None and (run.serve.pending_first(t_end)
                                      or run.serve.finished() < need):
            return True
        return train_check and run.batch.first_steps() is None

    while waiting() and now_ns() < cap:
        part.run(max_rounds=1)
    drain_ring()
    run.t0, run.t_end, run.t_closed, run.t_drained = (t0, t_end, t_closed,
                                                      now_ns())
    run.setup_s = setup_s
    run.serve_slot = (run.serve.job.contexts[0].ledger_slot
                      if run.serve is not None else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(device))
    else:
        run.memory_peak = 0
    if session is not None:
        kernels, sp = session.events()
        run.trace = summarize(kernels, sp, t0, t_closed)
        del session, kernels, sp

    # -- metrics ----------------------------------------------------------
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, workload_name, section):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device.type != "cuda":
        # a host rehearsal: its numbers are no device metric's
        run.host_values, metrics = metrics, {}

    run.backlog = backlog(run) if run.serve is not None else None

    # -- free the program's state, then the reference ---------------------
    batch_kind = batch_spec["kind"]
    score_tenant = run.batch if batch_kind == "score" else None
    answers = dict(score_tenant.answers) if score_tenant else {}
    batch_steps = list(run.batch.steps)
    train_rows = run.batch.rows
    first = run.batch.first_steps() if batch_kind == "train" else None
    served = run.serve.requests if run.serve is not None else []
    part.remove_job(run.batch.job)
    if run.serve is not None:
        part.remove_job(run.serve.job)
    run.batch.job.state = None
    run.serve = run.batch = None
    del part, fb
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings, run.control = {}, {}
    if served and check_output:
        sample = check.sample_finished(
            served, seed, roles["serve"]["check"]["requests"])
        got, run.served_compared = check.serve_gaps(cfg, shared, sample,
                                                    device)
        readings.update(got)
        if control:
            run.control.update(check.serve_gaps(cfg, shared, sample, device,
                                                control=True)[0])
    if batch_kind == "score" and check_output:
        in_window = [i for i, (a, b, _) in enumerate(batch_steps)
                     if t0 <= b <= t_end]
        rng = np.random.default_rng([int(seed), 0x5C0E])
        n = min(batch_spec["check"]["steps"], len(in_window))
        steps = sorted(rng.choice(in_window, size=n, replace=False).tolist())
        score_tenant.answers = answers
        readings.update(check.score_gaps(cfg, shared, score_tenant, steps,
                                         device))
        if control:
            run.control.update(check.score_gaps(
                cfg, shared, score_tenant, steps, device, control=True))
    if batch_kind == "train" and check_output:
        n = batch_spec["check"]["steps"]
        ref = check.reference_train(cfg, batch_spec, seed, n, train_rows,
                                    device)
        if first is not None:
            readings.update(check.train_gaps(first, ref))
        if control:
            low = check.reference_train(cfg, batch_spec, seed, n,
                                        train_rows, device, prec="fp8")
            run.control.update(check.train_gaps(low, ref))
    run.readings = readings

    limits = spec.limits(workload_name)
    # the numbers compared are those the cell's limits name (all of the
    # readings while it has none yet)
    checks = {k: {"value": readings.get(k), "limit": limits.get(k)}
              for k in (limits or readings)}
    correct = bool(checks) and all(
        c["limit"] is not None and c["value"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    attempted, failed = _attempts(run, served, batch_steps)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device(run),
    }
    if traced and run.trace is not None:
        result["breakdown"] = _breakdown(run.trace)
    result["checks"] = checks
    return result, run


def backlog(run) -> dict:
    """How the open loop's queue moved through the window: requests due
    and without a first token at the close, and the median time to first
    token of those due in the first and in the last third."""
    from benchmark.readers import due_requests, nearest_rank

    due = due_requests(run)
    third = (run.t_end - run.t0) / 3

    def med(rs):
        v = nearest_rank([(r["first_ns"] or run.t_drained) - r["due_ns"]
                          for r in rs], 0.5)
        return None if v is None else v / 1e6

    return {"due": len(due),
            "waiting_at_close": sum(1 for r in due if r["first_ns"] is None
                                    or r["first_ns"] > run.t_end),
            "ttft_p50_ms_first_third": med(
                [r for r in due if r["due_ns"] < run.t0 + third]),
            "ttft_p50_ms_last_third": med(
                [r for r in due if r["due_ns"] >= run.t0 + 2 * third])}


def _ledger(part) -> dict:
    return {j.name: j.contexts[0].counters.copy() for j in part.jobs}


def _attempts(run, served, batch_steps) -> tuple[int, int]:
    if served:
        due = [r for r in served if r["due_ns"] < run.t_end]
        return len(due), sum(1 for r in due if r["first_ns"] is None)
    steps = [s for s in batch_steps if run.t0 <= s[1] <= run.t_end]
    return len(steps), 0


def _device(run) -> dict:
    out = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": run.kind, "count": 1,
           "memory_peak_bytes": run.memory_peak}
    if run.trace is not None:
        out["busy_s"] = run.trace["busy_ns"] / 1e9
        out["window_s"] = run.trace["window_ns"] / 1e9
    return out


def _breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], v[1] / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps]}
