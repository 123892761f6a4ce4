"""The research story end to end: three tenants, one card, measured
feedback scheduling.

The port of ``examples/multi_tenant.py``:

    python -m pbs_tpu_torch.examples.multi_tenant [--device cpu]

A training tenant (long memory-bound steps), a latency-sensitive
serving tenant (BOOST on wake), and a *foreign* tenant — a plain torch
callable that knows nothing about the framework — share one device
under the adaptive credit scheduler. The feedback policy reads each
tenant's measured telemetry (``torch.profiler`` sampling for the
foreign one: the HVM vPMU analog, through ``Job.foreign`` under
``CudaBackend``) and adapts per-tenant quanta.
"""

from __future__ import annotations

import sys

TINY = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)


def run(device=None, log=print) -> dict:
    """The three tenants in one partition on ``device`` (None: the
    card). Returns the jobs, the backend and the feedback policy."""
    import torch

    from pbs_tpu_torch.models import (TransformerConfig, forward,
                                      init_params, make_train_step)
    from pbs_tpu_torch.models.transformer import resolve_device
    from pbs_tpu_torch.runtime import Job, Partition, SchedParams
    from pbs_tpu_torch.sched import FeedbackPolicy
    from pbs_tpu_torch.telemetry import Counter, CudaBackend

    dev = resolve_device(device)
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)

    # Tenant 1: training (the bulk workload).
    params = init_params(cfg, gen, device=dev)
    init_opt, train_step = make_train_step(cfg, learning_rate=1e-3)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                           device=dev, dtype=torch.int32)

    def train_fn(state):
        state, m = train_step(state, tokens)
        return state, {"tokens": m["tokens"]}

    train = Job("train", step_fn=train_fn,
                state=(params, init_opt(params), 0),
                params=SchedParams(weight=512), max_steps=40)
    # Cooperative tenants can opt into measured telemetry too: every
    # 4th step runs under the profiler.
    train.profile_every = 4

    # Tenant 2: latency-sensitive serving (BOOST on wake).
    gen_params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    prompt = torch.ones((1, 8), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def serve_fn(served):
        torch.argmax(forward(cfg, gen_params, prompt)[:, -1], dim=-1)
        return served + 1

    serve = Job("serve", step_fn=serve_fn, state=0,
                params=SchedParams(weight=256, tslice_us=100,
                                   boost_on_wake=True), max_steps=30)

    # Tenant 3: a FOREIGN guest — any torch callable, zero protocol.
    n = 192

    def guest_kernel(a, s):
        for _ in range(20):
            a = torch.tanh(a) * s + 0.1
        return a

    guest = Job.foreign("guest", guest_kernel,
                        torch.ones((n, n), device=dev), 0.5,
                        profile_every=2, max_steps=30)

    be = CudaBackend(profile_every=0, device=dev)  # only the per-job overrides sample
    part = Partition("demo", source=be)
    fb = FeedbackPolicy(part)  # default 1 ms metric tick
    for j in (train, serve, guest):
        part.add_job(j)
    part.run()

    log(f"{'tenant':<8} {'steps':>5} {'device_ms':>10} "
        f"{'stall_rate':>10} {'tslice_us':>9}")
    for j in (train, serve, guest):
        dev_ms = sum(int(c.counters[Counter.DEVICE_TIME_NS])
                     for c in j.contexts) / 1e6
        log(f"{j.name:<8} {j.steps_retired():>5} {dev_ms:>10.1f} "
            f"{j.stall_rate:>10.1f} {j.params.tslice_us:>9}")
    m = be.measured("guest")
    if m is not None:
        log(f"\nforeign tenant measured WITHOUT cooperation: "
            f"{m.n_ops} ops sampled, stall_frac={m.stall_frac:.2f} "
            f"(source={m.source})")
    log(f"feedback ticks: {fb.state_of(guest).ticks}")
    return {"jobs": (train, serve, guest), "backend": be, "feedback": fb,
            "guest_measured": m}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run the tenants here (default: the card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
