"""Driver entry points: a one-card compile check and a multi-rank dry run.

The port of ``__graft_entry__.py``.

- ``entry()`` returns the flagship transformer's forward and example
  args (params from a seeded ``torch.Generator``, zero tokens (4, 256)),
  on the card unless ``device`` says otherwise.
- ``dryrun_multichip(n)`` runs ONE full training step (forward,
  backward, AdamW) of each of the reference's eleven parallel schedules
  on tiny shapes over ``n`` gloo rank processes on the host's CPU
  (``parallel.launch.RankPool``): the port's stand-in for the
  reference's n-device virtual CPU mesh. Like the reference it never
  touches the card.

    python -m pbs_tpu_torch.drivers.graft_entry [--device cpu] [--ranks 8]
"""

from __future__ import annotations

import functools
import os
import time


def _flagship_cfg(tiny: bool = False):
    import torch

    from pbs_tpu_torch.models import TransformerConfig

    if tiny:
        return TransformerConfig(
            vocab=256, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=256, max_seq=128, dtype=torch.float32,
        )
    # ~700M params: d_model 2048, GQA 16/8, SwiGLU, bf16, remat("dots").
    # The reference's roofline-motivated starting point; bench_sweep
    # measures the remat x batch x attention choice on the card.
    return TransformerConfig(
        vocab=32_768, d_model=2048, n_layers=12, n_heads=16, n_kv_heads=8,
        d_ff=5_632, max_seq=1024, dtype=torch.bfloat16,
        remat=True, remat_policy="dots",
    )


def entry(device=None, tiny: bool = False):
    """(fn, example_args): the flagship forward and (params, tokens) on
    ``device`` (None means the card, and raises without one). ``tiny``
    takes the dry run's config instead of the flagship's."""
    import torch

    from pbs_tpu_torch.models import forward, init_params
    from pbs_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    cfg = _flagship_cfg(tiny)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    tokens = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    fn = torch.no_grad()(functools.partial(forward, cfg))
    return fn, (params, tokens)


# -- dryrun_multichip ---------------------------------------------------------

#: Token columns of every schedule's all-zero rows, as in the reference.
DRYRUN_SEQ = 64
#: The rank body, by module path (the module may run as ``__main__``).
RANK_TASK = "pbs_tpu_torch.drivers.graft_entry:rank_schedule"
#: Loss parity across schedules: |loss - dp x tp loss| < this x max(1, |loss|).
DRYRUN_PARITY = 5e-3


def _moe_fields(ep: int) -> dict:
    return dict(vocab=256, d_model=128, n_layers=2, n_heads=8,
                n_kv_heads=4, d_ff=192, max_seq=128,
                n_experts=max(ep, 4), top_k=2)


def dryrun_schedules(n_devices: int) -> list[dict]:
    """The reference's eleven schedules on ``n_devices`` ranks, in its
    order: each a dict of ``name`` (the budget's name, None for a core
    schedule), ``label`` (its part of the OK line), ``family`` ("dense",
    "moe", "pipe", "pipe_moe"), the config ``fields``, mesh ``axes``,
    token ``rows``, ``parity`` (held to the dp x tp loss) and ``drops``
    (must report no drop), or None where the reference skips it for
    ``n_devices`` (an odd count, or one not divisible by 8)."""
    n = n_devices

    def _factor(pref: int) -> int:
        for f in (pref, 4, 2):
            if f <= n and n % f == 0:
                return f
        return 1

    tiny = dict(vocab=256, d_model=128, n_layers=2, n_heads=8,
                n_kv_heads=4, d_ff=256, max_seq=128)
    tp = _factor(4)
    dp = n // tp
    ep = _factor(4)
    dp3 = n // ep
    sp = _factor(4)
    dp4 = n // sp
    moe = _moe_fields(ep)

    def s(name, label, family, fields, axes, rows, parity=True,
          drops=False):
        return dict(name=name, label=label, family=family, fields=fields,
                    axes=axes, rows=rows, parity=parity, drops=drops)

    even, eight = n % 2 == 0, n % 8 == 0
    return [
        # 1) dp x tp (+sp: the residual stream sequence-sharded over tp)
        s(None, f"dp{dp}xtp{tp}(sp)", "dense", tiny,
          {"dp": dp, "tp": tp}, 2 * dp, parity=False),
        # 2) dp x pp: the GPipe schedule (2 layers -> pp=2)
        s(None, f"dp{n // 2}xpp2", "pipe", tiny,
          {"dp": n // 2, "pp": 2}, 2 * (n // 2)) if even else None,
        # 3) MoE dp x ep: token all-to-all dispatch
        s(None, f"dp{dp3}xep{ep}", "moe", moe, {"dp": dp3, "ep": ep},
          2 * dp3, parity=False),
        # 4) dp x sp ring attention, with the chunked loss tail
        s(None, f"dp{dp4}xsp{sp}(ring)", "dense",
          dict(tiny, attn_impl="ring", loss_chunks=4),
          {"dp": dp4, "sp": sp}, 2 * dp4),
        # 5) dp x sp Ulysses: all-to-all head scatter
        s("dp x sp ulysses", f"dp{dp4}xsp{sp}(ulysses)", "dense",
          dict(tiny, attn_impl="ulysses"), {"dp": dp4, "sp": sp}, 2 * dp4),
        # 6) dp x tp x sp: Megatron tp and the ring under one mesh
        s("dp x tp x sp", f"dp{n // 4}xtp2xsp2(ring,3d)", "dense",
          dict(tiny, attn_impl="ring"),
          {"dp": n // 4, "tp": 2, "sp": 2}, 2 * (n // 4)) if eight else None,
        # 7) dp x pp x tp: tp's sums inside the pipeline's stages
        s("dp x pp x tp", f"dp{n // 4}xpp2xtp2", "pipe", tiny,
          {"dp": n // 4, "pp": 2, "tp": 2}, 2 * (n // 4)) if eight else None,
        # 8) dp x pp x ep: the dropless MoE through the pipeline
        s("dp x pp x ep (moe)", f"dp{n // 4}xpp2xep2(moe)", "pipe_moe",
          dict(moe, n_experts=4, dropless=True, router_group_size=63),
          {"dp": n // 4, "pp": 2, "ep": 2}, 2 * (n // 4), parity=False,
          drops=True) if eight else None,
        # 9) dp x pp x sp: the ring inside the pipeline's stages
        s("dp x pp x sp (ring)", f"dp{n // 4}xpp2xsp2(ring-in-pipe)", "pipe",
          dict(tiny, attn_impl="ring"),
          {"dp": n // 4, "pp": 2, "sp": 2}, 2 * (n // 4)) if eight else None,
        # 10) dp x pp with flash stages: the flash kernels on the card; on
        # CPU ranks their plain versions (the reference's interpreter mode)
        s("dp x pp (flash)", f"dp{n // 2}xpp2(flash)", "pipe",
          dict(tiny, attn_impl="pallas"),
          {"dp": n // 2, "pp": 2}, 2 * (n // 2)) if even else None,
        # 11) pp x ep x sp: the four-axis MoE composition, the ring inside
        # the MoE stages
        s("pp x ep x sp (moe ring)", f"dp{n // 8}xpp2xep2xsp2(moe-ring,4d)",
          "pipe_moe",
          dict(moe, n_experts=4, dropless=True, router_group_size=32,
               attn_impl="ring"),
          {"dp": n // 8, "pp": 2, "ep": 2, "sp": 2}, 2 * (n // 8),
          parity=False, drops=True) if eight else None,
    ]


def rank_schedule(family: str, fields: dict, axes: dict, rows: int) -> dict:
    """One schedule's first training step on this rank (runs inside a
    rank process): the mesh over ``axes`` on the host's CPU, every rank's
    params from ``init_params`` seeded 0 (so all schedules start from one
    tree), all-zero token rows (``rows``, 64) sharded as the schedule
    shards its batch. Returns the global metrics (every rank holds
    them)."""
    import torch

    from pbs_tpu_torch import parallel
    from pbs_tpu_torch.parallel import pipeline

    if family in ("moe", "pipe_moe"):
        from pbs_tpu_torch.models.moe import MoEConfig

        cfg = MoEConfig(**fields, dtype=torch.float32)
    else:
        from pbs_tpu_torch.models import TransformerConfig

        cfg = TransformerConfig(**fields, dtype=torch.float32)
    mesh = parallel.make_mesh(axes, device="cpu")
    if family == "dense":
        state, step = parallel.make_sharded_train(cfg, mesh, 1e-3, key=0)
        sharding = parallel.batch_sharding(mesh)
    elif family == "moe":
        state, step = parallel.make_sharded_moe_train(cfg, mesh, 1e-3, key=0)
        sharding = parallel.moe_batch_sharding(mesh)
    else:
        make = (pipeline.make_pipelined_moe_train if family == "pipe_moe"
                else pipeline.make_pipelined_train)
        state, step = make(cfg, mesh, n_micro=2, learning_rate=1e-3, key=0)
        sharding = pipeline.pipeline_batch_sharding(mesh)
    tokens = torch.zeros((rows, DRYRUN_SEQ), dtype=torch.int32)
    _, metrics = step(state, sharding.shard(tokens))
    return {k: float(v) for k, v in metrics.items()}


def _budget_s(budget_s: float | None) -> float:
    if budget_s is not None:
        return float(budget_s)
    try:
        return float(os.environ.get("PBST_DRYRUN_BUDGET_S", "480"))
    except ValueError:
        raise SystemExit("PBST_DRYRUN_BUDGET_S must be a number (seconds)")


def dryrun_multichip(n_devices: int, budget_s: float | None = None) -> dict:
    """Run one training step of each parallelism family on ``n_devices``
    gloo rank processes on the host's CPU: (1) dense dp x tp with
    sequence parallelism riding tp, (2) dense dp x pp microbatch
    pipeline, (3) MoE dp x ep all-to-all, (4) dense dp x sp ring
    attention, then the extended compositions (5)-(11).

    Assertions are parity-grade, as in the reference: the dense
    schedules run one model from one init on all-identical token rows,
    so their step-0 losses must agree with the dp x tp loss within
    5e-3 x max(1, |loss|); the MoE schedules must be finite and the
    dropless pipelines report no drop.

    Wall budget: the four CORE schedules always run; each EXTENDED
    schedule first checks the elapsed time against
    ``PBST_DRYRUN_BUDGET_S`` (default 480 s; ``budget_s`` overrides it)
    and is skipped, named in the printed notice, once it is spent.
    ``PBST_DRYRUN_BUDGET_S=0`` forces the core subset. Prints one
    ``dryrun_multichip OK: ...`` line; returns each schedule's loss by
    label and the skipped names."""
    from pbs_tpu_torch.parallel.launch import RankPool

    t0 = time.monotonic()
    budget = _budget_s(budget_s)
    skipped: list[str] = []
    losses: dict[str, float] = {}
    loss_tp = None
    with RankPool(n_devices, backend="gloo", device="cpu") as pool:
        for sched in dryrun_schedules(n_devices):
            if sched is None:
                continue
            if sched["name"] is not None and time.monotonic() - t0 >= budget:
                skipped.append(sched["name"])
                continue
            m = pool.run(RANK_TASK, sched["family"],
                         sched["fields"], sched["axes"], sched["rows"])[0]
            loss = m["loss"]
            label = sched["label"]
            assert loss == loss and abs(loss) != float("inf"), (
                f"non-finite loss in {label} dryrun")
            if loss_tp is None:
                loss_tp = loss
            if sched["parity"]:
                assert abs(loss - loss_tp) < DRYRUN_PARITY * max(
                    1.0, abs(loss_tp)), f"{label} loss {loss} != tp loss {loss_tp}"
            if sched["drops"]:
                assert abs(m["moe_drop_frac"]) < 1e-6, (
                    f"dropless MoE {label} reported drops")
            losses[label] = loss
    parts = [f"{label} loss={loss:.4f}" for label, loss in losses.items()]
    if n_devices % 2:
        parts.insert(1, "pp skipped (odd n)")
    line = ("dryrun_multichip OK: " + "; ".join(parts)
            + (f"; SKIPPED over {budget:.0f}s budget: " + ", ".join(skipped)
               if skipped else "")
            + f" [{time.monotonic() - t0:.0f}s]")
    print(line, flush=True)
    return {"losses": losses, "skipped": skipped, "line": line}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="run entry()'s forward here (default: the card)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="rank processes of the dry run (default 8)")
    args = ap.parse_args(argv)
    fn, fargs = entry(device=args.device)
    out = fn(*fargs)
    print("entry OK:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(args.ranks)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
