"""The serving stack in one script: continuous batching with prefix
caching, int8 quantization, and speculative decoding, on one model.

The port of ``examples/serving_stack.py``:

    python -m pbs_tpu_torch.examples.serving_stack [--device cpu]
"""

# pbst: ignore-file[gw-direct-submit] -- the walkthrough shows the engine itself, below the gateway that fronts it in deployment (the reference's copy lives outside its package's scan)

from __future__ import annotations

import sys

SYSTEM = "You are a scheduler. "
QUESTIONS = ("tell me a story", "what is a tpu?")


def config():
    import torch

    from pbs_tpu_torch.data import VOCAB
    from pbs_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab=VOCAB, d_model=128, n_layers=4, n_heads=8, n_kv_heads=4,
        d_ff=256, max_seq=256, dtype=torch.float32)


def run(device=None, log=print) -> dict:
    """The walkthrough on ``device`` (None: the card). Returns the fp32
    params, the speculative engine's prompts and completions by prompt,
    and each part's stats."""
    import torch

    from pbs_tpu_torch.data import decode_tokens, encode_text
    from pbs_tpu_torch.models import (ContinuousBatcher, MoEConfig,
                                      SpeculativeBatcher, init_moe_params,
                                      init_params, make_speculative_generate,
                                      quantize_weights, quantized_nbytes)
    from pbs_tpu_torch.models.moe import moe_slot_mlp
    from pbs_tpu_torch.models.transformer import resolve_device

    dev = resolve_device(device)
    cfg = config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)

    # int8 weight-only: the serving copy at ~1/4 the bytes.
    qp = quantize_weights(params)
    log(f"params: {quantized_nbytes(params) / 1e6:.1f} MB fp32 -> "
        f"{quantized_nbytes(qp) / 1e6:.1f} MB int8")

    # Continuous batching + exact-prompt prefix cache.
    eng = ContinuousBatcher(cfg, qp, n_slots=4, prompt_bucket=32,
                            max_len=96, prefix_cache_size=8, device=dev)
    for _ in range(6):
        eng.submit(encode_text(SYSTEM, add_eos=False), max_new_tokens=12)
    done = []
    while eng.has_work():
        done += eng.step()
    st = eng.stats()
    log(f"served {st['completed']} requests; prefix hits "
        f"{st['prefix_hits']}/{st['prefix_hits'] + st['prefix_misses']}; "
        f"ttft_p50 {st['ttft_p50_s'] * 1e3:.1f} ms")
    log(f"sample: {repr(decode_tokens(done[0].tokens))[:60]}")

    # Speculative decoding (greedy token-exact). Untrained random
    # models disagree almost always, so for the demo the target drafts
    # for itself — the 100% ceiling; a real deployment pairs a small
    # trained draft with a large target and lands in between.
    spec = make_speculative_generate(cfg, cfg, 16, k=4)
    prompt = torch.as_tensor(encode_text(SYSTEM, add_eos=False),
                             dtype=torch.int32, device=dev)[None, :]
    _, stats = spec(params, params, prompt)
    acc, prop = int(stats["accepted"]), int(stats["proposed"])
    log(f"speculative (self-draft ceiling): {int(stats['rounds'])} "
        f"rounds, acceptance {acc}/{prop} = {acc / max(prop, 1):.0%}")

    # The two composed: speculative CONTINUOUS batching — draft
    # propose-k + one-forward verify per engine tick, each slot
    # advancing by its own acceptance; token-identical to the plain
    # engine, ~acceptance-rate fewer ticks.
    seng = SpeculativeBatcher(cfg, params, cfg, params, k=4, n_slots=2,
                              prompt_bucket=64, max_len=128, device=dev)
    prompts = [encode_text(SYSTEM + q, add_eos=False) for q in QUESTIONS]
    rid_of = {seng.submit(p, max_new_tokens=12): i
              for i, p in enumerate(prompts)}
    spec_tokens = {}
    while seng.has_work():
        for c in seng.step():
            spec_tokens[rid_of[c.request_id]] = [int(t) for t in c.tokens]
    sst = seng.stats()
    log(f"speculative serving: {sst['completed']} requests in "
        f"{sst['steps']} engine ticks, acceptance "
        f"{sst['spec_acceptance']:.0%}")

    # The second model family through the SAME engine: MoE serving via
    # the shared FFN seam, with router drop telemetry in the stats.
    mcfg = MoEConfig(vocab=cfg.vocab, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=96, max_seq=128, dtype=cfg.dtype,
                     n_experts=4, top_k=2, capacity_factor=4.0)
    mparams = init_moe_params(mcfg, torch.Generator(device=dev)
                              .manual_seed(3), device=dev)
    meng = ContinuousBatcher(mcfg, mparams, n_slots=2, prompt_bucket=64,
                             max_len=128, mlp_fn=moe_slot_mlp(mcfg),
                             device=dev)
    meng.submit(encode_text(SYSTEM, add_eos=False), max_new_tokens=8)
    while meng.has_work():
        meng.step()
    mst = meng.stats()
    log(f"MoE serving: {mst['completed']} request, router drop "
        f"telemetry {mst['mlp_extra_mean']:.3f} (dropless)")
    return {"params": params, "prompts": prompts,
            "spec_tokens": [spec_tokens[i] for i in range(len(prompts))],
            "engine": st, "spec_generate": stats, "spec_engine": sst,
            "moe_engine": mst}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="serve here (default: the card)")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
