"""End-to-end training from raw text on the card.

The port of ``examples/train_from_text.py``:

    python -m pbs_tpu_torch.examples.train_from_text [path/to/text.txt]
        [--device cpu] [--workdir DIR]

Byte-level tokens (no external tokenizer), a packed corpus, prefetched
batches, the train step with remat "dots", a checkpoint at the end
(``ckpt.save_checkpoint``, readable by either package). bf16 compute on
the card, fp32 on the host.
"""

from __future__ import annotations

import os
import sys
import tempfile

BATCH, SEQ, STEPS = 4, 128, 30
TEXT = ["The credit scheduler multiplexes tenants over step quanta; "
        "telemetry feeds the slice. "] * 200


def run(device=None, text_path: str | None = None,
        workdir: str | None = None, log=print) -> dict:
    """Train STEPS steps on ``device`` (None: the card). Returns the
    losses by step, the checkpoint's path and the final params."""
    import torch

    from pbs_tpu_torch.ckpt import save_checkpoint
    from pbs_tpu_torch.data import (VOCAB, Prefetcher, ShardedBatchSource,
                                    TokenDataset, corpus_from_file,
                                    corpus_from_text)
    from pbs_tpu_torch.models import (TransformerConfig, init_params,
                                      make_train_step)
    from pbs_tpu_torch.models.transformer import resolve_device, tree_map

    dev = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="pbst_example_")
    corpus = os.path.join(workdir, "corpus.tok")
    if text_path is not None:
        n = corpus_from_file(corpus, text_path)
    else:
        n = corpus_from_text(corpus, TEXT)
    log(f"corpus: {n} byte-tokens")

    cfg = TransformerConfig(
        vocab=VOCAB, d_model=128, n_layers=4, n_heads=8, n_kv_heads=4,
        d_ff=256, max_seq=SEQ,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        remat=True, remat_policy="dots")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    init_opt, step = make_train_step(cfg, learning_rate=3e-3)
    state = (params, init_opt(params), 0)

    ds = TokenDataset(corpus)
    # ShardedBatchSource: on a multi-host pod each host would pass its
    # own host_id/n_hosts and draw its disjoint slice of one global
    # schedule; the cursor rides the checkpoint so a restore resumes
    # the exact data position on every host.
    src = ShardedBatchSource(ds, global_batch=BATCH, seq_len=SEQ,
                             host_id=0, n_hosts=1, seed=0)
    losses = {}
    with Prefetcher(src, depth=2, device=dev) as pf:
        for i in range(STEPS):
            state, m = step(state, next(pf))
            if i % 10 == 0 or i == STEPS - 1:
                losses[i] = float(m["loss"])
                log(f"step {i:3d}  loss {losses[i]:.3f}")
    ckpt = os.path.join(workdir, "ckpt")
    # Cursor from the CONSUMED count (one batch per step), not the
    # producer counter: the prefetcher sources ahead by a thread-
    # timing-dependent amount, which would desync hosts on restore.
    cursor = dict(src.state(), step=STEPS)
    host_params = tree_map(lambda t: t.detach().cpu(), state[0])
    save_checkpoint(ckpt, host_params,
                    metadata={"steps": STEPS, "data_cursor": cursor})
    log(f"checkpoint: {ckpt}  (pbst-torch ckpt-info / pbst-torch quantize)")
    ds.close()
    return {"losses": losses, "ckpt": ckpt, "params": host_params,
            "workdir": workdir}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("text", nargs="?", default=None,
                    help="a text file to train on (default: a built-in line)")
    ap.add_argument("--device", default=None,
                    help="train here (default: the card)")
    ap.add_argument("--workdir", default=None,
                    help="corpus and checkpoint directory (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)
    run(args.device, args.text, args.workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
