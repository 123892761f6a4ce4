"""Whether what the timed path produced is correct: the comparison with
the plain reference.

Each number compared is a reading of a gap between the program and the
reference (or between the control, the reference in float8, and the
reference); ``limits/<workload>.json`` holds each number's limit.

- ``serve_gap``: over a sample of finished requests drawn from the seed
  (the longest among them), the widest gap by which a served token's
  logit lies below the reference's best at its position, the reference
  run once over each prompt with its served tokens.
- ``score_gap``: over a sample of scoring steps from the window, the
  widest gap between a row's next-token log-likelihood and the
  reference's.
- ``train_loss_gap``: the widest gap between a step's loss and the
  reference's, over the first steps.
- ``train_grad_gap``: the first gradient's norm as AdamW holds it, by
  leaf: the worst leaf's gap to the reference's norm, over the larger
  of that leaf's and the median leaf's reference norm.
- ``train_change_gap``: the same for each leaf's change over the first
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights as W
from benchmark.reference import model as R

#: Leaves whose first reference gradient is under this share of the
#: median leaf's are left out of the change.
NOUGHT_GRAD = 1e-3


def sample_finished(requests: list[dict], seed: int, n: int) -> list[dict]:
    done = [r for r in requests if r["tokens"]]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["tokens"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _positions(cfg, weights, req, device, prec):
    """The reference's logits at the positions that produced each served
    token (prec "fp32"), or those of ``prec`` beside them."""
    toks = np.concatenate([req["prompt"], np.asarray(req["tokens"][:-1])])
    seq = torch.tensor(toks, dtype=torch.long, device=device)[None]
    plen = len(req["prompt"])
    with torch.no_grad():
        logits = R.forward(cfg, weights, seq, prec)[0]
    return logits[plen - 1:]


def _stats(prefix: str, gaps: torch.Tensor) -> dict:
    """The widest gap under ``prefix`` and, beside it, the steadier
    statistics of the same gaps (an MoE's routing flips at near-ties
    put a tail on them that the median and the mean ride out)."""
    g = gaps.float().flatten()
    return {prefix: float(g.max()), prefix + "_mean": float(g.mean()),
            prefix + "_median": float(g.median())}


def serve_gaps(cfg: dict, weights: dict, sample: list[dict], device,
               control: bool = False) -> tuple[dict, int]:
    """(the gaps' statistics, tokens compared). With ``control``, the
    token judged at each position is the one the float8 reference puts
    first."""
    gaps = []
    for req in sample:
        ref = _positions(cfg, weights, req, device, "fp32")
        if control:
            low = _positions(cfg, weights, req, device, "fp8")
            toks = low.argmax(dim=-1)
            del low
        else:
            toks = torch.tensor(req["tokens"], device=device)
        gaps.append(ref.max(dim=-1).values
                    - ref.gather(-1, toks[:, None])[:, 0])
        del ref
    g = torch.cat(gaps)
    return _stats("serve_gap", g), int(g.numel())


def score_gaps(cfg: dict, weights: dict, tenant, steps: list[int], device,
               control: bool = False) -> dict:
    gaps = []
    for j in steps:
        rows = tenant.rows(j)
        ref = R.token_logprobs(cfg, weights, rows, "fp32")
        got = (R.token_logprobs(cfg, weights, rows, "fp8") if control
               else tenant.answers[j].float())
        gaps.append((got - ref).abs().flatten())
    return _stats("score_gap", torch.cat(gaps)) if gaps else {}


def reference_train(cfg: dict, spec: dict, seed: int, n_steps: int,
                    rows, device, prec: str = "fp32") -> dict:
    """The reference's first ``n_steps`` steps from the same first
    weights (made again from the seed) and the same micro-batches
    (``rows(i)``): losses, the first gradient's norms and each leaf's
    change, by leaf name."""
    weights = W.make_tree(cfg, seed, "train", torch.float32, device)
    named = dict(R.leaves(weights))
    opt = spec["optimizer"]
    adam = R.AdamW(spec["learning_rate"], opt["b1"], opt["b2"], opt["eps"],
                   opt["weight_decay"])
    K = spec["micro_per_step"]
    losses, grad_norms = [], {}
    for s in range(n_steps):
        micro = [rows(s * K + k) for k in range(K)]
        step_losses, grads = R.grads_of(cfg, weights, micro, prec)
        losses.append(sum(step_losses) / K)
        if s == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g))
                          for n, g in grads.items()}
        adam.step(named, grads)
        del grads
    change = {n: float(torch.linalg.vector_norm(
        named[n] - W.make_leaf(cfg, n, seed, "train", torch.float32, device)))
        for n in named}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _worst_leaf(got: dict, ref: dict, leaves: list[str]) -> float:
    med = float(np.median([ref[n] for n in leaves]))
    return max(abs(got[n] - ref[n]) / max(ref[n], med) for n in leaves)


def train_gaps(got: dict, ref: dict) -> dict:
    grad_med = float(np.median(list(ref["grad_norms"].values())))
    moving = [n for n, g in ref["grad_norms"].items()
              if g >= NOUGHT_GRAD * grad_med]
    return {
        "train_loss_gap": max(abs(a - b) for a, b in zip(got["losses"],
                                                          ref["losses"])),
        "train_grad_gap": _worst_leaf(got["grad_norms"], ref["grad_norms"],
                                      list(ref["grad_norms"])),
        "train_change_gap": _worst_leaf(got["change_norms"],
                                        ref["change_norms"], moving),
    }
