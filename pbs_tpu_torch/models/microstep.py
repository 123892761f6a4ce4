"""Gradient-accumulation micro-steps: chunked long steps for latency.

The port of ``pbs_tpu.models.microstep``. A device cannot be preempted
mid-kernel, so a tenant whose step takes a second makes a 100 us time
slice meaningless: the quantum floor is one step. The answer is
cooperative decomposition: split the optimizer step into K
micro-batches, return to the host between them, and let the executor
deschedule at any chunk boundary (``Job(micro_step_fn=...,
micro_per_step=K)``, dispatched by ``CudaBackend.execute_micro``).

Math contract: K micro-steps over micro-batches b_1..b_K with averaged
accumulated gradients are exactly one full-batch step over
concat(b_1..b_K) (equal micro-batch sizes: the mean of means is the
global mean, so AdamW sees the same gradients).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pbs_tpu_torch.models.transformer import (
    TransformerConfig,
    default_optimizer,
    loss_and_grads,
    tree_leaves,
    tree_map,
)
from pbs_tpu_torch.obs import phases


def make_micro_train_step(
    cfg: TransformerConfig,
    n_micro: int,
    learning_rate: float = 3e-4,
    next_batch: Callable[[int], Any] | None = None,
):
    """Returns ``(init_state, micro_step)``.

    - ``init_state(params) -> state``, the dict ``params/opt/acc/micro/
      step``;
    - ``micro_step(state) -> (state, {"loss", "tokens"})`` processes ONE
      micro-batch; every ``n_micro``-th call applies the AdamW update
      to the mean of the accumulated gradients and retires the
      optimizer step.

    ``next_batch(micro_index) -> tokens`` supplies each micro-batch; it
    lives in the closure, not in the state. The gradient accumulator,
    the params and the moments are updated in place.
    """
    if n_micro < 1:
        raise ValueError("n_micro must be >= 1")
    if next_batch is None:
        raise ValueError("next_batch is required (micro-batch supplier)")
    tx = default_optimizer(learning_rate)

    def init_state(params):
        return {
            "params": params,
            "opt": tx.init(params),
            "acc": tree_map(torch.zeros_like, params),
            "micro": 0,
            "step": 0,
        }

    def micro_step(state):
        with phases.span("train.micro") as sp:
            with phases.span("train.feed"):
                tokens = next_batch(state["micro"])
            ntok = tokens.shape[0] * (tokens.shape[1] - 1)
            sp.count = ntok
            loss, grads = loss_and_grads(cfg, state["params"], tokens)
            acc = state["acc"]
            with phases.span("train.accumulate"), torch.no_grad():
                for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                    a.add_(g)
            state = dict(state, micro=state["micro"] + 1)
            if state["micro"] >= n_micro:
                with phases.span("train.optimizer",
                                 count=state["step"] + 1):
                    mean = tree_map(lambda a: a / n_micro, acc)
                    opt = tx.update(mean, state["opt"], state["params"])
                    for a in tree_leaves(acc):
                        a.zero_()
                state.update(opt=opt, micro=0, step=state["step"] + 1)
        return state, {"loss": loss, "tokens": ntok}

    return init_state, micro_step
