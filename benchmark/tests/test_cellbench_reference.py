"""The plain reference against the port at tiny widths, on the CPU in
fp32: Mistral's and Mixtral's forward, the loss, the mean gradient of a
step's micro-batches and the AdamW step."""

import dataclasses

import pytest
import torch

from benchmark import tenants
from benchmark import weights as W
from benchmark.reference import model as R
from benchmark.tests import tiny

DEV = torch.device("cpu")


def port_cfg(cfg, **kw):
    return dataclasses.replace(tenants.port_config(cfg), dtype=torch.float32,
                               **kw)


@pytest.mark.parametrize("name", ["mistral-7b-v0.3", "mixtral-8x7b-v0.1"])
def test_forward_matches_the_port(name):
    from pbs_tpu_torch.models import forward, moe_forward

    cfg = tiny.config(name)
    w = W.make_tree(cfg, 5, "serve", torch.float32, DEV)
    tokens = W.token_rows(5, "t", 0, (2, 40), cfg["vocab_size"], DEV)
    pc = port_cfg(cfg)
    with torch.no_grad():
        got = (moe_forward(pc, w, tokens)[0] if "num_local_experts" in cfg
               else forward(pc, w, tokens))
        ref = R.forward(cfg, w, tokens)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["mistral-7b-v0.3", "mixtral-8x7b-v0.1"])
def test_token_logprobs_match_the_port(name):
    cfg = tiny.config(name)
    w = W.make_tree(cfg, 6, "serve", torch.float32, DEV)
    spec = {"rows": [2, 32], "attn_impl": "xla"}
    sc = tenants.ScoreTenant(cfg, spec, w, 6, tenants.Spans(False), DEV)
    sc.pcfg = port_cfg(cfg)
    rows = sc.rows(0)
    torch.testing.assert_close(sc._forward(rows), R.token_logprobs(cfg, w, rows),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["mistral-7b-v0.3", "mixtral-8x7b-v0.1"])
def test_a_step_of_micro_batches_matches_the_port(name):
    from pbs_tpu_torch.models import make_micro_train_step
    from pbs_tpu_torch.models.moe import make_moe_train_step

    cfg = tiny.config(name)
    pc = port_cfg(cfg)
    micro = [W.token_rows(7, "train", i, (1, 24), cfg["vocab_size"], DEV)
             for i in range(3)]
    port = W.make_tree(cfg, 7, "train", torch.float32, DEV)
    if "num_local_experts" in cfg:
        # the MoE family trains a whole batch a step, with its aux loss
        pc = dataclasses.replace(pc, aux_loss_weight=0.0)
        init, step = make_moe_train_step(pc, learning_rate=3e-4)
        state = (port, init(port), 0)
        state, m = step(state, torch.cat(micro))
        port_loss = float(m["loss"])
        ref_micro = [torch.cat(micro)]
    else:
        feed = iter(micro)
        init, step = make_micro_train_step(pc, 3, learning_rate=3e-4,
                                           next_batch=lambda _: next(feed))
        state = init(port)
        losses = []
        for _ in range(3):
            state, m = step(state)
            losses.append(float(m["loss"]))
        port_loss = sum(losses) / 3
        ref_micro = micro
    ref = W.make_tree(cfg, 7, "train", torch.float32, DEV)
    ref_losses, grads = R.grads_of(cfg, ref, ref_micro)
    named = dict(R.leaves(ref))
    R.AdamW(3e-4, 0.9, 0.95, 1e-8, 0.1).step(named, grads)
    assert abs(port_loss - sum(ref_losses) / len(ref_losses)) < 1e-5
    # the mean gradient as AdamW took it: m = (1 - b1) g after step 1
    opt = state[1] if isinstance(state, tuple) else state["opt"]
    for n, m in R.leaves(opt["mu"]):
        torch.testing.assert_close(m / 0.1, grads[n], rtol=1e-4, atol=1e-6)
    # Adam's first step divides by |g| + eps, so an element whose
    # gradient is at the noise floor may move by up to 2 lr on either
    # side: the parameters are held to a tenth of lr
    for n, p in R.leaves(port):
        torch.testing.assert_close(p, named[n], rtol=1e-5, atol=3e-5)
