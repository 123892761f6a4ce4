"""The three walkthroughs (``pbs_tpu_torch.examples``) on the host.

- ``train_from_text``: the loss falls over its 30 steps, and the JAX
  package's ``pbs_tpu.ckpt.load_checkpoint`` reads its checkpoint back
  equal to the trained params.
- ``serving_stack``: the speculative engine's completions equal the
  plain engine's on the same prompts and fp32 weights (greedy, token
  for token).
- ``multi_tenant``: all three tenants retire their steps, and the
  foreign guest is measured without cooperating.

Each raises without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pbs_tpu_torch.examples import multi_tenant, serving_stack, train_from_text

torch.set_num_threads(2)


def test_train_from_text_loss_falls_and_the_reference_reads_its_checkpoint(
        tmp_path):
    pytest.importorskip("jax", reason="the checkpoint is read by the JAX "
                                      "package")
    from pbs_tpu.ckpt import load_checkpoint

    out = train_from_text.run(device="cpu", workdir=str(tmp_path),
                              log=lambda *_: None)
    losses = out["losses"]
    assert list(losses) == [0, 10, 20, 29]
    assert losses[29] < 0.5 * losses[0], losses
    state, meta = load_checkpoint(out["ckpt"])
    assert meta["steps"] == train_from_text.STEPS
    assert meta["data_cursor"]["step"] == train_from_text.STEPS

    def check(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                check(got[k], want[k], f"{path}/{k}")
            return
        np.testing.assert_array_equal(np.asarray(got), want.numpy(),
                                      err_msg=path)

    check(state, out["params"])


def test_serving_stack_speculative_output_equals_the_plain_engine():
    from pbs_tpu_torch.models import ContinuousBatcher

    out = serving_stack.run(device="cpu", log=lambda *_: None)
    assert out["engine"]["completed"] == 6
    assert out["engine"]["prefix_hits"] == 5
    assert out["spec_engine"]["completed"] == 2
    assert out["moe_engine"]["mlp_extra_mean"] == 0.0
    assert int(out["spec_generate"]["accepted"]) == int(
        out["spec_generate"]["proposed"])  # self-draft: the ceiling
    plain = ContinuousBatcher(serving_stack.config(), out["params"],
                              n_slots=2, prompt_bucket=64, max_len=128,
                              device="cpu")
    rid_of = {plain.submit(p, max_new_tokens=12): i
              for i, p in enumerate(out["prompts"])}
    want = {}
    while plain.has_work():
        for c in plain.step():
            want[rid_of[c.request_id]] = [int(t) for t in c.tokens]
    assert out["spec_tokens"] == [want[i] for i in range(len(want))]
    assert all(len(t) == 12 for t in out["spec_tokens"])


def test_multi_tenant_every_tenant_retires_and_the_guest_is_measured():
    out = multi_tenant.run(device="cpu", log=lambda *_: None)
    train, serve, guest = out["jobs"]
    assert [j.steps_retired() for j in (train, serve, guest)] == [40, 30, 30]
    m = out["guest_measured"]
    assert m is not None and m.n_ops > 0 and m.source == "host"
    # its cost harvested from one counted invocation: elementwise ops
    # move bytes (the FLOP counter counts products only)
    assert guest.compiled is not None and guest.compiled.nbytes > 0
    assert out["feedback"].state_of(guest).ticks > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("mod", [train_from_text, serving_stack,
                                 multi_tenant],
                         ids=["train_from_text", "serving_stack",
                              "multi_tenant"])
def test_examples_raise_without_a_card(mod, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--workdir", str(tmp_path)] if mod is train_from_text
                 else [])
