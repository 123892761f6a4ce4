"""The correctness check catches a broken timed path: each cell's CPU
rehearsal, run with one fault planted in the program underneath, comes
out not correct, and the same rehearsal without it comes out correct.
The faults: a training step that leaves its state unchanged, the
executor dropping the state a micro-step returns (the window's own
dispatch, which a second driver of the training step would not see),
half of a micro-batch left out with the mean taken over the rest, served tokens
altered where the engine produces them (one in ten; every one in the
Mixtral cell, which compares the mean gap: a single token moves a mean
too little), a scored row's answers altered and half of a scoring batch
left out. (The exchange between chips: no cell
runs on more than one.)"""

import pytest
import torch

from benchmark import spec
from benchmark.tests import tiny

SERVE_TRAIN = "colo.mistral-7b.serve-train"
SERVE_SCORE = "colo.mixtral-8x7b.serve-score"
TRAIN = "train.mistral-7b"


def run_with_limits(workload):
    result, run = tiny.run(workload)
    assert all(c["limit"] is not None for c in result["checks"].values())
    return result, run


@pytest.mark.parametrize("workload", [SERVE_TRAIN, SERVE_SCORE, TRAIN])
def test_sound_rehearsal_is_correct(workload):
    result, _ = run_with_limits(workload)
    assert result["correct"], result["checks"]


def _unchanged_state(monkeypatch):
    from pbs_tpu_torch.models import transformer

    def update(self, grads, state, params):
        return dict(state, count=torch.tensor(int(state["count"]) + 1,
                                              dtype=torch.int32))

    monkeypatch.setattr(transformer.AdamW, "update", update)


def _half_micro_batch(monkeypatch):
    from pbs_tpu_torch.models import microstep

    orig = microstep.loss_and_grads

    def half(cfg, params, tokens, *a, **kw):
        return orig(cfg, params, tokens[:, : tokens.shape[1] // 2 + 1],
                    *a, **kw)

    monkeypatch.setattr(microstep, "loss_and_grads", half)


def _dispatch_drops_state(monkeypatch):
    """The executor's micro-step dispatch keeps the state it had: the
    moments and weights move in place, the step's count never does, so
    no optimizer step retires."""
    from pbs_tpu_torch.telemetry import source

    orig = source.CudaBackend._invoke

    def invoke(self, job, fn):
        before = job.state
        out = orig(self, job, fn)
        if job.micro_step_fn is not None:
            job.state = before
        return out

    monkeypatch.setattr(source.CudaBackend, "_invoke", invoke)


def _altered_tokens(every, monkeypatch):
    from pbs_tpu_torch.models import serving

    orig = serving.ContinuousBatcher._emit
    calls = {"n": 0}

    def emit(self, slot, tok):
        calls["n"] += 1
        if calls["n"] % every == 0:
            tok = (tok + 1) % self.cfg.vocab
        return orig(self, slot, tok)

    monkeypatch.setattr(serving.ContinuousBatcher, "_emit", emit)


def _altered_token(monkeypatch):
    """One decoded token in ten altered: the widest gap sees one."""
    _altered_tokens(10, monkeypatch)


def _altered_every_token(monkeypatch):
    """Every decoded token altered: what the Mixtral cell's mean gap is
    sure to see (one token in many moves a mean too little)."""
    _altered_tokens(1, monkeypatch)


def _scored(monkeypatch, alter):
    import pbs_tpu_torch.models as models

    orig = models.moe_forward

    def fwd(cfg, params, tokens, *a, **kw):
        logits, aux, drop = orig(cfg, params, tokens, *a, **kw)
        return alter(logits), aux, drop

    monkeypatch.setattr(models, "moe_forward", fwd)


def _altered_answer(monkeypatch):
    _scored(monkeypatch, lambda x: torch.cat([x[:1], x[1:].roll(1, -1)]))


def _half_scoring_batch(monkeypatch):
    _scored(monkeypatch, lambda x: x[:1].expand_as(x).clone())


FAULTS = [
    (TRAIN, _unchanged_state),
    (TRAIN, _half_micro_batch),
    (TRAIN, _dispatch_drops_state),
    (SERVE_TRAIN, _unchanged_state),
    (SERVE_TRAIN, _half_micro_batch),
    (SERVE_TRAIN, _altered_token),
    (SERVE_SCORE, _altered_every_token),
    (SERVE_SCORE, _altered_answer),
    (SERVE_SCORE, _half_scoring_batch),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}"
                              for w, f in FAULTS])
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_with_limits(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", [SERVE_TRAIN, SERVE_SCORE, TRAIN])
def test_the_control_separates(workload):
    """The control, the reference in float8 in the program's place, at
    the test's size: it reads at least three times what the program
    reads on one of the cell's numbers (on the card, at the cell's own
    size, it fails the limits themselves: PERF.md gives the readings)."""
    _, run = tiny.run(workload, control=True)
    ratios = {k: run.control[k] / max(v, 1e-12)
              for k, v in run.readings.items()}
    assert max(ratios.values()) >= 3, (run.readings, run.control)
    assert set(spec.limits(workload)) <= set(run.readings)
