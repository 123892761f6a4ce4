"""One gradient write per L-stacked layer leaf in the backward.

The port's forwards cut each stacked layer leaf once per forward
(``unstack_layers``, one ``unbind(0)``), so the backward writes each
stacked leaf's gradient by one ``stack`` of its L layer gradients. The
``w[i]`` slicing it replaced cost a zero-filled stack-size
``select_backward`` per layer and L - 1 stack-size adds per leaf. These
tests count the backward's ops under a ``TorchDispatchMode`` at tiny
width on the CPU, and hold the gradients, and three micro-steps'
accumulator, parameters and moments, bitwise to the ``w[i]`` path
written out below. Nothing here needs the JAX reference.
"""

from __future__ import annotations

import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from pbs_tpu_torch.models import moe as port_moe
from pbs_tpu_torch.models import transformer as port_tf
from pbs_tpu_torch.models.microstep import make_micro_train_step

torch.set_num_threads(2)

#: L = 3 so that no activation or batch tensor shares a stacked shape.
DENSE = port_tf.TransformerConfig(
    vocab=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2, d_ff=48,
    max_seq=32, dtype=torch.float32)
MOE = port_moe.MoEConfig(**{f.name: getattr(DENSE, f.name)
                            for f in dataclasses.fields(DENSE)},
                         n_experts=4, top_k=2)

#: (family, remat policy or None): the forwards whose loops take layers.
CASES = [("dense", None), ("dense", "dots"), ("dense", "full"),
         ("moe", None), ("moe", "full")]


def _cfg(family: str, remat: str | None):
    base = DENSE if family == "dense" else MOE
    if remat is None:
        return base
    return dataclasses.replace(base, remat=True, remat_policy=remat)


def _params(family: str) -> dict:
    gen = torch.Generator().manual_seed(0)
    if family == "dense":
        return port_tf.init_params(DENSE, gen, device="cpu")
    return port_moe.init_moe_params(MOE, gen, device="cpu")


def _tokens(seed: int, shape=(2, 17)) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, DENSE.vocab, shape, generator=gen)


def _loss(family: str, cfg, params: dict, tokens: torch.Tensor):
    if family == "dense":
        return port_tf.next_token_loss(cfg, params, tokens)
    return port_moe.moe_loss(cfg, params, tokens)[0]


def select_layers(params: dict) -> list[dict]:
    """The ``w[i]`` slicing: layer i of every stacked leaf by index."""
    def pick(w, i):
        if isinstance(w, dict):
            return {k: pick(v, i) for k, v in w.items()}
        return w[i]

    L = port_tf.tree_leaves(params["layers"])[0].shape[0]
    return [pick(params["layers"], i) for i in range(L)]


@pytest.fixture
def by_select(monkeypatch):
    """Route the dense and MoE forwards through ``select_layers``."""
    def use():
        monkeypatch.setattr(port_tf, "unstack_layers", select_layers)
        monkeypatch.setattr(port_moe, "unstack_layers", select_layers)

    return use


class _OpShapes(TorchDispatchMode):
    """(op packet name, output shape) of every tensor each op returns."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.ops += [(name, tuple(t.shape)) for t in pytree_leaves(out)
                     if isinstance(t, torch.Tensor)]
        return out


def _backward_ops(family: str, cfg, params: dict) -> list:
    live = port_tf.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = _loss(family, cfg, live, _tokens(1))
    with _OpShapes() as rec:
        torch.autograd.grad(loss, port_tf.tree_leaves(live))
    return rec.ops


@pytest.mark.parametrize("family,remat", CASES)
def test_backward_writes_each_stacked_leaf_once(family, remat):
    """No stack-size ``select_backward`` or add, and at most one
    stack-size op per stacked leaf of that shape. (The loss's
    ``[..., 0]`` on the gathered log-probabilities keeps one
    activation-size ``select_backward``.)"""
    cfg = _cfg(family, remat)
    params = _params(family)
    stacked = collections.Counter(
        tuple(w.shape) for w in port_tf.tree_leaves(params["layers"]))
    ops = _backward_ops(family, cfg, params)
    assert any(name == "mm" for name, _ in ops)  # the recorder saw it
    assert [o for o in ops if o[1] in stacked and o[0] in
            ("select_backward", "add", "add_")] == []
    seen = collections.Counter(shape for _, shape in ops
                               if shape in stacked)
    for shape, n in seen.items():
        assert n <= stacked[shape], (shape, n, [o for o in ops
                                               if o[1] == shape])


def test_select_path_is_what_the_count_catches(by_select):
    """The count above fails on the ``w[i]`` path: L select-backwards
    and L - 1 stack-size adds per stacked leaf."""
    by_select()
    params = _params("dense")
    ops = _backward_ops("dense", DENSE, params)
    n_leaves = len(port_tf.tree_leaves(params["layers"]))
    L = DENSE.n_layers
    stacked = {tuple(w.shape)
               for w in port_tf.tree_leaves(params["layers"])}
    selects = sum(name == "select_backward" and shape in stacked
                  for name, shape in ops)
    assert selects == n_leaves * L
    adds = sum(name in ("add", "add_") and shape in stacked
               for name, shape in ops)
    assert adds == n_leaves * (L - 1)


@pytest.mark.parametrize("family,remat", [("dense", None), ("dense", "dots"),
                                          ("moe", None), ("moe", "full")])
def test_grads_bitwise_equal_to_select_path(family, remat, by_select):
    """The gradient tree keeps its stacked shapes and leaf order and
    equals the ``w[i]`` path's, leaf by leaf, exactly."""
    cfg = _cfg(family, remat)
    tokens = _tokens(2)

    def grads():
        return port_tf.value_and_grad(
            lambda p: (_loss(family, cfg, p, tokens), None),
            _params(family))

    (loss, _), got = grads()
    by_select()
    (want_loss, _), want = grads()
    assert torch.equal(loss, want_loss)
    for (name, g), (_, w) in zip(_named(got), _named(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name


def _named(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _micro_run(n_steps: int):
    """Three micro-steps (one AdamW step) on the dense tree: the
    accumulator after each of the first two, then the state."""
    cfg = dataclasses.replace(DENSE, remat=True, remat_policy="dots")
    batches = [_tokens(10 + i) for i in range(3)]
    init, micro = make_micro_train_step(cfg, n_micro=3, learning_rate=1e-2,
                                        next_batch=lambda i: batches[i])
    state = init(_params("dense"))
    accs = []
    for _ in range(n_steps):
        state, _ = micro(state)
        if state["micro"]:
            accs.append([a.clone() for a in port_tf.tree_leaves(
                state["acc"])])
    return accs, state


def test_micro_steps_bitwise_equal_to_select_path(by_select):
    """make_micro_train_step: the same accumulator after each micro-step
    and the same parameters and moments after the AdamW step."""
    accs, state = _micro_run(3)
    by_select()
    want_accs, want = _micro_run(3)
    assert len(accs) == len(want_accs) == 2
    for got_acc, want_acc in zip(accs, want_accs):
        for a, b in zip(got_acc, want_acc, strict=True):
            assert torch.equal(a, b)
    assert state["step"] == want["step"] == 1
    for key in ("params", "acc"):
        for a, b in zip(port_tf.tree_leaves(state[key]),
                        port_tf.tree_leaves(want[key]), strict=True):
            assert torch.equal(a, b), key
    for key in ("mu", "nu"):
        for a, b in zip(port_tf.tree_leaves(state["opt"][key]),
                        port_tf.tree_leaves(want["opt"][key]), strict=True):
            assert torch.equal(a, b), key
