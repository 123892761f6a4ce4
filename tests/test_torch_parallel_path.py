"""``__graft_entry__.dryrun_multichip``'s nine-schedule loss contract on
the port, and chip_smoke's phase 3x at toy width.

The dryrun's schedules at its tiny config on four gloo CPU rank
processes (``test_torch_parallel_ranks``), its 3-axis schedules at dp=1
so that they fit: the contract is the reference's, 5e-3 x max(1, |loss|)
of the dense loss from the reference's init on all-zero token rows, and
every dense schedule is also held to it at rel 1e-5 (fp32), the MoE ones
to the reference's MoE losses. Phase 3x's code runs on the host with the
card's checks (two rank processes over gloo, a one-rank world).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

from test_torch_parallel_ranks import rank_pool  # noqa: E402
from test_torch_parallel_seq import LOSS_REL  # noqa: E402
from test_torch_parallel_sharding import _key, _params, _reference  # noqa: E402

torch.set_num_threads(2)

RANKS = "test_torch_parallel_ranks"


@pytest.fixture(scope="module")
def pool():
    p = rank_pool(4)
    yield p
    p.close()


# -- __graft_entry__.dryrun_multichip's contract -------------------------------


DRY = dict(vocab=256, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
           d_ff=256, max_seq=128)
DRY_MOE = dict(DRY, d_ff=192, n_experts=4, top_k=2)
DRY_MOE_PP = dict(DRY_MOE, dropless=True, router_group_size=63)

#: The nine schedules at four ranks: (name, family, fields, axes, rows).
DRY_SCHEDULES = [
    ("dp x tp", "dense", DRY, {"dp": 1, "tp": 4}, 2),
    ("dp x pp", "pipe", DRY, {"dp": 2, "pp": 2}, 4),
    ("dp x ep (moe)", "moe", DRY_MOE, {"dp": 1, "ep": 4}, 2),
    ("dp x sp ring, loss_chunks=4", "dense",
     dict(DRY, attn_impl="ring", loss_chunks=4), {"dp": 1, "sp": 4}, 2),
    ("dp x sp ulysses", "dense", dict(DRY, attn_impl="ulysses"),
     {"dp": 1, "sp": 4}, 2),
    ("dp x tp x sp", "dense", dict(DRY, attn_impl="ring"),
     {"dp": 1, "tp": 2, "sp": 2}, 2),
    ("dp x pp x tp", "pipe", DRY, {"dp": 1, "pp": 2, "tp": 2}, 2),
    ("dp x pp x ep (moe)", "pipe_moe", DRY_MOE_PP,
     {"dp": 1, "pp": 2, "ep": 2}, 2),
    ("dp x pp x sp (ring)", "pipe", dict(DRY, attn_impl="ring"),
     {"dp": 1, "pp": 2, "sp": 2}, 2),
]


def _dry_params(fields):
    base = {k: v for k, v in fields.items()
            if k not in ("attn_impl", "loss_chunks")}
    return _params(_key(base)), _key(base)


def test_dryrun_multichip_contract(pool):
    """Each schedule's first loss on all-zero token rows: the dense ones
    within the reference's 5e-3 x max(1, |loss|) of the dense loss (and
    at rel 1e-5), the MoE ones at the reference's MoE loss, finite, the
    dropless pipeline with no drop."""
    loss_tp = _reference(_dry_params(DRY)[1], (2, 64, 0, 0))[0]["loss"]
    for name, family, fields, axes, rows in DRY_SCHEDULES:
        params, key = _dry_params(fields)
        out = pool.run(f"{RANKS}:rank_train", family, fields, axes,
                       np.zeros((rows, 64), np.int32), params, 1, 1e-3)[0]
        got = out["metrics"][0]
        assert np.isfinite(got["loss"]), name
        if family in ("moe", "pipe_moe"):
            want = _reference(key, (2, 64, 0, 0))[0]["loss"]
            assert got["loss"] == pytest.approx(want, rel=LOSS_REL), name
            if family == "pipe_moe":
                assert abs(got["moe_drop_frac"]) < 1e-6, name
            continue
        assert abs(got["loss"] - loss_tp) < 5e-3 * max(1.0, abs(loss_tp)), (
            name, got["loss"], loss_tp)
        assert got["loss"] == pytest.approx(loss_tp, rel=LOSS_REL), name


def test_dryrun_schedules_are_nine():
    assert len(DRY_SCHEDULES) == 9


# -- phase 3x at toy width -----------------------------------------------------


def test_parallel_phase_at_toy_width():
    """chip_smoke's phase 3x on the host: the single-process runs, the
    five schedules on two rank processes over gloo and the one-rank
    world; its checks are fatal, and in fp32 every schedule's losses
    also sit at rel 1e-5 of its single-process run and every rank's norms
    of the first step's summed gradients at rel 1e-4 of its run's."""
    import chip_smoke

    dense = dict(vocab=256, d_model=64, n_layers=4, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq=64, dtype="float32",
                 remat=True, remat_policy="dots", attn_impl="pallas")
    moe = dict(dense, d_ff=32, n_experts=4, top_k=2)
    del moe["remat_policy"]
    out = chip_smoke.parallel_path(torch, dense, moe, 2, "cpu", 2, 32, "host")
    scheds = {s["name"]: s for s in chip_smoke.parallel_schedules(
        dense, moe, 2)}
    assert set(out["runs"]) == set(scheds) | {"one-rank gloo world"}
    for name, res in out["runs"].items():
        key = scheds[name]["base"] if name in scheds else "shallow"
        for r in res:
            np.testing.assert_allclose(r["losses"], out["base"][key],
                                       rtol=LOSS_REL, err_msg=name)
            worst, where = chip_smoke.grad_norm_diff(out["base_norms"][key],
                                                     r["grad_norms"])
            assert worst <= 1e-4, (name, r["rank"], worst, where)
    ring = out["runs"]["sp2 ring, flash blocks"]
    assert [r["block"] for r in ring] == [(2, 16), (2, 16)]
