"""Phase 3f's host twin: ``chip_smoke.observer_run`` at toy width with
``device="cpu"``.

The foreign tenants of ``chip_smoke.foreign_tenants`` (a two-layer
scoring forward, a chain of six bf16 products at 64^2, forty
tanh-scale-shift passes) adopted through ``Job.foreign`` into one
partition under ``CudaBackend(device="cpu")``; the observer child
(``pbst-torch oprofile`` until its stdin closes, then ``mon``, no torch
imported); the obs dump through ``perfc``/``lockprof``/``params``/
``lockdep --dump-graph`` and into ``check --lockdep-graph``. Every check
of the card phase runs and raises ``chip_smoke.Failed`` on a miss. No
JAX.
"""

from __future__ import annotations

import tempfile

import pytest
import torch

import chip_smoke

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

N, EW = 64, 1 << 16


@pytest.fixture
def lockdep_restored():
    from pbs_tpu_torch.obs import lockdep

    yield lockdep
    lockdep.lockdep.reset()
    lockdep.reset()


def test_observer_path_on_the_host(lockdep_restored):
    from pbs_tpu_torch.models import TransformerConfig, init_params
    from pbs_tpu_torch.obs.lockprof import ProfiledLock
    from pbs_tpu_torch.utils import params as boot

    cfg = TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq=64,
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    weights = init_params(cfg, gen, device="cpu")
    tenants = chip_smoke.foreign_tenants(torch, gen, cfg, weights, "cpu",
                                         (2, 64), N, EW)
    acquire = ProfiledLock.acquire
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.observer_run(
            tenants, "cpu", tmp, chip_smoke.OBSERVER_STEPS,
            chip_smoke.OBSERVER_MM_CHAIN * 2 * N ** 3)
    chip_smoke.observer_lines(out, "host")
    a, b, c = out["a"], out["b"], out["c"]
    assert a["flops_per_step"]["fmm"] == 6 * 2 * N ** 3
    # The harvest counts the products' and passes' bytes, no fewer than
    # the arguments' and the output's.
    assert a["harvest"]["fmm"].nbytes >= 3 * N * N * 2
    assert a["harvest"]["few"].nbytes >= 2 * EW * 4
    assert set(b["oprofile"]) == {"card/fscore", "card/fmm", "card/few"}
    assert c["edge"] == ("fixture_clean_a", "fixture_clean_b")
    assert c["base"]["rc"] == 0 and c["inv"]["rc"] == 1
    # The phase leaves the bridge off, the params at their defaults.
    assert ProfiledLock.acquire is acquire
    assert not lockdep_restored.lockdep.value
    assert not boot.get("lock_profile").value


def test_oprofile_and_mon_tables_parse():
    """The parsers read the commands' own tables."""
    op = ("job                           samples  lost  device_ms  stall%"
          "  coll_ms last_step\n"
          "card/few                           12     0    160.123   99.10"
          "    0.000         8\n")
    assert chip_smoke.oprofile_rows(op) == {"card/few": dict(
        samples=12, lost=0, device_ms=160.123, stall_pct=99.1,
        coll_ms=0.0, last_step=8)}
    mon = ("pbst mon — partition=observed window=1.0s records=40\n"
           "slot job          ctx              weight    cpu%  gotten_ms"
           "   execs   wakes\n"
           "   0 fscore       fscore/0            256    1.20     12.000"
           "       6       0\n")
    assert chip_smoke.mon_rows(mon)["fscore"]["execs"] == 6


def test_observer_child_without_a_ledger_fails(tmp_path):
    """The observer child that finds no ledger file fails; it does not
    skip."""
    with pytest.raises(chip_smoke.Failed):
        proc = chip_smoke.start_observer(str(tmp_path / "none.ledger"),
                                         "card")
        seen = chip_smoke.stop_observer(proc)
        chip_smoke.check(seen["rc"] == 0 and seen["final"].get(
            "rc_oprofile") == 0, f"observer child: {seen['final']}")
