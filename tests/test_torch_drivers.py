"""The twins of the root scripts (``pbs_tpu_torch.drivers``) against them.

- ``bench_sim``'s document equals ``bench_sim.py``'s byte for byte.
- The twins of ``tests/test_bench_knobs.py`` (the sweep's knobs fail
  before any device touch, with the reference's messages) and
  ``tests/test_bench_unavailable.py`` (the fatal/point-level split, on
  the card's error classes: no device, a poisoned context and a failed
  kernel build end a matrix; an out-of-memory or a ValueError is one
  point's row).
- The twin of ``tests/test_dryrun_budget.py`` at 4 gloo rank processes,
  and ``dryrun_multichip(8)``'s eleven schedules on 8.
- ``entry()`` at the tiny config on the host, fed the reference's init
  through ``params_from_numpy``: its logits within fp32 tolerance of the
  reference's ``forward`` (rtol 2e-4, atol 2e-5, the parity bound of
  ``tests/test_torch_train.py``).
- The tiny smokes of ``bench_serving``, ``bench_longctx``,
  ``bench_sweep`` and ``bench_decompose``, with the reference's row keys.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu_torch.drivers import (bench_common, bench_decompose,  # noqa: E402
                                   bench_longctx, bench_serving, bench_sim,
                                   bench_sweep, graft_entry)
from pbs_tpu_torch.ops.cuda_build import BuildError  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FATAL_MSG = ("CUDA error: an illegal memory access was encountered\n"
             "CUDA kernel errors might be asynchronously reported")


def _rows(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _clean_env(monkeypatch, prefix):
    for k in list(os.environ):
        if k.startswith(prefix):
            monkeypatch.delenv(k)


# -- bench_sim ----------------------------------------------------------------


def test_bench_sim_document_equals_the_reference(tmp_path, capsys):
    """Same args, same key order, same trace digests: the simulator is a
    copy, so the documents are equal byte for byte."""
    import bench_sim as ref_bench_sim

    argv = ["--seconds", "0.5", "--workloads", "contended,stable,serving"]
    assert ref_bench_sim.main(argv + ["--out", str(tmp_path / "r.json")]) == 0
    ref_out = capsys.readouterr().out
    assert bench_sim.main(argv + ["--out", str(tmp_path / "p.json")]) == 0
    port_out = capsys.readouterr().out
    assert port_out == ref_out
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    doc = json.loads(port_out)
    assert list(doc["workloads"]) == ["contended", "stable", "serving"]
    assert doc["headline"]["metric"] == "contended_p99_wait_us"


# -- knobs (twin of tests/test_bench_knobs.py) --------------------------------


@pytest.mark.parametrize("env,msg", [
    ({"PBST_SWEEP_BATCHES": "0"}, "must be ints >= 1"),
    ({"PBST_SWEEP_BATCHES": "-4"}, "must be ints >= 1"),
    ({"PBST_SWEEP_BATCHES": "8,0"}, "must be ints >= 1"),
    ({"PBST_SWEEP_BATCHES": "4,-2,8"}, "must be ints >= 1"),
    ({"PBST_SWEEP_BATCHES": "8x"}, "must be ints >= 1"),
    ({"PBST_SWEEP_ATTN": "flash"}, "PBST_SWEEP_ATTN must be xla|pallas"),
    ({"PBST_SWEEP_LOSS_CHUNKS": "3"}, "must divide seq=1024"),
    ({"PBST_SWEEP_LOSS_CHUNKS": "four"},
     "PBST_SWEEP_LOSS_CHUNKS must be an int >= 1"),
    ({"PBST_SWEEP_MU_DTYPE": "fp8"}, "PBST_SWEEP_MU_DTYPE: mu_dtype 'fp8' "
                                     "unknown"),
])
def test_sweep_knobs_fail_before_any_device_touch(monkeypatch, capsys, env,
                                                  msg):
    """A bad knob prints the error row and returns 1 before the device is
    resolved (full mode: on a host with no card that would raise) and
    before any point runs."""
    _clean_env(monkeypatch, "PBST_SWEEP_")
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def touched(*a, **k):
        raise AssertionError("the device was touched")

    monkeypatch.setattr(bench_sweep, "bench_device", touched)
    monkeypatch.setattr(bench_sweep, "run_point", touched)
    assert bench_sweep.main([]) == 1
    out = capsys.readouterr().out
    rows = _rows(out)
    assert len(rows) == 1 and msg in rows[0]["error"], rows
    assert "tokens_per_s" not in out


def test_sweep_attn_knob_drops_the_full_remat_row(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_SWEEP_")
    monkeypatch.setenv("PBST_SWEEP_TINY", "1")
    monkeypatch.setenv("PBST_SWEEP_ATTN", "pallas")
    k = bench_sweep.parse_knobs(tiny=True)
    assert [r[0] for r in k["remats"]] == ["none", "dots"]
    assert k["attns"] == ["pallas"] and k["batches"] == [2]


def test_parse_mu_dtype_spellings():
    assert bench_common.parse_mu_dtype("BF16") == (torch.bfloat16, "bf16")
    assert bench_common.parse_mu_dtype("bfloat16")[1] == "bf16"
    for raw in (None, "", "f32", "fp32", "float32"):
        assert bench_common.parse_mu_dtype(raw) == (None, "f32")
    with pytest.raises(ValueError, match="expected bf16/bfloat16 or "
                                         "f32/fp32/float32"):
        bench_common.parse_mu_dtype("half")


# -- the fatal/point-level split (twin of tests/test_bench_unavailable.py) ----


@pytest.mark.parametrize("exc,fatal", [
    (RuntimeError(FATAL_MSG), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (BuildError("kernel build failed:\nflash_fwd: nvcc exit 1"), True),
    (RuntimeError("no CUDA device is available; pass device='cpu' "
                  "explicitly to run on the host"), True),
    # Point-level failures stay point-level: the matrix keeps going.
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "4.00 GiB"), False),
    (ValueError("shape mismatch"), False),
    (RuntimeError("CUDA error: out of memory"), False),
    (RuntimeError("expected scalar type BFloat16 but found Float"), False),
])
def test_backend_unavailable_classification(exc, fatal):
    assert bench_common.backend_unavailable(exc) is fatal


def test_bench_device_refuses_the_host_unless_asked():
    assert bench_common.bench_device(True).type == "cpu"
    assert bench_common.bench_device(False, "cpu").type == "cpu"
    if torch.cuda.is_available():
        assert bench_common.bench_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_common.bench_device()


def test_sweep_abandons_after_first_fatal_error(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_SWEEP_")
    monkeypatch.setenv("PBST_SWEEP_TINY", "1")
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError(FATAL_MSG)

    monkeypatch.setattr(bench_sweep, "run_point", boom)
    rc = bench_sweep.main([])
    rows = _rows(capsys.readouterr().out)
    assert rc == 1
    assert len(calls) == 1, calls  # not one per grid point (tiny has 6)
    assert any("abandoning the remaining sweep points" in
               r.get("error", "") for r in rows), rows


def test_sweep_keeps_going_after_point_level_failure(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_SWEEP_")
    monkeypatch.setenv("PBST_SWEEP_TINY", "1")
    calls = []

    def oom(*a, **k):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(bench_sweep, "run_point", oom)
    rc = bench_sweep.main([])
    out = capsys.readouterr().out
    assert rc == 1  # no green rows
    assert len(calls) == 6, calls  # every grid point still probed
    assert "abandoning" not in out
    assert all(r["error"].startswith("OutOfMemoryError") for r in
               _rows(out)[:6])


def test_serving_abandons_engines_after_first_fatal_error(monkeypatch,
                                                          capsys):
    """The engine matrix keeps going past one engine's failure, but a
    fatal error from the first engine ends it."""
    import pbs_tpu_torch.models as models_pkg

    _clean_env(monkeypatch, "PBST_BENCH_")
    monkeypatch.setenv("PBST_BENCH_TINY", "1")
    calls = []

    class Boom:
        def __init__(self, *a, **k):
            calls.append(1)
            raise RuntimeError(FATAL_MSG)

    monkeypatch.setattr(models_pkg, "ContinuousBatcher", Boom)
    monkeypatch.setattr(models_pkg, "SpeculativeBatcher", Boom)
    rc = bench_serving.main([])
    out = capsys.readouterr().out
    assert rc == 1
    assert len(calls) == 1, calls  # not one per engine row
    assert "abandoning the remaining serving engines" in out


def test_longctx_abandons_after_first_fatal_error(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_LONGCTX_")
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError(FATAL_MSG)

    monkeypatch.setattr(bench_longctx, "run_point", boom)
    rc = bench_longctx.main(["--device", "cpu"])  # the full grid's 4 points
    out = capsys.readouterr().out
    assert rc == 1
    assert len(calls) == 1, calls
    assert "abandoning the remaining long-context points" in out


def test_longctx_keeps_going_after_an_out_of_memory(monkeypatch, capsys):
    """The "xla" column at 8192 may not fit: an error row, and the other
    points still run."""
    _clean_env(monkeypatch, "PBST_LONGCTX_")
    seen = []

    def point(cfg, seq, batch, attn, **kw):
        seen.append((seq, attn))
        if (seq, attn) == (8192, "xla"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return {"seq": seq, "batch": batch, "attn": attn,
                "tokens_per_s": 100.0 if attn == "xla" else 150.0}

    monkeypatch.setattr(bench_longctx, "run_point", point)
    assert bench_longctx.main(["--device", "cpu"]) == 0
    rows = _rows(capsys.readouterr().out)
    assert seen == [(4096, "xla"), (4096, "pallas"), (8192, "xla"),
                    (8192, "pallas")]
    assert rows[2]["error"].startswith("OutOfMemoryError")
    assert rows[-1] == {"seq": 4096, "pallas_speedup": 1.5}


# -- dryrun_multichip (twin of tests/test_dryrun_budget.py) ------------------


def test_zero_budget_runs_core_and_skips_extended(monkeypatch, capsys):
    monkeypatch.setenv("PBST_DRYRUN_BUDGET_S", "0")
    out = graft_entry.dryrun_multichip(4)
    line = capsys.readouterr().out
    assert "dryrun_multichip OK" in line
    for core in ("xtp", "xpp2 loss", "xep", "(ring) loss"):
        assert core in line.split("SKIPPED")[0], (core, line)
    assert "SKIPPED over 0s budget" in line
    # at 4 ranks the schedules the reference gates on 8 never run; the
    # rest are skipped by the budget
    assert out["skipped"] == ["dp x sp ulysses", "dp x pp (flash)"]
    assert len(out["losses"]) == 4


def test_bad_budget_knob_fails_fast(monkeypatch):
    monkeypatch.setenv("PBST_DRYRUN_BUDGET_S", "5m")
    with pytest.raises(SystemExit,
                       match="PBST_DRYRUN_BUDGET_S must be a number"):
        graft_entry.dryrun_multichip(4)


def test_dryrun_multichip_eight_ranks_runs_all_eleven(monkeypatch, capsys):
    """All eleven schedules on 8 gloo rank processes: the dense losses
    within the reference's 5e-3 x max(1, |loss|) of dp x tp (asserted
    inside) and at rel 1e-5 of one process's loss on the same init, the
    dropless pipelines with no drop."""
    from pbs_tpu_torch.models import init_params, next_token_loss

    monkeypatch.delenv("PBST_DRYRUN_BUDGET_S", raising=False)
    out = graft_entry.dryrun_multichip(8)
    line = capsys.readouterr().out
    assert "SKIPPED" not in line
    labels = [s["label"] for s in graft_entry.dryrun_schedules(8)]
    assert list(out["losses"]) == labels and len(labels) == 11
    cfg = graft_entry._flagship_cfg(tiny=True)
    want = float(next_token_loss(
        cfg, init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu"),
        torch.zeros((2, 64), dtype=torch.int32)))
    for s in graft_entry.dryrun_schedules(8):
        got = out["losses"][s["label"]]
        if s["family"] in ("dense", "pipe"):
            assert got == pytest.approx(want, rel=1e-5), s["label"]
        else:
            assert np.isfinite(got), s["label"]


def test_dryrun_schedules_follow_the_reference_layout():
    """The mesh factors and token rows the reference gives each schedule
    (``__graft_entry__.py:130-135`` ``_factor``)."""
    s8 = graft_entry.dryrun_schedules(8)
    assert [s["axes"] for s in s8] == [
        {"dp": 2, "tp": 4}, {"dp": 4, "pp": 2}, {"dp": 2, "ep": 4},
        {"dp": 2, "sp": 4}, {"dp": 2, "sp": 4},
        {"dp": 2, "tp": 2, "sp": 2}, {"dp": 2, "pp": 2, "tp": 2},
        {"dp": 2, "pp": 2, "ep": 2}, {"dp": 2, "pp": 2, "sp": 2},
        {"dp": 4, "pp": 2}, {"dp": 1, "pp": 2, "ep": 2, "sp": 2}]
    assert [s["rows"] for s in s8] == [4, 8, 4, 4, 4, 4, 4, 4, 4, 8, 2]
    assert s8[9]["fields"]["attn_impl"] == "pallas"
    s6 = graft_entry.dryrun_schedules(6)
    assert s6[0]["axes"] == {"dp": 3, "tp": 2}
    assert [s is None for s in s6] == [False, False, False, False, False,
                                       True, True, True, True, False, True]
    assert graft_entry.dryrun_schedules(3)[1] is None  # odd: no pp


# -- entry() ------------------------------------------------------------------


def test_entry_matches_the_reference_forward():
    """``entry()`` at the tiny config on the host, on the reference's
    init: the logits of the reference's ``forward`` on the same zero
    tokens."""
    from __graft_entry__ import _flagship_cfg as ref_cfg
    from pbs_tpu import models as ref
    from pbs_tpu_torch.models import params_from_numpy

    fn, (params, tokens) = graft_entry.entry(device="cpu", tiny=True)
    assert tuple(tokens.shape) == (4, 256) and not bool(tokens.any())
    assert params["layers"]["wq"].shape == (2, 128, 128)
    jcfg = ref_cfg(tiny=True)
    jparams = ref.init_params(jcfg, jax.random.PRNGKey(0))
    want = np.asarray(ref.forward(jcfg, jparams,
                                  jnp.zeros((4, 256), jnp.int32)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got = fn(tree, tokens)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 256, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_flagship_cfg_fields_match_the_reference():
    from __graft_entry__ import _flagship_cfg as ref_cfg

    for tiny in (False, True):
        want, got = ref_cfg(tiny), graft_entry._flagship_cfg(tiny)
        for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq", "remat", "remat_policy", "attn_impl",
                  "loss_chunks"):
            assert getattr(got, f) == getattr(want, f), (tiny, f)
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
        assert got.num_params() == want.num_params()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("call", [
    lambda: graft_entry.entry(),
    lambda: graft_entry.main([]),
    lambda: bench_serving.main([]),
    lambda: bench_longctx.main([]),
    lambda: bench_sweep.main([]),
    lambda: bench_decompose.main([]),
], ids=["entry", "graft_entry.main", "bench_serving", "bench_longctx",
        "bench_sweep", "bench_decompose"])
def test_twins_raise_without_a_card(monkeypatch, call):
    """No card and no tiny mode or explicit CPU: every twin raises
    before it measures anything."""
    for prefix in ("PBST_BENCH_", "PBST_SWEEP_", "PBST_LONGCTX_",
                   "PBST_DECOMP_"):
        _clean_env(monkeypatch, prefix)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# -- tiny smokes with the reference's keys ------------------------------------

#: The reference's row keys (``bench_serving.py:70-77, 104-113, 197-207``,
#: ``bench_longctx.py:99-109``, ``bench_sweep.py:80-90``,
#: ``bench_decompose.py:105-111, 117-120, 153-158, 166-168, 216-223,
#: 226-232, 245-255``).
SERVING_KEYS = {
    "serving_prefill_ms": {"metric", "value", "unit", "p90_ms", "batch",
                           "prompt_len"},
    "serving_decode_throughput": {"metric", "value", "unit", "per_step_ms",
                                  "batch", "new_tokens", "device"},
}
ENGINE_KEYS = {"metric", "value", "unit", "ticks", "requests", "ttft_p50_s",
               "ttft_p99_s", "latency_p99_s"}
LONGCTX_KEYS = {"seq", "batch", "attn", "tokens_per_s", "mfu_dense",
                "mfu_incl_attn", "step_ms", "compile_s", "loss"}
SWEEP_KEYS = {"remat", "batch", "attn", "tokens_per_s", "mfu", "step_ms",
              "compile_s", "loss", "n_params"}
DECOMP_KEYS = [
    {"config", "flops_per_token", "dense_6N", "ratio_vs_6N",
     "hbm_bytes_per_token"},
    {"remat_tax_frac", "flops_none_per_token"},
    {"membw_gbs", "membw_buffer_mib", "membw_stream_reps", "membw_rtt_ms"},
    {"attention_flops_per_token", "attention_share_of_6N"},
    {"step_ms_hostloop", "step_ms_scan", "dispatch_overhead_ms",
     "tokens_per_s_scan", "mfu_6N", "mfu_cost_analysis"},
    {"measured_source", "compute_frac", "stall_frac", "collective_frac",
     "top_ops"},
    {"reconcile_predicted_mem_frac", "reconcile_measured_mem_frac",
     "reconcile_proxy_correction", "reconcile_note"},
]


def test_bench_serving_tiny_covers_the_matrix(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_BENCH_")
    monkeypatch.setenv("PBST_BENCH_TINY", "1")
    assert bench_serving.main([]) == 0
    rows = _rows(capsys.readouterr().out)
    for r in rows[:2]:
        assert set(r) == SERVING_KEYS[r["metric"]], r
    assert rows[1]["device"] == "cpu" and rows[1]["value"] > 0
    engine_rows = rows[2:]
    assert [r["metric"] for r in engine_rows] == [
        f"serving_{n}_throughput" for n in bench_serving.ENGINE_NAMES]
    errs = [r for r in engine_rows if "error" in r]
    assert not errs, errs
    for r in engine_rows:
        spec = "spec_" in r["metric"]
        assert set(r) == ENGINE_KEYS | ({"acceptance"} if spec else set()), r
        assert r["requests"] == 4 and r["value"] > 0
    # Self-draft rows are exact on the CPU's fp32 path: acceptance ~1.0.
    for m in ("serving_spec_continuous_bf16_throughput",
              "serving_spec_continuous_moe_dropless_throughput"):
        row = next(r for r in engine_rows if r["metric"] == m)
        assert row["acceptance"] >= 0.9, row


def test_bench_serving_sizes_are_the_references():
    assert bench_serving.sizes(False) == dict(
        batch=8, prompt_len=512, new_tokens=128, iters=5, n_slots=8,
        eng_new=64, bucket=512)
    assert bench_serving.sizes(True) == dict(
        batch=2, prompt_len=16, new_tokens=8, iters=2, n_slots=2, eng_new=8,
        bucket=16)
    mcfg = bench_serving.moe_config(graft_entry._flagship_cfg())
    assert (mcfg.d_ff, mcfg.n_experts, mcfg.top_k, mcfg.dropless) == (
        1408, 4, 2, True)


def test_bench_longctx_tiny_emits_points(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_LONGCTX_")
    monkeypatch.setenv("PBST_LONGCTX_TINY", "1")
    assert bench_longctx.main([]) == 0
    rows = _rows(capsys.readouterr().out)
    assert len(rows) == 1 and set(rows[0]) == LONGCTX_KEYS, rows
    assert rows[0]["attn"] == "xla" and rows[0]["tokens_per_s"] > 0
    assert np.isfinite(rows[0]["loss"])


def test_longctx_flash_column_matches_dense_on_the_host():
    """The "pallas" column's step on the host (the flash plain versions)
    against "xla"'s on the same params and tokens: the first loss within
    rel 1e-5 (fp32); chip_smoke phase 3b holds the card's columns to each
    other the same way."""
    cfg = graft_entry._flagship_cfg(tiny=True)
    got = {a: bench_longctx.measure_point(cfg, 128, 1, a, warm_chunks=1,
                                          timed_chunks=1, device="cpu",
                                          steps=2)
           for a in ("xla", "pallas")}
    assert set(got["pallas"][0]) == LONGCTX_KEYS
    assert got["pallas"][1]["first_loss"] == pytest.approx(
        got["xla"][1]["first_loss"], rel=1e-5)
    assert got["pallas"][1]["peak_gib"] is None  # no card memory on the host


def test_bench_sweep_tiny_grid_and_best(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_SWEEP_")
    monkeypatch.setenv("PBST_SWEEP_TINY", "1")
    monkeypatch.setenv("PBST_SWEEP_MU_DTYPE", "bf16")
    monkeypatch.setenv("PBST_SWEEP_LOSS_CHUNKS", "4")
    assert bench_sweep.main([]) == 0
    rows = _rows(capsys.readouterr().out)
    points, best = rows[:-1], rows[-1]
    assert [(r["remat"], r["attn"]) for r in points] == [
        (m, a) for m in ("none", "dots", "full") for a in ("xla", "pallas")]
    for r in points:
        assert set(r) == SWEEP_KEYS | {"loss_chunks", "mu_dtype"}, r
        assert (r["loss_chunks"], r["mu_dtype"]) == (4, "bf16")
    # one model, one init, one batch: every point's loss is the same
    assert len({r["loss"] for r in points}) == 1
    assert best == {"best": max(points, key=lambda r: r["tokens_per_s"])}


def test_bench_decompose_tiny_emits_sections(monkeypatch, capsys):
    _clean_env(monkeypatch, "PBST_DECOMP_")
    monkeypatch.setenv("PBST_DECOMP_TINY", "1")
    assert bench_decompose.main([]) == 0
    rows = _rows(capsys.readouterr().out)
    assert [set(r) for r in rows] == DECOMP_KEYS, rows
    cost = rows[0]
    # The counted step: the 6N convention plus attention and AdamW.
    assert 1.0 < cost["ratio_vs_6N"] < 1.5, cost
    assert cost["hbm_bytes_per_token"] > 0
    assert rows[1]["remat_tax_frac"] == 0.0  # the tiny config has no remat
    assert rows[5]["measured_source"] == "host"


def test_remat_dots_costs_more_counted_flops_than_none():
    """The remat tax the decomposition reports: remat "dots" recomputes
    attention and the activations in the backward, so its counted FLOPs
    exceed remat off's, by less than a second forward."""
    import dataclasses

    cfg = graft_entry._flagship_cfg(tiny=True)
    dots = dataclasses.replace(cfg, remat=True, remat_policy="dots")
    f_dots, _ = bench_decompose.counted_step(dots, 2, 64, "cpu")
    f_none, _ = bench_decompose.counted_step(cfg, 2, 64, "cpu")
    assert f_none < f_dots < f_none * 4 / 3
