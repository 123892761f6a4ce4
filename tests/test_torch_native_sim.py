"""The port's native sim dispatch core: tier invariance and degradation.

Twins of ``tests/test_sim_native.py``: the port's pure-Python engine is
the witness, and its C core (``pbst_sim_run`` in the port's copy of the
runtime) must give bit-identical metrics reports, trace digests and
tuned-profile check digests on its ctypes and fastcall tiers — and the
reference's native core's, so a digest recorded by either package's
native core replays on the other's. The state block's words are held to
the C enum and to the knob registry's ``native=`` symbols. Native cases
skip, naming the cached reason, only where the toolchain is missing;
the degradation cases run everywhere.
"""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

from pbs_tpu.sim import engine as ref_engine  # noqa: E402
from pbs_tpu.sim import native_core as ref_core  # noqa: E402
from pbs_tpu_torch.runtime import native  # noqa: E402
from pbs_tpu_torch.sim import native_core  # noqa: E402
from pbs_tpu_torch.sim.engine import ListSchedulerProbe, SimEngine  # noqa: E402
from pbs_tpu_torch.sim.sweep import (  # noqa: E402
    META_KEYS,
    build_grid,
    native_stamp,
    sweep,
    sweep_digest,
)

#: The module: ``pbs_tpu.sim``'s own name ``sweep`` is the function.
ref_sweep = importlib.import_module("pbs_tpu.sim.sweep")
MS = 1_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiers() -> list[str]:
    """Binding tiers present on this host (ctypes whenever the library
    loads; fastcall with Python.h at build time)."""
    if native_core.available_tier() is None:
        pytest.skip(f"native sim core unavailable: "
                    f"{native.unavailable_reason() or native.last_failure()}")
    tiers = ["ctypes"]
    if native_core.available_tier("fastcall") is not None:
        tiers.append("fastcall")
    return tiers


def _run(policy: str, native_req, workload: str = "mixed", seed: int = 17,
         record: bool = True, cls=SimEngine, **kw) -> dict:
    return cls(workload=workload, policy=policy, seed=seed, n_tenants=4,
               horizon_ns=60 * MS, record=record, native=native_req,
               **kw).run()


# -- the layout ----------------------------------------------------------------


def _c_enum(prefix: str) -> list[str]:
    """The names of the C core's ``enum { <prefix>... }`` in order."""
    src = open(os.path.join(REPO, "pbs_tpu_torch", "runtime", "csrc",
                            "pbst_runtime.cc")).read()
    for body in re.findall(r"enum\s*\{([^}]*)\}", src):
        names = [t.split("=")[0].strip() for t in body.split(",")]
        names = [n for n in names if n]
        if names and names[0].startswith(prefix):
            return names
    raise AssertionError(f"no {prefix} enum in the C core")


@pytest.mark.parametrize("prefix,words", [("GS_", "GS_WORDS"),
                                          ("GF_", "GF_WORDS"),
                                          ("J_", "JS_WORDS"),
                                          ("JF_", "JF_WORDS")])
def test_state_words_equal_the_c_enum(prefix, words):
    names = _c_enum(prefix)
    assert names[-1] == words
    for i, n in enumerate(names[:-1]):
        assert getattr(native_core, n) == i, n
    assert getattr(native_core, words) == len(names) - 1
    assert getattr(native_core, words) == getattr(ref_core, words)


def test_knob_native_symbols_are_the_core_s_words():
    """Every registry knob that names a ``native=`` symbol names a word
    of the state block, at the C enum's index."""
    from pbs_tpu_torch import knobs

    declared = [k for k in knobs.all_knobs() if k.native]
    assert declared
    enum = _c_enum("GS_") + _c_enum("GF_")
    for k in declared:
        assert k.native in enum, k.name
        prefix = k.native.split("_", 1)[0] + "_"
        assert getattr(native_core, k.native) == \
            _c_enum(prefix).index(k.native), k.name


def test_layout_mirrors_are_the_reference_s():
    for name in ("SIM_ABI_VERSION", "GS_WORDS", "GF_WORDS", "JS_WORDS",
                 "JF_WORDS", "PH_I_WORDS", "PH_F_WORDS", "HP_WORDS",
                 "EV_WORDS", "MAX_WINDOW", "MAX_STEPS_PER_QUANTUM"):
        assert getattr(native_core, name) == getattr(ref_core, name), name


# -- tier invariance -------------------------------------------------------------


@pytest.mark.parametrize("policy", ["credit", "feedback", "atc"])
def test_record_mode_cross_tier_digest(policy):
    """Same seed ⇒ the same trace digest and report on every tier, and
    on the reference's native core."""
    tiers = _tiers()
    py = _run(policy, False)
    for tier in tiers:
        nat = _run(policy, tier)
        assert nat["trace_digest"] == py["trace_digest"], tier
        assert json.dumps(nat, sort_keys=True) == \
            json.dumps(py, sort_keys=True), tier
    ref = _run(policy, None, cls=ref_engine.SimEngine)
    assert ref["trace_digest"] == py["trace_digest"]


def test_sweep_mode_cross_tier_report():
    py = _run("credit", False, record=False)
    for tier in _tiers():
        assert _run("credit", tier, record=False) == py, tier


def test_native_against_list_probe_witness():
    _tiers()
    lst = _run("feedback", False, record=False, probe_cls=ListSchedulerProbe)
    assert _run("feedback", True, record=False) == lst


def test_reference_native_core_equals_the_port_s():
    """A reference-native run and a port-native run of one cell give
    one report (the reference stamps its own tier)."""
    _tiers()
    for policy in ("credit", "feedback", "atc"):
        ours = _run(policy, True, workload="contended", record=False)
        ref = ref_engine.SimEngine(
            workload="contended", policy=policy, seed=17, n_tenants=4,
            horizon_ns=60 * MS, record=False, native=None)
        theirs = ref.run()
        assert ours == theirs, policy


# -- degradation -------------------------------------------------------------------


def test_forcing_native_off_reproduces_auto():
    auto = SimEngine(workload="stable", policy="feedback", seed=5,
                     horizon_ns=50 * MS, record=False).run()
    off = SimEngine(workload="stable", policy="feedback", seed=5,
                    horizon_ns=50 * MS, record=False, native=False).run()
    assert auto == off


def test_unsupported_configs_degrade_to_python():
    eng = SimEngine(workload="stable", policy="credit", seed=1,
                    horizon_ns=20 * MS, record=False,
                    probe_cls=ListSchedulerProbe)
    eng.run()
    assert eng.native_tier_used is None
    eng = SimEngine(workload="stable", policy="credit", seed=1,
                    horizon_ns=20 * MS, record=False, n_executors=2)
    eng.run()
    assert eng.native_tier_used is None
    eng = SimEngine(workload="stable", policy="credit2", seed=1,
                    horizon_ns=20 * MS, record=False)
    eng.run()
    assert eng.native_tier_used is None
    eng = SimEngine(workload="stable", policy="credit", seed=1,
                    horizon_ns=20 * MS)
    eng.run()
    assert eng.native_tier_used is None
    eng = SimEngine(workload="stable", policy="credit", seed=1,
                    horizon_ns=20 * MS, record=False)
    eng.run()
    assert eng.native_tier_used == native_core.available_tier()


def test_auto_degrades_when_core_unavailable(monkeypatch):
    monkeypatch.setattr(native_core, "available_tier",
                        lambda want=None: None)
    eng = SimEngine(workload="stable", policy="feedback", seed=2,
                    horizon_ns=20 * MS, record=False)
    eng.run()
    assert eng.native_tier_used is None
    st = native_core.stamp()
    assert st["native_available"] is False and st["native_error"]
    with pytest.raises(RuntimeError, match="native"):
        SimEngine(workload="stable", policy="feedback", seed=2,
                  horizon_ns=20 * MS, record=False, native=True).run()


def test_explicit_native_request_raises_when_unusable():
    with pytest.raises(RuntimeError, match="native"):
        SimEngine(workload="stable", policy="credit", seed=1,
                  horizon_ns=20 * MS, record=False, n_executors=2,
                  native=True).run()


def test_native_stamp_shape():
    st = native_stamp()
    assert set(st) >= {"native_available", "native_tier"}
    assert set(st) == set(ref_sweep.native_stamp())
    if not st["native_available"]:
        assert st["native_error"]
    else:
        assert st["native_tier"] == native.tier()


# -- the sweep ---------------------------------------------------------------------


def _sweep_cells():
    return build_grid(["contended"], ["credit", "feedback"], n_reps=2,
                      horizon_ns=30 * MS)


def test_sweep_worker_parity_native_off():
    cells = _sweep_cells()
    inline = sweep(cells, base_seed=3, workers=1, native=False)
    fanned = sweep(cells, base_seed=3, workers=2, native=False)
    assert inline == fanned
    assert sweep_digest(inline) == sweep_digest(fanned)


def test_sweep_worker_parity_native_on():
    _tiers()
    cells = _sweep_cells()
    inline = sweep(cells, base_seed=3, workers=1, native=True)
    fanned = sweep(cells, base_seed=3, workers=2, native=True)
    assert inline == fanned
    off = sweep(cells, base_seed=3, workers=1, native=False)
    assert sweep_digest(inline) == sweep_digest(off)
    assert all(r["native_tier"] != "python" for r in inline)
    assert all(r["native_tier"] == "python" for r in off)
    for r in inline:
        assert set(META_KEYS) <= set(r)
    ref_cells = ref_sweep.build_grid(["contended"], ["credit", "feedback"],
                                     n_reps=2, horizon_ns=30 * MS)
    theirs = ref_sweep.sweep(ref_cells, base_seed=3, native=True)
    assert ref_sweep.sweep_digest(theirs) == sweep_digest(inline)


# -- tuned profiles ------------------------------------------------------------------


def test_tuned_profile_check_digest_cross_tier():
    """A check grid scored on the port's native core and on its Python
    witness hashes identically, and equals the reference's native
    digest of the same grid."""
    from pbs_tpu.sched import tune as ref_tune
    from pbs_tpu_torch.sched import tune

    _tiers()
    wl = "contended"
    prof = tune.load_profile(wl)
    kw = dict(base_seed=0, horizon_ns=40 * MS, n_reps=1, n_tenants=4)
    a = tune.check_block(wl, prof["policy"], prof["params"], **kw)
    assert a["tier"] in ("fastcall", "ctypes")
    cells = tune._cells_for(wl, prof["policy"], prof["params"],
                            kw["horizon_ns"], kw["n_reps"])
    nat = sweep(cells, base_seed=0, native=True)
    py = sweep(cells, base_seed=0, native=False)
    assert sweep_digest(nat) == sweep_digest(py)
    b = ref_tune.check_block(wl, prof["policy"], prof["params"], **kw)
    assert a["digest"] == b["digest"]


@pytest.mark.parametrize("workload", ["stable", "phases", "serving"])
def test_recorded_trace_replays_on_the_native_core(tmp_path, workload):
    """A run recorded by the reference's native core, replayed through
    the port's native core from the trace's own header: one digest."""
    _tiers()
    path = str(tmp_path / "ref.jsonl")
    ref_run = ref_engine.SimEngine(workload=workload, policy="feedback",
                                   seed=9, n_tenants=4, horizon_ns=60 * MS,
                                   trace_path=path, native=True).run()
    ours = SimEngine(workload=workload, policy="feedback", seed=9,
                     n_tenants=4, horizon_ns=60 * MS, record=True,
                     native=True)
    got = ours.run()
    assert ours.native_tier_used in ("fastcall", "ctypes")
    assert got["trace_digest"] == ref_run["trace_digest"]
