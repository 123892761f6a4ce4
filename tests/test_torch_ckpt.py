"""Checkpoints on the port, against ``pbs_tpu``: twins of
``tests/test_async_ckpt.py``, the checkpoint and replicator cases of
``tests/test_ckpt_store_events.py`` and the torn-write case of
``tests/test_fault_injection.py``, plus the cross-package restores.

The on-disk format is shared: the same state saved by each package
gives byte-identical leaf files and manifests equal but for
``treedef`` and ``wall_time``; a whole toy train state saved by either
restores bit for bit into the other's template; a bf16 leaf the JAX
package wrote restores bit for bit in the port, while the reference's
own restore refuses it (pinned below as the reference's behaviour, the
departure by design ROADMAP queue 3 records).
"""

from __future__ import annotations

import filecmp
import json
import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pbs_tpu import ckpt as ref_ckpt  # noqa: E402
from pbs_tpu import models as ref_models  # noqa: E402
from pbs_tpu.faults import FaultPlan as RefPlan  # noqa: E402
from pbs_tpu.faults import FaultSpec as RefSpec  # noqa: E402
from pbs_tpu.faults import injector as ref_faults  # noqa: E402
from pbs_tpu_torch import ckpt as port_ckpt  # noqa: E402
from pbs_tpu_torch import models as port_models  # noqa: E402
from pbs_tpu_torch.faults import FaultPlan, FaultSpec  # noqa: E402
from pbs_tpu_torch.faults import injector as port_faults  # noqa: E402
from pbs_tpu_torch.faults.injector import InjectedFault  # noqa: E402
from pbs_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

#: A 2-layer toy decoder: its train state has 38 leaves in both packages.
TOY = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
           d_ff=64, max_seq=64)


def _state(seed: int = 0) -> dict:
    """The reference's ``state_pytree`` shape, from a numpy seed: one
    tree of numpy leaves both packages save."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "nested": {"b": np.arange(4, dtype=np.int32), "step": 7}}


def _torch_state(seed: int = 0) -> dict:
    s = _state(seed)
    return {"w": torch.from_numpy(s["w"]),
            "nested": {"b": torch.from_numpy(s["nested"]["b"]),
                       "step": 7}}


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return {k: v for k, v in m.items() if k not in ("treedef", "wall_time")}


def _same_files(a: str, b: str) -> None:
    """Two checkpoints' leaf files byte for byte, manifests but for
    treedef and wall_time."""
    ma, mb = _manifest(a), _manifest(b)
    assert ma == mb
    for e in ma["leaves"]:
        assert filecmp.cmp(os.path.join(a, e["file"]),
                           os.path.join(b, e["file"]), shallow=False), e
    for extra in ("telemetry.npy",):
        assert os.path.exists(os.path.join(a, extra)) == os.path.exists(
            os.path.join(b, extra))
        if os.path.exists(os.path.join(a, extra)):
            assert filecmp.cmp(os.path.join(a, extra),
                               os.path.join(b, extra), shallow=False)


# -- twins of tests/test_ckpt_store_events.py ------------------------------


def test_checkpoint_roundtrip_same_files(tmp_path):
    tel = np.arange(18, dtype=np.uint64)
    paths = {}
    for name, ck, state in (("ref", ref_ckpt, _state()),
                            ("port", port_ckpt, _torch_state())):
        paths[name] = str(tmp_path / name / "ckpt")
        m = ck.save_checkpoint(paths[name], state, metadata={"job": "test"},
                               telemetry=tel)
        assert ck.checkpoint_exists(paths[name])
        assert m["metadata"]["job"] == "test"
    _same_files(paths["ref"], paths["port"])
    for src in paths.values():  # the port restores either package's
        restored, m2 = port_ckpt.restore_checkpoint(src,
                                                    like=_torch_state(5))
        assert torch.equal(restored["w"], _torch_state()["w"])
        assert torch.equal(restored["nested"]["b"],
                           _torch_state()["nested"]["b"])
        assert restored["nested"]["step"] == 7
        np.testing.assert_array_equal(m2["_telemetry"], tel)
    got, _ = ref_ckpt.restore_checkpoint(paths["port"], like=_state(5))
    np.testing.assert_array_equal(got["w"], _state()["w"])


def test_checkpoint_atomic_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    port_ckpt.save_checkpoint(path, _torch_state(0))
    port_ckpt.save_checkpoint(path, _torch_state(1))
    restored, _ = port_ckpt.restore_checkpoint(path, like=_torch_state())
    assert torch.equal(restored["w"], _torch_state(1)["w"])
    assert not os.path.exists(path + ".old")


@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_checkpoint_mismatch_rejected_alike(tmp_path, what):
    """Shape and dtype mismatches raise ValueError with the reference's
    message, for numpy templates and tensor templates alike."""
    path = str(tmp_path / "ckpt")
    ref_ckpt.save_checkpoint(path, {"w": np.zeros((2, 2), np.float32)})
    bad = (np.zeros((3, 3), np.float32) if what == "shape"
           else np.zeros((2, 2), np.float64))
    with pytest.raises(ValueError, match=what) as ref_err:
        ref_ckpt.restore_checkpoint(path, like={"w": bad})
    with pytest.raises(ValueError, match=what) as port_err:
        port_ckpt.restore_checkpoint(path, like={"w": bad})
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match=what):
        port_ckpt.restore_checkpoint(path, like={"w": torch.from_numpy(bad)})


def test_checkpoint_path_never_missing_during_save(tmp_path):
    path = str(tmp_path / "ckpt")
    for seed in range(3):
        port_ckpt.save_checkpoint(path, _torch_state(seed))
        assert port_ckpt.checkpoint_exists(path)
    assert os.path.islink(path)
    gens = [d for d in os.listdir(tmp_path)
            if d.startswith(".ckpt.gen.") and not d.endswith(".lnk")]
    assert len(gens) == 1  # only one generation retained


def test_load_checkpoint_template_free(tmp_path):
    """Key-path manifests: plain dict/list trees reload without a
    template, from either package's files; bare-leaf and tuple-bearing
    states fall back loudly to restore_checkpoint."""
    st = {"a": {"b": [np.ones(2), np.arange(3)]}, "c": np.int32(5)}
    for ck in (ref_ckpt, port_ckpt):
        ok = str(tmp_path / ck.__name__ / "ok")
        ck.save_checkpoint(ok, st, metadata={"m": 1})
        got, meta = port_ckpt.load_checkpoint(ok)
        assert torch.equal(got["a"]["b"][1], torch.arange(3))
        assert got["c"] == 5 and meta["m"] == 1
    _same_files(str(tmp_path / ref_ckpt.__name__ / "ok"),
                str(tmp_path / port_ckpt.__name__ / "ok"))

    bare = str(tmp_path / "bare")
    port_ckpt.save_checkpoint(bare, torch.ones(3))
    with pytest.raises(ValueError, match="restore_checkpoint"):
        port_ckpt.load_checkpoint(bare)
    tup = str(tmp_path / "tup")
    port_ckpt.save_checkpoint(tup, {"x": (torch.ones(2), torch.zeros(2))})
    with pytest.raises(ValueError, match="restore_checkpoint"):
        port_ckpt.load_checkpoint(tup)
    got, _ = port_ckpt.restore_checkpoint(
        tup, {"x": (torch.zeros(2), torch.zeros(2))})
    assert isinstance(got["x"], tuple) and torch.equal(got["x"][0],
                                                       torch.ones(2))


def test_replicator_epochs_and_retention(tmp_path):
    for ck in (ref_ckpt, port_ckpt):
        base = str(tmp_path / ck.__name__ / "remus")
        counter = {"n": 0}

        def snap():
            counter["n"] += 1
            return ({"step": np.int64(counter["n"])},
                    {"epoch": counter["n"]}, None)

        rep = ck.Replicator(base, snap, keep=2)
        for _ in range(5):
            rep.replicate_once()
        epochs = sorted(d for d in os.listdir(base)
                        if d.startswith("epoch_"))
        assert epochs == ["epoch_00000003", "epoch_00000004"]  # retention
        restored, m = ck.restore_checkpoint(rep.latest(),
                                            like={"step": np.int64(0)})
        assert int(restored["step"]) == 5 and m["metadata"] == {"epoch": 5}


def test_replicator_resumes_epoch_numbering(tmp_path):
    base = str(tmp_path / "remus")
    counter = {"n": 0}

    def snap():
        counter["n"] += 1
        return {"step": torch.tensor(counter["n"])}, {}, None

    rep = port_ckpt.Replicator(base, snap, keep=2)
    for _ in range(5):
        rep.replicate_once()
    rep2 = port_ckpt.Replicator(base, snap, keep=2)  # process restart
    rep2.replicate_once()
    restored, _ = port_ckpt.restore_checkpoint(
        rep2.latest(), like={"step": torch.tensor(0)})
    assert int(restored["step"]) == 6  # newest, not the stale epoch
    # the reference reads the port's epochs the same way
    got, _ = ref_ckpt.restore_checkpoint(rep2.latest(),
                                         like={"step": np.int64(0)})
    assert int(got["step"]) == 6


def test_replicator_records_failures(tmp_path):
    def bad_snap():
        raise OSError("disk full")

    rep = port_ckpt.Replicator(str(tmp_path / "r"), bad_snap, period_s=0.01)
    rep.start()
    deadline = time.time() + 2.0
    while rep.failures == 0 and time.time() < deadline:
        time.sleep(0.01)
    rep.stop()
    assert rep.failures > 0
    assert "disk full" in rep.last_error


def test_torn_checkpoint_write_keeps_published_generation(tmp_path):
    """The ``ckpt.write`` seam of each package's injector dies
    mid-serialization in both; the published generation stays."""
    for ck, faults, plan, spec, err in (
            (ref_ckpt, ref_faults, RefPlan, RefSpec,
             ref_faults.InjectedFault),
            (port_ckpt, port_faults, FaultPlan, FaultSpec, InjectedFault)):
        d = tmp_path / ck.__name__
        path = str(d / "ck")
        ck.save_checkpoint(path, {"w": [1.0, 2.0], "b": [3.0]})
        faults.install(plan(seed=0, specs=(
            spec("ckpt.write", "torn", p=1.0, key="ck"),)))
        try:
            with pytest.raises(err, match="torn"):
                ck.save_checkpoint(path, {"w": [9.0, 9.0], "b": [9.0]})
        finally:
            faults.uninstall()
        state, _ = ck.load_checkpoint(path)
        assert [float(x) for x in state["w"]] == [1.0, 2.0]
        assert [p for p in d.iterdir()
                if p.name.startswith(".ckpt_tmp_")] == []


# -- twins of tests/test_async_ckpt.py --------------------------------------


def _async_state(v):
    return {"w": torch.full((64, 64), float(v)), "step": v}


def test_async_save_restores_identically(tmp_path):
    paths = {}
    for name, ck, state in (
            ("ref", ref_ckpt, {"w": jnp.full((64, 64), 7.0), "step": 7}),
            ("port", port_ckpt, _async_state(7))):
        paths[name] = str(tmp_path / name / "ck")
        a = ck.AsyncCheckpointer()
        a.save(paths[name], state)
        manifest = a.wait()
        assert manifest is not None and ck.checkpoint_exists(paths[name])
    _same_files(paths["ref"], paths["port"])
    got, _ = port_ckpt.restore_checkpoint(paths["port"],
                                          like=_async_state(0))
    assert torch.equal(got["w"], torch.full((64, 64), 7.0))
    assert got["step"] == 7


def test_snapshot_is_immune_to_later_mutation(tmp_path):
    """After save() returns, overwriting the tensors in place (what the
    port's training step does) must not corrupt the checkpoint."""
    path = str(tmp_path / "ck")
    state = {"w": torch.full((256, 256), 1.0, dtype=torch.float64),
             "n": np.full((8,), 2.0), "step": 1}
    ck = port_ckpt.AsyncCheckpointer()
    ck.save(path, state)
    state["w"].fill_(-999.0)
    state["n"][:] = -999.0
    ck.wait()
    got, _ = port_ckpt.restore_checkpoint(
        path, like={"w": torch.zeros(256, 256, dtype=torch.float64),
                    "n": np.zeros(8), "step": 0})
    assert torch.equal(got["w"], torch.full((256, 256), 1.0,
                                            dtype=torch.float64))
    np.testing.assert_array_equal(got["n"], np.full((8,), 2.0))


def test_non_owning_view_leaves_are_copied(tmp_path):
    path = str(tmp_path / "ck")
    base = np.zeros((128, 128), np.float32)
    view = base[:]
    assert not view.flags.owndata
    tbase = torch.zeros(128, 128)
    ck = port_ckpt.AsyncCheckpointer()
    ck.save(path, {"w": view, "t": tbase[:, :64]})
    base[:] = -1.0
    tbase.fill_(-1.0)
    ck.wait()
    got, _ = port_ckpt.restore_checkpoint(
        path, like={"w": np.zeros((128, 128), np.float32),
                    "t": torch.zeros(128, 64)})
    np.testing.assert_array_equal(got["w"], np.zeros((128, 128)))
    assert torch.equal(got["t"], torch.zeros(128, 64))


def test_single_save_in_flight_backpressure(tmp_path):
    path = str(tmp_path / "ck")
    ck = port_ckpt.AsyncCheckpointer()
    ck.save(path, _async_state(1))
    ck.save(path, _async_state(2))  # waits for save 1's write
    ck.wait()
    assert ck.saves == 2
    got, _ = port_ckpt.restore_checkpoint(path, like=_async_state(0))
    assert got["step"] == 2


def test_background_failure_surfaces_at_next_call(tmp_path):
    ck = port_ckpt.AsyncCheckpointer()
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    ck.save(str(blocker / "nested" / "ck"), _async_state(1))
    with pytest.raises(OSError):
        ck.wait()
    # the error is raised exactly once; the checkpointer is reusable
    ck.save(str(tmp_path / "ok"), _async_state(3))
    assert ck.wait() is not None


def test_io_overlaps_caller(tmp_path):
    path = str(tmp_path / "ck")
    big = {"w": torch.ones(2048, 2048)}  # ~16 MB
    ck = port_ckpt.AsyncCheckpointer()
    t0 = time.perf_counter()
    ck.save(path, big)
    returned_after = time.perf_counter() - t0
    in_flight_seen = ck.in_flight
    ck.wait()
    assert port_ckpt.checkpoint_exists(path)
    assert in_flight_seen or returned_after < 0.5


# -- across the two packages ------------------------------------------------


def _ref_train_state(steps: int):
    """The reference's toy train state after ``steps`` eager steps (as
    a booted image runs them): (params, optax state, Python-int step)."""
    cfg = ref_models.TransformerConfig(**TOY, dtype=jnp.float32)
    params = ref_models.init_params(cfg, jax.random.PRNGKey(0))
    init_opt, step = ref_models.make_train_step(cfg, learning_rate=1e-2)
    state = (params, jax.jit(init_opt)(params), 0)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        toks = rng.integers(0, TOY["vocab"], size=(2, 17)).astype(np.int32)
        state, _ = step(state, jnp.asarray(toks))
    return state


def _port_template():
    cfg = port_models.TransformerConfig(**TOY, dtype=torch.float32)
    params = port_models.init_params(cfg, torch.Generator().manual_seed(1),
                                     device="cpu")
    init_opt, step = port_models.make_train_step(cfg, learning_rate=1e-2)
    return (params, init_opt(params), 0), step


def test_jax_train_state_restores_into_the_port_bitwise(tmp_path):
    ref_state = _ref_train_state(steps=2)
    path = str(tmp_path / "ck")
    ref_ckpt.save_checkpoint(path, ref_state)
    like, _ = _port_template()
    got, m = port_ckpt.restore_checkpoint(path, like=like)
    want = jax.tree_util.tree_leaves(ref_state)
    have = tree_leaves(got)
    assert m["n_leaves"] == len(want) == len(have) == 38
    for w, h in zip(want, have):
        w = np.asarray(w)
        hv = np.asarray(h) if not isinstance(h, torch.Tensor) else h.numpy()
        assert hv.dtype == w.dtype and np.array_equal(hv, w)
    assert got[2] == 2 and isinstance(got[2], int)
    assert got[1]["count"].dtype == torch.int32 and int(got[1]["count"]) == 2
    # the key order of the template survives the restore
    assert list(got[0]) == list(like[0])
    assert list(got[1]["mu"]["layers"]) == list(like[1]["mu"]["layers"])


def test_port_train_state_restores_into_jax_bitwise(tmp_path):
    state, step = _port_template()
    rng = np.random.default_rng(0)
    for _ in range(2):
        toks = rng.integers(0, TOY["vocab"], size=(2, 17)).astype(np.int32)
        state, _ = step(state, torch.from_numpy(toks))
    path = str(tmp_path / "ck")
    port_ckpt.save_checkpoint(path, state)
    like = _ref_train_state(steps=0)
    got, m = ref_ckpt.restore_checkpoint(path, like=like)
    have = jax.tree_util.tree_leaves(got)
    want = tree_leaves(state)
    assert m["n_leaves"] == len(have) == len(want) == 38
    for w, h in zip(want, have):
        wv = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.asarray(h).dtype == wv.dtype
        assert np.array_equal(np.asarray(h), wv)
    assert int(got[1][0].count) == 2 and int(got[2]) == 2


def test_jax_bf16_leaf_restores_in_the_port_bitwise(tmp_path):
    """The bf16 leaf the JAX package writes ('<V2' records, manifest
    "bfloat16") restores bit for bit in the port; the port writes the
    same bytes; the reference's own restore refuses it (pinned)."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_checkpoint(ref_path, {"w": jw})
    port_ckpt.save_checkpoint(port_path,
                              {"w": torch.from_numpy(w).bfloat16()})
    _same_files(ref_path, port_path)
    got, _ = port_ckpt.restore_checkpoint(
        ref_path, like={"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    want_bits = np.asarray(jw).view(np.uint16)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                          want_bits)
    loaded, _ = port_ckpt.load_checkpoint(ref_path)
    assert torch.equal(loaded["w"], got["w"])
    with pytest.raises(ValueError, match=r"dtype \|V2 != template bfloat16"):
        ref_ckpt.restore_checkpoint(ref_path,
                                    like={"w": jnp.zeros((3, 5),
                                                         jnp.bfloat16)})
