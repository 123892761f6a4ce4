"""Job images and consoles on the port, against ``pbs_tpu``: twins of
the image and console cases of ``tests/test_image_console_hooks.py``
(its lifecycle-hook and control-plane cases wait for ROADMAP queue 1,
items 9 and 12).

Both packages write the same ``image.json`` for the same arguments, and
an image written by either boots in the other: a JAX-written toy image
(``attn_impl: "pallas"``, corpus data, a warm checkpoint) boots in the
port on the CPU, and its first step's loss agrees with the JAX boot's
within rtol 2e-4, atol 2e-5, its updated parameters within rtol 2e-4,
atol 2e-6 (the bounds of ``tests/test_torch_train.py``; the JAX side
runs the Pallas kernels in interpret mode, the port the plain flash
backward). Console lines are the reference's, word for word.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pbs_tpu.runtime as ref_rt  # noqa: E402
import pbs_tpu_torch.runtime as port_rt  # noqa: E402
from pbs_tpu.ckpt import remove_checkpoint  # noqa: E402
from pbs_tpu.data.tokens import write_token_file  # noqa: E402
from pbs_tpu.obs import console as ref_console  # noqa: E402
from pbs_tpu.runtime.image import _make_batch_fn as ref_batch_fn  # noqa: E402
from pbs_tpu.telemetry import SimBackend as RefSim  # noqa: E402
from pbs_tpu.telemetry import SimProfile as RefProfile  # noqa: E402
from pbs_tpu_torch.obs import console as port_console  # noqa: E402
from pbs_tpu_torch.runtime.image import _make_batch_fn  # noqa: E402
from pbs_tpu_torch.telemetry import CudaBackend, SimBackend, SimProfile  # noqa: E402
from pbs_tpu_torch.utils.tree import tree_leaves  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

TINY = dict(vocab=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64, dtype="float32")
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)


def _part():
    return port_rt.Partition("p", source=CudaBackend(device="cpu"))


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "image.json")) as f:
        return json.load(f)


# -- images (pygrub) --------------------------------------------------------


def test_save_image_writes_the_reference_manifest(tmp_path):
    kw = dict(sched={"weight": 320},
              train={"batch": 2, "seq": 32, "max_steps": 2},
              data={"kind": "corpus", "path": "shard.tok"},
              metadata={"label": "svc"})
    ref_rt.save_image(str(tmp_path / "r"), "transformer",
                      {**TINY, "dtype": jnp.bfloat16}, **kw)
    port_rt.save_image(str(tmp_path / "p"), "transformer",
                       {**TINY, "dtype": torch.bfloat16}, **kw)
    assert _manifest(str(tmp_path / "p")) == _manifest(str(tmp_path / "r"))
    assert _manifest(str(tmp_path / "p"))["config"]["dtype"] == "bfloat16"


def test_cold_boot_image_runs(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY, sched={"weight": 320},
                       train={"batch": 2, "seq": 32, "max_steps": 2})
    job = port_rt.boot_job(path, device="cpu")
    assert job.params.weight == 320 and job.max_steps == 2
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    assert job.steps_retired() == 2 and job.error is None
    assert job.state[2] == 2 and int(job.state[1]["count"]) == 2


def test_boot_needs_the_card_unless_asked_for_the_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rt.boot_job(path)


def test_warm_boot_restores_checkpoint(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32})
    job = port_rt.boot_job(path, max_steps=3, device="cpu")
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    assert job.state[2] == 3  # step counter advanced
    port_rt.save_image(path, "transformer", TINY, state=job.state,
                       train={"batch": 2, "seq": 32})
    job2 = port_rt.boot_job(path, name="warm", max_steps=5, device="cpu")
    assert job2.state[2] == 3 and job2.name == "warm"
    for a, b in zip(tree_leaves(job.state), tree_leaves(job2.state)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_port_image_boots_warm_in_jax(tmp_path):
    """The other direction: a port-written warm image boots in the JAX
    package with every leaf bit for bit."""
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32})
    job = port_rt.boot_job(path, max_steps=2, device="cpu")
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    port_rt.save_image(path, "transformer", TINY, state=job.state,
                       train={"batch": 2, "seq": 32})
    jjob = ref_rt.boot_job(path, max_steps=4)
    got = jax.tree_util.tree_leaves(jjob.state)
    want = tree_leaves(job.state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        wv = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(np.asarray(g), wv)


def test_moe_image_kind_waits_for_moe(tmp_path):
    """A "moe" image boots the MoE family (it raised until MoE was
    ported) and its step trains with the MoE metrics."""
    path = str(tmp_path / "img")
    port_rt.save_image(path, "moe", {**TINY, "n_experts": 4, "top_k": 2},
                       train={"batch": 2, "seq": 32, "max_steps": 1})
    job = port_rt.boot_job(path, device="cpu")
    assert set(job.state[0]["layers"]) >= {"router", "we1", "we2", "we3"}
    _, metrics = job.step_fn(job.state)
    assert set(metrics) == {"loss", "aux_loss", "moe_drop_frac", "tokens"}
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    assert job.steps_retired() == 1 and job.error is None


def test_warm_image_with_missing_checkpoint_refuses_cold_boot(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32})
    job = port_rt.boot_job(path, max_steps=1, device="cpu")
    port_rt.save_image(path, "transformer", TINY, state=job.state,
                       train={"batch": 2, "seq": 32})
    remove_checkpoint(os.path.join(path, "ckpt"))  # partial-rsync case
    with pytest.raises(FileNotFoundError, match="refusing to cold-boot"):
        port_rt.boot_job(path, device="cpu")


def test_image_spec_rejects_unknown_sched_key(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32, "max_steps": 1})
    part = _part()
    with pytest.raises(KeyError, match="wieght"):
        port_rt.image_workload(part, "oops",
                               {"path": path, "sched": {"wieght": 512}},
                               device="cpu")
    assert part.jobs == []
    job = port_rt.image_workload(
        part, "booted", {"path": path, "sched": {"weight": 777},
                         "label": "svc"}, device="cpu")
    part.run(max_rounds=5)
    assert job.params.weight == 777 and job.label == "svc"
    assert job.steps_retired() == 1


def test_bad_manifest_rejected(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY)
    m = _manifest(path)
    m["kind"] = "diffusion"
    with open(os.path.join(path, "image.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="unknown image kind"):
        port_rt.boot_job(path, device="cpu")


def test_image_with_bundled_corpus(tmp_path):
    path = str(tmp_path / "img")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    write_token_file(os.path.join(path, "shard.tok"),
                     rng.integers(0, 64, size=8_192))
    port_rt.save_image(path, "transformer", TINY,
                       train={"batch": 2, "seq": 32, "max_steps": 3},
                       data={"kind": "corpus", "path": "shard.tok"})
    job = port_rt.boot_job(path, device="cpu")
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    assert job.steps_retired() == 3 and job.error is None


@pytest.mark.parametrize("sampling", ["sequential", "random"])
def test_image_corpus_batches_are_the_reference_batches(tmp_path, sampling):
    corpus = str(tmp_path / "c.tok")
    write_token_file(corpus, np.arange(1_000) % 64)
    spec = {"kind": "corpus", "path": corpus, "sampling": sampling}
    fn = _make_batch_fn(spec, str(tmp_path), batch=2, seq=16, vocab=64,
                        seed=3, device="cpu")
    ref = ref_batch_fn(spec, str(tmp_path), batch=2, seq=16, vocab=64,
                       seed=3)
    for step in range(3):
        np.testing.assert_array_equal(fn(step).numpy(), np.asarray(ref(step)))
    assert torch.equal(fn(0), fn(0)) and not torch.equal(fn(0), fn(1))


def test_synthetic_batches_are_seeded_per_step(tmp_path):
    fn = _make_batch_fn({"kind": "synthetic"}, str(tmp_path), batch=2,
                        seq=16, vocab=64, seed=0, device="cpu")
    a = fn(0)
    assert a.shape == (2, 16) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 64
    assert torch.equal(a, fn(0)) and not torch.equal(a, fn(1))


def test_image_bad_data_kind_rejected(tmp_path):
    path = str(tmp_path / "img")
    port_rt.save_image(path, "transformer", TINY, data={"kind": "parquet"})
    with pytest.raises(ValueError, match="unknown data kind"):
        port_rt.boot_job(path, device="cpu")


def test_jax_image_boots_in_the_port(tmp_path):
    """A JAX-written warm image, attention through the flash kernels and
    corpus data, boots in the port: the first step's loss and updated
    parameters match the JAX boot's."""
    path = str(tmp_path / "img")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(1)
    write_token_file(os.path.join(path, "shard.tok"),
                     rng.integers(0, 64, size=8_192))
    kw = dict(train={"batch": 2, "seq": 32, "learning_rate": 1e-2,
                     "seed": 4},
              data={"kind": "corpus", "path": "shard.tok"})
    cfg = {**TINY, "attn_impl": "pallas"}
    ref_rt.save_image(path, "transformer", cfg, **kw)
    cold = ref_rt.boot_job(path)
    ref_rt.save_image(path, "transformer", cfg, state=cold.state, **kw)

    jjob = ref_rt.boot_job(path)
    tjob = port_rt.boot_job(path, device="cpu")
    for g, w in zip(tree_leaves(tjob.state),
                    jax.tree_util.tree_leaves(jjob.state)):
        gv = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(gv, np.asarray(w))  # booted bit for bit
    jstate, jm = jjob.step_fn(jjob.state)
    tstate, tm = tjob.step_fn(tjob.state)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    assert tstate[2] == int(jstate[2]) == 1
    for g, w in zip(tree_leaves(tstate[0]),
                    jax.tree_util.tree_leaves(jstate[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PARAM_TOL)


MOE_TINY = {**TINY, "n_experts": 4, "top_k": 2}


def test_jax_moe_image_boots_in_the_port(tmp_path):
    """A JAX-written warm "moe" image, attention through the flash
    kernels and corpus data: booted bit for bit, and the first step's
    loss and MoE metrics those of the JAX boot. Its updated parameters
    are the port's own make_moe_train_step on the booted state and
    batch, bit for bit. (Against the reference they are held in
    tests/test_torch_moe.py at widths where no gradient element sits
    near Adam's eps: here one does, and the two frameworks' fp32 sums
    put it on either side.)"""
    path = str(tmp_path / "img")
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(1)
    write_token_file(os.path.join(path, "shard.tok"),
                     rng.integers(0, 64, size=8_192))
    kw = dict(train={"batch": 2, "seq": 32, "learning_rate": 1e-2,
                     "seed": 4},
              data={"kind": "corpus", "path": "shard.tok"})
    cfg = {**MOE_TINY, "attn_impl": "pallas"}
    ref_rt.save_image(path, "moe", cfg, **kw)
    cold = ref_rt.boot_job(path)
    ref_rt.save_image(path, "moe", cfg, state=cold.state, **kw)

    jjob = ref_rt.boot_job(path)
    tjob = port_rt.boot_job(path, device="cpu")
    for g, w in zip(tree_leaves(tjob.state),
                    jax.tree_util.tree_leaves(jjob.state)):
        gv = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(gv, np.asarray(w))  # booted bit for bit
    from pbs_tpu_torch.models import MoEConfig, make_moe_train_step
    from pbs_tpu_torch.models.transformer import tree_map

    batch = _make_batch_fn(kw["data"], path, 2, 32, 64, 4, "cpu")(0)
    init, step = make_moe_train_step(
        MoEConfig(**{**cfg, "dtype": torch.float32}), learning_rate=1e-2)
    params = tree_map(torch.clone, tjob.state[0])
    own, _ = step((params, init(params), 0), batch)
    jstate, jm = jjob.step_fn(jjob.state)
    tstate, tm = tjob.step_fn(tjob.state)
    for key in ("loss", "aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   **LOSS_TOL, err_msg=key)
    assert tstate[2] == int(jstate[2]) == 1
    for g, w in zip(tree_leaves(tstate[0]), tree_leaves(own[0])):
        assert torch.equal(g, w)


def test_port_moe_image_boots_warm_in_jax(tmp_path):
    """A port-written warm "moe" image boots in the JAX package with
    every leaf bit for bit."""
    path = str(tmp_path / "img")
    port_rt.save_image(path, "moe", MOE_TINY, train={"batch": 2, "seq": 32})
    job = port_rt.boot_job(path, max_steps=1, device="cpu")
    part = _part()
    part.add_job(job)
    part.run(max_rounds=10)
    port_rt.save_image(path, "moe", MOE_TINY, state=job.state,
                       train={"batch": 2, "seq": 32})
    jjob = ref_rt.boot_job(path, max_steps=2)
    got = jax.tree_util.tree_leaves(jjob.state)
    want = tree_leaves(job.state)
    assert len(got) == len(want) and int(jjob.state[2]) == 1
    for g, w in zip(got, want):
        wv = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.array_equal(np.asarray(g), wv)


# -- consoles (xl console) --------------------------------------------------


def test_console_ring_and_cursors():
    reads = []
    for mod in (ref_console, port_console):
        c = mod.Console(capacity=4)
        for i in range(6):
            c.write(f"line{i}")
        r = c.read(since=0)
        reads.append([{k: v for k, v in r.items() if k != "lines"},
                      [(ln["seq"], ln["line"]) for ln in r["lines"]],
                      c.read(since=r["next"])["lines"],
                      c.read(since=3, max_lines=1)["next"]])
    assert reads[1] == reads[0]
    assert reads[1][0]["dropped"] == 2  # ring of 4: lines 0-1 lost
    assert [ln for _, ln in reads[1][1]] == ["line2", "line3", "line4",
                                            "line5"]


def test_system_console():
    seq = port_console.log("agent quarantined")
    r = port_console.read_system(since=seq)
    assert [ln["line"] for ln in r["lines"]] == ["agent quarantined"]
    assert port_console.system_console() is port_console.system_console()
    assert port_console.system_console() is not ref_console.system_console()


def test_job_lifecycle_lands_in_console():
    lines = []
    for rt, sim, profile in ((ref_rt, RefSim, RefProfile),
                             (port_rt, SimBackend, SimProfile)):
        be = sim()
        be.register("j", profile.steady(step_time_ns=1_000_000))
        part = rt.Partition("p", source=be)
        job = part.add_job(rt.Job("j", max_steps=2))
        job.log("hello from the guest")
        part.run(max_rounds=5)
        part.remove_job(job)
        lines.append([ln["line"] for ln in job.console.read()["lines"]])
    assert lines[1] == lines[0] == ["admitted to p (1 ctx, scheduler credit)",
                                    "hello from the guest", "destroyed"]


def test_fault_containment_writes_console():
    part = _part()

    def bad(state):
        raise RuntimeError("device on fire")

    job = part.add_job(port_rt.Job("burny", step_fn=bad, state=0,
                                   max_steps=5))
    part.run(max_rounds=3)
    lines = [ln["line"] for ln in job.console.read()["lines"]]
    assert any("FAULT contained" in ln and "device on fire" in ln
               for ln in lines)
