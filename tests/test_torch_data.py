"""The input pipeline on the port, against ``pbs_tpu``: twins of
``tests/test_data.py``.

Token files written by the two packages are byte-identical, and every
window, sampled batch, sharded batch and prefetched stream the port
builds equals the reference's from the same seed. The port gathers rows
with the reference's numpy path (no native runtime yet), held against
the reference's gather, native where its library is built. Training
through the prefetched batches starts from the reference's own weights:
losses agree within rtol 2e-4, atol 2e-5 (the bound of
``tests/test_torch_train.py``: two frameworks' fp32 reductions).
"""

from __future__ import annotations

import filecmp

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from __graft_entry__ import _flagship_cfg  # noqa: E402
from pbs_tpu import data as ref_data  # noqa: E402
from pbs_tpu import models as ref_models  # noqa: E402
from pbs_tpu_torch import data as port_data  # noqa: E402
from pbs_tpu_torch import models as port_models  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def corpus(tmp_path):
    toks = np.arange(10_000, dtype=np.int64) % 32_000
    paths = {}
    for name, d in (("ref", ref_data), ("port", port_data)):
        paths[name] = str(tmp_path / f"{name}.pbst")
        d.write_token_file(paths[name], toks)
    assert filecmp.cmp(paths["ref"], paths["port"], shallow=False)
    ref = ref_data.TokenDataset(paths["ref"])
    ds = port_data.TokenDataset(paths["port"])
    yield ds, ref, toks
    ds.close()
    ref.close()


def _port_params(jcfg):
    """The reference's init for ``jcfg``, carried to the port."""
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, port_models.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _port_cfg(jcfg):
    fields = ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "norm_eps")
    return port_models.TransformerConfig(
        **{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)


def test_roundtrip_and_dtype(corpus, tmp_path):
    ds, _, toks = corpus
    assert len(ds) == 10_000
    assert ds.dtype == np.uint16  # vocab < 65536 packs to u16
    big = np.array([0, 1, 1 << 20], dtype=np.int64)
    p, q = str(tmp_path / "big.pbst"), str(tmp_path / "big_ref.pbst")
    port_data.write_token_file(p, big)
    ref_data.write_token_file(q, big)
    assert filecmp.cmp(p, q, shallow=False)
    ds2 = port_data.TokenDataset(p)
    assert ds2.dtype == np.uint32
    np.testing.assert_array_equal(ds2.window(0, 1, 3)[0], big)
    ds2.close()


def test_window_deterministic_and_correct(corpus):
    ds, ref, toks = corpus
    w = ds.window(0, 4, 128)
    assert w.shape == (4, 128) and w.dtype == np.int32
    for b in range(4):
        np.testing.assert_array_equal(w[b], toks[b * 128:(b + 1) * 128])
    np.testing.assert_array_equal(w, ds.window(0, 4, 128))
    for i in (0, 5, 77):  # wrapping at the end alike
        np.testing.assert_array_equal(ds.window(i, 4, 128),
                                      ref.window(i, 4, 128))


def test_sample_windows_are_the_reference_windows(corpus):
    ds, ref, toks = corpus
    s = ds.sample(8, 64, np.random.default_rng(7))
    np.testing.assert_array_equal(s, ref.sample(8, 64,
                                                np.random.default_rng(7)))
    for row in s:
        start = int(row[0])  # corpus is arange: first token = offset
        np.testing.assert_array_equal(row, toks[start:start + 64])


def test_gather_matches_the_reference_gather(corpus):
    """The port's gather (its native ``pbst_gather_rows`` where the
    library builds) against the reference's, and against the numpy
    gather."""
    from pbs_tpu_torch.runtime import native as port_native

    ds, ref, toks = corpus
    assert (ds._nat is not None) == port_native.available()
    starts = np.array([0, 17, 9_000], dtype=np.int64)
    np.testing.assert_array_equal(ds._gather(starts, 50),
                                  ref._gather(starts, 50))
    np.testing.assert_array_equal(
        ds._gather(starts, 50), np.stack([toks[s:s + 50] for s in starts]))


def test_gather_bounds_checked(corpus):
    ds, _, _ = corpus
    with pytest.raises((IndexError, ValueError)):
        ds._gather(np.array([9_990], dtype=np.int64), 64)
    with pytest.raises(IndexError):
        ds._gather(np.array([-5], dtype=np.int64), 8)


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"nope" + b"\0" * 32)
    with pytest.raises(ValueError, match="not a PBST"):
        port_data.TokenDataset(str(p))


def test_negative_tokens_rejected(tmp_path):
    with pytest.raises(ValueError, match="negative"):
        port_data.write_token_file(str(tmp_path / "neg.pbst"),
                                   np.array([1, -1, 2], dtype=np.int64))


def test_prefetcher_streams_the_reference_stream(corpus):
    ds, ref, _ = corpus
    streams = []
    for d, dset in ((port_data, ds), (ref_data, ref)):
        src = d.make_batch_source(dset, batch=4, seq_len=32, seed=3)
        with d.Prefetcher(src, depth=2, place=lambda x: x) as pf:
            streams.append([next(pf) for _ in range(10)])
    assert all(b.shape == (4, 32) for b in streams[0])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_cpu_place_is_from_numpy(corpus):
    ds, _, _ = corpus
    src = port_data.make_batch_source(ds, batch=2, seq_len=16, seed=1)
    want = port_data.make_batch_source(ds, batch=2, seq_len=16, seed=1)
    with port_data.Prefetcher(src, depth=2, device="cpu") as pf:
        for _ in range(3):
            got = next(pf)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want())


def test_prefetcher_refuses_the_card_without_one(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement is valid")
    ds, _, _ = corpus
    src = port_data.make_batch_source(ds, batch=2, seq_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_data.Prefetcher(src)


def test_prefetcher_propagates_worker_error():
    calls = {"n": 0}

    def bad_source():
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("disk gone")
        return np.zeros((2, 8), np.int32)

    pf = port_data.Prefetcher(bad_source, depth=1, place=lambda x: x)
    with pytest.raises(RuntimeError, match="disk gone"):
        for _ in range(10):
            next(pf)
    pf.stop()


def test_prefetcher_feeds_training(corpus):
    """End to end: the loader drives the tiny flagship's train step in
    both packages from the same weights; the losses agree."""
    ds, ref, _ = corpus
    jcfg = _flagship_cfg(tiny=True)
    jparams, tparams = _port_params(jcfg)
    tcfg = _port_cfg(jcfg)

    init_opt, step = ref_models.make_train_step(jcfg, learning_rate=1e-3)
    jstate = (jparams, jax.jit(init_opt)(jparams), 0)
    jstep = jax.jit(step)
    want = []
    src = ref_data.make_batch_source(ref, batch=2, seq_len=33, seed=0)
    with ref_data.Prefetcher(src, depth=2) as pf:
        for _ in range(4):
            jstate, m = jstep(jstate, next(pf) % jcfg.vocab)
            want.append(float(m["loss"]))

    init_opt, step = port_models.make_train_step(tcfg, learning_rate=1e-3)
    state = (tparams, init_opt(tparams), 0)
    got = []
    src = port_data.make_batch_source(ds, batch=2, seq_len=33, seed=0)
    with port_data.Prefetcher(src, depth=2, device="cpu") as pf:
        for _ in range(4):
            state, m = step(state, next(pf) % tcfg.vocab)
            got.append(float(m["loss"]))
    assert state[2] == 4
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_byte_tokenizer_roundtrip(tmp_path):
    text = "Hello, scheduler — café ü"
    toks = port_data.encode_text(text)
    np.testing.assert_array_equal(toks, ref_data.encode_text(text))
    assert toks[0] == port_data.BOS and toks[-1] == port_data.EOS
    assert toks.max() < port_data.VOCAB
    assert port_data.decode_tokens(toks) == text
    assert (port_data.BOS, port_data.EOS, port_data.VOCAB) == (
        ref_data.BOS, ref_data.EOS, ref_data.VOCAB)
    src = tmp_path / "doc.txt"
    src.write_text(text * 3, encoding="utf-8")
    n = port_data.corpus_from_file(str(tmp_path / "p.tok"), str(src))
    assert n == ref_data.corpus_from_file(str(tmp_path / "r.tok"), str(src))
    assert filecmp.cmp(tmp_path / "p.tok", tmp_path / "r.tok",
                       shallow=False)


def test_text_to_training_end_to_end(tmp_path):
    """Text -> packed corpus -> TokenDataset -> prefetched batches ->
    train steps: the loss moves, as in the reference, by the same
    amounts."""
    path = str(tmp_path / "corpus.tok")
    docs = ["the quick brown fox jumps over the lazy dog. " * 8
            for _ in range(4)]
    assert port_data.corpus_from_text(path, docs) > 512
    ds = port_data.TokenDataset(path)
    jcfg = ref_models.TransformerConfig(
        vocab=port_data.VOCAB, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, max_seq=64, dtype=jnp.float32)
    jparams, tparams = _port_params(jcfg)

    init_opt, jstep = ref_models.make_train_step(jcfg, learning_rate=3e-3)
    jstate = (jparams, jax.jit(init_opt)(jparams), 0)
    jstep = jax.jit(jstep)
    init_opt, step = port_models.make_train_step(_port_cfg(jcfg),
                                                 learning_rate=3e-3)
    state = (tparams, init_opt(tparams), 0)
    want, got = [], []
    src = port_data.make_batch_source(ds, batch=2, seq_len=64, seed=3)
    with port_data.Prefetcher(src, depth=2, place=lambda x: x) as pf:
        for _ in range(8):
            batch = next(pf)
            jstate, m = jstep(jstate, jnp.asarray(batch))
            want.append(float(m["loss"]))
            state, m = step(state, torch.from_numpy(batch))
            got.append(float(m["loss"]))
    assert got[-1] < got[0]  # byte-level text actually trains
    np.testing.assert_allclose(got, want, rtol=1e-3)
    ds.close()


def test_sharded_source_partitions_and_resumes(tmp_path):
    """Hosts draw disjoint slices of ONE global schedule, the reference's
    schedule, and the one-int cursor resumes the exact position."""
    path = str(tmp_path / "corpus.pbst")
    port_data.write_token_file(path, np.arange(10_000) % 251)
    ds = port_data.TokenDataset(path)
    ref = ref_data.TokenDataset(path)
    srcs = [port_data.ShardedBatchSource(ds, global_batch=8, seq_len=16,
                                         host_id=h, n_hosts=4, seed=5)
            for h in range(4)]
    refs = [ref_data.ShardedBatchSource(ref, global_batch=8, seq_len=16,
                                        host_id=h, n_hosts=4, seed=5)
            for h in range(4)]
    shards = [s() for s in srcs]
    for sh, r in zip(shards, refs):
        np.testing.assert_array_equal(sh, r())
    whole = port_data.ShardedBatchSource(ds, global_batch=8, seq_len=16,
                                         host_id=0, n_hosts=1, seed=5)()
    np.testing.assert_array_equal(np.concatenate(shards), whole)

    nxt = srcs[2]()
    assert srcs[2].state() == refs[2].state() | {"step": 2}
    fresh = port_data.ShardedBatchSource(ds, global_batch=8, seq_len=16,
                                         host_id=2, n_hosts=4, seed=5)
    fresh.load_state({"step": 1, "seed": 5, "host_id": 2, "n_hosts": 4,
                      "global_batch": 8, "seq_len": 16})
    np.testing.assert_array_equal(fresh(), nxt)
    with pytest.raises(ValueError, match="different data schedule"):
        fresh.load_state({"step": 3, "seed": 99, "n_hosts": 4,
                          "global_batch": 8, "seq_len": 16})
    with pytest.raises(ValueError, match="different data schedule"):
        fresh.load_state({"step": 3, "seed": 5, "n_hosts": 4,
                          "global_batch": 16, "seq_len": 16})
    with pytest.raises(ValueError):
        port_data.ShardedBatchSource(ds, global_batch=7, seq_len=16,
                                     n_hosts=4)
    ds.close()
    ref.close()
