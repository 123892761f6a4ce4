"""The port's commands of ROADMAP queue 1 item 10 against ``pbs_tpu``'s.

Twins of the ``tests/test_cli.py`` cases whose commands the port now
has (``demo``, ``dump``, ``top``, ``sched-credit``, ``trace`` with the
Chrome export, ``ckpt-info``, ``oprofile`` on a live ledger), of the
``knobs`` command cases of ``tests/test_knobs.py``, of ``quantize``
(``tests/test_quant.py``) and of ``gateway demo|stats``
(``tests/test_gateway_chaos.py``, ``tests/test_gateway.py``). Each case
is a function of a package, runs on both with the reference test's
assertions, and the two runs' output must be equal: the same text, the
same JSON, the same files (paths and clock readings aside).
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import re
import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, main=mod("cli.pbst").main, obs=mod("obs"),
        ckpt=mod("ckpt"), knobs=mod("knobs"), channel=mod("knobs.channel"),
        registry=mod("knobs.registry"), tune=mod("sched.tune"),
        gateway=mod("gateway"), gw=mod("gateway.gateway"),
        backends=mod("gateway.backends"), clock=mod("utils.clock"),
        admission=mod("gateway.admission"), tel=mod("telemetry"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
#: How long the port's seqlock readers wait for a writer
#: (``pbs_tpu_torch.utils.seqlock``).
SNAPSHOT_WAIT_S = importlib.import_module(
    "pbs_tpu_torch.utils.seqlock").SNAPSHOT_WAIT_S


def _run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _scrub(text: str, tmp) -> str:
    """Paths and wall-clock stamps out of a command's output."""
    text = text.replace(str(tmp), "<tmp>")
    return re.sub(r"\(\d\d:\d\d:\d\d\)", "(<time>)", text)


def c_demo_and_dump(P, tmp):
    ledger = str(tmp / "p.ledger")
    rc, out, _ = _run(P.main, ["demo", "--seconds", "0.5", "--ledger",
                               ledger])
    assert rc == 0
    d = json.loads(out[: out.rindex("}") + 1].rsplit(
        "{\n \"feedback\"", 1)[0])
    assert d["partition"] == "demo"
    rc, dump, _ = _run(P.main, ["dump", "--ledger", ledger])
    assert rc == 0
    assert "train/0" in dump and "serve/0" in dump
    return [out, dump]


def c_top_iterations(P, tmp):
    ledger = str(tmp / "p.ledger")
    _run(P.main, ["demo", "--seconds", "0.2", "--ledger", ledger])
    rc, out, _ = _run(P.main, ["top", "--ledger", ledger, "--iterations",
                               "2", "--interval", "0.01"])
    assert rc == 0
    assert "pbst top" in out and "train/0" in out
    # The rate column is steps over the measured interval: drop it.
    return [ln[:-9] for ln in _scrub(out, tmp).splitlines()]


def c_sched_credit_cli(P, tmp):
    db = str(tmp / "store.json")
    assert _run(P.main, ["sched-credit", "-d", "train", "-w", "512", "-c",
                         "25", "--db", db])[0] == 0
    rc, out, _ = _run(P.main, ["sched-credit", "-d", "train", "--db", db])
    assert rc == 0
    got = json.loads(out)
    assert got == {"weight": 512, "cap": 25, "tslice_us": 100}
    rc, _, err = _run(P.main, ["sched-credit", "-d", "train", "-t", "5",
                               "--db", db])
    assert rc == 1
    return [out, err.split(":", 1)[1], open(db).read()]


def _trace_file(P, tmp, recs: list) -> str:
    tb = P.obs.TraceBuffer(capacity=16)
    for r in recs:
        tb.emit(*r)
    f = str(tmp / "trace.npy")
    np.save(f, tb.consume())
    return f


def c_trace_cli(P, tmp):
    Ev = P.obs.Ev
    f = _trace_file(P, tmp, [(1_000_000, Ev.SCHED_PICK, 3, 100_000)])
    rc, out, _ = _run(P.main, ["trace", f])
    assert rc == 0 and "SCHED_PICK" in out
    return out


def c_trace_chrome_export(P, tmp):
    Ev = P.obs.Ev
    f = _trace_file(P, tmp, [(1_000_000, Ev.SCHED_PICK, 3, 100_000),
                             (1_150_000, Ev.SCHED_DESCHED, 3, 140_000, 7),
                             (1_200_000, Ev.SCHED_WAKE, 2, 1)])
    out = str(tmp / "trace.chrome.json")
    rc, text, _ = _run(P.main, ["trace", f, "--chrome", out])
    assert rc == 0
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    dur = [e for e in evs if e["ph"] == "X"]
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(dur) == 1 and dur[0]["tid"] == 3
    assert dur[0]["dur"] == pytest.approx(140_000 / 1e3)
    assert len(inst) == 1 and inst[0]["name"] == "SCHED_WAKE"
    return [doc, _scrub(text, tmp)]


def c_ckpt_info_cli(P, tmp):
    path = str(tmp / "ck")
    w = np.zeros(4) if P is REF else torch.zeros(4, dtype=torch.float64)
    P.ckpt.save_checkpoint(path, {"w": w}, metadata={"job": "j"})
    rc, out, _ = _run(P.main, ["ckpt-info", path])
    assert rc == 0
    info = json.loads(out)
    assert info["n_leaves"] == 1 and info["metadata"]["job"] == "j"
    return {k: v for k, v in info.items() if k != "wall_time"}


def c_oprofile_passive_ledger(P, tmp):
    ledger = str(tmp / "p.ledger")
    _run(P.main, ["demo", "--seconds", "0.2", "--ledger", ledger])
    # The live demo starts only once the session's first sample_once
    # has primed its baselines: a demo (0.1-0.2 s of wall time) that
    # finished before the priming left every counter still from there
    # on, and the report without its demo/ rows. The live demo prints
    # into the same stdout as the profiler, as in the reference test.
    Session = P.obs.ProfileSession
    sample_once, primed = Session.sample_once, threading.Event()

    def sample_then_release(self, *a, **k):
        wait_until = time.monotonic() + SNAPSHOT_WAIT_S
        while True:
            try:
                sample_once(self, *a, **k)
                break
            except RuntimeError as e:
                # The reference's seqlock reader gives up after its spin
                # count where the port's waits (a stated departure): a
                # demo thread preempted mid-write must not end the
                # reference's run. Its tick is retried as long as the
                # port's reader would wait.
                if (P is PORT or "retries exhausted" not in str(e)
                        or time.monotonic() > wait_until):
                    raise
                time.sleep(1e-3)
        primed.set()

    def live_demo():
        primed.wait(timeout=30)
        P.main(["demo", "--seconds", "1.0", "--ledger", ledger])

    t = threading.Thread(target=live_demo)
    t.start()
    Session.sample_once = sample_then_release
    try:
        rc, out, _ = _run(P.main, ["oprofile", "--ledger", ledger,
                                   "--name", "demo", "--seconds", "0.5",
                                   "--period", "20"])
    finally:
        Session.sample_once = sample_once
        primed.set()
        t.join()
    assert rc == 0
    assert "samples" in out and "device_ms" in out
    assert "demo/train" in out
    # Sample counts follow the host's timing: the header and the rows'
    # names are the case's.
    return [ln.split()[0] for ln in out.splitlines()
            if ln.startswith(("job ", "demo/"))]


#: The two TPU roofline peaks the port's registry does not declare
#: (``tests/test_torch_knobs.py::test_registry_difference_is_exactly_
#: the_two_peaks``): left out of the knob commands' output compared.
PEAKS = ("telemetry.source.peak_flops", "telemetry.source.peak_hbm_bw")


def _no_peaks(obj):
    if isinstance(obj, dict):
        return {k: v for k, v in obj.items() if k not in PEAKS}
    text = "\n".join(ln for ln in obj.split("\n")
                     if not any(p in ln for p in PEAKS))
    return re.sub(r"\d+ knob\(s\), generation", "knob(s), generation",
                  text)


def c_wedged_channel_refuses_push_and_init_recovers(P, tmp):
    KnobChannel, KnobError = P.channel.KnobChannel, P.registry.KnobError
    path = str(tmp / "knobs.led")
    ch = KnobChannel.create(path)
    ch.push({"sched.feedback.grow_step_us": 150})
    ch._store(2, ch._words(2, 1)[0] + 1)
    with pytest.raises(KnobError, match="wedged"):
        ch.push({"sched.feedback.grow_step_us": 50})
    with pytest.raises(KnobError, match="retries exhausted"):
        KnobChannel.attach(path).snapshot(max_retries=4)
    rc, out, _ = _run(P.main, ["knobs", "init", "--channel", path])
    assert rc == 0
    gen, vals = KnobChannel.attach(path).snapshot()
    assert gen == 0 and vals == P.knobs.snapshot()
    return [_no_peaks(_scrub(out, tmp)), gen, _no_peaks(vals)]


def c_cli_knobs_get_set_watch_roundtrip(P, tmp):
    ch = str(tmp / "knobs.led")
    seen = []
    rc, out, _ = _run(P.main, ["knobs", "list"])
    assert rc == 0 and "sched.feedback.tslice_min_us" in out
    assert _run(P.main, ["knobs", "init", "--channel", ch])[0] == 0
    rc, out, _ = _run(P.main, ["knobs", "set",
                               "sched.feedback.tslice_min_us=200",
                               "sched.feedback.tslice_max_us=2000",
                               "--channel", ch])
    assert rc == 0 and "generation 1" in out
    seen.append(out)
    for bad in ("sched.feedback.window=banana",
                "gateway.admission.rate_scale=1e9"):
        rc, _, err = _run(P.main, ["knobs", "set", bad, "--channel", ch])
        assert rc == 1
        seen.append(err.split(":", 1)[1])
    rc, out, _ = _run(P.main, ["knobs", "get",
                               "sched.feedback.tslice_min_us",
                               "--channel", ch, "--json"])
    assert rc == 0
    assert json.loads(out) == {"sched.feedback.tslice_min_us": 200}
    rc, out, _ = _run(P.main, ["knobs", "watch", "--channel", ch,
                               "--timeout", "0.2", "--max-events", "1"])
    assert rc == 0
    assert "generation 1" in out and "tslice_min_us=200" in out
    seen.append(_no_peaks(out))
    assert _run(P.main, ["knobs", "get", "no.such.knob"])[0] == 2
    return seen


def c_cli_knobs_load_profile_dry_and_push(P, tmp):
    rc, dry, _ = _run(P.main, ["knobs", "load-profile", "contended"])
    assert rc == 0 and "sched.feedback.tslice_min_us=" in dry
    ch = str(tmp / "knobs.led")
    assert _run(P.main, ["knobs", "load-profile", "contended",
                         "--channel", ch])[0] == 0
    rc, out, _ = _run(P.main, ["knobs", "get", "sched.feedback.window",
                               "--channel", ch])
    assert rc == 0
    prof = P.tune.load_profile("contended")
    assert out.strip() == \
        f"sched.feedback.window={prof['params']['window']}"
    return [dry, out]


FIELDS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=128, max_seq=128)


@pytest.fixture(scope="module")
def fp_params():
    from pbs_tpu.models import TransformerConfig, init_params

    jp = init_params(TransformerConfig(**FIELDS, dtype=jax.numpy.float32),
                     jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def test_quantize_cli_roundtrip_twin(fp_params, tmp_path):
    """``quantize``: checkpoint -> int8 checkpoint; the quantized tree
    loads template-free and serves. The same fp32 tree through both
    packages: equal byte accounting, bitwise-equal int8 leaves, and the
    greedy decode of the port's tree equals the reference's."""
    import jax.numpy as jnp

    from pbs_tpu import models as ref_models
    from pbs_tpu_torch import models as port_models
    from pbs_tpu_torch.models.transformer import params_from_numpy

    docs, trees = [], []
    for P, params in ((REF, fp_params),
                      (PORT, params_from_numpy(fp_params, "cpu"))):
        src, dst = tmp_path / f"{P.root}-fp", tmp_path / f"{P.root}-q8"
        P.ckpt.save_checkpoint(str(src), params, metadata={"job": "m"})
        rc, out, _ = _run(P.main, ["quantize", str(src), str(dst)])
        assert rc == 0
        doc = json.loads(out)
        docs.append({k: v for k, v in doc.items() if k not in ("src", "dst")})
        qp, meta = P.ckpt.load_checkpoint(str(dst))
        assert meta["quantized"] == "int8-weight-only"
        assert meta["job"] == "m"
        trees.append(qp)
    assert docs[1] == docs[0]
    assert trees[0]["layers"]["wq"]["q"].dtype == np.int8
    assert trees[1]["layers"]["wq"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(trees[1]["layers"]["wq"]["q"].numpy(),
                                  np.asarray(trees[0]["layers"]["wq"]["q"]))
    jcfg = ref_models.TransformerConfig(**FIELDS, dtype=jnp.float32)
    tcfg = port_models.TransformerConfig(**FIELDS, dtype=torch.float32)
    want = jax.jit(ref_models.make_generate(jcfg, max_new_tokens=4,
                                            temperature=0.0))(
        jax.tree.map(jnp.asarray, trees[0]), jnp.zeros((1, 8), jnp.int32),
        jax.random.PRNGKey(0))
    got = port_models.make_generate(tcfg, max_new_tokens=4)(
        trees[1], torch.zeros((1, 8), dtype=torch.int32))
    assert got.shape == (1, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_refuses_a_tree_without_params(tmp_path):
    for P, leaf in ((REF, np.zeros(3)), (PORT, torch.zeros(3))):
        src = str(tmp_path / f"{P.root}-x")
        P.ckpt.save_checkpoint(src, {"w": leaf})
        rc, _, err = _run(P.main, ["quantize", src,
                                   str(tmp_path / f"{P.root}-y")])
        assert rc == 1 and err.startswith(
            "pbst-torch:" if P is PORT else "pbst:")


def c_gateway_demo_cli_json(P, tmp):
    rc, out, _ = _run(P.main, ["gateway", "demo", "--ticks", "120",
                               "--json"])
    assert rc == 0
    return json.loads(out)


def c_gateway_demo_cli_text(P, tmp):
    rc, out, _ = _run(P.main, ["gateway", "demo", "--ticks", "120"])
    assert rc == 0
    assert "gateway demo" in out and "ok" in out
    return out


def c_gateway_demo_federated(P, tmp):
    rc, out, _ = _run(P.main, ["gateway", "demo", "--federated",
                               "--ticks", "120", "--json"])
    assert rc == 0
    return json.loads(out)


def c_gateway_ledger_stats(P, tmp):
    """``gateway stats --ledger F`` renders a gateway ledger (the
    reference's ``test_gateway_ledger_and_trace_export`` CLI step)."""
    MS = P.clock.MS
    INTERACTIVE = P.admission.INTERACTIVE
    clock = P.clock.VirtualClock()
    be = P.backends.SimServeBackend("b0", n_slots=2,
                                    service_ns_per_cost=1 * MS)
    led_path = str(tmp / "gw.ledger")
    gw = P.gw.Gateway([be], clock=clock, trace_capacity=512,
                      ledger_path=led_path,
                      quotas={"t": P.admission.TenantQuota(
                          rate=1e6, burst=1e6, slo=INTERACTIVE)})
    for _ in range(4):
        assert gw.submit("t", None).admitted
    for _ in range(30):
        gw.tick()
        clock.advance(MS)
    led = P.tel.Ledger.file_backed(led_path, readonly=True)
    snap = led.snapshot(P.gw.GW_LEDGER_SLOTS[INTERACTIVE])
    assert int(snap[P.tel.Counter.STEPS_RETIRED]) == 4
    rc, out, _ = _run(P.main, ["gateway", "stats", "--ledger", led_path])
    assert rc == 0
    assert _run(P.main, ["gateway", "stats"])[0] == 2
    return out


CASES = [
    c_demo_and_dump, c_top_iterations, c_sched_credit_cli, c_trace_cli,
    c_trace_chrome_export, c_ckpt_info_cli, c_oprofile_passive_ledger,
    c_wedged_channel_refuses_push_and_init_recovers,
    c_cli_knobs_get_set_watch_roundtrip,
    c_cli_knobs_load_profile_dry_and_push, c_gateway_demo_cli_json,
    c_gateway_demo_cli_text, c_gateway_demo_federated,
    c_gateway_ledger_stats,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_cli_case_twin(case, tmp_path):
    got = []
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got.append(json.dumps(case(P, d), sort_keys=True, default=str)
                   .replace(str(d), "<tmp>"))
    assert got[1] == got[0]


def test_missing_file_is_a_clean_error(tmp_path):
    """A missing input is one ``pbst-torch:`` line, as the reference's
    is one ``pbst:`` line: rc 1 for a missing checkpoint, an exit with
    the message for a missing ledger."""
    for P, prefix in ((REF, "pbst:"), (PORT, "pbst-torch:")):
        rc, _, err = _run(P.main, ["ckpt-info", str(tmp_path / "none")])
        assert rc == 1 and err.startswith(f"{prefix} not found")
        with pytest.raises(SystemExit, match=f"^{prefix} no ledger"):
            P.main(["dump", "--ledger", str(tmp_path / "none")])
