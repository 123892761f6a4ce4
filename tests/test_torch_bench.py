"""The headline bench's twin (``pbs_tpu_torch.drivers.bench``) against
``bench.py``.

- The twins of ``tests/test_bench_knobs.py``'s bad knobs: the port's
  worker stops with the reference worker's message, before CUDA is
  touched.
- The tiny worker on the host: one JSON line with the reference tiny
  run's keys; the arithmetic of ``value``, ``mfu``, ``vs_baseline`` and
  ``step_ms`` against the reference's formulas.
- The supervisor with stub workers (``PBST_BENCH_WORKER_CMD``), on both
  packages where the reference has the behaviour: success passes the
  line through, an ordinary crash is retried once, an unavailable
  backend is not, a bad seconds knob still prints JSON. Departure (a):
  a stalled worker's process group is killed, its last stage named.
  Departure (b): no card gives the error row, never the serving mode.
- The serving mode on the host, on the reference's weights: its counts
  equal the reference's ``--serving-fallback`` run's.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX reference")
import torch  # noqa: E402

from pbs_tpu_torch.drivers import bench, bench_common  # noqa: E402
from pbs_tpu_torch.drivers.graft_entry import _flagship_cfg  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import STALL_WORKER, pid_running  # noqa: E402
REF_BENCH = os.path.join(REPO, "bench.py")
#: The supervisor of each package, as the driver starts it.
SUPERVISORS = {"ref": [sys.executable, REF_BENCH],
               "port": [sys.executable, "-m", "pbs_tpu_torch.drivers.bench"]}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PBST_BENCH_")}
    # Two intra-op threads a child, as in the pytest workers: the suite
    # runs beside wall-clock-paced tests.
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
                "OMP_NUM_THREADS": "2", **extra})
    return env


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert lines, out
    return json.loads(lines[-1])


def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PBST_BENCH_"):
            monkeypatch.delenv(k)


# -- knobs --------------------------------------------------------------------


@pytest.mark.parametrize("knob", [
    {"PBST_BENCH_BATCH": "8x"},
    {"PBST_BENCH_BATCH": "0"},
    {"PBST_BENCH_LOSS_CHUNKS": "3"},
    {"PBST_BENCH_ATTN": "flash"},
    {"PBST_BENCH_REMAT": "selective"},
], ids=["batch-8x", "batch-0", "loss-chunks-3", "attn-flash",
        "remat-selective"])
def test_bad_knob_fails_like_the_reference_before_cuda(knob, monkeypatch):
    """``tests/test_bench_knobs.py``'s five bad knobs: the port's worker
    stops with the message ``bench.py --worker`` prints as its last
    line, and never asks torch for a card."""
    ref = subprocess.run([sys.executable, REF_BENCH, "--worker"],
                         capture_output=True, text=True, timeout=60,
                         env=_env(PBST_BENCH_TINY="1", **knob), cwd=REPO)
    assert ref.returncode != 0 and "backend init" not in ref.stderr
    want = ref.stderr.strip().splitlines()[-1]

    def touched(*a, **k):
        raise AssertionError("the card was asked for before the knobs")

    _clean_env(monkeypatch)
    for k, v in {"PBST_BENCH_TINY": "1", **knob}.items():
        monkeypatch.setenv(k, v)
    for name in ("is_available", "init", "_lazy_init", "device_count"):
        monkeypatch.setattr(torch.cuda, name, touched)
    with pytest.raises(SystemExit) as e:
        bench.main(["--worker"])
    assert str(e.value) == want


def test_tiny_spellings_are_the_references(monkeypatch):
    _clean_env(monkeypatch)
    for raw, want in (("1", True), ("true", True), ("YES", True),
                      ("0", False), ("", False), ("no", False)):
        monkeypatch.setenv("PBST_BENCH_TINY", raw)
        assert bench.tiny_mode() is want, raw


def test_committed_defaults_are_the_references():
    import bench as ref_bench

    assert bench.DEFAULTS == ref_bench.DEFAULTS
    for name in ("TARGET_MFU", "WARMUP_CHUNKS", "BENCH_CHUNKS",
                 "STEPS_PER_CHUNK", "BATCH", "SEQ", "SERVING_BAR_TOKENS_S"):
        assert getattr(bench, name) == getattr(ref_bench, name), name
    assert bench.PEAK_FLOPS == 989e12  # the H100's bf16 peak


# -- the worker ---------------------------------------------------------------


def test_tiny_worker_line_has_the_references_keys(monkeypatch, capsys):
    """One JSON line on stdout, with exactly the keys of the reference's
    tiny run; a positive rate and a finite loss."""
    ref = subprocess.run([sys.executable, REF_BENCH, "--worker"],
                         capture_output=True, text=True, timeout=300,
                         env=_env(PBST_BENCH_TINY="1"), cwd=REPO)
    assert ref.returncode == 0, ref.stderr[-800:]
    want = _last_json(ref.stdout)
    _clean_env(monkeypatch)
    monkeypatch.setenv("PBST_BENCH_TINY", "1")
    assert bench.main(["--worker"]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == list(want)
    assert got["metric"] == "flagship_train_throughput"
    assert got["value"] > 0 and math.isfinite(got["loss"])
    assert got["n_params"] == want["n_params"]
    assert got["device"] == "cpu" and got["mu_dtype"] == "f32"
    # The stage markers, in the reference's order.
    marks = [ln.split("] ", 1)[1] for ln in out.err.splitlines()
             if ln.startswith("[bench ")]
    assert marks[0] == "importing torch" and marks[1] == "backend init: cpu"
    assert marks[2:] == ["params initialized (0M)", "compiling train chunk",
                         "warmup chunk 0 done", marks[5],
                         "warmup done; timing"]
    assert marks[5].startswith("warmup chunk 1 done (")


def test_good_knobs_name_themselves_in_the_line(monkeypatch):
    """The twin of ``test_good_knobs_reach_result_with_extras``: every
    non-default knob is named in the row."""
    _clean_env(monkeypatch)
    for k, v in {"PBST_BENCH_TINY": "1", "PBST_BENCH_BATCH": "2",
                 "PBST_BENCH_LOSS_CHUNKS": "4", "PBST_BENCH_REMAT": "none",
                 "PBST_BENCH_ATTN": "pallas",
                 "PBST_BENCH_MU_DTYPE": "bf16"}.items():
        monkeypatch.setenv(k, v)
    row, first = bench.measure(bench.parse_knobs(True), tiny=True)
    assert (row["batch"], row["loss_chunks"], row["remat"], row["attn"],
            row["mu_dtype"]) == (2, 4, "none", "pallas", "bf16")
    assert row["value"] > 0 and row["loss"] < first


@pytest.mark.parametrize("batch,seq,steps,dt,n", [
    (6, 1024, 30, 7.3, 700_000_000),
    (2, 128, 2, 0.0337, 361_088),
    (8, 1024, 10, 2.0, 123_456_789),
])
@pytest.mark.parametrize("peak", [197e12, 989e12], ids=["v5e", "h100"])
def test_headline_arithmetic_is_the_references(batch, seq, steps, dt, n,
                                               peak):
    """``bench.py:407-423`` written out: the port's numbers at the
    reference's peak are the reference's."""
    ntok = batch * (seq - 1) * steps
    tokens_per_s = ntok / dt
    flops_per_token = 6 * n
    mfu = tokens_per_s * flops_per_token / peak
    bar = 0.40 * peak / flops_per_token
    assert bench.headline(batch, seq, steps, dt, n, peak=peak) == {
        "value": round(tokens_per_s, 1),
        "vs_baseline": round(tokens_per_s / bar, 4),
        "mfu": round(mfu, 4),
        "step_ms": round(1e3 * dt / steps, 1),
    }


def test_degraded_protocol_times_the_probe_chunk(monkeypatch):
    """A budget that one more chunk would overrun: the probe chunk is the
    measurement, and the row says so (``bench.py:380-386``)."""
    _clean_env(monkeypatch)
    row, _ = bench.measure(bench.parse_knobs(True), tiny=True,
                           timeout_s=0.0, t_start=time.perf_counter())
    assert row["degraded_protocol"] is True and row["bench_chunks"] == 0
    assert row["value"] > 0


def test_training_chunks_keep_timed_trainings_numbers():
    """``timed_training`` now runs on ``TrainingChunks``: its losses are
    the loop it replaced, bit for bit."""
    from pbs_tpu_torch.models import init_params, make_train_step

    cfg = _flagship_cfg(tiny=True)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    init_opt, train_step = make_train_step(cfg, learning_rate=3e-4)
    state = (params, init_opt(params), 0)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           dtype=torch.int32)
    losses = []
    for _ in range(4):
        state, m = train_step(state, tokens)
        losses.append(float(m["loss"]))
    got = bench_common.timed_training(cfg, 2, 64, 2, "cpu", warm_chunks=1,
                                      timed_chunks=1)
    assert (got["first_loss"], got["loss"]) == (losses[0], losses[-1])


def test_measure_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _clean_env(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure(bench.parse_knobs(False))


# -- the supervisor -----------------------------------------------------------

COUNT = (
    "import os\n"
    "d = os.environ['PBST_STUB_DIR']\n"
    "p = os.path.join(d, 'attempts')\n"
    "n = int(open(p).read()) + 1 if os.path.exists(p) else 1\n"
    "open(p, 'w').write(str(n))\n"
)


def _supervise(which: str, tmp_path, worker_body: str | None, timeout=60,
               worker_args: str = "", **extra):
    """Run a package's supervisor, with a stub worker (given
    ``worker_args``) unless ``worker_body`` is None; returns (JSON line,
    process, seconds)."""
    env = _env(**{"PBST_BENCH_PROBE_S": "6", "PBST_BENCH_TIMEOUT_S": "30",
                  "PBST_BENCH_RETRY_SLEEP_S": "0.2",
                  "PBST_STUB_DIR": str(tmp_path),
                  "PBST_BENCH_SERVING_FALLBACK": "0", **extra})
    if worker_body is not None:
        stub = tmp_path / "stub_worker.py"
        stub.write_text(worker_body)
        env["PBST_BENCH_WORKER_CMD"] = (f"{sys.executable} {stub} "
                                        f"{worker_args}")
    t0 = time.perf_counter()
    proc = subprocess.run(SUPERVISORS[which], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    return _last_json(proc.stdout), proc, time.perf_counter() - t0


@pytest.mark.parametrize("which", ["ref", "port"])
def test_success_passes_worker_json_through(which, tmp_path):
    payload = {"metric": "flagship_train_throughput", "value": 123.0,
               "unit": "tokens/s", "vs_baseline": 1.5}
    result, proc, _ = _supervise(
        which, tmp_path,
        "import sys, json\n"
        "sys.stderr.write('[bench +  1.0s] backend init: ok\\n')\n"
        f"print(json.dumps({payload!r}))\n")
    assert result == payload and proc.returncode == 0


@pytest.mark.parametrize("which", ["ref", "port"])
def test_ordinary_crash_is_retried_once(which, tmp_path):
    result, proc, _ = _supervise(
        which, tmp_path,
        COUNT + "import sys\nsys.stderr.write('boom\\n')\nsys.exit(1)\n")
    assert result["value"] == 0.0 and "boom" in result["error"]
    assert (tmp_path / "attempts").read_text() == "2"


@pytest.mark.parametrize("which,line", [
    ("ref", "RuntimeError: UNAVAILABLE: TPU backend setup/compile error"),
    ("port", f"{bench.UNAVAILABLE_MARK} RuntimeError: CUDA error: an "
             "illegal memory access was encountered"),
])
def test_unavailable_backend_is_not_retried(which, line, tmp_path):
    """Each package's fatal class (the TPU plugin's UNAVAILABLE; the
    port's ``backend_unavailable``) ends the run after one attempt."""
    result, proc, _ = _supervise(
        which, tmp_path,
        COUNT + f"import sys\nsys.stderr.write({line + chr(10)!r})\n"
        "sys.exit(3)\n")
    assert result["value"] == 0.0
    assert (tmp_path / "attempts").read_text() == "1"
    if which == "port":
        assert result["error"].startswith(
            "backend unavailable: RuntimeError: CUDA error: an illegal")
        assert proc.returncode == 1


@pytest.mark.parametrize("which", ["ref", "port"])
def test_bad_seconds_knob_still_prints_json(which, tmp_path):
    result, proc, _ = _supervise(which, tmp_path, None,
                                 PBST_BENCH_PROBE_S="90s")
    assert "PBST_BENCH_PROBE_S must be a number" in result["error"]
    assert result["value"] == 0.0 and proc.returncode == 1


def test_stalled_worker_group_is_killed_naming_its_stage(tmp_path):
    """Departure (a): at the deadline the worker and its children are
    gone when the supervisor returns (the reference orphans them), and
    the error names the last stage reached. The stub is phase 3b (f4)'s."""
    result, proc, dt = _supervise("port", tmp_path, STALL_WORKER,
                                  worker_args=str(tmp_path / "pids"),
                                  PBST_BENCH_TIMEOUT_S="3")
    assert result["value"] == 0.0 and proc.returncode == 1
    assert result["error"].startswith("deadline after 3s; last stage: ")
    assert "compiling train chunk" in result["error"]
    assert "process group was killed" in result["error"]
    pids = [int(p) for p in (tmp_path / "pids").read_text().split()]
    assert not [p for p in pids if pid_running(p)]
    assert dt < 3 + bench.KILL_GRACE_S + 10
    assert not (tmp_path / "attempts").exists()


def test_worker_without_a_backend_marker_is_killed_at_the_probe(tmp_path):
    """No "backend init:" within the probe window: claim-unavailable,
    one attempt, the group killed (the reference leaves a waiter)."""
    result, proc, dt = _supervise(
        "port", tmp_path,
        COUNT + STALL_WORKER.replace("backend init", "importing"),
        worker_args=str(tmp_path / "pids"), PBST_BENCH_PROBE_S="2")
    assert result["error"].startswith(
        "claim-unavailable: no CUDA backend within 2s")
    assert (tmp_path / "attempts").read_text() == "1"
    pids = [int(p) for p in (tmp_path / "pids").read_text().split()]
    assert not [p for p in pids if pid_running(p)]


@pytest.mark.parametrize("knob", [
    "PBST_BENCH_PROBE_SENTINEL", "PBST_BENCH_SELF_EXIT_S",
    "PBST_BENCH_SELF_EXIT_GRACE_S", "PBST_BENCH_PROBE_EXIT_GRACE_S"])
def test_claim_holder_knobs_are_ignored(knob, tmp_path):
    """Departure (a): the reference's waiter knobs have nothing to
    configure here; even a value the reference would refuse leaves the
    run as it is, and the docstring names the knob."""
    payload = {"metric": "flagship_train_throughput", "value": 1.0}
    result, proc, _ = _supervise(
        "port", tmp_path,
        COUNT + "import json, sys\n"
        "sys.stderr.write('[bench +  1.0s] backend init: ok\\n')\n"
        f"print(json.dumps({payload!r}))\n", **{knob: "not-a-number"})
    assert result == payload and proc.returncode == 0
    assert (tmp_path / "attempts").read_text() == "1"
    assert f"``{knob}``" in bench.__doc__


def test_no_card_gives_the_error_row_never_the_serving_mode(tmp_path):
    """Departure (b): the real worker on a host with no card, with the
    reference's fallback knob on, is one attempt, the
    ``flagship_train_throughput`` error row and rc 1: no serving
    number takes its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    result, proc, _ = _supervise("port", tmp_path, None, timeout=120,
                                 PBST_BENCH_SERVING_FALLBACK="1")
    assert proc.returncode == 1
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert result["metric"] == "flagship_train_throughput"
    assert result["error"].startswith(
        "backend unavailable: RuntimeError: no CUDA device is available")
    assert proc.stderr.count("importing torch") == 1  # not retried
    assert "gateway_serving_throughput" not in proc.stdout
    assert "requests x" not in proc.stderr


def test_no_compilation_cache_counterpart():
    """Departure (c), stated in the module's docstring."""
    assert not hasattr(bench, "setup_compilation_cache")
    assert not hasattr(bench_common, "setup_compilation_cache")
    doc = bench.__doc__
    for part in ("(a) On a deadline", "(b) No automatic serving fallback",
                 "(c) No ``setup_compilation_cache``"):
        assert part in doc, part


# -- the serving mode ---------------------------------------------------------


def test_serving_mode_counts_equal_the_references(monkeypatch):
    """``--serving-fallback`` on the host, on the reference's weights
    (``params_from_numpy``): the counts and placement facts of the
    reference's run."""
    from pbs_tpu.models import TransformerConfig, init_params
    from pbs_tpu_torch.models import params_from_numpy

    env = _env(PBST_BENCH_SERVING_REQUESTS="8")
    ref = subprocess.run([sys.executable, REF_BENCH, "--serving-fallback"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert ref.returncode == 0, ref.stderr[-800:]
    want = _last_json(ref.stdout)
    cfg = TransformerConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq=128,
                            dtype=jax.numpy.float32)
    jparams = init_params(cfg, jax.random.PRNGKey(0))
    tree = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _clean_env(monkeypatch)
    monkeypatch.setenv("PBST_BENCH_SERVING_REQUESTS", "8")
    got = bench.serving_measure("cpu", params=tree)
    assert list(got) == list(want)
    for k in ("metric", "requests", "completions", "shed", "tokens",
              "mesh", "sharded_param_leaves", "fallback_from"):
        assert got[k] == want[k], k
    assert got["completions"] == 8 and got["value"] > 0
    assert got["device"] == "cpu"


def test_chip_smoke_bench_twin_path_on_the_host(monkeypatch):
    """Phase 3b (f)'s code as it runs on the card, on the host in the
    twin's tiny mode: the headline child, the worker body with attn
    "pallas" (no kernel launches here), the serving mode and both fault
    paths."""
    import chip_smoke

    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the children's threads
    launches, routes = chip_smoke.run_bench_twin(torch, "host", device="cpu")
    assert set(launches.values()) == {0}
