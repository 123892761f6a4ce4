"""Self-check: ``pbst-torch check`` is clean on the port's own tree.

Twins of every case of ``tests/test_analysis_selfcheck.py`` for
``pbs_tpu_torch``: the tree has no finding and exactly the reference's
four justified suppressions, at the port's copies of the reference's
lines, with the reference's rules and justifications in its order (the
copies once dropped them, and the reference's checker found 4 findings
in them). Then the CPU twin of ``chip_smoke.py``'s phase 3k: the same
sequence at toy width on the host (named locks under lockdep through one
agent, the checker in a child process with the live graph, the reversed
edge it must catch).
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile

import pytest
import torch

import chip_smoke
from pbs_tpu import analysis as ref
from pbs_tpu_torch.analysis import (check_paths, format_human,
                                    list_suppressions, pass_ids)
from pbs_tpu_torch.cli.pbst import main

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pbs_tpu_torch")
REF_PKG = os.path.join(REPO, "pbs_tpu")

#: The serving walkthrough's file-level suppression: the port keeps the
#: walkthroughs inside its package (``pbs_tpu_torch/examples/``), where
#: the scan reaches them; the reference keeps its copy outside its own.
WALKTHROUGH = ("pbs_tpu_torch/examples/serving_stack.py",
               "the walkthrough shows the engine itself, below the gateway "
               "that fronts it in deployment (the reference's copy lives "
               "outside its package's scan)")
#: The port tree's justified suppressions in path order: the
#: walkthrough's three direct engine submits, then the reference's four
#: in its order.
SUPPRESSED = [("gw-direct-submit", WALKTHROUGH[1])] * 3 + [
    ("rollout-push",
     "chaos harness IS the adversary: the knob plan injects raw "
     "mid-run pushes to prove the consumers survive them; "
     "production writers go through autopilot/canary.py"),
    ("perf-dispatch-alloc",
     "reference equivalence witness, deliberately list-based"),
    ("perf-dispatch-alloc",
     "reference equivalence witness, deliberately list-based"),
    ("perf-emit-in-loop",
     "witness replay: the JSONL recorder is fed record-by-record "
     "so the byte stream (and digest) matches the live engine's "
     "emission order"),
]


@pytest.fixture(scope="module")
def tree_result():
    # One full-tree scan shared by the module (tier-1 budget). The port's
    # runtime/csrc/*.cc are inside the package, so one path covers both
    # sides of the language boundary.
    return check_paths([PKG], root=REPO)


def test_repo_tree_is_clean(tree_result):
    r = tree_result
    assert r.files_scanned > 80  # the whole package, not a subset
    assert r.passes_run == pass_ids()
    assert r.findings == [], "\n" + format_human(r)
    assert [(fi.check, j) for fi, j in r.suppressed] == SUPPRESSED
    assert [fi.path for fi, _ in r.suppressed] == [WALKTHROUGH[0]] * 3 + [
        "pbs_tpu_torch/gateway/chaos.py", "pbs_tpu_torch/sim/engine.py",
        "pbs_tpu_torch/sim/engine.py", "pbs_tpu_torch/sim/native_core.py"]


def test_suppressions_are_the_reference_s_in_its_order():
    """Rules, scope and justification of each suppression comment equal
    the reference tree's, one for one, at the same files; the port adds
    only the serving walkthrough's, which the reference keeps outside
    its package."""
    def view(sups, pkg):
        return [(s["path"].removeprefix(pkg), s["rules"], s["scope"],
                 s["justification"]) for s in sups]

    got = view(list_suppressions([PKG], root=REPO), "pbs_tpu_torch/")
    want = view(ref.list_suppressions([REF_PKG], root=REPO), "pbs_tpu/")
    assert got[0] == ("examples/serving_stack.py", ["gw-direct-submit"],
                      "file", WALKTHROUGH[1])
    assert got[1:] == want and len(want) == 4


def test_both_native_sources_are_in_the_scan_set():
    """The cross-language passes only see what the walker feeds them:
    both C sources of the port's runtime are in the default scan set,
    and its CUDA kernels are not (the checker reads .py and .cc)."""
    from pbs_tpu_torch.analysis import iter_check_files

    files = iter_check_files([PKG])
    cc = sorted(os.path.basename(p) for p in files if p.endswith(".cc"))
    assert cc == ["pbst_fastcall.cc", "pbst_runtime.cc"]
    assert all(p.endswith((".py", ".cc")) for p in files)


def test_cli_selfcheck_json_exit_zero(capsys):
    assert main(["check", PKG, "--format", "json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["findings"] == []
    assert [s["check"] for s in d["suppressed"]] == \
        ["gw-direct-submit"] * 3 + ["rollout-push"] + \
        ["perf-dispatch-alloc"] * 2 + ["perf-emit-in-loop"]


def test_list_suppressions_pins_the_trees_escape_hatch_count(capsys):
    """The count is pinned at the reference's 4 plus the serving
    walkthrough's one, at the port's paths."""
    assert main(["check", PKG, "--list-suppressions",
                 "--format", "json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["count"] == 5
    assert all(s["justification"] for s in d["suppressions"])
    paths = sorted({s["path"] for s in d["suppressions"]})
    assert paths == [WALKTHROUGH[0], "pbs_tpu_torch/gateway/chaos.py",
                     "pbs_tpu_torch/sim/engine.py",
                     "pbs_tpu_torch/sim/native_core.py"]
    assert main(["check", PKG, "--list-suppressions"]) == 0
    out = capsys.readouterr().out
    assert "5 suppression(s)" in out
    assert "NO JUSTIFICATION" not in out


def test_default_path_is_the_port_tree(capsys):
    """With no path, ``pbst-torch check`` reads ``pbs_tpu_torch`` from
    the working directory (the reference: ``pbs_tpu`` and its C
    directory)."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert main(["check", "--list-suppressions", "--format",
                     "json"]) == 0
    finally:
        os.chdir(cwd)
    d = json.loads(capsys.readouterr().out)
    assert d["count"] == 5
    assert all(s["path"].startswith("pbs_tpu_torch/")
               for s in d["suppressions"])


def test_check_changed_incremental_mode(tmp_path, capsys):
    """`pbst-torch check --changed REF` analyzes only files changed vs
    the ref; a bad ref is a usage error."""
    repo = tmp_path / "r"
    pkg = repo / "pbs_tpu_torch" / "runtime"
    pkg.mkdir(parents=True)
    (pkg / "ok.py").write_text("X = 1\n")
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    "commit", "-q", "--allow-empty", "-m", "seed"],
                   cwd=repo, check=True)
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        assert main(["check", "pbs_tpu_torch", "--changed", "HEAD"]) == 0
        out = capsys.readouterr().out
        assert "1 file(s)" in out
        (pkg / "bad.py").write_text(
            "import threading\n_l = threading.Lock()\n")
        assert main(["check", "pbs_tpu_torch", "--changed", "HEAD"]) == 1
        capsys.readouterr()
        assert main(["check", "pbs_tpu_torch", "--changed",
                     "no-such-ref"]) == 2
        assert "bad --changed" in capsys.readouterr().err
        # Tracked modifications from a subdirectory: `git diff` names are
        # toplevel-relative while the cwd is not.
        subprocess.run(["git", "add", "-A"], cwd=repo, check=True)
        subprocess.run(["git", "-c", "user.email=t@t",
                        "-c", "user.name=t", "commit", "-q", "-m",
                        "files"], cwd=repo, check=True)
        (pkg / "bad.py").write_text(
            "import threading\n_l = threading.Lock()\n_m = "
            "threading.Lock()\n")
        os.chdir(repo / "pbs_tpu_torch")
        assert main(["check", ".", "--changed", "HEAD"]) == 1
        assert "lock-raw" in capsys.readouterr().out
    finally:
        os.chdir(cwd)


def test_check_changed_empty_set_is_clean(capsys):
    """No checkable file changed vs HEAD in an untouched subtree: exit 0
    with an explicit note."""
    pristine = subprocess.run(
        ["git", "status", "--porcelain", "pbs_tpu_torch/utils"],
        cwd=REPO, capture_output=True, text=True)
    if pristine.returncode != 0 or pristine.stdout.strip():
        pytest.skip("pbs_tpu_torch/utils locally modified")
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert main(["check", "pbs_tpu_torch/utils", "--changed",
                     "HEAD"]) == 0
        assert "no checkable files changed" in capsys.readouterr().out
    finally:
        os.chdir(cwd)


def test_check_changed_cc_arms_cross_language_passes(tmp_path, capsys):
    """A changed ``runtime/csrc/*.cc`` pulls the port's Python ABI mirror
    modules into the incremental scan set."""
    repo = tmp_path / "r"
    csrc = repo / "pbs_tpu_torch" / "runtime" / "csrc"
    csrc.mkdir(parents=True)
    counters = repo / "pbs_tpu_torch" / "telemetry"
    counters.mkdir(parents=True)
    (counters / "counters.py").write_text("NUM_COUNTERS = 18\n")
    cc = csrc / "rt.cc"
    cc.write_text("static const int kNumCounters = 18;\n")
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True)
    subprocess.run(["git", "add", "-A"], cwd=repo, check=True)
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    "commit", "-q", "-m", "seed"], cwd=repo, check=True)
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        cc.write_text("static const int kNumCounters = 20;\n")
        assert main(["check", "pbs_tpu_torch", "--changed", "HEAD"]) == 1
        out = capsys.readouterr().out
        assert "abi-const-drift" in out
        assert "NUM_COUNTERS = 18" in out or "kNumCounters" in out
        cc.write_text("static const int kNumCounters = 18;\n")
        (counters / "counters.py").write_text("NUM_COUNTERS = 18\n")
        assert main(["check", "pbs_tpu_torch", "--changed", "HEAD"]) == 0
        capsys.readouterr()
    finally:
        os.chdir(cwd)


# -- phase 3k's CPU twin ------------------------------------------------------


@pytest.fixture
def lockdep_restored():
    """The lockdep graph and its boot param are process-global: restore
    both after the test, whatever it left."""
    from pbs_tpu_torch.obs import lockdep

    yield lockdep
    lockdep.lockdep.reset()
    lockdep.reset()


@pytest.mark.parametrize("root", ["pbs_tpu", "pbs_tpu_torch"])
def test_lockdep_param_alone_records_no_profiled_lock(root,
                                                      lockdep_restored):
    """In both packages a ``ProfiledLock`` has no lockdep hook: with the
    param set, nested ProfiledLocks record nothing and nested
    OrderedLocks record their edge. Phase 3k bridges the former."""
    import importlib

    lockdep = importlib.import_module(f"{root}.obs.lockdep")
    lockprof = importlib.import_module(f"{root}.obs.lockprof")
    lockdep.lockdep.set("1")
    lockdep.reset()
    try:
        with lockprof.ProfiledLock("pl_outer"):
            with lockprof.ProfiledLock("pl_inner"):
                pass
        assert lockdep.export_graph()["edges"] == []
        with lockdep.OrderedLock("ol_outer"):
            with lockdep.OrderedLock("ol_inner"):
                pass
        assert lockdep.export_graph()["edges"] == [["ol_outer", "ol_inner"]]
    finally:
        lockdep.lockdep.reset()
        lockdep.reset()


def toy_tenants():
    from pbs_tpu_torch.ops.matmul import instrumented_matmul, scale_stats

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=gen)
    b = torch.randn(64, 64, generator=gen)

    def mm_fn(state):
        out, raw = instrumented_matmul(a, b, 32, 32, 32)
        return out, scale_stats(raw, 32, 32, 32).metrics()

    def score_fn(state):
        logits = torch.tanh(a @ b)
        return logits[:, -1].argmax(), {"tokens": logits.shape[0]}

    return {"score": (score_fn, 64 * 64 * 4), "mm": (mm_fn, 3 * 64 * 64 * 4)}


def test_check_path_on_the_host(lockdep_restored):
    """Phase 3k (a)-(c) at toy width with ``device="cpu"``: every check
    of the card phase passes (each raises ``chip_smoke.Failed``), the
    live graph holds the RPC, memory and perfc locks' nesting, and the
    bridge leaves lockdep disarmed and empty."""
    from pbs_tpu_torch.obs.lockprof import ProfiledLock
    from pbs_tpu_torch.runtime.memory import MemoryManager

    acquire = ProfiledLock.acquire
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.check_path_run(toy_tenants(), "cpu",
                                        MemoryManager(1 << 30), tmp)
    chip_smoke.check_path_lines(out, "host")
    graph = out["a"]["graph"]
    assert ["rpc_dispatch", "memory_manager"] in graph["edges"]
    assert graph["violations"] == []
    assert out["b"]["out"]["files_scanned"] > 80
    assert out["c"]["tree_edges"] == 0
    assert out["c"]["edge"] == ("fixture_clean_a", "fixture_clean_b")
    assert ProfiledLock.acquire is acquire
    assert not lockdep_restored.lockdep.value
    assert lockdep_restored.export_graph()["edges"] == []
