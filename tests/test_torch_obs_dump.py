"""``pbs_tpu_torch.obs.dumpfile`` and the commands that read it, against
``pbs_tpu``'s.

The cases of ``tests/test_params_lockprof.py`` that the control-plane
twins (``tests/test_torch_control.py``) leave out: the store lock's
profile, the obs dump round trip through ``perfc``/``lockprof``/
``params``, ``params --cmdline`` and ``params`` in a fresh process. Each
runs on both packages with the reference test's assertions and equal
observables. Then the dump file itself: a dump written by either
package reads the same through either package's ``perfc``,
``lockprof``, ``params`` and ``lockdep`` commands.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import types

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    # The registry holds the params of the modules imported so far: load
    # the ones that declare params, in both packages, as ``params``
    # does in a fresh process.
    for name in ("obs.lockprof", "obs.lockdep", "obs.trace", "runtime.job",
                 "runtime.partition"):
        mod(name)
    return types.SimpleNamespace(
        root=root, params=mod("utils.params"), lockprof=mod("obs.lockprof"),
        lockdep=mod("obs.lockdep"), perfc=mod("obs.perfc").perfc,
        dumpfile=mod("obs.dumpfile"), store=mod("store"),
        main=mod("cli.pbst").main)


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
COMMANDS = ("perfc", "lockprof", "params", "lockdep")


@pytest.fixture(autouse=True)
def _clean_registry():
    for P in (REF, PORT):
        P.params.reset_all()
        P.lockprof.reset()
        P.lockdep.reset()
    yield
    for P in (REF, PORT):
        P.params.reset_all()
        P.lockprof.reset()
        P.lockdep.lockdep.reset()
        P.lockdep.reset()


def _run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def c_store_lock_is_profiled(P, tmp):
    P.params.get("lock_profile").set("on")
    P.lockprof.reset()
    s = P.store.Store()
    s.write("/x", 1)
    assert s.read("/x") == 1
    row = {r["name"]: r for r in P.lockprof.dump()}["store"]
    assert row["acquires"] >= 2
    return row["acquires"]


def _own_params(out: str) -> list[str]:
    """A ``params`` listing cut to the params both packages' registries
    declare, the ``t_`` ones tests declare left out: a registry holds
    every param of the modules imported so far, and a file run earlier
    on the same worker may have imported a module, or declared a test
    param, in one package only (the reference's ``ops.attention``
    declares ``flash_block_q``/``_k``, which the port has no param for)."""
    shared = set(REF.params.dump()) & set(PORT.params.dump())
    return [ln for ln in out.splitlines()
            if ln.split("=", 1)[0] in shared and not ln.startswith("t_")]


def c_obs_dump_roundtrip_and_cli(P, tmp):
    P.params.get("lock_profile").set("on")
    # perfc is process-global and never reset between files: the counter
    # shows what this case added to what it held.
    before = P.perfc.get("t_cli_counter")
    P.perfc.incr("t_cli_counter", 3)
    with P.lockprof.ProfiledLock("t_cli_lock"):
        pass
    path = str(tmp / "obs.json")
    snap = P.dumpfile.write_obs_dump(path)
    assert P.dumpfile.read_obs_dump(path) == json.loads(json.dumps(snap))
    rc, out = _run(P.main, ["perfc", path])
    perfc_line = [ln.split() for ln in out.splitlines()
                  if ln.startswith("t_cli_counter")]
    assert rc == 0 and perfc_line == [["t_cli_counter", str(before + 3)]]
    rc, out = _run(P.main, ["lockprof", path])
    assert rc == 0 and "t_cli_lock" in out
    lock_line = [ln.split()[:3] for ln in out.splitlines()
                 if "t_cli_lock" in ln]
    rc, out = _run(P.main, ["params", "--file", path])
    assert rc == 0 and "lock_profile=true" in out
    return [lock_line, sorted(snap), _own_params(out)]


def c_cli_params_cmdline(P, tmp):
    rc, out = _run(P.main, ["params", "--cmdline", "tbuf_size=99"])
    assert rc == 0 and "tbuf_size=99" in out
    return _own_params(out)


def c_cli_params_standalone_process(P, tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         f"from {P.root}.cli.pbst import main; main(['params'])"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("sched=", "tbuf_size=", "lock_profile=",
                 "sched_credit_tslice_us="):
        assert name in out.stdout
    return out.stdout


CASES = [c_store_lock_is_profiled, c_obs_dump_roundtrip_and_cli,
         c_cli_params_cmdline, c_cli_params_standalone_process]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_params_lockprof_case_twin(case, tmp_path):
    got = []
    for tag, P in (("ref", REF), ("port", PORT)):
        d = tmp_path / tag
        d.mkdir()
        got.append(case(P, d))
    assert got[1] == got[0]


def _dump_of(P, path: str) -> None:
    """A dump with something in every section: a counter, a profiled
    lock, a lock-order graph with one inversion, a set param."""
    P.params.get("lock_profile").set("on")
    P.lockdep.lockdep.set("1")
    P.perfc.incr("t_x_counter", 7)
    with P.lockprof.ProfiledLock("t_x_lock"):
        pass
    a, b = P.lockdep.OrderedLock("t_A"), P.lockdep.OrderedLock("t_B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    P.dumpfile.write_obs_dump(path)


def _lockprof_rows(out: str) -> list:
    # Wait and hold times differ run to run: names and counts only.
    return [ln.split()[:3] for ln in out.splitlines()]


@pytest.mark.parametrize("writer", [REF, PORT], ids=["ref-dump", "port-dump"])
@pytest.mark.parametrize("command", COMMANDS)
def test_dump_reads_the_same_through_either_package(writer, command,
                                                    tmp_path):
    path = str(tmp_path / "obs.json")
    _dump_of(writer, path)
    argv = ["params", "--file", path] if command == "params" \
        else [command, path]
    got = [_run(P.main, argv) for P in (REF, PORT)]
    if command == "lockprof":
        got = [(rc, _lockprof_rows(out)) for rc, out in got]
    assert got[1] == got[0]
    rc, out = got[0]
    assert rc == (1 if command == "lockdep" else 0)
    if command == "lockdep":
        graphs = [_run(P.main, ["lockdep", path, "--dump-graph"])
                  for P in (REF, PORT)]
        assert graphs[1] == graphs[0] and graphs[0][0] == 0
        assert json.loads(graphs[0][1])["violations"] == [
            {"holding": "t_B", "taking": "t_A", "count": 1}]


def test_both_dumps_have_one_shape(tmp_path):
    """The two packages' dumps of the same activity have the same
    sections and the same lock-order graph."""
    docs = []
    for P in (REF, PORT):
        path = str(tmp_path / f"{P.root}.json")
        _dump_of(P, path)
        docs.append(P.dumpfile.read_obs_dump(path))
    assert sorted(docs[0]) == sorted(docs[1]) == [
        "lockdep", "lockprof", "params", "perfc"]
    strip = lambda d: {k: v for k, v in d["lockdep"].items()  # noqa: E731
                       if k != "violations"}
    assert strip(docs[1]) == strip(docs[0])
    assert docs[1]["perfc"]["t_x_counter"] == docs[0]["perfc"]["t_x_counter"]
