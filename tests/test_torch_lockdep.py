"""``pbs_tpu_torch.obs.lockdep`` against ``pbs_tpu.obs.lockdep``.

Every case of ``tests/test_lockdep.py`` is written as a function of a
lockdep module: it runs on both packages with their ``lockdep`` boot
param on, makes the reference test's own assertions on each, and the
two runs' observables (violations, the order graph, ``export_graph``'s
JSON, strict-mode errors) must be equal. The CLI case writes an obs dump
with each package's ``write_obs_dump`` and reads it with each package's
``lockdep`` command: the verdicts and the ``--dump-graph`` documents of
all four pairings are equal.
"""

from __future__ import annotations

import importlib
import json
import threading

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")

REF = importlib.import_module("pbs_tpu.obs.lockdep")
PORT = importlib.import_module("pbs_tpu_torch.obs.lockdep")


@pytest.fixture(autouse=True)
def _lockdep_on():
    for L in (REF, PORT):
        L.lockdep.set("1")
        L.lockdep_strict.reset()
        L.reset()
    yield
    for L in (REF, PORT):
        L.lockdep.reset()
        L.lockdep_strict.reset()
        L.reset()


def _observe(L) -> str:
    snap = L.dump()
    return json.dumps({"violations": [
        {k: v for k, v in x.items() if k != "where"}
        for x in snap["violations"]],
        "edges": snap["edges"], "classes": snap["classes"],
        "checked_edges": snap["checked_edges"],
        "graph": L.export_graph()}, sort_keys=True)


def c_consistent_order_no_violation(L):
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert L.violations() == []
    assert L.dump()["edges"] == {"A": ["B"]}


def c_abba_inversion_detected_without_deadlock(L):
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    v = L.violations()
    assert len(v) == 1
    assert v[0]["holding"] == "B" and v[0]["taking"] == "A"
    assert v[0]["established_order"] == ["A", "B"]


def c_transitive_cycle_detected(L):
    a, b, c = L.OrderedLock("A"), L.OrderedLock("B"), L.OrderedLock("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass
    v = L.violations()
    assert len(v) == 1
    assert v[0]["established_order"] == ["A", "B", "C"]


def c_strict_mode_raises_at_faulting_acquire(L):
    L.lockdep_strict.set("1")
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(L.OrderViolation, match="AB-BA") as info:
            a.acquire()
    with a:
        with b:
            pass
    assert len(L.violations()) == 1
    return [str(info.value), info.value.cycle]


def c_reentrant_same_class_ok(L):
    a = L.OrderedLock("A", recursive=True)
    with a:
        with a:
            pass
    assert L.violations() == []


def c_reentrant_deep_in_stack_not_inversion(L):
    a = L.OrderedLock("A", recursive=True)
    b = L.OrderedLock("B")
    L.lockdep_strict.set("1")
    with a:
        with b:
            with a:
                pass
    assert L.violations() == []


def c_disabling_mid_hold_does_not_leak_held_stack(L):
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    a.acquire()
    L.lockdep.reset()
    a.release()
    L.lockdep.set("1")
    with b:
        pass
    assert L.dump()["edges"] == {}


def c_hand_over_hand_release(L):
    a, b, c = L.OrderedLock("A"), L.OrderedLock("B"), L.OrderedLock("C")
    a.acquire()
    b.acquire()
    a.release()
    c.acquire()
    c.release()
    b.release()
    assert L.dump()["edges"] == {"A": ["B"], "B": ["C"]}
    assert L.violations() == []


def c_per_thread_stacks_independent(L):
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    entered = threading.Event()
    release = threading.Event()

    def t1():
        with a:
            entered.set()
            release.wait(timeout=5)

    th = threading.Thread(target=t1)
    th.start()
    entered.wait(timeout=5)
    with b:
        pass
    release.set()
    th.join()
    assert L.dump()["edges"] == {}


def c_repeated_inversion_deduped(L):
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    with a:
        with b:
            pass
    for _ in range(50):
        with b:
            with a:
                pass
    v = L.violations()
    assert len(v) == 1
    assert v[0]["count"] == 50


def c_gating_off_means_no_bookkeeping(L):
    L.lockdep.reset()
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    with b:
        with a:
            pass
    assert L.dump()["edges"] == {}


def c_export_graph_reports_violation(L, tmp):
    """The twin of the reference's ``test_cli_lockdep_reports_violation``
    (the dump-file case): an inversion makes ``lockdep`` exit 1 on the
    dump and shows in its ``--dump-graph`` export, a reset dump exits 0. Each package's dump is
    read by both packages' command, with equal verdicts and graphs."""
    a, b = L.OrderedLock("A"), L.OrderedLock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    pkg = L.__name__.rsplit(".obs.", 1)[0]
    dumpfile = importlib.import_module(f"{pkg}.obs.dumpfile")
    dump_path = str(tmp / f"{pkg}.obs.json")
    dumpfile.write_obs_dump(dump_path)
    out = []
    for main in MAINS:
        assert main(["lockdep", dump_path]) == 1  # violations -> rc 1
        out.append(_graph_of(main, dump_path))
    L.reset()
    clean_path = str(tmp / f"{pkg}.clean.json")
    dumpfile.write_obs_dump(clean_path)
    for main in MAINS:
        assert main(["lockdep", clean_path]) == 0
        out.append(_graph_of(main, clean_path))
    assert out[0] == out[1] and out[2] == out[3]
    assert json.loads(out[0])["violations"] == [
        {"holding": "B", "taking": "A", "count": 1}]
    assert json.loads(out[2])["violations"] == []
    return out


CASES = [c_consistent_order_no_violation,
         c_abba_inversion_detected_without_deadlock,
         c_transitive_cycle_detected,
         c_strict_mode_raises_at_faulting_acquire,
         c_reentrant_same_class_ok,
         c_reentrant_deep_in_stack_not_inversion,
         c_disabling_mid_hold_does_not_leak_held_stack,
         c_hand_over_hand_release, c_per_thread_stacks_independent,
         c_repeated_inversion_deduped, c_gating_off_means_no_bookkeeping,
         c_export_graph_reports_violation]


MAINS = (importlib.import_module("pbs_tpu.cli.pbst").main,
         importlib.import_module("pbs_tpu_torch.cli.pbst").main)


def _graph_of(main, dump_path: str) -> str:
    """``lockdep DUMP --dump-graph``'s document, read off stdout."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["lockdep", dump_path, "--dump-graph"]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_lockdep_case_twin(case, tmp_path, capsys):
    got = []
    for L in (REF, PORT):
        args = (tmp_path,) if case.__code__.co_argcount == 2 else ()
        ret = case(L, *args)
        got.append((repr(ret), _observe(L)))
    capsys.readouterr()
    assert got[1] == got[0]


def test_lockdep_params_are_boot_params():
    """``lockdep``/``lockdep_strict`` are the port's boot params, off by
    default, as the reference declares them."""
    from pbs_tpu_torch.utils import params

    for name in ("lockdep", "lockdep_strict"):
        p = params.get(name)
        assert p.default is False
    assert PORT.lockdep is params.get("lockdep")
