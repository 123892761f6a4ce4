"""The port's static checker (``pbs_tpu_torch.analysis``) against
``pbs_tpu.analysis``.

Twins of every case of ``tests/test_analysis_passes.py``, plus direct
parity checks in the same process. The reference's fixture trees
(``tests/fixtures/analysis/{bad,clean}``) are copied at test time under
the port's names by ``chip_smoke.port_fixture_tree`` (the fixture files
themselves are never touched); the port's findings over the copies,
mapped back to the reference's names by :func:`to_reference`, must equal
``golden_bad.json`` with nothing else tolerated. Cases that write a small
tree of their own write it once per package, under that package's name,
and run each package's checker on its own tree: the findings must be
equal once mapped.
"""

from __future__ import annotations

import json
import os
import re

import pytest

import chip_smoke
from pbs_tpu import analysis as ref
from pbs_tpu_torch import analysis as port
from pbs_tpu_torch.cli.pbst import main

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "analysis")
REF_BAD = os.path.join(FIXTURES, "bad")

#: Every rule of every pass, as the reference test lists them.
ALL_RULES = {
    "lock-raw", "lock-order", "lock-blocking",
    "unit-mix",
    "sched-ops-missing", "sched-ops-signature", "sched-ops-clamp",
    "counter-raw-cache", "counter-raw-threshold",
    "net-raw-socket", "net-raw-transport",
    "gw-direct-submit", "gw-direct-dispatch", "gw-lease-bypass",
    "perf-rec-loop", "perf-emit-in-loop", "perf-dispatch-alloc",
    "perf-native-unchecked", "perf-native-sim-unguarded",
    "obs-unclosed-span", "obs-span-emit-in-loop", "obs-hist-scan",
    "knob-unrouted", "knob-inline-tunable", "knob-unknown",
    "knob-unit-drift", "knob-native-drift",
    "rollout-push", "rollout-set-local",
    "scenario-corpus-golden", "scenario-raw-genome",
    "dur-unjournaled-mutation", "dur-unsealed-read",
    "proc-raw-kill", "proc-unreaped-spawn",
    "proc-undeadlined-client",
    "serve-unmatched-rule", "serve-raw-mesh-axis",
    "seqlock-missing-release", "seqlock-plain-store",
    "seqlock-unbalanced", "seqlock-reader-protocol",
    "seqlock-ring-publish", "seqlock-raw-py-write",
    "abi-const-drift", "abi-missing-const", "abi-magic-literal",
    "abi-binding-arity", "abi-unknown-symbol",
    "abi-unbound-export", "abi-fastcall-table",
    "hw-raw-syscall", "hw-unguarded-probe", "hw-wallclock",
    "det-wallclock", "det-unseeded-rng", "det-urandom",
    "det-set-iteration",
}

_PORT_NAME = re.compile(r"\bpbs_tpu_torch\b")


def _names_back(text: str) -> str:
    text = text.replace("pbs_tpu_torch/runtime/csrc/", "native/")
    text = text.replace("runtime/csrc/", "native/")
    return _PORT_NAME.sub("pbs_tpu", text)


def to_reference(finding: dict, root: str | None = None) -> dict:
    """The name map, port to reference: a finding's path, message and
    hint with the port's C directory (``pbs_tpu_torch/runtime/csrc/``, or
    ``runtime/csrc/`` in prose) read as ``native/`` and
    ``pbs_tpu_torch`` as ``pbs_tpu``. Given the ``root`` the path is
    under, the column drops by the length of the renamed text before it
    on its line (``_torch`` for each ``pbs_tpu_torch`` that ends at or
    before it); nothing else changes."""
    out = dict(finding)
    for key in ("path", "message", "hint"):
        if key in out:
            out[key] = _names_back(out[key])
    if root is not None and finding["path"].endswith(".py"):
        with open(os.path.join(root, finding["path"]), encoding="utf-8") as f:
            lines = f.read().splitlines()
        if 0 < finding["line"] <= len(lines):
            text = lines[finding["line"] - 1]
            shifted = sum(1 for m in _PORT_NAME.finditer(text)
                          if m.end() <= finding["col"])
            out["col"] = finding["col"] - len("_torch") * shifted
    return out


def _sort_key(d: dict) -> tuple:
    # The runner's own order (Finding.sort_key) over the mapped names.
    return (d["path"], d["line"], d["col"], d["check"], d["message"])


def mapped(result, root: str) -> list[dict]:
    return sorted((to_reference(f.as_dict(), root) for f in result.findings),
                  key=_sort_key)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The bad and clean fixture trees under the port's names, and the
    port's check of each."""
    out = {}
    for which in ("bad", "clean"):
        root = chip_smoke.port_fixture_tree(
            which, str(tmp_path_factory.mktemp(which)))
        out[which] = root
        out[which + "_result"] = port.check_paths([root], root=root)
    return out


def both(tmp_path, files: dict[str, str], **kw) -> list[dict]:
    """Write ``files`` ({path: text}, ``{pkg}`` standing for the package
    name in both) once per package, run that package's ``check_paths``
    on its own tree, and return the reference's findings after holding
    the port's, mapped, equal to them."""
    got = {}
    for tag, mod, pkg in (("ref", ref, "pbs_tpu"),
                          ("port", port, "pbs_tpu_torch")):
        root = tmp_path / tag
        for rel, text in files.items():
            f = root / rel.format(pkg=pkg)
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(text.replace("{pkg}", pkg))
        r = mod.check_paths([str(root)], root=str(root), **kw)
        got[tag] = (r, str(root))
    want = sorted((f.as_dict() for f in got["ref"][0].findings),
                  key=_sort_key)
    assert mapped(*got["port"]) == want
    assert len(got["port"][0].suppressed) == len(got["ref"][0].suppressed)
    return want


# -- parity with the reference ----------------------------------------------


def test_pass_table_equals_the_reference():
    """Pass ids, rule ids and descriptions, in report order."""
    want = [(c.id, c.rules, c.description) for c in ref.ALL_PASSES]
    got = [(c.id, c.rules, _names_back(c.description))
           for c in port.ALL_PASSES]
    assert got == want
    assert port.pass_ids() == ref.pass_ids()
    assert {r for c in port.ALL_PASSES for r in c.rules} == ALL_RULES


def test_bad_tree_matches_golden(trees):
    with open(os.path.join(FIXTURES, "golden_bad.json")) as f:
        golden = json.load(f)
    assert len(golden) == 109
    assert mapped(trees["bad_result"], trees["bad"]) == golden
    # The reference over the original tree, in the same process.
    got = [fi.as_dict() for fi in ref.check_paths([REF_BAD],
                                                  root=REF_BAD).findings]
    assert got == golden


def test_all_rules_fire_on_bad_tree(trees):
    counts = trees["bad_result"].counts()
    assert set(counts) == ALL_RULES
    assert counts == ref.check_paths([REF_BAD], root=REF_BAD).counts()


def test_clean_twins_are_clean(trees):
    r = trees["clean_result"]
    assert [fi.as_dict() for fi in r.findings] == []
    assert [(fi.check, j) for fi, j in r.suppressed] == [
        ("lock-raw",
         "interpreter-boot guard, taken once before any thread exists")]


def test_pass_selection(trees):
    bad = trees["bad"]
    r = port.check_paths([bad], root=bad, passes=["time-units"])
    assert r.passes_run == ["time-units"]
    assert set(r.counts()) == {"unit-mix"}
    with pytest.raises(KeyError):
        port.check_paths([bad], passes=["nonesuch"])


@pytest.mark.parametrize("payload", [
    '{"version": 1, "edges": [["a", "b"], ["b", "c"]]}',
    '{"classes": ["a", "b"], "edges": {"a": ["b"]}, "violations": []}',
    '{"lockdep": {"edges": {"a": ["b", "c"]}}, "perfc": {"x": 1}}',
    '[["a", "b"]]',
    '[]',
    '{"edges": [["a"]]}',
    '"just a string"',
    "[1, 2]",
    '{"perfc": {"x": 1}}',
    '{"edges": {"a": "b"}}',
    '{"edges": {"a": [1]}}',
    '{"edges": 7}',
])
def test_load_dynamic_graph_accepts_and_rejects_as_the_reference(
        tmp_path, payload):
    path = tmp_path / "graph.json"
    path.write_text(payload)
    out = []
    for mod in (ref, port):
        try:
            out.append(("edges", sorted(mod.load_dynamic_graph(str(path)))))
        except Exception as e:  # noqa: BLE001 — the type is compared
            out.append(("raises", type(e).__name__))
    assert out[1] == out[0]


def test_each_file_anchored_once_under_its_own_package(tmp_path):
    """A tree holding both packages: the port's checker anchors the
    port's files under ``pbs_tpu_torch`` and reads the reference's
    ``pbs_tpu`` as no package of its own (so a hot-path rule does not
    fire there), and the reference's checker the other way round."""
    raw = "import threading\n_l = threading.Lock()\n"
    for pkg in ("pbs_tpu", "pbs_tpu_torch"):
        f = tmp_path / pkg / "runtime" / "m.py"
        f.parent.mkdir(parents=True)
        f.write_text(raw)
    # Nested the other way: a package directory inside the other's tree.
    for outer, inner in (("pbs_tpu", "pbs_tpu_torch"),
                         ("pbs_tpu_torch", "pbs_tpu")):
        f = tmp_path / outer / "vendor" / inner / "store" / "m.py"
        f.parent.mkdir(parents=True)
        f.write_text(raw)
    root = str(tmp_path)
    got = {}
    for tag, mod in (("ref", ref), ("port", port)):
        r = mod.check_paths([root], root=root, passes=["lock-discipline"])
        got[tag] = sorted(f.path for f in r.findings)
    assert got["port"] == ["pbs_tpu/vendor/pbs_tpu_torch/store/m.py",
                           "pbs_tpu_torch/runtime/m.py"]
    assert got["ref"] == ["pbs_tpu/runtime/m.py",
                          "pbs_tpu_torch/vendor/pbs_tpu/store/m.py"]


# -- twins of tests/test_analysis_passes.py ---------------------------------


def test_suppression_requires_justification(tmp_path):
    want = both(tmp_path, {"{pkg}/runtime/m.py": (
        "import threading\n"
        "_a = threading.Lock()  # pbst: ignore[lock-raw]\n"
        "_b = threading.Lock()  # pbst: ignore-file[lock-raw] -- "
        "fixture-wide escape, reviewed\n")})
    assert [fi["check"] for fi in want] == ["bad-suppression"]
    root = tmp_path / "port"
    r = port.check_paths([str(root)], root=str(root))
    assert len(r.suppressed) == 2


def test_cli_check_bad_tree_exits_nonzero(trees, capsys):
    assert main(["check", trees["bad"]]) == 1
    out = capsys.readouterr().out
    assert "lock-order" in out and "finding(s)" in out


def test_cli_check_json_format(trees, capsys):
    assert main(["check", trees["bad"], "--format", "json"]) == 1
    d = json.loads(capsys.readouterr().out)
    assert d["version"] == 1
    assert d["counts"]["unit-mix"] == 5
    assert all({"check", "path", "line", "col", "message"} <= set(f)
               for f in d["findings"])
    assert d["passes"] == ref.pass_ids()


def test_cli_unknown_pass_is_usage_error(trees, capsys):
    assert main(["check", trees["bad"], "--pass", "nonesuch"]) == 2
    assert "unknown pass" in capsys.readouterr().err


def test_cli_list_passes(capsys):
    from pbs_tpu.cli.pbst import main as ref_main

    assert main(["check", "--list-passes"]) == 0
    out = capsys.readouterr().out
    for pid in ("lock-discipline", "time-units", "sched-ops",
                "counter-api", "gateway-discipline", "perf-discipline",
                "obs-discipline", "knob-discipline",
                "rollout-discipline", "scenario-discipline",
                "durability-discipline", "serve-discipline",
                "seqlock-discipline", "abi-layout-drift",
                "hw-discipline", "determinism-discipline"):
        assert pid in out
    assert ref_main(["check", "--list-passes"]) == 0
    assert _names_back(out) == capsys.readouterr().out


def test_static_dynamic_crosscheck(tmp_path, capsys):
    """The lockdep bridge, by the reference's route: a dynamic A->B edge
    written to an obs dump (``write_obs_dump``) and exported by
    ``pbst-torch lockdep --dump-graph`` makes a static B->A nesting a
    finding."""
    from pbs_tpu_torch.obs import lockdep
    from pbs_tpu_torch.obs.dumpfile import write_obs_dump

    lockdep.lockdep.set("1")
    lockdep.reset()
    try:
        outer = lockdep.OrderedLock("dyn_outer")
        inner = lockdep.OrderedLock("dyn_inner")
        with outer:
            with inner:  # dynamic edge dyn_outer -> dyn_inner
                pass
        dump_path = str(tmp_path / "obs.json")
        write_obs_dump(dump_path)
    finally:
        lockdep.lockdep.reset()
        lockdep.reset()

    assert main(["lockdep", dump_path, "--dump-graph"]) == 0
    graph = json.loads(capsys.readouterr().out)
    assert graph["version"] == 1
    assert ["dyn_outer", "dyn_inner"] in graph["edges"]
    graph_path = tmp_path / "graph.json"
    graph_path.write_text(json.dumps(graph))
    assert ("dyn_outer", "dyn_inner") in port.load_dynamic_graph(
        str(graph_path))

    # Static code nesting the two in the INVERTED order: clean on its
    # own, an AB-BA finding once the dynamic graph joins the check.
    mod = tmp_path / "pbs_tpu_torch" / "runtime" / "inverted.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(
        "from pbs_tpu_torch.obs.lockprof import ProfiledLock\n"
        "x = ProfiledLock('dyn_inner')\n"
        "y = ProfiledLock('dyn_outer')\n"
        "def f():\n"
        "    with x:\n"
        "        with y:\n"
        "            pass\n")
    assert main(["check", str(tmp_path / "pbs_tpu_torch")]) == 0
    capsys.readouterr()
    assert main(["check", str(tmp_path / "pbs_tpu_torch"),
                 "--lockdep-graph", str(graph_path)]) == 1
    assert "AB-BA" in capsys.readouterr().out


def test_purely_static_cycle_needs_no_dynamic_graph(tmp_path):
    want = both(tmp_path, {"m.py": (
        "from {pkg}.obs.lockprof import ProfiledLock\n"
        "a = ProfiledLock('s_a')\n"
        "b = ProfiledLock('s_b')\n"
        "def f():\n"
        "    with a:\n"
        "        with b: pass\n"
        "def g():\n"
        "    with b:\n"
        "        with a: pass\n")})
    assert [fi["check"] for fi in want] == ["lock-order", "lock-order"]


def test_blocking_in_with_item_is_caught(tmp_path):
    want = both(tmp_path, {"{pkg}/runtime/m.py": (
        "from {pkg}.obs.lockprof import ProfiledLock\n"
        "mu = ProfiledLock('itemlock')\n"
        "def f(path):\n"
        "    with mu:\n"
        "        with open(path) as fh:\n"
        "            return fh.read()\n")})
    assert [fi["check"] for fi in want] == ["lock-blocking"]


def test_deferred_callback_under_lock_not_flagged(tmp_path):
    want = both(tmp_path, {"{pkg}/runtime/m.py": (
        "import time\n"
        "from {pkg}.obs.lockprof import ProfiledLock\n"
        "mu = ProfiledLock('cb_lock')\n"
        "cbs = []\n"
        "def register():\n"
        "    with mu:\n"
        "        def cb(now):\n"
        "            time.sleep(1)\n"
        "        cbs.append(cb)\n")})
    assert want == []


def test_cli_malformed_graph_is_usage_error(trees, tmp_path, capsys):
    bad_graph = tmp_path / "graph.json"
    for payload in ('{"edges": [["a"]]}', '"just a string"', "[1, 2]"):
        bad_graph.write_text(payload)
        assert main(["check", trees["bad"], "--lockdep-graph",
                     str(bad_graph)]) == 2
        assert "bad --lockdep-graph" in capsys.readouterr().err
    # The bare pair-list shorthand is accepted.
    bad_graph.write_text('[["a", "b"]]')
    assert port.load_dynamic_graph(str(bad_graph)) == {("a", "b")}


@pytest.mark.parametrize("payload,rc", [
    ('{"version": 1, "classes": ["a", "b"], "edges": [["a", "b"]], '
     '"violations": []}', 0),
    ('{"classes": ["a", "b"], "edges": {"a": ["b"]}, "violations": [], '
     '"checked_edges": 1}', 0),
    ('{"perfc": {"x": 1}, "lockdep": {"edges": {"a": ["b"]}}}', 0),
    ('[["a", "b"]]', 0),
    ('{"perfc": {"x": 1}}', 2),
])
def test_cli_lockdep_graph_shapes(trees, tmp_path, capsys, payload, rc):
    """``--lockdep-graph``: the export, the raw snapshot, an obs dump's
    section and a bare pair list are accepted (the clean tree stays
    clean); a dict without ``edges`` is a usage error."""
    graph = tmp_path / "graph.json"
    graph.write_text(payload)
    assert main(["check", trees["clean"], "--lockdep-graph",
                 str(graph)]) == rc
    captured = capsys.readouterr()
    if rc == 2:
        assert "bad --lockdep-graph" in captured.err
    else:
        assert "0 finding(s)" in captured.out


def test_parse_error_is_reported(tmp_path):
    want = both(tmp_path, {"broken.py": "def f(:\n"})
    assert [fi["check"] for fi in want] == ["parse-error"]


def test_lock_raw_catches_imported_and_aliased_ctors(tmp_path):
    want = both(tmp_path, {"{pkg}/runtime/m.py": (
        "from threading import Lock, RLock as RL\n"
        "_a = Lock()\n"
        "_b = RL()\n")})
    assert [fi["check"] for fi in want] == ["lock-raw", "lock-raw"]


def test_sched_clamp_catches_keyword_and_qualified_decision(tmp_path):
    want = both(tmp_path, {"m.py": (
        "from {pkg}.sched import base\n"
        "from {pkg}.sched.base import Scheduler, register_scheduler\n"
        "@register_scheduler\n"
        "class Kw(Scheduler):\n"
        "    name = 'kw'\n"
        "    def wake(self, ctx):\n"
        "        pass\n"
        "    def do_schedule(self, ex, now_ns):\n"
        "        ctx = self.q.pop()\n"
        "        return base.Decision(\n"
        "            ctx=ctx, quantum_ns=ctx.job.params.tslice_us * 1000)\n")})
    assert [fi["check"] for fi in want] == ["sched-ops-clamp"]


def test_counter_cache_not_fooled_by_unrelated_prev_names(tmp_path):
    want = both(tmp_path, {"m.py": (
        "class C:\n"
        "    def f(self, ctx, prev_offset):\n"
        "        self.base = int(ctx.counters[0]) + prev_offset\n"
        "    def g(self, ctx):\n"
        "        return int(ctx.counters[0] - ctx.prev_counters[0])\n")})
    assert [fi["check"] for fi in want] == ["counter-raw-cache"]


def test_obs_dump_accepted_as_lockdep_graph(tmp_path):
    dump = tmp_path / "obs.json"
    dump.write_text(json.dumps({
        "perfc": {"x": 1},
        "lockprof": [],
        "lockdep": {"classes": ["a", "b"], "edges": {"a": ["b"]},
                    "violations": [], "checked_edges": 1},
        "params": {},
    }))
    assert port.load_dynamic_graph(str(dump)) == {("a", "b")}
    dump.write_text(json.dumps({"perfc": {"x": 1}}))
    with pytest.raises(ValueError):
        port.load_dynamic_graph(str(dump))
