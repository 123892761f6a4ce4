"""Hardware-counter-plane discipline pass (docs/HWTELEM.md).

``pbs_tpu_torch.hwtelem`` holds real kernel counter sources behind a
probed degradation ladder (perf_event → cgroup → rusage), recorded
windows, and deterministic replay. Three invariants keep that plane
honest, each mirroring a rule the tree already enforces elsewhere:

- ``hw-raw-syscall``: a raw ``perf_event_open``/``syscall(...)``
  invocation outside ``hwtelem/sources.py``. The ladder is the single
  owner of the perf ABI — attr packing, fd lifecycle, per-event errno
  interpretation, the ``PBST_HWTELEM_DISABLE`` kill switch all live
  there; a second site re-doing the syscall skips all of it (the
  counter-api single-owner rule, applied to the kernel boundary).
- ``hw-unguarded-probe``: a ``pick_tier(...)`` result consumed
  without a ``None`` branch. The ladder is OPTIONAL by contract —
  locked-down containers (``perf_event_paranoid``, missing cgroup
  controllers) legitimately yield no tier, and ``pick_tier`` returns
  None exactly there; unguarded consumers crash on the hosts the
  rusage floor exists for (the perf-native-unchecked rule, applied to
  counter tiers). Guards are recognized the same way: the bound name
  (or ``self`` attribute) in an ``if``/``while``/ternary/``assert``
  test or an ``is [not] None`` compare — per function for locals, per
  class for attributes.
- ``hw-wallclock``: a ``time.*`` clock read inside ``hwtelem/``
  outside a declared ``REAL_CLOCK_SEAM`` module. hwtelem is replay
  infrastructure — recorded windows must replay byte-identically, so
  only modules that DECLARE their live edge (the det-discipline seam
  marker, same detection) may touch the wall clock; everything else
  is handed timestamps or advances a VirtualClock.

The port of ``pbs_tpu.analysis.hwpass``; no departure (it anchors
through ``perfpass``).
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile
from pbs_tpu_torch.analysis.perfpass import (
    _anchored,
    _is_test,
    _none_guard_idents,
)

#: The one sanctioned owner of the raw perf ABI.
SYSCALL_MACHINERY = ("hwtelem/sources.py",)

#: Call names that constitute a raw perf/syscall invocation.
RAW_SYSCALLS = ("syscall", "perf_event_open")

#: The ladder probes whose result is None on locked-down hosts.
PROBE_CALLS = ("pick_tier",)

#: The det-discipline seam marker (memmodel/detpass.py): a module-level
#: non-empty string assignment to this name declares the live edge.
SEAM_MARKER = "REAL_CLOCK_SEAM"

#: Wall-clock reads (the det-wallclock set): any of these off a
#: ``time.``-rooted receiver is a live clock read.
TIME_FUNCS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns",
    "clock_gettime", "clock_gettime_ns",
})

#: The package the wallclock rule covers.
HW_PACKAGE = "hwtelem/"


def _call_tail(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _declares_seam(tree: ast.AST) -> bool:
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == SEAM_MARKER \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.value.value.strip():
            return True
    return False


def _time_aliases(tree: ast.AST) -> dict[str, str]:
    """``from time import monotonic [as m]`` bindings in this module."""
    out: dict[str, str] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in TIME_FUNCS:
                    out[alias.asname or alias.name] = alias.name
    return out


def _is_probe_call(node: ast.Call) -> bool:
    return _call_tail(node.func) in PROBE_CALLS


class _ProbeScan:
    """hw-unguarded-probe: the _NativeScan shape (perfpass) against
    ``pick_tier`` — locals per function, ``self.X`` per class, plus
    attribute rides directly off the call."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "hw-unguarded-probe", self.src.rel_path, node.lineno,
            node.col_offset,
            f"{what} — pick_tier() returns None when NO ladder tier "
            "works (perf_event_paranoid, missing cgroup controllers, "
            "PBST_HWTELEM_DISABLE), and this site crashes exactly on "
            "the locked-down hosts the degradation ladder exists for",
            hint="branch on the result (`if tier is not None: ...`) "
                 "and keep the no-counters path working "
                 "(hwtelem/sources.py, docs/HWTELEM.md)"))

    def scan(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Call) and \
                    _is_probe_call(node.value):
                self._flag(node, "attribute access directly on a "
                                 "pick_tier() result")
        for scope in ast.walk(tree):
            if isinstance(scope, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                self._scan_scope(scope, attr_scope=False)
            elif isinstance(scope, ast.ClassDef):
                self._scan_scope(scope, attr_scope=True)

    def _scan_scope(self, scope: ast.AST, attr_scope: bool) -> None:
        guarded = None  # lazy: most scopes never probe
        for sub in ast.walk(scope):
            if not (isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)
                    and _is_probe_call(sub.value)
                    and len(sub.targets) == 1):
                continue
            target = sub.targets[0]
            if attr_scope:
                if not (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    continue
                ident = target.attr
                what = (f"pick_tier() result stashed on self.{ident} "
                        "with no None branch anywhere in this class")
            else:
                if not isinstance(target, ast.Name):
                    continue  # self.X handled at class level
                ident = target.id
                what = (f"pick_tier() result bound to {ident!r} with "
                        "no None branch in this function")
            if guarded is None:
                guarded = _none_guard_idents(scope)
            if ident not in guarded:
                self._flag(sub, what)


class HwDisciplinePass(Pass):
    id = "hw-discipline"
    rules = ("hw-raw-syscall", "hw-unguarded-probe", "hw-wallclock")
    description = ("the hardware-counter plane stays honest: the perf "
                   "ABI has one owner (hwtelem/sources.py — no raw "
                   "perf_event_open/syscall elsewhere), every "
                   "pick_tier() consumer handles the None/locked-down "
                   "branch, and hwtelem modules read the wall clock "
                   "only behind a declared REAL_CLOCK_SEAM")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        findings: list[Finding] = []

        if anchored not in SYSCALL_MACHINERY:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call) and \
                        _call_tail(node.func) in RAW_SYSCALLS:
                    findings.append(Finding(
                        "hw-raw-syscall", src.rel_path, node.lineno,
                        node.col_offset,
                        f"raw {_call_tail(node.func)}(...) outside the "
                        "ladder — hwtelem/sources.py is the single "
                        "owner of the perf ABI (attr packing, fd "
                        "lifecycle, per-event errno reasons, the "
                        "disable kill switch); a second syscall site "
                        "skips all of it",
                        hint="go through hwtelem.sources: pick_tier() "
                             "/ HwCounterSource, or extend a "
                             "CounterTier there (docs/HWTELEM.md)"))

        pscan = _ProbeScan(src)
        pscan.scan(src.tree)
        findings.extend(pscan.findings)

        if anchored.startswith(HW_PACKAGE) and \
                not _declares_seam(src.tree):
            aliases = _time_aliases(src.tree)
            for node in ast.walk(src.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                clock = None
                if isinstance(func, ast.Attribute) and \
                        isinstance(func.value, ast.Name) and \
                        func.value.id == "time" and \
                        func.attr in TIME_FUNCS:
                    clock = f"time.{func.attr}"
                elif isinstance(func, ast.Name) and func.id in aliases:
                    clock = f"time.{aliases[func.id]}"
                if clock is not None:
                    findings.append(Finding(
                        "hw-wallclock", src.rel_path, node.lineno,
                        node.col_offset,
                        f"{clock}() in an hwtelem module with no "
                        "declared REAL_CLOCK_SEAM — recorded windows "
                        "must replay byte-identically, so only "
                        "modules that declare their live sampling "
                        "edge may read the wall clock",
                        hint="take timestamps as arguments / advance "
                             "a VirtualClock from recorded deltas, or "
                             "declare the seam: REAL_CLOCK_SEAM = "
                             "\"<why this module reads live time>\" "
                             "(hwtelem/sources.py, docs/HWTELEM.md)"))
        return findings
