"""``pbst check`` driver: walk, parse, run passes, filter, format.

The runner owns everything pass-agnostic: file discovery, suppression
filtering (passes emit every hit; the escape hatch is applied in ONE
place so no pass can forget it), deterministic ordering, and the two
output formats. Exit-code contract (CI gates on it):

- 0: clean tree (possibly via justified suppressions)
- 1: findings
- 2: usage error (no files, unknown pass, unreadable graph)

The port of ``pbs_tpu.analysis.runner``; no departure of its own:
``--changed`` expands a changed ``.cc`` with
``memmodel.CROSS_LANG_PY_ANCHORS``, which name the port's files.
``CHECK_EXTS`` stays ``.py`` and ``.cc``, as in the reference, so the
port's ``.cu``/``.cuh`` kernels are out of scope.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterable

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    CSourceFile,
    Finding,
    Pass,
    SourceFile,
)
from pbs_tpu_torch.analysis.counterapi import CounterApiPass
from pbs_tpu_torch.analysis.durabilitypass import DurabilityPass
from pbs_tpu_torch.analysis.gatewaypass import GatewayDisciplinePass
from pbs_tpu_torch.analysis.hwpass import HwDisciplinePass
from pbs_tpu_torch.analysis.knobspass import KnobDisciplinePass
from pbs_tpu_torch.analysis.locks import LockDisciplinePass
from pbs_tpu_torch.analysis.memmodel import (
    AbiLayoutDriftPass,
    DeterminismDisciplinePass,
    SeqlockDisciplinePass,
)
from pbs_tpu_torch.analysis.netdiscipline import NetDisciplinePass
from pbs_tpu_torch.analysis.obspass import ObsDisciplinePass
from pbs_tpu_torch.analysis.perfpass import PerfDisciplinePass
from pbs_tpu_torch.analysis.procpass import ProcessDisciplinePass
from pbs_tpu_torch.analysis.rolloutpass import RolloutDisciplinePass
from pbs_tpu_torch.analysis.scenariopass import ScenarioDisciplinePass
from pbs_tpu_torch.analysis.schedops import SchedOpsPass
from pbs_tpu_torch.analysis.servepass import ServeDisciplinePass
from pbs_tpu_torch.analysis.units import TimeUnitPass

#: The suite, in report order. Adding a pass = append here + docs.
ALL_PASSES: tuple[type[Pass], ...] = (
    LockDisciplinePass,
    TimeUnitPass,
    SchedOpsPass,
    CounterApiPass,
    NetDisciplinePass,
    GatewayDisciplinePass,
    PerfDisciplinePass,
    ObsDisciplinePass,
    KnobDisciplinePass,
    RolloutDisciplinePass,
    ScenarioDisciplinePass,
    DurabilityPass,
    ProcessDisciplinePass,
    ServeDisciplinePass,
    SeqlockDisciplinePass,
    AbiLayoutDriftPass,
    HwDisciplinePass,
    DeterminismDisciplinePass,
)


def pass_ids() -> list[str]:
    return [p.id for p in ALL_PASSES]


@dataclasses.dataclass
class CheckResult:
    findings: list[Finding]
    suppressed: list[tuple[Finding, str]]  # (finding, justification)
    files_scanned: int
    passes_run: list[str]

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def as_dict(self) -> dict[str, Any]:
        return {
            "version": 1,
            "passes": self.passes_run,
            "files_scanned": self.files_scanned,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [
                {**f.as_dict(), "justification": j}
                for f, j in self.suppressed
            ],
            "counts": self.counts(),
        }

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.check] = out.get(f.check, 0) + 1
        return out


#: Extensions the checker scans. .py files get the AST pass suite;
#: .cc files get the cross-language memmodel passes (run_c hook).
CHECK_EXTS = (".py", ".cc")


def iter_check_files(paths: Iterable[str],
                     exts: tuple[str, ...] = CHECK_EXTS) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(exts):
                out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                for f in sorted(files):
                    if f.endswith(exts):
                        out.append(os.path.join(root, f))
    return sorted(dict.fromkeys(out))


def iter_py_files(paths: Iterable[str]) -> list[str]:
    return iter_check_files(paths, exts=(".py",))


def load_dynamic_graph(path: str) -> set[tuple[str, str]]:
    """Edges from a ``pbst lockdep --dump-graph`` artifact. Accepts the
    stable export shape ({"edges": [["a","b"], ...]}), the raw snapshot
    shape ({"edges": {"a": ["b", ...]}}), a whole obs dump (descends
    into its "lockdep" section), and a bare pair list. Anything else
    is a ValueError — fabricating edges from an unrelated dict would
    silently disable the cross-check."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("lockdep"), dict):
        data = data["lockdep"]  # obs dump artifact: use its section
    if isinstance(data, dict):
        if "edges" not in data:
            raise ValueError("dict artifact has no 'edges' key — not a "
                             "lock-order graph")
        edges = data["edges"]
    else:
        edges = data
    out: set[tuple[str, str]] = set()
    if isinstance(edges, dict):
        for a, bs in edges.items():
            if not isinstance(bs, list) or \
                    not all(isinstance(b, str) for b in bs):
                raise ValueError(f"edges[{a!r}] is not a list of class "
                                 "names")
            for b in bs:
                out.add((str(a), b))
    elif isinstance(edges, list):
        for pair in edges:
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise ValueError(f"edge {pair!r} is not a [holder, taken] "
                                 "pair")
            out.add((str(pair[0]), str(pair[1])))
    else:
        raise ValueError("graph holds no edges dict or pair list")
    return out


def changed_check_files(base_ref: str, paths: Iterable[str],
                        root: str | None = None) -> list[str]:
    """The ``--changed`` fast path: checkable files (.py and .cc)
    under ``paths`` that differ from ``base_ref`` in git (working tree
    vs ref, deletions excluded) plus untracked files. Raises
    ValueError when git cannot answer (not a repo, unknown ref) — the
    CLI maps that to a usage error, never to a silently-empty "clean"
    run.

    A changed ``.cc`` file arms the cross-language memmodel passes,
    which diff the C layout against its Python mirrors — so the
    changed set is EXPANDED with every sibling .cc under ``paths``
    (pbst_fastcall.cc #includes pbst_runtime.cc: constants flow across
    files) and the declared Python ABI anchor modules (resolved
    against the git toplevel; silently absent in trees that don't
    have them). A .py-only change set is returned as-is.

    Caveat (documented in docs/ANALYSIS.md): cross-file analyses
    (static lock-order graph, knob-native-drift, knob constant
    resolution across modules) see only the changed subset in this
    mode — it is the pre-commit fast path; CI runs the full tree."""
    import subprocess

    root = os.path.abspath(root or os.getcwd())
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=root, capture_output=True, text=True, timeout=60)
        diff = subprocess.run(
            ["git", "diff", "--name-only", "--diff-filter=d", base_ref],
            cwd=root, capture_output=True, text=True, timeout=60)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise ValueError(f"git unavailable for --changed: {e}") from None
    if top.returncode != 0 or diff.returncode != 0:
        raise ValueError(
            f"git diff {base_ref!r} failed: "
            f"{(diff.stderr or top.stderr).strip() or 'unknown error'}")
    # `git diff --name-only` paths are TOPLEVEL-relative; `ls-files
    # --others` paths are cwd-relative. Anchor each against the right
    # base or a subdirectory invocation silently reports clean.
    toplevel = top.stdout.strip()
    changed = {os.path.abspath(os.path.join(toplevel, n))
               for n in diff.stdout.splitlines() if n.endswith(CHECK_EXTS)}
    if untracked.returncode == 0:
        changed |= {os.path.abspath(os.path.join(root, n))
                    for n in untracked.stdout.splitlines()
                    if n.endswith(CHECK_EXTS)}
    wanted = set()
    for p in iter_check_files(paths):
        ap = os.path.abspath(p)
        if ap in changed and os.path.isfile(ap):
            wanted.add(p)
    if any(p.endswith(".cc") for p in wanted):
        # Cross-language context for the memmodel passes: every .cc
        # under paths (constants span #include'd siblings) + the
        # Python mirror modules the ABI contract names.
        from pbs_tpu_torch.analysis.memmodel import CROSS_LANG_PY_ANCHORS

        wanted |= {p for p in iter_check_files(paths)
                   if p.endswith(".cc")}
        for rel in CROSS_LANG_PY_ANCHORS:
            ap = os.path.join(toplevel, rel)
            if os.path.isfile(ap):
                wanted.add(ap)
    return sorted(wanted)


def changed_py_files(base_ref: str, paths: Iterable[str],
                     root: str | None = None) -> list[str]:
    """Back-compat shim: the .py subset of :func:`changed_check_files`
    (no cross-language expansion)."""
    return [p for p in changed_check_files(base_ref, paths, root)
            if p.endswith(".py")]


def list_suppressions(paths: Iterable[str],
                      root: str | None = None) -> list[dict]:
    """Every suppression comment under ``paths`` with file:line,
    rules, scope, and justification — the ``pbst check
    --list-suppressions`` audit surface. Unparseable/justification-
    less comments are listed too (rule ``bad-suppression``), so the
    audit can't under-report the escape hatch."""
    root = root or os.getcwd()
    out: list[dict] = []
    for path in iter_check_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            continue
        rel = os.path.relpath(os.path.abspath(path), root)
        cls = CSourceFile if path.endswith(".cc") else SourceFile
        src = cls(path, text, rel_path=rel.replace(os.sep, "/"))
        for s in src.suppressions:
            out.append({
                "path": src.rel_path, "line": s.line,
                "rules": list(s.rules),
                "scope": "file" if s.file_wide else "line",
                "justification": s.justification,
            })
        for f_ in src.bad_suppressions:
            out.append({
                "path": src.rel_path, "line": f_.line,
                "rules": ["bad-suppression"], "scope": "line",
                "justification": "",
            })
    out.sort(key=lambda d: (d["path"], d["line"]))
    return out


def check_paths(paths: Iterable[str],
                passes: Iterable[str] | None = None,
                dynamic_graph: set[tuple[str, str]] | None = None,
                root: str | None = None) -> CheckResult:
    """Run the suite over ``paths``. ``root`` (default cwd) anchors the
    relative paths findings report, so golden outputs are stable."""
    root = root or os.getcwd()
    selected = list(ALL_PASSES)
    if passes is not None:
        wanted = set(passes)
        unknown = wanted - set(pass_ids())
        if unknown:
            raise KeyError(
                f"unknown pass(es) {sorted(unknown)}; "
                f"available: {pass_ids()}")
        selected = [p for p in ALL_PASSES if p.id in wanted]

    files: list[SourceFile] = []
    c_files: list[CSourceFile] = []
    for path in iter_check_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            continue
        rel = os.path.relpath(os.path.abspath(path), root)
        rel = rel.replace(os.sep, "/")
        if path.endswith(".cc"):
            c_files.append(CSourceFile(path, text, rel_path=rel))
        else:
            files.append(SourceFile(path, text, rel_path=rel))

    ctx = CheckContext(files, dynamic_lock_edges=dynamic_graph,
                       c_files=c_files)
    instances = [cls() for cls in selected]
    raw: list[Finding] = []
    for src in files:
        if src.parse_error is not None:
            raw.append(src.parse_error)
        raw.extend(src.bad_suppressions)
        if src.tree is None:
            continue
        for inst in instances:
            raw.extend(inst.run(src, ctx))
    for csrc in c_files:
        raw.extend(csrc.bad_suppressions)
        for inst in instances:
            raw.extend(inst.run_c(csrc, ctx))
    for inst in instances:
        raw.extend(inst.finalize(ctx))

    by_rel = {src.rel_path: src for src in [*files, *c_files]}
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for f in sorted(raw, key=Finding.sort_key):
        src = by_rel.get(f.path)
        if src is not None and src.suppressed(f.check, f.line):
            just = next((s.justification for s in src.suppressions
                         if s.matches(f.check, f.line)), "")
            suppressed.append((f, just))
        else:
            findings.append(f)
    return CheckResult(findings=findings, suppressed=suppressed,
                       files_scanned=len(files) + len(c_files),
                       passes_run=[p.id for p in instances])


def format_human(result: CheckResult) -> str:
    lines = []
    for f in result.findings:
        lines.append(f.format())
    counts = result.counts()
    summary = (
        f"pbst check: {len(result.findings)} finding(s) in "
        f"{result.files_scanned} file(s)"
        + (f" [{', '.join(f'{k}={v}' for k, v in sorted(counts.items()))}]"
           if counts else "")
        + (f"; {len(result.suppressed)} suppressed"
           if result.suppressed else "")
        + f" (passes: {', '.join(result.passes_run)})"
    )
    lines.append(summary)
    return "\n".join(lines)
