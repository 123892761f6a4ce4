"""Rollout-discipline pass: production knob writes go through the
guarded rollout path.

The knob registry made every tunable declared and every push validated
(docs/KNOBS.md); the autopilot made production pushes GUARDED — a
candidate reaches the fleet only through the canary controller's
scoped-push → SLO-burn guard → promote/rollback protocol
(docs/AUTOPILOT.md). Both guarantees evaporate if any other module
writes knobs directly: a raw ``channel.push`` skips the canary scoping
and the guard window entirely, and a ``set_local`` silently forks a
process's view away from the channel every consumer watches. Two
rules:

- ``rollout-push``: a ``.push(...)`` call on a knob channel (an object
  constructed from ``KnobChannel.create``/``KnobChannel.attach`` in
  the same module, including ``self.x = KnobChannel...`` attributes
  and direct ``KnobChannel.create(p).push(...)`` chains) outside the
  sanctioned writers.
- ``rollout-set-local``: a call to the registry's ``set_local``
  (however imported: ``knobs.set_local``, ``registry.set_local``, or
  the bare name from either module) outside the sanctioned writers.

Sanctioned writers: ``knobs/`` (the machinery), ``autopilot/canary.py``
(THE production rollout path), ``cli/`` (the operator's explicit
hands, ``pbst knobs set``), ``analysis/`` (this checker's own
fixtures/tooling), and tests. The chaos harness's mid-run knob plan
keeps a justified line suppression — it is the adversary, not a
production writer (docs/ANALYSIS.md).

The port of ``pbs_tpu.analysis.rolloutpass``. Departure: a file's place
is found by the path part ``pbs_tpu_torch`` (exactly that part, so a
tree that holds both packages anchors each file under its own) and
module prefixes ``pbs_tpu_torch.``; messages and hints name the port's
modules.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    Finding,
    Pass,
    SourceFile,
    qualified_name,
)

#: Channel constructor classmethods whose result is a knob channel.
CHANNEL_CTORS = {"KnobChannel.create", "KnobChannel.attach"}

#: Modules of the registry whose ``set_local`` is the guarded surface.
SET_LOCAL_MODULES = ("pbs_tpu_torch.knobs", "pbs_tpu_torch.knobs.registry")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _exempt(rel_path: str) -> bool:
    anchored = _anchored(rel_path)
    if anchored.startswith(("knobs/", "cli/", "analysis/")) \
            or anchored == "autopilot/canary.py":
        return True
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _is_channel_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    qual = qualified_name(node.func)
    if qual is None:
        return False
    # Match on the trailing "KnobChannel.create" segments so aliased
    # module prefixes (pbs_tpu_torch.knobs.channel.KnobChannel.create, a
    # bare KnobChannel import, ...) all resolve.
    parts = qual.split(".")
    return len(parts) >= 2 and ".".join(parts[-2:]) in CHANNEL_CTORS


class _Taint(ast.NodeVisitor):
    """First sweep: names/attributes bound to knob-channel
    constructions, plus the module's set_local aliases."""

    def __init__(self) -> None:
        self.channels: set[str] = set()
        self.set_local_names: set[str] = set()
        self.knobs_modules: set[str] = set()

    def _record(self, value: ast.AST, targets: list[ast.AST]) -> None:
        if not _is_channel_ctor(value):
            return
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                self.channels.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                self.channels.add(tgt.attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._record(node.value, node.targets)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.value, [node.target])
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module in SET_LOCAL_MODULES:
            for alias in node.names:
                if alias.name == "set_local":
                    self.set_local_names.add(alias.asname or alias.name)
        if node.module == "pbs_tpu_torch":
            for alias in node.names:
                if alias.name == "knobs":
                    self.knobs_modules.add(alias.asname or "knobs")
        if node.module == "pbs_tpu_torch.knobs":
            for alias in node.names:
                if alias.name == "registry":
                    self.knobs_modules.add(alias.asname or "registry")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name in SET_LOCAL_MODULES:
                self.knobs_modules.add(alias.asname or alias.name)
        self.generic_visit(node)


class _RolloutScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile, taint: _Taint):
        self.src = src
        self.taint = taint
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "push":
            base = fn.value
            base_name = None
            if isinstance(base, ast.Name):
                base_name = base.id
            elif isinstance(base, ast.Attribute):
                base_name = base.attr
            tainted = (base_name in self.taint.channels
                       or _is_channel_ctor(base))
            if tainted:
                self.findings.append(Finding(
                    check="rollout-push",
                    path=self.src.rel_path,
                    line=node.lineno, col=node.col_offset,
                    message="knob channel push outside the guarded "
                            "rollout path",
                    hint="production knob writes go through the "
                         "canary controller (pbs_tpu_torch/autopilot/"
                         "canary.py) or the operator CLI — a raw "
                         "push skips canary scoping and the "
                         "SLO-burn guard (docs/AUTOPILOT.md)",
                ))
        qual = qualified_name(fn)
        if qual is not None:
            parts = qual.split(".")
            is_set_local = (
                qual in self.taint.set_local_names
                or (len(parts) >= 2 and parts[-1] == "set_local"
                    and (parts[-2] in ("knobs", "registry")
                         or ".".join(parts[:-1])
                         in self.taint.knobs_modules)))
            if is_set_local:
                self.findings.append(Finding(
                    check="rollout-set-local",
                    path=self.src.rel_path,
                    line=node.lineno, col=node.col_offset,
                    message="process-local knob override outside the "
                            "guarded rollout path",
                    hint="set_local forks this process's knob view "
                         "away from the channel every consumer "
                         "watches; push through the canary "
                         "controller or `pbst knobs set` instead "
                         "(docs/KNOBS.md, docs/AUTOPILOT.md)",
                ))
        self.generic_visit(node)


class RolloutDisciplinePass(Pass):
    id = "rollout-discipline"
    rules = ("rollout-push", "rollout-set-local")
    description = ("production knob writes go through the guarded "
                   "rollout path: channel.push / set_local calls "
                   "outside knobs/, autopilot/canary.py, the CLI, "
                   "and tests are findings — a raw push skips canary "
                   "scoping and the SLO-burn guard")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _exempt(src.rel_path):
            return []
        taint = _Taint()
        taint.visit(src.tree)
        scan = _RolloutScan(src, taint)
        scan.visit(src.tree)
        return scan.findings
