"""Serve-discipline pass: the partition rule table stays honest and
mesh-axis names stay in one place.

The serving tier (docs/SERVING.md) partitions parameters by an ordered
regex rule table (pbs_tpu_torch/serve/partition.py): first match wins, an
unmatched leaf is a hard error at construction. Two rot modes are
invisible at runtime and need a checker:

- ``serve-unmatched-rule``: a rule in a ``*_RULES`` table that is DEAD
  (matches none of the module's ``TEMPLATE_PATHS`` flagship paths) or
  SHADOWED (every path it matches was already claimed by an earlier
  rule), or a template path no rule covers. A dead rule is usually a
  typo'd regex that silently stopped placing a weight family; a
  shadowed rule means the table's ORDER no longer does what its
  author believed; an uncovered path is a construction-time crash
  waiting for the next model. The table and paths are extracted as
  AST literals, so the check runs with no jax anywhere in sight.
- ``serve-raw-mesh-axis``: a mesh-axis name string literal inside a
  ``PartitionSpec`` / ``P`` / ``NamedSharding`` / ``Mesh`` /
  ``make_mesh`` call outside ``pbs_tpu_torch/parallel/`` and
  ``pbs_tpu_torch/serve/partition.py``. Axis names are topology facts with
  exactly two homes: the parallel layer that defines layouts and the
  serve partition table that maps rules onto them POSITIONALLY. A
  raw ``"tp"`` anywhere else couples that module to one mesh shape
  and rots the moment the mesh is renamed or reshaped — route it
  through a ``parallel/sharding.py`` helper (the serving KV cache's
  ``slot_cache_kv_sharding`` is the template).

The port of ``pbs_tpu.analysis.servepass``. Departure: a file's place is
found by the path part ``pbs_tpu_torch`` (exactly that part, so a tree
that holds both packages anchors each file under its own) and module
prefixes ``pbs_tpu_torch.``; messages and hints name the port's modules.
"""

from __future__ import annotations

import ast
import re

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    Finding,
    Pass,
    SourceFile,
    qualified_name,
)

#: Call surfaces whose positional string literals are mesh-axis names.
_AXIS_CALLS = ("PartitionSpec", "P", "NamedSharding", "Mesh", "make_mesh")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test_path(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or \
        norm.rsplit("/", 1)[-1].startswith("test_")


def _axis_exempt(anchored: str) -> bool:
    """The two legitimate axis-name homes (module docstring)."""
    return anchored.startswith("parallel/") or \
        anchored == "serve/partition.py"


def _literal(node: ast.AST):
    """ast.literal_eval that swallows non-literals (dynamic tables are
    out of scope for a static table audit)."""
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


class _AxisScan(ast.NodeVisitor):
    """Flags string literals in positional args of the axis-call
    surfaces — recursing through tuple/list/dict containers (dict keys
    are ``make_mesh``'s axis names) but NOT into keyword arguments
    (``memory_kind=...`` and friends are not axis names)."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _scan(self, node: ast.AST, call: str) -> None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            self.findings.append(Finding(
                check="serve-raw-mesh-axis",
                path=self.src.rel_path,
                line=node.lineno, col=node.col_offset,
                message=f"raw mesh-axis name {node.value!r} in a "
                        f"{call}(...) call outside the parallel layer",
                hint="axis names live in pbs_tpu_torch/parallel/ (layout "
                     "helpers like slot_cache_kv_sharding) or the "
                     "positional rule table in serve/partition.py; "
                     "a literal here couples this module to one mesh "
                     "shape (docs/SERVING.md)",
            ))
            return
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                self._scan(e, call)
        elif isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self._scan(k, call)

    def visit_Call(self, node: ast.Call) -> None:
        qual = qualified_name(node.func)
        if qual is not None:
            leaf = qual.rsplit(".", 1)[-1]
            if leaf in _AXIS_CALLS:
                for arg in node.args:
                    self._scan(arg, leaf)
        self.generic_visit(node)


def _audit_table(rules, paths, line_of_rule, table_line,
                 rel_path: str) -> list[Finding]:
    """First-match-wins claim tracking, the static twin of
    ``pbs_tpu_torch.serve.partition.audit_rules`` (kept jax-free here on
    purpose — the runtime auditor imports the partition module, which
    imports jax)."""
    findings: list[Finding] = []
    compiled: list[tuple[int, "re.Pattern | None"]] = []
    for i, entry in enumerate(rules):
        pat = entry[0]
        try:
            compiled.append((i, re.compile(pat)))
        except re.error as e:
            findings.append(Finding(
                check="serve-unmatched-rule", path=rel_path,
                line=line_of_rule(i), col=0,
                message=f"partition rule {pat!r} does not compile: {e}",
                hint="every rule regex must compile; a broken rule "
                     "silently stops placing its weight family"))
            compiled.append((i, None))
    claimed: dict[str, int] = {}
    matched_any = [False] * len(rules)
    matched_fresh = [False] * len(rules)
    for path in paths:
        for i, rx in compiled:
            if rx is None or rx.search(path) is None:
                continue
            matched_any[i] = True
            if path not in claimed:
                claimed[path] = i
                matched_fresh[i] = True
    for i, entry in enumerate(rules):
        if compiled[i][1] is None:
            continue
        if not matched_any[i]:
            findings.append(Finding(
                check="serve-unmatched-rule", path=rel_path,
                line=line_of_rule(i), col=0,
                message=f"dead partition rule {entry[0]!r}: matches no "
                        "template path",
                hint="delete it or fix the regex — a dead rule is "
                     "usually a typo that stopped placing a weight "
                     "family (TEMPLATE_PATHS is the coverage "
                     "universe)"))
        elif not matched_fresh[i]:
            findings.append(Finding(
                check="serve-unmatched-rule", path=rel_path,
                line=line_of_rule(i), col=0,
                message=f"shadowed partition rule {entry[0]!r}: every "
                        "path it matches is claimed by an earlier rule",
                hint="first match wins — reorder the table or delete "
                     "the rule; a shadowed rule means the order no "
                     "longer does what it reads as doing"))
    uncovered = [p for p in paths if p not in claimed]
    if uncovered:
        findings.append(Finding(
            check="serve-unmatched-rule", path=rel_path,
            line=table_line, col=0,
            message="template path(s) no rule covers: "
                    + ", ".join(repr(p) for p in uncovered),
            hint="an uncovered non-scalar leaf is a hard error at "
                 "backend construction (match_partition_rules); add "
                 "a rule or drop the path"))
    return findings


class ServeDisciplinePass(Pass):
    id = "serve-discipline"
    rules = ("serve-unmatched-rule", "serve-raw-mesh-axis")
    description = ("the serving tier's partition rule table stays "
                   "honest (no dead/shadowed rules, no uncovered "
                   "template path) and mesh-axis name literals stay "
                   "inside parallel/ + serve/partition.py")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test_path(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        findings: list[Finding] = []
        if not _axis_exempt(anchored):
            scan = _AxisScan(src)
            scan.visit(src.tree)
            findings.extend(scan.findings)
        # Rule-table audit: any module declaring both a *_RULES literal
        # and a TEMPLATE_PATHS literal at top level opts in (the serve
        # partition module is the flagship; fixture twins mirror it).
        tables: list[tuple[ast.AST, object]] = []
        paths = None
        paths_line = 1
        for node in src.tree.body:
            targets = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id.endswith("_RULES"):
                    tables.append((value, _literal(value)))
                elif t.id == "TEMPLATE_PATHS":
                    paths = _literal(value)
                    paths_line = node.lineno
        if paths is None:
            return findings
        for value_node, rules in tables:
            if not isinstance(rules, (tuple, list)) or not all(
                    isinstance(e, (tuple, list)) and len(e) >= 1
                    and isinstance(e[0], str) for e in rules):
                continue
            elt_lines = [e.lineno for e in value_node.elts] \
                if isinstance(value_node, (ast.Tuple, ast.List)) else []

            def line_of_rule(i: int, _lines=elt_lines,
                             _fallback=value_node.lineno) -> int:
                return _lines[i] if i < len(_lines) else _fallback

            findings.extend(_audit_table(
                rules, tuple(paths), line_of_rule,
                paths_line, src.rel_path))
        return findings
