"""Time-unit consistency pass.

The repo's convention (utils/clock.py): all times are integer
nanoseconds; names carry their unit as a suffix — ``RUNQ_WAIT_NS``,
``CSCHED_DEFAULT_TSLICE_US``, ``acct_period_us``, ``timeout_ms`` — and
conversions go through the named constants ``US``/``MS``/``SEC`` (or an
explicit numeric factor). A ``_ns`` value added to a ``_us`` value with
no conversion in sight is a silent 1000x bug; this pass catches it at
review time.

Rule ``unit-mix`` fires when two operands whose *names* carry different
unit suffixes meet in an add/subtract, a comparison (including
``min``/``max`` arguments), an assignment, or a keyword argument —
**unless** the mixing expression contains an explicit conversion (a
multiply/divide by ``US``/``MS``/``SEC``/``NS_PER_*`` or a numeric
literal), which marks the conversion as deliberate.

The checker infers units, it does not track them through data flow: a
converted value stored under the right suffix (``ran_us = ran_ns / US``)
is clean by construction, which is exactly the convention the codebase
already follows.

The port of ``pbs_tpu.analysis.units``; no departure.
"""

from __future__ import annotations

import ast
import re

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    Finding,
    Pass,
    SourceFile,
    identifier_of,
    unit_of_identifier,
)

#: Names whose presence in a multiply/divide marks an explicit
#: conversion (utils/clock.py constants + the *_PER_* idiom).
_CONVERSION_NAME = re.compile(
    r"^(NS|US|MS|SEC|SECS?|HZ)$|_PER_|^(NSEC|USEC|MSEC)S?$")


def _is_conversion_factor(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value not in (0,)  # *1 is still a declared factor
    ident = identifier_of(node)
    if ident is not None and _CONVERSION_NAME.search(ident):
        return True
    if isinstance(node, ast.BinOp):
        return _is_conversion_factor(node.left) or \
            _is_conversion_factor(node.right)
    return False


def unit_of_expr(node: ast.AST) -> str | None:
    """Best-effort unit of an expression; None = unknown/converted."""
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, (ast.Mult, ast.Div, ast.FloorDiv, ast.Mod)):
            # A multiply/divide is where conversions happen; once a
            # factor is involved the result's unit is declared by
            # whatever name it lands in, not inferred here.
            if _is_conversion_factor(node.left) or \
                    _is_conversion_factor(node.right):
                return None
            return unit_of_expr(node.left) or unit_of_expr(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            return unit_of_expr(node.left) or unit_of_expr(node.right)
        return None
    if isinstance(node, ast.UnaryOp):
        return unit_of_expr(node.operand)
    if isinstance(node, ast.Constant):
        return None
    if isinstance(node, ast.Call):
        # int(x_ns), float(x_ns), np.uint64(x_ns): unit-preserving casts.
        fn = node.func
        cast = (isinstance(fn, ast.Name) and fn.id in ("int", "float", "abs")) \
            or (isinstance(fn, ast.Attribute)
                and fn.attr in ("uint64", "int64", "float64"))
        if cast and len(node.args) == 1:
            return unit_of_expr(node.args[0])
        return None
    ident = identifier_of(node)
    if ident is None:
        return None
    return unit_of_identifier(ident)


def _contains_conversion(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp) and \
                isinstance(sub.op, (ast.Mult, ast.Div, ast.FloorDiv)):
            if _is_conversion_factor(sub.left) or \
                    _is_conversion_factor(sub.right):
                return True
    return False


class _UnitScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, a: str, b: str, what: str) -> None:
        self.findings.append(Finding(
            "unit-mix", self.src.rel_path, node.lineno, node.col_offset,
            f"{what} mixes time units: {a} vs {b} with no explicit "
            "conversion",
            hint="convert through utils.clock constants (US/MS/SEC) or "
                 "rename so the suffix matches the actual unit"))

    def _check_pair(self, node: ast.AST, left: ast.AST, right: ast.AST,
                    what: str) -> None:
        ua, ub = unit_of_expr(left), unit_of_expr(right)
        if ua is not None and ub is not None and ua != ub:
            if not (_contains_conversion(left) or _contains_conversion(right)):
                self._flag(node, ua, ub, what)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_pair(node, node.left, node.right, "arithmetic")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        prev = node.left
        for cmp in node.comparators:
            self._check_pair(node, prev, cmp, "comparison")
            prev = cmp
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # min()/max() compare their arguments.
        if isinstance(node.func, ast.Name) and node.func.id in ("min", "max") \
                and len(node.args) >= 2:
            for other in node.args[1:]:
                self._check_pair(node, node.args[0], other,
                                 f"{node.func.id}() argument")
        # Keyword arguments: f(period_ns=x_us) is an interface-crossing
        # unit bug the callee can never catch.
        for kw in node.keywords:
            if kw.arg is None:
                continue
            want = unit_of_identifier(kw.arg)
            got = unit_of_expr(kw.value)
            if want is not None and got is not None and want != got \
                    and not _contains_conversion(kw.value):
                self._flag(kw.value, got, f"{kw.arg}= ({want})",
                           "keyword argument")
        self.generic_visit(node)

    def _check_assign(self, node: ast.AST, target: ast.AST,
                      value: ast.AST) -> None:
        ident = identifier_of(target)
        if ident is None:
            return
        want = unit_of_identifier(ident)
        got = unit_of_expr(value)
        if want is not None and got is not None and want != got \
                and not _contains_conversion(value):
            self._flag(node, got, f"{ident} ({want})", "assignment")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_assign(node, t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_assign(node, node.target, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            self._check_assign(node, node.target, node.value)
        self.generic_visit(node)


class TimeUnitPass(Pass):
    id = "time-units"
    rules = ("unit-mix",)
    description = ("_NS/_US/_MS suffix consistency: arithmetic, "
                   "comparisons, assignments, and keyword args mixing "
                   "units without an explicit conversion")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None:
            return []
        scan = _UnitScan(src)
        scan.visit(src.tree)
        return scan.findings
