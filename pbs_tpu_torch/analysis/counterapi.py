"""Counter-API misuse pass.

Telemetry counters (``ExecutionContext.counters``) are monotonically
increasing totals folded in at quantum boundaries. The sanctioned ways
to consume them are:

- **deltas** against a window baseline: ``ctx.counters -
  ctx.prev_counters`` (what the feedback tick does), and
- **thresholds** through the :class:`telemetry.sampler.OverflowSampler`
  (arm/fire/rearm — the i-mode perfctr contract), which owns the
  window bookkeeping.

What breaks is a consumer *raw-reading* a counter and carrying that
raw value across a window boundary itself: totals survive job
migration/restore and sampler rearm resets the baseline, so ad-hoc
caching silently double-counts or goes negative. Two rules, scoped to
consumer code (the windowing machinery in ``telemetry/`` and ``obs/``
is exempt — it *implements* the contract):

- ``counter-raw-cache``: a raw ``.counters[...]`` read stored on
  ``self`` — a cross-call cache of an absolute counter value.
- ``counter-raw-threshold``: a comparison of a raw ``.counters[...]``
  read against a non-counter operand — an inline threshold check that
  should be an armed sampler sample.

A read that participates in the delta idiom (the same expression also
touches ``prev_counters``) is clean. Raw reads into *local* state
(formatting a dump row, summing a report) never cross a window
boundary and are not flagged.

The port of ``pbs_tpu.analysis.counterapi``; no departure.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile

#: Module path fragments that implement the windowing contract.
MACHINERY = ("/telemetry/", "/obs/")


def _is_machinery(rel_path: str) -> bool:
    p = "/" + rel_path.replace("\\", "/")
    return any(m in p for m in MACHINERY)


def _raw_counter_read(node: ast.AST) -> bool:
    """True when node is ``<x>.counters[...]`` (or bare
    ``counters[...]``)."""
    if not isinstance(node, ast.Subscript):
        return False
    v = node.value
    return (isinstance(v, ast.Attribute) and v.attr == "counters") or \
        (isinstance(v, ast.Name) and v.id == "counters")


def _contains_raw_read(node: ast.AST) -> bool:
    return any(_raw_counter_read(sub) for sub in ast.walk(node))


def _contains_prev(node: ast.AST) -> bool:
    # The delta idiom specifically: a prev_counters-style baseline in
    # the same expression. An arbitrary name merely containing "prev"
    # (preview, prevent_flag, ...) is NOT a window baseline.
    for sub in ast.walk(node):
        ident = sub.attr if isinstance(sub, ast.Attribute) else \
            sub.id if isinstance(sub, ast.Name) else ""
        if "prev" in ident and "counter" in ident:
            return True
    return False


class _CounterScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and _contains_raw_read(node.value) \
                    and not _contains_prev(node.value):
                self.findings.append(Finding(
                    "counter-raw-cache", self.src.rel_path, node.lineno,
                    node.col_offset,
                    f"raw counter read cached on self.{t.attr} — absolute "
                    "counter values must not cross a window boundary",
                    hint="consume deltas (counters - prev_counters) or arm "
                         "an OverflowSampler sample (telemetry/sampler.py)"))
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        operands = [node.left, *node.comparators]
        raws = [_contains_raw_read(o) and not _contains_prev(o)
                for o in operands]
        if any(raws) and not all(raws):
            # raw counter vs an unrelated operand = inline threshold.
            if not _contains_prev(node):
                self.findings.append(Finding(
                    "counter-raw-threshold", self.src.rel_path, node.lineno,
                    node.col_offset,
                    "threshold comparison against a raw counter read — "
                    "window bookkeeping belongs to the sampler",
                    hint="arm an OverflowSampler sample "
                         "(telemetry/sampler.py) and consume the "
                         "overflow event instead"))
        self.generic_visit(node)


class CounterApiPass(Pass):
    id = "counter-api"
    rules = ("counter-raw-cache", "counter-raw-threshold")
    description = ("telemetry counters consumed as deltas via the "
                   "sampler; raw reads must not cross window "
                   "boundaries in consumer code")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_machinery(src.rel_path):
            return []
        scan = _CounterScan(src)
        scan.visit(src.tree)
        return scan.findings
