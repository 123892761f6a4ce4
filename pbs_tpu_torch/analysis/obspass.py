"""Obs-discipline pass.

The span layer (``pbs_tpu_torch.obs.spans``; docs/TRACING.md) makes three
promises the rest of the tree can quietly break:

- **every span closes** — a begin-style span emit (``span.begin()`` /
  ``spans.start()``) that can exit the function on a control-flow path
  with no terminal emit leaves an unclosed span: the chain validator
  reports a gap at chaos time, but the bug belongs at review time.
  Scoped to gateway/federation code, where request custody moves.
  Rule ``obs-unclosed-span``.
- **span emits stay batched** — a scalar ring ``.emit(...)`` of a
  ``SPAN_*`` event inside a loop pays the per-event ring cost the
  :class:`~pbs_tpu_torch.obs.spans.SpanRecorder` exists to amortize (its
  methods stage through an EmitBatch). Rule ``obs-span-emit-in-loop``
  (the span twin of perf-discipline's ``perf-emit-in-loop``).
- **no histogram-bucket scans in hot paths** — quantiles over the
  log2 histograms are one ``cumsum`` + ``searchsorted``
  (:func:`~pbs_tpu_torch.obs.spans.hist_quantile`); a ``for`` loop striding
  ``HIST_BUCKETS`` in producer code re-introduces the per-element
  Python cost the vectorized helper removed. Rule ``obs-hist-scan``.

The port of ``pbs_tpu.analysis.obspass``. Departure: a file's place is
found by the path part ``pbs_tpu_torch`` (exactly that part, so a tree
that holds both packages anchors each file under its own) and module
prefixes ``pbs_tpu_torch.``; messages and hints name the port's modules.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile

#: Modules that IMPLEMENT the span/histogram layout — the scans and
#: scalar emits live there by design.
OBS_MACHINERY = ("obs/spans.py", "obs/trace.py", "perf/")

#: Where the unclosed-span rule applies: the code that moves request
#: custody around (and therefore opens/closes spans on branchy paths).
SPAN_SCOPE = ("gateway/",)

#: Begin-style / terminal-style method names on a span-ish receiver.
SPAN_BEGIN = ("begin", "start", "open")
SPAN_END = ("end", "close", "finish", "complete", "shed")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _receiver_ident(func: ast.Attribute) -> str:
    base = func.value
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _span_call(node: ast.Call, names: tuple[str, ...]) -> bool:
    func = node.func
    return (isinstance(func, ast.Attribute) and func.attr in names
            and "span" in _receiver_ident(func).lower())


def _mentions_span_event(node: ast.Call) -> bool:
    for arg in node.args:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Attribute) and \
                    sub.attr.startswith("SPAN_"):
                return True
            if isinstance(sub, ast.Name) and sub.id.startswith("SPAN_"):
                return True
    return False


def _mentions_hist_buckets(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "HIST_BUCKETS":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "HIST_BUCKETS":
            return True
    return False


class _ObsScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile, span_scope: bool,
                 emit_scope: bool):
        self.src = src
        self.span_scope = span_scope
        self.emit_scope = emit_scope
        self.findings: list[Finding] = []
        self._loop_depth = 0

    # -- unclosed spans (per function, control-flow aware) ---------------

    def _visit_func(self, node) -> None:
        if self.span_scope:
            begins: list[ast.Call] = []
            ends: list[ast.Call] = []
            returns: list[ast.stmt] = []
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    if _span_call(sub, SPAN_BEGIN):
                        begins.append(sub)
                    elif _span_call(sub, SPAN_END):
                        ends.append(sub)
                elif isinstance(sub, (ast.Return, ast.Raise)):
                    returns.append(sub)
                elif sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    pass  # nested defs still walked; good enough
            if begins and not ends:
                b = begins[0]
                self.findings.append(Finding(
                    "obs-unclosed-span", self.src.rel_path, b.lineno,
                    b.col_offset,
                    "span begun here but no terminal span emit exists "
                    "in this function — every control-flow path must "
                    "close the span or the chain validator reports a "
                    "gap at chaos time",
                    hint="emit the terminal (complete/shed/end) on "
                         "every exit path, or route the lifecycle "
                         "through SpanRecorder's paired emit points "
                         "(obs/spans.py, docs/TRACING.md)"))
            elif begins and ends:
                first_begin = min(b.lineno for b in begins)
                for r in returns:
                    if r.lineno > first_begin and not any(
                            e.lineno <= r.lineno for e in ends):
                        self.findings.append(Finding(
                            "obs-unclosed-span", self.src.rel_path,
                            r.lineno, r.col_offset,
                            "early exit between span begin and its "
                            "terminal emit — this path leaves the "
                            "span unclosed",
                            hint="close the span before returning/"
                                 "raising, or restructure so the "
                                 "terminal emit dominates every exit "
                                 "(docs/TRACING.md)"))
        self.generic_visit(node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- scalar SPAN_* emits in loops ------------------------------------

    def _visit_loop(self, node) -> None:
        if self.emit_scope and isinstance(node, ast.For) and \
                _mentions_hist_buckets(node.iter):
            self.findings.append(Finding(
                "obs-hist-scan", self.src.rel_path, node.lineno,
                node.col_offset,
                "per-bucket Python scan over HIST_BUCKETS in a hot "
                "path — quantiles over the log2 histograms are one "
                "vectorized pass",
                hint="use hist_quantile / LatencyHistograms."
                     "class_quantile (obs/spans.py): cumsum + "
                     "searchsorted, no Python loop"))
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (self.emit_scope and self._loop_depth > 0
                and isinstance(func, ast.Attribute)
                and func.attr in ("emit", "trace_emit")
                and "batch" not in _receiver_ident(func).lower()
                and _mentions_span_event(node)):
            self.findings.append(Finding(
                "obs-span-emit-in-loop", self.src.rel_path, node.lineno,
                node.col_offset,
                "scalar ring emit of a SPAN_* event inside a loop — "
                "span producers must stage through the recorder's "
                "EmitBatch (one vectorized ring write per watermark)",
                hint="emit through SpanRecorder (its methods stage "
                     "via EmitBatch), or build records and call "
                     "emit_many once (obs/spans.py)"))
        self.generic_visit(node)


class ObsDisciplinePass(Pass):
    id = "obs-discipline"
    rules = ("obs-unclosed-span", "obs-span-emit-in-loop",
             "obs-hist-scan")
    description = ("span/histogram discipline (docs/TRACING.md): spans "
                   "close on every control-flow path in gateway code, "
                   "SPAN_* emits stay on the EmitBatch staging path, "
                   "and no per-bucket HIST_BUCKETS scans outside the "
                   "vectorized helpers")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        if any(anchored == m or anchored.startswith(m)
               for m in OBS_MACHINERY):
            return []
        span_scope = any(anchored.startswith(p) for p in SPAN_SCOPE)
        scan = _ObsScan(src, span_scope, True)
        scan.visit(src.tree)
        return scan.findings
