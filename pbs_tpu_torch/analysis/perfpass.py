"""Perf-discipline pass.

The trace/telemetry hot path is vectorized (``docs/PERF.md``):
records move through ``TraceBuffer.emit_many``/``consume`` in bulk
slice copies, and bursty producers stage events through
``obs.trace.EmitBatch``. What regresses is code quietly reintroducing
the per-record idioms the rewrite removed — a Python loop striding a
``TRACE_REC_WORDS``-word buffer one record at a time, or a hot loop
paying a scalar ring emit per event. Two rules:

- ``perf-rec-loop``: a ``for`` loop whose body does
  ``TRACE_REC_WORDS``-strided record arithmetic — the
  one-record-per-iteration copy the vectorized ring APIs replaced.
  Scoped to the whole tree minus the machinery that *implements* the
  record layout (``obs/trace.py``) and the harness that measures it
  (``perf/``).
- ``perf-emit-in-loop``: a scalar ``.emit(...)``/``.trace_emit(...)``
  call inside a ``for``/``while`` body in the heavy-producer packages
  (``sim/``, ``gateway/``, ``telemetry/``). Staged emits are
  sanctioned and recognized by naming convention: a receiver whose
  trailing identifier contains ``batch`` (``self._trace_batch.emit``,
  ``ring_batch.emit``) is an ``EmitBatch``, which exists precisely to
  be called per event.
- ``perf-dispatch-alloc``: per-dispatch Python-object allocation in a
  simulator dispatch edge — a ``.append(...)`` call or a
  dict/list/set display (or comprehension) inside a ``do_schedule`` /
  ``wake`` / ``sleep`` / ``descheduled`` body under ``sim/``. The
  probe rewrite (``sim/engine.py``) moved accumulation onto
  preallocated grow-by-doubling numpy arrays precisely because a list
  append per dispatched quantum was the sweep bottleneck; this rule
  keeps it out. The list-based reference probe carries justified
  line suppressions — it exists to witness equivalence, not to sweep.
- ``perf-native-unchecked``: a call site consuming a
  ``native_mod.load()`` / ``native_mod.fastcall()`` result without
  handling the None branch. The native runtime is OPTIONAL by
  contract (no toolchain → pure-Python fallback); code that does
  ``native_mod.load().pbst_x(...)``, or stashes the result and never
  None-checks it, crashes exactly on the hosts the fallback exists
  for. Guards are recognized as: the result name (or ``self``
  attribute) appearing in an ``if``/``while``/ternary/``assert``
  test, or in an ``is None`` / ``is not None`` compare — in the
  enclosing function for locals, anywhere in the class for
  attributes. Scoped to the whole tree minus ``runtime/native.py``
  (the loader itself).
- ``perf-native-sim-unguarded``: sim/sweep code invoking the native
  sim dispatch core (``run_native``/``sim_run``) without a
  degradation branch. The C core is optional exactly like the rest of
  the native runtime, AND configuration-gated (policies, executors,
  probes it doesn't model): every consumer must route through
  ``native_core.unsupported_reason`` / ``available_tier`` and keep
  the pure-Python witness engine as the fallback, or a toolchain-less
  host (or an unsupported sweep cell) crashes instead of degrading.
  Recognized guards: a name assigned from one of the guard calls
  appearing in a conditional/None compare, or a guard call directly
  inside an ``if``/``while``/ternary/``assert`` test — in the
  enclosing function (module scope for top-level code). Scoped to
  ``sim/`` minus ``sim/native_core.py`` (the marshaller owns its own
  availability checks).

The port of ``pbs_tpu.analysis.perfpass``. Departure: a file's place is
found by the path part ``pbs_tpu_torch`` (exactly that part, so a tree
that holds both packages anchors each file under its own) and module
prefixes ``pbs_tpu_torch.``; messages and hints name the port's modules.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile

#: Modules that implement the record layout / measure it — the strided
#: arithmetic lives there by design.
REC_MACHINERY = ("obs/trace.py", "perf/")

#: Packages whose event producers are hot enough to batch.
HOT_PACKAGES = ("sim/", "gateway/", "telemetry/")

#: Scalar per-event emitters the batching APIs replace in hot loops.
EMITTERS = ("emit", "trace_emit")

#: The optional-runtime loaders whose results can be None.
NATIVE_LOADERS = ("load", "fastcall")

#: Scheduler-probe dispatch edges: the per-quantum hot methods the
#: numpy-accumulator rewrite de-allocated (sim/engine.py).
DISPATCH_EDGES = ("do_schedule", "wake", "sleep", "descheduled")

#: Packages whose dispatch edges the allocation rule covers.
DISPATCH_PACKAGES = ("sim/",)

#: The loader implementation itself (its internal load() calls are the
#: machinery the rule protects callers of).
NATIVE_MACHINERY = ("runtime/native.py",)

#: Native sim-core consumers that must sit behind a degradation branch.
NATIVE_SIM_CONSUMERS = ("run_native", "sim_run")

#: The calls whose (None-checked) result constitutes that branch.
NATIVE_SIM_GUARDS = ("unsupported_reason", "supported", "available_tier")

#: Packages the sim-core rule covers...
NATIVE_SIM_PACKAGES = ("sim/",)

#: ...minus the marshaller that implements the core's entry points.
NATIVE_SIM_MACHINERY = ("sim/native_core.py",)


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _receiver_ident(func: ast.Attribute) -> str:
    """Trailing identifier of the emit receiver: ``self._trace_batch``
    -> "_trace_batch", ``ring`` -> "ring"."""
    base = func.value
    if isinstance(base, ast.Attribute):
        return base.attr
    if isinstance(base, ast.Name):
        return base.id
    return ""


def _mentions_rec_words(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id == "TRACE_REC_WORDS"
               for sub in ast.walk(node))


class _DispatchAllocScan(ast.NodeVisitor):
    """perf-dispatch-alloc: allocation idioms inside a sim dispatch
    edge's body (nested defs get their own scan, so a helper defined
    inside an edge is not double-counted)."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name in DISPATCH_EDGES:
            for stmt in node.body:
                self._scan_body(stmt)
        # Recurse either way: a nested def (edge or not) gets its own
        # visit — _scan_body below excludes nested-def subtrees from
        # the ENCLOSING edge's scan.
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "perf-dispatch-alloc", self.src.rel_path, node.lineno,
            node.col_offset,
            f"{what} inside a scheduler dispatch edge — one Python "
            "object allocation per dispatched quantum is the "
            "accumulation pattern the numpy probe rewrite removed",
            hint="accumulate on preallocated grow-by-doubling arrays "
                 "(index store + count bump; see sim/engine.py "
                 "SchedulerProbe/_TenantAcc) and defer container "
                 "building to the metrics accessors"))

    def _scan_body(self, stmt: ast.stmt) -> None:
        # Manual stack walk: ast.walk would descend INTO nested defs,
        # attributing a helper's one-time allocations to the edge —
        # here a nested def's whole subtree is pruned (it gets its own
        # visit_FunctionDef pass instead).
        stack = [stmt]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "append":
                self._flag(sub, "list .append() per dispatch")
            elif isinstance(sub, (ast.Dict, ast.DictComp)):
                self._flag(sub, "dict literal/comprehension")
            elif isinstance(sub, (ast.List, ast.ListComp,
                                  ast.Set, ast.SetComp)):
                self._flag(sub, "list/set literal/comprehension")
            stack.extend(ast.iter_child_nodes(sub))


class _PerfScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile, rec_scope: bool, emit_scope: bool):
        self.src = src
        self.rec_scope = rec_scope
        self.emit_scope = emit_scope
        self.findings: list[Finding] = []
        self._loop_depth = 0

    def _visit_loop(self, node: ast.For | ast.While) -> None:
        if self.rec_scope and isinstance(node, ast.For) and any(
                _mentions_rec_words(stmt) for stmt in node.body):
            self.findings.append(Finding(
                "perf-rec-loop", self.src.rel_path, node.lineno,
                node.col_offset,
                "per-record loop over a TRACE_REC_WORDS-strided buffer — "
                "one slice copy per record is the scalar path the "
                "vectorized ring APIs replaced",
                hint="move records in bulk: TraceBuffer.emit_many / "
                     "consume / peek copy the wrapped span in at most "
                     "two contiguous slices (obs/trace.py)"))
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (self.emit_scope and self._loop_depth > 0
                and isinstance(func, ast.Attribute)
                and func.attr in EMITTERS
                and "batch" not in _receiver_ident(func).lower()):
            self.findings.append(Finding(
                "perf-emit-in-loop", self.src.rel_path, node.lineno,
                node.col_offset,
                f"scalar .{func.attr}() inside a loop in a hot producer "
                "package — every event pays the full ring-emit cost",
                hint="stage through an EmitBatch (one vectorized "
                     "emit_many per watermark) or build the records and "
                     "call emit_many once (obs/trace.py)"))
        self.generic_visit(node)


def _is_native_loader(node: ast.Call) -> bool:
    func = node.func
    return (isinstance(func, ast.Attribute)
            and func.attr in NATIVE_LOADERS
            and "native" in _receiver_ident(func).lower())


def _none_guard_idents(scope: ast.AST) -> set[str]:
    """Identifiers (plain names and attribute names) that appear in a
    conditional test or an ``is [not] None`` compare inside ``scope``
    — the shapes a None-branch handler takes."""
    guarded: set[str] = set()

    def _collect(expr: ast.AST) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name):
                guarded.add(sub.id)
            elif isinstance(sub, ast.Attribute):
                guarded.add(sub.attr)

    for sub in ast.walk(scope):
        if isinstance(sub, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            _collect(sub.test)
        elif isinstance(sub, ast.Compare):
            if any(isinstance(c, ast.Constant) and c.value is None
                   for c in [sub.left, *sub.comparators]):
                _collect(sub)
    return guarded


class _NativeScan:
    """perf-native-unchecked: loader results consumed without a None
    branch. Locals are checked against their enclosing function,
    ``self.X`` stashes against their whole class (the stash-in-init,
    branch-at-use idiom of TraceBuffer/Ledger)."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "perf-native-unchecked", self.src.rel_path, node.lineno,
            node.col_offset,
            f"{what} — native_mod.load()/fastcall() return None when "
            "the runtime is unavailable (no toolchain, failed build), "
            "and this site would crash exactly on the hosts the "
            "pure-Python fallback exists for",
            hint="branch on the result (`if lib is not None: ...`) "
                 "and keep the Python path as the fallback "
                 "(runtime/native.py, docs/PERF.md)"))

    def scan(self, tree: ast.AST) -> None:
        # Direct uses: an attribute ridden straight off the call.
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Call) and \
                    _is_native_loader(node.value):
                self._flag(node, "attribute access directly on a "
                                 "native loader result")
        # Stashed results: name assigns per function, self-attribute
        # assigns per class.
        for scope in ast.walk(tree):
            if isinstance(scope, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                self._scan_function(scope)
            elif isinstance(scope, ast.ClassDef):
                self._scan_class(scope)

    def _loader_assigns(self, scope: ast.AST):
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call) and \
                    _is_native_loader(sub.value) and \
                    len(sub.targets) == 1:
                yield sub, sub.targets[0]

    def _scan_function(self, fn) -> None:
        guarded = None  # computed lazily: most functions have none
        for assign, target in self._loader_assigns(fn):
            if not isinstance(target, ast.Name):
                continue  # self.X handled at class level
            if guarded is None:
                guarded = _none_guard_idents(fn)
            if target.id not in guarded:
                self._flag(assign, f"native loader result bound to "
                                   f"{target.id!r} with no None "
                                   "branch in this function")

    def _scan_class(self, cls) -> None:
        guarded = None
        for assign, target in self._loader_assigns(cls):
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            if guarded is None:
                guarded = _none_guard_idents(cls)
            if target.attr not in guarded:
                self._flag(assign, f"native loader result stashed on "
                                   f"self.{target.attr} with no None "
                                   "branch anywhere in this class")


def _call_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _NativeSimScan:
    """perf-native-sim-unguarded: native sim-core invocations whose
    enclosing scope has no degradation branch (see module docstring)."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            "perf-native-sim-unguarded", self.src.rel_path, node.lineno,
            node.col_offset,
            f"{what} with no degradation branch in scope — the native "
            "sim core is optional (toolchain) AND configuration-gated "
            "(policies/executors/probes it doesn't model); this site "
            "crashes exactly where the Python witness engine should "
            "take over",
            hint="gate on native_core.unsupported_reason(...) (None = "
                 "supported) or available_tier() and fall back to the "
                 "pure-Python engine path (sim/engine.py _run_native, "
                 "docs/SIM.md 'Native dispatch core')"))

    @staticmethod
    def _scope_nodes(scope: ast.AST):
        """The scope's own statements, nested def subtrees pruned
        (each def is judged against its own body)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield sub
            stack.extend(ast.iter_child_nodes(sub))

    def _scope_guarded(self, scope: ast.AST) -> bool:
        guard_names: set[str] = set()
        for sub in self._scope_nodes(scope):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call) and \
                    _call_name(sub.value.func) in NATIVE_SIM_GUARDS and \
                    len(sub.targets) == 1 and \
                    isinstance(sub.targets[0], ast.Name):
                guard_names.add(sub.targets[0].id)
            elif isinstance(sub, (ast.If, ast.While, ast.IfExp,
                                  ast.Assert)):
                # A guard call used directly in the test counts too.
                for c in ast.walk(sub.test):
                    if isinstance(c, ast.Call) and \
                            _call_name(c.func) in NATIVE_SIM_GUARDS:
                        return True
        if not guard_names:
            return False
        return bool(guard_names & _none_guard_idents(scope))

    def _scan_scope(self, scope: ast.AST) -> None:
        guarded = None  # lazy: most scopes consume nothing
        for sub in self._scope_nodes(scope):
            if isinstance(sub, ast.Call) and \
                    _call_name(sub.func) in NATIVE_SIM_CONSUMERS:
                if guarded is None:
                    guarded = self._scope_guarded(scope)
                if not guarded:
                    self._flag(sub, f"native sim-core call "
                                    f".{_call_name(sub.func)}(...)")

    def scan(self, tree: ast.AST) -> None:
        # Module top-level is a scope of its own; each def is scanned
        # against its own body (a guard in the caller doesn't sanction
        # an unguarded helper).
        self._scan_scope(tree)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_scope(node)


class PerfDisciplinePass(Pass):
    id = "perf-discipline"
    rules = ("perf-rec-loop", "perf-emit-in-loop",
             "perf-dispatch-alloc", "perf-native-unchecked",
             "perf-native-sim-unguarded")
    description = ("trace/telemetry hot paths stay vectorized and "
                   "native-optional: no per-record TRACE_REC_WORDS "
                   "loops, no scalar ring emits inside loops in "
                   "sim/gateway/telemetry (EmitBatch/emit_many are "
                   "the sanctioned forms), no per-dispatch container "
                   "allocation in sim dispatch edges (numpy "
                   "accumulators are the sanctioned form), and every "
                   "native loader result handles the None/unavailable "
                   "branch")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        rec_scope = not any(
            anchored == m or anchored.startswith(m) for m in REC_MACHINERY)
        emit_scope = any(anchored.startswith(p) for p in HOT_PACKAGES)
        native_scope = anchored not in NATIVE_MACHINERY
        findings: list[Finding] = []
        if rec_scope or emit_scope:
            scan = _PerfScan(src, rec_scope, emit_scope)
            scan.visit(src.tree)
            findings.extend(scan.findings)
        if any(anchored.startswith(p) for p in DISPATCH_PACKAGES):
            dscan = _DispatchAllocScan(src)
            dscan.visit(src.tree)
            findings.extend(dscan.findings)
        if native_scope:
            nat = _NativeScan(src)
            nat.scan(src.tree)
            findings.extend(nat.findings)
        if any(anchored.startswith(p) for p in NATIVE_SIM_PACKAGES) \
                and anchored not in NATIVE_SIM_MACHINERY:
            sim = _NativeSimScan(src)
            sim.scan(src.tree)
            findings.extend(sim.findings)
        return findings
