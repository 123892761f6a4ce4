"""Lock-discipline pass: the static half of lockprof/lockdep.

Three rules over the hot-path packages (``runtime/``, ``store/``,
``dist/`` — where :class:`pbs_tpu_torch.obs.lockprof.ProfiledLock` is the
policy):

- ``lock-raw``: a raw ``threading.Lock()`` / ``threading.RLock()``
  in a hot-path module. Raw locks are invisible to lockprof contention
  stats and lockdep order validation; every framework lock must be a
  *named* ``ProfiledLock`` (or ``OrderedLock``) so the dynamic side
  can see it.
- ``lock-order``: nested ``with lock:`` acquisitions are extracted
  into a *static* lock-order graph (edge A->B = "B taken while A
  held", the same encoding ``obs.lockdep`` builds at runtime). A
  static edge that closes a cycle — against other static edges or
  against the dynamic graph exported by ``pbst lockdep --dump-graph``
  — is an AB-BA inversion reported at review time, before any thread
  ever interleaves.
- ``lock-blocking``: a blocking call (``time.sleep``, subprocess,
  socket connect, file ``open``, RPC ``.call``) inside a held-lock
  region. This is the lock-holder-preemption shape the paper's
  scheduler work exists to mitigate — holding a lock across a block
  turns every waiter into a convoy.

Static name resolution is deliberately simple: a lock is "known" when
it is assigned from a ``ProfiledLock("name")`` / ``OrderedLock("name")``
constructor to ``self.<attr>`` (class scope) or a module-level name.
``with`` items that don't resolve to a known lock are ignored — the
dynamic lockdep still covers them.

The port of ``pbs_tpu.analysis.locks``. Departure: a file's place is
found by the path part ``pbs_tpu_torch`` (exactly that part, so a tree
that holds both packages anchors each file under its own) and module
prefixes ``pbs_tpu_torch.``; messages and hints name the port's modules.
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

#: Packages where raw threading locks are banned (ProfiledLock policy).
HOT_PACKAGES = ("runtime", "store", "dist")

#: Constructors that produce a *named*, observability-visible lock.
NAMED_LOCK_TYPES = ("ProfiledLock", "OrderedLock")

#: Qualified call names that block the calling thread.
BLOCKING_CALLS = {
    "time.sleep": "time.sleep",
    "os.system": "subprocess spawn",
    "subprocess.run": "subprocess spawn",
    "subprocess.call": "subprocess spawn",
    "subprocess.check_call": "subprocess spawn",
    "subprocess.check_output": "subprocess spawn",
    "subprocess.Popen": "subprocess spawn",
    "socket.create_connection": "socket connect",
    "open": "file I/O",
}

#: Method names that are blocking RPC/service calls when invoked on
#: anything (the RpcClient surface is ``cli.call(...)``).
BLOCKING_METHODS = {"call": "RPC round-trip"}


def _hot_module(rel_path: str) -> bool:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return bool(parts) and parts[0] in HOT_PACKAGES


def _lock_ctor_name(node: ast.AST) -> str | None:
    """'name' when node is ProfiledLock("name")/OrderedLock("name")."""
    if not isinstance(node, ast.Call):
        return None
    callee = qualified_name(node.func)
    if callee is None or callee.split(".")[-1] not in NAMED_LOCK_TYPES:
        return None
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    for kw in node.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _is_raw_lock_ctor(node: ast.Call, raw_aliases: set[str]) -> bool:
    callee = qualified_name(node.func)
    return callee in ("threading.Lock", "threading.RLock") or \
        (callee in raw_aliases)


class _FileScan(ast.NodeVisitor):
    """Single-file scan: lock name table, with-nesting edges, raw
    ctors, blocking calls under held locks."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []
        # (scope, ident) -> lock class name; scope is the enclosing
        # class name for self-attrs, "" for module-level names.
        self.lock_names: dict[tuple[str, str], str] = {}
        # Static order edges: (outer, inner) -> (line, col).
        self.edges: dict[tuple[str, str], tuple[int, int]] = {}
        self._class_stack: list[str] = []
        self._held: list[str] = []  # named locks held at this point
        # Local names bound to threading.Lock/RLock via
        # `from threading import Lock [as L]`.
        self._raw_aliases: set[str] = set()

    # -- name table ------------------------------------------------------

    def _record_ctor(self, target: ast.AST, value: ast.AST) -> None:
        name = _lock_ctor_name(value)
        if name is None:
            return
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self" and self._class_stack:
            self.lock_names[(self._class_stack[-1], target.attr)] = name
        elif isinstance(target, ast.Name):
            self.lock_names[("", target.id)] = name

    def _resolve_lock(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and self._class_stack:
            return self.lock_names.get((self._class_stack[-1], expr.attr))
        if isinstance(expr, ast.Name):
            return self.lock_names.get(("", expr.id))
        return None

    # -- visitors --------------------------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "threading":
            for alias in node.names:
                if alias.name in ("Lock", "RLock"):
                    self._raw_aliases.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record_ctor(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_ctor(node.target, node.value)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if _is_raw_lock_ctor(node, self._raw_aliases) \
                and _hot_module(self.src.rel_path):
            self.findings.append(Finding(
                "lock-raw", self.src.rel_path, node.lineno, node.col_offset,
                "raw threading lock in a hot-path module is invisible to "
                "lockprof/lockdep",
                hint='use a named ProfiledLock("<class-name>") '
                     "(pbs_tpu_torch.obs.lockprof) so it participates in "
                     "contention stats and order validation"))
        if self._held:
            self._check_blocking(node)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            # The item expression evaluates while earlier items (and
            # any enclosing with) are already held — `with lock:` then
            # `with open(...)` is file I/O under the lock.
            self.visit(item.context_expr)
            name = self._resolve_lock(item.context_expr)
            if name is None:
                continue
            if self._held and self._held[-1] != name and name not in self._held:
                edge = (self._held[-1], name)
                self.edges.setdefault(
                    edge, (item.context_expr.lineno,
                           item.context_expr.col_offset))
            self._held.append(name)
            acquired.append(name)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    visit_AsyncWith = visit_With  # same acquisition semantics

    def _visit_deferred(self, node) -> None:
        # A function/lambda BODY defined under a with-lock runs when
        # called, not here — its calls are not "under the lock".
        saved, self._held = self._held, []
        self.generic_visit(node)
        self._held = saved

    visit_FunctionDef = _visit_deferred
    visit_AsyncFunctionDef = _visit_deferred
    visit_Lambda = _visit_deferred

    # -- blocking-in-lock ------------------------------------------------

    def _check_blocking(self, node: ast.Call) -> None:
        callee = qualified_name(node.func)
        kind = BLOCKING_CALLS.get(callee or "")
        if kind is None and isinstance(node.func, ast.Attribute) \
                and node.func.attr in BLOCKING_METHODS \
                and not isinstance(node.func.value, ast.Attribute):
            # Bare ``<obj>.call(...)`` — the RpcClient idiom. Attribute
            # chains (``self.timer.call``) are too ambiguous to flag.
            kind = BLOCKING_METHODS[node.func.attr]
        if kind is None:
            return
        self.findings.append(Finding(
            "lock-blocking", self.src.rel_path, node.lineno, node.col_offset,
            f"blocking call ({kind}: {callee or node.func.attr}) while "
            f"holding lock {self._held[-1]!r}",
            hint="move the blocking work outside the critical section; a "
                 "lock held across a block convoys every waiter "
                 "(lock-holder preemption)"))


def _has_path(edges: dict[str, set[str]], src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst (same search obs.lockdep runs at runtime)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in sorted(edges.get(node, ())):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class LockDisciplinePass(Pass):
    id = "lock-discipline"
    rules = ("lock-raw", "lock-order", "lock-blocking")
    description = ("raw locks in hot paths, static AB-BA order "
                   "inversions (cross-checked against the dynamic "
                   "lockdep graph), blocking calls under a held lock")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None:
            return []
        scan = _FileScan(src)
        scan.visit(src.tree)
        ctx.state.setdefault("static_lock_edges", {}).update({
            edge: (src.rel_path, pos) for edge, pos in scan.edges.items()
        })
        return scan.findings

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        static: dict[tuple[str, str], tuple[str, tuple[int, int]]] = \
            ctx.state.get("static_lock_edges", {})
        findings: list[Finding] = []
        # The established graph = dynamic + static edges, built once.
        # The edge under test may stay in: a->b leaves a, and the
        # inversion search (path b -> a) terminates on reaching a, so
        # the edge can never witness its own cycle.
        graph: dict[str, set[str]] = {}
        for (x, y) in list(ctx.dynamic_lock_edges) + list(static):
            graph.setdefault(x, set()).add(y)
        for edge in sorted(static):
            a, b = edge
            cycle = _has_path(graph, b, a)
            if cycle is None:
                continue
            path, (line, col) = static[edge]
            findings.append(Finding(
                "lock-order", path, line, col,
                f"taking {b!r} while holding {a!r} inverts the "
                f"established lock order {' -> '.join(cycle)} "
                "(AB-BA deadlock possible)",
                hint="acquire these locks in one global order; see "
                     "obs/lockdep.py and docs/ANALYSIS.md"))
        return findings
