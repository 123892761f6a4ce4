"""Durability-discipline pass.

The write-ahead intent journal (gateway/journal.py,
docs/DURABILITY.md) only recovers what was journaled FIRST: a queue or
lease mutation that sneaks past the journal is state a crash silently
loses, and a recovery path that consumes journal frames without the
sealed read surface silently replays torn or corrupt bytes. Two rules:

- ``dur-unjournaled-mutation`` — inside gateway-machinery modules
  (files under a ``gateway/`` directory, minus the queue/journal/
  replay internals and the chaos harness), a durable-state mutation —
  ``queue.push`` / ``queue.requeue_front`` / ``queue.restore_tenant``,
  an ``inflight[...]`` assignment, or a bucket ``.credit(...)`` lease
  top-up — with NO journal intent earlier in the same function body
  (custody-transfer verbs like ``adopt`` journal inside the adopting
  gateway, so their queue ops are covered there). The ordering
  is positional by design: the intent emit (or the ``journal``-guard
  that wraps it) must textually precede the mutation it covers.
- ``dur-unsealed-read`` — a function that consumes journal bytes
  (mentions a journal-ish name or a ``.jrnl`` path) and unpacks raw
  records (``struct.unpack``/``unpack_from``/``np.frombuffer``)
  without going through the sealed read surface (``read_journal``) or
  validating CRCs itself (``zlib.crc32``). Torn-tail and corrupt-body
  handling live in exactly one place; a second bespoke parser WILL
  forget one of them.

The port of ``pbs_tpu.analysis.durabilitypass``; no departure.
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

#: Attribute-call mutation surface: method name -> receiver rule
#: ("queue" = base name must contain "queue"; None = any receiver).
_MUTATIONS: dict[str, str | None] = {
    "push": "queue",
    "requeue_front": "queue",
    "restore_tenant": "queue",
    "credit": None,
}

#: Modules under gateway/ that ARE the machinery the rules protect
#: (the queue implementation itself, the journal/replay pair, and the
#: chaos harness that deliberately plays adversary).
_EXEMPT_FILES = ("fairqueue.py", "journal.py", "recovery.py",
                 "chaos.py")

_UNPACKERS = {"unpack", "unpack_from", "frombuffer"}
_SEALED = ("read_journal", "crc32")


def _in_gateway_machinery(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    if "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_"):
        return False
    parts = norm.split("/")
    if "gateway" not in parts[:-1]:
        return False
    return parts[-1] not in _EXEMPT_FILES


def _is_test_path(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


class _FnScan(ast.NodeVisitor):
    """Per-function facts: first line mentioning a journal, mutation
    calls, raw unpack calls, journal-ish references, sealed-read
    calls. Nested defs are scanned as their own scopes by the outer
    walker, not here."""

    def __init__(self) -> None:
        self.journal_mention: int | None = None
        self.mutations: list[tuple[str, ast.Call]] = []
        self.unpacks: list[ast.Call] = []
        self.journal_ish = False
        self.sealed = False

    def _note_name(self, text: str, line: int) -> None:
        low = text.lower()
        if "journal" in low or low.endswith(".jrnl"):
            self.journal_ish = True
            if self.journal_mention is None or line < self.journal_mention:
                self.journal_mention = line

    def visit_FunctionDef(self, node):  # nested scopes scan separately
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Name(self, node: ast.Name) -> None:
        self._note_name(node.id, node.lineno)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._note_name(node.attr, node.lineno)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str):
            self._note_name(node.value, node.lineno)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._flag_inflight(tgt, node)
        self.generic_visit(node)

    def _flag_inflight(self, target: ast.AST, node: ast.AST) -> None:
        # self.inflight[rid] = req — the dispatch-side durable move.
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Attribute)
                and target.value.attr == "inflight"):
            fake = ast.Call(func=ast.Attribute(
                value=target.value.value, attr="inflight",
                ctx=ast.Load()), args=[], keywords=[])
            ast.copy_location(fake, node)
            self.mutations.append(("inflight[...] assignment", fake))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        qual = qualified_name(func) or ""
        leaf = qual.rsplit(".", 1)[-1]
        if isinstance(func, ast.Attribute):
            rule = _MUTATIONS.get(func.attr)
            if rule is not None or func.attr in _MUTATIONS:
                base = func.value
                base_name = ""
                if isinstance(base, ast.Attribute):
                    base_name = base.attr
                elif isinstance(base, ast.Name):
                    base_name = base.id
                receiver_ok = (rule is None
                               or rule in base_name.lower())
                # The journal's own emit helpers share verb names
                # (journal.adopt / journal.adopt_tenant ARE the
                # intents, not mutations).
                if receiver_ok and "journal" not in base_name.lower() \
                        and base_name not in ("jr", "j"):
                    self.mutations.append((f".{func.attr}(...)", node))
        if leaf in _UNPACKERS:
            self.unpacks.append(node)
        if any(s in qual for s in _SEALED):
            self.sealed = True
        self.generic_visit(node)


def _walk_functions(tree: ast.AST):
    """Yield every function/method node, outermost first."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class DurabilityPass(Pass):
    id = "durability-discipline"
    rules = ("dur-unjournaled-mutation", "dur-unsealed-read")
    description = ("write-ahead ordering in gateway machinery (queue/"
                   "lease mutations need a preceding journal intent in "
                   "the same function) and sealed journal reads "
                   "(frame consumers go through read_journal or "
                   "validate CRCs; torn/corrupt handling lives in one "
                   "place)")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test_path(src.rel_path):
            return []
        findings: list[Finding] = []
        machinery = _in_gateway_machinery(src.rel_path)
        is_journal_impl = src.rel_path.replace("\\", "/").endswith(
            "gateway/journal.py")
        for fn in _walk_functions(src.tree):
            scan = _FnScan()
            for stmt in fn.body:
                scan.visit(stmt)
            # The function's own name/args count toward "this is
            # journal-consuming code" (load_journal, path="x.jrnl") —
            # but NOT toward the write-ahead ordering line, which only
            # body statements can satisfy.
            names = [fn.name] + [a.arg for a in fn.args.args]
            if any("journal" in n.lower() or n.lower().endswith(".jrnl")
                   for n in names):
                scan.journal_ish = True
            if machinery:
                for label, node in scan.mutations:
                    if (scan.journal_mention is None
                            or node.lineno < scan.journal_mention):
                        findings.append(Finding(
                            "dur-unjournaled-mutation", src.rel_path,
                            node.lineno, node.col_offset,
                            f"durable gateway state moves ({label} in "
                            f"{fn.name}) with no preceding journal "
                            "intent in this function — a crash here "
                            "silently loses the transition",
                            hint="emit the matching GatewayJournal "
                                 "intent (admit/dispatch/complete/"
                                 "requeue/adopt/grant) BEFORE the "
                                 "mutation; see docs/DURABILITY.md"))
            if (scan.journal_ish and scan.unpacks and not scan.sealed
                    and not is_journal_impl):
                node = scan.unpacks[0]
                findings.append(Finding(
                    "dur-unsealed-read", src.rel_path,
                    node.lineno, node.col_offset,
                    f"{fn.name} parses journal bytes with a raw "
                    "unpack and never validates frames — torn tails "
                    "and CRC-corrupt bodies would replay silently",
                    hint="consume frames through gateway.journal."
                         "read_journal (the sealed read surface), or "
                         "verify zlib.crc32 per frame like it does"))
        return findings
