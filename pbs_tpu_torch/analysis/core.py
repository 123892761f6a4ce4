"""Static invariant checking framework (the ``pbst check`` core).

The sim regression harness gates policy *behavior* offline; this
subsystem gates policy *code* the same way: a repo-aware AST analysis
pass suite that enforces the invariants the runtime/sched/telemetry
layers already rely on implicitly — lock discipline (lockdep's static
twin), time-unit suffix consistency, scheduler-ops conformance, and
counter-API usage. The framework is deliberately small: passes visit
parsed files and emit :class:`Finding` records; the runner collects,
filters suppressions, and formats.

Suppression syntax (reviewed escapes, never silent):

- line:  ``# pbst: ignore[rule-id] -- justification``
- file:  ``# pbst: ignore-file[rule-id] -- justification``

A suppression **must** carry a justification after ``--`` or it is
itself reported (rule ``bad-suppression``). Rule ``*`` matches every
rule (use sparingly).

No dependency on jax/numpy: ``pbst check`` must run anywhere the repo
checks out, including CI images with no accelerator stack.

The port of ``pbs_tpu.analysis.core``. Departure: the C sources are
named ``runtime/csrc/*.cc`` in its comments (the reference's
C directory); the grammar and the code are the reference's.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Any

#: Time-unit suffixes the taxonomy uses (clock.py: ns is canonical).
UNIT_SUFFIXES = ("ns", "us", "ms")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit, anchored to file:line:col with a fix hint."""

    check: str  # rule id, e.g. "lock-raw"
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.check, self.message)

    def as_dict(self) -> dict[str, Any]:
        d = {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.hint:
            d["hint"] = self.hint
        return d

    def format(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: [{self.check}] {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


_SUPPRESS_RE = re.compile(
    r"#\s*pbst:\s*(ignore|ignore-file)\[([A-Za-z0-9_*,\s-]+)\]"
    r"(?:\s*--\s*(.*))?")

#: Same grammar behind a C ``//`` comment leader (runtime/csrc/*.cc sources).
_C_SUPPRESS_RE = re.compile(
    r"//\s*pbst:\s*(ignore|ignore-file)\[([A-Za-z0-9_*,\s-]+)\]"
    r"(?:\s*--\s*(.*))?")


@dataclasses.dataclass(frozen=True)
class Suppression:
    rules: tuple[str, ...]
    line: int  # comment line (line-level applies to this physical line)
    file_wide: bool
    justification: str

    def matches(self, rule: str, line: int) -> bool:
        if rule == "bad-suppression":
            return False  # the escape hatch cannot hide its own misuse
        if not any(r == "*" or r == rule for r in self.rules):
            return False
        return self.file_wide or line == self.line


def _classify_comment(regex: re.Pattern, comment: str, line: int,
                      rel_path: str, leader: str):
    """One comment string -> Suppression, bad-suppression Finding, or
    None (not a suppression comment at all). Shared by the Python and
    C scanners so both languages get the same grammar and the same
    justification-or-report contract."""
    m = regex.search(comment)
    if m is None:
        if "pbst:" in comment and "ignore" in comment:
            return Finding(
                "bad-suppression", rel_path, line, 0,
                f"unparseable suppression comment: {comment.strip()!r}",
                hint=f"syntax: {leader} pbst: ignore[rule-id] -- "
                     "justification")
        return None
    kind, rules_s, just = m.group(1), m.group(2), m.group(3)
    rules = tuple(r.strip() for r in rules_s.split(",") if r.strip())
    if not (just or "").strip():
        return Finding(
            "bad-suppression", rel_path, line, 0,
            "suppression without a justification",
            hint="append ' -- why this is safe' to the comment")
    return Suppression(
        rules=rules, line=line, file_wide=(kind == "ignore-file"),
        justification=just.strip())


class SourceFile:
    """One parsed source file: AST + per-line suppression table."""

    def __init__(self, path: str, text: str, rel_path: str | None = None):
        self.path = path
        #: Path as reported in findings (relative to the check root).
        self.rel_path = rel_path if rel_path is not None else path
        self.text = text
        self.tree: ast.AST | None = None
        self.parse_error: Finding | None = None
        self.suppressions: list[Suppression] = []
        self.bad_suppressions: list[Finding] = []
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_error = Finding(
                "parse-error", self.rel_path, e.lineno or 1, e.offset or 0,
                f"cannot parse: {e.msg}")
        self._scan_comments()

    def _scan_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            comments = [(t.start[0], t.string) for t in toks
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = [
                (i + 1, ln[ln.index("#"):])
                for i, ln in enumerate(self.text.splitlines()) if "#" in ln
            ]
        for line, comment in comments:
            got = _classify_comment(_SUPPRESS_RE, comment, line,
                                    self.rel_path, "#")
            if isinstance(got, Suppression):
                self.suppressions.append(got)
            elif isinstance(got, Finding):
                self.bad_suppressions.append(got)

    def suppressed(self, rule: str, line: int) -> bool:
        return any(s.matches(rule, line) for s in self.suppressions)


class CSourceFile:
    """One C/C++ source file (runtime/csrc/*.cc): raw text + the same
    per-line suppression table as :class:`SourceFile`, behind ``//``
    comment leaders. No AST — the memmodel passes run their own
    tokenizing scans over :attr:`code` (text with comments and string
    literals blanked, so protocol patterns never match prose).

    Duck-compatible with SourceFile where the runner cares:
    ``rel_path``/``suppressions``/``bad_suppressions``/``suppressed``.
    """

    is_c = True

    def __init__(self, path: str, text: str, rel_path: str | None = None):
        self.path = path
        self.rel_path = rel_path if rel_path is not None else path
        self.text = text
        self.suppressions: list[Suppression] = []
        self.bad_suppressions: list[Finding] = []
        self.code = self._blank_noncode(text)
        for i, ln in enumerate(self.code.splitlines()):
            # Comment start = the first // that survives string
            # blanking (a // inside a string literal is code).
            col = ln.find("//")
            if col < 0:
                continue
            got = _classify_comment(_C_SUPPRESS_RE, ln[col:], i + 1,
                                    self.rel_path, "//")
            if isinstance(got, Suppression):
                self.suppressions.append(got)
            elif isinstance(got, Finding):
                self.bad_suppressions.append(got)

    @staticmethod
    def _blank_noncode(text: str) -> str:
        """``text`` with double-quoted string literals and /* */
        comment bodies replaced by spaces (newlines kept, so offsets
        and line numbers survive). // comments are KEPT verbatim — the
        suppression scanner needs them — and stripped later by
        :meth:`code_lines`. Single quotes are left alone: this tree
        uses them as C++14 digit separators (0x70627374'6462ULL), not
        char literals, and a naive quote-matcher would blank real code
        between two separators."""
        out = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c == '"':
                out.append(c)
                i += 1
                while i < n and text[i] != '"':
                    if text[i] == "\\" and i + 1 < n:
                        out.append("  ")
                        i += 2
                        continue
                    out.append("\n" if text[i] == "\n" else " ")
                    i += 1
                if i < n:
                    out.append('"')
                    i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "*":
                out.append("  ")
                i += 2
                while i + 1 < n and not (text[i] == "*"
                                         and text[i + 1] == "/"):
                    out.append("\n" if text[i] == "\n" else " ")
                    i += 1
                if i + 1 < n:
                    out.append("  ")
                    i += 2
            elif c == "/" and i + 1 < n and text[i + 1] == "/":
                while i < n and text[i] != "\n":
                    out.append(text[i])
                    i += 1
            else:
                out.append(c)
                i += 1
        return "".join(out)

    def code_lines(self) -> list[str]:
        """Per-line code with // comments stripped too (1-based via
        index+1). The surface the memmodel token scans run over."""
        out = []
        for ln in self.code.splitlines():
            cut = ln.find("//")
            out.append(ln if cut < 0 else ln[:cut])
        return out

    def suppressed(self, rule: str, line: int) -> bool:
        return any(s.matches(rule, line) for s in self.suppressions)


class CheckContext:
    """Shared state for one ``pbst check`` run (all files + options)."""

    def __init__(self, files: list[SourceFile],
                 dynamic_lock_edges: set[tuple[str, str]] | None = None,
                 c_files: list[CSourceFile] | None = None):
        self.files = files
        #: C/C++ sources (runtime/csrc/*.cc) in the scan set — visited by
        #: passes that override :meth:`Pass.run_c` (the cross-language
        #: memmodel passes). Empty for pure-Python runs.
        self.c_files = c_files or []
        #: Dynamic lock-order graph edges (from ``pbst lockdep
        #: --dump-graph``) merged into the static cross-check.
        self.dynamic_lock_edges = dynamic_lock_edges or set()
        #: Scratch space for passes that accumulate across files.
        self.state: dict[str, Any] = {}


class Pass:
    """One checker. Subclasses set ``id``/``rules`` and override
    :meth:`run` (per file) and optionally :meth:`finalize` (after every
    file was visited — cross-file analyses report here)."""

    id: str = "abstract"
    #: Rule ids this pass can emit (drives --list-passes and docs).
    rules: tuple[str, ...] = ()
    description: str = ""

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        return []

    def run_c(self, csrc: CSourceFile, ctx: CheckContext) -> list[Finding]:
        """Per C source file (runtime/csrc/*.cc). Only the cross-language
        passes override this; pure-Python passes never see C files."""
        return []

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        return []


# -- shared AST helpers -----------------------------------------------------


def qualified_name(node: ast.AST) -> str | None:
    """Dotted name for Name/Attribute chains (``time.sleep`` ->
    "time.sleep"); None for anything dynamic."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = qualified_name(node.value)
        return f"{base}.{node.attr}" if base is not None else None
    return None


def identifier_of(node: ast.AST) -> str | None:
    """The trailing identifier a human would read a unit suffix off:
    ``job.params.tslice_us`` -> "tslice_us"; ``Counter.RUNQ_WAIT_NS``
    -> "RUNQ_WAIT_NS"; subscripts defer to the index when it carries a
    suffix (``snap[Counter.DEVICE_TIME_NS]``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        idx = node.slice
        ident = identifier_of(idx)
        if ident is not None and unit_of_identifier(ident) is not None:
            return ident
        return identifier_of(node.value)
    if isinstance(node, ast.UnaryOp):
        return identifier_of(node.operand)
    return None


def unit_of_identifier(ident: str) -> str | None:
    low = ident.lower()
    for suf in UNIT_SUFFIXES:
        if low.endswith("_" + suf):
            return suf
    return None


