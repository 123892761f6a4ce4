"""Lightweight C/C++ source scanning for the memmodel passes.

Deliberately NOT a C parser: the passes need exactly four shapes out
of ``runtime/csrc/*.cc`` — function bodies, integer constants (``static
const``/``constexpr``/enums), ``extern "C"`` prototypes with arities,
and token positions inside a body — and the repo's C style (clang
-format'd, no macros-defining-functions, no templates in signatures)
makes a tokenizing scan exact for them. Anything the scanner cannot
resolve it SKIPS (returns nothing) rather than guesses; the honest-
about-limits rule of docs/ANALYSIS.md applies here with force, since
a false "drift" finding against working C would teach people to
suppress the pass.

All scans run over :attr:`CSourceFile.code` with ``//`` comments
stripped (:func:`nocomment_text`), so prose like "// 38 words" never
matches a layout literal.

The port of ``pbs_tpu.analysis.memmodel.ctokens``. Departure: the C
sources are named ``runtime/csrc/*.cc`` in its text.
"""

from __future__ import annotations

import ast
import bisect
import dataclasses
import re

from pbs_tpu_torch.analysis.core import CSourceFile

#: Control keywords that look like ``name (...) {`` but aren't
#: function definitions.
_NOT_FUNCS = frozenset({
    "if", "for", "while", "switch", "catch", "do", "else", "return",
    "sizeof",
})

_FUNC_RE = re.compile(
    r"([A-Za-z_]\w*)\s*\(([^;{}()]*(?:\([^()]*\)[^()]*)*)\)\s*(?:const\s*)?\{")

_CONST_RE = re.compile(
    r"(?:static\s+)?(?:const|constexpr)\s+"
    r"(?:unsigned\s+|signed\s+)?(?:u?int\d*_t|int|long|size_t)\s+"
    r"([A-Za-z_]\w*)\s*=\s*([^;]+);")

_ENUM_RE = re.compile(r"\benum\b[^{;]*\{([^}]*)\}", re.S)


def nocomment_text(csrc: CSourceFile) -> str:
    """The file's code with strings blanked AND // comments stripped,
    newline structure preserved (offsets map to lines)."""
    return "\n".join(csrc.code_lines())


def line_of(text: str, pos: int) -> int:
    """1-based line number of character offset ``pos`` in ``text``."""
    starts = _line_starts(text)
    return bisect.bisect_right(starts, pos)


def _line_starts(text: str) -> list[int]:
    starts = [0]
    for i, ch in enumerate(text):
        if ch == "\n":
            starts.append(i + 1)
    return starts


@dataclasses.dataclass
class CFunc:
    name: str
    params: str
    line: int          # header line (1-based)
    body_start: int    # offset of the opening { in the scan text
    body_end: int      # offset just past the closing }
    body: str          # body text between the braces


def _match_brace(text: str, open_pos: int) -> int:
    """Offset just past the } matching the { at ``open_pos``, or -1."""
    depth = 0
    for i in range(open_pos, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return -1


def param_count(params: str) -> int:
    """Arity of a C parameter list (top-level comma split; ``void``
    and empty count 0)."""
    p = params.strip()
    if not p or p == "void":
        return 0
    depth = 0
    n = 1
    for c in p:
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == "," and depth == 0:
            n += 1
    return n


def functions(text: str) -> list[CFunc]:
    """Every function (or method) definition in ``text`` (the
    no-comment scan text). Bodies nested inside other bodies (lambdas
    don't exist here) are not re-reported: matches that fall inside a
    previously-matched body are skipped, so ``if (...) {`` inside a
    function never shadows it."""
    out: list[CFunc] = []
    covered_until = -1
    for m in _FUNC_RE.finditer(text):
        if m.start() < covered_until:
            continue
        name = m.group(1)
        if name in _NOT_FUNCS:
            continue
        open_pos = m.end() - 1
        end = _match_brace(text, open_pos)
        if end < 0:
            continue
        # `struct X {`-style matches can't occur (no parens); but an
        # initializer like `= {` preceded by a call match can't reach
        # here because the regex requires `)` immediately before `{`.
        out.append(CFunc(
            name=name, params=m.group(2), line=line_of(text, m.start()),
            body_start=open_pos, body_end=end,
            body=text[open_pos + 1:end - 1]))
        covered_until = end
    return out


def eval_int_expr(expr: str, env: dict[str, int]) -> int | None:
    """Integer value of a C constant expression, or None. Handles the
    repo's idioms: decimal/hex literals with ' digit separators and
    U/L suffixes, +-*/ arithmetic, parens, references to earlier
    constants (via ``env``), and unary minus. Python's own expression
    grammar covers all of that once suffixes are stripped."""
    s = expr.strip().replace("'", "")
    s = re.sub(r"\b(0[xX][0-9a-fA-F]+|\d+)[uUlL]{0,3}\b", r"\1", s)
    # C casts like (int64_t)x would confuse ast.parse; the repo's
    # layout constants don't use them — bail if present.
    try:
        node = ast.parse(s, mode="eval")
    except SyntaxError:
        return None
    return _eval_node(node.body, env)


def _eval_node(node: ast.AST, env: dict[str, int]) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp):
        v = _eval_node(node.operand, env)
        if v is None:
            return None
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
        return None
    if isinstance(node, ast.BinOp):
        a = _eval_node(node.left, env)
        b = _eval_node(node.right, env)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Add):
            return a + b
        if isinstance(node.op, ast.Sub):
            return a - b
        if isinstance(node.op, ast.Mult):
            return a * b
        if isinstance(node.op, ast.FloorDiv):
            return a // b if b else None
        if isinstance(node.op, ast.Div):
            return a // b if b and a % b == 0 else None
        if isinstance(node.op, ast.LShift):
            return a << b
        if isinstance(node.op, ast.BitOr):
            return a | b
        return None
    return None


def constants(text: str) -> tuple[dict[str, int], dict[str, int],
                                  set[int]]:
    """(env, def_lines, excluded_lines) for ``text``: every integer
    constant the file declares (static const / constexpr / enum
    members), the line each was declared on, and the full set of lines
    occupied by those declarations (the magic-literal rule must not
    flag a constant's own initializer)."""
    env: dict[str, int] = {}
    def_lines: dict[str, int] = {}
    excluded: set[int] = set()
    for m in _CONST_RE.finditer(text):
        name, expr = m.group(1), m.group(2)
        ln = line_of(text, m.start())
        excluded.update(range(ln, line_of(text, m.end()) + 1))
        val = eval_int_expr(expr, env)
        if val is not None:
            env[name] = val
            def_lines[name] = ln
    for m in _ENUM_RE.finditer(text):
        first = line_of(text, m.start())
        last = line_of(text, m.end())
        excluded.update(range(first, last + 1))
        nxt = 0
        for item in m.group(1).split(","):
            item = item.strip()
            if not item:
                continue
            if "=" in item:
                name, expr = item.split("=", 1)
                name = name.strip()
                val = eval_int_expr(expr, env)
                if val is None:
                    # Unresolvable member poisons the auto-increment
                    # chain that follows; stop rather than guess.
                    break
                nxt = val
            else:
                name, val = item, nxt
            if re.fullmatch(r"[A-Za-z_]\w*", name):
                env[name] = val
                def_lines[name] = first
                nxt = val + 1
    return env, def_lines, excluded


#: A store through an indexed lvalue: ``base[i] = / += / ...``. The
#: (?!=) guard keeps ``==`` comparisons out; ``!=``/``<=``/``>=``
#: never match because their first char isn't an assignment op.
STORE_RE = re.compile(
    r"\b([A-Za-z_]\w*)\s*\[[^\]]+\]\s*(?:[+\-|&^]|<<|>>)?=(?!=)")

#: memcpy/memset destination base variable (first identifier of the
#: first argument).
MEM_DST_RE = re.compile(
    r"\b(?:std::)?mem(?:cpy|set)\s*\(\s*&?\s*([A-Za-z_]\w*)")

ATOMIC_STORE_RE = re.compile(
    r"__atomic_store_n\s*\(\s*&\s*([A-Za-z_]\w*)\s*\[([^\]]+)\]\s*,"
    r"[^;]*?(__ATOMIC_\w+)\s*\)")

ATOMIC_LOAD_RE = re.compile(
    r"(?:\b([A-Za-z_]\w*)\s*=\s*)?__atomic_load_n\s*\(\s*&\s*"
    r"(?:\(([^()]*)\))?\s*([A-Za-z_]\w*)\s*[\[)]?[^,]*,\s*(__ATOMIC_\w+)")

FENCE_RE = re.compile(r"__atomic_thread_fence\s*\(\s*(__ATOMIC_\w+)\s*\)")


def plain_stores(body: str) -> list[tuple[int, str]]:
    """(offset-in-body, base-var) for every plain (non-atomic) store:
    indexed assignments and memcpy/memset destinations."""
    out = [(m.start(), m.group(1)) for m in STORE_RE.finditer(body)]
    out += [(m.start(), m.group(1)) for m in MEM_DST_RE.finditer(body)]
    return sorted(out)


def loops(body: str) -> list[tuple[int, str]]:
    """(offset, loop-body-text) for every for/while loop directly or
    transitively inside ``body`` — each loop's FULL body, so nested
    retry shapes are still seen as one loop."""
    out = []
    for m in re.finditer(r"\b(?:for|while)\s*\(", body):
        # Find the { after the closing paren of the loop head.
        close = _match_paren(body, m.end() - 1)
        if close < 0:
            continue
        rest = body[close:]
        bm = re.match(r"\s*\{", rest)
        if not bm:
            continue
        open_pos = close + bm.end() - 1
        end = _match_brace(body, open_pos)
        if end < 0:
            continue
        out.append((m.start(), body[open_pos + 1:end - 1]))
    return out


def _match_paren(text: str, open_pos: int) -> int:
    depth = 0
    for i in range(open_pos, len(text)):
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    return -1
