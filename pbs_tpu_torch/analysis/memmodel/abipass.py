"""ABI layout drift checker across the Python/C boundary.

knob-native-drift checks ONE table (the feedback marshalling words);
this pass generalizes the idea to the whole shared-memory ABI: every
slot word count, header magic and field offset that exists on both
sides of the boundary is extracted from BOTH sources and diffed, the
ctypes binding arity is cross-checked against the C prototypes, and
hardcoded layout literals are flagged — so a word added on one side
is a finding at check time, not a torn read in production. Seven
rules:

- ``abi-const-drift``: a contract pair (C constant expression vs
  Python mirror constant) with different values, including the
  auto-matched sim-core enum names shared between
  ``runtime/csrc/pbst_runtime.cc`` and ``sim/native_core.py``.
- ``abi-missing-const``: a contract pair declared on one side only.
- ``abi-magic-literal``: a bare integer literal (>= 16) in a ``.cc``
  file equal to a named layout constant — ``38`` instead of
  ``kSlotWords`` keeps compiling after the layout changes.
- ``abi-binding-arity``: a ``lib.X.argtypes`` list in
  ``runtime/native.py`` whose length differs from the C prototype's
  parameter count — ctypes would silently marshal garbage.
- ``abi-unknown-symbol``: the binding layer names a ``pbst_*`` symbol
  no scanned C source defines (stale binding or typo; at runtime this
  is an AttributeError only on the declaring path).
- ``abi-unbound-export``: a C ``pbst_*`` export no scanned Python
  source references — dead ABI surface, or a binding someone forgot.
- ``abi-fastcall-table``: the METH_FASTCALL method table must map
  every entry to an ``fc_<name>`` handler, and the required-symbol
  tuple in ``runtime/native.py`` must be a subset of the table (a
  stale table makes ``fastcall()`` raise and silently drop the tier).

Python constants are resolved across modules (``from pbs_tpu_torch.x
import NAME``) with a bounded fixpoint; anything unresolvable is
skipped, never guessed. Cross-language rules only arm when both
sides are in the scan set, so ``--changed`` runs on a .py-only diff
stay cheap and a .cc diff pulls the declared anchor modules in
(runner ``changed_check_files``).

The port of ``pbs_tpu.analysis.memmodel.abipass``. Departure: a file's
place is found by the path part ``pbs_tpu_torch`` (exactly that part, so
a tree that holds both packages anchors each file under its own) and
module prefixes ``pbs_tpu_torch.``; messages and hints name the port's
modules. The C side is named ``runtime/csrc/`` in messages and hints.
"""

from __future__ import annotations

import ast
import re

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    CSourceFile,
    Finding,
    Pass,
    SourceFile,
)
from pbs_tpu_torch.analysis.memmodel import ctokens

#: The explicit cross-language constant contract:
#: (C expression, anchored Python module, Python name). The C side is
#: evaluated against the union constant environment of every scanned
#: .cc file (pbst_fastcall.cc #includes pbst_runtime.cc, so constants
#: span files).
CONTRACT = (
    ("kNumCounters", "telemetry/counters.py", "NUM_COUNTERS"),
    ("kHeaderWords", "telemetry/ledger.py", "HEADER_WORDS"),
    ("kSlotWords", "telemetry/ledger.py", "SLOT_WORDS"),
    ("kSlotWords * 8", "telemetry/ledger.py", "SLOT_BYTES"),
    ("kHeaderWords", "telemetry/ledger.py", "_SUMS"),
    ("kHeaderWords + kNumCounters", "telemetry/ledger.py", "_START"),
    ("kTraceHeaderWords", "obs/trace.py", "TRACE_HEADER_WORDS"),
    ("kTraceRecWords", "obs/trace.py", "TRACE_REC_WORDS"),
    ("kDoorbellHeaderWords", "runtime/doorbell.py", "HEADER_WORDS"),
    ("kDoorbellMagic", "runtime/doorbell.py", "_MAGIC"),
    ("C_STEPS", "sim/native_core.py", "_C_STEPS"),
    ("C_DEV", "sim/native_core.py", "_C_DEV"),
    ("C_HBM", "sim/native_core.py", "_C_HBM"),
    ("C_STALL", "sim/native_core.py", "_C_STALL"),
    ("C_COLL", "sim/native_core.py", "_C_COLL"),
    ("C_FLOPS", "sim/native_core.py", "_C_FLOPS"),
    ("C_TOKENS", "sim/native_core.py", "_C_TOKENS"),
    ("C_SCHED_COUNT", "sim/native_core.py", "_C_SCHED"),
    ("C_NUM", "sim/native_core.py", "_NUM_COUNTERS"),
)

#: The module whose SAME-NAMED constants are auto-diffed against the C
#: environment (GS_*/J_*/JF_*/GF_*/*_WORDS/TK_*/POL_*/SIM_ABI_VERSION
#: — the sim-core layout mirrors, declared "keep in lockstep" in both
#: files). Names on one side only are fine here (each side has private
#: helpers); value disagreement on a shared name is drift.
AUTO_MIRROR = "sim/native_core.py"

#: The ctypes/fastcall binding module (anchored).
BINDING_MOD = "runtime/native.py"

#: Bare-literal threshold: small structural numbers (0/1/2/8...) are
#: everywhere legitimately; layout constants the rule cares about
#: (word counts, arities, magics) are >= 16 in this tree.
MAGIC_MIN = 16

_INT_LIT_RE = re.compile(
    r"(?<![\w.])(0[xX][0-9a-fA-F']+|\d[\d']*)[uUlL]{0,3}(?![\w.])")


def _is_layout_name(name: str) -> bool:
    """Constants the magic-literal rule guards: layout/arity/magic
    names (kFoo, *_WORDS, C_NUM, *ABI*, *MAGIC*). Field-index enum
    members (GS_MIN_US, J_ENQ_TS, ...) are excluded — a loop bound or
    buffer index that merely equals one of those is not layout math."""
    upper = name.upper()
    return ((name[:1] == "k" and name[1:2].isupper())
            or name.endswith("_WORDS")
            or "ABI" in upper or "MAGIC" in upper
            or name == "C_NUM")

_ARGTYPES_SYM_RE = re.compile(r"^pbst_\w+$")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


# -- Python constant environments -------------------------------------------


def _py_assigns(tree: ast.AST):
    """Module-level (name, value-node, line) triples plus range-tuple
    unpacks, and the from-import alias map."""
    assigns: list[tuple[str, ast.AST, int]] = []
    ranges: list[tuple[list[str], ast.AST, int]] = []
    imports: dict[str, tuple[str, str]] = {}
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("pbs_tpu_torch.") and node.level == 0:
            below = node.module.removeprefix("pbs_tpu_torch.")
            mod_path = below.replace(".", "/") + ".py"
            for alias in node.names:
                imports[alias.asname or alias.name] = (mod_path,
                                                       alias.name)
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            assigns.append((target.id, node.value, node.lineno))
        elif isinstance(target, ast.Tuple) and \
                all(isinstance(e, ast.Name) for e in target.elts):
            names = [e.id for e in target.elts]
            if isinstance(node.value, ast.Call) and \
                    isinstance(node.value.func, ast.Name) and \
                    node.value.func.id == "range" and \
                    len(node.value.args) == 1:
                ranges.append((names, node.value.args[0], node.lineno))
            elif isinstance(node.value, ast.Tuple) and \
                    len(node.value.elts) == len(names):
                for nm, val in zip(names, node.value.elts):
                    assigns.append((nm, val, node.lineno))
    return assigns, ranges, imports


def _py_int(node: ast.AST, lookup) -> int | None:
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or \
                not isinstance(node.value, int):
            return None
        return node.value
    if isinstance(node, ast.Name):
        return lookup(node.id)
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _py_int(node.operand, lookup)
        if v is None:
            return None
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.BinOp):
        a = _py_int(node.left, lookup)
        b = _py_int(node.right, lookup)
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
        if isinstance(node.op, ast.LShift):
            return a << b
        if isinstance(node.op, ast.BitOr):
            return a | b
    return None


def _resolve_envs(modules: dict):
    """Fixpoint constant resolution across the scanned modules.
    ``modules``: anchored path -> (assigns, ranges, imports). Returns
    anchored path -> {name: (value, line)}."""
    envs: dict[str, dict[str, tuple[int, int]]] = {
        mod: {} for mod in modules}
    for _ in range(4):  # import chains in this tree are depth <= 2
        changed = False
        for mod, (assigns, ranges, imports) in modules.items():
            env = envs[mod]

            def lookup(name, _env=env, _imports=imports):
                if name in _env:
                    return _env[name][0]
                imp = _imports.get(name)
                if imp is not None and imp[0] in envs:
                    got = envs[imp[0]].get(imp[1])
                    return got[0] if got else None
                return None

            for name, value, line in assigns:
                if name in env:
                    continue
                v = _py_int(value, lookup)
                if v is not None:
                    env[name] = (v, line)
                    changed = True
            for names, arg, line in ranges:
                if names[0] in env:
                    continue
                n = _py_int(arg, lookup)
                if n is not None and n == len(names):
                    for i, nm in enumerate(names):
                        env[nm] = (i, line)
                    changed = True
        if not changed:
            break
    return envs


# -- binding-layer extraction -----------------------------------------------


def _argtypes_len(node: ast.AST) -> int | None:
    """Statically-known length of an argtypes expression: a list, a
    concatenation of lists, or ``list * int``."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return len(node.elts)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            a = _argtypes_len(node.left)
            b = _argtypes_len(node.right)
            return None if a is None or b is None else a + b
        if isinstance(node.op, ast.Mult):
            for seq, k in ((node.left, node.right),
                           (node.right, node.left)):
                n = _argtypes_len(seq)
                if n is not None and isinstance(k, ast.Constant) and \
                        isinstance(k.value, int):
                    return n * k.value
    return None


def _binding_decls(tree: ast.AST):
    """From runtime/native.py: ``lib.NAME.argtypes = [...]`` arities,
    every ``lib.NAME`` attribute touched, every pbst_* string literal,
    and the required-fastcall-symbol tuple (the For that iterates a
    tuple of identifier strings and ``hasattr``-probes each one — the
    restype loops in _declare() iterate symbol tuples too, but only
    the fastcall gate probes with hasattr)."""
    arities: list[tuple[str, int | None, int]] = []
    symbols: list[tuple[str, int]] = []
    required: list[tuple[str, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and t.attr == "argtypes" \
                    and isinstance(t.value, ast.Attribute) and \
                    isinstance(t.value.value, ast.Name) and \
                    t.value.value.id == "lib":
                arities.append((t.value.attr, _argtypes_len(node.value),
                                node.lineno))
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "lib" and \
                node.attr.startswith("pbst_"):
            symbols.append((node.attr, node.lineno))
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                _ARGTYPES_SYM_RE.match(node.value):
            symbols.append((node.value, node.lineno))
        if isinstance(node, ast.For) and \
                isinstance(node.iter, ast.Tuple) and node.iter.elts and \
                all(isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                    and e.value.isidentifier()
                    for e in node.iter.elts) and \
                any(isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Name)
                    and inner.func.id == "hasattr"
                    for stmt in node.body
                    for inner in ast.walk(stmt)):
            for e in node.iter.elts:
                required.append((e.value, node.lineno))
    return arities, symbols, required


_FC_TABLE_RE = re.compile(r'\{\s*"(\w+)"\s*,\s*\(PyCFunction\)')


class AbiLayoutDriftPass(Pass):
    id = "abi-layout-drift"
    rules = ("abi-const-drift", "abi-missing-const", "abi-magic-literal",
             "abi-binding-arity", "abi-unknown-symbol",
             "abi-unbound-export", "abi-fastcall-table")
    description = (
        "the shared-memory ABI agrees across the language boundary: "
        "slot word counts, header magics and field offsets extracted "
        "from runtime/csrc/*.cc match their declared Python mirrors "
        "(telemetry/obs/runtime/sim anchor modules), ctypes argtypes "
        "arity matches the C prototypes, the fastcall method table is "
        "complete, no C export is left unbound, and no .cc file "
        "hardcodes a layout constant as a bare literal")

    # -- collection ------------------------------------------------------

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        state = ctx.state.setdefault("abi", {
            "py_modules": {}, "py_srcs": {}, "binding": None,
            "py_texts": [],
        })
        state["py_texts"].append(src.text)
        contract_mods = {c[1] for c in CONTRACT} | {AUTO_MIRROR}
        if anchored in contract_mods:
            state["py_modules"][anchored] = _py_assigns(src.tree)
            state["py_srcs"][anchored] = src
        if anchored == BINDING_MOD:
            state["binding"] = (src, _binding_decls(src.tree))
        return []

    # -- cross-language diff ---------------------------------------------

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        if not ctx.c_files:
            return []
        state = ctx.state.get("abi") or {
            "py_modules": {}, "py_srcs": {}, "binding": None,
            "py_texts": [],
        }
        out: list[Finding] = []

        # Union C constant environment + per-file definition lines.
        c_env: dict[str, int] = {}
        c_lines: dict[str, tuple[str, int]] = {}
        per_file: list[tuple[CSourceFile, str, set[int]]] = []
        for csrc in ctx.c_files:
            text = ctokens.nocomment_text(csrc)
            env, def_lines, excluded = ctokens.constants(text)
            for name, val in env.items():
                c_env.setdefault(name, val)
                c_lines.setdefault(name,
                                   (csrc.rel_path, def_lines[name]))
            per_file.append((csrc, text, excluded))

        envs = _resolve_envs(state["py_modules"])
        out.extend(self._contract(state, c_env, c_lines, envs))
        out.extend(self._auto_mirror(state, c_env, c_lines, envs))
        out.extend(self._magic_literals(per_file, c_env))
        out.extend(self._bindings(state, ctx))
        out.extend(self._fastcall_table(state, ctx))
        return out

    def _contract(self, state, c_env, c_lines, envs) -> list[Finding]:
        out = []
        for c_expr, mod, py_name in CONTRACT:
            if mod not in state["py_modules"]:
                continue  # mirror not in scan set: nothing to diff
            src = state["py_srcs"][mod]
            c_val = ctokens.eval_int_expr(c_expr, c_env)
            py = envs.get(mod, {}).get(py_name)
            c_names = re.findall(r"[A-Za-z_]\w+", c_expr)
            anchor = next((c_lines[n] for n in c_names if n in c_lines),
                          None)
            if c_val is None and py is not None:
                out.append(Finding(
                    "abi-missing-const", src.rel_path, py[1], 0,
                    f"{py_name} mirrors C expression {c_expr!r} but "
                    "no scanned .cc file declares it — the layouts "
                    "can no longer be diffed",
                    hint="declare the constant in runtime/csrc/*.cc (or "
                         "update the contract table in "
                         "analysis/memmodel/abipass.py)"))
            elif c_val is not None and py is None:
                line = anchor[1] if anchor else 1
                path = anchor[0] if anchor else src.rel_path
                out.append(Finding(
                    "abi-missing-const", path, line, 0,
                    f"C layout constant {c_expr!r} (= {c_val}) has no "
                    f"Python mirror {py_name} in {mod} — one side of "
                    "the ABI is unchecked",
                    hint=f"declare {py_name} in {mod} (or update the "
                         "contract table)"))
            elif c_val is not None and py is not None and \
                    c_val != py[0]:
                out.append(Finding(
                    "abi-const-drift", src.rel_path, py[1], 0,
                    f"{mod}:{py_name} = {py[0]} but the C side says "
                    f"{c_expr} = {c_val} "
                    f"({anchor[0]}:{anchor[1] if anchor else '?'}) — "
                    "every reader of the shared buffer tears on this "
                    "disagreement",
                    hint="change BOTH sides together; the layout "
                         "tables are declared lockstep mirrors"))
        return out

    def _auto_mirror(self, state, c_env, c_lines, envs) -> list[Finding]:
        out = []
        if AUTO_MIRROR not in state["py_modules"]:
            return out
        src = state["py_srcs"][AUTO_MIRROR]
        env = envs.get(AUTO_MIRROR, {})
        for name in sorted(set(env) & set(c_env)):
            py_val, line = env[name]
            if py_val != c_env[name]:
                cpath, cline = c_lines[name]
                out.append(Finding(
                    "abi-const-drift", src.rel_path, line, 0,
                    f"sim-core layout word {name}: Python says "
                    f"{py_val}, C says {c_env[name]} "
                    f"({cpath}:{cline}) — the marshalled state block "
                    "and the C core disagree on where this word lives",
                    hint="the two enums are declared lockstep mirrors "
                         "(sim/native_core.py <-> "
                         "runtime/csrc/pbst_runtime.cc); change both"))
        return out

    def _magic_literals(self, per_file, c_env) -> list[Finding]:
        out = []
        by_val: dict[int, list[str]] = {}
        for name, val in c_env.items():
            if val >= MAGIC_MIN and _is_layout_name(name):
                by_val.setdefault(val, []).append(name)
        if not by_val:
            return out
        for csrc, text, excluded in per_file:
            for i, ln in enumerate(csrc.code_lines()):
                line_no = i + 1
                if line_no in excluded:
                    continue
                for m in _INT_LIT_RE.finditer(ln):
                    lit = m.group(1).replace("'", "")
                    val = int(lit, 16) if lit[:2].lower() == "0x" \
                        else int(lit)
                    names = by_val.get(val)
                    if not names:
                        continue
                    out.append(Finding(
                        "abi-magic-literal", csrc.rel_path, line_no,
                        m.start(),
                        f"bare literal {m.group(1)} duplicates layout "
                        f"constant {' / '.join(sorted(names))} — it "
                        "keeps compiling after the layout changes and "
                        "the buffer math silently shears",
                        hint=f"spell it {sorted(names)[0]}"))
        return out

    def _bindings(self, state, ctx) -> list[Finding]:
        out = []
        if state["binding"] is None:
            return out
        src, (arities, symbols, required) = state["binding"]
        protos: dict[str, tuple[int, str, int]] = {}
        for csrc in ctx.c_files:
            text = ctokens.nocomment_text(csrc)
            for fn in ctokens.functions(text):
                if fn.name.startswith("pbst_"):
                    protos.setdefault(
                        fn.name, (ctokens.param_count(fn.params),
                                  csrc.rel_path, fn.line))
        for name, arity, line in arities:
            proto = protos.get(name)
            if proto is None:
                continue  # abi-unknown-symbol covers it below
            if arity is not None and arity != proto[0]:
                out.append(Finding(
                    "abi-binding-arity", src.rel_path, line, 0,
                    f"lib.{name}.argtypes declares {arity} argument(s) "
                    f"but the C prototype takes {proto[0]} "
                    f"({proto[1]}:{proto[2]}) — ctypes marshals "
                    "garbage into the extra/missing slots without a "
                    "peep",
                    hint="mirror the C parameter list exactly"))
        # A .cc file's stem doubles as its CPython module name
        # (spec_from_file_location("pbst_fastcall", ...)) — not a
        # symbol the binding layer resolves against the .so.
        module_names = {
            csrc.rel_path.replace("\\", "/").rsplit("/", 1)[-1]
            .removesuffix(".cc")
            for csrc in ctx.c_files}
        for name, line in sorted(set(symbols)):
            if name in module_names:
                continue
            if name not in protos:
                out.append(Finding(
                    "abi-unknown-symbol", src.rel_path, line, 0,
                    f"binding layer references {name} but no scanned "
                    ".cc file defines it — a stale binding or a typo "
                    "(AttributeError only on the path that touches "
                    "it)",
                    hint="fix the name or add the C entry point"))
        referenced = [t for t in state["py_texts"]]
        for name in sorted(protos):
            if not any(name in t for t in referenced):
                _, cpath, cline = protos[name]
                out.append(Finding(
                    "abi-unbound-export", cpath, cline, 0,
                    f"C export {name} is referenced by no scanned "
                    "Python source — dead ABI surface, or a binding "
                    "someone forgot to declare",
                    hint="declare it in runtime/native.py _declare() "
                         "(restype/argtypes) or retire the export"))
        return out

    def _fastcall_table(self, state, ctx) -> list[Finding]:
        out = []
        table: dict[str, tuple[str, int]] = {}
        handlers: set[str] = set()
        fc_src = None
        for csrc in ctx.c_files:
            text = ctokens.nocomment_text(csrc)
            for fn in ctokens.functions(text):
                if fn.name.startswith("fc_"):
                    handlers.add(fn.name)
            # The table names live in string literals, which the scan
            # text blanks — extract from the RAW text. Entries wrap
            # (clang-format splits long ones), so match across lines.
            for m in _FC_TABLE_RE.finditer(csrc.text):
                line = csrc.text.count("\n", 0, m.start()) + 1
                table.setdefault(m.group(1), (csrc.rel_path, line))
                fc_src = csrc
        if fc_src is None:
            return out  # no fastcall table in the scan set
        for name, (path, line) in sorted(table.items()):
            if f"fc_{name}" not in handlers:
                out.append(Finding(
                    "abi-fastcall-table", path, line, 0,
                    f"method table entry {name!r} has no fc_{name} "
                    "handler in the scanned .cc sources — the module "
                    "would not compile, or the entry points at the "
                    "wrong function",
                    hint="keep the kMethods name and the fc_ handler "
                         "in lockstep"))
        if state["binding"] is not None:
            src, (_, _, required) = state["binding"]
            for name, line in sorted(set(required)):
                if name not in table:
                    out.append(Finding(
                        "abi-fastcall-table", src.rel_path, line, 0,
                        f"runtime/native.py requires fastcall symbol "
                        f"{name!r} but the method table does not "
                        "export it — fastcall() raises on import and "
                        "the whole tier silently degrades to ctypes",
                        hint="add the kMethods entry (or drop the "
                             "requirement)"))
        return out
