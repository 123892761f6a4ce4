"""Knob-discipline pass: the registry stays authoritative.

The typed knob registry (``pbs_tpu_torch/knobs/registry.py``) only means
anything if bypassing it is a CI failure — a tunable constant that
quietly reverts to a module literal is invisible to ``pbst knobs``,
to tuned-profile loads, and to hot-reload, exactly the drift Xkernel's
declared-tunable model exists to prevent (docs/KNOBS.md). Five rules:

- ``knob-unrouted``: a module-level tunable constant (UPPERCASE,
  unit-suffixed or tunable-hinted name, defined as a bare numeric
  literal — including ``N * MS`` forms) consumed inside a **hot-path
  body** (``do_schedule`` / ``wake`` / ``tick`` / ``admit`` /
  ``dispatch`` functions and their ``_``-prefixed / suffixed
  variants). The sanctioned form is
  ``NAME = knobs.default("<subsystem>...")``. Resolution follows
  ``from pbs_tpu_torch.x import NAME`` and ``module.NAME`` references
  across the scanned tree.
- ``knob-inline-tunable``: a ``<literal> * US|MS|SEC`` expression
  inside a hot-path body — an inline magic duration no registry entry
  governs (the ``50 * MS`` retry-hint class of constant).
- ``knob-unknown``: ``knobs.default("...")`` / ``knobs.get("...")``
  naming a knob the registry does not declare — a typo that would
  otherwise surface as a KeyError at import time on some other host.
- ``knob-unit-drift``: a routed constant whose ``_ns/_us/_ms`` name
  suffix disagrees with the registry's declared unit (the time-units
  machinery applied at the registry boundary: the suffix is what the
  unit-mix checker trusts downstream, so it must match the
  declaration).
- ``knob-native-drift``: the cross-language mirror. The policy's
  ``TUNABLE_PARAMS``, the knob mapping (knobs/profile.py
  ``PARAM_KNOBS``), the registry's declared ``native=`` symbols, the
  marshalling table in ``sim/native_core.py`` (``gs[GS_X] =
  fb.param``), and the symbols in ``runtime/csrc/pbst_runtime.cc`` must
  agree — a knob added on one side of the C ABI without the other is
  a static finding, not a silent drift.

The pass imports ``pbs_tpu_torch.knobs`` (stdlib-only by contract) but
nothing heavier — ``pbst check`` still runs on bare CI images.

The port of ``pbs_tpu.analysis.knobspass``. Departure: a file's place is
found by the path part ``pbs_tpu_torch`` (exactly that part, so a tree
that holds both packages anchors each file under its own) and module
prefixes ``pbs_tpu_torch.``; messages and hints name the port's modules.
It reads the port's own registry (``pbs_tpu_torch.knobs.registry``,
``knobs.profile.PARAM_KNOBS``), and looks for the C core at
``runtime/csrc/pbst_runtime.cc`` inside the package that holds
``sim/native_core.py`` (the reference: ``pbst_runtime.cc`` in a C
directory beside its package).
"""

from __future__ import annotations

import ast
import os

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    Finding,
    Pass,
    SourceFile,
    qualified_name,
    unit_of_identifier,
)

#: Hot-path function-name roots (the inventory surface):
#: scheduler dispatch edges, pump ticks, admission, dispatch bodies.
HOT_ROOTS = ("do_schedule", "wake", "tick", "admit", "dispatch")

#: Name tokens that mark an UPPERCASE constant as a tunable even
#: without a time-unit suffix (window depths, rates, weights, ...).
TUNABLE_HINTS = frozenset({
    "WINDOW", "THRESHOLD", "RATE", "BURST", "QUANTUM", "PERIOD",
    "TTL", "BACKOFF", "WATERMARK", "RETRIES", "MARGIN", "ALPHA",
    "WEIGHT", "FRAC", "SCALE", "SLOTS", "CREDIT", "STALL",
})

#: Clock-unit names whose product with a literal is an inline duration.
CLOCK_UNITS = frozenset({"US", "MS", "SEC", "NS"})

#: The registry accessor attributes that route a constant.
ROUTE_CALLS = frozenset({"default", "get"})

#: native_core attribute -> TUNABLE_PARAMS name, where they differ.
ATTR_PARAMS = {"window_len": "window"}

#: Anchored path of the C-ABI marshaller and the policy module.
NATIVE_CORE = "sim/native_core.py"
FEEDBACK_MOD = "sched/feedback.py"


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _module_of(rel_path: str) -> str:
    """Dotted module key for cross-file resolution, anchored below the
    pbs_tpu_torch package root so fixture trees resolve like the real one."""
    return _anchored(rel_path).removesuffix(".py").replace("/", ".")


def _is_upper(name: str) -> bool:
    return bool(name) and name[0].isalpha() and name == name.upper() \
        and any(c.isalpha() for c in name)


def tunable_shaped(name: str) -> bool:
    """Does this constant's NAME claim to be a tunable? Unit-suffixed,
    or carrying a tunable hint token."""
    if not _is_upper(name):
        return False
    if unit_of_identifier(name) is not None:
        return True
    return bool(set(name.split("_")) & TUNABLE_HINTS)


def _routed_call(node: ast.AST) -> str | None:
    """The knob name when ``node`` is a registry accessor call
    (``knobs.default("x")`` / ``knobs.get("x")`` / ``registry.default``
    / bare ``default("x")`` after a from-import), else None ("" when
    the name argument is dynamic)."""
    if not isinstance(node, ast.Call) or not node.args:
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr not in ROUTE_CALLS:
            return None
        recv = qualified_name(fn.value) or ""
        if not (recv == "knobs" or recv.endswith(".knobs")
                or recv == "registry" or recv.endswith(".registry")):
            return None
    elif isinstance(fn, ast.Name):
        # ``from pbs_tpu_torch.knobs import default`` — rare but sanctioned.
        if fn.id not in ROUTE_CALLS:
            return None
    else:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return ""  # dynamic name: routed, but unverifiable statically


def _literal_numeric(node: ast.AST) -> bool:
    """A compile-time numeric expression: literals, +/-/* / ** trees of
    literals and unit-constant names (``500 * US``) — the module-
    constant shapes the registry exists to absorb."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.op, (ast.USub, ast.UAdd)):
        return _literal_numeric(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Mult, ast.Div, ast.FloorDiv, ast.Add,
                      ast.Sub, ast.Pow, ast.LShift, ast.RShift)):
        return _literal_factor(node.left) and _literal_factor(node.right)
    return False


def _literal_factor(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        # US/MS/SEC and fellow UPPERCASE constants keep the expression
        # a compile-time number.
        return _is_upper(node.id)
    return _literal_numeric(node)


def hot_function(name: str) -> bool:
    base = name.lstrip("_")
    if base in HOT_ROOTS:
        return True
    return any(base.startswith(r + "_") or base.endswith("_" + r)
               for r in HOT_ROOTS)


class _FileScan(ast.NodeVisitor):
    """One file: module-constant definitions, import aliases, hot-body
    constant uses, and the per-file rules (unknown/unit-drift/inline)."""

    def __init__(self, src: SourceFile, registry):
        self.src = src
        self.registry = registry
        self.findings: list[Finding] = []
        #: NAME -> ("literal"|"routed"|"other", knob_name|None, line)
        self.defs: dict[str, tuple[str, str | None, int]] = {}
        #: local alias -> (module, original name|None). None original =
        #: a module alias (``from pbs_tpu_torch.sched import base``).
        self.imports: dict[str, tuple[str, str | None]] = {}
        #: (line, col, target module|None, NAME) consts read in hot
        #: bodies; module None = this file.
        self.hot_uses: list[tuple[int, int, str | None, str]] = []
        self._fn_depth = 0
        self._hot_depth = 0

    # -- module-level defs + imports -------------------------------------

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.module.startswith("pbs_tpu_torch.") \
                and node.level == 0:
            below = node.module.removeprefix("pbs_tpu_torch.")
            for alias in node.names:
                local = alias.asname or alias.name
                if _is_upper(alias.name):
                    self.imports[local] = (below, alias.name)
                else:
                    # Possibly a module import: ``from pbs_tpu_torch.sched
                    # import base`` — record as a module alias.
                    self.imports[local] = (f"{below}.{alias.name}", None)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._fn_depth == 0 and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _is_upper(node.targets[0].id):
            name = node.targets[0].id
            knob_name = _routed_call(node.value)
            if knob_name is not None:
                self.defs[name] = ("routed", knob_name or None,
                                   node.lineno)
                self._check_routed(node, name, knob_name)
            elif _literal_numeric(node.value):
                self.defs[name] = ("literal", None, node.lineno)
            else:
                self.defs[name] = ("other", None, node.lineno)
        self.generic_visit(node)

    def _check_routed(self, node: ast.AST, const_name: str,
                      knob_name: str) -> None:
        if not knob_name:
            return  # dynamic name: nothing to check statically
        if not self.registry.exists(knob_name):
            self.findings.append(Finding(
                "knob-unknown", self.src.rel_path, node.lineno,
                node.col_offset,
                f"{const_name} routes through undeclared knob "
                f"{knob_name!r}",
                hint="declare it in pbs_tpu_torch/knobs/registry.py (name, "
                     "type, unit, safe range, default, subsystem) or "
                     "fix the name"))
            return
        declared = self.registry.knob(knob_name).unit
        name_unit = unit_of_identifier(const_name)
        declared_time = declared if declared in ("ns", "us", "ms") \
            else None
        if name_unit != declared_time:
            self.findings.append(Finding(
                "knob-unit-drift", self.src.rel_path, node.lineno,
                node.col_offset,
                f"{const_name} (suffix: {name_unit or 'none'}) is "
                f"routed through {knob_name!r} declared in "
                f"{declared or 'unitless'} — downstream unit-mix "
                "checking trusts the suffix, so they must agree",
                hint="rename the constant so its _ns/_us/_ms suffix "
                     "matches the declared unit (or fix the "
                     "declaration)"))

    # -- hot bodies ------------------------------------------------------

    def _visit_fn(self, node) -> None:
        hot = hot_function(node.name)
        self._fn_depth += 1
        if hot:
            self._hot_depth += 1
        self.generic_visit(node)
        if hot:
            self._hot_depth -= 1
        self._fn_depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Name(self, node: ast.Name) -> None:
        if self._hot_depth > 0 and isinstance(node.ctx, ast.Load) and \
                tunable_shaped(node.id):
            self.hot_uses.append((node.lineno, node.col_offset,
                                  None, node.id))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._hot_depth > 0 and isinstance(node.ctx, ast.Load) and \
                tunable_shaped(node.attr) and \
                isinstance(node.value, ast.Name):
            alias = self.imports.get(node.value.id)
            if alias is not None and alias[1] is None:
                # module-qualified constant: base.TSLICE_MIN_US
                self.hot_uses.append((node.lineno, node.col_offset,
                                      alias[0], node.attr))
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if self._hot_depth > 0 and isinstance(node.op, ast.Mult):
            lit, unit = None, None
            for a, b in ((node.left, node.right),
                         (node.right, node.left)):
                if isinstance(a, ast.Constant) and \
                        isinstance(a.value, (int, float)) and \
                        isinstance(b, ast.Name) and b.id in CLOCK_UNITS:
                    lit, unit = a.value, b.id
            if lit is not None:
                self.findings.append(Finding(
                    "knob-inline-tunable", self.src.rel_path,
                    node.lineno, node.col_offset,
                    f"inline duration {lit} * {unit} inside a hot-path "
                    "body — a magic tunable no registry entry governs",
                    hint="declare it in pbs_tpu_torch/knobs/registry.py and "
                         "route a module constant through "
                         "knobs.default(...) (docs/KNOBS.md)"))
        self.generic_visit(node)


class _NativeCoreScan:
    """The marshalling table of sim/native_core.py: which
    ``fb.<attr>`` values land in which GS_*/GF_* words (one level of
    local indirection followed, for the ``wlen = fb.window_len`` /
    ``gs[GS_WINDOW_LEN] = wlen`` shape)."""

    def __init__(self, tree: ast.AST):
        #: param name -> marshalling symbol
        self.pairs: dict[str, str] = {}
        var_attr: dict[str, str] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target, value = node.targets[0], node.value
            attr = self._fb_attr(value)
            if isinstance(target, ast.Name) and attr is not None:
                var_attr[target.id] = attr
            if isinstance(target, ast.Subscript) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id in ("gs", "gf") and \
                    isinstance(target.slice, ast.Name):
                sym = target.slice.id
                a = self._fb_attr(value)
                if a is None and isinstance(value, ast.Name):
                    a = var_attr.get(value.id)
                if a is not None:
                    self.pairs[ATTR_PARAMS.get(a, a)] = sym

    @staticmethod
    def _fb_attr(node: ast.AST) -> str | None:
        if isinstance(node, ast.IfExp):
            return _NativeCoreScan._fb_attr(node.body)
        if isinstance(node, ast.Call) and len(node.args) == 1:
            return _NativeCoreScan._fb_attr(node.args[0])
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "fb":
            return node.attr
        return None


def _tunable_params_of(tree: ast.AST) -> tuple[list[str], int] | None:
    """The FeedbackPolicy.TUNABLE_PARAMS tuple (statically), with its
    line, or None when the module doesn't carry one."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and \
                node.name == "FeedbackPolicy":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Name) and \
                        stmt.targets[0].id == "TUNABLE_PARAMS" and \
                        isinstance(stmt.value, (ast.Tuple, ast.List)):
                    out = [e.value for e in stmt.value.elts
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str)]
                    return out, stmt.lineno
    return None


class KnobDisciplinePass(Pass):
    id = "knob-discipline"
    rules = ("knob-unrouted", "knob-inline-tunable", "knob-unknown",
             "knob-unit-drift", "knob-native-drift")
    description = ("hot-path tunables route through the typed knob "
                   "registry: no literal-defined tunable constants or "
                   "inline N*MS durations in "
                   "do_schedule/wake/tick/admit/dispatch bodies, "
                   "routed constants name declared knobs with "
                   "matching unit suffixes, and the TUNABLE_PARAMS "
                   "C-ABI marshalling table (sim/native_core.py + "
                   "runtime/csrc/pbst_runtime.cc) mirrors the registry's "
                   "native= declarations exactly")

    def __init__(self) -> None:
        from pbs_tpu_torch.knobs import registry

        self.registry = registry

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        if anchored.startswith("knobs/") or anchored.startswith("analysis/"):
            return []  # the registry/checker machinery itself
        state = ctx.state.setdefault("knobs", {
            "defs": {}, "uses": [], "native": None, "tunable": None,
        })
        scan = _FileScan(src, self.registry)
        scan.visit(src.tree)
        mod = _module_of(src.rel_path)
        state["defs"][mod] = (src, scan.defs, scan.imports)
        for line, col, target_mod, name in scan.hot_uses:
            state["uses"].append(
                (src, line, col, target_mod or mod, mod, name))
        if anchored == NATIVE_CORE:
            state["native"] = (src, _NativeCoreScan(src.tree))
        if anchored == FEEDBACK_MOD:
            state["tunable"] = (src, _tunable_params_of(src.tree))
        return scan.findings

    # -- cross-file rules -------------------------------------------------

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        state = ctx.state.get("knobs")
        if not state:
            return []
        findings: list[Finding] = []
        findings.extend(self._unrouted(state))
        findings.extend(self._native_drift(state))
        return findings

    def _resolve(self, state, mod: str, name: str, hops: int = 0):
        """(def_mod, kind, line) for constant ``name`` as seen from
        ``mod``, following from-imports across scanned files."""
        entry = state["defs"].get(mod)
        if entry is None or hops > 4:
            return None
        _, defs, imports = entry
        if name in defs:
            kind, _, line = defs[name]
            # A from-imported name shadows nothing here: local def wins
            # (python semantics: last binding, but module constants are
            # defined once).
            return mod, kind, line
        imp = imports.get(name)
        if imp is not None and imp[1] is not None:
            return self._resolve(state, imp[0], imp[1], hops + 1)
        return None

    def _unrouted(self, state) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple] = set()
        for src, line, col, target_mod, use_mod, name in state["uses"]:
            resolved = self._resolve(state, target_mod, name)
            if resolved is None:
                # Not a scanned module constant: a local, a builtin,
                # or a definition outside the scanned tree.
                continue
            def_mod, kind, def_line = resolved
            if kind != "literal":
                continue
            key = (src.rel_path, line, col, name)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "knob-unrouted", src.rel_path, line, col,
                f"hot-path body reads tunable constant {name} defined "
                f"as a bare literal ({def_mod}:{def_line}) — invisible "
                "to the knob registry, pbst knobs, and hot-reload",
                hint="declare it in pbs_tpu_torch/knobs/registry.py and "
                     f"define {name} = knobs.default(\"...\") "
                     "(docs/KNOBS.md)"))
        return out

    def _native_drift(self, state) -> list[Finding]:
        native = state.get("native")
        if native is None:
            return []  # no marshaller in this tree: nothing to mirror
        from pbs_tpu_torch.knobs.profile import PARAM_KNOBS

        nsrc, nscan = native
        mapping = PARAM_KNOBS["feedback"]
        out: list[Finding] = []

        tunable = state.get("tunable")
        if tunable is not None and tunable[1] is not None:
            tsrc, (params, tline) = tunable
            for p in params:
                if p not in mapping:
                    out.append(Finding(
                        "knob-native-drift", tsrc.rel_path, tline, 0,
                        f"TUNABLE_PARAMS entry {p!r} has no knob "
                        "mapping (knobs/profile.py PARAM_KNOBS) — the "
                        "param is tunable but invisible to the "
                        "registry and knob files",
                        hint="declare the knob and add the param to "
                             "PARAM_KNOBS for every policy family"))
            for p in mapping:
                if p not in params:
                    out.append(Finding(
                        "knob-native-drift", tsrc.rel_path, tline, 0,
                        f"PARAM_KNOBS maps {p!r} but FeedbackPolicy."
                        "TUNABLE_PARAMS does not declare it — the "
                        "registry advertises a tunable the policy "
                        "cannot take",
                        hint="add the constructor param or drop the "
                             "mapping"))

        # Registry native= symbols <-> marshalling table.
        for p, knob_name in sorted(mapping.items()):
            if not self.registry.exists(knob_name):
                continue  # knob-unknown fires at the routed def site
            sym = self.registry.knob(knob_name).native
            got = nscan.pairs.get(p)
            if sym is not None and got is None:
                out.append(Finding(
                    "knob-native-drift", nsrc.rel_path, 1, 0,
                    f"registry declares native symbol {sym} for "
                    f"{knob_name!r} (param {p!r}) but the marshalling "
                    "table does not move fb."
                    f"{self._attr_of(p)} into it — the C core would "
                    "run a stale constant",
                    hint="marshal the param in sim/native_core.py (and "
                         "consume it in runtime/csrc/pbst_runtime.cc) or "
                         "declare the knob native=None"))
            elif sym is None and got is not None:
                out.append(Finding(
                    "knob-native-drift", nsrc.rel_path, 1, 0,
                    f"marshalling table moves param {p!r} into {got} "
                    f"but the registry declares {knob_name!r} with no "
                    "native symbol — a knob added on one side of the "
                    "C ABI",
                    hint=f"declare native=\"{got}\" on the knob (and "
                         "mirror it in runtime/csrc/pbst_runtime.cc)"))
            elif sym is not None and got != sym:
                out.append(Finding(
                    "knob-native-drift", nsrc.rel_path, 1, 0,
                    f"param {p!r} marshals into {got} but "
                    f"{knob_name!r} declares native={sym}",
                    hint="make the registry declaration and the "
                         "marshalling table agree"))

        # The C side: every declared symbol must exist in the .cc.
        cc = os.path.join(os.path.dirname(os.path.abspath(nsrc.path)),
                          os.pardir, "runtime", "csrc", "pbst_runtime.cc")
        if os.path.isfile(cc):
            try:
                with open(cc, encoding="utf-8", errors="replace") as f:
                    cc_text = f.read()
            except OSError:
                cc_text = None
            if cc_text is not None:
                for p, knob_name in sorted(mapping.items()):
                    if not self.registry.exists(knob_name):
                        continue
                    sym = self.registry.knob(knob_name).native
                    if sym is not None and sym not in cc_text:
                        out.append(Finding(
                            "knob-native-drift", nsrc.rel_path, 1, 0,
                            f"native symbol {sym} ({knob_name!r}) is "
                            "absent from runtime/csrc/pbst_runtime.cc — the "
                            "Python side marshals a word the C side "
                            "never reads",
                            hint="consume the word in the C core or "
                                 "retire the declaration on both "
                                 "sides"))
        return out

    @staticmethod
    def _attr_of(param: str) -> str:
        for attr, p in ATTR_PARAMS.items():
            if p == param:
                return attr
        return param
