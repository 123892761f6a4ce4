"""Scheduler-ops conformance pass.

The sched registry (``sched/__init__.py`` / ``@register_scheduler``) is
the ops-table: every registered policy must present the interface
``sched/base.py`` declares — the shape Xen enforces at compile time
through ``struct scheduler`` and C type checking, which Python happily
skips. Three rules:

- ``sched-ops-missing``: a registered policy does not implement a
  required (abstract) hook — ``wake``, ``do_schedule``.
- ``sched-ops-signature``: an implemented hook's positional parameters
  differ from the ops-table declaration (wrong arity or names — the
  calls are positional in the dispatch hot path, so a renamed/extra
  parameter is a latent TypeError or silent misbind).
- ``sched-ops-clamp``: ``do_schedule`` returns a ``Decision`` whose
  quantum derives from ``params.tslice_us`` without clamping it into
  the dispatch-legal band — the exact bug class the feedback
  ``_shrink`` clamp fixed: an out-of-band store write (operator
  ``sched-credit -t``, restore of an old save) lands a slice outside
  [TSLICE_MIN_US, TSLICE_MAX_US] and the policy dispatches it
  verbatim. Clamp with ``sched.base.clamp_tslice_us`` (or an
  equivalent min/max) at the Decision site.

When ``sched/base.py`` is among the scanned files the ops-table spec is
parsed from it (so the checker can never drift from the code); when a
subset of files is checked, a built-in fallback spec of the required
hooks is used.

The port of ``pbs_tpu.analysis.schedops``; no departure.
"""

from __future__ import annotations

import ast

from pbs_tpu_torch.analysis.core import CheckContext, Finding, Pass, SourceFile

#: Fallback ops-table spec, used only when sched/base.py is not among
#: the scanned files. hook -> positional params after self.
FALLBACK_REQUIRED = {
    "wake": ["ctx"],
    "do_schedule": ["ex", "now_ns"],
}
FALLBACK_OPTIONAL = {
    "executor_added": ["ex"],
    "executor_removed": ["ex"],
    "job_added": ["job"],
    "job_removed": ["job"],
    "sleep": ["ctx"],
    "yield_": ["ctx"],
    "pick_executor": ["ctx"],
    "descheduled": ["ex", "ctx", "ran_ns", "now_ns"],
    "dump_settings": [],
    "dump_executor": ["ex"],
    "dump_admin_conf": [],
}

#: Names accepted as a clamp at the Decision site.
CLAMP_CALLS = ("clamp_tslice_us", "_clamp", "clamp")


def _params_of(fn: ast.FunctionDef) -> list[str]:
    args = [a.arg for a in fn.args.args]
    return args[1:] if args and args[0] == "self" else args


def _is_abstract(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        name = dec.attr if isinstance(dec, ast.Attribute) else \
            dec.id if isinstance(dec, ast.Name) else ""
        if name == "abstractmethod":
            return True
    return False


def _registered_classes(tree: ast.AST) -> list[ast.ClassDef]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for dec in node.decorator_list:
                name = dec.id if isinstance(dec, ast.Name) else \
                    dec.attr if isinstance(dec, ast.Attribute) else ""
                if name == "register_scheduler":
                    out.append(node)
    return out


def _mentions_tslice(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "tslice_us":
            return True
        if isinstance(sub, ast.Name) and sub.id == "tslice_us":
            return True
    return False


def _has_clamp(node: ast.AST) -> bool:
    has_min = has_max = False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            if name in CLAMP_CALLS:
                return True
            if name == "min":
                has_min = True
            if name == "max":
                has_max = True
    return has_min and has_max


class SchedOpsPass(Pass):
    id = "sched-ops"
    rules = ("sched-ops-missing", "sched-ops-signature", "sched-ops-clamp")
    description = ("registered policies implement the sched/base.py "
                   "ops table with matching signatures and clamp "
                   "tslice-derived quanta at the Decision site")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None:
            return []
        path = src.rel_path.replace("\\", "/")
        if path.endswith("sched/base.py"):
            required: dict[str, list[str]] = {}
            optional: dict[str, list[str]] = {}
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef) and node.name == "Scheduler":
                    for item in node.body:
                        if not isinstance(item, ast.FunctionDef) or \
                                item.name.startswith("__"):
                            continue
                        spec = required if _is_abstract(item) else optional
                        spec[item.name] = _params_of(item)
            if required:
                ctx.state["sched_ops_spec"] = (required, optional)
        regs = _registered_classes(src.tree)
        if regs:
            ctx.state.setdefault("sched_classes", []).append((src, regs))
        return []

    def finalize(self, ctx: CheckContext) -> list[Finding]:
        required, optional = ctx.state.get(
            "sched_ops_spec", (FALLBACK_REQUIRED, FALLBACK_OPTIONAL))
        findings: list[Finding] = []
        for src, classes in ctx.state.get("sched_classes", []):
            for cls in classes:
                methods = {m.name: m for m in cls.body
                           if isinstance(m, ast.FunctionDef)}
                for hook, params in sorted(required.items()):
                    if hook not in methods:
                        findings.append(Finding(
                            "sched-ops-missing", src.rel_path, cls.lineno,
                            cls.col_offset,
                            f"registered scheduler {cls.name!r} does not "
                            f"implement required ops-table hook {hook!r}",
                            hint=f"def {hook}(self, {', '.join(params)}): "
                                 "... (see sched/base.py)"))
                for hook, m in sorted(methods.items()):
                    spec = required.get(hook) or optional.get(hook)
                    if spec is None:
                        continue
                    got = _params_of(m)
                    if got != spec:
                        findings.append(Finding(
                            "sched-ops-signature", src.rel_path, m.lineno,
                            m.col_offset,
                            f"{cls.name}.{hook} signature ({', '.join(got)}) "
                            f"does not match the ops table "
                            f"({', '.join(spec)})",
                            hint="the dispatch path calls hooks "
                                 "positionally; match sched/base.py "
                                 "parameter names and order"))
                self._check_clamp(src, cls, methods, findings)
        return findings

    def _check_clamp(self, src: SourceFile, cls: ast.ClassDef,
                     methods: dict[str, ast.FunctionDef],
                     findings: list[Finding]) -> None:
        do_sched = methods.get("do_schedule")
        if do_sched is None:
            return
        for node in ast.walk(do_sched):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            callee = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            if callee != "Decision":
                continue
            quantum = node.args[1] if len(node.args) >= 2 else None
            for kw in node.keywords:
                if kw.arg == "quantum_ns":
                    quantum = kw.value
            if quantum is None:
                continue
            if _mentions_tslice(quantum) and not _has_clamp(quantum):
                findings.append(Finding(
                    "sched-ops-clamp", src.rel_path, quantum.lineno,
                    quantum.col_offset,
                    f"{cls.name}.do_schedule dispatches a tslice_us-derived "
                    "quantum without clamping to the dispatch-legal band",
                    hint="wrap with sched.base.clamp_tslice_us(...) — "
                         "out-of-band store writes can land tslice_us "
                         "outside [TSLICE_MIN_US, TSLICE_MAX_US]"))
