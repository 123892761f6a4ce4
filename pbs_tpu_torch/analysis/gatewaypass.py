"""Gateway-discipline pass.

Serving traffic enters through exactly one door: :class:`pbs_tpu_torch
.gateway.Gateway`, which owns admission (tenant quotas, backpressure,
explicit shed), fair queueing across tenants, and routing with the
drain/requeue guarantee (docs/GATEWAY.md). What breaks is code
submitting straight into an engine or dispatching straight onto a
backend — that traffic is invisible to every one of those guarantees:
no quota charges it, no fairness schedules it, and a backend loss
silently drops it. Two rules, scoped to the package tree minus the
machinery (``pbs_tpu_torch/gateway/`` implements the door; ``models/
serving.py`` implements the engine the door fronts) and tests:

- ``gw-direct-submit``: ``.submit(...)`` on an object constructed from
  ``ContinuousBatcher``/``SpeculativeBatcher`` in the same module
  (including ``self.x = ContinuousBatcher(...)`` attributes) — an
  admission bypass.
- ``gw-direct-dispatch``: a call to a backend's ``dispatch_request``
  — dispatch without routing, so nothing requeues it on backend loss.
- ``gw-lease-bypass``: a write to a token bucket's ``.level`` outside
  the gateway machinery. Under federation (docs/GATEWAY.md
  "Federation") admission state is REPLICATED: bucket levels are
  slices of one global bank, and every level change must go through
  the lease path (``LeaseBroker.grant``/``deposit``,
  ``LeasedBucket.credit``/``take``) or the federation's global-rate
  contract silently desyncs — a hand-topped bucket is minting tokens
  nobody audited.

The port of ``pbs_tpu.analysis.gatewaypass``. Departure: a file's place
is found by the path part ``pbs_tpu_torch`` (exactly that part, so a
tree that holds both packages anchors each file under its own) and
module prefixes ``pbs_tpu_torch.``; messages and hints name the port's
modules.
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

#: Engine constructors whose instances must be fed via the gateway.
ENGINE_CTORS = {"ContinuousBatcher", "SpeculativeBatcher"}

#: Bucket constructors whose ``.level`` is replicated admission state.
BUCKET_CTORS = {"TokenBucket", "LeasedBucket", "GlobalBucket"}

#: Modules that ARE the machinery (relative to the package root).
#: The two serve backend modules (docs/SERVING.md) qualify file-by-
#: file: their engine submits happen INSIDE dispatch_request / the
#: KV-handoff path, on the far side of admission — the exact seam
#: gateway/backends.py is exempt for. The rest of serve/ is NOT
#: machinery and stays covered.
MACHINERY = ("gateway", "models/serving.py", "serve/backend.py",
             "serve/disagg.py")


def _anchored(rel_path: str) -> list[str]:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return parts


def _exempt(rel_path: str) -> bool:
    parts = _anchored(rel_path)
    if not parts:
        return True
    joined = "/".join(parts)
    if parts[0] == "gateway" or joined in (
            "models/serving.py", "serve/backend.py", "serve/disagg.py"):
        return True
    # Tests drive engines directly on purpose (parity/latency pins).
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


def _ctor_name(node: ast.AST) -> str | None:
    """Last dotted segment of a Call's callee, if resolvable."""
    if not isinstance(node, ast.Call):
        return None
    qual = qualified_name(node.func)
    if qual is None:
        return None
    return qual.rsplit(".", 1)[-1]


class _EngineNames(ast.NodeVisitor):
    """First sweep: names/attributes bound to engine (and bucket)
    constructions."""

    def __init__(self) -> None:
        self.names: set[str] = set()
        self.buckets: set[str] = set()

    def _record(self, ctor: str | None, targets: list[ast.AST]) -> None:
        if ctor not in ENGINE_CTORS and ctor not in BUCKET_CTORS:
            return
        into = self.names if ctor in ENGINE_CTORS else self.buckets
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                into.add(tgt.id)
            elif isinstance(tgt, ast.Attribute):
                into.add(tgt.attr)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._record(_ctor_name(node.value), node.targets)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(_ctor_name(node.value), [node.target])
        self.generic_visit(node)


class _GatewayScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile, engine_names: set[str],
                 bucket_names: set[str]):
        self.src = src
        self.engine_names = engine_names
        self.bucket_names = bucket_names
        self.findings: list[Finding] = []

    def _base_name(self, node: ast.Attribute) -> str | None:
        base = node.value
        if isinstance(base, ast.Subscript):
            base = base.value  # buckets["t"].level — name the mapping
        if isinstance(base, ast.Name):
            return base.id
        if isinstance(base, ast.Attribute):
            return base.attr
        return None

    def _flag_level_write(self, target: ast.AST, node: ast.AST) -> None:
        if not (isinstance(target, ast.Attribute)
                and target.attr == "level"):
            return
        base = self._base_name(target)
        if base is None:
            return
        if base not in self.bucket_names and "bucket" not in base.lower():
            return
        self.findings.append(Finding(
            "gw-lease-bypass", self.src.rel_path,
            node.lineno, node.col_offset,
            "token-bucket level written outside the lease path — "
            "replicated admission state changes only through lease "
            "grant/renew/deposit, or the federation's global-rate "
            "contract silently desyncs",
            hint="route through LeaseBroker.grant/deposit or "
                 "LeasedBucket.credit (pbs_tpu_torch.gateway.federation); "
                 "spend via the bucket's own take()"))

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._flag_level_write(tgt, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._flag_level_write(node.target, node)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "submit":
                base = self._base_name(func)
                qual = qualified_name(func) or ""
                owner = qual.rsplit(".", 2)
                if (base in self.engine_names
                        or (len(owner) >= 2 and owner[-2] in ENGINE_CTORS)):
                    self.findings.append(Finding(
                        "gw-direct-submit", self.src.rel_path,
                        node.lineno, node.col_offset,
                        "direct engine submit bypasses the gateway — no "
                        "admission (quota/backpressure), no fair queue, "
                        "no requeue on backend loss",
                        hint="route requests through Gateway.submit "
                             "(pbs_tpu_torch.gateway); wrap the engine in a "
                             "BatcherBackend"))
            elif func.attr == "dispatch_request":
                self.findings.append(Finding(
                    "gw-direct-dispatch", self.src.rel_path,
                    node.lineno, node.col_offset,
                    "direct backend dispatch skips routing — nothing "
                    "drains or requeues this request if the backend "
                    "dies, and no queue-delay sample is taken",
                    hint="let the gateway pump dispatch (Gateway.tick); "
                         "backends are routed least-loaded and "
                         "breaker-vetted there"))
        self.generic_visit(node)


class GatewayDisciplinePass(Pass):
    id = "gateway-discipline"
    rules = ("gw-direct-submit", "gw-direct-dispatch", "gw-lease-bypass")
    description = ("serving requests enter through the gateway front "
                   "door (admission, fair queue, routed dispatch) and "
                   "replicated admission state moves only through the "
                   "lease path; direct engine submits, backend "
                   "dispatches, and bucket-level writes outside "
                   "pbs_tpu_torch/gateway/ are flagged")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or _exempt(src.rel_path):
            return []
        names = _EngineNames()
        names.visit(src.tree)
        scan = _GatewayScan(src, names.names, names.buckets)
        scan.visit(src.tree)
        return scan.findings
