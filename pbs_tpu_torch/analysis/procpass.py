"""Process-discipline pass.

Process mode (docs/GATEWAY.md "Process mode") concentrates every raw
process primitive in ONE module: ``gateway/supervisor.py`` owns the
spawn (:class:`~pbs_tpu_torch.gateway.supervisor.ProcessHandle`), the
``SIGKILL``, and the reap. Everything else holds handles and speaks
rpc. What breaks when that discipline slips:

- a stray ``os.kill``/``signal`` call is an unsupervised death — the
  liveness state machine never records it, so no restart, no drain,
  no handoff, and the member's journal fd may stay held by a
  half-dead process;
- a spawned process that is never joined lingers as a zombie on the
  1-vCPU CI box until the parent exits (and its exit code — the
  SIGKILL evidence — is lost);
- an :class:`~pbs_tpu_torch.dist.rpc.RpcClient` built without ``deadline_s``
  has per-attempt timeouts but NO bound on the whole retry loop — a
  flaky peer can pin a supervision pump for minutes
  (``federation.proc.rpc_deadline_ns`` exists precisely so every
  parent→member op sheds instead of hanging).

Three rules, tree-wide (the supervisor module is the machinery
exemption for the first two; ``dist/rpc.py`` implements the client and
is exempt from the third):

- ``proc-raw-kill``: ``os.kill`` / ``os.killpg`` / ``os.fork`` /
  ``signal.signal`` / ``signal.pthread_kill`` outside the supervisor.
- ``proc-unreaped-spawn``: a ``subprocess.Popen`` / ``Process(...)``
  spawn in a function that never joins/waits/reaps the handle.
- ``proc-undeadlined-client``: an ``RpcClient(...)`` construction
  without an explicit ``deadline_s=``.

The port of ``pbs_tpu.analysis.procpass``. Departure: a file's place is
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

#: The one module allowed to touch raw process primitives.
MACHINERY = ("gateway/supervisor.py",)

#: The transport implementation (deadline plumbing lives here).
RPC_MACHINERY = ("dist/rpc.py",)

#: Raw signal/fork primitives and why each is unsupervised.
RAW_KILL_CALLS = {
    "os.kill": "a signal the supervisor never records",
    "os.killpg": "a process-group signal the supervisor never records",
    "os.fork": "a fork outside the spawn-context discipline (inherits "
               "the parent's threads and locks)",
    "signal.signal": "a handler installed behind the supervisor's back",
    "signal.pthread_kill": "a thread signal the supervisor never "
                           "records",
}

#: Spawn constructors that hand back a process handle needing a reap.
SPAWN_CALLS = ("subprocess.Popen",)

#: Method/attr names that count as reaping a spawned handle.
REAP_NAMES = {"join", "wait", "communicate", "reap", "kill9"}


def _anchored(rel_path: str) -> list[str]:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return parts


def _is_machinery(rel_path: str, machinery: tuple[str, ...]) -> bool:
    return "/".join(_anchored(rel_path)) in machinery


def _is_spawn(node: ast.Call) -> bool:
    qual = qualified_name(node.func)
    if qual in SPAWN_CALLS:
        return True
    # mp_context.Process(...) / multiprocessing.Process(...): spawn by
    # any name — the ctor attribute is the stable signature.
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "Process")


class _Scan(ast.NodeVisitor):
    def __init__(self, src: SourceFile, skip_raw: bool):
        self.src = src
        self.skip_raw = skip_raw
        self.findings: list[Finding] = []
        #: Spawn call sites within the current function scope.
        self._spawns: list[list[ast.Call]] = []
        #: Did the current function scope reap anything?
        self._reaps: list[bool] = []

    # -- function scopes -------------------------------------------------

    def _visit_func(self, node) -> None:
        self._spawns.append([])
        self._reaps.append(False)
        self.generic_visit(node)
        spawns = self._spawns.pop()
        reaped = self._reaps.pop()
        if not reaped:
            for call in spawns:
                self.findings.append(Finding(
                    "proc-unreaped-spawn", self.src.rel_path,
                    call.lineno, call.col_offset,
                    "spawned process handle is never joined/waited in "
                    "this function — it lingers as a zombie and its "
                    "exit code is lost",
                    hint="hold a gateway.supervisor.ProcessHandle and "
                         "reap() it, or join()/wait() the handle on "
                         "every path"))

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- calls -----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        qual = qualified_name(node.func)
        if not self.skip_raw and qual in RAW_KILL_CALLS:
            self.findings.append(Finding(
                "proc-raw-kill", self.src.rel_path, node.lineno,
                node.col_offset,
                f"raw process primitive {qual}() outside the "
                f"supervisor — {RAW_KILL_CALLS[qual]}",
                hint="route process lifecycle through gateway."
                     "supervisor.ProcessHandle (kill9/reap); it is "
                     "the one module allowed raw primitives"))
        if not self.skip_raw and self._spawns and _is_spawn(node):
            self._spawns[-1].append(node)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in REAP_NAMES and self._reaps:
            self._reaps[-1] = True
        if (qual or "").split(".")[-1] == "RpcClient":
            has_deadline = any(
                kw.arg == "deadline_s" or kw.arg is None  # **kwargs
                for kw in node.keywords)
            if not has_deadline:
                self.findings.append(Finding(
                    "proc-undeadlined-client", self.src.rel_path,
                    node.lineno, node.col_offset,
                    "RpcClient built without deadline_s — per-attempt "
                    "timeouts bound one try, nothing bounds the whole "
                    "retry loop",
                    hint="pass deadline_s= (knob federation.proc."
                         "rpc_deadline_ns for supervision paths) or "
                         "an explicit per-call _deadline at every "
                         "call site"))
        self.generic_visit(node)


class ProcessDisciplinePass(Pass):
    id = "process-discipline"
    rules = ("proc-raw-kill", "proc-unreaped-spawn",
             "proc-undeadlined-client")
    description = ("raw process primitives live in gateway/supervisor "
                   "only; spawned handles must be reaped; RpcClient "
                   "constructions carry a whole-call deadline")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None:
            return []
        skip_raw = _is_machinery(src.rel_path, MACHINERY)
        if _is_machinery(src.rel_path, RPC_MACHINERY):
            return []
        scan = _Scan(src, skip_raw)
        scan.visit(src.tree)
        return scan.findings
