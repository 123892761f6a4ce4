"""Network-discipline pass.

Control-plane bytes ride exactly one transport: :class:`dist.rpc
.RpcClient`, whose ``call`` owns bounded retries with capped backoff,
the per-op deadline, and the idempotency token the server deduplicates
(docs/FAULTS.md). What breaks is a caller in the distributed layers
opening its own socket or reaching into the client's private transport
helpers — that traffic silently loses every one of those guarantees: a
dropped frame hangs or desyncs instead of retrying, a retried mutation
re-executes instead of deduplicating, and no deadline bounds the call.
Two rules, scoped to ``dist/`` and ``ckpt/`` (the layers that talk to
peers); ``dist/rpc.py`` is exempt — it *implements* the transport:

- ``net-raw-socket``: a direct ``socket.socket`` /
  ``socket.create_connection`` / ``socket.socketpair`` construction —
  a private wire the retry/deadline/idempotency machinery never sees.
- ``net-raw-transport``: a call to the client's private helpers
  (``._roundtrip(...)`` / ``._call_raw(...)``) — ``_roundtrip``
  bypasses retries AND the idempotency token; ``_call_raw`` bypasses
  the token, so a retried mutation may execute twice.

The port of ``pbs_tpu.analysis.netdiscipline``. Departure: a file's
place is found by the path part ``pbs_tpu_torch`` (exactly that part, so
a tree that holds both packages anchors each file under its own) and
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

#: Packages whose modules must speak RpcClient.call, never raw sockets.
NET_PACKAGES = ("dist", "ckpt")

#: The transport implementation itself (relative to the package root).
MACHINERY = ("dist/rpc.py",)

#: Socket constructors that open a private wire.
RAW_SOCKET_CALLS = {
    "socket.socket": "socket construction",
    "socket.create_connection": "socket connect",
    "socket.socketpair": "socket pair",
}

#: RpcClient private transport helpers and what skipping them loses.
PRIVATE_HELPERS = {
    "_roundtrip": "retries, the deadline, and the idempotency token",
    "_call_raw": "the idempotency token (a retried mutation may "
                 "execute twice)",
}


def _anchored(rel_path: str) -> list[str]:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return parts


def _net_module(rel_path: str) -> bool:
    parts = _anchored(rel_path)
    return bool(parts) and parts[0] in NET_PACKAGES


def _is_machinery(rel_path: str) -> bool:
    return "/".join(_anchored(rel_path)) in MACHINERY


class _NetScan(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        qual = qualified_name(node.func)
        if qual in RAW_SOCKET_CALLS:
            self.findings.append(Finding(
                "net-raw-socket", self.src.rel_path, node.lineno,
                node.col_offset,
                f"raw {RAW_SOCKET_CALLS[qual]} ({qual}) in the control "
                "plane — this wire has no retries, no deadline, no "
                "idempotency",
                hint="speak RpcClient.call (dist/rpc.py); it owns "
                     "bounded retries, the per-op deadline, and the "
                     "idempotency token"))
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in PRIVATE_HELPERS:
            self.findings.append(Finding(
                "net-raw-transport", self.src.rel_path, node.lineno,
                node.col_offset,
                f"private transport helper .{node.func.attr}() called "
                f"outside dist/rpc.py — bypasses "
                f"{PRIVATE_HELPERS[node.func.attr]}",
                hint="use RpcClient.call / multicall; pass _deadline= "
                     "to bound the whole retry loop"))
        self.generic_visit(node)


class NetDisciplinePass(Pass):
    id = "net-discipline"
    rules = ("net-raw-socket", "net-raw-transport")
    description = ("control-plane traffic in dist//ckpt/ rides "
                   "RpcClient.call (retries, deadline, idempotency); "
                   "raw sockets and private transport helpers are "
                   "flagged")

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        if src.tree is None or not _net_module(src.rel_path) \
                or _is_machinery(src.rel_path):
            return []
        scan = _NetScan(src)
        scan.visit(src.tree)
        return scan.findings
