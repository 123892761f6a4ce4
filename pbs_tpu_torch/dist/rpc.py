"""DCN control-plane RPC: length-prefixed JSON over TCP.

Reference mapping: the dom0 toolstack reaches the hypervisor through
privcmd ioctls -> hypercalls and reaches remote hosts over plain TCP
(live migration, ``tools/libxc/xc_domain_save.c``); batches of hypercalls
are issued through the multicall interface (``xen/common/multicall.c``)
to amortize boundary crossings. Here the boundary is the data-center
network between the controller and per-host agents, so the same three
ideas appear as: a tiny framed-JSON RPC (the hypercall ABI), a
server-side op table (the hypercall dispatch table,
``arch/x86/x86_64/entry.S:663-770``), and a first-class ``multicall``
op executing a batch in one round trip.

Deliberately dependency-free (stdlib sockets): the data plane never
touches this path; this carries only control messages, telemetry
summaries, and checkpoint metadata.

The port of ``pbs_tpu.dist.rpc``, byte for byte on the wire: the same
frames (a 4-byte big-endian length, then compact JSON), op table,
idempotency cache, ``lockfree`` ops, ``auth`` trust model, fault points
and backoff, so a port client talks to a reference server and the
reverse (``tests/test_torch_dist.py``).
"""

from __future__ import annotations

import collections
import hmac
import itertools
import json
import os
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Any, Callable

from pbs_tpu_torch.faults import injector as faults
from pbs_tpu_torch import knobs
from pbs_tpu_torch.obs import console as _console
from pbs_tpu_torch.obs.lockprof import ProfiledLock

MAX_MSG_BYTES = 64 << 20

# Transport retry/backoff envelope, declared in the knob registry
# (dist.rpc.*): the constructor defaults every client rides unless a
# caller overrides per-connection.
RPC_MAX_RETRIES = knobs.default("dist.rpc.max_retries")
RPC_BACKOFF_BASE_S = knobs.default("dist.rpc.backoff_base_s")
RPC_BACKOFF_CAP_S = knobs.default("dist.rpc.backoff_cap_s")
RPC_TIMEOUT_S = knobs.default("dist.rpc.timeout_s")
_LEN = struct.Struct(">I")

#: Process-unique client ids feeding idempotency-token prefixes.
_CLIENT_SEQ = itertools.count()


class RpcError(Exception):
    """Remote op raised; .remote_type / .remote_message carry details."""

    def __init__(self, op: str, remote_type: str, remote_message: str):
        super().__init__(f"{op}: {remote_type}: {remote_message}")
        self.op = op
        self.remote_type = remote_type
        self.remote_message = remote_message


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    if len(data) > MAX_MSG_BYTES:
        raise ValueError(f"message too large: {len(data)} bytes")
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_MSG_BYTES:
        raise ValueError(f"message too large: {n} bytes")
    return json.loads(_recv_exact(sock, n).decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


class RpcServer:
    """Threaded TCP server with a registered op table.

    Dispatch is serialized by a single lock — the moral equivalent of
    entering the hypervisor: op handlers may freely mutate the hosted
    partition without their own locking.

    Subject trust model: XSM subjects in request args are *advisory
    labels* checked against the policy — except privileged subjects
    (``system`` by default, the label that bypasses every policy rule).
    Those are only honored on connections that authenticated with the
    server's ``auth_token`` (built-in ``auth`` op), so a remote caller
    cannot claim hypervisor identity through a request field the way a
    Xen domain cannot forge being dom0 (the subject there derives from
    the calling domain, not from hypercall payload). With no token
    configured, no connection can ever be privileged.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 auth_token: str | None = None,
                 privileged_subjects: frozenset[str] = frozenset({"system"}),
                 fault_key: str = "server"):
        self.ops: dict[str, Callable[..., Any]] = {}
        self.auth_token = auth_token
        self.privileged_subjects = privileged_subjects
        #: Logical name for fault-injection streams (``rpc.server`` point
        #: keys are ``<fault_key>:<op>``); agents pass their own name so
        #: chaos streams stay stable across runs (ports are ephemeral).
        self.fault_key = fault_key
        #: How long stop() waits for the serve_forever thread.
        self.join_timeout_s = 2.0
        self._lock = ProfiledLock("rpc_dispatch")
        # Exactly-once for retried mutations: replies are cached by the
        # caller's idempotency token, so a client retrying into us after
        # a lost reply gets the ORIGINAL reply instead of a re-execution
        # (the Remus ack model generalized to every op). Bounded LRU —
        # a retry storms within seconds, not hours.
        self._idem_lock = ProfiledLock("rpc_idem")
        self._idem_cache: collections.OrderedDict[str, dict] = (
            collections.OrderedDict())
        # Tokens whose op is STILL EXECUTING: the cache only fills on
        # completion, so without this a retry racing a slow op (the
        # per-attempt timeout fired mid-execution) would re-execute the
        # mutation. A duplicate parks on the event and replays.
        self._idem_inflight: dict[str, threading.Event] = {}
        self.idem_capacity = 1024
        self.idem_hits = 0
        #: Per-op real execution counts (dedup cache hits excluded) —
        #: the observable tests/chaos assert exactly-once against.
        self.op_executions: dict[str, int] = {}
        # Connection bookkeeping must never wait on the dispatch lock,
        # or a fresh ping connection blocks behind a long-running op.
        self._conns_lock = ProfiledLock("rpc_conns")
        self._conns: set[socket.socket] = set()
        # Liveness probes must answer while a long op holds the dispatch
        # lock — otherwise a busy host reads as dead and gets its jobs
        # double-placed (the NMI watchdog answers from interrupt context
        # for the same reason, xen/arch/x86/nmi.c).
        self._lockfree_ops = {"ping", "ops"}
        self.register("ping", lambda: "pong")
        self.register("ops", lambda: sorted(self.ops))

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection = many requests
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn = {"trusted": False}  # connection-level identity
                with outer._conns_lock:
                    outer._conns.add(sock)
                try:
                    while True:
                        req = recv_msg(sock)
                        resp = outer._handle(req, conn)
                        # rpc.server injection point (reply path): the op
                        # already ran — 'crash' loses the reply and the
                        # connection, forcing the caller through its
                        # retry + idempotency machinery. Lockfree probes
                        # (ping/info) and auth are exempt: liveness must
                        # stay a transport-only signal.
                        op = req.get("op") if isinstance(req, dict) else None
                        if (isinstance(op, str) and op != "auth"
                                and op not in outer._lockfree_ops):
                            f = faults.consult(
                                "rpc.server", f"{outer.fault_key}:{op}")
                            if f is not None:
                                if f.fault == "crash":
                                    raise ConnectionResetError(
                                        "injected server crash")
                                if f.fault == "delay":
                                    time.sleep(float(
                                        f.args.get("delay_s", 0.001)))
                        send_msg(sock, resp)
                except (ConnectionError, OSError, ValueError):
                    return
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.address: tuple[str, int] = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    # -- op table (hypercall registry) -----------------------------------

    def register(self, name: str, fn: Callable[..., Any],
                 lockfree: bool = False) -> None:
        """``lockfree=True`` ops dispatch without the serializing lock —
        only for handlers that are read-only and tolerate torn reads
        (liveness probes, load heuristics)."""
        self.ops[name] = fn
        if lockfree:
            self._lockfree_ops.add(name)

    def _handle(self, req: Any, conn: dict | None = None) -> dict:
        # Idempotency dedup wraps the whole dispatch: a token seen
        # before re-delivers the cached reply without touching the op
        # table, so a duplicated frame or a retry after a lost reply is
        # exactly-once. Tokens are client-generated and stable across
        # the retries of ONE call only. Lockfree probes (ping/info) are
        # exempt: they are read-only, retried freely, and caching their
        # replies would churn the mutation replies out of the LRU.
        tok = req.get("idem") if isinstance(req, dict) else None
        op = req.get("op") if isinstance(req, dict) else None
        if not isinstance(tok, str) or op in self._lockfree_ops:
            return self._handle_uncached(req, conn)
        while True:
            with self._idem_lock:
                hit = self._idem_cache.get(tok)
                if hit is not None:
                    self._idem_cache.move_to_end(tok)
                    self.idem_hits += 1
                    return hit
                ev = self._idem_inflight.get(tok)
                if ev is None:
                    ev = self._idem_inflight[tok] = threading.Event()
                    break
            # Another connection is executing this very token (a retry
            # overtook its own still-running first attempt): wait for
            # it to finish, then replay its reply from the cache —
            # never execute a mutation a second time.
            ev.wait()
        try:
            resp = self._handle_uncached(req, conn)
            with self._idem_lock:
                self._idem_cache[tok] = resp
                while len(self._idem_cache) > self.idem_capacity:
                    self._idem_cache.popitem(last=False)
            return resp
        finally:
            with self._idem_lock:
                self._idem_inflight.pop(tok, None)
            ev.set()

    def _handle_uncached(self, req: Any, conn: dict | None = None) -> dict:
        # A malformed request must produce an error reply, never kill
        # the connection (the client would block until timeout).
        conn = conn if conn is not None else {"trusted": False}
        try:
            if not isinstance(req, dict) or "op" not in req:
                raise ValueError("bad request")
            op = req["op"]
            kwargs = req.get("args") or {}
            if op == "auth":
                # Connection-level identity: the only way a connection
                # may later present a privileged subject.
                token = (kwargs or {}).get("token")
                if (self.auth_token is not None and isinstance(token, str)
                        and hmac.compare_digest(token, self.auth_token)):
                    conn["trusted"] = True
                    return {"ok": True, "result": True}
                raise PermissionError("bad or missing auth token")
            if op == "multicall":
                # xen/common/multicall.c: execute each entry in order; a
                # failing entry doesn't abort the batch — per-entry status.
                calls = req.get("calls", [])
                if not isinstance(calls, list) or not all(
                        isinstance(c, dict) for c in calls):
                    raise ValueError("multicall 'calls' must be a list of "
                                     "{op, args} objects")
                results = [self._call_one(c.get("op"), c.get("args") or {},
                                          conn)
                           for c in calls]
                return {"ok": True, "result": results}
            if not isinstance(kwargs, dict):
                raise ValueError("'args' must be an object")
            return self._call_one(op, kwargs, conn)
        except Exception as e:  # noqa: BLE001 — marshalled to caller
            return {"ok": False, "error": type(e).__name__, "message": str(e)}

    def _call_one(self, op: str, kwargs: dict,
                  conn: dict | None = None) -> dict:
        fn = self.ops.get(op)
        if fn is None:
            return {"ok": False, "error": "LookupError",
                    "message": f"unknown op {op!r}"}
        try:
            # Inside the try: a malformed entry (non-dict args) must
            # yield a per-entry error status, never abort a multicall.
            if not isinstance(kwargs, dict):
                raise ValueError("'args' must be an object")
            subj = kwargs.get("subject")
            if (isinstance(subj, str) and subj in self.privileged_subjects
                    and not (conn or {}).get("trusted")):
                raise PermissionError(
                    f"subject {subj!r} requires an authenticated "
                    "connection")
            if op in self._lockfree_ops:
                self.op_executions[op] = self.op_executions.get(op, 0) + 1
                return {"ok": True, "result": fn(**kwargs)}
            with self._lock:
                # Counted under the dispatch lock: mutating-op execution
                # counts are the exactly-once evidence and must be exact.
                self.op_executions[op] = self.op_executions.get(op, 0) + 1
                return {"ok": True, "result": fn(**kwargs)}
        except Exception as e:  # noqa: BLE001 — marshalled to caller
            return {"ok": False, "error": type(e).__name__, "message": str(e)}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name=f"rpc-server-{self.address[1]}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() blocks on an acknowledgment from the serve_forever
        # loop — which never comes if start() was never called (the
        # stdlib primitive hangs forever). Only signal a loop that ran.
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        # Handler threads outlive shutdown(); sever their connections so
        # a stopped host really goes silent (heartbeats must fail).
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        if self._thread is not None:
            self._thread.join(timeout=self.join_timeout_s)
            if self._thread.is_alive():
                # A leaked serve_forever thread means a handler is
                # wedged and the port stays half-alive — silently
                # dropping that hid real hangs; say so where operators
                # look (the system console ring, obs.console).
                _console.log(
                    f"rpc-server {self.address[0]}:{self.address[1]} "
                    f"({self.fault_key}): thread failed to join within "
                    f"{self.join_timeout_s:.1f}s; leaking daemon thread")


class RpcClient:
    """Persistent connection to one RpcServer.

    ``auth_token`` (if given) is presented on every (re)connect, so the
    connection-level trust survives transparent reconnects.

    Transport failures (drop, reset, timeout) are absorbed by bounded
    retries with capped exponential backoff and *deterministic* jitter
    (derived from (fault_key, op, attempt) — no RNG state, so chaos
    runs replay); every request carries an idempotency token the server
    deduplicates, making a retried mutating op exactly-once. A per-op
    deadline (``deadline_s`` / per-call ``_deadline``) bounds the whole
    retry loop. ``fault_key`` is the logical stream label for the
    ``rpc.client`` injection point — callers use stable names (agent
    name, not host:port) so seeded chaos runs are reproducible.
    """

    def __init__(self, address: tuple[str, int],
                 timeout_s: float = RPC_TIMEOUT_S,
                 auth_token: str | None = None, fault_key: str = "client",
                 max_retries: int = RPC_MAX_RETRIES,
                 backoff_base_s: float = RPC_BACKOFF_BASE_S,
                 backoff_cap_s: float = RPC_BACKOFF_CAP_S,
                 deadline_s: float | None = None):
        self.address = (address[0], int(address[1]))
        self.timeout_s = timeout_s
        self.auth_token = auth_token
        self.fault_key = fault_key
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.deadline_s = deadline_s
        self.retries = 0  # transport retries performed (observability)
        # Random component: token prefixes must be unguessable (a
        # guessable token lets another connection replay or pre-poison
        # a cached reply) and collision-free across process restarts
        # (pid reuse + a reset counter would resurrect a dead
        # incarnation's cached replies). os.urandom touches no seeded
        # RNG, so chaos-run determinism is unaffected.
        self._idem_prefix = (f"{os.getpid():x}.{next(_CLIENT_SEQ):x}."
                             f"{os.urandom(8).hex()}")
        self._idem_seq = itertools.count()
        self._sock: socket.socket | None = None
        # Serializes request/response pairs on the one socket; held
        # across the round trip BY DESIGN (framing would interleave
        # otherwise) — visible to lockprof as "rpc_client" so that
        # wait time shows up in contention stats instead of hiding.
        self._lock = ProfiledLock("rpc_client")

    def _token(self) -> str:
        return f"{self._idem_prefix}.{next(self._idem_seq):x}"

    def _backoff(self, op: str, attempt: int) -> float:
        """Capped exponential backoff with deterministic jitter in
        [0.5, 1.0)× — a hash of (fault_key, op, attempt), not RNG
        state, so two same-seed chaos runs sleep identically."""
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2 ** (attempt - 1)))
        h = zlib.crc32(f"{self.fault_key}:{op}:{attempt}".encode())
        return base * (0.5 + (h % 1024) / 2048.0)

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.address, timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            if self.auth_token is not None:
                send_msg(s, {"op": "auth",
                             "args": {"token": self.auth_token}})
                resp = recv_msg(s)
                if not resp.get("ok"):
                    self._sock = None
                    s.close()
                    raise RpcError("auth", resp.get("error", "?"),
                                   resp.get("message", ""))
        return self._sock

    def _roundtrip(self, req: dict, timeout_s: float | None = None) -> Any:
        op = req.get("op", "?")
        # Consult the injector BEFORE taking the round-trip lock: a
        # 'delay' fault sleeps here, and sleeping under the lock would
        # be a lock-blocking pathology.
        fault = faults.consult("rpc.client", f"{self.fault_key}:{op}")
        if fault is not None and fault.fault == "delay":
            time.sleep(float(fault.args.get("delay_s", 0.001)))
            fault = None
        with self._lock:
            try:
                if fault is not None and fault.fault == "reset":
                    self.close()
                    raise ConnectionResetError("injected connection reset")
                if fault is not None and fault.fault == "drop_request":
                    # The frame vanished on the wire; the caller's read
                    # would time out — simulated without the wait. The
                    # socket dies with it (see the except note below).
                    self.close()
                    raise socket.timeout("injected request drop")
                sock = self._ensure()
                if timeout_s is not None:
                    sock.settimeout(timeout_s)
                try:
                    if fault is not None and fault.fault == "garble":
                        # Valid length header, corrupt body: the server
                        # kills the stream, we read the close.
                        payload = b'\x16{"__garbled frame__'
                        sock.sendall(_LEN.pack(len(payload)) + payload)
                        return recv_msg(sock)
                    send_msg(sock, req)
                    if fault is not None and fault.fault == "duplicate":
                        # Retransmit: two frames land server-side. Both
                        # replies must be drained or every later call
                        # reads its predecessor's reply; the idem cache
                        # makes the second a non-execution.
                        send_msg(sock, req)
                        recv_msg(sock)
                        return recv_msg(sock)
                    resp = recv_msg(sock)
                    if fault is not None and fault.fault == "drop_reply":
                        self.close()
                        raise socket.timeout("injected reply drop")
                    return resp
                finally:
                    if timeout_s is not None and self._sock is not None:
                        try:
                            self._sock.settimeout(self.timeout_s)
                        except OSError:  # closed/reset mid-call
                            pass
            except (ConnectionError, socket.timeout, OSError):
                # A timeout mid-frame leaves the stream desynced (a
                # partial send/recv cannot be resumed): the socket must
                # die with the call, or every later reply on the reused
                # connection would be parsed against the wrong length
                # header. socket.timeout is spelled out even though
                # 3.10+ folds it into OSError — this line IS the
                # contract, not an accident of the exception tree.
                self.close()
                raise

    def _call_raw(self, req: dict, op: str,
                  _timeout: float | None = None,
                  _deadline: float | None = None) -> dict:
        """Shared retry loop: bounded attempts, capped backoff with
        deterministic jitter, overall deadline. Only transport errors
        retry — an in-band op error means the server executed and
        answered, and re-executing is the caller's decision."""
        budget = self.deadline_s if _deadline is None else _deadline
        deadline = None if budget is None else time.monotonic() + budget
        attempt = 0
        while True:
            try:
                t = _timeout
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise socket.timeout(f"{op}: deadline exhausted")
                    t = min(t if t is not None else self.timeout_s, left)
                return self._roundtrip(req, timeout_s=t)
            except (ConnectionError, socket.timeout, OSError):
                attempt += 1
                if attempt > self.max_retries:
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                self.retries += 1
                delay = self._backoff(op, attempt)
                if deadline is not None:
                    # Clamp the sleep to the remaining budget: a capped
                    # backoff larger than what's left would overshoot
                    # the deadline by up to a whole backoff period —
                    # the loop must wake AT the deadline and raise, not
                    # after it (supervisor pumps schedule against this).
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                time.sleep(delay)

    def call(self, op: str, _timeout: float | None = None,
             _deadline: float | None = None, **kwargs: Any) -> Any:
        """One op, exactly-once. ``_timeout`` overrides the per-attempt
        socket timeout (long-running ops like agent ``run``);
        ``_deadline`` bounds the WHOLE call including retries (default
        ``self.deadline_s``). The request carries an idempotency token
        stable across its retries, so a retry after a lost reply
        re-delivers the original result instead of re-executing."""
        req = {"op": op, "args": kwargs, "idem": self._token()}
        resp = self._call_raw(req, op, _timeout=_timeout,
                              _deadline=_deadline)
        if not resp.get("ok"):
            raise RpcError(op, resp.get("error", "?"), resp.get("message", ""))
        return resp["result"]

    def multicall(self, calls: list[tuple[str, dict]]) -> list[Any]:
        """Batch of (op, kwargs) in one round trip; per-entry results.
        Raises only on transport failure (after retries) — op errors
        come back in-band as ``{"ok": False, ...}`` entries, like
        multicall entry status. One idempotency token covers the whole
        batch: a retried multicall replays the cached entry statuses."""
        req = {
            "op": "multicall",
            "calls": [{"op": op, "args": kw} for op, kw in calls],
            "idem": self._token(),
        }
        resp = self._call_raw(req, "multicall")
        if not resp.get("ok"):
            raise RpcError("multicall", resp.get("error", "?"),
                           resp.get("message", ""))
        return resp["result"]

    def try_ping(self) -> bool:
        try:
            return self.call("ping") == "pong"
        except Exception:  # noqa: BLE001 — liveness probe
            return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
