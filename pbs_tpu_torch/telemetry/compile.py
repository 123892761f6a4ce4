"""Compile-time metering: per-job attribution of kernel build cost.

The port of ``pbs_tpu.telemetry.compile``. Every distinct program a
tenant brings costs compile time before its first step, and a partition
multiplexing many tenants can spend more time compiling than running.
The port runs eagerly (nothing reaches ``torch.compile``); what it
compiles is its own CUDA kernels, one ``nvcc`` run per source
(``ops/cuda_build.py``). Each finished ``nvcc`` process is reported
here as one backend-compile event of its wall seconds, and each first
load of a built library (``ctypes`` ``dlopen``) as a front-end event.

Events are attributed to the job whose dispatch triggered them — the
scope is set by ``CudaBackend`` around every host-callable invocation,
per thread, so a build started from a tenant's first step lands in that
tenant's ``COMPILES`` / ``COMPILE_TIME_NS`` ledger slots and feeds the
admission gate in ``pbs_tpu_torch.runtime.compile_gate``. Unattributed
events (a build before any tenant runs) accumulate under
``"<ambient>"``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

#: One finished ``nvcc`` run: one real compilation, one cache entry.
BACKEND_COMPILE_EVENT = "/pbs_tpu_torch/cuda_build/nvcc_duration"
#: First-use work that fills no cache entry (loading a built library;
#: the counted invocation that harvests a foreign tenant's cost,
#: ``telemetry.source.count_invocation``), attributed to the job but not
#: counted as a "compile".
FRONTEND_EVENTS = (
    "/pbs_tpu_torch/cuda_build/load_duration",
    "/pbs_tpu_torch/telemetry/cost_harvest_duration",
)


class CompileMeter:
    """Singleton tap on the port's compile-event stream.

    ``attribute(name)`` scopes the current thread's compilations to a
    job; unattributed events accumulate under ``"<ambient>"`` so system
    compile load is visible too, never silently dropped.
    """

    _instance: "CompileMeter | None" = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        # name -> [compiles, compile_ns, frontend_ns] (pending drain)
        self._pending: dict[str, list[int]] = {}
        # lifetime totals (admission projections read these)
        self.total_compiles = 0
        self.total_compile_ns = 0

    @classmethod
    def install(cls) -> "CompileMeter":
        """Create-or-return the process-wide meter (``ops.cuda_build``
        reports to this one instance)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- listener ---------------------------------------------------------

    def _on_event(self, event: str, duration_s: float, **kw) -> None:
        is_backend = event == BACKEND_COMPILE_EVENT
        if not is_backend and event not in FRONTEND_EVENTS:
            return
        scope = getattr(self._tls, "scope", None) or "<ambient>"
        ns = int(duration_s * 1e9)
        with self._lock:
            ent = self._pending.setdefault(scope, [0, 0, 0])
            if is_backend:
                ent[0] += 1
                ent[1] += ns
                self.total_compiles += 1
                self.total_compile_ns += ns
            else:
                ent[2] += ns

    # -- attribution scope ------------------------------------------------

    @contextlib.contextmanager
    def attribute(self, name: str) -> Iterator[None]:
        prev = getattr(self._tls, "scope", None)
        self._tls.scope = name
        try:
            yield
        finally:
            self._tls.scope = prev

    def take(self, name: str) -> tuple[int, int]:
        """Drain (compiles, compile_ns) attributed to ``name`` since the
        last take. Frontend time is folded into compile_ns — from the
        tenant's perspective it is all time-to-first-step."""
        with self._lock:
            ent = self._pending.pop(name, None)
        if ent is None:
            return 0, 0
        return ent[0], ent[1] + ent[2]

    def peek_all(self) -> dict[str, tuple[int, int]]:
        with self._lock:
            return {k: (v[0], v[1] + v[2])
                    for k, v in self._pending.items()}

    @property
    def mean_compile_ns(self) -> int:
        """Observed average per-compilation cost — the projection basis
        for admission when a job declares no estimate."""
        if self.total_compiles == 0:
            return 0
        return self.total_compile_ns // self.total_compiles
