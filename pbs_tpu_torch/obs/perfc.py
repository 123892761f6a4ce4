"""Software performance counters (perfc analog).

Reference: hypervisor-internal counters behind ``PERF_COUNTERS``
(``xen/common/perfc.c``), bumped with ``perfc_incr``, dumped via console
keys 'p'/'P' (``keyhandler.c:556-559``) and the ``xenperf`` CLI
(``tools/misc/xenperf.c``). Cheap unconditional counters for framework
internals, distinct from the per-job telemetry ledger.

The port of ``pbs_tpu.obs.perfc``: the same counter names land here
(``mem_claims``, ``paging_out_bytes``, ``weights_published``, ...),
behind a ``ProfiledLock`` as in the reference.
"""

from __future__ import annotations

import collections
from pbs_tpu_torch.obs.lockprof import ProfiledLock


class Perfc:
    def __init__(self):
        self._c: dict[str, int] = collections.defaultdict(int)
        self._lock = ProfiledLock("perfc")

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] += by

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def dump(self) -> dict[str, int]:
        """The 'p' console key / xenperf surface."""
        with self._lock:
            return dict(sorted(self._c.items()))

    def reset(self) -> None:
        """The 'P' console key: zero all counters."""
        with self._lock:
            self._c.clear()


#: Process-global instance (perfc is global in the hypervisor too).
perfc = Perfc()
