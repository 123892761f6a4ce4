"""Observability dump artifact: the sysctl-read seam for CLIs.

The port of ``pbs_tpu.obs.dumpfile``. Reference: ``xenperf`` and
``xenlockprof`` read hypervisor-internal counters through sysctl
hypercalls (``tools/misc/xenperf.c``, ``tools/misc/xenlockprof.c``).
Our CLIs attach to artifacts rather than a live daemon (same decoupling
as xentop over shared pages), so the producing process publishes a JSON
snapshot of its software counters, lock profile, lock-order graph and
effective boot params; ``pbst-torch perfc`` / ``lockprof`` / ``lockdep``
/ ``params`` format it. The file has the reference's JSON shape, so
either package's commands read the other's dump.
"""

from __future__ import annotations

import json
import os

from pbs_tpu_torch.obs import lockdep, lockprof
from pbs_tpu_torch.obs.perfc import perfc
from pbs_tpu_torch.utils import params


def write_obs_dump(path: str) -> dict:
    """Snapshot perfc + lockprof + lockdep + params to ``path``
    (atomic rename)."""
    snap = {
        "perfc": perfc.dump(),
        "lockprof": lockprof.dump(),
        "lockdep": lockdep.dump(),
        "params": params.dump(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f)
    os.replace(tmp, path)
    return snap


def read_obs_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
