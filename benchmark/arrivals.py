"""The one generator of serving traffic: an open loop read from a
traffic file's parameters.

Every seed gets the same multiset of request sizes and of gaps between
arrivals, drawn once from the file's ``size_seed``; the run's seed
orders them and draws the prompts' token ids. So seeds change which
request comes when and what it says, never how much work a window
holds.
"""

from __future__ import annotations

import math

import numpy as np


def _lognormal(rng, p: dict, n: int) -> np.ndarray:
    x = np.exp(rng.normal(math.log(p["median"]), p["sigma"], n))
    return np.clip(np.rint(x), p["min"], p["max"]).astype(np.int64)


def open_loop(spec: dict, rate_per_s: float, seconds: float, seed: int,
              vocab: int) -> list[dict]:
    """Requests due in [0, seconds): dicts with ``i``, ``due_s`` (from
    the window's start), ``prompt`` (int32 ids) and ``max_new``."""
    base = np.random.default_rng(spec["size_seed"])
    pool = int(rate_per_s * seconds * 2) + 64
    gaps = base.exponential(1.0 / rate_per_s, pool)
    n = int(np.searchsorted(np.cumsum(gaps), seconds))
    gaps = gaps[:n]
    plen = _lognormal(base, spec["prompt_tokens"], n)
    olen = _lognormal(base, spec["output_tokens"], n)
    rng = np.random.default_rng([int(seed), 0x0A11])
    gaps = rng.permutation(gaps)
    order = rng.permutation(n)
    due = np.cumsum(gaps)
    return [{"i": i, "due_s": float(due[i]),
             "prompt": rng.integers(0, vocab, int(plen[order[i]]),
                                    dtype=np.int32),
             "max_new": int(olen[order[i]])}
            for i in range(n)]
