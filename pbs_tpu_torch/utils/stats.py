"""Small shared statistics helpers (framework-free, import-anywhere).

The port's copy of ``pbs_tpu.utils.stats``, estimator for estimator.
One canonical nearest-rank percentile so every latency surface
(the serving engine's SLO stats, the simulator's wait quantiles)
reports the same estimator.
Nearest-rank is deliberate: it returns an observed sample (never an
interpolated value that no request experienced), which is what latency
SLOs are written against.
"""

from __future__ import annotations

import math
from typing import Iterable


def nearest_rank(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile: the ``ceil(q * n)``-th smallest sample
    (1-indexed), 0.0 for an empty input.

    The naive ``int(q * n)`` index over-shoots by one rank (p50 of two
    samples would return the max); ``ceil(q * n) - 1`` is the standard
    definition — p50 of [1, 2] is 1, p99 of 1..100 is 99.

    Returns the sample element itself (int stays int — report surfaces
    serialize these, so the type must not drift).
    """
    v = sorted(values)
    if not v:
        return 0.0
    k = math.ceil(q * len(v)) - 1
    return v[max(0, min(len(v) - 1, k))]


def nearest_rank_sorted(sorted_values, q: float) -> float:
    """:func:`nearest_rank` over an ALREADY-SORTED sequence (list or 1-D
    numpy array) — the vectorized-consumer form: sort once, read many
    quantiles. Same estimator byte-for-byte; callers own the sort."""
    n = len(sorted_values)
    if n == 0:
        return 0.0
    k = math.ceil(q * n) - 1
    return float(sorted_values[max(0, min(n - 1, k))])
