"""Small shared statistics helpers (framework-free, import-anywhere).

The port's copy of ``pbs_tpu.utils.stats``, estimator for estimator.
One canonical nearest-rank percentile so every latency surface
(the serving engine's SLO stats) reports the same estimator.
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
