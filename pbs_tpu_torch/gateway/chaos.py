"""The gateway chaos harnesses' shared arrival model.

The port of the part of ``pbs_tpu.gateway.chaos`` that the hardware
counter plane's serving pump (``hwtelem.fidelity.record_serving_window``)
drives: the admission contract per catalog tenant (:func:`quota_for`),
the seeded arrival streams (:func:`catalog_arrivals`,
:func:`draw_arrival`) and the pluggable :class:`ArrivalModel`, draw for
draw the reference's. The harnesses themselves (``run_gateway_chaos``,
``run_federation_chaos``) need the federation, the journal and the fault
plans of the gateway tier, which are ROADMAP queue 1 item 12; they
raise ``NotImplementedError`` naming that item (:data:`CHAOS_MISSING`).
"""

from __future__ import annotations

import numpy as np

from pbs_tpu_torch.gateway.admission import INTERACTIVE, TenantQuota
from pbs_tpu_torch.sim.workload import build_workload

__all__ = ["ArrivalModel", "build_workload", "catalog_arrivals",
           "draw_arrival", "quota_for", "run_federation_chaos",
           "run_gateway_chaos"]

CHAOS_MISSING = (
    "the gateway chaos harnesses need the federation, the write-ahead "
    "journal and the gateway fault plans, which are not ported (ROADMAP "
    "queue 1 item 12)")


def quota_for(tenant_name: str, slo: str, weight: int) -> TenantQuota:
    """Admission contract derived from a workload-catalog tenant:
    interactive tenants get high rate / small burst (latency traffic),
    batch tenants lower rate / big burst (throughput traffic)."""
    if slo == INTERACTIVE:
        return TenantQuota(rate=600.0, burst=60.0, weight=weight,
                           slo=slo, max_queued=64)
    return TenantQuota(rate=300.0, burst=120.0, weight=weight,
                       slo=slo, max_queued=128)


def catalog_arrivals(tenants, seed: int, tag: int) -> dict:
    """One independent seeded arrival stream per catalog tenant
    (``tag`` separates the harnesses' stream families)."""
    return {t.name: np.random.default_rng([int(seed), int(tag), i])
            for i, t in enumerate(tenants)}


def draw_arrival(t, rng) -> tuple[bool, int]:
    """This tick's (fire, cost) for one tenant — the shared arrival
    model the reference's chaos harnesses pin goldens on (interactive:
    frequent small requests; batch: rare big ones). Draw ORDER is part
    of the determinism contract: the cost is drawn whether or not it
    fires."""
    u = float(rng.random())
    if t.slo == INTERACTIVE:
        return u < 0.35, 1 + int(rng.integers(0, 3))
    return u < 0.15, 4 + int(rng.integers(0, 9))


class ArrivalModel:
    """Pluggable per-tick arrival shape (the harnesses' ``arrival_model=``).
    The default is :func:`draw_arrival`; a custom model owns its
    tenants' rng streams and MUST consume a fixed number of draws per
    ``draw`` call so its decision stream is a pure function of the
    seed. ``note_result`` closes the loop for reactive shapes (retry
    storms re-submitting after a shed)."""

    def draw(self, t, tick: int, rng) -> tuple[bool, int]:
        return draw_arrival(t, rng)

    def note_result(self, tenant: str, tick: int,
                    admitted: bool) -> None:
        pass


def run_gateway_chaos(*_args, **_kw):
    raise NotImplementedError(CHAOS_MISSING)


def run_federation_chaos(*_args, **_kw):
    raise NotImplementedError(CHAOS_MISSING)
