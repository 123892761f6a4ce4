"""Shadow replay + candidate search: the background-sim half of the
autopilot loop (docs/AUTOPILOT.md).

The port of ``pbs_tpu.autopilot.shadow``: for the same window the
replay report and the proposal are the reference's, key for key.

Two instruments over a captured :class:`~pbs_tpu_torch.autopilot.recorder
.ShadowWindow`:

- :func:`replay_window` — re-schedule the captured traffic through a
  fresh, stand-alone serving stack (Gateway + SimServeBackends on a
  virtual clock). Deterministic by construction: the window IS the
  workload, every noise source is a seeded generator, every float in
  the report is pre-rounded — so replaying the same window twice is
  byte-identical, and replaying a window captured from an identically
  configured gateway reproduces its admission/completion counts
  exactly (the record→replay roundtrip test pins both). ``knob_values``
  arms the member profile model, so "what would this window have
  looked like under candidate C" is a measurable what-if.
- :func:`shadow_search` — the candidate proposer: classify the window
  into a tuned workload class, run the ``sched/tune`` successive-
  halving search over that class (the tuned-profile space), then score
  the winner HEAD-TO-HEAD against the live config on one paired grid
  (``tune.evaluate_params``: cell seeds derive from workload identity
  only, so live and candidate replay the identical realization and
  the margin is pure policy signal). The proposal's base seed derives
  from the window digest — the whole search is a pure function of the
  captured traffic.

The canary controller (autopilot/canary.py) consumes the proposal; a
candidate only ever reaches production through its guarded rollout.
"""

from __future__ import annotations

import numpy as np

from pbs_tpu_torch.autopilot.recorder import ShadowWindow
from pbs_tpu_torch.gateway.admission import TenantQuota
from pbs_tpu_torch.gateway.backends import SimServeBackend
from pbs_tpu_torch.gateway.gateway import Gateway
from pbs_tpu_torch.knobs.profile import PARAM_KNOBS, knobs_to_params
from pbs_tpu_torch.sched import tune
from pbs_tpu_torch.sim.sweep import seed_from_digest
from pbs_tpu_torch.utils.clock import MS, VirtualClock


def window_seed(window: ShadowWindow, salt: int = 0) -> int:
    """Base seed derived from the capture itself (the sweep seed
    space): the shadow search is a pure function of the recorded
    traffic (same window ⇒ same candidate), independent of wall clock
    or host."""
    return seed_from_digest(window.digest(), salt)


def reference_params(policy: str = "feedback") -> dict:
    """The reference profile as constructor params: the registry's
    declared defaults mapped through the profile bijection — what the
    tree ships, and what a rollback restores."""
    from pbs_tpu_torch.knobs import registry

    return knobs_to_params(policy, {
        k: registry.default(k) for k in PARAM_KNOBS[policy].values()})


# -- window replay -----------------------------------------------------------


def replay_window(window: ShadowWindow, seed: int = 0,
                  n_backends: int = 2, slots_per_backend: int = 2,
                  service_ns_per_cost: int = 3 * MS,
                  tick_ns: int = 1 * MS,
                  knob_values: dict | None = None,
                  switch_cost_ns: int = 0,
                  max_queued: int | None = None) -> dict:
    """Re-schedule a captured window through a stand-alone gateway sim;
    returns the byte-stable report (ints and pre-rounded floats only).

    The replay shape mirrors one federation member (the chaos
    harness's member geometry is the default); ``knob_values`` +
    ``switch_cost_ns`` arm the serving profile model exactly as a
    member adopting those knobs would (``Gateway.apply_member_knobs``),
    so candidate what-ifs and live members speak the same model."""
    clock = VirtualClock()
    backends = [
        SimServeBackend(f"sb{i}", n_slots=slots_per_backend,
                        service_ns_per_cost=service_ns_per_cost,
                        seed=int(seed) * 1009 + i)
        for i in range(max(1, int(n_backends)))
    ]
    n_tenants = max(1, len(window.tenants))
    gw = Gateway(backends, clock=clock,
                 max_queued=(max_queued if max_queued is not None
                             else 64 * n_tenants),
                 name="shadow")
    for tenant, m in sorted(window.tenants.items()):
        gw.register_tenant(tenant, TenantQuota(
            rate=m["rate"], burst=m["burst"], weight=m["weight"],
            slo=m["slo"], max_queued=m["max_queued"]), now_ns=0)
    if knob_values and switch_cost_ns > 0:
        gw.profile_switch_cost_ns = int(switch_cost_ns)
        gw.apply_member_knobs(dict(knob_values), dict(knob_values))

    horizon = max(int(window.t1_ns) - int(window.t0_ns), 1)
    n_ticks = -(-horizon // int(tick_ns))  # ceil
    arrivals = window.arrivals
    ai, n_arrivals = 0, len(arrivals)
    admitted = completed = shed = 0
    per_tenant: dict[str, dict[str, int]] = {
        t: {"admitted": 0, "completed": 0, "shed": 0}
        for t in sorted(window.tenants)}

    def _bump(tenant: str, key: str) -> None:
        row = per_tenant.get(tenant)
        if row is None:
            row = per_tenant[tenant] = {"admitted": 0, "completed": 0,
                                        "shed": 0}
        row[key] += 1

    for k in range(n_ticks):
        end = (k + 1) * int(tick_ns)
        while ai < n_arrivals and arrivals[ai][0] < end:
            _, tenant, cls, cost = arrivals[ai]
            r = gw.submit(tenant, None, cost=cost, slo=cls)
            if r.admitted:
                admitted += 1
                _bump(tenant, "admitted")
            else:
                shed += 1
                _bump(tenant, "shed")
            ai += 1
        for rid, info in gw.tick():
            completed += 1
            _bump(info["tenant"], "completed")
        clock.advance(int(tick_ns))

    # Drain (bounded): the captured window must account completely.
    for _ in range(max(64, n_ticks * 8)):
        if not gw.busy():
            break
        for rid, info in gw.tick():
            completed += 1
            _bump(info["tenant"], "completed")
        clock.advance(int(tick_ns))

    tenants_out = {}
    for tenant in sorted(per_tenant):
        m = window.tenants.get(tenant, {})
        cls = m.get("slo", "batch")
        tenants_out[tenant] = {
            **per_tenant[tenant],
            "e2e_p50_ns": gw.hist.quantile(tenant, cls, "e2e", 0.50),
            "e2e_p99_ns": gw.hist.quantile(tenant, cls, "e2e", 0.99),
        }
    return {
        "window_digest": window.digest(),
        "seed": int(seed),
        "arrivals": n_arrivals,
        "admitted": admitted,
        "completed": completed,
        "shed": shed,
        "drained": not gw.busy(),
        "tenants": tenants_out,
    }


# -- workload classification -------------------------------------------------


def classify_window(window: ShadowWindow) -> str:
    """Map a captured window onto the tuned workload class whose
    profile space the candidate search explores. First-order and
    deterministic (documented in docs/AUTOPILOT.md):

    - interactive-dominated traffic (≥ 75 % of arrivals) with bursty
      inter-arrivals (CV > 1.0) → ``serving``; steadier → ``stable``
    - batch-dominated traffic (≤ 25 % interactive) → ``contended``
      (sustained heavyweight work is the shrink-pressure class)
    - anything in between → ``mixed``

    An empty window is ``mixed`` (the widest profile).
    """
    arr = window.arrivals
    if not arr:
        return "mixed"
    n = len(arr)
    inter = sum(1 for _, _, cls, _ in arr if cls == "interactive")
    frac = inter / n
    ts = np.diff(np.array([t for t, _, _, _ in arr], dtype=np.int64))
    ts = ts[ts > 0]
    cv = (float(ts.std() / ts.mean()) if len(ts) and ts.mean() > 0
          else 0.0)
    if frac >= 0.75:
        return "serving" if cv > 1.0 else "stable"
    if frac <= 0.25:
        return "contended"
    return "mixed"


# -- candidate search --------------------------------------------------------


def shadow_search(window: ShadowWindow, live_params: dict | None = None,
                  policy: str = "feedback", quick: bool = True,
                  workers: int = 1, base_seed: int | None = None) -> dict:
    """Propose a candidate for a captured window; returns the proposal
    (all scores x1e6 ints — byte-stable). ``live_params`` is the
    config production currently runs (default: the reference profile);
    the ``margin_x1e6`` is candidate-minus-live on one paired grid, so
    a candidate only clears the rollout gate by beating the live
    config on the identical workload realization."""
    wl = classify_window(window)
    digest = window.digest()  # once: a full ring is a real hash
    if base_seed is None:
        base_seed = seed_from_digest(digest)
    live = dict(live_params) if live_params else reference_params(policy)
    space = (tune.QUICK_SPACE if quick else tune.SEARCH_SPACE)[policy]
    rungs = tune.QUICK_RUNGS if quick else tune.RUNGS
    frontier = tune.successive_halving(
        wl, policy=policy, configs=space, rungs=rungs,
        base_seed=base_seed, workers=workers)
    candidate = dict(frontier["winner"]["params"])
    live_score, cand_score = tune.evaluate_params(
        wl, policy, [live, candidate], base_seed=base_seed,
        workers=workers)
    return {
        "workload": wl,
        "policy": policy,
        "base_seed": int(base_seed),
        "window_digest": digest,
        "arrivals": len(window.arrivals),
        "candidate": candidate,
        "live": live,
        "candidate_score_x1e6": int(round(cand_score * 1e6)),
        "live_score_x1e6": int(round(live_score * 1e6)),
        "margin_x1e6": int(round((cand_score - live_score) * 1e6)),
    }
