"""Gateway backends: where admitted requests actually execute.

A copy of ``pbs_tpu.gateway.backends``. A backend is anything that
accepts a dispatched :class:`~pbs_tpu_torch.gateway.fairqueue.Request`
and later reports it finished. The gateway only ever talks to this
surface — ``dispatch_request`` / ``poll`` / ``drain`` — so the same
admission/fairness/routing stack fronts the port's
:class:`~pbs_tpu_torch.models.serving.ContinuousBatcher` (on the card
or the CPU), a simulated service (tests), or, later, a remote agent.

The drain contract is the "no admitted request is ever lost" half the
router depends on: a dying backend must hand back every request it has
not completed, and the gateway requeues them at the front of the fair
queue. ``BatcherBackend`` additionally installs the engine's
``submit_hook`` to count submissions that did NOT come through the
gateway — the runtime twin of the static ``gateway-discipline`` pass
(docs/ANALYSIS.md): bypass traffic is invisible to admission and
fairness, so it is surfaced as a stat instead of silently tolerated.
"""

from __future__ import annotations

import zlib
from collections import deque

import numpy as np

from pbs_tpu_torch.gateway.fairqueue import Request
from pbs_tpu_torch.utils.clock import MS


class Backend:
    """Duck-typed base; subclasses override the four verbs."""

    name: str = "backend"
    capacity: int = 1  # concurrent requests before queueing inside
    #: Span seam (docs/TRACING.md): the gateway's recorder wiring sets
    #: this to ``(request, now_ns) -> None``; backends call it when a
    #: dispatched request actually STARTS executing (enters a run slot
    #: / the engine), distinguishing backend-internal queueing from
    #: execution on the request's timeline. None = spans off.
    exec_hook = None
    #: Intra-backend stage handoff seam (docs/SERVING.md): set by the
    #: same span wiring to ``(request, now_ns, from_member, to_member)
    #: -> None``; a staged backend (prefill/decode disaggregation)
    #: calls it when a request moves between its internal pools, so
    #: the request keeps ONE stitched span chain (SPAN_HANDOFF + an
    #: internal re-DISPATCH). None = spans off or single-stage backend.
    handoff_hook = None

    def alive(self) -> bool:
        return True

    def depth(self) -> int:
        """Requests inside the backend (running + backend-queued)."""
        raise NotImplementedError

    def dispatch_request(self, req: Request, now_ns: int) -> None:
        raise NotImplementedError

    def poll(self, now_ns: int) -> list[tuple[Request, dict]]:
        """Completions since the last poll: (request, info) pairs."""
        raise NotImplementedError

    def drain(self) -> list[Request]:
        """Hand back every uncompleted dispatched request (backend
        loss path). Must leave the backend empty of gateway work."""
        raise NotImplementedError


class SimServeBackend(Backend):
    """Deterministic simulated backend (virtual or real clock).

    ``n_slots`` requests run concurrently; service time is
    ``cost * service_ns_per_cost`` with seeded multiplicative jitter —
    the same determinism contract as the sim workload catalog (all
    noise from a per-backend ``np.random.Generator``).
    """

    def __init__(self, name: str, n_slots: int = 2,
                 service_ns_per_cost: int = 2 * MS, jitter: float = 0.1,
                 seed: int = 0):
        self.name = name
        self.capacity = int(n_slots)
        self.service_ns_per_cost = int(service_ns_per_cost)
        self.jitter = float(jitter)
        #: Live service-time multiplier (the canary's member profile
        #: model): adopting a knob profile re-rates service by a
        #: declared first-order switch-overhead factor. 1.0 (the
        #: default) is bit-identical to the pre-scale
        #: backend — multiplying by 1.0 is an IEEE identity, and the
        #: jitter stream is drawn before the scale applies.
        self.service_scale = 1.0
        # crc32, not hash(): str hashing is salted per process and
        # would silently reseed every run (the injector's rule).
        self._rng = np.random.default_rng(
            [int(seed), zlib.crc32(name.encode())])
        self._alive = True
        self._running: list[tuple[int, int, Request]] = []  # (t_done, t0, r)
        self._waiting: deque[Request] = deque()
        self.completed = 0

    def alive(self) -> bool:
        return self._alive

    def fail(self) -> None:
        self._alive = False

    def set_service_scale(self, scale: float) -> None:
        """The knob-profile seam the gateway's member adoption calls
        (``Gateway.apply_member_knobs``); applies to dispatches from
        now on — in-flight requests keep their scheduled completion."""
        self.service_scale = max(1e-3, float(scale))

    def depth(self) -> int:
        return len(self._running) + len(self._waiting)

    def _service_ns(self, req: Request) -> int:
        j = 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        return max(1, int(req.cost * self.service_ns_per_cost * j
                          * self.service_scale))

    def _fill(self, now_ns: int) -> None:
        while self._waiting and len(self._running) < self.capacity:
            req = self._waiting.popleft()
            self._running.append(
                (now_ns + self._service_ns(req), now_ns, req))
            if self.exec_hook is not None:
                self.exec_hook(req, now_ns)

    def dispatch_request(self, req: Request, now_ns: int) -> None:
        if not self._alive:
            raise RuntimeError(f"backend {self.name} is dead")
        self._waiting.append(req)
        self._fill(now_ns)

    def poll(self, now_ns: int) -> list[tuple[Request, dict]]:
        if not self._alive:
            return []
        # service_ns is the scheduled completion minus start — exact,
        # not rounded up to the poll tick that happened to observe it.
        done = [(r, {"service_ns": t_done - t0, "backend": self.name})
                for t_done, t0, r in self._running if t_done <= now_ns]
        if done:
            finished = {r.rid for r, _ in done}
            self._running = [x for x in self._running
                             if x[2].rid not in finished]
            self.completed += len(done)
        self._fill(now_ns)
        return done

    def drain(self) -> list[Request]:
        out = [r for _, _, r in self._running] + list(self._waiting)
        self._running = []
        self._waiting.clear()
        return out


class BatcherBackend(Backend):
    """A :class:`ContinuousBatcher` (or :class:`SpeculativeBatcher`)
    behind the gateway surface. Duck-typed on purpose — this module
    imports no torch; the engine arrives already constructed, on
    whatever device it was built for.

    ``poll`` advances the engine one tick (``engine.step()``), so the
    gateway pump *is* the serving loop: one gateway tick = one decode
    token across slots, the same quantum-sized unit
    ``make_continuous_serve_step`` exposes to the scheduler.

    Request payloads: ``{"prompt": <tokens>, "max_new": <int>}``.
    """

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine
        self.capacity = int(engine.n_slots)
        self._by_engine_rid: dict[int, Request] = {}
        #: Engine submissions that did not come through dispatch_request
        #: — admission/fairness bypasses (the gateway-discipline stat).
        self.bypass_submits = 0
        self._dispatching = False
        self._dispatching_req: tuple[Request, int] | None = None
        prev_hook = getattr(engine, "submit_hook", None)

        def _hook(rid: int, prompt_len: int, max_new: int) -> None:
            if not self._dispatching:
                self.bypass_submits += 1
            elif (self.exec_hook is not None
                    and self._dispatching_req is not None):
                # Span execution attribution rides the same engine
                # submit_hook seam the bypass counter uses: a gateway
                # dispatch that reached engine.submit has entered the
                # execution pipeline (prefill queue), which is this
                # backend's observable "execution begins".
                self.exec_hook(*self._dispatching_req)
            if prev_hook is not None:
                prev_hook(rid, prompt_len, max_new)

        engine.submit_hook = _hook

    def alive(self) -> bool:
        return True

    def depth(self) -> int:
        return len(self.engine.queue) + int(self.engine.active.sum())

    def dispatch_request(self, req: Request, now_ns: int) -> None:
        self._dispatching = True
        self._dispatching_req = (req, now_ns)
        try:
            erid = self.engine.submit(req.payload["prompt"],
                                      int(req.payload["max_new"]))
        finally:
            self._dispatching = False
            self._dispatching_req = None
        self._by_engine_rid[erid] = req

    def poll(self, now_ns: int) -> list[tuple[Request, dict]]:
        if not self.engine.has_work():
            return []
        out: list[tuple[Request, dict]] = []
        for comp in self.engine.step():
            req = self._by_engine_rid.pop(comp.request_id, None)
            if req is None:
                continue  # a bypass submission's completion: not ours
            out.append((req, {
                "service_ns": int(comp.latency_s * 1e9),
                "ttft_ns": int(comp.ttft_s * 1e9),
                "tokens": len(comp.tokens),
                "backend": self.name,
            }))
        return out

    def drain(self) -> list[Request]:
        """Pull back gateway requests still in the ENGINE QUEUE (not
        yet prefilled). Requests already occupying slots cannot be
        detached from a live engine mid-decode; they complete via
        ``poll`` as usual."""
        out: list[Request] = []
        kept = deque()
        for item in self.engine.queue:
            req = self._by_engine_rid.pop(item[0], None)
            if req is not None:
                out.append(req)
            else:
                kept.append(item)
        self.engine.queue = kept
        return out
