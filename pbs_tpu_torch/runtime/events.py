"""Event channels: async doorbell signaling (event_channel.c analog).

Reference: Xen event channels (``xen/common/event_channel.c``) are the
async signaling fabric — interdomain doorbells, virtual IRQs
(``VIRQ_PERFCTR`` 13 added at ``public/xen.h:163``, delivered to the
guest's perfctr driver via ``send_guest_vcpu_virq``,
``pmustate.c:66-80``), and IPIs. Binding is by port; notification is
edge-triggered (pending bit), delivery is a callback.

Here: a per-partition EventBus with ports, VIRQ-style well-known
events, edge-triggered pending semantics (multiple sends before a
dispatch coalesce — exactly like the evtchn pending bit), masking, and
delivery either synchronous (sim determinism) or via the run loop
(``deliver_pending`` is called by the partition between quanta).
"""

from __future__ import annotations

import enum
from typing import Callable


class Virq(enum.IntEnum):
    """Well-known virtual interrupts (public/xen.h VIRQ_*)."""

    TELEMETRY = 13  # VIRQ_PERFCTR: counter overflow / telemetry event
    TRACE = 4  # VIRQ_TBUF: trace ring passed threshold
    WATCHDOG = 17  # job heartbeat missed
    CKPT_DONE = 32  # checkpoint epoch finished
    JOB_DONE = 33
    JOB_FAILED = 34  # fault contained to a job (MCE containment)


class EventChannel:
    __slots__ = ("port", "handler", "pending", "masked", "sends", "deliveries")

    def __init__(self, port: int, handler: Callable[[int], None]):
        self.port = port
        self.handler = handler
        self.pending = False
        self.masked = False
        self.sends = 0
        self.deliveries = 0


class EventBus:
    def __init__(self, synchronous: bool = False):
        """synchronous=True delivers at send time (deterministic sim);
        False coalesces until deliver_pending() (run-loop delivery)."""
        self.synchronous = synchronous
        self._channels: dict[int, EventChannel] = {}
        self._next_port = 64  # low ports reserved for VIRQs
        # Send-time taps: observe EVERY signal without occupying a port
        # (the doorbell bridge rides here — an interrupt is raised at
        # send, independent of in-process binding/masking/delivery).
        self._taps: list[Callable[[int], None]] = []

    def add_tap(self, fn: Callable[[int], None]) -> None:
        self._taps.append(fn)

    def remove_tap(self, fn: Callable[[int], None]) -> None:
        if fn in self._taps:
            self._taps.remove(fn)

    # -- binding (evtchn_bind_* analogs) ---------------------------------

    def bind(self, handler: Callable[[int], None], port: int | None = None) -> int:
        if port is None:
            while self._next_port in self._channels:
                self._next_port += 1
            port = self._next_port
            self._next_port += 1
        if port in self._channels:
            raise ValueError(f"port {port} already bound")
        self._channels[port] = EventChannel(port, handler)
        return port

    def bind_virq(self, virq: Virq, handler: Callable[[int], None]) -> int:
        return self.bind(handler, port=int(virq))

    def unbind(self, port: int) -> None:
        self._channels.pop(port, None)

    def mask(self, port: int, masked: bool = True) -> None:
        self._channels[port].masked = masked

    # -- signaling (evtchn_send / send_guest_vcpu_virq analogs) ----------

    def send(self, port: int) -> bool:
        for tap in self._taps:
            tap(port)  # fires even with no in-process subscriber
        ch = self._channels.get(port)
        if ch is None:
            return False
        ch.sends += 1
        ch.pending = True  # edge-triggered: repeat sends coalesce
        if self.synchronous and not ch.masked:
            self._deliver(ch)
        return True

    def send_virq(self, virq: Virq) -> bool:
        return self.send(int(virq))

    # -- delivery --------------------------------------------------------

    def _deliver(self, ch: EventChannel) -> None:
        ch.pending = False
        ch.deliveries += 1
        ch.handler(ch.port)

    def deliver_pending(self) -> int:
        """Dispatch all pending unmasked channels; returns count."""
        n = 0
        for ch in list(self._channels.values()):
            if ch.pending and not ch.masked:
                self._deliver(ch)
                n += 1
        return n

    def dump(self) -> list[dict]:
        return [
            {
                "port": ch.port,
                "pending": ch.pending,
                "masked": ch.masked,
                "sends": ch.sends,
                "deliveries": ch.deliveries,
            }
            for ch in sorted(self._channels.values(), key=lambda c: c.port)
        ]
