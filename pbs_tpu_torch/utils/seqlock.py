"""The seqlock readers' retry schedule, shared by the telemetry ledger
(``Ledger.snapshot``/``snapshot_many``) and the knob channel
(``KnobChannel.snapshot``).

A version word that stays odd is a writer mid-write, and under the GIL
that writer may sit preempted between its odd and even stores for a
switch interval or more. The reader yields between attempts and waits
for it, bounded by time: only a version held odd (or torn) for
``SNAPSHOT_WAIT_S`` raises. The reference bounds the same loop by a
spin count (its readers' ``max_retries``); the values read and the
errors raised are its own.
"""

from __future__ import annotations

import time

SNAPSHOT_WAIT_S = 0.5


def read_attempts(wait_s: float = SNAPSHOT_WAIT_S):
    """Yield once per read attempt until ``wait_s`` has passed since the
    first one, giving up the GIL (``time.sleep(0)``) between attempts
    so that a preempted writer runs to its closing store."""
    yield
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        time.sleep(0)
        yield
