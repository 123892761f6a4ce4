"""Cross-language shared-memory protocol checkers (``pbst check``).

Every production layer since the telemetry ledger rides the same
file-backed seqlock protocol, implemented twice: numpy/``struct`` in
Python and ``__atomic_*`` discipline in C (runtime/csrc/pbst_runtime.cc).
The only guard used to be after-the-fact golden digests; these passes
make the memory model *statically checkable* the way the knob registry
made tunables checkable:

- :class:`SeqlockDisciplinePass` — the write/read protocol over
  ``runtime/csrc/*.cc`` (release-ordered odd/even version brackets, acquire
  retry loops, publish-after-payload ring heads) plus the Python
  mirror (no raw writes to seqlock-backed buffers outside the
  sanctioned writer modules).
- :class:`AbiLayoutDriftPass` — slot word counts, magic/ABI versions
  and field offsets diffed across the language boundary, ctypes
  binding arity cross-checked against the C prototypes, and hardcoded
  layout literals flagged — a word added on one side is a finding,
  not a torn read in production.
- :class:`DeterminismDisciplinePass` — wall-clock reads, unseeded RNG
  construction and set-iteration-order dependence inside the
  digest-covered subsystems ("same seed, same digest" is the repo
  contract; goldens only catch the bug after it ships).

See docs/ANALYSIS.md for rule tables and fix hints.

The port of ``pbs_tpu.analysis.memmodel``. Departure:
``CROSS_LANG_PY_ANCHORS`` name ``pbs_tpu_torch/...`` (git-toplevel-
relative), and the C side is ``runtime/csrc/*.cc``.
"""

from pbs_tpu_torch.analysis.memmodel.abipass import AbiLayoutDriftPass
from pbs_tpu_torch.analysis.memmodel.detpass import DeterminismDisciplinePass
from pbs_tpu_torch.analysis.memmodel.seqlockpass import SeqlockDisciplinePass

#: Python modules the cross-language passes diff C layout against.
#: ``pbst check --changed`` pulls these into the scan set whenever a
#: .cc file changed, so an ABI edit is checked against its mirrors
#: even in incremental mode (paths are git-toplevel-relative).
CROSS_LANG_PY_ANCHORS = (
    "pbs_tpu_torch/telemetry/counters.py",
    "pbs_tpu_torch/telemetry/ledger.py",
    "pbs_tpu_torch/obs/trace.py",
    "pbs_tpu_torch/runtime/doorbell.py",
    "pbs_tpu_torch/runtime/native.py",
    "pbs_tpu_torch/sim/native_core.py",
    "pbs_tpu_torch/knobs/channel.py",
    "pbs_tpu_torch/gateway/journal.py",
)

__all__ = [
    "AbiLayoutDriftPass",
    "CROSS_LANG_PY_ANCHORS",
    "DeterminismDisciplinePass",
    "SeqlockDisciplinePass",
]
