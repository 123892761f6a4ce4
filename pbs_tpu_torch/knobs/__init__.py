"""pbs_tpu_torch.knobs: the typed knob registry and its hot-reload.

The port of ``pbs_tpu.knobs``:

- ``registry``: the declarations (name, kind, unit, safe range,
  default, subsystem, native ABI symbol) and the process-local live
  overlay, stdlib only;
- ``channel``: the file-backed seqlock transport with all-or-nothing
  pushes, byte for byte the reference's file layout, and
  ``KnobWatcher``;
- ``profile``: tuned profiles as knob documents.

Module-level tunable constants derive from ``knobs.default(...)``;
live consumers read ``knobs.get(...)`` or subscribe through
``channel.KnobWatcher``.
"""

from pbs_tpu_torch.knobs.registry import (  # noqa: F401
    BAND_PAIRS,
    Knob,
    KnobError,
    all_knobs,
    check_value,
    default,
    exists,
    get,
    knob,
    names,
    reset_local,
    schema,
    set_local,
    snapshot,
    validate_set,
)

__all__ = [
    "BAND_PAIRS", "Knob", "KnobError", "all_knobs", "check_value",
    "default", "exists", "get", "knob", "names", "reset_local",
    "schema", "set_local", "snapshot", "validate_set",
]
