"""Static invariant checker suite (``pbst check``).

See docs/ANALYSIS.md for the checker list, suppression syntax, and how
to add a pass. Import surface mirrors the other subsystems: the
framework types, the suite registry, and the entry points the CLI and
tests drive.

The port of ``pbs_tpu.analysis``, pure AST like the reference: it
imports neither torch, nor JAX, nor ``pbs_tpu``, so ``pbst-torch check``
runs on a host with no device runtime. Passes, rule ids, messages and
order are the reference's; the departures (the package anchor,
``runtime/csrc/`` for the reference's C directory, the default paths)
are listed in each module.
"""

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    CSourceFile,
    Finding,
    Pass,
    SourceFile,
)
from pbs_tpu_torch.analysis.runner import (
    ALL_PASSES,
    CheckResult,
    changed_check_files,
    changed_py_files,
    check_paths,
    format_human,
    iter_check_files,
    iter_py_files,
    list_suppressions,
    load_dynamic_graph,
    pass_ids,
)

__all__ = [
    "ALL_PASSES",
    "CheckContext",
    "CheckResult",
    "CSourceFile",
    "Finding",
    "Pass",
    "SourceFile",
    "changed_check_files",
    "changed_py_files",
    "check_paths",
    "format_human",
    "iter_check_files",
    "iter_py_files",
    "list_suppressions",
    "load_dynamic_graph",
    "pass_ids",
]
