"""Device-memory accounting: the byte size of a parameter tree.

The port of ``pbs_tpu.runtime.memory``'s :func:`nbytes_of`, which the
int8 serving bill (``models.quant.quantized_nbytes``) delegates to. The
rest of the reference module (``device_memory_stats``, the
``MemoryManager`` with its per-job accounts, claims and balloon
callbacks, and the partition's memory admission) is not ported yet:
ROADMAP queue 1, item 4.
"""

from __future__ import annotations

from typing import Any

import torch


def nbytes_of(tree: Any) -> int:
    """Device-byte estimate of a nested dict/list/tuple of tensors:
    ``numel() * element_size()`` per tensor; None and scalars are free."""
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
