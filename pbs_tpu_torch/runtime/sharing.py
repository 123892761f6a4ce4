"""Shared immutable weights across tenants (the mem-sharing analog).

Reference: Xen memory sharing (``tools/memshr``,
``xen/arch/x86/mm/mem_sharing.c``) deduplicates identical pages across
domains down to one physical page, copy-on-write on modification —
density for fleets of near-identical guests. The port of
``pbs_tpu.runtime.sharing``: serving tenants of the SAME model each
carry gigabytes of identical weights, so N jobs reference ONE device
copy of the tensors. ``jax.Array`` is immutable by construction; a
``torch.Tensor`` is not, so immutability is the sharers' contract here:
a published set is read only (the serving and scoring paths never
write their weights; the training step updates its params in place and
so never shares them).

The registry refcounts named weight sets and charges their HBM ONCE
against a dedicated account, so the MemoryManager's admission math
prices a second same-model tenant at its PRIVATE state only (KV
cache, cursors) — the density win is visible to the claim system, not
just physically true.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from pbs_tpu_torch.obs.lockprof import ProfiledLock
from pbs_tpu_torch.obs.perfc import perfc
from pbs_tpu_torch.runtime.memory import nbytes_of
from pbs_tpu_torch.utils.tree import tree_leaves

#: Account-name prefix for shared sets (one account per set).
SHARED_PREFIX = "shared:"

# Every leaf of every PUBLISHED set, process-wide, keyed by id — the
# pager consults this to skip shared leaves (evicting a refcounted set
# through one tenant and restoring a private copy would break the
# dedup). The map holds STRONG references with a per-leaf count, so a
# registered id can never be recycled onto an unrelated object while
# it is in the map (id() reuse after gc was a real bug here).
_shared_leaves: dict[int, tuple[Any, int]] = {}
_shared_ids_lock = ProfiledLock("shared_leaves")


def is_shared_leaf(leaf: Any) -> bool:
    """True when ``leaf`` belongs to a currently-published shared
    weight set (any registry in this process)."""
    ent = _shared_leaves.get(id(leaf))
    return ent is not None and ent[0] is leaf


def _register_leaves(params: Any) -> None:
    with _shared_ids_lock:
        for leaf in tree_leaves(params):
            ent = _shared_leaves.get(id(leaf))
            _shared_leaves[id(leaf)] = (
                leaf, (ent[1] + 1) if ent is not None else 1)


def _unregister_leaves(params: Any) -> None:
    with _shared_ids_lock:
        for leaf in tree_leaves(params):
            ent = _shared_leaves.get(id(leaf))
            if ent is None:
                continue
            if ent[1] <= 1:
                del _shared_leaves[id(leaf)]
            else:
                _shared_leaves[id(leaf)] = (leaf, ent[1] - 1)


@dataclasses.dataclass
class SharedWeights:
    """Handle to one published weight set."""

    name: str
    params: Any  # read-only tree of tensors
    nbytes: int
    refs: int = 0


class WeightsRegistry:
    """Refcounted publication of immutable weight sets.

    With a :class:`MemoryManager`, the set's bytes are claimed once
    under ``shared:<name>`` at publish and released when the last
    reference drops — N sharers never multiply the bill.
    """

    def __init__(self, memory=None):
        self.memory = memory
        self._sets: dict[str, SharedWeights] = {}
        self._lock = ProfiledLock("weights_registry")

    def publish(self, name: str, params: Any) -> SharedWeights:
        """Register a weight set (claims its HBM once). Publishing an
        existing name is an error — immutability is the whole safety
        story, so sets are never silently replaced under readers."""
        with self._lock:
            if name in self._sets:
                raise ValueError(f"weight set {name!r} already published")
            nbytes = nbytes_of(params)
            if self.memory is not None:
                self.memory.open_account(SHARED_PREFIX + name)
                try:
                    self.memory.claim_or_balloon(SHARED_PREFIX + name,
                                                 nbytes)
                except BaseException:
                    self.memory.close_account(SHARED_PREFIX + name)
                    raise
            sw = SharedWeights(name, params, nbytes)
            self._sets[name] = sw
            _register_leaves(params)
            perfc.incr("weights_published")
            return sw

    def acquire(self, name: str) -> Any:
        """Take a reference; returns the params tree. Tenants hold
        the SAME tensors — zero copies, zero extra HBM."""
        with self._lock:
            sw = self._sets[name]
            sw.refs += 1
            perfc.incr("weights_acquired")
            return sw.params

    def release(self, name: str) -> int:
        """Drop a reference; at zero the set unpublishes and its HBM
        account closes. Returns remaining refs. Releasing a set with
        no outstanding references raises — an underflow means some
        tenant double-released while another may still hold the
        arrays, and silently closing the account would free HBM the
        ledger still needs to model (review finding)."""
        with self._lock:
            sw = self._sets[name]
            if sw.refs <= 0:
                raise ValueError(
                    f"release of {name!r} with no outstanding "
                    "references (double-release?)")
            sw.refs -= 1
            if sw.refs == 0:
                del self._sets[name]
                _unregister_leaves(sw.params)
                if self.memory is not None:
                    self.memory.close_account(SHARED_PREFIX + name)
                perfc.incr("weights_unpublished")
            return sw.refs

    def unpublish(self, name: str) -> None:
        """Publisher-side teardown of a set nobody acquired (refs must
        be zero — live sharers pin the set)."""
        with self._lock:
            sw = self._sets[name]
            if sw.refs > 0:
                raise ValueError(
                    f"cannot unpublish {name!r}: {sw.refs} live "
                    "reference(s)")
            del self._sets[name]
            _unregister_leaves(sw.params)
            if self.memory is not None:
                self.memory.close_account(SHARED_PREFIX + name)
            perfc.incr("weights_unpublished")

    def refs(self, name: str) -> int:
        with self._lock:
            sw = self._sets.get(name)
            return sw.refs if sw else 0

    def saved_bytes(self) -> int:
        """The mem-sharing headline: bytes deduplicated = what the
        CURRENT sharers would have cost privately, minus the one copy."""
        with self._lock:
            return sum(max(0, sw.refs - 1) * sw.nbytes
                       for sw in self._sets.values())

    def dump(self) -> dict:
        with self._lock:
            return {
                "sets": {
                    n: {"nbytes": sw.nbytes, "refs": sw.refs}
                    for n, sw in self._sets.items()
                },
                "saved_bytes": sum(
                    max(0, sw.refs - 1) * sw.nbytes
                    for sw in self._sets.values()),
            }
