"""HBM paging: evict parked tenants' device state to host memory.

Reference: xenpaging (``tools/xenpaging``) pages guest memory out to a
dom0 file under pressure and faults it back transparently on access —
the mechanism that lets more guests exist than RAM strictly allows.
The port of ``pbs_tpu.runtime.paging``. A job's state is only touched
at step boundaries and a BLOCKED job cannot be dispatched, so paging a
sleeping tenant is exact by construction — no dirty tracking, no fault
path, just whole-state eviction and restore. A parked tenant's
params/optimizer slabs are pure HBM cost; paging them means the card
multiplexes more tenants than fit in HBM simultaneously.

Two entry points:

- explicit: ``page_out_job``/``page_in_job`` (policy decisions, like
  ``xenpaging``'s target file size);
- automatic: ``register_paging_reclaim`` hooks a job into the
  MemoryManager's balloon path, so ``claim_or_balloon`` for a NEW
  tenant transparently pages out sleeping neighbors, biggest first —
  admission pressure is what xenpaging exists for.

Every tensor leaf of the state is paged (the reference pages every
``jax.Array``): a leaf on a CUDA device is copied into a pinned host
tensor, one on the CPU into a plain host copy. The copies of one
page-out run on the current stream of each leaf's device and are
waited for once, before any device tensor is dropped; a pinned
allocation that fails raises (the state is left as it was), never
falling back to pageable memory. Each leaf's device is recorded and
restored at page-in, where the host-to-device copies are queued on the
current stream, so they are ordered before the job's next kernel; only
a device that is gone falls back to the default one. HBM is freed only
if the job's state held the last reference to each tensor: the caller
keeps no other.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

from pbs_tpu_torch.obs.perfc import perfc
from pbs_tpu_torch.utils.tree import tree_flatten, tree_unflatten

if TYPE_CHECKING:
    from pbs_tpu_torch.runtime.job import Job
    from pbs_tpu_torch.runtime.partition import Partition


class PagingError(RuntimeError):
    pass


def _is_device_array(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor)


def _evict_state(state: Any) -> tuple[Any, list, int]:
    """(host_state_placeholder, paged_leaves, bytes_freed): tensor
    leaves become index markers; the paged list holds (host tensor,
    device) pairs for restore. Leaves belonging to a PUBLISHED shared
    weight set (runtime.sharing) are left in place: evicting a
    refcounted set through one tenant and restoring it as a private
    copy would silently break the dedup (and the tenant's account
    never paid for those bytes)."""
    from pbs_tpu_torch.runtime.sharing import is_shared_leaf

    leaves, treedef = tree_flatten(state)
    paged: list[tuple[torch.Tensor, torch.device]] = []
    out_leaves = []
    freed = 0
    cuda_devices: set[torch.device] = set()
    for leaf in leaves:
        if _is_device_array(leaf) and not is_shared_leaf(leaf):
            if leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                cuda_devices.add(leaf.device)
            else:
                host = leaf.detach().clone()
            freed += leaf.numel() * leaf.element_size()
            out_leaves.append(_PagedLeaf(len(paged)))
            paged.append((host, leaf.device))
        else:
            out_leaves.append(leaf)
    # The copies must land before anything reads the host tensors or
    # the caller drops the device ones.
    for dev in cuda_devices:
        torch.cuda.current_stream(dev).synchronize()
    return tree_unflatten(treedef, out_leaves), paged, freed


class _PagedLeaf:
    """Marker standing where a device array lived (never dispatched:
    the owning job is BLOCKED while paged)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self) -> str:  # surfaces clearly if ever leaked
        return f"<paged-out leaf #{self.index}>"


def _device_gone(device: torch.device) -> bool:
    return device.type == "cuda" and (
        not torch.cuda.is_available()
        or (device.index or 0) >= torch.cuda.device_count())


def _restore_state(state: Any, paged: list) -> Any:
    leaves, treedef = tree_flatten(state)
    out = []
    for leaf in leaves:
        if isinstance(leaf, _PagedLeaf):
            host, device = paged[leaf.index]
            if _device_gone(device):
                # ONLY the device-gone case falls back to default
                # placement (post-restart restore on a different
                # topology); any other copy failure — real HBM
                # exhaustion especially — must propagate so the job
                # stays asleep+paged instead of waking mislaid.
                device = torch.device(
                    "cuda" if torch.cuda.is_available() else "cpu")
            out.append(host.to(device, non_blocking=True))
        else:
            out.append(leaf)
    return tree_unflatten(treedef, out)


def _sleeping(job: "Job") -> bool:
    from pbs_tpu_torch.runtime.job import ContextState

    return {c.state for c in job.contexts} <= {
        ContextState.BLOCKED, ContextState.DONE, ContextState.FAILED}


def _do_page_out(job: "Job", pressure: bool,
                 acct_used: int | None = None) -> int:
    """Shared eviction body (explicit + balloon paths); the caller
    decides policy (raise vs skip) and accounting. ``acct_used`` (the
    job's CURRENT ledger balance, when accounting is on) bounds the
    re-claim at page-in: the account may hold less than the device
    bytes (declared mem_bytes, post-admission growth) and the round
    trip must not inflate it."""
    new_state, paged, freed = _evict_state(job.state)
    if freed == 0:
        return 0
    job.state = new_state
    job.paged = paged
    job.paged_bytes = freed
    job.paged_acct_bytes = (freed if acct_used is None
                            else min(freed, acct_used))
    perfc.incr("paging_out_bytes", freed)
    job.console.write(
        f"paged out{' under pressure' if pressure else ''}: "
        f"{freed} bytes to host")
    return freed


def page_out_job(partition: "Partition", job: "Job") -> int:
    """Evict ``job``'s device state to host memory; returns bytes
    freed. The job must be asleep (BLOCKED) — it is un-runnable until
    :func:`page_in_job` (which ``Partition.wake_job`` invokes
    automatically). Idempotent: paging a paged job frees 0."""
    if getattr(job, "paged", None) is not None:
        return 0
    if not _sleeping(job):
        raise PagingError(
            f"job {job.name!r} is runnable; sleep it before paging "
            "(a dispatched paged state would fault)")
    acct_used = None
    if partition.memory is not None:
        acct_used = partition.memory.account(job.name).used_bytes
    freed = _do_page_out(job, pressure=False, acct_used=acct_used)
    if freed and partition.memory is not None:
        partition.memory.release(job.name, freed)
    return freed


def page_in_job(partition: "Partition", job: "Job") -> int:
    """Restore a paged job's device state (claiming its HBM back,
    ballooning/paging others if needed). Raises OutOfDeviceMemory when
    the chip genuinely cannot host it — the job stays paged+asleep."""
    paged = getattr(job, "paged", None)
    if paged is None:
        return 0
    nbytes = job.paged_bytes
    # Re-claim exactly what the ACCOUNT gave up at page-out (which may
    # be less than the device bytes) — claiming the device size would
    # inflate the ledger on every round trip (review finding).
    acct_bytes = getattr(job, "paged_acct_bytes", nbytes)
    if partition.memory is not None:
        # may balloon (and thereby page out) other sleeping tenants
        partition.memory.claim_or_balloon(job.name, acct_bytes)
    try:
        job.state = _restore_state(job.state, paged)
    except BaseException:
        if partition.memory is not None:
            partition.memory.release(job.name, acct_bytes)
        raise
    job.paged = None
    job.paged_bytes = 0
    job.paged_acct_bytes = 0
    perfc.incr("paging_in_bytes", nbytes)
    job.console.write(f"paged in: {nbytes} bytes to device")
    return nbytes


def register_paging_reclaim(partition: "Partition", job: "Job") -> None:
    """Hook ``job`` into the balloon path: under admission pressure,
    ``claim_or_balloon`` pages it out IF it is asleep at that moment
    (a runnable job reports 0 and the balloon moves on). The released
    accounting is handled by the balloon itself."""
    if partition.memory is None:
        raise PagingError("partition has no MemoryManager")

    def _reclaim(need: int) -> int:
        if getattr(job, "paged", None) is not None:
            return 0
        if not _sleeping(job):
            return 0  # running tenants are never paged out from under;
            # "nothing right now" is transient — balloon() skips this
            # call only, never unregisters the hook
        acct_used = partition.memory.account(job.name).used_bytes
        return _do_page_out(job, pressure=True,
                            acct_used=acct_used)  # balloon() releases

    partition.memory.register_reclaim(job.name, _reclaim)
