"""Device-memory accounting: per-job HBM budgets (page_alloc analog).

The port of ``pbs_tpu.runtime.memory``. Xen accounts every page to a
domain: ``max_pages`` caps a domain, ``tot_pages`` tracks usage, domain
builds *claim* pages up front so admission fails fast instead of
OOMing mid-boot, and the balloon driver reclaims guest memory
cooperatively under pressure. Here a :class:`MemoryManager` owns one
card's capacity; jobs open accounts with optional caps, *claim* their
working-set bytes at admission, and may register balloon callbacks the
manager invokes under pressure (``runtime.paging`` registers one that
pages a sleeping tenant's state out to host memory).

Live numbers come from the CUDA caching allocator where the reference
reads ``jax.Device.memory_stats()``: :func:`device_memory_stats` maps
``bytes_in_use`` to ``torch.cuda.memory_allocated(device)`` (the bytes
of live tensors; blocks the allocator caches for reuse are free to a
claim) and ``bytes_limit`` to the card's total memory
(``torch.cuda.mem_get_info(device)[1]``). A CPU device has no such
numbers: the result is ``{}``, as the reference's is on the CPU, and
only then does ``MemoryManager.for_device`` fall back to its 16 GiB
default. Estimates for a job come from the byte size of its state.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

from pbs_tpu_torch.obs.lockprof import ProfiledLock
from pbs_tpu_torch.obs.perfc import perfc


class OutOfDeviceMemory(MemoryError):
    """Admission-time claim failure (the -ENOMEM a domain build gets
    when its claim exceeds free heap). ``reason`` is ``"cap"`` (per-
    account limit — ballooning others cannot help) or ``"capacity"``
    (device pressure — reclaim may free room)."""

    def __init__(self, msg: str, reason: str = "capacity"):
        super().__init__(msg)
        self.reason = reason


def nbytes_of(tree: Any) -> int:
    """Device-byte estimate of a nested dict/list/tuple of tensors or
    arrays: ``numel() * element_size()`` per tensor, ``nbytes`` per
    numpy array; None and Python scalars are free."""
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    # A tensor can only exist once torch is loaded: look it up rather
    # than import it, so the simulator plane (sim -> runtime.partition
    # -> here) stays free of torch.
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nb = getattr(tree, "nbytes", None)
    return int(nb) if nb is not None else 0


def device_memory_stats(device: Any = None) -> dict:
    """Live memory numbers of a CUDA device (``bytes_in_use``,
    ``bytes_limit``), ``{}`` for a CPU device. ``device=None`` is the
    current card."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device_memory_stats: no CUDA device is available; pass "
            "device='cpu' explicitly for the host")
    return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}


@dataclasses.dataclass
class MemoryAccount:
    """Per-domain accounting record (``struct domain``'s max_pages /
    tot_pages pair, in bytes)."""

    owner: str
    max_bytes: int = 0  # 0 = uncapped (dom0-style)
    used_bytes: int = 0
    claims: int = 0  # successful claim count (perfc-style)


class MemoryManager:
    """One device's HBM ledger: capacity, accounts, claims, ballooning."""

    def __init__(self, capacity_bytes: int, reserve_bytes: int = 0):
        # reserve = the runtime's own arena (Xen keeps a hypervisor
        # heap reserve the same way).
        self.capacity = int(capacity_bytes)
        self.reserve = int(reserve_bytes)
        self._accounts: dict[str, MemoryAccount] = {}
        self._reclaim: dict[str, Callable[[int], int]] = {}
        self._lock = ProfiledLock("memory_manager")

    @classmethod
    def for_device(cls, device: Any = None,
                   default_capacity: int = 16 << 30) -> "MemoryManager":
        """A manager sized to the card: capacity its total memory,
        reserve what live tensors hold right now."""
        stats = device_memory_stats(device)
        cap = int(stats.get("bytes_limit", default_capacity))
        used = int(stats.get("bytes_in_use", 0))
        return cls(cap, reserve_bytes=used)

    # -- accounts --------------------------------------------------------

    def open_account(self, owner: str, max_bytes: int = 0) -> MemoryAccount:
        with self._lock:
            if owner in self._accounts:
                raise ValueError(f"account {owner!r} exists")
            acct = MemoryAccount(owner, max_bytes=int(max_bytes))
            self._accounts[owner] = acct
            return acct

    def close_account(self, owner: str) -> int:
        """Returns the bytes freed (domain destruction releases all)."""
        with self._lock:
            acct = self._accounts.pop(owner, None)
            self._reclaim.pop(owner, None)
            return acct.used_bytes if acct else 0

    def account(self, owner: str) -> MemoryAccount:
        with self._lock:
            return self._accounts[owner]

    # -- claims (fail-fast admission) ------------------------------------

    def free_bytes(self) -> int:
        with self._lock:
            return self._free_locked()

    def _free_locked(self) -> int:
        used = sum(a.used_bytes for a in self._accounts.values())
        return self.capacity - self.reserve - used

    def claim(self, owner: str, nbytes: int) -> None:
        """XENMEM_claim_pages: reserve before allocating. Raises
        :class:`OutOfDeviceMemory` on cap or capacity violation —
        admission fails fast rather than OOMing mid-step."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("negative claim")
        with self._lock:
            acct = self._accounts[owner]
            if acct.max_bytes and acct.used_bytes + nbytes > acct.max_bytes:
                perfc.incr("mem_claim_cap_denied")
                raise OutOfDeviceMemory(
                    f"{owner}: claim {nbytes} exceeds cap "
                    f"{acct.max_bytes} (used {acct.used_bytes})",
                    reason="cap")
            if nbytes > self._free_locked():
                perfc.incr("mem_claim_capacity_denied")
                raise OutOfDeviceMemory(
                    f"{owner}: claim {nbytes} exceeds free "
                    f"{self._free_locked()} of {self.capacity}")
            acct.used_bytes += nbytes
            acct.claims += 1
            perfc.incr("mem_claims")

    def release(self, owner: str, nbytes: int) -> int:
        """Returns the bytes actually deducted (the account clamps at
        zero — callers re-claiming later must re-claim THIS amount,
        not their request, or the ledger inflates)."""
        with self._lock:
            acct = self._accounts[owner]
            deducted = min(acct.used_bytes, max(0, int(nbytes)))
            acct.used_bytes -= deducted
            return deducted

    # -- ballooning (cooperative reclaim) --------------------------------

    def register_reclaim(self, owner: str,
                         fn: Callable[[int], int]) -> None:
        """``fn(nbytes) -> freed`` — the balloon driver's target-set
        callback; the job frees caches and reports how much."""
        self._reclaim[owner] = fn

    def balloon(self, want_bytes: int) -> int:
        """Reclaim until ``want_bytes`` are free (or callbacks are
        exhausted). Returns bytes actually freed. Biggest consumers
        first, like the balloon targeting policy.

        A callback that frees nothing — or whose reported freeing does
        not actually grow free capacity — is skipped for the REST OF
        THIS CALL only, never unregistered ("nothing to give right
        now" is transient). A callback that DID free stays eligible,
        so chunked reclaimers (a cache evicting 100 MB per ask) are
        re-asked until the target is met or they dry up."""
        freed_total = 0
        skip: set[str] = set()
        while self.free_bytes() < want_bytes:
            with self._lock:
                candidates = sorted(
                    (a for a in self._accounts.values()
                     if a.owner in self._reclaim and a.used_bytes > 0
                     and a.owner not in skip),
                    key=lambda a: -a.used_bytes)
            if not candidates:
                break
            acct = candidates[0]
            need = want_bytes - self.free_bytes()
            fn = self._reclaim.get(acct.owner)
            if fn is None:  # concurrently unregistered
                skip.add(acct.owner)
                continue
            free_before = self.free_bytes()
            freed = int(fn(need))
            if freed > 0:
                deducted = self.release(acct.owner, freed)
                freed_total += deducted
                perfc.incr("mem_balloon_freed_bytes", deducted)
            if freed <= 0 or self.free_bytes() <= free_before:
                # dry, uncooperative, or claims bytes the ledger never
                # charged it for — either way, asking again this call
                # cannot make progress
                skip.add(acct.owner)
        return freed_total

    def claim_or_balloon(self, owner: str, nbytes: int) -> None:
        """Claim; on capacity pressure, balloon others then retry once.
        A per-account cap denial re-raises immediately — evicting other
        tenants' caches cannot make an over-cap claim succeed."""
        try:
            self.claim(owner, nbytes)
        except OutOfDeviceMemory as e:
            if e.reason == "cap":
                raise
            self.balloon(nbytes)
            self.claim(owner, nbytes)

    # -- observability ---------------------------------------------------

    def dump(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "reserve": self.reserve,
                "free": self._free_locked(),
                "accounts": {
                    a.owner: {"used": a.used_bytes, "max": a.max_bytes,
                              "claims": a.claims}
                    for a in self._accounts.values()
                },
            }
