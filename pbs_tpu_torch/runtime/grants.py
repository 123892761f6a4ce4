"""Grant tables: controlled zero-copy shared memory (grant_table.c analog).

Reference: Xen grant tables (``xen/common/grant_table.c``, ~2.5k LoC)
let a domain *grant* specific frames of its memory to a specific peer —
the substrate for zero-copy I/O between isolation boundaries: blkfront
grants pages to blkback, netfront to netback. Key semantics preserved
here:

- a grant names (grantee, region, access) and yields a small integer
  *ref* the grantee uses to map;
- mapping is refcounted (``map_ref``/``unmap_ref``); the granter cannot
  end access while mappings exist (``gnttab_end_foreign_access`` "still
  in use" busy state);
- *transfer* moves ownership of a region outright (the page-transfer
  flavor used by early netfront);
- everything is revocable and auditable from the granter side.

The port of ``pbs_tpu.runtime.grants``, semantics for semantics. The
"frames" are byte ranges of named host shared-memory segments
(``multiprocessing.shared_memory``) — the same host-buffer substrate
the telemetry ledger and trace rings ride. Device tensors never touch
this path; grants carry host-side staging buffers (checkpoint chunks,
telemetry pages, input shards) between the processes of one host.
"""

from __future__ import annotations

import dataclasses
from multiprocessing import shared_memory
from typing import Any

import numpy as np

from pbs_tpu_torch.obs.lockprof import ProfiledLock

GRANT_INVALID = -1


class GrantError(Exception):
    pass


class GrantBusy(GrantError):
    """End-access/transfer attempted while mappings exist (the
    ``gnttab_end_foreign_access`` still-in-use state)."""


class GrantDenied(GrantError):
    """Mapper is not the grantee, or access mode exceeds the grant."""


class SharedRegion:
    """A named host shared-memory segment (the granter's 'frames').

    ``create=True`` allocates; otherwise attaches to an existing segment
    by name (what a peer process does after receiving a grant ref).
    """

    def __init__(self, name: str | None = None, size: int = 0,
                 create: bool = False):
        self._shm = shared_memory.SharedMemory(
            name=name, create=create, size=size if create else 0)
        self.name = self._shm.name
        self.size = self._shm.size

    def view(self, offset: int = 0, length: int | None = None,
             readonly: bool = False) -> np.ndarray:
        length = self.size - offset if length is None else length
        arr = np.frombuffer(self._shm.buf, dtype=np.uint8,
                            offset=offset, count=length)
        if readonly:
            arr = arr.view()
            arr.flags.writeable = False
        return arr

    def close(self) -> None:
        # Views into the buffer must be dropped by callers first.
        self._shm.close()

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


@dataclasses.dataclass
class GrantEntry:
    ref: int
    segment: str  # shared-memory segment name
    offset: int
    length: int
    grantee: str  # domain name allowed to map
    readonly: bool
    use_count: int = 0  # live mappings
    revoked: bool = False
    transferred_to: str | None = None

    def describe(self) -> dict[str, Any]:
        """Wire form a granter sends to the grantee (the grant ref plus
        enough to attach — Xen passes just the ref because the table
        itself is shared; ours rides the control plane)."""
        return {
            "ref": self.ref,
            "segment": self.segment,
            "offset": self.offset,
            "length": self.length,
            "readonly": self.readonly,
        }


class GrantTable:
    """One domain's grant table (``struct grant_table`` per domain)."""

    def __init__(self, owner: str):
        self.owner = owner
        self._entries: dict[int, GrantEntry] = {}
        self._next_ref = 0
        self._lock = ProfiledLock("grant_table")

    # -- granter side ----------------------------------------------------

    def grant_access(self, grantee: str, region: SharedRegion,
                     offset: int = 0, length: int | None = None,
                     readonly: bool = False) -> int:
        """gnttab_grant_foreign_access: allow ``grantee`` to map a byte
        range of ``region``. Returns the grant ref."""
        length = region.size - offset if length is None else length
        if offset < 0 or length <= 0 or offset + length > region.size:
            raise GrantError(
                f"range [{offset}, {offset + length}) outside segment "
                f"of {region.size} bytes")
        with self._lock:
            ref = self._next_ref
            self._next_ref += 1
            self._entries[ref] = GrantEntry(
                ref=ref, segment=region.name, offset=offset, length=length,
                grantee=grantee, readonly=readonly)
            return ref

    def end_access(self, ref: int, force: bool = False) -> None:
        """gnttab_end_foreign_access: revoke. Raises :class:`GrantBusy`
        while mapped unless forced (force mirrors the page-orphaning
        fallback — the mapping stays valid but the grant is dead)."""
        with self._lock:
            e = self._need(ref)
            if e.use_count > 0 and not force:
                raise GrantBusy(
                    f"grant {ref} has {e.use_count} live mappings")
            e.revoked = True

    def transfer(self, ref: int, new_owner: str) -> GrantEntry:
        """gnttab_transfer: move ownership outright. The entry is
        removed from this table; the region now belongs to
        ``new_owner`` (who should re-grant as needed)."""
        with self._lock:
            e = self._need(ref)
            if e.use_count > 0:
                raise GrantBusy(
                    f"grant {ref} has {e.use_count} live mappings")
            e.revoked = True
            e.transferred_to = new_owner
            del self._entries[ref]
            return e

    def entry(self, ref: int) -> GrantEntry:
        with self._lock:
            return self._need(ref)

    def active(self) -> list[GrantEntry]:
        with self._lock:
            return [e for e in self._entries.values() if not e.revoked]

    def _need(self, ref: int) -> GrantEntry:
        e = self._entries.get(ref)
        if e is None:
            raise GrantError(f"bad grant ref {ref}")
        return e

    # -- grantee side ----------------------------------------------------

    def map_ref(self, ref: int, as_domain: str,
                write: bool = False) -> "GrantMapping":
        """gnttab_map_grant_ref: validate and produce a mapping handle.
        The returned mapping attaches the shared segment (possibly in a
        different process via ``GrantEntry.describe()`` + ``map_grant``)."""
        with self._lock:
            e = self._need(ref)
            if e.revoked:
                raise GrantError(f"grant {ref} revoked")
            if e.grantee != as_domain:
                raise GrantDenied(
                    f"grant {ref} is for {e.grantee!r}, not {as_domain!r}")
            if write and e.readonly:
                raise GrantDenied(f"grant {ref} is read-only")
            e.use_count += 1
        try:
            return GrantMapping(self, e, write=write)
        except BaseException:
            # Attach failed (e.g. segment unlinked): no mapping exists
            # to unmap, so the refcount must not stay pinned or the
            # grant reads busy forever.
            self._unmap(ref)
            raise

    def _unmap(self, ref: int) -> None:
        with self._lock:
            e = self._entries.get(ref)
            if e is not None and e.use_count > 0:
                e.use_count -= 1


class GrantMapping:
    """A live mapping of a granted range (the map_track entry)."""

    def __init__(self, table: GrantTable, entry: GrantEntry, write: bool):
        self._table = table
        self._entry = entry
        self._write = write
        self._region = SharedRegion(name=entry.segment)
        self.data = self._region.view(
            entry.offset, entry.length, readonly=not write)

    def unmap(self) -> None:
        if self._table is not None:
            del self.data
            self._region.close()
            self._table._unmap(self._entry.ref)
            self._table = None

    def __enter__(self) -> "GrantMapping":
        return self

    def __exit__(self, *exc) -> None:
        self.unmap()


def map_grant(desc: dict, write: bool = False) -> tuple[SharedRegion, np.ndarray]:
    """Foreign-process attach from a wire-form grant description
    (``GrantEntry.describe()``): returns (region, view). The caller must
    ``region.close()`` when done. Refcounts live in the granter's table,
    so cross-process mappers report unmap over the control plane."""
    if write and desc.get("readonly"):
        raise GrantDenied("grant is read-only")
    region = SharedRegion(name=desc["segment"])
    view = region.view(desc["offset"], desc["length"],
                       readonly=not write)
    return region, view
