"""Hierarchical config/rendezvous store — the xenstore analog.

Reference: xenstore (``xen-4.2.1/tools/xenstore``, 11.7k LoC C +
oxenstored) is the control-plane rendezvous: a transactional
hierarchical key-value tree with watches, used by the toolstack and
guests to exchange configuration and device state.

Here: an in-process tree with path keys (``/jobs/train/weight``),
watches firing on subtree changes (xenstore watch semantics: a watch on
a prefix fires for any descendant), simple transactions
(all-or-nothing batches with optimistic version checks), and optional
JSON file persistence for cross-process handoff. The ``pbst-torch``
CLI and the controller use it as their source of truth.

The port of ``pbs_tpu.store.store``: the same paths, versions, watch and
transaction semantics, XSM checks and persisted file layout, so a file
persisted by one package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from pbs_tpu_torch.obs.lockprof import ProfiledLock
from pbs_tpu_torch.runtime.xsm import xsm_check


def _norm(path: str) -> str:
    if not path.startswith("/"):
        raise ValueError(f"store paths are absolute: {path!r}")
    while "//" in path:
        path = path.replace("//", "/")
    return path.rstrip("/") or "/"


class TransactionError(Exception):
    pass


class Store:
    def __init__(self, persist_path: str | None = None):
        self._data: dict[str, Any] = {}
        self._version: dict[str, int] = {}
        self._watches: list[tuple[str, Callable[[str, Any], None]]] = []
        self._lock = ProfiledLock("store", recursive=True)
        self._persist = persist_path
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as f:
                raw = json.load(f)
            self._data = dict(raw.get("data", {}))
            self._version = {k: int(v) for k, v in raw.get("version", {}).items()}

    # -- basic ops -------------------------------------------------------

    def write(self, path: str, value: Any, subject: str = "system") -> None:
        path = _norm(path)
        xsm_check(subject, "store.write", path)
        with self._lock:
            self._data[path] = value
            self._version[path] = self._version.get(path, 0) + 1
            self._fire(path, value)
            self._save()

    def read(self, path: str, default: Any = None,
             subject: str = "system") -> Any:
        """In-process callers default to the system subject; RPC/CLI
        surfaces pass the caller's label so an enforcing policy governs
        information flow too (FLASK checks reads, not only writes)."""
        path = _norm(path)
        xsm_check(subject, "store.read", path)
        with self._lock:
            return self._data.get(path, default)

    def exists(self, path: str, subject: str = "system") -> bool:
        # Existence is information too: a read-denied label must not be
        # able to probe the key space.
        path = _norm(path)
        xsm_check(subject, "store.read", path)
        return path in self._data

    def rm(self, path: str, subject: str = "system") -> int:
        """Remove path and its whole subtree (xenstore rm). Returns the
        number of removed keys."""
        path = _norm(path)
        xsm_check(subject, "store.rm", path)
        with self._lock:
            doomed = [k for k in self._data
                      if k == path or k.startswith(path + "/")]
            for k in doomed:
                del self._data[k]
                self._version[k] = self._version.get(k, 0) + 1
                self._fire(k, None)
            self._save()
            return len(doomed)

    def ls(self, path: str, subject: str = "system") -> list[str]:
        """Immediate children names (xenstore-ls one level)."""
        path = _norm(path)
        xsm_check(subject, "store.read", path)
        prefix = "" if path == "/" else path
        out = set()
        with self._lock:
            for k in self._data:
                if k.startswith(prefix + "/"):
                    rest = k[len(prefix) + 1:]
                    out.add(rest.split("/", 1)[0])
        return sorted(out)

    def version(self, path: str, subject: str = "system") -> int:
        path = _norm(path)
        xsm_check(subject, "store.read", path)
        return self._version.get(path, 0)

    # -- watches (fire for the key or any ancestor watch prefix) ---------

    def watch(self, prefix: str, fn: Callable[[str, Any], None],
              subject: str = "system") -> None:
        """A watch is a standing read of the subtree — same check."""
        xsm_check(subject, "store.read", _norm(prefix))
        self._watches.append((_norm(prefix), fn))

    def unwatch(self, prefix: str, fn) -> None:
        self._watches.remove((_norm(prefix), fn))

    def _fire(self, path: str, value: Any) -> None:
        for prefix, fn in list(self._watches):
            if path == prefix or path.startswith(prefix + "/") or prefix == "/":
                fn(path, value)

    # -- transactions ----------------------------------------------------

    def transaction(self, subject: str = "system") -> "Transaction":
        return Transaction(self, subject=subject)

    def _save(self) -> None:
        if not self._persist:
            return
        tmp = self._persist + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"data": self._data, "version": self._version}, f)
        os.replace(tmp, self._persist)


class Transaction:
    """Optimistic all-or-nothing batch: reads record versions; commit
    fails if any read key changed (xenstore transaction semantics)."""

    def __init__(self, store: Store, subject: str = "system"):
        self.store = store
        self.subject = subject
        self._reads: dict[str, int] = {}
        self._writes: dict[str, Any] = {}
        self._rms: list[str] = []

    def read(self, path: str, default: Any = None) -> Any:
        path = _norm(path)
        if path in self._writes:
            return self._writes[path]
        self._reads[path] = self.store.version(path, subject=self.subject)
        return self.store.read(path, default, subject=self.subject)

    def write(self, path: str, value: Any) -> None:
        self._writes[_norm(path)] = value

    def rm(self, path: str) -> None:
        self._rms.append(_norm(path))

    def commit(self) -> None:
        s = self.store
        # XSM before any mutation: a transaction must not bypass the
        # checks its individual ops would face (and a denial must leave
        # the batch unapplied — all-or-nothing includes policy).
        for path in self._rms:
            xsm_check(self.subject, "store.rm", path)
        for path in self._writes:
            xsm_check(self.subject, "store.write", path)
        with s._lock:
            for path, ver in self._reads.items():
                if s.version(path) != ver:
                    raise TransactionError(
                        f"conflict on {path}: version {ver} -> "
                        f"{s.version(path)}"
                    )
            # Apply the whole batch in memory, persist ONCE, then fire
            # watches — so a crash cannot leave a half-persisted batch
            # and watchers never observe intermediate states.
            fired: list[tuple[str, Any]] = []
            for path in self._rms:
                doomed = [k for k in s._data
                          if k == path or k.startswith(path + "/")]
                for k in doomed:
                    del s._data[k]
                    s._version[k] = s._version.get(k, 0) + 1
                    fired.append((k, None))
            for path, value in self._writes.items():
                s._data[path] = value
                s._version[path] = s._version.get(path, 0) + 1
                fired.append((path, value))
            s._save()
            for path, value in fired:
                s._fire(path, value)
