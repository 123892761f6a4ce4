"""Lock-order validation: the lockdep analog (race detection, §5).

Reference: the guest kernel ships lockdep
(``linux-3.2.30/kernel/lockdep.c``): every acquisition records edges
from the locks already held to the lock being taken; when a new edge
closes a cycle in that order graph, a potential AB-BA deadlock is
reported the FIRST time the inverted order is ever seen — no actual
deadlock needs to occur.

The port of ``pbs_tpu.obs.lockdep``. Same design, framework-scale: a
process-wide order graph over named lock classes (the same per-name
classing ``ProfiledLock`` uses for stats), a per-thread held stack,
and DFS cycle detection on each new edge. Validation is gated by the
``lockdep`` boot param (off = zero overhead, like the kernel's CONFIG
gate); ``strict`` mode raises at the violating acquisition (the
development posture), default mode records the violation with both
witness chains (the AVC-log posture —
dumps via :func:`violations`, :func:`dump` and :func:`export_graph`).
"""

from __future__ import annotations

import threading

from pbs_tpu_torch.utils.params import boolean_param

#: Validation gate (CONFIG_PROVE_LOCKING analog; off = no bookkeeping).
lockdep = boolean_param("lockdep", False)
#: Raise OrderViolation at the faulting acquire instead of only logging.
lockdep_strict = boolean_param("lockdep_strict", False)


class OrderViolation(RuntimeError):
    def __init__(self, holding: str, taking: str, cycle: list[str]):
        super().__init__(
            f"lock order violation: taking {taking!r} while holding "
            f"{holding!r}, but the order graph already requires "
            f"{' -> '.join(cycle)} (AB-BA deadlock possible)")
        self.holding = holding
        self.taking = taking
        self.cycle = cycle


class _Graph:
    """Order graph over lock-class names. Edge A->B = 'B was taken
    while A was held' (B nests inside A)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._witness: dict[tuple[str, str], str] = {}
        self._tls = threading.local()
        self.violations: list[dict] = []
        # One record per (holding, taking) class pair (the kernel
        # reports a pair once); repeats only bump the count — a hot
        # inverted path must not grow memory per quantum.
        self._seen_pairs: dict[tuple[str, str], dict] = {}
        self.checked_edges = 0

    # -- per-thread held stack ------------------------------------------

    def _held(self) -> list[str]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    # -- graph ops -------------------------------------------------------

    def _path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> ... -> dst in the existing order graph."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def note_acquire(self, name: str, where: str = "") -> None:
        held = self._held()
        if held:
            holding = held[-1]
            # Re-entrant same-class acquisition is legal no matter how
            # deep it sits in the stack (A, B, A-again cannot invert:
            # the thread already owns A).
            if holding != name and name not in held:
                with self._mu:
                    self.checked_edges += 1
                    # Inversion: does the graph already require name
                    # to be taken BEFORE holding (a path name->holding)?
                    cycle = self._path(name, holding)
                    if cycle is not None:
                        pair = (holding, name)
                        v = self._seen_pairs.get(pair)
                        if v is not None:
                            v["count"] += 1
                        else:
                            v = {
                                "holding": holding,
                                "taking": name,
                                "established_order": cycle,
                                "witness": self._witness.get(
                                    (cycle[0], cycle[1]), "")
                                if len(cycle) > 1 else "",
                                "where": where,
                                "count": 1,
                            }
                            self._seen_pairs[pair] = v
                            self.violations.append(v)
                        if lockdep_strict.value:
                            raise OrderViolation(holding, name,
                                                 cycle + [name])
                    else:
                        edge = (holding, name)
                        if name not in self._edges.setdefault(holding,
                                                              set()):
                            self._edges[holding].add(name)
                            self._witness.setdefault(edge, where)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        # Out-of-order release is legal (hand-over-hand): remove the
        # LAST occurrence, preserving the rest of the stack.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "classes": sorted(
                    set(self._edges) | {b for s in self._edges.values()
                                        for b in s}),
                "edges": {a: sorted(bs)
                          for a, bs in sorted(self._edges.items())},
                "violations": list(self.violations),
                "checked_edges": self.checked_edges,
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._witness.clear()
            self.violations.clear()
            self._seen_pairs.clear()
            self.checked_edges = 0


_graph = _Graph()


def note_acquire(name: str, where: str = "") -> None:
    """Hook point: call on every (gated) lock acquisition."""
    if lockdep.value:
        _graph.note_acquire(name, where)


def note_release(name: str) -> None:
    # Deliberately NOT gated on the live param: flipping lockdep off
    # while locks are held must still pop the held stacks, or phantom
    # holds poison the graph when it is re-enabled. (The pop is a
    # cheap no-op for stacks that were never pushed.)
    _graph.note_release(name)


def violations() -> list[dict]:
    return list(_graph.violations)


def dump() -> dict:
    return _graph.snapshot()


def export_graph(snapshot: dict | None = None) -> dict:
    """The dynamic order graph in its *stable public* JSON form — the
    interface static/dynamic cross-checking consumes. Edges are sorted ``[holder, taken]`` pairs so two
    exports of the same graph are byte-identical; ``version`` gates
    schema evolution."""
    snap = snapshot if snapshot is not None else dump()
    edges = snap.get("edges", {})
    return {
        "version": 1,
        "classes": sorted(snap.get("classes", [])),
        "edges": sorted([a, b] for a, bs in edges.items() for b in bs),
        "violations": sorted(
            ({"holding": v["holding"], "taking": v["taking"],
              "count": v.get("count", 1)}
             for v in snap.get("violations", [])),
            key=lambda v: (v["holding"], v["taking"])),
    }


def reset() -> None:
    _graph.reset()


class OrderedLock:
    """A named lock with lockdep validation AND contention profiling —
    the composition the kernel gives every spinlock. Drop-in for
    ``ProfiledLock`` where order checking is wanted."""

    def __init__(self, name: str, recursive: bool = False):
        from pbs_tpu_torch.obs.lockprof import ProfiledLock

        self.name = name
        self._inner = ProfiledLock(name, recursive=recursive)

    def acquire(self) -> None:
        note_acquire(self.name)
        try:
            self._inner.acquire()
        except BaseException:
            note_release(self.name)  # strict-mode raise or interrupt:
            raise  # the held stack must not wedge

    def release(self) -> None:
        self._inner.release()
        note_release(self.name)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
