"""File-backed knob channel: the port of ``pbs_tpu.knobs.channel``.

The live-value transport for the registry (knobs/registry.py), built on
the same protocol as the telemetry ledger (telemetry/ledger.py): a
fixed little-endian u64 word layout in an mmap'd file, a seqlock
version word that goes odd while a write is in progress, and lock-free
retried reader snapshots. The layout is the reference's word for word,
so a push from either package is read by the other's watcher.

Word layout (all ``<u8``):

    [0] magic       — KNOB_MAGIC ("PBSTKNOB")
    [1] abi         — CHANNEL_ABI
    [2] version     — seqlock: odd while a push is writing
    [3] generation  — applied pushes; watch() keys on it
    [4] n_knobs     — slot count
    [5:5+n]         — one value word per knob, in the sidecar's order:
                      int knobs as two's-complement i64, float knobs
                      as float64 bit patterns

A ``<path>.meta.json`` sidecar (written once, atomically, at create)
records the slot order and each knob's kind, so a reader never guesses
the layout and a channel created under an older registry still reads
correctly (missing knobs fall back to their declared defaults). A
channel the reference created also carries the two knobs the port does
not declare (``registry.UNDECLARED``): their slots keep their place
(decoded by the sidecar's kind), their values never surface and no push
can touch them.

**Atomicity contract**: ``push`` validates the WHOLE update against
the registry — unknown names, malformed values, out-of-range values,
inverted bands — before the seqlock write begins. A rejected push
raises :class:`KnobError` with every problem and leaves the file
byte-identical: generation does not move, watchers see nothing.

**Scoped pushes (the canary transport)**: a push
may carry ``scope=[member, ...]`` — the knob VALUES still land in the
shared file (one file, one truth), but a ``<path>.scope.json`` sidecar
records, per touched knob, which consumers are allowed to adopt it.
:class:`KnobWatcher` instances constructed with ``member=`` apply a
changed knob only when the knob is unscoped or their member name is in
its scope — and a value they skipped stays FOREIGN: it is excluded
from their last-seen view, so a later unrelated global push cannot
fold a canary-scoped value into a non-canary member's adoption set
(the silent re-adoption bug the scoping regression test pins), while a
later push that CLEARS the scope (``scope=None`` — promotion or
rollback) re-delivers it as changed even when the file bytes for that
knob did not move. The sidecar is written atomically BEFORE the
seqlock round, so any reader that observes the new generation already
observes the scope that governs it.

**Writer concurrency**: single-writer like the telemetry ledger's pure
Python path — one control plane owns ``push``; readers are always
safe (the retry loop tolerates torn reads by construction).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import time
from typing import Any, Callable

from pbs_tpu_torch.knobs import registry
from pbs_tpu_torch.knobs.registry import KnobError
from pbs_tpu_torch.utils.seqlock import read_attempts

KNOB_MAGIC = int.from_bytes(b"PBSTKNOB", "little")
CHANNEL_ABI = 1
HEADER_WORDS = 5
_W_MAGIC, _W_ABI, _W_VERSION, _W_GEN, _W_N = range(HEADER_WORDS)


def _pack_value(kind: str, value: int | float) -> int:
    """Value -> u64 word: i64 two's complement for ints, float64 bits
    for floats."""
    if kind == "int":
        return int(value) & 0xFFFFFFFFFFFFFFFF
    return struct.unpack("<Q", struct.pack("<d", float(value)))[0]


def _unpack_value(kind: str, word: int) -> int | float:
    if kind == "int":
        return word - (1 << 64) if word >= (1 << 63) else word
    return struct.unpack("<d", struct.pack("<Q", word))[0]


class KnobChannel:
    """One knob file: the writer end (``create``) or a reader attach.

    All values ride the registry's declarations; the channel itself
    stores only the (name-ordered) value words.
    """

    def __init__(self, path: str, names: list[str], mm, writable: bool,
                 kinds: dict[str, str] | None = None):
        self.path = path
        self.names = list(names)
        kinds = kinds or {}
        self._kinds = {n: kinds[n] if n in kinds else registry.knob(n).kind
                       for n in self.names}
        self._index = {n: i for i, n in enumerate(self.names)}
        # Slots of the reference's knobs the port leaves undeclared:
        # kept in the layout, never surfaced as values.
        self._hidden = frozenset(
            n for n in self.names if not registry.exists(n))
        self._mm = mm
        self.writable = writable

    # -- construction ----------------------------------------------------

    @classmethod
    def create(cls, path: str,
               initial: dict[str, Any] | None = None) -> "KnobChannel":
        """Create (or recreate) a channel holding every registry knob.
        ``initial`` overrides the declared defaults, validated like any
        push."""
        names = registry.names()
        values = registry.snapshot()
        if initial:
            values.update(registry.validate_set(initial, base=values))
        meta = {
            "version": 1,
            "abi": CHANNEL_ABI,
            "knobs": [{"name": n, "kind": registry.knob(n).kind,
                       "unit": registry.knob(n).unit}
                      for n in names],
        }
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path + ".meta.json")
        nbytes = (HEADER_WORDS + len(names)) * 8
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        ch = cls(path, names, mm, writable=True)
        words = [KNOB_MAGIC, CHANNEL_ABI, 0, 0, len(names)]
        words += [_pack_value(ch._kinds[n], values[n]) for n in names]
        mm[:nbytes] = struct.pack(f"<{len(words)}Q", *words)
        mm.flush()
        return ch

    @classmethod
    def attach(cls, path: str, writable: bool = False) -> "KnobChannel":
        """Open an existing channel. Reader attaches are always safe;
        ``writable=True`` makes this end a (single) writer."""
        try:
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise KnobError(
                [f"cannot read knob channel sidecar {path}.meta.json: "
                 f"{e}"]) from None
        names = [k["name"] for k in meta.get("knobs", [])]
        unknown = [n for n in names if not registry.exists(n)
                   and n not in registry.UNDECLARED]
        if unknown:
            raise KnobError(
                [f"channel {path} carries knobs this registry does "
                 f"not declare: {unknown[:5]}"])
        flags = os.O_RDWR if writable else os.O_RDONLY
        fd = os.open(path, flags)
        try:
            size = os.fstat(fd).st_size
            want = (HEADER_WORDS + len(names)) * 8
            if size < want:
                raise KnobError(
                    [f"channel {path} truncated: {size} < {want} bytes"])
            mm = mmap.mmap(fd, want,
                           prot=(mmap.PROT_READ | mmap.PROT_WRITE
                                 if writable else mmap.PROT_READ))
        finally:
            os.close(fd)
        ch = cls(path, names, mm, writable=writable,
                 kinds={k["name"]: k["kind"] for k in meta["knobs"]
                        if k["name"] in registry.UNDECLARED})
        hdr = ch._words(0, HEADER_WORDS)
        if hdr[_W_MAGIC] != KNOB_MAGIC or hdr[_W_ABI] != CHANNEL_ABI:
            raise KnobError(
                [f"{path} is not a knob channel (magic/abi mismatch)"])
        if hdr[_W_N] != len(names):
            raise KnobError(
                [f"{path}: slot count {hdr[_W_N]} != sidecar "
                 f"{len(names)}"])
        return ch

    # -- raw words -------------------------------------------------------

    def _words(self, off: int, n: int) -> tuple[int, ...]:
        return struct.unpack_from(f"<{n}Q", self._mm, off * 8)

    def _store(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._mm, off * 8, value)

    # -- reader side -----------------------------------------------------

    @property
    def generation(self) -> int:
        return self._words(_W_GEN, 1)[0]

    def snapshot(self, max_retries: int = 64
                 ) -> tuple[int, dict[str, int | float]]:
        """Torn-free ``(generation, {name: value})`` — the telemetry
        ledger's retry contract, waiting out a live writer that holds
        the version odd (``utils.seqlock.read_attempts``; ``max_retries``
        is the reference's signature, time bounds the wait)."""
        n = len(self.names)
        for _ in read_attempts():
            v0, gen = self._words(_W_VERSION, 2)
            if v0 & 1:
                continue
            words = self._words(HEADER_WORDS, n) if n else ()
            v1 = self._words(_W_VERSION, 1)[0]
            if v0 == v1:
                return gen, {
                    name: _unpack_value(self._kinds[name], words[i])
                    for i, name in enumerate(self.names)
                    if name not in self._hidden
                }
        raise KnobError(
            [f"channel {self.path}: snapshot retries exhausted "
             "(writer wedged mid-push?)"])

    def get(self, name: str) -> int | float:
        if name not in self._index or name in self._hidden:
            # Declared after this channel was created: the declared
            # default is the truthful current value (and an undeclared
            # name raises as unknown).
            return registry.get(name)
        _, values = self.snapshot()
        return values[name]

    def poll(self, last_generation: int
             ) -> tuple[int, dict[str, int | float]] | None:
        """None if nothing changed since ``last_generation``, else the
        fresh (generation, values) snapshot — the watch primitive.
        Cheap when idle: one header read, no value copy."""
        if self.generation == last_generation:
            return None
        return self.snapshot()

    def watch(self, on_change: Callable[[int, dict[str, int | float]], None],
              timeout_s: float | None = None,
              poll_interval_s: float = 0.05,
              max_events: int | None = None,
              initial: bool = True) -> int:
        """Blocking watch loop (``pbst knobs watch`` in the reference): invoke
        ``on_change(generation, values)`` once with the current state
        (``initial=True``, so a watcher starts from truth, not from a
        gap) and then for every generation move. Returns events
        delivered. Test/automation friendly: bounded by ``timeout_s``
        and/or ``max_events``."""
        gen = self.generation
        events = 0
        if initial:
            g, values = self.snapshot()
            gen = g
            on_change(g, values)
            events += 1
            if max_events is not None and events >= max_events:
                return events
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while True:
            got = self.poll(gen)
            if got is not None:
                gen, values = got
                on_change(gen, values)
                events += 1
                if max_events is not None and events >= max_events:
                    return events
            if deadline is not None and time.monotonic() >= deadline:
                return events
            time.sleep(poll_interval_s)

    # -- scope sidecar (canary rollouts) ----------------------------------

    def knob_scopes(self) -> dict[str, list[str]]:
        """Per-knob adoption scope: ``{knob: [member, ...]}``. A knob
        absent from the map is GLOBAL (every watcher adopts it). A
        MISSING sidecar means no knob was ever scoped — the pre-scope
        behavior, so plain channels are unaffected. A sidecar that
        exists but cannot be parsed raises: failing open would let a
        canary-scoped (possibly pathological) value become globally
        adoptable through corruption, with no push and no guard."""
        try:
            with open(self.path + ".scope.json") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError) as e:
            raise KnobError(
                [f"knob scope sidecar {self.path}.scope.json is "
                 f"unreadable ({e}); refusing to treat scoped knobs "
                 "as global — recreate the channel (pbst knobs init)"]
            ) from None
        scopes = doc.get("knob_scopes", {})
        return {k: [str(m) for m in v] for k, v in scopes.items()
                if isinstance(v, list) and v}

    def _write_scopes(self, scopes: dict[str, list[str]]) -> None:
        tmp = self.path + ".scope.json.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1,
                       "knob_scopes": {k: sorted(v) for k, v
                                       in sorted(scopes.items())}},
                      f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path + ".scope.json")

    # -- writer side -----------------------------------------------------

    def push(self, updates: dict[str, Any],
             scope: "list[str] | None" = None) -> int:
        """Atomic hot-reload: validate EVERYTHING against the registry
        (unknown/malformed/out-of-range/inverted-band -> KnobError with
        every problem, file untouched), then publish under one seqlock
        round and bump the generation. Returns the new generation.

        ``scope`` restricts ADOPTION of the pushed knobs to the named
        members (a canary rollout); ``scope=None`` is a global push and
        additionally CLEARS any recorded scope on the touched knobs
        (promotion / rollback): member-filtered watchers treat the
        cleared knobs as changed against their own last-adopted view,
        so one global push converges every member. The scope sidecar is
        written before the seqlock round — rejection still leaves both
        files untouched (validation happens first)."""
        if not self.writable:
            raise KnobError(
                [f"channel {self.path} attached read-only"])
        if self._words(_W_VERSION, 1)[0] & 1:
            # A writer died mid-push (version left odd). Writing on
            # top would make the seqlock parity lie to readers — an
            # in-progress write marked "stable". Refuse explicitly;
            # the snapshot() below would also refuse, but with a
            # less actionable message.
            raise KnobError(
                [f"channel {self.path} is wedged (a writer crashed "
                 "mid-push); recreate it with `pbst knobs init`"])
        _, current = self.snapshot()
        coerced = registry.validate_set(updates, base=current)
        missing = [n for n in coerced if n not in self._index]
        if missing:
            # The registry grew since this channel file was created;
            # a push touching the new knob needs a recreated channel.
            raise KnobError(
                [f"channel {self.path} predates knob(s) {missing}; "
                 "recreate it (pbst knobs init)"])
        # Scope ORDERING vs the seqlock round — each direction lands on
        # its conservative side for a cross-process reader racing one
        # generation behind:
        # - scope-ADDS are written BEFORE the value round: a reader of
        #   the old generation that sees the new (narrower) scope
        #   merely skips values it would have adopted — never adopts
        #   values it should not;
        # - scope-CLEARS are written AFTER the value round (below): a
        #   reader that still sees the old generation with the old
        #   scope keeps skipping the canary values — clearing first
        #   would let it adopt the OLD (possibly pathological)
        #   generation's values as if unscoped, fleet-wide, for one
        #   poll period.
        if scope is not None:
            members = sorted({str(m) for m in scope})
            if not members:
                raise KnobError(
                    ["scoped push with an empty member set — a push "
                     "nobody may adopt is a misconfiguration, not a "
                     "rollout"])
            scopes = self.knob_scopes()
            for name in coerced:
                scopes[name] = members
            self._write_scopes(scopes)
        v0, gen = self._words(_W_VERSION, 2)
        self._store(_W_VERSION, v0 + 1)  # odd: push in progress
        for name, value in sorted(coerced.items()):
            self._store(HEADER_WORDS + self._index[name],
                        _pack_value(self._kinds[name], value))
        self._store(_W_GEN, gen + 1)
        self._store(_W_VERSION, v0 + 2)  # even: stable
        self._mm.flush()
        if scope is None and os.path.exists(self.path + ".scope.json"):
            # Global push: clear any canary scope on the touched knobs
            # (promotion/rollback) — AFTER the value round, see the
            # ordering note above. Channels that never saw a scoped
            # push never grow a sidecar.
            scopes = self.knob_scopes()
            if any(n in scopes for n in coerced):
                for name in coerced:
                    scopes.pop(name, None)
                self._write_scopes(scopes)
        return gen + 1

    def close(self) -> None:
        self._mm.close()


class KnobWatcher:
    """Deterministic poll-and-apply bridge from a channel to live
    consumers (virtual-clock friendly: the owner calls :meth:`poll`
    from its own loop — a partition timer, the federation pump — so
    application points are a function of the run's own timeline, never
    of wall-clock threads).

    Appliers are ``fn(changed: dict, values: dict)``; each poll calls
    every applier with the knobs that changed since the LAST poll plus
    the full current APPLICABLE view (scope-filtered — an applier that
    derives state from ``values`` must never see a foreign canary
    value). Appliers must be atomic on their own consumer
    (validate-then-apply), mirroring the channel contract.

    ``member`` names this watcher's identity for SCOPED pushes
    (the canary transport): a changed knob whose scope (the channel's
    ``knob_scopes`` sidecar) does not include the member — including
    every scoped knob for an anonymous ``member=None`` watcher — is
    SKIPPED, and crucially stays out of the watcher's last-seen view:
    a later global push of an unrelated knob cannot silently deliver a
    foreign canary value (the per-member adoption filter the scoping
    regression test pins), while a push that clears the scope
    re-delivers the value as changed even if its file word never
    moved. :meth:`prime` fires the appliers once with the full current
    applicable state (the ``watch()`` current-state-first contract,
    for consumers that must start from truth).
    """

    def __init__(self, channel: KnobChannel, member: str | None = None):
        self.channel = channel
        self.member = member
        gen, values = channel.snapshot()
        self._gen = gen
        # The last-seen view starts as the current APPLICABLE state:
        # a knob scoped away from this member at construction stays
        # foreign until a push it may see delivers it.
        self._last, foreign = self._split(values)
        #: Foreign values as last observed — so ``skipped`` counts a
        #: filtered DELIVERY once, not every generation the value
        #: merely persists in the file.
        self._foreign_seen: dict = dict(foreign)
        self._appliers: list[Callable[[dict, dict], None]] = []
        self.applied = 0  # generations applied (observability)
        self.skipped = 0  # scope-filtered knob values (observability)

    def add(self, fn: Callable[[dict, dict], None]) -> None:
        self._appliers.append(fn)

    def prime(self) -> dict:
        """Deliver the current applicable state to the appliers as one
        synthetic change set (call after :meth:`add`): the consumer
        starts from the channel's truth instead of a gap — every
        federation member then carries the same adopted baseline, so a
        later rollback restores a canary member to exactly its peers'
        state."""
        changed = dict(self._last)
        self._fire(changed, changed)
        return changed

    def _split(self, values: dict) -> tuple[dict, dict]:
        """(applicable, foreign) partition of a value view under the
        channel's current per-knob scopes."""
        scopes = self.channel.knob_scopes()
        if not scopes:
            return dict(values), {}
        applicable, foreign = {}, {}
        for n, v in values.items():
            s = scopes.get(n)
            if s is not None and (self.member is None
                                  or self.member not in s):
                foreign[n] = v
            else:
                applicable[n] = v
        return applicable, foreign

    def _fire(self, changed: dict, values: dict) -> None:
        for fn in self._appliers:
            fn(changed, values)

    def poll(self) -> dict[str, int | float] | None:
        """Apply any pending generation; returns the changed-knob dict
        (empty and fully out-of-scope pushes return {}) or None when
        nothing moved."""
        got = self.channel.poll(self._gen)
        if got is None:
            return None
        gen, values = got
        applicable, foreign = self._split(values)
        changed = {n: v for n, v in applicable.items()
                   if self._last.get(n) != v}
        self._gen = gen
        # The last-seen view advances only over applicable knobs: a
        # foreign (scope-filtered) value must remain invisible so it
        # can never ride a later unrelated generation into this
        # consumer — and so clearing its scope re-delivers it.
        new_last = dict(applicable)
        for n in foreign:
            if n in self._last:
                new_last[n] = self._last[n]
        self._last = new_last
        self.applied += 1
        # One skip per filtered DELIVERY (the file word moved while
        # scoped away), not per generation it merely persists.
        self.skipped += sum(1 for n, v in foreign.items()
                            if self._foreign_seen.get(n) != v)
        self._foreign_seen = dict(foreign)
        # Appliers see the APPLICABLE view only: handing them the raw
        # file values would leak a canary-scoped value into a
        # non-canary consumer that derives state from ``values`` (the
        # member profile model reads its band cap there), defeating
        # the scope filter at one remove.
        self._fire(changed, applicable)
        return changed
