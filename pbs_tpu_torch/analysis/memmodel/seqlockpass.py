"""Seqlock write/read protocol checker (C side + Python mirror).

The protocol being enforced is the one the repo already ships
(runtime/csrc/pbst_runtime.cc, telemetry/ledger.py, knobs/channel.py): a
writer brackets every payload store between a version-word increment
to odd (``__ATOMIC_RELEASE`` store) and a release-fenced increment
back to even; a reader retry loop takes two acquire loads of the
version word, rejects odd, fences the payload copy with acquires on
both sides, and re-checks ``v0 == v1``; a lockless ring publishes its
head word with release ordering only AFTER the payload memcpy. Six
rules:

- ``seqlock-missing-release``: a ``write_begin``/``write_end`` helper
  whose body lacks the release-ordered version store or the release
  fence — the bracket exists but orders nothing.
- ``seqlock-plain-store``: a store through a slot pointer (a
  ``slot_ptr(...)`` / ``buf + slot * kSlotWords`` derived variable)
  outside a ``write_begin``/``write_end`` bracket — a torn read
  waiting for a concurrent snapshot.
- ``seqlock-unbalanced``: a function whose ``write_begin`` and
  ``write_end`` call counts differ — some path leaves the version
  word odd forever (readers spin their whole retry budget).
- ``seqlock-reader-protocol``: a retry loop (two version-word loads
  of the same buffer) missing any leg of the read protocol: acquire
  ordering on the loads, the odd check, the ``v0 == v1`` re-check, or
  the two acquire fences around the payload copy.
- ``seqlock-ring-publish``: a function that both plain-stores payload
  into a buffer and atomically publishes a word of the same buffer
  must publish with ``__ATOMIC_RELEASE``, and no payload store may
  follow the publish — the consumer would read records the head does
  not cover yet.
- ``seqlock-raw-py-write``: the Python mirror — ``struct.pack_into``,
  ``os.pwrite``, or the private seqlock writer helpers
  (``._begin``/``._end``/``._store``) used outside the sanctioned
  writer modules. Everything else goes through Ledger/TraceRing/
  KnobChannel/IntentJournal APIs, which own the version-word
  discipline.

All C scans run over comment-and-string-blanked text (ctokens), so a
commented-out store or a protocol keyword in a docstring never fires.

The port of ``pbs_tpu.analysis.memmodel.seqlockpass``. Departure: a
file's place is found by the path part ``pbs_tpu_torch`` (exactly that
part, so a tree that holds both packages anchors each file under its
own) and module prefixes ``pbs_tpu_torch.``; messages and hints name the
port's modules.
"""

from __future__ import annotations

import re

from pbs_tpu_torch.analysis.core import (
    CheckContext,
    CSourceFile,
    Finding,
    Pass,
    SourceFile,
    qualified_name,
)
from pbs_tpu_torch.analysis.memmodel import ctokens

#: Python modules that own raw seqlock/journal writes; everything
#: else must go through their APIs (paths anchored below pbs_tpu_torch/).
SANCTIONED_WRITERS = frozenset({
    "knobs/channel.py",
    "telemetry/ledger.py",
    "obs/trace.py",
    "gateway/journal.py",
    "runtime/doorbell.py",
})

#: Private writer-helper method names (the seqlock bracket + store
#: primitives of ledger.py / channel.py).
_WRITER_HELPERS = frozenset({"_begin", "_end", "_store"})

_BEGIN_RE = re.compile(r"\bwrite_begin\s*\(\s*(\w+)\s*\)")
_END_RE = re.compile(r"\bwrite_end\s*\(\s*(\w+)\s*\)")

#: A slot-pointer derivation: the two shapes the tree uses.
_SLOT_DECL_RE = re.compile(
    r"(?:const\s+)?uint64_t\s*\*\s*(\w+)\s*=\s*"
    r"(?:slot_ptr\s*\(|\w+\s*\+\s*\w+\s*\*\s*kSlotWords)")

#: A pointer alias via arithmetic: ``uint64_t* rec = buf + ...``.
_ALIAS_DECL_RE = re.compile(
    r"(?:const\s+)?uint64_t\s*\*\s*(\w+)\s*=\s*(\w+)\s*\+")

#: A version-word load inside a reader loop: ``v = __atomic_load_n(
#: &base[0], ORDER)``.
_VLOAD_RE = re.compile(
    r"(?:(\w+)\s*=\s*)?__atomic_load_n\s*\(\s*&\s*(\w+)\s*\[\s*0\s*\]"
    r"\s*,\s*(__ATOMIC_\w+)")


def _anchored(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    if "pbs_tpu_torch" in parts:
        parts = parts[parts.index("pbs_tpu_torch") + 1:]
    return "/".join(parts)


def _is_test(rel_path: str) -> bool:
    norm = rel_path.replace("\\", "/")
    return "tests/" in norm or norm.rsplit("/", 1)[-1].startswith("test_")


class SeqlockDisciplinePass(Pass):
    id = "seqlock-discipline"
    rules = ("seqlock-missing-release", "seqlock-plain-store",
             "seqlock-unbalanced", "seqlock-reader-protocol",
             "seqlock-ring-publish", "seqlock-raw-py-write")
    description = (
        "the file-backed seqlock memory model stays well-formed on "
        "both sides of the language boundary: C writers bracket every "
        "slot store in release-ordered write_begin/write_end pairs, "
        "reader retry loops carry acquire loads + fences + the "
        "v0==v1-and-even re-check, ring heads publish with release "
        "after the payload memcpy, and Python code outside the "
        "sanctioned writer modules never raw-writes a seqlock-backed "
        "buffer (struct.pack_into / os.pwrite / ._begin/._end/._store)")

    # -- C side ----------------------------------------------------------

    def run_c(self, csrc: CSourceFile, ctx: CheckContext) -> list[Finding]:
        text = ctokens.nocomment_text(csrc)
        out: list[Finding] = []
        for fn in ctokens.functions(text):
            if fn.name in ("write_begin", "write_end"):
                out.extend(self._check_helper(csrc, text, fn))
                continue
            out.extend(self._check_brackets(csrc, text, fn))
            out.extend(self._check_readers(csrc, text, fn))
            out.extend(self._check_publish(csrc, text, fn))
        return out

    def _check_helper(self, csrc, text, fn) -> list[Finding]:
        """write_begin/write_end must release-store the version word
        and carry a release fence."""
        out = []
        stores = [m for m in ctokens.ATOMIC_STORE_RE.finditer(fn.body)
                  if m.group(2).strip() == "0"]
        if not any(m.group(3) == "__ATOMIC_RELEASE" for m in stores):
            out.append(Finding(
                "seqlock-missing-release", csrc.rel_path, fn.line, 0,
                f"{fn.name} does not store the version word with "
                "__ATOMIC_RELEASE — the odd/even bracket orders "
                "nothing and readers can observe torn payloads",
                hint="__atomic_store_n(&s[0], v + 1, __ATOMIC_RELEASE)"))
        fences = [m.group(1)
                  for m in ctokens.FENCE_RE.finditer(fn.body)]
        if "__ATOMIC_RELEASE" not in fences:
            out.append(Finding(
                "seqlock-missing-release", csrc.rel_path, fn.line, 0,
                f"{fn.name} has no __atomic_thread_fence("
                "__ATOMIC_RELEASE) — payload stores can reorder "
                "across the version-word flip",
                hint="fence between the version store and the payload "
                     "(write_begin: after the store; write_end: "
                     "before it)"))
        return out

    def _check_brackets(self, csrc, text, fn) -> list[Finding]:
        """Stores through slot pointers stay inside write_begin/
        write_end brackets; bracket calls balance per function."""
        out = []
        guarded = {m.group(1)
                   for m in _SLOT_DECL_RE.finditer(fn.body)}
        begins = [(m.start(), m.group(1))
                  for m in _BEGIN_RE.finditer(fn.body)]
        ends = [(m.start(), m.group(1))
                for m in _END_RE.finditer(fn.body)]
        if len(begins) != len(ends):
            out.append(Finding(
                "seqlock-unbalanced", csrc.rel_path, fn.line, 0,
                f"{fn.name} calls write_begin {len(begins)}x but "
                f"write_end {len(ends)}x — some path leaves the "
                "version word odd and readers spin forever",
                hint="every write_begin(s) needs exactly one "
                     "write_end(s) on every path"))
        if not guarded:
            return out
        events = sorted(
            [(off, "begin", var) for off, var in begins]
            + [(off, "end", var) for off, var in ends]
            + [(off, "store", var)
               for off, var in ctokens.plain_stores(fn.body)
               if var in guarded])
        depth: dict[str, int] = {}
        for off, kind, var in events:
            if kind == "begin":
                depth[var] = depth.get(var, 0) + 1
            elif kind == "end":
                depth[var] = depth.get(var, 0) - 1
            elif depth.get(var, 0) <= 0:
                line = ctokens.line_of(text, fn.body_start + 1 + off)
                out.append(Finding(
                    "seqlock-plain-store", csrc.rel_path, line, 0,
                    f"{fn.name} stores into seqlock slot {var!r} "
                    "outside a write_begin/write_end bracket — a "
                    "concurrent snapshot reads the torn payload as "
                    "consistent",
                    hint=f"bracket the store: write_begin({var}); "
                         f"... write_end({var});"))
        return out

    def _check_readers(self, csrc, text, fn) -> list[Finding]:
        """Every retry loop (>= 2 version-word loads of one buffer)
        carries the full read protocol."""
        out = []
        for loop_off, lbody in ctokens.loops(fn.body):
            by_base: dict[str, list] = {}
            for m in _VLOAD_RE.finditer(lbody):
                by_base.setdefault(m.group(2), []).append(m)
            line = ctokens.line_of(text, fn.body_start + 1 + loop_off)
            for base, loads in sorted(by_base.items()):
                if len(loads) < 2:
                    continue
                for m in loads:
                    if m.group(3) != "__ATOMIC_ACQUIRE":
                        out.append(Finding(
                            "seqlock-reader-protocol", csrc.rel_path,
                            line, 0,
                            f"{fn.name}: retry-loop version load of "
                            f"{base}[0] uses {m.group(3)} — both "
                            "loads must be __ATOMIC_ACQUIRE or the "
                            "payload copy can hoist above them",
                            hint="__atomic_load_n(&s[0], "
                                 "__ATOMIC_ACQUIRE)"))
                names = [m.group(1) for m in loads if m.group(1)]
                if not any(re.search(rf"\b{re.escape(nm)}\s*&\s*1\b",
                                     lbody) for nm in names):
                    out.append(Finding(
                        "seqlock-reader-protocol", csrc.rel_path,
                        line, 0,
                        f"{fn.name}: retry loop over {base} never "
                        "rejects odd versions — it can copy a "
                        "half-written slot while the writer is inside "
                        "the bracket",
                        hint="if (v0 & 1) continue;  before the "
                             "payload copy"))
                recheck = any(
                    re.search(rf"\b{re.escape(a)}\s*[!=]=\s*"
                              rf"{re.escape(b)}\b", lbody)
                    for a in names for b in names if a != b)
                if len(names) >= 2 and not recheck:
                    out.append(Finding(
                        "seqlock-reader-protocol", csrc.rel_path,
                        line, 0,
                        f"{fn.name}: retry loop over {base} never "
                        "compares the two version reads — a write "
                        "completing mid-copy goes unnoticed",
                        hint="if (v0 == v1) return;  else retry"))
                acq_fences = [m for m in ctokens.FENCE_RE.finditer(lbody)
                              if m.group(1) == "__ATOMIC_ACQUIRE"]
                if len(acq_fences) < 2:
                    out.append(Finding(
                        "seqlock-reader-protocol", csrc.rel_path,
                        line, 0,
                        f"{fn.name}: retry loop over {base} has "
                        f"{len(acq_fences)} acquire fence(s) — the "
                        "payload copy needs one on each side to pair "
                        "with the writer's release fences",
                        hint="__atomic_thread_fence(__ATOMIC_ACQUIRE) "
                             "before and after the memcpy"))
        return out

    def _check_publish(self, csrc, text, fn) -> list[Finding]:
        """Ring-head publication: payload first, release-store last."""
        out = []
        alias = {m.group(1): m.group(2)
                 for m in _ALIAS_DECL_RE.finditer(fn.body)}

        def resolve(var: str) -> str:
            seen = set()
            while var in alias and var not in seen:
                seen.add(var)
                var = alias[var]
            return var

        plain: dict[str, list[int]] = {}
        for off, var in ctokens.plain_stores(fn.body):
            plain.setdefault(resolve(var), []).append(off)
        atomics: dict[str, list] = {}
        for m in ctokens.ATOMIC_STORE_RE.finditer(fn.body):
            atomics.setdefault(resolve(m.group(1)), []).append(m)
        for base in sorted(set(plain) & set(atomics)):
            for m in atomics[base]:
                if m.group(3) != "__ATOMIC_RELEASE":
                    line = ctokens.line_of(
                        text, fn.body_start + 1 + m.start())
                    out.append(Finding(
                        "seqlock-ring-publish", csrc.rel_path, line, 0,
                        f"{fn.name} publishes {base}[{m.group(2).strip()}]"
                        f" with {m.group(3)} while plain-storing "
                        "payload into the same buffer — consumers can "
                        "read records the head does not cover",
                        hint="publish with __ATOMIC_RELEASE after the "
                             "payload stores"))
            last_pub = max(m.start() for m in atomics[base])
            for off in plain[base]:
                if off > last_pub:
                    line = ctokens.line_of(
                        text, fn.body_start + 1 + off)
                    out.append(Finding(
                        "seqlock-ring-publish", csrc.rel_path, line, 0,
                        f"{fn.name} stores payload into {base} AFTER "
                        "publishing its head/version word — the "
                        "publish covers bytes not yet written",
                        hint="move every payload store before the "
                             "__ATOMIC_RELEASE publish"))
        return out

    # -- Python mirror ---------------------------------------------------

    def run(self, src: SourceFile, ctx: CheckContext) -> list[Finding]:
        import ast

        if src.tree is None or _is_test(src.rel_path):
            return []
        anchored = _anchored(src.rel_path)
        if anchored in SANCTIONED_WRITERS or \
                anchored.startswith("analysis/"):
            return []
        out: list[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = qualified_name(node.func) or ""
            attr = node.func.attr \
                if isinstance(node.func, ast.Attribute) else ""
            if qn.endswith(".pack_into") or qn == "pack_into":
                what = "struct.pack_into"
            elif qn == "os.pwrite" or qn.endswith(".pwrite"):
                what = "os.pwrite"
            elif attr in _WRITER_HELPERS:
                what = f".{attr}()"
            else:
                continue
            out.append(Finding(
                "seqlock-raw-py-write", src.rel_path, node.lineno,
                node.col_offset,
                f"raw seqlock-buffer write ({what}) outside the "
                "sanctioned writer modules — the version-word "
                "discipline lives in Ledger/TraceRing/KnobChannel/"
                "IntentJournal, and a bypass writes torn bytes no "
                "reader can detect",
                hint="go through the owning writer API (telemetry/"
                     "ledger.py, obs/trace.py, knobs/channel.py, "
                     "gateway/journal.py, runtime/doorbell.py)"))
        return out
