"""Mandatory access control on control-plane ops (XSM/Flask analog).

The port of ``pbs_tpu.runtime.xsm``.

Reference: Xen's XSM (``xen/xsm/``, ~13k LoC) interposes a pluggable
security module on every sensitive hypercall: the default ``dummy``
module allows everything (classic dom0-is-root), while FLASK enforces
label-based policy (subject label × operation class × target label →
allow/deny) compiled from policy rules. Hooks sit at the hypercall
dispatch layer (``do_domctl``/``do_sysctl`` entry), not inside the
subsystems.

Same shape here: :func:`xsm_check` is called at the control-plane
surfaces (agent ops, partition admission, store writes) with a subject
label, an operation name, and a target label. :class:`DummyPolicy`
allows all; :class:`LabelPolicy` evaluates explicit rules with a
configurable default. Labels live on jobs (``Job(label=...)``) and on
RPC peers (agents attach a subject to incoming ops).
"""

from __future__ import annotations

import dataclasses
import fnmatch

from pbs_tpu_torch.obs.lockprof import ProfiledLock

#: The all-powerful subject (dom0 / system_u in FLASK terms).
SYSTEM = "system"


class XsmDenied(PermissionError):
    def __init__(self, subject: str, op: str, target: str | None):
        tgt = f" target={target!r}" if target is not None else ""
        super().__init__(f"xsm: {subject!r} denied {op!r}{tgt}")
        self.subject = subject
        self.op = op
        self.target = target


class DummyPolicy:
    """Allow-everything (the XSM dummy module)."""

    name = "dummy"

    def check(self, subject: str, op: str, target: str | None) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Rule:
    """allow/deny (subject-glob, op-glob, target-glob). First match
    wins, like an access-vector lookup."""

    subject: str
    op: str
    target: str  # a None target matches as "" (so "*" covers it)
    allow: bool

    def matches(self, subject: str, op: str, target: str | None) -> bool:
        return (fnmatch.fnmatchcase(subject, self.subject)
                and fnmatch.fnmatchcase(op, self.op)
                and fnmatch.fnmatchcase(target or "", self.target))


class LabelPolicy:
    """FLASK-style explicit rules over labels.

    ``default_allow=False`` is enforcing mode (deny anything unmatched);
    True is permissive-with-denials (useful for staged rollout). The
    ``system`` subject always passes — Xen likewise never locks out the
    hypervisor's own internal ops.
    """

    name = "label"

    def __init__(self, rules: list[Rule] | None = None,
                 default_allow: bool = False):
        self.rules = list(rules or [])
        self.default_allow = default_allow
        self.denials: list[tuple[str, str, str | None]] = []  # AVC log

    def allow(self, subject: str, op: str = "*", target: str = "*") -> "LabelPolicy":
        self.rules.append(Rule(subject, op, target, True))
        return self

    def deny(self, subject: str, op: str = "*", target: str = "*") -> "LabelPolicy":
        self.rules.append(Rule(subject, op, target, False))
        return self

    def check(self, subject: str, op: str, target: str | None) -> bool:
        if subject == SYSTEM:
            return True
        for r in self.rules:
            if r.matches(subject, op, target):
                if not r.allow:
                    self.denials.append((subject, op, target))
                return r.allow
        if not self.default_allow:
            self.denials.append((subject, op, target))
        return self.default_allow


_lock = ProfiledLock("xsm_policy")
_policy = DummyPolicy()


def set_policy(policy) -> None:
    """Install the active security module (boot-time XSM selection)."""
    global _policy
    with _lock:
        _policy = policy


def get_policy():
    return _policy


def xsm_check(subject: str, op: str, target: str | None = None) -> None:
    """Hook: raise :class:`XsmDenied` unless policy allows. Call sites
    mirror Xen's — at the operation dispatch surface, before any state
    changes."""
    if not _policy.check(subject, op, target):
        raise XsmDenied(subject, op, target)
