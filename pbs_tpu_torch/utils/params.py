"""Boot-parameter registry (boolean_param/integer_param analog).

The port of ``pbs_tpu.utils.params``: the same names, parsing and
``PBST_<NAME>`` environment variables, in a registry of the port's own.

Reference: hypervisor subsystems declare command-line knobs through
registration macros — ``boolean_param("perfctr", opt_perfctr_enabled)``
(``xen-4.2.1/xen/arch/x86/pmustate.c:27-28``),
``integer_param("sched_credit_tslice_us", sched_credit_tslice_us)``
(``xen/common/sched_credit.c:126-127``), ``sched=credit``
(``xen/common/schedule.c:65-70``) — all parsed once from the boot
command line. Here the same shape: modules declare typed params into a
process-global registry; values resolve from an explicit command line
(``parse_cmdline``) or from ``PBST_<NAME>`` environment variables, with
declaration-time defaults underneath.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable


class Param:
    """One registered knob. Read with ``.value`` (cheap, cached)."""

    def __init__(self, name: str, default: Any, parse: Callable[[str], Any],
                 is_bool: bool = False):
        self.name = name
        self.default = default
        self._parse = parse
        self._value = default
        self._explicit = False  # set via cmdline/env (wins over default)
        self.is_bool = is_bool  # bare / "no-" cmdline forms allowed

    @property
    def value(self) -> Any:
        return self._value

    def set(self, raw: str) -> None:
        self._value = self._parse(raw)
        self._explicit = True

    def reset(self) -> None:
        self._value = self.default
        self._explicit = False

    def __repr__(self) -> str:
        src = "set" if self._explicit else "default"
        return f"Param({self.name}={self._value!r} [{src}])"


_lock = threading.Lock()
_registry: dict[str, Param] = {}


def _parse_bool(raw: str) -> bool:
    # The reference accepts "no-<param>"/empty/1/0 forms (xen/common/kernel.c
    # parse_params); accept the common spellings.
    low = raw.strip().lower()
    if low in ("", "1", "on", "true", "yes", "enable"):
        return True
    if low in ("0", "off", "false", "no", "disable"):
        return False
    raise ValueError(f"bad boolean param value {raw!r}")


def _register(name: str, default: Any, parse: Callable[[str], Any],
              is_bool: bool = False) -> Param:
    with _lock:
        if name in _registry:
            # Same-module re-import: keep the existing param (and any
            # explicitly-set value) rather than silently resetting it.
            return _registry[name]
        p = Param(name, default, parse, is_bool=is_bool)
        env = os.environ.get("PBST_" + name.upper().replace("-", "_"))
        if env is not None:
            # Same contract as parse_cmdline: a bad value is warned about
            # and ignored, never fatal — params register at module import,
            # so raising here would make the whole package unimportable.
            try:
                p.set(env)
            except (ValueError, TypeError):
                import sys

                print(f"pbst: bad env value PBST_{name.upper()}={env!r}; "
                      f"using default {default!r}", file=sys.stderr)
        _registry[name] = p
        return p


def boolean_param(name: str, default: bool = False) -> Param:
    return _register(name, default, _parse_bool, is_bool=True)


def integer_param(name: str, default: int = 0) -> Param:
    return _register(name, default, lambda r: int(r, 0))


def string_param(name: str, default: str = "") -> Param:
    return _register(name, default, str)


def custom_param(name: str, default: Any, parse: Callable[[str], Any]) -> Param:
    return _register(name, default, parse)


def parse_cmdline(cmdline: str) -> list[str]:
    """Apply a space-separated ``name=value`` / ``name`` / ``no-name``
    string to the registry; returns the rejected tokens — unknown names
    and unparseable values (the reference warns about those at boot
    rather than failing it, ``xen/common/kernel.c``)."""
    rejected: list[str] = []
    for tok in cmdline.split():
        name, has_eq, raw = tok.partition("=")
        neg = name.startswith("no-")
        if neg:
            name = name[3:]
        with _lock:
            p = _registry.get(name)
        if p is None:
            rejected.append(tok)
            continue
        if (neg or not has_eq) and not p.is_bool:
            # Bare / "no-" forms only make sense for booleans; applying
            # them to e.g. a string param would silently set the literal
            # "on"/"off" and blow up far from the parse site.
            rejected.append(tok)
            continue
        try:
            p.set("off" if neg else (raw if has_eq else "on"))
        except (ValueError, TypeError):
            rejected.append(tok)
    return rejected


def get(name: str) -> Param:
    with _lock:
        return _registry[name]


def dump() -> dict[str, Any]:
    """All registered params and their effective values."""
    with _lock:
        return {n: p.value for n, p in sorted(_registry.items())}


def reset_all() -> None:
    """Test hook: restore every param to its declaration default."""
    with _lock:
        for p in _registry.values():
            p.reset()
