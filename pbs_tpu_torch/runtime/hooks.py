"""Lifecycle hook scripts: the Xen hotplug-script analog.

The port of ``pbs_tpu.runtime.hooks``.

Reference: domain lifecycle drives ``/etc/xen/scripts/*`` — vif/vbd
hotplug scripts run with a device environment on attach/detach, and a
script failure fails the attach (the domain doesn't get a half-plugged
device). The accelerator analog attaches side-effectful environment setup to
job lifecycle: mounting a dataset path, registering with an external
tracker, tearing down exports — things the framework itself should not
hardcode.

Hooks may be Python callables (``fn(event, env)``) or shell commands
(run with the event environment exported as ``PBST_*`` variables, the
exact hotplug-script contract). ``required=True`` hooks propagate
failure — an admission hook that raises aborts ``add_job`` and the
partition unwinds the whole admission (the attach-fails semantics);
optional hooks are contained and counted.
"""

from __future__ import annotations

import subprocess
from typing import Callable

EVENTS = ("job-add", "job-remove", "job-fail", "job-sleep", "job-wake")


class HookError(RuntimeError):
    """A required hook failed; the triggering operation must unwind."""


class HookRegistry:
    def __init__(self):
        self._hooks: dict[str, list[tuple[object, bool]]] = {
            e: [] for e in EVENTS}
        self.failures = 0
        self.fired = 0

    def on(self, event: str, hook: "Callable | str",
           required: bool = False) -> None:
        """Register a callable ``fn(event, env)`` or a shell command
        string for ``event``."""
        if event not in self._hooks:
            raise ValueError(f"unknown hook event {event!r}; "
                             f"one of {EVENTS}")
        self._hooks[event].append((hook, required))

    def fire(self, event: str, env: dict[str, str],
             console=None) -> None:
        """Run all hooks for ``event``. Optional-hook failures are
        contained (counted, logged to ``console`` when given);
        required-hook failures raise :class:`HookError`."""
        for hook, required in self._hooks.get(event, ()):
            self.fired += 1
            try:
                if callable(hook):
                    hook(event, dict(env))
                else:
                    import os

                    proc = subprocess.run(
                        str(hook), shell=True, capture_output=True,
                        timeout=60, env={**os.environ, **env},
                    )
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"hook command rc={proc.returncode}: "
                            f"{proc.stderr.decode(errors='replace')[-200:]}")
            except Exception as e:  # noqa: BLE001 — containment decision
                self.failures += 1
                if console is not None:
                    console.write(f"[hook:{event}] FAILED: {e}")
                if required:
                    raise HookError(f"{event} hook failed: {e}") from e

    def dump(self) -> dict:
        return {
            "registered": {e: len(h) for e, h in self._hooks.items() if h},
            "fired": self.fired,
            "failures": self.failures,
        }
