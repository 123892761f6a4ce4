"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, and loaded with ``ctypes``. A
library's file name carries a digest of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale build is never loaded; builds land in ``pbs_tpu_torch/build/``
(listed in ``.gitignore``) at first use, or all at once through
:func:`build`, which starts one ``nvcc`` per source and waits for all.

Nothing here runs at import time: the CPU tests import every module on
a host with no ``nvcc``. A failed build raises :class:`BuildError`; no
caller falls back to a plain version because a kernel did not build.

Every finished ``nvcc`` run is reported to the port's ``CompileMeter``
as one backend-compile event of its own wall seconds, and every first
load of a library as a front-end event, both in the calling thread, so
they land in the scope of whichever job's dispatch asked for them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pbs_tpu_torch.telemetry.compile import (BACKEND_COMPILE_EVENT,
                                             FRONTEND_EVENTS, CompileMeter)

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

#: Kernel sources, by library name (``csrc/<name>.cu``).
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "instrumented_matmul")

#: The routes a wrapper can launch: Hopper tensor cores (wgmma on TMA-loaded
#: tiles) or fp32 FMAs on the CUDA cores. Each wrapper counts its launches
#: per route in ``launches_by_route``.
ROUTES = ("wgmma", "simt")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already built
    log: str  # nvcc's stderr (``-Xptxas -v`` register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found on PATH or at /usr/local/cuda/bin")


def source_path(name: str) -> Path:
    if name not in KERNEL_SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {KERNEL_SOURCES}")
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _finish(proc: subprocess.Popen) -> tuple[str, str, float]:
    """Wait for one ``nvcc``: (stdout, stderr, the moment it ended)."""
    stdout, stderr = proc.communicate()
    return stdout, stderr, time.monotonic()


def build(names: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, BuildResult]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together, and report each finished run to
    the ``CompileMeter``. Raises BuildError naming every source that
    failed, with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    if not running:
        return results
    # One waiter per process, so each run's seconds end when it ends,
    # not when the runs before it in this loop have been waited for.
    with ThreadPoolExecutor(len(running)) as pool:
        ended = {name: pool.submit(_finish, proc)
                 for name, (proc, *_) in running.items()}
    meter = CompileMeter.install()
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        stdout, stderr, t1 = ended[name].result()
        seconds = t1 - t0
        log = (stdout + stderr).strip()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a file
        meter._on_event(BACKEND_COMPILE_EVENT, seconds)
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise BuildError("kernel build failed:\n" + "\n".join(failures))
    return results


_loaded: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed
    (once per process: a loaded library cannot be unloaded)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        t0 = time.monotonic()
        lib = _loaded[name] = ctypes.CDLL(str(path))
        CompileMeter.install()._on_event(FRONTEND_EVENTS[0],
                                         time.monotonic() - t0)
    return lib


def tma_addressable(t) -> bool:
    """Whether TMA can read the contiguous bf16 tensor ``t`` as rows of
    its last dimension: a 16-byte aligned base and a row pitch that is a
    multiple of 16 bytes. The tensor-core routes take such tensors only."""
    return (t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
            and (t.shape[-1] * t.element_size()) % 16 == 0)


def new_route_counts() -> dict[str, int]:
    return dict.fromkeys(ROUTES, 0)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``; every
    source exports ``pbs_error_string`` for the message."""
    if rc != 0:
        fn = lib.pbs_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({fn(rc).decode()}) at launch")
