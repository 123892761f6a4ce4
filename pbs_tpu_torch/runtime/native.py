"""ctypes bindings for the port's native runtime (``runtime/csrc/``).

The port of ``pbs_tpu.runtime.native``: a small C++ shared library over
flat u64 buffers — seqlock ledger writes and snapshots, the lockless
trace ring, log2 histograms, doorbells, the corpus row gather and the
sweep-mode sim dispatch core — bound with ctypes, plus a METH_FASTCALL
module over the same entry points. The sources are the port's own
copies (``csrc/pbst_runtime.cc``, ``csrc/pbst_fastcall.cc``): the C ABI,
byte layouts and arithmetic are the reference's, so a buffer written on
one tier, or by one package, reads the same on every other.

**Build.** At first use, ``g++ -O2 -std=c++17 -fPIC -shared`` compiles
each artifact into ``pbs_tpu_torch/build/`` (git-ignored) under a name
that carries a digest of its sources and flags (and, for the fastcall
module, of the interpreter it binds), so a stale library is never
loaded. Concurrent first uses take turns on an advisory lock, and each
build writes a temporary file renamed into place: processes that start
at once compile once and never map half a library.

**Fallback.** Every caller degrades to its pure-Python tier when the
library does not build or load — the tiers are bit-identical by
contract, so results do not change. The reason is cached
(:func:`unavailable_reason`, :func:`last_failure`) and logged once to
the system console ring. ``PBST_TORCH_NATIVE_LIB`` points the loader at
another build of the same ABI (the sanitizer builds of
:func:`build_library`), used as-is.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

from pbs_tpu_torch.obs.lockprof import ProfiledLock

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

#: The reference Makefile's compile line for the runtime library.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

#: Extra flags per artifact kind. "runtime" is the ctypes library;
#: "fastcall" the CPython module; "asan"/"ubsan" the sanitizer builds of
#: the runtime that tests load through ``PBST_TORCH_NATIVE_LIB``.
KIND_FLAGS = {
    "runtime": (),
    "fastcall": (),
    "asan": ("-fsanitize=address", "-fno-omit-frame-pointer"),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=undefined"),
}

BUILD_TIMEOUT_S = 120

#: Names an alternate build of the runtime ABI, used as-is (no build).
#: The port's own variable, so pointing one package at a sanitizer
#: build never redirects the other.
_LIB_OVERRIDE = os.environ.get("PBST_TORCH_NATIVE_LIB") or None

_lock = ProfiledLock("native_load")
_lib: ctypes.CDLL | None = None
_tried = False
_fc = None
_fc_tried = False
#: Why a native tier is unavailable (build or load failure), cached so
#: "why is everything on the Python tier" has an answer.
_fail_reason: str | None = None

_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)


class BuildError(RuntimeError):
    """``g++`` is missing or refused a source."""


def _note_failure(reason: str) -> None:
    global _fail_reason
    _fail_reason = reason
    from pbs_tpu_torch.obs import console

    console.log(f"native: runtime unavailable, pure-Python fallback "
                f"paths in use ({reason})")


def _sources(kind: str) -> tuple[Path, ...]:
    if kind == "fastcall":
        # pbst_fastcall.cc includes pbst_runtime.cc by name.
        return (CSRC_DIR / "pbst_fastcall.cc", CSRC_DIR / "pbst_runtime.cc")
    return (CSRC_DIR / "pbst_runtime.cc",)


def _command_flags(kind: str) -> tuple[str, ...]:
    flags = CXX_FLAGS + KIND_FLAGS[kind]
    if kind == "fastcall":
        flags += ("-I" + sysconfig.get_paths()["include"],)
    return flags


def artifact_path(kind: str = "runtime") -> Path:
    """Where ``kind``'s build lands: a name keyed by a digest of its
    sources, its flags and (fastcall) the interpreter's ABI."""
    if kind not in KIND_FLAGS:
        raise KeyError(f"unknown native artifact {kind!r}; "
                       f"have {tuple(KIND_FLAGS)}")
    h = hashlib.sha256()
    for src in _sources(kind):
        h.update(src.read_bytes())
    h.update(" ".join(_command_flags(kind)).encode())
    stem = "libpbst_runtime" if kind != "fastcall" else "pbst_fastcall"
    if kind == "fastcall":
        h.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    elif kind != "runtime":
        stem += f"_{kind}"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_library(kind: str = "runtime") -> Path:
    """Compile ``kind`` unless its digest-named artifact exists; returns
    the path. Raises :class:`BuildError` with the compiler's last lines.

    Processes that find the artifact missing at once take turns on an
    advisory lock beside it, so one compiles and the rest find its
    result (the kernel releases the lock if its holder dies); the
    compile writes a temporary file renamed into place, so no process
    maps half a library either way."""
    out = artifact_path(kind)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = ["g++", *_command_flags(kind), "-o", str(tmp),
               str(_sources(kind)[0])]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.SubprocessError) as e:
            raise BuildError(
                f"build not attempted: {type(e).__name__}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            tail = " | ".join(
                (proc.stderr or proc.stdout or "").strip().splitlines()[-4:])
            raise BuildError(f"g++ exited {proc.returncode}: {tail[:400]}")
        os.replace(tmp, out)  # atomic: no process maps half a library
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.pbst_ledger_slot_words.restype = ctypes.c_int
    lib.pbst_ledger_reset.argtypes = [_U64P, ctypes.c_int64]
    lib.pbst_ledger_resume.argtypes = [
        _U64P, ctypes.c_int64, ctypes.c_uint64, _U64P]
    lib.pbst_ledger_suspend.argtypes = [_U64P, ctypes.c_int64, _U64P]
    lib.pbst_ledger_add.argtypes = [
        _U64P, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
    lib.pbst_ledger_add_many.argtypes = [_U64P, ctypes.c_int64, _U64P]
    lib.pbst_ledger_snapshot.argtypes = [
        _U64P, ctypes.c_int64, _U64P, ctypes.c_int]
    lib.pbst_ledger_snapshot.restype = ctypes.c_int
    lib.pbst_ledger_tsc_start.argtypes = [_U64P, ctypes.c_int64]
    lib.pbst_ledger_tsc_start.restype = ctypes.c_uint64
    lib.pbst_ledger_snapshot_many.argtypes = [
        _U64P, ctypes.c_int64, _I64P, ctypes.c_int, _U64P, ctypes.c_int]
    lib.pbst_ledger_snapshot_many.restype = ctypes.c_int
    lib.pbst_hist_record.argtypes = [
        _U64P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int]
    lib.pbst_hist_record_many.argtypes = [
        _U64P, ctypes.c_int64, _I64P, _U64P, ctypes.c_int, ctypes.c_int]
    lib.pbst_hist_record_many.restype = ctypes.c_int
    lib.pbst_trace_init.argtypes = [_U64P, ctypes.c_uint64]
    lib.pbst_trace_emit.argtypes = [_U64P] + [ctypes.c_uint64] * 8
    lib.pbst_trace_emit.restype = ctypes.c_int
    lib.pbst_trace_emit_many.argtypes = [_U64P, _U64P, ctypes.c_int]
    lib.pbst_trace_emit_many.restype = ctypes.c_int
    lib.pbst_trace_consume.argtypes = [_U64P, _U64P, ctypes.c_int]
    lib.pbst_trace_consume.restype = ctypes.c_int
    lib.pbst_trace_lost.argtypes = [_U64P]
    lib.pbst_trace_lost.restype = ctypes.c_uint64
    # Layout getters: the Python mirrors can be checked against the
    # geometry the library was compiled with.
    lib.pbst_trace_rec_words.restype = ctypes.c_int
    lib.pbst_trace_header_words.restype = ctypes.c_int
    _U8P = ctypes.POINTER(ctypes.c_uint8)
    lib.pbst_gather_rows.argtypes = [
        _U8P, ctypes.c_uint64, _U64P, ctypes.c_int, ctypes.c_uint64, _U8P]
    lib.pbst_gather_rows.restype = ctypes.c_int
    lib.pbst_db_header_words.restype = ctypes.c_int
    lib.pbst_db_init.argtypes = [_U64P, ctypes.c_uint64]
    lib.pbst_db_valid.argtypes = [_U64P]
    lib.pbst_db_valid.restype = ctypes.c_int
    lib.pbst_db_send.argtypes = [_U64P, ctypes.c_uint64]
    lib.pbst_db_send.restype = ctypes.c_uint64
    lib.pbst_db_pending.argtypes = [_U64P, ctypes.c_uint64]
    lib.pbst_db_pending.restype = ctypes.c_uint64
    lib.pbst_db_take.argtypes = [_U64P, ctypes.c_uint64]
    lib.pbst_db_take.restype = ctypes.c_uint64
    lib.pbst_db_seq.argtypes = [_U64P]
    lib.pbst_db_seq.restype = ctypes.c_uint64
    lib.pbst_db_wait.argtypes = [_U64P, ctypes.c_uint64, ctypes.c_uint64]
    lib.pbst_db_wait.restype = ctypes.c_uint64
    # Sweep-mode sim dispatch core. The ABI/word getters let
    # sim/native_core.py assert that the layout it marshals is the one
    # this library was compiled with.
    _F64P = ctypes.POINTER(ctypes.c_double)
    for fn in ("pbst_sim_abi", "pbst_sim_gs_words", "pbst_sim_js_words",
               "pbst_sim_jf_words", "pbst_sim_ev_words"):
        getattr(lib, fn).restype = ctypes.c_int64
    lib.pbst_sim_run.restype = ctypes.c_int64
    lib.pbst_sim_run.argtypes = [
        _I64P, _F64P, _I64P, _F64P, _U64P, _U64P,  # gs gf js jf ctr prev
        _I64P, _F64P,                               # ph_i ph_f
        _I64P, _I64P, _F64P, _I64P,                 # heap runq window hist
        _U64P, _U64P, _U64P, _U64P, _U64P,          # rng/wt/ww/qt/qq tabs
        _I64P,                                      # ev
    ]


def load() -> ctypes.CDLL | None:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _LIB_OVERRIDE:
            path = _LIB_OVERRIDE
            if not os.path.exists(path):
                _note_failure(f"PBST_TORCH_NATIVE_LIB={path} does not exist")
                return None
        else:
            try:
                path = str(build_library("runtime"))
            except BuildError as e:
                _note_failure(str(e))
                return None
        try:
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        except (OSError, AttributeError) as e:
            _note_failure(f"load failed: {type(e).__name__}: {e}")
        return _lib


def available() -> bool:
    return load() is not None


def fastcall():
    """The METH_FASTCALL module over the same C entry points, or None.
    A tier above ctypes, not a replacement: it needs ``Python.h`` to
    build, and without it everything runs on the ctypes tier, with the
    reason cached for :func:`last_failure` and logged once."""
    global _fc, _fc_tried
    if load() is None:
        return None  # no base library: the reason is already cached
    with _lock:
        if _fc is not None or _fc_tried:
            return _fc
    # Build outside the lock, so a slow compile does not convoy every
    # ring and ledger constructor; a duplicate build is only wasted.
    try:
        path, err = build_library("fastcall"), None
    except BuildError as e:
        path, err = None, str(e)
    with _lock:
        if _fc is not None or _fc_tried:
            return _fc
        _fc_tried = True
        if path is None:
            _note_failure(f"fastcall tier unavailable ({err}); ctypes "
                          "tier in use")
            return None
        try:
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "pbst_fastcall", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            for sym in ("trace_emit", "trace_emit_many", "trace_consume",
                        "hist_record", "hist_record_many",
                        "ledger_snapshot_many", "sim_run"):
                if not hasattr(mod, sym):
                    raise AttributeError(f"stale fastcall module: {sym}")
            _fc = mod
        except Exception as e:  # wrong interpreter, missing symbol, ...
            _fc = None
            _note_failure(f"fastcall import failed ({type(e).__name__}: "
                          f"{e}); ctypes tier in use")
        return _fc


def tier() -> str:
    """The best tier this process reaches: "fastcall", "ctypes" or
    "python"."""
    if load() is None:
        return "python"
    return "fastcall" if fastcall() is not None else "ctypes"


def unavailable_reason() -> str | None:
    """Why :func:`load` returned None, or None when the library loads
    or no attempt failed yet."""
    load()
    return None if _lib is not None else (_fail_reason or "never attempted")


def last_failure() -> str | None:
    """The most recent cached failure of any tier, including a fastcall
    failure on a host whose base library loads (where
    :func:`unavailable_reason` is None)."""
    return _fail_reason


def as_u64p(arr: np.ndarray):
    """uint64 pointer into a (C-contiguous) numpy array's buffer."""
    assert arr.dtype == np.uint64 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(_U64P)


def as_i64p(arr: np.ndarray):
    """int64 pointer into a (C-contiguous) numpy array's buffer."""
    assert arr.dtype == np.int64 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(_I64P)


def as_f64p(arr: np.ndarray):
    """float64 pointer into a (C-contiguous) numpy array's buffer."""
    assert arr.dtype == np.float64 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
