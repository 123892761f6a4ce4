"""Checkpoint/resume: save/restore for jobs, fixing the reference's gap.

The port of ``pbs_tpu.ckpt.checkpoint``. Reference path: ``xl
save|restore|migrate`` -> libxl -> ``tools/libxc/xc_domain_save.c`` /
``xc_domain_restore.c``; Remus layers continuous sub-second checkpoints
on the same machinery for fault tolerance. Known reference gap: perfctr
counter state is NOT in the save/restore records and silently resets on
migration — here the telemetry ledger slice is a first-class checkpoint
record.

The on-disk format is the JAX package's, word for word, so a checkpoint
saved by either package restores in the other: a directory of flat
``leaf_%05d.npy`` files, one per leaf in ``jax.tree_util``'s flatten
order (dict keys sorted; ``utils.tree``), plus ``manifest.json`` with
the same keys, dtype names and key-path tokens. Writes go to a temp
directory published by an atomic symlink swap — a crash mid-save never
corrupts the latest checkpoint. ``Replicator`` re-checkpoints on a
period and keeps the last N (Remus's continuous replication, minus the
network hop).

Leaves are tensors (any device), numpy arrays and Python scalars. A
bf16 tensor is written as the JAX package writes an ml_dtypes bf16
array: raw 2-byte records under the header dtype ``'<V2'``, manifest
dtype ``"bfloat16"``, so the files are byte-identical. It is read back
through the manifest's dtype (the raw bytes viewed as int16, then as
``torch.bfloat16``), bit for bit; the reference's own restore refuses
such a leaf (``|V2`` against its template's ``bfloat16``), a departure
by design that ROADMAP queue 3 records. Restored tensor leaves land on
their template leaf's device; :func:`load_checkpoint` returns CPU
tensors.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from pbs_tpu_torch.faults import injector as _faults
from pbs_tpu_torch.faults.injector import InjectedFault
from pbs_tpu_torch.utils.tree import (flatten_with_path, tree_flatten,
                                      tree_unflatten)

MANIFEST = "manifest.json"

_gen_counter = itertools.count()

#: The ``.npy`` header dtype of a bf16 leaf (what ``np.save`` writes for
#: an ml_dtypes bfloat16 array).
_BF16_DESCR = "<V2"


def _path_tokens(path: tuple) -> list | None:
    """Serialize a tree path to JSON tokens, or None when a dict key is
    not a string (a template-free restore could not rebuild it)."""
    toks: list = []
    for kind, key in path:
        if kind == "d" and not isinstance(key, str):
            return None
        toks.append([kind, key])
    return toks or None  # a bare-leaf state has no path to rebuild


def _plain_tree(node) -> bool:
    """True when the state is rebuildable from key paths alone: nested
    str-keyed dicts and LISTS of leaves. Tuples are excluded — key
    paths cannot distinguish tuple from list, so a round-trip would
    silently change the tree structure."""
    if isinstance(node, dict):
        return all(isinstance(k, str) and _plain_tree(v)
                   for k, v in node.items())
    if isinstance(node, list):
        return all(_plain_tree(v) for v in node)
    return not isinstance(node, tuple)


def _insert(root, toks, value):
    """Build nested dict/list structure along ``toks``."""
    key = toks[0][1]
    if len(toks) == 1:
        if toks[0][0] == "d":
            root[key] = value
        else:
            while len(root) <= key:
                root.append(None)
            root[key] = value
        return
    nxt_container: Any = {} if toks[1][0] == "d" else []
    if toks[0][0] == "d":
        child = root.setdefault(key, nxt_container)
    else:
        while len(root) <= key:
            root.append(None)
        if root[key] is None:
            root[key] = nxt_container
        child = root[key]
    _insert(child, toks[1:], value)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under numpy's name for it (``torch.float32`` ->
    ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _host_leaf(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array whose bytes a leaf's file holds, its manifest dtype).
    A bf16 tensor gives its raw bytes as int16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), _dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load_leaf(path: str, dtype: str) -> np.ndarray | torch.Tensor:
    """A leaf file as numpy, or as a bf16 CPU tensor where the manifest
    says ``"bfloat16"`` and the file holds raw 2-byte records."""
    arr = np.load(path)
    if dtype == "bfloat16" and arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _loaded_dtype(arr) -> str:
    return (_dtype_name(arr.dtype) if isinstance(arr, torch.Tensor)
            else str(arr.dtype))


def save_checkpoint(path: str, state: Any, metadata: dict | None = None,
                    telemetry: np.ndarray | None = None) -> dict:
    """Atomically write ``state`` (a tree of tensors, arrays and
    scalars) to ``path``. Returns the manifest."""
    # One traversal yields leaves and key paths. Key paths enable
    # template-free load_checkpoint for plain dict/list trees (param
    # trees); tuples and bare-leaf states fall back to the
    # template-based restore_checkpoint.
    flat = flatten_with_path(state)
    leaves = [v for _, v in flat]
    _, treedef = tree_flatten(state)
    if _plain_tree(state):
        paths = [_path_tokens(p) for p, _ in flat]
    else:
        paths = [None] * len(leaves)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=parent)
    # ``ckpt.write`` injection point (stream key = checkpoint basename,
    # logical and run-stable): 'torn' dies mid-serialization — half the
    # leaves written, no manifest, nothing published — which is exactly
    # the crash the atomic symlink-swap design defends against; any
    # previously published generation at ``path`` must remain loadable.
    # 'delay' stretches the write (a slow disk under the async saver).
    fault = _faults.consult("ckpt.write", os.path.basename(path))
    try:
        if fault is not None and fault.fault == "delay":
            time.sleep(float(fault.args.get("delay_s", 0.001)))
        tear_at = len(leaves) // 2 if (
            fault is not None and fault.fault == "torn") else None
        entries = []
        total = 0
        for i, leaf in enumerate(leaves):
            if tear_at is not None and i >= tear_at:
                raise InjectedFault(
                    f"injected torn checkpoint write at leaf {i}/"
                    f"{len(leaves)} ({os.path.basename(path)})")
            arr, dtype = _host_leaf(leaf)
            fname = f"leaf_{i:05d}.npy"
            _save_leaf(os.path.join(tmp, fname), arr, dtype)
            entry = {"file": fname, "shape": list(arr.shape),
                     "dtype": dtype}
            if paths[i] is not None:
                entry["path"] = paths[i]
            entries.append(entry)
            total += arr.nbytes
        if tear_at is not None:
            # Leafless state (empty tree): the tear still has to fire
            # before the manifest makes the write look complete.
            raise InjectedFault(
                f"injected torn checkpoint write (pre-manifest, "
                f"{os.path.basename(path)})")
        if telemetry is not None:
            np.save(os.path.join(tmp, "telemetry.npy"),
                    np.asarray(telemetry))
        manifest = {
            "version": 1,
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "leaves": entries,
            "bytes": total,
            "has_telemetry": telemetry is not None,
            "metadata": metadata or {},
            "wall_time": time.time(),
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        # Atomic publish via symlink swap: ``path`` is a symlink to a
        # generation directory; POSIX cannot atomically swap two
        # directories, but replacing a symlink with os.replace IS
        # atomic, so there is no instant at which ``path`` is missing
        # or partial (libxc's two-phase final-suspend guarantee).
        gen = (f".{os.path.basename(path)}.gen."
               f"{int(time.time() * 1e6)}_{next(_gen_counter)}")
        gen_path = os.path.join(parent, gen)
        os.rename(tmp, gen_path)
        link_tmp = os.path.join(parent, gen + ".lnk")
        os.symlink(gen, link_tmp)
        if os.path.isdir(path) and not os.path.islink(path):
            # Migrating from a pre-symlink layout: move the real dir
            # aside first (non-atomic, once per migration only).
            os.rename(path, os.path.join(parent, gen + ".legacy"))
            shutil.rmtree(os.path.join(parent, gen + ".legacy"))
        os.replace(link_tmp, path)
        # Drop superseded generations.
        base = f".{os.path.basename(path)}.gen."
        for d in os.listdir(parent):
            if d.startswith(base) and d != gen and not d.endswith(".lnk"):
                shutil.rmtree(os.path.join(parent, d), ignore_errors=True)
        return manifest
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Template-free restore for checkpoints whose state is a plain
    dict/list tree (e.g. param trees): rebuilds the structure from the
    recorded leaf key paths, each leaf a CPU tensor. Returns (state,
    metadata). Raises ValueError for checkpoints without key paths (use
    :func:`restore_checkpoint` with a template there)."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    entries = manifest["leaves"]
    if not entries:
        return {}, manifest.get("metadata", {})
    if any("path" not in e for e in entries):
        raise ValueError(
            "checkpoint predates key-path manifests (or holds custom "
            "pytree nodes); use restore_checkpoint(path, like=...)")
    root: Any = {} if entries[0]["path"][0][0] == "d" else []
    for e in entries:
        arr = _load_leaf(os.path.join(path, e["file"]), e["dtype"])
        _insert(root, e["path"],
                arr if isinstance(arr, torch.Tensor)
                else torch.from_numpy(arr))
    return root, manifest.get("metadata", {})


def _template_dtype(tmpl: Any) -> str:
    if isinstance(tmpl, torch.Tensor):
        return _dtype_name(tmpl.dtype)
    tdtype = getattr(tmpl, "dtype", None)
    if tdtype is None:
        tdtype = np.asarray(tmpl).dtype
    return str(tdtype)


def _as_template_leaf(arr, tmpl: Any) -> Any:
    """A loaded leaf in its template leaf's kind: a tensor on the
    template's device, a numpy array, or a Python scalar."""
    if isinstance(tmpl, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(tmpl.device)
    if isinstance(tmpl, (bool, int, float, complex)):
        return type(tmpl)(arr.item())
    return arr


def restore_checkpoint(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (shape/dtype template).
    Returns (state, manifest). Each leaf comes back in its template
    leaf's kind: a tensor on the template's device, a numpy array, or a
    Python scalar. Telemetry (if present) is under
    manifest['_telemetry'] as an array."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has "
            f"{len(leaves_like)}"
        )
    leaves = []
    for i, (entry, tmpl) in enumerate(zip(manifest["leaves"], leaves_like)):
        arr = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"])
        tshape = tuple(np.shape(tmpl))
        if tuple(arr.shape) != tshape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(arr.shape)} != "
                f"template {tshape}"
            )
        tdtype = _template_dtype(tmpl)
        if _loaded_dtype(arr) != tdtype:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {_loaded_dtype(arr)} != "
                f"template {tdtype}"
            )
        leaves.append(_as_template_leaf(arr, tmpl))
    state = tree_unflatten(treedef, leaves)
    tpath = os.path.join(path, "telemetry.npy")
    if manifest.get("has_telemetry") and os.path.exists(tpath):
        manifest["_telemetry"] = np.load(tpath)
    return state, manifest


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST))


def remove_checkpoint(path: str) -> None:
    """Remove a checkpoint: the symlink and its generation directory
    (or a plain directory from the pre-symlink layout)."""
    if os.path.islink(path):
        target = os.path.join(os.path.dirname(os.path.abspath(path)),
                              os.readlink(path))
        os.unlink(path)
        shutil.rmtree(target, ignore_errors=True)
    elif os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)


def _snapshot_leaf(leaf: Any) -> Any:
    """A host copy of one leaf that aliases nothing the caller can
    mutate: a CUDA tensor into pinned host memory (the copy is queued
    on the current stream; :func:`_snapshot` waits for it), a CPU
    tensor cloned, a numpy array copied unless it owns fresh bytes."""
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            return host.copy_(leaf, non_blocking=True)
        return leaf.detach().clone()
    arr = np.asarray(leaf)
    if arr is leaf or not arr.flags.owndata:
        arr = arr.copy()
    return arr


def _snapshot(state: Any) -> Any:
    leaves, treedef = tree_flatten(state)
    host = [_snapshot_leaf(leaf) for leaf in leaves]
    for dev in {leaf.device for leaf in leaves
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return tree_unflatten(treedef, host)


class AsyncCheckpointer:
    """Orbax-style async save: the device→host snapshot happens
    synchronously on the caller's thread (consistent — the training
    step may update its tensors in place immediately after), while
    serialization + atomic publish run on a background thread, so
    checkpoint I/O overlaps the next training steps instead of stalling
    them. CUDA leaves are copied into pinned host memory, one
    synchronise for the whole state.

    One save in flight at a time (a second ``save`` waits for the
    first — same back-pressure contract as orbax's AsyncCheckpointer):
    unbounded queueing would hide a slow disk until memory ran out.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last_manifest: dict | None = None
        self.saves = 0

    def save(self, path: str, state: Any, metadata: dict | None = None,
             telemetry: np.ndarray | None = None) -> None:
        """Snapshot ``state`` to host NOW; write to ``path`` in the
        background. Raises any error from the PREVIOUS save (delayed
        failure must surface, not vanish)."""
        self.wait()  # back-pressure + surface prior failure
        # Host snapshot on the caller's thread: after this returns the
        # caller may freely mutate the device tensors.
        host_state = _snapshot(state)
        tel = None if telemetry is None else np.asarray(telemetry).copy()

        def _write() -> None:
            try:
                self._last_manifest = save_checkpoint(
                    path, host_state, metadata, tel)
                self.saves += 1
            except BaseException as e:  # noqa: BLE001 — re-raised at
                self._error = e  # the next save()/wait()

        self._thread = threading.Thread(
            target=_write, daemon=True, name="pbst-async-ckpt")
        self._thread.start()

    def wait(self, timeout: float | None = None) -> dict | None:
        """Join the in-flight save; returns its manifest (None if no
        save has completed). Raises a background failure exactly once."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("checkpoint write still in flight")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._last_manifest

    @property
    def in_flight(self) -> bool:
        t = self._thread  # capture: wait() may None it concurrently
        return t is not None and t.is_alive()


class Replicator:
    """Remus analog: continuous periodic checkpointing with retention.

    Runs in a background thread (the dom0 replication daemon analog);
    ``snapshot_fn`` must return (state, metadata, telemetry|None) — for
    jobs, capture at a step boundary (a step is never interrupted
    mid-way, which gives Remus's epoch consistency for free).
    """

    def __init__(self, base_dir: str, snapshot_fn, period_s: float = 1.0,
                 keep: int = 3):
        self.base_dir = base_dir
        self.snapshot_fn = snapshot_fn
        self.period_s = period_s
        self.keep = keep
        # Resume numbering past any epochs already on disk — a restarted
        # replicator must not write below the retained epochs (they'd be
        # pruned as "oldest" and latest() would pin the stale snapshot).
        self.epochs = self._next_epoch()
        self.failures = 0
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _next_epoch(self) -> int:
        if not os.path.isdir(self.base_dir):
            return 0
        nums = []
        for d in os.listdir(self.base_dir):
            if d.startswith("epoch_"):
                try:
                    nums.append(int(d[len("epoch_"):]))
                except ValueError:
                    continue
        return max(nums) + 1 if nums else 0

    def replicate_once(self) -> str:
        state, metadata, telemetry = self.snapshot_fn()
        epoch = self.epochs
        path = os.path.join(self.base_dir, f"epoch_{epoch:08d}")
        save_checkpoint(path, state, metadata, telemetry)
        self.epochs += 1
        self._prune()
        return path

    def _prune(self) -> None:
        if not os.path.isdir(self.base_dir):
            return
        epochs = sorted(
            d for d in os.listdir(self.base_dir) if d.startswith("epoch_")
        )
        for d in epochs[: max(0, len(epochs) - self.keep)]:
            remove_checkpoint(os.path.join(self.base_dir, d))

    def latest(self) -> str | None:
        if not os.path.isdir(self.base_dir):
            return None
        epochs = sorted(
            d for d in os.listdir(self.base_dir)
            if d.startswith("epoch_")
            and checkpoint_exists(os.path.join(self.base_dir, d))
        )
        return os.path.join(self.base_dir, epochs[-1]) if epochs else None

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.period_s):
                try:
                    self.replicate_once()
                    self.last_error = None
                except Exception as e:  # must never kill the job, but
                    self.failures += 1  # dead replication must be visible
                    self.last_error = f"{type(e).__name__}: {e}"

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
