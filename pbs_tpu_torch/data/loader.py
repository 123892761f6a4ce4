"""Prefetching batch loader: overlap host I/O with device compute.

The port of ``pbs_tpu.data.loader``. The card must never wait on the
host, so batches are built (mmap gather) and transferred from a
background thread into a small bounded queue while the current step
runs — classic double buffering.

The default placement for a CUDA device stages each batch in a pinned
host tensor of its own (a staging buffer is never reused while its
copy is in flight: the caching host allocator hands the block out again
only after the copy's event), copies it non-blocking on a side stream
and records an event; ``Prefetcher.__next__`` makes the consumer's
current stream wait on that event and hands the tensor to that stream
(``record_stream``). With ``device="cpu"`` a batch is a plain
``torch.from_numpy``; the pipeline logic is identical.

The loader is a plain iterator so it plugs into a Job as
``step_fn=lambda s: train_step(s, next(batches))`` or feeds a scanned
multi-step chunk.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from pbs_tpu_torch.data.tokens import TokenDataset


def make_batch_source(ds: TokenDataset, batch: int, seq_len: int,
                      seed: int = 0) -> Callable[[], np.ndarray]:
    """Stateful sampler closure: each call returns one (B, S) batch."""
    rng = np.random.default_rng(seed)

    def source() -> np.ndarray:
        return ds.sample(batch, seq_len, rng)

    return source


class ShardedBatchSource:
    """Multi-host data-parallel sampling with a checkpointable cursor.

    Every host derives the SAME per-step window schedule from
    ``(seed, step)`` — no cross-host communication, the standard
    multi-host recipe — and takes its own disjoint row slice of the
    global batch: host h of n gets rows [h*B/n, (h+1)*B/n). The step
    counter is the whole cursor, so checkpoint/resume is
    ``state()``/``load_state()`` with one int — on restore every host
    resumes the identical schedule position (the reference's analog:
    migration records the exact phase cursor so a restored guest does
    not replay I/O — SURVEY.md §5 checkpoint/resume).

    Under a :class:`Prefetcher` the cursor counts *sourced* batches,
    which run ``depth`` ahead of consumption by a thread-timing-
    dependent amount. Single-host that merely skips in-flight batches
    on restore (never replays — the right bias for training data);
    MULTI-host it would desync the hosts' shared schedule, so derive
    the checkpointed cursor from the CONSUMED count instead:
    ``dict(src.state(), step=consumed_steps)``.
    """

    def __init__(self, ds: TokenDataset, global_batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, seed: int = 0):
        if not (0 <= host_id < n_hosts):
            raise ValueError(f"host_id {host_id} outside [0, {n_hosts})")
        if global_batch % n_hosts:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"n_hosts {n_hosts}")
        self.ds = ds
        self.global_batch = global_batch
        self.per_host = global_batch // n_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.seed = seed
        self.step = 0

    def _starts(self, step: int) -> np.ndarray:
        span = self.ds.n_tokens - self.seq_len + 1
        if span <= 0:
            raise ValueError("seq_len exceeds corpus")
        rng = np.random.default_rng([self.seed, step])
        all_starts = rng.integers(0, span, size=self.global_batch)
        lo = self.host_id * self.per_host
        return all_starts[lo:lo + self.per_host].astype(np.int64)

    def __call__(self) -> np.ndarray:
        """One (B/n_hosts, S) batch; advances the cursor."""
        out = self.ds._gather(self._starts(self.step), self.seq_len)
        self.step += 1
        return out

    # -- checkpointable cursor ------------------------------------------

    def _schedule_id(self) -> dict:
        # EVERYTHING that determines the draw: seed (stream),
        # global_batch (draw size), seq_len (span), n_hosts (slicing).
        return {"seed": self.seed, "global_batch": self.global_batch,
                "seq_len": self.seq_len, "n_hosts": self.n_hosts}

    def state(self) -> dict:
        return dict(self._schedule_id(), step=self.step,
                    host_id=self.host_id)

    def load_state(self, state: dict) -> None:
        mine = self._schedule_id()
        theirs = {k: state.get(k) for k in mine}
        if theirs != mine:
            raise ValueError(
                "checkpoint cursor belongs to a different data schedule "
                f"({theirs} != {mine})")
        self.step = int(state["step"])


class _InFlight:
    """A batch on the card whose copy may still run on the loader's
    side stream."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: "torch.cuda.Event"):
        self.tensor = tensor
        self.event = event

    def ready(self) -> torch.Tensor:
        """The tensor, ordered for the calling thread's current stream."""
        stream = torch.cuda.current_stream(self.tensor.device)
        stream.wait_event(self.event)
        self.tensor.record_stream(stream)
        return self.tensor


def _cuda_place(device: torch.device) -> Callable[[np.ndarray], _InFlight]:
    """Pinned staging, a non-blocking copy on a side stream, an event."""
    side = torch.cuda.Stream(device)

    def place(batch: np.ndarray) -> _InFlight:
        staged = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
        with torch.cuda.stream(side):
            out = staged.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return _InFlight(out, done)

    return place


def _default_place(device: Any = None) -> Callable[[np.ndarray], Any]:
    """The placement :class:`Prefetcher` uses when given none: onto
    ``device`` (the card when None; raises without one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Prefetcher: no CUDA device is available; pass "
                "device='cpu' explicitly to load onto the host")
        return _cuda_place(dev)
    if dev.type != "cpu":
        raise ValueError(f"Prefetcher: unsupported device {dev}")
    return torch.from_numpy


class Prefetcher:
    """Background batch pipeline with a bounded queue.

    ``depth`` is the number of in-flight batches (2 = double buffer).
    ``place`` maps a host array to its device form (default
    ``_default_place(device)``: the card unless ``device`` is
    "cpu"); failures in the worker propagate to the consumer on the
    next ``__next__``.
    """

    def __init__(self, source: Callable[[], np.ndarray], depth: int = 2,
                 place: Callable | None = None, device: Any = None):
        if depth < 1:
            raise ValueError("depth >= 1")
        if place is None:
            place = _default_place(device)
        self._source = source
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pbst-prefetch")
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                item = self._place(self._source())
                # Bounded put that stays responsive to stop().
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised to consumer
            self._err = e
            self._stop.set()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._err is not None and self._q.empty():
                raise self._err
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set() and self._q.empty():
                    if self._err is not None:
                        raise self._err
                    raise StopIteration
                continue
            return item.ready() if isinstance(item, _InFlight) else item

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        # drain so producer threads blocked on put can exit
        while not self._q.empty():
            self._q.get_nowait()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
