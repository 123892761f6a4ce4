"""Rank processes on one host: the port's stand-in for the reference's
many-devices-in-one-process.

Port-only. A JAX process sees all its devices and ``shard_map`` runs
the per-device bodies; a ``torch.distributed`` world is one process per
rank. :class:`RankPool` starts ``world_size`` rank processes of this
module (a fresh interpreter each: nothing of the parent is imported),
joins them into one process group through a ``FileStore`` in a private
temporary directory (no port, so pools can run side by side), and runs
tasks on every rank at once: ``pool.run("module:function", *args)``
imports the function on each rank, calls it with the same arguments and
returns the ranks' results in rank order. A task that raises on any rank
raises in the parent with that rank's traceback (the pool is closed if
the others do not answer soon after, as when they wait for the failed
rank inside an exchange); a rank that does not answer within the task's
deadline fails the pool, which is then closed (every rank killed). Results travel pickled, so a task returns numpy
arrays, numbers or CPU tensors.

``backend="gloo"`` with ``device="cuda"`` puts every rank on the card
``rank % device_count`` — two ranks may share one card — and stages
their exchanges through host memory (:mod:`pbs_tpu_torch.parallel.comm`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener, wait
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
#: How long rank processes may take to start and join the group.
START_TIMEOUT_S = 120.0
#: How long the other ranks may still answer once one has failed (they
#: may be waiting for it inside an exchange); then the pool is closed.
FAILED_GRACE_S = 3.0


def listen(address: str, authkey: bytes, world_size: int) -> Listener:
    """The pool's AF_UNIX listener, its backlog room for every rank: the
    ranks connect all at once, and a connect that finds the backlog full
    fails at once (EAGAIN) where the socket has a timeout, rather than
    waiting for the accepting thread."""
    return Listener(address, family="AF_UNIX", authkey=authkey,
                    backlog=world_size)


class RankPool:
    """``world_size`` rank processes in one process group."""

    def __init__(self, world_size: int, backend: str = "gloo",
                 device: str = "cpu", env: dict | None = None):
        self.world_size = world_size
        self._dir = tempfile.mkdtemp(prefix="pbst-ranks-")
        address = os.path.join(self._dir, "pool.sock")
        authkey = os.urandom(16)
        self._listener = listen(address, authkey, world_size)
        child_env = dict(os.environ, **(env or {}))
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in child_env.get("PYTHONPATH", "")
                            .split(os.pathsep) if p])
        spec = {"address": address, "authkey": authkey,
                "store": os.path.join(self._dir, "store"),
                "world_size": world_size, "backend": backend,
                "device": device}
        self._procs = []
        self._conns: list = [None] * world_size
        try:
            for rank in range(world_size):
                self._procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pbs_tpu_torch.parallel.launch"],
                    stdin=subprocess.PIPE, env=child_env, cwd=str(_ROOT)))
                self._procs[-1].stdin.write(
                    pickle.dumps(dict(spec, rank=rank)))
                self._procs[-1].stdin.close()
            accepter = threading.Thread(target=self._accept, daemon=True)
            accepter.start()
            accepter.join(START_TIMEOUT_S)
            if accepter.is_alive() or None in self._conns:
                raise TimeoutError(
                    f"{self._conns.count(None)} of {world_size} rank "
                    f"processes did not join within {START_TIMEOUT_S} s")
            self.run("pbs_tpu_torch.parallel.launch:_ready",
                     timeout_s=START_TIMEOUT_S)
        except BaseException:
            self.close()
            raise

    def _accept(self) -> None:
        for _ in range(self.world_size):
            try:
                conn = self._listener.accept()
            except OSError:
                return
            self._conns[conn.recv()] = conn

    def run(self, task: str, *args, timeout_s: float = 300.0, **kwargs):
        """Run ``task`` ("module:function") on every rank with the same
        arguments; returns the results in rank order."""
        if any(p.poll() is not None for p in self._procs):
            self.close()
            raise RuntimeError("a rank process has exited")
        blob = pickle.dumps((task, args, kwargs))
        for conn in self._conns:
            conn.send_bytes(blob)
        deadline = time.monotonic() + timeout_s
        results: dict = {}
        failures: list = []
        waiting = dict(zip(self._conns, range(self.world_size)))
        while waiting:
            left = deadline - time.monotonic()
            if failures:  # the others may wait on the failed rank
                left = min(left, FAILED_GRACE_S)
            ready = wait(list(waiting), max(left, 0.0))
            if not ready:
                self.close(kill=True)
                if failures:
                    break
                raise TimeoutError(
                    f"ranks {sorted(waiting.values())} gave no answer to "
                    f"{task} within {timeout_s} s; the pool is closed")
            for conn in ready:
                rank = waiting.pop(conn)
                ok, value = pickle.loads(conn.recv_bytes())
                if ok:
                    results[rank] = value
                else:
                    failures.append(f"rank {rank}:\n{value}")
        if failures:
            raise RuntimeError(f"{task} failed on {len(failures)} of "
                               f"{self.world_size} ranks\n"
                               + "\n".join(failures))
        return [results[rank] for rank in range(self.world_size)]

    def close(self, kill: bool = False) -> None:
        """Stop every rank (killing any that does not leave within a few
        seconds, or at once with ``kill``) and remove the pool's
        directory."""
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send_bytes(pickle.dumps(None))
                    conn.close()
                except OSError:
                    pass
        for p in self._procs:
            if kill:
                p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._procs = []
        self._conns = [None] * self.world_size
        self._listener.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _ready() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _resolve(task: str):
    import importlib

    module, _, name = task.partition(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _worker() -> None:
    spec = pickle.loads(sys.stdin.buffer.read())
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the host's cores
    rank, world = spec["rank"], spec["world_size"]
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        spec["backend"], store=dist.FileStore(spec["store"], world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600))
    conn = Client(spec["address"], family="AF_UNIX",
                  authkey=spec["authkey"])
    conn.send(rank)
    try:
        while True:
            msg = pickle.loads(conn.recv_bytes())
            if msg is None:
                break
            task, args, kwargs = msg
            try:
                out = (True, _resolve(task)(*args, **kwargs))
            except BaseException:
                out = (False, traceback.format_exc())
            conn.send_bytes(pickle.dumps(out))
    except EOFError:
        pass
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker()
