"""Shared bits for the root scripts' twins (the port of ``bench_common.py``).

One copy of the peak constant the MFU numbers divide by, the mu-dtype
knob parser, the device every twin runs on, and the split between an
error that ends a whole matrix and one that is a result of one point.

The reference also points JAX at a persistent compilation cache
(``setup_compilation_cache``). The port has no counterpart: its kernels
are built once by ``nvcc`` into ``pbs_tpu_torch/build/``
(``ops/cuda_build.py``, keyed by a digest of their sources) and eager
PyTorch compiles nothing else.
"""

from __future__ import annotations

import json
import os
import time

# One constant: the telemetry seam is canonical; the twins re-export it
# so their MFU numbers can never disagree with the backend's.
from pbs_tpu_torch.telemetry.source import H100_PEAK_FLOPS as PEAK_FLOPS  # noqa: F401


def tiny_mode(knob: str) -> bool:
    """Whether the env knob ``knob`` asks for the CPU smoke."""
    return os.environ.get(knob, "").lower() in ("1", "true")


def bench_device(tiny: bool = False, device=None):
    """The torch.device a twin runs on: the CPU in tiny mode, else
    ``device`` when given, else the card. With no card and neither of
    the first two, raise: a twin never carries on on the host under a
    device metric's name."""
    import torch

    if tiny:
        return torch.device("cpu")
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set the tiny-mode knob or pass "
            "device='cpu' (--device cpu) to run on the host")
    return torch.device("cuda")


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    host). The twins close every timing with this where the reference
    fetches a scalar to the host."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def parse_mu_dtype(raw: str | None):
    """One parser for the PBST_*_MU_DTYPE knobs -> (mu_dtype, label).

    Accepts bf16/bfloat16 and f32/fp32/float32 (or empty/None for the
    default); raises ValueError on anything else so a typo fails in
    milliseconds, before any device touch."""
    key = (raw or "").strip().lower()
    if key in ("bf16", "bfloat16"):
        import torch

        return torch.bfloat16, "bf16"
    if key in ("", "f32", "fp32", "float32"):
        return None, "f32"
    raise ValueError(f"mu_dtype {raw!r} unknown; expected bf16/bfloat16 "
                     "or f32/fp32/float32")


#: Messages of CUDA errors that leave the context unusable: every later
#: call in the process fails the same way.
_POISONED = ("illegal memory access", "an illegal instruction",
             "unspecified launch failure", "misaligned address",
             "device-side assert", "cuda error: launch failure")


def backend_unavailable(e: BaseException) -> bool:
    """True when ``e`` ends the whole matrix: no CUDA device; a CUDA
    error that poisons the context (an illegal address, a launch
    failure); a kernel that fails to build. Every later point would
    fail the same way, so the caller stops its loop via
    :func:`abandon_if_unavailable` after printing the point's own error
    row. An out-of-memory (``torch.cuda.OutOfMemoryError``) or a
    ``ValueError`` is a result of one point, and the matrix goes on."""
    import torch

    from pbs_tpu_torch.ops.cuda_build import BuildError

    if isinstance(e, BuildError):
        return True
    if isinstance(e, (torch.cuda.OutOfMemoryError, ValueError)):
        return False
    s = str(e).lower()
    if "no cuda device" in s or "no cuda gpus are available" in s:
        return True
    return ("cuda error" in s or "cuda_error" in s) and any(
        p in s for p in _POISONED)


def abandon_if_unavailable(e: BaseException, what: str) -> bool:
    """One shared abandonment site: if ``e`` is fatal (see
    :func:`backend_unavailable`), print a single error row saying
    ``what`` is being abandoned and return True (caller breaks its
    loop)."""
    if not backend_unavailable(e):
        return False
    print(json.dumps({"error": (
        f"backend unavailable: abandoning {what} (no usable CUDA device "
        "or kernel build; every further point would fail the same way)")}),
        flush=True)
    return True


def error_row(e: BaseException) -> str:
    """A point's error cell, as the reference writes it."""
    return f"{type(e).__name__}: {str(e)[:120]}"


def release(device) -> None:
    """Return a finished point's cached blocks to the card, so the next
    point's allocation starts from an empty pool."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class TrainingChunks:
    """The flagship-style training chunk the benches share: fp32 master
    params and seeded tokens (batch, seq) on ``device``, AdamW at 3e-4.
    The port has no ``lax.scan``: each :meth:`run` is ``steps`` train
    steps queued back to back with one synchronise, at the read of its
    last loss."""

    def __init__(self, cfg, batch: int, seq: int, steps: int, device,
                 mu_dtype=None, seed: int = 0):
        import torch

        from pbs_tpu_torch.models import init_params, make_train_step

        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, gen, device=dev)
        init_opt, self._train_step = make_train_step(
            cfg, learning_rate=3e-4, mu_dtype=mu_dtype)
        self._state = (params, init_opt(params), 0)
        del params
        self._tokens = torch.randint(0, cfg.vocab, (batch, seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
        self.steps = steps
        self.n_params = cfg.num_params()
        self._first = None  # the first step's loss, read at the end

    def run(self) -> float:
        """One chunk; returns its last step's loss."""
        for _ in range(self.steps):
            self._state, m = self._train_step(self._state, self._tokens)
            if self._first is None:
                self._first = m["loss"]
        return float(m["loss"])  # the chunk's one synchronise

    @property
    def first_loss(self) -> float:
        return float(self._first)


def timed_training(cfg, batch: int, seq: int, steps: int, device,
                   warm_chunks: int = 1, timed_chunks: int = 2,
                   mu_dtype=None, seed: int = 0) -> dict:
    """The training measurement the sweep, long-context and
    decomposition twins share: :class:`TrainingChunks`, then
    ``warm_chunks`` untimed chunks (their wall time, kernels built, is
    ``compile_s``), then ``timed_chunks`` timed ones.

    Returns ``n_params``, ``tokens_per_s`` (batch x (seq - 1) tokens a
    step), ``step_ms``, ``compile_s``, ``loss`` (the last step's),
    ``first_loss`` (the first step's) and ``peak_gib`` (peak device
    memory allocated on the card, None on the host)."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    chunks = TrainingChunks(cfg, batch, seq, steps, dev, mu_dtype=mu_dtype,
                            seed=seed)
    t0 = time.perf_counter()
    for _ in range(warm_chunks):
        chunks.run()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        loss = chunks.run()
    dt = time.perf_counter() - t0
    n_steps = timed_chunks * steps
    return {
        "n_params": chunks.n_params,
        "tokens_per_s": batch * (seq - 1) * n_steps / dt,
        "step_ms": 1e3 * dt / n_steps,
        "compile_s": compile_s,
        "loss": loss,
        "first_loss": chunks.first_loss,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if on_card else None),
    }
