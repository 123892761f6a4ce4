"""Import discipline of the PyTorch/CUDA port (``pbs_tpu_torch``).

The port imports torch and numpy, never JAX and never the JAX package —
not even its JAX-free modules — and it must import on a host with no
``triton``, no ``nvcc`` and no card. Entry points that default to the
card raise there instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# The suite runs in parallel worker processes: uncapped, torch's intra-op
# pool takes every core in each of them and oversubscribes the host.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pbs_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "pbs_tpu"}


def _port_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_names() -> list[str]:
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imported_tops(path: Path) -> list[tuple[int, str]]:
    """(line, top-level module name) of every absolute import anywhere
    in the file — module level, function bodies, type-checking blocks."""
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.append((node.lineno, node.module.split(".")[0]))
    return tops


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    # Exact top-level comparison: "pbs_tpu_torch" starts with "pbs_tpu".
    bad = [(ln, top) for ln, top in _imported_tops(path) if top in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_prefix_check_is_exact():
    """The rule above must not flag the port's own imports."""
    tops = {top for p in _port_files() for _, top in _imported_tops(p)}
    assert "pbs_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_port_imports_without_triton_nvcc_or_jax():
    """Import every module of the port in a fresh interpreter where
    ``triton`` cannot be imported and no ``nvcc`` is on PATH; neither
    JAX nor the JAX package may end up loaded."""
    names = _module_names()
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"  # any import of it now fails
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pbs_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(names) + "))\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_device_defaults_refuse_without_a_card():
    """With no card, the card-defaulting entry points raise RuntimeError
    (no quiet CPU fallback); with one, they land on it."""
    import numpy as np

    from pbs_tpu_torch.models import (TransformerConfig, init_params,
                                      params_from_numpy)
    from pbs_tpu_torch.models.transformer import rope_tables
    from pbs_tpu_torch.telemetry import CudaBackend

    cfg = TransformerConfig(vocab=16, d_model=16, n_layers=1, n_heads=2,
                            n_kv_heads=1, d_ff=32, max_seq=8,
                            dtype=torch.float32)
    tree = {"w": np.ones((2, 2), np.float32)}
    if torch.cuda.is_available():
        assert CudaBackend().device.type == "cuda"
        gen = torch.Generator(device="cuda").manual_seed(0)
        assert init_params(cfg, gen)["head"].is_cuda
        assert params_from_numpy(tree)["w"].is_cuda
        assert rope_tables(cfg, 4)[0].is_cuda
        return
    with pytest.raises(RuntimeError):
        CudaBackend()
    with pytest.raises(RuntimeError):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError):
        rope_tables(cfg, 4)
    # An explicit host device is honoured.
    assert CudaBackend(device="cpu").device.type == "cpu"
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["layers"]["wq"].shape == (1, 16, 16)


def test_profiler_sampling_samples_on_the_host():
    """``profile_every`` is accepted: the first invocation of a job and
    every 4th after it run under ``torch.profiler``, and on the host the
    sample reads the host's ops."""
    from pbs_tpu_torch.runtime import Job, Partition
    from pbs_tpu_torch.telemetry import CudaBackend, TorchQuantumProfiler

    be = CudaBackend(device="cpu", profile_every=4)
    assert isinstance(be.profiler, TorchQuantumProfiler)
    x = torch.ones(32, 32)
    part = Partition("p", source=be)
    job = part.add_job(Job("mm", step_fn=lambda s: s + x @ x, state=x,
                           max_steps=5))
    part.run(max_rounds=10)
    assert job.steps_retired() == 5
    assert (be.profiler.samples, be.profiler.failures) == (2, 0)
    m = be.measured("mm")
    assert m.source == "host" and m.n_ops > 0 and m.compute_ns > 0


def test_kernel_wrappers_never_fall_back_to_plain():
    """A tensor that is neither on the CPU nor usable by the kernel is
    refused: the plain version is reserved for CPU tensors."""
    from pbs_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_bwd)
    from pbs_tpu_torch.ops.matmul import instrumented_matmul

    q = torch.empty((1, 8, 2, 16), device="meta")
    kv = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv)
    lse = torch.empty((1, 8, 2, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, kv, kv, q, lse, q)
    a = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        instrumented_matmul(a, a)
