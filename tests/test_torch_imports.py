"""Import discipline of the PyTorch/CUDA port (``pbs_tpu_torch``).

The port imports torch and numpy, never JAX and never the JAX package —
not even its JAX-free modules — and it must import on a host with no
``triton``, no ``nvcc`` and no card. Entry points that default to the
card raise there instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import ast
import os
import re
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


#: A path into the JAX package's native directory (``native/...``).
_NATIVE_DIR = re.compile(r"(?<![\w])native/")


def _native_dir_refs(path: Path) -> list[tuple[int, str]]:
    """(line, text) of every mention of the reference's ``native/``
    directory, and (Python) of every path join onto ``"native"``."""
    text = path.read_text()
    bad = [(i, ln.strip()) for i, ln in enumerate(text.splitlines(), 1)
           if _NATIVE_DIR.search(ln)]
    if path.suffix == ".py":
        for node in ast.walk(ast.parse(text, filename=str(path))):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "join"
                    and any(isinstance(a, ast.Constant) and a.value == "native"
                            for a in node.args)):
                bad.append((node.lineno, "join onto 'native'"))
    return bad


@pytest.mark.parametrize(
    "path", _port_files() + sorted(PORT.rglob("*.cc")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_names_the_reference_native_dir(path):
    """The port builds its runtime from its own copies under
    ``runtime/csrc/``: it never loads, builds or names the JAX package's
    ``native/`` directory."""
    bad = _native_dir_refs(path)
    assert not bad, f"{path.relative_to(REPO)} names native/: {bad}"


def test_native_dir_rule_catches_a_reference():
    probe = PORT / "runtime" / "native.py"
    assert _native_dir_refs(probe) == []
    assert _NATIVE_DIR.search("make -C native ") is None
    assert _NATIVE_DIR.search('"native/pbst_runtime.cc"')
    assert not _NATIVE_DIR.search("runtime/csrc/pbst_runtime.cc")


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


#: The cluster control plane and the process federation (PR 14's
#: modules): each must be in the module list the checks above walk.
CLUSTER_MODULES = (
    "pbs_tpu_torch.dist", "pbs_tpu_torch.dist.rpc",
    "pbs_tpu_torch.dist.agent", "pbs_tpu_torch.dist.controller",
    "pbs_tpu_torch.dist.remus", "pbs_tpu_torch.store",
    "pbs_tpu_torch.store.store", "pbs_tpu_torch.faults.chaos",
    "pbs_tpu_torch.gateway.procfed",
)


def test_cluster_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in CLUSTER_MODULES if m not in names]
    assert not missing, missing


#: The closed tuning loop and the scenario frontier: each must be in the
#: module list the checks above walk.
LOOP_MODULES = (
    "pbs_tpu_torch.autopilot", "pbs_tpu_torch.autopilot.recorder",
    "pbs_tpu_torch.autopilot.shadow", "pbs_tpu_torch.autopilot.canary",
    "pbs_tpu_torch.autopilot.pilot", "pbs_tpu_torch.scenarios",
    "pbs_tpu_torch.scenarios.genome", "pbs_tpu_torch.scenarios.score",
    "pbs_tpu_torch.scenarios.hunt", "pbs_tpu_torch.scenarios.corpus",
)


def test_loop_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in LOOP_MODULES if m not in names]
    assert not missing, missing


#: The static checker: each of the reference's 23 modules must be in the
#: module list the checks above walk.
ANALYSIS_MODULES = tuple(
    f"pbs_tpu_torch.analysis{m}" for m in (
        "", ".core", ".runner", ".units", ".counterapi", ".schedops",
        ".locks", ".netdiscipline", ".gatewaypass", ".perfpass",
        ".obspass", ".hwpass", ".knobspass", ".rolloutpass",
        ".scenariopass", ".durabilitypass", ".procpass", ".servepass",
        ".memmodel", ".memmodel.ctokens", ".memmodel.seqlockpass",
        ".memmodel.detpass", ".memmodel.abipass"))


def test_analysis_modules_are_covered():
    names = set(_module_names())
    assert len(ANALYSIS_MODULES) == 23
    missing = [m for m in ANALYSIS_MODULES if m not in names]
    assert not missing, missing


#: The observers, the self-test, the obs dump and the perf harness: each
#: must be in the module list the checks above walk.
OBSERVER_MODULES = (
    "pbs_tpu_torch.obs.dumpfile", "pbs_tpu_torch.obs.mon",
    "pbs_tpu_torch.obs.oprofile", "pbs_tpu_torch.obs.selftest",
    "pbs_tpu_torch.perf", "pbs_tpu_torch.perf.bench",
    "pbs_tpu_torch.perf.report", "pbs_tpu_torch.perf.drift",
)


def test_observer_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in OBSERVER_MODULES if m not in names]
    assert not missing, missing
    for m in OBSERVER_MODULES:
        path = PORT.joinpath(*m.split(".")[1:])
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        assert _native_dir_refs(path) == [], m
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN]


#: The parallel schedules: each of the reference's nine modules, and the
#: port's own collectives and rank launcher, in the module list the
#: checks above walk (no JAX, nothing of ``pbs_tpu``).
PARALLEL_MODULES = tuple(
    f"pbs_tpu_torch.parallel{m}" for m in (
        "", ".mesh", ".sharding", ".ring_attention", ".ulysses", ".expert",
        ".pipeline", ".gang", ".multihost", ".comm", ".launch"))


#: The serving tier: the reference's four modules, in the module list the
#: checks above walk (no JAX, nothing of ``pbs_tpu``).
SERVE_MODULES = tuple(
    f"pbs_tpu_torch.serve{m}" for m in ("", ".partition", ".backend",
                                        ".disagg"))


def test_serve_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in SERVE_MODULES if m not in names]
    assert not missing, missing
    for m in SERVE_MODULES:
        path = PORT.joinpath(*m.split(".")[1:])
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN], m


def test_parallel_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in PARALLEL_MODULES if m not in names]
    assert not missing, missing
    for m in PARALLEL_MODULES:
        path = PORT.joinpath(*m.split(".")[1:])
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN], m


#: The twins of the root scripts and of the three
#: walkthroughs, in the module list the checks above walk (no JAX,
#: nothing of ``pbs_tpu``).
DRIVER_MODULES = tuple(
    f"pbs_tpu_torch.drivers{m}" for m in (
        "", ".bench_common", ".graft_entry", ".bench_sim", ".bench_serving",
        ".bench_longctx", ".bench_sweep", ".bench_decompose",
        ".bench")) + tuple(
    f"pbs_tpu_torch.examples{m}" for m in (
        "", ".train_from_text", ".serving_stack", ".multi_tenant"))


def test_driver_modules_are_covered():
    names = set(_module_names())
    missing = [m for m in DRIVER_MODULES if m not in names]
    assert not missing, missing
    for m in DRIVER_MODULES:
        path = PORT.joinpath(*m.split(".")[1:])
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        assert not [t for _, t in _imported_tops(path) if t in FORBIDDEN], m
        assert _native_dir_refs(path) == [], m


def test_models_name_no_wait_for_the_parallel_schedules():
    """``parallel/`` and ``serve/`` are ported: the models no longer say
    the sequence-parallel impls and the sharding seams wait for them,
    and serving's mesh is served (``_MESH_MISSING`` is gone)."""
    for name in ("transformer.py", "moe.py"):
        text = (PORT / "models" / name).read_text()
        assert "not ported yet" not in text and "item 7" not in text, name
    serving = (PORT / "models" / "serving.py").read_text()
    assert "item 8" not in serving and "_MESH_MISSING" not in serving
    assert "ServingSeams" in serving


def test_job_docstring_names_no_missing_foreign():
    """``Job.foreign`` is ported: the module no longer lists it as
    missing, and the obs package no longer waits for item 12."""
    job = ast.get_docstring(ast.parse(
        (PORT / "runtime" / "job.py").read_text()))
    assert "Not ported yet" not in job and "Job.foreign" in job
    obs = ast.get_docstring(ast.parse(
        (PORT / "obs" / "__init__.py").read_text()))
    assert "wait for" not in obs and "item 12" not in obs


def test_analysis_plane_names_no_native_dir():
    """The checker's copies say ``runtime/csrc/`` where the reference's
    say ``native/``, and look for the C core there: the parametrised rule
    above walks every one of its files."""
    files = sorted((PORT / "analysis").rglob("*.py"))
    assert len(files) == 23
    assert set(files) <= set(_port_files())
    assert [(f.name, _native_dir_refs(f)) for f in files
            if _native_dir_refs(f)] == []


def test_image_docstring_names_no_wait_for_the_ported_control_plane():
    """``runtime/image.py`` no longer says the agent and control plane
    that call ``image_workload`` are still to come: the port's agent
    binds it as its ``"image"`` workload."""
    image = ast.get_docstring(ast.parse(
        (PORT / "runtime" / "image.py").read_text()))
    assert "ROADMAP" not in image and "wait for" not in image
    agent = (PORT / "dist" / "agent.py").read_text()
    assert "import image_workload" in agent
    assert '"image": functools.partial(image_workload' in agent


def test_device_free_planes_import_no_torch():
    """The process federation's member processes load the gateway plane,
    the journal, recovery, spans and the RPC: none of it imports torch
    (nor JAX), so a spawned member costs no device runtime. The package
    inits of ``dist`` and ``runtime`` load their torch-touching modules
    on first use for the same reason. The simulator plane, the tune
    search, the chaos harness, the closed tuning loop and the scenario
    frontier are device-free too (``runtime.memory`` loads torch only
    when asked for a card's numbers), so their spawn workers pay no
    torch import. So is the static checker with the command line around
    it: ``pbst-torch check`` runs on a host with no device runtime. So
    are the observers (``mon``, ``oprofile``), the self-test, the obs
    dump and the perf harness: an observer process attached to a card
    partition's files imports no torch. So does the serving tier's
    package (its backends load torch when built), as the reference's
    loads JAX."""
    mods = ["pbs_tpu_torch.gateway.procfed", "pbs_tpu_torch.dist",
            "pbs_tpu_torch.dist.rpc", "pbs_tpu_torch.store",
            "pbs_tpu_torch.gateway.gateway", "pbs_tpu_torch.gateway.journal",
            "pbs_tpu_torch.gateway.recovery",
            "pbs_tpu_torch.gateway.backends", "pbs_tpu_torch.obs.spans",
            "pbs_tpu_torch.runtime.job", "pbs_tpu_torch.runtime.xsm",
            "pbs_tpu_torch.sim", "pbs_tpu_torch.sched.tune",
            "pbs_tpu_torch.gateway.chaos", "pbs_tpu_torch.autopilot",
            "pbs_tpu_torch.scenarios", "pbs_tpu_torch.analysis",
            "pbs_tpu_torch.cli.pbst", "pbs_tpu_torch.obs.mon",
            "pbs_tpu_torch.obs.oprofile", "pbs_tpu_torch.obs.selftest",
            "pbs_tpu_torch.obs.dumpfile", "pbs_tpu_torch.perf",
            "pbs_tpu_torch.serve", "pbs_tpu_torch.utils",
            "pbs_tpu_torch.cli"]
    code = (
        "import sys, importlib\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'pbs_tpu'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


#: The port's stated renames of the reference's public names.
EXPORT_RENAMES = {"TpuBackend": "CudaBackend",
                  "XlaQuantumProfiler": "TorchQuantumProfiler"}


def _reference_all(init: Path) -> list[str] | None:
    """The literal ``__all__`` of a reference package init, read from
    its source (nothing of the reference is imported)."""
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


@pytest.mark.parametrize(
    "init", [p for p in sorted((REPO / "pbs_tpu").rglob("__init__.py"))
             if _reference_all(p) is not None],
    ids=lambda p: ".".join(p.parent.relative_to(REPO).parts))
def test_port_package_exports_the_reference_all(init):
    """Every name in a reference package's ``__all__`` is in its port
    twin's ``__all__`` and resolves there, under the stated renames
    only (so ``from pbs_tpu_torch.utils import VirtualClock`` works as
    the reference's import does)."""
    import importlib

    names = _reference_all(init)
    rel = init.parent.relative_to(REPO).parts
    port = importlib.import_module(".".join(("pbs_tpu_torch",) + rel[1:]))
    want = [EXPORT_RENAMES.get(n, n) for n in names]
    port_all = getattr(port, "__all__", [])
    assert [n for n in want if n not in port_all] == []
    assert [n for n in want if not hasattr(port, n)] == []


def test_chip_smoke_top_level_is_stdlib_only():
    """Spawned members re-import the parent's ``__main__``: when that is
    ``chip_smoke.py``, its module level must load nothing but the
    standard library (no torch, nothing CUDA before ``main()``)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    tops = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= set(sys.stdlib_module_names), tops - set(
        sys.stdlib_module_names)


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
