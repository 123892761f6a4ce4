"""The import boundary of the benchmark: nothing under ``benchmark/``
imports JAX or the JAX package, and the reference imports nothing of the
port. Module names are compared by their top-level name, whole:
``pbs_tpu_torch`` is not ``pbs_tpu``."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pbs_tpu"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "pbs_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)


def test_the_comparison_is_by_whole_name():
    src = "import pbs_tpu_torch.models\nfrom pbs_tpu.x import y\n"
    tmp = HERE / "tests" / "__boundary_probe__.py"
    try:
        tmp.write_text(src)
        names = top_level_imports(tmp)
    finally:
        tmp.unlink()
    assert names == {"pbs_tpu_torch", "pbs_tpu"}
    assert names & FORBIDDEN == {"pbs_tpu"}
