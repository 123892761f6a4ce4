"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one configuration, traffic mix,
metric or cell sits in a file of its own under this folder, found by
the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes;
- ``traffic/<traffic>.json``: a tenant mix (``"tenants"``: role ->
  tenant file, plus the cell's own numbers such as ``rate_per_s``) or a
  single tenant (``"kind"``), which then stands as the batch tenant;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limit of each number the correctness
  check compares, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    """The cell's tenant mix: {"tenants": {role: tenant spec}, ...} with
    every tenant spec loaded and the mix's own keys beside."""
    mix = load_json(HERE / "traffic" / f"{name}.json")
    if "kind" in mix:
        return {"tenants": {"batch": dict(mix, name=name)}}
    tenants = {role: dict(load_json(HERE / "traffic" / f"{t}.json"), name=t)
               for role, t in mix["tenants"].items()}
    return dict(mix, tenants=tenants)


def limits(workload_name: str) -> dict:
    path = HERE / "limits" / f"{workload_name}.json"
    return load_json(path)["limits"] if path.exists() else {}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those without a ``workloads`` key, and those that list
    it."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]
