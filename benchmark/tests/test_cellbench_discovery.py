"""The harness is driven by data: a configuration, a traffic mix or a
metric placed beside the others is found by its name, and each cell's
CPU rehearsal runs its whole control flow at tiny widths without
writing a number under a device metric's name."""

import json
import shutil

import pytest

from benchmark import spec
from benchmark.tests import tiny


@pytest.fixture
def copied(tmp_path, monkeypatch):
    dst = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(spec, "HERE", dst)
    return dst


def test_a_new_config_is_found_by_name(copied):
    cfg = dict(spec.config("mistral-7b-v0.3"), name="probe-model")
    (copied / "configs" / "probe-model.json").write_text(json.dumps(cfg))
    assert spec.config("probe-model")["name"] == "probe-model"


def test_a_new_traffic_mix_is_found_by_name(copied):
    (copied / "traffic" / "chat-open.probe.json").write_text(json.dumps(
        {"why": "probe", "tenants": {"serve": "chat-open",
                                     "batch": "score-s2048"},
         "rate_per_s": 3.5}))
    mix = spec.traffic("chat-open.probe")
    assert mix["rate_per_s"] == 3.5
    assert mix["tenants"]["serve"]["kind"] == "open_loop"
    assert mix["tenants"]["batch"]["kind"] == "score"
    # a single tenant file stands as the cell's batch tenant
    assert spec.traffic("train-s4096")["tenants"]["batch"]["kind"] == "train"


def test_a_new_metric_is_found_by_name(copied):
    (copied / "metrics" / "probe_metric.x.py").write_text(
        "def read(run):\n    return 41.5 if run else None\n")
    assert spec.reader("probe_metric.x")(object()) == 41.5
    bench = spec.benchmark()
    bench["per_layer"].append({"name": "probe_metric.x", "unit": "ms",
                               "workloads": ["train.mistral-7b"]})
    names = [m["name"] for m in
             spec.metrics_of(bench, "train.mistral-7b", "per_layer")]
    assert "probe_metric.x" in names
    assert "probe_metric.x" not in [
        m["name"] for m in spec.metrics_of(
            bench, "colo.mixtral-8x7b.serve-score", "per_layer")]


def test_every_named_part_of_the_benchmark_exists():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert spec.traffic(w["traffic"])["tenants"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_the_cpu_rehearsal_runs_each_cell(workload):
    result, run = tiny.run(workload)
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"]
    e2e = {m["name"] for m in
           spec.metrics_of(spec.benchmark(), workload, "end_to_end")}
    assert set(run.host_values) == e2e
    assert result["attempted"] > 0 and result["failed"] == 0
    # the numbers compared are those the cell's limits name, each read
    assert set(result["checks"]) == set(spec.limits(workload)) != set()
    assert set(result["checks"]) <= set(run.readings)
