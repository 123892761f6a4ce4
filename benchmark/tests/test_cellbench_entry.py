"""The entry's contract with the host: no card, no result; on the card
(marked ``cuda``, skipped without one), a short run of the cheapest
cell prints a correct result line."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import spec


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=spec.ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: this is the host's half")
    p = _run(["--workload", "train.mistral-7b", "--seed", "3",
              "--seconds", "1", "--trace", "0"], 120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run(["--workload", "train.mistral-7b", "--seed", "2718281828",
              "--seconds", "3", "--trace", "0"], 900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"batch_tokens_per_s", "setup_s"}
