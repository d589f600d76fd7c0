"""On a card: a short run of each one-card cell through the command, as
the benchmark's runs make it.  Skips where there is no CUDA card."""
import json
import subprocess
import sys

import pytest

from decode_bench.harness import spec
from decode_bench.harness.streams import REPO_DIR


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]
                                  if w["chips"] == 1])
def test_a_short_run_on_the_card_is_correct(card, cell):
    r = subprocess.run([sys.executable, "decode_bench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "3",
                        "--trace", "0"], cwd=REPO_DIR, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
