"""On a CUDA card: each cell's command runs end to end with a short
window and prints a correct result line (skipped without a card)."""

import json
import subprocess
import sys

import pytest

from port_bench import harness

WORKLOADS = [w["name"] for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload,
                        "--seed", "2147483713", "--seconds", "2", "--trace", "0"],
                       cwd=harness.REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == set(harness.load_cell(workload).end_to_end)
