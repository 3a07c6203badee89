"""On the card: each cell runs once through the benchmark's command,
for a short window, and reads correct; a traced run reads its per-layer
metrics, no share above 100 %. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")


def _run(workload, trace):
    r = subprocess.run(
        [sys.executable, os.path.join(harness.PKG, "run.py"), "--workload",
         workload, "--seed", "3000000001", "--seconds", "5", "--trace",
         str(trace)], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload):
    _card()
    line = _run(workload, 0)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_traced_cell_reads_its_layers(workload):
    _card()
    line = _run(workload, 1)
    assert line["correct"], line["checks"]
    _, layer = harness.cell_metrics(BENCH, workload)
    for m in layer:
        if m["unit"] == "%" and m["name"] in line["metrics"]:
            assert 0.0 <= line["metrics"][m["name"]]["value"] <= 100.0
    assert 0.0 < line["device"]["busy_s"] <= line["device"]["window_s"]
