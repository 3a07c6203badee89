"""Whole runs of the serving cells on the CPU at the tiny size: the
result line's keys and metrics; the output check false under each fault
of the timed path; the control separated from the program; and a new
cell and metric taken from new files alone."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from perfbench import calibrate, faults, harness

from tiny_cells import TINY, tiny_run

SERVE_CELLS = ["serve_mono-surs_bf16", "serve_dense-surs_f32"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_a_sound_run_is_correct(workload):
    run, line = tiny_run(workload)
    assert line["correct"], line["checks"]
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"subject_s", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert run.out["obj_bytes"] > 0


def test_a_traced_run_reads_its_layers():
    run, line = tiny_run("serve_mono-surs_bf16", trace=True)
    got = line["metrics"]
    assert {"write_s.serve", "extract_s.serve", "queries.serve",
            "mfu.serve", "idle_share.serve"} <= set(got)
    assert "k1_roofline" not in got      # no kernel ran on the CPU
    assert 0.0 < got["mfu.serve"]["value"] <= 100.0
    assert "window_s" in line["device"] and "breakdown" in line


@pytest.mark.parametrize("fault", ["half_points", "altered"])
@pytest.mark.parametrize("workload", ["serve_mono-surs_bf16",
                                      "serve_dense-surs_f32"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    undo = faults.plant(fault)
    try:
        _, line = tiny_run(workload)
    finally:
        undo()
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_the_control_reads_far_above_the_program(workload, capsys):
    """The control (the plain model one precision below the
    configuration's, in the program's place) reads far above the
    program. At this size the float32 cells' median gaps are mostly 0 on
    both sides (a voxel is 1/32 of the box), so the widest gap of three
    seeds is compared there."""
    # every column of the tiny grid: the dense control's mesh is its
    # crossings along the sampled columns
    tiny = copy.deepcopy(TINY)
    tiny["traffic"]["check"]["columns"] = 32 * 32
    calibrate.main(["--workload", workload, "--seeds", "21,22,23",
                    "--control-seeds", "21,22,23", "--device", "cpu"],
                   tiny)
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]
    key = "mesh_gap_p50" if "bf16" in workload else "widest"

    def reading(r):
        return r["numbers"][key] if key in r["numbers"] else r[key]
    # every row is judged under the cell's limits, as a run is
    assert all(isinstance(r["correct"], bool) for r in rows)
    prog = max(reading(r) for r in rows if r["side"] == "program")
    ctrl = max(reading(r) for r in rows if r["side"] == "control")
    assert ctrl > 3 * prog and ctrl > 1e-6, (prog, ctrl)


def test_a_new_cell_and_metric_come_from_new_files(tmp_path):
    """A copy of the benchmark gets a dummy mix, cell, limits and
    per-layer metric as new files and new entries; no file the benchmark
    had is edited, and the run reports the dummy metric."""
    shutil.copytree(harness.PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (tmp_path / "perfbench" / p).read_bytes()
              for p in os.listdir(tmp_path / "perfbench")
              if (tmp_path / "perfbench" / p).is_file()}
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    bench = copy.deepcopy(bench)
    pb = tmp_path / "perfbench"
    mix = json.loads((pb / "traffic" / "serve_mono.json").read_text())
    mix["pool"] = 2
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "dummy_mix-surs_bf16.json").write_text(
        (pb / "limits" / "serve_mono-surs_bf16.json").read_text())
    (pb / "metrics" / "dummy_subjects.py").write_text(
        "def read(run):\n    return run.out.get('subjects')\n")
    bench["workloads"].append({"name": "dummy_mix-surs_bf16",
                               "config": "surs_bf16", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dummy_mix-surs_bf16")
    bench["per_layer"].append({"name": "dummy_subjects", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "test", "moves": "subject_s",
                               "workloads": ["dummy_mix-surs_bf16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys, time\n"
        "sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2])\n"
        "from perfbench import harness\n"
        "from tiny_cells import TINY\n"
        "bench = harness.load_json(sys.argv[1] + '/BENCHMARK.json')\n"
        "run = harness.prepare(bench, 'dummy_mix-surs_bf16', 3, 1.0, True,"
        " time.perf_counter(), 'cpu', TINY)\n"
        "harness.drive(run)\n"
        "print(json.dumps(harness.result(bench, run), default=float))\n")
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                        os.path.dirname(__file__) + os.pathsep
                        + harness.ROOT],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ,
                            "PYTHONPATH": harness.ROOT + os.pathsep
                            + os.path.dirname(__file__)})
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["dummy_subjects"]["value"] >= 1
    for p, b in before.items():
        assert (pb / p).read_bytes() == b


TRAIN_TINY = {"model": {"loadSize": 32, "num_stack_lr": 1},
              "traffic": {"batch": 2, "points": 64, "items": 2}}


@pytest.mark.parametrize("fault", ["", "unchanged", "half_batch"])
def test_the_training_check(fault):
    """A sound training run is correct; a step that leaves the state
    unchanged, or a loss over half the batch, is not."""
    undo = faults.plant(fault) if fault else None
    try:
        run, line = tiny_run("train_b8-surs_bf16", seconds=1.0,
                             overrides=TRAIN_TINY)
    finally:
        if undo is not None:
            undo()
    assert line["correct"] == (not fault), line["checks"]
    assert set(line["metrics"]) == {"step_s", "setup_s"}
    assert run.out["steps"] >= 1
