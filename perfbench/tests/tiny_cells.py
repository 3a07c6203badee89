"""Tiny sizes of the cells for the CPU tests: the configurations' model
and mixes at loadSize 32, one hourglass stack and a 32^3 grid."""

import time

from perfbench import harness

TINY = {"model": {"loadSize": 32, "num_stack_lr": 1, "resolution": 32,
                  "octree_init_resolution": 8, "num_samples": 4096},
        "traffic": {"image_size": 16, "pool": 4,
                    "check": {"subjects": 2, "vertices": 256, "faces": 256,
                              "columns": 32 * 32}}}


def tiny_run(workload: str, seed: int = 12345678901, seconds: float = 1.0,
             trace: bool = False, bench=None, overrides=None):
    """One run of ``workload`` on the CPU at the tiny size; returns
    (run, result line)."""
    bench = bench or harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    run = harness.prepare(bench, workload, seed, seconds, trace,
                          time.perf_counter(), "cpu", overrides or TINY)
    harness.drive(run)
    return run, harness.result(bench, run)
