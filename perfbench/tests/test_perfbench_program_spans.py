"""The readers of the program's own spans and counters
(``perfbench/regions.py`` and the metrics that read the ``surs.*``
regions and ``stats`` keys): a traced tiny run of a serving and of the
training cell reads each as a number, an untraced run reports none, a
program without the spans reads none, the audit of a traced run counts
its spans and waits, and the entries name only cells the benchmark
has."""

import pytest

from perfbench import harness, regions
from perfbench.trace import Trace

from tiny_cells import TINY, tiny_run

SERVE = ("evaluate_s.serve", "evaluate_idle_s.serve", "syncs.serve",
         "sync_wait_s.serve")
TRAIN = ("data_wait_ms.train", "forward_ms.train", "backward_ms.train",
         "optimizer_idle_ms.train")
TRAIN_TINY = {"model": {"loadSize": 32, "num_stack_lr": 1},
              "traffic": {"batch": 2, "points": 64, "items": 2}}
CELLS = {"serve_mono-surs_bf16": (SERVE, TINY),
         "train_b8-surs_bf16": (TRAIN, TRAIN_TINY)}


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("traced", [True, False])
def test_the_readers_read_a_traced_run_alone(workload, traced):
    names, tiny = CELLS[workload]
    run, line = tiny_run(workload, trace=traced, overrides=tiny)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    if not traced:
        assert not set(names) & set(got)
        return
    for name in names:
        assert name in got, name
        assert got[name]["value"] >= 0.0, name
    if workload.startswith("serve"):
        st = run.out["stats"]
        assert got["syncs.serve"]["value"] == \
            st["syncs"] / run.out["subjects"]
        assert got["evaluate_s.serve"]["value"] > 0.0
    else:
        assert got["forward_ms.train"]["value"] > 0.0


def test_no_spans_read_nothing():
    """A program without the spans, as an older one: its trace has no
    ``surs.*`` region and its stats no span keys."""
    trace = Trace([("k", "kernel", 0.0, 1.0)], [("aten::mm", 0.0, 1.0)],
                  (0.0, 2.0))

    class Run:
        out = {"trace": trace, "steps": 3, "subjects": 2,
               "stats": {"queries": 5}}
    for name in SERVE + TRAIN:
        mod = harness.load_file_module(
            f"{harness.PKG}/metrics/{name}.py", "m_" + name.replace(".", "_"))
        assert mod.read(Run) is None, name


def test_idle_inside_and_by_region():
    """Idle stretches inside named regions, and the window's idle given
    to the innermost region around it."""
    dev = [("k", "kernel", 1.0, 2.0), ("k", "kernel", 5.0, 6.0)]
    cpu = [("surs.evaluate", 0.5, 4.0), ("surs.evaluate.level", 1.5, 3.0),
           ("surs.sync", 2.5, 3.0), ("surs.evaluate", 5.5, 7.0),
           ("aten::add", 0.6, 0.7)]
    tr = Trace(dev, cpu, (0.0, 8.0))
    idle, n = regions.idle_inside(tr, "surs.evaluate")
    assert n == 2 and idle == pytest.approx(0.5 + 2.0 + 1.0)
    by = regions.idle_by_region(tr)
    assert by == pytest.approx({"surs.evaluate": 0.5 + 1.0 + 1.0,
                                "surs.evaluate.level": 0.5,
                                "surs.sync": 0.5, "outside": 0.5 + 1.0 + 1.0})
    assert sum(by.values()) == pytest.approx(8.0 - tr.busy_s())


def test_the_audit_of_a_traced_run():
    """The record of a traced tiny run: every program wait a ``surs.sync``
    region, and on the CPU no blocking CUDA call."""
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    run, prof = regions.traced(bench, "serve_mono-surs_bf16", 5, 1.0, "cpu",
                               TINY)
    rec = regions.audit(run, prof)
    n = run.out["subjects"]
    assert rec["units"] == n >= 1
    assert rec["syncs_per_unit"] == run.out["stats"]["syncs"] / n > 0
    assert rec["span_counts"]["surs.sync"] == run.out["stats"]["syncs"]
    assert rec["span_counts"]["surs.write"] == 2 * n
    assert rec["blocking_calls_per_unit"] == 0
    assert rec["spans_per_unit"] > rec["syncs_per_unit"]


def test_the_entries_name_cells_that_exist():
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    cells = {w["name"] for w in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SERVE + TRAIN:
        m = entries[name]
        assert m["workloads"] and set(m["workloads"]) <= cells, name
        assert m["better"] == "lower"
    assert set(entries["syncs.serve"]["workloads"]) == {
        "serve_mono-surs_bf16", "serve_dense-surs_f32"}
    assert entries["optimizer_idle_ms.train"]["workloads"] == [
        "train_b8-surs_bf16"]
