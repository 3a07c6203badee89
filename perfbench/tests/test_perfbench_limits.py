"""Each cell's limits against the readings they were set from
(``perfbench/limits/<cell>.json`` ``readings``): the program's largest
sound reading passes every limit, and every row of the control and of
each planted fault, judged as a run is judged, reads not correct."""

import os

import pytest

from perfbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _limits(cell):
    return harness.load_json(os.path.join(harness.PKG, "limits",
                                          cell + ".json"))


def _judged(numbers, limits):
    # a row must hold every number compared, so that it fails on a
    # reading and not on a missing one
    held = set(limits["numbers"]) - {"failed"}
    assert held <= set(numbers), sorted(held - set(numbers))
    return harness.compare({**numbers, "failed": 0.0}, limits)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_reads_within_every_limit(cell):
    limits = _limits(cell)
    largest = limits["readings"]["program_largest"]
    zeros = {k: 0.0 for k in limits["numbers"]}
    verdict = _judged({**zeros, **largest}, limits)
    assert verdict["correct"], verdict["compared"]
    for name, value in largest.items():
        # room above the largest sound reading
        assert value < limits["numbers"][name], name


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(cell):
    rows = _limits(cell)["readings"]["control_rows"]
    assert len(rows) >= 3
    for row in rows:
        verdict = _judged(row["numbers"], _limits(cell))
        assert not verdict["correct"], (row["seed"], verdict["compared"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_reads_not_correct(cell):
    faults = _limits(cell)["readings"].get("fault_rows", {})
    for fault, rows in faults.items():
        assert len(rows) >= 3, fault
        for row in rows:
            verdict = _judged(row["numbers"], _limits(cell))
            assert not verdict["correct"], (fault, row["seed"])


def test_a_missing_number_is_not_correct():
    limits = {"numbers": {"gap": 1.0, "failed": 0}}
    assert harness.compare({"gap": 0.5, "failed": 0.0}, limits)["correct"]
    assert not harness.compare({"failed": 0.0}, limits)["correct"]
    assert not harness.compare({"gap": float("nan"), "failed": 0.0},
                               limits)["correct"]
