"""The core of a run: find the cell's files by name, hand the run to the
traffic mix's driver, judge its output, read the per-layer metrics and
print the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs`` -> its ``file``), a traffic mix (``perfbench/traffic/
<traffic>.json``, whose ``driver`` names ``perfbench/drivers/
<driver>.py``) and has its limits in ``perfbench/limits/<cell>.json``.
A per-layer metric is read by ``perfbench/metrics/<metric>.py``, whose
``read(run)`` returns a number or None. Nothing here names a cell, a
mix or a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# top-level modules that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "surs_tpu")


class Run:
    """What a driver and the readers are given, and what the driver
    leaves: ``out`` (its measures, ``stats``, ``trace``, ``check``)."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict,
                 limits: Dict, seed: int, seconds: float, trace: bool,
                 t0: float, device: str, overrides: Optional[Dict] = None):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.t0 = t0
        self.device = device
        self.overrides = overrides or {}
        self.out: Dict = {}

    def sync(self) -> None:
        import torch
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell_metrics(bench: Dict, cell: str):
    """(end-to-end entries, per-layer entries) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def prepare(bench: Dict, workload: str, seed: int, seconds: float,
            trace: bool, t0: float, device: str,
            overrides: Optional[Dict] = None) -> Run:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(PKG, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(PKG, "limits", workload + ".json"))
    return Run(cell, config, traffic, limits, seed, seconds, trace, t0,
               device, overrides)


def drive(run: Run) -> Dict:
    driver = importlib.import_module(
        "perfbench.drivers." + run.traffic["driver"])
    run.out = driver.run(run)
    return run.out


def compare(numbers: Dict, limits: Dict) -> Dict:
    """{name: (value, limit)} of every number that ``limits`` holds, and
    correct: each one finite and within its limit (a missing number
    fails)."""
    compared = {}
    for name, lim in limits["numbers"].items():
        value = float(numbers.get(name, float("inf")))
        compared[name] = (value, float(lim))
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in compared.values())
    return {"compared": compared, "correct": correct}


def judge(run: Run) -> Dict:
    """The driven run's output check against the cell's limits."""
    numbers = dict(run.out["check"]["numbers"])
    numbers["failed"] = float(run.out["failed"])
    return compare(numbers, run.limits)


def build_log() -> Dict[str, float]:
    """Seconds of each native library the program compiled in this
    process (its ``cuda_build.BUILD_LOG``): empty where every kernel was
    already built in the checkout."""
    mod = sys.modules.get("surs_tpu_torch.ops.cuda_build")
    log = getattr(mod, "BUILD_LOG", None) or {}
    return {name: float(v[0]) for name, v in log.items()}


def build_info(run: Run) -> Dict:
    """Whether this run compiled: a checkout's first run builds the
    kernels inside ``setup_s``; a kernel built after set-up was built
    inside the window."""
    at_setup = run.out.get("built_at_setup", {})
    after = build_log()
    return {"first_run": bool(after),
            "build_s": sum(at_setup.values()),
            "built": sorted(at_setup),
            "built_in_window": sorted(set(after) - set(at_setup))}


def read_layers(run: Run, entries: List[Dict]) -> Dict:
    out = {}
    for m in entries:
        path = os.path.join(PKG, "metrics", m["name"] + ".py")
        mod = load_file_module(path, "perfbench_metric_"
                               + m["name"].replace(".", "_"))
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run) -> Dict:
    import torch
    info = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if run.device.startswith("cuda") else "cpu"),
            "count": int(run.cell.get("chips", 1)),
            "memory_peak_bytes": int(run.out.get("memory_peak_bytes", 0))}
    tr = run.out.get("trace")
    if run.trace and tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
    return info


def result(bench: Dict, run: Run) -> Dict:
    """The result line of a driven run."""
    e2e, layer = cell_metrics(bench, run.cell["name"])
    verdict = judge(run)
    if run.trace:
        metrics = read_layers(run, layer)
    else:
        metrics = {m["name"]: {"value": float(run.out[m["name"]]),
                               "unit": m["unit"]} for m in e2e}
    line = {"correct": verdict["correct"],
            "attempted": int(run.out["attempted"]),
            "failed": int(run.out["failed"]),
            "metrics": metrics, "device": device_info(run)}
    tr = run.out.get("trace")
    if run.trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.device_top(),
                             "idle_gaps": tr.idle_top()}
    line["info"] = {k: run.out[k] for k in
                    ("subjects", "window_subjects", "window_s", "check_s",
                     "obj_bytes", "obj_crc32", "faces_per_subject",
                     "write_s_per_subject", "extract_s_per_subject",
                     "steps")
                    if k in run.out}
    line["info"]["check"] = run.out["check"].get("info", {})
    line["info"]["build"] = build_info(run)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in verdict["compared"].items()}
    return line


def print_result(line: Dict) -> int:
    """Print the comparisons last on stderr and the line last on
    stdout; exit 1 when a forbidden module was loaded (no line then)."""
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 1
    build = line.get("info", {}).get("build", {})
    if build.get("first_run"):
        print(f"first run in this checkout: {len(build['built'])} native "
              f"libraries compiled in {build['build_s']!r} s inside "
              f"setup_s; built inside the window: "
              f"{build['built_in_window'] or 'none'}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, default=float), flush=True)
    return 0
