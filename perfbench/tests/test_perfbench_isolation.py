"""Nothing of the benchmark loads JAX or the JAX package: its modules
import with those blocked, module names compared whole by their top-level
part (the program, ``surs_tpu_torch``, starts with ``surs_tpu``), and the
plain reference loads with the program blocked too."""

import glob
import json
import os
import subprocess
import sys

from perfbench import harness

BLOCKER = r'''
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
import importlib, runpy
for mod in sys.argv[3].split(","):
    if mod.endswith(".py"):
        runpy.run_path(mod, run_name="perfbench_loaded")
    else:
        importlib.import_module(mod)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("LOADED_BAD=" + ",".join(bad))
'''


def load_with_blocked(blocked, modules):
    r = subprocess.run(
        [sys.executable, "-c", BLOCKER, ",".join(blocked), harness.ROOT,
         ",".join(modules)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED_BAD=\n" in r.stdout or r.stdout.strip().endswith(
        "LOADED_BAD="), r.stdout


def test_harness_and_files_load_without_jax():
    pkg = harness.PKG
    mods = ["perfbench.run", "perfbench.harness", "perfbench.calibrate",
            "perfbench.drivers.serve", "perfbench.sink", "perfbench.trace",
            "perfbench.yardstick", "perfbench.work", "perfbench.faults",
            "perfbench.reference.serve_check", "surs_tpu_torch.serve",
            "surs_tpu_torch.train.loop"]
    mods += sorted(glob.glob(os.path.join(pkg, "metrics", "*.py")))
    load_with_blocked(["jax", "jaxlib", "flax", "optax", "surs_tpu"], mods)
    for kind in ("configs", "traffic", "limits"):
        for path in glob.glob(os.path.join(pkg, kind, "*.json")):
            with open(path) as f:
                json.load(f)


def test_reference_loads_without_the_program():
    mods = ["perfbench.reference.model", "perfbench.reference.octree",
            "perfbench.reference.check", "perfbench.reference.serve_check",
            "perfbench.yardstick"]
    load_with_blocked(["jax", "jaxlib", "flax", "optax", "surs_tpu",
                       "surs_tpu_torch"], mods)


def test_the_block_compares_whole_top_level_names():
    # surs_tpu_torch passes a block of surs_tpu; surs_tpu itself does not
    load_with_blocked(["surs_tpu"], ["surs_tpu_torch.config"])
    r = subprocess.run(
        [sys.executable, "-c", BLOCKER, "surs_tpu", harness.ROOT,
         "surs_tpu"], capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "blocked: surs_tpu" in r.stderr
