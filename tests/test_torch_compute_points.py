"""The port's compute_points app (surs_tpu_torch/apps/compute_points.py)
against apps/compute_points.py on the CPU: the same printed lines for a
tiny GEO/OBJ folder of two HR / LR pairs with the same seed (the same
draws, the winding-number labels of both packages)."""

import os
import runpy
import sys

import numpy as np
import torch

from surs_tpu.recon.mesh_io import save_obj_mesh as jax_save_obj
from surs_tpu_torch.apps import compute_points
from tests.test_prt import icosphere

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_pairs(root):
    """Two subjects: an HR sphere and a coarser, slightly smaller and
    shifted LR one, so labels flip both ways."""
    obj = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj)
    for i, name in enumerate(("s0", "s1")):
        v, f = icosphere(2, 0.5 + 0.05 * i)
        jax_save_obj(os.path.join(obj, f"{name}_HR.obj"), v, f)
        v, f = icosphere(1, 0.47)
        jax_save_obj(os.path.join(obj, f"{name}_LR.obj"),
                     v + np.float32([0.03, 0, 0]), f)


def test_compute_points_prints_the_jax_lines(tmp_path, capsys,
                                             monkeypatch):
    write_pairs(str(tmp_path))
    flags = ["--dataroot", str(tmp_path), "--num_sample_inout", "400",
             "--sigma", "0.05", "--b_min", "-1", "-1", "-1", "--b_max",
             "1", "1", "1", "--seed", "7"]
    counts = compute_points.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["compute_points.py"] + flags)
    runpy.run_path(os.path.join(ROOT, "apps", "compute_points.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    assert got == want
    assert [ln.split(":")[0] for ln in got] == ["s0", "s1", "TOTAL"]
    assert sorted(counts) == ["s0", "s1"]
    assert all(n == 400 for _, _, n in counts.values())
    assert sum(a for a, _, _ in counts.values()) > 0      # both ways
    assert sum(b for _, b, _ in counts.values()) > 0
    # --limit keeps the first subject
    compute_points.main(flags + ["--device", "cpu", "--limit", "1"])
    assert capsys.readouterr().out.splitlines()[0] == got[0]
