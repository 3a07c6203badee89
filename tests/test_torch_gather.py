"""Kernel K5's plain version (surs_tpu_torch/ops/row_gather.py) and the
port's gather probe against benchmarks/vmem_gather_probe.py on the CPU
(its Pallas bodies in interpret mode, as its PROBE=interp mode runs
them); the port's import isolation; the evaluators' device default.

A gather does no arithmetic, so every comparison is bit for bit.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from surs_tpu_torch.ops import row_gather as rg
from surs_tpu_torch.probes import vmem_gather_probe as tprobe
from surs_tpu_torch.recon.evaluator import eval_grid_dense, eval_grid_octree
from surs_tpu_torch.recon.grid import grid_matrix

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROBE = os.path.join(ROOT, "benchmarks", "vmem_gather_probe.py")
SHAPES = {"small": dict(H=16, W=16, C=128, N=1024),
          "full": dict(H=128, W=128, C=256, N=49152)}


@pytest.fixture
def jprobe(monkeypatch):
    """The JAX probe loaded by path in its CPU mode (PROBE=interp: each
    Pallas variant runs in interpret mode)."""
    monkeypatch.setenv("PROBE", "interp")
    monkeypatch.setattr(sys, "path", list(sys.path))   # it prepends ROOT
    spec = importlib.util.spec_from_file_location("jax_vmem_gather_probe",
                                                  JAX_PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX array (2- or 4-byte
    elements) as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.element_size() == 2
                   else torch.int32).numpy()
    else:
        x = np.asarray(x)
    return x.view(np.uint16 if x.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("size,dtype", [("small", "bfloat16"),
                                        ("small", "float32"),
                                        ("full", "bfloat16")])
def test_gather_matches_jax_probe(jprobe, size, dtype):
    """run_xla, build("vec") and build("loop") against row_gather_ref
    and row_gather's two variants on CPU tensors."""
    shape = SHAPES[size]
    for name, value in shape.items():
        setattr(jprobe, name, value)
    jprobe.DTYPE = getattr(jnp, dtype)
    rows = shape["H"] * shape["W"]
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((rows, shape["C"])).astype(np.float32)
    idx = rng.integers(0, rows, shape["N"]).astype(np.int32)
    jfeat, jidx = jnp.asarray(f32, jprobe.DTYPE), jnp.asarray(idx)
    tfeat = torch.from_numpy(f32).to(getattr(torch, dtype))
    tidx = torch.from_numpy(idx)
    np.testing.assert_array_equal(bits(tfeat), bits(jfeat))
    want = [jprobe.run_xla(jfeat, jidx), jprobe.build("vec")(jfeat, jidx),
            jprobe.build("loop")(jfeat, jidx)]
    got = [rg.row_gather_ref(tfeat, tidx)] + [
        rg.row_gather(tfeat, tidx, v) for v in rg.VARIANTS]
    for w in want:
        assert w.shape == (shape["N"], shape["C"])
        for g in got:
            np.testing.assert_array_equal(bits(g), bits(w))
    assert rg.row_gather.launches == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", rg.VARIANTS)
def test_kernel_order_matches_jax_probe(jprobe, variant, dtype):
    """K5's plain version in the kernel's order (row_gather_tiled_ref,
    on the card's grid and on 1 SM of 3 blocks) against the JAX probe's
    Pallas body of the same name, bit for bit: at the small shape and at
    ragged counts n = 1, T - 1 and T + 1 around loop's tile T (the JAX
    probe's BLOCK set to n: one grid step)."""
    shape = SHAPES["small"]
    for name in ("H", "W", "C"):
        setattr(jprobe, name, shape[name])
    jprobe.DTYPE = getattr(jnp, dtype)
    rows = shape["H"] * shape["W"]
    rng = np.random.default_rng(11)
    f32 = rng.standard_normal((rows, shape["C"])).astype(np.float32)
    jfeat = jnp.asarray(f32, jprobe.DTYPE)
    tfeat = torch.from_numpy(f32).to(getattr(torch, dtype))
    row_bytes = shape["C"] * tfeat.element_size()
    tile = rg.loop_tile(row_bytes)[0]
    for n in (shape["N"], 1, tile - 1, tile + 1):
        idx = rng.integers(0, rows, n).astype(np.int32)
        jprobe.N = n
        jprobe.BLOCK = 512 if n % 512 == 0 else n
        want = jprobe.build(variant)(jfeat, jnp.asarray(idx))
        assert want.shape == (n, shape["C"])
        for sms, occupancy in ((132, 3), (1, 3)):
            plan = rg.row_gather_plan(n, row_bytes, variant, sms, occupancy)
            got = rg.row_gather_tiled_ref(tfeat, torch.from_numpy(idx), plan)
            np.testing.assert_array_equal(bits(got), bits(want))


def test_probe_constants_and_inputs_match_jax_probe(jprobe):
    for name in ("H", "W", "C", "N", "BLOCK"):
        assert getattr(tprobe, name) == getattr(jprobe, name), name
    assert tprobe.DTYPE == torch.bfloat16 and jprobe.DTYPE == jnp.bfloat16
    # the JAX probe's main() makes its inputs so
    rng = np.random.default_rng(0)
    jfeat = jnp.asarray(rng.standard_normal((jprobe.H * jprobe.W,
                                             jprobe.C)), jprobe.DTYPE)
    jidx = jnp.asarray(rng.integers(0, jprobe.H * jprobe.W, jprobe.N),
                       jnp.int32)
    feat, idx = tprobe.probe_inputs("cpu")
    np.testing.assert_array_equal(bits(feat), bits(jfeat))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32


def _bad_calls():
    feat = torch.zeros((64, 128), dtype=torch.bfloat16)
    idx = torch.zeros(8, dtype=torch.int32)
    shifted = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:]
    return {
        "float16 map": (feat.half(), idx, "vec"),
        "int32 map": (feat.int(), idx, "loop"),
        "1-D map": (feat.reshape(-1), idx, "vec"),
        "3-D map": (feat.view(8, 8, 128), idx, "vec"),
        "strided map": (feat.t(), idx, "vec"),
        "24-byte rows": (torch.zeros((64, 12), dtype=torch.bfloat16), idx,
                         "vec"),
        "misaligned base": (shifted.view(64, 128), idx, "loop"),
        "loop rows over 64 KB": (torch.zeros((4, 16400)), idx, "loop"),
        "2-D idx": (feat, idx.view(2, 4), "vec"),
        "int64 idx": (feat, idx.long(), "vec"),
        "idx on another device": (feat, idx.to("meta"), "vec"),
        "meta tensors": (feat.to("meta"), idx.to("meta"), "vec"),
        "unknown variant": (feat, idx, "take"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    feat, idx, variant = _bad_calls()[case]
    with pytest.raises(ValueError):
        rg.row_gather(feat, idx, variant)
    assert rg.row_gather.launches == 0


def test_plain_version_raises_on_index_past_the_map():
    feat = torch.arange(64 * 8, dtype=torch.float32).view(64, 8)
    with pytest.raises(IndexError):
        rg.row_gather(feat, torch.tensor([0, 64], dtype=torch.int32))
    assert rg.row_gather.launches == 0


def test_probe_main_on_cpu_reports_correct(capsys):
    recs = tprobe.main(device="cpu")
    assert [r["variant"] for r in recs] == list(tprobe.VARIANTS)
    assert all(r["correct"] for r in recs)
    assert not any("steady_ms" in r or "first_s" in r for r in recs)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == recs
    assert rg.row_gather.launches == 0


def test_probe_main_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprobe.main()


@pytest.mark.parametrize("evaluator", ["octree", "dense"])
def test_evaluators_without_device_raise_without_gpu(monkeypatch, evaluator):
    """No device means CUDA, as for the service and train(): never the
    CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R = 8
    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)

    def eval_fn(points):
        z = torch.zeros(points.shape[1])
        return z, z

    with pytest.raises(RuntimeError, match="no CUDA device"):
        if evaluator == "octree":
            eval_grid_octree(eval_fn, R, mat, 0.05, init_resolution=4)
        else:
            eval_grid_dense(eval_fn, R, mat)


ISOLATION = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import surs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(surs_tpu_torch.__path__,
                                               "surs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "surs_tpu" or m.startswith(("surs_tpu.", "jax", "benchmarks"))))
print(" ".join(names))
print(" ".join(bad))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_surs_tpu():
    """Every module of surs_tpu_torch, and chip_smoke.py, imports with
    JAX unimportable and loads nothing of surs_tpu or benchmarks/."""
    run = subprocess.run([sys.executable, "-c", ISOLATION], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    names, bad = run.stdout.split("\n")[:2]
    assert "surs_tpu_torch.probes.vmem_gather_probe" in names.split()
    assert "surs_tpu_torch.ops.row_gather" in names.split()
    assert bad == ""
