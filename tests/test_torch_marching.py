"""The port's marching cubes (surs_tpu_torch/recon/marching.py) against
the JAX package's ``marching_cubes_classic``: the same table, the same
welding and float64 interpolation, so the same arrays exactly; and the
OBJ writer byte for byte."""

import numpy as np
import pytest
import torch

from surs_tpu.recon.mc_tables import MC_CASE_TRIS as J_TABLE
from surs_tpu.recon.mc_tables import marching_cubes_classic
from surs_tpu.recon.mesh_io import save_obj_mesh as j_save_obj_mesh
from surs_tpu_torch.recon.marching import marching_cubes
from surs_tpu_torch.recon.mc_tables import MC_CASE_TRIS
from surs_tpu_torch.recon.mesh_io import save_obj_mesh

torch.set_num_threads(1)


def sphere_vol(n, center, r):
    g = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"), -1)
    d = np.sqrt(((g - np.asarray(center)) ** 2).sum(-1))
    return (0.5 + (r - d)).astype(np.float32)


VOLUMES = {
    "interior_sphere": lambda: sphere_vol(24, (11.5, 11.5, 11.5), 7.3),
    "boundary_cut_sphere": lambda: sphere_vol(16, (15.0, 15.0, 15.0), 9.1),
    "noise": lambda: np.random.default_rng(11).random(
        (9, 10, 11)).astype(np.float32),
    "flat_plateaus": lambda: np.round(np.random.default_rng(3).random(
        (12, 12, 12)) * 2).astype(np.float32) * 0.5,
}


def test_table_is_the_same_construction():
    np.testing.assert_array_equal(MC_CASE_TRIS, J_TABLE)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_mesh_equals_classic(name):
    vol = VOLUMES[name]()
    want_v, want_f = marching_cubes_classic(vol, 0.5)
    got_v, got_f = marching_cubes(torch.from_numpy(vol), 0.5)
    assert got_v.dtype == torch.float32 and got_f.dtype == torch.int64
    assert want_f.shape[0] > 0
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_f.numpy(), want_f)


def test_empty_field():
    v, f = marching_cubes(torch.zeros(6, 6, 6), 0.5)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_obj_writer_is_byte_identical(tmp_path):
    vol = VOLUMES["interior_sphere"]()
    verts, faces = marching_cubes_classic(vol, 0.5)
    verts = verts * 0.013 - 0.21          # negative and rounding cases
    j_save_obj_mesh(str(tmp_path / "a.obj"), verts, faces)
    save_obj_mesh(str(tmp_path / "b.obj"), verts, faces)
    a = (tmp_path / "a.obj").read_bytes()
    assert a == (tmp_path / "b.obj").read_bytes()
    assert a.startswith(b"v ") and b"\nf " in a


def native_fixed4(v: float) -> str:
    """csrc/mesh_native.cpp:fmt_fixed4 in Python: the sign from v < 0,
    then |v| * 1e4 + 0.5 truncated, in the same double arithmetic."""
    scaled = int(abs(v) * 10000.0 + 0.5)
    return f"{'-' if v < 0 else ''}{scaled // 10000}.{scaled % 10000:04d}"


def native_obj_bytes(verts, faces) -> bytes:
    lines = ["v " + " ".join(native_fixed4(float(c)) for c in v)
             for v in np.asarray(verts, dtype=np.float64)]
    lines += ["f %d %d %d" % (f[0] + 1, f[2] + 1, f[1] + 1) for f in faces]
    return ("\n".join(lines) + "\n").encode()


def test_obj_writer_rounds_ties_as_the_native_writer(tmp_path):
    """A plateau field (values 0 / 0.5 / 1) puts vertices on grid points
    and midpoints; mapped as a 512^3 grid over the +-0.5 box, many lie
    exactly halfway between two 4-decimal values (g / 512 - 0.5 for
    g = 16 mod 32). The port's file equals the JAX package's default
    writer byte for byte: its native writer where the library is built,
    else that writer's formula."""
    from surs_tpu.recon import native
    vol = VOLUMES["flat_plateaus"]()
    verts, faces = marching_cubes_classic(vol, 0.5)
    verts = verts.astype(np.float64) * 16 / 512 - 0.5
    scaled = np.abs(verts) * 1e4
    assert (scaled - np.floor(scaled) == 0.5).any()      # ties present
    save_obj_mesh(str(tmp_path / "port.obj"), verts, faces)
    got = (tmp_path / "port.obj").read_bytes()
    if native.available():
        native.write_obj(str(tmp_path / "jax.obj"), verts, faces)
        want = (tmp_path / "jax.obj").read_bytes()
    else:
        want = native_obj_bytes(verts, faces)
    assert got == want


def test_obj_writer_tie_list(tmp_path):
    """Hand-made ties and signs against the native writer's formula."""
    vals = [-0.40625, 0.40625, 0.00005, -0.00005, -0.00001, -0.0, 0.0,
            0.03125, -0.5, 1.99995, -123.45675, 2.5e-5]
    verts = np.array(vals, dtype=np.float64).reshape(-1, 3)
    p = tmp_path / "ties.obj"
    save_obj_mesh(str(p), verts, np.zeros((0, 3), np.int64))
    assert p.read_bytes() == native_obj_bytes(verts, [])
    text = p.read_text().split()
    assert text[1] == "-0.4063" and text[3] == "0.0001"
    assert text[6] == "-0.0000" and text[7] == "0.0000"


def test_obj_writer_winding(tmp_path):
    p = tmp_path / "tri.obj"
    save_obj_mesh(str(p), np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]),
                  np.array([[0, 1, 2]]))
    assert p.read_text().splitlines() == [
        "v 0.0000 0.0000 0.0000", "v 1.0000 0.0000 0.0000",
        "v 0.0000 1.0000 0.0000", "f 1 3 2"]
