"""The port's host OBJ library (surs_tpu_torch/csrc/mesh_native.cpp,
recon/native.py, recon/mesh_io.py) against the JAX package's writer and
reader: ``surs_tpu.recon.native.write_obj`` (its default writer, the
committed ``csrc/libsurs_native.so``) and ``surs_tpu.recon.mesh_io.
load_obj``. Files are compared byte for byte, read meshes exactly; also
the port's plain versions (``save_obj_mesh_ref``, ``load_obj_ref``) and
the build's rules (the library named by a hash, a failed or missing
compiler raising)."""

import os

import numpy as np
import pytest
import torch

from surs_tpu.recon import native as j_native
from surs_tpu.recon.mc_tables import marching_cubes_classic
from surs_tpu.recon.mesh_io import load_obj as j_load_obj
from surs_tpu_torch.ops import cuda_build
from surs_tpu_torch.recon import native
from surs_tpu_torch.recon.mesh_io import (load_obj, load_obj_ref,
                                          save_obj_mesh, save_obj_mesh_ref)

torch.set_num_threads(1)


def sphere():
    n, c, r = 20, 9.5, 6.3
    g = np.stack(np.meshgrid(*([np.arange(n)] * 3), indexing="ij"), -1)
    vol = (0.5 + r - np.sqrt(((g - c) ** 2).sum(-1))).astype(np.float32)
    verts, faces = marching_cubes_classic(vol, 0.5)
    return verts * 0.013 - 0.21, faces      # negatives, every rounding


def tie_plateaus():
    """tests/test_torch_marching.py's plateau field as a 512^3 grid over
    the +-0.5 box: many coordinates lie halfway between two 4-decimal
    values."""
    vol = np.round(np.random.default_rng(3).random(
        (12, 12, 12)) * 2).astype(np.float32) * 0.5
    verts, faces = marching_cubes_classic(vol, 0.5)
    verts = verts.astype(np.float64) * 16 / 512 - 0.5
    scaled = np.abs(verts) * 1e4
    assert (scaled - np.floor(scaled) == 0.5).any()
    return verts, faces


def signs():
    vals = [-0.0, 0.0, -0.00001, -0.00004999, -0.00005, 0.00005, -0.40625,
            0.40625, -1e-300, 1.99995, -123.45675, 2.5e-5, -7.0, 1e6,
            -0.99999, 0.99995, -0.0001, 3.14159265]
    verts = np.array(vals, dtype=np.float64).reshape(-1, 3)
    return verts, np.array([[0, 1, 2], [3, 4, 5]], np.int64)


def big_indices():
    rng = np.random.default_rng(5)
    verts = rng.standard_normal((7, 3))
    faces = np.array([[2 ** 31, 2 ** 31 + 1, 2 ** 32 + 7],
                      [2 ** 40, 0, 2 ** 53 - 2],
                      [2 ** 31 - 2, 2 ** 31 - 1, 9]], np.int64)
    return verts, faces


def empty():
    return np.zeros((0, 3)), np.zeros((0, 3), np.int64)


MESHES = {"sphere": sphere, "tie_plateaus": tie_plateaus, "signs": signs,
          "big_indices": big_indices, "empty": empty}


def test_jax_writer_is_the_native_one():
    # the comparison below is against the JAX package's default writer,
    # its C++ library, and not its Python fallback
    assert j_native.available()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_writer_matches_jax_byte_for_byte(tmp_path, name):
    verts, faces = MESHES[name]()
    save_obj_mesh(str(tmp_path / "port.obj"), verts, faces)
    save_obj_mesh_ref(str(tmp_path / "ref.obj"), verts, faces)
    assert j_native.write_obj(str(tmp_path / "jax.obj"), verts, faces)
    got = (tmp_path / "port.obj").read_bytes()
    assert got == (tmp_path / "jax.obj").read_bytes()
    assert got == (tmp_path / "ref.obj").read_bytes()
    assert (len(got) == 0) == (name == "empty")


def test_signs_and_ties_as_text(tmp_path):
    verts, faces = signs()
    save_obj_mesh(str(tmp_path / "s.obj"), verts, faces)
    text = (tmp_path / "s.obj").read_text().split()
    assert text[1:4] == ["0.0000", "0.0000", "-0.0000"]
    # ties away from zero
    assert text[5:8] == ["-0.0000", "-0.0001", "0.0001"]
    assert text[9:12] == ["-0.4063", "0.4063", "-0.0000"]
    assert text[-8:] == ["f", "1", "3", "2", "f", "4", "6", "5"]


def write_text(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


OBJ_TEXTS = {
    "polygons": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                "f 1 2 3 4\nf 1 2 5\nf 2 3 4 5 1\n",
    "negative": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
                "v 2 2 2\nf -4 -1 -2\nf 1 -1 2\n",
    "vt_vn": "# comment\nv 0.1 0.2 0.3\nvt 0.5 0.5\nvn 0 0 1\n"
             "v -1.5 2.25 3.125\nv 1e-3 -2e2 7\nv 4 5 6\n"
             "f 1/1/1 2/1/1 3/1/1\nf 4//1 3//1 2//1 1//1\n"
             "f 1/1 -1/1 -2/1\n",
}


@pytest.mark.parametrize("name", sorted(OBJ_TEXTS))
def test_reader_matches_jax(tmp_path, name):
    path = write_text(tmp_path / "m.obj", OBJ_TEXTS[name])
    verts, faces = load_obj(path)
    j_verts, j_faces = j_load_obj(path)
    assert verts.dtype == np.float32 and faces.dtype == np.int64
    np.testing.assert_array_equal(verts, j_verts)
    np.testing.assert_array_equal(faces, j_faces)
    r_verts, r_faces = load_obj_ref(path)
    np.testing.assert_array_equal(r_verts, j_verts)
    np.testing.assert_array_equal(r_faces, j_faces)
    assert faces.shape[0] > 0


@pytest.mark.parametrize("name", ["sphere", "tie_plateaus", "empty"])
def test_round_trip_to_4_decimals(tmp_path, name):
    verts, faces = MESHES[name]()
    path = str(tmp_path / "m.obj")
    save_obj_mesh(path, verts, faces)
    got_v, got_f = load_obj(path)
    v = np.asarray(verts, np.float64)
    want = np.where(v < 0, -1, 1) * np.floor(np.abs(v) * 1e4 + 0.5) / 1e4
    np.testing.assert_array_equal(got_v, want.astype(np.float32))
    np.testing.assert_array_equal(got_f, np.asarray(faces)[:, [0, 2, 1]])


def test_write_into_a_missing_directory_raises(tmp_path):
    verts, faces = sphere()
    with pytest.raises(OSError, match="cannot open"):
        save_obj_mesh(str(tmp_path / "no" / "m.obj"), verts, faces)
    with pytest.raises(OSError, match="cannot open"):
        load_obj(str(tmp_path / "missing.obj"))


def test_library_is_built_from_source_by_hash():
    path = cuda_build.build(["mesh_native"])["mesh_native"]
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("mesh_native-") and path.exists()
    assert native.library() is cuda_build.load("mesh_native")


@pytest.mark.parametrize("cxx,match", [
    ("false", "build failed for mesh_native"),
    ("no-such-compiler-here", "not found")])
def test_failed_or_missing_compiler_raises(tmp_path, monkeypatch, cxx,
                                           match):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        cuda_build.build(["mesh_native"])
    assert not [p for p in os.listdir(tmp_path / "_build")
                if p.endswith(".so")]
