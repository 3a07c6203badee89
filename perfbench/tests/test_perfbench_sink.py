"""The OBJ sink: the bytes the program's native writer puts into the
harness's pipes equal the file the same writer writes, none reach the
disk, and the reservoir keeps the drawn subjects."""

import os

import numpy as np

from perfbench import sink as sink_mod


def test_drained_bytes_equal_the_written_file(tmp_path):
    from surs_tpu_torch.recon.mesh_io import save_obj_mesh
    rng = np.random.default_rng(0)
    verts = rng.uniform(-0.5, 0.5, (30_000, 3)).astype(np.float32)
    faces = rng.integers(0, 30_000, (60_000, 3))
    save_obj_mesh(str(tmp_path / "file.obj"), verts, faces)
    want = (tmp_path / "file.obj").read_bytes()
    sink = sink_mod.ObjSink(str(tmp_path / "pipes"), keep=2,
                            rng=np.random.default_rng(1))
    try:
        for name in ("a", "b", "c"):
            sink.plan(name)
            for suffix in sink_mod.SUFFIXES:
                save_obj_mesh(os.path.join(sink.dir, name + suffix), verts,
                              faces)
        sink.wait()
        assert sink.files == 6 and sink.bytes == 6 * len(want)
        assert len(sink.kept) == 2
        for pair in sink.kept.values():
            assert pair == [want, want]
        assert os.listdir(sink.dir) == []
    finally:
        sink.close()


def test_close_frees_a_pipe_never_written(tmp_path):
    sink = sink_mod.ObjSink(str(tmp_path / "pipes"))
    sink.plan("never", sample=False)
    sink.close()
    assert not sink._thread.is_alive()
