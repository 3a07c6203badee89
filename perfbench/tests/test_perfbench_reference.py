"""The plain reference against the measured program's plain path at a
tiny size on the CPU: the same weights give the same features, point
occupancy and octree fields, and a served OBJ pair reads no gap."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from perfbench.drivers import serve
from perfbench.reference import check as chk
from perfbench.reference import model as ref
from perfbench.reference import serve_check

from tiny_cells import TINY


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.serve import SuRSService
    import json
    conf = json.load(open(os.path.join(serve_check.__file__.rsplit(
        "/reference/", 1)[0], "configs", "surs_f32.json")))
    cfg = SuRSConfig(**{**conf["model"], **TINY["model"]})
    params = ref.make_params(ref.param_shapes(cfg.hg_dim, cfg.num_stack_lr),
                             conf["weight_seed"], torch.device("cpu"))
    d = tmp_path_factory.mktemp("served")
    ckpt = str(d / "netG")
    torch.save({"step": 0, "model": params}, ckpt)
    cfg = dataclasses.replace(cfg, load_netG_checkpoint_path=ckpt)
    return SuRSService(cfg, device="cpu"), cfg, params, d


def test_encode_and_query_match_the_program(served):
    svc, cfg, params, _ = served
    pool, _ = serve.make_pool(TINY["traffic"], 7)
    img, mask = pool[1]
    x, _ = serve_check.normalize(img, mask)
    with torch.no_grad():
        img_sr, feats, feat_hr = ref.encode(torch.tensor(x), params,
                                            cfg.num_stack_lr)
        p_sr, p_feats, p_hr = svc.model.encode(torch.tensor(x))
    torch.testing.assert_close(img_sr.permute(0, 2, 3, 1), p_sr,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(feats[-1].permute(0, 2, 3, 1), p_feats[-1],
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(feat_hr.permute(0, 2, 3, 1), p_hr,
                               rtol=1e-4, atol=1e-5)
    pts = torch.rand(1, 3, 500, generator=torch.Generator().manual_seed(0)) \
        - 0.5
    calib = torch.tensor(serve_check.CALIB[None])
    with torch.no_grad():
        hr, lr = ref.query(feats[-1], feat_hr, pts, calib, params,
                           cfg.loadSize, cfg.z_size)
        p_hr_q, p_lr_q = svc.model.query(p_feats, p_hr, pts, calib)
    torch.testing.assert_close(hr, p_hr_q, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(lr, p_lr_q, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_octree", [True, False])
def test_fields_match_the_program(served, use_octree):
    svc, cfg, params, _ = served
    svc.cfg = dataclasses.replace(svc.cfg, use_octree=use_octree)
    c = dataclasses.replace(cfg, use_octree=use_octree)
    pool, _ = serve.make_pool(TINY["traffic"], 8)
    for img, mask in pool[:2]:
        st = {}
        hr, lr = svc.fields(img, mask, stats=st)
        f = serve_check.Fields(c, params, img, mask, torch.device("cpu"),
                               "float32")
        if use_octree:
            assert f.octree() == st["queries"]
            rh, rl = f.full
        else:
            cols = np.stack(np.meshgrid(np.arange(32), np.arange(32),
                                        indexing="ij"), -1).reshape(-1, 2)
            rh, rl = [x.reshape(32, 32, 32) for x in f.lines(2, cols)]
            for axis in (0, 1):
                lh, _ = f.lines(axis, cols)
                full = rh.movedim(axis, -1).reshape(-1, 32)
                torch.testing.assert_close(lh, full, rtol=0, atol=2e-6)
        torch.testing.assert_close(rh, hr, rtol=0, atol=2e-6)
        torch.testing.assert_close(rl, lr, rtol=0, atol=2e-6)
    svc.cfg = dataclasses.replace(svc.cfg, use_octree=True)


def test_served_obj_reads_no_gap(served):
    svc, cfg, params, d = served
    pool, _ = serve.make_pool(TINY["traffic"], 9)
    img, mask = pool[2]
    svc.reconstruct(img, mask, "s", str(d))
    f = serve_check.Fields(cfg, params, img, mask, torch.device("cpu"),
                           "float32")
    f.octree()
    grid = chk.Grid(cfg.resolution, cfg.b_min, cfg.b_max)
    cols = np.stack(np.meshgrid(np.arange(32), np.arange(32),
                                indexing="ij"), -1).reshape(-1, 2)
    rng = np.random.default_rng(0)
    total = 0
    for which, suffix in enumerate(("_HR.obj", "_LR.obj")):
        buf = open(d / ("s" + suffix), "rb").read()
        v, faces, nf = chk.parse_obj(buf, 10_000, rng)
        lines = [(a, cols, f.lines(a, cols)[which]) for a in range(3)]
        res = chk.check_mesh(v, faces, lambda n: f.at_nodes(n, which),
                             lines, grid, 10_000, rng)
        assert res["column_missed"] + res["column_extra"] == 0
        assert res["column_crossings"] > 0
        assert res["malformed"] == 0
        assert np.max(np.concatenate([res["vertex"], res["column"]]),
                      initial=0.0) < 1e-5
        # every crossing of the reference is a served vertex
        assert len(v) == len(chk.crossings_3d(f.full[which]))
        total += len(v)
    assert total > 0


def test_moved_vertices_read_a_gap(served):
    svc, cfg, params, d = served
    pool, _ = serve.make_pool(TINY["traffic"], 9)
    img, mask = pool[2]
    svc.reconstruct(img, mask, "m", str(d))
    f = serve_check.Fields(cfg, params, img, mask, torch.device("cpu"),
                           "float32")
    f.octree()
    grid = chk.Grid(cfg.resolution, cfg.b_min, cfg.b_max)
    buf = open(d / "m_LR.obj", "rb").read()
    v, faces, _ = chk.parse_obj(buf, 1000, np.random.default_rng(0))
    cols = np.zeros((1, 2), np.int64)
    v2 = chk.round_like_writer(v + grid.h * 0.3)
    res = chk.check_mesh(v2, faces, lambda n: f.at_nodes(n, 1),
                         [(2, cols, f.lines(2, cols)[1])], grid, 1000,
                         np.random.default_rng(0))
    assert res["malformed"] > 0.5 * len(v)
