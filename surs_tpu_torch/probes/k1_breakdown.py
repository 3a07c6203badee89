"""Where the bf16 K1 (the served dual MLP's wgmma chain) spends its time.

    python -m surs_tpu_torch.probes.k1_breakdown

Builds ablated copies of ``csrc/fused_dual_mlp.cu`` next to the real one
(into ``csrc/_build/k1_breakdown/``) and times each one's bf16 K1 on one
call of 50,000 points (the served chunk), full widths, seeded weights
and inputs:

- ``full``: the kernel as built for the service;
- ``no_weight_stream``: the producer copies no weights (each stage
  arrives empty at once): the chain without its L2 weight stream;
- ``no_mma``: the consumers issue no wgmma: the weight stream, the input
  staging and the epilogues without the tensor cores;
- ``no_restage``: X is not restaged from the input at each MLP's layer
  2 (the x-products read h1's second half instead).

The ablated kernels compute nothing useful; only their times are read.
One JSON line per variant, then the card's name and power limit. Runs
only on a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import time

from .cols_breakdown import ABLATIONS as COLS_ABLATIONS
from .cols_breakdown import build_variants, card_line

N = 50_000
# (file, text, replacement) per ablation; each text must occur once
ABLATIONS = {
    "full": [],
    "no_weight_stream": [(
        "fused_dual_mlp.cu",
        "        mbar_arrive_tx(full + 8 * slot, bytes);\n"
        "        bulk_g2s(ring0 + slot * STAGE_BYTES, w + (size_t)s * STAGE_ELEMS,\n"
        "                 bytes, full + 8 * slot);",
        "        mbar_arrive_tx(full + 8 * slot, 0);")],
    "no_mma": COLS_ABLATIONS["no_mma"] + [(
        "hopper.cuh",
        '      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " '
        'SURS_WG_D32\n      ", %32, %33, p, 1, 1, 0, 0;\\n}\\n"',
        '      "}\\n"')],
    "no_restage": [(
        "fused_dual_mlp.cu",
        "  // X back over h1's second half, which every warp has read\n"
        "  bar_sync(1 + w, 128);\n"
        "  stage_x(X, a, tile, w, tw);\n",
        "  bar_sync(1 + w, 128);\n")],
}


def main() -> None:
    import numpy as np
    import torch
    from .. import roofline
    from ..models.layers import init_weights
    from ..models.surface_classifier import SurfaceClassifier
    from ..ops import fused_mlp as fm

    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown needs a CUDA card")
    t0 = time.perf_counter()
    libs = build_variants("fused_dual_mlp.cu", ABLATIONS, list(ABLATIONS),
                          "k1_breakdown")
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.surs_fused_dual_mlp_bf16.argtypes = [P, I, P, I, I] + [P] * 6
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator().manual_seed(3)
    mlps = [SurfaceClassifier(d) for d in (fm.KERNEL_DIMS_LR,
                                           fm.KERNEL_DIMS_HR)]
    for m in mlps:
        init_weights(m, gen)
    pk = fm.prepare_fused_weights(*(m.cuda() for m in mlps),
                                  dtype=torch.bfloat16).packed
    rng = np.random.default_rng(3)
    x_lr, xz = (torch.from_numpy(rng.standard_normal((N, c)).astype(
        np.float32)).cuda() for c in (256, 65))
    out = torch.empty(N, device="cuda"), torch.empty(N, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flops, _ = roofline.k1_work(N, "bfloat16")

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    for name, lib in libs.items():
        def call():
            rc = lib.surs_fused_dual_mlp_bf16(
                x_lr.data_ptr(), 256, xz.data_ptr(), 65, N,
                pk.stages.data_ptr(), pk.nbytes.data_ptr(), pk.vec.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
        ms = timed(call, 20)
        print(json.dumps({"variant": name, "k1_ms_per_call": ms, "n": N,
                          "tflops": flops / (ms * 1e-3) / 1e12}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
