"""Where a tile of the bf16 K3/K4 chain kernels spends its time.

    python -m surs_tpu_torch.probes.cols_breakdown

Builds ablated copies of ``csrc/fused_cols_mlp.cu`` next to the real one
(into ``csrc/_build/breakdown/``) and times the chain kernel of each, K3
on one chunk of 32,768 columns x 512 depths and K4 on one chunk of
32,768 windows, over column terms from the real pre-pass:

- ``full``: the kernel as built for the service;
- ``no_weight_stream``: the producer copies no hidden weights (the C0
  slices still travel): the chain without its L2 weight stream;
- ``no_mma``: the consumers issue no wgmma: the weight stream, the
  layer-0 build and the epilogues without the tensor cores;
- ``no_layer0``: layer 1's A fragments are constants instead of layer 0
  built from the column terms;
- ``two_slots``: a ring of 2 stages instead of 4.

The ablated kernels compute nothing useful; only their times are read.
One JSON line per variant, then the card's name and power limit. Runs
only on a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import time

from ..ops import cuda_build

# (file, text, replacement) per ablation; each text must occur once
ABLATIONS = {
    "full": [],
    "no_weight_stream": [(
        "fused_cols_mlp.cu",
        "mbar_arrive_tx(full + 8 * slot, STAGE_BYTES + (c0 ? G * SK * 4 : 0));\n"
        "        bulk_g2s(ring0 + slot * STAGE_BYTES, w + (size_t)s * STAGE_ELEMS,\n"
        "                 STAGE_BYTES, full + 8 * slot);",
        "mbar_arrive_tx(full + 8 * slot, c0 ? G * SK * 4 : 0);")],
    "no_mma": [
        ("hopper.cuh",
         '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " '
         'SURS_WG_D64\n      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\\n}\\n"',
         '      "}\\n"'),
        ("hopper.cuh",
         '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " '
         'SURS_WG_D64\n      ", %64, %65, p, 1, 1, 0, 0;\\n}\\n"',
         '      "}\\n"')],
    "no_layer0": [(
        "fused_cols_mlp.cu",
        "      build_a0<HR>(af, cb + r.c0 * SK, cb + r.c1 * SK, wz + COL0 + kc * SK,\n"
        "                   wp + COL0 + kc * SK, r, tig);",
        "      for (int j = 0; j < 4; ++j)\n"
        "        for (int e = 0; e < 4; ++e) af[j][e] = 0x3c003c00u + kc;")],
    "two_slots": [(
        "fused_cols_mlp.cu",
        "constexpr int SLOTS = 4;",
        "constexpr int SLOTS = 2;")],
}


def build_variants(source: str, ablations, names, subdir: str):
    """{variant: loaded library} of ``csrc/<source>`` with each named
    ablation's replacements (``ablations[name]``: (file, text,
    replacement), each text found once), into
    ``csrc/_build/<subdir>/<variant>/``; one nvcc per variant, all
    together."""
    root = cuda_build.BUILD_DIR / subdir
    shutil.rmtree(root, ignore_errors=True)
    files = [source] + [h.name for h in cuda_build.CSRC.glob("*.cuh")]
    for name in names:          # every ablation applies before any build
        d = root / name
        d.mkdir(parents=True)
        for f in files:
            (d / f).write_text((cuda_build.CSRC / f).read_text())
        for f, old, new in ablations[name]:
            text = (d / f).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: text not found in {f}")
            (d / f).write_text(text.replace(old, new))
    procs = {}
    for name in names:
        d = root / name
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
               str(d / "lib.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(root / name / "lib.so"))
    return libs


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def main() -> None:
    import numpy as np
    import torch
    from ..models.layers import init_weights
    from ..models.surface_classifier import SurfaceClassifier
    from ..ops import fused_mlp as fm

    if not torch.cuda.is_available():
        raise SystemExit("cols_breakdown needs a CUDA card")
    t0 = time.perf_counter()
    libs = build_variants("fused_cols_mlp.cu", ABLATIONS, list(ABLATIONS),
                          "breakdown")
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.surs_fused_dual_mlp_cols_wgmma.argtypes = [P, P, I, I] + [P] * 6
        lib.surs_fused_dual_mlp_runs_wgmma.argtypes = [P, P, I] + [P] * 6
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator().manual_seed(3)
    mlps = [SurfaceClassifier(d) for d in (fm.KERNEL_DIMS_LR,
                                           fm.KERNEL_DIMS_HR)]
    for m in mlps:
        init_weights(m, gen)
    cw = fm.prepare_cols_weights(*(m.cuda() for m in mlps), 256,
                                 dtype=torch.bfloat16)
    pk = cw.packed
    n = fm.CHUNK_COLS
    rng = np.random.default_rng(3)
    x_lr, x_hr = (torch.from_numpy(rng.standard_normal((n, c)).astype(
        np.float32)).cuda() for c in (256, 64))
    kf = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)).cuda()
    zf = torch.linspace(-0.9, 0.9, 512).cuda()
    terms = fm.column_terms(x_lr, x_hr, kf, cw)
    out = torch.empty((n, 512), device="cuda"), torch.empty((n, 512),
                                                            device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    weights = (pk.whid.data_ptr(), pk.cvec.data_ptr(), pk.hvec.data_ptr())

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
        k3 = timed(lambda: lib.surs_fused_dual_mlp_cols_wgmma(
            terms.data_ptr(), zf.data_ptr(), n, 512, *weights,
            out[0].data_ptr(), out[1].data_ptr(), stream), 3)
        k4 = timed(lambda: lib.surs_fused_dual_mlp_runs_wgmma(
            terms.data_ptr(), zf.data_ptr(), n, *weights, out[0].data_ptr(),
            out[1].data_ptr(), stream), 20)
        print(json.dumps({"variant": name, "k3_chain_ms_per_chunk": k3,
                          "k4_chain_ms_per_chunk": k4}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
