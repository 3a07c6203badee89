#!/usr/bin/env python3
"""Drive the PyTorch port (surs_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. build:   compile every CUDA kernel (K1, K2, K3 and K4 together, K5,
              the winding number: five sources) with nvcc and the host
              mesh library (marching tetrahedra, OBJ I/O) with g++
              from the repository's sources (one compiler per source, in
              parallel), with ptxas' registers, spills
              and warnings per kernel and, where the toolkit has
              cuobjdump, the HGMMA count of each kernel's SASS; the bf16
              K1/K3/K4 kernels, K2's 3xTF32 GEMM, the float32 (3xTF32)
              K1/K3/K4 chain kernels and pre-pass and K5's four kernels
              must not spill, and the wgmma kernels must hold HGMMA that
              ptxas did not serialize (its C7511 report).
  2. k1:      kernel K1 (fused dual MLP) against its plain PyTorch version
              on the card, at the serving shapes (N = 50,000 and a ragged
              49,999; also 257, 129, 127 and 1, the ragged edges of a
              128-point tile; the (256, 65) input split, in float32 also
              one [N, 321] part; full widths), in bf16 and float32
              (3xTF32: the float32 K3/K4's pre-pass and chain, one point
              a row), with the kernel's and the plain version's times,
              TFLOP/s and the card's bound for the same work; in float32
              also the pre-pass alone, both bounds (3xTF32 at the TF32
              peak, float32 FMA), the rate of TF32 products and the CUDA
              launches a call (torch.profiler).
  3. k2:      kernel K2 (the training variant, float32 weights, 3xTF32
              on the tensor cores) against its plain version at the
              training shapes (N = B * num_sample_inout = 12,000 and a
              ragged 11,999; also 1, 127 and 129 around its 128-row
              tiles; a mask with zeros), with times, the 3xTF32 and the
              float32 FMA bounds, and its CUDA launches per call (from
              torch.profiler); first its GEMM kernel alone at each
              layer's shape (12,000 rows) against its plain version, with
              ms per layer, and its weight-pack kernel alone against its
              plain version, bit for bit.
  4. k3:      kernel K3 (column-shared dual MLP) against its plain version
              on a slice of the dense 512^3 grid (1,024 columns x 512
              depths and a ragged 1,023 x 500; the real depth features of
              a 512 grid) and at 33,769 columns x 500 (two chunks of the
              wrapper, the second ragged), in bf16 and in float32 (3xTF32
              on wgmma), the slice timed with its plain version; K3 timed
              on the whole grid (262,144 columns x 512 depths) in both,
              with its column-term pre-pass alone (``cols_terms_ms``,
              held to its plain version), the bound (float32: 3xTF32 at
              the TF32 peak, the float32 FMA bound beside it) and, in
              bf16, the plain version; the whole grid's output held to
              the plain version at 2,048 seeded random columns.
  5. k4:      kernel K4 (window dual MLP) the same way at one chunk of the
              runs evaluator (32,768 windows x 8 depths and ragged 32,767
              and 17; depth offsets of the 512 level), in bf16 and
              float32, timed at 32,768 with its pre-pass alone and both
              bounds in float32.
  6. k5:      kernel K5 (row gather, variants vec and loop) against its
              plain version, bit for bit, at the gather probe's shape
              (49,152 rows of a [16384, 256] bf16 map), a ragged 49,151,
              1 and loop's tile - 1 and + 1, 64-channel rows (the hr
              map's) in bf16 and float32, 200- and 2,048-channel rows,
              and indices outside the map (rows of zeros), among them a
              whole tile, also on grids of 1 and 3 blocks; each variant,
              torch.index_select and the plain version timed per launch
              with L2 cold, cold with clean lines (probes/k5_times.py)
              and warm, with the bound and the launch plans; then the
              port's gather probe (surs_tpu_torch.probes.
              vmem_gather_probe), its lines passed on, K5's launch count
              zeroed just before and read just after; and, for
              information, one tap of the serving gather (the full-width
              service's lr map from encode, 50,000 random rows) through
              K5 and through PyTorch.
  7. serve:   SuRSService at the reference model's full width (loadSize
              512, hg_dim 256, 3 lr stacks, the reference MLPs; seeded
              random weights) reconstructs 3 synthetic subjects at 512^3
              with silhouette pruning; K1's launch count is zeroed just
              before and read just after.
  8. check:   the card's results against references: the served query
              path against the model's float32 reference chain at full
              width, a full-resolution field's range, and a small float32
              service on the card against the same service on the CPU.
  9. stages:  one subject's time by stage (encode, evaluate, extract,
              write).
 9b. native_io: the host OBJ library (csrc/mesh_native.cpp, built with
              g++ in the build phase; its seconds) writes the serve
              phase's HR mesh of subject 0; the plain numpy writer writes
              it too, and the bytes must be equal (both timed); the file
              read back (timed) must give the vertices rounded to 4
              decimals and the written winding.
 9c. tets:    marching tetrahedra on the eval path (runs `serve` first
              if it was not named): the serve phase's subject-0 fields at
              512^3 (HR and LR) meshed by marching cubes and marching
              tetrahedra on the card (synchronised seconds, faces,
              vertices, peak memory) and by the host library's marching
              tetrahedra after a copy to the host (seconds of each); the
              card's tets must equal the host's as sets (quantised
              vertices, winding-preserving faces). A 128^3 field (every
              fourth HR point) meshed on the card and on the CPU: the
              same arrays. Then one served request with
              mc_algorithm='tets' and one with mc_backend='host' (request
              seconds, extract_s, write_s, faces, stats["mc"]).
 9d. cli:     whether PIL imports here; then the CLI (surs_tpu_torch's
              main(), ``--once``) serves one PNG image + mask pair at 128^3
              on the card at full width with PIL hidden, so it decodes the
              PNGs itself; K1's launch count zeroed just before and read
              just after (> 0), both OBJ files non-empty.
 9e. eval:    the eval CLI (``surs_tpu_torch.apps.eval_surs.main``) at
              full width and 512^3 on a folder of two PNG pairs
              (image_final/, mask_final/), PIL hidden, loading a
              reference-style state dict synthesized from
              tests/fixtures/ref_netG_state_spec.json with SEED; K1's
              launch count zeroed just before and read just after (> 0),
              both OBJ pairs non-empty, every tensor of the model
              imported; seconds and OBJ-write seconds per subject. Then a
              float32 service loaded from that file and one given the
              same weights through params= give the same fields at
              128^3.
 9e'. turntable: the render_turntable app on the eval phase's subject-0
              HR mesh at 512^3 (the reference-style netG's; kept from
              the eval phase's clean-up): 4 frames at 256 into a GIF
              (s a frame, the GIF's bytes), frame 0 rendered on the card
              against the CPU (masks on 99.9 % of the pixels, RGB within
              1 LSB where both are set).
 9f. color:   the color branch at full width. The humanoid's HR mesh
              (probes/subject_demo.humanoid_mesh, 129,616 faces) written
              with position-coded vertex colors (save_obj_mesh_with_color),
              its views at 512 for 4 yaws and its UV layout at 512
              (render_uv_dataset) on the card, the UV maps rendered again
              on the CPU: mask share and largest position gap. Then
              ResBlkColorNet (mlp_dim_color 513-1024-512-256-128-3, its
              filter on the 256^2 LR image) trained 300 Adam steps at
              batch 2 on TrainDataset items with num_sample_color 5,000:
              the mean loss of the last 10 steps below the first 10's and
              the mean absolute color error at the ground-truth vertices
              below its step-0 value. Then the eval CLI with --with_color
              at 512^3 on one PNG pair, the eval phase's reference netG
              and a seeded reference ResBlkPIFuNet netC
              (tests/fixtures/ref_netC_state_spec.json, every tensor
              imported into RefColorNet); K1's launch count zeroed just
              before and read just after (> 0); the _HR_color.obj holds a
              color in [0, 1] for every vertex of _HR.obj; the card's
              colors of the first 4,096 vertices equal the port's CPU
              RefColorNet's on the same inputs within COLOR_CPU_TOL;
              colorize_s, the color write's seconds, the vertices and the
              card's peak memory.
 9g. mono_f32: SuRSService with feature_dtype float32 serves one
              subject at 512^3 on the mono octree through the float32 K1
              (K1's, K3's and K4's launch counts zeroed just before and
              read just after: K1 > 0, K3 = K4 = 0), with its peak memory
              and time by stage.
 10. dense:   SuRSService(use_octree=False) serves one subject at 512^3
              through K3 (K3's and K1's launch counts zeroed just before
              and read just after: K3 > 0, K1 = 0), with its time by
              stage; K1 scores 50,000 random grid points of the subject
              and they are held against the dense field. Then the same
              with feature_dtype float32: one subject through the float32
              K3 (K3 > 0, K1 = 0), its time by stage.
 11. runs:    SuRSService(serve_octree_mode="runs") serves the 3 subjects
              of `serve` through K4 (K4 > 0, K1 = 0), with one subject's
              time by stage; one subject with feature_dtype float32
              through the float32 K4 (K4 > 0, K1 = 0), its time by stage;
              then a float32 runs service and a float32 mono service at
              128^3, full width, give the same fields within 2e-4.
 12. train:   train/loop.train at full width (batch 2, 6,000 points,
              --fused_train, bf16 trunk) on one synthetic batch repeated:
              1 warm-up step and 5 timed ones; K2's launch count is zeroed
              just before and read just after (3 per step, one per lr
              stack); the loss must fall.
 13. train_check: from one state with a float32 trunk, the fused step's
              gradients against the plain step's, tensor by tensor; and
              the trainer's last checkpoint restored into a fresh state
              on the card equals the state it saved.
 13b. configs: the rest of the model's configuration space at full
              width, on the `train` phase's batch and points: (a) 48
              steps of a batch-norm model with --fused_train, which
              takes the plain step (K2's launch count zeroed just before
              and read just after: 0), beside 3 plain group-norm steps;
              the running statistics moved; its netG_latest loaded
              strictly into a fresh service through load_netG (the
              statistics restored) and the first training item's view
              served at 512^3, mono, K1's launch count zeroed just before
              and read just after (> 0), both meshes non-empty, request
              seconds, evaluate_s; the served field against the trained
              model's own through the same path (CONFIG_FIELD_TOL). (b)
              num_views=2 at batch 1 with --fused_train (the plain step,
              K2 0): predictions [2, N, 1],
              finite losses, seconds per step, peak memory. (c) one
              float32 step at batch 1 each way (no remat, remat, remat +
              remat_encoder) for group and batch norm from the same
              weights: loss, gradients (GRAD_TOL, GRAD_FLOOR) and running
              statistics against no remat's; peak memory, step seconds.
 14. containment (run after k5): the winding-number kernel
              (csrc/winding_number.cu) against its plain version on the
              card at one training item's draw (25,500 points, sigma 5.0
              in the default box) against a body of four ellipsoids
              (327,680 faces HR, 20,480 LR), and on a ragged open mesh,
              zero-area triangles, points on vertices and a mesh with a
              hole: max |winding difference| within WIND_TOL and no label
              mismatch outside the band ||w| - pi| <= WIND_TOL; ms per
              item (HR + LR) against roofline.containment_work's bound
              and the plain version's ms; the kernel's inner loop in the
              built library's SASS (probes/winding_sass.py, cuobjdump):
              instructions a point-triangle pair and the item's time at
              full issue at the card's maximum SM clock.
 15. train_data: writes a dataset of 2 such bodies x 12 yaws (RENDER
              JPEG and MASK PNG at 512 with the bodies' silhouettes under
              the PARAM camera, PARAM .npy, GEO/OBJ through the port's
              writer), times one item's parts (mesh load, image,
              containment, the rest of the sampling), then runs the train
              CLI's main() at full width (loadSize 512, batch 2, 6,000
              points, 3 lr stacks, --fused_train, flip / scale /
              translate and ColorJitter) for one epoch of 12 steps with
              the epoch-end checkpoint and the 4 OBJ files of the meshes
              at 512^3; the winding number's, K2's and K1's launch counts
              are zeroed just before main() and read just after (2 an
              item, 3 a step, > 0); seconds per step, each step's wait
              for its batch, peak memory, finite losses.
 16. precompute: precompute_samples on the card (draws a second; 2
              containment launches a draw), then 6 fused steps trained
              from the cache (no containment launch), their wait for
              data beside train_data's.
 17. accuracy: the accuracy loop of surs_tpu_torch/probes/subject_demo.py
              with 1,000 steps (1,500 there): the capsule humanoid (HR
              detail 0.012, smooth LR) meshed by marching tetrahedra at
              160^3, 12 yaws rendered at 512 on the card, a 16-draw sample
              cache
              with exact implicit labels, train() at full width (residual
              SR, 3 lr stacks, --fused_train, lr 4e-4, batch 2, 6,000
              points, box +-1), then a 512^3 mono reconstruction of view 0
              with its own calibration, meshed by marching cubes on the
              card, timed by stage, and its fields meshed three ways as
              in `tets` (the card's tets equal to the host's); K1's and
              K2's launch counts zeroed just before and read just after.
              Chamfer, P2S and normal L2 /
              cos against the HR ground truth, and the step-0 weights'
              Chamfer through the same pipeline (all through
              probes/subject_demo.run); the ground truth's HR-to-LR
              Chamfer with TF32 on and off (equal); 4 of the 12 views
              (every third yaw) rendered on the card against the same
              renderer on the CPU. Fails
              unless the meshes are non-empty, the mean loss of the last
              10 steps is below that of the first 10, the Chamfer is at
              most 0.085 (5 % of the subject's 1.7-unit height) and at
              most half the step-0 Chamfer (an empty step-0 mesh counts as
              infinitely far), the masks agree on 99.9 % of the pixels
              and RGB within 1 LSB where both are set.
 16b. prt:    PRT shading on train_data's first body (327,680 HR faces,
              163,848 vertices; the dataset is written when train_data
              did not run) with compute_prt's defaults (128 directions,
              96^3): the voxel grid through the winding-number kernel
              (seconds, launches), 8,192 seeded grid points against the
              plain winding number (no label mismatch outside the band
              ||w| - pi| <= WIND_TOL); one 4,096-vertex chunk's
              visibility on the card against the CPU from the same
              float32 inputs (at most 1e-3 of the rays differ); the
              render_dataset CLI with --prt at 512 for 12 yaws, called
              twice (the _prt.npy cache written, then reused; the
              winding number's launch count zeroed just before the first
              call and read just after the second: the voxel grid's,
              once), compute_prt on the whole mesh timed inside the
              first call (seconds, steps, peak memory); one PRT view on
              the card against the CPU (as the accuracy phase's views).
 16c. compute_points: the compute_points app on that dataset at 6,000
              points, sigma 5.0: its lines, flip counts and seconds, the
              winding number's launch count zeroed just before and read
              just after (2 a subject).
 16d. profile: train() at the train phase's configuration for 3 steps
              with profile_dir, and one 512^3 mono
              SuRSService.reconstruct inside utils/profiling.Profiler with
              encode / evaluate / extract / write annotated: each
              trace's bytes, events, device events, K1 / K2 launches (the
              wrappers' counts zeroed just before and read just after,
              and the kernels in the trace) and the card's busy share of
              the traced window (the union of kernel, copy and set
              intervals over the span from the first event to the
              last).
 16e. parallel: the multi-device paths (surs_tpu_torch/parallel/) at
              full width. (a) NCCL at world size 1 in this process: the
              dense subject through K3 into the sharded extraction
              (cubes), as quantised sets against eval_grid_dense_cols and
              the card's cubes, at 256^3 (one slab holds 861,574
              crossing points, past the JAX package's 21-bit face
              format, which the port does not keep); the point-sharded
              mono octree at 512^3 through K1 (bit for bit
              against the unsharded one); ShardedReconstructor on the
              subject at 256^3 (K1, host tets); the data-parallel fused
              step (K2, float32 trunk, SGD) against the single-device
              fused step (losses within 1e-4, the update within 1e-3,
              relative); the eval CLI with --mc_backend sharded at
              256^3. (b) Two ranks sharing the card: over NCCL first
              (its refusal printed), then over gloo: the dense subject
              at 256^3 with the extraction, the point octree at 256^3
              and the step at batch 2, a row a rank, each against the
              single-device result on rank 0 and rank 1. Each part's
              kernel launches zeroed just before it and read just after
              (> 0), its seconds and peak memory, beside the card's name
              and power limit.

``--phases`` runs a subset (for debugging; the result line then says
which ran). Two phases run only when named: ``train_profile`` (a
torch.profiler breakdown of 3 fused steps) and ``serve_profile`` (one
mono octree evaluation at 512^3 timed 4 times and profiled once: device
time by kernel, device operations, K1's device time, busy share). Then a line
saying that the orbax reader (compat/orbax_import.py) is not run here, a
``{"kernels": [...]}`` line (K1-K5, and the float32 K1, K3 and K4 with
their own launches from `mono_f32`, `dense` and `runs`), a ``{"port_kernels": [...]}`` line
(the winding number, which replaces no Pallas kernel), the card's name
and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 3
N_MAIN = 50_000
# training: batch 2 x num_sample_inout 6,000 points per K2 launch
TRAIN_BATCH, TRAIN_POINTS = 2, 6_000
N_TRAIN = TRAIN_BATCH * TRAIN_POINTS
TRAIN_STEPS = 6                  # 1 warm-up + 5 timed
# K1 against its plain version, max |difference| of pred_hr and pred_lr.
# bf16: both round the input, every activation and pred_lr to bf16 and
# sum in float32; only the summation order differs, which can flip a
# bf16 rounding (2^-8 relative) of an activation now and then.
# float32: the kernel's 3xTF32 keeps each product to about 2^-21
# relative (lo.lo dropped, each split 2^-22), at float32 FMA's level, and
# sums in another order (as K2_TOL), on outputs in [0, 1].
K1_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# point counts around K1's 128-point tile and its two 64-row warpgroups
# (both dtypes)
K1_RAGGED = (257, 129, 127, 1)
# the CLI phase's grid
CLI_RESOLUTION = 128
# the eval phase: subjects, the checkpoint's spec (the reference's netG
# keys and shapes at the README config), and the float32 services loaded
# from the file and through params= (the same weights, the same card and
# shapes, so the same kernels: equal up to a nondeterministic cuDNN
# algorithm's summation order)
EVAL_SUBJECTS = 2
EVAL_RESOLUTION = 512
REF_SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "ref_netG_state_spec.json")
CKPT_TOL = 1e-5
# K2 against its plain version, float32 weights and inputs: 3xTF32 keeps
# each product to about 2^-21 relative (lo.lo dropped, each split 2^-22),
# at float32 FMA's level, and sums in another order; on outputs in [0, 1]
K2_TOL = 1e-5
# point counts around K2's 128-row tiles
K2_RAGGED = (1, 127, 129)
# K2's GEMM alone against its plain version on the same split operands,
# max |difference| relative to the largest output: the same products in
# another order (up to 3 x 1,024 terms, ~1e-7 relative each), and the
# output's own split (2^-22)
K2_LAYER_TOL = 1e-5
# K3 and K4 against their plain versions: both round the features, every
# activation and the depth term z * w_z to bf16 at the same points and
# keep kf and pred_lr in float32; only the summation order differs (the
# column terms are a 320-long FMA chain in the kernel, a blocked product
# in the plain version), which can flip an activation's bf16 rounding
# now and then, as for K1. float32: the kernels' 3xTF32 keeps each
# product to about 2^-21 relative, at float32 FMA's level (as K2_TOL),
# and sums in another order.
COLS_TOL = {"bfloat16": K1_TOL["bfloat16"], "float32": 1e-5}
# the column-term pre-pass against its plain version, relative to the
# largest term: both take the same bf16 (or 3xTF32 hi / lo) products,
# summed in float32 in another order (320 terms, ~1e-7 relative each)
TERMS_TOL = 1e-5
# the float32 runs service against the float32 mono service at 128^3
# (tests/test_evaluator_runs.py's tolerance): the window path feeds the
# depth as kf + zt, the point path as one projected z, equal up to
# float32 rounding, and a rounding-level change can move a pruned cell's
# (max + min) / 2 fill by that much
RUNS_VS_MONO_TOL = 2e-4
# the dense phase's shapes: a slice of the 512^3 grid, and the grid
DENSE_R = 512
SLICE_COLS = 1024
# K3 at a column count that is not a multiple of the wrappers' chunk
# (32,768 columns): two chunks, the second ragged
K3_RAGGED_COLS = 32_768 + 1_001
# columns of the whole dense grid held to the plain version
GRID_SAMPLE_COLS = 2048
# the runs evaluator's chunk of windows, and its window depth
NWIN = 32_768
ZB = 8
# fused vs plain step gradients, float32 trunk, per tensor, relative
# norm error. Both compute the same float32 function: the MLP outputs
# differ by summation order (~1e-7 relative, K2 vs cuBLAS), and cuDNN's
# convolution backward may accumulate in another order from run to run.
# 1e-4 leaves a margin of ~100x over that, while a wrong gradient path
# (mask, cross-wiring, a missing term) is off by O(1).
GRAD_TOL = 1e-4
# the served path (bf16 weights and features) against the model's float32
# reference chain: bf16 rounds weights and activations (2^-9 relative)
# at each of five layers per MLP
SERVE_TOL = 2e-2
# the float32 service on the card against the same service on the CPU
# (cuDNN and cuBLAS in float32, TF32 off)
F32_SERVICE_TOL = 1e-4
# K5: a gather copies bits, so it must equal its plain version exactly;
# its checks add rows of 64 channels (the hr map's 128-byte bf16 rows)
K5_HR_CHANNELS = 64


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the script's
    seconds when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def time_cuda(fn, reps: int, warm: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_cuda_batch(fn, calls: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` enqueued ``calls`` times between
    two CUDA events (median of ``reps``): a kernel shorter than its
    launch's host time is timed on the card, not on the host."""
    return time_cuda(lambda: [fn() for _ in range(calls)], reps) / calls


# K5's four kernels, which must not spill either
K5_KERNELS = ("row_gather_vec_bf16_kernel", "row_gather_vec_f32_kernel",
              "row_gather_loop_bf16_kernel", "row_gather_loop_f32_kernel")
KERNELS = ("fused_dual_mlp_wgmma_kernel",
           "fused_dual_mlp_train_tf32x3_gemm_kernel",
           "fused_dual_mlp_train_tf32x3_pack_kernel",
           "fused_dual_mlp_train_tf32x3_split_kernel",
           "fused_dual_mlp_train_tf32x3_head_kernel", "cols_terms_bf16_kernel",
           "fused_dual_mlp_cols_wgmma_kernel", "fused_dual_mlp_runs_wgmma_kernel",
           "cols_terms_tf32x3_kernel", "fused_dual_mlp_cols_tf32x3_kernel",
           "fused_dual_mlp_runs_tf32x3_kernel",
           "fused_dual_mlp_points_tf32x3_kernel",
           "winding_number_kernel", "winding_number_reduce_kernel",
           ) + K5_KERNELS
# the kernel sources, and the host library of the OBJ writer and reader
# (csrc/mesh_native.cpp, built with g++ beside them)
SOURCES = ("fused_dual_mlp", "fused_train_tf32", "fused_cols_mlp",
           "row_gather", "winding_number", "mesh_native")
# the bf16 K1/K3/K4 chain kernels, K2's 3xTF32 GEMM and the float32
# (3xTF32) K1/K3/K4 chain kernels, whose SASS must hold warpgroup MMAs
WGMMA_KERNELS = ("fused_dual_mlp_wgmma_kernel",
                 "fused_dual_mlp_train_tf32x3_gemm_kernel",
                 "fused_dual_mlp_cols_wgmma_kernel",
                 "fused_dual_mlp_runs_wgmma_kernel",
                 "fused_dual_mlp_cols_tf32x3_kernel",
                 "fused_dual_mlp_runs_tf32x3_kernel",
                 "fused_dual_mlp_points_tf32x3_kernel")


def ptxas_report(log: str):
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b}}
    from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((k for k in KERNELS if k in ln), None)
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            out[cur].update(spill_stores=int(st), spill_loads=int(ld))
        elif cur and "registers" in ln:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  ln).group(1))
    return out


def sass_hgmma(lib_path) -> dict:
    """{kernel: count of HGMMA instructions} in a built library's SASS,
    from cuobjdump; {} where the toolkit has no cuobjdump."""
    tool = next((c for c in ("/usr/local/cuda/bin/cuobjdump",
                             shutil.which("cuobjdump") or "")
                 if c and os.path.isfile(c)), None)
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = next((k for k in KERNELS if k in m.group(1)), None)
            if cur:
                out[cur] = 0
        elif cur and "HGMMA" in ln:
            out[cur] += 1
    return out


def phase_build():
    from surs_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    # a clean build from the checkout's sources, with its ptxas report
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    libs = cuda_build.build(SOURCES)
    ptxas, warnings, serialized = {}, [], []
    for _, log in cuda_build.BUILD_LOG.values():
        ptxas.update(ptxas_report(log))
        warnings += [ln.strip() for ln in log.splitlines()
                     if "warning" in ln.lower()]
        # ptxas' C7511: a kernel's wgmma waits for each other to finish
        serialized += [k for ln in log.splitlines() if "C7511" in ln
                       for k in KERNELS if k in ln]
    hgmma = {**sass_hgmma(libs["fused_dual_mlp"]),
             **sass_hgmma(libs["fused_train_tf32"]),
             **sass_hgmma(libs["fused_cols_mlp"])}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compile_seconds": {k: v[0]
                              for k, v in cuda_build.BUILD_LOG.items()},
          "ptxas": ptxas, "ptxas_warnings": warnings,
          "wgmma_serialized": serialized,
          "sass_hgmma": hgmma or "no cuobjdump"})
    missing = [k for k in KERNELS if k not in ptxas]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if any(k in spills for k in WGMMA_KERNELS + K5_KERNELS
           + ("cols_terms_bf16_kernel", "cols_terms_tf32x3_kernel",
              "winding_number_kernel")):
        raise AssertionError(f"a wgmma kernel, the pre-pass, K5 or the "
                             f"winding number spills: {spills}")
    if any(k in serialized for k in WGMMA_KERNELS):
        raise AssertionError(f"ptxas serialized the wgmma of {serialized}")
    if hgmma and not all(hgmma.get(k) for k in WGMMA_KERNELS):
        raise AssertionError(f"no HGMMA in a wgmma kernel: {hgmma}")


def kernel_mlps():
    """The reference-width MLP pair on the card, seeded, with
    larger-than-init weights so that the outputs spread over (0, 1)."""
    import torch
    from surs_tpu_torch.models.layers import init_weights
    from surs_tpu_torch.models.surface_classifier import SurfaceClassifier
    from surs_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    mlps = (SurfaceClassifier(fm.KERNEL_DIMS_LR),
            SurfaceClassifier(fm.KERNEL_DIMS_HR))
    for m in mlps:
        init_weights(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(3.0)
    return tuple(m.cuda() for m in mlps)


def k1_inputs(rng, n: int, one_part: bool):
    """K1's input at n points: the served (256, 65) split (part 2's last
    column the depth), or one [n, 321] part."""
    import torch
    x = torch.from_numpy(rng.standard_normal((n, 321)).astype(
        np.float32)).cuda()
    return [x] if one_part else [x[:, :256].contiguous(),
                                 x[:, 256:].contiguous()]


def k1_f32_times(fw, parts, rec) -> None:
    """The float32 K1 at N_MAIN: its pre-pass alone (the same features and
    depth, contiguous, through column_terms), its CUDA launches a call
    (torch.profiler), both bounds (3xTF32 at the TF32 peak, float32 FMA)
    and its rate of TF32 products."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    n = parts[0].shape[0]
    cw = fm.prepare_cols_weights(None, None, 256, torch.float32, fw=fw)
    x_lr, x_hr, kf = (t.contiguous() for t in fm._k1_split(parts))
    flops, nbytes = roofline.k1_tf32x3_work(n)
    ops = device_kernels(lambda: fm.fused_dual_mlp(parts, fw))
    rec.update(
        cols_terms_ms=time_cuda(lambda: fm.column_terms(x_lr, x_hr, kf, cw),
                                20),
        **cols_bounds(flops, nbytes, "float32",
                      roofline.k1_work(n, "float32")[0]),
        k1_kernel_launches_per_call=sum(ops.values()),
        scratch_bytes=fm.k1_scratch_bytes(n))
    rec["tf32_tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["cols_terms_share"] = rec["cols_terms_ms"] / rec["ms"]


def phase_k1():
    """K1 against its plain version at the serving shapes and around its
    tiles, in bf16 and float32 (both input forms), timed at N_MAIN."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    mlp_lr, mlp_hr = kernel_mlps()
    rng = np.random.default_rng(SEED)
    results = {}
    counts = (N_MAIN, N_MAIN - 1) + K1_RAGGED
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        fw = fm.prepare_fused_weights(mlp_lr, mlp_hr, dtype=dtype)
        forms = (False, True) if dtype_name == "float32" else (False,)
        for n in counts:
            for one_part in forms:
                parts = k1_inputs(rng, n, one_part)
                hr, lr = fm.fused_dual_mlp(parts, fw)
                torch.cuda.synchronize()
                ref_hr, ref_lr = fm.fused_dual_mlp_ref(parts, fw)
                ok = bool(torch.isfinite(hr).all()
                          and torch.isfinite(lr).all())
                err = max((hr - ref_hr).abs().max().item(),
                          (lr - ref_lr).abs().max().item())
                rec = {"phase": "k1", "dtype": dtype_name, "n": n,
                       "input": "one part" if one_part else "(256, 65)",
                       "max_abs_err": err, "tol": K1_TOL[dtype_name],
                       "pred_hr_range": [hr.min().item(), hr.max().item()]}
                if n == N_MAIN and not one_part:
                    rec.update(
                        ms=time_cuda(lambda: fm.fused_dual_mlp(parts, fw),
                                     20),
                        plain_ms=time_cuda(
                            lambda: fm.fused_dual_mlp_ref(parts, fw), 5))
                    flops, nbytes = roofline.k1_work(n, dtype_name)
                    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
                    if dtype_name == "float32":
                        k1_f32_times(fw, parts, rec)
                    else:
                        b_ms, b_by = roofline.bound(flops, nbytes, dtype_name)
                        rec.update(bound_ms=b_ms, bound_by=b_by,
                                   gflop=flops / 1e9)
                emit(rec)
                results[(dtype_name, n, one_part)] = rec
                if not ok or not err <= K1_TOL[dtype_name]:
                    raise AssertionError(f"K1 disagrees with its plain "
                                         f"version: {rec}")
    return results


def k2_layers(rng):
    """K2's GEMM kernel alone (``tf32x3_linear``) at each layer's shape,
    12,000 rows (94 tiles of 128), against its plain version on the same
    split operands; ms per layer, 20 launches enqueued back to back."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm

    rows = -(-N_TRAIN // 128) * 128
    recs = []
    for i, (n_out, k) in enumerate(fm.K2_LAYERS):
        a = torch.from_numpy(rng.standard_normal((rows, k)).astype(
            np.float32)).cuda()
        w = torch.from_numpy((rng.standard_normal((n_out, k)) / np.sqrt(k))
                             .astype(np.float32)).cuda()
        b = torch.from_numpy((0.1 * rng.standard_normal(n_out)).astype(
            np.float32)).cuda()
        # layers 2 and 3 read [h | x]: two operands, as in K2
        kh = k - fm.K2_XK if i >= 2 else k
        a1 = fm.split_tiles(a[:, :kh])
        a2 = fm.split_tiles(a[:, kh:]) if kh < k else None
        wt = fm.split_tiles(w)
        out = fm.tf32x3_linear(a1, a2, wt, b, rows)
        torch.cuda.synchronize()
        hi, lo = fm.unsplit_tiles(out, rows, n_out)
        sa, sw = fm.tf32_split(a), fm.tf32_split(w)
        want = fm.tf32x3_linear_ref(*sa, *sw, b)
        err = ((hi + lo - want).abs().max() / want.abs().max()).item()
        rec = {"phase": "k2_layer", "layer": i, "rows": rows, "k": k,
               "n": n_out, "max_rel_err": err, "tol": K2_LAYER_TOL,
               "ms": time_cuda_batch(lambda: fm.tf32x3_linear(
                   a1, a2, wt, b, rows)),
               "plain_ms": time_cuda_batch(lambda: fm.tf32x3_linear_ref(
                   *sa, *sw, b))}
        rec["tf32_tflops"] = 3 * 2.0 * rows * k * n_out / (
            rec["ms"] * 1e-3) / 1e12
        emit(rec)
        recs.append(rec)
        if not (bool(torch.isfinite(hi).all()) and err <= K2_LAYER_TOL):
            raise AssertionError(f"K2's GEMM disagrees with its plain "
                                 f"version: {rec}")
    return recs


def device_kernels(fn) -> dict:
    """{name: launches} of the device operations ``fn`` runs, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not ev.is_user_annotation}


def phase_k2():
    """K2 (float32 weights, 3xTF32) against its plain version at the
    training shapes, after its GEMM alone at each layer's shape."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    fw = fm.prepare_fused_weights(*kernel_mlps(), dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    out = {"layers": k2_layers(rng)}
    # the pack kernel alone: bit for bit its plain version (integer split)
    wt = fm.pack_k2(fw)
    torch.cuda.synchronize()
    out["pack"] = {"phase": "k2_pack",
                   "equal": bool(torch.equal(wt, fm.pack_k2_ref(fw))),
                   "ms": time_cuda(lambda: fm.pack_k2(fw), 20),
                   "plain_ms": time_cuda(lambda: fm.pack_k2_ref(fw), 5)}
    emit(out["pack"])
    if not out["pack"]["equal"]:
        raise AssertionError("K2's pack kernel disagrees with pack_k2_ref")
    for n in (N_TRAIN, N_TRAIN - 1) + K2_RAGGED:
        xa, xb = (torch.from_numpy(rng.standard_normal((n, 321)).astype(
            np.float32)).cuda() for _ in range(2))
        mask = (rng.random(n) > 0.3).astype(np.float32)
        mask[0] = 0.0                    # a masked point at every n
        mask = torch.from_numpy(mask).cuda()
        hr, lr = fm.fused_dual_mlp_train(xa, xb, mask, fw)
        torch.cuda.synchronize()
        ref_hr, ref_lr = fm.fused_dual_mlp_train_ref(xa, xb, mask, fw)
        ok = bool(torch.isfinite(hr).all() and torch.isfinite(lr).all())
        err = max((hr - ref_hr).abs().max().item(),
                  (lr - ref_lr).abs().max().item())
        rec = {"phase": "k2", "dtype": "float32", "n": n,
               "mask_zeros": int((mask == 0).sum().item()),
               "max_abs_err": err, "tol": K2_TOL,
               "pred_hr_range": [hr.min().item(), hr.max().item()],
               "pred_lr_range": [lr.min().item(), lr.max().item()]}
        if n == N_TRAIN:
            flops, nbytes = roofline.k2_tf32x3_work(n)
            b_ms, b_by = roofline.bound(flops, nbytes, "tf32")
            fma_ms, _ = roofline.bound(*roofline.k2_work(n), "float32")
            ops = device_kernels(lambda: fm.fused_dual_mlp_train(
                xa, xb, mask, fw))
            rec.update(
                ms=time_cuda(lambda: fm.fused_dual_mlp_train(xa, xb, mask,
                                                             fw), 20),
                plain_ms=time_cuda(lambda: fm.fused_dual_mlp_train_ref(
                    xa, xb, mask, fw), 20),
                bound_ms=b_ms, bound_by=b_by, bound_fma_ms=fma_ms,
                tf32_gflop=flops / 1e9, library_ms=None,
                k2_kernel_launches_per_call=sum(
                    c for k, c in ops.items() if "fused_dual_mlp_train" in k),
                device_ops_per_call=sum(ops.values()))
            rec["float32_tflops"] = flops / 3 / (rec["ms"] * 1e-3) / 1e12
        emit(rec)
        out[n] = rec
        if not ok or not err <= K2_TOL or rec["mask_zeros"] == 0:
            raise AssertionError(f"K2 disagrees with its plain version: "
                                 f"{rec}")
    return out


def grid_depths(R: int = DENSE_R):
    """The depth features zf [R] of the eval calibration's R^3 grid over
    the +-0.5 box at full width (loadSize 512, z_size 200), computed on
    the card as the column evaluators compute them."""
    import torch
    from surs_tpu_torch.ops.geometry import normalize_depth, orthogonal
    from surs_tpu_torch.recon.grid import flat_index_to_world, grid_matrix
    from surs_tpu_torch.recon.pipeline import eval_calibration

    mat = grid_matrix((R,) * 3, [-0.5] * 3, [0.5] * 3)
    pts = flat_index_to_world(torch.arange(R).cuda(), R, 1, mat)
    calib = torch.from_numpy(eval_calibration(1)).cuda()
    return normalize_depth(orthogonal(pts[None], calib)[0, 2, :], 512,
                           200.0).contiguous()


def seeded_features(rng, n: int):
    import torch
    return tuple(torch.from_numpy(rng.standard_normal((n, c)).astype(
        np.float32)).cuda() for c in (256, 64))


def check_cols_kernel(phase, kernel, plain, args, dtype_name, shape):
    """One launch of a column kernel against its plain version."""
    import torch
    hr, lr = kernel(*args)
    torch.cuda.synchronize()
    ref_hr, ref_lr = plain(*args)
    ok = bool(torch.isfinite(hr).all() and torch.isfinite(lr).all()
              and tuple(hr.shape) == shape)
    err = max((hr - ref_hr).abs().max().item(),
              (lr - ref_lr).abs().max().item())
    rec = {"phase": phase, "dtype": dtype_name, "shape": list(shape),
           "max_abs_err": err, "tol": COLS_TOL[dtype_name],
           "pred_hr_range": [hr.min().item(), hr.max().item()]}
    if not ok or not err <= COLS_TOL[dtype_name]:
        emit(rec)
        raise AssertionError(f"{phase} disagrees with its plain version: "
                             f"{rec}")
    return rec


def cols_weights(mlp_lr, mlp_hr, dtype):
    from surs_tpu_torch.ops import fused_mlp as fm
    return fm.prepare_cols_weights(mlp_lr, mlp_hr, 256, dtype=dtype)


def check_terms(phase, cw, x_lr, x_hr, kf):
    """The column-term pre-pass (bf16 or 3xTF32, by the packing) against
    its plain version."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm
    got = fm.column_terms(x_lr, x_hr, kf, cw)
    torch.cuda.synchronize()
    want = fm.column_terms_ref(x_lr, x_hr, kf, cw)
    err = (got - want).abs().max().item() / want.abs().max().item()
    rec = {"phase": phase, "n": x_lr.shape[0], "kf": kf is not None,
           "max_rel_err": err, "tol": TERMS_TOL}
    if not (bool(torch.isfinite(got).all()) and err <= TERMS_TOL):
        emit(rec)
        raise AssertionError(f"the column-term pre-pass disagrees: {rec}")
    return rec


def cols_bounds(flops: float, nbytes: float, dtype_name: str,
                fma_flops: float = 0.0) -> dict:
    """A column kernel's bound in its dtype's arithmetic (float32:
    3xTF32 at the TF32 peak), and in float32 its FMA bound beside it."""
    from surs_tpu_torch import roofline
    peak = "tf32" if dtype_name == "float32" else dtype_name
    b_ms, b_by = roofline.bound(flops, nbytes, peak)
    out = {"bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9}
    if dtype_name == "float32":
        out["bound_fma_ms"] = roofline.bound(fma_flops, nbytes,
                                             "float32")[0]
    return out


def k3_grid(rng, zf, cw, dtype_name: str, plain: bool):
    """K3 on the whole dense grid (the shape the dense path gives it),
    its pre-pass alone and (``plain``) its plain version timed; the
    output held to the plain version at sampled columns, every chunk's
    offsets exercised."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    ncol = DENSE_R * DENSE_R
    x_lr, x_hr = seeded_features(rng, ncol)
    args = (x_lr, x_hr, zf, cw)
    terms = check_terms(f"k3_terms_{dtype_name}", cw, x_lr[:SLICE_COLS],
                        x_hr[:SLICE_COLS], None)
    fma_flops, nbytes = roofline.k3_work(ncol, DENSE_R, dtype_name)
    flops = (roofline.k3_tf32x3_work(ncol, DENSE_R)[0]
             if dtype_name == "float32" else fma_flops)
    grid = {"phase": "k3_grid", "dtype": dtype_name,
            "shape": [ncol, DENSE_R],
            "ms": time_cuda(lambda: fm.fused_dual_mlp_cols(*args),
                            3 if plain else 2, warm=1),
            "cols_terms_ms": time_cuda(
                lambda: fm.column_terms(x_lr, x_hr, None, cw), 3),
            "cols_terms_rel_err": terms["max_rel_err"],
            **cols_bounds(flops, nbytes, dtype_name, fma_flops),
            "library_ms": None}
    if plain:
        grid["plain_ms"] = time_cuda(
            lambda: fm.fused_dual_mlp_cols_ref(*args), 1, warm=0)
    grid["tflops"] = flops / (grid["ms"] * 1e-3) / 1e12
    hr, lr = fm.fused_dual_mlp_cols(*args)
    torch.cuda.synchronize()
    cols = torch.from_numpy(np.sort(rng.choice(ncol, GRID_SAMPLE_COLS,
                                               replace=False))).cuda()
    ref_hr, ref_lr = fm.fused_dual_mlp_cols_ref(x_lr[cols], x_hr[cols], zf,
                                                cw)
    grid["sampled_cols"] = GRID_SAMPLE_COLS
    grid["sampled_max_abs_err"] = max(
        (hr[cols] - ref_hr).abs().max().item(),
        (lr[cols] - ref_lr).abs().max().item())
    grid["tol"] = COLS_TOL[dtype_name]
    emit(grid)
    del hr, lr
    if not (bool(torch.isfinite(ref_hr).all())
            and grid["sampled_max_abs_err"] <= COLS_TOL[dtype_name]):
        raise AssertionError(f"K3's whole grid disagrees: {grid}")
    return grid


def phase_k3():
    """K3 against its plain version on a slice of the dense grid and at
    ragged shapes (two chunks, the second ragged), in bf16 and float32;
    K3 and its pre-pass timed on the whole grid in both, with the plain
    version in bf16 (in float32 at the slice), the whole grid's output
    held to the plain version at sampled columns."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    mlp_lr, mlp_hr = kernel_mlps()
    rng = np.random.default_rng(SEED + 2)
    zf = grid_depths()
    recs, grids = [], {}
    shapes = ((SLICE_COLS, DENSE_R), (SLICE_COLS - 1, 500),
              (K3_RAGGED_COLS, 500))
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        cw = cols_weights(mlp_lr, mlp_hr, dtype)
        for ncol, z in shapes:
            args = (*seeded_features(rng, ncol), zf[:z].contiguous(), cw)
            rec = check_cols_kernel("k3", fm.fused_dual_mlp_cols,
                                    fm.fused_dual_mlp_cols_ref, args,
                                    dtype_name, (ncol, z))
            if ncol == SLICE_COLS:
                fma_flops, nbytes = roofline.k3_work(ncol, z, dtype_name)
                flops = (roofline.k3_tf32x3_work(ncol, z)[0]
                         if dtype_name == "float32" else fma_flops)
                rec.update(
                    ms_slice=time_cuda(lambda: fm.fused_dual_mlp_cols(*args),
                                       5),
                    plain_ms_slice=time_cuda(
                        lambda: fm.fused_dual_mlp_cols_ref(*args), 3),
                    **{f"{k}_slice": v for k, v in cols_bounds(
                        flops, nbytes, dtype_name, fma_flops).items()})
            emit(rec)
            recs.append(rec)
        grids[dtype_name] = k3_grid(rng, zf, cw, dtype_name,
                                    plain=dtype_name == "bfloat16")
        recs.append({"dtype": dtype_name,
                     "max_abs_err": grids[dtype_name]["sampled_max_abs_err"]})
        del cw
        torch.cuda.empty_cache()
    return {"checks": recs, "grid": grids["bfloat16"],
            "grid_f32": grids["float32"],
            "slice_f32": next(r for r in recs if r.get("dtype") == "float32"
                              and r.get("shape") == [SLICE_COLS, DENSE_R])}


def phase_k4():
    """K4 against its plain version at one chunk of the runs evaluator,
    in bf16 and float32, with the depth offsets of the 512 level, and at
    ragged window counts; K4 and its pre-pass timed at one chunk."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import fused_mlp as fm

    mlp_lr, mlp_hr = kernel_mlps()
    rng = np.random.default_rng(SEED + 3)
    zf = grid_depths()
    zt = zf[:ZB].contiguous()
    kf_all = zf - zf[0]
    recs, main = [], {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        cw = cols_weights(mlp_lr, mlp_hr, dtype)
        for nr in (NWIN, NWIN - 1, 17):
            k0 = torch.from_numpy(rng.integers(0, DENSE_R // ZB, nr) * ZB)
            kf = kf_all[k0.cuda()].contiguous()
            x_lr, x_hr = seeded_features(rng, nr)
            args = (x_lr, x_hr, kf, zt, cw)
            rec = check_cols_kernel("k4", fm.fused_dual_mlp_runs,
                                    fm.fused_dual_mlp_runs_ref, args,
                                    dtype_name, (nr, ZB))
            if nr == NWIN:
                fma_flops, nbytes = roofline.k4_work(nr, ZB, dtype_name)
                flops = (roofline.k4_tf32x3_work(nr, ZB)[0]
                         if dtype_name == "float32" else fma_flops)
                rec.update(
                    ms=time_cuda(lambda: fm.fused_dual_mlp_runs(*args), 20),
                    plain_ms=time_cuda(
                        lambda: fm.fused_dual_mlp_runs_ref(*args), 5),
                    **cols_bounds(flops, nbytes, dtype_name, fma_flops),
                    library_ms=None)
                rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
                terms = check_terms(f"k4_terms_{dtype_name}", cw, x_lr, x_hr,
                                    kf)
                rec.update(
                    cols_terms_ms=time_cuda(
                        lambda: fm.column_terms(x_lr, x_hr, kf, cw), 20),
                    cols_terms_rel_err=terms["max_rel_err"])
                main[dtype_name] = rec
            emit(rec)
            recs.append(rec)
    return {"checks": recs, "main": main["bfloat16"],
            "main_f32": main["float32"]}


def check_gather(feat, idx, want, grids=(None,)):
    """Both K5 variants against ``want``, bit for bit: on the default
    launch (None) and on each of ``grids`` blocks."""
    import dataclasses

    import torch
    from surs_tpu_torch.ops import row_gather as rg

    int_view = torch.int16 if feat.element_size() == 2 else torch.int32
    rec = {"phase": "k5", "dtype": str(feat.dtype).replace("torch.", ""),
           "rows": feat.shape[0], "channels": feat.shape[1],
           "n": idx.shape[0]}
    ok = True
    for variant in rg.VARIANTS:
        for grid in grids:
            plan, key = None, variant
            if grid is not None:
                plan = dataclasses.replace(
                    rg.device_plan(feat, idx.shape[0], variant), grid=grid)
                key = f"{variant}_grid{grid}"
            out = rg.row_gather(feat, idx, variant, plan)
            torch.cuda.synchronize()
            same = (out.shape == want.shape and out.dtype == want.dtype
                    and torch.equal(out.view(int_view), want.view(int_view)))
            rec[f"{key}_equal"] = bool(same)
            rec[f"{key}_max_abs_err"] = (
                (out.float() - want.float()).abs().max().item() if same
                else float("inf"))
            ok = ok and same
    emit(rec)
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {rec}")
    return rec


def phase_k5(subjects, device: str = "cuda"):
    """K5 against its plain version, exactly; its cold, clean-cold and
    warm times beside torch.index_select's and the bound; the gather
    probe as K5's main path; one tap of the serving gather."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.ops import row_gather as rg
    from surs_tpu_torch.probes import k5_times
    from surs_tpu_torch.probes import vmem_gather_probe as probe
    from surs_tpu_torch.serve import SuRSService, normalize_image

    rows = probe.H * probe.W
    rng = np.random.default_rng(SEED + 4)
    # the edges of loop's tile and of vec's 32-row batch at the probe's rows
    tile = rg.loop_tile(probe.C * 2)[0]
    checks = []
    # the probe's shape, a ragged count, a tile and less, the hr map's
    # rows; then rows of 25 vectors (batches that straddle rows) and of
    # 8 KB (a tile of 2 rows in loop, 16 rounds a lane in vec)
    for n, c, dtype in ((probe.N, probe.C, torch.bfloat16),
                        (probe.N - 1, probe.C, torch.bfloat16),
                        (1, probe.C, torch.bfloat16),
                        (tile - 1, probe.C, torch.bfloat16),
                        (tile + 1, probe.C, torch.bfloat16),
                        (probe.N, K5_HR_CHANNELS, torch.bfloat16),
                        (probe.N, K5_HR_CHANNELS, torch.float32),
                        (4099, 200, torch.bfloat16),
                        (4099, 2048, torch.float32)):
        feat = torch.from_numpy(rng.standard_normal((rows, c)).astype(
            np.float32)).to(dtype).to(device)
        idx = torch.from_numpy(rng.integers(0, rows, n).astype(
            np.int32)).to(device)
        checks.append(check_gather(feat, idx, rg.row_gather_ref(feat, idx)))
    # indices outside [0, rows) give rows of zeros: a few among rows in
    # range (the last map's 8 KB float32 rows); in the probe's map a tile
    # of them alone, and at the probe's count the second and the last
    # tile (and vec batch) of them, also on 1 and 3 blocks (hundreds of
    # tiles or batches a block: the loop ring's phases wrap)
    outside = np.array([-1, rows, -2 ** 31, 2 ** 31 - 1, rows + 7, -rows])
    mixed = rng.integers(0, rows, probe.N)
    mixed[tile:2 * tile] = np.resize(outside, tile)
    mixed[-tile:] = np.resize(outside, tile)
    feat_probe, idx_probe = probe.probe_inputs(device)
    for f, case, grids in ((feat, [0, -1, rows, rows - 1, -2 ** 31,
                                   2 ** 31 - 1], (None,)),
                           (feat_probe, np.resize(outside, tile), (None,)),
                           (feat_probe, mixed, (None, 1, 3))):
        idx = torch.from_numpy(np.asarray(case).astype(np.int32)).to(device)
        inside = ((idx >= 0) & (idx < rows))[:, None]
        rows_at = f[idx.clamp(0, rows - 1).long()]
        checks.append(check_gather(f, idx, torch.where(
            inside, rows_at, torch.zeros_like(rows_at)), grids))

    # per launch at the probe's shape: L2 cold (the bound's case), cold
    # with clean lines in L2, and warm
    feat, idx = feat_probe, idx_probe
    fns = {"vec": lambda: rg.row_gather(feat, idx, "vec"),
           "loop": lambda: rg.row_gather(feat, idx, "loop"),
           "index_select": lambda: torch.index_select(feat, 0, idx),
           "plain": lambda: rg.row_gather_ref(feat, idx)}
    flops, nbytes = roofline.k5_work(rows, probe.N, probe.C)
    b_ms, b_by = roofline.bound(flops, nbytes, "bfloat16")
    timing = {"phase": "k5_time", "rows": rows, "channels": probe.C,
              "n": probe.N, "dtype": "bfloat16",
              "plans": {v: vars(rg.device_plan(feat, probe.N, v))
                        for v in rg.VARIANTS},
              **k5_times.measure(fns),
              "bound_ms": b_ms, "bound_by": b_by, "mbytes": nbytes / 1e6}
    emit(timing)

    # the probe: K5's main path
    torch.cuda.synchronize()
    rg.row_gather.launches = 0           # main path starts here
    recs = probe.main(device)
    torch.cuda.synchronize()
    launches = rg.row_gather.launches    # main path ends here
    emit({"phase": "k5_probe", "k5_launches": launches,
          "correct": [r["correct"] for r in recs]})
    if launches <= 0 or not all(r["correct"] for r in recs):
        raise AssertionError(f"the gather probe failed: {recs}")

    # one tap of the serving gather: the lr map as the served query
    # samples it (grid_sample_points: flat[bidx, idx])
    service = SuRSService(full_width_config(), device=device)
    arr, _ = normalize_image(*subjects[0])
    _, feats_lr, _ = service.rec.encode(arr)
    lr = feats_lr[-1].to(service.rec.feature_dtype)
    B, Hm, Wm, Cm = lr.shape
    flat = lr.reshape(B * Hm * Wm, Cm).contiguous()
    flat3 = flat.view(B, Hm * Wm, Cm)
    tidx = torch.from_numpy(rng.integers(0, Hm * Wm, N_MAIN).astype(
        np.int32)).to(device)
    idx64, bidx = tidx.long()[None], torch.arange(B, device=device)[:, None]
    got, want = rg.row_gather(flat, tidx, "vec"), flat3[bidx, idx64][0]
    tap = {"phase": "k5_serve_tap", "map_shape": list(lr.shape),
           "dtype": str(flat.dtype).replace("torch.", ""), "n": N_MAIN,
           "equal": bool(torch.equal(got, want)),
           "warm_ms": {
               "vec": k5_times.time_warm(
                   lambda: rg.row_gather(flat, tidx, "vec")),
               "loop": k5_times.time_warm(
                   lambda: rg.row_gather(flat, tidx, "loop")),
               "index_select": k5_times.time_warm(
                   lambda: torch.index_select(flat, 0, tidx)),
               "serving_index": k5_times.time_warm(
                   lambda: flat3[bidx, idx64])}}
    emit(tap)
    del service, feats_lr, lr, flat, flat3
    torch.cuda.empty_cache()
    if not tap["equal"]:
        raise AssertionError(f"K5 disagrees at the serving tap: {tap}")
    return {"checks": checks, "timing": timing, "launches": launches}


def synthetic_subject(i: int, S: int = 256):
    rng = np.random.default_rng(SEED + i)
    img = (rng.random((S, S, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:S, :S]
    cx, cy = S / 2 + 6 * i, S / 2 - 4 * i
    ax, ay = S * (0.22 + 0.02 * i), S * 0.40
    mask = ((((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2) < 1
            ).astype(np.uint8) * 255
    return img, mask


def full_width_config(**kw):
    from surs_tpu_torch.config import SuRSConfig
    base = dict(loadSize=512, hg_dim=256, num_stack_lr=3, resolution=512,
                mask_prune=True, b_min=[-0.5, -0.5, -0.5],
                b_max=[0.5, 0.5, 0.5], seed=SEED)
    return SuRSConfig(**{**base, **kw})


def cli_args(cfg) -> list:
    """The command-line flags that give ``cfg``'s model and grid."""
    return ["--loadSize", str(cfg.loadSize), "--hg_dim", str(cfg.hg_dim),
            "--num_stack_lr", str(cfg.num_stack_lr),
            "--resolution", str(cfg.resolution),
            "--octree_init_resolution", str(cfg.octree_init_resolution),
            "--num_samples", str(cfg.num_samples),
            "--b_min", *map(str, cfg.b_min), "--b_max", *map(str, cfg.b_max),
            "--seed", str(cfg.seed)] + (["--residual"] if cfg.residual
                                        else [])


def clear_objs(out_dir: str) -> None:
    """Drop the phase's OBJ files (hundreds of MB at 512^3)."""
    for f in os.listdir(out_dir):
        if f.endswith(".obj"):
            os.remove(os.path.join(out_dir, f))


def phase_serve(out_dir: str):
    import torch
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.serve import SuRSService

    t0 = time.perf_counter()
    service = SuRSService(full_width_config())
    warm = service.warmup((256, 256))
    emit({"phase": "serve_setup", "build_seconds": time.perf_counter() - t0,
          "warmup_seconds": warm, "dtype": service.cfg.dtype,
          "feature_dtype": service.cfg.feature_dtype})
    subjects = [synthetic_subject(i) for i in range(3)]
    torch.cuda.synchronize()
    fused_dual_mlp.launches = 0          # main path starts here
    per = []
    for i, (img, mask) in enumerate(subjects):
        stats = {}
        t1 = time.perf_counter()
        p_hr, p_lr = service.reconstruct(img, mask, f"subject{i}", out_dir,
                                         stats=stats)
        per.append({"seconds": time.perf_counter() - t1,
                    "queries": stats["queries"],
                    "write_s": stats["write_s"],
                    "faces_hr": stats["faces"][0],
                    "faces_lr": stats["faces"][1],
                    "obj_bytes": [os.path.getsize(p_hr),
                                  os.path.getsize(p_lr)]})
    torch.cuda.synchronize()
    launches = fused_dual_mlp.launches   # main path ends here
    rec = {"phase": "serve", "resolution": service.cfg.resolution,
           "requests": per, "k1_launches": launches,
           "seconds_per_request": float(np.mean([r["seconds"]
                                                 for r in per]))}
    emit(rec)
    for i, r in enumerate(per):
        for suffix in ("_HR.obj", "_LR.obj"):
            if not os.path.isfile(os.path.join(out_dir,
                                               f"subject{i}{suffix}")):
                raise AssertionError(f"subject{i}{suffix} not written")
        if r["faces_lr"] <= 0:
            raise AssertionError(f"subject{i}: empty LR mesh")
    if launches <= 0:
        raise AssertionError("the main path never launched K1")
    return service, subjects, rec


def phase_check(service, subjects):
    import torch
    from surs_tpu_torch.ops.point_query import fused_query
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import SuRSService, normalize_image

    rec = {"phase": "check"}
    # (a) served query (K1, bf16) vs the model's float32 reference chain
    img, mask = subjects[0]
    arr, _ = normalize_image(img, mask)
    _, feats_lr, feat_hr = service.rec.encode(arr)
    f_lr = feats_lr[-1].to(torch.bfloat16)
    f_hr = feat_hr.to(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 3, N_MAIN)).astype(
        np.float32)).cuda()
    calib = torch.from_numpy(eval_calibration(1)).cuda()
    with torch.inference_mode():
        got = fused_query(service.weights, f_lr, f_hr, pts, calib,
                          service.cfg.loadSize, service.cfg.z_size)
        want = service.model.query([f_lr], f_hr, pts, calib)
    rec["query_vs_f32_chain"] = max((g - w).abs().max().item()
                                    for g, w in zip(got, want))
    rec["query_tol"] = SERVE_TOL
    # (b) a full-resolution field: shape, finite, in [0, 1]
    sdf_hr, sdf_lr = service.fields(img, mask)
    rng_ok = all(bool(torch.isfinite(s).all()) and s.min().item() >= 0.0
                 and s.max().item() <= 1.0 for s in (sdf_hr, sdf_lr))
    rec["field_shape"] = list(sdf_hr.shape)
    rec["field_lr_range"] = [sdf_lr.min().item(), sdf_lr.max().item()]
    del sdf_hr, sdf_lr
    # (c) a small float32 service on the card vs the same on the CPU
    small = dict(loadSize=32, num_stack_lr=1, resolution=32,
                 octree_init_resolution=8, num_samples=4096,
                 b_min=[-0.5] * 3, b_max=[0.5] * 3, dtype="float32",
                 feature_dtype="float32", seed=SEED)
    from surs_tpu_torch.config import SuRSConfig
    s_img, s_mask = synthetic_subject(0, S=16)
    on_card = SuRSService(SuRSConfig(**small)).fields(s_img, s_mask)
    on_cpu = SuRSService(SuRSConfig(**small), device="cpu").fields(
        s_img, s_mask)
    rec["f32_service_card_vs_cpu"] = max(
        (a.cpu() - b).abs().max().item() for a, b in zip(on_card, on_cpu))
    rec["f32_service_tol"] = F32_SERVICE_TOL
    emit(rec)
    if not (rec["query_vs_f32_chain"] <= SERVE_TOL and rng_ok
            and rec["field_shape"] == [service.cfg.resolution] * 3
            and rec["f32_service_card_vs_cpu"] <= F32_SERVICE_TOL):
        raise AssertionError(f"check failed: {rec}")


def phase_stages(service, subjects, out_dir: str, phase: str = "stages"):
    """One subject's wall time by stage, each ending in a synchronize."""
    import torch
    from surs_tpu_torch.recon.mesh_io import save_obj_mesh
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import normalize_image

    img, mask = subjects[1]
    arr, m = normalize_image(img, mask)
    cfg = service.cfg
    t = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    _, feats_lr, feat_hr = service.rec.encode(arr)
    mark()
    stats = {}
    sdf_hr, sdf_lr, mat = service.rec.evaluate(
        feats_lr, feat_hr, eval_calibration(1), cfg.resolution, cfg.b_min,
        cfg.b_max, use_octree=cfg.use_octree, num_samples=cfg.num_samples,
        threshold=cfg.threshold, init_resolution=cfg.octree_init_resolution,
        silhouette=m, stats=stats)
    mark()
    meshes = list(service.rec.extract_pair(
        sdf_hr, sdf_lr, mat, mc_backend="device",
        mc_caps={"algorithm": "cubes"}))
    mark()
    for name, (v, f) in zip(("HR", "LR"), meshes):
        save_obj_mesh(os.path.join(out_dir, f"{phase}_{name}.obj"), v, f)
    mark()
    d = np.diff(t)
    rec = {"phase": phase, "mode": stats["mode"], "encode_s": d[0],
           "evaluate_s": d[1], "extract_s": d[2], "write_s": d[3],
           "queries": stats["queries"], "faces": [len(f) for _, f in meshes]}
    emit(rec)
    return rec


def phase_native_io(service, subjects, out_dir: str):
    """The host OBJ library on the serve phase's HR mesh (subject 0):
    its build seconds, the native write against the plain numpy writer
    (the same bytes; both timed), and the native read back (timed), equal
    to the vertices rounded to 4 decimals and the written winding."""
    from surs_tpu_torch.ops import cuda_build
    from surs_tpu_torch.recon.grid import grid_matrix
    from surs_tpu_torch.recon.mesh_io import (load_obj, save_obj_mesh,
                                              save_obj_mesh_ref)

    sdf_hr, sdf_lr = service.fields(*subjects[0])
    cfg = service.cfg
    mat = grid_matrix((cfg.resolution,) * 3, cfg.b_min, cfg.b_max)
    verts, faces = next(service.rec.extract_pair(
        sdf_hr, sdf_lr, mat, mc_backend="device",
        mc_caps={"algorithm": "cubes"}))
    del sdf_hr, sdf_lr
    paths = [os.path.join(out_dir, f"native_io_{k}.obj")
             for k in ("native", "ref")]
    t0 = time.perf_counter()
    save_obj_mesh(paths[0], verts, faces)
    t1 = time.perf_counter()
    save_obj_mesh_ref(paths[1], verts, faces)
    t2 = time.perf_counter()
    with open(paths[0], "rb") as f:
        native = f.read()
    with open(paths[1], "rb") as f:
        same = native == f.read()
    t3 = time.perf_counter()
    got_v, got_f = load_obj(paths[0])
    read_s = time.perf_counter() - t3
    v = verts.astype(np.float64)
    want_v = (np.where(v < 0, -1, 1) * np.floor(np.abs(v) * 1e4 + 0.5)
              / 1e4).astype(np.float32)
    round_trip = (got_v.shape == want_v.shape and got_f.shape == faces.shape
                  and bool((got_v == want_v).all())
                  and bool((got_f == faces[:, [0, 2, 1]]).all()))
    rec = {"phase": "native_io",
           "build_s": cuda_build.BUILD_LOG["mesh_native"][0],
           "verts": len(verts), "faces": len(faces), "bytes": len(native),
           "native_write_s": t1 - t0, "ref_write_s": t2 - t1,
           "native_read_s": read_s, "bytes_equal": same,
           "round_trip_4_decimals": round_trip}
    emit(rec)
    for p in paths:
        os.remove(p)
    if not (same and round_trip and len(faces) > 0):
        raise AssertionError(f"native_io failed: {rec}")
    return rec


def mesh_set(verts, faces, device: str = "cuda"):
    """A mesh as sets (tests/test_tetra_device.py's canon_faces,
    vectorized, sorted on ``device``): the sorted vertex keys (grid
    coordinates quantised to 1/4096, packed 21 bits an axis) and the
    faces as key triples in their lexicographically least cyclic
    rotation (winding kept; canon_faces' rotation to the smallest key,
    with ties between equal keys broken the same way in both meshes), in
    lexicographic order."""
    import torch
    q = np.rint(np.asarray(verts, np.float64) * 4096.0).astype(np.int64)
    if q.size and not (q.min() >= 0 and q.max() < 1 << 21):
        raise AssertionError("mesh_set: grid coordinates out of range")
    key = torch.from_numpy((q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
                           ).to(device)
    fk = key[torch.from_numpy(np.asarray(faces, np.int64)).to(device)]

    def less(a, b):
        return ((a[:, 0] < b[:, 0]) | ((a[:, 0] == b[:, 0])
                & ((a[:, 1] < b[:, 1]) | ((a[:, 1] == b[:, 1])
                                          & (a[:, 2] < b[:, 2])))))

    best = fk
    for shift in (1, 2):
        rot = torch.roll(fk, -shift, dims=1)
        best = torch.where(less(rot, best)[:, None], rot, best)
    fk = best
    for col in (2, 1, 0):             # stable sorts: lexicographic order
        fk = fk[torch.sort(fk[:, col], stable=True).indices]
    return torch.sort(key).values, fk


def same_mesh(va, fa, vb, fb, device: str = "cuda") -> bool:
    """The same quantised vertex set and winding-preserving face set."""
    import torch
    if va.shape != vb.shape or fa.shape != fb.shape:
        return False
    (ka, fka), (kb, fkb) = (mesh_set(va, fa, device),
                            mesh_set(vb, fb, device))
    return bool(torch.equal(ka, kb) and torch.equal(fka, fkb))


def compare_extractors(fields, level: float = 0.5) -> dict:
    """Each field ({tag: [X, Y, Z] on the card}) meshed three ways:
    marching cubes and marching tetrahedra on the card (synchronised
    seconds, faces, vertices; the tets' peak memory above what was
    allocated before), and the host library's marching tetrahedra after
    a copy to the host (the copy's and the extraction's seconds). The
    card's tets must equal the host's as sets (compared on the card)."""
    import torch
    from surs_tpu_torch.recon.marching import (extract_isosurface,
                                               marching_cubes)
    from surs_tpu_torch.recon.tetra import marching_tetrahedra

    out = {}
    for tag, sdf in fields.items():
        rec = {}
        for algo, fn in (("cubes", marching_cubes),
                         ("tets", marching_tetrahedra)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            v, f = fn(sdf, level)
            torch.cuda.synchronize()
            rec[f"device_{algo}"] = {
                "s": time.perf_counter() - t0, "faces": int(f.shape[0]),
                "verts": int(v.shape[0]),
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        dev_v, dev_f = v.cpu().numpy(), f.cpu().numpy()
        del v, f
        t0 = time.perf_counter()
        host = sdf.float().cpu().numpy()
        t1 = time.perf_counter()
        hv, hf = extract_isosurface(host, level, "native")
        rec["host_tets"] = {"s": time.perf_counter() - t1, "copy_s": t1 - t0,
                            "faces": int(hf.shape[0]),
                            "verts": int(hv.shape[0])}
        t0 = time.perf_counter()
        rec["card_equals_host"] = same_mesh(dev_v, dev_f, hv, hf,
                                            sdf.device)
        rec["compare_s"] = time.perf_counter() - t0
        if not (rec["card_equals_host"] and hf.shape[0] > 0):
            raise AssertionError(f"card tets != host tets ({tag}): {rec}")
        out[tag] = rec
    torch.cuda.empty_cache()
    return out


def phase_tets(service, subjects, out_dir: str):
    """Marching tetrahedra on the eval path: the serve phase's subject-0
    fields at 512^3 meshed by the card's cubes and tets and the host's
    tets (compare_extractors); a 128^3 field's card tets against the
    same function on the CPU, array for array; then one served request
    through mc_algorithm='tets' and one through mc_backend='host', each
    a service of its own (the serve phase's weights: the same seed)."""
    import torch
    from surs_tpu_torch.recon.tetra import marching_tetrahedra
    from surs_tpu_torch.serve import SuRSService

    sdf_hr, sdf_lr = service.fields(*subjects[0])
    rec = {"phase": "tets", "resolution": service.cfg.resolution,
           "fields": compare_extractors({"hr": sdf_hr, "lr": sdf_lr})}
    small = sdf_hr[::4, ::4, ::4].contiguous()
    del sdf_hr, sdf_lr
    v_card, f_card = marching_tetrahedra(small, 0.5)
    v_cpu, f_cpu = marching_tetrahedra(small.cpu(), 0.5)
    rec["small"] = {"shape": list(small.shape),
                    "faces": int(f_cpu.shape[0]),
                    "card_equals_cpu": bool(
                        torch.equal(v_card.cpu(), v_cpu)
                        and torch.equal(f_card.cpu(), f_cpu))}
    del small, v_card, f_card
    rec["requests"] = {}
    img, mask = subjects[0]
    for name, kw in (("tets", {"mc_algorithm": "tets"}),
                     ("host", {"mc_backend": "host"})):
        svc = SuRSService(full_width_config(**kw))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = svc.reconstruct(img, mask, f"tets_{name}", out_dir,
                                stats=stats)
        rec["requests"][name] = {
            "seconds": time.perf_counter() - t0, "mc": stats["mc"],
            "extract_s": stats["extract_s"], "write_s": stats["write_s"],
            "faces_hr": stats["faces"][0], "faces_lr": stats["faces"][1],
            "obj_bytes": [os.path.getsize(p) for p in paths]}
        del svc
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    emit(rec)
    req = rec["requests"]
    if not (rec["small"]["card_equals_cpu"] and rec["small"]["faces"] > 0
            and req["tets"]["mc"] == "device/tets"
            and req["host"]["mc"] == "host/tets"
            and min(req["tets"]["faces_hr"], req["host"]["faces_hr"]) > 0):
        raise AssertionError(f"tets failed: {rec}")
    return rec


def write_png(path: str, img) -> None:
    """[H, W] or [H, W, 3] uint8 -> an 8-bit gray or RGB PNG, every row
    unfiltered (the standard library alone: PIL may be absent)."""
    import struct
    import zlib
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def phase_cli(out_dir: str):
    """The CLI's main() on the card: one PNG pair at CLI_RESOLUTION^3,
    the reference model's full width; whether PIL is installed."""
    import torch
    from surs_tpu_torch.__main__ import main
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp

    watch = os.path.join(out_dir, "cli_in")
    os.makedirs(watch, exist_ok=True)
    img, mask = synthetic_subject(0)
    write_png(os.path.join(watch, "subject.png"), img)
    write_png(os.path.join(watch, "subject_mask.png"), mask)
    args = ["--watch_dir", watch, "--once", "--resolution",
            str(CLI_RESOLUTION), "--b_min", "-0.5", "-0.5", "-0.5",
            "--b_max", "0.5", "0.5", "0.5", "--seed", str(SEED),
            "--results_path", out_dir, "--name", "cli"]
    torch.cuda.synchronize()
    # the CLI decodes the PNGs itself: PIL hidden, as on a machine
    # without it
    saved = sys.modules.get("PIL", False)
    sys.modules["PIL"] = None
    try:
        fused_dual_mlp.launches = 0          # the CLI's path starts here
        t0 = time.perf_counter()
        main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fused_dual_mlp.launches   # the CLI's path ends here
    finally:
        if saved is False:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    objs = [os.path.join(out_dir, "cli", f"subject{s}")
            for s in ("_HR.obj", "_LR.obj")]
    sizes = [os.path.getsize(p) if os.path.isfile(p) else 0 for p in objs]
    try:
        import PIL  # noqa: F401  (only whether it imports)
        pil = True
    except ImportError:
        pil = False
    rec = {"phase": "cli", "pil_available": pil, "decoded_without_pil": True,
           "resolution": CLI_RESOLUTION, "seconds": seconds,
           "k1_launches": launches, "obj_bytes": sizes}
    emit(rec)
    for p in objs:
        if os.path.isfile(p):
            os.remove(p)
    if launches <= 0 or not all(sizes):
        raise AssertionError(f"cli failed: {rec}")
    return rec


def reference_state_dict(seed: int = SEED, scale: float = 0.05):
    """A reference-style netG state dict at the README config (every key
    and shape of ``tests/fixtures/ref_netG_state_spec.json``), zero-mean
    seeded weights."""
    import torch
    with open(REF_SPEC) as f:
        spec = json.load(f)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
        for k, shape in spec.items()}


def phase_eval(out_dir: str, keep_obj=None):
    """The eval CLI (surs_tpu_torch.apps.eval_surs.main) at full width
    and 512^3 on a folder of two PNG pairs, PIL hidden, loading a
    reference-style checkpoint; then a float32 service loaded from that
    file against one given the same weights through params=. With
    ``keep_obj`` subject 0's HR mesh is moved there before the phase's
    OBJ files are dropped."""
    import contextlib
    import io

    import torch
    from surs_tpu_torch.apps.eval_surs import main
    from surs_tpu_torch.compat.torch_import import reference_to_flax
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.recon import pipeline
    from surs_tpu_torch.serve import SuRSService

    root = os.path.join(out_dir, "eval_in")
    for sub in ("image_final", "mask_final"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(EVAL_SUBJECTS):
        img, mask = synthetic_subject(i)
        write_png(os.path.join(root, "image_final", f"subject{i}.png"), img)
        write_png(os.path.join(root, "mask_final", f"subject{i}.png"), mask)
    sd = reference_state_dict()
    ckpt = os.path.join(out_dir, "ref_netG")
    torch.save(sd, ckpt)
    cfg = full_width_config(resolution=EVAL_RESOLUTION, residual=True)
    args = ["--dataroot", root, "--name", "eval", *cli_args(cfg),
            "--load_netG_checkpoint_path", ckpt, "--results_path", out_dir]
    # time each subject; its stats carry the OBJ writes' seconds
    per, gen_mesh = [], pipeline.Reconstructor.gen_mesh

    def timed(self, cfg, data, save_path, stats=None):
        st = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths = gen_mesh(self, cfg, data, save_path, st)
        torch.cuda.synchronize()
        per.append({"seconds": time.perf_counter() - t,
                    "write_s": st["write_s"], "mode": st["mode"],
                    "queries": st["queries"], "faces": st["faces"],
                    "obj_bytes": [os.path.getsize(p) for p in paths]})
        return paths

    log = io.StringIO()
    saved = sys.modules.get("PIL", False)
    sys.modules["PIL"] = None            # the CLI decodes the PNGs itself
    pipeline.Reconstructor.gen_mesh = timed
    try:
        torch.cuda.synchronize()
        fused_dual_mlp.launches = 0          # the eval path starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fused_dual_mlp.launches   # the eval path ends here
    finally:
        pipeline.Reconstructor.gen_mesh = gen_mesh
        if saved is False:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    text = log.getvalue()
    m = re.search(r"imported (\d+) tensors from torch checkpoint", text)
    imported = int(m.group(1)) if m else 0
    saved_lines = text.count("\nsaved ")
    if keep_obj is not None:
        os.replace(os.path.join(out_dir, "eval", "subject0_HR.obj"),
                   keep_obj)
    clear_objs(os.path.join(out_dir, "eval"))
    torch.cuda.empty_cache()
    # float32 at full width, 128^3: loaded from the file against the same
    # weights given as a Flax tree
    f32 = dict(resolution=min(CLI_RESOLUTION, EVAL_RESOLUTION),
               dtype="float32", feature_dtype="float32", residual=True)
    with contextlib.redirect_stdout(io.StringIO()):
        from_file = SuRSService(full_width_config(
            load_netG_checkpoint_path=ckpt, **f32))
        tree, n_tree = reference_to_flax(sd, from_file.model)
        from_params = SuRSService(full_width_config(**f32), params=tree)
    img, mask = synthetic_subject(0)
    a = from_file.fields(img, mask)
    b = from_params.fields(img, mask)
    err = max((x - y).abs().max().item() for x, y in zip(a, b))
    lr_range = [a[1].min().item(), a[1].max().item()]
    n_model = len(from_file.model.state_dict())
    del from_file, from_params, a, b
    torch.cuda.empty_cache()
    rec = {"phase": "eval", "resolution": EVAL_RESOLUTION,
           "subjects": EVAL_SUBJECTS,
           "seconds": seconds, "k1_launches": launches, "requests": per,
           "seconds_per_subject": float(np.mean([r["seconds"]
                                                 for r in per])),
           "write_s_per_subject": float(np.mean([r["write_s"]
                                                 for r in per])),
           "imported_tensors": imported, "model_tensors": n_model,
           "saved_lines": saved_lines,
           "f32_file_vs_params": err, "f32_tol": CKPT_TOL,
           "f32_resolution": f32["resolution"],
           "f32_field_lr_range": lr_range}
    emit(rec)
    if not (launches > 0 and len(per) == EVAL_SUBJECTS
            and saved_lines == EVAL_SUBJECTS
            and all(min(r["obj_bytes"]) > 0 and min(r["faces"]) > 0
                    for r in per)
            and imported == n_tree == n_model and err <= CKPT_TOL):
        raise AssertionError(f"eval failed: {rec}")
    return rec


def phase_dense(out_dir: str, subjects):
    """Dense serving through K3: one subject at 512^3, its stages, and K1
    held against the dense field at random grid points."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.ops.point_query import fused_query
    from surs_tpu_torch.recon.grid import flat_index_to_world
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import SuRSService, normalize_image

    t0 = time.perf_counter()
    service = SuRSService(full_width_config(use_octree=False))
    warm = service.warmup((256, 256))
    setup_s = time.perf_counter() - t0
    img, mask = subjects[0]
    stats = {}
    torch.cuda.synchronize()
    fm.fused_dual_mlp.launches = 0        # main path starts here
    fm.fused_dual_mlp_cols.launches = 0
    t1 = time.perf_counter()
    p_hr, p_lr = service.reconstruct(img, mask, "dense0", out_dir,
                                     stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    k3, k1 = fm.fused_dual_mlp_cols.launches, fm.fused_dual_mlp.launches
    written = [os.path.getsize(p) for p in (p_hr, p_lr)]
    stages = phase_stages(service, subjects, out_dir, phase="dense_stages")
    # K1 at random grid points against the dense field of the subject
    arr, _ = normalize_image(img, mask)
    cfg = service.cfg
    _, feats_lr, feat_hr = service.rec.encode(arr)
    sdf_hr, sdf_lr, mat = service.rec.evaluate(
        feats_lr, feat_hr, eval_calibration(1), cfg.resolution, cfg.b_min,
        cfg.b_max, use_octree=False)
    rng = np.random.default_rng(SEED)
    flat = torch.from_numpy(rng.integers(0, cfg.resolution ** 3,
                                         N_MAIN)).cuda()
    pts = flat_index_to_world(flat, cfg.resolution, 1, mat)
    fdt = service.rec.feature_dtype
    with torch.inference_mode():
        q_hr, q_lr = fused_query(service.weights, feats_lr[-1].to(fdt),
                                 feat_hr.to(fdt), pts[None],
                                 torch.from_numpy(eval_calibration(1)).cuda(),
                                 cfg.loadSize, cfg.z_size)
    err = max((q_hr[0] - sdf_hr.reshape(-1)[flat]).abs().max().item(),
              (q_lr[0] - sdf_lr.reshape(-1)[flat]).abs().max().item())
    rec = {"phase": "dense", "resolution": cfg.resolution,
           "setup_s": setup_s, "warmup_s": warm, "seconds": seconds,
           "mode": stats["mode"], "queries": stats["queries"],
           "faces": stats["faces"], "obj_bytes": written,
           "k3_launches": k3, "k1_launches": k1,
           "k1_vs_dense_field": err, "k1_vs_dense_tol": SERVE_TOL,
           "field_lr_range": [sdf_lr.min().item(), sdf_lr.max().item()],
           "stages": {k: stages[k] for k in ("encode_s", "evaluate_s",
                                             "extract_s", "write_s")}}
    del service, sdf_hr, sdf_lr
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    rec["float32"] = f32 = dense_float32(out_dir, img, mask, subjects)
    emit(rec)
    if not (k3 > 0 and k1 == 0 and rec["mode"] == "dense-cols"
            and stats["faces"][1] > 0 and err <= SERVE_TOL
            and stages["mode"] == "dense-cols"
            and f32["k3_launches"] > 0 and f32["k1_launches"] == 0
            and f32["mode"] == f32["stages"]["mode"] == "dense-cols"
            and f32["faces"][1] > 0):
        raise AssertionError(f"dense failed: {rec}")
    return rec


def dense_float32(out_dir: str, img, mask, subjects) -> dict:
    """One 512^3 subject served with --feature_dtype float32 through the
    float32 (3xTF32) K3, K3's and K1's launch counts zeroed just before
    and read just after; its time by stage."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.serve import SuRSService

    service = SuRSService(full_width_config(use_octree=False,
                                            feature_dtype="float32"))
    service.warmup((256, 256))
    stats = {}
    torch.cuda.synchronize()
    fm.fused_dual_mlp.launches = 0        # main path starts here
    fm.fused_dual_mlp_cols.launches = 0
    t1 = time.perf_counter()
    service.reconstruct(img, mask, "dense_f32", out_dir, stats=stats)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t1, "mode": stats["mode"],
           "queries": stats["queries"], "faces": stats["faces"],
           "k3_launches": fm.fused_dual_mlp_cols.launches,
           "k1_launches": fm.fused_dual_mlp.launches}
    stages = phase_stages(service, subjects, out_dir,
                          phase="dense_f32_stages")
    out["stages"] = {k: stages[k] for k in ("mode", "encode_s",
                                            "evaluate_s", "extract_s",
                                            "write_s")}
    del service
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    return out


def phase_mono_f32(out_dir: str, subjects) -> dict:
    """One 512^3 subject served on the mono octree with --feature_dtype
    float32, through the float32 K1 (3xTF32: the pre-pass and the chain
    one point a row); K1's, K3's and K4's launch counts zeroed just before
    and read just after, the peak memory; then its time by stage."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.serve import SuRSService

    service = SuRSService(full_width_config(feature_dtype="float32"))
    service.warmup((256, 256))
    img, mask = subjects[0]
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.fused_dual_mlp.launches = 0        # main path starts here
    fm.fused_dual_mlp_cols.launches = 0
    fm.fused_dual_mlp_runs.launches = 0
    t1 = time.perf_counter()
    service.reconstruct(img, mask, "mono_f32", out_dir, stats=stats)
    torch.cuda.synchronize()
    rec = {"phase": "mono_f32", "seconds": time.perf_counter() - t1,
           "mode": stats["mode"], "queries": stats["queries"],
           "faces": stats["faces"],
           "k1_launches": fm.fused_dual_mlp.launches,
           "k3_launches": fm.fused_dual_mlp_cols.launches,
           "k4_launches": fm.fused_dual_mlp_runs.launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    stages = phase_stages(service, subjects, out_dir,
                          phase="mono_f32_stages")
    rec["stages"] = {k: stages[k] for k in ("mode", "encode_s", "evaluate_s",
                                            "extract_s", "write_s")}
    emit(rec)
    del service
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    if not (rec["k1_launches"] > 0 and rec["k3_launches"] == 0
            and rec["k4_launches"] == 0 and rec["faces"][1] > 0
            and rec["mode"] == stages["mode"] == "octree-mono"):
        raise AssertionError(f"mono_f32 failed: {rec}")
    return rec


def phase_runs(out_dir: str, subjects, serve_rec=None):
    """Runs-mode serving through K4 on the subjects of ``serve``; then a
    float32 runs service against a float32 mono service at 128^3."""
    import torch
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.serve import SuRSService

    t0 = time.perf_counter()
    service = SuRSService(full_width_config(serve_octree_mode="runs"))
    warm = service.warmup((256, 256))
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    fm.fused_dual_mlp.launches = 0        # main path starts here
    fm.fused_dual_mlp_runs.launches = 0
    per = []
    for i, (img, mask) in enumerate(subjects):
        stats = {}
        t1 = time.perf_counter()
        p_hr, p_lr = service.reconstruct(img, mask, f"runs{i}", out_dir,
                                         stats=stats)
        per.append({"seconds": time.perf_counter() - t1,
                    "mode": stats["mode"], "queries": stats["queries"],
                    "faces_hr": stats["faces"][0],
                    "faces_lr": stats["faces"][1],
                    "obj_bytes": [os.path.getsize(p_hr),
                                  os.path.getsize(p_lr)]})
    torch.cuda.synchronize()
    k4, k1 = fm.fused_dual_mlp_runs.launches, fm.fused_dual_mlp.launches
    resolution = service.cfg.resolution
    stages = phase_stages(service, subjects, out_dir, phase="runs_stages")
    del service
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    # one 512^3 subject with --feature_dtype float32: the float32 (3xTF32)
    # K4's main path, its launch counts zeroed just before and read just
    # after
    img, mask = subjects[0]
    service = SuRSService(full_width_config(serve_octree_mode="runs",
                                            feature_dtype="float32"))
    service.warmup((256, 256))
    st_f = {}
    torch.cuda.synchronize()
    fm.fused_dual_mlp.launches = 0
    fm.fused_dual_mlp_runs.launches = 0
    t1 = time.perf_counter()
    service.reconstruct(img, mask, "runs_f32", out_dir, stats=st_f)
    torch.cuda.synchronize()
    f32 = {"seconds": time.perf_counter() - t1, "mode": st_f["mode"],
           "queries": st_f["queries"], "faces": st_f["faces"],
           "k4_launches": fm.fused_dual_mlp_runs.launches,
           "k1_launches": fm.fused_dual_mlp.launches}
    f32_stages = phase_stages(service, subjects, out_dir,
                              phase="runs_f32_stages")
    f32["stages"] = {k: f32_stages[k] for k in ("encode_s", "evaluate_s",
                                                "extract_s", "write_s")}
    del service
    clear_objs(out_dir)
    torch.cuda.empty_cache()
    # float32, full width, 128^3: the window path against the point path
    small = dict(resolution=128, dtype="float32", feature_dtype="float32")
    st_r, st_m = {}, {}
    f_runs = SuRSService(full_width_config(serve_octree_mode="runs",
                                           **small)).fields(img, mask, st_r)
    f_mono = SuRSService(full_width_config(**small)).fields(img, mask, st_m)
    err = max((a - b).abs().max().item() for a, b in zip(f_runs, f_mono))
    rec = {"phase": "runs", "resolution": resolution, "setup_s": setup_s,
           "warmup_s": warm, "requests": per, "k4_launches": k4,
           "k1_launches": k1,
           "seconds_per_request": float(np.mean([r["seconds"] for r in per])),
           "queries_per_request": float(np.mean([r["queries"] for r in per])),
           "f32_runs_vs_mono_128": err, "f32_tol": RUNS_VS_MONO_TOL,
           "f32_modes": [st_r["mode"], st_m["mode"]],
           "f32_queries": [st_r["queries"], st_m["queries"]],
           "float32": f32,
           "stages": {k: stages[k] for k in ("encode_s", "evaluate_s",
                                             "extract_s", "write_s")}}
    if serve_rec is not None:
        rec["mono_seconds_per_request"] = serve_rec["seconds_per_request"]
        rec["mono_queries_per_request"] = float(np.mean(
            [r["queries"] for r in serve_rec["requests"]]))
    emit(rec)
    if not (k4 > 0 and k1 == 0 and err <= RUNS_VS_MONO_TOL
            and all(r["mode"] == "octree-runs" and r["faces_lr"] > 0
                    for r in per)
            and rec["f32_modes"] == ["octree-runs", "octree-mono"]
            and stages["mode"] == "octree-runs"
            and f32["k4_launches"] > 0 and f32["k1_launches"] == 0
            and f32["mode"] == "octree-runs" and f32["faces"][1] > 0):
        raise AssertionError(f"runs failed: {rec}")
    return rec


# ------------------------------------------------------------- training --
class RepeatedItems:
    """``len(items) * times`` items cycling through ``items``."""

    def __init__(self, items, times: int):
        self.items, self.times = items, times

    def __len__(self):
        return len(self.items) * self.times

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


def train_items(cfg, seed: int = SEED):
    """One batch of training items in the dataset's format, from a seed:
    an image with an ellipse silhouette (LR at loadSize/2, HR at
    loadSize), the eval calibration, sample points in the +-0.5 box and
    occupancy labels of an ellipsoid (labels_disp: the HR occupancy at
    the LR samples, as the dataset defines it), and the silhouette
    (mask_LR)."""
    rng = np.random.default_rng(seed)
    S, N = cfg.loadSize // 2, cfg.num_sample_inout
    yy, xx = np.mgrid[:S, :S]
    axes = np.array([0.18, 0.40, 0.15])

    def inside(p):
        return (((p / axes[:, None]) ** 2).sum(0) < 1).astype(np.float32)

    items = []
    for i in range(cfg.batch_size):
        sil = ((((xx - S / 2) / (S * 0.18)) ** 2
                + ((yy - S / 2) / (S * 0.40)) ** 2) < 1)[..., None]
        img_lr = ((rng.random((S, S, 3)) * 2 - 1) * sil).astype(np.float32)
        img_hr = np.repeat(np.repeat(img_lr, 2, 0), 2, 1)
        pts_hr = rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
        pts_lr = rng.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
        items.append({
            "name": f"synthetic{i}", "img_LR": img_lr, "img_HR": img_hr,
            "mask_LR": sil.astype(np.float32),
            "calib": np.diag([2.0, -2.0, 2.0, 1.0]).astype(np.float32),
            "samples_HR": pts_hr, "samples_LR": pts_lr,
            "labels_HR": inside(pts_hr)[None],
            "labels_disp": inside(pts_lr)[None]})
    return items


def train_config(root: str):
    return full_width_config(
        batch_size=TRAIN_BATCH, num_sample_inout=TRAIN_POINTS,
        fused_train=True, no_gen_mesh=True, freq_save_ply=0, freq_plot=5,
        num_epoch=1, checkpoints_path=os.path.join(root, "checkpoints"),
        results_path=os.path.join(root, "results"), name="smoke")


def phase_train(root: str, device: str = "cuda"):
    import torch
    from surs_tpu_torch.data.loader import DataLoader
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp_train
    from surs_tpu_torch.train.loop import train

    cfg = train_config(root)
    items = train_items(cfg)
    loader = DataLoader(RepeatedItems(items, TRAIN_STEPS),
                        batch_size=TRAIN_BATCH, shuffle=False)
    marks, held = [], {}

    def on_step(state, metrics):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), float(metrics["total"])))
        held["state"] = state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dual_mlp_train.launches = 0    # main path starts here
    t0 = time.perf_counter()
    out = train(cfg, loader, max_iters=TRAIN_STEPS, device=device,
                on_step=on_step)
    torch.cuda.synchronize()
    launches = fused_dual_mlp_train.launches   # main path ends here
    times = np.diff([t0] + [t for t, _ in marks])
    losses = [loss for _, loss in marks]
    rec = {"phase": "train", "batch": TRAIN_BATCH, "points": TRAIN_POINTS,
           "loadSize": cfg.loadSize, "num_stack_lr": cfg.num_stack_lr,
           "trunk_dtype": str(held["state"].model.super_resolution
                              .compute_dtype),
           "steps": out["iters"], "k2_launches": launches,
           "warmup_s": float(times[0]),
           "seconds_per_step": float(np.median(times[1:])),
           "step_s": [float(t) for t in times],
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "wall_s": out["wall_sec"],
           "save_s": out["save_sec"]}
    emit(rec)
    if not (out["iters"] == TRAIN_STEPS and launches == 3 * TRAIN_STEPS
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train failed: {rec}")
    return cfg, items, held["state"], rec


def phase_train_check(cfg, items, trained, device: str = "cuda"):
    import dataclasses
    import torch
    from surs_tpu_torch.data.loader import collate
    from surs_tpu_torch.models.surs_net import surs_net_from_config
    from surs_tpu_torch.config import resolve_config
    from surs_tpu_torch.train.checkpoint import CheckpointManager
    from surs_tpu_torch.train.fused_step import fused_train_loss
    from surs_tpu_torch.train.loop import batch_to_device
    from surs_tpu_torch.train.optim import make_optimizer
    from surs_tpu_torch.train.step import (create_train_state,
                                           denormalize_images, train_loss)

    rec = {"phase": "train_check"}
    # (a) fused vs plain gradients from one float32 state
    cfg = resolve_config(cfg, device)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = surs_net_from_config(cfg32, device).train()
    batch = denormalize_images(batch_to_device(collate(items), device,
                                               quantize_images=True))

    def grads(loss_fn):
        model.zero_grad(set_to_none=True)
        total, (errors, _, _) = loss_fn(model, batch)
        total.backward()
        return ({n: p.grad.detach().clone()
                 for n, p in model.named_parameters()},
                {k: v.item() for k, v in errors.items()})

    g_plain, e_plain = grads(train_loss)
    g_again, _ = grads(train_loss)
    g_fused, e_fused = grads(fused_train_loss)

    def rel(a, b):
        worst = (0.0, None)
        for n in b:
            d, s = float((a[n] - b[n]).norm()), float(b[n].norm())
            r = d / s if s > 0 else (0.0 if d == 0 else float("inf"))
            worst = max(worst, (r, n))
        return worst

    worst, rec["worst_tensor"] = rel(g_fused, g_plain)
    rec.update(grad_rel_err=worst, grad_tol=GRAD_TOL,
               plain_repeat_rel_err=rel(g_again, g_plain)[0],
               tensors=len(g_plain), loss_fused=e_fused["total"],
               loss_plain=e_plain["total"])
    del model, g_plain, g_again, g_fused
    # (b) the trainer's last checkpoint, restored into a fresh state
    fresh = surs_net_from_config(cfg, device, seed=SEED + 7)
    state = create_train_state(fresh, make_optimizer(cfg, fresh.parameters()))
    CheckpointManager(cfg.checkpoints_path, cfg.name).restore(state)
    want_p = trained.model.state_dict()
    same = state.step == trained.step and all(
        torch.equal(v, want_p[k]) for k, v in state.model.state_dict().items())
    got_o = state.optimizer.state_dict()["state"]
    want_o = trained.optimizer.state_dict()["state"]
    same = same and sorted(got_o) == sorted(want_o) and all(
        torch.equal(got_o[i][k].float(), want_o[i][k].float())
        for i in want_o for k in want_o[i])
    rec.update(checkpoint_roundtrip_equal=bool(same),
               checkpoint_step=state.step)
    emit(rec)
    if not (worst <= GRAD_TOL and same
            and abs(e_fused["total"] - e_plain["total"])
            <= 1e-5 * abs(e_plain["total"])):
        raise AssertionError(f"train_check failed: {rec}")


# the configs phase: batch-norm steps (the running statistics then hold
# 1 - 0.9^48 = 99.4 % of the batches'; after 16 the init's unit variance
# still holds 19 %, enough to take the eval trunk off scale and leave
# the served meshes empty), the group-norm plain steps beside them,
# multi-view steps (a second step gives a warm time), and the remat
# comparison's batch (one item runs the same recomputation as four, in
# less time; the peaks then cover one item)
CONFIG_STEPS = 48
GN_STEPS = 3
MV_STEPS = 2
REMAT_BATCH = 1
# the batch-norm model served from its netG file against the same
# trained model in memory through the same path: the same weights,
# statistics and kernels (bf16 trunk and K1), so equal up to a cuDNN
# algorithm's summation order, which can flip a bf16 rounding as in K1
CONFIG_FIELD_TOL = K1_TOL["bfloat16"]
# remat against no remat, float32, one step from the same weights: the
# same operations recomputed, so the loss to float32 rounding (1e-6
# relative), the gradients per tensor at GRAD_TOL (cuDNN's backward may
# sum in another order from run to run), the running statistics (from
# the first forward alone) to 1e-6 of their norm
REMAT_LOSS_TOL = 1e-6
REMAT_STATS_TOL = 1e-6
# a gradient that is zero by construction (the bias of a conv in front of
# a batch norm, which removes any per-channel constant) holds float32
# noise: each tensor's gradient error is taken relative to its norm plus
# this share of the whole gradient's norm
GRAD_FLOOR = 1e-6


def configs_fields(rec, cfg, img, mask):
    """(sdf_hr, sdf_lr, evaluate seconds) of one subject through ``rec``
    (mono octree, silhouette pruning, as the service)."""
    import torch
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import normalize_image

    arr, m = normalize_image(img, mask)
    _, feats_lr, feat_hr = rec.encode(arr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sdf_hr, sdf_lr, _ = rec.evaluate(
        feats_lr, feat_hr, eval_calibration(1), cfg.resolution, cfg.b_min,
        cfg.b_max, use_octree=cfg.use_octree, num_samples=cfg.num_samples,
        threshold=cfg.threshold, init_resolution=cfg.octree_init_resolution,
        silhouette=m)
    torch.cuda.synchronize()
    return sdf_hr, sdf_lr, time.perf_counter() - t0


def configs_train(cfg, items, steps: int):
    """train() on ``items`` repeated, ``steps`` steps, on the card ->
    (its record: seconds per step after the first, losses, the
    predictions' shape, peak memory, K2's launches; the trained state)."""
    import torch
    from surs_tpu_torch.data.loader import DataLoader
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp_train
    from surs_tpu_torch.train.loop import train

    loader = DataLoader(RepeatedItems(items, steps),
                        batch_size=cfg.batch_size, shuffle=False)
    marks, held = [], {}

    def on_step(state, metrics):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), float(metrics["total"])))
        held.update(state=state, shape=list(metrics["pred_hr"].shape))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dual_mlp_train.launches = 0        # main path starts here
    t0 = time.perf_counter()
    train(cfg, loader, max_iters=steps, device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    k2 = fused_dual_mlp_train.launches       # main path ends here
    times = np.diff([t0] + [t for t, _ in marks])
    losses = [loss for _, loss in marks]
    rec = {"batch": cfg.batch_size, "views": cfg.num_views,
           "points": cfg.num_sample_inout, "norm": cfg.norm,
           "fused_train": cfg.fused_train, "steps": len(marks),
           "k2_launches": k2, "pred_shape": held["shape"],
           "warmup_s": float(times[0]),
           "seconds_per_step": float(np.median(times[1:])),
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "first_loss": losses[0], "last_loss": losses[-1]}
    rec["ok"] = bool(len(marks) == steps and k2 == 0
                     and np.isfinite(losses).all())
    return rec, held["state"]


def configs_batch_norm(root: str):
    """(a) A batch-norm model trained at full width with --fused_train
    (the plain step: K2 never launched; the group-norm plain step beside
    it), saved, loaded strictly into a fresh service through load_netG
    and served at 512^3 through K1 on the first training item's view
    (the input its statistics were gathered on); the served field
    against the trained model's own."""
    import torch
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.recon.pipeline import build_reconstructor
    from surs_tpu_torch.serve import SuRSService
    from surs_tpu_torch.train.checkpoint import CheckpointManager

    base = train_config(root)
    items = train_items(base)
    gn, _ = configs_train(dataclasses.replace(
        base, fused_train=False, name="configs_gn"), items, GN_STEPS)
    cfg = dataclasses.replace(base, norm="batch", name="configs_bn")
    bn, state = configs_train(cfg, items, CONFIG_STEPS)
    model = state.model
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    moved = sum(not torch.equal(v, torch.zeros_like(v) if
                                k.endswith("mean") else torch.ones_like(v))
                for k, v in stats.items())

    path = CheckpointManager(cfg.checkpoints_path, cfg.name).path()
    service = SuRSService(full_width_config(norm="batch",
                                            load_netG_checkpoint_path=path))
    service.warmup((256, 256))
    # the first item's view, as the service takes an image in [0, 1]
    img, mask = (items[0]["img_LR"] + 1.0) / 2.0, items[0]["mask_LR"]
    torch.cuda.synchronize()
    fused_dual_mlp.launches = 0              # main path starts here
    t1 = time.perf_counter()
    req = {}
    service.reconstruct(img, mask, "configs_bn", root, stats=req)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t1
    k1 = fused_dual_mlp.launches             # main path ends here
    served_hr, served_lr, evaluate_s = configs_fields(
        service.rec, service.cfg, img, mask)
    mem_rec = build_reconstructor(service.cfg, model, "cuda",
                                  service.cfg.serve_octree_mode)
    mem_hr, mem_lr, _ = configs_fields(mem_rec, service.cfg, img, mask)
    field_err = max((a - b).abs().max().item() for a, b in
                    ((served_hr, mem_hr), (served_lr, mem_lr)))
    restored = all(torch.equal(v, stats[k].to(v.device))
                   for k, v in service.model.state_dict().items()
                   if k in stats)
    bn.update(stats=len(stats), stats_moved=moved, stats_restored=restored,
              k1_launches=k1, request_s=request_s, queries=req["queries"],
              extract_s=req["extract_s"], write_s=req["write_s"],
              faces=req["faces"], evaluate_s=evaluate_s,
              field_lr_range=[served_lr.min().item(),
                              served_lr.max().item()],
              served_vs_trained_field=field_err, field_tol=CONFIG_FIELD_TOL)
    ok = (gn["ok"] and bn["ok"] and moved == len(stats) > 0 and restored
          and k1 > 0 and min(req["faces"]) > 0
          and field_err <= CONFIG_FIELD_TOL)
    return {"group_norm_plain": gn, "batch_norm": bn}, ok


def configs_multi_view(root: str):
    """(b) num_views=2 at batch 1 (the reference's only multi-view
    shape), full width, --fused_train: the plain step."""
    cfg = dataclasses.replace(train_config(root), num_views=2, batch_size=1,
                              name="configs_mv")
    a, b = train_items(dataclasses.replace(cfg, batch_size=2))
    item = {**a, **{k: np.stack([a[k], b[k]])
                    for k in ("img_LR", "img_HR", "calib")}}
    rec, _ = configs_train(cfg, [item], MV_STEPS)
    return rec, rec["ok"] and rec["pred_shape"] == [2, TRAIN_POINTS, 1]


def configs_remat(root: str):
    """(c) One full-width float32 step at batch REMAT_BATCH each way (no
    remat, remat, remat + remat_encoder), with group and batch norm,
    from the same weights and statistics: losses, gradients and running
    statistics against no remat's; peak memory and step time."""
    import torch
    from surs_tpu_torch.data.loader import collate
    from surs_tpu_torch.models.surs_net import surs_net_from_config
    from surs_tpu_torch.config import resolve_config
    from surs_tpu_torch.train.loop import batch_to_device
    from surs_tpu_torch.train.step import denormalize_images, train_loss

    base = dataclasses.replace(train_config(root), dtype="float32",
                               batch_size=REMAT_BATCH)
    batch = denormalize_images(batch_to_device(
        collate(train_items(base)), "cuda", quantize_images=True))
    modes = (("none", False, False), ("remat", True, False),
             ("remat+encoder", True, True))
    out, ok = {}, True
    for norm in ("group", "batch"):
        cfg = resolve_config(dataclasses.replace(base, norm=norm), "cuda")
        model = surs_net_from_config(cfg, "cuda").train()
        init = {k: v.clone() for k, v in model.state_dict().items()}
        want = None
        # the first no-remat step (group norm) also warms cuDNN up for
        # these float32 shapes; the batch-norm model has the same convs
        runs = ((modes[0],) if norm == "group" else ()) + modes
        for name, remat, remat_encoder in runs:
            model.load_state_dict(init)
            model.remat, model.remat_encoder = remat, remat_encoder
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            total = train_loss(model, batch)[0]
            total.backward()
            torch.cuda.synchronize()
            r = {"step_s": time.perf_counter() - t0,
                 "max_memory_allocated_gb":
                     torch.cuda.max_memory_allocated() / 1e9,
                 "loss": total.item()}
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            stats = {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            if want is None:             # no remat: the reference
                want = (r, grads, stats)
                if norm == "batch":
                    out[f"{norm}/{name}"] = r
                continue
            w_r, w_g, w_s = want
            r["loss_rel_err"] = abs(r["loss"] - w_r["loss"]) / abs(
                w_r["loss"])
            floor = GRAD_FLOOR * float(torch.stack(
                [g.norm() for g in w_g.values()]).norm())
            r["grad_rel_err"] = max(
                float((grads[n] - g).norm()) / (float(g.norm()) + floor)
                for n, g in w_g.items())
            r["stats_rel_err"] = max(
                (float((stats[k] - v).norm() / v.norm())
                 for k, v in w_s.items()), default=0.0)
            out[f"{norm}/{name}"] = r
            ok = ok and (r["loss_rel_err"] <= REMAT_LOSS_TOL
                         and r["grad_rel_err"] <= GRAD_TOL
                         and r["stats_rel_err"] <= REMAT_STATS_TOL)
            del grads
        del model, want
        torch.cuda.empty_cache()
    return {"batch": REMAT_BATCH, "points": TRAIN_POINTS,
            "dtype": "float32", "runs": out,
            "tol": {"loss": REMAT_LOSS_TOL, "grad": GRAD_TOL,
                    "grad_floor": GRAD_FLOOR, "stats": REMAT_STATS_TOL}}, ok


def phase_configs(root: str):
    """The rest of the model's configuration space at full width: (a)
    batch norm trained and served, (b) multi-view training, (c) remat."""
    import torch

    t0 = time.perf_counter()
    bn, ok_bn = configs_batch_norm(root)
    clear_objs(root)
    torch.cuda.empty_cache()
    mv, ok_mv = configs_multi_view(root)
    torch.cuda.empty_cache()
    rm, ok_rm = configs_remat(root)
    rec = {"phase": "configs", **bn, "multi_view": mv, "remat": rm,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (ok_bn and ok_mv and ok_rm):
        raise AssertionError(
            f"configs failed: batch_norm {ok_bn}, multi_view {ok_mv}, "
            f"remat {ok_rm}")


def phase_train_profile(cfg, items, trained, steps: int = 3):
    """Device time by kernel over ``steps`` fused steps from the trained
    state (torch.profiler, CUDA activity), and the device's busy share
    of the steps' wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from surs_tpu_torch.data.loader import collate
    from surs_tpu_torch.train.fused_step import make_fused_train_step
    from surs_tpu_torch.train.loop import batch_to_device

    step = make_fused_train_step(trained.model, trained.optimizer)
    batch = batch_to_device(collate(items), "cuda", quantize_images=True)
    state, _ = step(trained, batch)                 # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, launches, host, spans = {}, 0, {}, {}
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / steps
        if ev.device_type != DeviceType.CUDA:
            if ev.key.startswith(("Optimizer.step", "_FusedDualMLPTrain")):
                host[ev.key.split("#")[0]] = ev.cpu_time_total / 1e3 / steps
        elif ev.is_user_annotation:    # a host range mirrored on the card
            spans[ev.key.split("#")[0]] = ms
        else:                          # kernels, copies, sets
            per[ev.key] = ms
            launches += ev.count
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    k2_ms = sum(v for k, v in per.items() if "fused_dual_mlp_train" in k)
    rec = {"phase": "train_profile", "steps": steps,
           "wall_ms_per_step": wall * 1e3 / steps,
           "device_ms_per_step": busy,
           "device_busy_share": busy / (wall * 1e3 / steps),
           "device_ops_per_step": launches / steps,
           "k2_ms_per_step": k2_ms, "host_ms_per_step": host,
           "device_span_ms_per_step": spans,
           "top_device_ms_per_step": [[k[:80], v] for k, v in top]}
    emit(rec)
    if busy <= 0 or k2_ms <= 0:
        raise AssertionError(f"the profile saw no device time: {rec}")


def phase_serve_profile(subjects, repeats: int = 4):
    """One subject's mono octree evaluation at 512^3, full width:
    ``repeats`` timed runs (host clock to a synchronize), then one under
    torch.profiler: device time by kernel, device operations, K1's share
    and the device's busy share of the evaluation's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.recon.pipeline import eval_calibration
    from surs_tpu_torch.serve import SuRSService, normalize_image

    service = SuRSService(full_width_config())
    service.warmup((256, 256))
    cfg = service.cfg
    arr, sil = normalize_image(*subjects[1])
    _, feats_lr, feat_hr = service.rec.encode(arr)

    def evaluate():
        stats = {}
        service.rec.evaluate(
            feats_lr, feat_hr, eval_calibration(1), cfg.resolution,
            cfg.b_min, cfg.b_max, use_octree=True,
            num_samples=cfg.num_samples, threshold=cfg.threshold,
            init_resolution=cfg.octree_init_resolution, silhouette=sil,
            stats=stats)
        torch.cuda.synchronize()
        return stats

    times = []
    for _ in range(repeats):
        fused_dual_mlp.launches = 0
        t0 = time.perf_counter()
        stats = evaluate()
        times.append(time.perf_counter() - t0)
    launches = fused_dual_mlp.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate()
        wall = time.perf_counter() - t0
    per, ops = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            per[ev.key] = ev.self_device_time_total / 1e3
            ops += ev.count
    busy = sum(per.values())
    k1_ms = sum(v for k, v in per.items() if "fused_dual_mlp_wgmma" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    rec = {"phase": "serve_profile", "mode": stats["mode"],
           "queries": stats["queries"], "k1_launches": launches,
           "evaluate_s": times, "profiled_wall_ms": wall * 1e3,
           "device_ms": busy, "device_ops": ops, "k1_device_ms": k1_ms,
           "device_busy_share_median_wall": busy / (np.median(times) * 1e3),
           "top_device_ms": [[k[:80], v] for k, v in top]}
    emit(rec)
    del service
    torch.cuda.empty_cache()
    if busy <= 0 or k1_ms <= 0 or launches <= 0:
        raise AssertionError(f"the serve profile saw no K1: {rec}")


# -------------------------------------------- training data: containment --
# The on-disk dataset of train_data and precompute, made from numpy: each
# subject is four overlapping ellipsoids (torso, head, two legs) in the
# default box's units (b_min/b_max = [-128, -28, -128] / [128, 228,
# 128], sigma 5.0), an icosphere of HR_LEVEL (4 x 81,920 = 327,680 faces)
# for the HR mesh and of LR_LEVEL (4 x 5,120 = 20,480) for the LR one.
BODY = (((0.0, 120.0, 0.0), (32.0, 45.0, 18.0)),
        ((0.0, 178.0, 0.0), (12.0, 15.0, 13.0)),
        ((-13.0, 45.0, 0.0), (11.0, 48.0, 12.0)),
        ((13.0, 45.0, 0.0), (11.0, 48.0, 12.0)))
HR_LEVEL, LR_LEVEL = 6, 4
# the subjects' proportions (x, y, z stretch of BODY)
DATA_STRETCH = ((1.0, 1.0, 1.0), (1.1, 0.96, 1.08))
DATA_YAWS = list(range(0, 360, 30))          # 12 views a subject
# the PARAM camera: orthographic, the body's height over about 0.8 of the
# 512 image's half-height
DATA_ORTHO_RATIO, DATA_SCALE = 0.4, 0.84
DATA_CENTER = (0.0, 95.0, 0.0)
# the winding number against its plain version on the card, max |w|
# difference (radians, out of 4 pi = 12.6 inside): the kernel adds a
# share's ~30,000 angles one after another in float32, the plain version
# adds chunks of 2,048 by pairs (~1e-4 apart for 3e5 terms of up to 2 pi,
# 1e-3 worst); a dropped tile near a jittered point moves it by up to
# 2 pi. Labels are compared where ||w| - pi| exceeds it.
WIND_TOL = 1e-2
# precompute: draws a subject, and the steps trained from the cache
PRECOMPUTE_DRAWS = 4
PRECOMPUTE_STEPS = 6


def icosphere(level: int):
    """Unit icosphere: (verts [V, 3] float64, faces [F, 3] int64, 20 x
    4^level faces, outward)."""
    t = (1.0 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(level):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m01, m12, m20 = (inv.reshape(3, -1) + len(v))
        a, b, c = f.T
        v = np.concatenate([v, mid])
        f = np.stack([np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
                      np.stack([m20, m12, c], 1),
                      np.stack([m01, m12, m20], 1)], 1).reshape(-1, 3)
    return v, f.astype(np.int64)


def body_parts(stretch=(1.0, 1.0, 1.0)):
    st = np.asarray(stretch, float)
    return [(np.asarray(c) * st, np.asarray(a) * st) for c, a in BODY]


def body_mesh(level: int, stretch=(1.0, 1.0, 1.0)):
    """The body as one triangle soup of its parts: (verts float32,
    faces int64). Overlapping parts wind twice (|w| = 8 pi): inside."""
    sv, sf = icosphere(level)
    verts, faces = [], []
    for i, (c, a) in enumerate(body_parts(stretch)):
        verts.append(c + sv * a)
        faces.append(sf + i * len(sv))
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces))


def yaw_rotation(yaw: float) -> np.ndarray:
    y = np.deg2rad(yaw)
    return np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0],
                     [-np.sin(y), 0, np.cos(y)]])


def body_silhouette(param: dict, size: int, stretch) -> np.ndarray:
    """The body's mask [size, size] uint8 under the PARAM camera: the
    union of its parts' projected ellipses (an ellipsoid c + diag(a) z,
    |z| <= 1, projects orthographically onto the ellipse of B = P R
    diag(a)), at pixel centres, in the calib's uv convention (u right,
    v down, |uv| <= 1 across the image)."""
    R = np.asarray(param["R"])
    k = param["scale"] / param["ortho_ratio"] / (size // 2)
    uv = (np.arange(size) + 0.5) / (size // 2) - 1.0
    qx, qy = uv[None, :] / k, -uv[:, None] / k    # camera x, y
    mask = np.zeros((size, size), bool)
    for c, a in body_parts(stretch):
        B = (R @ np.diag(a))[:2]
        q0 = (R @ (c - np.asarray(param["center"])))[:2]
        Q = np.linalg.inv(B @ B.T)
        dx, dy = qx - q0[0], qy - q0[1]
        mask |= (Q[0, 0] * dx * dx + 2 * Q[0, 1] * dx * dy
                 + Q[1, 1] * dy * dy) <= 1.0
    return mask.astype(np.uint8) * 255


def write_train_dataset(root: str, size: int = 512) -> dict:
    """RENDER/ (JPEG), MASK/ (PNG), PARAM/ (.npy) at DATA_YAWS and
    GEO/OBJ/<s>_{HR,LR}.obj (the port's writer) for DATA_STRETCH's
    subjects, an empty val.txt; returns the mesh sizes."""
    from PIL import Image
    from surs_tpu_torch.recon.mesh_io import save_obj_mesh
    rng = np.random.default_rng(SEED)
    obj_dir = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj_dir)
    open(os.path.join(root, "val.txt"), "w").close()
    sizes = {}
    yy, xx = np.mgrid[:size, :size] / size
    for s, stretch in enumerate(DATA_STRETCH):
        subject = f"body{s}"
        for tag, level in (("HR", HR_LEVEL), ("LR", LR_LEVEL)):
            verts, faces = body_mesh(level, stretch)
            save_obj_mesh(os.path.join(obj_dir, f"{subject}_{tag}.obj"),
                          verts, faces)
            sizes[f"{subject}_{tag}_faces"] = len(faces)
        for d in ("RENDER", "MASK", "PARAM"):
            os.makedirs(os.path.join(root, d, subject))
        base = rng.uniform(0.3, 0.9, 3)
        for yaw in DATA_YAWS:
            param = {"ortho_ratio": DATA_ORTHO_RATIO, "scale": DATA_SCALE,
                     "center": np.asarray(DATA_CENTER),
                     "R": yaw_rotation(yaw)}
            mask = body_silhouette(param, size, stretch)
            shade = (0.6 + 0.4 * np.cos(6 * xx + yaw / 57.3)[..., None]
                     * np.sin(4 * yy)[..., None]) * base
            rgb = np.clip(shade + rng.normal(0, 0.03, shade.shape), 0, 1)
            rgb = (rgb * 255 * (mask[..., None] > 0)).astype(np.uint8)
            stem = f"{yaw}_0_00"
            Image.fromarray(rgb).save(
                os.path.join(root, "RENDER", subject, stem + ".jpg"))
            Image.fromarray(mask).save(
                os.path.join(root, "MASK", subject, stem + ".png"))
            np.save(os.path.join(root, "PARAM", subject, stem + ".npy"),
                    param, allow_pickle=True)
    return sizes


def item_draw(mesh_hr, mesh_lr, seed: int = SEED):
    """The 25,500 points of one training item's draw (sample_points_and_
    labels at TRAIN_POINTS, sigma 5.0, the default box): its own code,
    with the labelling replaced by a recorder."""
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.data.sampling import sample_points_and_labels
    cfg, drawn = SuRSConfig(), []

    def record(pts, mesh):
        drawn.append(pts)
        return np.zeros(len(pts), bool)

    sample_points_and_labels(mesh_hr, mesh_lr, TRAIN_POINTS, cfg.sigma,
                             np.asarray(cfg.b_min), np.asarray(cfg.b_max),
                             np.random.default_rng(seed),
                             contains_fn=record)
    return drawn[0].astype(np.float32)


def phase_containment():
    """The winding-number kernel against its plain version on the card
    at one item's draw (25,500 points) against the HR (327,680 faces) and
    LR (20,480) body, and on edge cases: a ragged open mesh, zero-area
    triangles, points on vertices, a mesh with a hole; ms per item (HR +
    LR) against the bound and the plain version."""
    import torch
    from surs_tpu_torch import roofline
    from surs_tpu_torch.data.sampling import MeshData
    from surs_tpu_torch.ops.containment import (THRESHOLD, winding_number,
                                                winding_number_ref)

    hr, lr = (MeshData(*body_mesh(lv)) for lv in (HR_LEVEL, LR_LEVEL))
    pts = item_draw(hr, lr)
    dev = torch.device("cuda")

    def tris_of(mesh, faces=None):
        f = mesh.faces if faces is None else faces
        return torch.from_numpy(np.ascontiguousarray(
            mesh.verts[f])).to(dev)

    p = torch.from_numpy(pts).to(dev)
    t_hr, t_lr = tris_of(hr), tris_of(lr)
    cen = (hr.verts[hr.faces].mean(1))
    hole = hr.faces[~((cen[:, 1] > 150) & (np.abs(cen[:, 0]) < 20))]
    degenerate = np.repeat(lr.verts[lr.faces[:150, :1]], 3, axis=1)
    sliver = lr.verts[lr.faces[150:300]].copy()
    sliver[:, 2] = sliver[:, 1]
    cases = {
        "hr": (p, t_hr), "lr": (p, t_lr),
        "ragged_open": (p, tris_of(hr, hr.faces[:-37])),
        "zero_area": (p, torch.cat([t_lr, torch.from_numpy(np.concatenate(
            [degenerate, sliver]).astype(np.float32)).to(dev)])),
        "on_vertex": (torch.from_numpy(np.concatenate(
            [hr.verts[::40], pts[:999]])).to(dev), t_hr),
        "hole": (p, tris_of(hr, hole)),
    }
    rec = {"phase": "containment", "points": len(pts),
           "faces_hr": len(hr.faces), "faces_lr": len(lr.faces),
           "tol": WIND_TOL, "cases": {}}
    for name, (q, t) in cases.items():
        wk = winding_number(q, t)
        wp = winding_number_ref(q, t)
        torch.cuda.synchronize()
        band = (wp.abs() - THRESHOLD).abs() <= WIND_TOL
        flips = ((wk.abs() > THRESHOLD) != (wp.abs() > THRESHOLD)) & ~band
        rec["cases"][name] = {
            "points": q.shape[0], "tris": t.shape[0],
            "max_abs_err": float((wk - wp).abs().max()),
            "near_cut": int(band.sum()),
            "label_mismatches": int(flips.sum()),
            "inside": int((wp.abs() > THRESHOLD).sum())}
    timing = {}
    for name, t in (("hr", t_hr), ("lr", t_lr)):
        timing[f"ms_{name}"] = time_cuda(lambda: winding_number(p, t), 5)
        timing[f"plain_ms_{name}"] = time_cuda(
            lambda: winding_number_ref(p, t), 1, warm=0)
    flops = nbytes = 0.0
    for faces in (len(hr.faces), len(lr.faces)):
        f, b = roofline.containment_work(len(pts), faces)
        flops, nbytes = flops + f, nbytes + b
    bound_ms, bound_by = roofline.bound(flops, nbytes, "float32")
    timing.update(ms=timing["ms_hr"] + timing["ms_lr"],
                  plain_ms=timing["plain_ms_hr"] + timing["plain_ms_lr"],
                  bound_ms=bound_ms, bound_by=bound_by,
                  gflop=flops / 1e9)
    timing["roofline_share"] = bound_ms / timing["ms"]
    timing.update(winding_sass(timing["ms"], len(pts) * (len(hr.faces)
                                                      + len(lr.faces))))
    rec["timing"] = timing
    emit(rec)
    bad = {k: v for k, v in rec["cases"].items()
           if not (v["max_abs_err"] <= WIND_TOL
                   and v["label_mismatches"] == 0)}
    if bad or rec["cases"]["hr"]["inside"] == 0:
        raise AssertionError(f"containment failed: {bad or rec}")
    return rec


def winding_sass(ms: float, pairs: int) -> dict:
    """The winding-number kernel's inner loop in the built library's SASS
    (probes/winding_sass.py): instructions a point-triangle pair on its
    common path, and the time of ``pairs`` pairs at full issue at the
    card's maximum SM clock beside ``ms``; where the toolkit has no
    cuobjdump, a line saying so."""
    import torch
    from surs_tpu_torch.ops import cuda_build
    from surs_tpu_torch.probes import winding_sass as ws
    if ws.cuobjdump() is None:
        return {"sass": "no cuobjdump"}
    lib = cuda_build.build(["winding_number"])["winding_number"]
    loop = ws.sass_loop(ws.library_sass(lib))
    if "error" in loop:
        raise AssertionError(f"winding-number SASS: {loop['error']}")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = ws.issue_ms(loop["per_pair"], pairs, sms, clock)
    return {"sass_per_pair": loop["per_pair"],
            "sass_pairs_per_iteration": loop["pairs_per_iteration"],
            "sass_mufu": loop["mufu"], "sass_histogram": loop["histogram"],
            "clock_max_mhz": clock, "issue_ms": issue,
            "issue_share": issue / ms}


class _Timed:
    """Wrap module attributes (functions) so that each call's seconds
    add to ``secs[bucket]``; restored on exit."""

    def __init__(self, targets):
        self.targets, self.secs, self.saved = targets, {}, []

    def __enter__(self):
        for module, name, bucket in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def timed(*a, _fn=fn, _bucket=bucket, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.secs[_bucket] = (self.secs.get(_bucket, 0.0)
                                          + time.perf_counter() - t0)
            setattr(module, name, timed)
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)


def item_parts(cfg, n: int = 6) -> dict:
    """Seconds of ``n`` training items by part, built one after another
    (no loader) with the containment on the card: mesh load, image (load
    and process_render), containment (both meshes), the rest of the
    sampling, the whole item. Items 0 and 1 load their subjects'
    meshes; the medians are over the later ones."""
    import torch
    from surs_tpu_torch.data import datasets, sampling
    parts = {"mesh_load": [], "image": [], "containment": [],
             "sampling": [], "item": []}
    ds = datasets.TrainDataset(cfg, "train", yaw_list=DATA_YAWS)
    for i in range(n):
        with _Timed([(datasets, "load_obj", "mesh_load"),
                     (datasets, "load_render_mask_pil", "image"),
                     (datasets, "process_render", "image"),
                     (sampling, "contains", "containment"),
                     (datasets, "sample_points_and_labels", "sampling")]
                    ) as tm:
            t0 = time.perf_counter()
            ds.get_item(i, np.random.default_rng(SEED + i))
            torch.cuda.synchronize()
            tm.secs["item"] = time.perf_counter() - t0
        tm.secs["sampling"] = tm.secs.get("sampling", 0.0) \
            - tm.secs.get("containment", 0.0)
        for k in parts:
            parts[k].append(tm.secs.get(k, 0.0))
    out = {f"{k}_s": v for k, v in parts.items()}
    out.update({f"median_{k}_s": float(np.median(v[2:]))
                for k, v in parts.items() if k != "mesh_load"})
    out["first_item_s"] = parts["item"][0]
    out["first_mesh_load_s"] = parts["mesh_load"][0]
    out["containment_share"] = (out["median_containment_s"]
                                / out["median_item_s"])
    return out


class _StepClock:
    """Time every fused step (synchronized, with its loss) and every wait
    of the training loop for its next batch, by wrapping
    make_fused_train_step and DataLoader.__iter__; restored on exit."""

    def __enter__(self):
        import torch
        from surs_tpu_torch.data.loader import DataLoader
        from surs_tpu_torch.train import fused_step
        self.marks, self.waits = [], []
        self.saved = (fused_step.make_fused_train_step, DataLoader.__iter__)
        make, it = self.saved

        def make_timed(model, opt):
            fn = make(model, opt)

            def step(state, batch):
                state, metrics = fn(state, batch)
                torch.cuda.synchronize()
                self.marks.append((time.perf_counter(),
                                   float(metrics["total"])))
                return state, metrics
            return step

        def timed_iter(loader):
            gen = it(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(gen)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield batch

        fused_step.make_fused_train_step = make_timed
        DataLoader.__iter__ = timed_iter
        return self

    def __exit__(self, *exc):
        from surs_tpu_torch.data.loader import DataLoader
        from surs_tpu_torch.train import fused_step
        fused_step.make_fused_train_step, DataLoader.__iter__ = self.saved

    def record(self, t0: float) -> dict:
        times = np.diff([t0] + [t for t, _ in self.marks])
        losses = [loss for _, loss in self.marks]
        return {"steps": len(times), "warmup_s": float(times[0]),
                "seconds_per_step": float(np.median(times[1:])),
                "step_s": [float(t) for t in times],
                "data_wait_s": [float(w) for w in self.waits],
                "median_data_wait_s": float(np.median(self.waits[1:])),
                "losses": losses}


def train_data_argv(dataroot: str, out_dir: str, name: str) -> list:
    """The train CLI at full width on the on-disk dataset: loadSize 512,
    batch 2, 6,000 points, 3 lr stacks, the fused step, every geometric
    augmentation and ColorJitter, one epoch, meshes at 512^3 in the
    default box."""
    return ["--dataroot", dataroot, "--name", name,
            "--checkpoints_path", os.path.join(out_dir, "checkpoints"),
            "--results_path", os.path.join(out_dir, "results"),
            "--loadSize", "512", "--hg_dim", "256", "--num_stack_lr", "3",
            "--batch_size", str(TRAIN_BATCH),
            "--num_sample_inout", str(TRAIN_POINTS), "--sigma", "5.0",
            "--fused_train", "--random_flip", "--random_scale",
            "--random_trans", "--aug_bri", "0.2", "--aug_con", "0.2",
            "--aug_sat", "0.1", "--aug_hue", "0.05", "--num_epoch", "1",
            "--resolution", "512", "--seed", str(SEED),
            "--yaw_list", *map(str, DATA_YAWS)]


def phase_train_data(out_dir: str):
    """Training from the on-disk dataset through the train CLI's main():
    the dataset written, one item's parts timed, then one epoch (24
    items, 12 steps) with the epoch-end checkpoint and the four OBJ files
    of the meshes at 512^3. The winding-number kernel's, K2's and K1's
    launch counts are zeroed just before main() and read just after."""
    import torch
    from surs_tpu_torch.apps import train_surs
    from surs_tpu_torch.config import build_parser, config_from_args
    from surs_tpu_torch.ops.containment import winding_number
    from surs_tpu_torch.ops.fused_mlp import (fused_dual_mlp,
                                              fused_dual_mlp_train)

    dataroot = os.path.join(out_dir, "train_data")
    t0 = time.perf_counter()
    sizes = write_train_dataset(dataroot)
    rec = {"phase": "train_data", "dataset_write_s": time.perf_counter() - t0,
           **sizes, "subjects": len(DATA_STRETCH), "yaws": len(DATA_YAWS)}
    argv = train_data_argv(dataroot, out_dir, "train_data")
    cfg = config_from_args(build_parser().parse_args(
        argv[:argv.index("--yaw_list")]))
    rec["item"] = item_parts(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _StepClock() as clock:
        winding_number.launches = 0          # main path starts here
        fused_dual_mlp_train.launches = 0
        fused_dual_mlp.launches = 0
        t0 = time.perf_counter()
        out = train_surs.main(argv)
        torch.cuda.synchronize()
        launches = {"winding_number": winding_number.launches,
                    "k2": fused_dual_mlp_train.launches,
                    "k1": fused_dual_mlp.launches}   # main path ends here
        wall = time.perf_counter() - t0
    steps = clock.record(t0)
    results = os.path.join(out_dir, "results", "train_data")
    objs = {f: os.path.getsize(os.path.join(results, f))
            for f in sorted(os.listdir(results)) if f.endswith(".obj")}
    ckpts = sorted(os.listdir(os.path.join(out_dir, "checkpoints",
                                           "train_data")))
    rec.update(steps, launches=launches, wall_s=wall,
               data_sec=out["data_sec"], data_sec_per_step=out["data_sec"]
               / out["iters"], save_s=out["save_sec"], iters=out["iters"],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, objs=objs, checkpoints=ckpts)
    emit(rec)
    n_items = len(DATA_STRETCH) * len(DATA_YAWS)
    if not (out["iters"] == n_items // TRAIN_BATCH
            and launches["k2"] == cfg.num_stack_lr * out["iters"]
            and launches["k1"] > 0
            and launches["winding_number"] == 2 * (n_items + 2)
            and all(np.isfinite(rec["losses"])) and len(objs) == 4
            and "netG_latest" in ckpts):
        raise AssertionError(f"train_data failed: {rec}")
    clear_objs(results)
    torch.cuda.empty_cache()
    return dataroot, argv, rec


def phase_precompute(out_dir: str, dataroot: str, argv: list, fed: dict):
    """precompute_samples on the card (draws a second), then
    PRECOMPUTE_STEPS fused steps trained from the cache (no containment
    launch), their data wait beside train_data's."""
    import torch
    from surs_tpu_torch.apps import precompute_samples
    from surs_tpu_torch.config import build_parser, config_from_args
    from surs_tpu_torch.ops.containment import winding_number
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp_train
    from surs_tpu_torch.train.loop import train

    winding_number.launches = 0
    t0 = time.perf_counter()
    written = precompute_samples.main(
        ["--dataroot", dataroot, "--num_sample_inout", str(TRAIN_POINTS),
         "--sigma", "5.0", "--draws", str(PRECOMPUTE_DRAWS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rec = {"phase": "precompute", "draws": written, "seconds": secs,
           "draws_per_s": written / secs,
           "precompute_launches": winding_number.launches}
    flags = argv[:argv.index("--yaw_list")]
    cfg = config_from_args(build_parser().parse_args(
        flags + ["--name", "precompute"]))
    with _StepClock() as clock:
        winding_number.launches = 0
        fused_dual_mlp_train.launches = 0
        t0 = time.perf_counter()
        out = train(cfg, max_iters=PRECOMPUTE_STEPS, yaw_list=DATA_YAWS)
        torch.cuda.synchronize()
        launches = {"winding_number": winding_number.launches,
                    "k2": fused_dual_mlp_train.launches}
    rec.update(clock.record(t0), launches=launches,
               data_sec_per_step=out["data_sec"] / out["iters"],
               train_data_median_data_wait_s=fed["median_data_wait_s"],
               train_data_data_sec_per_step=fed["data_sec_per_step"])
    emit(rec)
    if not (written == PRECOMPUTE_DRAWS * len(DATA_STRETCH)
            and rec["precompute_launches"] == 2 * written
            and launches["winding_number"] == 0
            and launches["k2"] == cfg.num_stack_lr * PRECOMPUTE_STEPS
            and all(np.isfinite(rec["losses"]))):
        raise AssertionError(f"precompute failed: {rec}")
    return rec


# the accuracy phase: a reduced run of probes/subject_demo.py (1,500
# steps there). 1,000 steps: four proof runs at 700-800 read a Chamfer of
# 0.048, 0.071, 0.081 and 0.081 against the 0.085 bound below, and the
# 0.27-0.31 s steps are most of the phase (a 1,000-step run took 254 s)
ACC_ITERS = 1000
# 5 % of the subject's 1.7-unit height. Not tightened to 1.5 x a first
# run: six runs at 1,000 steps read 0.0276-0.0505 against a marching
# cubes truth, 0.0454 against the tets truth
ACC_CHAMFER_MAX = 0.085
# the views held card against CPU: every third of the 12 (a CPU render of
# the 129,616-face tets truth takes 1.3 s)
ACC_CHECK_YAWS = slice(None, None, 3)
ACC_MASK_SHARE = 0.999       # card renders against CPU renders
ACC_RGB_LSB = 1


def check_renders(verts, faces, load_size: int, yaws,
                  device: str = "cuda", prt=None) -> dict:
    """The renderer on the card against the same renderer on the CPU, view
    by view: the share of pixels whose masks agree, and the largest RGB
    difference where both masks are set; the card's and the CPU's
    seconds a view."""
    import torch
    from surs_tpu_torch.render import render_views

    out = {"views": len(yaws), "mask_agree": 1.0, "rgb_max_lsb": 0,
           "params_equal": True}
    secs = {}
    views = {}
    for dev in ("card", "cpu"):
        t0 = time.perf_counter()
        views[dev] = list(render_views(verts, faces, load_size, yaws,
                                       device=device if dev == "card"
                                       else "cpu", prt=prt))
        torch.cuda.synchronize()
        secs[dev] = (time.perf_counter() - t0) / len(yaws)
    for (_, rgb_c, m_c, p_c), (_, rgb_h, m_h, p_h) in zip(views["card"],
                                                          views["cpu"]):
        both = (m_c > 0) & (m_h > 0)
        out["mask_agree"] = min(out["mask_agree"],
                                float((m_c == m_h).mean()))
        diff = np.abs(rgb_c.astype(int) - rgb_h.astype(int))[both]
        out["rgb_max_lsb"] = max(out["rgb_max_lsb"],
                                 int(diff.max()) if diff.size else 0)
        out["params_equal"] &= all(np.array_equal(p_c[k], p_h[k])
                                   for k in p_h)
        out["min_mask_pixels"] = min(out.get("min_mask_pixels", m_c.size),
                                     int((m_c > 0).sum()))
    out.update(card_s_per_view=secs["card"], cpu_s_per_view=secs["cpu"])
    return out


def phase_accuracy(out_dir: str, device: str = "cuda"):
    """The accuracy loop (``probes/subject_demo.run``) at full width with
    ACC_ITERS steps: the humanoid's dataset rendered on the card,
    training through train() (K2), a 512^3 mono reconstruction of view 0
    with the item's calibration (K1), timed by stage, and its Chamfer,
    P2S and normal error against the HR ground truth, beside the same
    pipeline's Chamfer at step 0. K1's and K2's launch counts are zeroed
    just before and read just after. Then the Chamfer of the ground
    truth's HR and LR meshes with TF32 on and off (equal), and 4 of the
    12 views rendered on the card against the same renderer on the
    CPU."""
    import torch
    from surs_tpu_torch.data.sampling import MeshData
    from surs_tpu_torch.ops.fused_mlp import (fused_dual_mlp,
                                              fused_dual_mlp_train)
    from surs_tpu_torch.probes import subject_demo as sd
    from surs_tpu_torch.utils.metrics import chamfer_distance

    torch.cuda.synchronize()
    fused_dual_mlp.launches = 0              # main path starts here
    fused_dual_mlp_train.launches = 0
    # the trained fields meshed three ways (card cubes and tets, host
    # tets), the card's tets held to the host's
    rec = sd.run(ACC_ITERS, device, work_dir=out_dir,
                 on_fields=lambda hr, lr: compare_extractors({"hr": hr,
                                                              "lr": lr}))
    torch.cuda.synchronize()
    launches = {"k1": fused_dual_mlp.launches,
                "k2": fused_dual_mlp_train.launches}   # main path ends here
    rec = {"phase": "accuracy", **rec, "launches": launches}
    torch.cuda.empty_cache()
    # the metric must not depend on its caller's TF32 flag
    hr, lr = (MeshData(*sd.humanoid_mesh(detail, device=device))
              for detail in (sd.HR_DETAIL, 0.0))
    flag = torch.backends.cuda.matmul.allow_tf32
    chamfers = {}
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            chamfers[tf32] = chamfer_distance(hr, lr, sd.METRIC_SAMPLES,
                                              device=device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    rec["gt_hr_lr_chamfer"] = chamfers[False][0]
    rec["chamfer_tf32_on_equal"] = chamfers[True] == chamfers[False]
    rec["renders"] = check_renders(hr.verts, hr.faces, rec["load_size"],
                                   sd.YAWS[ACC_CHECK_YAWS], device)
    emit(rec)
    r = rec["renders"]
    if not (rec["faces_hr_gt"] > 0 and rec["faces_hr"] > 0
            and np.isfinite([rec["loss_first"], rec["loss_last"]]).all()
            and rec["loss_last10"] < rec["loss_first10"]
            and rec["chamfer"] <= ACC_CHAMFER_MAX
            and rec["chamfer"] <= 0.5 * rec["step0"]["chamfer"]
            and rec["chamfer_tf32_on_equal"]
            and launches["k1"] > 0
            and launches["k2"] == rec["num_stack_lr"] * ACC_ITERS
            and r["mask_agree"] >= ACC_MASK_SHARE
            and r["min_mask_pixels"] > 0
            and r["rgb_max_lsb"] <= ACC_RGB_LSB and r["params_equal"]):
        raise AssertionError(f"accuracy failed: {rec}")
    return rec


# the color phase (the color branch, ROADMAP.md A11): the humanoid's
# four views and UV layout at 512, ResBlkColorNet trained at full width
# on UV-sampled colors, then the eval CLI with --with_color at 512^3 and
# a reference-style netC
COLOR_YAWS = [0, 90, 180, 270]
COLOR_UV_SIZE = 512
COLOR_SAMPLES = 5_000            # num_sample_color of an item
COLOR_SIGMA = 0.005              # the samples' jitter along the normal
COLOR_ITEMS = 16                 # items drawn once, cycled by the steps
COLOR_BATCH = 2
COLOR_STEPS = 300
COLOR_LR = 1e-3
NETC_SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "fixtures", "ref_netC_state_spec.json")
# the card's RefColorNet colors against the port's CPU RefColorNet on the
# same inputs (float32, TF32 off on the card, the rows independent): the
# same products and instance norms summed in other orders, ~1e-6
# relative in the maps, on colors in [0, 1]
COLOR_CPU_TOL = 1e-4
COLOR_CPU_VERTS = 4096
# the UV maps on the card against the same renderer on the CPU: the mask
# share (the view renderer's ACC_MASK_SHARE) and the largest position
# gap where both are set (float32 interpolation in another order)
UV_MASK_SHARE = 0.999
UV_POS_TOL = 1e-5
# flat lighting for the UV renders (Y00 alone, irradiance 1): UV_RENDER
# then carries the vertex colors themselves, the position code that the
# trained net's colors are scored against
FLAT_SH = np.array([1.0 / 0.28209479177387814] + [0.0] * 8, np.float32)


def reference_netc(seed: int = SEED, scale: float = 0.05):
    """A reference ResBlkPIFuNet (netC) state dict: every key and shape
    of ``tests/fixtures/ref_netC_state_spec.json`` (the 513-wide MLP),
    zero-mean seeded weights."""
    import torch
    with open(NETC_SPEC) as f:
        spec = json.load(f)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale)
        for k, shape in sorted(spec.items())}


def color_dataset(root: str, device: str = "cuda") -> dict:
    """The humanoid's HR mesh with position-coded vertex colors
    (GEO/OBJ/h0_HR.obj through save_obj_mesh_with_color), its RENDER /
    MASK / PARAM views at COLOR_YAWS and its UV layout at COLOR_UV_SIZE
    under flat lighting, both rendered on ``device``; the UV maps also
    rendered on the CPU and held to the card's."""
    import torch
    from surs_tpu_torch.probes import subject_demo as sd
    from surs_tpu_torch.recon.mesh_io import (load_obj,
                                              save_obj_mesh_with_color)
    from surs_tpu_torch.render import render_dataset, render_uv_dataset
    from surs_tpu_torch.render.uv import render_uv_maps
    from surs_tpu_torch.utils.exr import read_exr

    obj_dir = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj_dir, exist_ok=True)
    verts, faces = sd.humanoid_mesh(sd.HR_DETAIL, device=device)
    lo, hi = verts.min(0), verts.max(0)
    colors = (verts - lo) / (hi - lo)
    obj = os.path.join(obj_dir, f"{sd.SUBJECT}_HR.obj")
    save_obj_mesh_with_color(obj, verts, faces, colors)
    with open(os.path.join(root, "val.txt"), "w"):
        pass
    step = 360 // len(COLOR_YAWS)
    render_dataset(obj_dir, root, load_size=full_width_config().loadSize,
                   yaw_step=step, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_uv_dataset(obj_dir, root, uv_size=COLOR_UV_SIZE, yaw_step=step,
                      sh_coeffs=FLAT_SH, device=device)
    torch.cuda.synchronize()
    uv_s = time.perf_counter() - t0
    v, f, c = load_obj(obj, with_colors=True)
    maps = {}
    for dev in ("card", "cpu"):
        t0 = time.perf_counter()
        maps[dev] = render_uv_maps(v, f, colors=c, uv_size=COLOR_UV_SIZE,
                                   device=device if dev == "card" else "cpu")
        torch.cuda.synchronize()
        maps[dev + "_s"] = time.perf_counter() - t0
    (pos_c, _, _, m_c), (pos_h, _, _, m_h) = maps["card"], maps["cpu"]
    both = m_c & m_h
    written = read_exr(os.path.join(root, "UV_POS", sd.SUBJECT, "00.exr"))
    return {"faces": int(f.shape[0]), "vertices": int(v.shape[0]),
            "colors_read": c is not None and c.shape == v.shape,
            "uv_dataset_s": uv_s, "uv_maps_card_s": maps["card_s"],
            "uv_maps_cpu_s": maps["cpu_s"],
            "uv_texels": int(m_c.sum()),
            "uv_mask_agree": float((m_c == m_h).mean()),
            "uv_pos_max_gap": float(np.abs(pos_c[both] - pos_h[both]).max()),
            "uv_pos_file_equal": bool(np.array_equal(written, pos_c)),
            "verts": v, "colors": c}


def color_train(root: str, data: dict, device: str = "cuda") -> dict:
    """ResBlkColorNet at full width (mlp_dim_color 513-1024-512-256-128-3,
    its filter on the 256^2 LR image) trained COLOR_STEPS Adam steps on
    TrainDataset items with num_sample_color COLOR_SAMPLES; the mean
    absolute color error at the ground-truth HR vertices, seen from view
    0, against their position code before and after."""
    import torch
    from surs_tpu_torch.config import SuRSConfig
    from surs_tpu_torch.data.datasets import TrainDataset
    from surs_tpu_torch.models.pifu_legacy import ResBlkColorNet
    from surs_tpu_torch.train import color

    base = full_width_config()
    cfg = SuRSConfig(dataroot=root, loadSize=base.loadSize,
                     num_sample_inout=0, num_sample_color=COLOR_SAMPLES,
                     sigma=COLOR_SIGMA, b_min=[-1.0] * 3, b_max=[1.0] * 3,
                     learning_rate=COLOR_LR, seed=SEED)
    ds = TrainDataset(cfg, "train", yaw_list=COLOR_YAWS,
                      contains_device=device)
    t0 = time.perf_counter()
    items = [ds.get_item(i % len(ds), np.random.default_rng(SEED + i))
             for i in range(COLOR_ITEMS)]
    item_s = (time.perf_counter() - t0) / COLOR_ITEMS
    net = ResBlkColorNet(mlp_dim_color=tuple(base.mlp_dim_color),
                         load_size=base.loadSize)
    state = color.create_color_state(
        net, cfg, torch.Generator().manual_seed(SEED), device)
    step = color.make_color_train_step(cfg.color_loss_type)
    view = items[0]

    def vertex_error():
        rgb = color.colorize_vertices(state.net, view["img_LR"][None],
                                      data["verts"], view["calib"][None])
        return float(np.abs(rgb - data["colors"]).mean())

    err0 = vertex_error()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(COLOR_STEPS):
        group = [items[(COLOR_BATCH * i + j) % COLOR_ITEMS]
                 for j in range(COLOR_BATCH)]
        batch = {"images": np.stack([it["img_LR"] for it in group]),
                 "points": np.stack([it["color_samples"] for it in group]),
                 "calibs": np.stack([it["calib"] for it in group]),
                 "rgbs": np.stack([it["rgbs"].T for it in group])}
        state, loss = step(state, batch)
        losses.append(float(loss))
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    return {"items": COLOR_ITEMS, "item_s": item_s,
            "samples": COLOR_SAMPLES, "batch": COLOR_BATCH,
            "steps": COLOR_STEPS, "step_s": steps_s / COLOR_STEPS,
            "loss_first10": float(np.mean(losses[:10])),
            "loss_last10": float(np.mean(losses[-10:])),
            "losses_finite": bool(np.isfinite(losses).all()),
            "vertex_err_step0": err0, "vertex_err": vertex_error()}


def color_eval(out_dir: str) -> dict:
    """The eval CLI (main()) with --with_color at full width and
    EVAL_RESOLUTION^3 on one PNG pair, the reference-style netG of the
    eval phase and a seeded reference netC; K1's launch count zeroed
    just before and read just after. The card's colors of the first
    COLOR_CPU_VERTS vertices against the port's RefColorNet on the CPU
    on the same inputs."""
    import contextlib
    import io

    import torch
    from surs_tpu_torch.apps import eval_surs
    from surs_tpu_torch.compat.torch_import import load_netC
    from surs_tpu_torch.ops.fused_mlp import fused_dual_mlp
    from surs_tpu_torch.recon.mesh_io import load_obj
    from surs_tpu_torch.train import color

    root = os.path.join(out_dir, "color_in")
    for sub in ("image_final", "mask_final"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    img, mask = synthetic_subject(0)
    write_png(os.path.join(root, "image_final", "subject0.png"), img)
    write_png(os.path.join(root, "mask_final", "subject0.png"), mask)
    netg, netc = (os.path.join(out_dir, n) for n in ("ref_netG", "ref_netC"))
    torch.save(reference_state_dict(), netg)
    torch.save(reference_netc(), netc)
    cfg = full_width_config(resolution=EVAL_RESOLUTION, residual=True,
                            with_color=True, load_netC_checkpoint_path=netc)
    args = ["--dataroot", root, "--name", "color", *cli_args(cfg),
            "--load_netG_checkpoint_path", netg, "--with_color",
            "--load_netC_checkpoint_path", netc, "--results_path", out_dir]
    seen, recs = {}, []
    colorize_ref, colorize_mesh = (color.colorize_vertices_ref,
                                   eval_surs.colorize_mesh)

    def spy_colorize(net, image, im_feat, verts, calib, **kw):
        seen.update(image=np.asarray(image), verts=verts,
                    calib=np.asarray(calib), feat_dtype=str(im_feat.dtype),
                    im_feat=im_feat.float().cpu().numpy())
        seen["rgb"] = colorize_ref(net, image, im_feat, verts, calib, **kw)
        return seen["rgb"]

    def spy_mesh(*a, **kw):
        torch.cuda.reset_peak_memory_stats()
        recs.append(colorize_mesh(*a, **kw))
        recs[-1]["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return recs[-1]

    log = io.StringIO()
    color.colorize_vertices_ref = spy_colorize
    eval_surs.colorize_mesh = spy_mesh
    try:
        torch.cuda.synchronize()
        fused_dual_mlp.launches = 0          # the color eval path starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            eval_surs.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fused_dual_mlp.launches   # the color eval path ends here
    finally:
        color.colorize_vertices_ref = colorize_ref
        eval_surs.colorize_mesh = colorize_mesh
    text = log.getvalue()
    p_hr = os.path.join(out_dir, "color", "subject0_HR.obj")
    hr_v, _ = load_obj(p_hr)
    cv, cf, cc = load_obj(p_hr[:-4] + "_color.obj", with_colors=True)
    n = min(COLOR_CPU_VERTS, hr_v.shape[0])
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_net, is_ref = load_netC(cfg, "cpu")
    t0 = time.perf_counter()
    cpu_rgb = color.colorize_vertices_ref(
        cpu_net, seen["image"], seen["im_feat"], seen["verts"][:n],
        seen["calib"], chunk=n)
    cpu_s = time.perf_counter() - t0
    rec = {"seconds": seconds, "k1_launches": launches,
           "netc_imported": "imported 40 netC tensors" in text,
           "netc_is_ref": is_ref, "im_feat_dtype": seen["feat_dtype"],
           "hr_vertices": int(hr_v.shape[0]),
           "color_vertices": int(cv.shape[0]),
           "color_faces": int(cf.shape[0]),
           "colors_in_unit": bool(cc is not None and cc.min() >= 0.0
                                  and cc.max() <= 1.0),
           "color_std": float(cc.std()) if cc is not None else 0.0,
           "card_vs_cpu_max_gap": float(np.abs(seen["rgb"][:n]
                                               - cpu_rgb).max()),
           "card_vs_cpu_vertices": n, "cpu_colorize_s": cpu_s,
           "tol": COLOR_CPU_TOL, **recs[0]}
    clear_objs(os.path.join(out_dir, "color"))
    return rec


def phase_color(out_dir: str, device: str = "cuda"):
    """The color branch at full width: the humanoid's dataset with its UV
    layout (render_uv_dataset on the card, held to the CPU renderer),
    ResBlkColorNet trained on its UV-sampled colors, and the eval CLI
    with --with_color at 512^3 through K1 and a reference netC."""
    import torch
    root = os.path.join(out_dir, "color_data")
    data = color_dataset(root, device)
    rec = {"phase": "color",
           "data": {k: v for k, v in data.items()
                    if k not in ("verts", "colors")}}
    rec["train"] = color_train(root, data, device)
    torch.cuda.empty_cache()
    rec["eval"] = color_eval(out_dir)
    torch.cuda.empty_cache()
    emit(rec)
    d, tr, ev = rec["data"], rec["train"], rec["eval"]
    if not (d["colors_read"] and d["uv_texels"] > 0
            and d["uv_mask_agree"] >= UV_MASK_SHARE
            and d["uv_pos_max_gap"] <= UV_POS_TOL and d["uv_pos_file_equal"]
            and tr["losses_finite"]
            and tr["loss_last10"] < tr["loss_first10"]
            and tr["vertex_err"] < tr["vertex_err_step0"]
            and ev["k1_launches"] > 0 and ev["netc_imported"]
            and ev["netc_is_ref"]
            and ev["color_vertices"] == ev["hr_vertices"] == ev["vertices"]
            and ev["hr_vertices"] > 0 and ev["colors_in_unit"]
            and ev["color_std"] > 0
            and ev["card_vs_cpu_max_gap"] <= COLOR_CPU_TOL):
        raise AssertionError(f"color failed: {rec}")
    return rec


# ------------------------------------- PRT, turntable, compute_points --
PRT_SUBJECT = "body0"            # train_data's first body: 327,680 faces
PRT_DIRS, PRT_GRID = 128, 96     # compute_prt's and render_dataset's defaults
PRT_YAW_STEP = 30                # 12 views at 512
PRT_CHECK_POINTS = 8_192         # voxel centres held to the plain version
PRT_CHUNK = 4_096                # compute_prt's vertex chunk
# visibility of one chunk, card against CPU from the same float32 inputs
# (tests/test_torch_prt.py's share against the JAX package's)
PRT_VIS_SHARE = 1e-3
# 4 frames of the 1.32 M-face mesh (about 0.7 s each): the app's whole
# path and a GIF, frame 0 held to the CPU
TURNTABLE_FRAMES, TURNTABLE_RES = 4, 256
COMPUTE_POINTS = 6_000


def prt_dataroot(out_dir: str, dataroot) -> str:
    """The on-disk dataset of train_data (written here when that phase
    did not run)."""
    if dataroot is None:
        dataroot = os.path.join(out_dir, "prt_data")
        write_train_dataset(dataroot)
    return dataroot


def phase_prt(out_dir: str, dataroot: str, device: str = "cuda"):
    """PRT shading on one training body (327,680 HR faces, 163,848
    vertices) with compute_prt's defaults (128 directions, a 96^3 grid):
    the voxel grid through the winding-number kernel, 8,192 of its points
    held to the plain version; the visibility of one 4,096-vertex chunk,
    card against CPU; the render_dataset CLI with --prt at 512, 12
    yaws, twice (the _prt.npy cache written, then reused), compute_prt
    on the whole mesh timed inside the first call (seconds, steps, peak
    memory); one PRT view, card against CPU. The winding number's launch count is zeroed before the
    CLI's first call and read after its second."""
    import torch
    from surs_tpu_torch.apps import render_dataset as render_cli
    from surs_tpu_torch.ops.containment import (THRESHOLD, winding_number,
                                                winding_number_ref)
    from surs_tpu_torch.recon.mesh_io import load_obj, save_obj_mesh
    from surs_tpu_torch.render import dataset_gen, prt
    from surs_tpu_torch.render.shading import vertex_normals

    t_phase = time.perf_counter()
    dev = torch.device(device)
    src = os.path.join(dataroot, "GEO", "OBJ", f"{PRT_SUBJECT}_HR.obj")
    root = os.path.join(out_dir, "prt")
    obj_dir = os.path.join(root, "GEO", "OBJ")
    os.makedirs(obj_dir)
    # the dataset's OBJ carries the writer's swapped winding (its faces
    # wind inward, which containment ignores); written once more through
    # the writer it winds outward, as a scan does, so the vertex normals
    # and PRT's rays point out of the body
    dst = os.path.join(obj_dir, f"{PRT_SUBJECT}_HR.obj")
    save_obj_mesh(dst, *load_obj(src))
    verts, faces = load_obj(dst)
    tri = verts[faces].astype(np.float64)
    volume = float(np.einsum("ij,ij->i", tri[:, 0], np.cross(
        tri[:, 1], tri[:, 2])).sum() / 6.0)
    rec = {"phase": "prt", "vertices": len(verts), "faces": len(faces),
           "signed_volume": volume, "n_dirs": PRT_DIRS, "grid": PRT_GRID}
    # the voxel grid, and 8,192 of its centres against the plain version
    torch.cuda.synchronize()
    winding_number.launches = 0
    t0 = time.perf_counter()
    occ, b_min, cell = prt.voxelize_occupancy(verts, faces, grid=PRT_GRID,
                                              device=dev)
    torch.cuda.synchronize()
    rec["voxelize_s"] = time.perf_counter() - t0
    rec["voxelize_launches"] = winding_number.launches
    pts, _, _ = prt.grid_points(verts, PRT_GRID)
    idx = np.random.default_rng(SEED).choice(len(pts), PRT_CHECK_POINTS,
                                             replace=False)
    tris = torch.from_numpy(np.ascontiguousarray(verts[faces])).to(dev)
    wp = winding_number_ref(torch.from_numpy(pts[idx]).to(dev), tris)
    band = ((wp.abs() - THRESHOLD).abs() <= WIND_TOL).cpu().numpy()
    plain = (wp.abs() > THRESHOLD).cpu().numpy()
    got = occ.reshape(-1)[torch.from_numpy(idx).to(dev)].cpu().numpy()
    rec["voxel_check"] = {"points": PRT_CHECK_POINTS,
                          "inside": int(plain.sum()),
                          "near_cut": int(band.sum()),
                          "label_mismatches": int(((got != plain)
                                                   & ~band).sum())}
    del tris, wp
    # one chunk's visibility, card against CPU, the same float32 inputs
    v_t = torch.from_numpy(verts).to(dev)
    n = vertex_normals(v_t, torch.from_numpy(faces).to(dev))[:PRT_CHUNK]
    t0f, t1f, n_steps = prt.march_plan(verts, cell, 2.0, None)
    orig = (v_t[:PRT_CHUNK] + t0f * n).cpu()
    dirs = torch.from_numpy(prt.fibonacci_sphere(PRT_DIRS))
    b_min_t = torch.from_numpy(b_min.astype(np.float32))
    inv_cell = torch.from_numpy((1.0 / cell).astype(np.float32))
    t0 = time.perf_counter()
    vis_card = prt.visibility(orig.to(dev), dirs.to(dev), occ,
                              b_min_t.to(dev), inv_cell.to(dev), t0f, t1f,
                              n_steps).cpu()
    rec["visibility_chunk_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vis_cpu = prt.visibility(orig, dirs, occ.cpu(), b_min_t, inv_cell,
                             t0f, t1f, n_steps)
    rec["visibility_chunk_cpu_s"] = time.perf_counter() - t0
    rec["visibility_check"] = {
        "rays": vis_cpu.numel(), "occluded_share":
            float((~vis_cpu).float().mean()),
        "differ_share": float((vis_card != vis_cpu).float().mean())}
    rec["n_steps"] = n_steps
    del occ, v_t, n
    # the CLI twice: the cache written, then reused; compute_prt on the
    # whole mesh timed inside the first call (seconds, peak memory)
    argv = ["--dataroot", root, "--loadSize", "512", "--yaw_step",
            str(PRT_YAW_STEP), "--subjects", PRT_SUBJECT, "--prt",
            "--device", device]
    cache = os.path.join(obj_dir, f"{PRT_SUBJECT}_prt.npy")
    real_compute, timed = dataset_gen.compute_prt, []

    def compute_prt(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real_compute(*a, **kw)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 1e9))
        return out

    dataset_gen.compute_prt = compute_prt
    try:
        torch.cuda.synchronize()
        winding_number.launches = 0      # the --prt path starts here
        calls = []
        for _ in range(2):
            t0 = time.perf_counter()
            render_cli.main(argv)
            torch.cuda.synchronize()
            calls.append({"seconds": time.perf_counter() - t0,
                          "cache_mtime_ns": os.stat(cache).st_mtime_ns})
        launches = winding_number.launches   # the --prt path ends here
    finally:
        dataset_gen.compute_prt = real_compute
    (rec["compute_prt_s"], rec["compute_prt_peak_gb"]), = timed
    cached = np.load(cache)
    renders = sorted(os.listdir(os.path.join(root, "RENDER", PRT_SUBJECT)))
    rec["transfer_finite"] = bool(np.isfinite(cached).all())
    rec["cli"] = {"calls_s": [c["seconds"] for c in calls],
                  "cache_reused": calls[0]["cache_mtime_ns"]
                  == calls[1]["cache_mtime_ns"],
                  "compute_prt_calls": len(timed),
                  "winding_launches": launches, "renders": len(renders),
                  "cache_shape": list(cached.shape)}
    # one PRT view, card against CPU
    rec["view_check"] = check_renders(verts, faces, 512, [0], prt=cached,
                                      device=device)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    vc, cli = rec["view_check"], rec["cli"]
    if not (volume > 0 and rec["voxel_check"]["label_mismatches"] == 0
            and rec["voxel_check"]["inside"] > 0
            and rec["visibility_check"]["differ_share"] <= PRT_VIS_SHARE
            and 0 < rec["visibility_check"]["occluded_share"] < 1
            and rec["transfer_finite"] and cli["cache_reused"]
            and cli["renders"] == 360 // PRT_YAW_STEP
            and launches == rec["voxelize_launches"] > 0
            and cached.shape == (len(verts), 9)
            and vc["mask_agree"] >= ACC_MASK_SHARE
            and vc["rgb_max_lsb"] <= ACC_RGB_LSB
            and vc["min_mask_pixels"] > 0):
        raise AssertionError(f"prt failed: {rec}")
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return rec


def phase_turntable(obj_path: str, device: str = "cuda"):
    """The render_turntable app on a served 512^3 HR mesh: 4 frames at
    256 into a GIF (s a frame, the GIF's bytes), then frame 0 rendered on
    the card against the CPU."""
    import torch
    from PIL import Image
    from surs_tpu_torch.apps import render_turntable
    from surs_tpu_torch.recon.mesh_io import load_obj

    t_phase = time.perf_counter()
    gif = os.path.splitext(obj_path)[0] + ".gif"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_turntable.main([obj_path, gif, "--frames",
                           str(TURNTABLE_FRAMES), "--res",
                           str(TURNTABLE_RES), "--device", device])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with Image.open(gif) as im:
        n_frames, size = im.n_frames, im.size
    verts, faces = load_obj(obj_path)
    rec = {"phase": "turntable", "mesh": os.path.basename(obj_path),
           "faces": len(faces), "frames": n_frames, "res": TURNTABLE_RES,
           "seconds": seconds, "s_per_frame": seconds / TURNTABLE_FRAMES,
           "gif_bytes": os.path.getsize(gif),
           "frame_check": check_renders(verts, faces, TURNTABLE_RES, [0.0],
                                        device=device)}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    fc = rec["frame_check"]
    if not (n_frames == TURNTABLE_FRAMES
            and size == (TURNTABLE_RES, TURNTABLE_RES)
            and fc["mask_agree"] >= ACC_MASK_SHARE
            and fc["rgb_max_lsb"] <= ACC_RGB_LSB
            and fc["min_mask_pixels"] > 0):
        raise AssertionError(f"turntable failed: {rec}")
    os.remove(gif)
    return rec


def phase_compute_points(dataroot: str, device: str = "cuda"):
    """The compute_points app on the on-disk dataset (2 bodies, 327,680
    HR / 20,480 LR faces) at 6,000 points and train_data's sigma; the
    winding number's launch count zeroed just before and read just
    after (2 a subject)."""
    import contextlib
    import io

    import torch
    from surs_tpu_torch.apps import compute_points
    from surs_tpu_torch.ops.containment import winding_number

    log = io.StringIO()
    torch.cuda.synchronize()
    winding_number.launches = 0          # the app's path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        counts = compute_points.main(
            ["--dataroot", dataroot, "--num_sample_inout",
             str(COMPUTE_POINTS), "--sigma", "5.0", "--device", device])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = winding_number.launches   # the app's path ends here
    lines = log.getvalue().splitlines()
    rec = {"phase": "compute_points", "seconds": seconds,
           "winding_launches": launches, "lines": lines,
           "flips": {k: list(v) for k, v in counts.items()}}
    emit(rec)
    if not (len(counts) == len(DATA_STRETCH)
            and launches == 2 * len(counts)
            and all(n == COMPUTE_POINTS and 0 < a + b < n
                    for a, b, n in counts.values())
            and lines[-1].startswith("TOTAL: ")):
        raise AssertionError(f"compute_points failed: {rec}")
    return rec


# ----------------------------------------------------------- profile --
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path: str, kernel_keys: dict) -> dict:
    """A Chrome trace of utils/profiling.Profiler: its bytes, events,
    device events (kernels, copies, sets), the launches of the kernels
    whose names hold each of ``kernel_keys``' values, and the card's busy
    share of the traced window: the union of the device events'
    intervals over the span from the first event to the last."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, -np.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    start = min(float(e["ts"]) for e in events)
    stop = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    regions = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            regions[e["name"]] = regions.get(e["name"], 0.0) \
                + float(e.get("dur", 0)) / 1e3
    launches = {k: sum(1 for e in events if e.get("cat") == "kernel"
                       and key in e.get("name", ""))
                for k, key in kernel_keys.items()}
    return {"bytes": os.path.getsize(path), "events": len(events),
            "device_events": len(dev), "kernel_launches": launches,
            "window_ms": (stop - start) / 1e3, "device_busy_ms": busy / 1e3,
            "busy_share": busy / (stop - start),
            "device_span_busy_share": (busy / (dev[-1][1] - dev[0][0])
                                       if dev else 0.0),
                        "regions_ms": regions}


def phase_profile(out_dir: str, device: str = "cuda"):
    """train(cfg, max_iters=3) at the train phase's configuration with
    profile_dir set, and one 512^3 mono SuRSService.reconstruct inside a
    Profiler with its stages annotated (encode, evaluate, extract,
    write); for each trace its size, device events, K1 / K2 launches
    (wrapper counts zeroed just before and read just after, and kernels
    in the trace) and the card's busy share of the traced window."""
    import dataclasses

    import torch
    from surs_tpu_torch.data.loader import DataLoader
    from surs_tpu_torch.ops.fused_mlp import (fused_dual_mlp,
                                              fused_dual_mlp_train)
    from surs_tpu_torch.recon import pipeline
    from surs_tpu_torch.serve import SuRSService
    from surs_tpu_torch.train.loop import train
    from surs_tpu_torch.utils.profiling import Profiler, annotate

    t_phase = time.perf_counter()
    keys = {"k1": "fused_dual_mlp_wgmma_kernel",
            "k2": "fused_dual_mlp_train"}
    root = os.path.join(out_dir, "profile")
    cfg = dataclasses.replace(train_config(root),
                              profile_dir=os.path.join(root, "train_trace"))
    items = train_items(cfg)
    loader = DataLoader(RepeatedItems(items, 3), batch_size=TRAIN_BATCH,
                        shuffle=False)
    torch.cuda.synchronize()
    fused_dual_mlp_train.launches = 0    # the traced steps start here
    out = train(cfg, loader, max_iters=3, device=device)
    torch.cuda.synchronize()
    k2 = fused_dual_mlp_train.launches   # and end here
    (trace,) = os.listdir(cfg.profile_dir)
    step = trace_summary(os.path.join(cfg.profile_dir, trace), keys)
    step.update(steps=out["iters"], k2_wrapper_launches=k2,
                wall_s=out["wall_sec"])
    # one request, its stages annotated
    service = SuRSService(full_width_config(), device=device)
    service.warmup((256, 256))
    rec_, write = service.rec, pipeline.save_obj_mesh
    encode, evaluate, extract = rec_.encode, rec_.evaluate, \
        rec_.extract_pair

    def annotated(name, fn):
        def call(*a, **kw):
            with annotate(name):
                return fn(*a, **kw)
        return call

    def extract_pair(*a, **kw):
        gen = extract(*a, **kw)
        while True:
            with annotate("extract"):
                item = next(gen, None)
            if item is None:
                return
            yield item

    rec_.encode = annotated("encode", encode)
    rec_.evaluate = annotated("evaluate", evaluate)
    rec_.extract_pair = extract_pair
    pipeline.save_obj_mesh = annotated("write", write)
    img, mask = synthetic_subject(0)
    prof = Profiler(os.path.join(root, "request_trace"))
    try:
        torch.cuda.synchronize()
        fused_dual_mlp.launches = 0      # the traced request starts here
        t0 = time.perf_counter()
        with prof:
            service.reconstruct(img, mask, "profiled", root)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1 = fused_dual_mlp.launches     # and ends here
    finally:
        pipeline.save_obj_mesh = write
        del rec_.encode, rec_.evaluate, rec_.extract_pair
    request = trace_summary(prof.last_trace, keys)
    request.update(seconds_with_trace_export=seconds,
                   k1_wrapper_launches=k1)
    del service
    torch.cuda.empty_cache()
    rec = {"phase": "profile", "train": step, "request": request,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not (step["steps"] == 3 and k2 == 3 * cfg.num_stack_lr
            and step["kernel_launches"]["k2"] > 0
            and request["kernel_launches"]["k1"] > 0 and k1 > 0
            and 0 < step["busy_share"] <= 1
            and 0 < request["busy_share"] <= 1
            and set(request["regions_ms"]) >= {"encode", "evaluate",
                                               "extract", "write"}):
        raise AssertionError(f"profile failed: {rec}")
    shutil.rmtree(root)
    return rec


# parallel: (a) NCCL at world size 1 in this process, (b) two gloo ranks
# sharing the one card (NCCL refuses two ranks on one device)
PAR_RESOLUTION = 512             # (a): the point octree
# (a): the dense chain (at world size 1 one slab holds the whole field:
# 861,574 crossing points, past the JAX package's 21-bit face format,
# which the port does not keep), the subjects, the CLI; (b)
PAR_RESOLUTION_2 = 256
# a data-parallel step against the single-device step on the whole
# batch: the losses (tests/test_parallel.py's rtol on total) and the
# whole float32 update (||d_dp - d_1|| / ||d_1||: the split batch sums
# its gradients in another order; 2.6e-4 at the CPU tests' size)
PAR_LOSS_TOL = 1e-4
PAR_UPDATE_TOL = 1e-3
PAR_DEADLINE_S = 300


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def parallel_spec(resolution: int, subjects, parts) -> dict:
    """parallel/checks.run's spec at full width: subject 0, the train
    phase's batch (2 items x 6,000 points) and, for the step, a float32
    trunk under SGD; every part against its single-device counterpart."""
    from surs_tpu_torch.data.loader import collate
    from surs_tpu_torch.serve import normalize_image
    from surs_tpu_torch.train.loop import batch_host_arrays
    cfg = full_width_config(resolution=resolution, batch_size=TRAIN_BATCH,
                            num_sample_inout=TRAIN_POINTS)
    arr, mask = normalize_image(*subjects[0])
    return dict(cfg={f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)},
                parts=parts, image=arr, mask=mask, images=arr,
                reference=True, fused=True,
                step_cfg={"dtype": "float32", "optimizer": "SGD",
                          "momentum": 0.0, "learning_rate": 1e-3},
                batch=batch_host_arrays(collate(train_items(cfg)),
                                        quantize_images=True))


def parallel_checks(res: dict, resolution: int) -> dict:
    """One rank's parts (checks.run's result) -> launches, seconds, peak
    MiB and the comparisons with the single-device runs: the dense
    meshes as quantised sets (rank 0), the octrees bit for bit, the
    step's losses and update."""
    out = {}
    for part, r in res.items():
        if part == "rank":
            continue
        o = {k: r.get(k) for k in ("launches", "seconds", "peak_mib")}
        if part == "dense" and r["meshes"] is not None:
            got, ref = r["meshes"], r["reference"]

            def grid(v):
                return (np.asarray(v, np.float64) + 0.5) * resolution
            o["faces"] = [int(got[1].shape[0]), int(got[3].shape[0])]
            o["same_as_single"] = [
                same_mesh(grid(got[i]), got[i + 1], grid(ref[i]),
                          ref[i + 1]) for i in (0, 2)]
        if part in ("octree", "batch"):
            o["bitwise"] = r["bitwise"]
        if part == "batch":
            o["faces"] = [int(m[1].shape[0]) for m in r["meshes"]]
        if part == "step":
            o["loss_rel_err"] = max(
                abs(r["metrics"][k] - r["reference"][k])
                / max(abs(r["reference"][k]), 1e-12)
                for k in r["metrics"])
            o["update_rel_err"] = r["update_rel_err"]
            o["total"] = r["metrics"]["total"]
        out[part] = o
    return out


def parallel_ok(parts: dict) -> bool:
    for part, o in parts.items():
        if not o["launches"]:
            return False
        if "same_as_single" in o and not (all(o["same_as_single"])
                                          and min(o["faces"]) > 0):
            return False
        if part in ("octree", "batch") and not o["bitwise"]:
            return False
        if part == "step" and not (o["loss_rel_err"] <= PAR_LOSS_TOL
                                   and o["update_rel_err"]
                                   <= PAR_UPDATE_TOL):
            return False
    return True


def phase_parallel(out_dir: str, subjects):
    """The multi-device paths (surs_tpu_torch/parallel/). (a) NCCL at
    world size 1 in this process, full width: the dense subject through
    K3 chained into the sharded extraction (cubes) against
    eval_grid_dense_cols + the card's cubes as quantised sets, at 256^3
    (one slab of 861,574 crossing points); the point-sharded mono octree
    at 512^3 through K1 against the unsharded one, bit for bit;
    ShardedReconstructor on the subject at 256^3; the data-parallel
    fused step (K2) against the single-device fused step; the eval CLI
    with --mc_backend sharded at 256^3. (b) Two ranks on the one card:
    first over NCCL (its error printed), then over gloo (the collectives
    of CUDA tensors that gloo lacks go through pinned host memory): the
    dense subject at 256^3 with the extraction, the point octree at
    256^3 and the step at batch 2 (a row a rank), each against the
    single-device result. Every part's launches of its
    kernel are zeroed just before it and read just after (> 0)."""
    import contextlib
    import datetime
    import io

    import torch
    import torch.distributed as dist
    from surs_tpu_torch.apps.eval_surs import main as eval_main
    from surs_tpu_torch.ops import fused_mlp as fm
    from surs_tpu_torch.parallel import checks, make_mesh
    from surs_tpu_torch.parallel.launch import spawn

    rec = {"phase": "parallel", "card": card()}
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(dir=out_dir)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(store, "pg"), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device_type="cuda")
        a = {"world": 1, "backend": "nccl",
             "dense_resolution": PAR_RESOLUTION_2}
        res = checks.run(mesh, parallel_spec(
            PAR_RESOLUTION, subjects, ["octree", "step"]))
        a["parts"] = parallel_checks(res, PAR_RESOLUTION)
        # ShardedReconstructor meshes with the host library's tets, as
        # the JAX package does: 17.7 M faces at 512^3 without pruning
        res = checks.run(mesh, parallel_spec(
            PAR_RESOLUTION_2, subjects, ["dense", "batch"]))
        a["parts"].update(parallel_checks(res, PAR_RESOLUTION_2))
        del res
        torch.cuda.empty_cache()
        # the eval CLI, --mc_backend sharded, inside the NCCL group
        root = os.path.join(out_dir, "par_in")
        for sub in ("image_final", "mask_final"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        img, mask = subjects[0]
        write_png(os.path.join(root, "image_final", "par.png"), img)
        write_png(os.path.join(root, "mask_final", "par.png"), mask)
        # 256^3: a 512^3 served field's one slab can hold more active
        # cells than the extractor's default max_cells_shard, as in the
        # JAX package, and the CLI passes no capacity
        cfg = full_width_config(resolution=PAR_RESOLUTION_2)
        fm.fused_dual_mlp.launches = 0
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            eval_main(["--dataroot", root, "--name", "par", *cli_args(cfg),
                       "--mc_backend", "sharded", "--results_path",
                       out_dir])
        torch.cuda.synchronize()
        objs = [os.path.join(out_dir, "par", f"par_{t}.obj")
                for t in ("HR", "LR")]
        a["cli"] = {"seconds": time.perf_counter() - t1,
                    "launches": fm.fused_dual_mlp.launches,
                    "obj_bytes": [os.path.getsize(p) for p in objs]}
        shutil.rmtree(os.path.join(out_dir, "par"))
    finally:
        dist.destroy_process_group()
    a["seconds"] = time.perf_counter() - t0
    rec["a"] = a
    torch.cuda.empty_cache()
    # (b) two ranks on one card
    t0 = time.perf_counter()
    try:
        spawn(checks.run, 2, backend="nccl", device="cuda",
              args=(dict(cfg={"loadSize": 32, "num_stack_lr": 1},
                         parts=[]),), deadline=120, store_dir=out_dir)
        nccl = "ran"
    except RuntimeError as err:
        # rank 0's exception and NCCL's own reason, once
        lines = [ln.strip() for ln in str(err).splitlines()
                 if any(k in ln for k in ("Error:", "Duplicate GPU",
                                          "ncclInvalidUsage"))]
        nccl = " | ".join(dict.fromkeys(lines))[:600] or str(err)[-400:]
    ranks = spawn(checks.run, 2, backend="gloo", device="cuda",
                  args=(parallel_spec(PAR_RESOLUTION_2, subjects,
                                      ["dense", "octree", "step"]),),
                  n_points=2, deadline=PAR_DEADLINE_S, store_dir=out_dir)
    rec["b"] = {"world": 2, "backend": "gloo", "nccl_two_ranks": nccl,
                "ranks": [parallel_checks(r, PAR_RESOLUTION_2)
                          for r in ranks],
                "seconds": time.perf_counter() - t0}
    emit(rec)
    ok = (parallel_ok(a["parts"]) and a["cli"]["launches"] > 0
          and min(a["cli"]["obj_bytes"]) > 0
          and all(parallel_ok(r) for r in rec["b"]["ranks"])
          and "same_as_single" in rec["b"]["ranks"][0]["dense"])
    if not ok:
        raise AssertionError(f"parallel failed: {rec}")
    return rec


PHASES = ("build", "k1", "k2", "k3", "k4", "k5", "containment", "serve",
          "check", "stages", "native_io", "tets", "cli", "eval", "turntable",
          "color", "mono_f32", "dense", "runs", "train", "train_check", "configs",
          "train_data", "precompute", "prt", "compute_points", "profile",
          "parallel", "accuracy")
# run only when named in --phases
EXTRA_PHASES = ("train_profile", "serve_profile")


def print_card() -> None:
    print(card(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    phases = ap.parse_args().phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1 = phase_k1() if "k1" in phases else None
    k2 = phase_k2() if "k2" in phases else None
    k3 = phase_k3() if "k3" in phases else None
    k4 = phase_k4() if "k4" in phases else None
    subjects = [synthetic_subject(i) for i in range(3)]
    k5 = phase_k5(subjects) if "k5" in phases else None
    cont = phase_containment() if "containment" in phases else None
    serve = mono = dense = runs = tr = fed = None
    with tempfile.TemporaryDirectory() as out_dir:
        if "serve" in phases or "tets" in phases:
            service, subjects, serve = phase_serve(out_dir)
            if "check" in phases:
                phase_check(service, subjects)
            if "stages" in phases:
                phase_stages(service, subjects, out_dir)
            if "native_io" in phases:
                phase_native_io(service, subjects, out_dir)
            if "tets" in phases:
                phase_tets(service, subjects, out_dir)
            del service
            clear_objs(out_dir)
            torch.cuda.empty_cache()
        if "cli" in phases:
            phase_cli(out_dir)
        if "eval" in phases or "turntable" in phases:
            kept = os.path.join(out_dir, "turntable_HR.obj")
            phase_eval(out_dir, keep_obj=kept if "turntable" in phases
                       else None)
            if "turntable" in phases:
                phase_turntable(kept)
                os.remove(kept)
        if "color" in phases:
            phase_color(out_dir)
            torch.cuda.empty_cache()
        if "serve_profile" in phases:
            phase_serve_profile(subjects)
        if "mono_f32" in phases:
            mono = phase_mono_f32(out_dir, subjects)
        if "dense" in phases:
            dense = phase_dense(out_dir, subjects)
        if "runs" in phases:
            runs = phase_runs(out_dir, subjects, serve)
        if "train" in phases:
            cfg, items, trained, tr = phase_train(out_dir)
            if "train_check" in phases:
                phase_train_check(cfg, items, trained)
            if "train_profile" in phases:
                phase_train_profile(cfg, items, trained)
            del trained
            torch.cuda.empty_cache()
        if "configs" in phases:
            phase_configs(out_dir)
            torch.cuda.empty_cache()
        dataroot = None
        if "train_data" in phases or "precompute" in phases:
            dataroot, argv, fed = phase_train_data(out_dir)
            if "precompute" in phases:
                phase_precompute(out_dir, dataroot, argv, fed)
        if "prt" in phases or "compute_points" in phases:
            dataroot = prt_dataroot(out_dir, dataroot)
            if "prt" in phases:
                phase_prt(out_dir, dataroot)
            if "compute_points" in phases:
                phase_compute_points(dataroot)
        if "profile" in phases:
            phase_profile(out_dir)
        if "parallel" in phases:
            phase_parallel(out_dir, subjects)
            torch.cuda.empty_cache()
        if "accuracy" in phases:
            phase_accuracy(out_dir)
    emit({"orbax_import": "not run on the card: reading the JAX package's "
                          "orbax train states needs tensorstore and a "
                          "directory that JAX wrote, and this machine has "
                          "neither; tests/test_torch_orbax.py holds the "
                          "reader to JAX's CheckpointManager on the CPU"})
    if set(phases) != set(PHASES):
        print_card()
        emit({"partial": phases})
        return 0
    main_rec = k1[("bfloat16", N_MAIN, False)]
    f32_rec = k1[("float32", N_MAIN, False)]
    k2_rec = k2[N_TRAIN]
    emit({"kernels": [{
        "name": "fused_dual_mlp",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_dual_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:228",
        "launches": serve["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for (d, _, _), r in k1.items()
                           if d == "bfloat16"),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_points_tf32x3",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_cols_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:228 (float32 weights)",
        "launches": mono["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for (d, _, _), r in k1.items()
                           if d == "float32"),
        "ms": f32_rec["ms"],
        "plain_ms": f32_rec["plain_ms"],
        "bound_ms": f32_rec["bound_ms"],
        "bound_by": f32_rec["bound_by"],
        "bound_fma_ms": f32_rec["bound_fma_ms"],
        "cols_terms_ms": f32_rec["cols_terms_ms"],
        "cuda_launches_per_call": f32_rec["k1_kernel_launches_per_call"],
        "per": "one 50,000-point call (the pre-pass and the chain)",
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_train",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_train_tf32.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:313",
        "launches": tr["k2_launches"],
        "max_abs_err": max(r["max_abs_err"] for n, r in k2.items()
                           if isinstance(n, int)),
        "ms": k2_rec["ms"],
        "plain_ms": k2_rec["plain_ms"],
        "bound_ms": k2_rec["bound_ms"],
        "bound_by": k2_rec["bound_by"],
        "bound_fma_ms": k2_rec["bound_fma_ms"],
        "cuda_launches_per_call": k2_rec["k2_kernel_launches_per_call"],
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_cols",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_cols_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:576",
        "launches": dense["k3_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k3["checks"]
                           if r["dtype"] == "bfloat16"),
        "ms": k3["grid"]["ms"],
        "plain_ms": k3["grid"]["plain_ms"],
        "bound_ms": k3["grid"]["bound_ms"],
        "bound_by": k3["grid"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_runs",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_cols_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:728",
        "launches": runs["k4_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k4["checks"]
                           if r["dtype"] == "bfloat16"),
        "ms": k4["main"]["ms"],
        "plain_ms": k4["main"]["plain_ms"],
        "bound_ms": k4["main"]["bound_ms"],
        "bound_by": k4["main"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_cols_tf32x3",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_cols_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:576 (float32 weights)",
        "launches": dense["float32"]["k3_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k3["checks"]
                           if r["dtype"] == "float32"),
        "ms": k3["slice_f32"]["ms_slice"],
        "plain_ms": k3["slice_f32"]["plain_ms_slice"],
        "bound_ms": k3["slice_f32"]["bound_ms_slice"],
        "bound_by": k3["slice_f32"]["bound_by_slice"],
        "bound_fma_ms": k3["slice_f32"]["bound_fma_ms_slice"],
        "grid_ms": k3["grid_f32"]["ms"],
        "grid_bound_ms": k3["grid_f32"]["bound_ms"],
        "grid_bound_fma_ms": k3["grid_f32"]["bound_fma_ms"],
        "per": "one 1,024-column slice of the 512^3 grid x 512 depths "
               "(grid_*: the whole grid; the plain version timed at the "
               "slice only)",
        "library_ms": None,
    }, {
        "name": "fused_dual_mlp_runs_tf32x3",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/fused_cols_mlp.cu",
        "replaces": "surs_tpu/ops/fused_mlp.py:728 (float32 weights)",
        "launches": runs["float32"]["k4_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k4["checks"]
                           if r["dtype"] == "float32"),
        "ms": k4["main_f32"]["ms"],
        "plain_ms": k4["main_f32"]["plain_ms"],
        "bound_ms": k4["main_f32"]["bound_ms"],
        "bound_by": k4["main_f32"]["bound_by"],
        "bound_fma_ms": k4["main_f32"]["bound_fma_ms"],
        "library_ms": None,
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/row_gather.cu",
        "replaces": "benchmarks/vmem_gather_probe.py:79",
        "launches": k5["launches"],
        "max_abs_err": max(r[f"{v}_max_abs_err"] for r in k5["checks"]
                           for v in ("vec", "loop")),
        "ms": k5["timing"]["cold_ms"]["vec"],
        "cold_clean_ms": k5["timing"]["cold_clean_ms"]["vec"],
        "loop_ms": k5["timing"]["cold_ms"]["loop"],
        "loop_cold_clean_ms": k5["timing"]["cold_clean_ms"]["loop"],
        "plain_ms": k5["timing"]["cold_ms"]["plain"],
        "bound_ms": k5["timing"]["bound_ms"],
        "bound_by": k5["timing"]["bound_by"],
        "library_ms": k5["timing"]["cold_ms"]["index_select"],
        "library_cold_clean_ms":
            k5["timing"]["cold_clean_ms"]["index_select"],
    }]})
    emit({"port_kernels": [{
        "name": "winding_number",
        "route": "cuda",
        "source": "surs_tpu_torch/csrc/winding_number.cu",
        "replaces": "winding_number, surs_tpu/ops/containment.py:47-67 "
                    "(a lax.scan that XLA fuses; no pallas_call)",
        "launches": fed["launches"]["winding_number"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in cont["cases"].values()),
        "ms": cont["timing"]["ms"],
        "plain_ms": cont["timing"]["plain_ms"],
        "bound_ms": cont["timing"]["bound_ms"],
        "bound_by": cont["timing"]["bound_by"],
        "library_ms": None,
        "sass_per_pair": cont["timing"].get("sass_per_pair"),
        "issue_ms": cont["timing"].get("issue_ms"),
        "per": "one training item: 25,500 points against the HR (327,680 "
               "faces) and the LR (20,480) mesh",
    }]})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
