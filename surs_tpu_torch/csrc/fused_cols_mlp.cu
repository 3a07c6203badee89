// Kernels K3 and K4: the column-shared dual occupancy MLP on Hopper
// (sm_90a).
//
// K3 replaces the Pallas kernel `fused_dual_mlp_cols` (body `_kernel_cols`)
// of surs_tpu/ops/fused_mlp.py: per grid column, features sampled once
// (x_lr [Ncol, C_lr], x_hr [Ncol, C_hr]) and Z depth samples zf [Z] ->
// (pred_hr, pred_lr) [Ncol, Z]. K4 replaces `fused_dual_mlp_runs` (body
// `_kernel_runs`): per dirty 8-deep z-window of a column, its features,
// its depth offset kf [NR] and the shared in-window depths zt [8] ->
// [NR, 8]; depth t of window w has the depth feature kf[w] + zt[t].
//
// Both compute the TPU's `_cols_chain`. Every layer that reads the input
// (0 and the residual layers 2-4) splits it into a per-column term and a
// per-depth term:
//   layer_i = x_col.W_feat (+ kf * w_z) + b    once per column / window
//           + round(z * w_z)                   rank-1 in depth
//           + h.W_h                            per depth sample (i > 0)
//           + pred_lr * w_pred                 fine MLP only, unrounded
// Layer 0 has no per-sample product at all; layer 1 is h-only.
// Rounding follows the TPU kernel: the features are cast to the compute
// dtype before their product, the depth term is rounded after it, kf and
// pred_lr are not rounded; accumulation, bias, leaky-ReLU and sigmoid are
// float32; every activation is rounded before the next product.
//
// What bounds it: per depth sample only the hidden chain remains, about
// 2.75 MFLOP for both MLPs against 8 bytes of output: one dense 512^3 grid
// (K3) is 370 TFLOP, bound 374 ms by the bf16 tensor cores; one K4 chunk of
// 32,768 windows is 780.8 GFLOP, bound 0.789 ms. In float32 the same work
// is three TF32 products per product (3xTF32, below): bound 2,242 ms a grid
// and 4.73 ms a chunk at the TF32 peak (5,522 and 11.65 by float32 FMA).
// What stands in the way is the weight stream: every tile of rows reads
// all hidden weights of both MLPs from L2, 2.75 MB in bf16, 11 MB as
// float32 hi + lo.
//
// bf16, the design (one launch of each kernel per chunk of columns):
//   * cols_terms_bf16_kernel, the pre-pass: the column terms of every
//     input-reading layer of both MLPs, C [n, 2 x 1412] float32 =
//     round([x_lr | x_hr]) . W_feat (+ kf * w_z) + b, a [n, 320] x
//     [320, 2824] product on the tensor cores (mma.sync), once per column
//     or window;
//   * fused_dual_mlp_{cols,runs}_wgmma_kernel: a persistent block of two
//     consumer warpgroups (64 rows each: a tile of 128 rows, 128 depths of
//     one column for K3, 16 windows x 8 depths for K4) and a producer
//     warpgroup, whose registers go to the consumers (setmaxnreg). The
//     producer streams the hidden weights, repacked by
//     ops/fused_mlp.py:prepare_cols_weights into 16 KB stages already in
//     the 128-byte-swizzled wgmma layout, through a 4-slot ring in shared
//     memory with cp.async.bulk on mbarriers; each weight byte read from
//     L2 feeds 128 rows. Layer 0 is never stored: its activations,
//     leaky(C0 + round(z w_z0) + pred w_p0), are built slice by slice in
//     k as layer 1's A fragments in registers (the C0 slice travels in the
//     ring with the weights). Layer 1 goes to shared memory (h1, [128, 512]
//     bf16, swizzled) as layer 2's A; layer 2's epilogue leaves its output
//     in registers as layer 3's A; layer 3's epilogue ends in the last
//     layer's 128-wide dot product, reduced with shuffles. Every epilogue
//     works on the wgmma accumulators in registers.
//
// float32, the design (3xTF32, as K2 in fused_train_tf32.cu): every
// operand v is split into hi = tf32_rna(v) and lo = tf32_rna(v - hi),
// tf32_rna(v) = (bits(v) + 0x1000) & 0xFFFFE000 (ops/fused_mlp.py:
// tf32_split), and a product a.b becomes lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
// in float32. The tensor cores add into their accumulator with a
// truncating alignment, so each 32-k stage is summed into a fresh partial
// that the CUDA cores add to a float32 sum (layer 2: each 128-k chunk).
// No activation is rounded between layers: the chain is float32 to about
// 2^-21 a product, as JAX's compute_dtype=float32.
//   * cols_terms_tf32x3_kernel, the pre-pass: C as above in 3xTF32 on
//     mma.sync m16n8k8 (W_feat pre-split into hi and lo by
//     prepare_cols_weights; x split as its fragments are loaded);
//   * fused_dual_mlp_{cols,runs}_tf32x3_kernel: the bf16 chain's block
//     (two consumer warpgroups of 64 rows, a producer warpgroup, a
//     persistent grid), A from registers (wgmma m64n128k8 tf32 with
//     register A). A float32 h1 of 128 rows would take 256 KB of shared
//     memory, so it is never whole: layer 1 runs in four chunks of 128
//     outputs, each chunk's output (64 values a thread) goes straight into
//     layer 2 as 128 k of its A, and layer 2's [128, 256] float32 sums live
//     in shared memory (128 KB, each thread its own 128 values). The A
//     fragments come from the accumulators without leaving the thread: the
//     accumulator gives a thread columns 2t and 2t + 1 of each 8-column
//     block where tf32's A fragment wants k t and t + 4, so every hidden
//     weight block is packed with its k rows permuted within each 8 (k t
//     <- row 2t, k t + 4 <- row 2t + 1; ops/fused_mlp.py:TF32_KPERM). The
//     producer streams the hidden weights of both MLPs as 168 stages an
//     MLP of [32 k x 128 n] hi then lo (32 KB, 128-byte swizzle) through a
//     3-slot ring: each weight byte read from L2 feeds 128 rows, 11 MB a
//     tile. The column terms, depth rows and biases are read through L1.
//
// The float32 K1 (the Pallas kernel `fused_dual_mlp`, body `_kernel`,
// with float32 weights) is the same two kernels with one point a row: a
// point is a K4 window of one depth. The pre-pass takes the point's 320
// features, and its depth (input column 320) as kf, so kf . w_z is in
// every term; fused_dual_mlp_points_tf32x3_kernel then runs the chain
// over tiles of 128 points, each row reading its own terms, with no
// in-chain depth, pred_lr entering the fine MLP unrounded as float32
// (K1's float32 plain version rounds nothing). Bound: 228.25 GFLOP per
// 50,000 points, 1.38 ms as 3xTF32 at the TF32 peak (3.41 ms by float32
// FMA). bf16 K1's design, the input tile in shared memory, does not fit
// float32: X [128, 320] is 160 KB beside the ring and layer 2's sums, and
// layer 1's four chunks would rebuild layer 0 four times.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrappers are ops/fused_mlp.py:fused_dual_mlp_cols
// and fused_dual_mlp_runs (and column_terms, either pre-pass alone), and
// for float32 weights fused_dual_mlp.

#include "wg_chain.cuh"

namespace {

constexpr int FEAT = 320;         // feature rows of the x block (lr + hr)
constexpr int WIN = 8;            // depths per window (K4)
// the column terms of one MLP: the outputs of layers 0, 2, 3 and 4
constexpr int COL0 = 0, COL2 = D0, COL3 = D0 + D2, COL4 = D0 + D2 + D3;
constexpr int CW = COL4 + 1;      // 1409
constexpr int CWP = CW + 3;       // 1412: one MLP's terms, 16-byte rows
constexpr int CSTR = 2 * CWP;     // 2824: one column's terms, both MLPs
// what a row of a chain tile is: K3 a depth of one column, K4 a depth of
// a window (the bf16 chain's `bool RUNS` is 0 or 1), K1 a point
enum RowMode : int { COL_ROWS = 0, WIN_ROWS = 1, POINT_ROWS = 2 };

// =========================================== bf16: the column pre-pass ===
constexpr int TM = 128;                 // columns per block
constexpr int TN = 64;                  // term outputs per step
constexpr int TLD = FEAT + 8;           // smem row (bf16): conflict-free
constexpr int TERMS_N = (CSTR + TN - 1) / TN * TN;  // 2880 packed rows
constexpr int TTHREADS = 256;
constexpr size_t TERMS_SMEM = (size_t)(TM + 2 * TN) * TLD * 2 + TM * 4;

struct TermsArgs {
  const float* x_lr;   // [n, c_lr]
  const float* x_hr;   // [n, FEAT - c_lr]
  int c_lr;
  const float* kf;     // [n] or null
  int n;
  const bf16* wfeat;   // [TERMS_N, FEAT]: W_feat transposed, term-major
  const float* cvec;   // [3, CSTR]: depth rows, prediction rows, biases
  float* terms;        // [ceil(n / TM) * TM, CSTR]
};

// C[m, o] = round(x_m) . wfeat[o] (+ kf_m * wz[o]) + b[o]: a block holds
// 128 columns' rounded features in shared memory and walks the 2,880
// outputs 64 at a time (cp.async double buffer); warp (wm, wn) owns 32
// rows x 32 outputs as 2 x 4 m16n8k16 tiles. Rows past n are computed
// from zeros and stored: the buffer is padded to whole blocks.
__global__ void __launch_bounds__(TTHREADS, 1)
    cols_terms_bf16_kernel(TermsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + TM * TLD;
  float* kfs = reinterpret_cast<float*>(Bs + 2 * TN * TLD);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)blockIdx.x * TM;
  const int c_hr = FEAT - a.c_lr;

  auto load_b = [&](int nt, int buf) {
    const bf16* src = a.wfeat + (size_t)nt * TN * FEAT;
    bf16* dst = Bs + buf * TN * TLD;
    for (int c = t; c < TN * (FEAT / 8); c += TTHREADS) {
      const int r = c / (FEAT / 8), q = c - r * (FEAT / 8);
      cp_async16(dst + r * TLD + q * 8, src + (size_t)r * FEAT + q * 8);
    }
    cp_async_commit();
  };
  load_b(0, 0);
  if (a.c_lr % 4 == 0) {
    // 16-byte loads, 8 in flight a thread
#pragma unroll 8
    for (int idx = t; idx < TM * FEAT / 4; idx += TTHREADS) {
      const int r = idx / (FEAT / 4), k = (idx - r * (FEAT / 4)) * 4;
      const long long c = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < a.n)
        v = k < a.c_lr
                ? *reinterpret_cast<const float4*>(a.x_lr + c * a.c_lr + k)
                : *reinterpret_cast<const float4*>(a.x_hr + c * c_hr +
                                                   (k - a.c_lr));
      uint2 p;
      p.x = pack_bf16(v.x, v.y);
      p.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(As + r * TLD + k) = p;
    }
  } else {
    for (int idx = t; idx < TM * FEAT; idx += TTHREADS) {
      const int r = idx / FEAT, k = idx - r * FEAT;
      const long long c = m0 + r;
      float v = 0.f;
      if (c < a.n)
        v = k < a.c_lr ? a.x_lr[c * a.c_lr + k]
                       : a.x_hr[c * c_hr + (k - a.c_lr)];
      As[r * TLD + k] = __float2bfloat16(v);
    }
  }
  if (t < TM) kfs[t] = a.kf != nullptr && m0 + t < a.n ? a.kf[m0 + t] : 0.f;

  const float* wz = a.cvec;
  const float* bias = a.cvec + 2 * CSTR;
  const int wm = warp & 3, wn = warp >> 2;
  constexpr int NT = TERMS_N / TN;
  for (int nt = 0; nt < NT; ++nt) {
    if (nt + 1 < NT) {
      load_b(nt + 1, (nt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* B = Bs + (nt & 1) * TN * TLD;
    // the epilogue's depth-row and bias values, loaded under the products
    float2 wzo[4], bo[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int o = min(nt * TN + wn * 32 + ni * 8 + 2 * tig, CSTR - 2);
      wzo[ni] = *reinterpret_cast<const float2*>(wz + o);
      bo[ni] = *reinterpret_cast<const float2*>(bias + o);
    }
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < FEAT; k += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = As + (wm * 32 + mi * 16 + gid) * TLD + k + 2 * tig;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * TLD);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * TLD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = B + (wn * 32 + ni * 8 + gid) * TLD + k + 2 * tig;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = nt * TN + wn * 32 + ni * 8 + 2 * tig;
        if (o >= CSTR) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + gid + 8 * h;
          float2 v;
          v.x = acc[mi][ni][2 * h] + kfs[r] * wzo[ni].x + bo[ni].x;
          v.y = acc[mi][ni][2 * h + 1] + kfs[r] * wzo[ni].y + bo[ni].y;
          *reinterpret_cast<float2*>(a.terms + (size_t)(m0 + r) * CSTR + o) = v;
        }
      }
    __syncthreads();
  }
}

// ==================================== bf16: the hidden chain on wgmma ===
constexpr int SLOTS = 4;                    // ring depth
// stages of one MLP in consumption order (ops/fused_mlp.py:hidden_stages)
constexpr int L1_STAGES = (D0 / SK) * (D1 / SN);   // 64: 2 halves x 16 k x 2
constexpr int L2_STAGES = (D1 / SK) * (D2 / SN);   // 16: 8 k x 2
constexpr int L3_STAGES = (D2 / SK) * (D3 / SN);   // 4
constexpr int MLP_STAGES = L1_STAGES + L2_STAGES + L3_STAGES;  // 84
constexpr int HVEC = D1 + D3;               // per MLP: b1 | w4h (float32)

// shared memory, from a 1,024-byte aligned base
constexpr int RING_OFF = H1_BYTES;
constexpr int CBUF_OFF = RING_OFF + SLOTS * STAGE_BYTES;
template <int G> struct WgSmem {
  // layer-1 stages that carry a C0 slice have even stage numbers, so
  // they land in slots 0 and 2: two slice buffers of G x 64 floats
  static constexpr int CONST_OFF = CBUF_OFF + 2 * G * SK * 4;
  static constexpr int BAR_OFF = CONST_OFF + 2 * CSTR * 4;
  static constexpr size_t BYTES = BAR_OFF + 2 * SLOTS * 8 + 1024;
};

struct WgArgs {
  const float* terms;  // [rows, CSTR] column terms (the pre-pass)
  const float* zf;     // K3: zf [z]; K4: zt [WIN]
  int n;               // columns (K3) or windows (K4)
  int z;               // K3: depths per column
  int z_tiles;         // K3: tiles per column
  int tiles;
  const void* whid;    // bf16 [2, MLP_STAGES, STAGE_ELEMS] repacked W1h..W3h;
                       // float32 [2, F_MLP_STAGES, F_STAGE]
  const float* cvec;   // [3, CSTR]
  const float* hvec;   // [2, HVEC]
  float* out_hr;
  float* out_lr;
};

using Ring = RingT<SLOTS>;

// one thread's two rows of the tile (r0 and r0 + 8 of its warpgroup)
struct Rows {
  int g0, g1;        // their columns (windows) in the chunk's terms
  int c0, c1;        // their slice index in the ring's C0 buffer
  float z0, z1;      // depth features
  float p0, p1;      // coarse predictions (fine MLP)
};

// leaky(acc + column term + round(z w_z) [+ pred w_p]), in float32
template <bool HR>
__device__ __forceinline__ float act(float acc, float c, float z, float wz,
                                     float p, float wp) {
  float v = acc + c + bf16r(z * wz);
  if (HR) v += p * wp;
  return leaky(v);
}

// Layer 0 for the 64 k of stage-pair kc, as layer 1's A fragments: k step
// j, registers {r0 k, r0+8 k, r0 k+8, r0+8 k+8}, k = 16 j + 2 (lane % 4).
template <bool HR>
__device__ __forceinline__ void build_a0(uint32_t (&af)[4][4],
                                         const float* cb0, const float* cb1,
                                         const float* wz, const float* wp,
                                         const Rows& r, int tig) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 16 * j + 2 * tig;
    const float2 wa = ld2(wz + k), wb = ld2(wz + k + 8);
    float2 pa = make_float2(0.f, 0.f), pb = pa;
    if (HR) { pa = ld2(wp + k); pb = ld2(wp + k + 8); }
    const float2 c0a = ld2(cb0 + k), c0b = ld2(cb0 + k + 8);
    const float2 c1a = ld2(cb1 + k), c1b = ld2(cb1 + k + 8);
    af[j][0] = pack_bf16(act<HR>(0.f, c0a.x, r.z0, wa.x, r.p0, pa.x),
                         act<HR>(0.f, c0a.y, r.z0, wa.y, r.p0, pa.y));
    af[j][1] = pack_bf16(act<HR>(0.f, c1a.x, r.z1, wa.x, r.p1, pa.x),
                         act<HR>(0.f, c1a.y, r.z1, wa.y, r.p1, pa.y));
    af[j][2] = pack_bf16(act<HR>(0.f, c0b.x, r.z0, wb.x, r.p0, pb.x),
                         act<HR>(0.f, c0b.y, r.z0, wb.y, r.p0, pb.y));
    af[j][3] = pack_bf16(act<HR>(0.f, c1b.x, r.z1, wb.x, r.p1, pb.x),
                         act<HR>(0.f, c1b.y, r.z1, wb.y, r.p1, pb.y));
  }
}

// Layer 2's epilogue for outputs [nb, nb + 128) into layer 3's A
// fragments a3[nb / 16 + jj]: k step jj covers accumulator chunks 2 jj
// (registers 0, 1) and 2 jj + 1 (registers 2, 3).
template <bool HR, int NB>
__device__ __forceinline__ void epi_frag(const float (&acc)[64],
                                         uint32_t (&a3)[16][4],
                                         const Rows& r, const float* t0,
                                         const float* t1, const float* wz,
                                         const float* wp, int tig) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = NB + 8 * i + 2 * tig;
    const float2 ca = ldg2(t0 + COL2 + n), cb = ldg2(t1 + COL2 + n);
    const float2 wzv = ld2(wz + COL2 + n);
    const float2 wpv = HR ? ld2(wp + COL2 + n) : make_float2(0.f, 0.f);
    a3[NB / 16 + i / 2][2 * (i & 1)] =
        pack_bf16(act<HR>(acc[4 * i], ca.x, r.z0, wzv.x, r.p0, wpv.x),
                  act<HR>(acc[4 * i + 1], ca.y, r.z0, wzv.y, r.p0, wpv.y));
    a3[NB / 16 + i / 2][2 * (i & 1) + 1] =
        pack_bf16(act<HR>(acc[4 * i + 2], cb.x, r.z1, wzv.x, r.p1, wpv.x),
                  act<HR>(acc[4 * i + 3], cb.y, r.z1, wzv.y, r.p1, wpv.y));
  }
}

// One MLP over the warpgroup's 64 rows; returns the predictions of rows
// r0 and r0 + 8 (every lane of a quad holds them).
template <bool RUNS, bool HR>
__device__ float2 mlp_wg(const WgArgs& a, Ring& ring, bf16* h1,
                         const float* cbuf, const float* consts,
                         const Rows& r, int w, int m0, int tig) {
  constexpr int G = RUNS ? MROWS / WIN : 1;
  // the MLP's index, opaque to the compiler: the two MLPs' addresses
  // differ by constants, and addresses shared between them would be held
  // in registers across a whole layer-1 loop
  int m = HR ? 1 : 0;
  asm volatile("" : "+r"(m));
  const float* hv = a.hvec + m * HVEC;
  const float* wz = consts + m * CWP;          // depth rows, term layout
  const float* wp = consts + CSTR + m * CWP;   // prediction rows
  const uint32_t h1a = smem_u32(h1) + w * 64 * 128;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  // layers 0 and 1, in two halves of 256 outputs; the warpgroup's last
  // reads of h1 (the previous MLP's layer 2) are done before it rewrites
  bar_sync(1 + w, 128);
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    uint32_t af[4][4];
#pragma unroll 1
    for (int kc = 0; kc < D0 / SK; ++kc) {
      const int s0 = ring.wait();
      const float* cb = cbuf + (s0 / 2) * G * SK;
      wg_wait<0>();
      ring.release_to(ring.head - 1);
      build_a0<HR>(af, cb + r.c0 * SK, cb + r.c1 * SK, wz + COL0 + kc * SK,
                   wp + COL0 + kc * SK, r, tig);
      wg_fence_acc(acc0);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(acc0, af[j], ring.desc_b(s0, j), kc | j);
      wg_commit();
      const int s1 = ring.wait();
      wg_fence_acc(acc1);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(acc1, af[j], ring.desc_b(s1, j), kc | j);
      wg_commit();
      wg_wait<1>();
      ring.release_to(ring.head - 1);
    }
    wg_wait<0>();
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    ring.release_to(ring.head);
    store_h1(acc0, h1, 256 * half, hv, m0, tig);
    store_h1(acc1, h1, 256 * half + 128, hv, m0, tig);
  }
  fence_proxy_async();
  bar_sync(1 + w, 128);

  // layer 2: A = h1 (the warpgroup's 64 rows), two 128-wide accumulators
#pragma unroll 1
  for (int kc = 0; kc < D1 / SK; ++kc) {
    const int s0 = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc0, wg_desc(h1a + kc * MROWS * 128 + j * 32, 1024),
               ring.desc_b(s0, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
    const int s1 = ring.wait();
    wg_fence_acc(acc1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc1, wg_desc(h1a + kc * MROWS * 128 + j * 32, 1024),
               ring.desc_b(s1, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  wg_wait<0>();
  wg_fence_acc(acc0);
  wg_fence_acc(acc1);
  ring.release_to(ring.head);
  // this MLP's column terms of the two rows' columns
  const float* t0 = a.terms + (size_t)r.g0 * CSTR + m * CWP;
  const float* t1 = RUNS ? a.terms + (size_t)r.g1 * CSTR + m * CWP : t0;
  uint32_t a3[16][4];
  epi_frag<HR, 0>(acc0, a3, r, t0, t1, wz, wp, tig);
  epi_frag<HR, 128>(acc1, a3, r, t0, t1, wz, wp, tig);

  // layer 3: A = a3 in registers
#pragma unroll
  for (int kc = 0; kc < D2 / SK; ++kc) {
    const int s = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs(acc0, a3[4 * kc + j], ring.desc_b(s, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  wg_wait<0>();
  wg_fence_acc(acc0);
  ring.release_to(ring.head);

  // layer 3's epilogue and the last layer: the 128-wide dot with w4h
  const float* w4 = hv + D1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = 8 * i + 2 * tig;
    const float2 ca = ldg2(t0 + COL3 + n), cb = ldg2(t1 + COL3 + n);
    const float2 wzv = ld2(wz + COL3 + n);
    const float2 wpv = HR ? ld2(wp + COL3 + n) : make_float2(0.f, 0.f);
    const float2 wo = ldg2(w4 + n);
    s0 += bf16r(act<HR>(acc0[4 * i], ca.x, r.z0, wzv.x, r.p0, wpv.x)) * wo.x;
    s0 += bf16r(act<HR>(acc0[4 * i + 1], ca.y, r.z0, wzv.y, r.p0, wpv.y)) * wo.y;
    s1 += bf16r(act<HR>(acc0[4 * i + 2], cb.x, r.z1, wzv.x, r.p1, wpv.x)) * wo.x;
    s1 += bf16r(act<HR>(acc0[4 * i + 3], cb.y, r.z1, wzv.y, r.p1, wpv.y)) * wo.y;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  float l0 = s0 + t0[COL4] + bf16r(r.z0 * wz[COL4]);
  float l1 = s1 + t1[COL4] + bf16r(r.z1 * wz[COL4]);
  if (HR) {
    l0 += r.p0 * wp[COL4];
    l1 += r.p1 * wp[COL4];
  }
  return make_float2(1.f / (1.f + expf(-l0)), 1.f / (1.f + expf(-l1)));
}

// The producer: one thread walks the stages of every tile in order,
// each slot refilled once all 256 consumer threads have released it.
template <bool RUNS>
__device__ __forceinline__ void produce(const WgArgs& a, uint32_t ring0,
                                        uint32_t cbuf0, uint32_t full,
                                        uint32_t empty) {
  constexpr int G = RUNS ? MROWS / WIN : 1;
  uint32_t i = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long g0 = RUNS ? (long long)tile * G : tile / a.z_tiles;
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const bf16* w = static_cast<const bf16*>(a.whid) +
                      (size_t)m * MLP_STAGES * STAGE_ELEMS;
#pragma unroll 1
      for (int s = 0; s < MLP_STAGES; ++s, ++i) {
        const int slot = i % SLOTS;
        mbar_wait(empty + 8 * slot, ((i / SLOTS) & 1) ^ 1);
        const bool c0 = s < L1_STAGES && (s & 1) == 0;
        mbar_arrive_tx(full + 8 * slot, STAGE_BYTES + (c0 ? G * SK * 4 : 0));
        bulk_g2s(ring0 + slot * STAGE_BYTES, w + (size_t)s * STAGE_ELEMS,
                 STAGE_BYTES, full + 8 * slot);
        if (c0) {
          const int kc = (s % (L1_STAGES / 2)) / 2;
          const uint32_t dst = cbuf0 + (slot / 2) * G * SK * 4;
          for (int g = 0; g < G; ++g)
            bulk_g2s(dst + g * SK * 4,
                     a.terms + (size_t)(g0 + g) * CSTR + m * CWP + kc * SK,
                     SK * 4, full + 8 * slot);
        }
      }
    }
  }
}

// The two rows' predictions to out [n, z] (K3), [n, WIN] (K4) or [n]
// (K1), past the ragged edges of n and z nothing.
template <int MODE>
__device__ __forceinline__ void store_rows(const WgArgs& a, float* out,
                                           float2 v, const Rows& r, int zb,
                                           int gid, int tig) {
  if (tig != 0) return;
  if (MODE == POINT_ROWS) {
    if (r.g0 < a.n) out[r.g0] = v.x;
    if (r.g1 < a.n) out[r.g1] = v.y;
  } else if (MODE == WIN_ROWS) {
    if (r.g0 < a.n) out[r.g0 * WIN + gid] = v.x;
    if (r.g1 < a.n) out[r.g1 * WIN + gid] = v.y;
  } else {
    if (zb < a.z) out[(size_t)r.g0 * a.z + zb] = v.x;
    if (zb + 8 < a.z) out[(size_t)r.g0 * a.z + zb + 8] = v.y;
  }
}

// The two rows of a thread (m0 and m0 + 8 of the tile) in `tile`: K3
// depths zb and zb + 8 of one column, K4 depth gid of two windows, K1
// points m0 and m0 + 8 of the tile's 128 (depth 0: it is in their terms).
// Rows past n read the terms' padding rows (the pre-pass fills whole
// blocks of 128) and store nothing.
template <int MODE>
__device__ __forceinline__ Rows tile_rows(const WgArgs& a, int tile, int m0,
                                          int gid, int& zb) {
  constexpr int G = MODE == WIN_ROWS ? MROWS / WIN : 1;
  Rows r;
  zb = 0;
  if (MODE == POINT_ROWS) {
    r.g0 = tile * MROWS + m0;               // n < 2^31
    r.g1 = r.g0 + 8;
    r.c0 = r.c1 = 0;
    r.z0 = r.z1 = 0.f;
  } else if (MODE == WIN_ROWS) {
    r.g0 = tile * G + m0 / WIN;             // m0 / 8 = 8 w + 2 q
    r.g1 = r.g0 + 1;
    r.c0 = m0 / WIN;
    r.c1 = r.c0 + 1;
    r.z0 = r.z1 = a.zf[gid];                // depth index m0 % 8 = gid
  } else {
    r.g0 = r.g1 = tile / a.z_tiles;
    zb = (tile - r.g0 * a.z_tiles) * MROWS + m0;
    r.c0 = r.c1 = 0;
    r.z0 = zb < a.z ? a.zf[zb] : 0.f;
    r.z1 = zb + 8 < a.z ? a.zf[zb + 8] : 0.f;
  }
  r.p0 = r.p1 = 0.f;
  return r;
}

// The consumers: warpgroup w owns tile rows [64 w, 64 w + 64).
template <bool RUNS>
__device__ __forceinline__ void consume(const WgArgs& a, bf16* h1,
                                        const float* cbuf,
                                        const float* consts, Ring ring) {
  const int t = threadIdx.x;
  const int w = t >> 7, q = (t >> 5) & 3, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 64 * w + 16 * q + gid;       // rows m0 and m0 + 8
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int zb;
    Rows r = tile_rows<RUNS>(a, tile, m0, gid, zb);
    const float2 lr = mlp_wg<RUNS, false>(a, ring, h1, cbuf, consts, r, w,
                                          m0, tig);
    store_rows<RUNS>(a, a.out_lr, lr, r, zb, gid, tig);
    r.p0 = lr.x;
    r.p1 = lr.y;
    const float2 hr = mlp_wg<RUNS, true>(a, ring, h1, cbuf, consts, r, w,
                                         m0, tig);
    store_rows<RUNS>(a, a.out_hr, hr, r, zb, gid, tig);
  }
}

template <bool RUNS>
__device__ void wg_body(const WgArgs& a) {
  constexpr int G = RUNS ? MROWS / WIN : 1;   // columns per tile
  using L = WgSmem<G>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cbuf = reinterpret_cast<float*>(smem + CBUF_OFF);
  float* consts = reinterpret_cast<float*>(smem + L::CONST_OFF);
  const uint32_t full = smem_u32(smem + L::BAR_OFF);
  const uint32_t empty = full + 8 * SLOTS;
  const int t = threadIdx.x;

  for (int i = t; i < 2 * CSTR; i += WG_THREADS) consts[i] = a.cvec[i];
  if (t == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup 2 produces and hands its registers to warpgroups 0 and 1
  if (t >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (t == CONSUMERS)
      produce<RUNS>(a, smem_u32(smem + RING_OFF), smem_u32(cbuf), full,
                    empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<RUNS>(a, reinterpret_cast<bf16*>(smem), cbuf, consts,
                  Ring{smem_u32(smem + RING_OFF), full, empty, 0u, 0u});
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_cols_wgmma_kernel(WgArgs a) { wg_body<false>(a); }
__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_runs_wgmma_kernel(WgArgs a) { wg_body<true>(a); }

// A persistent grid of min(tiles, SMs) blocks of `kernel` over the tiles
// of K3 (128 depths of a column), K4 (16 windows) or K1 (128 points).
template <int MODE>
int launch_chain(void (*kernel)(WgArgs), size_t bytes, WgArgs a,
                 void* stream) {
  constexpr int G = MODE == WIN_ROWS ? MROWS / WIN : MROWS;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long tiles;
  if (MODE != COL_ROWS) {
    tiles = ((long long)a.n + G - 1) / G;
  } else {
    a.z_tiles = (a.z + MROWS - 1) / MROWS;
    tiles = (long long)a.n * a.z_tiles;
  }
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  a.tiles = (int)tiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, WG_THREADS, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RUNS>
int launch_wg(WgArgs a, void* stream) {
  constexpr int G = RUNS ? MROWS / WIN : 1;
  return launch_chain<RUNS>(RUNS ? fused_dual_mlp_runs_wgmma_kernel
                                 : fused_dual_mlp_cols_wgmma_kernel,
                            WgSmem<G>::BYTES, a, stream);
}

// ============================ float32: the column pre-pass in 3xTF32 ===
constexpr int PM = 128;                 // columns per block
constexpr int PN = 64;                  // term outputs per step
constexpr int PK = 32;                  // k per step
constexpr int PLDA = FEAT + 4;          // smem row of x (float32): conflict-free
constexpr int PLDB = PK + 4;            // smem row of a W_feat chunk
constexpr int PKC = FEAT / PK;          // 10 k-chunks for 64 outputs
constexpr int PSTEPS = TERMS_N / PN * PKC;  // 450
constexpr int PB_ELEMS = PN * PLDB;     // one of hi / lo of a chunk
constexpr size_t PRE_SMEM =
    (size_t)PM * PLDA * 4 + 2 * 2 * PB_ELEMS * 4 + PM * 4;  // 203,264

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
// v -> hi = tf32_rna(v), lo = tf32_rna(v - hi), as tf32 operands
// (ops/fused_mlp.py:tf32_split)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

struct TermsF32Args {
  const float* x_lr;   // [n, c_lr], rows ld_lr floats apart
  const float* x_hr;   // [n, FEAT - c_lr], rows ld_hr apart
  int c_lr;
  const float* kf;     // [n], ld_kf apart, or null
  int n;
  long long ld_lr, ld_hr, ld_kf;   // K1's input parts are read in place
  const float* wfeat;  // [2, TERMS_N, FEAT]: hi, lo of W_feat transposed
  const float* cvec;   // [3, CSTR]: depth rows, prediction rows, biases
  float* terms;        // [ceil(n / PM) * PM, CSTR]
};

// C[m, o] = x_m . wfeat[o] (+ kf_m * wz[o]) + b[o] in 3xTF32: a block holds
// 128 columns' features (float32) in shared memory and walks the 2,880
// outputs 64 at a time, each in 10 k-chunks of 32 whose hi / lo W_feat
// rows come through a cp.async double buffer; warp (wm, wn) owns 32 rows
// x 32 outputs as 2 x 4 m16n8k8 tiles, each chunk summed into a fresh
// partial. Rows past n are computed from zeros and stored: the buffer is
// padded to whole blocks.
__global__ void __launch_bounds__(TTHREADS, 1)
    cols_terms_tf32x3_kernel(TermsF32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + PM * PLDA;             // [2 buffers][hi, lo][PN][PLDB]
  float* kfs = Bs + 4 * PB_ELEMS;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)blockIdx.x * PM;

  auto load_b = [&](int step, int buf) {
    const int nt = step / PKC, kc = step - nt * PKC;
    for (int c = t; c < 2 * PN * (PK / 4); c += TTHREADS) {
      const int h = c / (PN * (PK / 4)), rq = c - h * PN * (PK / 4);
      const int r = rq / (PK / 4), q = rq - r * (PK / 4);
      cp_async16(Bs + (2 * buf + h) * PB_ELEMS + r * PLDB + q * 4,
                 a.wfeat + ((size_t)h * TERMS_N + nt * PN + r) * FEAT +
                     kc * PK + q * 4);
    }
    cp_async_commit();
  };
  load_b(0, 0);
  for (int idx = t; idx < PM * FEAT; idx += TTHREADS) {
    const int r = idx / FEAT, k = idx - r * FEAT;
    const long long c = m0 + r;
    float v = 0.f;
    if (c < a.n)
      v = k < a.c_lr ? a.x_lr[c * a.ld_lr + k]
                     : a.x_hr[c * a.ld_hr + (k - a.c_lr)];
    As[r * PLDA + k] = v;
  }
  if (t < PM)
    kfs[t] = a.kf != nullptr && m0 + t < a.n ? a.kf[(m0 + t) * a.ld_kf] : 0.f;

  const float* wz = a.cvec;
  const float* bias = a.cvec + 2 * CSTR;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll 1
  for (int step = 0; step < PSTEPS; ++step) {
    if (step + 1 < PSTEPS) {
      load_b(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nt = step / PKC, kc = step - nt * PKC;
    const float* Bh = Bs + 2 * (step & 1) * PB_ELEMS;
    const float* Bl = Bh + PB_ELEMS;
#pragma unroll
    for (int k8 = 0; k8 < PK / 8; ++k8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = As + (wm * 32 + mi * 16 + gid) * PLDA + kc * PK +
                         k8 * 8 + tig;
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8 * PLDA], ah[mi][1], al[mi][1]);
        split_tf32(p[4], ah[mi][2], al[mi][2]);
        split_tf32(p[8 * PLDA + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = (wn * 32 + ni * 8 + gid) * PLDB + k8 * 8 + tig;
        bh[ni][0] = __float_as_uint(Bh[o]);
        bh[ni][1] = __float_as_uint(Bh[o + 4]);
        bl[ni][0] = __float_as_uint(Bl[o]);
        bl[ni][1] = __float_as_uint(Bl[o + 4]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (k8 == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
          }
          // lo.hi + hi.lo + hi.hi: the small terms first
          mma1688_tf32(part[mi][ni], al[mi], bh[ni]);
          mma1688_tf32(part[mi][ni], ah[mi], bl[ni]);
          mma1688_tf32(part[mi][ni], ah[mi], bh[ni]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    if (kc == PKC - 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int o = nt * PN + wn * 32 + ni * 8 + 2 * tig;
          if (o < CSTR) {
            const float2 wzo = *reinterpret_cast<const float2*>(wz + o);
            const float2 bo = *reinterpret_cast<const float2*>(bias + o);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * 32 + mi * 16 + gid + 8 * h;
              float2 v;
              v.x = acc[mi][ni][2 * h] + kfs[r] * wzo.x + bo.x;
              v.y = acc[mi][ni][2 * h + 1] + kfs[r] * wzo.y + bo.y;
              *reinterpret_cast<float2*>(a.terms + (size_t)(m0 + r) * CSTR +
                                         o) = v;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
        }
    }
    __syncthreads();
  }
}

// ============================ float32: the hidden chain in 3xTF32 ===
constexpr int FK = 32;                      // k of a float32 stage
constexpr int F_TILE = FK * SN;             // [128 n x 32 k]: 4,096 floats
constexpr int F_STAGE = 2 * F_TILE;         // hi, then lo
constexpr int F_STAGE_BYTES = F_STAGE * 4;  // 32 KB
constexpr int F_SLOTS = 3;                  // ring depth
// stages of one MLP in consumption order (ops/fused_mlp.py:tf32_stages):
// per 128-output chunk of layer 1 its 32 k-stages, then layer 2's 2 x 4
// stages of those 128 k; then layer 3's 8
constexpr int F_N1 = 128;
constexpr int F_L1_CHUNKS = D1 / F_N1;      // 4
constexpr int F_L1_KC = D0 / FK;            // 32
constexpr int F_L2_KC = F_N1 / FK;          // 4 per half of layer 2's outputs
constexpr int F_L3_KC = D2 / FK;            // 8
constexpr int F_MLP_STAGES =
    F_L1_CHUNKS * (F_L1_KC + 2 * F_L2_KC) + F_L3_KC;   // 168
constexpr int F_SUMS = D2 / 2;              // layer 2 sums a thread: 128
// shared memory, from a 1,024-byte aligned base: the ring, layer 2's sums
// ([F_SUMS][CONSUMERS] float32, a thread's own column), the barriers
constexpr int F_SUM_OFF = F_SLOTS * F_STAGE_BYTES;
constexpr int F_BAR_OFF = F_SUM_OFF + F_SUMS * CONSUMERS * 4;
constexpr size_t F_SMEM = F_BAR_OFF + 2 * F_SLOTS * 8 + 1024;
static_assert(F_SMEM <= 232448, "over a block's 227 KB of shared memory");

using FRing = RingT<F_SLOTS, F_STAGE_BYTES>;

// leaky(acc + column term [+ z w_z] [+ pred w_p]), float32 throughout;
// K1 (no DEPTH) has its depth in the terms
template <bool HR, bool DEPTH = true>
__device__ __forceinline__ float act32(float acc, float c, float z, float wz,
                                       float p, float wp) {
  float v = acc + c;
  if (DEPTH) v += z * wz;
  if (HR) v += p * wp;
  return leaky(v);
}

// N values the compiler must treat as written here, so that what is
// computed from them stays below this point
template <int N>
__device__ __forceinline__ void hold(float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i]));
}

// The A fragments of k8 step j from four float32 values: (r0, k t), (r1,
// k t), (r0, k t + 4), (r1, k t + 4), k t holding physical column 2 t and
// k t + 4 column 2 t + 1 of the step's 8 (the weights' k permutation).
__device__ __forceinline__ void a_frag(uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4], int j, float v0,
                                       float v1, float v2, float v3) {
  split_tf32(v0, ah[j][0], al[j][0]);
  split_tf32(v1, ah[j][1], al[j][1]);
  split_tf32(v2, ah[j][2], al[j][2]);
  split_tf32(v3, ah[j][3], al[j][3]);
}

// d (+)= A . B over one [32 k x 128 n] stage at `stage` (hi tile, then lo):
// per k8 step lo.hi + hi.lo + hi.hi, the small terms first; `accumulate`
// 0 overwrites d with the first product.
__device__ __forceinline__ void mma_stage(float (&d)[64],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          uint32_t stage, int accumulate) {
  const uint32_t lo = stage + F_TILE * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_rs_tf32(d, al[j], wg_desc(stage + 32 * j, 1024), accumulate | j);
    wgmma_rs_tf32(d, ah[j], wg_desc(lo + 32 * j, 1024), 1);
    wgmma_rs_tf32(d, ah[j], wg_desc(stage + 32 * j, 1024), 1);
  }
}

// wait for the next stage, run it, wait for the products, release it
__device__ __forceinline__ void run_stage(FRing& ring, float (&d)[64],
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          int accumulate) {
  const int s = ring.wait();
  wg_fence_acc(d);
  wg_fence();
  mma_stage(d, ah, al, ring.addr(s), accumulate);
  wg_commit();
  wg_wait<0>();
  wg_fence_acc(d);
  ring.release_to(ring.head);
}

// Layer 0's inputs for one 32-k stage of layer 1: per k8 step j the
// column terms of the two rows' columns, the depth and prediction rows at
// physical columns 8 j + 2 t, + 1.
struct L0Raw {
  float2 c0[4], c1[4], wz[4], wp[4];
};
template <bool OWN, bool DEPTH, bool HR>
__device__ __forceinline__ void load_l0(L0Raw& q, const float* t0,
                                        const float* t1, const float* wz,
                                        const float* wp, int tig) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 8 * j + 2 * tig;
    q.c0[j] = ldg2(t0 + k);
    q.c1[j] = OWN ? ldg2(t1 + k) : q.c0[j];
    q.wz[j] = DEPTH ? ldg2(wz + k) : make_float2(0.f, 0.f);
    q.wp[j] = HR ? ldg2(wp + k) : make_float2(0.f, 0.f);
  }
}

// One MLP over the warpgroup's 64 rows; returns the predictions of rows
// r0 and r0 + 8 (every lane of a quad holds them). OWN: the two rows read
// their own terms (K4's windows, K1's points); DEPTH: an in-chain depth
// term (K3, K4).
template <int MODE, bool HR>
__device__ float2 mlp_tf32(const WgArgs& a, FRing& ring, float* sums,
                           const Rows& r, int tig) {
  constexpr bool OWN = MODE != COL_ROWS, DEPTH = MODE != POINT_ROWS;
  // the MLP's index, opaque to the compiler (as mlp_wg's)
  int m = HR ? 1 : 0;
  asm volatile("" : "+r"(m));
  const float* hv = a.hvec + m * HVEC;         // b1 | w4h
  const float* wz = a.cvec + m * CWP;          // depth rows, term layout
  const float* wp = a.cvec + CSTR + m * CWP;   // prediction rows
  const float* t0 = a.terms + (size_t)r.g0 * CSTR + m * CWP;
  const float* t1 = OWN ? a.terms + (size_t)r.g1 * CSTR + m * CWP : t0;
  float sum[64], d[64];
  uint32_t ah[4][4], al[4][4];

  // layer 1 in chunks of 128 outputs, each feeding layer 2's sums
#pragma unroll 1
  for (int c = 0; c < F_L1_CHUNKS; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    L0Raw q;
    load_l0<OWN, DEPTH, HR>(q, t0 + COL0, t1 + COL0, wz + COL0, wp + COL0,
                            tig);
#pragma unroll 1
    for (int kc = 0; kc < F_L1_KC; ++kc) {
      // layer 0: leaky(C0 + z w_z0 [+ pred w_p0]), layer 1's A
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_frag(ah, al, j,
               act32<HR, DEPTH>(0.f, q.c0[j].x, r.z0, q.wz[j].x, r.p0,
                                q.wp[j].x),
               act32<HR, DEPTH>(0.f, q.c1[j].x, r.z1, q.wz[j].x, r.p1,
                                q.wp[j].x),
               act32<HR, DEPTH>(0.f, q.c0[j].y, r.z0, q.wz[j].y, r.p0,
                                q.wp[j].y),
               act32<HR, DEPTH>(0.f, q.c1[j].y, r.z1, q.wz[j].y, r.p1,
                                q.wp[j].y));
      // the next stage's inputs load under this stage's products
      if (kc + 1 < F_L1_KC) {
        const int k = COL0 + (kc + 1) * FK;
        load_l0<OWN, DEPTH, HR>(q, t0 + k, t1 + k, wz + k, wp + k, tig);
      }
      run_stage(ring, d, ah, al, 0);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += d[i];
    }
    // h1 = leaky(sum + b1) for outputs 128 c + 8 i + 2 t (+ 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 b = ldg2(hv + F_N1 * c + 8 * i + 2 * tig);
      sum[4 * i] = leaky(sum[4 * i] + b.x);
      sum[4 * i + 1] = leaky(sum[4 * i + 1] + b.y);
      sum[4 * i + 2] = leaky(sum[4 * i + 2] + b.x);
      sum[4 * i + 3] = leaky(sum[4 * i + 3] + b.y);
    }
    // layer 2 over these 128 k, for each half of its 256 outputs: a
    // partial, added to the thread's sums in shared memory
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < F_L2_KC; ++kk) {
        // split after the previous stage's products: hoisted, the four
        // stages' fragments would hold 128 registers at once
        hold<16>(sum + 16 * kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * kk + j;
          a_frag(ah, al, j, sum[4 * i], sum[4 * i + 2], sum[4 * i + 1],
                 sum[4 * i + 3]);
        }
        run_stage(ring, d, ah, al, kk);
      }
      float* p = sums + h * 64 * CONSUMERS;
      if (c == 0) {
#pragma unroll
        for (int v = 0; v < 64; ++v) p[v * CONSUMERS] = d[v];
      } else {
#pragma unroll
        for (int v = 0; v < 64; ++v) p[v * CONSUMERS] += d[v];
      }
    }
  }

  // layer 3: A = leaky(layer 2's sums + column terms ...), k in stages of
  // 32; sum v = 16 kc + 4 j + e holds output 32 kc + 8 j + 2 t + e % 2 of
  // row e / 2
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < F_L3_KC; ++kc) {
    const float* p = sums + 16 * kc * CONSUMERS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = COL2 + FK * kc + 8 * j + 2 * tig;
      const float2 ca = ldg2(t0 + n);
      const float2 cb = OWN ? ldg2(t1 + n) : ca;
      const float2 wzv = DEPTH ? ldg2(wz + n) : make_float2(0.f, 0.f);
      const float2 wpv = HR ? ldg2(wp + n) : make_float2(0.f, 0.f);
      const float* pv = p + 4 * j * CONSUMERS;
      a_frag(ah, al, j,
             act32<HR, DEPTH>(pv[0], ca.x, r.z0, wzv.x, r.p0, wpv.x),
             act32<HR, DEPTH>(pv[2 * CONSUMERS], cb.x, r.z1, wzv.x, r.p1,
                              wpv.x),
             act32<HR, DEPTH>(pv[CONSUMERS], ca.y, r.z0, wzv.y, r.p0, wpv.y),
             act32<HR, DEPTH>(pv[3 * CONSUMERS], cb.y, r.z1, wzv.y, r.p1,
                              wpv.y));
    }
    run_stage(ring, d, ah, al, 0);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += d[i];
  }

  // layer 3's epilogue and the last layer: the 128-wide dot with w4h
  const float* w4 = hv + D1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = 8 * i + 2 * tig;
    const float2 ca = ldg2(t0 + COL3 + n);
    const float2 cb = OWN ? ldg2(t1 + COL3 + n) : ca;
    const float2 wzv = DEPTH ? ldg2(wz + COL3 + n) : make_float2(0.f, 0.f);
    const float2 wpv = HR ? ldg2(wp + COL3 + n) : make_float2(0.f, 0.f);
    const float2 wo = ldg2(w4 + n);
    s0 += act32<HR, DEPTH>(sum[4 * i], ca.x, r.z0, wzv.x, r.p0, wpv.x) * wo.x;
    s0 += act32<HR, DEPTH>(sum[4 * i + 1], ca.y, r.z0, wzv.y, r.p0, wpv.y) *
          wo.y;
    s1 += act32<HR, DEPTH>(sum[4 * i + 2], cb.x, r.z1, wzv.x, r.p1, wpv.x) *
          wo.x;
    s1 += act32<HR, DEPTH>(sum[4 * i + 3], cb.y, r.z1, wzv.y, r.p1, wpv.y) *
          wo.y;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  float l0 = s0 + t0[COL4], l1 = s1 + t1[COL4];
  if (DEPTH) {
    l0 += r.z0 * wz[COL4];
    l1 += r.z1 * wz[COL4];
  }
  if (HR) {
    l0 += r.p0 * wp[COL4];
    l1 += r.p1 * wp[COL4];
  }
  return make_float2(1.f / (1.f + expf(-l0)), 1.f / (1.f + expf(-l1)));
}

// The producer: one thread streams both MLPs' 168 stages for every tile,
// each slot refilled once all 256 consumer threads have released it.
__device__ __forceinline__ void produce_f32(const WgArgs& a, uint32_t ring0,
                                            uint32_t full, uint32_t empty) {
  uint32_t i = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int s = 0; s < 2 * F_MLP_STAGES; ++s, ++i) {
      const int slot = i % F_SLOTS;
      mbar_wait(empty + 8 * slot, ((i / F_SLOTS) & 1) ^ 1);
      mbar_arrive_tx(full + 8 * slot, F_STAGE_BYTES);
      bulk_g2s(ring0 + slot * F_STAGE_BYTES,
               static_cast<const float*>(a.whid) + (size_t)s * F_STAGE,
               F_STAGE_BYTES, full + 8 * slot);
    }
  }
}

template <int MODE>
__device__ void f32_body(const WgArgs& a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + F_BAR_OFF);
  const uint32_t empty = full + 8 * F_SLOTS;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < F_SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup 2 produces and hands its registers to warpgroups 0 and 1
  if (t >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (t == CONSUMERS) produce_f32(a, smem_u32(smem), full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  FRing ring{smem_u32(smem), full, empty, 0u, 0u};
  float* sums = reinterpret_cast<float*>(smem + F_SUM_OFF) + t;
  const int q = (t >> 5) & 3, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 64 * (t >> 7) + 16 * q + gid;  // rows m0 and m0 + 8
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    int zb;
    Rows r = tile_rows<MODE>(a, tile, m0, gid, zb);
    const float2 lr = mlp_tf32<MODE, false>(a, ring, sums, r, tig);
    store_rows<MODE>(a, a.out_lr, lr, r, zb, gid, tig);
    r.p0 = lr.x;
    r.p1 = lr.y;
    const float2 hr = mlp_tf32<MODE, true>(a, ring, sums, r, tig);
    store_rows<MODE>(a, a.out_hr, hr, r, zb, gid, tig);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_cols_tf32x3_kernel(WgArgs a) { f32_body<COL_ROWS>(a); }
__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_runs_tf32x3_kernel(WgArgs a) { f32_body<WIN_ROWS>(a); }
__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_points_tf32x3_kernel(WgArgs a) { f32_body<POINT_ROWS>(a); }

WgArgs wg_args(const void* terms, const void* zf, int n, int z,
               const void* whid, const void* cvec, const void* hvec,
               void* out_hr, void* out_lr) {
  return WgArgs{(const float*)terms, (const float*)zf, n, z, 0, 0, whid,
                (const float*)cvec, (const float*)hvec,
                (float*)out_hr, (float*)out_lr};
}

}  // namespace

extern "C" {

// The column-term pre-pass on `stream`; returns cudaGetLastError() (0 on
// success). x_lr [n, c_lr], x_hr [n, 320 - c_lr], kf [n] or null float32;
// wfeat [2880, 320] bf16, cvec [3, 2824] float32 (ops/fused_mlp.py:
// prepare_cols_weights); terms [ceil(n / 128) * 128, 2824] float32.
int surs_cols_terms_bf16(const void* x_lr, const void* x_hr, int c_lr,
                         const void* kf, int n, const void* wfeat,
                         const void* cvec, void* terms, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cols_terms_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TERMS_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + TM - 1) / TM;
  TermsArgs a{(const float*)x_lr, (const float*)x_hr, c_lr, (const float*)kf,
              n, (const bf16*)wfeat, (const float*)cvec, (float*)terms};
  cols_terms_bf16_kernel<<<blocks, TTHREADS, TERMS_SMEM,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch K3 (bf16) on `stream` over the terms of ncol columns; returns
// cudaGetLastError(). zf [z] float32; whid, cvec, hvec from
// prepare_cols_weights; out_* [ncol, z] float32.
int surs_fused_dual_mlp_cols_wgmma(const void* terms, const void* zf,
                                   int ncol, int z, const void* whid,
                                   const void* cvec, const void* hvec,
                                   void* out_hr, void* out_lr, void* stream) {
  return launch_wg<false>(
      wg_args(terms, zf, ncol, z, whid, cvec, hvec, out_hr, out_lr), stream);
}

// Launch K4 (bf16) over the terms of nr windows: zt [8]; out_* [nr, 8].
int surs_fused_dual_mlp_runs_wgmma(const void* terms, const void* zt, int nr,
                                   const void* whid, const void* cvec,
                                   const void* hvec, void* out_hr,
                                   void* out_lr, void* stream) {
  return launch_wg<true>(
      wg_args(terms, zt, nr, WIN, whid, cvec, hvec, out_hr, out_lr), stream);
}

// The float32 column-term pre-pass (3xTF32) on `stream`, as
// surs_cols_terms_bf16 but with row strides (floats: x_lr's rows ld_lr
// apart, x_hr's ld_hr, kf's ld_kf) and wfeat [2, 2880, 320] float32: hi,
// then lo.
int surs_cols_terms_tf32x3(const void* x_lr, long long ld_lr,
                           const void* x_hr, long long ld_hr, int c_lr,
                           const void* kf, long long ld_kf, int n,
                           const void* wfeat, const void* cvec, void* terms,
                           void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      cols_terms_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PRE_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + PM - 1) / PM;
  TermsF32Args a{(const float*)x_lr, (const float*)x_hr, c_lr,
                 (const float*)kf, n, ld_lr, ld_hr, ld_kf,
                 (const float*)wfeat, (const float*)cvec, (float*)terms};
  cols_terms_tf32x3_kernel<<<blocks, TTHREADS, PRE_SMEM,
                             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Launch K3 (float32, 3xTF32) on `stream` over the terms of ncol columns,
// as surs_fused_dual_mlp_cols_wgmma but whid [2, 168, 8192] float32 (hi
// and lo stages, ops/fused_mlp.py:prepare_cols_weights).
int surs_fused_dual_mlp_cols_tf32x3(const void* terms, const void* zf,
                                    int ncol, int z, const void* whid,
                                    const void* cvec, const void* hvec,
                                    void* out_hr, void* out_lr,
                                    void* stream) {
  return launch_chain<COL_ROWS>(
      fused_dual_mlp_cols_tf32x3_kernel, F_SMEM,
      wg_args(terms, zf, ncol, z, whid, cvec, hvec, out_hr, out_lr), stream);
}

// Launch K4 (float32, 3xTF32) over the terms of nr windows: zt [8];
// out_* [nr, 8].
int surs_fused_dual_mlp_runs_tf32x3(const void* terms, const void* zt,
                                    int nr, const void* whid,
                                    const void* cvec, const void* hvec,
                                    void* out_hr, void* out_lr,
                                    void* stream) {
  return launch_chain<WIN_ROWS>(
      fused_dual_mlp_runs_tf32x3_kernel, F_SMEM,
      wg_args(terms, zt, nr, WIN, whid, cvec, hvec, out_hr, out_lr), stream);
}

// Launch the float32 K1's chain (3xTF32) over the terms of n points (the
// float32 pre-pass with kf the depth column), one point a row; out_* [n].
int surs_fused_dual_mlp_points_tf32x3(const void* terms, int n,
                                      const void* whid, const void* cvec,
                                      const void* hvec, void* out_hr,
                                      void* out_lr, void* stream) {
  return launch_chain<POINT_ROWS>(
      fused_dual_mlp_points_tf32x3_kernel, F_SMEM,
      wg_args(terms, nullptr, n, 1, whid, cvec, hvec, out_hr, out_lr),
      stream);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
