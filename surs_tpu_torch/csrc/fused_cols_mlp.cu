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
// 32,768 windows is 780.8 GFLOP, bound 0.789 ms. What stands in the way is
// the weight stream: every tile of rows reads all 2.6 MB of hidden weights
// of both MLPs from L2.
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
// float32 keeps the first design (a check path only): one block per 32-row
// tile runs the whole chain with FMA loops, the column terms recomputed
// per tile on the CUDA cores.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrappers are ops/fused_mlp.py:fused_dual_mlp_cols
// and fused_dual_mlp_runs (and column_terms, the pre-pass alone).

#include "wg_chain.cuh"

namespace {

constexpr int FEAT = 320;         // feature rows of the x block (lr + hr)
constexpr int ZROW = FEAT;        // depth row of the x block
constexpr int PROW = FEAT + 1;    // coarse-prediction row (fine MLP)
constexpr int WIN = 8;            // depths per window (K4)
// the column terms of one MLP: the outputs of layers 0, 2, 3 and 4
constexpr int COL0 = 0, COL2 = D0, COL3 = D0 + D2, COL4 = D0 + D2 + D3;
constexpr int CW = COL4 + 1;      // 1409
constexpr int CWP = CW + 3;       // 1412: one MLP's terms, 16-byte rows
constexpr int CSTR = 2 * CWP;     // 2824: one column's terms, both MLPs

// ====================================================== float32 (FMA) ===
struct ColsArgs {
  const float* x_lr;   // [n, c_lr]
  const float* x_hr;   // [n, FEAT - c_lr]
  int c_lr;
  const float* kf;     // [n] (K4) or null (K3)
  const float* zf;     // [z] depth features (K3: zf, K4: zt)
  int n;               // columns (K3) or windows (K4)
  int z;               // depths per column (K3) or WIN (K4)
  int z_tiles;         // K3: tiles per column
  const float* wlr;
  const float* blr;
  const float* whr;
  const float* bhr;
  float* out_hr;       // [n, z]
  float* out_lr;
};

template <bool RUNS>
struct Shape {
  static constexpr int BN = BN32;
  static constexpr int RPG = RUNS ? WIN : BN;  // tile rows per column
  static constexpr int G = BN / RPG;           // columns per tile
  static constexpr size_t SMEM =
      (size_t)BN * LDP32 * sizeof(float)
      + (size_t)((G + 2) * CWP + G * FEAT + G + 3 * BN) * 4;
};

// Per-row epilogue of a layer that reads the input: the column term
// (bias included), the rounded depth term and the coarse-prediction
// term (zero in the coarse MLP, whose prediction row is zero padding and
// whose predc is 0). Everything it reads is in shared memory.
template <int RPG>
struct ColsEpi {
  const float* colb;          // this layer's column terms, row stride CWP
  const float* wzs;           // the layer's depth-row weights
  const float* wps;           // its coarse-prediction row
  const float* zrow;          // [BN] depth feature of each tile row
  const float* predc;         // [BN] coarse prediction of each tile row
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    v += colb[(r / RPG) * CWP + c];
    v += zrow[r] * wzs[c];
    return v + predc[r] * wps[c];
  }
};

// The last layer's per-row term: ColsEpi at its one output.
template <int RPG>
struct ColsExtra {
  ColsEpi<RPG> epi;
  __device__ __forceinline__ float operator()(int r) const {
    return epi(r, 0, 0.f);
  }
};

// colb[g][n] = x_g . W_x[:FEAT, n] (+ kf_g * W_x[ZROW, n]) + b[n] for the
// outputs n of every input-reading layer, g < G; wzs[n] and wps[n] the
// depth and coarse-prediction rows, for the epilogues. Threads own
// outputs, so the weight rows are read coalesced, once per tile; the
// loop over rows keeps 16 loads from L2 in flight per thread.
template <int G>
__device__ void column_terms(const float* xs, const float* kfs, bool runs,
                             const float* __restrict__ w,
                             const float* __restrict__ b, float* colb,
                             float* wzs, float* wps) {
  for (int n = threadIdx.x; n < CW; n += THREADS) {
    size_t off;
    int N, nn, bo;
    if (n < COL2) { off = OFF_W0X; N = D0; nn = n; bo = OFF_B0; }
    else if (n < COL3) { off = OFF_W2X; N = D2; nn = n - COL2; bo = OFF_B2; }
    else if (n < COL4) { off = OFF_W3X; N = D3; nn = n - COL3; bo = OFF_B3; }
    else { off = OFF_W4X; N = 1; nn = 0; bo = OFF_B4; }
    const float* wc = w + off + nn;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 16
    for (int k = 0; k < FEAT; ++k) {
      const float wk = wc[(size_t)k * N];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(xs[g * FEAT + k], wk, acc[g]);
    }
    const float wz = wc[(size_t)ZROW * N];
    wzs[n] = wz;
    wps[n] = wc[(size_t)PROW * N];
#pragma unroll
    for (int g = 0; g < G; ++g)
      colb[g * CWP + n] = acc[g] + (runs ? kfs[g] * wz : 0.f) + b[bo + nn];
  }
}

// Layer 0: no per-sample product, out = leaky(epi(0)).
template <typename Epi>
__device__ void layer0_cols(float* out, Epi epi) {
  for (int idx = threadIdx.x; idx < BN32 * D0; idx += THREADS) {
    const int r = idx / D0, c = idx - r * D0;
    out[r * LDP32 + c] = leaky(epi(r, c, 0.f));
  }
  __syncthreads();
}

// One MLP of the column chain over the tile; pred[r] = sigmoid(logit).
template <bool RUNS>
__device__ void mlp_cols(float* P, const float* xs, const float* kfs,
                         const float* __restrict__ w,
                         const float* __restrict__ b, float* colb,
                         float* wzs, float* wps, const float* zrow,
                         const float* predc, float* pred) {
  using S = Shape<RUNS>;
  constexpr int RPG = S::RPG;
  column_terms<S::G>(xs, kfs, RUNS, w, b, colb, wzs, wps);
  __syncthreads();
  auto epi = [&](int col_off) {
    return ColsEpi<RPG>{colb + col_off, wzs + col_off, wps + col_off, zrow,
                        predc};
  };
  layer0_cols(P, epi(COL0));
  layer_f32<D1, D0, 0, true>(P, nullptr, w + OFF_W1H, nullptr,
                             BiasEpi{b + OFF_B1}, P);
  layer_f32<D2, D1, 0, true>(P, nullptr, w + OFF_W2H, nullptr, epi(COL2), P);
  layer_f32<D3, D2, 0, true>(P, nullptr, w + OFF_W3H, nullptr, epi(COL3), P);
  final_layer<float, S::BN, 0>(P, LDP32, (const float*)nullptr, 0,
                               w + OFF_W4H, (const float*)nullptr,
                               ColsExtra<RPG>{epi(COL4)}, pred);
}

template <bool RUNS>
__device__ void cols_body(const ColsArgs& a) {
  using S = Shape<RUNS>;
  constexpr int BN = S::BN, RPG = S::RPG, G = S::G;
  extern __shared__ __align__(128) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);
  float* colb = P + BN * LDP32;
  float* wzs = colb + G * CWP;
  float* wps = wzs + CWP;
  float* xs = wps + CWP;
  float* kfs = xs + G * FEAT;
  float* zrow = kfs + G;
  float* predc = zrow + BN;
  float* pred = predc + BN;
  const int t = threadIdx.x;

  // the tile: K3, depths [z0, z0 + BN) of column c0; K4, windows
  // [c0, c0 + G), each 8 depths
  int c0, z0 = 0;
  if (RUNS) {
    c0 = blockIdx.x * G;
  } else {
    c0 = blockIdx.x / a.z_tiles;
    z0 = (blockIdx.x - c0 * a.z_tiles) * BN;
  }
  const int c_hr = FEAT - a.c_lr;
  for (int idx = t; idx < G * FEAT; idx += THREADS) {
    const int g = idx / FEAT, k = idx - g * FEAT, c = c0 + g;
    float v = 0.f;
    if (c < a.n)
      v = k < a.c_lr ? a.x_lr[(size_t)c * a.c_lr + k]
                     : a.x_hr[(size_t)c * c_hr + (k - a.c_lr)];
    xs[idx] = v;
  }
  if (t < G) kfs[t] = RUNS && c0 + t < a.n ? a.kf[c0 + t] : 0.f;
  if (t < BN) {
    const int z = RUNS ? t % RPG : z0 + t;
    zrow[t] = z < a.z ? a.zf[z] : 0.f;
    predc[t] = 0.f;
  }
  __syncthreads();

  // tile row t -> output element, or -1 past the ragged edge
  int o = -1;
  if (t < BN) {
    const int c = c0 + t / RPG, z = RUNS ? t % RPG : z0 + t;
    if (c < a.n && z < a.z) o = c * a.z + z;
  }
  mlp_cols<RUNS>(P, xs, kfs, a.wlr, a.blr, colb, wzs, wps, zrow, predc,
                 pred);
  if (t < BN) {
    predc[t] = pred[t];
    if (o >= 0) a.out_lr[o] = pred[t];
  }
  __syncthreads();
  mlp_cols<RUNS>(P, xs, kfs, a.whr, a.bhr, colb, wzs, wps, zrow, predc,
                 pred);
  if (o >= 0) a.out_hr[o] = pred[t];
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_cols_f32_kernel(ColsArgs a) { cols_body<false>(a); }
__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_runs_f32_kernel(ColsArgs a) { cols_body<true>(a); }

template <bool RUNS>
int launch_f32(void (*kernel)(ColsArgs), ColsArgs a, void* stream) {
  using S = Shape<RUNS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return (int)e;
  long long blocks;
  if (RUNS) {
    blocks = (a.n + S::G - 1) / S::G;
  } else {
    a.z_tiles = (a.z + S::BN - 1) / S::BN;
    blocks = (long long)a.n * a.z_tiles;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, THREADS, S::SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

ColsArgs args(const void* x_lr, const void* x_hr, int c_lr, const void* kf,
              const void* zf, int n, int z, const void* wlr, const void* blr,
              const void* whr, const void* bhr, void* out_hr, void* out_lr) {
  return ColsArgs{(const float*)x_lr, (const float*)x_hr, c_lr,
                  (const float*)kf, (const float*)zf, n, z, 0,
                  (const float*)wlr, (const float*)blr, (const float*)whr,
                  (const float*)bhr, (float*)out_hr, (float*)out_lr};
}

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
  const float* terms;  // [rows, CSTR] column terms (cols_terms_bf16_kernel)
  const float* zf;     // K3: zf [z]; K4: zt [WIN]
  int n;               // columns (K3) or windows (K4)
  int z;               // K3: depths per column
  int z_tiles;         // K3: tiles per column
  int tiles;
  const bf16* whid;    // [2, MLP_STAGES, STAGE_ELEMS] repacked W1h..W3h
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
      const bf16* w = a.whid + (size_t)m * MLP_STAGES * STAGE_ELEMS;
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

// The two rows' predictions to out [n, z] (K3) or [n, WIN] (K4), past
// the ragged edges of n and z nothing.
template <bool RUNS>
__device__ __forceinline__ void store_rows(const WgArgs& a, float* out,
                                           float2 v, const Rows& r, int zb,
                                           int gid, int tig) {
  if (tig != 0) return;
  if (RUNS) {
    if (r.g0 < a.n) out[r.g0 * WIN + gid] = v.x;
    if (r.g1 < a.n) out[r.g1 * WIN + gid] = v.y;
  } else {
    if (zb < a.z) out[(size_t)r.g0 * a.z + zb] = v.x;
    if (zb + 8 < a.z) out[(size_t)r.g0 * a.z + zb + 8] = v.y;
  }
}

// The consumers: warpgroup w owns tile rows [64 w, 64 w + 64).
template <bool RUNS>
__device__ __forceinline__ void consume(const WgArgs& a, bf16* h1,
                                        const float* cbuf,
                                        const float* consts, Ring ring) {
  constexpr int G = RUNS ? MROWS / WIN : 1;
  const int t = threadIdx.x;
  const int w = t >> 7, q = (t >> 5) & 3, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 64 * w + 16 * q + gid;       // rows m0 and m0 + 8
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    Rows r;
    int zb = 0;
    if (RUNS) {
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

template <bool RUNS>
int launch_wg(WgArgs a, void* stream) {
  constexpr int G = RUNS ? MROWS / WIN : 1;
  auto kernel = RUNS ? fused_dual_mlp_runs_wgmma_kernel
                     : fused_dual_mlp_cols_wgmma_kernel;
  const size_t bytes = WgSmem<G>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long tiles;
  if (RUNS) {
    tiles = (a.n + G - 1) / G;
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

WgArgs wg_args(const void* terms, const void* zf, int n, int z,
               const void* whid, const void* cvec, const void* hvec,
               void* out_hr, void* out_lr) {
  return WgArgs{(const float*)terms, (const float*)zf, n, z, 0, 0,
                (const bf16*)whid, (const float*)cvec, (const float*)hvec,
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

// Launch K3 (float32) on `stream`; returns cudaGetLastError() (0 on
// success). x_lr [ncol, c_lr], x_hr [ncol, 320 - c_lr], zf [z] float32;
// packed float32 weights and biases; out_* [ncol, z] float32.
int surs_fused_dual_mlp_cols_f32(const void* x_lr, const void* x_hr,
                                 int c_lr, const void* zf, int ncol, int z,
                                 const void* wlr, const void* blr,
                                 const void* whr, const void* bhr,
                                 void* out_hr, void* out_lr, void* stream) {
  return launch_f32<false>(
      fused_dual_mlp_cols_f32_kernel,
      args(x_lr, x_hr, c_lr, nullptr, zf, ncol, z, wlr, blr, whr, bhr,
           out_hr, out_lr), stream);
}

// Launch K4 (float32): x_lr [nr, c_lr], x_hr [nr, 320 - c_lr], kf [nr],
// zt [8] float32; weights as K3; out_* [nr, 8] float32.
int surs_fused_dual_mlp_runs_f32(const void* x_lr, const void* x_hr,
                                 int c_lr, const void* kf, const void* zt,
                                 int nr, const void* wlr, const void* blr,
                                 const void* whr, const void* bhr,
                                 void* out_hr, void* out_lr, void* stream) {
  return launch_f32<true>(
      fused_dual_mlp_runs_f32_kernel,
      args(x_lr, x_hr, c_lr, kf, zt, nr, WIN, wlr, blr, whr, bhr, out_hr,
           out_lr), stream);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
