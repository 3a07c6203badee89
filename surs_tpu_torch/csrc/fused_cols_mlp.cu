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
//   layer_i = x_col.W_feat (+ kf * w_z)       once per column / window
//           + round(z * w_z)                   rank-1 in depth
//           + h.W_h                            per depth sample (i > 0)
//           + pred_lr * w_pred                 fine MLP only, unrounded
// Layer 0 has no per-sample product at all; layer 1 is h-only.
//
// What bounds it: per depth sample only the hidden chain remains, about
// 2.75 MFLOP for both MLPs against 8 bytes of output, so one dense 512^3
// grid is about 370 TFLOP: bound by the tensor cores. The design is K1's
// (dual_mlp.cuh): one block per 64-row tile (bf16, wmma) or 32-row tile
// (float32, FMA) runs the whole dual chain with activations in shared
// memory and weights read from L2. What changes:
//   * a tile is 64 (32) depths of one column for K3, 8 (4) windows x 8
//     depths for K4;
//   * the column terms of the tile's 1 or 8 columns, [G, 320] x [320, 1409]
//     for the four input-reading layers of one MLP, plus kf * w_z and the
//     bias, are computed once per tile on the CUDA cores into shared
//     memory (recomputed per tile: about 1 % of the work for K3, 8 % for
//     K4);
//   * z * w_z is formed in each layer's epilogue from the depth value and
//     the weight's depth row (staged in shared memory with the column
//     terms), rounded to the compute dtype as the TPU kernel rounds its z0
//     tiles; no [Z, out] array is built;
//   * layer 0 is an elementwise pass; layers 1-3 are K1's hidden layer
//     with the input product left out; ragged Ncol, Z and NR are masked.
// Rounding follows the TPU kernel: the features are cast to the compute
// dtype before their product, the depth term is rounded after it, kf and
// pred_lr are not rounded; accumulation, bias, leaky-ReLU and sigmoid are
// float32. Not yet done, for a later change: wgmma, TMA weight staging, a
// persistent grid, the column terms on the tensor cores.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrappers are ops/fused_mlp.py:fused_dual_mlp_cols
// and fused_dual_mlp_runs.

#include "dual_mlp.cuh"

namespace {

constexpr int FEAT = 320;         // feature rows of the x block (lr + hr)
constexpr int ZROW = FEAT;        // depth row of the x block
constexpr int PROW = FEAT + 1;    // coarse-prediction row (fine MLP)
constexpr int WIN = 8;            // depths per window (K4)
// the column terms of one MLP: the outputs of layers 0, 2, 3 and 4
constexpr int COL0 = 0, COL2 = D0, COL3 = D0 + D2, COL4 = D0 + D2 + D3;
constexpr int CW = COL4 + 1;      // 1409
constexpr int CWP = CW + 3;       // row stride in shared memory

struct ColsArgs {
  const float* x_lr;   // [n, c_lr]
  const float* x_hr;   // [n, FEAT - c_lr]
  int c_lr;
  const float* kf;     // [n] (K4) or null (K3)
  const float* zf;     // [z] depth features (K3: zf, K4: zt)
  int n;               // columns (K3) or windows (K4)
  int z;               // depths per column (K3) or WIN (K4)
  int z_tiles;         // K3: tiles per column
  const void* wlr;
  const float* blr;
  const void* whr;
  const float* bhr;
  float* out_hr;       // [n, z]
  float* out_lr;
};

// Tile shape per compute dtype.
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BN = BN16, LDP = LDP16, SCRATCH = WARPS * 256;
};
template <> struct Tile<float> {
  static constexpr int BN = BN32, LDP = LDP32, SCRATCH = 0;
};

template <typename T, bool RUNS>
struct Shape {
  static constexpr int BN = Tile<T>::BN;
  static constexpr int RPG = RUNS ? WIN : BN;  // tile rows per column
  static constexpr int G = BN / RPG;           // columns per tile
  static constexpr size_t SMEM =
      (size_t)BN * Tile<T>::LDP * sizeof(T)
      + (size_t)(Tile<T>::SCRATCH + (G + 2) * CWP + G * FEAT + G + 3 * BN)
        * 4;
};

// Per-row epilogue of a layer that reads the input: the column term
// (bias included), the rounded depth term and the coarse-prediction
// term (zero in the coarse MLP, whose prediction row is zero padding and
// whose predc is 0). Everything it reads is in shared memory.
template <typename T, int RPG>
struct ColsEpi {
  const float* colb;          // this layer's column terms, row stride CWP
  const float* wzs;           // the layer's depth-row weights
  const float* wps;           // its coarse-prediction row
  const float* zrow;          // [BN] depth feature of each tile row
  const float* predc;         // [BN] coarse prediction of each tile row
  __device__ __forceinline__ float operator()(int r, int c, float v) const {
    v += colb[(r / RPG) * CWP + c];
    v += round_to<T>(zrow[r] * wzs[c]);
    return v + predc[r] * wps[c];
  }
};

// The last layer's per-row term: ColsEpi at its one output.
template <typename T, int RPG>
struct ColsExtra {
  ColsEpi<T, RPG> epi;
  __device__ __forceinline__ float operator()(int r) const {
    return epi(r, 0, 0.f);
  }
};

// colb[g][n] = x_g . W_x[:FEAT, n] (+ kf_g * W_x[ZROW, n]) + b[n] for the
// outputs n of every input-reading layer, g < G; wzs[n] and wps[n] the
// depth and coarse-prediction rows, for the epilogues. Threads own
// outputs, so the weight rows are read coalesced, once per tile; the
// loop over rows keeps 16 loads from L2 in flight per thread.
template <typename T, int G>
__device__ void column_terms(const float* xs, const float* kfs, bool runs,
                             const T* __restrict__ w,
                             const float* __restrict__ b, float* colb,
                             float* wzs, float* wps) {
  for (int n = threadIdx.x; n < CW; n += THREADS) {
    size_t off;
    int N, nn, bo;
    if (n < COL2) { off = OFF_W0X; N = D0; nn = n; bo = OFF_B0; }
    else if (n < COL3) { off = OFF_W2X; N = D2; nn = n - COL2; bo = OFF_B2; }
    else if (n < COL4) { off = OFF_W3X; N = D3; nn = n - COL3; bo = OFF_B3; }
    else { off = OFF_W4X; N = 1; nn = 0; bo = OFF_B4; }
    const T* wc = w + off + nn;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 16
    for (int k = 0; k < FEAT; ++k) {
      const float wk = to_f32(wc[(size_t)k * N]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(xs[g * FEAT + k], wk, acc[g]);
    }
    const float wz = to_f32(wc[(size_t)ZROW * N]);
    wzs[n] = wz;
    wps[n] = to_f32(wc[(size_t)PROW * N]);
#pragma unroll
    for (int g = 0; g < G; ++g)
      colb[g * CWP + n] = acc[g] + (runs ? kfs[g] * wz : 0.f) + b[bo + nn];
  }
}

// Layer 0: no per-sample product, out = leaky(epi(0)).
template <typename T, int BN, int LDP, typename Epi>
__device__ void layer0_cols(T* out, Epi epi) {
  for (int idx = threadIdx.x; idx < BN * D0; idx += THREADS) {
    const int r = idx / D0, c = idx - r * D0;
    from_f32(out[r * LDP + c], leaky(epi(r, c, 0.f)));
  }
  __syncthreads();
}

// Hidden layers 1-3 of the column chain: h.W_h only.
template <int N, int KH, typename Epi>
__device__ void hidden(bf16* P, const bf16* wh, Epi epi, float* scratch) {
  layer_bf16<N, KH, 0, true>(P, nullptr, wh, nullptr, epi, P, scratch);
}
template <int N, int KH, typename Epi>
__device__ void hidden(float* P, const float* wh, Epi epi, float*) {
  layer_f32<N, KH, 0, true>(P, nullptr, wh, nullptr, epi, P);
}

// One MLP of the column chain over the tile; pred[r] = sigmoid(logit).
template <typename T, bool RUNS>
__device__ void mlp_cols(T* P, const float* xs, const float* kfs,
                         const T* __restrict__ w,
                         const float* __restrict__ b, float* colb,
                         float* wzs, float* wps, const float* zrow,
                         const float* predc, float* scratch, float* pred) {
  using S = Shape<T, RUNS>;
  constexpr int BN = S::BN, RPG = S::RPG;
  column_terms<T, S::G>(xs, kfs, RUNS, w, b, colb, wzs, wps);
  __syncthreads();
  auto epi = [&](int col_off) {
    return ColsEpi<T, RPG>{colb + col_off, wzs + col_off, wps + col_off,
                           zrow, predc};
  };
  layer0_cols<T, BN, Tile<T>::LDP>(P, epi(COL0));
  hidden<D1, D0>(P, w + OFF_W1H, BiasEpi{b + OFF_B1}, scratch);
  hidden<D2, D1>(P, w + OFF_W2H, epi(COL2), scratch);
  hidden<D3, D2>(P, w + OFF_W3H, epi(COL3), scratch);
  final_layer<T, BN, 0>(P, Tile<T>::LDP, (const T*)nullptr, 0,
                        w + OFF_W4H, (const T*)nullptr,
                        ColsExtra<T, RPG>{epi(COL4)}, pred);
}

template <typename T, bool RUNS>
__device__ void cols_body(const ColsArgs& a) {
  using S = Shape<T, RUNS>;
  constexpr int BN = S::BN, RPG = S::RPG, G = S::G;
  extern __shared__ __align__(128) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  float* f = reinterpret_cast<float*>(smem + (size_t)BN * Tile<T>::LDP *
                                                 sizeof(T));
  float* scratch = f + (threadIdx.x >> 5) * 256;  // bf16 only
  float* colb = f + Tile<T>::SCRATCH;
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
    xs[idx] = round_to<T>(v);
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
  mlp_cols<T, RUNS>(P, xs, kfs, (const T*)a.wlr, a.blr, colb, wzs, wps,
                    zrow, predc, scratch, pred);
  if (t < BN) {
    predc[t] = pred[t];
    if (o >= 0) a.out_lr[o] = pred[t];
  }
  __syncthreads();
  mlp_cols<T, RUNS>(P, xs, kfs, (const T*)a.whr, a.bhr, colb, wzs, wps,
                    zrow, predc, scratch, pred);
  if (o >= 0) a.out_hr[o] = pred[t];
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_cols_bf16_kernel(ColsArgs a) { cols_body<bf16, false>(a); }
__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_cols_f32_kernel(ColsArgs a) { cols_body<float, false>(a); }
__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_runs_bf16_kernel(ColsArgs a) { cols_body<bf16, true>(a); }
__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_runs_f32_kernel(ColsArgs a) { cols_body<float, true>(a); }

template <typename T, bool RUNS>
int launch(void (*kernel)(ColsArgs), ColsArgs a, void* stream) {
  using S = Shape<T, RUNS>;
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
                  (const float*)kf, (const float*)zf, n, z, 0, wlr,
                  (const float*)blr, whr, (const float*)bhr, (float*)out_hr,
                  (float*)out_lr};
}

}  // namespace

extern "C" {

// Launch K3 on `stream`; returns cudaGetLastError() (0 on success).
// x_lr [ncol, c_lr], x_hr [ncol, 320 - c_lr], zf [z] float32; packed
// weights in the compute dtype, packed float32 biases; out_* [ncol, z]
// float32.
int surs_fused_dual_mlp_cols_bf16(const void* x_lr, const void* x_hr,
                                  int c_lr, const void* zf, int ncol, int z,
                                  const void* wlr, const void* blr,
                                  const void* whr, const void* bhr,
                                  void* out_hr, void* out_lr, void* stream) {
  return launch<bf16, false>(
      fused_dual_mlp_cols_bf16_kernel,
      args(x_lr, x_hr, c_lr, nullptr, zf, ncol, z, wlr, blr, whr, bhr,
           out_hr, out_lr), stream);
}

int surs_fused_dual_mlp_cols_f32(const void* x_lr, const void* x_hr,
                                 int c_lr, const void* zf, int ncol, int z,
                                 const void* wlr, const void* blr,
                                 const void* whr, const void* bhr,
                                 void* out_hr, void* out_lr, void* stream) {
  return launch<float, false>(
      fused_dual_mlp_cols_f32_kernel,
      args(x_lr, x_hr, c_lr, nullptr, zf, ncol, z, wlr, blr, whr, bhr,
           out_hr, out_lr), stream);
}

// Launch K4 on `stream`; returns cudaGetLastError() (0 on success).
// x_lr [nr, c_lr], x_hr [nr, 320 - c_lr], kf [nr], zt [8] float32;
// weights as K3; out_* [nr, 8] float32.
int surs_fused_dual_mlp_runs_bf16(const void* x_lr, const void* x_hr,
                                  int c_lr, const void* kf, const void* zt,
                                  int nr, const void* wlr, const void* blr,
                                  const void* whr, const void* bhr,
                                  void* out_hr, void* out_lr, void* stream) {
  return launch<bf16, true>(
      fused_dual_mlp_runs_bf16_kernel,
      args(x_lr, x_hr, c_lr, kf, zt, nr, WIN, wlr, blr, whr, bhr, out_hr,
           out_lr), stream);
}

int surs_fused_dual_mlp_runs_f32(const void* x_lr, const void* x_hr,
                                 int c_lr, const void* kf, const void* zt,
                                 int nr, const void* wlr, const void* blr,
                                 const void* whr, const void* bhr,
                                 void* out_hr, void* out_lr, void* stream) {
  return launch<float, true>(
      fused_dual_mlp_runs_f32_kernel,
      args(x_lr, x_hr, c_lr, kf, zt, nr, WIN, wlr, blr, whr, bhr, out_hr,
           out_lr), stream);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
