// Kernel K1: the fused dual occupancy MLP on Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_dual_mlp` (body `_kernel`) of
// surs_tpu/ops/fused_mlp.py. Per point it runs the coarse MLP
// 321 -> 1024 -> 512 -> 256 -> 128 -> 1 (the input re-concatenated before
// layers 2-4, leaky-ReLU 0.01 between layers, sigmoid -> pred_lr), then the
// fine MLP of the same shape on [x, pred_lr] (322 inputs) -> pred_hr.
//
// What bounds it: about 4.57 MFLOP per point against 1.3 KB of input and
// output, so one 50,000-point call is about 228 GFLOP against 64 MB: it is
// bound by the tensor cores, not by memory. The design keeps the work on
// the tensor cores and every activation on chip:
//   * one block per tile of BN points runs the whole dual chain;
//   * the input tile is staged once, rounded to the compute dtype, and
//     stays in shared memory for the residual layers of both MLPs;
//   * each layer's activations are written to shared memory in the compute
//     dtype; a layer whose whole output fits in the warps' accumulators
//     overwrites its own input after a barrier, so one [BN, 1024] buffer
//     serves every layer;
//   * residual layers accumulate h.W_h + x.W_x from two row blocks of the
//     weight and never build the concatenation;
//   * weights (about 4.6 MB in bf16) are read from global memory, where
//     they stay resident in the 50 MB L2; each warp owns a band of output
//     columns over all BN rows, so each weight fragment is fetched once per
//     block and used for every row tile.
// Rounding follows the TPU kernel: the input, the activations and pred_lr
// are cast to the compute dtype before their product; accumulation, bias,
// leaky-ReLU and sigmoid are float32.
//
// The bf16 instantiation uses nvcuda::wmma 16x16x16 with float32
// accumulators (BN = 64); the float32 one uses FMA loops (BN = 32). Not yet
// done, for a later change: wgmma, TMA weight staging, a persistent grid,
// and the feature gather fused into the prologue.
//
// Kernel K2, the training variant (coarse and fine MLP on two point
// sets), is at the end of the file and reuses this device code.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrappers are ops/fused_mlp.py:fused_dual_mlp
// and fused_dual_mlp_train.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stddef.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// Reference widths (ops/fused_mlp.py checks them before a launch).
constexpr int XK = 336;  // padded input width: 321 / 322 rounded up to 16
constexpr int D0 = 1024, D1 = 512, D2 = 256, D3 = 128;

// Packed weight buffer of one MLP (elements), built by
// ops/fused_mlp.py:prepare_fused_weights. Each block is [in, out] row-major.
constexpr size_t OFF_W0X = 0;                                  // [XK, D0]
constexpr size_t OFF_W1H = OFF_W0X + (size_t)XK * D0;          // [D0, D1]
constexpr size_t OFF_W2H = OFF_W1H + (size_t)D0 * D1;          // [D1, D2]
constexpr size_t OFF_W2X = OFF_W2H + (size_t)D1 * D2;          // [XK, D2]
constexpr size_t OFF_W3H = OFF_W2X + (size_t)XK * D2;          // [D2, D3]
constexpr size_t OFF_W3X = OFF_W3H + (size_t)D2 * D3;          // [XK, D3]
constexpr size_t OFF_W4H = OFF_W3X + (size_t)XK * D3;          // [D3]
constexpr size_t OFF_W4X = OFF_W4H + D3;                       // [XK]
constexpr int OFF_B0 = 0, OFF_B1 = D0, OFF_B2 = D0 + D1,
              OFF_B3 = D0 + D1 + D2, OFF_B4 = D0 + D1 + D2 + D3;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(bf16& d, float v) {
  d = __float2bfloat16(v);
}
__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.01f * v;
}

// Stage BN input rows into smem as [BN, ldx] in the compute dtype: columns
// [0, w0) from x0, [w0, w0 + w1) from x1, zeros elsewhere and past n.
template <typename T, int BN>
__device__ void stage_input(T* X, int ldx, const float* __restrict__ x0,
                            int w0, const float* __restrict__ x1, int w1,
                            int n, int base) {
  for (int idx = threadIdx.x; idx < BN * ldx; idx += THREADS) {
    const int p = idx / ldx, c = idx - p * ldx, g = base + p;
    float v = 0.f;
    if (g < n) {
      if (c < w0) v = x0[(size_t)g * w0 + c];
      else if (c < w0 + w1) v = x1[(size_t)g * w1 + (c - w0)];
    }
    from_f32(X[idx], v);
  }
}

// Last layer (one output): a warp per group of points, lanes split the
// h.w_h + x.w_x dot product; sigmoid into pred[BN].
template <typename T, int BN>
__device__ void final_layer(const T* P, int ldp, const T* X, int ldx,
                            const T* __restrict__ wh,
                            const T* __restrict__ wx, float b, float* pred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < BN / WARPS; ++i) {
    const int p = warp * (BN / WARPS) + i;
    float s = 0.f;
    for (int k = lane; k < D3; k += 32)
      s += to_f32(P[p * ldp + k]) * to_f32(wh[k]);
    for (int k = lane; k < XK; k += 32)
      s += to_f32(X[p * ldx + k]) * to_f32(wx[k]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) pred[p] = 1.f / (1.f + expf(-(s + b)));
  }
  __syncthreads();
}

// ---------------------------------------------------------------- bf16 ---
constexpr int BN16 = 64;
constexpr int LDX16 = XK + 8;  // row pads keep wmma's smem rows off one bank
constexpr int LDP16 = D0 + 8;
constexpr size_t SMEM16 = (size_t)BN16 * LDX16 * 2 + (size_t)BN16 * LDP16 * 2 +
                          (size_t)WARPS * 256 * 4 + BN16 * 4;

// One hidden layer: out[BN16, N] = leaky(h[:, :KH].Wh + X[:, :KX].Wx + b).
// Warp w owns output column tiles [w * TPW, (w + 1) * TPW), taken CT at a
// time with a 4 x CT block of accumulators (all 64 rows). IN_PLACE layers
// finish every read of `h` before the barrier and then overwrite it.
template <int N, int KH, int KX, bool IN_PLACE>
__device__ void layer_bf16(const bf16* h, const bf16* X,
                           const bf16* __restrict__ wh,
                           const bf16* __restrict__ wx,
                           const float* __restrict__ bias, bf16* out,
                           float* scratch) {
  constexpr int TPW = N / 16 / WARPS;
  constexpr int CT = TPW < 4 ? TPW : 4;
  constexpr int PASSES = TPW / CT;
  static_assert(TPW >= 1 && TPW % CT == 0, "bad layer width");
  static_assert(!IN_PLACE || PASSES == 1, "in-place needs one pass");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int pass = 0; pass < PASSES; ++pass) {
    const int col0 = (warp * TPW + pass * CT) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][CT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) wmma::fill_fragment(acc[r][c], 0.f);

#pragma unroll 1
    for (int k = 0; k < KH; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wmma::load_matrix_sync(a[r], h + r * 16 * LDP16 + k, LDP16);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wh + (size_t)k * N + col0 + c * 16, N);
#pragma unroll
        for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[r][c], a[r], b, acc[r][c]);
      }
    }
#pragma unroll 1
    for (int k = 0; k < KX; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wmma::load_matrix_sync(a[r], X + r * 16 * LDX16 + k, LDX16);
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wx + (size_t)k * N + col0 + c * 16, N);
#pragma unroll
        for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[r][c], a[r], b, acc[r][c]);
      }
    }
    if (IN_PLACE) __syncthreads();

    // epilogue through a per-warp 16x16 float tile: bias, leaky, round
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        wmma::store_matrix_sync(scratch, acc[r][c], 16, wmma::mem_row_major);
        __syncwarp();
        const int cb = col0 + c * 16;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = lane + 32 * e, row = idx >> 4, col = idx & 15;
          out[(r * 16 + row) * LDP16 + cb + col] =
              __float2bfloat16(leaky(scratch[idx] + bias[cb + col]));
        }
        __syncwarp();
      }
  }
  __syncthreads();
}

__device__ void mlp_bf16(bf16* P, const bf16* X, const bf16* __restrict__ w,
                         const float* __restrict__ b, float* scratch,
                         float* pred) {
  layer_bf16<D0, 0, XK, false>(P, X, nullptr, w + OFF_W0X, b + OFF_B0, P,
                               scratch);
  layer_bf16<D1, D0, 0, true>(P, X, w + OFF_W1H, nullptr, b + OFF_B1, P,
                              scratch);
  layer_bf16<D2, D1, XK, true>(P, X, w + OFF_W2H, w + OFF_W2X, b + OFF_B2, P,
                               scratch);
  layer_bf16<D3, D2, XK, true>(P, X, w + OFF_W3H, w + OFF_W3X, b + OFF_B3, P,
                               scratch);
  final_layer<bf16, BN16>(P, LDP16, X, LDX16, w + OFF_W4H, w + OFF_W4X,
                          b[OFF_B4], pred);
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_bf16_kernel(const float* __restrict__ x0, int w0,
                               const float* __restrict__ x1, int w1, int n,
                               const bf16* __restrict__ wlr,
                               const float* __restrict__ blr,
                               const bf16* __restrict__ whr,
                               const float* __restrict__ bhr,
                               float* __restrict__ out_hr,
                               float* __restrict__ out_lr) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + (size_t)BN16 * LDX16 * 2);
  float* scratch_all = reinterpret_cast<float*>(
      smem + (size_t)BN16 * LDX16 * 2 + (size_t)BN16 * LDP16 * 2);
  float* scratch = scratch_all + (threadIdx.x >> 5) * 256;
  float* pred = scratch_all + WARPS * 256;
  const int base = blockIdx.x * BN16;
  const int t = threadIdx.x;

  stage_input<bf16, BN16>(X, LDX16, x0, w0, x1, w1, n, base);
  __syncthreads();
  mlp_bf16(P, X, wlr, blr, scratch, pred);
  if (t < BN16) {
    // the fine MLP reads the coarse prediction as input column w0 + w1
    X[t * LDX16 + w0 + w1] = __float2bfloat16(pred[t]);
    if (base + t < n) out_lr[base + t] = pred[t];
  }
  __syncthreads();
  mlp_bf16(P, X, whr, bhr, scratch, pred);
  if (t < BN16 && base + t < n) out_hr[base + t] = pred[t];
}

// ----------------------------------------------------------------- f32 ---
constexpr int BN32 = 32;
constexpr int LDX32 = XK + 4;
constexpr int LDP32 = D0 + 4;
constexpr size_t SMEM32 = (size_t)BN32 * LDX32 * 4 +
                          (size_t)BN32 * LDP32 * 4 + BN32 * 4;

// One hidden layer in float32 FMA loops: each thread owns an 8 x 8 tile
// of the [BN32, N] output (N / 2 tiles, taken THREADS at a time).
template <int N, int KH, int KX, bool IN_PLACE>
__device__ void layer_f32(const float* h, const float* X,
                          const float* __restrict__ wh,
                          const float* __restrict__ wx,
                          const float* __restrict__ bias, float* out) {
  constexpr int CG = N / 8;             // column groups
  constexpr int TILES = (BN32 / 8) * CG;
  constexpr int PASSES = (TILES + THREADS - 1) / THREADS;
  static_assert(!IN_PLACE || PASSES == 1, "in-place needs one pass");
  for (int pass = 0; pass < PASSES; ++pass) {
    const int tile = pass * THREADS + threadIdx.x;
    const bool active = tile < TILES;
    const int rg = tile / CG, cg = tile % CG;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    if (active) {
#pragma unroll 2
      for (int k = 0; k < KH; ++k) {
        float a[8], w[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = h[(rg * 8 + r) * LDP32 + k];
        const float4 w0 = *reinterpret_cast<const float4*>(wh + (size_t)k * N + cg * 8);
        const float4 w1 = *reinterpret_cast<const float4*>(wh + (size_t)k * N + cg * 8 + 4);
        w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
        w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
#pragma unroll 2
      for (int k = 0; k < KX; ++k) {
        float a[8], w[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = X[(rg * 8 + r) * LDX32 + k];
        const float4 w0 = *reinterpret_cast<const float4*>(wx + (size_t)k * N + cg * 8);
        const float4 w1 = *reinterpret_cast<const float4*>(wx + (size_t)k * N + cg * 8 + 4);
        w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
        w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
      }
    }
    if (IN_PLACE) __syncthreads();
    if (active) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          out[(rg * 8 + r) * LDP32 + cg * 8 + c] =
              leaky(acc[r][c] + bias[cg * 8 + c]);
    }
  }
  __syncthreads();
}

__device__ void mlp_f32(float* P, const float* X, const float* __restrict__ w,
                        const float* __restrict__ b, float* pred) {
  layer_f32<D0, 0, XK, false>(P, X, nullptr, w + OFF_W0X, b + OFF_B0, P);
  layer_f32<D1, D0, 0, true>(P, X, w + OFF_W1H, nullptr, b + OFF_B1, P);
  layer_f32<D2, D1, XK, true>(P, X, w + OFF_W2H, w + OFF_W2X, b + OFF_B2, P);
  layer_f32<D3, D2, XK, true>(P, X, w + OFF_W3H, w + OFF_W3X, b + OFF_B3, P);
  final_layer<float, BN32>(P, LDP32, X, LDX32, w + OFF_W4H, w + OFF_W4X,
                           b[OFF_B4], pred);
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_f32_kernel(const float* __restrict__ x0, int w0,
                              const float* __restrict__ x1, int w1, int n,
                              const float* __restrict__ wlr,
                              const float* __restrict__ blr,
                              const float* __restrict__ whr,
                              const float* __restrict__ bhr,
                              float* __restrict__ out_hr,
                              float* __restrict__ out_lr) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  float* P = X + BN32 * LDX32;
  float* pred = P + BN32 * LDP32;
  const int base = blockIdx.x * BN32;
  const int t = threadIdx.x;

  stage_input<float, BN32>(X, LDX32, x0, w0, x1, w1, n, base);
  __syncthreads();
  mlp_f32(P, X, wlr, blr, pred);
  if (t < BN32) {
    X[t * LDX32 + w0 + w1] = pred[t];
    if (base + t < n) out_lr[base + t] = pred[t];
  }
  __syncthreads();
  mlp_f32(P, X, whr, bhr, pred);
  if (t < BN32 && base + t < n) out_hr[base + t] = pred[t];
}

// ------------------------------------------------------- K2, float32 ---
// Kernel K2: the training variant. Replaces the Pallas kernel
// `fused_dual_mlp_train` (body `_kernel_train`) of
// surs_tpu/ops/fused_mlp.py. The coarse MLP runs on xa (the HR sample
// points), the fine MLP on [xb, mask_a * pred_lr] (the LR sample points,
// conditioned on the masked coarse prediction); both outputs unmasked.
// Training keeps float32 weights, so only the float32 instantiation
// exists. Same work per point as K1 (about 4.57 MFLOP against 2.6 KB of
// input): bound by operations. It reuses K1's device code and shared
// memory: once the coarse chain is done, xb is restaged into the same X
// tile, which is possible because the residual layers of each MLP read
// only that MLP's own input.
__global__ void __launch_bounds__(THREADS, 1)
    fused_dual_mlp_train_f32_kernel(const float* __restrict__ xa,
                                    const float* __restrict__ xb,
                                    const float* __restrict__ mask_a,
                                    int w, int n,
                                    const float* __restrict__ wlr,
                                    const float* __restrict__ blr,
                                    const float* __restrict__ whr,
                                    const float* __restrict__ bhr,
                                    float* __restrict__ out_hr,
                                    float* __restrict__ out_lr) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem);
  float* P = X + BN32 * LDX32;
  float* pred = P + BN32 * LDP32;
  const int base = blockIdx.x * BN32;
  const int t = threadIdx.x;

  stage_input<float, BN32>(X, LDX32, xa, w, nullptr, 0, n, base);
  __syncthreads();
  mlp_f32(P, X, wlr, blr, pred);  // ends in a barrier: X is free again
  if (t < BN32 && base + t < n) out_lr[base + t] = pred[t];
  stage_input<float, BN32>(X, LDX32, xb, w, nullptr, 0, n, base);
  __syncthreads();
  if (t < BN32) {
    // the fine MLP reads the masked coarse prediction as input column w
    X[t * LDX32 + w] = base + t < n ? pred[t] * mask_a[base + t] : 0.f;
  }
  __syncthreads();
  mlp_f32(P, X, whr, bhr, pred);
  if (t < BN32 && base + t < n) out_hr[base + t] = pred[t];
}

}  // namespace

extern "C" {

// Launch K1 on `stream`; returns cudaGetLastError() (0 on success).
// x0 [n, w0] and x1 [n, w1] float32 (x1 may be null when w1 == 0),
// w0 + w1 == 321; w_* packed weights, b_* packed float32 biases;
// out_* [n] float32.
int surs_fused_dual_mlp_bf16(const void* x0, int w0, const void* x1, int w1,
                             int n, const void* wlr, const void* blr,
                             const void* whr, const void* bhr, void* out_hr,
                             void* out_lr, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_dual_mlp_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM16);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + BN16 - 1) / BN16;
  fused_dual_mlp_bf16_kernel<<<blocks, THREADS, SMEM16,
                               (cudaStream_t)stream>>>(
      (const float*)x0, w0, (const float*)x1, w1, n, (const bf16*)wlr,
      (const float*)blr, (const bf16*)whr, (const float*)bhr, (float*)out_hr,
      (float*)out_lr);
  return (int)cudaGetLastError();
}

int surs_fused_dual_mlp_f32(const void* x0, int w0, const void* x1, int w1,
                            int n, const void* wlr, const void* blr,
                            const void* whr, const void* bhr, void* out_hr,
                            void* out_lr, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_dual_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM32);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + BN32 - 1) / BN32;
  fused_dual_mlp_f32_kernel<<<blocks, THREADS, SMEM32,
                              (cudaStream_t)stream>>>(
      (const float*)x0, w0, (const float*)x1, w1, n, (const float*)wlr,
      (const float*)blr, (const float*)whr, (const float*)bhr,
      (float*)out_hr, (float*)out_lr);
  return (int)cudaGetLastError();
}

// Launch K2 on `stream`; returns cudaGetLastError() (0 on success).
// xa, xb [n, w] float32 with w == 321, mask_a [n] float32; float32
// packed weights and biases; out_* [n] float32.
int surs_fused_dual_mlp_train_f32(const void* xa, const void* xb,
                                  const void* mask_a, int w, int n,
                                  const void* wlr, const void* blr,
                                  const void* whr, const void* bhr,
                                  void* out_hr, void* out_lr, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_dual_mlp_train_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM32);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + BN32 - 1) / BN32;
  fused_dual_mlp_train_f32_kernel<<<blocks, THREADS, SMEM32,
                                    (cudaStream_t)stream>>>(
      (const float*)xa, (const float*)xb, (const float*)mask_a, w, n,
      (const float*)wlr, (const float*)blr, (const float*)whr,
      (const float*)bhr, (float*)out_hr, (float*)out_lr);
  return (int)cudaGetLastError();
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
