// Device code shared by the fused dual-MLP kernels (K1 in
// fused_dual_mlp.cu, K2 in fused_train_tf32.cu, K3 and K4 in
// fused_cols_mlp.cu): the reference widths, the packed weight layout, and
// the float32 K1's FMA design: one 32-row hidden layer with activations
// in shared memory.
//
// A layer's epilogue is a functor `epi(row, col, acc) -> pre-activation`:
// the float32 K1's adds the bias.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

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
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.01f * v;
}

// The plain epilogue: acc + bias[col].
struct BiasEpi {
  const float* b;
  __device__ __forceinline__ float operator()(int, int c, float v) const {
    return v + b[c];
  }
};

// A per-point term that does not depend on the point: the last bias.
struct ConstExtra {
  float b;
  __device__ __forceinline__ float operator()(int) const { return b; }
};

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
// h.w_h (+ x.w_x over KX input columns) dot product;
// pred[p] = sigmoid(dot + extra(p)).
template <typename T, int BN, int KX, typename Extra>
__device__ void final_layer(const T* P, int ldp, const T* X, int ldx,
                            const T* __restrict__ wh,
                            const T* __restrict__ wx, Extra extra,
                            float* pred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < BN / WARPS; ++i) {
    const int p = warp * (BN / WARPS) + i;
    float s = 0.f;
    for (int k = lane; k < D3; k += 32)
      s += to_f32(P[p * ldp + k]) * to_f32(wh[k]);
    for (int k = lane; k < KX; k += 32)
      s += to_f32(X[p * ldx + k]) * to_f32(wx[k]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) pred[p] = 1.f / (1.f + expf(-(s + extra(p))));
  }
  __syncthreads();
}

// ----------------------------------------------------------------- f32 ---
constexpr int BN32 = 32;
constexpr int LDX32 = XK + 4;
constexpr int LDP32 = D0 + 4;

// One hidden layer in float32 FMA loops: each thread owns an 8 x 8 tile
// of the [BN32, N] output (N / 2 tiles, taken THREADS at a time).
template <int N, int KH, int KX, bool IN_PLACE, typename Epi>
__device__ void layer_f32(const float* h, const float* X,
                          const float* __restrict__ wh,
                          const float* __restrict__ wx, Epi epi, float* out) {
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
              leaky(epi(rg * 8 + r, cg * 8 + c, acc[r][c]));
    }
  }
  __syncthreads();
}

}  // namespace
