// Device code shared by the fused dual-MLP kernels (K1 in
// fused_dual_mlp.cu and fused_cols_mlp.cu, K2 in fused_train_tf32.cu, K3
// and K4 in fused_cols_mlp.cu): the reference widths, the packed weight
// layout, the leaky-ReLU.

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

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : 0.01f * v;
}

}  // namespace
