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
// sets), is at the end of the file and reuses this device code. The
// hidden-layer device code lives in dual_mlp.cuh, shared with K3 and K4
// (fused_cols_mlp.cu).
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrappers are ops/fused_mlp.py:fused_dual_mlp
// and fused_dual_mlp_train.

#include "dual_mlp.cuh"

namespace {

constexpr size_t SMEM16 = (size_t)BN16 * LDX16 * 2 + (size_t)BN16 * LDP16 * 2 +
                          (size_t)WARPS * 256 * 4 + BN16 * 4;

__device__ void mlp_bf16(bf16* P, const bf16* X, const bf16* __restrict__ w,
                         const float* __restrict__ b, float* scratch,
                         float* pred) {
  layer_bf16<D0, 0, XK, false>(P, X, nullptr, w + OFF_W0X,
                               BiasEpi{b + OFF_B0}, P, scratch);
  layer_bf16<D1, D0, 0, true>(P, X, w + OFF_W1H, nullptr, BiasEpi{b + OFF_B1},
                              P, scratch);
  layer_bf16<D2, D1, XK, true>(P, X, w + OFF_W2H, w + OFF_W2X,
                               BiasEpi{b + OFF_B2}, P, scratch);
  layer_bf16<D3, D2, XK, true>(P, X, w + OFF_W3H, w + OFF_W3X,
                               BiasEpi{b + OFF_B3}, P, scratch);
  final_layer<bf16, BN16, XK>(P, LDP16, X, LDX16, w + OFF_W4H, w + OFF_W4X,
                              ConstExtra{b[OFF_B4]}, pred);
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
constexpr size_t SMEM32 = (size_t)BN32 * LDX32 * 4 +
                          (size_t)BN32 * LDP32 * 4 + BN32 * 4;

__device__ void mlp_f32(float* P, const float* X, const float* __restrict__ w,
                        const float* __restrict__ b, float* pred) {
  layer_f32<D0, 0, XK, false>(P, X, nullptr, w + OFF_W0X, BiasEpi{b + OFF_B0},
                              P);
  layer_f32<D1, D0, 0, true>(P, X, w + OFF_W1H, nullptr, BiasEpi{b + OFF_B1},
                             P);
  layer_f32<D2, D1, XK, true>(P, X, w + OFF_W2H, w + OFF_W2X,
                              BiasEpi{b + OFF_B2}, P);
  layer_f32<D3, D2, XK, true>(P, X, w + OFF_W3H, w + OFF_W3X,
                              BiasEpi{b + OFF_B3}, P);
  final_layer<float, BN32, XK>(P, LDP32, X, LDX32, w + OFF_W4H, w + OFF_W4X,
                               ConstExtra{b[OFF_B4]}, pred);
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
