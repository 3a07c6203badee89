// Kernel K5: a row gather by index on Hopper (sm_90a).
//
// Replaces the Pallas kernel of benchmarks/vmem_gather_probe.py (`build()`,
// bodies `kernel_vec` and `kernel_loop`): out[i, :] = feat[idx[i], :] for a
// feature map feat [rows, C] and int32 indices idx [n]. The TPU probe asked
// whether a kernel can gather rows from a map kept on the chip; there
// variant A (an in-kernel vector take) did not lower and variant B (a loop
// of one-row copies, indices in SMEM) crashed the compiler.
//
// What bounds it: bytes; it does no arithmetic. At the probe's shape (a
// [16384, 256] bf16 map, 49,152 indices) the map read once, the indices and
// the rows written once are 33.8 MB (roofline.k5_work): 0.0101 ms at
// 3.35 TB/s. The 8.4 MB map fits in the 50 MB L2 many times over, so across
// launches it stays there: a warm launch reads it from L2 and can beat that
// bound; only a launch with L2 cold is held to it.
//
// Both variants copy bytes, 16 at a time, and never convert a value: bf16
// and float32 differ only in the row's width in bytes, which must be a
// multiple of 16 on a 16-byte-aligned base (the wrapper checks both).
//   vec:  the TPU's "vector gather" rethought for Hopper. A row is `vecs`
//         16-byte vectors and each thread copies one vector of one row with
//         __ldg of uint4, so a 512-byte bf16 row of 256 channels is one
//         warp-wide coalesced read and one coalesced write; a block takes
//         THREADS / vecs rows per pass, grid-stride over the rows.
//   loop: the TPU's grid: one block per BLOCK = 512 indices. The block
//         first loads its indices into shared memory (the TPU's SMEM index
//         block), then copies its rows through shared memory with cp.async
//         (16 B) and writes each sub-tile out coalesced. A whole 512-row
//         tile of 512-byte rows is 256 KB, more than a block's 227 KB, so
//         the rows go in sub-tiles of STAGE_BYTES (64 rows of 512 B),
//         double-buffered: the next sub-tile's copies are in flight while
//         the current one is written out.
// An index outside [0, rows) gives a row of zeros: no read leaves feat.
// Row offsets are 64-bit. Not yet done, for a later change: TMA, an L2
// access-policy window that pins the map.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrapper is ops/row_gather.py:row_gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK = 512;              // indices per block of `loop`
constexpr int STAGE_BYTES = 32 * 1024;  // one shared-memory sub-tile
constexpr long long MAX_BLOCKS = 65535;

__device__ __forceinline__ bool in_range(int r, int rows) {
  return (unsigned)r < (unsigned)rows;
}

// vecs 16-byte vectors per row; each thread owns one row of a pass (rr)
// and the vectors v0, v0 + THREADS, ... of it.
struct Lanes {
  int vecs, per, rr, v0;
  __device__ Lanes(int row_bytes)
      : vecs(row_bytes / 16),
        per(max(1, THREADS / vecs)),
        rr(threadIdx.x / vecs),
        v0(threadIdx.x - (threadIdx.x / vecs) * vecs) {}
};

template <typename T>
__device__ void vec_body(const T* __restrict__ feat_,
                         const int* __restrict__ idx, T* __restrict__ out_,
                         int rows, int channels, int n) {
  const Lanes L(channels * (int)sizeof(T));
  if (L.rr >= L.per) return;
  const uint4* feat = reinterpret_cast<const uint4*>(feat_);
  uint4* out = reinterpret_cast<uint4*>(out_);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long step = (long long)gridDim.x * L.per;
  for (long long i = (long long)blockIdx.x * L.per + L.rr; i < n; i += step) {
    const int r = __ldg(idx + i);
    const bool ok = in_range(r, rows);
    const uint4* src = feat + (long long)(ok ? r : 0) * L.vecs;
    uint4* dst = out + i * L.vecs;
    for (int v = L.v0; v < L.vecs; v += THREADS)
      dst[v] = ok ? __ldg(src + v) : zero;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows per sub-tile for rows of `row_bytes`.
__host__ __device__ int stage_rows(int row_bytes) {
  return row_bytes < STAGE_BYTES ? STAGE_BYTES / row_bytes : 1;
}

template <typename T>
__device__ void loop_body(const T* __restrict__ feat_,
                          const int* __restrict__ idx, T* __restrict__ out_,
                          int rows, int channels, int n) {
  extern __shared__ uint4 tile[];  // two sub-tiles
  __shared__ int sidx[BLOCK];
  const int row_bytes = channels * (int)sizeof(T);
  const Lanes L(row_bytes);
  const uint4* feat = reinterpret_cast<const uint4*>(feat_);
  uint4* out = reinterpret_cast<uint4*>(out_);
  const long long row0 = (long long)blockIdx.x * BLOCK;
  const int nb = (int)min((long long)BLOCK, n - row0);
  for (int i = threadIdx.x; i < nb; i += THREADS) sidx[i] = idx[row0 + i];
  __syncthreads();

  const int sub = stage_rows(row_bytes);
  const int nsub = (nb + sub - 1) / sub;
  // Start the copies of sub-tile s into buffer s & 1.
  auto start_copies = [&](int s) {
    uint4* buf = tile + (s & 1) * sub * L.vecs;
    const int r0 = s * sub, cnt = min(sub, nb - r0);
    for (int k = L.rr; k < cnt && L.rr < L.per; k += L.per) {
      const int r = sidx[r0 + k];
      uint4* d = buf + k * L.vecs;
      if (in_range(r, rows)) {
        const uint4* src = feat + (long long)r * L.vecs;
        for (int v = L.v0; v < L.vecs; v += THREADS)
          cp_async16(d + v, src + v);
      } else {
        for (int v = L.v0; v < L.vecs; v += THREADS)
          d[v] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  start_copies(0);
  for (int s = 0; s < nsub; ++s) {
    if (s + 1 < nsub) {
      start_copies(s + 1);
      cp_async_wait<1>();  // sub-tile s has landed, s + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* buf = tile + (s & 1) * sub * L.vecs;
    const int cnt = min(sub, nb - s * sub);
    uint4* dst = out + (row0 + (long long)s * sub) * L.vecs;
    for (int k = L.rr; k < cnt && L.rr < L.per; k += L.per)
      for (int v = L.v0; v < L.vecs; v += THREADS)
        dst[k * L.vecs + v] = buf[k * L.vecs + v];
    __syncthreads();  // buffer s & 1 is free for sub-tile s + 2
  }
}

__global__ void __launch_bounds__(THREADS)
    row_gather_vec_bf16_kernel(const __nv_bfloat16* feat, const int* idx,
                               __nv_bfloat16* out, int rows, int channels,
                               int n) {
  vec_body(feat, idx, out, rows, channels, n);
}
__global__ void __launch_bounds__(THREADS)
    row_gather_vec_f32_kernel(const float* feat, const int* idx, float* out,
                              int rows, int channels, int n) {
  vec_body(feat, idx, out, rows, channels, n);
}
__global__ void __launch_bounds__(THREADS)
    row_gather_loop_bf16_kernel(const __nv_bfloat16* feat, const int* idx,
                                __nv_bfloat16* out, int rows, int channels,
                                int n) {
  loop_body(feat, idx, out, rows, channels, n);
}
__global__ void __launch_bounds__(THREADS)
    row_gather_loop_f32_kernel(const float* feat, const int* idx, float* out,
                               int rows, int channels, int n) {
  loop_body(feat, idx, out, rows, channels, n);
}

template <typename T>
int launch(void (*kernel)(const T*, const int*, T*, int, int, int), bool loop,
           const void* feat, const void* idx, void* out, int rows,
           int channels, int n, void* stream) {
  const int row_bytes = channels * (int)sizeof(T);
  if (channels <= 0 || row_bytes % 16 != 0 || rows < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  long long blocks;
  size_t smem = 0;
  if (loop) {
    smem = (size_t)2 * stage_rows(row_bytes) * row_bytes;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    blocks = (n + BLOCK - 1) / BLOCK;
  } else {
    const int per = std::max(1, THREADS / (row_bytes / 16));
    blocks = std::min((n + (long long)per - 1) / per, MAX_BLOCKS);
  }
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)feat, (const int*)idx, (T*)out, rows, channels, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K5 on `stream`; returns cudaGetLastError() (0 on success).
// feat [rows, channels] (channels * element size a multiple of 16 bytes,
// 16-byte-aligned base), idx [n] int32, out [n, channels] in feat's dtype.
int surs_row_gather_vec_bf16(const void* feat, const void* idx, void* out,
                             int rows, int channels, int n, void* stream) {
  return launch<__nv_bfloat16>(row_gather_vec_bf16_kernel, false, feat, idx,
                               out, rows, channels, n, stream);
}

int surs_row_gather_vec_f32(const void* feat, const void* idx, void* out,
                            int rows, int channels, int n, void* stream) {
  return launch<float>(row_gather_vec_f32_kernel, false, feat, idx, out, rows,
                       channels, n, stream);
}

int surs_row_gather_loop_bf16(const void* feat, const void* idx, void* out,
                              int rows, int channels, int n, void* stream) {
  return launch<__nv_bfloat16>(row_gather_loop_bf16_kernel, true, feat, idx,
                               out, rows, channels, n, stream);
}

int surs_row_gather_loop_f32(const void* feat, const void* idx, void* out,
                             int rows, int channels, int n, void* stream) {
  return launch<float>(row_gather_loop_f32_kernel, true, feat, idx, out, rows,
                       channels, n, stream);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
