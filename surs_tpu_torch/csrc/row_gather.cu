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
// 3.35 TB/s. The whole launch is about one wave of copies, so what it
// pays beyond the bytes is latency: the index load, then the row load it
// depends on, then the store. probes/k5_breakdown.py times the read and
// write sides apart, beside a fill of the output and a one-row launch.
//
// Both variants copy bytes and never convert a value: bf16 and float32
// differ only in the row's width in bytes, which must be a multiple of 16
// on a 16-byte-aligned base (the wrapper checks both). Both run on a
// persistent grid that the host plans (ops/row_gather.py:row_gather_plan:
// the card's SMs times the blocks that fit on one) and split the rows, or
// tiles of rows, evenly and contiguously over it, so each piece of the
// output is written in one stream.
//   vec:  the TPU's "vector gather": registers only. A warp owns a
//         contiguous share of the rows and takes them 32 at a time: lane l
//         loads index l in one coalesced read and hands it out with
//         __shfl_sync. The 32 rows' 16-byte vectors are numbered flat (they
//         are contiguous in `out`); each lane loads VEC_UNROLL of them,
//         from VEC_UNROLL different rows when a row is a warp wide, before
//         it stores any, and the next 32 indices are loaded while the rows
//         are in flight. Map reads ask L2 to keep their lines (evict_last,
//         no L1 allocation); the output is stored streaming (st.global.cs),
//         so its 25 MB do not push the 8.4 MB map out of L2.
//   loop: the TPU's "loop of one-row copies", on the bulk-copy engine. A
//         block is one warp that walks its tiles of T rows (T x row bytes
//         is one ring stage of about 8 KB) through a ring of S stages:
//         each lane issues one cp.async.bulk per in-range row of the tile
//         into the stage, lane 0 announces the tile's in-range bytes on the
//         stage's mbarrier, and once the barrier completes lane 0 writes
//         the whole tile back with one bulk store (the tile's output rows
//         are contiguous). Loads run S - 2 tiles ahead of the store; a
//         stage is refilled only after lane 0's bulk wait says the store
//         two tiles back has read it. Several one-warp blocks share an SM,
//         so their index loads overlap.
// An index outside [0, rows) gives a row of zeros: no read leaves feat. In
// `loop` the zeros are written into the stage by the lane that owns the
// row, which then fences them for the async proxy; a tile with no row in
// range expects 0 bytes and still completes its barrier phase. Row offsets
// are 64-bit.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrapper is ops/row_gather.py:row_gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int VEC_THREADS = 256;
constexpr int VEC_UNROLL = 8;       // 16-byte loads in flight per lane
constexpr int LOOP_THREADS = 32;    // one warp per block
constexpr int LOOP_MAX_TILE = 128;  // rows per tile: at most 4 per lane
constexpr int LOOP_MIN_STAGES = 3;  // the loads run S - 2 tiles ahead
constexpr int LOOP_MAX_STAGES = 8;
constexpr int LOOP_BARRIER_BYTES = 128;  // the ring's mbarriers
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool in_range(int r, int rows) {
  return (unsigned)r < (unsigned)rows;
}

// an L2 policy that keeps the lines it touches (the map)
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 ld_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 "
      "{%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// feat [rows, vecs] and out [n, vecs] as 16-byte vectors
__device__ void vec_body(const uint4* __restrict__ feat,
                         const int* __restrict__ idx, uint4* __restrict__ out,
                         int rows, int vecs, int n) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (VEC_THREADS / 32);
  const long long w =
      (long long)blockIdx.x * (VEC_THREADS / 32) + (threadIdx.x >> 5);
  // this warp's rows [begin, end): an even, contiguous share
  const long long begin = w * n / warps, end = (w + 1) * n / warps;
  const uint64_t keep = l2_evict_last();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // flat vector p of a batch lies in row p / vecs at vector p % vecs; a
  // step of 32 vectors is q rows and rm vectors
  const int q = 32 / vecs, rm = 32 - q * vecs;
  const int row_l = lane / vecs, v_l = lane - row_l * vecs;
  int cur = begin + lane < end ? __ldg(idx + begin + lane) : 0;
  for (long long b = begin; b < end; b += 32) {
    // the next 32 indices, in flight while this batch's rows are
    const long long nx = b + 32 + lane;
    const int nxt = nx < end ? __ldg(idx + nx) : 0;
    const int total = (int)min(32LL, end - b) * vecs;
    uint4* dst = out + b * vecs;
    int row = row_l, v = v_l;
    for (int p0 = lane; p0 - lane < total; p0 += 32 * VEC_UNROLL) {
      uint4 val[VEC_UNROLL];
#pragma unroll
      for (int u = 0; u < VEC_UNROLL; ++u) {
        const int r = __shfl_sync(FULL, cur, row & 31);
        uint4 x = zero;
        if (p0 + 32 * u < total && in_range(r, rows))
          x = ld_keep(feat + (long long)r * vecs + v, keep);
        val[u] = x;
        v += rm;
        row += q;
        if (v >= vecs) {
          v -= vecs;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < VEC_UNROLL; ++u)
        if (p0 + 32 * u < total) st_stream(dst + p0 + 32 * u, val[u]);
    }
    cur = nxt;
  }
}

struct LoopArgs {
  const uint8_t* feat;
  const int* idx;
  uint8_t* out;
  int rows, row_bytes, n, tile_rows, stages;
};

// The indices of tile t, lane's rows lane + 32 j.
__device__ __forceinline__ void load_tile_idx(const LoopArgs& a, long long t,
                                              int lane, int (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane + 32 * j;
    const long long i = t * a.tile_rows + k;
    r[j] = (k < a.tile_rows && i < a.n) ? __ldg(a.idx + i) : 0;
  }
}

// Start the copies of tile t into stage `st` whose barrier is `bar`.
__device__ __forceinline__ void issue_tile(const LoopArgs& a, long long t,
                                           int lane, const int (&r)[4],
                                           uint8_t* st, uint32_t bar) {
  const int cnt = (int)min((long long)a.tile_rows, a.n - t * a.tile_rows);
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    mine += (lane + 32 * j < cnt && in_range(r[j], a.rows)) ? 1u : 0u;
  const unsigned total = __reduce_add_sync(FULL, mine);
  if (lane == 0) {
    if (total) mbar_arrive_tx(bar, total * (unsigned)a.row_bytes);
    else mbar_arrive(bar);  // a tile of zero rows: the phase completes
  }
  bool zeros = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane + 32 * j;
    if (k >= cnt) continue;
    uint8_t* d = st + (size_t)k * a.row_bytes;
    if (in_range(r[j], a.rows)) {
      bulk_g2s(smem_u32(d), a.feat + (long long)r[j] * a.row_bytes,
               a.row_bytes, bar);
    } else {
      uint4* z = reinterpret_cast<uint4*>(d);
      for (int v = 0; v < a.row_bytes / 16; ++v)
        z[v] = make_uint4(0u, 0u, 0u, 0u);
      zeros = true;
    }
  }
  // the zeros, written by this lane, visible to the bulk store
  if (zeros) fence_proxy_async();
}

__device__ void loop_body(const LoopArgs& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x;
  const int S = a.stages, ahead = a.stages - 2;
  const long long stage_bytes = (long long)a.tile_rows * a.row_bytes;
  const long long tiles = (a.n + (long long)a.tile_rows - 1) / a.tile_rows;
  // this block's tiles [t0, t0 + nt): an even, contiguous share
  const long long t0 = blockIdx.x * tiles / gridDim.x;
  const long long nt = (blockIdx.x + 1) * tiles / gridDim.x - t0;
  const uint32_t bars = smem_u32(smem);
  uint8_t* ring = smem + LOOP_BARRIER_BYTES;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
  }
  __syncwarp();

  int nxt[4] = {0, 0, 0, 0};
  if (nt > 0) load_tile_idx(a, t0, lane, nxt);
  for (long long k = 0; k < nt && k < ahead; ++k) {
    const int cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
    if (k + 1 < nt) load_tile_idx(a, t0 + k + 1, lane, nxt);
    const int s = (int)(k % S);
    issue_tile(a, t0 + k, lane, cur, ring + s * stage_bytes, bars + 8 * s);
  }
  __syncwarp();
  for (long long k = 0; k < nt; ++k) {
    const int s = (int)(k % S);
    const long long t = t0 + k;
    if (lane == 0) {
      mbar_wait(bars + 8 * s, (uint32_t)((k / S) & 1));
      const long long row0 = t * a.tile_rows;
      const int cnt = (int)min((long long)a.tile_rows, a.n - row0);
      bulk_s2g(a.out + row0 * a.row_bytes, smem_u32(ring + s * stage_bytes),
               (uint32_t)cnt * a.row_bytes);
      bulk_commit();
      // the stage of tile k + ahead last held tile k - 2: its store must
      // have read it
      if (k + ahead < nt) bulk_wait_read<2>();
    }
    __syncwarp();
    if (k + ahead < nt) {
      const long long kn = k + ahead;
      const int cur[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
      if (kn + 1 < nt) load_tile_idx(a, t0 + kn + 1, lane, nxt);
      const int sn = (int)(kn % S);
      issue_tile(a, t0 + kn, lane, cur, ring + sn * stage_bytes,
                 bars + 8 * sn);
      __syncwarp();
    }
  }
  if (lane == 0) bulk_wait_all();
}

__global__ void __launch_bounds__(VEC_THREADS, 3)
    row_gather_vec_bf16_kernel(const __nv_bfloat16* feat, const int* idx,
                               __nv_bfloat16* out, int rows, int vecs,
                               int n) {
  vec_body(reinterpret_cast<const uint4*>(feat), idx,
           reinterpret_cast<uint4*>(out), rows, vecs, n);
}
__global__ void __launch_bounds__(VEC_THREADS, 3)
    row_gather_vec_f32_kernel(const float* feat, const int* idx, float* out,
                              int rows, int vecs, int n) {
  vec_body(reinterpret_cast<const uint4*>(feat), idx,
           reinterpret_cast<uint4*>(out), rows, vecs, n);
}
__global__ void __launch_bounds__(LOOP_THREADS)
    row_gather_loop_bf16_kernel(LoopArgs a) {
  loop_body(a);
}
__global__ void __launch_bounds__(LOOP_THREADS)
    row_gather_loop_f32_kernel(LoopArgs a) {
  loop_body(a);
}

// the loop variant's shared memory: barriers, then the ring
long long loop_smem(int row_bytes, int tile_rows, int stages) {
  return LOOP_BARRIER_BYTES + (long long)stages * tile_rows * row_bytes;
}

int check_shape(int elem, int rows, int channels, int n, int grid) {
  if (channels <= 0 || (long long)channels * elem % 16 != 0 || rows < 0 ||
      n < 0 || grid <= 0 || (long long)channels * elem > (1 << 30))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <typename T>
int launch_vec(void (*kernel)(const T*, const int*, T*, int, int, int),
               const void* feat, const void* idx, void* out, int rows,
               int channels, int n, int grid, void* stream) {
  int e = check_shape((int)sizeof(T), rows, channels, n, grid);
  if (e != cudaSuccess || n == 0) return e;
  const int vecs = channels * (int)sizeof(T) / 16;
  kernel<<<grid, VEC_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)feat, (const int*)idx, (T*)out, rows, vecs, n);
  return (int)cudaGetLastError();
}

int launch_loop(void (*kernel)(LoopArgs), int elem, const void* feat,
                const void* idx, void* out, int rows, int channels, int n,
                int grid, int tile_rows, int stages, void* stream) {
  int e = check_shape(elem, rows, channels, n, grid);
  if (e != cudaSuccess || n == 0) return e;
  const int row_bytes = channels * elem;
  if (tile_rows < 1 || tile_rows > LOOP_MAX_TILE ||
      stages < LOOP_MIN_STAGES || stages > LOOP_MAX_STAGES ||
      (long long)tile_rows * row_bytes >= (1 << 20))
    return (int)cudaErrorInvalidValue;
  const LoopArgs a{(const uint8_t*)feat, (const int*)idx, (uint8_t*)out,
                   rows, row_bytes, n, tile_rows, stages};
  kernel<<<grid, LOOP_THREADS, (size_t)loop_smem(row_bytes, tile_rows, stages),
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K5 on `stream`; returns cudaGetLastError() (0 on success).
// feat [rows, channels] (channels * element size a multiple of 16 bytes,
// 16-byte-aligned base), idx [n] int32, out [n, channels] in feat's dtype;
// `grid` blocks (the host's plan: ops/row_gather.py:row_gather_plan).
int surs_row_gather_vec_bf16(const void* feat, const void* idx, void* out,
                             int rows, int channels, int n, int grid,
                             void* stream) {
  return launch_vec<__nv_bfloat16>(row_gather_vec_bf16_kernel, feat, idx,
                                   out, rows, channels, n, grid, stream);
}

int surs_row_gather_vec_f32(const void* feat, const void* idx, void* out,
                            int rows, int channels, int n, int grid,
                            void* stream) {
  return launch_vec<float>(row_gather_vec_f32_kernel, feat, idx, out, rows,
                           channels, n, grid, stream);
}

// The loop variant also takes its tile (`tile_rows` rows) and ring depth
// (`stages`) from the plan; it needs loop_smem bytes of shared memory,
// allowed by surs_row_gather_allow_smem first.
int surs_row_gather_loop_bf16(const void* feat, const void* idx, void* out,
                              int rows, int channels, int n, int grid,
                              int tile_rows, int stages, void* stream) {
  return launch_loop(row_gather_loop_bf16_kernel, 2, feat, idx, out, rows,
                     channels, n, grid, tile_rows, stages, stream);
}

int surs_row_gather_loop_f32(const void* feat, const void* idx, void* out,
                             int rows, int channels, int n, int grid,
                             int tile_rows, int stages, void* stream) {
  return launch_loop(row_gather_loop_f32_kernel, 4, feat, idx, out, rows,
                     channels, n, grid, tile_rows, stages, stream);
}

// Allow the loop kernel in `f32` (0 bf16, 1 float32) the current
// device's largest dynamic shared memory. Once per kernel and device,
// before its first occupancy query: launches set no attribute.
int surs_row_gather_allow_smem(int f32) {
  int dev, most;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(f32 ? (const void*)row_gather_loop_f32_kernel
                                 : (const void*)row_gather_loop_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  return (int)e;
}

// Blocks of variant `loop` (0 vec, 1 loop) in `f32` (0 bf16, 1 float32)
// that fit on one SM of the current device with `smem` bytes of dynamic
// shared memory each, into *blocks.
int surs_row_gather_occupancy(int loop, int f32, int smem, int* blocks) {
  const void* fn =
      loop ? (f32 ? (const void*)row_gather_loop_f32_kernel
                  : (const void*)row_gather_loop_bf16_kernel)
           : (f32 ? (const void*)row_gather_vec_f32_kernel
                  : (const void*)row_gather_vec_bf16_kernel);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, loop ? LOOP_THREADS : VEC_THREADS, (size_t)smem);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
