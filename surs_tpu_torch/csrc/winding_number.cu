// The generalized winding number of query points with respect to a
// triangle soup, on Hopper (sm_90a): the containment test that labels the
// training samples inside or outside a subject's mesh.
//
// Replaces `winding_number` (surs_tpu/ops/containment.py:47-67), which is
// no Pallas kernel: a lax.scan over chunks of 2,048 triangles whose body
// (`_solid_angle_sum`, :32-44) XLA fuses into one loop on the TPU. Written
// as eager PyTorch, that body is about 25 element-wise kernels over
// [points, triangles] intermediates, some 200 bytes of device traffic a
// point-triangle pair; this kernel keeps every intermediate in registers.
//
// Each pair adds the solid angle the triangle (A, B, C) subtends at the
// point p (van Oosterom and Strackee): with a = A - p, b = B - p,
// c = C - p,
//     2 * atan2(a . (b x c),
//               |a||b||c| + (a . b)|c| + (b . c)|a| + (c . a)|b|),
// summed in float32, the differences taken first as the JAX function
// takes them (an expanded form such as |A|^2 - 2 p.A + |p|^2 would cancel
// for the many samples near the surface). A zero-area triangle gives a
// det of 0 (up to a fused multiply-add's rounding residue) and a
// denominator >= 0, so it adds atan2(~0, +x) ~ 0; a point on one of its
// vertices gives atan2(+-0, +0) = +-0 (the denominator starts from
// |a||b||c| = +0, and +0 + -0 is +0), never atan2(0, -0) = pi.
//
// What bounds it: instruction issue. A pair costs 63 float32 additions
// and multiplications, 3 square roots and an arctangent (roofline.
// containment_work counts 67, each square root and arctangent as one),
// on 12 bytes of a point and 36 of a triangle, each read once: 25,500
// points against 327,680 triangles are 5.7e11 operations and 12 MB. The
// IEEE sqrtf and atan2f of the first design issued 135 instructions a
// pair (a square root is MUFU.RSQ with a Newton step and a branch to a
// slow path, atan2f two divisions with their own), and the kernel ran at
// about 84 % of the card's issue rate for that count. So this design
// cuts instructions a pair:
//   * each thread holds POINTS_PER_THREAD points in registers, so a
//     triangle read from shared memory serves all of them;
//   * a triangle is a 16-byte-aligned record of 12 floats (A, B, C, each
//     padded to a float4; the wrapper pads them on the card), read as
//     three 16-byte broadcasts;
//   * tiles of TILE records are staged by cp.async.bulk into a ring of
//     STAGES shared-memory buffers with mbarriers (hopper.cuh): a thread
//     waits for a tile's barrier, each warp marks the buffer free once it
//     has read it, and thread 0 refills it; no __syncthreads in the loop;
//   * square roots are sqrt.approx.ftz.f32 (one MUFU.SQRT, relative error
//     2^-23) and the arctangent is atan2_approx below (one MUFU.RCP, a
//     degree-7 polynomial in r^2, three fix-ups; at most 6 ulp from the
//     exact atan2 where max(|y|, |x|) lies in [2^-126, 2^126) or is 0),
//     written here as explicit intrinsics: the build's flags stay IEEE
//     for every other kernel.
// About 66 instructions a pair, none of them a branch (probes/
// winding_sass.py counts them in the built library's SASS).
//
// The triangles still go in contiguous shares of whole tiles to
// `splits` blocks a column of points (grid.y), so that a few thousand
// points still fill the card's 132 SMs; each share's sum goes to
// partial[split][point] and a second kernel adds the shares in order, so
// the result does not depend on the schedule. The host's plan
// (ops/containment.py:winding_plan) picks `splits` to fill whole waves of
// the kernel's resident blocks (surs_winding_blocks_per_sm).

#include <cuda_runtime.h>
#include <float.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;           // a block: 4 warps
constexpr int POINTS_PER_THREAD = 4;   // ops/containment.py mirrors these
constexpr int BLOCK_POINTS = THREADS * POINTS_PER_THREAD;
constexpr int TILE = 128;              // triangle records a ring stage
constexpr int STAGES = 3;
constexpr int RECORD_BYTES = 48;       // 12 floats: A, B, C as float4
constexpr float HALF_PI_F = 1.57079637f;
constexpr float PI_F = 3.14159274f;

// atan(r) / r ~ P(r^2) on [0, 1], P's coefficients from the constant
// term up: a minimax fit of the relative error (9.9e-8 in exact
// arithmetic; ops/containment.py:ATAN_COEFFS holds the same numbers for
// the tests' model of this arithmetic)
constexpr float ATAN_C0 = 0.999999881f;
constexpr float ATAN_C1 = -0.333319902f;
constexpr float ATAN_C2 = 0.199697301f;
constexpr float ATAN_C3 = -0.140195221f;
constexpr float ATAN_C4 = 0.0991442278f;
constexpr float ATAN_C5 = -0.0594884418f;
constexpr float ATAN_C6 = 0.0242539942f;
constexpr float ATAN_C7 = -0.00469375867f;

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// atan2(y, x): r = min / max of |y|, |x| in [0, 1] (the max held at
// least FLT_MIN, so that 0 / 0 gives r = 0), atan(r) = r P(r^2), then
// pi/2 - t where |y| > |x|, pi - t where x's sign bit is set, and y's
// sign: atan2(+-0, +0) = +-0, atan2(+-0, -0) = +-pi, as IEEE's.
__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mn = fminf(ax, ay);
  const float mx = fmaxf(fmaxf(ax, ay), FLT_MIN);
  const float r = mn * rcp_approx(mx);
  const float s = r * r;
  float p = fmaf(ATAN_C7, s, ATAN_C6);
  p = fmaf(p, s, ATAN_C5);
  p = fmaf(p, s, ATAN_C4);
  p = fmaf(p, s, ATAN_C3);
  p = fmaf(p, s, ATAN_C2);
  p = fmaf(p, s, ATAN_C1);
  p = fmaf(p, s, ATAN_C0);
  float t = r * p;
  if (ay > ax) t = HALF_PI_F - t;
  if (__float_as_int(x) < 0) t = PI_F - t;
  return __int_as_float(__float_as_int(t) |
                        (__float_as_int(y) & 0x80000000));
}

// atan2(a . (b x c), denominator) of one pair, as the JAX function's
// _solid_angle_sum orders it; the caller doubles the sum
__device__ __forceinline__ float half_solid_angle(const float4& A,
                                                  const float4& B,
                                                  const float4& C, float px,
                                                  float py, float pz) {
  const float ax = A.x - px, ay = A.y - py, az = A.z - pz;
  const float bx = B.x - px, by = B.y - py, bz = B.z - pz;
  const float cx = C.x - px, cy = C.y - py, cz = C.z - pz;
  const float la = sqrt_approx(ax * ax + ay * ay + az * az);
  const float lb = sqrt_approx(bx * bx + by * by + bz * bz);
  const float lc = sqrt_approx(cx * cx + cy * cy + cz * cz);
  const float det = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz) +
                    az * (bx * cy - by * cx);
  const float ab = ax * bx + ay * by + az * bz;
  const float bc = bx * cx + by * cy + bz * cz;
  const float ca = cx * ax + cy * ay + cz * az;
  float denom = la * lb * lc;
  denom += ab * lc;
  denom += bc * la;
  denom += ca * lb;
  return atan2_approx(det, denom);
}

// at most 80 registers a thread (ptxas alone takes 96), so that 6 blocks
// (24 warps) share an SM instead of 5 and hide more of the pairs'
// latencies
__global__ void __launch_bounds__(THREADS, 6)
winding_number_kernel(const float* __restrict__ points,
                      const float4* __restrict__ records,
                      float* __restrict__ partial, int n_points,
                      int n_tris, int tiles_per_split) {
  __shared__ __align__(128) float4 ring[STAGES * TILE * 3];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x;
  float px[POINTS_PER_THREAD], py[POINTS_PER_THREAD], pz[POINTS_PER_THREAD];
  float acc[POINTS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < POINTS_PER_THREAD; ++j) {
    const int p = blockIdx.x * BLOCK_POINTS + j * THREADS + tid;
    const bool in = p < n_points;
    px[j] = in ? points[3 * p] : 0.f;
    py[j] = in ? points[3 * p + 1] : 0.f;
    pz[j] = in ? points[3 * p + 2] : 0.f;
    acc[j] = 0.f;
  }
  const long long first = (long long)blockIdx.y * tiles_per_split;
  const int tiles = (int)min((long long)tiles_per_split,
                             (n_tris + TILE - 1) / TILE - first);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), THREADS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // tile i of this share into stage i % STAGES, completing on its barrier
  auto issue = [&](int i) {
    const long long t0 = (first + i) * TILE;
    const int n = (int)min((long long)TILE, n_tris - t0);
    const uint32_t bar = smem_u32(&full[i % STAGES]);
    mbar_arrive_tx(bar, n * RECORD_BYTES);
    bulk_g2s(smem_u32(ring + (i % STAGES) * TILE * 3), records + t0 * 3,
             n * RECORD_BYTES, bar);
  };
  if (tid == 0)
    for (int i = 0; i < min(STAGES, tiles); ++i) issue(i);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % STAGES;
    const uint32_t parity = (uint32_t)((i / STAGES) & 1);
    mbar_wait(smem_u32(&full[st]), parity);
    const int n = (int)min((long long)TILE, n_tris - (first + i) * TILE);
    const float4* tile = ring + st * TILE * 3;
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      const float4 A = tile[3 * k], B = tile[3 * k + 1], C = tile[3 * k + 2];
#pragma unroll
      for (int j = 0; j < POINTS_PER_THREAD; ++j)
        acc[j] += half_solid_angle(A, B, C, px[j], py[j], pz[j]);
    }
    // the warp has read the stage; once every warp has, thread 0 refills
    // it with the tile STAGES ahead
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(smem_u32(&empty[st]));
    if (tid == 0 && i + STAGES < tiles) {
      mbar_wait(smem_u32(&empty[st]), parity);
      issue(i + STAGES);
    }
  }
#pragma unroll
  for (int j = 0; j < POINTS_PER_THREAD; ++j) {
    const int p = blockIdx.x * BLOCK_POINTS + j * THREADS + tid;
    if (p < n_points)
      partial[(size_t)blockIdx.y * n_points + p] = 2.f * acc[j];
  }
}

// out[p] = sum over the shares of partial[share][p], shares in order.
__global__ void winding_number_reduce_kernel(const float* __restrict__ partial,
                                             float* __restrict__ out,
                                             int n_points, int splits) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_points) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * n_points + p];
  out[p] = acc;
}

}  // namespace

extern "C" {

// Launch the winding number on `stream`; returns cudaGetLastError() (0 on
// success). points [n_points, 3] float32; records [n_tris, 3, 4] float32
// (A, B, C, each padded to 4 floats), 16-byte aligned; both contiguous;
// out [n_points] float32. With splits > 1 the shares' sums go to partial
// [splits, n_points] float32 and a second kernel adds them into out; with
// splits == 1 the one share writes out directly and partial is not read.
// The host's plan (ops/containment.py:winding_plan) gives every tile of
// TILE triangles to exactly one share.
int surs_winding_number(const void* points, const void* records,
                        void* partial, void* out, int n_points, int n_tris,
                        int splits, int tiles_per_split, void* stream) {
  if (n_points <= 0 || n_tris <= 0 || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 || ((uintptr_t)records & 15) ||
      (long long)(splits - 1) * tiles_per_split * TILE >= n_tris ||
      (long long)splits * tiles_per_split * TILE < n_tris)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* sums = splits == 1 ? (float*)out : (float*)partial;
  const dim3 grid((n_points + BLOCK_POINTS - 1) / BLOCK_POINTS, splits);
  winding_number_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)points, (const float4*)records, sums, n_points, n_tris,
      tiles_per_split);
  int e = (int)cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  winding_number_reduce_kernel<<<(n_points + 255) / 256, 256, 0, s>>>(
      sums, (float*)out, n_points, splits);
  return (int)cudaGetLastError();
}

// The winding kernel's resident blocks an SM, for the host's plan;
// returns cudaGetLastError()'s code of the query.
int surs_winding_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, winding_number_kernel, THREADS, 0);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
