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
// summed in float32. A zero-area triangle gives det = 0 and a denominator
// >= 0, so it adds atan2(0, +x) = 0; a point on one of its vertices gives
// atan2(+-0, +0) = +-0 too (the denominator starts from |a||b||c| = +0,
// and +0 + -0 is +0), never atan2(0, -0) = pi.
//
// What bounds it: operations. A pair costs 63 float32 additions and
// multiplications, 3 square roots and an arctangent (roofline.
// containment_work counts 67, each square root and arctangent as one),
// on 12 bytes of a point and 36 of a triangle, each read once: 25,500
// points against 327,680 triangles are 5.7e11 operations and 12 MB.
//
// The design is the simple one: one thread a point, its coordinates and
// its sum in registers. A block of THREADS points stages TILE triangles
// at a time in shared memory (9 KB; every thread then reads the same
// triangle, a broadcast), and walks a contiguous share of the tiles: the
// host splits the triangles into `splits` shares (grid.y) so that a few
// thousand points still fill the card's 132 SMs. Each share's sum goes to
// partial[split][point]; a second kernel adds the shares in order, so the
// result does not depend on the schedule.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // points a block (ops/containment.py)
constexpr int TILE = 256;      // triangles staged in shared memory at once

__global__ void __launch_bounds__(THREADS)
winding_number_kernel(const float* __restrict__ points,
                      const float* __restrict__ tris,
                      float* __restrict__ partial, int n_points,
                      int n_tris, int tiles_per_split) {
  __shared__ float s_tri[TILE * 9];
  const int p = blockIdx.x * THREADS + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (p < n_points) {
    px = points[3 * p];
    py = points[3 * p + 1];
    pz = points[3 * p + 2];
  }
  const long long first = (long long)blockIdx.y * tiles_per_split * TILE;
  const long long last =
      min((long long)n_tris, first + (long long)tiles_per_split * TILE);
  float acc = 0.f;
  for (long long t0 = first; t0 < last; t0 += TILE) {
    const int n = (int)min((long long)TILE, last - t0);
    __syncthreads();   // the previous tile is read by every thread
    const float* src = tris + t0 * 9;
    for (int i = threadIdx.x; i < n * 9; i += THREADS) s_tri[i] = src[i];
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* t = s_tri + 9 * k;
      const float ax = t[0] - px, ay = t[1] - py, az = t[2] - pz;
      const float bx = t[3] - px, by = t[4] - py, bz = t[5] - pz;
      const float cx = t[6] - px, cy = t[7] - py, cz = t[8] - pz;
      const float la = sqrtf(ax * ax + ay * ay + az * az);
      const float lb = sqrtf(bx * bx + by * by + bz * bz);
      const float lc = sqrtf(cx * cx + cy * cy + cz * cz);
      const float det = ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)
                        + az * (bx * cy - by * cx);
      const float ab = ax * bx + ay * by + az * bz;
      const float bc = bx * cx + by * cy + bz * cz;
      const float ca = cx * ax + cy * ay + cz * az;
      float denom = la * lb * lc;
      denom += ab * lc;
      denom += bc * la;
      denom += ca * lb;
      acc += 2.f * atan2f(det, denom);
    }
  }
  if (p < n_points) partial[(size_t)blockIdx.y * n_points + p] = acc;
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
// success). points [n_points, 3] and tris [n_tris, 3, 3] float32,
// contiguous; out [n_points] float32. With splits > 1 the shares' sums go
// to partial [splits, n_points] float32 and a second kernel adds them
// into out; with splits == 1 the one share writes out directly and
// partial is not read. The host's plan (ops/containment.py:winding_plan)
// gives every tile of TILE triangles to exactly one share.
int surs_winding_number(const void* points, const void* tris, void* partial,
                        void* out, int n_points, int n_tris, int splits,
                        int tiles_per_split, void* stream) {
  if (n_points <= 0 || n_tris <= 0 || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 ||
      (long long)(splits - 1) * tiles_per_split * TILE >= n_tris ||
      (long long)splits * tiles_per_split * TILE < n_tris)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* sums = splits == 1 ? (float*)out : (float*)partial;
  const dim3 grid((n_points + THREADS - 1) / THREADS, splits);
  winding_number_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)points, (const float*)tris, sums, n_points, n_tris,
      tiles_per_split);
  int e = (int)cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  winding_number_reduce_kernel<<<(n_points + 255) / 256, 256, 0, s>>>(
      sums, (float*)out, n_points, splits);
  return (int)cudaGetLastError();
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
