// Kernel K1: the fused dual occupancy MLP on Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_dual_mlp` (body `_kernel`) of
// surs_tpu/ops/fused_mlp.py. Per point it runs the coarse MLP
// 321 -> 1024 -> 512 -> 256 -> 128 -> 1 (the input re-concatenated before
// layers 2-4, leaky-ReLU 0.01 between layers, sigmoid -> pred_lr), then the
// fine MLP of the same shape on [x, pred_lr] (322 inputs) -> pred_hr.
// Rounding follows the TPU kernel: the input, the activations and pred_lr
// are cast to the compute dtype before their product; accumulation, bias,
// leaky-ReLU and sigmoid are float32.
//
// What bounds it: about 4.57 MFLOP per point against 1.3 KB of input and
// output, so one 50,000-point call is about 228 GFLOP against 64 MB: the
// tensor cores, not memory. What stands in the way is the weight stream:
// every tile of points reads both MLPs' weights (4.6 MB) from L2.
//
// bf16, the design: K3's chain (wg_chain.cuh) with the input products
// inside it. A persistent block of two consumer warpgroups (64 points
// each: a tile of 128) and a producer warpgroup, whose registers go to
// the consumers (setmaxnreg). The producer streams every weight the
// tensor cores take, repacked by ops/fused_mlp.py:prepare_fused_weights
// into 16 KB stages already in the 128-byte-swizzled wgmma layout
// (k1_stages: 195 per MLP), through a 5-slot ring with cp.async.bulk on
// mbarriers; each weight byte read from L2 feeds 128 points.
//   * The input tile X [128, 320] bf16 (the feature columns, 80 KB) sits
//     in shared memory as the A of every input product. The depth and
//     pred_lr columns (320, 321) enter the epilogues as float32 rank-1
//     terms: bf16 x bf16 products, exact in float32.
//   * Layer 0 is never stored: per 64-wide k-slice of layer 1 a wgmma
//     X x W0x-slice (m64n64, 20 k-steps) lands in 32 registers, beside
//     layer 1's products of the slice before; its epilogue gives layer
//     1's A fragments. A [64, 512] float32 accumulator
//     does not fit a warpgroup's registers, so layer 1 runs in two halves
//     of 256 outputs and layer 0 is built twice.
//   * h1 [128, 512] bf16 for layer 2's A: its first half has its own 64 KB,
//     its second half is written over X, which is dead by then; X is
//     restaged from the input (L2) after layer 2's h1 products, for the
//     x-products of layers 2 and 3 and the last layer's x-dot.
//   * Layer 2's output goes over h1's first half as layer 3's A (held in
//     registers, it would spill: layer 2's accumulators are live beside
//     it); layer 3's epilogue ends in the last layer's 128-wide dot,
//     reduced with shuffles. Every epilogue works on the accumulators in
//     registers.
// Shared memory: h1's first half 64 KB + X 80 KB + the ring 80 KB.
// The float32 K1 is in fused_cols_mlp.cu: the float32 column-term
// pre-pass, then the 3xTF32 chain with one point a row.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrapper is ops/fused_mlp.py:fused_dual_mlp.

#include "wg_chain.cuh"

namespace {

// ======================================== bf16: the chain on wgmma ===
constexpr int XF = 320;            // input columns on the tensor cores
constexpr int XC = XF / SK;        // their 64-k chunks: 5
constexpr int ZCOL = XF;           // the depth column (pred_lr: XF + 1)
constexpr int SLICES = D0 / SK;    // layer-0 slices per half of layer 1
// ring depth: the layer-0/1 schedule holds up to 5 stages at once (layer
// 1's two of slice kc - 1 while it takes layer 0's three of slice kc), so
// fewer slots deadlock
constexpr int K1_SLOTS = 5;
constexpr int K1_STAGES = 195;     // per MLP (ops/fused_mlp.py:k1_stages)
constexpr int N64_CHUNK = SK * 64 * 2;   // 64 k of a 64-wide stage, 8 KB
// float32 epilogue rows of one MLP (ops/fused_mlp.py:K1_VEC_OFF): biases,
// the depth (Z) and prediction (P) rows of each x block, w4h, w4x's
// feature rows, then [b4, w4x depth, w4x prediction]
constexpr int V_B0 = 0, V_Z0 = 1024, V_P0 = 2048, V_B1 = 3072, V_B2 = 3584,
              V_Z2 = 3840, V_P2 = 4096, V_B3 = 4352, V_Z3 = 4480,
              V_P3 = 4608, V_W4H = 4736, V_W4X = 4864, V_TAIL = 5184,
              K1_VEC = 5188;
// shared memory, from a 1,024-byte aligned base: h1's first half, X
// (h1's second half goes over it), the ring, the barriers
constexpr int X_OFF = H1_BYTES / 2;
constexpr int K1_RING_OFF = X_OFF + XC * CHUNK_BYTES;
constexpr int K1_BAR_OFF = K1_RING_OFF + K1_SLOTS * STAGE_BYTES;
constexpr size_t K1_SMEM = K1_BAR_OFF + 2 * K1_SLOTS * 8 + 1024;
static_assert(K1_SMEM <= 232448, "over a block's 227 KB of shared memory");
using K1Ring = RingT<K1_SLOTS>;

struct K1Args {
  const float* x0;     // [n, w0]
  int w0;
  int vec0;            // x0's rows 16-byte aligned: float4 loads
  const float* x1;     // [n, w1] or null (w1 == 0); w0 + w1 == 321
  int w1;
  int n;
  int tiles;
  const bf16* stages;  // [2, K1_STAGES, STAGE_ELEMS]
  const int* nbytes;   // [K1_STAGES] bytes of each stage
  const float* vec;    // [2, K1_VEC]
  float* out_hr;
  float* out_lr;
};

// the two rows' depth and (bf16) pred_lr inputs
struct K1Rows {
  float z0, z1, p0, p1;
};

__device__ __forceinline__ float x_at(const K1Args& a, long long g, int c) {
  return c < a.w0 ? __ldg(a.x0 + g * a.w0 + c)
                  : __ldg(a.x1 + g * a.w1 + (c - a.w0));
}

// columns [k, k + 4) of point g
__device__ __forceinline__ float4 x_quad(const K1Args& a, long long g, int k) {
  if (a.vec0 && k + 4 <= a.w0)
    return __ldg(reinterpret_cast<const float4*>(a.x0 + g * a.w0 + k));
  return make_float4(x_at(a, g, k), x_at(a, g, k + 1), x_at(a, g, k + 2),
                     x_at(a, g, k + 3));
}

// The warpgroup's 64 rows of X (tile rows 64 w + r) from the input,
// columns [0, XF) rounded to bf16, zeros past n; `tw` the thread in the
// group. Latency-bound: each thread keeps BATCH quads of loads in flight
// before it stores any (more spill beside layer 2's accumulators).
__device__ void stage_x(bf16* X, const K1Args& a, int tile, int w, int tw) {
  const long long base = (long long)tile * MROWS + 64 * w;
  constexpr int QUADS = XF / 4;            // 80 a row
  constexpr int PER = 64 * QUADS / 128;    // 40 a thread
  constexpr int BATCH = 4;
#pragma unroll 1
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    float4 q[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tw + 128 * (b0 + u), r = i / QUADS;
      const long long g = base + r;
      q[u] = g < a.n ? x_quad(a, g, 4 * (i - r * QUADS))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = tw + 128 * (b0 + u), r = i / QUADS;
      uint2 p;
      p.x = pack_bf16(q[u].x, q[u].y);
      p.y = pack_bf16(q[u].z, q[u].w);
      *reinterpret_cast<uint2*>(X + h1_index(64 * w + r,
                                             4 * (i - r * QUADS))) = p;
    }
  }
}

// leaky(acc + b + z w_z [+ p w_p]), in float32
template <bool HR>
__device__ __forceinline__ float act1(float acc, float b, float wz, float wp,
                                      float z, float p) {
  float v = acc + b + z * wz;
  if (HR) v += p * wp;
  return leaky(v);
}

// Layer 0's slice (accumulator d, outputs c0 - 2 tig + [0, 64)) as layer
// 1's A fragments: k step j, registers {r0 k, r0+8 k, r0 k+8, r0+8 k+8},
// k = 16 j + 2 (lane % 4); c0 = 64 kc + 2 tig.
template <bool HR>
__device__ __forceinline__ void build_a0(uint32_t (&af)[4][4],
                                         const float (&d)[32], const float* v,
                                         int c0, const K1Rows& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + 8 * i;
    const float2 b = ldg2(v + V_B0 + c), wz = ldg2(v + V_Z0 + c);
    const float2 wp = HR ? ldg2(v + V_P0 + c) : make_float2(0.f, 0.f);
    af[i / 2][2 * (i & 1)] =
        pack_bf16(act1<HR>(d[4 * i], b.x, wz.x, wp.x, r.z0, r.p0),
                  act1<HR>(d[4 * i + 1], b.y, wz.y, wp.y, r.z0, r.p0));
    af[i / 2][2 * (i & 1) + 1] =
        pack_bf16(act1<HR>(d[4 * i + 2], b.x, wz.x, wp.x, r.z1, r.p1),
                  act1<HR>(d[4 * i + 3], b.y, wz.y, wp.y, r.z1, r.p1));
  }
}

// Layer 0's slice: d = X [64 rows, 320] x a W0x slice [320, 64] held in
// three stages of 128, 128 and 64 k (slots s).
__device__ __forceinline__ void issue_l0(float (&d)[32], uint32_t xa,
                                         const K1Ring& ring,
                                         const int (&s)[3]) {
  // opaque: the 20 descriptors are loop-invariant, and held in registers
  // across the layer-1 loop they would spill
  asm volatile("" : "+r"(xa));
  wg_fence_acc(d);
  wg_fence();
#pragma unroll
  for (int j = 0; j < XF / 16; ++j) {
    const int in = j % 8;
    wgmma_ss_n64(d, wg_desc(xa + (j / 4) * CHUNK_BYTES + (j % 4) * 32, 1024),
                 wg_desc(ring.addr(s[j / 8]) + (in / 4) * N64_CHUNK +
                             (in % 4) * 32, 1024),
                 j);
  }
  wg_commit();
}

// One step of layers 0 and 1: layer 0's slice kc runs on the tensor
// cores beside layer 1's products of slice kc - 1; once both are done,
// slice kc's epilogue gives layer 1's A, and its products are issued.
template <bool HR>
__device__ __forceinline__ void l01_step(int kc, float (&acc0)[64],
                                         float (&acc1)[64], float (&d0)[32],
                                         uint32_t (&af)[4][4], K1Ring& ring,
                                         uint32_t xa, const float* v,
                                         const K1Rows& r, int tig) {
  int s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = ring.wait();
  issue_l0(d0, xa, ring, s);
  if (kc > 0) {
    // layer 1's products of slice kc - 1 done: their two stages go
    wg_wait<1>();
    ring.release_to(ring.head - 3);
  }
  // slice kc done: its three stages go
  wg_wait<0>();
  wg_fence_acc(d0);
  ring.release_to(ring.head);
  build_a0<HR>(af, d0, v, kc * SK + 2 * tig, r);
  const int s0 = ring.wait();
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
}

// Layer 2's epilogue for outputs [nb, nb + 128) into shared memory, h1's
// layout (layer 3's A): bf16(leaky(acc + b2 + z w_z2 [+ p w_p2])).
template <bool HR>
__device__ __forceinline__ void store_h2(const float (&acc)[64], bf16* h2,
                                         int nb, const float* v,
                                         const K1Rows& r, int m0, int tig) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = nb + 8 * i + 2 * tig;
    const float2 b = ldg2(v + V_B2 + n), wz = ldg2(v + V_Z2 + n);
    const float2 wp = HR ? ldg2(v + V_P2 + n) : make_float2(0.f, 0.f);
    *reinterpret_cast<uint32_t*>(h2 + h1_index(m0, n)) =
        pack_bf16(act1<HR>(acc[4 * i], b.x, wz.x, wp.x, r.z0, r.p0),
                  act1<HR>(acc[4 * i + 1], b.y, wz.y, wp.y, r.z0, r.p0));
    *reinterpret_cast<uint32_t*>(h2 + h1_index(m0 + 8, n)) =
        pack_bf16(act1<HR>(acc[4 * i + 2], b.x, wz.x, wp.x, r.z1, r.p1),
                  act1<HR>(acc[4 * i + 3], b.y, wz.y, wp.y, r.z1, r.p1));
  }
}

__device__ __forceinline__ float dot8(uint4 x, float4 a, float4 b) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  return f0.x * a.x + f0.y * a.y + f1.x * a.z + f1.y * a.w + f2.x * b.x +
         f2.y * b.y + f3.x * b.z + f3.y * b.w;
}

// This lane's quarter of X . w4x for rows m0 and m0 + 8: 16-byte pieces
// tig, tig + 4, ... of the 40 in a row.
__device__ __forceinline__ float2 dot_w4x(const bf16* X, const float* w4x,
                                          int m0, int tig) {
  // opaque: the 20 shared addresses are the same in both MLPs, and held
  // from one to the other they would spill
  asm volatile("" : "+r"(m0));
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < XF / 32; ++i) {
    const int k = 8 * (tig + 4 * i);
    const float4 wa = __ldg(reinterpret_cast<const float4*>(w4x + k));
    const float4 wb = __ldg(reinterpret_cast<const float4*>(w4x + k + 4));
    s0 += dot8(*reinterpret_cast<const uint4*>(X + h1_index(m0, k)), wa, wb);
    s1 += dot8(*reinterpret_cast<const uint4*>(X + h1_index(m0 + 8, k)), wa,
               wb);
  }
  return make_float2(s0, s1);
}

// One MLP over the warpgroup's 64 rows of the tile, X staged;
// returns the predictions of rows m0 and m0 + 8 (every lane of a quad
// holds them). Leaves X staged.
template <bool HR>
__device__ float2 k1_mlp(const K1Args& a, K1Ring& ring, bf16* H,
                         const K1Rows& r, int tile, int w, int m0, int tw,
                         int tig) {
  // the MLP's index, opaque to the compiler: addresses shared between the
  // two MLPs would be held in registers across the layer-1 loop
  int m = HR ? 1 : 0;
  asm volatile("" : "+r"(m));
  const float* v = a.vec + m * K1_VEC;
  bf16* X = H + X_OFF / 2;
  const uint32_t h1a = smem_u32(H) + w * 64 * 128;  // the group's rows
  const uint32_t xa = h1a + X_OFF;
  float acc0[64], acc1[64], d0[32];
  uint32_t af[4][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  // every warp of the group is past the previous MLP's reads of H
  bar_sync(1 + w, 128);

  // layers 0 and 1, in two halves of 256 outputs
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
#pragma unroll 1
    for (int kc = 0; kc < SLICES; ++kc)
      l01_step<HR>(kc, acc0, acc1, d0, af, ring, xa, v, r, tig);
    wg_wait<0>();
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    ring.release_to(ring.head);
    // the second half goes over X: every warp is past its last read
    if (half == 1) bar_sync(1 + w, 128);
    store_h1(acc0, H, 256 * half, v + V_B1, m0, tig);
    store_h1(acc1, H, 256 * half + 128, v + V_B1, m0, tig);
  }
  fence_proxy_async();
  bar_sync(1 + w, 128);

  // layer 2: h1 x W2h, then X x W2x, two 128-wide accumulators
#pragma unroll 1
  for (int kc = 0; kc < D1 / SK; ++kc) {
    const int s0 = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc0, wg_desc(h1a + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s0, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
    const int s1 = ring.wait();
    wg_fence_acc(acc1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc1, wg_desc(h1a + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s1, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  wg_wait<0>();
  wg_fence_acc(acc0);
  wg_fence_acc(acc1);
  ring.release_to(ring.head);
  // X back over h1's second half, which every warp has read
  bar_sync(1 + w, 128);
  stage_x(X, a, tile, w, tw);
  fence_proxy_async();
  bar_sync(1 + w, 128);
#pragma unroll 1
  for (int kc = 0; kc < XC; ++kc) {
    const int s0 = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc0, wg_desc(xa + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s0, j), 1);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
    const int s1 = ring.wait();
    wg_fence_acc(acc1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc1, wg_desc(xa + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s1, j), 1);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  wg_wait<0>();
  wg_fence_acc(acc0);
  wg_fence_acc(acc1);
  ring.release_to(ring.head);
  // layer 2's output over h1's first half, which every warp has read
  store_h2<HR>(acc0, H, 0, v, r, m0, tig);
  store_h2<HR>(acc1, H, 128, v, r, m0, tig);
  fence_proxy_async();
  bar_sync(1 + w, 128);

  // layer 3: h2 (A from shared memory) x W3h, then X x W3x
#pragma unroll 1
  for (int kc = 0; kc < D2 / SK; ++kc) {
    const int s = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc0, wg_desc(h1a + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s, j), kc | j);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  // the last layer's x-dot, under the products
  const float2 sx = dot_w4x(X, v + V_W4X, m0, tig);
#pragma unroll 1
  for (int kc = 0; kc < XC; ++kc) {
    const int s = ring.wait();
    wg_fence_acc(acc0);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_ss(acc0, wg_desc(xa + kc * CHUNK_BYTES + j * 32, 1024),
               ring.desc_b(s, j), 1);
    wg_commit();
    wg_wait<1>();
    ring.release_to(ring.head - 1);
  }
  wg_wait<0>();
  wg_fence_acc(acc0);
  ring.release_to(ring.head);

  // layer 3's epilogue and the last layer: the 128-wide dot with w4h
  float s0 = sx.x, s1 = sx.y;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = 8 * i + 2 * tig;
    const float2 b = ldg2(v + V_B3 + n), wz = ldg2(v + V_Z3 + n);
    const float2 wp = HR ? ldg2(v + V_P3 + n) : make_float2(0.f, 0.f);
    const float2 wo = ldg2(v + V_W4H + n);
    s0 += bf16r(act1<HR>(acc0[4 * i], b.x, wz.x, wp.x, r.z0, r.p0)) * wo.x;
    s0 += bf16r(act1<HR>(acc0[4 * i + 1], b.y, wz.y, wp.y, r.z0, r.p0)) * wo.y;
    s1 += bf16r(act1<HR>(acc0[4 * i + 2], b.x, wz.x, wp.x, r.z1, r.p1)) * wo.x;
    s1 += bf16r(act1<HR>(acc0[4 * i + 3], b.y, wz.y, wp.y, r.z1, r.p1)) * wo.y;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  const float b4 = __ldg(v + V_TAIL), wz4 = __ldg(v + V_TAIL + 1);
  float l0 = s0 + b4 + r.z0 * wz4, l1 = s1 + b4 + r.z1 * wz4;
  if (HR) {
    const float wp4 = __ldg(v + V_TAIL + 2);
    l0 += r.p0 * wp4;
    l1 += r.p1 * wp4;
  }
  return make_float2(1.f / (1.f + expf(-l0)), 1.f / (1.f + expf(-l1)));
}

// The producer: one thread walks the stages of every tile in order, each
// slot refilled once all 256 consumer threads have released it.
__device__ __forceinline__ void k1_produce(const K1Args& a, uint32_t ring0,
                                           uint32_t full, uint32_t empty) {
  uint32_t i = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
#pragma unroll 1
    for (int m = 0; m < 2; ++m) {
      const bf16* w = a.stages + (size_t)m * K1_STAGES * STAGE_ELEMS;
#pragma unroll 1
      for (int s = 0; s < K1_STAGES; ++s, ++i) {
        const int slot = i % K1_SLOTS;
        mbar_wait(empty + 8 * slot, ((i / K1_SLOTS) & 1) ^ 1);
        const uint32_t bytes = (uint32_t)__ldg(a.nbytes + s);
        mbar_arrive_tx(full + 8 * slot, bytes);
        bulk_g2s(ring0 + slot * STAGE_BYTES, w + (size_t)s * STAGE_ELEMS,
                 bytes, full + 8 * slot);
      }
    }
  }
}

// The consumers: warpgroup w owns tile rows [64 w, 64 w + 64).
__device__ __forceinline__ void k1_consume(const K1Args& a, bf16* H,
                                           K1Ring ring) {
  const int t = threadIdx.x;
  const int w = t >> 7, tw = t & 127, q = tw >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 64 * w + 16 * q + gid;       // rows m0 and m0 + 8
  bf16* X = H + X_OFF / 2;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    // every warp of the group is past the previous tile's reads of X
    bar_sync(1 + w, 128);
    stage_x(X, a, tile, w, tw);
    fence_proxy_async();
    bar_sync(1 + w, 128);
    const int g0 = tile * MROWS + m0, g1 = g0 + 8;   // n < 2^31
    K1Rows r;
    r.z0 = g0 < a.n ? bf16r(x_at(a, g0, ZCOL)) : 0.f;
    r.z1 = g1 < a.n ? bf16r(x_at(a, g1, ZCOL)) : 0.f;
    r.p0 = r.p1 = 0.f;
    const float2 lr = k1_mlp<false>(a, ring, H, r, tile, w, m0, tw, tig);
    if (tig == 0) {
      if (g0 < a.n) a.out_lr[g0] = lr.x;
      if (g1 < a.n) a.out_lr[g1] = lr.y;
    }
    // the fine MLP reads the coarse prediction as input column 321
    r.p0 = bf16r(lr.x);
    r.p1 = bf16r(lr.y);
    const float2 hr = k1_mlp<true>(a, ring, H, r, tile, w, m0, tw, tig);
    if (tig == 0) {
      if (g0 < a.n) a.out_hr[g0] = hr.x;
      if (g1 < a.n) a.out_hr[g1] = hr.y;
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_dual_mlp_wgmma_kernel(K1Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + K1_BAR_OFF);
  const uint32_t empty = full + 8 * K1_SLOTS;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < K1_SLOTS; ++s) {
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
      k1_produce(a, smem_u32(smem + K1_RING_OFF), full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    k1_consume(a, reinterpret_cast<bf16*>(smem),
               K1Ring{smem_u32(smem + K1_RING_OFF), full, empty, 0u, 0u});
  }
}

}  // namespace

extern "C" {

// Launch K1 (bf16) on `stream`; returns cudaGetLastError() (0 on
// success). x0 [n, w0] and x1 [n, w1] float32 (x1 may be null when
// w1 == 0), w0 + w1 == 321; stages, nbytes, vec from
// ops/fused_mlp.py:prepare_fused_weights (K1Packed); out_* [n] float32.
int surs_fused_dual_mlp_bf16(const void* x0, int w0, const void* x1, int w1,
                             int n, const void* stages, const void* nbytes,
                             const void* vec, void* out_hr, void* out_lr,
                             void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_dual_mlp_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K1_SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + MROWS - 1) / MROWS;
  const int vec0 = w0 % 4 == 0 && (size_t)x0 % 16 == 0;
  K1Args a{(const float*)x0, w0, vec0, (const float*)x1, w1, n, tiles,
           (const bf16*)stages, (const int*)nbytes, (const float*)vec,
           (float*)out_hr, (float*)out_lr};
  fused_dual_mlp_wgmma_kernel<<<tiles < sms ? tiles : sms, WG_THREADS,
                                K1_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
