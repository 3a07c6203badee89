// Kernel K2: the training dual MLP on Hopper (sm_90a), float32-accurate
// on the tensor cores (3xTF32).
//
// Replaces the Pallas kernel `fused_dual_mlp_train` (body `_kernel_train`)
// of surs_tpu/ops/fused_mlp.py. The coarse MLP 321 -> 1024 -> 512 -> 256
// -> 128 -> 1 runs on xa (the HR sample points); the fine MLP (322 inputs,
// the same shape) on [xb, mask_a * pred_lr] (the LR sample points). The
// input is re-concatenated before layers 2-4, leaky-ReLU 0.01 sits between
// layers, a sigmoid comes last; both outputs unmasked. Weights float32.
//
// What bounds it: 54.78 GFLOP per 12,000-point call against about 24 MB
// of inputs and weights: operations. Float32 FMA peaks at 67 TFLOP/s
// (0.818 ms); TF32 on the tensor cores at 495, but keeps 10 mantissa bits.
//
// The arithmetic, 3xTF32: every operand v is split into hi = tf32_rna(v)
// and lo = tf32_rna(v - hi), tf32_rna(v) being (bits(v) + 0x1000) &
// 0xFFFFE000 (what cvt.rna.tf32.f32 gives for a finite v; integer code
// here and in ops/fused_mlp.py:tf32_split, so host and card agree bit for
// bit). A product a.b becomes lo_a.hi_b + hi_a.lo_b + hi_a.hi_b, summed in
// that order (small terms first) into one float32 accumulator; lo_a.lo_b
// (2^-22 relative) is dropped. Three TF32 products: 0.332 ms at the peak.
//
// The design: one GEMM kernel per layer and MLP,
//   out = leaky(A . W^T + b),  A = [a1 | a2] along k (h, then the input),
// on a tile of 128 rows x 128 outputs: two consumer warpgroups (64 rows
// each) and a producer warpgroup, whose registers go to the consumers
// (setmaxnreg), one thread of which streams k-chunks of 32 through a ring
// of SLOTS stages with cp.async.bulk on mbarriers. A stage is A_hi, A_lo,
// B_hi, B_lo, each [128 rows x 32] float32 (16 KB) in the 128-byte-
// swizzled K-major layout; per chunk each consumer issues 4 k8 steps x 3
// products of wgmma m64n128k8 tf32, both operands in shared memory, into
// a fresh m64n128 float32 partial, then adds the partial to its float32
// sum on the CUDA cores. The tensor cores add each step into the
// accumulator with a truncating alignment, about an ulp toward zero a
// step: over a whole layer (up to 3 x 1,024 / 8 steps) that bias reached
// 9e-6 of the output; summed per chunk of 12 steps and then rounded to
// nearest, it stays at the float32 FMA's level. Every operand is
// pre-split and pre-swizzled in global memory, so the GEMM only copies
// and multiplies:
//   * weights: the pack kernel reads ops/fused_mlp.py's FusedWeights
//     packing ([in, out] blocks, dual_mlp.cuh's OFF_W*) and writes each
//     W_i [out, in] as hi and lo tiles (the input block padded to KX =
//     352 columns, a multiple of 32), per call, on the card;
//   * activations: each epilogue writes leaky(sum + b) split, as hi and lo
//     tiles of the next layer's A;
//   * inputs: the split kernel writes xa and xb as hi / lo tiles.
// The head kernel runs layer 4 (128 + 322 -> 1) and the sigmoid in
// float32 FMA, a warp per point, from the FusedWeights packing. After the
// coarse MLP it also writes mask_a * pred_lr, split, into input column 321
// of xb's tiles: the fine MLP's conditioning.
//
// Tile layout of an operand [rows, K] (K a multiple of 32): tiles of
// [128 rows x 32 k] ordered [rows / 128][K / 32], each 128-byte row of a
// tile holding its 16-byte chunk c at chunk c ^ (row % 8): see tile_off.
//
// Built with nvcc into a shared library with a plain C interface
// (ops/cuda_build.py); the wrapper is ops/fused_mlp.py:fused_dual_mlp_train.

#include "dual_mlp.cuh"
#include "hopper.cuh"

namespace {

constexpr int TM = 128, TK = 32;           // rows (and outputs) x k of a tile
constexpr int TILE = TM * TK;              // 4,096 floats
constexpr int TILE_BYTES = TILE * 4;       // 16 KB
constexpr int SLOTS = 3;                   // ring stages
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // A_hi, A_lo, B_hi, B_lo
constexpr int CONSUMERS = 256;             // two warpgroups, 64 rows each
constexpr int GEMM_THREADS = CONSUMERS + 128;  // + the producer warpgroup
// registers a thread after the split (setmaxnreg): 2 x 128 x 240 +
// 128 x 24 of the SM's 65,536
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int BAR_OFF = SLOTS * STAGE_BYTES;
// + 1,024 bytes to align the base for the swizzle atoms
constexpr size_t GEMM_SMEM = BAR_OFF + 2 * SLOTS * 8 + 1024;
static_assert(GEMM_SMEM <= 232448, "over a block's 227 KB of shared memory");

// the input padded to a multiple of 32 (ops/fused_mlp.py:K2_XK): 11 chunks
constexpr int KX = 352, KXC = KX / TK;
// one MLP's weight tiles (ops/fused_mlp.py:K2_LAYERS): per layer the hi
// tiles then the lo tiles of W [n, k], k = kh (the h width) + KX for the
// layers that read the input
constexpr size_t WBUF = 2ull * (D0 * KX + D1 * D0 + D2 * (D1 + KX) +
                                D3 * (D2 + KX));
struct Layer {
  int n, k, kh;
  size_t off;      // in one MLP's tiles
  size_t wh, wx;   // the h and x blocks in the FusedWeights packing
  int bias;        // the bias, ditto
};
__host__ __device__ __forceinline__ Layer layer_of(int i) {
  constexpr size_t O1 = 2ull * D0 * KX, O2 = O1 + 2ull * D1 * D0,
                   O3 = O2 + 2ull * D2 * (D1 + KX);
  switch (i) {
    case 0: return Layer{D0, KX, 0, 0, 0, OFF_W0X, OFF_B0};
    case 1: return Layer{D1, D0, D0, O1, OFF_W1H, 0, OFF_B1};
    case 2: return Layer{D2, D1 + KX, D1, O2, OFF_W2H, OFF_W2X, OFF_B2};
    default: return Layer{D3, D2 + KX, D2, O3, OFF_W3H, OFF_W3X, OFF_B3};
  }
}

constexpr int HEAD_WARPS = 8;              // points per head block
constexpr int SPLIT_THREADS = 256, PACK_THREADS = 256;

// tf32 round-to-nearest, ties away from zero, of a finite float32
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// offset of element (m, k) in the tile layout of an operand of kc k-chunks
__device__ __forceinline__ size_t tile_off(int m, int k, int kc) {
  return ((size_t)(m >> 7) * kc + (k >> 5)) * TILE + (m & 127) * 32 +
         ((((k >> 2) & 7) ^ (m & 7)) << 2) + (k & 3);
}

// 4 values split into hi and lo at the tile offset o (o % 4 == 0)
__device__ __forceinline__ void store_split4(float* hi, float* lo, size_t o,
                                             const float (&v)[4]) {
  float4 h, l;
  h.x = tf32_rna(v[0]); h.y = tf32_rna(v[1]);
  h.z = tf32_rna(v[2]); h.w = tf32_rna(v[3]);
  l.x = tf32_rna(v[0] - h.x); l.y = tf32_rna(v[1] - h.y);
  l.z = tf32_rna(v[2] - h.z); l.w = tf32_rna(v[3] - h.w);
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(lo + o) = l;
}

// 2 values split into hi and lo at the tile offset o (o % 2 == 0)
__device__ __forceinline__ void store_split2(float* hi, float* lo, size_t o,
                                             float v0, float v1) {
  const float h0 = tf32_rna(v0), h1 = tf32_rna(v1);
  *reinterpret_cast<float2*>(hi + o) = make_float2(h0, h1);
  *reinterpret_cast<float2*>(lo + o) =
      make_float2(tf32_rna(v0 - h0), tf32_rna(v1 - h1));
}

struct Operand {
  const float* hi;   // [rows / 128][kc][TILE]
  const float* lo;
  int kc;            // k-chunks of 32
};

struct GemmArgs {
  Operand a1, a2;         // A = [a1 | a2] along k; a2.kc may be 0
  const float* b_hi;      // W [N, K] tiles [N / 128][a1.kc + a2.kc][TILE]
  const float* b_lo;
  const float* bias;      // [N]
  float* out_hi;          // leaky(A . W^T + b) tiles [M / 128][N / 32][TILE]
  float* out_lo;
  int ncs;                // N / 32
};

// The producer: one thread streams the tile's k-chunks, each slot refilled
// once all 256 consumer threads have released it.
__device__ __forceinline__ void gemm_produce(const GemmArgs& a, uint32_t ring,
                                             uint32_t full, uint32_t empty) {
  const int mt = blockIdx.y, nt = blockIdx.x;
  const int kcs = a.a1.kc + a.a2.kc;
#pragma unroll 1
  for (int kc = 0; kc < kcs; ++kc) {
    const int slot = kc % SLOTS;
    mbar_wait(empty + 8 * slot, ((kc / SLOTS) & 1) ^ 1);
    const bool first = kc < a.a1.kc;
    const float* ahi = first ? a.a1.hi : a.a2.hi;
    const float* alo = first ? a.a1.lo : a.a2.lo;
    const size_t ao = first ? ((size_t)mt * a.a1.kc + kc) * TILE
                            : ((size_t)mt * a.a2.kc + (kc - a.a1.kc)) * TILE;
    const size_t bo = ((size_t)nt * kcs + kc) * TILE;
    const uint32_t s = ring + slot * STAGE_BYTES, bar = full + 8 * slot;
    mbar_arrive_tx(bar, STAGE_BYTES);
    bulk_g2s(s, ahi + ao, TILE_BYTES, bar);
    bulk_g2s(s + TILE_BYTES, alo + ao, TILE_BYTES, bar);
    bulk_g2s(s + 2 * TILE_BYTES, a.b_hi + bo, TILE_BYTES, bar);
    bulk_g2s(s + 3 * TILE_BYTES, a.b_lo + bo, TILE_BYTES, bar);
  }
}

// The consumers: warpgroup w owns tile rows [64 w, 64 w + 64).
__device__ __forceinline__ void gemm_consume(const GemmArgs& a, uint32_t ring,
                                             uint32_t full, uint32_t empty) {
  const int t = threadIdx.x;
  const int w = t >> 7, warp = (t >> 5) & 3, lane = t & 31, tig = lane & 3;
  const int kcs = a.a1.kc + a.a2.kc;
  float acc[64], d[64];   // the sum and one chunk's partial
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < kcs; ++kc) {
    const int slot = kc % SLOTS;
    mbar_wait(full + 8 * slot, (kc / SLOTS) & 1);
    const uint32_t ah = ring + slot * STAGE_BYTES + w * (64 * 128);
    const uint32_t al = ah + TILE_BYTES;
    const uint32_t bh = ring + slot * STAGE_BYTES + 2 * TILE_BYTES;
    const uint32_t bl = bh + TILE_BYTES;
    wg_fence_acc(d);
    wg_fence();
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      // lo.hi + hi.lo + hi.hi: the small terms first; the chunk's first
      // product overwrites the partial
      wgmma_ss_tf32(d, wg_desc(al + 32 * j, 1024), wg_desc(bh + 32 * j, 1024),
                    j);
      wgmma_ss_tf32(d, wg_desc(ah + 32 * j, 1024), wg_desc(bl + 32 * j, 1024),
                    1);
      wgmma_ss_tf32(d, wg_desc(ah + 32 * j, 1024), wg_desc(bh + 32 * j, 1024),
                    1);
    }
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(d);
    // the chunk's products are done: its slot goes, its partial is added
    mbar_arrive(empty + 8 * slot);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }

  // the epilogue: rows m0 and m0 + 8, outputs n0 + 8 i + {0, 1}
  const int m0 = blockIdx.y * TM + 64 * w + 16 * warp + (lane >> 2);
  const int n0 = blockIdx.x * TM + 2 * tig;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = n0 + 8 * i;
    const float2 b = __ldg(reinterpret_cast<const float2*>(a.bias + n));
    store_split2(a.out_hi, a.out_lo, tile_off(m0, n, a.ncs),
                 leaky(acc[4 * i] + b.x), leaky(acc[4 * i + 1] + b.y));
    store_split2(a.out_hi, a.out_lo, tile_off(m0 + 8, n, a.ncs),
                 leaky(acc[4 * i + 2] + b.x), leaky(acc[4 * i + 3] + b.y));
  }
}

// One layer of one MLP: grid (N / 128, M / 128), a tile a block.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    fused_dual_mlp_train_tf32x3_gemm_kernel(GemmArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + BAR_OFF, empty = full + 8 * SLOTS;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // warpgroup 2 produces and hands its registers to warpgroups 0 and 1
  if (t >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (t == CONSUMERS) gemm_produce(a, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    gemm_consume(a, ring, full, empty);
  }
}

// Both MLPs' weights (blockIdx.z) from the FusedWeights packing ([in, out]
// blocks) as K2's tiles: layer blockIdx.y's W [n, k] split, hi tiles then
// lo tiles; a thread per 4 k of one output n (neighbouring threads on
// neighbouring n: the reads coalesce).
__global__ void __launch_bounds__(PACK_THREADS)
    fused_dual_mlp_train_tf32x3_pack_kernel(const float* __restrict__ w_lr,
                                            const float* __restrict__ w_hr,
                                            float* wt) {
  const Layer L = layer_of(blockIdx.y);
  const float* w = blockIdx.z ? w_hr : w_lr;
  const int q = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (q >= L.n * L.k / 4) return;
  const int n = q % L.n, k = 4 * (q / L.n);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kk = k + e;
    v[e] = kk < L.kh ? __ldg(w + L.wh + (size_t)kk * L.n + n)
           : kk - L.kh < XK ? __ldg(w + L.wx + (size_t)(kk - L.kh) * L.n + n)
                            : 0.f;
  }
  float* out = wt + blockIdx.z * WBUF + L.off;
  store_split4(out, out + (size_t)L.n * L.k, tile_off(n, k, L.k / TK), v);
}

// xa and xb (blockIdx.y) [n, w] as hi / lo tiles [mp / 128][KXC][TILE]:
// columns past w and rows past n zero.
__global__ void __launch_bounds__(SPLIT_THREADS)
    fused_dual_mlp_train_tf32x3_split_kernel(const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             int w, int n, int mp,
                                             float* xa_hi, float* xa_lo,
                                             float* xb_hi, float* xb_lo) {
  const bool b = blockIdx.y == 1;
  const float* x = b ? xb : xa;
  float* hi = b ? xb_hi : xa_hi;
  float* lo = b ? xb_lo : xa_lo;
  const int quads = KX / 4;
  const long long i = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= (long long)mp * quads) return;
  const int m = (int)(i / quads), k = 4 * (int)(i % quads);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = m < n && k + e < w ? __ldg(x + (size_t)m * w + k + e) : 0.f;
  store_split4(hi, lo, tile_off(m, k, KXC), v);
}

struct HeadArgs {
  const float* h_hi;   // layer 3's output tiles [mp / 128][D3 / 32][TILE]
  const float* h_lo;
  const float* x;      // the MLP's input [n, w] float32
  int w;
  int n;
  const float* wts;    // the MLP's FusedWeights packing: w4h, w4x
  const float* bias;   // ditto, its biases: b4
  const float* mask;   // [n]
  const float* cond;   // the fine MLP: pred_lr [n] (input column w is
                       // cond * mask); the coarse MLP: null
  float* out;          // [n]
  float* xb_hi;        // the coarse MLP: xb's tiles, column w gets
  float* xb_lo;        // split(mask * pred); the fine MLP: null
};

// The last layer (h3 . w4h + x . w4x + b4) and the sigmoid, a warp a point.
__global__ void __launch_bounds__(HEAD_WARPS * 32)
    fused_dual_mlp_train_tf32x3_head_kernel(HeadArgs a) {
  const int m = blockIdx.x * HEAD_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= a.n) return;
  // lane's 16-byte chunk of h3: columns 4 lane .. 4 lane + 3 (hi + lo is
  // the float32 activation, exactly)
  const size_t o = tile_off(m, 4 * lane, D3 / TK);
  const float4 hh = *reinterpret_cast<const float4*>(a.h_hi + o);
  const float4 hl = *reinterpret_cast<const float4*>(a.h_lo + o);
  const float* w4x = a.wts + OFF_W4X;
  const float4 wh = __ldg(reinterpret_cast<const float4*>(a.wts + OFF_W4H) +
                          lane);
  float s = (hh.x + hl.x) * wh.x + (hh.y + hl.y) * wh.y +
            (hh.z + hl.z) * wh.z + (hh.w + hl.w) * wh.w;
  for (int k = lane; k < a.w; k += 32)
    s += __ldg(a.x + (size_t)m * a.w + k) * __ldg(w4x + k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (a.cond) s += a.cond[m] * a.mask[m] * __ldg(w4x + a.w);
  const float p = 1.f / (1.f + expf(-(s + __ldg(a.bias + OFF_B4))));
  a.out[m] = p;
  if (a.xb_hi) {
    const float c = p * a.mask[m];
    const float h = tf32_rna(c);
    const size_t oc = tile_off(m, a.w, KXC);
    a.xb_hi[oc] = h;
    a.xb_lo[oc] = tf32_rna(c - h);
  }
}

cudaError_t launch_gemm(const GemmArgs& a, int mtiles, int n_out,
                        cudaStream_t stream) {
  fused_dual_mlp_train_tf32x3_gemm_kernel<<<dim3(n_out / TM, mtiles),
                                            GEMM_THREADS, GEMM_SMEM,
                                            stream>>>(a);
  return cudaGetLastError();
}

cudaError_t set_gemm_smem() {
  return cudaFuncSetAttribute(fused_dual_mlp_train_tf32x3_gemm_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)GEMM_SMEM);
}

cudaError_t launch_pack(const float* w_lr, const float* w_hr, float* wt,
                        cudaStream_t stream) {
  const int quads = D1 * D0 / 4;   // the largest layer's
  fused_dual_mlp_train_tf32x3_pack_kernel<<<
      dim3((quads + PACK_THREADS - 1) / PACK_THREADS, 4, 2), PACK_THREADS, 0,
      stream>>>(w_lr, w_hr, wt);
  return cudaGetLastError();
}

// hi / lo halves of a scratch operand of rows x k floats each
struct Buf {
  float* hi;
  float* lo;
};
Buf carve(float*& p, size_t rows, int k) {
  Buf b{p, p + rows * k};
  p += 2 * rows * k;
  return b;
}

// One MLP: layers 0-3 on the tensor cores (weight tiles wt), then the
// head.
cudaError_t run_mlp(Buf x, const Buf (&h)[4], const float* wt,
                    const float* bias, HeadArgs head, int mtiles,
                    cudaStream_t stream) {
  for (int i = 0; i < 4; ++i) {
    const Layer L = layer_of(i);
    GemmArgs g;
    g.a1 = i == 0 ? Operand{x.hi, x.lo, KXC}
                  : Operand{h[i - 1].hi, h[i - 1].lo, L.kh / TK};
    g.a2 = i >= 2 ? Operand{x.hi, x.lo, KXC} : Operand{nullptr, nullptr, 0};
    g.b_hi = wt + L.off;
    g.b_lo = wt + L.off + (size_t)L.n * L.k;
    g.bias = bias + L.bias;
    g.out_hi = h[i].hi;
    g.out_lo = h[i].lo;
    g.ncs = L.n / TK;
    const cudaError_t e = launch_gemm(g, mtiles, L.n, stream);
    if (e != cudaSuccess) return e;
  }
  head.h_hi = h[3].hi;
  head.h_lo = h[3].lo;
  fused_dual_mlp_train_tf32x3_head_kernel<<<
      (head.n + HEAD_WARPS - 1) / HEAD_WARPS, HEAD_WARPS * 32, 0, stream>>>(
      head);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K2 on `stream`: the weight pack, the split, the coarse MLP's four
// layers and head, the fine MLP's four layers and head (12 launches);
// returns the first cudaGetLastError() that is not 0. xa, xb [n, w]
// float32 with w == 321, mask_a [n]; w_*, b_* the float32 FusedWeights
// packing (ops/fused_mlp.py:prepare_fused_weights); wt [2, WBUF] floats
// for the weight tiles (ops/fused_mlp.py:K2_WBUF); scratch of
// ops/fused_mlp.py:k2_scratch_floats(n) floats: xa's and xb's tiles, then
// layers 0-3's outputs, each hi then lo, over n rounded up to 128 rows
// (carved in that order below); out_* [n] float32.
int surs_fused_dual_mlp_train_tf32x3(const void* xa, const void* xb,
                                     const void* mask_a, int w, int n,
                                     const void* w_lr, const void* b_lr,
                                     const void* w_hr, const void* b_hr,
                                     void* wt, void* scratch, void* out_hr,
                                     void* out_lr, void* stream) {
  cudaError_t e = set_gemm_smem();
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  float* wtf = (float*)wt;
  e = launch_pack((const float*)w_lr, (const float*)w_hr, wtf, s);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (n + TM - 1) / TM;
  const size_t mp = (size_t)mtiles * TM;
  float* p = (float*)scratch;
  const Buf xa_t = carve(p, mp, KX), xb_t = carve(p, mp, KX);
  const Buf h[4] = {carve(p, mp, D0), carve(p, mp, D1), carve(p, mp, D2),
                    carve(p, mp, D3)};
  const long long quads = (long long)mp * (KX / 4);
  fused_dual_mlp_train_tf32x3_split_kernel<<<
      dim3((unsigned)((quads + SPLIT_THREADS - 1) / SPLIT_THREADS), 2),
      SPLIT_THREADS, 0, s>>>((const float*)xa, (const float*)xb, w, n,
                             (int)mp, xa_t.hi, xa_t.lo, xb_t.hi, xb_t.lo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  HeadArgs lr{nullptr, nullptr, (const float*)xa, w, n, (const float*)w_lr,
              (const float*)b_lr, (const float*)mask_a, nullptr,
              (float*)out_lr, xb_t.hi, xb_t.lo};
  e = run_mlp(xa_t, h, wtf, (const float*)b_lr, lr, mtiles, s);
  if (e != cudaSuccess) return (int)e;
  HeadArgs hr{nullptr, nullptr, (const float*)xb, w, n, (const float*)w_hr,
              (const float*)b_hr, (const float*)mask_a,
              (const float*)out_lr, (float*)out_hr, nullptr, nullptr};
  return (int)run_mlp(xb_t, h, wtf + WBUF, (const float*)b_hr, hr, mtiles,
                      s);
}

// The weight pack alone on `stream` (its check): wt [2, WBUF] from the
// FusedWeights packing w_lr, w_hr.
int surs_k2_pack_weights(const void* w_lr, const void* w_hr, void* wt,
                         void* stream) {
  return (int)launch_pack((const float*)w_lr, (const float*)w_hr, (float*)wt,
                          (cudaStream_t)stream);
}

// One layer alone on `stream` (its check): out = leaky([a1 | a2] . W^T +
// b) for m_tiles x 128 rows and n_out outputs, every operand hi / lo
// tiles as above (a2 may be null with k2c == 0).
int surs_tf32x3_gemm(const void* a1_hi, const void* a1_lo, int k1c,
                     const void* a2_hi, const void* a2_lo, int k2c,
                     const void* b_hi, const void* b_lo, const void* bias,
                     void* out_hi, void* out_lo, int m_tiles, int n_out,
                     void* stream) {
  cudaError_t e = set_gemm_smem();
  if (e != cudaSuccess) return (int)e;
  GemmArgs g{Operand{(const float*)a1_hi, (const float*)a1_lo, k1c},
             Operand{(const float*)a2_hi, (const float*)a2_lo, k2c},
             (const float*)b_hi, (const float*)b_lo, (const float*)bias,
             (float*)out_hi, (float*)out_lo, n_out / TK};
  return (int)launch_gemm(g, m_tiles, n_out, (cudaStream_t)stream);
}

const char* surs_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
