// The wgmma chain shared by the bf16 K1 (fused_dual_mlp.cu) and the bf16
// K3/K4 (fused_cols_mlp.cu), whose ring the float32 K3/K4 share too: a
// persistent block of two consumer
// warpgroups (64 rows each, a tile of 128 rows) and one producer
// warpgroup that streams weights in 16 KB stages through a ring in
// shared memory; layer 1's output h1 [128, 512] bf16 in shared memory
// with the 128-byte swizzle, as layer 2's A.

#pragma once

#include "dual_mlp.cuh"
#include "hopper.cuh"

namespace {

constexpr int MROWS = 128;                  // rows per tile
constexpr int CONSUMERS = 256;              // two warpgroups, 64 rows each
constexpr int WG_THREADS = CONSUMERS + 128; // + the producer warpgroup
// registers a thread after the split (setmaxnreg): 2 x 128 x 240 +
// 128 x 24 of the SM's 65,536
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int SK = 64, SN = 128;            // a stage: 64 k x 128 n
constexpr int STAGE_ELEMS = SK * SN;        // 8,192 bf16, 16 KB
constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
constexpr int H1_BYTES = MROWS * D1 * 2;    // layer 1 out, [128, 512] bf16
constexpr int CHUNK_BYTES = MROWS * SK * 2; // 64 k of 128 rows, 16 KB

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
// element (m, k) of h1 (and of any [128, 64 c] tile in its layout): k-chunks
// of 64 k, each [128 rows x 128 bytes] with the 128-byte swizzle
__device__ __forceinline__ int h1_index(int m, int k) {
  return (k >> 6) * (MROWS * 64) + m * 64 +
         ((((k >> 3) & 7) ^ (m & 7)) << 3) + (k & 7);
}

// consumer side of a ring of NSLOTS stages of BYTES each: stage counter
// `head`, released up to `tail`
template <int NSLOTS, int BYTES = STAGE_BYTES>
struct RingT {
  uint32_t slots, full, empty;   // shared addresses of slot 0 and barriers
  uint32_t head, tail;
  __device__ __forceinline__ int wait() {
    const int slot = head % NSLOTS;
    mbar_wait(full + 8 * slot, (head / NSLOTS) & 1);
    ++head;
    return slot;
  }
  __device__ __forceinline__ void release_to(uint32_t h) {
    for (; tail < h; ++tail) mbar_arrive(empty + 8 * (tail % NSLOTS));
  }
  __device__ __forceinline__ uint32_t addr(int slot) const {
    return slots + slot * BYTES;
  }
  // B of k16 step j of a [64 k x 128 n] stage
  __device__ __forceinline__ uint64_t desc_b(int slot, int j) const {
    return wg_desc(addr(slot) + j * 32, 1024);
  }
};

// Layer 1's epilogue for outputs [nb, nb + 128): h1 = bf16(leaky(acc + b1)).
__device__ __forceinline__ void store_h1(const float (&acc)[64], bf16* h1,
                                         int nb, const float* b1, int m0,
                                         int tig) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = nb + 8 * i + 2 * tig;
    const float2 b = ldg2(b1 + n);
    *reinterpret_cast<uint32_t*>(h1 + h1_index(m0, n)) =
        pack_bf16(leaky(acc[4 * i] + b.x), leaky(acc[4 * i + 1] + b.y));
    *reinterpret_cast<uint32_t*>(h1 + h1_index(m0 + 8, n)) =
        pack_bf16(leaky(acc[4 * i + 2] + b.x), leaky(acc[4 * i + 3] + b.y));
  }
}

}  // namespace
