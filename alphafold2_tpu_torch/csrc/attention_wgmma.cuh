// A warpgroup attention mainloop for Hopper (sm_90a): TMA loads into
// mbarrier rings, wgmma products in consumer warpgroups, persistent
// blocks. Used by the fused biased attention (fused_attention.cu, K1,
// layout 3); the block-sparse attention (block_sparse.cu, K2, layout 3)
// builds its own mainloop from the same pieces (the mbarrier and TMA
// helpers, the descriptors and wgmma instances, tile_logits, Ring and the
// host's tensor-map encoding).
//
// A block has kThreads threads: kConsumers consumer warpgroups (warps
// 0-7) and one producer warp (warp 8). The grid is one block per SM (at
// most one per unit); each block walks the units blockIdx.x, blockIdx.x +
// gridDim.x, ... where a unit is (batch*head row bh, kTileRows = 128
// query rows). Per unit:
//
//   producer   lane 0 loads the unit's Q tile into one of two Q buffers
//              (the other may still be in use), then, for each key tile
//              of BK keys, K with the fp32 bias tile of the same (rows,
//              keys) into a stage of the K ring and V into a stage of the
//              V ring, each once its stage is free; the warp's 32 lanes
//              write the tile's key flags (1 valid, 0 masked, -1 past Nk)
//              beside K and arrive on its "full" barrier, lane 0 with the
//              TMA's byte count. Loads run ahead across units.
//   consumer   each warpgroup owns 64 query rows. Per key tile t: S_t =
//              Q . K_t^T by wgmma from 128-byte-swizzled shared tiles
//              (64- or 32-byte swizzle at D = 32 or 16) and the delayed
//              O += P_{t-1} . V_{t-1} (P in registers: the S accumulator
//              layout is wgmma's register A layout; V through a transposed,
//              MN-major, descriptor) are issued as two groups; once S_t is
//              done, its softmax (the bias read from the stage,
//              conflict-free through the same swizzle; the masks; the
//              online update in fp32 registers) runs while P . V is still
//              on the tensor cores, and each warp frees K stage t; then V
//              stage t-1 is freed and O rescaled. After the last tile O is
//              normalised, written as bf16 into a swizzled shared tile and
//              stored by one TMA store per warpgroup (rows past Nq are
//              clipped).
//
// The tensor maps are 3-D, (B, N, D) and (Bb, Nq, Nk), so rows and keys
// past N are zero-filled per batch*head row, never read from the next.
// Keys past Nk count -inf; masked logits are REPLACED by -1e9 after the
// bias add; q arrives pre-scaled; the softmax is fp32 (p = exp2(x log2 e -
// max log2 e); exactly 1 for a fully masked row's -1e9 logits).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace af2wg {

constexpr float kMaskValue = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;                         // query rows a warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kTileRows = kRows * kConsumers;     // query rows a unit
constexpr int kConsumerThreads = kConsumers * 128;
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kBiasCols = 32;                     // fp32 keys a bias box

// Tile sizes and the shared-memory plan of one instance. Q and O tiles
// and each K / V tile are NCB column blocks of DC elements (one swizzle
// span, SW bytes, a row); a bias tile is BK / 32 blocks of 32 keys by
// kTileRows rows. Two rings: KSTAGES stages of K with its bias tile and
// key flags, freed once the softmax has read them; VSTAGES stages of V,
// freed after the (delayed) P . V product.
template <int D, int BIAS>
struct Config {
  static constexpr int BK = BIAS ? (D >= 128 ? 32 : 64) : (D >= 128 ? 64 : 128);
  static constexpr int KSTAGES = (BIAS && D == 64) ? 3 : 4;
  static constexpr int VSTAGES = 4;
  static constexpr int DC = D < 64 ? D : 64;
  static constexpr int SW = DC * 2;
  static constexpr int NCB = D / DC;
  static constexpr int Q_BYTES = kTileRows * D * 2;
  static constexpr int QCB = kTileRows * SW;      // column block stride
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BIAS_BYTES = BIAS ? kTileRows * BK * 4 : 0;
  static constexpr int KSTAGE_BYTES = KV_BYTES + BIAS_BYTES;
  static constexpr int O_OFF = 2 * Q_BYTES;       // after two Q buffers
  static constexpr int KRING_OFF = 3 * Q_BYTES;
  static constexpr int VRING_OFF = KRING_OFF + KSTAGES * KSTAGE_BYTES;
  static constexpr int FLAG_OFF = VRING_OFF + VSTAGES * KV_BYTES;
  static constexpr int OK_OFF = FLAG_OFF + KSTAGES * BK * 4;   // tile_ok
  static constexpr int BAR_OFF = OK_OFF + ((KSTAGES * 4 + 7) & ~7);
  // + 1024: the base is aligned up to the 1024-byte swizzle pattern
  static constexpr int SMEM =
      BAR_OFF + (2 * KSTAGES + 2 * VSTAGES + 4) * 8 + 1024;
  static_assert(D % 16 == 0 && D <= 128 && BK % kBiasCols == 0, "shape");
  static_assert(SMEM <= 232448, "shared memory");
};

// The tensor maps of one launch (kernel parameters, __grid_constant__)
struct Maps {
  CUtensorMap q, k, v, bias, out;
};

struct Params {
  const uint8_t* q_mask;    // (B / heads, Nq) flags, or null
  const uint8_t* k_mask;    // (B / heads, Nk) flags, or null
  int nq, nk, heads, bias_repeat;
  int q_tiles;              // units of one batch*head row
  int units;                // B * q_tiles
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// ~9 s at the H100's clock: no wait of a healthy ring comes near it
constexpr long long kWaitLimitCycles = 1LL << 34;

// wait until the phase of parity `parity` has completed; a wait that
// cannot end (a fault in the ring's bookkeeping) traps, so the launch
// fails with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > kWaitLimitCycles) __trap();
}

// ---- TMA ------------------------------------------------------------------
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's stores have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N committed groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of wgmma accumulators across the
// asynchronous product's wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode of SW-byte rows.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// byte offset -> its place in a tile of SW-byte rows under the TMA's
// SW-byte swizzle (16-byte chunks XORed with the row's low bits)
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ ((off >> 3) & ((SW / 16 - 1) << 4));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (64 x 16, fp32) += A . B; A (64 x 16) from registers, B (16 x 16)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, fp32) = A . B (+ d when `accumulate`); A (64 x 16) and
// B (16 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, fp32) = A . B (+ d when `accumulate`); A (64 x 16) and
// B (32 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, fp32) += A . B; A (64 x 16) from registers, B (16 x 32)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, fp32) = A . B (+ d when `accumulate`); A (64 x 16) and
// B (64 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A . B; A (64 x 16) from registers, B (16 x 64)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) = A . B (+ d when `accumulate`); A (64 x 16) and
// B (128 x 16) from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += A . B; A (64 x 16) from registers, B (16 x 128)
// from shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the kernel body ------------------------------------------------------
// S + bias with the masks of one key tile, into s; the rows' maxima into
// mx. FAST: every key of the tile exists and is unmasked and both of the
// thread's rows are valid, so no mask is looked at. Two partial maxima a
// row keep the dependency chains short. The bias tile is BK / BCOLS boxes
// of BROWS rows by BCOLS fp32 keys, each under the TMA's (BCOLS * 4)-byte
// swizzle (K1: boxes of 128 rows by 32 keys). SCALED: the fp32 logits are
// multiplied by `scale` before the bias add (K2; K1's q arrives scaled).
template <int BK, int BIAS, bool FAST, int BROWS = kTileRows,
          int BCOLS = kBiasCols, bool SCALED = false>
__device__ __forceinline__ void tile_logits(float (&s)[BK / 2],
                                            const uint8_t* bias_tile,
                                            const float* flags,
                                            const bool (&q_ok)[2], int row0,
                                            int t4, float (&mx)[2],
                                            float scale = 1.f) {
  constexpr int BROW = BCOLS * 4;   // bytes of one bias row
  float part[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    bool ok[2][2];
    float2 fill = make_float2(0.f, 0.f);
    if constexpr (!FAST) {
      // keys past Nk are -inf; masked logits are replaced by -1e9
      const float2 kf = *reinterpret_cast<const float2*>(flags + c);
      fill = make_float2(kf.x < 0.f ? -INFINITY : kMaskValue,
                         kf.y < 0.f ? -INFINITY : kMaskValue);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ok[r][0] = kf.x > 0.f && q_ok[r];
        ok[r][1] = kf.y > 0.f && q_ok[r];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x0 = s[4 * j + 2 * r];
      float x1 = s[4 * j + 2 * r + 1];
      if constexpr (SCALED) {
        x0 *= scale;
        x1 *= scale;
      }
      if constexpr (BIAS != 0) {
        const uint32_t off = (row0 + 8 * r) * BROW + (c % BCOLS) * 4;
        const float2 b = *reinterpret_cast<const float2*>(
            bias_tile + (c / BCOLS) * BROWS * BROW + swizzle<BROW>(off));
        x0 += b.x;
        x1 += b.y;
      }
      if constexpr (!FAST) {
        x0 = ok[r][0] ? x0 : fill.x;
        x1 = ok[r][1] ? x1 : fill.y;
      }
      s[4 * j + 2 * r] = x0;
      s[4 * j + 2 * r + 1] = x1;
      part[r][j & 1] = fmaxf(part[r][j & 1], fmaxf(x0, x1));
    }
  }
  mx[0] = fmaxf(part[0][0], part[0][1]);
  mx[1] = fmaxf(part[1][0], part[1][1]);
}

// A ring position: stage and phase parity
struct Ring {
  int stage = 0, phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int D, int BIAS>
__device__ __forceinline__ void attend(const Maps& maps, const Params& p) {
  using C = Config<D, BIAS>;
  constexpr int BK = C::BK, SW = C::SW, DC = C::DC;
  constexpr int KSTAGES = C::KSTAGES, VSTAGES = C::VSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* os = smem + C::O_OFF;
  uint8_t* kring = smem + C::KRING_OFF;
  uint8_t* vring = smem + C::VRING_OFF;
  float* flags = reinterpret_cast<float*>(smem + C::FLAG_OFF);
  int* tile_ok = reinterpret_cast<int*>(smem + C::OK_OFF);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* k_empty = k_full + KSTAGES;
  uint64_t* v_full = k_empty + KSTAGES;
  uint64_t* v_empty = v_full + VSTAGES;
  uint64_t* q_full = v_empty + VSTAGES;    // two, one per Q buffer
  uint64_t* q_empty = q_full + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KSTAGES; ++s) {
      mbar_init(&k_full[s], 32);             // the producer warp's lanes
      mbar_init(&k_empty[s], kConsumers * 4);   // every consumer warp
    }
    for (int s = 0; s < VSTAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumers);    // one thread a warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ntiles = (p.nk + BK - 1) / BK;
  // the warpgroup index, warp-uniform to the compiler (a shuffle's result
  // is): a wgmma in a path it must treat as divergent is serialised
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == kConsumers) {
    // ---- the producer warp ----
    const int lane = threadIdx.x % 32;
    Ring kr, vr;
    int n = 0;   // the block's units so far
    for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x, ++n) {
      const int bh = unit / p.q_tiles;
      const int q0 = (unit % p.q_tiles) * kTileRows;
      const int brow = (bh / (p.bias_repeat * p.heads)) * p.heads +
                       bh % p.heads;
      const uint8_t* km = p.k_mask == nullptr
                              ? nullptr
                              : p.k_mask + (size_t)(bh / p.heads) * p.nk;
      if (lane == 0) {
        // Q buffer n % 2, free once unit n - 2 has read it
        const int qb = n & 1;
        mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        mbar_arrive_tx(&q_full[qb], C::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load(qs + qb * C::Q_BYTES + cb * C::QCB, &maps.q, &q_full[qb],
                   cb * DC, q0, bh);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int j0 = it * BK;
        // K, its bias tile and its key flags (1 valid, 0 masked, -1 past
        // Nk; the mask bytes are read before the wait for a free stage)
        float f[BK / 32];
        bool valid = true;
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) {
          const int j = j0 + lane + 32 * i;
          f[i] = j >= p.nk ? -1.f : (km == nullptr || km[j] != 0) ? 1.f
                                                                  : 0.f;
        }
        mbar_wait(&k_empty[kr.stage], kr.phase ^ 1);
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) {
          flags[kr.stage * BK + lane + 32 * i] = f[i];
          valid = valid && f[i] > 0.f;
        }
        valid = __all_sync(0xffffffffu, valid);
        if (lane == 0) {
          tile_ok[kr.stage] = valid;
          uint8_t* st = kring + kr.stage * C::KSTAGE_BYTES;
          mbar_arrive_tx(&k_full[kr.stage], C::KSTAGE_BYTES);
#pragma unroll
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(st + cb * BK * SW, &maps.k, &k_full[kr.stage], cb * DC,
                     j0, bh);
          if constexpr (BIAS != 0) {
#pragma unroll
            for (int i = 0; i < BK / kBiasCols; ++i)
              tma_load(st + C::KV_BYTES + i * kTileRows * 128, &maps.bias,
                       &k_full[kr.stage], j0 + i * kBiasCols, q0, brow);
          }
          // V
          mbar_wait(&v_empty[vr.stage], vr.phase ^ 1);
          mbar_arrive_tx(&v_full[vr.stage], C::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < C::NCB; ++cb)
            tma_load(vring + vr.stage * C::KV_BYTES + cb * BK * SW, &maps.v,
                     &v_full[vr.stage], cb * DC, j0, bh);
        } else {
          mbar_arrive(&k_full[kr.stage]);
        }
        kr.advance<KSTAGES>();
        vr.advance<VSTAGES>();
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  // Per key tile t a warpgroup issues S_t = Q . K_t^T and the delayed
  // O += P_{t-1} . V_{t-1} as two commit groups, waits for S_t only and
  // runs the softmax of S_t into P_t while P_{t-1} . V_{t-1} is still on
  // the tensor cores; each warp frees K stage t as soon as its softmax is
  // done; then the warpgroup waits for the product, frees V stage t-1 and
  // rescales O. P alternates between two register sets (the loop is
  // unrolled by two), since the product in flight still reads the other.
  const int wg = role;
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = wg * kRows + (wtid / 32) * 16 + g;   // and row0 + 8
  const uint32_t q_base = smem_u32(qs) + wg * kRows * SW;
  // A V stage (or Q buffer) is released by one thread of the warpgroup,
  // after a wgmma wait: the product completes only once all four warps
  // have issued it, so every warp is past its reads. A K stage is
  // released by each warp after its own softmax.
  auto release = [&](uint64_t* bar) {
    if (wtid == 0) mbar_arrive(bar);
  };
  auto release_warp = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  Ring kr, vr;
  int n = 0;
  for (int unit = blockIdx.x; unit < p.units; unit += gridDim.x, ++n) {
    const int bh = unit / p.q_tiles;
    const int q0 = (unit % p.q_tiles) * kTileRows;
    const int mrow = bh / p.heads;
    bool q_ok[2];            // the thread's two rows are valid queries
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row0 + 8 * r;
      q_ok[r] = p.q_mask == nullptr ||
                (i < p.nq && p.q_mask[(size_t)mrow * p.nq + i] != 0);
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float s[BK / 2];
    float scale[2];
    uint32_t pa0[BK / 16][4], pa1[BK / 16][4];

    const int qb = n & 1;
    const uint32_t q_addr = q_base + qb * C::Q_BYTES;
    auto issue_s = [&](int stg) {
      const uint32_t k_addr = smem_u32(kring + stg * C::KSTAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16;
        wgmma_ss(s,
                 make_desc<SW>(q_addr + (col / DC) * C::QCB + (col % DC) * 2,
                               16, 8 * SW),
                 make_desc<SW>(k_addr + (col / DC) * BK * SW + (col % DC) * 2,
                               16, 8 * SW),
                 kk > 0);
      }
    };
    auto issue_pv = [&](int stg, const uint32_t (&pa)[BK / 16][4]) {
      const uint32_t v_addr = smem_u32(vring + stg * C::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(o, pa[kk],
                 make_desc<SW>(v_addr + kk * 16 * SW, BK * SW, 8 * SW));
    };
    // bias, masks and the online softmax of S (K stage stg) into P; the
    // rescale of O it asks for is left in `scale`
    auto softmax = [&](int stg, uint32_t (&pa)[BK / 16][4]) {
      const uint8_t* bias_tile = kring + stg * C::KSTAGE_BYTES + C::KV_BYTES;
      const bool fast = tile_ok[stg] && q_ok[0] && q_ok[1];
      float mx[2];
      if (fast)
        tile_logits<BK, BIAS, true>(s, bias_tile, flags + stg * BK, q_ok,
                                    row0, t4, mx);
      else
        tile_logits<BK, BIAS, false>(s, bias_tile, flags + stg * BK, q_ok,
                                     row0, t4, mx);
      // every tile holds a key that exists, so the new max is finite and
      // exp2(-inf) = 0 rescales the first tile
      float mul[2], add[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        scale[r] = exp2_approx((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= scale[r];
        // p = exp2(x * mul + add): x log2 e - max log2 e in one FFMA; a
        // row whose max is the mask value holds only -1e9 and -inf, and
        // x + 1e9 is exactly 0 (p = 1) or -inf (p = 0)
        const bool masked = m_new == kMaskValue;
        mul[r] = masked ? 1.f : kLog2e;
        add[r] = masked ? -kMaskValue : -m_new * kLog2e;
      }
      float lp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], mul[r], add[r]));
        lp[r][(i >> 2) & 1] += s[i];
      }
      l[0] += lp[0][0] + lp[0][1];
      l[1] += lp[1][0] + lp[1][1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto rescale_o = [&] {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= scale[0];
        o[4 * j + 1] *= scale[0];
        o[4 * j + 2] *= scale[1];
        o[4 * j + 3] *= scale[1];
      }
    };
    // S_it's softmax into pa, then K stage it freed
    auto scores = [&](int it, uint32_t (&pa)[BK / 16][4]) {
      if (it == ntiles - 1) release(&q_empty[qb]);   // Q is read
      softmax(kr.stage, pa);
      release_warp(&k_empty[kr.stage]);
      kr.advance<KSTAGES>();
    };
    // tile it >= 1: P_it into pa_new while P_{it-1} . V_{it-1} (pa_old)
    // runs
    auto tile = [&](int it, uint32_t (&pa_new)[BK / 16][4],
                    const uint32_t (&pa_old)[BK / 16][4]) {
      mbar_wait(&k_full[kr.stage], kr.phase);
      mbar_wait(&v_full[vr.stage], vr.phase);
      wgmma_fence();
      issue_s(kr.stage);
      wgmma_commit();
      issue_pv(vr.stage, pa_old);
      wgmma_commit();
      wgmma_wait<1>();                          // S_it
      fence_regs(s);
      scores(it, pa_new);
      wgmma_wait<0>();                          // P_{it-1} . V_{it-1}
      fence_regs(o);
      release(&v_empty[vr.stage]);
      vr.advance<VSTAGES>();
      rescale_o();
    };
    // the last tile's P . V
    auto last_pv = [&](const uint32_t (&pa)[BK / 16][4]) {
      mbar_wait(&v_full[vr.stage], vr.phase);
      wgmma_fence();
      issue_pv(vr.stage, pa);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(&v_empty[vr.stage]);
      vr.advance<VSTAGES>();
    };

    mbar_wait(&q_full[qb], (n >> 1) & 1);
    // tile 0: S only
    mbar_wait(&k_full[kr.stage], kr.phase);
    wgmma_fence();
    issue_s(kr.stage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    scores(0, pa0);                             // O is 0: no rescale
    int it = 1;
    for (; it + 1 < ntiles; it += 2) {
      tile(it, pa1, pa0);
      tile(it + 1, pa0, pa1);
    }
    if (it < ntiles) {
      tile(it, pa1, pa0);
      last_pv(pa1);
    } else {
      last_pv(pa0);
    }

    // O / l as bf16 into the warpgroup's rows of the swizzled O tile,
    // then one TMA store (rows past Nq are clipped by the tensor map); a
    // warpgroup whose rows all lie past Nq stores nothing
    if (q0 + wg * kRows < p.nq) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = __frcp_rn(l[r]);
      }
      if (wtid == 0) bulk_wait_read();   // the last store has read it
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = (row0 + 8 * r) * SW + (c % DC) * 2;
          *reinterpret_cast<uint32_t*>(os + (c / DC) * C::QCB +
                                       swizzle<SW>(off)) =
              pack_bf16(o[4 * j + 2 * r] * inv[r],
                        o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (wtid == 0) {
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_store(&maps.out, os + cb * C::QCB + wg * kRows * SW, cb * DC,
                    q0 + wg * kRows, bh);
        bulk_commit();
      }
    }
  }
  if (wtid == 0) bulk_wait();
}

// ---- host: tensor maps ----------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The map of a row-major (outer, rows, cols) tensor of `elem`-byte
// elements read or written in boxes of (1, box_rows, box_cols), zero
// fill past the edges. False when the driver refuses it (a base not
// 16-byte aligned, a row stride not a multiple of 16 bytes).
inline bool encode_3d(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType type, int elem, uint64_t outer,
                      uint64_t rows, uint64_t cols, uint32_t box_rows,
                      uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * elem, rows * cols * elem};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int SW>
constexpr CUtensorMapSwizzle swizzle_mode() {
  return SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The five maps of one K1 launch (out is written by 64-row boxes, one
// per warpgroup). False when one is refused.
template <int D, int BIAS>
bool encode_maps(Maps* maps, const void* q, const void* k, const void* v,
                 const float* bias, void* out, int b, int nq, int nk,
                 int bias_rows) {
  using C = Config<D, BIAS>;
  constexpr CUtensorMapSwizzle sw = swizzle_mode<C::SW>();
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = encode_3d(&maps->q, q, bf16, 2, b, nq, D, kTileRows, C::DC, sw) &&
            encode_3d(&maps->k, k, bf16, 2, b, nk, D, C::BK, C::DC, sw) &&
            encode_3d(&maps->v, v, bf16, 2, b, nk, D, C::BK, C::DC, sw) &&
            encode_3d(&maps->out, out, bf16, 2, b, nq, D, kRows, C::DC, sw);
  if (ok && BIAS)
    ok = encode_3d(&maps->bias, bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   bias_rows, nq, nk, kTileRows, kBiasCols,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  return ok;
}

}  // namespace af2wg
