// One warp-level bf16 attention tile on Hopper's tensor cores, shared by
// the fused biased attention (fused_attention.cu, K1) and the
// block-skipping sparse attention (block_sparse.cu, K2).
//
// A *group* of WG warps owns R = 16 * WG query rows of one batch*head row
// and walks a sequence of key tiles of BK keys; each warp owns 16 of the
// rows. Per key tile and warp:
//
//   S = Q . K^T         mma.sync m16n8k16 bf16 -> fp32 accumulators; the
//                       Q fragment is loaded once with ldmatrix and kept
//                       in registers, K fragments come from ldmatrix
//   S = S * scale + bias, then masked logits replaced by -1e9, keys past
//                       the end -inf (the fp32 bias is read straight from
//                       device memory at the thread's own fragment
//                       positions: it is small and L2-resident)
//   online softmax      row max and row sum reduced across the quad with
//                       __shfl_xor_sync; O and l rescaled per tile
//   O += P . V          P rounded to bf16 in registers and fed back as the
//                       A operand (the m16n8 accumulator layout is the
//                       m16k16 A layout); V fragments from ldmatrix.trans
//
// k and v stay bf16 in shared memory, in rows padded by 8 elements (16
// bytes) so that the eight 16-byte rows an ldmatrix reads fall in eight
// different bank quads. They arrive by cp.async in a ring of kStages
// stages: while the warps multiply tile t, the copies of tile
// t + kStages - 1 are in flight, and one cp.async.wait_group plus one
// barrier per tile orders the two. O stays in fp32 fragments and is
// written once, after the last tile, through shared memory so that every
// lane stores 16 contiguous bytes.
//
// Rows past nq get a zero Q and are never stored. Keys past nk (RAGGED
// only) are zero-filled in shared memory and count as -inf. The first
// tile starts from m = -inf; a row max of -inf is exponentiated against
// 0 so exp(-inf - -inf) never makes a NaN.
//
// Heads wider than 128 take the sliced path at the end of the file
// (attend_sliced in bf16, attend_sliced_f32 in fp32): the output columns
// are split across units, so no thread holds more than a D = 128 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace af2tile {

constexpr float kMaskValue = -1e9f;
constexpr int kStages = 2;    // the k/v ring: one tile in flight, one in use

// What one group computes (all pointers already offset to its batch*head
// row). T is the element type of q, k, v and out.
template <typename T>
struct TileArgsT {
  const T* q;               // (nq, D)
  const T* k;               // (nk, D)
  const T* v;               // (nk, D)
  T* out;                   // (nq, D)
  const float* bias;        // (nq, nk) fp32, or null
  const uint8_t* q_mask;    // (nq,) flags, or null
  const uint8_t* k_mask;    // (nk,) flags, or null
  const int* cols;          // live key blocks of this query block (K2), or
                            // null: the key tiles are 0, BK, 2 BK, ...
  int block;                // key block size when cols is set
  int q0;                   // the group's first query row
  int nq, nk;
  int num_tiles;            // key tiles this group visits
  float scale;              // multiplies the fp32 S accumulator
};
using TileArgs = TileArgsT<__nv_bfloat16>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a . b on one m16n8k16 tile (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared memory one group needs: its Q rows (reused for the output) and
// the k/v ring.
template <int D, int WG, int BK>
__host__ __device__ constexpr int group_smem_bytes() {
  return (16 * WG + 2 * BK * kStages) * (D + 8) * 2;
}

// Named barrier of one group (id 1 + group; 0 is __syncthreads).
template <int WG>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (WG == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(group + 1), "n"(WG * 32)
                 : "memory");
  }
}

// The pieces of `attend` and of the sliced path (below): the bias and
// key flags at this thread's fragment positions of the key tile starting
// at j0 (rows i_row of the group's fragment).
template <int BK, bool RAGGED>
__device__ __forceinline__ void load_bias(const TileArgs& a,
                                          const int (&i_row)[2], int t,
                                          int j0, float (&bv)[BK / 8][4],
                                          bool (&kv)[BK / 8][2]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const int j = j0 + n * 8 + 2 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      kv[n][c] = (!RAGGED || j + c < a.nk) &&
                 (a.k_mask == nullptr || a.k_mask[j + c] != 0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float b0 = 0.f, b1 = 0.f;
      if (a.bias != nullptr && (!RAGGED || i_row[r] < a.nq)) {
        const float* bp = a.bias + (size_t)i_row[r] * a.nk + j;
        if (!RAGGED || (a.nk % 2 == 0 && j < a.nk)) {
          const float2 b = *reinterpret_cast<const float2*>(bp);
          b0 = b.x;
          b1 = b.y;
        } else {   // odd nk: the pair may straddle a row, or the end
          if (j < a.nk) b0 = bp[0];
          if (j + 1 < a.nk) b1 = bp[1];
        }
      }
      bv[n][2 * r] = b0;
      bv[n][2 * r + 1] = b1;
    }
  }
}

// One key tile after S = Q . K^T: scale, bias and masks on S, the online
// softmax update of m, l and O, then O += P . V with P from the
// accumulators as bf16 A fragments and V from the tile `vs` (BK rows of
// DV + 8 elements).
template <int DV, int BK, bool RAGGED>
__device__ __forceinline__ void softmax_pv(
    const TileArgs& a, float (&s)[BK / 8][4], const float (&bv)[BK / 8][4],
    const bool (&kv)[BK / 8][2], const bool (&q_ok)[2], int j0, int t,
    int lane, float (&m)[2], float (&l)[2], float (&o)[DV / 8][4],
    const __nv_bfloat16* vs) {
  constexpr int SD = DV + 8;
  // scale, bias, masks; the tile's row max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = e & 1;
      float x = s[n][e] * a.scale + bv[n][e];
      if (RAGGED && j0 + n * 8 + 2 * t + c >= a.nk)
        x = -INFINITY;                 // the key does not exist
      else if (!(q_ok[r] && kv[n][c]))
        x = kMaskValue;                // fill after the bias add
      s[n][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }

  // online softmax update
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    const float rescale = __expf(m[r] - m_use[r]);   // 0 while m = -inf
    m[r] = m_new;
    l[r] *= rescale;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][2 * r] *= rescale;
      o[n][2 * r + 1] *= rescale;
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[n][e] - m_use[e >> 1]);
      s[n][e] = p;
      l[e >> 1] += p;
    }
  }

  // O += P . V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DV / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, smem_addr(vs + (kk * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * SD +
                                      dp * 16 + (lane >> 4) * 8));
      mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
    }
  }
}

// Normalise the warp's O (16 rows of DV columns) and write it: the warp's
// own 16 rows of shared memory at `os` (rows of DV + 8) take the bf16
// output, then each lane stores 16 contiguous bytes to `out`, whose rows
// are `stride` elements apart; rows from row0 on, those past nq skipped.
template <int DV>
__device__ __forceinline__ void store_out(float (&o)[DV / 8][4],
                                          float (&l)[2], __nv_bfloat16* os,
                                          __nv_bfloat16* out, int stride,
                                          int row0, int nq, int lane) {
  constexpr int SD = DV + 8;
  constexpr int CH = DV / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t packed =
          pack_bf16(o[n][2 * r] * l[r], o[n][2 * r + 1] * l[r]);
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * SD + n * 8 + 2 * t) =
          packed;
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = (e % CH) * 8;
    const int i = row0 + r;
    if (i < nq)
      *reinterpret_cast<uint4*>(out + (size_t)i * stride + c) =
          *reinterpret_cast<const uint4*>(os + r * SD + c);
  }
}

// The group's part of the attention (see the file note). `smem` is the
// group's own region of group_smem_bytes<D, WG, BK>() bytes; `warp` is
// the warp's index inside the group.
template <int D, int WG, int BK, bool RAGGED>
__device__ __forceinline__ void attend(const TileArgs& a, uint8_t* smem,
                                       int group, int warp, int lane) {
  static_assert(D % 16 == 0 && BK % 16 == 0, "tile shape");
  constexpr int SD = D + 8;             // padded row, in bf16 elements
  constexpr int R = 16 * WG;
  constexpr int NT = WG * 32;           // threads of the group
  constexpr int CH = D / 8;             // 16-byte chunks per row
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + R * SD;    // stage s: k at 2s, v at 2s + 1
  const int tid = warp * 32 + lane;
  const int sub = a.cols != nullptr ? a.block / BK : 1;

  auto tile_start = [&](int it) {
    return a.cols != nullptr ? a.cols[it / sub] * a.block + (it % sub) * BK
                             : it * BK;
  };
  auto load_kv = [&](int stage, int it) {
    const int j0 = tile_start(it);
    __nv_bfloat16* ks = ring + (2 * stage) * BK * SD;
    __nv_bfloat16* vs = ks + BK * SD;
    for (int e = tid; e < BK * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 8;
      const int j = j0 + r;
      const bool ok = !RAGGED || j < a.nk;
      const size_t off = ok ? (size_t)j * D + c : 0;
      cp_async16(smem_addr(ks + r * SD + c), a.k + off, ok);
      cp_async16(smem_addr(vs + r * SD + c), a.v + off, ok);
    }
  };

  // prologue: Q, then the first kStages - 1 key tiles, one group each
  for (int e = tid; e < R * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    const int i = a.q0 + r;
    const bool ok = i < a.nq;
    cp_async16(smem_addr(qs + r * SD + c),
               a.q + (ok ? (size_t)i * D + c : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < a.num_tiles) load_kv(s, s);
    cp_async_commit();
  }

  const int g = lane >> 2;          // fragment row (and row + 8)
  const int t = lane & 3;           // fragment column pair
  const int wr = warp * 16;         // the warp's first row in the group
  const int i_row[2] = {a.q0 + wr + g, a.q0 + wr + g + 8};
  bool q_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    q_ok[r] = a.q_mask == nullptr ||
              (i_row[r] < a.nq && a.q_mask[i_row[r]] != 0);

  cp_async_wait<kStages - 1>();       // Q has landed
  group_sync<WG>(group);
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qf[ks], smem_addr(qs + (wr + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * SD +
                                  ks * 16 + (lane >> 4) * 8));

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < a.num_tiles; ++it) {
    cp_async_wait<kStages - 2>();     // tile it has landed (this thread's)
    group_sync<WG>(group);           // ... everyone's; stage it-1 is free
    const int nxt = it + kStages - 1;
    if (nxt < a.num_tiles) load_kv(nxt % kStages, nxt);
    cp_async_commit();

    const int stage = it % kStages;
    const __nv_bfloat16* ks = ring + (2 * stage) * BK * SD;
    const __nv_bfloat16* vs = ks + BK * SD;
    const int j0 = tile_start(it);

    // issued before the products so their latency hides behind them
    float bv[BK / 8][4];
    bool kv[BK / 8][2];
    load_bias<BK, RAGGED>(a, i_row, t, j0, bv, kv);

    // S = Q . K^T
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kstep = 0; kstep < D / 16; ++kstep) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(ks + (np * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * SD +
                                  kstep * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kstep], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kstep], kf[2], kf[3]);
      }
    }

    softmax_pv<D, BK, RAGGED>(a, s, bv, kv, q_ok, j0, t, lane, m, l, o, vs);
  }

  // the warp's own 16 Q rows in shared memory take the bf16 output
  store_out<D>(o, l, qs + wr * SD, a.out, D, a.q0 + wr, a.nq, lane);
}

// ---------------------------------------------------------------------------
// Wide heads: D > 128, padded by the caller to a multiple of kSlice. The
// output columns are split into slices, one per unit, so no thread holds
// more output accumulators than at D = 128 (a plain D = 256 tile would
// double them and the resident Q fragment, and spill). A unit walks the
// key tiles once; per tile it computes S = Q . K^T over the whole D in
// chunks staged through shared memory (no resident Q: each chunk of Q is
// re-read from L2), then the online softmax, then O += P . V over its own
// slice of V. The Q . K^T work is repeated for every slice: D / slice
// times in all.

constexpr int kSlice = 128;   // bf16 sliced path: slice and chunk width

// Shared memory one group of the bf16 sliced path needs: one chunk of its Q
// rows (reused for the output), one chunk of K and its slice of V.
template <int WG, int BK>
__host__ __device__ constexpr int sliced_smem_bytes() {
  return (16 * WG + 2 * BK) * (kSlice + 8) * 2;
}

// The bf16 sliced path for one group: output columns [c0, c0 + kSlice) of a
// head `d` wide (a multiple of kSlice); q, k, v and out rows are d apart.
template <int WG, int BK, bool RAGGED>
__device__ __forceinline__ void attend_sliced(const TileArgs& a, int d, int c0,
                                            uint8_t* smem, int group,
                                            int warp, int lane) {
  static_assert(BK % 16 == 0, "tile shape");
  constexpr int SD = kSlice + 8;
  constexpr int R = 16 * WG;
  constexpr int NT = WG * 32;
  constexpr int CH = kSlice / 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + R * SD;
  __nv_bfloat16* vs = ks + BK * SD;
  const int tid = warp * 32 + lane;
  const int sub = a.cols != nullptr ? a.block / BK : 1;

  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int i_row[2] = {a.q0 + wr + g, a.q0 + wr + g + 8};
  bool q_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    q_ok[r] = a.q_mask == nullptr ||
              (i_row[r] < a.nq && a.q_mask[i_row[r]] != 0);

  float o[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < a.num_tiles; ++it) {
    const int j0 = a.cols != nullptr
                       ? a.cols[it / sub] * a.block + (it % sub) * BK
                       : it * BK;
    group_sync<WG>(group);   // the previous tile's chunks and V are read
    for (int e = tid; e < BK * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 8;
      const int j = j0 + r;
      const bool ok = !RAGGED || j < a.nk;
      cp_async16(smem_addr(vs + r * SD + c),
                 a.v + (ok ? (size_t)j * d + c0 + c : 0), ok);
    }
    // S = Q . K^T, one kSlice chunk of D at a time
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int dc = 0; dc < d; dc += kSlice) {
      if (dc > 0) group_sync<WG>(group);   // the previous chunk is read
      for (int e = tid; e < R * CH; e += NT) {
        const int r = e / CH, c = (e % CH) * 8;
        const int i = a.q0 + r;
        const bool ok = i < a.nq;
        cp_async16(smem_addr(qs + r * SD + c),
                   a.q + (ok ? (size_t)i * d + dc + c : 0), ok);
      }
      for (int e = tid; e < BK * CH; e += NT) {
        const int r = e / CH, c = (e % CH) * 8;
        const int j = j0 + r;
        const bool ok = !RAGGED || j < a.nk;
        cp_async16(smem_addr(ks + r * SD + c),
                   a.k + (ok ? (size_t)j * d + dc + c : 0), ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      group_sync<WG>(group);
#pragma unroll
      for (int kstep = 0; kstep < kSlice / 16; ++kstep) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_addr(qs + (wr + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * SD +
                                  kstep * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(ks + (np * 16 + (lane & 7) +
                                          (lane >> 4) * 8) * SD +
                                    kstep * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      }
    }
    // the bias after the products: fewer registers live across them
    float bv[BK / 8][4];
    bool kv[BK / 8][2];
    load_bias<BK, RAGGED>(a, i_row, t, j0, bv, kv);
    softmax_pv<kSlice, BK, RAGGED>(a, s, bv, kv, q_ok, j0, t, lane, m, l, o,
                                   vs);
  }
  // every warp reads only its own rows of qs, so no group barrier is due
  store_out<kSlice>(o, l, qs + wr * SD, a.out + c0, d, a.q0 + wr, a.nq,
                   lane);
}

constexpr int kSliceF32 = 64;   // fp32 sliced path: slice and chunk width
constexpr int kSliceF32BK = 16; // fp32 sliced path: keys per tile

// The fp32 sliced path on the CUDA cores, for one block of BQ threads, one
// per query row from a.q0: output columns [c0, c0 + kSliceF32) of a head
// `d` wide (a multiple of kSliceF32). Per key tile S is accumulated over D
// in chunks of K staged through shared memory (q read from L1/L2), then
// one online-softmax rescale and O += P . V over the slice of V.
template <int BQ, bool RAGGED>
__device__ __forceinline__ void attend_sliced_f32(const TileArgsT<float>& a,
                                                int d, int c0) {
  constexpr int DC = kSliceF32;
  constexpr int BK = kSliceF32BK;
  __shared__ __align__(16) float ks[BK][DC];
  __shared__ __align__(16) float vs[BK][DC];
  __shared__ float bs[BQ][BK + 1];   // +1: row reads are conflict-free
  __shared__ float kms[BK];          // 1 valid, 0 masked, -1 past the end
  const int tid = threadIdx.x;
  const int i = a.q0 + tid;
  const bool q_in = i < a.nq;
  const bool q_valid =
      q_in && (a.q_mask == nullptr || a.q_mask[i] != 0);
  const float* qrow = a.q + (size_t)(q_in ? i : 0) * d;
  const int sub = a.cols != nullptr ? a.block / BK : 1;

  float o[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) o[c] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int it = 0; it < a.num_tiles; ++it) {
    const int j0 = a.cols != nullptr
                       ? a.cols[it / sub] * a.block + (it % sub) * BK
                       : it * BK;
    float s[BK];
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) s[jj] = 0.f;
    for (int dc = 0; dc < d; dc += DC) {
      __syncthreads();   // the previous chunk (or tile) is no longer read
      for (int e = tid; e < BK * DC; e += BQ) {
        const int r = e / DC, c = e % DC;
        const int j = j0 + r;
        ks[r][c] = (!RAGGED || j < a.nk) ? a.k[(size_t)j * d + dc + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DC; dd += 4) {
        const float4 qv =
            q_in ? *reinterpret_cast<const float4*>(qrow + dc + dd)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int jj = 0; jj < BK; ++jj) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][dd]);
          s[jj] = fmaf(qv.x, kk.x, s[jj]);
          s[jj] = fmaf(qv.y, kk.y, s[jj]);
          s[jj] = fmaf(qv.z, kk.z, s[jj]);
          s[jj] = fmaf(qv.w, kk.w, s[jj]);
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < BK * DC; e += BQ) {
      const int r = e / DC, c = e % DC;
      const int j = j0 + r;
      vs[r][c] = (!RAGGED || j < a.nk) ? a.v[(size_t)j * d + c0 + c] : 0.f;
    }
    if (a.bias != nullptr) {
      for (int e = tid; e < BQ * BK; e += BQ) {
        const int r = e / BK, c = e % BK;
        const int ii = a.q0 + r, j = j0 + c;
        bs[r][c] = (ii < a.nq && (!RAGGED || j < a.nk))
                       ? a.bias[(size_t)ii * a.nk + j] : 0.f;
      }
    }
    for (int c = tid; c < BK; c += BQ) {
      const int j = j0 + c;
      kms[c] = (RAGGED && j >= a.nk) ? -1.f
               : (a.k_mask == nullptr || a.k_mask[j] != 0) ? 1.f : 0.f;
    }
    __syncthreads();

    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float x = s[jj] * a.scale;
      if (a.bias != nullptr) x += bs[tid][jj];
      const float flag = kms[jj];
      if (flag < 0.f)
        x = -INFINITY;                  // the key does not exist
      else if (!(q_valid && flag > 0.f))
        x = kMaskValue;                 // fill after the bias add
      s[jj] = x;
      cmax = fmaxf(cmax, x);
    }
    if (cmax == -INFINITY) continue;    // no key of the tile exists
    const float m_new = fmaxf(m, cmax);
    const float rescale = expf(m - m_new);   // 0 while m is -inf
    l *= rescale;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] *= rescale;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < DC; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[jj][c]);
        o[c] = fmaf(p, vv.x, o[c]);
        o[c + 1] = fmaf(p, vv.y, o[c + 1]);
        o[c + 2] = fmaf(p, vv.z, o[c + 2]);
        o[c + 3] = fmaf(p, vv.w, o[c + 3]);
      }
    }
    m = m_new;
  }

  if (q_in) {
    const float inv = 1.f / l;
    float* orow = a.out + (size_t)i * d + c0;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = o[c] * inv;
  }
}

}  // namespace af2tile
