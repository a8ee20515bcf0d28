// Block-skipping sparse attention for long serving buckets, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of alphafold2_tpu/ops/block_sparse.py
// (its pallas_call is at block_sparse.py:269, launched by
// `block_sparse_attention`). Same contract:
//
//   out[i] = softmax_j(scale * q[i] . k[j] + bias[i, j],
//                      masked -> -1e9, dead block -> -inf) . v
//
// q, k, v are (B, N, D) with B = batch * fold * heads, head fastest, and
// N = block * nqb. The (nqb, nqb) block pattern arrives as a plan on the
// device: cols (nqb, T) int32, the t-th live key block of each query
// block, and counts (nqb,) int32, how many of a row's T slots are real.
// The bias is fp32 (Bb, N, N) and unrepeated: batch row i reads bias row
// (i / (bias_repeat * heads)) * heads + i % heads, and only the tiles of
// live blocks are read (layout 3: the 64-row tiles of its units, whose
// halves may lie in a dead and a live block). k_mask is (B / heads, N) bytes; a masked key's
// logit is REPLACED by -1e9 after the bias add. There is no query mask.
// `scale` multiplies the fp32 logits, never q before it is rounded. The
// softmax runs in fp32; the output is written in the input type.
//
// What bounds it on this card: at the 512-residue bucket's triangle
// shape (B=4096, N=512, D=64, bf16, the default policy: block 32, 74 of
// 256 blocks live) the call must move 1076.4 MB from device memory (q, k,
// v, out, the live bias tiles once, the key mask and the plan), 0.3213 ms
// at 3.35 TB/s, against 79.457 GFLOP of live work, 0.0803 ms on the bf16
// tensor cores: it is bound by device-memory bytes. Beside them it reads
// much more from L2: the bias is only (8, 512, 512) fp32, 8.4 MB, but is
// replayed over the 512 fold rows, so its live tiles are 4096 x 74 x 32 x
// 32 x 4 B = 1.24 GB a call, and K and V are read again by every unit
// that walks their block.
//
// Layout 3 (bf16, D <= 128, N >= 64; `kernel_layout` in
// ops/block_sparse.py picks it): the warpgroup kernel below, built from
// the pieces of attention_wgmma.cuh.
//   units    64 query rows of one batch*head row, one consumer warpgroup
//            a unit: two query blocks of 32 (four of 16, one of 64, half
//            of one of 128). A unit walks the union of its blocks' live
//            key blocks (the host's unit plan: 50 tiles a row at the
//            default policy, against 74 for each block padded to 64 rows,
//            with 1.5 times the logit slots), in key tiles of min(block,
//            32).
//   owners   each entry carries a 4-bit owner mask: warp w's 16 rows own
//            the key block. A warp that does not own a tile skips the
//            bias, the masks and the exp2; its P is 0 and its row
//            statistics and O are left as they are, so a row's first
//            owned tile may come after unowned ones with no -inf - -inf.
//   loads    one producer warp issues TMA into mbarrier rings: Q, then
//            per tile K with one 64-row bias box into a K ring of 3 or 4
//            stages, and V into a V ring; its lanes write the tile's key
//            flags beside K. The unit plan sits in shared memory, and the
//            key flags of an item's tiles are loaded an item ahead.
//   products S = Q . K^T from swizzled shared tiles (m64n16 / n32) and O
//            += P . V with P from registers and V by an MN-major
//            descriptor, the P . V of one tile overlapping the softmax of
//            the next, as in K1's layout 3.
//   schedule persistent blocks, three to an SM at the triangle, pull items
//            (unit, batch*head row) from a counter, heaviest unit first:
//            item = rank * rows + row within groups of rows whose K and V
//            fit in 8 MB, so the 16-tile units of the global rows start
//            first, the 4- and 5-tile units fill in behind them, and the
//            rows in flight keep their K and V in L2.
// Measured against what the plan first had (chip_smoke.py and PERF.md):
// the bias read as one 64-row box a tile beats a box of only the owning
// rows (one TMA request, not one or two), and a second warpgroup sharing
// each bias box over two fold rows was slower (fewer blocks an SM).
//
// Layout 1 (the older rule for bf16, and D > 128 on the sliced path):
// the shared tensor-core tile of attention_tile.cuh: mma.sync products
// with fp32 accumulators, k and v kept bf16 in padded shared memory and
// brought in by cp.async in a two-stage ring, the online softmax in
// registers, the live bias tiles read straight from L2; one unit a query
// block (block 16: four query blocks of one warp each in a block of
// threads, block 32 two of two warps, block 64 one of four, block 128
// two units of four warps). fp32 (the small parity folds) keeps the first
// design: one thread per query row with fp32 FMAs on the CUDA cores.
//
// What is left (PERF.md): the softmax and the producer's per-tile path
// hold layout 3 to about 60 % of its bound at the triangle; the bias kept
// across the fold rows that replay it, without giving up blocks an SM,
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace {

using af2tile::kMaskValue;
constexpr int kChunk = 8;   // keys per online-softmax rescale (fp32)

// BQ queries per thread block (the query block, or half of a 128 block at
// D = 128 so the static shared memory stays under 48 KB); BK keys per
// shared-memory tile.
template <int D, int BQ>
__global__ void __launch_bounds__(BQ)
block_sparse_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias,
                    const uint8_t* __restrict__ k_mask,
                    const int* __restrict__ cols,
                    const int* __restrict__ counts, float* __restrict__ out,
                    int n, int block, int t_max, int heads, int bias_repeat,
                    float scale, int nqb, int q_tiles) {
  constexpr int BK = BQ < 32 ? BQ : 32;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float bs[BQ][BK + 1];   // +1: row reads are conflict-free
  __shared__ float kms[BK];          // 1 valid, 0 masked

  const int qt = blockIdx.x % q_tiles;
  const int row = blockIdx.x / q_tiles;
  const int qb = row % nqb;
  const int bh = row / nqb;
  const int tid = threadIdx.x;
  const int q0 = qb * block + qt * BQ;
  const int qi = q0 + tid;
  const int mrow = bh / heads;
  const bool has_bias = bias != nullptr;

  const float* kb = k + (size_t)bh * n * D;
  const float* vb = v + (size_t)bh * n * D;
  const float* biasb = nullptr;
  if (has_bias) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    biasb = bias + brow * n * n;
  }

  float qr[D];
  float o[D];
  const float* qrow = q + ((size_t)bh * n + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = qrow[d] * scale;
    o[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int live = counts[qb];
  for (int t = 0; t < live; ++t) {
    const int kblock = cols[(size_t)qb * t_max + t];
    for (int j0 = kblock * block; j0 < (kblock + 1) * block; j0 += BK) {
      __syncthreads();  // the previous tile is no longer read
      for (int e = tid; e < BK * D; e += BQ) {
        const int jj = e / D;
        const int d = e % D;
        ks[jj][d] = kb[(size_t)(j0 + jj) * D + d];
        vs[jj][d] = vb[(size_t)(j0 + jj) * D + d];
      }
      if (has_bias) {
        for (int e = tid; e < BQ * BK; e += BQ) {
          const int r = e / BK;
          const int c = e % BK;
          bs[r][c] = biasb[(size_t)(q0 + r) * n + j0 + c];
        }
      }
      for (int c = tid; c < BK; c += BQ)
        kms[c] = (k_mask == nullptr || k_mask[(size_t)mrow * n + j0 + c] != 0)
                     ? 1.f : 0.f;
      __syncthreads();

#pragma unroll 1
      for (int c0 = 0; c0 < BK; c0 += kChunk) {
        float s[kChunk];
        float cmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int jj = c0 + c;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&ks[jj][d]);
            acc = fmaf(qr[d], kk.x, acc);
            acc = fmaf(qr[d + 1], kk.y, acc);
            acc = fmaf(qr[d + 2], kk.z, acc);
            acc = fmaf(qr[d + 3], kk.w, acc);
          }
          if (has_bias) acc += bs[tid][jj];
          if (kms[jj] == 0.f) acc = kMaskValue;   // fill after the bias add
          s[c] = acc;
          cmax = fmaxf(cmax, acc);
        }
        const float m_new = fmaxf(m, cmax);
        const float rescale = expf(m - m_new);    // 0 while m is -inf
        l *= rescale;
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] *= rescale;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float p = expf(s[c] - m_new);
          l += p;
          const int jj = c0 + c;
#pragma unroll
          for (int d = 0; d < D; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(&vs[jj][d]);
            o[d] = fmaf(p, vv.x, o[d]);
            o[d + 1] = fmaf(p, vv.y, o[d + 1]);
            o[d + 2] = fmaf(p, vv.z, o[d + 2]);
            o[d + 3] = fmaf(p, vv.w, o[d + 3]);
          }
        }
        m = m_new;
      }
    }
  }

  // l >= 1: every row has a live block, and its largest logit gives p = 1
  const float inv = 1.f / l;
  float* orow = out + ((size_t)bh * n + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = o[d] * inv;
}

int launch_f32(const void* q, const void* k, const void* v,
               const float* bias, const uint8_t* k_mask, const int* cols,
               const int* counts, void* out, int b, int n, int d, int block,
               int t_max, int heads, int bias_repeat, float scale,
               cudaStream_t stream) {
  const int nqb = n / block;
  // a 128 block runs as two thread blocks of 64 queries at D = 128
  const int bq = (block == 128 && d >= 128) ? 64 : block;
  const int q_tiles = block / bq;
  const long long blocks = (long long)b * nqb * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
#define AF2_F32(D, BQ)                                                      \
  block_sparse_kernel<D, BQ><<<(unsigned)blocks, BQ, 0, stream>>>(         \
      qf, kf, vf, bias, k_mask, cols, counts, of, n, block, t_max, heads,  \
      bias_repeat, scale, nqb, q_tiles)
#define AF2_F32_D(D)                                                        \
  switch (bq) {                                                             \
    case 16: AF2_F32(D, 16); break;                                         \
    case 32: AF2_F32(D, 32); break;                                         \
    case 64: AF2_F32(D, 64); break;                                         \
    case 128: AF2_F32(D, 128); break;                                       \
    default: return -1;                                                     \
  }
  switch (d) {
    case 16: AF2_F32_D(16); break;
    case 32: AF2_F32_D(32); break;
    case 64: AF2_F32_D(64); break;
    case 128:
      switch (bq) {
        case 16: AF2_F32(128, 16); break;
        case 32: AF2_F32(128, 32); break;
        case 64: AF2_F32(128, 64); break;
        default: return -1;
      }
      break;
    default: return -1;
  }
#undef AF2_F32_D
#undef AF2_F32
  return (int)cudaGetLastError();
}

// One unit's arguments: batch*head row bh, query block qb, queries from
// q0, key tiles of `tile` inside the live blocks, rows d elements apart.
template <typename T>
__device__ __forceinline__ af2tile::TileArgsT<T> unit_args(
    const T* q, const T* k, const T* v, const float* bias,
    const uint8_t* k_mask, const int* cols, const int* counts, T* out,
    int bh, int qb, int q0, int n, int d, int block, int t_max, int heads,
    int bias_repeat, float scale, int tile) {
  af2tile::TileArgsT<T> a;
  a.q = q + (size_t)bh * n * d;
  a.k = k + (size_t)bh * n * d;
  a.v = v + (size_t)bh * n * d;
  a.out = out + (size_t)bh * n * d;
  a.bias = nullptr;
  if (bias != nullptr) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    a.bias = bias + brow * n * n;
  }
  a.q_mask = nullptr;
  a.k_mask = k_mask == nullptr ? nullptr
                               : k_mask + (size_t)(bh / heads) * n;
  a.cols = cols + (size_t)qb * t_max;
  a.block = block;
  a.q0 = q0;
  a.nq = n;
  a.nk = n;
  a.num_tiles = counts[qb] * (block / tile);
  a.scale = scale;
  return a;
}

#define AF2_MMA_PARAMS                                                      \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v, const float *__restrict__ bias,  \
      const uint8_t *__restrict__ k_mask, const int *__restrict__ cols,     \
      const int *__restrict__ counts, __nv_bfloat16 *__restrict__ out,      \
      int units, int n, int block, int t_max, int heads, int bias_repeat,   \
      float scale, int nqb, int q_parts

// The bf16 kernel: groups of WG warps on the shared tensor-core tile, G
// groups (each on its own (batch*head, query block, part) unit) per block.
template <int D, int WG, int G, int BK>
__global__ void __launch_bounds__(WG * G * 32)
block_sparse_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ bias,
                        const uint8_t* __restrict__ k_mask,
                        const int* __restrict__ cols,
                        const int* __restrict__ counts,
                        __nv_bfloat16* __restrict__ out, int units, int n,
                        int block, int t_max, int heads, int bias_repeat,
                        float scale, int nqb, int q_parts) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int group = warp / WG;
  const int unit = blockIdx.x * G + group;
  if (unit >= units) return;   // groups never share a barrier
  const int qp = unit % q_parts;
  const int row = unit / q_parts;
  const int qb = row % nqb;
  const int bh = row / nqb;
  af2tile::TileArgs a;
  a.q = q + (size_t)bh * n * D;
  a.k = k + (size_t)bh * n * D;
  a.v = v + (size_t)bh * n * D;
  a.out = out + (size_t)bh * n * D;
  a.bias = nullptr;
  if (bias != nullptr) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    a.bias = bias + brow * n * n;
  }
  a.q_mask = nullptr;
  a.k_mask = k_mask == nullptr ? nullptr
                               : k_mask + (size_t)(bh / heads) * n;
  a.cols = cols + (size_t)qb * t_max;
  a.block = block;
  a.q0 = qb * block + qp * 16 * WG;
  a.nq = n;
  a.nk = n;
  a.num_tiles = counts[qb] * (block / BK);
  a.scale = scale;
  af2tile::attend<D, WG, BK, false>(
      a, smem + group * af2tile::group_smem_bytes<D, WG, BK>(),
      group, warp % WG, threadIdx.x % 32);
}

template <int D, int WG, int G, int BK>
int launch_mma(const void* q, const void* k, const void* v,
               const float* bias, const uint8_t* k_mask, const int* cols,
               const int* counts, void* out, int b, int n, int block,
               int t_max, int heads, int bias_repeat, float scale,
               cudaStream_t stream) {
  constexpr int bytes = G * af2tile::group_smem_bytes<D, WG, BK>();
  auto kernel = block_sparse_mma_kernel<D, WG, G, BK>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int nqb = n / block;
  const int q_parts = block / (16 * WG);
  const long long units = (long long)b * nqb * q_parts;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)((units + G - 1) / G), WG * G * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, k_mask, cols, counts,
      static_cast<__nv_bfloat16*>(out), (int)units, n, block, t_max, heads,
      bias_repeat, scale, nqb, q_parts);
  return (int)cudaGetLastError();
}

// The bf16 unit per block size (see the file note): query rows per unit
// 16 * WG, G units per block of threads, key tiles of BK.
template <int D>
int dispatch_mma(const void* q, const void* k, const void* v,
                 const float* bias, const uint8_t* k_mask, const int* cols,
                 const int* counts, void* out, int b, int n, int block,
                 int t_max, int heads, int bias_repeat, float scale,
                 cudaStream_t stream) {
  constexpr int BK = D >= 128 ? 32 : 64;
#define AF2_MMA(WG, G, BK_)                                                 \
  return launch_mma<D, WG, G, BK_>(q, k, v, bias, k_mask, cols, counts,    \
                                   out, b, n, block, t_max, heads,         \
                                   bias_repeat, scale, stream)
  switch (block) {
    case 16: AF2_MMA(1, 4, 16);
    case 32: AF2_MMA(2, 2, 32);
    case 64: AF2_MMA(4, 1, BK);
    case 128: AF2_MMA(4, 1, BK);
    default: return -1;
  }
#undef AF2_MMA
}

// Wide heads (D > 128, a multiple of 128; the sliced path of
// attention_tile.cuh): one unit per (batch*head, query block, part,
// output slice). fp32: 16 query rows a block of threads, one thread each,
// over slices of 64 columns; bf16: the units of dispatch_mma at D = 128
// over slices of 128 columns.
__global__ void __launch_bounds__(16)
block_sparse_sliced_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ bias,
                           const uint8_t* __restrict__ k_mask,
                           const int* __restrict__ cols,
                           const int* __restrict__ counts,
                           float* __restrict__ out, int n, int d, int block,
                           int t_max, int heads, int bias_repeat, float scale,
                           int nqb, int q_parts, int slices) {
  const int slice = blockIdx.x % slices;
  const int unit = blockIdx.x / slices;
  const int row = unit / q_parts;
  const int qb = row % nqb;
  const af2tile::TileArgsT<float> a = unit_args(
      q, k, v, bias, k_mask, cols, counts, out, row / nqb, qb,
      qb * block + (unit % q_parts) * 16, n, d, block, t_max, heads,
      bias_repeat, scale, af2tile::kSliceF32BK);
  af2tile::attend_sliced_f32<16, false>(a, d, slice * af2tile::kSliceF32);
}

template <int WG, int G, int BK>
__global__ void __launch_bounds__(WG * G * 32)
block_sparse_sliced_mma_kernel(AF2_MMA_PARAMS, int d, int slices) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int group = warp / WG;
  const int unit = blockIdx.x * G + group;
  if (unit >= units) return;   // groups never share a barrier
  const int slice = unit % slices;
  const int part = unit / slices;
  const int row = part / q_parts;
  const int qb = row % nqb;
  const af2tile::TileArgs a = unit_args(
      q, k, v, bias, k_mask, cols, counts, out, row / nqb, qb,
      qb * block + (part % q_parts) * 16 * WG, n, d, block, t_max, heads,
      bias_repeat, scale, BK);
  af2tile::attend_sliced<WG, BK, false>(
      a, d, slice * af2tile::kSlice,
      smem + group * af2tile::sliced_smem_bytes<WG, BK>(), group, warp % WG,
      threadIdx.x % 32);
}

int launch_sliced_f32(const void* q, const void* k, const void* v,
                      const float* bias, const uint8_t* k_mask,
                      const int* cols, const int* counts, void* out, int b,
                      int n, int d, int block, int t_max, int heads,
                      int bias_repeat, float scale, cudaStream_t stream) {
  const int nqb = n / block;
  const int q_parts = block / 16;
  const int slices = d / af2tile::kSliceF32;
  const long long blocks = (long long)b * nqb * q_parts * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  block_sparse_sliced_kernel<<<(unsigned)blocks, 16, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, k_mask, cols, counts,
      static_cast<float*>(out), n, d, block, t_max, heads, bias_repeat,
      scale, nqb, q_parts, slices);
  return (int)cudaGetLastError();
}

template <int WG, int G, int BK>
int launch_sliced_mma(const void* q, const void* k, const void* v,
                      const float* bias, const uint8_t* k_mask,
                      const int* cols, const int* counts, void* out, int b,
                      int n, int d, int block, int t_max, int heads,
                      int bias_repeat, float scale, cudaStream_t stream) {
  constexpr int bytes = G * af2tile::sliced_smem_bytes<WG, BK>();
  auto kernel = block_sparse_sliced_mma_kernel<WG, G, BK>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int nqb = n / block;
  const int q_parts = block / (16 * WG);
  const int slices = d / af2tile::kSlice;
  const long long units = (long long)b * nqb * q_parts * slices;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)((units + G - 1) / G), WG * G * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, k_mask, cols, counts,
      static_cast<__nv_bfloat16*>(out), (int)units, n, block, t_max, heads,
      bias_repeat, scale, nqb, q_parts, d, slices);
  return (int)cudaGetLastError();
}

int dispatch_sliced_mma(const void* q, const void* k, const void* v,
                        const float* bias, const uint8_t* k_mask,
                        const int* cols, const int* counts, void* out, int b,
                        int n, int d, int block, int t_max, int heads,
                        int bias_repeat, float scale, cudaStream_t stream) {
#define AF2_SLICED(WG, G, BK)                                               \
  return launch_sliced_mma<WG, G, BK>(q, k, v, bias, k_mask, cols, counts, \
                                      out, b, n, d, block, t_max, heads,   \
                                      bias_repeat, scale, stream)
  switch (block) {
    case 16: AF2_SLICED(1, 4, 16);
    case 32: AF2_SLICED(2, 2, 32);
    case 64: AF2_SLICED(4, 1, 32);
    case 128: AF2_SLICED(4, 1, 32);
    default: return -1;
  }
#undef AF2_SLICED
}

// ---- layout 3: the warpgroup kernel ---------------------------------------
// One block of threads = one consumer warpgroup (warps 0-3, 64 query rows,
// warp w owning rows 16w..16w+15) and one producer warp (warp 4); see the
// file note. The unit plan (BlockPlan.unit_*): per unit the union of its
// query blocks' live key blocks, each with an owner mask (bit w: warp w's
// query block has that key block live), walked in key tiles of BK =
// min(block, 32) keys.

constexpr int kUnitRows = af2wg::kRows;           // query rows a unit
constexpr int kWgThreads = 128 + 32;              // + the producer warp
// the items of about this many bytes of K and V run together (see
// SparseParams::group), so a batch*head row's K and V stay in L2 while
// its units are walked
constexpr long long kGroupBytes = 8LL << 20;
// the most shared memory a launch's unit plan may take (ops/block_sparse.py
// keeps larger plans on the mma.sync layout)
constexpr int kPlanBytes = 32 * 1024;

template <int D, int BK, int BIAS>
struct SparseConfig {
  static constexpr int DC = D < 64 ? D : 64;
  static constexpr int SW = DC * 2;
  static constexpr int NCB = D / DC;
  static constexpr int BSW = BK * 4;        // a bias row: 64 or 128 bytes
  static constexpr int Q_BYTES = kUnitRows * D * 2;
  static constexpr int QCB = kUnitRows * SW;      // column block stride
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BIAS_BYTES = BIAS ? kUnitRows * BSW : 0;
  // a K stage: the bias tile (one box of the unit's 64 rows, swizzled),
  // then K; 1024-byte aligned for the 128-byte swizzle
  static constexpr int KSTAGE_BYTES = (BIAS_BYTES + KV_BYTES + 1023) & ~1023;
  // rings of 3 stages where a stage is large, so that three blocks of
  // threads share an SM at the 512 triangle's <64, 32, 1>
  static constexpr int KSTAGES = KSTAGE_BYTES > 8192 ? 3 : 4;
  static constexpr int VSTAGES = KSTAGES;
  static constexpr int O_OFF = 2 * Q_BYTES;       // after two Q buffers
  static constexpr int KRING_OFF = (3 * Q_BYTES + 1023) & ~1023;
  static constexpr int VRING_OFF = KRING_OFF + KSTAGES * KSTAGE_BYTES;
  static constexpr int FLAG_OFF = VRING_OFF + VSTAGES * KV_BYTES;
  // per K stage: all keys unmasked, owner mask; per Q buffer: the item
  static constexpr int TILE_OFF = FLAG_OFF + KSTAGES * BK * 4;
  static constexpr int BAR_OFF = TILE_OFF + ((2 * KSTAGES + 2) * 4 + 7) / 8 * 8;
  // then the unit plan, copied from the device at the start (its size
  // is the launch's)
  static constexpr int PLAN_OFF =
      BAR_OFF + (2 * KSTAGES + 2 * VSTAGES + 4) * 8;
  // + 1024: the base is aligned up to the 1024-byte swizzle pattern
  static constexpr int SMEM = PLAN_OFF + 1024;
  static_assert(D % 16 == 0 && D <= 128 && (BK == 16 || BK == 32), "shape");
  static_assert(SMEM + kPlanBytes <= 232448, "shared memory");
};

struct SparseParams {
  const uint8_t* k_mask;      // (B / heads, N) flags, or null; 16-byte
                              // aligned
  const int* unit_cols;       // (units, unit_t): live key blocks
  const int* unit_owners;     // (units, unit_t): owner masks
  const int* unit_counts;     // (units,)
  const int* unit_order;      // (units,): heaviest first
  int* counter;               // the next item (zeroed before the launch)
  int n, heads, bias_repeat, block, unit_t, units, b, items;
  int group;                  // batch*head rows an item group spans
  float scale;
};

// The unit plan in shared memory: per unit its entries (the key block in
// the low 16 bits, the owner mask above), then the counts, then the order.
struct SmemPlan {
  const int* entries;
  const int* counts;
  const int* order;
  int t;
};

// Item i -> (batch*head row, unit). Items run in groups of `group` rows;
// inside a group the units go heaviest first, each over every row of the
// group, so the heavy units start first and the light ones fill in
// behind them, while the rows in flight keep their K and V in L2.
__device__ __forceinline__ void decode_item(const SparseParams& p,
                                            const SmemPlan& sp, int item,
                                            int& bh, int& unit) {
  const int span = p.group * p.units;
  const int grp = item / span;
  const int r = item - grp * span;
  const int g0 = grp * p.group;
  const int rows = min(p.group, p.b - g0);
  bh = g0 + r % rows;
  unit = sp.order[r / rows];
}

// The key flags of BK keys at `row` (16-byte aligned) as raw bytes, and
// as a bit a key (set: valid), lanes' bits past BK set.
template <int BK>
struct KeyBytes {
  uint4 raw[BK / 16];
  __device__ __forceinline__ void all_valid() {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) raw[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  __device__ __forceinline__ void load(const uint8_t* row) {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(row)[i];
  }
  __device__ __forceinline__ uint32_t bits() const {
    uint32_t out = BK < 32 ? ~0u << (BK % 32) : 0u;
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
      for (int c = 0; c < 16; ++c)
        out |= (uint32_t)(((w[c / 4] >> (8 * (c % 4))) & 0xffu) != 0)
               << (16 * i + c);
    }
    return out;
  }
};

template <int D, int BK, int BIAS>
__device__ __forceinline__ void attend_sparse(const af2wg::Maps& maps,
                                              const SparseParams& p) {
  using namespace af2wg;
  using C = SparseConfig<D, BK, BIAS>;
  constexpr int SW = C::SW, DC = C::DC;
  constexpr int KSTAGES = C::KSTAGES, VSTAGES = C::VSTAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* os = smem + C::O_OFF;
  uint8_t* kring = smem + C::KRING_OFF;
  uint8_t* vring = smem + C::VRING_OFF;
  float* flags = reinterpret_cast<float*>(smem + C::FLAG_OFF);
  int* tile_ok = reinterpret_cast<int*>(smem + C::TILE_OFF);
  int* tile_own = tile_ok + KSTAGES;
  int* item_of = tile_own + KSTAGES;         // one per Q buffer
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* k_empty = k_full + KSTAGES;
  uint64_t* v_full = k_empty + KSTAGES;
  uint64_t* v_empty = v_full + VSTAGES;
  uint64_t* q_full = v_empty + VSTAGES;      // two, one per Q buffer
  uint64_t* q_empty = q_full + 2;
  int* plan = reinterpret_cast<int*>(smem + C::PLAN_OFF);

  if (threadIdx.x == 0) {
    for (int s = 0; s < KSTAGES; ++s) {
      mbar_init(&k_full[s], 32);             // the producer warp's lanes
      mbar_init(&k_empty[s], 4);             // every consumer warp
    }
    for (int s = 0; s < VSTAGES; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 1);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nent = p.units * p.unit_t;
  for (int i = threadIdx.x; i < nent; i += blockDim.x)
    plan[i] = p.unit_cols[i] | (p.unit_owners[i] << 16);
  for (int i = threadIdx.x; i < p.units; i += blockDim.x) {
    plan[nent + i] = p.unit_counts[i];
    plan[nent + p.units + i] = p.unit_order[i];
  }
  __syncthreads();
  const SmemPlan sp{plan, plan + nent, plan + nent + p.units, p.unit_t};
  const int sub = p.block / BK;              // key tiles a live key block
  // the role, warp-uniform to the compiler (a shuffle's result is): a
  // wgmma in a path it must treat as divergent is serialised
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (role == 1) {
    // ---- the producer warp ----
    const int lane = threadIdx.x % 32;
    // the key flags of tile `first` + lane of `item`'s unit, loaded now
    // and read later (the latency hides under the tiles in between)
    auto load_keys = [&](KeyBytes<BK>& kb, int item, int first) {
      kb.all_valid();
      if (p.k_mask == nullptr || item >= p.items) return;
      int bh, unit;
      decode_item(p, sp, item, bh, unit);
      const int ti = first + lane;
      if (ti >= sp.counts[unit] * sub) return;
      const int col = sp.entries[unit * sp.t + ti / sub] & 0xffff;
      kb.load(p.k_mask + (size_t)(bh / p.heads) * p.n + col * p.block +
              (ti % sub) * BK);
    };
    Ring kr, vr;
    int item = blockIdx.x;
    int next = 0;                            // lane 0: the item after it
    if (lane == 0) next = gridDim.x + atomicAdd(p.counter, 1);
    KeyBytes<BK> ahead;                      // the next item's first keys
    load_keys(ahead, item, 0);
    for (int n = 0;; ++n) {
      const int qb = n & 1;
      // Q buffer n % 2 (and its item slot), free once item n - 2 has read
      // it; an item past the end tells the consumers to stop
      if (lane == 0) {
        mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        item_of[qb] = item;
      }
      if (item >= p.items) {
        if (lane == 0) mbar_arrive(&q_full[qb]);
        return;
      }
      int bh, unit;
      decode_item(p, sp, item, bh, unit);
      const int q0 = unit * kUnitRows;
      const int brow = (bh / (p.bias_repeat * p.heads)) * p.heads +
                       bh % p.heads;
      if (lane == 0) {
        mbar_arrive_tx(&q_full[qb], C::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load(qs + qb * C::Q_BYTES + cb * C::QCB, &maps.q, &q_full[qb],
                   cb * DC, q0, bh);
      }
      const int count = sp.counts[unit];
      const int* entries = sp.entries + unit * sp.t;
      // this item's first 32 tiles' key flags (loaded an item ago), then
      // the next item's, and the item after that
      uint32_t keys = ahead.bits();
      const int following = __shfl_sync(0xffffffffu, next, 0);
      if (lane == 0) next = gridDim.x + atomicAdd(p.counter, 1);
      load_keys(ahead, following, 0);
      int i = 0;                             // the item's tiles so far
      for (int e = 0; e < count; ++e) {
        const int entry = entries[e];
        for (int t = 0; t < sub; ++t, ++i) {
          const int j0 = (entry & 0xffff) * p.block + t * BK;
          if ((i & 31) == 0 && i > 0) {
            // tiles past the first 32 (long units): 32 more at once
            KeyBytes<BK> more;
            load_keys(more, item, i);
            keys = more.bits();
          }
          const uint32_t tile_keys = __shfl_sync(0xffffffffu, keys, i & 31);
          mbar_wait(&k_empty[kr.stage], kr.phase ^ 1);
          // the flags are read only for a tile with a masked key
          if (lane < BK && tile_keys != 0xffffffffu)
            flags[kr.stage * BK + lane] = (tile_keys >> lane) & 1 ? 1.f : 0.f;
          if (lane == 0) {
            tile_ok[kr.stage] = tile_keys == 0xffffffffu;
            tile_own[kr.stage] = entry >> 16;
            // K and the unit's 64-row bias box (one TMA request; the rows
            // of warps that do not own the tile are not read), then V
            uint8_t* st = kring + kr.stage * C::KSTAGE_BYTES;
            mbar_arrive_tx(&k_full[kr.stage], C::KV_BYTES + C::BIAS_BYTES);
#pragma unroll
            for (int cb = 0; cb < C::NCB; ++cb)
              tma_load(st + C::BIAS_BYTES + cb * BK * SW, &maps.k,
                       &k_full[kr.stage], cb * DC, j0, bh);
            if constexpr (BIAS != 0)
              tma_load(st, &maps.bias, &k_full[kr.stage], j0, q0, brow);
            mbar_wait(&v_empty[vr.stage], vr.phase ^ 1);
            mbar_arrive_tx(&v_full[vr.stage], C::KV_BYTES);
#pragma unroll
            for (int cb = 0; cb < C::NCB; ++cb)
              tma_load(vring + vr.stage * C::KV_BYTES + cb * BK * SW,
                       &maps.v, &v_full[vr.stage], cb * DC, j0, bh);
          } else {
            mbar_arrive(&k_full[kr.stage]);
          }
          kr.advance<KSTAGES>();
          vr.advance<VSTAGES>();
        }
      }
      item = following;
    }
  }

  // ---- the consumer warpgroup ----
  // As K1's layout 3 (attention_wgmma.cuh): per key tile t, S_t = Q . K_t^T
  // and the delayed O += P_{t-1} . V_{t-1} as two commit groups, the
  // softmax of S_t while P_{t-1} . V_{t-1} runs. A warp whose rows do not
  // own tile t skips the bias, the masks and the exp2: its P_t is 0 and
  // its O and row statistics are left as they are.
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;            // and row0 + 8
  const bool q_ok[2] = {true, true};         // no query mask
  auto release = [&](uint64_t* bar) {
    if (wtid == 0) mbar_arrive(bar);
  };
  auto release_warp = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  Ring kr, vr;
  for (int n = 0;; ++n) {
    const int qb = n & 1;
    mbar_wait(&q_full[qb], (n >> 1) & 1);
    const int item = item_of[qb];
    if (item >= p.items) break;
    int bh, unit;
    decode_item(p, sp, item, bh, unit);
    const int q0 = unit * kUnitRows;
    const int ntiles = sp.counts[unit] * sub;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float s[BK / 2];
    float scale[2];
    uint32_t pa0[BK / 16][4], pa1[BK / 16][4];

    const uint32_t q_addr = smem_u32(qs) + qb * C::Q_BYTES;
    auto issue_s = [&](int stg) {
      const uint32_t k_addr =
          smem_u32(kring + stg * C::KSTAGE_BYTES + C::BIAS_BYTES);
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
      if (((tile_own[stg] >> warp) & 1) == 0) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
        scale[0] = scale[1] = 1.f;
        return;
      }
      const uint8_t* bias_tile = kring + stg * C::KSTAGE_BYTES;
      float mx[2];
      if (tile_ok[stg])
        tile_logits<BK, BIAS, true, kUnitRows, BK, true>(
            s, bias_tile, flags + stg * BK, q_ok, row0, t4, mx, p.scale);
      else
        tile_logits<BK, BIAS, false, kUnitRows, BK, true>(
            s, bias_tile, flags + stg * BK, q_ok, row0, t4, mx, p.scale);
      // an owned tile holds only live keys, so the new max is finite and
      // exp2(-inf) = 0 rescales the row's first owned tile
      float mul[2], add[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        scale[r] = exp2_approx((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= scale[r];
        // a row whose max is the mask value holds only -1e9 so far, and
        // x + 1e9 is exactly 0 (p = 1): it averages over its live keys
        const bool masked = m_new == af2wg::kMaskValue;
        mul[r] = masked ? 1.f : kLog2e;
        add[r] = masked ? -af2wg::kMaskValue : -m_new * kLog2e;
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
    auto scores = [&](int it, uint32_t (&pa)[BK / 16][4]) {
      if (it == ntiles - 1) release(&q_empty[qb]);   // Q is read
      softmax(kr.stage, pa);
      release_warp(&k_empty[kr.stage]);
      kr.advance<KSTAGES>();
    };
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

    // O / l as bf16 into the swizzled O tile, then one TMA store; rows
    // past N (a unit of blocks 16 or 32 at the end of the row) own no
    // tile and are clipped by the tensor map
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = __frcp_rn(l[r]);
    }
    if (wtid == 0) bulk_wait_read();   // the last store has read it
    named_sync(1, 128);
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
    named_sync(1, 128);
    if (wtid == 0) {
#pragma unroll
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_store(&maps.out, os + cb * C::QCB, cb * DC, q0, bh);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait();
}

template <int D, int BK, int BIAS>
__global__ void __launch_bounds__(kWgThreads, 3)
block_sparse_wgmma_kernel(const __grid_constant__ af2wg::Maps maps,
                          const SparseParams p) {
  attend_sparse<D, BK, BIAS>(maps, p);
}

constexpr int kMaxDevices = 64;
constexpr int kTensorMapRefused = -2;

// resident blocks of the instance on device `dev` (SMs x blocks an SM)
// at `smem` bytes of dynamic shared memory, with its limit raised there
// once per device and instance; the last answer is kept
template <int D, int BK, int BIAS>
int wgmma_slots(int dev, int smem) {
  static int raised[kMaxDevices], last_smem[kMaxDevices], slots[kMaxDevices];
  auto kernel = block_sparse_wgmma_kernel<D, BK, BIAS>;
  cudaError_t e;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SparseConfig<D, BK, BIAS>::SMEM + kPlanBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return -(int)e;
    raised[dev] = 1;
  }
  if (last_smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWgThreads, smem);
    if (e != cudaSuccess) return -(int)e;
    slots[dev] = sms * (per_sm > 0 ? per_sm : 1);
    last_smem[dev] = smem;
  }
  return slots[dev];
}

// The warpgroup layout's plan on the device (BlockPlan.unit_*) and the
// launch's item counter.
struct UnitPlan {
  const int* cols;
  const int* owners;
  const int* counts;
  const int* order;
  int units, t;
  int* counter;
};

template <int D, int BK, int BIAS>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* bias, const uint8_t* k_mask,
                 const UnitPlan& plan, void* out, int b, int n, int block,
                 int heads, int bias_repeat, float scale,
                 cudaStream_t stream) {
  using C = SparseConfig<D, BK, BIAS>;
  const int plan_bytes = 4 * plan.units * (plan.t + 2);
  if (plan_bytes > kPlanBytes) return -1;
  const int smem = C::SMEM + plan_bytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int slots = wgmma_slots<D, BK, BIAS>(dev, smem);
  if (slots <= 0) return slots == 0 ? (int)cudaErrorInvalidDevice : -slots;
  const long long items = (long long)b * plan.units;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  af2wg::Maps maps;
  constexpr CUtensorMapSwizzle sw = af2wg::swizzle_mode<C::SW>();
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = af2wg::encode_3d(&maps.q, q, bf16, 2, b, n, D, kUnitRows, C::DC,
                             sw) &&
            af2wg::encode_3d(&maps.k, k, bf16, 2, b, n, D, BK, C::DC, sw) &&
            af2wg::encode_3d(&maps.v, v, bf16, 2, b, n, D, BK, C::DC, sw) &&
            af2wg::encode_3d(&maps.out, out, bf16, 2, b, n, D, kUnitRows,
                             C::DC, sw);
  if (ok && BIAS)
    ok = af2wg::encode_3d(&maps.bias, bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          4, b / bias_repeat, n, n,
                          kUnitRows, BK,
                          af2wg::swizzle_mode<C::BSW>());
  if (!ok) return kTensorMapRefused;
  long long group = kGroupBytes / (4LL * n * D);
  group = group < 1 ? 1 : group > b ? b : group;
  const SparseParams p{k_mask,     plan.cols,  plan.owners, plan.counts,
                       plan.order, plan.counter, n,         heads,
                       bias_repeat, block,     plan.t,      plan.units,
                       b,          (int)items,  (int)group,  scale};
  e = cudaMemsetAsync(plan.counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(items < slots ? items : slots);
  block_sparse_wgmma_kernel<D, BK, BIAS>
      <<<grid, kWgThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_wgmma(const void* q, const void* k, const void* v,
                   const float* bias, const uint8_t* k_mask,
                   const UnitPlan& plan, void* out, int b, int n, int block,
                   int heads, int bias_repeat, float scale,
                   cudaStream_t stream) {
#define AF2_WG(BK)                                                          \
  return bias != nullptr                                                    \
             ? launch_wgmma<D, BK, 1>(q, k, v, bias, k_mask, plan, out, b, \
                                      n, block, heads, bias_repeat, scale, \
                                      stream)                              \
             : launch_wgmma<D, BK, 0>(q, k, v, bias, k_mask, plan, out, b, \
                                      n, block, heads, bias_repeat, scale, \
                                      stream)
  switch (block) {
    case 16: AF2_WG(16);
    case 32:
    case 64:
    case 128: AF2_WG(32);
    default: return -1;
  }
#undef AF2_WG
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernels). layout: 0 takes the older rule (the CUDA-core
// kernel for fp32, the mma.sync tile of attention_tile.cuh for bf16, the
// sliced path for d > 128); 1 is that bf16 tile; 3 the warpgroup kernel
// (bf16, d <= 128, block 16, 32, 64 or 128), which reads the unit plan
// (unit_cols and unit_owners (units, unit_t), unit_counts and unit_order
// (units,)) and a device int it zeroes and counts items with. The Python
// wrapper chooses (`kernel_layout` in ops/block_sparse.py) and passes its
// choice. d is 16, 32, 64, 128 or a multiple of 128 (the sliced path).
// bias and k_mask may be null; cols and counts are the plan on the device.
// Returns cudaGetLastError() after the launch (0 on success), -1 for a
// head width, block, shape, dtype or layout the kernels do not take, -2
// when cuTensorMapEncodeTiled refuses a tensor map of layout 3 (whose
// k_mask must be 16-byte aligned).
extern "C" int af2_block_sparse_attention(
    const void* q, const void* k, const void* v, const float* bias,
    const uint8_t* k_mask, const int* cols, const int* counts, void* out,
    int b, int n, int d, int block, int t_max, int heads, int bias_repeat,
    float scale, int dtype, int layout, const int* unit_cols,
    const int* unit_owners, const int* unit_counts, const int* unit_order,
    int units, int unit_t, int* counter, void* stream) {
  if (block <= 0 || n % block != 0 || t_max < 1 || heads < 1 || b % heads)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || (dtype == 0 && layout != 0)) return -1;
  if (layout == 3) {
    if (d > af2tile::kSlice || unit_cols == nullptr ||
        unit_owners == nullptr || unit_counts == nullptr ||
        unit_order == nullptr || counter == nullptr || units < 1 ||
        unit_t < 1 || units * kUnitRows < n ||
        (reinterpret_cast<uintptr_t>(k_mask) & 15) != 0)
      return -1;
    const UnitPlan plan{unit_cols, unit_owners, unit_counts, unit_order,
                        units,     unit_t,      counter};
#define AF2_WG_D(D)                                                         \
  return dispatch_wgmma<D>(q, k, v, bias, k_mask, plan, out, b, n, block,  \
                           heads, bias_repeat, scale, s)
    switch (d) {
      case 16: AF2_WG_D(16);
      case 32: AF2_WG_D(32);
      case 64: AF2_WG_D(64);
      case 128: AF2_WG_D(128);
      default: return -1;
    }
#undef AF2_WG_D
  }
  if (layout != 0 && layout != 1) return -1;
  if (d > af2tile::kSlice) {
    if (d % af2tile::kSlice != 0) return -1;
    return (dtype == 0 ? launch_sliced_f32 : dispatch_sliced_mma)(
        q, k, v, bias, k_mask, cols, counts, out, b, n, d, block, t_max,
        heads, bias_repeat, scale, s);
  }
  if (dtype == 0)
    return launch_f32(q, k, v, bias, k_mask, cols, counts, out, b, n, d,
                      block, t_max, heads, bias_repeat, scale, s);
#define AF2_D(D)                                                            \
  return dispatch_mma<D>(q, k, v, bias, k_mask, cols, counts, out, b, n,   \
                         block, t_max, heads, bias_repeat, scale, s)
  switch (d) {
    case 16: AF2_D(16);
    case 32: AF2_D(32);
    case 64: AF2_D(64);
    case 128: AF2_D(128);
    default: return -1;
  }
#undef AF2_D
}
