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
// live blocks are read. k_mask is (B / heads, N) bytes; a masked key's
// logit is REPLACED by -1e9 after the bias add. There is no query mask.
// `scale` multiplies the fp32 logits, never q before it is rounded. The
// softmax runs in fp32; the output is written in the input type.
//
// What bounds it on this card: at the 512-residue bucket's triangle
// shape (B=4096, N=512, D=64, bf16, 74 of 256 blocks live) the call must
// move 1076.4 MB (q, k, v, out, the live bias tiles, the key mask and the
// plan), 0.3213 ms at 3.35 TB/s, against 79.457 GFLOP of live work,
// 0.0803 ms on the bf16 tensor cores: it is bound by device-memory bytes.
//
// What the design does about it: the Pallas grid (B, nqb, T) pads every
// row to T, the widest row's live count, and idles on padded slots; here
// each (batch*head, query block) unit loops over that row's own live
// count only, reading the plan on the device. bf16 (the fold path) runs
// on the shared tensor-core tile of attention_tile.cuh: mma.sync products
// with fp32 accumulators, k and v kept bf16 in padded shared memory and
// brought in by cp.async in a two-stage ring (the next live block's copy
// overlaps this one's products), the online softmax in registers, the
// live bias tiles read straight from L2. A key tile is one live block, or
// a half (a quarter at D = 128) of a 128 block. Units are sized so that no
// block of threads is one warp: block 16 puts four query blocks of one
// warp each into a block of threads, block 32 two query blocks of two
// warps, block 64 one of four warps, and block 128 two units of four
// warps per query block. fp32 (the small parity folds) keeps the first
// design: one thread per query row with fp32 FMAs on the CUDA cores.
//
// What is left: wgmma with TMA and an mbarrier ring, persistent blocks,
// and balancing the global row (all live blocks) against the banded rows
// (three or four).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

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

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core tile). d is 16, 32, 64, 128 or a multiple of 128 (the sliced
// path). bias and k_mask may be null; cols and counts are the plan on the
// device. Returns cudaGetLastError() after the launch (0 on
// success), or -1 for a head width, block, shape or dtype the kernel does
// not take.
extern "C" int af2_block_sparse_attention(
    const void* q, const void* k, const void* v, const float* bias,
    const uint8_t* k_mask, const int* cols, const int* counts, void* out,
    int b, int n, int d, int block, int t_max, int heads, int bias_repeat,
    float scale, int dtype, void* stream) {
  if (block <= 0 || n % block != 0 || t_max < 1 || heads < 1 || b % heads)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > af2tile::kSlice) {
    if (d % af2tile::kSlice != 0 || dtype < 0 || dtype > 1) return -1;
    return (dtype == 0 ? launch_sliced_f32 : dispatch_sliced_mma)(
        q, k, v, bias, k_mask, cols, counts, out, b, n, d, block, t_max,
        heads, bias_repeat, scale, s);
  }
  if (dtype == 0)
    return launch_f32(q, k, v, bias, k_mask, cols, counts, out, b, n, d,
                      block, t_max, heads, bias_repeat, scale, s);
  if (dtype != 1) return -1;
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
