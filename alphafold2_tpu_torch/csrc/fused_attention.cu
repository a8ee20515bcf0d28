// Fused biased attention for the Evoformer trunk, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` of alphafold2_tpu/ops/attention.py
// (its pallas_call is at attention.py:170, launched by
// `_fused_attention_pallas`). Same contract:
//
//   out[i] = softmax_j(q[i] . k[j] + bias[i, j], masked -> -1e9) . v
//
// q, k, v are (B, N, D) with B = batch * fold * heads, head fastest. q
// arrives pre-scaled (the model scales it once in project_qkv), so the
// kernel applies no scale. The bias is fp32 (Bb, Nq, Nk) and unrepeated:
// query row block i reads bias row (i / (bias_repeat * heads)) * heads +
// i % heads. q_mask / k_mask are (B / heads, N) bytes; the pair (i, j) is
// valid when both are set. The bias is added first and masked logits are
// then REPLACED by -1e9 (not -inf), so a fully masked query row averages
// over every key, exactly as the plain version does. Keys past Nk are
// -inf. The softmax runs in fp32; the output is written in the input type.
//
// What bounds it on this card (bf16, D = 64, heads 8, the H100's 3.35
// TB/s and 989 dense bf16 TFLOP/s; chip_smoke.py prints each shape's
// bound, PERF.md keeps them). The triangle attentions (B = 2048 at N =
// 256; the template stack's B = 8192; B = 3072 at 384 and 4096 at 512)
// and the extra-MSA row attention (B = 8192, N = 256) are bound by
// device-memory bytes: the 256 triangle moves 270.7 MB (0.0808 ms)
// against 34.4 GFLOP (0.0347 ms). The extra-MSA column attention (B =
// 2048, N = 1024, no bias) is bound by operations: 550 GFLOP (0.556 ms)
// against 1.07 GB (0.32 ms); beside its products, its softmax takes one
// exp2 a logit on the SM's 16-a-clock MUFU, as long as the products at
// this head width.
//
// Layout 3 (bf16, Nq >= 64): the warpgroup kernel of attention_wgmma.cuh.
// One producer warp issues TMA loads of Q and, per key tile, of K with
// the fp32 bias tile of the same (rows, keys) and of V, into two
// mbarrier rings (128-byte swizzle; 3-D tensor maps, so rows and keys past
// N are zero-filled per batch*head row). The bias reaches the softmax
// from shared memory, prefetched with its tile, not from L2 in the
// softmax's critical path. Two consumer warpgroups of 64 query rows run
// S = Q . K^T and O += P . V on wgmma (P in registers as the A operand, V
// through a transposed descriptor), the P . V of one tile overlapping the
// softmax of the next. One persistent block per SM walks the (batch*head,
// 128 queries) units; Q is double-buffered so the next unit's loads run
// under this one's last tiles, and O leaves through shared memory by one
// TMA store per warpgroup.
//
// Layouts 1 and 2 (the mma.sync tile of attention_tile.cuh) keep the
// shapes layout 3 does not take, as ops.attention.kernel_layout routes
// them: Nq <= 16 (layout 2: the MSA column attention at N = 5, the
// template pointwise attention's single query, one-row MSA columns), where
// a 64-row warpgroup tile would be nearly all padding; 16 < Nq < 64
// (layout 1), for the same reason; Nk not a multiple of 4 under a bias
// (layout 1), since a TMA row stride must be a multiple of 16 bytes; and
// D > 128 (the sliced path, layouts 1 and 2), whose accumulators would not
// fit a warpgroup's registers. Layout 1 is eight warps on 128 queries
// over key tiles of 64 (four on 64 at D = 128), k and v in a two-stage
// cp.async ring, the bias read from L2; layout 2 one warp per batch*head
// row, four rows to a block. fp32 (the small parity folds) keeps the first
// design: one thread per query row, fp32 FMAs on the CUDA cores, keys
// streamed through shared memory in tiles of 32, online softmax rescaled
// once per 8 keys; no TF32.
//
// What is left (PERF.md): layout 3 reaches about half of its bound at the
// N = 256 shapes, a quarter to a third at 384, 512 and the extra-MSA
// column. The SM's shared-memory port is the limit at the triangles: each
// key tile brings K, V and a bias tile in by TMA, then the products read
// Q, K and V and the softmax reads the bias, ~128 KB through 128 bytes a
// clock; the bias alone is half of it, and every (row, key) reads 4
// bytes of it. At the extra-MSA column it is the softmax's exp2 on the
// MUFU. Q kept in registers for S, the bias kept across the fold rows
// that replay it, and exp2 partly on the FMA pipe are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace {

using af2tile::kMaskValue;
constexpr int kBK = 32;     // keys per shared-memory tile (fp32 kernel)
constexpr int kChunk = 8;   // keys per online-softmax rescale (fp32)

// The fp32 kernel: one thread per query row.
template <int D, int BQ>
__global__ void __launch_bounds__(BQ)
fused_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const uint8_t* __restrict__ q_mask,
                       const uint8_t* __restrict__ k_mask,
                       float* __restrict__ out, int nq, int nk, int heads,
                       int bias_repeat, int q_tiles) {
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ float bs[BQ][kBK + 1];   // +1: row reads are conflict-free
  __shared__ float kms[kBK];          // 1 valid, 0 masked, -1 past the end

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool q_in = qi < nq;
  const int mrow = bh / heads;
  const bool has_bias = bias != nullptr;

  const float* qb = q + (size_t)bh * nq * D;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;
  const float* biasb = nullptr;
  if (has_bias) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    biasb = bias + brow * nq * nk;
  }

  float qr[D];
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q_in ? qb[(size_t)qi * D + d] : 0.f;
    o[d] = 0.f;
  }
  const bool q_valid =
      q_in && (q_mask == nullptr || q_mask[(size_t)mrow * nq + qi] != 0);
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < nk; j0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * D; e += BQ) {
      const int jj = e / D;
      const int d = e % D;
      const int j = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        kx = kb[(size_t)j * D + d];
        vx = vb[(size_t)j * D + d];
      }
      ks[jj][d] = kx;
      vs[jj][d] = vx;
    }
    if (has_bias) {
      for (int e = tid; e < BQ * kBK; e += BQ) {
        const int r = e / kBK;
        const int c = e % kBK;
        const int i = q0 + r;
        const int j = j0 + c;
        bs[r][c] = (i < nq && j < nk) ? biasb[(size_t)i * nk + j] : 0.f;
      }
    }
    for (int c = tid; c < kBK; c += BQ) {
      const int j = j0 + c;
      float flag = -1.f;
      if (j < nk)
        flag = (k_mask == nullptr || k_mask[(size_t)mrow * nk + j] != 0)
                   ? 1.f : 0.f;
      kms[c] = flag;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += kChunk) {
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
        const float flag = kms[jj];
        if (flag < 0.f)
          acc = -INFINITY;                  // key does not exist
        else if (!(q_valid && flag > 0.f))
          acc = kMaskValue;                 // fill after the bias add
        s[c] = acc;
        cmax = fmaxf(cmax, acc);
      }
      if (cmax == -INFINITY) continue;      // the chunk lies past nk
      const float m_new = fmaxf(m, cmax);
      const float rescale = expf(m - m_new);  // 0 while m is -inf
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

  if (q_in) {
    const float inv = 1.f / l;
    float* ob = out + ((size_t)bh * nq + qi) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[d] = o[d] * inv;
  }
}


int launch_f32(const void* q, const void* k, const void* v,
               const float* bias, const uint8_t* q_mask,
               const uint8_t* k_mask, void* out, int b, int nq, int nk,
               int d, int heads, int bias_repeat, cudaStream_t stream) {
  // short query axes (the MSA column attention has N = msa depth) take
  // one-warp blocks; D = 128 takes 64 queries so the static shared memory
  // stays under 48 KB
  const int bq = nq <= 32 ? 32 : (d >= 128 ? 64 : 128);
  const int q_tiles = (nq + bq - 1) / bq;
  const long long blocks = (long long)b * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
#define AF2_F32(D, BQ)                                                      \
  fused_attention_kernel<D, BQ><<<(unsigned)blocks, BQ, 0, stream>>>(      \
      qf, kf, vf, bias, q_mask, k_mask, of, nq, nk, heads, bias_repeat,    \
      q_tiles)
#define AF2_F32_D(D)                                                        \
  if (bq == 32) AF2_F32(D, 32);                                             \
  else AF2_F32(D, 128)
  switch (d) {
    case 16: AF2_F32_D(16); break;
    case 32: AF2_F32_D(32); break;
    case 64: AF2_F32_D(64); break;
    case 128:
      if (bq == 32) AF2_F32(128, 32); else AF2_F32(128, 64);
      break;
    default: return -1;
  }
#undef AF2_F32_D
#undef AF2_F32
  return (int)cudaGetLastError();
}

// One unit's arguments: batch*head row bh, queries from q0, key tiles of
// `tile`, rows d elements apart.
template <typename T>
__device__ __forceinline__ af2tile::TileArgsT<T> unit_args(
    const T* q, const T* k, const T* v, const float* bias,
    const uint8_t* q_mask, const uint8_t* k_mask, T* out, int bh, int q0,
    int nq, int nk, int d, int heads, int bias_repeat, int tile) {
  const int mrow = bh / heads;
  af2tile::TileArgsT<T> a;
  a.q = q + (size_t)bh * nq * d;
  a.k = k + (size_t)bh * nk * d;
  a.v = v + (size_t)bh * nk * d;
  a.out = out + (size_t)bh * nq * d;
  a.bias = nullptr;
  if (bias != nullptr) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    a.bias = bias + brow * nq * nk;
  }
  a.q_mask = q_mask == nullptr ? nullptr : q_mask + (size_t)mrow * nq;
  a.k_mask = k_mask == nullptr ? nullptr : k_mask + (size_t)mrow * nk;
  a.cols = nullptr;
  a.block = 0;
  a.q0 = q0;
  a.nq = nq;
  a.nk = nk;
  a.num_tiles = (nk + tile - 1) / tile;
  a.scale = 1.f;
  return a;
}

// The bf16 kernels: groups of WG warps on the shared tensor-core tile, G
// groups (each on its own (batch*head, query tile) unit) per block.
template <int D, int WG, int G, int BK>
__device__ __forceinline__ void mma_units(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const uint8_t* __restrict__ q_mask, const uint8_t* __restrict__ k_mask,
    __nv_bfloat16* __restrict__ out, int units, int nq, int nk, int heads,
    int bias_repeat, int q_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int group = warp / WG;
  const int unit = blockIdx.x * G + group;
  if (unit >= units) return;   // groups never share a barrier
  const int bh = unit / q_tiles;
  const int mrow = bh / heads;
  af2tile::TileArgs a;
  a.q = q + (size_t)bh * nq * D;
  a.k = k + (size_t)bh * nk * D;
  a.v = v + (size_t)bh * nk * D;
  a.out = out + (size_t)bh * nq * D;
  a.bias = nullptr;
  if (bias != nullptr) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    a.bias = bias + brow * nq * nk;
  }
  a.q_mask = q_mask == nullptr ? nullptr : q_mask + (size_t)mrow * nq;
  a.k_mask = k_mask == nullptr ? nullptr : k_mask + (size_t)mrow * nk;
  a.cols = nullptr;
  a.block = 0;
  a.q0 = (unit % q_tiles) * 16 * WG;
  a.nq = nq;
  a.nk = nk;
  a.num_tiles = (nk + BK - 1) / BK;
  a.scale = 1.f;
  af2tile::attend<D, WG, BK, true>(
      a, smem + group * af2tile::group_smem_bytes<D, WG, BK>(),
      group, warp % WG, threadIdx.x % 32);
}

#define AF2_MMA_PARAMS                                                      \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v, const float *__restrict__ bias,  \
      const uint8_t *__restrict__ q_mask,                                   \
      const uint8_t *__restrict__ k_mask, __nv_bfloat16 *__restrict__ out,  \
      int units, int nq, int nk, int heads, int bias_repeat, int q_tiles
#define AF2_MMA_ARGS                                                        \
  q, k, v, bias, q_mask, k_mask, out, units, nq, nk, heads, bias_repeat,   \
      q_tiles

template <int D, int WG, int G, int BK>
__global__ void __launch_bounds__(WG * G * 32)
fused_attention_mma_kernel(AF2_MMA_PARAMS) {
  mma_units<D, WG, G, BK>(AF2_MMA_ARGS);
}

// The 128-query tile: at most 128 registers a thread, so that two blocks
// of eight warps share an SM (occupancy is what this latency-bound loop
// gains from; left to itself the compiler takes more and fits one).
template <int D, int BK>
__global__ void __launch_bounds__(256, 2)
fused_attention_mma_wide_kernel(AF2_MMA_PARAMS) {
  mma_units<D, 8, 1, BK>(AF2_MMA_ARGS);
}

template <int D, int WG, int G, int BK>
int launch_mma(const void* q, const void* k, const void* v,
               const float* bias, const uint8_t* q_mask,
               const uint8_t* k_mask, void* out, int b, int nq, int nk,
               int heads, int bias_repeat, cudaStream_t stream) {
  constexpr int bytes = G * af2tile::group_smem_bytes<D, WG, BK>();
  auto kernel = [] {
    if constexpr (WG == 8)
      return fused_attention_mma_wide_kernel<D, BK>;
    else
      return fused_attention_mma_kernel<D, WG, G, BK>;
  }();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int q_tiles = (nq + 16 * WG - 1) / (16 * WG);
  const long long units = (long long)b * q_tiles;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)((units + G - 1) / G), WG * G * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, q_mask, k_mask,
      static_cast<__nv_bfloat16*>(out), (int)units, nq, nk, heads,
      bias_repeat, q_tiles);
  return (int)cudaGetLastError();
}

// Layout 3: the warpgroup kernel of attention_wgmma.cuh (TMA, an mbarrier
// ring, wgmma, persistent blocks).
template <int D, int BIAS>
__global__ void __launch_bounds__(af2wg::kThreads, 1)
fused_attention_wgmma_kernel(const __grid_constant__ af2wg::Maps maps,
                             const af2wg::Params p) {
  af2wg::attend<D, BIAS>(maps, p);
}

constexpr int kMaxDevices = 64;
constexpr int kTensorMapRefused = -2;

// the SM count of device `dev`, with the instance's shared-memory limit
// raised there, both once per device and instance
template <int D, int BIAS>
int sm_count(int dev) {
  static int sms[kMaxDevices];
  if (sms[dev] == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_attention_wgmma_kernel<D, BIAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        af2wg::Config<D, BIAS>::SMEM);
    if (e != cudaSuccess) return -(int)e;
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

// one persistent block an SM (at most one a unit), walking the units
template <int D, int BIAS>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const float* bias, const uint8_t* q_mask,
                 const uint8_t* k_mask, void* out, int b, int nq, int nk,
                 int heads, int bias_repeat, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int sms = sm_count<D, BIAS>(dev);
  if (sms <= 0) return sms == 0 ? (int)cudaErrorInvalidDevice : -sms;
  af2wg::Maps maps;
  if (!af2wg::encode_maps<D, BIAS>(&maps, q, k, v, bias, out, b, nq, nk,
                                   b / bias_repeat))
    return kTensorMapRefused;
  const int q_tiles = (nq + af2wg::kTileRows - 1) / af2wg::kTileRows;
  const long long units = (long long)b * q_tiles;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const af2wg::Params p{q_mask, k_mask, nq, nk, heads, bias_repeat, q_tiles,
                        (int)units};
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  constexpr int smem = af2wg::Config<D, BIAS>::SMEM;
  fused_attention_wgmma_kernel<D, BIAS>
      <<<grid, af2wg::kThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// The bf16 layouts. 1: eight warps on 128 queries of one batch*head row,
// key tiles of 64 (at D = 128: four warps on 64 queries, key tiles of
// 32); 2: one warp per batch*head row (16 queries), four rows to a block,
// key tiles of 16; 3: the warpgroup kernel, for Nq >= 64 and, with a
// bias, Nk a multiple of 4 (the bias map's row stride must be a multiple
// of 16 bytes). Layout 0 is the older shape rule, kept for callers that pass
// no layout: 2 for Nq <= 16 (the MSA column attention, where a 128-row
// tile would be 96 % padding), else 1. The Python wrapper chooses
// (`kernel_layout` in ops/attention.py) and passes its choice.
template <int D>
int dispatch_mma(int layout, const void* q, const void* k, const void* v,
                 const float* bias, const uint8_t* q_mask,
                 const uint8_t* k_mask, void* out, int b, int nq, int nk,
                 int heads, int bias_repeat, cudaStream_t stream) {
  constexpr int WG = D >= 128 ? 4 : 8;
  constexpr int BK = D >= 128 ? 32 : 64;
  if (layout == 0) layout = nq <= 16 ? 2 : 1;
  switch (layout) {
    case 1:
      return launch_mma<D, WG, 1, BK>(q, k, v, bias, q_mask, k_mask, out, b,
                                      nq, nk, heads, bias_repeat, stream);
    case 2:
      return launch_mma<D, 1, 4, 16>(q, k, v, bias, q_mask, k_mask, out, b,
                                     nq, nk, heads, bias_repeat, stream);
    case 3:
      if (nq < af2wg::kRows || (bias != nullptr && nk % 4 != 0)) return -1;
      return bias != nullptr
                 ? launch_wgmma<D, 1>(q, k, v, bias, q_mask, k_mask, out, b,
                                      nq, nk, heads, bias_repeat, stream)
                 : launch_wgmma<D, 0>(q, k, v, bias, q_mask, k_mask, out, b,
                                      nq, nk, heads, bias_repeat, stream);
    default:
      return -1;
  }
}

// Wide heads (D > 128, a multiple of 128; the sliced path of
// attention_tile.cuh): one unit per (batch*head, query tile, output
// slice). fp32: one thread per query row over slices of 64 columns; bf16:
// the tensor-core layouts of dispatch_mma over slices of 128 columns.
template <int BQ>
__global__ void __launch_bounds__(BQ)
fused_attention_sliced_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              const uint8_t* __restrict__ q_mask,
                              const uint8_t* __restrict__ k_mask,
                              float* __restrict__ out, int nq, int nk, int d,
                              int heads, int bias_repeat, int q_tiles,
                              int slices) {
  const int slice = blockIdx.x % slices;
  const int unit = blockIdx.x / slices;
  const af2tile::TileArgsT<float> a = unit_args(
      q, k, v, bias, q_mask, k_mask, out, unit / q_tiles,
      (unit % q_tiles) * BQ, nq, nk, d, heads, bias_repeat,
      af2tile::kSliceF32BK);
  af2tile::attend_sliced_f32<BQ, true>(a, d, slice * af2tile::kSliceF32);
}

int launch_sliced_f32(const void* q, const void* k, const void* v,
                      const float* bias, const uint8_t* q_mask,
                      const uint8_t* k_mask, void* out, int b, int nq,
                      int nk, int d, int heads, int bias_repeat,
                      cudaStream_t stream) {
  const int bq = nq <= 32 ? 32 : 64;
  const int q_tiles = (nq + bq - 1) / bq;
  const int slices = d / af2tile::kSliceF32;
  const long long blocks = (long long)b * q_tiles * slices;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
#define AF2_SLICED_F32(BQ)                                                    \
  fused_attention_sliced_kernel<BQ><<<(unsigned)blocks, BQ, 0, stream>>>(    \
      static_cast<const float*>(q), static_cast<const float*>(k),          \
      static_cast<const float*>(v), bias, q_mask, k_mask,                  \
      static_cast<float*>(out), nq, nk, d, heads, bias_repeat, q_tiles,    \
      slices)
  if (bq == 32) AF2_SLICED_F32(32);
  else AF2_SLICED_F32(64);
#undef AF2_SLICED_F32
  return (int)cudaGetLastError();
}

template <int WG, int G, int BK>
__global__ void __launch_bounds__(WG * G * 32)
fused_attention_sliced_mma_kernel(AF2_MMA_PARAMS, int d, int slices) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int group = warp / WG;
  const int unit = blockIdx.x * G + group;
  if (unit >= units) return;   // groups never share a barrier
  const int slice = unit % slices;
  const int tile = unit / slices;
  const af2tile::TileArgs a = unit_args(
      q, k, v, bias, q_mask, k_mask, out, tile / q_tiles,
      (tile % q_tiles) * 16 * WG, nq, nk, d, heads, bias_repeat, BK);
  af2tile::attend_sliced<WG, BK, true>(
      a, d, slice * af2tile::kSlice,
      smem + group * af2tile::sliced_smem_bytes<WG, BK>(), group, warp % WG,
      threadIdx.x % 32);
}

template <int WG, int G, int BK>
int launch_sliced_mma(const void* q, const void* k, const void* v,
                      const float* bias, const uint8_t* q_mask,
                      const uint8_t* k_mask, void* out, int b, int nq,
                      int nk, int d, int heads, int bias_repeat,
                      cudaStream_t stream) {
  constexpr int bytes = G * af2tile::sliced_smem_bytes<WG, BK>();
  auto kernel = fused_attention_sliced_mma_kernel<WG, G, BK>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int q_tiles = (nq + 16 * WG - 1) / (16 * WG);
  const int slices = d / af2tile::kSlice;
  const long long units = (long long)b * q_tiles * slices;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)((units + G - 1) / G), WG * G * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, q_mask, k_mask,
      static_cast<__nv_bfloat16*>(out), (int)units, nq, nk, heads,
      bias_repeat, q_tiles, d, slices);
  return (int)cudaGetLastError();
}

// The bf16 sliced layouts, as dispatch_mma's at D = 128: 1 is four warps on
// 64 queries over key tiles of 32, 2 one warp per batch*head row over key
// tiles of 16; 0 takes 2 for Nq <= 16, else 1.
int dispatch_sliced_mma(int layout, const void* q, const void* k,
                        const void* v, const float* bias,
                        const uint8_t* q_mask, const uint8_t* k_mask,
                        void* out, int b, int nq, int nk, int d, int heads,
                        int bias_repeat, cudaStream_t stream) {
  if (layout == 0) layout = nq <= 16 ? 2 : 1;
  switch (layout) {
    case 1:
      return launch_sliced_mma<4, 1, 32>(q, k, v, bias, q_mask, k_mask, out, b,
                                       nq, nk, d, heads, bias_repeat, stream);
    case 2:
      return launch_sliced_mma<1, 4, 16>(q, k, v, bias, q_mask, k_mask, out, b,
                                       nq, nk, d, heads, bias_repeat, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernels). layout: 0 takes the older shape rule; 1, 2 or 3 picks a bf16
// layout (see dispatch_mma; the sliced path has 1 and 2). d is 16, 32,
// 64, 128 or a multiple of 128 (the sliced path). bias, q_mask and k_mask
// may be null. Returns cudaGetLastError() after the launch (0 on
// success), -1 for a head width, dtype, layout or shape the kernel does
// not take, -2 when the driver refuses a tensor map of layout 3.
extern "C" int af2_fused_attention(const void* q, const void* k,
                                   const void* v, const float* bias,
                                   const uint8_t* q_mask,
                                   const uint8_t* k_mask, void* out, int b,
                                   int nq, int nk, int d, int heads,
                                   int bias_repeat, int dtype, int layout,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > af2tile::kSlice) {
    if (d % af2tile::kSlice != 0) return -1;
    if (dtype == 0)
      return layout != 0 ? -1
                         : launch_sliced_f32(q, k, v, bias, q_mask, k_mask,
                                           out, b, nq, nk, d, heads,
                                           bias_repeat, s);
    if (dtype != 1) return -1;
    return dispatch_sliced_mma(layout, q, k, v, bias, q_mask, k_mask, out, b,
                             nq, nk, d, heads, bias_repeat, s);
  }
  if (dtype == 0)
    return layout != 0 ? -1
                       : launch_f32(q, k, v, bias, q_mask, k_mask, out, b,
                                    nq, nk, d, heads, bias_repeat, s);
  if (dtype != 1) return -1;
  switch (d) {
    case 16:
      return dispatch_mma<16>(layout, q, k, v, bias, q_mask, k_mask, out, b,
                              nq, nk, heads, bias_repeat, s);
    case 32:
      return dispatch_mma<32>(layout, q, k, v, bias, q_mask, k_mask, out, b,
                              nq, nk, heads, bias_repeat, s);
    case 64:
      return dispatch_mma<64>(layout, q, k, v, bias, q_mask, k_mask, out, b,
                              nq, nk, heads, bias_repeat, s);
    case 128:
      return dispatch_mma<128>(layout, q, k, v, bias, q_mask, k_mask, out,
                               b, nq, nk, heads, bias_repeat, s);
    default:
      return -1;
  }
}
