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
// What bounds it on this card: at the main path's triangle shape (B=2048,
// N=256, D=64, bf16) the call must move 270.7 MB (q, k, v, out, the bias
// and the masks), 0.0808 ms at 3.35 TB/s, against 34.36 GFLOP, 0.0347 ms
// on the bf16 tensor cores: it is bound by device-memory bytes.
//
// What the design does about it. bf16 (the fold path) runs on the shared
// tensor-core tile of attention_tile.cuh: mma.sync products with fp32
// accumulators, k and v kept bf16 in padded shared memory and brought in
// by cp.async in a two-stage ring, so each tile's copy overlaps the
// previous tile's products, the online softmax in registers, the bias
// replayed by index straight from L2 and never materialised per fold.
// One thread block owns one (batch*head, 128 queries): eight warps of 16
// rows, held to 128 registers so that two blocks share an SM, over key
// tiles of 64 (at D = 128: 64 queries, four warps, key tiles of 32). The
// loop is bound by latency more than by any unit's rate, so occupancy is
// what this shape buys; on the card it beat 64-query blocks at ~170
// registers (three blocks an SM) and 32-key tiles (PERF.md). Short query
// axes (the MSA column attention, N = 5) take one warp per batch*head
// row, four such warps to a block, over key tiles of 16. fp32 (the small
// parity folds) keeps the first design: one thread per query row, fp32
// FMAs on the CUDA cores, keys streamed through shared memory in tiles of
// 32, online softmax rescaled once per 8 keys; no TF32.
//
// What is left: wgmma with TMA and an mbarrier ring (64-row warpgroup
// tiles), persistent blocks that walk many (batch*head, query tile) units
// so one unit's epilogue overlaps the next one's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

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

// The bf16 layouts. 1: eight warps on 128 queries of one batch*head row,
// key tiles of 64 (at D = 128: four warps on 64 queries, key tiles of
// 32); 2: one warp per batch*head row (16 queries), four rows to a block,
// key tiles of 16. Layout 0 is the shape rule: 2 for Nq <= 16 (the MSA
// column attention, where a 128-row tile would be 96 % padding), else 1.
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
// tile). layout: 0 takes the shape rule; 1 or 2 forces a bf16 layout (see
// dispatch_mma; for measuring the rule on the card). d is 16, 32, 64, 128
// or a multiple of 128 (the sliced path). bias, q_mask and k_mask may be
// null. Returns cudaGetLastError() after the launch (0 on success), or -1
// for a head width, dtype or layout the kernel does not take.
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
