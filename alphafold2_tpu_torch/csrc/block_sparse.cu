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
// Softmax and both products run in fp32; the output is written in the
// input type.
//
// What bounds it on this card: at the 512-residue bucket's triangle
// shape (B=4096, N=512, D=64, bf16, 74 of 256 blocks live) the call reads
// q, k, v and writes out, ~1.07 GB, against ~80 GFLOP of live work, so on
// the tensor cores it would be bound by device-memory bytes. This first
// version does both products with fp32 FMAs on the CUDA cores, so it is
// bound by FMA issue instead.
//
// What the design does about it: the Pallas grid (B, nqb, T) pads every
// row to T, the widest row's live count, and idles on padded slots; here
// one block of threads owns one (batch*head, query block) and loops over
// that row's own live count only. Each thread owns one query row, held in
// registers with its fp32 output accumulator (as in fused_attention.cu).
// Per live key block the threads stage k, v, the bias tile and the key
// mask flags through shared memory in tiles of up to 32 keys and run an
// online softmax (running max and denominator, rescaled once per kChunk
// keys); the output is written once, after the last live block.
// Tensor-core products (mma/wgmma), TMA and balancing the global row
// against the banded rows are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e9f;
constexpr int kChunk = 8;   // keys per online-softmax rescale

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// BQ queries per thread block (the query block, or half of a 128 block at
// D = 128 so the static shared memory stays under 48 KB); BK keys per
// shared-memory tile.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(BQ)
block_sparse_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const uint8_t* __restrict__ k_mask,
                    const int* __restrict__ cols,
                    const int* __restrict__ counts, T* __restrict__ out,
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

  const T* kb = k + (size_t)bh * n * D;
  const T* vb = v + (size_t)bh * n * D;
  const float* biasb = nullptr;
  if (has_bias) {
    const size_t brow = (size_t)(bh / (bias_repeat * heads)) * heads +
                        bh % heads;
    biasb = bias + brow * n * n;
  }

  float qr[D];
  float o[D];
  const T* qrow = q + ((size_t)bh * n + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f32(qrow[d]) * scale;
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
        ks[jj][d] = to_f32(kb[(size_t)(j0 + jj) * D + d]);
        vs[jj][d] = to_f32(vb[(size_t)(j0 + jj) * D + d]);
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
  T* orow = out + ((size_t)bh * n + qi) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(o[d] * inv);
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const uint8_t* k_mask, const int* cols, const int* counts,
           void* out, int b, int n, int block, int t_max, int heads,
           int bias_repeat, float scale, cudaStream_t stream) {
  const int nqb = n / block;
  const int q_tiles = block / BQ;
  const long long blocks = (long long)b * nqb * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  block_sparse_kernel<T, D, BQ><<<(unsigned)blocks, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, k_mask, cols, counts,
      static_cast<T*>(out), n, block, t_max, heads, bias_repeat, scale, nqb,
      q_tiles);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_block(const void* q, const void* k, const void* v,
                   const float* bias, const uint8_t* k_mask, const int* cols,
                   const int* counts, void* out, int b, int n, int block,
                   int t_max, int heads, int bias_repeat, float scale,
                   cudaStream_t stream) {
#define AF2_LAUNCH(BQ)                                                      \
  return launch<T, D, BQ>(q, k, v, bias, k_mask, cols, counts, out, b, n,  \
                          block, t_max, heads, bias_repeat, scale, stream)
  switch (block) {
    case 16: AF2_LAUNCH(16);
    case 32: AF2_LAUNCH(32);
    case 64: AF2_LAUNCH(64);
    case 128:
      if constexpr (D >= 128) {
        AF2_LAUNCH(64);
      } else {
        AF2_LAUNCH(128);
      }
    default:
      return -1;
  }
#undef AF2_LAUNCH
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const float* bias, const uint8_t* k_mask, const int* cols,
               const int* counts, void* out, int b, int n, int block,
               int t_max, int heads, int bias_repeat, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return dispatch_block<T, 16>(q, k, v, bias, k_mask, cols, counts, out,
                                   b, n, block, t_max, heads, bias_repeat,
                                   scale, stream);
    case 32:
      return dispatch_block<T, 32>(q, k, v, bias, k_mask, cols, counts, out,
                                   b, n, block, t_max, heads, bias_repeat,
                                   scale, stream);
    case 64:
      return dispatch_block<T, 64>(q, k, v, bias, k_mask, cols, counts, out,
                                   b, n, block, t_max, heads, bias_repeat,
                                   scale, stream);
    case 128:
      return dispatch_block<T, 128>(q, k, v, bias, k_mask, cols, counts,
                                    out, b, n, block, t_max, heads,
                                    bias_repeat, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. bias and k_mask may be null; cols and
// counts are the plan on the device. Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a head width, block, shape or dtype the
// kernel does not take.
extern "C" int af2_block_sparse_attention(
    const void* q, const void* k, const void* v, const float* bias,
    const uint8_t* k_mask, const int* cols, const int* counts, void* out,
    int b, int n, int d, int block, int t_max, int heads, int bias_repeat,
    float scale, int dtype, void* stream) {
  if (block <= 0 || n % block != 0 || t_max < 1 || heads < 1 || b % heads)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, bias, k_mask, cols, counts, out, b,
                             n, block, t_max, heads, bias_repeat, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, bias, k_mask, cols, counts,
                                     out, b, n, block, t_max, heads,
                                     bias_repeat, scale, s);
  return -1;
}
