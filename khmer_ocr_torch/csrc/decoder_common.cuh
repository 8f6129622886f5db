// Constants and small device routines of the decoder layer that kernels K2
// (decoder_layer_step.cu) and K3 (decode_loop.cu) share through the cluster
// layer of decoder_cluster.cuh: the CTA size, the masking constant, the
// LayerNorm epsilon, the order of the layer's 18 weights, warp reductions,
// the residual LayerNorm on full rows (one warp per lane row, so every CTA
// of a cluster computes the same bits from the same rows), and the storage
// types: float or __nv_bfloat16 for x, the caches, the memory K/V and the
// weight matrices, read 16 bytes at a time and widened to float, while the
// biases, LayerNorm parameters, softmax and every sum stay float.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dec {

constexpr int NT = 384;   // threads per CTA
constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr int N_WEIGHTS = 18;

// weight order (layer_weights in ops/kernels/decode_step.py)
enum {
  QKV_W, QKV_B, SO_W, SO_B, LN1_S, LN1_B, CQ_W, CQ_B, CO_W, CO_B,
  LN2_S, LN2_B, L1_W, L1_B, L2_W, L2_B, LN3_S, LN3_B
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Elements of a 16-byte vector of the storage type T.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

// CTAs per SM a kernel's registers are bounded for (K2 and its blocks):
// one in bf16, whose 8-wide vectors double the accumulators (and whose
// shared memory at 8 lanes a cluster leaves room for one CTA anyway). In
// float, K2_F32_MIN_BLOCKS: 1 by default (168 registers, no spills at 3
// lanes); K2's second float library is built with 2 (80 registers, 68 B
// of spill stores and 220 B of loads at 3 lanes), which holds twice the
// clusters. geometry.k2_two_ctas_an_sm picks between them per launch:
// examples/k2_registers_torch.py, 3 lanes, NVIDIA H100 80GB HBM3, 700 W,
// one CTA's registers an SM against two: 8 images at Tm 256 0.0471 against
// 0.0496 ms, 1 image 0.0468 against 0.0491; 64 images 0.2712 against
// 0.2067 and 8 images at Tm 4096 (16-CTA clusters) 0.1648 against 0.1318,
// where one CTA an SM holds 15 clusters of 8 (7 of 16) and two hold 30 (14).
// The blocks take 1: 0.0506 against 0.0525 ms for rank 0 of 2 at 8 images.
#ifndef K2_F32_MIN_BLOCKS
#define K2_F32_MIN_BLOCKS 1
#endif
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? K2_F32_MIN_BLOCKS : 1;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (to nearest, ties to even) and widened back: the compute
// dtype's rounding of an f32 value, the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ void widen(const float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void widen(const uint4 u, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Vec<T>::N elements at p (16-byte aligned) as floats: ldg16 through the
// read-only path (weights and memory K/V, never written by the kernel),
// ld16 a plain load (self caches, which the kernel writes, in global or
// shared memory), ld16f from float shared memory.
__device__ __forceinline__ void ldg16(const float* p, float* o) { widen(__ldg(reinterpret_cast<const float4*>(p)), o); }
__device__ __forceinline__ void ldg16(const __nv_bfloat16* p, float* o) {
  widen(__ldg(reinterpret_cast<const uint4*>(p)), o);
}
__device__ __forceinline__ void ld16(const float* p, float* o) { widen(*reinterpret_cast<const float4*>(p), o); }
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* o) { widen(*reinterpret_cast<const uint4*>(p), o); }
template <int N>
__device__ __forceinline__ void ld16f(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; i += 4) widen(*reinterpret_cast<const float4*>(p + i), o + i);
}

// x[r] = LayerNorm(x[r] + t[r]) for the K rows; one warp per row.
template <int K>
__device__ void residual_ln(float* x, const float* t, const float* __restrict__ s,
                            const float* __restrict__ b, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < K) {
    float* xr = x + warp * D;
    const float* tr = t + warp * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = xr[d] + tr[d];
      xr[d] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) / (float)D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = xr[d] - mean;
      sq = fmaf(c, c, sq);
    }
    const float var = warp_sum(sq) / (float)D;
    const float inv = 1.0f / sqrtf(var + LN_EPS);
    for (int d = lane; d < D; d += 32) xr[d] = (xr[d] - mean) * inv * s[d] + b[d];
  }
  __syncthreads();
}

}  // namespace dec
