// Constants and small device routines of the decoder layer that kernels K2
// (decoder_layer_step.cu) and K3 (decode_loop.cu) share through the cluster
// layer of decoder_cluster.cuh: the CTA size, the masking constant, the
// LayerNorm epsilon, the order of the layer's 18 weights, warp reductions
// and the residual LayerNorm on full rows (one warp per lane row, so every
// CTA of a cluster computes the same bits from the same rows).

#pragma once

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
