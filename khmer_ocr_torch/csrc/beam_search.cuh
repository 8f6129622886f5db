// One step of the beam search's bookkeeping on one image, as device routines
// that kernels K3 (decode_loop.cu, every step of its whole decode) and K5
// (beam_step.cu, one step a launch) share: the search of
// decode/beam.py::beam_advance, in its order and with its ties.
//   lane_topk:  log-softmax of a lane's logits in f32 (precise expf/logf)
//               unless they are log-probs already, then its top-K by K
//               passes of the first maximum (lowest column on ties), a
//               column taken in an earlier pass reading NEG_INF, as
//               topk_iter masks it; one warp a lane;
//   retire:     each lane's <eos> candidate normalised as raw / den, the
//               first best lane (argmax's), the best completion replaced
//               only on strict improvement; one warp;
//   next_beams: the best K of the K x K candidates that are not <eos>,
//               lowest flat (lane-major) index on ties, their parents and
//               tokens; one warp;
//   reorder:    rows of tokens or lineage taken from their parents, with
//               one slot set a row; the block's threads.
// K <= 32: a warp's lane holds one beam lane in retire. Values compare as
// the reference compares them (NaN aside): the larger first, then the
// lower index, so every warp reduction ends with the same pair in every
// thread.

#pragma once

#include "decoder_common.cuh"  // NEG_INF, warp_max, warp_sum

namespace beam {

using dec::NEG_INF;

constexpr int NONE = 1 << 30;                  // no column yet
constexpr float LOWEST = -3.402823466e38f;     // below every value, NEG_INF included
constexpr unsigned FULL = 0xffffffffu;

// Whether (v, i) comes before (bv, bi): the larger value, then the lower
// index; an empty pair (bi == NONE) comes after every other.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return i != NONE && (bi == NONE || v > bv || (v == bv && i < bi));
}

// The first pair of the warp: every lane's (bv, bi) reduced over the warp.
__device__ __forceinline__ void warp_first(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, bv, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// k passes of one warp over the n values val(c): pass j finds the first
// maximum, a column found by an earlier pass reading NEG_INF. Lane 0 writes
// top_v[j] and top_i[j] (shared memory, read back by every lane).
template <typename Val>
__device__ void warp_topk(Val val, int n, int k, float* top_v, int* top_i) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < k; ++j) {
    float bv = 0.f;
    int bi = NONE;
    for (int c = lane; c < n; c += 32) {
      float v = val(c);
      for (int t = 0; t < j; ++t) {
        if (top_i[t] == c) v = NEG_INF;
      }
      if (before(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_first(bv, bi);
    if (lane == 0) {
      top_v[j] = bv;
      top_i[j] = bi;
    }
    __syncwarp();
  }
}

// Steps 1-2 for one lane by one warp: the top-k of its log-probs over the
// first n columns of `row` (logits when log_softmax, else log-probs), into
// top_v[0..k) and top_i[0..k). A logit's log-prob is (x - max) - log(sum of
// exp(x - max)), the same bits at every read.
template <typename Row>
__device__ void lane_topk(const Row* row, int n, int k, bool log_softmax, float* top_v, int* top_i) {
  const int lane = threadIdx.x & 31;
  float m = 0.f, lse = 0.f;
  if (log_softmax) {
    m = LOWEST;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
    m = dec::warp_max(m);
    float se = 0.f;
    for (int c = lane; c < n; c += 32) se += expf(row[c] - m);
    lse = logf(dec::warp_sum(se));
    warp_topk([&](int c) { return (row[c] - m) - lse; }, n, k, top_v, top_i);
  } else {
    warp_topk([&](int c) { return (float)row[c]; }, n, k, top_v, top_i);
  }
}

// Step 3 by one warp over the K lanes' candidates (top_v, top_i: K x K,
// lane-major) with running scores score[K]: lane l's <eos> candidate
// normalised as (score[l] + lp) / den, the first lane with the best one
// (best_lane, in every lane). Returns in every lane whether it beats
// *best_score strictly, and then sets *best_score (lane 0 writes it).
__device__ bool retire(const float* score, const float* top_v, const int* top_i, int K, int eos, float den,
                       float* best_score, int& best_lane) {
  const int lane = threadIdx.x & 31;
  float e = NEG_INF;
  int l = NONE;
  if (lane < K) {
    l = lane;
    for (int j = 0; j < K; ++j) {
      if (top_i[lane * K + j] == eos) e = fmaxf(e, (score[lane] + top_v[lane * K + j]) / den);
    }
  }
  warp_first(e, l);
  best_lane = l;
  const bool improved = e > *best_score;
  __syncwarp();
  if (lane == 0 && improved) *best_score = e;
  __syncwarp();
  return improved;
}

// Step 4 by one warp: the next K beams, the best K of the candidates
// score[l] + top_v[l K + j] that are not <eos>. Writes next[r] (the new
// running scores: the caller copies them over score once no thread reads
// it), parent[r] and new_tok[r].
__device__ void next_beams(const float* score, const float* top_v, const int* top_i, int K, int eos, float* next,
                           int* parent, int* new_tok) {
  const int lane = threadIdx.x & 31;
  warp_topk([&](int c) { return top_i[c] == eos ? NEG_INF : score[c / K] + top_v[c]; }, K * K, K, next, parent);
  if (lane < K) {
    const int c = parent[lane];
    new_tok[lane] = top_i[c];
    parent[lane] = c / K;
  }
  __syncwarp();
}

// Step 5 by the block's threads: dst[r][t] = src[parent[r]][t] over K rows
// of n, slot `slot` of row r set to at_slot[r] instead. dst and src must not
// overlap.
template <typename D, typename S>
__device__ void reorder(D* dst, const S* src, const int* parent, int K, int n, int slot, const int* at_slot) {
  for (int i = threadIdx.x; i < K * n; i += blockDim.x) {
    const int r = i / n;
    const int t = i - r * n;
    dst[i] = t == slot ? (D)at_slot[r] : (D)src[parent[r] * n + t];
  }
}

}  // namespace beam
