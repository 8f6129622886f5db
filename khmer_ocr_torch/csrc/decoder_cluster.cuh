// One post-LN decoder layer of one image's lanes on a thread-block cluster,
// as one device routine shared by kernel K2 (decoder_layer_step.cu, one
// layer per launch) and kernel K3 (decode_loop.cu, every layer of every step
// of the beam decode in one launch).
//
// The cluster has H x S CTAs (one per attention head, S = 1 or 2 a head);
// CTA h owns head h and one H-th of every projection's output columns, so
// each weight byte is read by exactly one CTA of the cluster:
//   1. CTA h computes only head h's q, k and v columns and writes head h's
//      slice of the self caches at slot pos; head h's self-attention needs
//      nothing from the other CTAs;
//   2. the head outputs go to every CTA through distributed shared memory
//      (DSMEM), then one cluster barrier;
//   3. out-projection: CTA h computes D/H of the D output columns, they are
//      exchanged the same way, and every CTA does the residual and LN on the
//      full rows (the same sums in the same order, so every CTA holds the
//      same bits; a redundant LN is cheaper than another exchange);
//   4. cross-attention of head h reads only head h's D/H columns of the
//      memory K/V, for all the cluster's lanes at once;
//   5. out-projection and LN2 as in 3;
//   6. FFN: CTA h computes hidden columns [h F/H, (h+1) F/H) with ReLU and
//      multiplies them by the matching F/H rows of the second weight, a
//      partial sum of the full (lanes, D) output; CTA q receives every CTA's
//      partial of its D/H columns (reduce-scatter over DSMEM), adds them in
//      the fixed order of the CTAs, and sends the sums to every CTA
//      (all-gather); no atomics, so a result is the same from run to run.
//      Then the residual and LN3.
// Six cluster barriers per layer. With S = 2 (K2's long memories) a head
// takes two CTAs: each owns half the head's columns of every projection (the
// halves of q, k, v meet in both), both run the self-attention and send
// their half of it, each takes half the memory positions, and the two halves
// merge by their log-sum-exp in the order of the CTAs (three more barriers).
//
// Called in a loop (K3), the barriers also order every exchange across
// layers: a CTA writes a peer's buffer (s.a, s.t, s.part, and s.qkv, s.xo
// for S = 2) only after a cluster barrier that the peer reaches after its
// last read of that buffer in the layer before (each buffer is read before
// the next exchange's barrier, and written again at the earliest one
// exchange later).
//
// Attention is an online softmax over chunks of TC positions: the chunk's
// validity flags or lineage-gathered source rows staged in shared memory
// first (so no global load waits on another), then the logits in shared
// memory, one warp per lane for the running max and sum, and the weighted
// sum of V in registers. The self caches are read through a strided view
// (CacheView): K2's (rows, L, D) global caches, K3's per-head slices in
// shared or global memory.
//
// Storage type T (float or __nv_bfloat16): the weight matrices, the self
// caches and the memory K/V are T, read 16 bytes (Vec<T>::N elements) at a
// time and widened; shared memory, biases, LayerNorms, softmax and every
// accumulation are float. The rounding points are the TPU kernel's: every
// product's input is rounded to T (matvec_cols rounds its input rows, the
// attention rounds its weights before the weighted sum of V), q, k and v
// are rounded to T where they are made (so slot pos read from shared memory
// equals the cache slot written), and the caller rounds its outputs. With
// T = float every rounding is the identity and the arithmetic is the
// float kernel's, operation for operation.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decoder_common.cuh"  // NT, NEG_INF, the weight order, warp reductions, residual_ln

namespace dec {

namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The shared-memory layout of one CTA for G lanes, S CTAs per head and
// attention chunks of tc positions (floats, each part a multiple of 4).
struct Smem {
  float* x;     // [G][D]    residual stream, full rows (the same in every CTA)
  float* qkv;   // [G][3hd]  this head's self q, k, v; later its cross q
  float* a;     // [G][D]    every head's attention output (gathered)
  float* t;     // [G][D]    projection output, full rows (gathered)
  float* hid;   // [G][F/HS] this CTA's FFN hidden slice
  float* part;  // [HS][G][hd/S] every CTA's FFN partial of this CTA's columns
  float* y;     // [G][D]    local outputs before an exchange
  float* p;     // [G][tc]   attention weights of one chunk
  int* aux;     // [G][tc]   the chunk's validity flags or source cache rows
  float* xo;    // [S][G hd + 4G] the head's cross-attention partials (o, m, l), S > 1
  float* red;   // split-k and attention partial sums
  float* stat;  // [3][G]    running max, sum and correction per lane
  int tc;       // positions per attention chunk
};

// vw: Vec<T>::N, the columns one thread carries in a matvec or an attention row
__host__ __device__ inline size_t red_floats(int G, int D, int H, int F, int vw) {
  size_t n = (size_t)vw * NT;
  const size_t cols[3] = {(size_t)D, 3 * (size_t)(D / H), (size_t)(F / H)};
  for (size_t c : cols) n = c > n ? c : n;
  return (size_t)G * n;
}

__host__ __device__ inline size_t xo_floats(int G, int D, int H, int S) {
  return S > 1 ? (size_t)S * ((size_t)G * (D / H) + 4 * G) : 0;
}

__host__ __device__ inline size_t smem_floats(int G, int D, int H, int F, int S, int tc, int vw) {
  const int hd = D / H;
  return (size_t)G * D * 4 + (size_t)G * 3 * hd + (size_t)G * (F / (H * S)) + (size_t)H * G * hd +
         2 * (size_t)G * tc + xo_floats(G, D, H, S) + red_floats(G, D, H, F, vw) + 4 * (size_t)G;
}

__device__ inline Smem carve(float* base, int G, int D, int H, int F, int S, int tc, int vw) {
  const int hd = D / H;
  Smem s;
  s.tc = tc;
  s.x = base;
  s.qkv = s.x + G * D;
  s.a = s.qkv + G * 3 * hd;
  s.t = s.a + G * D;
  s.hid = s.t + G * D;
  s.part = s.hid + G * (F / (H * S));
  s.y = s.part + H * G * hd;
  s.p = s.y + G * D;
  s.aux = reinterpret_cast<int*>(s.p + G * tc);
  s.xo = s.p + 2 * G * tc;
  s.red = s.xo + xo_floats(G, D, H, S);
  s.stat = s.red + red_floats(G, D, H, F, vw);
  return s;
}

// out[r][j] = bias[c(j)] + sum_k T(in[r][k]) * W[k][c(j)] (optionally ReLU,
// optionally rounded to T) for the G rows and the ncols local columns j,
// where local column j is global column c(j) = (j / segw) * seg_stride +
// col0 + j % segw of W (row stride ldw). A thread carries Vec<T>::N columns
// (one 16-byte load of W a row); the input dimension is split over thread
// groups whose partial sums are added in a fixed order, so two equal weight
// columns give bit-equal outputs. bias may be null.
template <int G, typename T>
__device__ void matvec_cols(const T* __restrict__ W, int ldw, int col0, int segw, int seg_stride, int ncols,
                            const float* __restrict__ bias, const float* in, int in_ld, int kin, float* out,
                            int out_ld, float* red, bool relu, bool round_out = false) {
  constexpr int V = Vec<T>::N;
  const int nq = ncols / V;
  int groups = NT / nq;
  if (groups < 1) groups = 1;
  const int kchunk = (kin + groups - 1) / groups;
  const int tid = threadIdx.x;
  for (int item = tid; item < groups * nq; item += NT) {
    const int g = item / nq;
    const int j = V * (item - g * nq);
    const int seg = j / segw;
    const T* wc = W + seg * seg_stride + col0 + (j - seg * segw);
    const int k0 = g * kchunk;
    const int k1 = min(kin, k0 + kchunk);
    float acc[G][V];
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    }
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float w[V];
      ldg16(wc + (size_t)k * ldw, w);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float a = round_to<T>(in[r * in_ld + k]);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(a, w[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(red + (g * G + r) * ncols + j + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * ncols; i += NT) {
    const int r = i / ncols;
    const int j = i - r * ncols;
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += red[(g * G + r) * ncols + j];
    if (bias != nullptr) {
      const int seg = j / segw;
      v += bias[seg * seg_stride + col0 + (j - seg * segw)];
    }
    if (relu) v = fmaxf(v, 0.f);
    out[r * out_ld + j] = round_out ? round_to<T>(v) : v;
  }
  __syncthreads();
}

// Copy this CTA's [G][w] block (row stride src_ld) into columns [c, c + w)
// of the [G][dst_ld] buffer `dst` of the cluster's CTAs first..first+count-1.
template <int G>
__device__ void scatter_ranks(const cg::cluster_group& cluster, int first, int count, const float* src, int src_ld,
                              float* dst, int dst_ld, int c, int w) {
  const int n4 = w >> 2;
  const int per = G * n4;
  for (int i = threadIdx.x; i < count * per; i += NT) {
    const int q = i / per;
    const int j = i - q * per;
    const int r = j / n4;
    const int e = 4 * (j - r * n4);
    const float4 v = *reinterpret_cast<const float4*>(src + r * src_ld + e);
    *cluster.map_shared_rank(reinterpret_cast<float4*>(dst + r * dst_ld + c + e), first + q) = v;
  }
}

// Where the K and V rows (this head's hd columns) of position t come from:
// row_of(r, t) = cross ? nothing : the cache row of lane r's slot t, and the
// row starts at k + row * row_stride + t * t_stride.
template <typename T>
struct HeadRows {
  const T* k;          // cross: the image's memory K at this head's columns; self: the cache view
  const T* v;
  const int* lin;      // self: lineage row of the group's first lane (image-local), or nullptr
  const float* own;    // self: the group's new q|k|v rows in shared memory ([G][3hd])
  size_t row_stride;   // self: floats between two cache rows (lanes)
  int t_stride;        // floats between two positions
  int lin_stride, img_row0, lane0, pos, hd;
};

// o[r][e] = sum_t T(exp(q[r] . k_t / sqrt(hd) - m[r])) v_t[e] over this
// head's hd columns for the G rows and positions tb..te-1, with m[r] the
// largest logit and l[r] the sum of the weights (left in s.stat).
// normalize: out = o / l, else out = o. CROSS: the rows share the image's
// memory positions, masked by valid; otherwise each row reads its own
// lineage-gathered cache slots. Online softmax over chunks of s.tc
// positions; each chunk first stages its validity flags (cross) or its
// source cache rows (self) in shared memory, so that no global load waits
// on another. Dot products run over 16-byte vectors of T, their lanes
// summed from the last to the first.
template <int G, bool CROSS, typename T>
__device__ void attend_head(const Smem& s, const float* q, int q_ld, int tb, int te, const HeadRows<T>& src,
                            const float* __restrict__ valid, float* out, bool normalize) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd = src.hd;
  const int nv = hd / V;
  const int tgroups = NT / nv;
  const int TC = s.tc;
  const float scale = 1.0f / sqrtf((float)hd);
  float* m = s.stat;
  float* l = s.stat + G;
  float* corr = s.stat + 2 * G;
  if (tid < G) {
    m[tid] = NEG_INF;
    l[tid] = 0.f;
  }
  float acc[G][V];
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  }
  const int qv = tid % nv;
  const int tg = tid / nv;

  for (int t0 = tb; t0 < te; t0 += TC) {
    const int n = min(TC, te - t0);
    // the chunk's flags (cross: 1/0 valid) or source rows (self: cache row, -1 for slot pos)
    if (CROSS) {
      for (int tt = tid; tt < n; tt += NT) s.aux[tt] = valid[t0 + tt] > 0.f ? 1 : 0;
    } else {
      for (int i = tid; i < G * n; i += NT) {
        const int r = i / n;
        const int t = t0 + i - r * n;
        s.aux[r * TC + t - t0] = t == src.pos ? -1
                                 : src.img_row0 + (src.lin ? src.lin[r * src.lin_stride + t] : src.lane0 + r);
      }
    }
    __syncthreads();

    // logits
    if (CROSS) {
      for (int tt = tid; tt < n; tt += NT) {
        float dot[G];
#pragma unroll
        for (int r = 0; r < G; ++r) dot[r] = 0.f;
        const bool ok = s.aux[tt] != 0;
        if (ok) {
          const T* kr = src.k + (size_t)(t0 + tt) * src.t_stride;
          for (int c = 0; c < nv; ++c) {
            float kv[V];
            ldg16(kr + c * V, kv);
#pragma unroll
            for (int r = 0; r < G; ++r) {
              float qq[V];
              ld16f<V>(q + r * q_ld + V * c, qq);
#pragma unroll
              for (int e = V - 1; e >= 0; --e) dot[r] = fmaf(qq[e], kv[e], dot[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < G; ++r) s.p[r * TC + tt] = ok ? dot[r] * scale : NEG_INF;
      }
    } else {
      for (int i = tid; i < G * n; i += NT) {
        const int r = i / n;
        const int tt = i - r * n;
        const int row = s.aux[r * TC + tt];
        const float* qr = q + r * q_ld;
        float dot = 0.f;
        for (int c = 0; c < nv; ++c) {
          float kv[V], qq[V];
          if (row < 0) {
            ld16f<V>(src.own + r * 3 * hd + hd + c * V, kv);
          } else {
            ld16(src.k + (size_t)row * src.row_stride + (size_t)(t0 + tt) * src.t_stride + c * V, kv);
          }
          ld16f<V>(qr + V * c, qq);
#pragma unroll
          for (int e = V - 1; e >= 0; --e) dot = fmaf(qq[e], kv[e], dot);
        }
        s.p[r * TC + tt] = dot * scale;
      }
    }
    __syncthreads();

    // running max and sum, one warp per lane row
    for (int r = warp; r < G; r += NT / 32) {
      float* pr = s.p + r * TC;
      float mx = NEG_INF;
      for (int tt = lane; tt < n; tt += 32) mx = fmaxf(mx, pr[tt]);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int tt = lane; tt < n; tt += 32) {
        const float v = pr[tt];
        const float e = v != NEG_INF ? expf(v - m_new) : 0.f;
        pr[tt] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[r] = c;
        l[r] = l[r] * c + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // weighted sum of V: thread (qv, tg) owns V columns over positions tg + k * tgroups
    if (tg < tgroups) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float c = corr[r];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] *= c;
      }
      if (CROSS) {
        for (int tt = tg; tt < n; tt += tgroups) {
          if (!s.aux[tt]) continue;
          float vv[V];
          ldg16(src.v + (size_t)(t0 + tt) * src.t_stride + qv * V, vv);
#pragma unroll
          for (int r = 0; r < G; ++r) {
            const float p = round_to<T>(s.p[r * TC + tt]);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < G; ++r) {
          for (int tt = tg; tt < n; tt += tgroups) {
            const int row = s.aux[r * TC + tt];
            float vv[V];
            if (row < 0) {
              ld16f<V>(src.own + r * 3 * hd + 2 * hd + qv * V, vv);
            } else {
              ld16(src.v + (size_t)row * src.row_stride + (size_t)(t0 + tt) * src.t_stride + qv * V, vv);
            }
            const float p = round_to<T>(s.p[r * TC + tt]);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (tg < tgroups) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(s.red + (tg * G + r) * hd + V * qv + e) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += NT) {
    const int r = i / hd;
    float v = 0.f;
    for (int g = 0; g < tgroups; ++g) v += s.red[(g * G + r) * hd + (i - r * hd)];
    out[i] = normalize ? v / l[r] : v;
  }
  __syncthreads();
}

// The self caches as one CTA sees them: head column e of cache row `row`
// (a lane) at slot t is k[row * row_stride + t * t_stride + e]; k and v
// point at this head's column 0. K2: the (rows, L, D) caches (row_stride
// L D, t_stride D); K3: the head's own slice (lanes, max_len, hd).
template <typename T>
struct CacheView {
  T* k;
  T* v;
  size_t row_stride;
  int t_stride;
};

// What one layer of one cluster reads and writes besides its shared memory.
template <typename T>
struct LayerIO {
  const void* const* w;    // the 18 weights, in the enum's order: matrices T, vectors float
  CacheView<T> cache;      // written at slot pos (this CTA's columns of the cluster's lanes)
  int img_row0;            // cache row of the image's lane 0
  int lane0;               // image-local lane of the cluster's first row
  const int* lin;          // lineage row of the cluster's first lane (image-local parents), or nullptr
  int lin_stride;          // ints between two lanes' lineage rows
  const T* mem_k;          // the image's memory K/V (Tm, D) at column 0
  const T* mem_v;
  const float* mem_valid;  // the image's (Tm) 1/0
  int D, H, F, S, Tm, pos;
};

// One decoder layer on the G lane rows in s.x, in place, on the cluster's
// H x S CTAs (rank = head * S + part). wait_start: the first call after the
// kernel's cluster_arrive_relaxed(); it waits for every CTA of the cluster
// to have started before the first DSMEM store.
template <int G, typename T>
__device__ void cluster_layer(const cg::cluster_group& cluster, const Smem& s, const LayerIO<T>& io, bool wait_start) {
  const int D = io.D, H = io.H, F = io.F, S = io.S;
  const int ncta = H * S;
  const int rank = (int)cluster.block_rank();
  const int head = rank / S;
  const int part = rank - head * S;
  const int hd = D / H;
  const int sw = hd / S;      // this CTA's columns of a D-wide output: [cs, cs + sw)
  const int cs = rank * sw;   // = head * hd + part * sw
  const int c0 = head * hd;   // this head's columns
  const int fs = F / ncta;    // this CTA's FFN hidden columns: [rank * fs, (rank + 1) * fs)
  const int tid = threadIdx.x;
  auto mat = [&](int i) { return static_cast<const T*>(io.w[i]); };
  auto vec = [&](int i) { return static_cast<const float*>(io.w[i]); };
  const CacheView<T>& cv = io.cache;

  // 1. this CTA's q, k, v columns and its slice of cache slot pos; with S = 2
  //    the two halves of the head's q, k, v meet in both CTAs of the head
  float* qkv_own = S == 1 ? s.qkv : s.y;  // [G][3 sw]
  matvec_cols<G, T>(mat(QKV_W), 3 * D, cs, sw, D, 3 * sw, vec(QKV_B), s.x, D, D, qkv_own, 3 * sw, s.red, false,
                    true);
  for (int i = tid; i < G * sw; i += NT) {
    const int r = i / sw;
    const int e = i - r * sw;
    const size_t off = (size_t)(io.img_row0 + io.lane0 + r) * cv.row_stride + (size_t)io.pos * cv.t_stride +
                       part * sw + e;
    cv.k[off] = from_f32<T>(qkv_own[r * 3 * sw + sw + e]);
    cv.v[off] = from_f32<T>(qkv_own[r * 3 * sw + 2 * sw + e]);
  }
  if (wait_start) cluster_wait();  // every CTA of the cluster has started
  if (S > 1) {
    for (int seg = 0; seg < 3; ++seg)
      scatter_ranks<G>(cluster, head * S, S, s.y + seg * sw, 3 * sw, s.qkv, 3 * hd, seg * hd + part * sw, sw);
    cluster.sync();
  }

  // 2. head h's self-attention; each CTA sends its columns of it to every CTA
  HeadRows<T> self;
  self.k = cv.k;
  self.v = cv.v;
  self.lin = io.lin;
  self.own = s.qkv;
  self.row_stride = cv.row_stride;
  self.t_stride = cv.t_stride;
  self.lin_stride = io.lin_stride;
  self.img_row0 = io.img_row0;
  self.lane0 = io.lane0;
  self.pos = io.pos;
  self.hd = hd;
  attend_head<G, false, T>(s, s.qkv, 3 * hd, 0, io.pos + 1, self, nullptr, s.y, true);
  scatter_ranks<G>(cluster, 0, ncta, s.y + part * sw, hd, s.a, D, cs, sw);
  cluster.sync();

  // 3. out-projection columns of this CTA, exchanged; residual and LN1 on full rows
  matvec_cols<G, T>(mat(SO_W), D, cs, sw, 0, sw, vec(SO_B), s.a, D, D, s.y, sw, s.red, false);
  scatter_ranks<G>(cluster, 0, ncta, s.y, sw, s.t, D, cs, sw);
  cluster.sync();
  residual_ln<G>(s.x, s.t, vec(LN1_S), vec(LN1_B), D);

  // 4. cross-attention of head h over its columns of the image's memory; with
  //    S = 2 each CTA of the head takes half the positions, and the halves
  //    merge by their log-sum-exp in the order of the CTAs
  if (S == 1) {
    matvec_cols<G, T>(mat(CQ_W), D, c0, hd, 0, hd, vec(CQ_B), s.x, D, D, s.qkv, hd, s.red, false, true);
  } else {
    matvec_cols<G, T>(mat(CQ_W), D, cs, sw, 0, sw, vec(CQ_B), s.x, D, D, s.y, sw, s.red, false, true);
    scatter_ranks<G>(cluster, head * S, S, s.y, sw, s.qkv, hd, part * sw, sw);
    cluster.sync();
  }
  HeadRows<T> cross = self;
  cross.k = io.mem_k + c0;
  cross.v = io.mem_v + c0;
  cross.t_stride = D;
  const int per = (io.Tm + S - 1) / S;
  const int tb = min(io.Tm, part * per);
  attend_head<G, true, T>(s, s.qkv, hd, tb, min(io.Tm, tb + per), cross, io.mem_valid, s.y, S == 1);
  const float* ca = s.y + part * sw;  // this CTA's columns of the head output
  int ca_ld = hd;
  if (S > 1) {
    // (m, l, o) of this CTA's positions into slot `part` of both CTAs of the head
    const int slot = G * hd + 4 * G;
    for (int i = tid; i < S * (G * hd / 4 + G); i += NT) {
      const int q = head * S + i / (G * hd / 4 + G);
      const int j = i % (G * hd / 4 + G);
      float* dst = s.xo + part * slot;
      if (j < G * hd / 4) {
        *cluster.map_shared_rank(reinterpret_cast<float4*>(dst) + j, q) = reinterpret_cast<const float4*>(s.y)[j];
      } else {
        const int r = j - G * hd / 4;
        float* ml = cluster.map_shared_rank(dst + G * hd, q);
        ml[r] = s.stat[r];
        ml[G + r] = s.stat[G + r];
      }
    }
    cluster.sync();
    for (int i = tid; i < G * sw; i += NT) {
      const int r = i / sw;
      const int e = part * sw + (i - r * sw);
      float mx = NEG_INF;
      for (int p = 0; p < S; ++p) mx = fmaxf(mx, s.xo[p * slot + G * hd + r]);
      float lsum = 0.f, o = 0.f;
      for (int p = 0; p < S; ++p) {
        const float c = expf(s.xo[p * slot + G * hd + r] - mx);
        lsum += s.xo[p * slot + G * hd + G + r] * c;
        o += s.xo[p * slot + r * hd + e] * c;
      }
      s.t[i] = o / lsum;  // s.t is free until the next exchange writes it
    }
    __syncthreads();
    ca = s.t;
    ca_ld = sw;
  }
  scatter_ranks<G>(cluster, 0, ncta, ca, ca_ld, s.a, D, cs, sw);
  cluster.sync();

  // 5. out-projection, LN2
  matvec_cols<G, T>(mat(CO_W), D, cs, sw, 0, sw, vec(CO_B), s.a, D, D, s.y, sw, s.red, false);
  scatter_ranks<G>(cluster, 0, ncta, s.y, sw, s.t, D, cs, sw);
  cluster.sync();
  residual_ln<G>(s.x, s.t, vec(LN2_S), vec(LN2_B), D);

  // 6. FFN: this CTA's hidden slice, its partial of the output, reduce-scatter
  //    in CTA order, all-gather; residual and LN3
  matvec_cols<G, T>(mat(L1_W), F, rank * fs, fs, 0, fs, vec(L1_B), s.x, D, D, s.hid, fs, s.red, true);
  matvec_cols<G, T>(mat(L2_W) + (size_t)rank * fs * D, D, 0, D, 0, D, nullptr, s.hid, fs, fs, s.y, D, s.red, false);
  {
    const int n4 = sw >> 2;
    for (int i = tid; i < ncta * G * n4; i += NT) {
      const int q = i / (G * n4);
      const int j = i - q * G * n4;
      const int r = j / n4;
      const int e = 4 * (j - r * n4);
      const float4 v = *reinterpret_cast<const float4*>(s.y + r * D + q * sw + e);
      *cluster.map_shared_rank(reinterpret_cast<float4*>(s.part + (rank * G + r) * sw + e), q) = v;
    }
  }
  cluster.sync();
  for (int i = tid; i < G * sw; i += NT) {
    float v = 0.f;
    for (int q = 0; q < ncta; ++q) v += s.part[q * G * sw + i];
    s.y[i] = v + vec(L2_B)[cs + i % sw];
  }
  __syncthreads();
  scatter_ranks<G>(cluster, 0, ncta, s.y, sw, s.t, D, cs, sw);
  cluster.sync();
  residual_ln<G>(s.x, s.t, vec(LN3_S), vec(LN3_B), D);
}

}  // namespace dec
