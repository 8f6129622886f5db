// One post-LN decoder layer at one decode position, spread over the whole
// card: kernel K2's card route, for Hopper (sm_90a), float32, greedy rows.
//
// The same function as decoder_layer_step.cu (which replaces the JAX
// package's Pallas TPU kernel ops/pallas/decode_step.py::
// fused_decoder_layer_step) for a greedy decode batch of B <= 32 rows, one
// an image (one lane, no beam lineage): k and v written in place into the
// (B, L, D) self caches at slot `pos`, read from device memory (one int32)
// so that one captured launch serves every position of a CUDA graph's
// replays; self-attention over the row's own slots t <= pos;
// cross-attention over the row's image's memory K/V, masked by mem_valid;
// the out-projections, the ReLU FFN and the three residual LayerNorms.
//
// Its least time on the H100 is a matter of bytes: a launch must read the
// layer's weights (about 8.3 MB at D = 384, F = 1536), every image's memory
// K/V (2 x Tm x D floats an image) and the rows' cache prefixes; its FLOPs
// are tiny. The cluster route (decoder_layer_step.cu) runs one cluster of H
// CTAs per image, so each cluster reads all of the weights again, and a
// batch of more than 30 images takes two waves of clusters. This route reads
// each weight byte once per launch; what its launches cost in practice is
// their latency chains (below).
//
// Design: weight-stationary over the whole card, as a chain of seven
// launches on the caller's stream, each a phase that needs the one before
// complete:
//   1. proj   q | k | v = x Wqkv + b; k, v go to the caches at slot pos
//   2. self   (row, head): attention over the row's cache slots, then the
//             head's partial of the out-projection (its output times the
//             head's rows of Wso) for every column
//   3. cross  (row, head): x1 = LN1(x + (the heads' partials + bso)) of its
//             row, its cross q in this head's columns (x1 Wcq + b),
//             attention over the image's memory
//   4. proj   t = a Wco + b
//   5. proj   x2 = LN2(x1 + t) (every CTA, on full rows), h = ReLU(x2 W1 + b1)
//   6. proj   the partial sums of h W2 over 4 parts of h's 1536 columns
//   7. ln     out = LN3(x2 + (the parts' sum + b2)), a warp a row
// A projection CTA owns nc of the N output columns (geometry.k2_card_split:
// the fewest a CTA that keep the CTAs within the card's SMs; with inputs
// wider than 384, of one part of them), reads its slice of W exactly once
// per launch into shared memory, and applies it to every row of the batch,
// staged in shared memory. Within the CTA a warp carries 4 columns x 8 rows;
// the input dimension is split over its 32 lanes (and over `wpu` warps when
// the CTA has fewer than 12 units of 4 x 8), each lane summing its inputs in
// order, then the lanes by a butterfly of shuffles and the warps in order:
// no atomics, so the result is the same from run to run. An attention CTA
// takes one head of one row, in one pass: every logit in shared memory, each
// a thread's dot product over the key's 16-byte vectors loaded at once, the
// largest and the sum, then the weighted sum of V by groups of positions
// added in order. The self CTAs' partials of the out-projection are added
// over the heads in order by the cross CTAs, before LN1.
//
// What each launch costs is its chain of dependent steps, about 1 us each
// on the H100 (the launch, its inputs' reads, the products, the sums, the
// stores), whatever the batch: so the route pays where the cluster route
// needs a second wave (greedy batches of 31-32 images; geometry.k2_route).
//
// Ordering: stream order alone, no grid barrier, so the chain is safe beside
// kernels of other streams (the dispatch stage's encode) that hold SMs at
// the same time.
//
// Kernel names all hold `decoder_layer_step_kernel`, by which the benchmark
// and chip_smoke.py time K2.

#include <cuda_runtime.h>

#include "decoder_common.cuh"  // NT, NEG_INF, LN_EPS, the weight order, warp_sum, warp_max

namespace {

using namespace dec;

constexpr int WARPS = NT / 32;  // 12
constexpr int RT = 32;          // rows a launch takes at most, all staged at once
constexpr int RG = 8;           // rows a warp carries
constexpr int KC = 384;         // inputs a projection CTA stages (of one part), and a LayerNorm row, at most
constexpr int NC_MAX = 12;      // output columns a projection CTA owns at most
constexpr int WS_MAX = 6144;    // floats of a projection CTA's weight slice
constexpr int STAGE = RT * KC / 4 / NT;         // 16-byte loads a thread makes to stage the rows
constexpr int ROWS_A_WARP = (RT + WARPS - 1) / WARPS;  // rows a warp normalises

// out[r][c] = act(sum_k in[r][k] W[k][c] + bias[c]); with `add`, in is
// first LN(in + add) on full rows (K = D <= KC), written to ln_out too. With
// ksplit > 1 the K inputs split into ksplit parts of at most KC, CTA
// blockIdx.x = part x (N / nc) + slice, and part p writes its partial sum,
// without the bias, to out[0] + p B N (row stride N).
struct ProjArgs {
  const float* in;    // (B, K)
  const float* add;   // (B, K) or nullptr: no prologue
  const float* ln_s;  // (K) the prologue's LayerNorm
  const float* ln_b;
  float* ln_out;      // (B, K) the prologue's rows, row r written by CTA r % gridDim.x
  const float* w;     // (K, N)
  const float* bias;  // (N)
  float* out[3];      // column c -> out[c / seg_w][r * out_rs[c / seg_w] + c % seg_w]
  size_t out_rs[3];
  const int* pos;     // cache_out: segments 1 and 2 (k, v) start at slot *pos (t_stride seg_w)
  int cache_out, seg_w, B, K, N, nc, ksplit, relu;
};

// floats of a projection CTA's shared memory: its weight slice, bias slice and LayerNorm parameters, the warps'
// sums and the rows' inputs
__host__ __device__ inline size_t proj_smem_floats(int K, int nc, int ksplit) {
  return (size_t)(K / ksplit) * nc + NC_MAX + 2 * (size_t)KC + NT + (size_t)RT * KC;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// x[0..D) = LN(x) * s + b for one row held by a warp, lane-strided (d = lane + 32 j), in residual_ln's order
__device__ __forceinline__ void warp_layer_norm(float (&v)[KC / 32], int D, const float* s, const float* b) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < KC / 32; ++j)
    if (lane + 32 * j < D) sum += v[j];
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < KC / 32; ++j) {
    const float c = v[j] - mean;
    if (lane + 32 * j < D) sq = fmaf(c, c, sq);
  }
  const float var = warp_sum(sq) / (float)D;
  const float inv = 1.0f / sqrtf(var + LN_EPS);
#pragma unroll
  for (int j = 0; j < KC / 32; ++j) {
    const int d = lane + 32 * j;
    if (d < D) v[j] = (v[j] - mean) * inv * s[d] + b[d];
  }
}

__global__ void __launch_bounds__(NT, 2) decoder_layer_step_kernel_proj(const __grid_constant__ ProjArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nc = a.nc, nq = nc / 4, N = a.N, B = a.B;
  const int slices = N / nc;
  const int kpart = blockIdx.x / slices;
  const int K = a.K / a.ksplit;    // this CTA's inputs: [kpart K, (kpart + 1) K)
  const bool prologue = a.add != nullptr;
  float* ws = smem;                // [K][nc]
  float* bs = ws + (size_t)K * nc; // [NC_MAX]
  float* lns = bs + NC_MAX;        // [KC]
  float* lnb = lns + KC;           // [KC]
  float* red = lnb + KC;           // [WARPS][32] the warps' sums
  float* xs = red + NT;            // [RT][KC]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = (blockIdx.x - kpart * slices) * nc;

  // this CTA's slice of W, its bias and the LayerNorm's parameters
  const float* w = a.w + (size_t)kpart * K * N + c0;
#pragma unroll 4
  for (int i = tid; i < K * nq; i += NT) {
    const int k = i / nq;
    const int c = 4 * (i - k * nq);
    *reinterpret_cast<float4*>(ws + k * nc + c) = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * N + c));
  }
  if (tid < nc) bs[tid] = a.ksplit > 1 ? 0.f : a.bias[c0 + tid];
  if (prologue) {
    for (int d = tid; d < K; d += NT) {
      lns[d] = a.ln_s[d];
      lnb[d] = a.ln_b[d];
    }
  }
  const int slot = a.cache_out ? *a.pos : 0;
  float* out0 = a.out[0] + (size_t)kpart * B * N;

  // the rows' inputs (with the prologue, then its addend added), rows past B zero: every load of a pass in flight
  // at once
  const int ng = (B + RG - 1) / RG;
  const int n4 = K / 4;
  const float* in = a.in + (size_t)kpart * K;
  const int total = ng * RG * n4;
#pragma unroll 1
  for (int pass = 0; pass < (prologue ? 2 : 1); ++pass) {
    const float* src = pass == 0 ? in : a.add;
    float4 v[STAGE];
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int i = tid + j * NT;
      const int r = i / n4;
      v[j] = i < total && r < B ? *reinterpret_cast<const float4*>(src + (size_t)r * a.K + 4 * (i - r * n4))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < STAGE; ++j) {
      const int i = tid + j * NT;
      const int r = i / n4;
      float4* dst = reinterpret_cast<float4*>(xs + r * KC + 4 * (i - r * n4));
      if (i < total) *dst = pass == 0 ? v[j] : add4(*dst, v[j]);
    }
  }
  __syncthreads();
  if (prologue) {
    // x = LN(in + add) on the full rows (K <= KC), a warp the rows warp, warp + 12, warp + 24, together
    float v[ROWS_A_WARP][KC / 32];
#pragma unroll
    for (int h = 0; h < ROWS_A_WARP; ++h) {
      const int r = warp + h * WARPS;
#pragma unroll
      for (int j = 0; j < KC / 32; ++j) v[h][j] = r < B && lane + 32 * j < K ? xs[r * KC + lane + 32 * j] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < ROWS_A_WARP; ++h) warp_layer_norm(v[h], K, lns, lnb);
#pragma unroll
    for (int h = 0; h < ROWS_A_WARP; ++h) {
      const int r = warp + h * WARPS;
      if (r >= B) continue;
      const bool mine = r % gridDim.x == blockIdx.x;
#pragma unroll
      for (int j = 0; j < KC / 32; ++j) {
        const int d = lane + 32 * j;
        if (d < K) {
          xs[r * KC + d] = v[h][j];
          if (mine) a.ln_out[(size_t)r * K + d] = v[h][j];
        }
      }
    }
    __syncthreads();
  }

  const int units = nq * ng;  // <= 12: nc <= 12, B <= 32
  const int wpu = WARPS / units;
  const int u = warp / wpu;
  const int part = warp - u * wpu;
  const bool active = u < units;
  const int q = active ? u % nq : 0;
  const int g = active ? u / nq : 0;
  float acc[RG][4];
#pragma unroll
  for (int r = 0; r < RG; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  if (active) {
    const float* xg = xs + g * RG * KC;
#pragma unroll 4
    for (int kk = part * 32 + lane; kk < K; kk += 32 * wpu) {
      const float4 w4 = *reinterpret_cast<const float4*>(ws + kk * nc + 4 * q);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float xv = xg[r * KC + kk];
        acc[r][0] = fmaf(xv, w4.x, acc[r][0]);
        acc[r][1] = fmaf(xv, w4.y, acc[r][1]);
        acc[r][2] = fmaf(xv, w4.z, acc[r][2]);
        acc[r][3] = fmaf(xv, w4.w, acc[r][3]);
      }
    }
  }

  // the 32 lanes' sums of the warp's 32 outputs j = (row j / 4, column j % 4), each by a butterfly; lane j keeps
  // output j
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = warp_sum(acc[r][e]);
      if (lane == r * 4 + e) mine = v;
    }
  }
  if (active) red[warp * 32 + lane] = mine;
  __syncthreads();
  for (int i = tid; i < units * 32; i += NT) {
    const int uu = i >> 5;
    const int j = i & 31;
    const int r = (uu / nq) * RG + j / 4;
    if (r >= B) continue;
    float o = 0.f;
    for (int p = 0; p < wpu; ++p) o += red[(uu * wpu + p) * 32 + j];
    const int cl = 4 * (uu % nq) + (j & 3);
    o += bs[cl];
    if (a.relu) o = fmaxf(o, 0.f);
    const int c = c0 + cl;
    const int seg = c / a.seg_w;
    const int cc = c - seg * a.seg_w;
    float* dst = seg == 0 ? out0 : a.out[seg];
    const size_t at = (size_t)r * a.out_rs[seg] + (seg > 0 && a.cache_out ? (size_t)slot * a.seg_w : 0) + cc;
    dst[at] = o;
  }
}

// Attention of one head of one row: self over the row's cache slots, or
// cross over its image's memory. One pass: every logit in shared memory (a
// thread a position, the key's NV 16-byte vectors loaded at once), the
// maximum and the sum of the weights, then the weighted sum of V by TGN =
// NT / NV groups of positions (a thread a vector of columns, its group's
// positions loaded four at once), the groups added in order.
struct AttnArgs {
  const float* q;          // (B, D) self: the queries
  const float* wo;         // (D, D) self: Wso, whose rows of this head make the head's partial out-projection
  float* partial;          // (H, B, D) self: each head's partial out-projection; cross: read, summed over heads
  const float* self_k;     // (B, L, D), slot pos already written
  const float* self_v;
  const float* mem_k;      // (B, Tm, D)
  const float* mem_v;
  const float* mem_valid;  // (B, Tm) 1/0
  // cross: the row's x1 = LN1(x + (the heads' partials + bso)) and its cross q (x1 Wcq + bcq, this head's
  // columns) are made here
  const float* x;          // (B, D) the layer's input
  const float* bo;         // (D) bso
  const float* ln_s;       // (D) LN1
  const float* ln_b;
  const float* wq;         // (D, D) Wcq
  const float* bq;         // (D)
  float* x1;               // (B, D) written by each row's head-0 CTA
  float* out;              // (B, D)
  const int* pos;
  int B, D, H, L, Tm;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// floats of an attention CTA's shared memory: the query, n logits, the groups' partial sums (TGN x hd = 4 NT)
// and the statistics; self: this head's rows of Wso and its output; cross: this head's columns of Wcq and bcq,
// LN1's parameters and the row's x1
__host__ __device__ inline size_t attn_smem_floats(int hd, int n, int D, bool cross) {
  const size_t common = (size_t)hd + round4(n) + 4 * (size_t)NT + 4 * WARPS;
  return common + (cross ? (size_t)D * hd + hd + 3 * (size_t)D : (size_t)hd * D + hd);
}

// 16 bytes from global to shared memory, asynchronously (cp.async through L2), and the wait for all of them
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the largest (blockwide, all threads) or the sum in the order of the warps
__device__ __forceinline__ float block_max(float v, float* stat) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = stat[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, stat[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* stat) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) stat[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = stat[0];
  for (int w = 1; w < WARPS; ++w) r += stat[w];
  __syncthreads();
  return r;
}

// q . k over NV vectors, each vector's lanes from the last to the first (the cluster layer's order)
template <int NV>
__device__ __forceinline__ float dot(const float* qs, const float4 (&kv)[NV]) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const float4 q = *reinterpret_cast<const float4*>(qs + 4 * c);
    d = fmaf(q.w, kv[c].w, d);
    d = fmaf(q.z, kv[c].z, d);
    d = fmaf(q.y, kv[c].y, d);
    d = fmaf(q.x, kv[c].x, d);
  }
  return d;
}

template <int NV>
__global__ void __launch_bounds__(NT, 2) decoder_layer_step_kernel_self(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HD = 4 * NV, TGN = NT / NV;
  const int D = a.D, L = a.L, tid = threadIdx.x;
  const int row = blockIdx.x / a.H;
  const int head = blockIdx.x - row * a.H;
  float* qs = smem;              // [HD]
  float* p = qs + HD;            // [L] logits, then weights
  float* red = p + round4(L);    // [TGN][HD]
  float* stat = red + TGN * HD;  // [4 WARPS]
  float* wo = stat + 4 * WARPS;  // [HD][D] this head's rows of Wso
  float* ob = wo + HD * D;       // [HD] the head's attention output
  const float* wrows = a.wo + (size_t)head * HD * D;  // contiguous: HD rows of D
  for (int i = tid; i < HD * D / 4; i += NT) copy16(wo + 4 * i, wrows + 4 * i);
  const int pos = *a.pos;
  const int n = pos + 1;
  if (tid < NV)
    reinterpret_cast<float4*>(qs)[tid] = *reinterpret_cast<const float4*>(a.q + (size_t)row * D + head * HD + 4 * tid);
  copies_wait();
  __syncthreads();
  const float scale = 1.0f / sqrtf((float)HD);
  const float* kb = a.self_k + (size_t)row * L * D + head * HD;
  float mx = NEG_INF;
  for (int t = tid; t < n; t += NT) {
    const float4* kr = reinterpret_cast<const float4*>(kb + (size_t)t * D);
    float4 kv[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) kv[c] = kr[c];
    p[t] = dot<NV>(qs, kv) * scale;
    mx = fmaxf(mx, p[t]);
  }
  const float m = block_max(mx, stat);
  float sum = 0.f;
  for (int t = tid; t < n; t += NT) {
    const float e = expf(p[t] - m);
    p[t] = e;
    sum += e;
  }
  const float l = block_sum(sum, stat);  // also orders the weights' stores before the reads below
  const int qv = tid % NV;
  const int tg = tid / NV;
  const float* vb = a.self_v + (size_t)row * L * D + head * HD + 4 * qv;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = tg; t0 < n; t0 += 4 * TGN) {
    float4 v[4];
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j * TGN;
      w[j] = t < n ? p[t] : 0.f;
      v[j] = t < n ? *reinterpret_cast<const float4*>(vb + (size_t)t * D) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc.x = fmaf(w[j], v[j].x, acc.x);
      acc.y = fmaf(w[j], v[j].y, acc.y);
      acc.z = fmaf(w[j], v[j].z, acc.z);
      acc.w = fmaf(w[j], v[j].w, acc.w);
    }
  }
  *reinterpret_cast<float4*>(red + tg * HD + 4 * qv) = acc;
  __syncthreads();
  for (int e = tid; e < HD; e += NT) {
    float o = 0.f;
    for (int g = 0; g < TGN; ++g) o += red[g * HD + e];
    ob[e] = o / l;
  }
  __syncthreads();
  // this head's partial of the out-projection: its output times its HD rows of Wso, for every column
  float* part = a.partial + ((size_t)head * a.B + row) * D;
  for (int e = tid; e < D; e += NT) {
    float o = 0.f;
    for (int c = 0; c < HD; ++c) o = fmaf(ob[c], wo[c * D + e], o);
    part[e] = o;
  }
}

template <int NV>
__global__ void __launch_bounds__(NT, 2) decoder_layer_step_kernel_cross(const __grid_constant__ AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HD = 4 * NV, TGN = NT / NV;
  const int D = a.D, Tm = a.Tm, tid = threadIdx.x, tm4 = round4(Tm);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x / a.H;  // greedy: a row is an image
  const int head = blockIdx.x - row * a.H;
  float* qs = smem;              // [HD]
  float* p = qs + HD;            // [tm4] logits, then weights
  float* red = p + tm4;          // [TGN][HD]
  float* stat = red + TGN * HD;  // [4 WARPS]: the sum of the weights
  float* wq = stat + 4 * WARPS;  // [D][HD] this head's columns of Wcq
  float* bq = wq + D * HD;       // [HD]
  float* lns = bq + HD;          // [D]
  float* lnb = lns + D;          // [D]
  float* xr = lnb + D;           // [D] the row's x1
  const float* valid = a.mem_valid + (size_t)row * Tm;
  // this head's columns of Wcq, its bias and LN1's parameters
  for (int i = tid; i < D * NV; i += NT) {
    const int k = i / NV;
    const int c = 4 * (i - k * NV);
    copy16(wq + k * HD + c, a.wq + (size_t)k * D + head * HD + c);
  }
  for (int i = tid; i < HD; i += NT) bq[i] = a.bq[head * HD + i];
  for (int d = tid; d < D; d += NT) {
    lns[d] = a.ln_s[d];
    lnb[d] = a.ln_b[d];
  }
  // x1 = LN1(x + (the heads' partials + bso)): the sums by every thread, an element each, the LayerNorm by one
  // warp; the head-0 CTA writes it out
  for (int d = tid; d < D; d += NT) {
    const float* pr = a.partial + (size_t)row * D + d;
    float t = 0.f;
#pragma unroll 8
    for (int h = 0; h < a.H; ++h) t += pr[(size_t)h * a.B * D];
    xr[d] = a.x[(size_t)row * D + d] + (t + a.bo[d]);
  }
  __syncthreads();  // x1's sums and LN1's parameters are in shared memory
  if (warp == 0) {
    float v[KC / 32];
#pragma unroll
    for (int j = 0; j < KC / 32; ++j) v[j] = lane + 32 * j < D ? xr[lane + 32 * j] : 0.f;
    warp_layer_norm(v, D, lns, lnb);
#pragma unroll
    for (int j = 0; j < KC / 32; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        xr[d] = v[j];
        if (head == 0) a.x1[(size_t)row * D + d] = v[j];
      }
    }
  }
  copies_wait();
  __syncthreads();
  // the row's cross q in this head's columns: 8 lanes an output, each summing every 8th input, then their
  // butterfly, then the bias
  for (int i = tid; i < HD * 8; i += NT) {
    const int c = i >> 3;
    const int s = i & 7;
    float acc = 0.f;
    for (int k = s; k < D; k += 8) acc = fmaf(xr[k], wq[k * HD + c], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (s == 0) qs[c] = acc + bq[c];
  }
  __syncthreads();
  const float scale = 1.0f / sqrtf((float)HD);
  const float* kb = a.mem_k + (size_t)row * Tm * D + head * HD;
  for (int t = tid; t < Tm; t += NT) {
    const bool ok = valid[t] > 0.f;
    float d = 0.f;
    if (ok) {
      const float4* kr = reinterpret_cast<const float4*>(kb + (size_t)t * D);
      float4 kv[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) kv[c] = __ldg(kr + c);
      d = dot<NV>(qs, kv);
    }
    p[t] = ok ? d * scale : NEG_INF;
  }
  __syncthreads();
  // the largest logit and the sum of the weights, by one warp
  if (warp == 0) {
    float mx = NEG_INF;
    for (int t = lane; t < Tm; t += 32) mx = fmaxf(mx, p[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < Tm; t += 32) {
      const float e = p[t] != NEG_INF ? expf(p[t] - mx) : 0.f;
      p[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) stat[0] = sum;
  }
  __syncthreads();
  const int qv = tid % NV;
  const int tg = tid / NV;
  const float* vb = a.mem_v + (size_t)row * Tm * D + head * HD + 4 * qv;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = tg; t0 < Tm; t0 += 4 * TGN) {
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j * TGN;
      v[j] = t < Tm && valid[t] > 0.f ? __ldg(reinterpret_cast<const float4*>(vb + (size_t)t * D))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j * TGN;
      if (t >= Tm) break;
      const float w = p[t];
      acc.x = fmaf(w, v[j].x, acc.x);
      acc.y = fmaf(w, v[j].y, acc.y);
      acc.z = fmaf(w, v[j].z, acc.z);
      acc.w = fmaf(w, v[j].w, acc.w);
    }
  }
  *reinterpret_cast<float4*>(red + tg * HD + 4 * qv) = acc;
  __syncthreads();
  for (int e = tid; e < HD; e += NT) {
    float o = 0.f;
    for (int g = 0; g < TGN; ++g) o += red[g * HD + e];
    a.out[(size_t)row * D + head * HD + e] = o / stat[0];
  }
}

// out = LN(x + t), t the sum of `parts` partial sums in order plus the bias, a warp a row (D <= KC)
struct LnArgs {
  const float* x;     // (B, D)
  const float* part;  // (parts, B, D)
  const float* bias;  // (D)
  const float* ln_s;
  const float* ln_b;
  float* out;
  int B, D, parts;
};

__global__ void __launch_bounds__(NT, 2) decoder_layer_step_kernel_ln(const __grid_constant__ LnArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int D = a.D;
  if (row >= a.B) return;
  float v[KC / 32], t[KC / 32];
#pragma unroll
  for (int j = 0; j < KC / 32; ++j) t[j] = 0.f;
  for (int p = 0; p < a.parts; ++p) {
    const float* pr = a.part + ((size_t)p * a.B + row) * D;
#pragma unroll
    for (int j = 0; j < KC / 32; ++j)
      if (lane + 32 * j < D) t[j] += pr[lane + 32 * j];
  }
  const float* xr = a.x + (size_t)row * D;
#pragma unroll
  for (int j = 0; j < KC / 32; ++j)
    v[j] = lane + 32 * j < D ? xr[lane + 32 * j] + (t[j] + a.bias[lane + 32 * j]) : 0.f;
  warp_layer_norm(v, D, a.ln_s, a.ln_b);
  float* orow = a.out + (size_t)row * D;
#pragma unroll
  for (int j = 0; j < KC / 32; ++j)
    if (lane + 32 * j < D) orow[lane + 32 * j] = v[j];
}

template <typename Args>
cudaError_t launch(void (*kernel)(Args), const Args& a, int grid, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

cudaError_t launch_proj(ProjArgs a, cudaStream_t stream) {
  const int grid = a.N / a.nc * a.ksplit;
  return launch(decoder_layer_step_kernel_proj, a, grid, proj_smem_floats(a.K, a.nc, a.ksplit) * sizeof(float),
                stream);
}

// the attention of either kind for heads of 4 NV columns (NV 8, 12 or 16), a CTA a (row, head)
cudaError_t launch_attention(const AttnArgs& a, bool cross, cudaStream_t stream) {
  const int hd = a.D / a.H;
  const int grid = a.B * a.H;
  const size_t smem = attn_smem_floats(hd, cross ? a.Tm : a.L, a.D, cross) * sizeof(float);
  switch (hd / 4) {
    case 8:
      return cross ? launch(decoder_layer_step_kernel_cross<8>, a, grid, smem, stream)
                   : launch(decoder_layer_step_kernel_self<8>, a, grid, smem, stream);
    case 12:
      return cross ? launch(decoder_layer_step_kernel_cross<12>, a, grid, smem, stream)
                   : launch(decoder_layer_step_kernel_self<12>, a, grid, smem, stream);
    default:
      return cross ? launch(decoder_layer_step_kernel_cross<16>, a, grid, smem, stream)
                   : launch(decoder_layer_step_kernel_self<16>, a, grid, smem, stream);
  }
}

bool cols_ok(int N, int K, int nc, int ks) {
  return nc >= 4 && nc <= NC_MAX && nc % 4 == 0 && N % nc == 0 && ks >= 1 && K % ks == 0 && (K / ks) % 4 == 0 &&
         K / ks <= KC && (K / ks) * nc <= WS_MAX;
}

// Bytes of shared memory of the largest CTA: a projection of K inputs in ksplit parts to nc columns, or an
// attention CTA over heads of hd columns and L cache slots or Tm memory positions.
size_t smem_bytes(int K, int nc, int ksplit, int D, int hd, int L, int Tm) {
  size_t n = proj_smem_floats(K, nc, ksplit);
  const size_t self = attn_smem_floats(hd, L, D, false), cross = attn_smem_floats(hd, Tm, D, true);
  n = self > n ? self : n;
  n = cross > n ? cross : n;
  return n * sizeof(float);
}

}  // namespace

// ptrs: x, self_k, self_v, mem_k, mem_v, mem_valid, the 18 layer weights in layer_weights order, x_out, scratch
// (B x (5 D + F + ksplit[3] D + H D) floats). B greedy rows, one an image, at most 32. split: the columns a CTA
// owns in the four projections (qkv, co, l1, l2), then the parts their inputs split into (1 but for the FFN's
// second weight; geometry.k2_card_split). pos: a device int32, 0 <= pos < L, which the caller checks. Contiguous
// float32 device pointers, 16-byte aligned; D <= 384, heads of 32, 48 or 64 columns. Returns a cudaError_t, the
// first of the seven launches'.
extern "C" int decoder_layer_card_launch(void* const* ptrs, const int* pos, const int* split, int B, int D, int H,
                                         int F, int L, int Tm, void* stream_ptr) {
  const int hd = H > 0 ? D / H : 0;
  const int* cols = split;
  const int* ks = split + 4;
  const int ns[4] = {3 * D, D, F, D};
  const int kin[4] = {D, D, D, F};
  bool ok = B >= 1 && B <= RT && H >= 1 && D % H == 0 && (hd == 32 || hd == 48 || hd == 64) && D <= KC &&
            D % 4 == 0 && F % 4 == 0 && Tm >= 1 && L >= 1 && pos != nullptr;
  for (int i = 0; i < 4 && ok; ++i)
    ok = cols_ok(ns[i], kin[i], cols[i], ks[i]) && (ks[i] == 1 || i == 3) &&
         smem_bytes(kin[i], cols[i], ks[i], D, hd, L, Tm) <= 232448;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto f = [&](int i) { return static_cast<float*>(ptrs[i]); };
  auto w = [&](int i) { return static_cast<const float*>(ptrs[6 + i]); };
  const float* x = f(0);
  float* scratch = f(7 + N_WEIGHTS);
  const size_t bd = (size_t)B * D;
  float* q = scratch;                  // q
  float* att = q + bd;                 // the cross-attention's output
  float* t = att + bd;                 // the cross out-projection's output
  float* x1 = t + bd;
  float* x2 = x1 + bd;
  float* hid = x2 + bd;                // (B, F)
  float* parts = hid + (size_t)B * F;  // (ksplit, B, D) the FFN output's partial sums
  float* sop = parts + ks[3] * bd;     // (H, B, D) the heads' partials of the self out-projection

  ProjArgs p = {};
  p.pos = pos;
  p.B = B;
  p.K = D;
  p.N = D;
  p.seg_w = D;
  p.out_rs[0] = D;
  p.ksplit = 1;
  cudaError_t err;
  // 1. q | k | v, k and v into the caches at slot pos
  ProjArgs qkv = p;
  qkv.in = x;
  qkv.w = w(QKV_W);
  qkv.bias = w(QKV_B);
  qkv.N = 3 * D;
  qkv.nc = cols[0];
  qkv.out[0] = q;
  qkv.out[1] = f(1);
  qkv.out[2] = f(2);
  qkv.out_rs[1] = qkv.out_rs[2] = (size_t)L * D;
  qkv.cache_out = 1;
  if ((err = launch_proj(qkv, stream)) != cudaSuccess) return (int)err;
  // 2. self-attention, and each head's partial of the self out-projection
  AttnArgs at = {};
  at.q = q;
  at.wo = w(SO_W);
  at.partial = sop;
  at.self_k = f(1);
  at.self_v = f(2);
  at.mem_k = f(3);
  at.mem_v = f(4);
  at.mem_valid = f(5);
  at.x = x;
  at.bo = w(SO_B);
  at.ln_s = w(LN1_S);
  at.ln_b = w(LN1_B);
  at.wq = w(CQ_W);
  at.bq = w(CQ_B);
  at.x1 = x1;
  at.out = att;
  at.pos = pos;
  at.B = B;
  at.D = D;
  at.H = H;
  at.L = L;
  at.Tm = Tm;
  if ((err = launch_attention(at, false, stream)) != cudaSuccess) return (int)err;
  // 3. x1 = LN1(x + (the heads' partials + bso)), the cross q and the cross-attention
  if ((err = launch_attention(at, true, stream)) != cudaSuccess) return (int)err;
  // 4. the cross out-projection
  ProjArgs co = p;
  co.in = att;
  co.w = w(CO_W);
  co.bias = w(CO_B);
  co.nc = cols[1];
  co.out[0] = t;
  if ((err = launch_proj(co, stream)) != cudaSuccess) return (int)err;
  // 5. x2 = LN2(x1 + t), the FFN's hidden
  ProjArgs l1 = p;
  l1.in = x1;
  l1.add = t;
  l1.ln_s = w(LN2_S);
  l1.ln_b = w(LN2_B);
  l1.ln_out = x2;
  l1.w = w(L1_W);
  l1.bias = w(L1_B);
  l1.N = F;
  l1.nc = cols[2];
  l1.relu = 1;
  l1.seg_w = F;
  l1.out[0] = hid;
  l1.out_rs[0] = F;
  if ((err = launch_proj(l1, stream)) != cudaSuccess) return (int)err;
  // 6. the FFN's output, in ksplit partial sums without its bias
  ProjArgs l2 = p;
  l2.in = hid;
  l2.K = F;
  l2.w = w(L2_W);
  l2.bias = w(L2_B);
  l2.nc = cols[3];
  l2.ksplit = ks[3];
  l2.out[0] = parts;
  if ((err = launch_proj(l2, stream)) != cudaSuccess) return (int)err;
  // 7. out = LN3(x2 + (the partial sums + b2))
  LnArgs ln = {x2, parts, w(L2_B), w(LN3_S), w(LN3_B), f(6 + N_WEIGHTS), B, D, ks[3]};
  return (int)launch(decoder_layer_step_kernel_ln, ln, (B + WARPS - 1) / WARPS, 0, stream);
}
