// One post-LN decoder layer at one decode position, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas/decode_step.py::fused_decoder_layer_step. For the
// B = images x K lanes of a decode batch, in one launch:
//   1. packed self-QKV projection of x (B, D);
//   2. k, v written into the (B, L, D) self caches at slot `pos`, in place;
//   3. self-attention over slots t <= pos, each slot read through the
//      image-local beam lineage: k_read[b, t] = k[img*K + lin[b, t], t]
//      (slot pos reads the lane's own new k, v); greedy runs without lineage;
//   4. out-projection, residual, LayerNorm 1;
//   5. cross-attention of every lane over its image's single memory K/V
//      (Tm, D), masked by mem_valid;
//   6. out-projection, residual, LayerNorm 2;
//   7. ReLU FFN D -> F -> D, residual, LayerNorm 3.
// Softmax and all sums are f32. Slots t > pos are masked in the reference,
// so the kernel reads only t <= pos; that is the same function.
//
// What bounds it on the H100: bytes. Per launch it must read the layer's
// weights (about 8.3 MB in f32 at D = 384, F = 1536), the lanes' K/V prefixes
// and each image's memory K/V (2 x Tm x D x 4 bytes, 12.6 MB per image at
// Tm = 4096); its FLOPs are tiny. The design keeps every activation on chip
// and reads each memory K/V tile once per image for all K lanes.
//
// Design: one CTA per image; its K lanes share one pass over the memory K/V.
//   - Every matrix-vector product runs in this kernel: thread q owns four
//     output columns (float4 loads of a weight row) for all K lanes, and for
//     narrow outputs the input dimension is split over thread groups whose
//     partial sums are added in a fixed order. Weights come from global
//     memory; one layer's weights stay in the 50 MB L2 for all CTAs.
//   - Attention (self and cross) is one online-softmax routine over tiles of
//     32 positions staged in shared memory (rows padded to D + 1 floats so
//     that the per-head dot products are free of bank conflicts). The one
//     routine covers Tm from 32 to 4096, which the TPU kernel split into a
//     resident and a streaming path.
//   - LayerNorm is one warp per lane row.
// Reading the weights once per CTA is the known cost of this first design.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 384;   // threads per CTA
constexpr int TT = 32;    // positions per attention tile (one per warp lane)
constexpr float NEG_INF = -1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr int N_WEIGHTS = 18;

// weight order (the JAX package's layer_weights fields)
enum {
  QKV_W, QKV_B, SO_W, SO_B, LN1_S, LN1_B, CQ_W, CQ_B, CO_W, CO_B,
  LN2_S, LN2_B, L1_W, L1_B, L2_W, L2_B, LN3_S, LN3_B
};

struct Args {
  const float* x;          // (B, D)
  float* self_k;           // (B, L, D), written at slot pos
  float* self_v;           // (B, L, D)
  const float* mem_k;      // (n_img, Tm, D)
  const float* mem_v;      // (n_img, Tm, D)
  const float* mem_valid;  // (n_img, Tm) 1/0
  const int* lineage;      // (B, lin_stride) image-local parents, or nullptr
  const float* w[N_WEIGHTS];
  float* x_out;            // (B, D)
  int D, H, F, L, Tm, pos, lin_stride;
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

// out[r][j] = bias[j] + sum_k in[r][k] * W[k][j] (optionally ReLU), for the K
// rows r. W is (kin, n) row-major, n % 4 == 0. red holds the partial sums of
// the split-k groups.
template <int K>
__device__ void matvec(const float* __restrict__ W, const float* __restrict__ bias,
                       const float* in, int in_ld, int kin, int n, float* out, int out_ld,
                       float* red, bool relu) {
  const int nq = n >> 2;
  int groups = NT / nq;
  if (groups < 1) groups = 1;
  const int tid = threadIdx.x;
  if (groups == 1) {
    for (int q = tid; q < nq; q += NT) {
      float4 acc[K];
#pragma unroll
      for (int r = 0; r < K; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = 0; k < kin; ++k) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * n) + q);
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const float a = in[r * in_ld + k];
          acc[r].x = fmaf(a, w.x, acc[r].x);
          acc[r].y = fmaf(a, w.y, acc[r].y);
          acc[r].z = fmaf(a, w.z, acc[r].z);
          acc[r].w = fmaf(a, w.w, acc[r].w);
        }
      }
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + q);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        float4 v = make_float4(acc[r].x + b.x, acc[r].y + b.y, acc[r].z + b.z, acc[r].w + b.w);
        if (relu) {
          v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f); v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
        }
        float* o = out + r * out_ld + 4 * q;
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
      }
    }
    __syncthreads();
    return;
  }
  const int kchunk = (kin + groups - 1) / groups;
  if (tid < groups * nq) {
    const int g = tid / nq;
    const int q = tid - g * nq;
    const int k0 = g * kchunk;
    const int k1 = min(kin, k0 + kchunk);
    float4 acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * n) + q);
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float a = in[r * in_ld + k];
        acc[r].x = fmaf(a, w.x, acc[r].x);
        acc[r].y = fmaf(a, w.y, acc[r].y);
        acc[r].z = fmaf(a, w.z, acc[r].z);
        acc[r].w = fmaf(a, w.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      float* p = red + (g * K + r) * n + 4 * q;
      p[0] = acc[r].x; p[1] = acc[r].y; p[2] = acc[r].z; p[3] = acc[r].w;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * n; i += NT) {
    const int r = i / n;
    const int j = i - r * n;
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[(g * K + r) * n + j];
    float v = s + bias[j];
    if (relu) v = fmaxf(v, 0.f);
    out[r * out_ld + j] = v;
  }
  __syncthreads();
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

// Shared-memory scratch of the attention routine.
struct AttnSmem {
  float* kt;     // [TT][D + 1]
  float* vt;     // [TT][D + 1]
  float* p;      // [K][H][TT]
  float* m;      // [K][H]
  float* l;      // [K][H]
  float* corr;   // [K][H]
};

// Where the K and V rows of position t come from.
struct RowSource {
  // self-attention of one lane: lineage-gathered cache rows, slot pos from smem
  const float* self_k;
  const float* self_v;
  const int* lin;        // lineage row of this lane, or nullptr
  const float* own_k;    // this lane's new k, v (shared memory)
  const float* own_v;
  int img_row0, lane, L, pos;
  // cross-attention: the image's memory rows
  const float* mem_k;
  const float* mem_v;
  bool cross;

  __device__ void rows(int t, int D, const float*& kr, const float*& vr) const {
    if (cross) {
      kr = mem_k + (size_t)t * D;
      vr = mem_v + (size_t)t * D;
    } else if (t == pos) {
      kr = own_k;
      vr = own_v;
    } else {
      const int src = lin ? lin[t] : lane;
      const size_t off = ((size_t)(img_row0 + src) * L + t) * D;
      kr = self_k + off;
      vr = self_v + off;
    }
  }
};

// out[r] = softmax_t(q[r] . k_t / sqrt(hd)) @ v_t per head, for nq query rows
// sharing one set of positions 0..T-1, as an online softmax over TT-position
// tiles. valid (optional): 1/0 per position.
__device__ void attend(const float* q, int q_ld, int nq, int T, const RowSource& src,
                       const float* __restrict__ valid, float* out, const AttnSmem& sm, int D,
                       int H) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hd = D / H;
  const int dp = D + 1;
  const int d4 = D >> 2;
  const float scale = 1.0f / sqrtf((float)hd);

  for (int i = tid; i < nq * H; i += NT) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.f;
  }
  for (int i = tid; i < nq * D; i += NT) out[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int n = min(TT, T - t0);
    for (int idx = tid; idx < TT * d4; idx += NT) {
      const int tt = idx / d4;
      const int c = idx - tt * d4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (tt < n) {
        const float* kr;
        const float* vr;
        src.rows(t0 + tt, D, kr, vr);
        kv = reinterpret_cast<const float4*>(kr)[c];
        vv = reinterpret_cast<const float4*>(vr)[c];
      }
      float* kd = sm.kt + tt * dp + 4 * c;
      float* vd = sm.vt + tt * dp + 4 * c;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    // logits, position fastest so that a warp covers one (row, head)
    for (int i = tid; i < nq * H * TT; i += NT) {
      const int tt = i % TT;
      const int rh = i / TT;
      const int h = rh % H;
      const int r = rh / H;
      const float* qr = q + r * q_ld + h * hd;
      const float* kr = sm.kt + tt * dp + h * hd;
      float s = 0.f;
      for (int e = 0; e < hd; ++e) s = fmaf(qr[e], kr[e], s);
      const bool ok = tt < n && (valid == nullptr || valid[t0 + tt] > 0.f);
      sm.p[i] = ok ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax update, one warp per (row, head); lane = position
    for (int rh = warp; rh < nq * H; rh += NT / 32) {
      const float v = sm.p[rh * TT + lane];
      const bool ok = v != NEG_INF;
      const float m_old = sm.m[rh];
      const float m_new = fmaxf(m_old, warp_max(v));
      const float e = ok ? expf(v - m_new) : 0.f;
      const float sum = warp_sum(e);
      sm.p[rh * TT + lane] = e;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sm.corr[rh] = corr;
        sm.l[rh] = sm.l[rh] * corr + sum;
        sm.m[rh] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < nq * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      const int rh = r * H + d / hd;
      const float* pr = sm.p + rh * TT;
      float acc = out[i] * sm.corr[rh];
      for (int tt = 0; tt < n; ++tt) acc = fmaf(pr[tt], sm.vt[tt * dp + d], acc);
      out[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < nq * D; i += NT) {
    const int r = i / D;
    out[i] = out[i] / sm.l[r * H + (i - r * D) / hd];
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(NT) decoder_layer_step_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D, H = a.H, F = a.F;
  const int img = blockIdx.x;
  const int row0 = img * K;
  const int tid = threadIdx.x;

  float* x_s = smem;             // [K][D] residual stream
  float* q_s = x_s + K * D;      // [K][3D] self q, k, v; later the cross q
  float* a_s = q_s + K * 3 * D;  // [K][D] attention output
  float* t_s = a_s + K * D;      // [K][D] projection output
  float* h_s = t_s + K * D;      // [K][F] FFN hidden
  float* red = h_s + K * F;      // [K][4 * NT] split-k partial sums
  AttnSmem sm;
  sm.kt = red + K * 4 * NT;
  sm.vt = sm.kt + TT * (D + 1);
  sm.p = sm.vt + TT * (D + 1);
  sm.m = sm.p + K * H * TT;
  sm.l = sm.m + K * H;
  sm.corr = sm.l + K * H;

  for (int i = tid; i < K * D; i += NT) x_s[i] = a.x[(size_t)row0 * D + i];
  __syncthreads();

  // 1. packed self-QKV
  matvec<K>(a.w[QKV_W], a.w[QKV_B], x_s, D, D, 3 * D, q_s, 3 * D, red, false);

  // 2. cache write at slot pos (the self-attention below reads slot pos
  //    from shared memory, so no other thread depends on these stores)
  for (int i = tid; i < K * D; i += NT) {
    const int r = i / D;
    const int d = i - r * D;
    const size_t off = ((size_t)(row0 + r) * a.L + a.pos) * D + d;
    a.self_k[off] = q_s[r * 3 * D + D + d];
    a.self_v[off] = q_s[r * 3 * D + 2 * D + d];
  }

  // 3. self-attention, one lane at a time over its lineage-gathered prefix
  for (int r = 0; r < K; ++r) {
    RowSource src;
    src.self_k = a.self_k;
    src.self_v = a.self_v;
    src.lin = a.lineage ? a.lineage + (size_t)(row0 + r) * a.lin_stride : nullptr;
    src.own_k = q_s + r * 3 * D + D;
    src.own_v = q_s + r * 3 * D + 2 * D;
    src.img_row0 = row0;
    src.lane = r;
    src.L = a.L;
    src.pos = a.pos;
    src.mem_k = nullptr;
    src.mem_v = nullptr;
    src.cross = false;
    attend(q_s + r * 3 * D, 3 * D, 1, a.pos + 1, src, nullptr, a_s + r * D, sm, D, H);
  }

  // 4. out-projection, residual, LN1
  matvec<K>(a.w[SO_W], a.w[SO_B], a_s, D, D, D, t_s, D, red, false);
  residual_ln<K>(x_s, t_s, a.w[LN1_S], a.w[LN1_B], D);

  // 5. cross-attention: all K lanes over the image's memory
  matvec<K>(a.w[CQ_W], a.w[CQ_B], x_s, D, D, D, q_s, D, red, false);
  {
    RowSource src;
    src.self_k = nullptr;
    src.self_v = nullptr;
    src.lin = nullptr;
    src.own_k = nullptr;
    src.own_v = nullptr;
    src.img_row0 = row0;
    src.lane = 0;
    src.L = a.L;
    src.pos = -1;
    src.mem_k = a.mem_k + (size_t)img * a.Tm * D;
    src.mem_v = a.mem_v + (size_t)img * a.Tm * D;
    src.cross = true;
    attend(q_s, D, K, a.Tm, src, a.mem_valid + (size_t)img * a.Tm, a_s, sm, D, H);
  }

  // 6. out-projection, residual, LN2
  matvec<K>(a.w[CO_W], a.w[CO_B], a_s, D, D, D, t_s, D, red, false);
  residual_ln<K>(x_s, t_s, a.w[LN2_S], a.w[LN2_B], D);

  // 7. ReLU FFN, residual, LN3
  matvec<K>(a.w[L1_W], a.w[L1_B], x_s, D, D, F, h_s, F, red, true);
  matvec<K>(a.w[L2_W], a.w[L2_B], h_s, F, F, D, t_s, D, red, false);
  residual_ln<K>(x_s, t_s, a.w[LN3_S], a.w[LN3_B], D);

  for (int i = tid; i < K * D; i += NT) a.x_out[(size_t)row0 * D + i] = x_s[i];
}

size_t smem_bytes(int K, int D, int H, int F) {
  const size_t floats = (size_t)K * D * 6 + (size_t)K * F + (size_t)K * 4 * NT +
                        2 * (size_t)TT * (D + 1) + (size_t)K * H * TT + 3 * (size_t)K * H;
  return floats * sizeof(float);
}

template <int K>
cudaError_t launch(const Args& a, int n_img, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, a.D, a.H, a.F);
  cudaError_t err = cudaFuncSetAttribute(decoder_layer_step_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decoder_layer_step_kernel<K><<<n_img, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decoder_layer_step_smem_bytes(int lanes, int D, int H, int F) {
  return (int)smem_bytes(lanes, D, H, F);
}

// ptrs: x, self_k, self_v, mem_k, mem_v, mem_valid, lineage (may be null),
// the 18 layer weights in layer_weights order, x_out. Contiguous f32 (int32
// lineage) device pointers, 16-byte aligned. Returns a cudaError_t.
extern "C" int decoder_layer_step_launch(void* const* ptrs, int n_img, int lanes, int D, int H,
                                         int F, int L, int Tm, int pos, int lin_stride,
                                         void* stream) {
  Args a;
  a.x = static_cast<const float*>(ptrs[0]);
  a.self_k = static_cast<float*>(ptrs[1]);
  a.self_v = static_cast<float*>(ptrs[2]);
  a.mem_k = static_cast<const float*>(ptrs[3]);
  a.mem_v = static_cast<const float*>(ptrs[4]);
  a.mem_valid = static_cast<const float*>(ptrs[5]);
  a.lineage = static_cast<const int*>(ptrs[6]);
  for (int i = 0; i < N_WEIGHTS; ++i) a.w[i] = static_cast<const float*>(ptrs[7 + i]);
  a.x_out = static_cast<float*>(ptrs[7 + N_WEIGHTS]);
  a.D = D;
  a.H = H;
  a.F = F;
  a.L = L;
  a.Tm = Tm;
  a.pos = pos;
  a.lin_stride = lin_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return (int)launch<1>(a, n_img, s);
    case 2: return (int)launch<2>(a, n_img, s);
    case 3: return (int)launch<3>(a, n_img, s);
    case 4: return (int)launch<4>(a, n_img, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
