// LSTM recurrence for the BiLSTM context smoother, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/lstm.py::lstm_recurrence.
// For each direction d and batch row, from a zero state, for t = 0..T-1:
//     gates = xg[d, :, t] + h @ W_hh[d]      (B, 4H), gate order i, f, g, o
//     i, f, o = sigmoid(.), g = tanh(.)
//     c = f * c + i * g ;  h = o * tanh(c)
// and h is written for every t; with a cell output (training: the saved
// state of the backward, csrc/lstm_backward.cu) c is written too, by the
// thread that owns it. xg = x @ W_ih + b_ih + b_hh is computed outside, as
// one large matrix product. The directions (1 or 2) are independent
// recurrences that run side by side in one launch.
//
// What bounds it on the H100: the T steps are serial, and every step needs
// all of W_hh (H x 4H f32 = 576 KiB at H = 192), more than one SM's shared
// memory (227 KB). Bytes and FLOPs are far below the card's rates; a step
// costs the latency of one pass over W_hh plus the step's synchronisation.
//
// Two routes, chosen by the wrapper from the batch size
// (ops/kernels/geometry.py::k1_route, with the measured crossover):
//
// * The cluster route (small batches, the main path's long lines). A
//   thread-block cluster of C = 8 CTAs (16 measured no faster) runs one
//   tile of BT batch rows of one direction for all T steps. CTA c owns hidden units [c*H/C, (c+1)*H/C)
//   and their four gate columns (i, f, g, o at u, H+u, 2H+u, 3H+u), so the c
//   and h update of its units is local. Its slice of W_hh (H x 4H/C, 72 KiB
//   at C = 8) is loaded into registers once, before the time loop: inside
//   the loop W_hh is never read from L2 or HBM. A step: each thread takes
//   the dot products of its gate column over its share of the hidden inputs
//   for the BT rows (h read from this CTA's copy of the full h in shared
//   memory), the KS threads of a column add their sums by shuffles in a
//   fixed order, the 4 gates of a unit meet by shuffles, the unit's lanes
//   update c and h, and write the new h slice into every CTA of the cluster
//   (distributed shared memory). h is double-buffered, so one cluster
//   barrier per step orders the writes of step t before the reads of step
//   t + 1 and the reads of step t before the writes of step t + 1. xg of
//   step t + 1 is loaded into registers while step t computes.
//
// * The tile route (large batches): one CTA per tile of BT rows streams
//   W_hh from L2 every step; thread j computes gate column j for all BT rows
//   of its tile, so one read of W_hh[k, j] feeds BT multiply-adds. With
//   enough rows per CTA the stream is amortised and many CTAs fill the card.
//
// expf/tanhf are the precise library functions (no fast-math), so the f32
// result holds over 4096 steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// the tile route
// ---------------------------------------------------------------------------

template <int BT>
__global__ void lstm_recurrence_kernel(const float* __restrict__ xg_all, const float* __restrict__ w_all,
                                       float* __restrict__ h_all, float* __restrict__ c_all, int B, int T,
                                       int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int dir = blockIdx.y;
  const float* xg = xg_all + (size_t)dir * B * T * G;
  const float* w_hh = w_all + (size_t)dir * H * G;
  float* h_out = h_all + (size_t)dir * B * T * H;
  float* c_out = c_all ? c_all + (size_t)dir * B * T * H : nullptr;
  float* h_s = smem;           // [BT][H]
  float* c_s = h_s + BT * H;   // [BT][H]
  float* g_s = c_s + BT * H;   // [BT][4H]
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);

  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
    h_s[i] = 0.0f;
    c_s[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float xin[BT];
      float dot[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        xin[r] = (r < nb) ? xg[((size_t)(b0 + r) * T + t) * G + j] : 0.0f;
        dot[r] = 0.0f;
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(w_hh + (size_t)k * G + j);
#pragma unroll
        for (int r = 0; r < BT; ++r) dot[r] = fmaf(h_s[r * H + k], w, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) g_s[r * G + j] = xin[r] + dot[r];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * H; idx += blockDim.x) {
      const int r = idx / H;
      const int u = idx - r * H;
      const float* g = g_s + r * G;
      const float ig = sigmoid_f(g[u]);
      const float fg = sigmoid_f(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float og = sigmoid_f(g[3 * H + u]);
      const float c = fg * c_s[idx] + ig * gg;
      const float h = og * tanhf(c);
      c_s[idx] = c;
      h_s[idx] = h;
      h_out[((size_t)(b0 + r) * T + t) * H + u] = h;
      if (c_out) c_out[((size_t)(b0 + r) * T + t) * H + u] = c;
    }
    __syncthreads();
  }
}

template <int BT>
cudaError_t launch_tile(const float* xg, const float* w_hh, float* h_out, float* c_out, int ndir, int B, int T,
                        int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * 6 * H;
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid((B + BT - 1) / BT, ndir);
  lstm_recurrence_kernel<BT><<<grid, threads, smem, stream>>>(xg, w_hh, h_out, c_out, B, T, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the cluster route
// ---------------------------------------------------------------------------

constexpr int CLUSTER_H = 192;  // the hidden width the cluster route is compiled for (D = 384)
constexpr int NT = 384;         // threads per CTA

// One cluster of C CTAs per (batch tile of BT rows, direction); blockIdx.x =
// tile * C + rank, blockIdx.y = direction.
template <int H, int C, int BT>
__global__ void __launch_bounds__(NT, 1)
lstm_cluster_kernel(const float* __restrict__ xg_all, const float* __restrict__ w_all,
                    float* __restrict__ h_all, float* __restrict__ c_all, int B, int T) {
  constexpr int G = 4 * H;
  constexpr int U = H / C;           // hidden units of this CTA
  constexpr int NCOL = 4 * U;        // gate columns of this CTA
  constexpr int KS = NT / NCOL;      // threads that share one column (split over the inputs)
  constexpr int KQ = H / (4 * KS);   // float4 groups of inputs per thread
  constexpr int GROUP = 4 * KS;      // lanes of one unit (its 4 columns x KS)
  constexpr int ROW_LANES = GROUP / BT;
  static_assert(H % C == 0 && NCOL * KS == NT && H % (4 * KS) == 0, "cluster geometry");
  static_assert(GROUP <= 32 && 32 % GROUP == 0 && GROUP % BT == 0 && C <= GROUP, "unit lanes");

  __shared__ __align__(16) float h_buf[2][BT][H];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C;
  const int dir = blockIdx.y;
  const int b0 = tile * BT;
  const int nb = min(BT, B - b0);
  const float* xg = xg_all + (size_t)dir * B * T * G;
  const float* w_hh = w_all + (size_t)dir * H * G;
  float* h_out = h_all + (size_t)dir * B * T * H;
  float* c_out = c_all ? c_all + (size_t)dir * B * T * H : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = tid % KS;                  // input share of this thread
  const int lc = tid / KS;                 // local column, unit-major: u * 4 + gate
  const int u = lc >> 2;
  const int gate = lc & 3;
  const int unit = rank * U + u;           // this thread's hidden unit
  const int col = gate * H + unit;         // its gate column of W_hh
  const int glane = lane % GROUP;          // lane within the unit's group
  const int base = lane - glane;
  const int my_row = glane % BT;           // the row whose c, h this lane updates

  // this thread's slice of W_hh, once: inputs k = 4 * (p + KS * m) + e
  float w[4 * KQ];
#pragma unroll
  for (int m = 0; m < KQ; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * m + e] = __ldg(w_hh + (size_t)(4 * (p + KS * m) + e) * G + col);

  for (int i = tid; i < BT * H; i += NT) (&h_buf[0][0][0])[i] = 0.0f;

  float xin[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) xin[r] = (r < nb) ? __ldg(xg + ((size_t)(b0 + r) * T) * G + col) : 0.0f;
  float c_state = 0.0f;
  cluster.sync();  // every CTA has started and zeroed its h

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float xnext[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r)
      xnext[r] = (r < nb && t + 1 < T) ? __ldg(xg + ((size_t)(b0 + r) * T + t + 1) * G + col) : 0.0f;

    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int m = 0; m < KQ; ++m) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 hv = reinterpret_cast<const float4*>(&h_buf[cur][r][0])[p + KS * m];
        acc[r] = fmaf(hv.x, w[4 * m], acc[r]);
        acc[r] = fmaf(hv.y, w[4 * m + 1], acc[r]);
        acc[r] = fmaf(hv.z, w[4 * m + 2], acc[r]);
        acc[r] = fmaf(hv.w, w[4 * m + 3], acc[r]);
      }
    }
    // the KS shares of a column, added in a fixed order; then the 4 gates of
    // the unit, for this lane's row
    float gi = 0.f, gf = 0.f, gg = 0.f, go = 0.f;
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      float v = acc[r];
#pragma unroll
      for (int o = 1; o < KS; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      v += xin[r];
      const float vi = __shfl_sync(0xffffffffu, v, base);
      const float vf = __shfl_sync(0xffffffffu, v, base + KS);
      const float vg = __shfl_sync(0xffffffffu, v, base + 2 * KS);
      const float vo = __shfl_sync(0xffffffffu, v, base + 3 * KS);
      if (r == my_row) {
        gi = vi; gf = vf; gg = vg; go = vo;
      }
    }
    const float c = sigmoid_f(gf) * c_state + sigmoid_f(gi) * tanhf(gg);
    const float h = sigmoid_f(go) * tanhf(c);
    c_state = c;
    if (my_row < nb) {
      // the lanes of one row share the C destinations
      float* dst = &h_buf[cur ^ 1][my_row][unit];
      for (int q = glane / BT; q < C; q += ROW_LANES) *cluster.map_shared_rank(dst, q) = h;
      // c lives in this lane's register: the lane that writes h writes it
      if (glane / BT == 0) {
        h_out[((size_t)(b0 + my_row) * T + t) * H + unit] = h;
        if (c_out) c_out[((size_t)(b0 + my_row) * T + t) * H + unit] = c;
      }
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) xin[r] = xnext[r];
    cluster.sync();  // this step's h in every CTA; every CTA done reading the old h
  }
}

template <int C, int BT>
cudaError_t launch_cluster(const float* xg, const float* w_hh, float* h_out, float* c_out, int ndir, int B,
                           int T, cudaStream_t stream) {
  auto kernel = lstm_cluster_kernel<CLUSTER_H, C, BT>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + BT - 1) / BT), ndir);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&xg, &w_hh, &h_out, &c_out, &B, &T};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
}


}  // namespace

// xg (ndir, B, T, 4H), w_hh (ndir, H, 4H), h_out and c_out (ndir, B, T, H):
// contiguous f32 on the device; c_out may be null (no cell output). route 0:
// the tile route, 4H <= 1024; route 8: the cluster route with clusters of 8
// CTAs, H = 192. `rows` in {1, 2, 4, 8} batch rows per CTA or cluster.
// Returns a cudaError_t (0 on success).
extern "C" int lstm_recurrence_launch(const void* xg, const void* w_hh, void* h_out, void* c_out, int ndir, int B,
                                      int T, int H, int route, int rows, void* stream) {
  const float* x = static_cast<const float*>(xg);
  const float* w = static_cast<const float*>(w_hh);
  float* h = static_cast<float*>(h_out);
  float* c = static_cast<float*>(c_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    switch (rows) {
      case 1: return (int)launch_tile<1>(x, w, h, c, ndir, B, T, H, s);
      case 2: return (int)launch_tile<2>(x, w, h, c, ndir, B, T, H, s);
      case 4: return (int)launch_tile<4>(x, w, h, c, ndir, B, T, H, s);
      case 8: return (int)launch_tile<8>(x, w, h, c, ndir, B, T, H, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 8 || H != CLUSTER_H) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch_cluster<8, 1>(x, w, h, c, ndir, B, T, s);
    case 2: return (int)launch_cluster<8, 2>(x, w, h, c, ndir, B, T, s);
    case 4: return (int)launch_cluster<8, 4>(x, w, h, c, ndir, B, T, s);
    case 8: return (int)launch_cluster<8, 8>(x, w, h, c, ndir, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
