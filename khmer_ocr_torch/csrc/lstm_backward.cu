// The LSTM's adjoint recurrence (kernel K1b), for Hopper (sm_90a).
//
// The serial part of the backward of csrc/lstm_recurrence.cu (kernel K1).
// The JAX package computes it as the reverse lax.scan of
// ops/pallas/lstm.py::_vjp_bwd, which XLA compiles into one on-device loop;
// in eager PyTorch the same loop is about a dozen small kernels per step.
// Here it is one launch for both directions. For each direction d and batch
// row, from a zero carry (dh_next, dc_next) at t = T - 1, for t = T-1..0:
//     i, f, o = sigmoid(z_i, z_f, z_o), g = tanh(z_g)      z = gates[t]
//     dh = dh_seq[t] + dh_next
//     do = dh * tanh(c[t]) ; dc = dh * o * (1 - tanh(c[t])^2) + dc_next
//     dz = [dc g i(1-i), dc c[t-1] f(1-f), dc i (1-g^2), do o(1-o)]
//     dh_next = dz @ W_hh^T ;  dc_next = dc * f
// and dz (= d xg) is written for every t. The pre-activation gates
// (xg + h[t-1] @ W_hh, known for every t from the forward's saved h) come in
// as one matrix product made before the launch, and dW_hh = sum over t and
// rows of h[t-1]^T dz[t] is one matrix product after it
// (ops/kernels/lstm.py::LSTMRecurrence).
//
// What bounds it on the H100: as in the forward, the T steps are serial and
// every step needs all of W_hh (576 KiB at H = 192). Two routes, chosen by the
// wrapper from the width (ops/kernels/geometry.py::k1b_route):
//
// * The cluster route (H = 192, every batch: it measured no slower than the
//   tile route at any batch swept; PERF.md).
//   A thread-block cluster of C = 8 CTAs runs one tile of BT batch rows of
//   one direction for all T steps, as K1's cluster route does
//   (csrc/lstm_recurrence.cu). CTA c owns hidden units [c H/C, (c+1) H/C) and
//   their four gate columns; its slice of W_hh, W_hh[:, cols(c)] (H x 4H/C,
//   72 KiB at C = 8), is loaded into registers once, read straight from W_hh
//   (H, 4H), and never read again inside the time loop. A step t:
//     1. the lane of (row, unit) adds the C partial sums of dh_next that step
//        t + 1 left in this CTA's buffer, in rank order 0..C-1, to dh_seq[t];
//     2. from dh it forms do, dc and the unit's four dz; the dc carry stays in
//        that lane's register (as K1 keeps c);
//     3. it writes dz to dz_out and to the CTA's dz_s[BT][4H/C];
//     4. one __syncthreads;
//     5. thread (k, s) owns input k and share s of the CTA's 4H/C columns, and
//        forms sum_j dz[r, j] W_hh[k, j] over its share for every row; the KS
//        shares of k are added by shuffles;
//     6. the sum for unit k goes over distributed shared memory into the
//        buffer of k's owner, at slot [buf][c][r][k - owner H/C]: a
//        reduce-scatter, H floats a row a step out of each CTA, what K1's
//        forward sends. The buffer is double-buffered, so
//     7. one cluster barrier a step orders step t's writes before step
//        t - 1's reads, and step t's reads before step t - 1's writes.
//   The next step's gates, c[t - 2] and dh_seq are loaded into registers
//   while a step computes.
//
// * The tile route (other widths; the simple design of the first port): one
//   CTA per tile of BT batch rows and direction streams
//   W_hh^T (4H, H) from L2 every step; thread (s, k) sums gate block s's share
//   of dh_next[:, k] over its H inputs for the BT rows, so one read of W feeds
//   BT multiply-adds and neighbouring threads read neighbouring addresses.
//   The four shares of a unit are added in a fixed order by the thread that
//   updates it in the next step. Two barriers per step: dz is complete before
//   the product reads it, and the product is complete before the next step
//   reads it. A step takes about 7.4 us whatever the rows (PERF.md): one SM's
//   pass over W_hh; 32 loads in flight a thread and the next step's inputs
//   prefetched into registers measured no faster.
//
// expf/tanhf are the precise library functions (no fast-math), as in K1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// the tile route
// ---------------------------------------------------------------------------

template <int BT>
__global__ void lstm_backward_kernel(const float* __restrict__ gates_all, const float* __restrict__ c_all,
                                     const float* __restrict__ dh_all, const float* __restrict__ wt_all,
                                     float* __restrict__ dz_all, int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int dir = blockIdx.y;
  const size_t seq = (size_t)B * T;
  const float* gates = gates_all + (size_t)dir * seq * G;
  const float* c_seq = c_all + (size_t)dir * seq * H;
  const float* dh_seq = dh_all + (size_t)dir * seq * H;
  const float* wt = wt_all + (size_t)dir * G * H;
  float* dz_out = dz_all + (size_t)dir * seq * G;
  float* dz_s = smem;                 // [BT][4H] this step's dz
  float* part_s = dz_s + BT * G;      // [4][BT][H] gate block s's share of dh_next
  float* dc_s = part_s + 4 * BT * H;  // [BT][H] the dc carry
  const int b0 = blockIdx.x * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.x;

  for (int i = tid; i < BT * G; i += blockDim.x) dz_s[i] = 0.0f;
  for (int i = tid; i < 4 * BT * H; i += blockDim.x) part_s[i] = 0.0f;
  for (int i = tid; i < BT * H; i += blockDim.x) dc_s[i] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int idx = tid; idx < nb * H; idx += blockDim.x) {
      const int r = idx / H;
      const int u = idx - r * H;
      const size_t row = (size_t)(b0 + r) * T + t;
      const float* z = gates + row * G;
      const float ig = sigmoid_f(z[u]);
      const float fg = sigmoid_f(z[H + u]);
      const float gg = tanhf(z[2 * H + u]);
      const float og = sigmoid_f(z[3 * H + u]);
      const float tc = tanhf(c_seq[row * H + u]);
      const float c_prev = t > 0 ? c_seq[(row - 1) * H + u] : 0.0f;
      const float carry = ((part_s[r * H + u] + part_s[(BT + r) * H + u]) + part_s[(2 * BT + r) * H + u]) +
                          part_s[(3 * BT + r) * H + u];
      const float dh = dh_seq[row * H + u] + carry;
      const float d_o = dh * tc;
      const float dc = dh * og * (1.0f - tc * tc) + dc_s[idx];
      const float zi = dc * gg * ig * (1.0f - ig);
      const float zf = dc * c_prev * fg * (1.0f - fg);
      const float zg = dc * ig * (1.0f - gg * gg);
      const float zo = d_o * og * (1.0f - og);
      dc_s[idx] = dc * fg;
      float* dzr = dz_s + r * G;
      float* out = dz_out + row * G;
      dzr[u] = zi;
      dzr[H + u] = zf;
      dzr[2 * H + u] = zg;
      dzr[3 * H + u] = zo;
      out[u] = zi;
      out[H + u] = zf;
      out[2 * H + u] = zg;
      out[3 * H + u] = zo;
    }
    __syncthreads();  // dz of step t complete; every read of the old shares done
    if (t > 0 && tid < G) {
      const int s = tid / H;  // gate block
      const int k = tid - s * H;
      const float* w = wt + (size_t)s * H * H + k;  // W_hh^T[s H + jj][k]
      const float* dzs = dz_s + s * H;
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 8
      for (int jj = 0; jj < H; ++jj) {
        const float wv = __ldg(w + (size_t)jj * H);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(dzs[r * G + jj], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) part_s[(s * BT + r) * H + k] = acc[r];
    }
    __syncthreads();  // the shares of dh_next complete; every read of dz done
  }
}

template <int BT>
cudaError_t launch(const float* gates, const float* c, const float* dh, const float* wt, float* dz, int ndir, int B,
                   int T, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * 9 * H;
  cudaError_t err = cudaFuncSetAttribute(lstm_backward_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = ((4 * H + 31) / 32) * 32;
  const dim3 grid((B + BT - 1) / BT, ndir);
  lstm_backward_kernel<BT><<<grid, threads, smem, stream>>>(gates, c, dh, wt, dz, B, T, H);
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
lstm_backward_cluster_kernel(const float* __restrict__ gates_all, const float* __restrict__ c_all,
                             const float* __restrict__ dh_all, const float* __restrict__ w_all,
                             float* __restrict__ dz_all, int B, int T) {
  constexpr int G = 4 * H;
  constexpr int U = H / C;         // hidden units of this CTA
  constexpr int NCOL = 4 * U;      // its gate columns, gate-major: gate * U + u
  constexpr int KS = NT / H;       // threads that share one input k (split over the columns)
  constexpr int SH = NCOL / KS;    // columns of one share
  static_assert(H % C == 0 && KS * H == NT && SH % 4 == 0, "cluster geometry");
  static_assert(32 % KS == 0 && U * BT <= NT && C <= 8, "lanes");

  __shared__ __align__(16) float dz_s[BT][NCOL];  // this step's dz of this CTA's columns
  __shared__ float part_s[2][C][BT][U];           // [buf][source CTA][row][unit]: partial sums of dh_next

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C;
  const int dir = blockIdx.y;
  const int b0 = tile * BT;
  const int nb = min(BT, B - b0);
  const size_t seq = (size_t)B * T;
  const float* gates = gates_all + (size_t)dir * seq * G;
  const float* c_seq = c_all + (size_t)dir * seq * H;
  const float* dh_seq = dh_all + (size_t)dir * seq * H;
  const float* w_hh = w_all + (size_t)dir * H * G;
  float* dz_out = dz_all + (size_t)dir * seq * G;
  const int tid = threadIdx.x;

  // the product's role: input k, share s of the columns
  const int k = tid / KS;
  const int s = tid % KS;
  float w[SH];  // W_hh[k, cols]: local column j = s * SH + jj is gate j / U of unit rank * U + j % U
#pragma unroll
  for (int jj = 0; jj < SH; ++jj) {
    const int j = s * SH + jj;
    w[jj] = __ldg(w_hh + (size_t)k * G + (j / U) * H + rank * U + j % U);
  }
  float* const dst = cluster.map_shared_rank(&part_s[0][rank][0][k % U], k / U);  // k's owner's slot

  // the elementwise role: lane (r, u) of the first U * BT
  const bool ew = tid < U * BT;
  const int r = tid / U;
  const int u = tid - r * U;
  const int unit = rank * U + u;
  const bool live = ew && r < nb;
  const size_t row0 = (size_t)(b0 + (live ? r : 0)) * T;  // row r's step 0
  float z[4] = {0.f, 0.f, 0.f, 0.f}, ct = 0.f, cp = 0.f, dht = 0.f;
  if (live) {
    const size_t row = row0 + T - 1;
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = __ldg(gates + row * G + q * H + unit);
    ct = __ldg(c_seq + row * H + unit);
    cp = T > 1 ? __ldg(c_seq + (row - 1) * H + unit) : 0.f;
    dht = __ldg(dh_seq + row * H + unit);
  }
  float dc_next = 0.f;
  cluster.sync();  // every CTA of the cluster has started before any remote write

  for (int t = T - 1; t >= 0; --t) {
    const int buf = t & 1;  // written at step t, read at step t - 1
    float zn[4] = {0.f, 0.f, 0.f, 0.f}, cpn = 0.f, dhn = 0.f;
    if (live && t > 0) {
      const size_t row = row0 + t - 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) zn[q] = __ldg(gates + row * G + q * H + unit);
      cpn = t > 1 ? __ldg(c_seq + (row - 1) * H + unit) : 0.f;
      dhn = __ldg(dh_seq + row * H + unit);
    }
    if (ew) {
      float carry = 0.f;
      if (t < T - 1) {
#pragma unroll
        for (int q = 0; q < C; ++q) carry += part_s[buf ^ 1][q][r][u];
      }
      const float dh = dht + carry;
      const float ig = sigmoid_f(z[0]);
      const float fg = sigmoid_f(z[1]);
      const float gg = tanhf(z[2]);
      const float og = sigmoid_f(z[3]);
      const float tc = tanhf(ct);
      const float d_o = dh * tc;
      const float dc = dh * og * (1.0f - tc * tc) + dc_next;
      const float zi = dc * gg * ig * (1.0f - ig);
      const float zf = dc * cp * fg * (1.0f - fg);
      const float zg = dc * ig * (1.0f - gg * gg);
      const float zo = d_o * og * (1.0f - og);
      dc_next = dc * fg;
      dz_s[r][u] = zi;
      dz_s[r][U + u] = zf;
      dz_s[r][2 * U + u] = zg;
      dz_s[r][3 * U + u] = zo;
      if (live) {
        float* out = dz_out + (row0 + t) * G + unit;
        out[0] = zi;
        out[H] = zf;
        out[2 * H] = zg;
        out[3 * H] = zo;
      }
    }
    if (t == 0) break;  // no step needs dh_next of step 0; no remote write follows
    __syncthreads();    // dz of step t complete

    float acc[BT];
#pragma unroll
    for (int rr = 0; rr < BT; ++rr) acc[rr] = 0.f;
#pragma unroll
    for (int m = 0; m < SH / 4; ++m) {
#pragma unroll
      for (int rr = 0; rr < BT; ++rr) {
        const float4 zv = reinterpret_cast<const float4*>(&dz_s[rr][s * SH])[m];
        acc[rr] = fmaf(zv.x, w[4 * m], acc[rr]);
        acc[rr] = fmaf(zv.y, w[4 * m + 1], acc[rr]);
        acc[rr] = fmaf(zv.z, w[4 * m + 2], acc[rr]);
        acc[rr] = fmaf(zv.w, w[4 * m + 3], acc[rr]);
      }
    }
    // the KS shares of k, added by shuffles (every lane of k ends with the same sum); the
    // lanes of k split the rows between them for the remote writes
    float* const slot = dst + buf * (C * BT * U);
#pragma unroll
    for (int rr = 0; rr < BT; ++rr) {
      float v = acc[rr];
#pragma unroll
      for (int o = 1; o < KS; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (rr % KS == s && rr < nb) slot[rr * U] = v;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = zn[q];
    ct = cp;
    cp = cpn;
    dht = dhn;
    cluster.sync();  // step t's partials in their owners; every read of step t + 1's done
  }
}

template <int C, int BT>
cudaError_t launch_cluster(const float* gates, const float* c, const float* dh, const float* w_hh, float* dz,
                           int ndir, int B, int T, cudaStream_t stream) {
  auto kernel = lstm_backward_cluster_kernel<CLUSTER_H, C, BT>;
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
  void* args[] = {&gates, &c, &dh, &w_hh, &dz, &B, &T};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
}

}  // namespace

// gates (ndir, B, T, 4H) pre-activation, c and dh (ndir, B, T, H), dz (ndir,
// B, T, 4H): contiguous f32 on the device. route 0: the tile route, w =
// W_hh^T (ndir, 4H, H), 4H <= 1024; route 8: the cluster route with clusters
// of 8 CTAs, w = W_hh (ndir, H, 4H), H = 192. `rows` in {1, 2, 4, 8} batch
// rows per CTA or cluster. Returns a cudaError_t (0 on success).
extern "C" int lstm_backward_launch(const void* gates, const void* c, const void* dh, const void* w, void* dz,
                                    int ndir, int B, int T, int H, int route, int rows, void* stream) {
  const float* g = static_cast<const float*>(gates);
  const float* cs = static_cast<const float*>(c);
  const float* d = static_cast<const float*>(dh);
  const float* wp = static_cast<const float*>(w);
  float* out = static_cast<float*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (4 * H > 1024) return (int)cudaErrorInvalidValue;
    switch (rows) {
      case 1: return (int)launch<1>(g, cs, d, wp, out, ndir, B, T, H, s);
      case 2: return (int)launch<2>(g, cs, d, wp, out, ndir, B, T, H, s);
      case 4: return (int)launch<4>(g, cs, d, wp, out, ndir, B, T, H, s);
      case 8: return (int)launch<8>(g, cs, d, wp, out, ndir, B, T, H, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 8 || H != CLUSTER_H) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch_cluster<8, 1>(g, cs, d, wp, out, ndir, B, T, s);
    case 2: return (int)launch_cluster<8, 2>(g, cs, d, wp, out, ndir, B, T, s);
    case 4: return (int)launch_cluster<8, 4>(g, cs, d, wp, out, ndir, B, T, s);
    case 8: return (int)launch_cluster<8, 8>(g, cs, d, wp, out, ndir, B, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
