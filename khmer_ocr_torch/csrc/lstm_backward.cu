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
// every step needs all of W_hh (576 KiB at H = 192). This is the simple
// design, the forward's tile route transposed: one CTA per tile of BT batch
// rows and direction streams W_hh^T (4H, H) from L2 every step; thread
// (s, k) sums gate block s's share of dh_next[:, k] over its H inputs for
// the BT rows, so one read of W feeds BT multiply-adds and neighbouring
// threads read neighbouring addresses. The four shares of a unit are added
// in a fixed order by the thread that updates it in the next step. Two
// barriers per step: dz is complete before the product reads it, and the
// product is complete before the next step reads it. A step takes about
// 7.4 us at the train step's shape (PERF.md); 32 loads in flight a thread
// and the next step's inputs prefetched into registers measured no faster
// (3.809 against 3.827 ms), so this simple loop stays. The cluster layout of
// the forward (W_hh in the registers of 8 CTAs) would also need dz gathered
// across the cluster every step: a later design.
//
// expf/tanhf are the precise library functions (no fast-math), as in K1.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

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

}  // namespace

// gates (ndir, B, T, 4H) pre-activation, c and dh (ndir, B, T, H), wt = W_hh^T
// (ndir, 4H, H), dz (ndir, B, T, 4H): contiguous f32 on the device, 4H <= 1024.
// `rows` in {1, 2, 4, 8} batch rows per CTA. Returns a cudaError_t (0 on
// success).
extern "C" int lstm_backward_launch(const void* gates, const void* c, const void* dh, const void* wt, void* dz,
                                    int ndir, int B, int T, int H, int rows, void* stream) {
  const float* g = static_cast<const float*>(gates);
  const float* cs = static_cast<const float*>(c);
  const float* d = static_cast<const float*>(dh);
  const float* w = static_cast<const float*>(wt);
  float* out = static_cast<float*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (4 * H > 1024) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return (int)launch<1>(g, cs, d, w, out, ndir, B, T, H, s);
    case 2: return (int)launch<2>(g, cs, d, w, out, ndir, B, T, H, s);
    case 4: return (int)launch<4>(g, cs, d, w, out, ndir, B, T, H, s);
    case 8: return (int)launch<8>(g, cs, d, w, out, ndir, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
