// LSTM recurrence for the BiLSTM context smoother, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/lstm.py::lstm_recurrence.
// From a zero state, for t = 0..T-1:
//     gates = xg[:, t] + h @ W_hh            (B, 4H), gate order i, f, g, o
//     i, f, o = sigmoid(.), g = tanh(.)
//     c = f * c + i * g ;  h = o * tanh(c)
// and h is written for every t. xg = x @ W_ih + b_ih + b_hh is computed
// outside, as one large matrix product.
//
// What bounds it on the H100: the T steps are serial, and every step needs
// all of W_hh (H x 4H f32 = 576 KiB at H = 192). The TPU kernel keeps W_hh in
// VMEM; an SM's shared memory (227 KB) cannot hold it. Each step therefore
// streams W_hh from the L2 cache (it stays resident there: 576 KiB against
// 50 MB), and a step costs about one pass of W_hh through one SM's L2 port.
// The floor set by device memory bytes is far below that: the kernel is
// bound by the serial chain of L2 reads, not by HBM bytes or FLOPs.
//
// Design: one CTA per tile of BT batch rows, for any batch size. h and c of
// the tile live in shared memory. Thread j computes gate column j for all BT
// rows of the tile, so one read of W_hh[k, j] feeds BT fused multiply-adds and
// the tile amortises the L2 traffic. Two __syncthreads() per step separate
// the gate products from the elementwise update. expf/tanhf are the precise
// library functions (no fast-math), so the f32 result holds over 4096 steps.
// Splitting the gates over a 4-CTA cluster with W_hh in distributed shared
// memory would remove the L2 stream; that is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int BT>
__global__ void lstm_recurrence_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                                       float* __restrict__ h_out, int B, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
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
    }
    __syncthreads();
  }
}

template <int BT>
cudaError_t launch(const float* xg, const float* w_hh, float* h_out, int B, int T, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * 6 * H;
  cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((4 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int grid = (B + BT - 1) / BT;
  lstm_recurrence_kernel<BT><<<grid, threads, smem, stream>>>(xg, w_hh, h_out, B, T, H);
  return cudaGetLastError();
}

// Batch-tile size: enough CTAs to spread over the SMs while small batches
// still run one row per CTA.
int tile_rows(int B) {
  if (B >= 512) return 8;
  if (B >= 256) return 4;
  if (B >= 128) return 2;
  return 1;
}

}  // namespace

// xg (B, T, 4H), w_hh (H, 4H), h_out (B, T, H): contiguous f32 on the device.
// Returns a cudaError_t (0 on success).
extern "C" int lstm_recurrence_launch(const void* xg, const void* w_hh, void* h_out, int B, int T,
                                      int H, void* stream) {
  const float* x = static_cast<const float*>(xg);
  const float* w = static_cast<const float*>(w_hh);
  float* h = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows(B)) {
    case 8: return (int)launch<8>(x, w, h, B, T, H, s);
    case 4: return (int)launch<4>(x, w, h, B, T, H, s);
    case 2: return (int)launch<2>(x, w, h, B, T, H, s);
    default: return (int)launch<1>(x, w, h, B, T, H, s);
  }
}
