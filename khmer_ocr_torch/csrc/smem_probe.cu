// The largest dynamic shared memory one CTA can take, for Hopper (sm_90a):
// kernel K4.
//
// Replaces the JAX package's capacity probe examples/probe_vmem.py (the
// Pallas kernel in try_mb, which writes the first and last rows of a large
// VMEM scratch). Here the scratch is `rows` x 128 floats of dynamic shared
// memory: buf[0, :] = x[0, :], buf[rows - 1, :] = 2 x[0, :], then
// out[0, :] = buf[0, :] + buf[rows - 1, :], and rows 1..7 of out are zero
// (written here, so the caller allocates out without a fill). One CTA of 128
// threads, one column each.
//
// What bounds it: the host's work around one launch (1 KB in, 4 KB out); it
// exists to find what the card allows. smem_probe_launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize to the size when it differs
// from the size last set, launches and synchronises; a refused size returns
// cudaErrorInvalidValue (cleared from the runtime's last error).
// smem_probe_max_optin reads the device attribute the probe's answer is
// checked against.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 128;
constexpr int OUT_ROWS = 8;
int attr_bytes = -1;  // the size the kernel's attribute was last set to (-1: not set)

__global__ void __launch_bounds__(COLS) smem_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int rows) {
  extern __shared__ float buf[];
  const int c = threadIdx.x;
  float* last = buf + (size_t)(rows - 1) * COLS;
  buf[c] = x[c];
  last[c] = x[c] * 2.0f;
  __syncthreads();
  out[c] = buf[c] + last[c];
#pragma unroll
  for (int r = 1; r < OUT_ROWS; ++r) out[r * COLS + c] = 0.0f;
}

__global__ void empty_kernel() {}

}  // namespace

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the device, or minus a cudaError_t.
extern "C" int smem_probe_max_optin(int device) {
  int v = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

// x, out: (8, 128) f32 device pointers. nbytes: a multiple of 512 (one row),
// at least two rows. Returns a cudaError_t: 0 when the kernel ran to its end.
extern "C" int smem_probe_launch(const float* x, float* out, int nbytes, void* stream) {
  if (nbytes < 2 * COLS * 4 || nbytes % (COLS * 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (nbytes != attr_bytes) {
    err = cudaFuncSetAttribute(smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
    attr_bytes = err == cudaSuccess ? nbytes : -1;
  }
  if (err == cudaSuccess) {
    smem_probe_kernel<<<1, COLS, nbytes, s>>>(x, out, nbytes / (COLS * 4));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused configuration is not sticky: clear it
    return (int)err;
  }
  return (int)cudaStreamSynchronize(s);
}

// One launch of an empty kernel and a synchronise: the floor under K4's time
// (whose work is a launch). Returns a cudaError_t.
extern "C" int empty_launch(void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  empty_kernel<<<1, COLS, 0, s>>>();
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : (int)cudaStreamSynchronize(s);
}
