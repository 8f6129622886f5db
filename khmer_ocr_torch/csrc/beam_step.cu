// One step of the beam search's bookkeeping, for Hopper (sm_90a): kernel K5.
//
// Replaces no TPU kernel. The JAX package leaves this bookkeeping to XLA,
// which fuses it into the body of its lax.while_loop; the port's step ran it
// as separate torch ops (torch.log_softmax, then decode/beam.py::
// beam_advance: some ninety launches a step inside the step loop's CUDA
// graphs). This kernel is the port's fusion of them: one launch a step. K3
// (decode_loop.cu) runs the same device routines (beam_search.cuh) at every
// step of its whole decode. For each image, on the first V columns of each
// lane's row of x:
//   1. log-softmax in f32 (precise expf/logf), skipped when x holds
//      log-probs already (K2's fused head gives them);
//   2. each lane's top-K, lowest column on ties;
//   3. <eos> candidates retire at raw / lens[pos + 2] (true f32 division);
//      the first best lane replaces the image's best completion only on
//      strict improvement, its tokens with <eos> at pos + 1;
//   4. the next K beams: the best K non-<eos> of the K x K candidates,
//      lowest flat index on ties;
//   5. tokens and lineage reordered through the parents, in place: slot
//      pos + 1 of the tokens takes the new token, slot pos of the lineage
//      the parent.
// The position is read from the device's int32 `pos`, as K2 reads it, so one
// launch captured in a CUDA graph serves every position of its replays; the
// caller keeps pos + 2 < LP and pos < C, which the kernel cannot check.
//
// What bounds it on the H100: neither bytes nor operations. At 8 images x 3
// lanes and V 124 it moves about 7 KB an image (the logits, the tokens and
// the lineage read, the tokens and lineage written) and computes a few
// thousand operations. What a launch costs is the launch and the block's
// serial chain: K + 2 passes of a warp over its lane's row, then K passes of
// one warp over the K x K candidates, between two block barriers.
//
// Design: one CTA of K warps for each image (K <= 32). The image's tokens
// and lineage are staged in shared memory first, so that their reads
// overlap the warps' passes and the reorder can write them back in place;
// warp l takes lane l's log-softmax and top-K, warp 0 the retirement and
// the next beams, every thread the reorder.

#include <cuda_runtime.h>

#include "beam_search.cuh"  // the search's device routines, shared with K3

namespace {

constexpr int MAX_LANES = 32;  // a warp a lane in one block of at most 1024 threads

struct Args {
  const float* x;          // (n_img K, row) logits, or log-probs when !log_softmax; the first V columns read
  const int* pos;          // the position
  const float* lens;       // (LP) length denominators
  float* scores;           // (n_img, K) running scores
  float* best_score;       // (n_img) the best completion's normalised score
  long long* tokens;       // (n_img, K, LP)
  long long* best_tokens;  // (n_img, LP)
  int* lineage;            // (n_img, K, C) image-local parents
  int K, V, row, LP, C, eos, log_softmax;
};

// tokens K x LP (8 bytes each), lineage K x C, top_v and top_i K x K, then
// score, next, parent and new_tok K each (4 bytes each)
size_t smem_bytes(int K, int LP, int C) {
  return 8 * (size_t)K * LP + 4 * ((size_t)K * C + 2 * (size_t)K * K + 4 * (size_t)K);
}

__global__ void __launch_bounds__(32 * MAX_LANES) beam_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.K, LP = a.LP, C = a.C;
  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long* tok = reinterpret_cast<long long*>(smem_raw);  // [K][LP]
  int* lin = reinterpret_cast<int*>(tok + (size_t)K * LP);  // [K][C]
  float* top_v = reinterpret_cast<float*>(lin + (size_t)K * C);  // [K][K]
  int* top_i = reinterpret_cast<int*>(top_v + K * K);              // [K][K]
  float* score = reinterpret_cast<float*>(top_i + K * K);          // [K]
  float* next = score + K;                                         // [K]
  int* parent = reinterpret_cast<int*>(next + K);                  // [K]
  int* new_tok = parent + K;                                       // [K]

  const int p = *a.pos;
  long long* g_tok = a.tokens + (size_t)img * K * LP;
  int* g_lin = a.lineage + (size_t)img * K * C;
  for (int i = threadIdx.x; i < K * LP; i += blockDim.x) tok[i] = g_tok[i];
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) lin[i] = g_lin[i];
  if (threadIdx.x < K) score[threadIdx.x] = a.scores[(size_t)img * K + threadIdx.x];

  // 1-2. lane `warp`'s log-probs and their top-K
  beam::lane_topk(a.x + ((size_t)img * K + warp) * a.row, a.V, K, a.log_softmax != 0, top_v + warp * K,
                  top_i + warp * K);
  __syncthreads();

  // 3-4. completions and the next beams, one warp
  if (warp == 0) {
    int best_lane;
    if (beam::retire(score, top_v, top_i, K, a.eos, a.lens[p + 2], a.best_score + img, best_lane)) {
      long long* best = a.best_tokens + (size_t)img * LP;
      for (int t = lane; t < LP; t += 32) best[t] = t == p + 1 ? (long long)a.eos : tok[best_lane * LP + t];
    }
    beam::next_beams(score, top_v, top_i, K, a.eos, next, parent, new_tok);
    if (lane < K) a.scores[(size_t)img * K + lane] = next[lane];
  }
  __syncthreads();

  // 5. tokens and lineage from the parents' staged rows, in place
  beam::reorder(g_tok, tok, parent, K, LP, p + 1, new_tok);
  beam::reorder(g_lin, lin, parent, K, C, p, parent);
}

}  // namespace

extern "C" int beam_step_smem_bytes(int K, int LP, int C) { return (int)smem_bytes(K, LP, C); }

extern "C" int beam_step_max_lanes() { return MAX_LANES; }

// ptrs: x, pos, lens, scores, best_score, tokens, best_tokens, lineage
// (Args' order and types), contiguous device pointers. One CTA of 32 K
// threads for each of the n_img images. Returns a cudaError_t.
extern "C" int beam_step_launch(void* const* ptrs, int n_img, int K, int V, int row, int LP, int C, int eos,
                                int log_softmax, void* stream) {
  if (n_img < 1 || K < 1 || K > MAX_LANES || V < 1 || V > row || LP < 2 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 8; ++i) {
    if (ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = static_cast<const float*>(ptrs[0]);
  a.pos = static_cast<const int*>(ptrs[1]);
  a.lens = static_cast<const float*>(ptrs[2]);
  a.scores = static_cast<float*>(ptrs[3]);
  a.best_score = static_cast<float*>(ptrs[4]);
  a.tokens = static_cast<long long*>(ptrs[5]);
  a.best_tokens = static_cast<long long*>(ptrs[6]);
  a.lineage = static_cast<int*>(ptrs[7]);
  a.K = K;
  a.V = V;
  a.row = row;
  a.LP = LP;
  a.C = C;
  a.eos = eos;
  a.log_softmax = log_softmax;
  const size_t smem = smem_bytes(K, LP, C);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(beam_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&a};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(beam_step_kernel), dim3(n_img), dim3(32 * K), args,
                               smem, static_cast<cudaStream_t>(stream));
}
