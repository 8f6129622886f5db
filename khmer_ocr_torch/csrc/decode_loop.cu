// The whole beam-K decode in one launch, for Hopper (sm_90a): kernel K3.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas/decode_loop.py::fused_beam_decode. For each image, all
// max_len steps of the beam search, in the order of that kernel's step body:
//   1. embedding: tok_emb[token] + pos_emb[step] (a row read, exact);
//   2. every decoder layer, self-attention read through the lineage held in
//      shared memory;
//   3. the head x @ out_w + out_b over the V real columns;
//   4. log-softmax per lane in f32 (precise expf/logf);
//   5. per-lane top-K by iterative max, lowest index on ties;
//   6. <eos> candidates retire at raw / (step + 2), replacing the image's best
//      completion only on strict improvement;
//   7. the next K beams: the best K non-<eos> of the K*K candidates, lowest
//      flat index on ties (a taken candidate is masked to NEG_INF, as the
//      reference's iterative top-k does);
//   8. tokens and lineage reordered through the parent pointers.
// Steps 4-8 are the routines of beam_search.cuh, which kernel K5
// (beam_step.cu) runs one step a launch for the step loop.
// At the end: the best completion, else lane 0. No early exit (the host loop's
// exit is provably safe, so the tokens are the same).
//
// What bounds it on the H100: at the gate's sizes (Tm <= 128, max_len <= 64)
// the bound is the operations (a few MFLOP per lane, step and layer) and the
// layer weights (8.3 MB per layer at D = 384, F = 1536, read once); what a
// decode costs is the serial chain of max_len x layers layer-steps, each of
// which streams its weights from L2 and waits on barriers.
//
// Design: one thread-block cluster of H CTAs (one per attention head) per
// image, holding all K lanes and resident for all max_len steps. Every layer
// of every step is the cluster layer that K2 launches
// (decoder_cluster.cuh::cluster_layer): CTA h computes head h and one H-th
// of every projection, outputs meet over DSMEM, the LayerNorms run on full
// rows in every CTA. Around it, every CTA keeps the same state:
//   - the embedding rows are built in every CTA (the same bits);
//   - the head is split by columns: CTA h computes Vp/H of the Vp padded
//     vocabulary columns, the logits go to every CTA over DSMEM, then one
//     cluster barrier;
//   - the search (log-softmax, top-K, completions, next beams, tokens and
//     lineage) runs in every CTA on identical inputs in the same order, so
//     every CTA holds the same tokens, lineage and scores and nothing is
//     broadcast; rank 0 writes the answer.
// The self-KV caches: CTA h writes and reads only head h's hd columns of its
// image's lanes, so they need no cluster synchronisation. Its slice, (layers,
// k|v, K, max_len, hd), stays in shared memory where it fits (K <= 3 at the
// flagship: 73,728 B per layer at K = 3), as the TPU kernel keeps its caches
// in VMEM; otherwise it goes to a global scratch (n_img, H, layers, k|v, K,
// max_len, hd), each CTA's slice contiguous (geometry.k3_geometry chooses).
// Storage type (the TPU kernel's compute dtype, memory.dtype): float or
// bf16 for the embeddings, the weight matrices, the memory K/V, the self
// caches (on chip too, at half the bytes in bf16, which is what lets beam
// 4 keep them there) and the head's weight; the layer rounds as K2 does,
// the embedding row and each layer's output are rounded to the storage
// type (K2's output is stored in it), and the head (f32 sums of the
// rounded output, the f32 bias) and the search run in f32, as in the TPU
// kernel. The source builds twice, with STORAGE_BF16
// defined for the bf16 library (ops/kernels/build.py).
// The memory K/V of head h (Tm x hd x 2 floats a layer) come from L2 at
// every step, as in K2. The loop's exchanges are ordered by the layer's own
// cluster barriers (see decoder_cluster.cuh) and the one after the head; a
// last cluster barrier keeps every CTA's shared memory alive until no peer
// can write it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "beam_search.cuh"      // the search, shared with K5 (beam_step.cu)
#include "decoder_cluster.cuh"  // the cluster layer, its shared-memory layout and helpers

namespace {

using namespace dec;

#ifdef STORAGE_BF16
using Storage = __nv_bfloat16;
#else
using Storage = float;
#endif

constexpr int MAX_LAYERS = 8;

template <typename T>
struct LayerPtrs {
  const void* w[N_WEIGHTS];  // matrices T, vectors float
  const T* mem_k;            // (n_img, Tm, D)
  const T* mem_v;
};

template <typename T>
struct Args {
  LayerPtrs<T> layer[MAX_LAYERS];
  const T* tok_emb;        // (V, D)
  const T* pos_emb;        // (>= max_len, D)
  const T* out_w;          // (D, Vp), Vp = V rounded up to a multiple of Vec<T>::N H
  const float* out_b;      // (Vp)
  const float* mem_valid;  // (n_img, Tm) 1/0
  int* tokens_out;         // (n_img, max_len + 2)
  float* scores_out;       // (n_img, K + 1): running scores, then the best completion's
  T* scratch;              // global route: (n_img, H, n_layers, 2, K, max_len, hd) self caches; else null
  int n_layers, D, H, F, Tm, V, Vp, max_len, sos, eos, pad, tc, on_chip;
};

// elements of one CTA's self-cache slice: every layer's k and v for K lanes x max_len slots x hd
__host__ __device__ inline size_t cache_elems(int K, int D, int H, int max_len, int n_layers) {
  return (size_t)n_layers * 2 * K * max_len * (D / H);
}

// bytes of the slice on chip, rounded up to 16 so the search state after it stays aligned
__host__ __device__ inline size_t cache_bytes(int K, int D, int H, int max_len, int n_layers) {
  return (cache_elems(K, D, H, max_len, n_layers) * sizeof(Storage) + 15) / 16 * 16;
}

// 4-byte words of the search state after the layer's shared memory (and the caches on chip)
size_t state_words(int K, int max_len, int Vp) {
  const size_t lp = (size_t)max_len + 2;
  return 2 * K * lp + 2 * (size_t)K * max_len + lp + (size_t)K * Vp + 2 * (size_t)K * K + 3 * K + 1;
}

size_t smem_bytes(int K, int D, int H, int F, int max_len, int Vp, int n_layers, int on_chip, int tc) {
  return (smem_floats(K, D, H, F, 1, tc, Vec<Storage>::N) + state_words(K, max_len, Vp)) * 4 +
         (on_chip ? cache_bytes(K, D, H, max_len, n_layers) : 0);
}

// One cluster of H CTAs per image; blockIdx.x = img * H + head. One CTA per
// SM: with the registers of two (80 a thread) the loop spills and runs 1.7x
// slower (examples/k3_registers_torch.py, 8 x 3, Tm=128, max_len 64: 6.769 ms
// at 168 registers, 11.593 ms at 80, NVIDIA H100 80GB HBM3, 700 W).
template <int K, typename T>
__global__ void __launch_bounds__(NT, 1) fused_beam_decode_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // paired with the wait before the first DSMEM store
  const int D = a.D, H = a.H, ML = a.max_len, LP = a.max_len + 2, Vp = a.Vp;
  const int hd = D / H;
  const int rank = (int)cluster.block_rank();  // the head
  const int img = blockIdx.x / H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Smem s = carve(smem, K, D, H, a.F, 1, a.tc, Vec<T>::N);
  const size_t slice = (size_t)K * ML * hd;  // one layer's k (or v) of this head
  const size_t cache_n = cache_elems(K, D, H, ML, a.n_layers);
  float* after = smem + smem_floats(K, D, H, a.F, 1, a.tc, Vec<T>::N);
  T* cache = a.on_chip ? reinterpret_cast<T*>(after) : a.scratch + ((size_t)img * H + rank) * cache_n;
  float* logit = a.on_chip ? reinterpret_cast<float*>(reinterpret_cast<char*>(after) +
                                                      cache_bytes(K, D, H, ML, a.n_layers))
                           : after;                                                // [K][Vp]
  float* score = logit + K * Vp;                                                   // [K]
  float* top_lp = score + K;                                                       // [K][K]
  float* best_score = top_lp + K * K;                                              // [1]
  int* tok = reinterpret_cast<int*>(best_score + 1);                               // [K][LP]
  int* tok_nx = tok + K * LP;                                                      // [K][LP]
  int* lin = tok_nx + K * LP;                                                      // [K][ML]
  int* lin_nx = lin + K * ML;                                                      // [K][ML]
  int* best_tok = lin_nx + K * ML;                                                 // [LP]
  int* top_id = best_tok + LP;                                                     // [K][K]
  int* parent = top_id + K * K;                                                    // [K]
  int* new_tok = parent + K;                                                       // [K]

  for (int i = tid; i < K * LP; i += NT) tok[i] = (i % LP == 0) ? a.sos : a.pad;
  for (int i = tid; i < K * ML; i += NT) lin[i] = i / ML;
  for (int i = tid; i < LP; i += NT) best_tok[i] = a.pad;
  if (tid < K) score[tid] = tid == 0 ? 0.f : NEG_INF;  // lane 0 seeds the search
  if (tid == 0) *best_score = NEG_INF;
  __syncthreads();

  LayerIO<T> io;
  io.cache.row_stride = (size_t)ML * hd;
  io.cache.t_stride = hd;
  io.img_row0 = 0;
  io.lane0 = 0;
  io.lin_stride = ML;
  io.mem_valid = a.mem_valid + (size_t)img * a.Tm;
  io.D = D;
  io.H = H;
  io.F = a.F;
  io.S = 1;
  io.Tm = a.Tm;
  const int vw = Vp / H;  // this CTA's head columns: [rank vw, (rank + 1) vw)

  for (int step = 0; step < ML; ++step) {
    // 1. embedding, full rows in every CTA, rounded to T
    for (int i = tid; i < K * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      s.x[i] = round_to<T>(to_f32(a.tok_emb[(size_t)tok[r * LP + step] * D + d]) +
                           to_f32(a.pos_emb[(size_t)step * D + d]));
    }
    __syncthreads();

    // 2. the decoder layers on the cluster
    io.pos = step;
    io.lin = lin;
    for (int li = 0; li < a.n_layers; ++li) {
      const LayerPtrs<T>& lp = a.layer[li];
      io.w = lp.w;
      io.cache.k = cache + 2 * li * slice;
      io.cache.v = cache + (2 * li + 1) * slice;
      io.mem_k = lp.mem_k + (size_t)img * a.Tm * D;
      io.mem_v = lp.mem_v + (size_t)img * a.Tm * D;
      cluster_layer<K, T>(cluster, s, io, step == 0 && li == 0);
      if (sizeof(T) < sizeof(float)) {  // a layer's output is stored in T (the identity in float, skipped)
        for (int i = tid; i < K * D; i += NT) s.x[i] = round_to<T>(s.x[i]);
        __syncthreads();
      }
    }

    // 3. the head: this CTA's columns (of the layer output rounded to T), gathered in every CTA
    matvec_cols<K, T>(a.out_w, Vp, rank * vw, vw, 0, vw, a.out_b, s.x, D, D, s.y, vw, s.red, false);
    scatter_ranks<K>(cluster, 0, H, s.y, vw, logit, Vp, rank * vw, vw);
    cluster.sync();

    // 4-7. the search (beam_search.cuh, which K5 runs a step a launch): each lane's log-softmax and top-K, one
    //      warp per lane; then completions and the next beams, one warp
    if (warp < K) beam::lane_topk(logit + warp * Vp, a.V, K, true, top_lp + warp * K, top_id + warp * K);
    __syncthreads();
    if (warp == 0) {
      int best_lane;
      if (beam::retire(score, top_lp, top_id, K, a.eos, (float)(step + 2), best_score, best_lane)) {
        for (int t = lane; t < LP; t += 32) best_tok[t] = t == step + 1 ? a.eos : tok[best_lane * LP + t];
      }
      float* next = logit;  // the logits are spent: the head writes the next step's
      beam::next_beams(score, top_lp, top_id, K, a.eos, next, parent, new_tok);
      if (lane < K) score[lane] = next[lane];
    }
    __syncthreads();

    // 8. reorder tokens and lineage through the parents; slot `step` of a
    //    lane's history now belongs to its parent
    beam::reorder(tok_nx, tok, parent, K, LP, step + 1, new_tok);
    beam::reorder(lin_nx, lin, parent, K, ML, step, parent);
    __syncthreads();
    int* tmp = tok;
    tok = tok_nx;
    tok_nx = tmp;
    tmp = lin;
    lin = lin_nx;
    lin_nx = tmp;
  }

  if (rank == 0) {
    const bool has_done = *best_score > NEG_INF / 2;
    for (int t = tid; t < LP; t += NT) a.tokens_out[(size_t)img * LP + t] = has_done ? best_tok[t] : tok[t];
    if (tid < K) a.scores_out[(size_t)img * (K + 1) + tid] = score[tid];
    if (tid == 0) a.scores_out[(size_t)img * (K + 1) + K] = *best_score;
  }
  cluster.sync();  // no CTA exits while a peer may still write its shared memory
}

// The launch of n_img clusters of H CTAs, or (query) the number of such
// clusters the card can hold at once, into *resident.
template <int K, typename T>
cudaError_t launch(const Args<T>& a, int n_img, cudaStream_t stream, int* resident = nullptr) {
  const size_t smem = smem_bytes(K, a.D, a.H, a.F, a.max_len, a.Vp, a.n_layers, a.on_chip, a.tc);
  cudaError_t err = cudaFuncSetAttribute(fused_beam_decode_kernel<K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.H > 8) {
    err = cudaFuncSetAttribute(fused_beam_decode_kernel<K, T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_img * a.H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr) {
    return cudaOccupancyMaxActiveClusters(resident, reinterpret_cast<const void*>(fused_beam_decode_kernel<K, T>),
                                          &cfg);
  }
  void* args[] = {const_cast<Args<T>*>(&a)};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(fused_beam_decode_kernel<K, T>), args);
}

}  // namespace

extern "C" int fused_beam_decode_smem_bytes(int K, int D, int H, int F, int max_len, int Vp, int n_layers,
                                            int on_chip, int tc) {
  return (int)smem_bytes(K, D, H, F, max_len, Vp, n_layers, on_chip, tc);
}

// The clusters of one image each that the card holds at once with this
// shared memory (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int fused_beam_decode_resident_clusters(int K, int D, int H, int F, int max_len, int Vp, int n_layers,
                                                   int on_chip, int tc) {
  Args<Storage> a = {};
  a.D = D;
  a.H = H;
  a.F = F;
  a.max_len = max_len;
  a.Vp = Vp;
  a.n_layers = n_layers;
  a.on_chip = on_chip;
  a.tc = tc;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (K) {
    case 2: err = launch<2, Storage>(a, 1, nullptr, &n); break;
    case 3: err = launch<3, Storage>(a, 1, nullptr, &n); break;
    case 4: err = launch<4, Storage>(a, 1, nullptr, &n); break;
    default: break;
  }
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int fused_beam_decode_max_layers() { return MAX_LAYERS; }

// ptrs: tok_emb, pos_emb, out_w, out_b, mem_valid, tokens_out, scores_out,
// scratch (null when on_chip), then for each layer its 18 weights
// (layer_weights order), mem_k, mem_v. Contiguous device pointers, 16-byte
// aligned: the embeddings, out_w, the weight matrices, the memory K/V and
// the scratch of the storage type (bf16 when `bf16`, which must name this
// library's type, else f32), the rest f32 (int32 tokens_out). One cluster of
// H CTAs per image (at most 16); Vp a multiple of the vector width (4 in
// f32, 8 in bf16) times H; D/H and F/H multiples of the vector width, tc of
// 4. Returns a cudaError_t.
extern "C" int fused_beam_decode_launch(void* const* ptrs, int n_img, int K, int n_layers, int D, int H,
                                        int F, int Tm, int V, int Vp, int max_len, int sos, int eos,
                                        int pad, int on_chip, int tc, int bf16, void* stream) {
  using T = Storage;
  const int vw = Vec<T>::N;
  if (bf16 != (int)(sizeof(T) == 2) || n_img < 1 || n_layers < 1 || n_layers > MAX_LAYERS || max_len < 1 ||
      H < 1 || H > 16 || D % H || (D / H) % vw || F % H || (F / H) % vw || Vp % (vw * H) || V > Vp || tc < 4 ||
      tc % 4 || (!on_chip && ptrs[7] == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.tok_emb = static_cast<const T*>(ptrs[0]);
  a.pos_emb = static_cast<const T*>(ptrs[1]);
  a.out_w = static_cast<const T*>(ptrs[2]);
  a.out_b = static_cast<const float*>(ptrs[3]);
  a.mem_valid = static_cast<const float*>(ptrs[4]);
  a.tokens_out = static_cast<int*>(ptrs[5]);
  a.scores_out = static_cast<float*>(ptrs[6]);
  a.scratch = on_chip ? nullptr : static_cast<T*>(ptrs[7]);
  for (int li = 0; li < n_layers; ++li) {
    void* const* p = ptrs + 8 + li * (N_WEIGHTS + 2);
    LayerPtrs<T>& lp = a.layer[li];
    for (int i = 0; i < N_WEIGHTS; ++i) lp.w[i] = p[i];
    lp.mem_k = static_cast<const T*>(p[N_WEIGHTS]);
    lp.mem_v = static_cast<const T*>(p[N_WEIGHTS + 1]);
  }
  a.n_layers = n_layers;
  a.D = D;
  a.H = H;
  a.F = F;
  a.Tm = Tm;
  a.V = V;
  a.Vp = Vp;
  a.max_len = max_len;
  a.sos = sos;
  a.eos = eos;
  a.pad = pad;
  a.tc = tc;
  a.on_chip = on_chip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return (int)launch<2, T>(a, n_img, s);
    case 3: return (int)launch<3, T>(a, n_img, s);
    case 4: return (int)launch<4, T>(a, n_img, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
