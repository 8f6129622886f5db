// One post-LN decoder layer at one decode position, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas/decode_step.py::fused_decoder_layer_step. For the
// B = images x K lanes of a decode batch, in one launch:
//   1. packed self-QKV projection of x (B, D);
//   2. k, v written into the (B, L, D) self caches at slot `pos`, in place;
//      `pos` is read from device memory (one int32), as the TPU kernel reads
//      it from its scalar-prefetch operand, so one captured launch serves
//      every position of a CUDA graph's replays;
//   3. self-attention over slots t <= pos, each slot read through the
//      image-local beam lineage: k_read[b, t] = k[img*K + lin[b, t], t]
//      (slot pos reads the lane's own new k, v); greedy runs without lineage;
//   4. out-projection, residual, LayerNorm 1;
//   5. cross-attention of every lane over its image's single memory K/V
//      (Tm, D), masked by mem_valid;
//   6. out-projection, residual, LayerNorm 2;
//   7. ReLU FFN D -> F -> D, residual, LayerNorm 3;
//   8. optionally (the TPU kernel's `head`) the decode head: logits over
//      the Vp padded vocabulary columns, rounded to the storage type, plus
//      the bias rounded to it, then a log-softmax over the first v_real
//      columns in f32 (the others NEG_INF).
// Softmax and all sums are f32. Slots t > pos are masked in the reference,
// so the kernel reads only t <= pos; that is the same function.
//
// Storage type (the TPU kernel's compute dtype): float or bf16 for x, the
// caches, the memory K/V, the weight matrices and the output; biases and
// LayerNorm parameters, mem_valid and the log-probs are float. The
// rounding points are the TPU kernel's (decoder_cluster.cuh).
//
// What bounds it on the H100: bytes. Per launch it must read the layer's
// weights (about 8.3 MB in f32 at D = 384, F = 1536, half that in bf16),
// the lanes' K/V prefixes and each image's memory K/V (2 x Tm x D elements
// per image); its FLOPs are tiny. At the main path's 1-8 images what a
// launch costs is how many SMs share that reading, and how long each one's
// serial chain of reads and barriers is.
//
// Design: one thread-block cluster of H CTAs (one per attention head) for
// each image and group of up to 8 of its lanes, running the cluster layer of
// decoder_cluster.cuh (K3, decode_loop.cu, runs the same routine at every
// step of its whole beam decode): CTA h owns head h and one H-th of every
// projection's output columns, so each weight byte is read by exactly one
// CTA of the cluster; outputs meet over distributed shared memory with one
// cluster barrier per exchange, and every CTA runs the LayerNorms on full
// rows. This kernel loads x, calls the routine once and writes the CTA's
// D/H output columns. With long memories and few clusters
// (geometry.k2_split) a head takes two CTAs of a 16-CTA cluster, each
// with half the head's columns and half the memory positions. A CTA reads
// slots < pos of any lane of its image (written by earlier launches) and
// slot pos of its own lanes only (from shared memory), so the clusters of
// one image need no synchronisation. The head splits the Vp columns over
// the cluster's CTAs, gathers the logits in every CTA over DSMEM and takes
// each row's log-sum-exp in one warp, in the same order in every CTA.
//
// The storage type is fixed at compile time: the source builds twice,
// with STORAGE_BF16 defined for the bf16 library (ops/kernels/build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decoder_cluster.cuh"  // the cluster layer, its shared-memory layout and helpers

namespace {

using namespace dec;

#ifdef STORAGE_BF16
using Storage = __nv_bfloat16;
#else
using Storage = float;
#endif

constexpr int TC = 512;       // attention positions per chunk
constexpr int MAX_GROUP = 8;  // lanes per cluster

template <typename T>
struct Args {
  const T* x;              // (B, D)
  T* self_k;               // (B, L, D), written at slot pos
  T* self_v;               // (B, L, D)
  const T* mem_k;          // (n_img, Tm, D)
  const T* mem_v;          // (n_img, Tm, D)
  const float* mem_valid;  // (n_img, Tm) 1/0
  const int* lineage;      // (B, lin_stride) image-local parents, or nullptr
  const void* w[N_WEIGHTS];
  T* x_out;                // (B, D)
  const T* head_w;         // (D, Vp), or nullptr: no head
  const float* head_b;     // (Vp)
  float* logp;             // (B, Vp)
  const int* pos;          // the decode position, on the device
  int D, H, F, L, Tm, lin_stride, lanes, split, Vp, v_real;
};

// One cluster of H x S CTAs per (image, group of G lanes); blockIdx.x =
// (img * n_grp + grp) * H * S + rank, rank = head * S + part. With S = 2 the
// two CTAs of a head split its columns of every projection and its memory
// positions.
template <int G, typename T>
__global__ void __launch_bounds__(NT, MinBlocks<T>::value) decoder_layer_step_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // paired with the wait before the first DSMEM store
  const int D = a.D, S = a.split;
  const int ncta = a.H * S;
  const int rank = (int)cluster.block_rank();
  const int hd = D / a.H;
  const int sw = hd / S;
  const int cs = rank * sw;
  const int cl = blockIdx.x / ncta;
  const int n_grp = a.lanes / G;
  const int img = cl / n_grp;
  const int lane0 = (cl - img * n_grp) * G;
  const int img_row0 = img * a.lanes;
  const int row0 = img_row0 + lane0;
  const int tid = threadIdx.x;
  const Smem s = carve(smem, G, D, a.H, a.F, S, TC, Vec<T>::N);

  for (int i = tid; i < G * D; i += NT) s.x[i] = to_f32(a.x[(size_t)row0 * D + i]);
  __syncthreads();

  LayerIO<T> io;
  io.w = a.w;
  io.cache.k = a.self_k + (rank / S) * hd;
  io.cache.v = a.self_v + (rank / S) * hd;
  io.cache.row_stride = (size_t)a.L * D;
  io.cache.t_stride = D;
  io.img_row0 = img_row0;
  io.lane0 = lane0;
  io.lin = a.lineage ? a.lineage + (size_t)row0 * a.lin_stride : nullptr;
  io.lin_stride = a.lin_stride;
  io.mem_k = a.mem_k + (size_t)img * a.Tm * D;
  io.mem_v = a.mem_v + (size_t)img * a.Tm * D;
  io.mem_valid = a.mem_valid + (size_t)img * a.Tm;
  io.D = D;
  io.H = a.H;
  io.F = a.F;
  io.S = S;
  io.Tm = a.Tm;
  io.pos = *a.pos;
  cluster_layer<G, T>(cluster, s, io, true);

  for (int i = tid; i < G * sw; i += NT) {
    const int r = i / sw;
    const int e = i - r * sw;
    a.x_out[(size_t)(row0 + r) * D + cs + e] = from_f32<T>(s.x[r * D + cs + e]);
  }

  if (a.head_w != nullptr) {
    // the head: this CTA's vw logit columns from the layer output rounded to T (matvec_cols rounds its input),
    // the f32 sum rounded to T, the bias rounded to T added and the sum rounded again; gathered into s.a (free
    // since the layer's last exchange) of every CTA
    const int Vp = a.Vp;
    const int vw = Vp / ncta;
    const int c0 = rank * vw;
    matvec_cols<G, T>(a.head_w, Vp, c0, vw, 0, vw, nullptr, s.x, D, D, s.y, vw, s.red, false, true);
    for (int i = tid; i < G * vw; i += NT) {
      const int c = c0 + i % vw;
      const float v = round_to<T>(s.y[i] + round_to<T>(a.head_b[c]));
      s.y[i] = c < a.v_real ? v : NEG_INF;
    }
    __syncthreads();
    scatter_ranks<G>(cluster, 0, ncta, s.y, vw, s.a, Vp, c0, vw);
    cluster.sync();
    // log-sum-exp of each row over every column, one warp a row, the same order in every CTA
    const int warp = tid >> 5;
    const int lane = tid & 31;
    if (warp < G) {
      const float* lr = s.a + warp * Vp;
      float m = NEG_INF;
      for (int c = lane; c < Vp; c += 32) m = fmaxf(m, lr[c]);
      m = warp_max(m);
      float se = 0.f;
      for (int c = lane; c < Vp; c += 32) se += lr[c] != NEG_INF ? expf(lr[c] - m) : 0.f;
      se = warp_sum(se);
      if (lane == 0) s.stat[warp] = logf(se) + m;
    }
    __syncthreads();
    for (int i = tid; i < G * vw; i += NT) {
      const int r = i / vw;
      const int c = c0 + (i - r * vw);
      a.logp[(size_t)(row0 + r) * Vp + c] = c < a.v_real ? s.a[r * Vp + c] - s.stat[r] : NEG_INF;
    }
  }
}

// The launch of n_img x lanes/G clusters of H x S CTAs, or (query) the
// number of such clusters the card can hold at once, into *resident.
template <int G, typename T>
cudaError_t launch(const Args<T>& a, int n_img, cudaStream_t stream, int* resident = nullptr) {
  const size_t smem = smem_floats(G, a.D, a.H, a.F, a.split, TC, Vec<T>::N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decoder_layer_step_kernel<G, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ncta = a.H * a.split;
  if (ncta > 8) {
    err = cudaFuncSetAttribute(decoder_layer_step_kernel<G, T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_img * (a.lanes / G) * ncta);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident != nullptr) {
    return cudaOccupancyMaxActiveClusters(resident, reinterpret_cast<const void*>(decoder_layer_step_kernel<G, T>),
                                          &cfg);
  }
  void* args[] = {const_cast<Args<T>*>(&a)};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decoder_layer_step_kernel<G, T>), args);
}

template <typename T>
int launch_group(const Args<T>& a, int group, int n_img, cudaStream_t s, int* resident = nullptr) {
  switch (group) {
    case 1: return (int)launch<1, T>(a, n_img, s, resident);
    case 2: return (int)launch<2, T>(a, n_img, s, resident);
    case 3: return (int)launch<3, T>(a, n_img, s, resident);
    case 4: return (int)launch<4, T>(a, n_img, s, resident);
    case 5: return (int)launch<5, T>(a, n_img, s, resident);
    case 6: return (int)launch<6, T>(a, n_img, s, resident);
    case 7: return (int)launch<7, T>(a, n_img, s, resident);
    default: return (int)launch<8, T>(a, n_img, s, resident);
  }
}

template <typename T>
int fill_and_launch(void* const* ptrs, const int* pos, int n_img, int lanes, int group, int D, int H, int F, int L,
                    int Tm, int lin_stride, int split, int Vp, int v_real, cudaStream_t s) {
  Args<T> a;
  a.x = static_cast<const T*>(ptrs[0]);
  a.self_k = static_cast<T*>(ptrs[1]);
  a.self_v = static_cast<T*>(ptrs[2]);
  a.mem_k = static_cast<const T*>(ptrs[3]);
  a.mem_v = static_cast<const T*>(ptrs[4]);
  a.mem_valid = static_cast<const float*>(ptrs[5]);
  a.lineage = static_cast<const int*>(ptrs[6]);
  for (int i = 0; i < N_WEIGHTS; ++i) a.w[i] = ptrs[7 + i];
  a.x_out = static_cast<T*>(ptrs[7 + N_WEIGHTS]);
  a.head_w = static_cast<const T*>(ptrs[8 + N_WEIGHTS]);
  a.head_b = static_cast<const float*>(ptrs[9 + N_WEIGHTS]);
  a.logp = static_cast<float*>(ptrs[10 + N_WEIGHTS]);
  a.D = D;
  a.H = H;
  a.F = F;
  a.L = L;
  a.Tm = Tm;
  a.pos = pos;
  a.lin_stride = lin_stride;
  a.lanes = lanes;
  a.split = split;
  a.Vp = Vp;
  a.v_real = v_real;
  return launch_group<T>(a, group, n_img, s);
}

}  // namespace

// vw: 4 for float storage, 8 for bf16 (the elements of a 16-byte vector)
extern "C" int decoder_layer_step_smem_bytes(int group, int D, int H, int F, int split, int vw) {
  return (int)(smem_floats(group, D, H, F, split, TC, vw) * sizeof(float));
}

// The clusters of `group` lanes and H x split CTAs that the card holds at
// once with this library's registers and the launch's shared memory
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int decoder_layer_step_resident_clusters(int group, int D, int H, int F, int split) {
  if (group < 1 || group > MAX_GROUP || H < 1 || split < 1 || split > 2 || H * split > 16 || D % H)
    return -(int)cudaErrorInvalidValue;
  Args<Storage> a = {};
  a.D = D;
  a.H = H;
  a.F = F;
  a.lanes = group;
  a.split = split;
  int n = 0;
  const int err = launch_group<Storage>(a, group, 1, nullptr, &n);
  return err == (int)cudaSuccess ? n : -err;
}

// ptrs: x, self_k, self_v, mem_k, mem_v, mem_valid, lineage (may be null),
// the 18 layer weights in layer_weights order, x_out, head_w, head_b, logp
// (the last three null without the head). pos: a device int32, the
// position, 0 <= pos < lin_stride (the window), which the caller checks:
// the kernel reads it and cannot report it. Contiguous device pointers,
// 16-byte aligned: x, caches, memory K/V, weight matrices, x_out and head_w
// of the storage type (bf16 when `bf16`, which must name this library's
// type, else f32), every other operand
// f32 (int32 lineage). `group` lanes per cluster (1..8, dividing lanes),
// H x split CTAs per cluster (at most 16, split 1 or 2), D/(H split) and
// F/(H split) multiples of the vector width (4 in f32, 8 in bf16), Vp a
// multiple of it times H split and at most D. Returns a cudaError_t.
extern "C" int decoder_layer_step_launch(void* const* ptrs, const int* pos, int n_img, int lanes, int group, int D,
                                         int H, int F, int L, int Tm, int lin_stride, int split, int bf16, int Vp,
                                         int v_real, void* stream) {
  const int vw = bf16 ? 8 : 4;
  const bool head = ptrs[8 + N_WEIGHTS] != nullptr;
  if (lanes < 1 || group < 1 || group > MAX_GROUP || lanes % group || H < 1 || split < 1 || split > 2 ||
      H * split > 16 || D % H || F % (H * split) || (D / H) % (vw * split) || (F / (H * split)) % vw ||
      (head && (Vp % (vw * H * split) || Vp > D || v_real < 1 || v_real > Vp)) || pos == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bf16 != (int)(sizeof(Storage) == 2)) return (int)cudaErrorInvalidValue;  // the other library's storage type
  return fill_and_launch<Storage>(ptrs, pos, n_img, lanes, group, D, H, F, L, Tm, lin_stride, split, Vp, v_real,
                                  static_cast<cudaStream_t>(stream));
}

