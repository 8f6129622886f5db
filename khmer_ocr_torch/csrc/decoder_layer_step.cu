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
// Tm = 4096); its FLOPs are tiny. At the main path's 1-8 images what a
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
// one image need no synchronisation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decoder_cluster.cuh"  // the cluster layer, its shared-memory layout and helpers

namespace {

using namespace dec;

constexpr int TC = 512;       // attention positions per chunk
constexpr int MAX_GROUP = 8;  // lanes per cluster

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
  int D, H, F, L, Tm, pos, lin_stride, lanes, split;
};

// One cluster of H x S CTAs per (image, group of G lanes); blockIdx.x =
// (img * n_grp + grp) * H * S + rank, rank = head * S + part. With S = 2 the
// two CTAs of a head split its columns of every projection and its memory
// positions.
template <int G>
__global__ void __launch_bounds__(NT, 2) decoder_layer_step_kernel(const __grid_constant__ Args a) {
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
  const Smem s = carve(smem, G, D, a.H, a.F, S, TC);

  for (int i = tid; i < G * D; i += NT) s.x[i] = a.x[(size_t)row0 * D + i];
  __syncthreads();

  LayerIO io;
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
  io.pos = a.pos;
  cluster_layer<G>(cluster, s, io, true);

  for (int i = tid; i < G * sw; i += NT) {
    const int r = i / sw;
    const int e = i - r * sw;
    a.x_out[(size_t)(row0 + r) * D + cs + e] = s.x[r * D + cs + e];
  }
}

template <int G>
cudaError_t launch(const Args& a, int n_img, cudaStream_t stream) {
  const size_t smem = smem_floats(G, a.D, a.H, a.F, a.split, TC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decoder_layer_step_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ncta = a.H * a.split;
  if (ncta > 8) {
    err = cudaFuncSetAttribute(decoder_layer_step_kernel<G>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  void* args[] = {const_cast<Args*>(&a)};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decoder_layer_step_kernel<G>), args);
}

}  // namespace

extern "C" int decoder_layer_step_smem_bytes(int group, int D, int H, int F, int split) {
  return (int)(smem_floats(group, D, H, F, split, TC) * sizeof(float));
}

// ptrs: x, self_k, self_v, mem_k, mem_v, mem_valid, lineage (may be null),
// the 18 layer weights in layer_weights order, x_out. Contiguous f32 (int32
// lineage) device pointers, 16-byte aligned. `group` lanes per cluster
// (1..8, dividing lanes), H x split CTAs per cluster (at most 16, split 1 or
// 2), D/(H split) and F/(H split) multiples of 4. Returns a cudaError_t.
extern "C" int decoder_layer_step_launch(void* const* ptrs, int n_img, int lanes, int group, int D, int H, int F,
                                         int L, int Tm, int pos, int lin_stride, int split, void* stream) {
  if (lanes < 1 || group < 1 || group > MAX_GROUP || lanes % group || H < 1 || split < 1 || split > 2 ||
      H * split > 16 || D % H || F % (H * split) || (D / H) % (4 * split) || (F / (H * split)) % 4)
    return (int)cudaErrorInvalidValue;
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
  a.lanes = lanes;
  a.split = split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1: return (int)launch<1>(a, n_img, s);
    case 2: return (int)launch<2>(a, n_img, s);
    case 3: return (int)launch<3>(a, n_img, s);
    case 4: return (int)launch<4>(a, n_img, s);
    case 5: return (int)launch<5>(a, n_img, s);
    case 6: return (int)launch<6>(a, n_img, s);
    case 7: return (int)launch<7>(a, n_img, s);
    default: return (int)launch<8>(a, n_img, s);
  }
}
