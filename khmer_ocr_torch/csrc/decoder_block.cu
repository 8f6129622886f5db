// Tensor-parallel blocks of one post-LN decoder layer at one decode
// position, for Hopper (sm_90a): the model-group form of kernel K2
// (decoder_layer_step.cu), which replaces the JAX package's Pallas TPU
// kernel ops/pallas/decode_step.py::fused_decoder_layer_step.
//
// Tensor-parallel blocks (decoder_block_launch): under a model group of M
// ranks each rank holds H/M heads, D/M columns of q, k, v and of the cross
// q, the matching D/M rows of both out-projections, F/M columns of the
// first FFN weight and rows of the second. Post-LN needs the whole sum
// before each LayerNorm, so a layer runs as three launches, each ending in
// a (B, D) partial sum that the caller all-reduces over the group:
//   self:  [prologue] the local heads' q, k, v, the cache slot written in
//          place, self-attention through the lineage, the partial
//          out-projection;
//   cross: prologue residual + bias + LN1, the local heads' cross q and
//          attention over the local memory K/V columns, the partial out-
//          projection;
//   ffn:   prologue residual + bias + LN2, the FFN over the local columns,
//          the partial second product (reduce-scatter over DSMEM).
// The prologue is x = LN(x + (partial + bias)) on full rows in every CTA;
// the self block's prologue is the previous layer's LN3 (rounded to the
// storage type, the layer's output), and a fourth kind, finish, runs only
// the last layer's LN3. The cluster is the H/M local heads, one CTA each,
// or two under K2's k2_split (long memories, few clusters): the two CTAs
// of a head split its columns of every projection, both run its
// self-attention, and in the cross block each takes half the memory
// positions, the halves merged by their log-sum-exp, as K2's layer does.
//
// What bounds it: bytes, as K2: each launch reads one third of the rank's
// share of the layer's weights (1/M of them in all) and, for the self and
// cross blocks, the local heads' columns of the caches and of the memory
// K/V. Storage type, rounding points and helpers are K2's
// (decoder_cluster.cuh); the source builds twice, with STORAGE_BF16 defined
// for the bf16 library.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decoder_cluster.cuh"  // matvec_cols, attend_head, scatter_ranks, residual_ln

namespace {

using namespace dec;

#ifdef STORAGE_BF16
using Storage = __nv_bfloat16;
#else
using Storage = float;
#endif

constexpr int TC = 512;       // attention positions per chunk
constexpr int MAX_GROUP = 8;  // lanes per cluster

enum { FINISH = 0, SELF_BLOCK = 1, CROSS_BLOCK = 2, FFN_BLOCK = 3 };

template <typename T>
struct BlockArgs {
  int mode;
  const float* x;          // (B, D) the residual entering the block
  const float* part;       // (B, D) the all-reduced partial sum of the block before, or nullptr (no prologue)
  const float* pb;         // (D) the bias added to it, then LayerNorm (ln_s, ln_b)
  const float* ln_s;
  const float* ln_b;
  int round_x;             // round the prologue's output to T (the self block's, and finish: a layer's output)
  float* x_out;            // (B, D) the block's residual, after the prologue
  float* part_out;         // (B, D) the block's partial sum (not finish)
  T* self_k;               // (B, L, DA) local heads' caches, written at slot pos (self)
  T* self_v;
  const T* mem_k;          // (n_img, Tm, DA) local heads' memory K/V (cross)
  const T* mem_v;
  const float* mem_valid;  // (n_img, Tm)
  const int* lineage;      // (B, lin_stride) or nullptr
  const T* w0;             // self: qkv_w (D, 3 DA); cross: cq_w (D, DA); ffn: l1_w (D, Fl)
  const float* b0;         // self: qkv_b (3 DA); cross: cq_b (DA); ffn: l1_b (Fl)
  const T* w1;             // self: so_w (DA, D); cross: co_w (DA, D); ffn: l2_w (Fl, D)
  int D, DA, hd, Fl, L, Tm, pos, lin_stride, lanes, split;
};

__host__ __device__ inline size_t block_red_floats(int G, int D, int hd, int fs, int vw) {
  size_t n = (size_t)vw * NT;
  const size_t cols[3] = {(size_t)D, 3 * (size_t)hd, (size_t)fs};
  for (size_t c : cols) n = c > n ? c : n;
  return (size_t)G * n;
}

// x [G][D], qkv [G][3hd], a [G][DA], y [G][D], hid [G][fs], part [G][D], p [G][tc], aux [G][tc], the S > 1
// merge slots (xo_floats), red, stat [4G]
__host__ __device__ inline size_t block_smem_floats(int G, int D, int DA, int hd, int Fl, int S, int tc, int vw) {
  const int ncta = DA / hd * S;
  const int fs = Fl / ncta;
  return (size_t)G * (3 * (size_t)D + 3 * hd + DA + fs + 2 * (size_t)tc) + xo_floats(G, hd, 1, S) +
         block_red_floats(G, D, hd, fs, vw) + 4 * (size_t)G;
}

template <int G, typename T>
__global__ void __launch_bounds__(NT, MinBlocks<T>::value) decoder_block_kernel(const __grid_constant__ BlockArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // paired with the wait before the first DSMEM store
  const int D = a.D, DA = a.DA, hd = a.hd, S = a.split;
  const int ncta = DA / hd * S;
  const int rank = (int)cluster.block_rank();
  const int head = rank / S;      // the local head; with S = 2 its two CTAs split its columns and positions
  const int part = rank - head * S;
  const int sw = hd / S;          // this CTA's columns of the head: [head hd + part sw, + sw)
  const int ow = D / ncta;        // this CTA's columns of a D-wide output: [rank ow, (rank + 1) ow)
  const int fs = a.Fl / ncta;     // this CTA's FFN hidden columns
  const int cl = blockIdx.x / ncta;
  const int n_grp = a.lanes / G;
  const int img = cl / n_grp;
  const int lane0 = (cl - img * n_grp) * G;
  const int img_row0 = img * a.lanes;
  const int row0 = img_row0 + lane0;
  const int tid = threadIdx.x;

  Smem s;
  s.tc = TC;
  s.x = smem;
  s.qkv = s.x + G * D;
  s.a = s.qkv + G * 3 * hd;
  s.y = s.a + G * DA;
  s.hid = s.y + G * D;
  s.part = s.hid + G * fs;
  s.p = s.part + G * D;
  s.aux = reinterpret_cast<int*>(s.p + G * TC);
  s.xo = s.p + 2 * G * TC;
  s.red = s.xo + xo_floats(G, hd, 1, S);
  s.stat = s.red + block_red_floats(G, D, hd, fs, Vec<T>::N);
  s.t = nullptr;

  // prologue on full rows, the same bits in every CTA
  for (int i = tid; i < G * D; i += NT) {
    s.x[i] = a.x[(size_t)row0 * D + i];
    if (a.part != nullptr) s.y[i] = a.part[(size_t)row0 * D + i] + a.pb[i % D];
  }
  __syncthreads();
  if (a.part != nullptr) residual_ln<G>(s.x, s.y, a.ln_s, a.ln_b, D);
  if (a.round_x) {
    for (int i = tid; i < G * D; i += NT) s.x[i] = round_to<T>(s.x[i]);
    __syncthreads();
  }
  for (int i = tid; i < G * ow; i += NT) {
    const int r = i / ow;
    const int c = rank * ow + (i - r * ow);
    a.x_out[(size_t)(row0 + r) * D + c] = s.x[r * D + c];
  }
  if (a.mode == FINISH) {
    cluster_wait();
    return;
  }

  HeadRows<T> src;
  src.lin = a.lineage ? a.lineage + (size_t)row0 * a.lin_stride : nullptr;
  src.own = s.qkv;
  src.lin_stride = a.lin_stride;
  src.img_row0 = img_row0;
  src.lane0 = lane0;
  src.pos = a.pos;
  src.hd = hd;
  if (a.mode == SELF_BLOCK || a.mode == CROSS_BLOCK) {
    const int c0 = head * hd + part * sw;  // this CTA's columns of the local width DA
    const float* ho = s.y;                 // this CTA's sw columns of the head's output, row stride ho_ld
    int ho_ld = hd;
    if (a.mode == SELF_BLOCK) {
      // this CTA's columns of its head's q, k, v (rounded to T) and of cache slot pos; with S = 2 the two halves
      // meet in both CTAs of the head; self-attention through the lineage
      float* own = S == 1 ? s.qkv : s.y;  // [G][3 sw]
      matvec_cols<G, T>(a.w0, 3 * DA, c0, sw, DA, 3 * sw, a.b0, s.x, D, D, own, 3 * sw, s.red, false, true);
      const size_t row_stride = (size_t)a.L * DA;
      for (int i = tid; i < G * sw; i += NT) {
        const int r = i / sw;
        const int e = i - r * sw;
        const size_t off = (size_t)(row0 + r) * row_stride + (size_t)a.pos * DA + c0 + e;
        a.self_k[off] = from_f32<T>(own[r * 3 * sw + sw + e]);
        a.self_v[off] = from_f32<T>(own[r * 3 * sw + 2 * sw + e]);
      }
      cluster_wait();  // every CTA of the cluster has started
      if (S > 1) {
        for (int seg = 0; seg < 3; ++seg)
          scatter_ranks<G>(cluster, head * S, S, s.y + seg * sw, 3 * sw, s.qkv, 3 * hd, seg * hd + part * sw, sw);
        cluster.sync();
      }
      src.k = a.self_k + head * hd;
      src.v = a.self_v + head * hd;
      src.row_stride = row_stride;
      src.t_stride = DA;
      attend_head<G, false, T>(s, s.qkv, 3 * hd, 0, a.pos + 1, src, nullptr, s.y, true);
      ho = s.y + part * sw;
    } else {
      // the head's cross q (rounded to T; with S = 2 each CTA computes half and the halves meet), its attention
      // over the local memory K/V columns; with S = 2 each CTA takes half the positions, and the halves merge by
      // their log-sum-exp in the order of the CTAs
      if (S == 1) {
        matvec_cols<G, T>(a.w0, DA, c0, hd, 0, hd, a.b0, s.x, D, D, s.qkv, hd, s.red, false, true);
        cluster_wait();
      } else {
        matvec_cols<G, T>(a.w0, DA, c0, sw, 0, sw, a.b0, s.x, D, D, s.y, sw, s.red, false, true);
        cluster_wait();
        scatter_ranks<G>(cluster, head * S, S, s.y, sw, s.qkv, hd, part * sw, sw);
        cluster.sync();
      }
      src.k = a.mem_k + (size_t)img * a.Tm * DA + head * hd;
      src.v = a.mem_v + (size_t)img * a.Tm * DA + head * hd;
      src.row_stride = 0;
      src.t_stride = DA;
      const int per = (a.Tm + S - 1) / S;
      const int tb = min(a.Tm, part * per);
      attend_head<G, true, T>(s, s.qkv, hd, tb, min(a.Tm, tb + per), src, a.mem_valid + (size_t)img * a.Tm, s.y,
                              S == 1);
      if (S > 1) {
        // (o, m, l) of this CTA's positions into slot `part` of both CTAs of the head
        const int slot = G * hd + 4 * G;
        for (int i = tid; i < S * (G * hd / 4 + G); i += NT) {
          const int q = head * S + i / (G * hd / 4 + G);
          const int j = i % (G * hd / 4 + G);
          float* dst = s.xo + part * slot;
          if (j < G * hd / 4) {
            *cluster.map_shared_rank(reinterpret_cast<float4*>(dst) + j, q) = reinterpret_cast<const float4*>(s.y)[j];
          } else {
            const int r = j - G * hd / 4;
            float* ml = cluster.map_shared_rank(dst + G * hd, q);
            ml[r] = s.stat[r];
            ml[G + r] = s.stat[G + r];
          }
        }
        cluster.sync();
        for (int i = tid; i < G * sw; i += NT) {
          const int r = i / sw;
          const int e = part * sw + (i - r * sw);
          float mx = NEG_INF;
          for (int p = 0; p < S; ++p) mx = fmaxf(mx, s.xo[p * slot + G * hd + r]);
          float lsum = 0.f, o = 0.f;
          for (int p = 0; p < S; ++p) {
            const float c = expf(s.xo[p * slot + G * hd + r] - mx);
            lsum += s.xo[p * slot + G * hd + G + r] * c;
            o += s.xo[p * slot + r * hd + e] * c;
          }
          s.part[i] = o / lsum;  // s.part is free in this block
        }
        __syncthreads();
        ho = s.part;
        ho_ld = sw;
      }
    }
    scatter_ranks<G>(cluster, 0, ncta, ho, ho_ld, s.a, DA, c0, sw);
    cluster.sync();
    // the partial out-projection: this CTA's ow columns from the local heads' DA rows
    matvec_cols<G, T>(a.w1, D, rank * ow, ow, 0, ow, nullptr, s.a, DA, DA, s.y, ow, s.red, false);
    for (int i = tid; i < G * ow; i += NT) {
      const int r = i / ow;
      a.part_out[(size_t)(row0 + r) * D + rank * ow + (i - r * ow)] = s.y[i];
    }
    return;
  }

  // FFN block: this CTA's hidden slice, its partial of the output, reduce-scatter in CTA order
  matvec_cols<G, T>(a.w0, a.Fl, rank * fs, fs, 0, fs, a.b0, s.x, D, D, s.hid, fs, s.red, true);
  matvec_cols<G, T>(a.w1 + (size_t)rank * fs * D, D, 0, D, 0, D, nullptr, s.hid, fs, fs, s.y, D, s.red, false);
  cluster_wait();
  {
    const int n4 = ow >> 2;
    for (int i = tid; i < ncta * G * n4; i += NT) {
      const int q = i / (G * n4);
      const int j = i - q * G * n4;
      const int r = j / n4;
      const int e = 4 * (j - r * n4);
      const float4 v = *reinterpret_cast<const float4*>(s.y + r * D + q * ow + e);
      *cluster.map_shared_rank(reinterpret_cast<float4*>(s.part + (rank * G + r) * ow + e), q) = v;
    }
  }
  cluster.sync();
  for (int i = tid; i < G * ow; i += NT) {
    float v = 0.f;
    for (int q = 0; q < ncta; ++q) v += s.part[q * G * ow + i];
    const int r = i / ow;
    a.part_out[(size_t)(row0 + r) * D + rank * ow + (i - r * ow)] = v;
  }
}

// The launch, or (query) the clusters the card holds at once, into *resident.
template <int G, typename T>
cudaError_t launch_block(const BlockArgs<T>& a, int n_img, cudaStream_t stream, int* resident = nullptr) {
  const size_t smem = block_smem_floats(G, a.D, a.DA, a.hd, a.Fl, a.split, TC, Vec<T>::N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decoder_block_kernel<G, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int ncta = a.DA / a.hd * a.split;
  if (ncta > 8) {
    err = cudaFuncSetAttribute(decoder_block_kernel<G, T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
    return cudaOccupancyMaxActiveClusters(resident, reinterpret_cast<const void*>(decoder_block_kernel<G, T>), &cfg);
  }
  void* args[] = {const_cast<BlockArgs<T>*>(&a)};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decoder_block_kernel<G, T>), args);
}

template <typename T>
int fill_and_launch_block(void* const* ptrs, int mode, int round_x, int n_img, int lanes, int group, int D, int DA,
                          int hd, int Fl, int L, int Tm, int pos, int lin_stride, int split, cudaStream_t s) {
  BlockArgs<T> a;
  a.mode = mode;
  a.x = static_cast<const float*>(ptrs[0]);
  a.part = static_cast<const float*>(ptrs[1]);
  a.pb = static_cast<const float*>(ptrs[2]);
  a.ln_s = static_cast<const float*>(ptrs[3]);
  a.ln_b = static_cast<const float*>(ptrs[4]);
  a.x_out = static_cast<float*>(ptrs[5]);
  a.part_out = static_cast<float*>(ptrs[6]);
  a.self_k = static_cast<T*>(ptrs[7]);
  a.self_v = static_cast<T*>(ptrs[8]);
  a.mem_k = static_cast<const T*>(ptrs[9]);
  a.mem_v = static_cast<const T*>(ptrs[10]);
  a.mem_valid = static_cast<const float*>(ptrs[11]);
  a.lineage = static_cast<const int*>(ptrs[12]);
  a.w0 = static_cast<const T*>(ptrs[13]);
  a.b0 = static_cast<const float*>(ptrs[14]);
  a.w1 = static_cast<const T*>(ptrs[15]);
  a.round_x = round_x;
  a.D = D;
  a.DA = DA;
  a.hd = hd;
  a.Fl = Fl;
  a.L = L;
  a.Tm = Tm;
  a.pos = pos;
  a.lin_stride = lin_stride;
  a.lanes = lanes;
  a.split = split;
  switch (group) {
    case 1: return (int)launch_block<1, T>(a, n_img, s);
    case 2: return (int)launch_block<2, T>(a, n_img, s);
    case 3: return (int)launch_block<3, T>(a, n_img, s);
    case 4: return (int)launch_block<4, T>(a, n_img, s);
    case 5: return (int)launch_block<5, T>(a, n_img, s);
    case 6: return (int)launch_block<6, T>(a, n_img, s);
    case 7: return (int)launch_block<7, T>(a, n_img, s);
    default: return (int)launch_block<8, T>(a, n_img, s);
  }
}

}  // namespace

extern "C" int decoder_block_smem_bytes(int group, int D, int DA, int hd, int Fl, int split, int vw) {
  return (int)(block_smem_floats(group, D, DA, hd, Fl, split, TC, vw) * sizeof(float));
}

// The clusters of `group` lanes and DA/hd x split CTAs that the card holds
// at once with this library's registers and the launch's shared memory
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int decoder_block_resident_clusters(int group, int D, int DA, int hd, int Fl, int split) {
  const int ncta = hd > 0 ? DA / hd * split : 0;
  if (group < 1 || group > MAX_GROUP || split < 1 || split > 2 || ncta < 1 || ncta > 16)
    return -(int)cudaErrorInvalidValue;
  BlockArgs<Storage> a = {};
  a.D = D;
  a.DA = DA;
  a.hd = hd;
  a.Fl = Fl;
  a.lanes = group;
  a.split = split;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (group) {
    case 1: err = launch_block<1, Storage>(a, 1, nullptr, &n); break;
    case 2: err = launch_block<2, Storage>(a, 1, nullptr, &n); break;
    case 3: err = launch_block<3, Storage>(a, 1, nullptr, &n); break;
    case 4: err = launch_block<4, Storage>(a, 1, nullptr, &n); break;
    case 5: err = launch_block<5, Storage>(a, 1, nullptr, &n); break;
    case 6: err = launch_block<6, Storage>(a, 1, nullptr, &n); break;
    case 7: err = launch_block<7, Storage>(a, 1, nullptr, &n); break;
    default: err = launch_block<8, Storage>(a, 1, nullptr, &n); break;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// One tensor-parallel block (mode 0 finish, 1 self, 2 cross, 3 ffn) of the
// local heads. ptrs: x, part (null: no prologue), pb, ln_s, ln_b, x_out,
// part_out, self_k, self_v, mem_k, mem_v, mem_valid, lineage, w0, b0, w1
// (the unused ones may be null). x, part, x_out, part_out and the vectors
// f32; caches, memory K/V and w0, w1 of the storage type (bf16 when `bf16`,
// which must name this library's type). One cluster of DA/hd x split CTAs
// (at most 16; split 1 or 2, K2's k2_split) per image and group of lanes;
// hd/split, D/CTAs and Fl/CTAs multiples of the vector width (4 in f32, 8
// in bf16). Returns a cudaError_t.
extern "C" int decoder_block_launch(void* const* ptrs, int mode, int round_x, int n_img, int lanes, int group, int D,
                                    int DA, int hd, int Fl, int L, int Tm, int pos, int lin_stride, int split,
                                    int bf16, void* stream) {
  const int vw = Vec<Storage>::N;
  const int ncta = hd > 0 ? DA / hd * split : 0;
  if (bf16 != (int)(sizeof(Storage) == 2) || mode < FINISH || mode > FFN_BLOCK || lanes < 1 || group < 1 ||
      group > MAX_GROUP || lanes % group || split < 1 || split > 2 || ncta < 1 || ncta > 16 || DA % hd ||
      D % ncta || Fl % ncta || hd % (vw * split) || (D / ncta) % vw || (Fl / ncta) % vw ||
      (mode == FINISH && ptrs[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  return fill_and_launch_block<Storage>(ptrs, mode, round_x, n_img, lanes, group, D, DA, hd, Fl, L, Tm, pos,
                                        lin_stride, split, static_cast<cudaStream_t>(stream));
}
