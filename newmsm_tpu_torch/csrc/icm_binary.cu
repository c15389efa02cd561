// Binary ICM of one fusion move (K2): every start's exact parallel
// coordinate descent and its binary energy, in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this loop inside one XLA
// program, where it costs no launches. Eagerly in PyTorch the plain version
// (newmsm_tpu_torch/reg/optimise/fusion.py::_binary_icm + binary_energy)
// is icm_passes x colours dependent colour steps of ~39 small operations
// each, 780-936 launches a move, each touching a few thousand elements:
// the host's dispatch paced the pairwise and group optimisers, the card
// idle ~90 % of the time. This kernel makes the whole move's descent one
// launch.
//
// What it computes, step for step as the plain version, in float32:
//   for pass in icm_passes, for colour c in order, for each node v of c:
//     delta = (u1[v] - u0[v])
//             + sum over v's triplet incidences m = 0..MT-1 of
//               (t8[r, i1] - t8[r, i0]) * (incidence m real ? 1 : 0)
//             + sum over v's pair incidences the same on p4;
//     x[v] = delta < 0.
//   A padded incidence (-1) reads row 0 with its padded own-corner and is
//   multiplied by 0, as the plain version does, so a NaN or an infinite
//   difference in row 0 has the same effect in both. Then the start's
//   energy, (sum of the chosen unaries + sum of t8 at each triplet's
//   combination) + sum of p4 at each pair's combination. The arithmetic
//   goes through __fadd_rn / __fsub_rn / __fmul_rn, which are never
//   contracted into an FMA. The sums over incidences run in incidence
//   order and the energy's in a fixed block-reduction order: no atomics
//   anywhere, so the kernel repeats itself bit for bit.
//
// What bounds it on this card: neither bytes nor operations. A move at
// ico-4 reads ~0.6 MB of tables and does ~0.3 Mflop. The bound is the
// chain of icm_passes x colours dependent steps (20 on the strain path at
// ico-4, 44 on the group's at S = 8), each a barrier after a few dependent
// loads (node id, incidence, row members, their bits, two table entries)
// at data-dependent rows. Those gathers hit a new 32-byte sector in
// nearly every lane, so a step's time is the L1 wavefronts its nodes need
// on the SMs that run it. The design:
//   * One thread block cluster of kCluster blocks a start (S = 3 fixed
//     starts + restarts), on kCluster SMs, which split every colour
//     group's nodes: the gathers of a step go through kCluster L1s at
//     once (measured on the H100 at the gmsm_s8 shape: 2.2 ms a move with
//     one 1024-thread block a start, 0.61 ms with clusters of 8).
//   * A colour group is an independent set, so its nodes update together,
//     and a node's write of its own bit cannot change another node's delta
//     in the same step; a cluster barrier separates colours.
//   * Every block keeps the start's whole x in its shared memory as bytes
//     (N bytes) and a node's new bit is stored into all kCluster copies
//     (distributed shared memory), so every read of a bit is local. Where
//     N bytes do not fit, the same code (a template choice made on N by
//     the launcher) reads and writes the start's int64 row in device
//     memory through L2.
//   * A node's incidences go in chunks whose loads are all issued before
//     any is used (incidence_sum).
//   * The forms are compile-time variants: triplet tables only (strain,
//     anatomical, triclique), pair tables only (regoption 1), or both (the
//     group alpha step, whose unaries are zero), so no step tests a flag.
// What the card offers and this kernel does not use: tensor cores and TMA
// (gathers of a few bytes at data-dependent rows); the other SMs (one
// cluster a start; a start over more SMs would need clusters beyond the
// portable 8 or a grid barrier a step).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// blocks a start (a thread block cluster) and threads a block
constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// x of a start in shared memory up to this many nodes (bytes); the H100
// gives a block up to 227 KB, above 48 KB only after opting in
constexpr int kSharedMax = 160 * 1024;
constexpr int kDefaultShared = 48 * 1024;
// incidences whose loads go out together (a vertex of an ico grid is in
// at most 6 triplets; a group node's pair incidences run to ~20)
constexpr int kTripletChunk = 6;
constexpr int kPairChunk = 4;

struct Args {
  long long* x;                // (S,N) int64 0/1: the starts in, results out
  float* es;                   // (S,) energies out
  int n;                       // N nodes
  const float* u0;             // (N,)
  const float* u1;             // (N,)
  const float* t8;             // (T,8)
  const long long* trip;       // (T,3)
  const long long* vert_tri;   // (N,MT) incident triplet ids, -1 padded
  const long long* vert_corner;  // (N,MT) own corner in the triplet
  int mt;
  long long nt;                // T
  const float* p4;             // (P,4)
  const long long* pairs;      // (P,2)
  const long long* vert_pair;  // (N,MP) incident pair ids, -1 padded
  const long long* vert_end;   // (N,MP) own end in the pair
  int mp;
  long long np;                // P
  const int* color_ids;        // the colour groups, concatenated
  const int* color_offsets;    // (C+1,)
  int colors;                  // C
  int passes;
};

// a start's bits: this block's copy in shared memory, or the start's int64
// row in device memory, read past L1 (other SMs of the cluster write it)
template <bool SHARED>
struct Bits {
  unsigned char* s;
  long long* g;
  __device__ __forceinline__ int get(long long i) const {
    return SHARED ? (int)s[i] : (int)__ldcg(g + i);
  }
};

// sum of v over the block in a fixed order (warp shuffles, then the warp
// partials by warp 0); the result is in thread 0. Every thread calls it.
__device__ float block_sum(float v, float* partial) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // partial may still be read by the previous call
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

// sum over a node's incidences m = 0..count-1 of
//   (table[r, i1] - table[r, i0]) * (incidence m real ? 1 : 0),
// r its row (-1 padding reads row 0), W members a row, in order of m. The
// rows go in chunks of CHUNK whose loads are all issued before any of
// them is used, so a chunk costs the latency of one chain of loads
// (incidence -> members -> bits -> table) and not CHUNK of them.
template <int W, int CHUNK, bool SHARED>
__device__ __forceinline__ float incidence_sum(
    const Bits<SHARED>& x, const long long* inc, const long long* own_at,
    int count, const long long* members, const float* table) {
  constexpr int kCombos = 1 << W;
  float sum = 0.f;
  for (int m0 = 0; m0 < count; m0 += CHUNK) {
    int row[CHUNK], own[CHUNK], i0[CHUNK], w[CHUNK];
    float mask[CHUNK], lo[CHUNK], hi[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const bool live = m0 + k < count;
      const long long id = live ? inc[m0 + k] : 0;
      row[k] = id < 0 ? 0 : (int)id;
      own[k] = live ? (int)own_at[m0 + k] : 0;
      mask[k] = id >= 0 ? 1.f : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      int b[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        b[j] = x.get(members[(long long)W * row[k] + j]);
      int base = 0, bit = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        base = base * 2 + b[j];
        bit = own[k] == j ? b[j] : bit;
      }
      w[k] = 1 << (W - 1 - own[k]);
      i0[k] = base - bit * w[k];
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const float* t = table + (long long)kCombos * row[k];
      lo[k] = t[i0[k]];
      hi[k] = t[i0[k] + w[k]];
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (m0 + k < count)
        sum = __fadd_rn(sum, __fmul_rn(__fsub_rn(hi[k], lo[k]), mask[k]));
    }
  }
  return sum;
}

template <bool T8, bool P4, bool SHARED>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    icm_binary_kernel(const Args a) {
  extern __shared__ unsigned char x_shared[];
  __shared__ float partial[kWarps];
  __shared__ float totals[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // this thread's first slot of a sweep over the cluster's threads
  const int first = rank * kThreads + (int)threadIdx.x;
  constexpr int kStride = kCluster * kThreads;
  long long* row = a.x + (long long)(blockIdx.x / kCluster) * a.n;
  const Bits<SHARED> x{x_shared, row};
  if (SHARED) {
    for (int i = threadIdx.x; i < a.n; i += kThreads)
      x_shared[i] = (unsigned char)row[i];
  }
  cluster.sync();  // every copy filled before a block writes into another

  for (int pass = 0; pass < a.passes; ++pass) {
    for (int c = 0; c < a.colors; ++c) {
      const int hi = a.color_offsets[c + 1];
      for (int j = a.color_offsets[c] + first; j < hi; j += kStride) {
        const long long v = a.color_ids[j];
        float delta = __fsub_rn(a.u1[v], a.u0[v]);
        if (T8)
          delta = __fadd_rn(delta, incidence_sum<3, kTripletChunk>(
              x, a.vert_tri + v * a.mt, a.vert_corner + v * a.mt, a.mt,
              a.trip, a.t8));
        if (P4)
          delta = __fadd_rn(delta, incidence_sum<2, kPairChunk>(
              x, a.vert_pair + v * a.mp, a.vert_end + v * a.mp, a.mp,
              a.pairs, a.p4));
        const int bit = delta < 0.f ? 1 : 0;
        if (SHARED) {
          for (int q = 0; q < kCluster; ++q)
            *cluster.map_shared_rank(x_shared + v, q) = (unsigned char)bit;
        } else {
          __stcg(row + v, (long long)bit);
        }
      }
      cluster.sync();
    }
  }

  // the start's energy: three sums, each over the cluster's threads, then
  // the blocks' totals in rank order
  float eu = 0.f, et = 0.f, ep = 0.f;
#pragma unroll 4
  for (int i = first; i < a.n; i += kStride)
    eu = __fadd_rn(eu, x.get(i) == 1 ? a.u1[i] : a.u0[i]);
  if (T8) {
#pragma unroll 4
    for (long long t = first; t < a.nt; t += kStride) {
      const long long* tri = a.trip + 3 * t;
      const int k = x.get(tri[0]) * 4 + x.get(tri[1]) * 2 + x.get(tri[2]);
      et = __fadd_rn(et, a.t8[8 * t + k]);
    }
  }
  if (P4) {
#pragma unroll 4
    for (long long p = first; p < a.np; p += kStride) {
      const long long* pr = a.pairs + 2 * p;
      ep = __fadd_rn(ep, a.p4[4 * p + x.get(pr[0]) * 2 + x.get(pr[1])]);
    }
  }
  eu = block_sum(eu, partial);
  et = block_sum(et, partial);
  ep = block_sum(ep, partial);
  if (threadIdx.x == 0) {
    totals[0] = eu;
    totals[1] = et;
    totals[2] = ep;
  }
  if (SHARED) {  // the copies are equal since the last step: write a slice
    for (int i = first; i < a.n; i += kStride) row[i] = x_shared[i];
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float sum[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < kCluster; ++q) {
      const float* t = cluster.map_shared_rank(totals, q);
      for (int k = 0; k < 3; ++k) sum[k] = __fadd_rn(sum[k], t[k]);
    }
    a.es[blockIdx.x / kCluster] = __fadd_rn(__fadd_rn(sum[0], sum[1]), sum[2]);
  }
  cluster.sync();  // no block leaves while rank 0 reads its totals
}

template <bool T8, bool P4>
int launch(const Args& a, int starts, cudaStream_t stream) {
  if (a.n <= kSharedMax) {
    const auto kernel = icm_binary_kernel<T8, P4, true>;
    if (a.n > kDefaultShared) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedMax);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<starts * kCluster, kThreads, (size_t)a.n, stream>>>(a);
  } else {
    icm_binary_kernel<T8, P4, false>
        <<<starts * kCluster, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One launch: `starts` clusters, each the descent of one row of x (S,N)
// and its energy. t8 / p4 null select the forms without them. Returns the
// CUDA error of the launch (0 when it was taken).
extern "C" int icm_binary_launch(
    long long* x, float* es, int starts, int n, const float* u0,
    const float* u1, const float* t8, const long long* trip,
    const long long* vert_tri, const long long* vert_corner, int mt,
    long long nt, const float* p4, const long long* pairs,
    const long long* vert_pair, const long long* vert_end, int mp,
    long long np, const int* color_ids, const int* color_offsets, int colors,
    int passes, void* stream) {
  const Args a{x,  es,       n,     u0,         u1,     t8,
               trip, vert_tri, vert_corner, mt, nt,     p4,
               pairs, vert_pair, vert_end,  mp, np,     color_ids,
               color_offsets, colors, passes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t8 != nullptr && p4 != nullptr) return launch<true, true>(a, starts, s);
  if (t8 != nullptr) return launch<true, false>(a, starts, s);
  if (p4 != nullptr) return launch<false, true>(a, starts, s);
  return launch<false, false>(a, starts, s);
}
