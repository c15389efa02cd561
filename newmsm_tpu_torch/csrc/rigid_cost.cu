// Rigid neighbourhood cost of AFFINE (K3): the whole similarity of the
// rotated source sphere against the target, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this cost as XLA ops
// (newmsm_tpu/reg/rigid.py::rigid_cost). Eagerly in PyTorch the plain
// version (newmsm_tpu_torch/reg/rigid.py::rigid_terms_twin) walks the
// sources in chunks of 2048 and builds dense (2048, Nt) temporaries for
// every chunk (the gate, a (2048, Nt, 3) difference, the tangent-plane
// offsets, the weights, the similarities): at ico-5 about 22 GB of device
// traffic and hundreds of launches a cost evaluation, and AFFINE makes up
// to 161 evaluations. This kernel keeps every intermediate in registers.
//
// What it computes, for rotated source points rot (N,3), centred data
// columns src (D,N) and tdat (D,Nt), target points tgt (Nt,3), in float32,
// as the plain version does:
//   unit_i = rot_i / |rot_i|; e1_i, e2_i its tangent basis
//     (core/spherical.py::vertex_tangent_basis: the dominant axis, the
//     zero-magnitude fallback, e2 = normalize(unit x e1));
//   for every target j with dot(unit_i, tgt_j / |tgt_j|) >= cos_ang:
//     d1 = (tgt_j - rot_i) . e1_i, d2 = (tgt_j - rot_i) . e2_i,
//     dist2 = d1^2 + d2^2; pairs with dist2 == 0 are left out;
//     w = expf(-dist2 / (2 sigma^2));
//     ab = sum_d src[d,i] tdat[d,j];
//     simval 1: simm = -sqrtf(max(a2 + b2 - 2 ab, 0)) / D
//               (a2, b2 the columns' sums of squares);
//     other:    simm = ab / (|src_i| |tdat_j|), 0 where that product is 0;
//   jp_i = wsum_i > 0 ? (sum_j w simm) / wsum_i : 0, and the total sum_i jp_i.
// expf, IEEE division and sqrtf throughout (no fast-math intrinsics). The
// elementwise steps go through __fmul_rn / __fadd_rn, which are never
// contracted into an FMA, as the plain version's separate operations are
// not; its dot products are matrix products in cuBLAS's order, so the two
// agree to float32 rounding and not bit for bit.
//
// What bounds it on this card: operations, and how evenly they spread.
// At ico-5 (N = Nt = 10,242) the inputs are about 0.3 MB; the gate is 105 M
// three-term dot products and compares, and only ~59 targets a source pass
// it. Those pairs are not spread evenly: sphere vertices near in index are
// near on the sphere, so a rotation near the identity puts most of a block
// of sources' pairs into the target block of the same indices. The design:
//   * A dense gated scan, without a spatial index and without a tile-level
//     cull (the vertex order of an icosphere makes a tile of 128 targets
//     span some 40 degrees, so a cap test skips little). A block takes 128
//     sources and one tile of 128 targets, loaded once into shared memory
//     (the unit target with its data norm, the raw target with its sum of
//     squares; a target past the last is NaN and passes no gate).
//   * Each lane holds kPerLane sources, so one broadcast read of a target
//     from shared memory serves kPerLane gates (the shared-memory pipe, not
//     the arithmetic, bounded the gate loop at one source a lane).
//   * The block's four warps split the tile's targets, so the pairs of a
//     crowded block go over four warps: each lane tests a group of kGroup
//     targets against its sources first, then works through the pairs that
//     passed, each source's in target order, all lanes at once whatever
//     pairs each has.
//   * A 2-D grid, source blocks x target tiles (81 x 81 at ico-5, 6,561
//     blocks), writes every source's partial wsum and sum of w simm a tile:
//     the warps' sums added in warp order.
//   * A second kernel combines each source's partials in tile order, forms
//     jp and sums it: every block in a fixed order, then the last block to
//     finish (an integer ticket) the block sums in block order. No float
//     atomics anywhere, so two launches on the same inputs give the same
//     bits, and AFFINE's accept / reject sequence repeats.
// What the card offers and this kernel does not use: tensor cores (three-
// term dots, and a gate that decides membership wants full float32) and
// TMA (a few KB a block).

#include <cuda_runtime.h>

namespace {

constexpr int kPerLane = 4;           // sources a lane
constexpr int kSources = 32 * kPerLane;  // sources a scan block
constexpr int kThreads = 128;         // threads a scan block
constexpr int kScanWarps = kThreads / 32;
constexpr int kTile = 128;            // targets a scan block
constexpr int kWarpTargets = kTile / kScanWarps;  // targets a warp
constexpr int kGroup = 8;  // targets whose gates a lane tests before any pair
constexpr int kCombineThreads = 256;  // sources a combine block
constexpr int kWarps = kCombineThreads / 32;
static_assert(kWarpTargets % kGroup == 0, "a warp's targets are whole groups");
static_assert(kPerLane * kGroup <= 32, "a lane's gates of a group fit a word");
static_assert(kSources == kThreads && kTile == kThreads,
              "one thread a source and a target when the block loads them");

struct Args {
  const float* rot;     // (N,3) rotated source points
  const float* src;     // (D,N) centred source data
  const float* tgt;     // (Nt,3) target points
  const float* tdat;    // (D,Nt) centred target data
  int n, nt, d, slices;
  float cos_ang;        // neighbourhood gate on the unit dot product
  float two_sigma2;     // 2 sigma^2 of the Gaussian weight
  int simval;           // 1: -SSD; otherwise the cosine similarity
  float* part;          // (2, slices, N): wsum, then sum of w simm
                        // (a slice is one target tile)
  float* block_part;    // (combine blocks,) jp sums
  unsigned int* ticket; // combine blocks finished
  float* jp;            // (N,) out
  float* total;         // (1,) out
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// calculate_tangs (reg_tools.cpp:205-265) of the unit point a, as
// core/spherical.py::vertex_tangent_basis writes it
__device__ __forceinline__ void tangent_basis(const float a[3], float e1[3], float e2[3]) {
  const float ax = fabsf(a[0]), ay = fabsf(a[1]), az = fabsf(a[2]);
  const bool x_dom = ax >= ay && ax >= az;
  const bool y_dom = !x_dom && ay >= ax && ay >= az;
  if (x_dom) {
    const float mag = __fsqrt_rn(add(mul(a[2], a[2]), mul(a[1], a[1])));
    e1[0] = 0.f;
    e1[1] = mag > 0.f ? __fdiv_rn(-a[2], mag) : 0.f;
    e1[2] = mag > 0.f ? __fdiv_rn(a[1], mag) : 1.f;
  } else if (y_dom) {
    const float mag = __fsqrt_rn(add(mul(a[2], a[2]), mul(a[0], a[0])));
    e1[0] = mag > 0.f ? __fdiv_rn(-a[2], mag) : 0.f;
    e1[1] = 0.f;
    e1[2] = mag > 0.f ? __fdiv_rn(a[0], mag) : 1.f;
  } else {
    const float mag = __fsqrt_rn(add(mul(a[1], a[1]), mul(a[0], a[0])));
    e1[0] = mag > 0.f ? __fdiv_rn(-a[1], mag) : 1.f;
    e1[1] = mag > 0.f ? __fdiv_rn(a[0], mag) : 0.f;
    e1[2] = 0.f;
  }
  // normalize(cross(a, e1)): unchanged where the length is at most 1e-8
  float c[3] = {__fsub_rn(mul(a[1], e1[2]), mul(a[2], e1[1])),
                __fsub_rn(mul(a[2], e1[0]), mul(a[0], e1[2])),
                __fsub_rn(mul(a[0], e1[1]), mul(a[1], e1[0]))};
  const float len = __fsqrt_rn(add(add(mul(c[0], c[0]), mul(c[1], c[1])),
                                   mul(c[2], c[2])));
  for (int k = 0; k < 3; ++k) e2[k] = len > 1e-8f ? __fdiv_rn(c[k], len) : c[k];
}

// a column's sum of squares over the D rows of a (D,M) array
__device__ __forceinline__ float column_sumsq(const float* x, long long m,
                                              int d) {
  float s = 0.f;
#pragma unroll 1
  for (int q = 0; q < d; ++q) {
    const float v = x[q * m];
    s = add(s, mul(v, v));
  }
  return s;
}

// A source's state, shared by the warps of its block: the rotated point
// and the sum of squares of its data column, the unit point and its data
// norm, the tangent basis.
struct Source {
  float4 r, u, e1, e2;
};

// One block: kSources sources against the kTile targets of target slice
// blockIdx.y. Lane l of every warp holds sources l, l + 32, ... of the
// block (kPerLane of them, so that one read of a target serves that many
// gates) against its warp's own kWarpTargets of the targets. Writes each
// source's partial wsum and sum of w simm for the slice: the warps' sums
// added in warp order.
__global__ void __launch_bounds__(kThreads)
rigid_scan_kernel(const Args a) {
  __shared__ float4 s_unit[kTile];  // unit target, its data norm
  __shared__ float4 s_raw[kTile];   // raw target, its data sum of squares
  __shared__ Source s_src[kSources];
  __shared__ float2 s_sum[kScanWarps][kSources];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kSources;
  const int t0 = blockIdx.y * kTile;
  const int count = min(kTile, a.nt - t0);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *a.ticket = 0u;

  {  // thread k: target t0 + k and source first + k
    const int k = threadIdx.x;
    if (k < count) {
      const int j = t0 + k;
      const float x = a.tgt[3LL * j], y = a.tgt[3LL * j + 1],
                  z = a.tgt[3LL * j + 2];
      const float len = __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
      const float b2 = column_sumsq(a.tdat + j, a.nt, a.d);
      s_unit[k] = make_float4(__fdiv_rn(x, len), __fdiv_rn(y, len),
                              __fdiv_rn(z, len), __fsqrt_rn(b2));
      s_raw[k] = make_float4(x, y, z, b2);
    } else {  // past the last target: no gate passes
      s_unit[k] = make_float4(nanf(""), nanf(""), nanf(""), 0.f);
    }
    const int i = first + k;
    float r[3] = {0.f, 0.f, 1.f}, u[3] = {0.f, 0.f, 1.f}, e1[3], e2[3];
    float a2 = 0.f, sn = 0.f;
    if (i < a.n) {
      for (int c = 0; c < 3; ++c) r[c] = a.rot[3LL * i + c];
      const float len = __fsqrt_rn(add(add(mul(r[0], r[0]), mul(r[1], r[1])),
                                       mul(r[2], r[2])));
      for (int c = 0; c < 3; ++c) u[c] = __fdiv_rn(r[c], len);
      a2 = column_sumsq(a.src + i, a.n, a.d);
      sn = __fsqrt_rn(a2);
    }
    tangent_basis(u, e1, e2);
    s_src[k] = Source{make_float4(r[0], r[1], r[2], a2),
                      make_float4(u[0], u[1], u[2], sn),
                      make_float4(e1[0], e1[1], e1[2], 0.f),
                      make_float4(e2[0], e2[1], e2[2], 0.f)};
  }
  __syncthreads();

  float ux[kPerLane], uy[kPerLane], uz[kPerLane], gate[kPerLane];
  float wsum[kPerLane], wsim[kPerLane];
#pragma unroll
  for (int h = 0; h < kPerLane; ++h) {
    const float4 u = s_src[lane + 32 * h].u;
    ux[h] = u.x;
    uy[h] = u.y;
    uz[h] = u.z;
    // a lane without a source: no gate passes
    gate[h] = first + lane + 32 * h < a.n ? a.cos_ang : 2.f;
    wsum[h] = wsim[h] = 0.f;
  }
  for (int k0 = warp * kWarpTargets; k0 < (warp + 1) * kWarpTargets;
       k0 += kGroup) {
    // the gates of a group of targets first, then this lane's pairs
    // through them, each source's in target order
    unsigned pass = 0u;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4 t = s_unit[k0 + g];
#pragma unroll
      for (int h = 0; h < kPerLane; ++h) {
        const float dot = fmaf(uz[h], t.z, fmaf(uy[h], t.y, ux[h] * t.x));
        if (dot >= gate[h]) pass |= 1u << (h * kGroup + g);
      }
    }
    while (pass != 0u) {
      const int bit = __ffs(pass) - 1;
      pass &= pass - 1u;
      const int h = bit / kGroup, k = k0 + bit % kGroup;
      const int i = first + lane + 32 * h;
      const Source s = s_src[lane + 32 * h];
      const float4 p = s_raw[k];
      const float dx = __fsub_rn(p.x, s.r.x), dy = __fsub_rn(p.y, s.r.y),
                  dz = __fsub_rn(p.z, s.r.z);
      const float d1 = fmaf(dz, s.e1.z, fmaf(dy, s.e1.y, dx * s.e1.x));
      const float d2 = fmaf(dz, s.e2.z, fmaf(dy, s.e2.y, dx * s.e2.x));
      const float dist2 = add(mul(d1, d1), mul(d2, d2));
      if (!(dist2 > 0.f)) continue;
      const float w = expf(__fdiv_rn(-dist2, a.two_sigma2));
      const long long j = t0 + k;
      float ab = 0.f;
#pragma unroll 1
      for (int q = 0; q < a.d; ++q)
        ab = fmaf(__ldg(a.src + q * static_cast<long long>(a.n) + i),
                  __ldg(a.tdat + q * static_cast<long long>(a.nt) + j), ab);
      float simm;
      if (a.simval == 1) {
        const float ssd = fmaxf(__fsub_rn(add(s.r.w, p.w), mul(2.f, ab)), 0.f);
        simm = __fdiv_rn(-__fsqrt_rn(ssd), static_cast<float>(a.d));
      } else {
        const float den = mul(s.u.w, s_unit[k].w);
        simm = den > 0.f ? __fdiv_rn(ab, den) : 0.f;
      }
      const float ws = mul(w, simm);
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {  // registers, not local memory
        if (c == h) {
          wsum[c] = add(wsum[c], w);
          wsim[c] = add(wsim[c], ws);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kPerLane; ++h)
    s_sum[warp][lane + 32 * h] = make_float2(wsum[h], wsim[h]);
  __syncthreads();
  const int i = first + threadIdx.x;
  if (i < a.n) {
    float2 sum = s_sum[0][threadIdx.x];
    for (int w = 1; w < kScanWarps; ++w) {
      sum.x = add(sum.x, s_sum[w][threadIdx.x].x);
      sum.y = add(sum.y, s_sum[w][threadIdx.x].y);
    }
    const long long at = static_cast<long long>(blockIdx.y) * a.n + i;
    a.part[at] = sum.x;
    a.part[static_cast<long long>(a.slices) * a.n + at] = sum.y;
  }
}

// sum of v over the block in a fixed order (warp shuffles, then the warp
// partials by warp 0); the result is in thread 0
__device__ float block_sum(float v, float* partial) {
  for (int o = 16; o > 0; o >>= 1)
    v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kWarps ? partial[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(kCombineThreads)
rigid_combine_kernel(const Args a) {
  __shared__ float partial[kWarps];
  __shared__ bool last;
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  float jp = 0.f;
  if (i < a.n) {
    float ws = 0.f, wm = 0.f;
    const long long off = static_cast<long long>(a.slices) * a.n;
    for (int s = 0; s < a.slices; ++s) {
      ws = add(ws, a.part[static_cast<long long>(s) * a.n + i]);
      wm = add(wm, a.part[off + static_cast<long long>(s) * a.n + i]);
    }
    jp = ws > 0.f ? __fdiv_rn(wm, ws) : 0.f;
    a.jp[i] = jp;
  }
  const float sum = block_sum(jp, partial);
  if (threadIdx.x == 0) {
    a.block_part[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  for (int b = threadIdx.x; b < gridDim.x; b += kCombineThreads)
    acc = add(acc, __ldcg(a.block_part + b));
  const float total = block_sum(acc, partial);
  if (threadIdx.x == 0) a.total[0] = total;
}

}  // namespace

// The scratch the launch needs for N sources and Nt targets: slices (the
// scan grid's second dimension), combine blocks, and floats of scratch
// (the partials, then the combine blocks' sums).
extern "C" void rigid_cost_layout(int n, int nt, int* slices, int* blocks,
                                  long long* scratch) {
  *slices = (nt + kTile - 1) / kTile;
  *blocks = (n + kCombineThreads - 1) / kCombineThreads;
  *scratch = 2LL * *slices * n + *blocks;
}

// One evaluation: the scan, then the combine, on `stream`. Returns the
// first CUDA error of the two launches (0 when both were accepted).
extern "C" int rigid_cost_launch(
    const float* rot, const float* src, const float* tgt, const float* tdat,
    int n, int nt, int d, float cos_ang, float two_sigma2, int simval,
    float* scratch, unsigned int* ticket, float* jp, float* total,
    void* stream) {
  int slices = 0, blocks = 0;
  long long floats = 0;
  rigid_cost_layout(n, nt, &slices, &blocks, &floats);
  const Args a{rot, src, tgt, tdat, n, nt, d, slices, cos_ang, two_sigma2,
               simval, scratch, scratch + 2LL * slices * n, ticket, jp,
               total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kSources - 1) / kSources, slices);
  rigid_scan_kernel<<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rigid_combine_kernel<<<blocks, kCombineThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
