// Forward maps of a subject's label-deformed data grids (K4), for Hopper
// (sm_90a): for every label l and every template vertex q, the triangle of
// the label-l grid that the reference octree chooses for q, and q's
// barycentric weights in it.
//
// Replaces no TPU kernel: the JAX package runs this search as XLA ops, one
// label at a time (newmsm_tpu/ops/resample.py::label_deformed_maps). The
// plain version (ops/labelmap.py::label_forward_twin) calls
// ops/nearest.py::barycentric_coords once a label: a dense nearest-vertex
// score matrix of (4096, N) float32 a chunk of queries (671 MB at ico-6,
// eleven chunks a label), a re-rank of the ring's vertices by exact squared
// distance, the 2-ring containment choice (`_select`) on (c, C, 3, 3)
// gathers, then the weights. The group driver runs it for every subject,
// every iteration and each of the 18-19 labels of a level.
//
// What it computes, for grids (L, N, 3), the template points tmpl (Nt, 3)
// and the grid's 2-ring face corners ring_verts (N, C, 3), in float32:
//   nn = the grid vertex of least exact squared distance
//        ((qx - x)^2 + (qy - y)^2) + (qz - z)^2, the lowest index on a tie
//        (the tier the plain version ends with after its noisy-score argmax
//        and exact re-rank);
//   over nn's C ring faces in ring order: q projected to the face plane,
//   the relative containment test, the least boundary distance of the
//   contained faces (the first on a tie); with none contained, the face of
//   least geodesic distance from q to a corner (the octree's fallback);
//   tv = the chosen face's corners, w = core/spherical.py::
//   barycentric_weights of q in it.
// Every step mirrors the plain version's PyTorch operations on the CPU, in
// their order and rounding: a product or a difference is one rounded
// operation (__fmul_rn / __fsub_rn, which are never contracted), a sum over
// three components is summed left to right, a norm accumulates its squares
// by fused multiply-adds and a cross product fuses its first product, as
// PyTorch's CPU kernels do. So a face choice that float32 rounding decides
// (a template vertex within 1e-4 of an edge is contained by two faces whose
// boundary distances differ by far less than their rounding) comes out as
// the plain version's on the CPU.
//
// What bounds it on this card: operations. The nearest vertex is L x Nt x N
// exact distances (3 subtractions, 3 products, 2 sums and a compare each);
// at the last gMSM level (N = Nt = 40,962, L = 18) that is 3.0e10, about 3.6
// ms at 8 flops each and 67 TFLOP/s. The containment choice is C faces a
// query, about 1e-3 of that. The design:
//   * A block takes 128 template vertices (a thread each) of one label; the
//     grid is (query tiles) x (labels), 5,778 blocks at that level.
//   * The block walks the label's grid through shared memory in tiles of
//     2,048 vertices (float4, 32 KB); each vertex is one broadcast read for
//     the whole warp.
//   * A thread takes the least of 8 distances with fminf and compares that
//     with its best once; only a group that holds a new best is scanned
//     again for its lowest index.
//   * The containment choice and the weights then run in registers, reading
//     the C faces' corners from the label's grid (L2-resident: 0.5 MB).
// No atomics and no cross-block sums: a (label, query) result depends on
// its inputs alone, whatever block or subject slot computes it.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // template vertices a block
constexpr int kTile = 2048;    // grid vertices a shared-memory tile
constexpr int kGroup = 8;      // distances a thread reduces before a compare
static_assert(kTile % kGroup == 0, "a tile holds whole groups");

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ __forceinline__ V3 mul(V3 a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}

__device__ __forceinline__ V3 div(V3 a, float s) {
  return {__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s)};
}

// (a * b).sum(-1): rounded products, summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}

// torch.linalg.norm(v, dim=-1) on the CPU: squares accumulated by FMA
__device__ __forceinline__ float norm(V3 a) {
  return __fsqrt_rn(__fmaf_rn(a.z, a.z, __fmaf_rn(a.y, a.y,
                                                  __fmul_rn(a.x, a.x))));
}

// torch.linalg.cross on the CPU: r_i = fma(a_j, b_k, -(a_k * b_j))
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -__fmul_rn(a.z, b.y)),
          __fmaf_rn(a.z, b.x, -__fmul_rn(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -__fmul_rn(a.y, b.x))};
}

// core/spherical.py::normalize (eps 1e-8)
__device__ __forceinline__ V3 normalize(V3 v) {
  const float n = norm(v);
  return n > 1e-8f ? div(v, n) : v;
}

// core/spherical.py::project_to_plane
__device__ V3 project_to_plane(V3 p, V3 v0, V3 v1, V3 v2) {
  const V3 s1 = normalize(sub(v2, v0));
  const V3 s2 = normalize(sub(v1, v0));
  const V3 n = normalize(cross(s1, s2));
  const float denom = dot(n, p);
  const float si = __fdiv_rn(dot(n, v0), fabsf(denom) > 0.f ? denom : 1.f);
  return mul(p, si);
}

// core/spherical.py::point_in_triangle_relative (rel_tol 1e-4)
__device__ bool contains(V3 p, V3 a, V3 b, V3 c) {
  const V3 n = cross(sub(b, a), sub(c, a));
  const float tol = __fmul_rn(dot(n, n), -1e-4f);
  return dot(cross(sub(c, b), sub(p, b)), n) >= tol &&
         dot(cross(sub(a, c), sub(p, c)), n) >= tol &&
         dot(cross(sub(b, a), sub(p, a)), n) >= tol;
}

__device__ float edge_distance(V3 x0, V3 a, V3 b) {
  const V3 u = sub(b, a);
  const V3 xa = sub(x0, a), xb = sub(x0, b);
  if (!(dot(xa, u) > 0.f && dot(xb, u) < 0.f)) return FLT_MAX;
  return __fdiv_rn(norm(cross(xa, xb)), fmaxf(norm(u), 1e-30f));
}

// core/spherical.py::dist_to_triangle_boundary
__device__ float boundary_distance(V3 x0, V3 x1, V3 x2, V3 x3) {
  float d = fminf(edge_distance(x0, x1, x2),
                  fminf(edge_distance(x0, x1, x3), edge_distance(x0, x2, x3)));
  d = fminf(d, norm(sub(x0, x1)));
  d = fminf(d, norm(sub(x0, x2)));
  return fminf(d, norm(sub(x0, x3)));
}

// ops/nearest.py::_select's fallback: geodesic distance to a corner
__device__ float corner_geodesic(V3 q, V3 v, float rad) {
  const float s = fminf(fmaxf(__fdiv_rn(norm(sub(q, v)), 2.f * rad), -1.f),
                        1.f);
  return __fmul_rn(2.f * rad, asinf(s));
}

__device__ __forceinline__ V3 vertex(const float* g, long long i) {
  return {g[3 * i], g[3 * i + 1], g[3 * i + 2]};
}

// exact squared distance, as the plain version's re-rank computes it
__device__ __forceinline__ float dist2(V3 q, float4 v) {
  const float dx = __fsub_rn(q.x, v.x), dy = __fsub_rn(q.y, v.y),
              dz = __fsub_rn(q.z, v.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

struct Args {
  const float* grids;            // (L, N, 3)
  const float* tmpl;             // (Nt, 3)
  const long long* ring_verts;   // (N, C, 3)
  long long* tv;                 // (L, Nt, 3)
  float* w;                      // (L, Nt, 3)
  int n, nt, c;
  float rad;
};

__global__ void __launch_bounds__(kThreads) label_forward_kernel(Args a) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const float* g = a.grids + 3LL * a.n * blockIdx.y;
  V3 p = {0.f, 0.f, 0.f};
  if (q < a.nt) p = vertex(a.tmpl, q);

  // nearest grid vertex: exact distances, the lowest index on a tie
  float best = INFINITY;
  int nn = 0;
  for (int base = 0; base < a.n; base += kTile) {
    const int m = min(kTile, a.n - base);
    const int mg = (m + kGroup - 1) / kGroup * kGroup;
    __syncthreads();
    for (int i = threadIdx.x; i < mg; i += kThreads) {
      // past the last vertex: FLT_MAX corners, at infinite distance
      tile[i] = i < m ? make_float4(g[3LL * (base + i)],
                                    g[3LL * (base + i) + 1],
                                    g[3LL * (base + i) + 2], 0.f)
                      : make_float4(FLT_MAX, FLT_MAX, FLT_MAX, 0.f);
    }
    __syncthreads();
    for (int i = 0; i < mg; i += kGroup) {
      float d[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) d[k] = dist2(p, tile[i + k]);
      float lo = d[0];
#pragma unroll
      for (int k = 1; k < kGroup; ++k) lo = fminf(lo, d[k]);
      if (lo < best) {
        int first = kGroup - 1;
#pragma unroll
        for (int k = kGroup - 1; k >= 0; --k)
          if (d[k] == lo) first = k;
        best = lo;
        nn = base + i + first;
      }
    }
  }
  if (q >= a.nt) return;

  // the 2-ring containment choice (ops/nearest.py::_select)
  const long long* rv = a.ring_verts + 3LL * a.c * nn;
  float best_in = FLT_MAX;
  int sel = 0;
  bool found = false;
  for (int j = 0; j < a.c; ++j) {
    const V3 v0 = vertex(g, rv[3 * j]), v1 = vertex(g, rv[3 * j + 1]),
             v2 = vertex(g, rv[3 * j + 2]);
    const V3 pp = project_to_plane(p, v0, v1, v2);
    if (contains(pp, v0, v1, v2)) {
      found = true;
      const float d = boundary_distance(pp, v0, v1, v2);
      if (d < best_in) {
        best_in = d;
        sel = j;
      }
    }
  }
  if (!found) {
    float best_fb = INFINITY;
    for (int j = 0; j < a.c; ++j) {
      const float d = fminf(
          corner_geodesic(p, vertex(g, rv[3 * j]), a.rad),
          fminf(corner_geodesic(p, vertex(g, rv[3 * j + 1]), a.rad),
                corner_geodesic(p, vertex(g, rv[3 * j + 2]), a.rad)));
      if (d < best_fb) {
        best_fb = d;
        sel = j;
      }
    }
  }

  // barycentric weights (core/spherical.py::barycentric_weights)
  const long long i0 = rv[3 * sel], i1 = rv[3 * sel + 1],
                  i2 = rv[3 * sel + 2];
  const V3 v0 = vertex(g, i0), v1 = vertex(g, i1), v2 = vertex(g, i2);
  const V3 pp = project_to_plane(p, v0, v1, v2);
  const float aa = __fmul_rn(0.5f, norm(cross(sub(v1, pp), sub(v2, pp))));
  const float ab = __fmul_rn(0.5f, norm(cross(sub(v0, pp), sub(v2, pp))));
  const float ac = __fmul_rn(0.5f, norm(cross(sub(v0, pp), sub(v1, pp))));
  float total = __fadd_rn(__fadd_rn(aa, ab), ac);
  if (!(total > 0.f)) total = 1.f;
  const long long o = 3LL * ((long long)blockIdx.y * a.nt + q);
  a.tv[o] = i0;
  a.tv[o + 1] = i1;
  a.tv[o + 2] = i2;
  a.w[o] = __fdiv_rn(aa, total);
  a.w[o + 1] = __fdiv_rn(ab, total);
  a.w[o + 2] = __fdiv_rn(ac, total);
}

}  // namespace

// One launch on `stream`: tv and w of every (label, template vertex).
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int label_forward_launch(const float* grids, int n_labels, int n,
                                    const float* tmpl, int nt,
                                    const long long* ring_verts, int c,
                                    float rad, long long* tv, float* w,
                                    void* stream) {
  const Args a{grids, tmpl, ring_verts, tv, w, n, nt, c, rad};
  const dim3 grid((nt + kThreads - 1) / kThreads, n_labels);
  label_forward_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
