// Pristine-icosphere point location + barycentric weights, one thread per
// query, for Hopper (sm_90a).
//
// Replaces the TPU kernel newmsm_tpu/ops/pallas_locate.py::_locate_kernel
// (called by locate_bary_pallas). Same arithmetic as the plain twin
// newmsm_tpu_torch/ops/nearest.py (_locate_pristine_soa + _bary_weights_soa):
//   1. normalise the query with rsqrt;
//   2. base face = first max over the 20 icosahedron faces of the minimum
//      of the 3 inward edge-plane dots;
//   3. `res` subdivision levels: child k in {0 centre, 1, 3, 2} by the first
//      max of the minimum normalised signed distance to 6 planes; k is
//      computed ONCE per level and drives both fid = 4*fid + k and the
//      corner update, so the two can never take different branches on a
//      boundary tie;
//   4. barycentric weights: project onto the face plane, take sub-areas
//      (reference triangle.cpp:124-143).
//
// What bounds it on this card: FP32 ALU work, about 200 flops and nine
// rsqrt per level per query (plus ~300 flops for the base-face scan),
// against 28 bytes of device-memory traffic per query (three f32 loads,
// one i32 and three f32 stores). At res 6 that is ~55 flops per byte,
// above the H100's FP32-to-bandwidth balance (~20), so the kernel is
// compute-bound. The design keeps everything in registers: the
// descent is a loop over `res` with the three corners as 9 scalars, no
// shared memory, no tensor cores, coalesced structure-of-arrays loads and
// stores, and a grid-stride loop so any query count runs with one launch.
// The 20x(3 corners + 3 normals)x3 base tables (1440 bytes) are read through
// the read-only cache; every thread of a warp reads the same normal during
// the base-face scan.

#include <cuda_runtime.h>

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ V3 mid3(V3 a, V3 b) {
  float x = a.x + b.x, y = a.y + b.y, z = a.z + b.z;
  float inv = rsqrtf(x * x + y * y + z * z);
  return {x * inv, y * inv, z * inv};
}

// normalised signed distance of u to plane (origin, n), positive on the
// side of reference point r
__device__ __forceinline__ float sdist(V3 u, V3 n, V3 r) {
  float du = dot3(u, n) * rsqrtf(dot3(n, n));
  return dot3(r, n) >= 0.0f ? du : -du;
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ float area(V3 a, V3 b, V3 c) {
  V3 cr = cross3(sub3(b, a), sub3(c, a));
  return 0.5f * sqrtf(dot3(cr, cr));
}

// tables: [20][3][3] corners (face vertex order, unit radius), then
//         [20][3][3] inward edge normals
__global__ void locate_bary_kernel(const float* __restrict__ px,
                                   const float* __restrict__ py,
                                   const float* __restrict__ pz, long long n,
                                   int res, const float* __restrict__ tables,
                                   int* __restrict__ fid_out,
                                   float* __restrict__ w0,
                                   float* __restrict__ w1,
                                   float* __restrict__ w2) {
  const float* corners = tables;
  const float* normals = tables + 180;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float x = px[i], y = py[i], z = pz[i];
    float inv = rsqrtf(x * x + y * y + z * z);
    V3 u = {x * inv, y * inv, z * inv};

    // base face: running first max of min-over-3-edges inward dot
    int f = 0;
    float best = 0.0f;
    for (int ff = 0; ff < 20; ++ff) {
      const float* nf = normals + ff * 9;
      float s = fminf(dot3(u, load3(nf)),
                      fminf(dot3(u, load3(nf + 3)), dot3(u, load3(nf + 6))));
      if (ff == 0 || s > best) {
        best = s;
        f = ff;
      }
    }
    V3 va = load3(corners + f * 9);
    V3 vb = load3(corners + f * 9 + 3);
    V3 vc = load3(corners + f * 9 + 6);
    int fid = f;

    for (int l = 0; l < res; ++l) {
      V3 m01 = mid3(va, vb), m12 = mid3(vb, vc), m02 = mid3(va, vc);
      float s1 = sdist(u, cross3(m01, m12), m02);
      float s2 = sdist(u, cross3(m12, m02), m01);
      float s3 = sdist(u, cross3(m02, m01), m12);
      float sab = sdist(u, cross3(va, vb), vc);
      float sbc = sdist(u, cross3(vb, vc), va);
      float sca = sdist(u, cross3(vc, va), vb);

      // children in first-max order: centre, corner-a, corner-b, corner-c
      float bs = fminf(s1, fminf(s2, s3));
      int k = 0;
      float s_a = fminf(sca, fminf(sab, -s3));
      if (s_a > bs) { bs = s_a; k = 1; }
      float s_b = fminf(sab, fminf(sbc, -s1));
      if (s_b > bs) { bs = s_b; k = 3; }
      float s_c = fminf(sbc, fminf(sca, -s2));
      if (s_c > bs) { bs = s_c; k = 2; }

      fid = 4 * fid + k;
      // child k of face f is emitted at 4f+k (icosphere._retessellate):
      // k=0 centre (m01,m12,m02), k=1 corner v0 (m02,v0,m01),
      // k=2 corner v2 (m12,v2,m02), k=3 corner v1 (m01,v1,m12)
      if (k == 1) {
        vb = va; va = m02; vc = m01;
      } else if (k == 3) {
        va = m01; vc = m12;
      } else if (k == 2) {
        va = m12; vb = vc; vc = m02;
      } else {
        va = m01; vb = m12; vc = m02;
      }
    }

    // barycentric weights (triangle.cpp:124-143)
    V3 nrm = cross3(sub3(vc, va), sub3(vb, va));
    float denom = dot3(nrm, u);
    denom = fabsf(denom) > 0.0f ? denom : 1.0f;
    float si = dot3(nrm, va) / denom;
    V3 pp = {u.x * si, u.y * si, u.z * si};
    float aa = area(pp, vb, vc);
    float ab = area(pp, va, vc);
    float ac = area(pp, va, vb);
    float total = aa + ab + ac;
    total = total > 0.0f ? total : 1.0f;

    fid_out[i] = fid;
    w0[i] = aa / total;
    w1[i] = ab / total;
    w2[i] = ac / total;
  }
}

}  // namespace

extern "C" int locate_bary_launch(const float* px, const float* py,
                                  const float* pz, long long n, int res,
                                  const float* tables, int* fid, float* w0,
                                  float* w1, float* w2, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  locate_bary_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, n, res, tables, fid, w0, w1, w2);
  return (int)cudaGetLastError();
}
