// Pristine-icosphere point location + barycentric weights, one thread per
// query, for Hopper (sm_90a).
//
// Replaces the TPU kernel newmsm_tpu/ops/pallas_locate.py::_locate_kernel
// (called by locate_bary_pallas). Computes what the plain version
// newmsm_tpu_torch/ops/nearest.py (_locate_pristine_soa + _bary_weights_soa)
// computes:
//   1. normalise the query with rsqrt;
//   2. base face = first max over the 20 icosahedron faces of the minimum
//      of the 3 inward edge-plane dots;
//   3. RES subdivision levels: child k in {0 centre, 1, 3, 2} by the first
//      max of the minimum normalised signed distance to the child's 3
//      planes; k is computed ONCE per level and drives fid = 4*fid + k, the
//      corner update and the carried planes, so they can never take
//      different branches on a boundary tie;
//   4. barycentric weights: project onto the face plane, take sub-areas
//      (reference triangle.cpp:124-143).
//
// What bounds it on this card: FP32 issue slots. A query moves 28 bytes
// (three f32 loads, one i32 and three f32 stores) and needs ~500 + 110*RES
// flops, ~40 flops per byte at RES 6, above the H100's FP32-to-bandwidth
// balance (~20). Much of the work is min / compare / select, which fills an
// issue slot but is no FMA, so the design removes work rather than
// rescheduling it:
//   * Carried planes. The 3 outer planes of the chosen child are great
//     circles the parent level already measured: a corner child keeps two
//     of the parent's edge planes and takes the mid plane that cuts it off
//     with the sign flipped; the centre child takes the three mid planes.
//     So a level computes 3 new planes (3 cross products, 3 rsqrt), not 6.
//     A carried value differs from a recomputed one in the last bits, which
//     can only move an exact-tie query to the other incident face.
//   * Orientation once. All children keep the base face's orientation, so
//     the sign that turns a plane normal inward is one multiply of the
//     query per thread, not a dot product and a select per plane.
//   * Base scan from __constant__ memory. With the scan unrolled every
//     normal is a compile-time constant-bank operand of the FMA itself: no
//     load instruction and no address arithmetic (the scan reads the same
//     address in every thread). The chosen face's corners and normals are
//     then gathered per thread through the read-only cache, since a
//     constant read with a divergent index would serialise.
//   * RES is a template parameter behind a switch: the level loop unrolls
//     and corners, carried planes and the face id stay in registers.
//   * The grid is sized from the occupancy API times the SM count, with a
//     grid-stride loop, so every resident thread gets work in one wave.
// What the card offers and this kernel does not use: tensor cores (TF32
// would move coordinate-carrying boundary decisions, and the base scan as
// an FP32 (N x 3)(3 x 60) product has no tensor-core path); TMA and
// cp.async (28 bytes a query of coalesced traffic is a few microseconds of
// a compute-bound kernel: nothing to hide); shared memory (no data is
// shared between queries).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Resident blocks per SM asked of the compiler: caps the kernel at 40
// registers a thread (it takes 60-72 uncapped). Measured on the H100 at res
// 6: 6 blocks (12 bytes of spill) ran 2.7 % faster than the uncapped 3, and
// 8 blocks (32 registers, 352 bytes of spill) twice as slow.
constexpr int kMinBlocks = 6;
constexpr int kMaxDevices = 64;

// [20][3][3] inward unit edge-plane normals of the base faces
__constant__ float c_normals[180];

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

// normalised distance of (orientation-signed) u to the plane (origin, n)
__device__ __forceinline__ float pdist(V3 uo, V3 n) {
  return dot3(uo, n) * rsqrtf(dot3(n, n));
}

__device__ __forceinline__ V3 sel3(bool c, V3 a, V3 b) {
  return {c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z};
}

__device__ __forceinline__ V3 load3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ float area(V3 a, V3 b, V3 c) {
  V3 cr = cross3(sub3(b, a), sub3(c, a));
  return 0.5f * sqrtf(dot3(cr, cr));
}

// tables: [20][3][3] corners (face vertex order, unit radius), then the
//         [20][3][3] normals that are also in c_normals
template <int RES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
locate_bary_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, long long n,
                   const float* __restrict__ tables,
                   int* __restrict__ fid_out, float* __restrict__ w0,
                   float* __restrict__ w1, float* __restrict__ w2) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float x = px[i], y = py[i], z = pz[i];
    float inv = rsqrtf(x * x + y * y + z * z);
    V3 u = {x * inv, y * inv, z * inv};

    // base face: running first max of min-over-3-edges inward dot
    int f = 0;
    float best = 0.0f;
#pragma unroll
    for (int ff = 0; ff < 20; ++ff) {
      const float* nf = c_normals + ff * 9;
      float s = fminf(
          u.x * nf[0] + u.y * nf[1] + u.z * nf[2],
          fminf(u.x * nf[3] + u.y * nf[4] + u.z * nf[5],
                u.x * nf[6] + u.y * nf[7] + u.z * nf[8]));
      if (ff == 0 || s > best) {
        best = s;
        f = ff;
      }
    }
    const float* cf = tables + f * 9;
    V3 va = load3(cf), vb = load3(cf + 3), vc = load3(cf + 6);
    int fid = f;

    if constexpr (RES > 0) {
      // carried planes of the current face: normalised inward distances to
      // its edges (va,vb), (vb,vc), (vc,va)
      float sab = dot3(u, load3(cf + 180));
      float sbc = dot3(u, load3(cf + 183));
      float sca = dot3(u, load3(cf + 186));
      // every child keeps the base face's orientation: sign the query once
      float og = dot3(cross3(va, vb), vc) >= 0.0f ? 1.0f : -1.0f;
      V3 uo = {u.x * og, u.y * og, u.z * og};

#pragma unroll
      for (int l = 0; l < RES; ++l) {
        V3 m01 = mid3(va, vb), m12 = mid3(vb, vc), m02 = mid3(va, vc);
        // mid planes, positive towards the centre child: s1 cuts off corner
        // vb, s2 corner vc, s3 corner va
        float s1 = pdist(uo, cross3(m01, m12));
        float s2 = pdist(uo, cross3(m12, m02));
        float s3 = pdist(uo, cross3(m02, m01));

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
        bool ka = k == 1, kb = k == 3, kc = k == 2;
        V3 na = sel3(ka, m02, sel3(kc, m12, m01));
        V3 nb = sel3(ka, va, sel3(kb, vb, sel3(kc, vc, m12)));
        V3 nc = sel3(ka, m01, sel3(kb, m12, m02));
        // the child's edge planes, in its own (va,vb), (vb,vc), (vc,va)
        // order, from planes this level already holds
        float nab = ka ? sca : (kb ? sab : (kc ? sbc : s1));
        float nbc = ka ? sab : (kb ? sbc : (kc ? sca : s2));
        float nca = ka ? -s3 : (kb ? -s1 : (kc ? -s2 : s3));
        va = na; vb = nb; vc = nc;
        sab = nab; sbc = nbc; sca = nca;
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

// resident blocks of the RES kernel on the current device (occupancy API x
// SM count), cached per device; 0 on error (see *err)
template <int RES>
int resident_blocks(cudaError_t* err) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, locate_bary_kernel<RES>, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  int blocks = per_sm * sms;
  if (blocks <= 0) {
    *err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  if (dev < kMaxDevices) cached[dev] = blocks;
  return blocks;
}

template <int RES>
int launch(const float* px, const float* py, const float* pz, long long n,
           const float* tables, int* fid, float* w0, float* w1, float* w2,
           cudaStream_t stream) {
  cudaError_t err;
  long long cap = resident_blocks<RES>(&err);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  locate_bary_kernel<RES><<<(unsigned)blocks, kThreads, 0, stream>>>(
      px, py, pz, n, tables, fid, w0, w1, w2);
  return (int)cudaGetLastError();
}

}  // namespace

// Copies the 180 base-face normals (host memory) into the current device's
// constant memory. Call once per device before the first launch.
extern "C" int locate_bary_set_tables(const float* host_normals) {
  cudaError_t err =
      cudaMemcpyToSymbol(c_normals, host_normals, sizeof(c_normals));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

#define LOCATE_BARY_CASES(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

// Resident blocks the level-`res` kernel's grid is capped at on the current
// device (blocks per SM x SMs), or -1.
extern "C" int locate_bary_resident_blocks(int res) {
  cudaError_t err = cudaErrorInvalidValue;
  int blocks = 0;
  switch (res) {
#define X(R) case R: blocks = resident_blocks<R>(&err); break;
    LOCATE_BARY_CASES(X)
#undef X
    default: break;
  }
  return err == cudaSuccess ? blocks : -1;
}

extern "C" int locate_bary_launch(const float* px, const float* py,
                                  const float* pz, long long n, int res,
                                  const float* tables, int* fid, float* w0,
                                  float* w1, float* w2, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (res) {
#define X(R) \
  case R: return launch<R>(px, py, pz, n, tables, fid, w0, w1, w2, s);
    LOCATE_BARY_CASES(X)
#undef X
    default: return (int)cudaErrorInvalidValue;
  }
}
