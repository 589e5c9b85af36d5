// The Plücker ray-triangle pair test of rtf_tpu's MXU mesh tables, shared
// by the wave kernel's MXU variant (wave_kernel.cu) and the dense closest
// hit (mesh_hit_mxu.cu).
//
// rtf_tpu evaluates it as one matrix product per tile: a ray's row (d,
// o x d, o, 1) times a face's columns (rtf_tpu/render/fused.py:675-708,
// rtf_tpu/ops/pallas_mesh_mxu.py:1-33).  Here a thread evaluates one pair
// at a time, each product summed in one fixed order, element by element,
// as ops/mxu_pack.py::plucker_pair does in PyTorch, so the two agree bit
// for bit (built with --fmad=false: no contraction into FMAs):
//   s_k = d . m_k + (o x d) . e_k   (sa, sb, sc; w_k = (m_k, e_k))
//   dn  = d . n,   on = n.a - o . n
//   inside = all s_k >= 0 or all s_k <= 0 (either winding)
//   t = on / (|dn| < 1e-7 ? 1e-7 : dn), valid if inside, |dn| >= 1e-7
//   and t > 1e-3.
// A face is 22 floats (ops/mxu_pack.py rows 0-21): w_a, w_b, w_c, n, n.a,
// 16-byte aligned; degenerate faces are zero there, so dn == 0 and they
// never hit.
#pragma once

namespace plucker {

constexpr float ZERO = 1e-3f;      // reference bias epsilon
constexpr float DZ_EPS = 1e-7f;    // reference |dn| cutoff
constexpr int FACE_FLOAT4 = 6;     // a face's 22 floats as six float4

__device__ __forceinline__ float4 load4(const float4* p, bool ldg) {
  return ldg ? __ldg(p) : *p;
}

// the pair test of the face at F4 (global memory through the read-only
// cache when ldg, else shared memory) against a ray with direction d,
// moment c = o x d and origin o; returns validity without a t cap.  The
// winding test comes first: a pair outside both windings (most pairs)
// skips the plane terms, the division and the face's last 16 bytes, which
// changes no result (t and dn are read only where the pair is valid).
__device__ __forceinline__ bool pair(const float4* F4, bool ldg,
                                     const float d[3], const float c[3],
                                     const float o[3], float& t, float& sa,
                                     float& sb, float& sc, float& dn) {
  float w[20];
  for (int q = 0; q < 5; ++q) {
    const float4 v = load4(F4 + q, ldg);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
  float s[3];
  for (int k = 0; k < 3; ++k)
    s[k] = d[0] * w[6 * k] + d[1] * w[6 * k + 1] + d[2] * w[6 * k + 2]
        + c[0] * w[6 * k + 3] + c[1] * w[6 * k + 4] + c[2] * w[6 * k + 5];
  sa = s[0];
  sb = s[1];
  sc = s[2];
  if (!(fminf(fminf(sa, sb), sc) >= 0.0f
        || fmaxf(fmaxf(sa, sb), sc) <= 0.0f))
    return false;
  const float4 v = load4(F4 + 5, ldg);   // n.z, n.a
  dn = d[0] * w[18] + d[1] * w[19] + d[2] * v.x;
  const float on = v.y - (o[0] * w[18] + o[1] * w[19] + o[2] * v.x);
  const bool bad = fabsf(dn) < DZ_EPS;
  t = on / (bad ? DZ_EPS : dn);
  return !bad && t > ZERO;
}

// the winner's barycentrics: s_k over their sum (1 where the sum is 0)
__device__ __forceinline__ void bary(float sa, float sb, float sc, float& ba,
                                     float& bb) {
  const float ssum = sa + sb + sc;
  const float rs = 1.0f / (ssum == 0.0f ? 1.0f : ssum);
  ba = sa * rs;
  bb = sb * rs;
}

// o x d in fused.py::_rays16's order
__device__ __forceinline__ void cross_od(const float o[3], const float d[3],
                                         float c[3]) {
  c[0] = o[1] * d[2] - o[2] * d[1];
  c[1] = o[2] * d[0] - o[0] * d[2];
  c[2] = o[0] * d[1] - o[1] * d[0];
}

}  // namespace plucker
