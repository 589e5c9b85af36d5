// Closest ray-triangle hit of local-space rays over one mesh slot's
// Morton-packed triangle table, one thread per ray.
//
// Replaces the Pallas TPU kernel rtf_tpu/ops/pallas_mesh.py::_mesh_kernel
// (pallas_call pallas_mesh.py:330, behind mesh_closest_hit), which
// rtf_tpu/ops/trace.py::trace calls once per mesh instance for every
// closest-hit and every shadow ray of the XLA wavefront.  It computes what
// ops/mesh_hit.py::mesh_closest_hit_plain computes:
//   * rays8 [N, 8] float32 rows (ox oy oz dx dy dz t_init pad);
//   * the table [>= 12 rows, F_pad] float32 (ops/pack.py layout, rows 0-11
//     read: unit normal, n.a, K, L, the two axis masks), addressed with its
//     row stride so a slot's column slice of the scene table needs no copy;
//   * the tile boxes [F_pad / 128, 8] (lo xyz, hi xyz);
//   -> t, face (packed id + face0, -1 = no hit before t_init), front (0/1),
//      ba, bb, each [N].
// The table test runs in the Pallas kernel's own operation order
// (pallas_mesh.py:260-282): dn and pn = o.n - n.a, t = -pn / (bad ? DZ_EPS
// : dn), the point, pu/pv by the axis masks, ba = k0 + k1 pu + k2 pv,
// bb = l0 + l1 pu + l2 pv, bc = 1 - ba - bb, valid = !bad && t > 1e-3 &&
// t < t_best && ba, bb, bc >= 0, front = dn <= 0.  Faces are walked in
// increasing packed id with a strict t < t_best, so among exact t ties the
// lowest face id wins: the Pallas kernel's lane-reduction rule
// (pallas_mesh.py:288-292).  A miss returns t = t_init, face -1, zeros.
//
// What bounds it on an H100: operations, not bytes.  A ray reads 32 B and
// writes 20 B, but tests about 40 FP32 operations per face of every tile its
// segment enters, plus a 26-operation slab test per tile.
// What the design does about it:
//   * the TPU kernel's [8 rays x 128 faces] vreg layout, block reach box
//     and per-block tile flags are gone: each thread culls the 128-face
//     tiles with its own slab test over [0, t_best), so a ray stops paying
//     for tiles behind its current best hit;
//   * the boxes are padded here by 1e-4 * (1 + the box's largest
//     |coordinate|): the triangle vertices lie on the box faces, so a slab
//     entry rounded a hair past a triangle's own t cannot cull it; the cull
//     is conservative and the winner is the one the unculled loop finds;
//   * every thread of a warp reads the same face column at the same time
//     (a broadcast through the read-only cache).  Shared-memory staging of
//     the tiles and an any-hit variant for shadow rays are later work.
// Work counters (stats, optional): slab tests and ray-face pairs tested,
// summed per thread and added once per thread, for the bound
// (chip_smoke.py).
// Built with --fmad=false and without --use_fast_math: IEEE division and
// no contraction into FMAs, so it rounds like the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TRI_LANES = 128;      // faces per tile
constexpr float BIG = 1.0e30f;
constexpr float ZERO = 1e-3f;       // reference bias epsilon
constexpr float DZ_EPS = 1e-7f;     // reference |dn| cutoff
constexpr float TILE_PAD = 1e-4f;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// per-thread slab test of [0, cap) against a tile box, padded here
__device__ __forceinline__ bool slab(const float* B, const float o[3],
                                     const float ild[3], float cap) {
  float m = 0.0f;
  for (int a = 0; a < 6; ++a) m = fmaxf(m, fabsf(ld(B + a)));
  const float pad = TILE_PAD * (1.0f + m);
  float tmin = 0.0f, tmax = BIG;
  for (int a = 0; a < 3; ++a) {
    float t0 = (ld(B + a) - pad - o[a]) * ild[a];
    float t1 = (ld(B + 3 + a) + pad - o[a]) * ild[a];
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  return tmax >= tmin && tmin < cap;
}

__global__ void __launch_bounds__(THREADS)
mesh_hit_kernel(const float4* __restrict__ rays, int n,
                const float* __restrict__ tris, long long stride, int nt,
                const float* __restrict__ aabb, int face0,
                float* __restrict__ t_out, int* __restrict__ face_out,
                float* __restrict__ front_out, float* __restrict__ ba_out,
                float* __restrict__ bb_out,
                unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float4 r0 = __ldg(rays + 2 * i), r1 = __ldg(rays + 2 * i + 1);
  const float o[3] = {r0.x, r0.y, r0.z};
  const float d[3] = {r0.w, r1.x, r1.y};
  const float t_init = r1.z;
  float ild[3];
  for (int a = 0; a < 3; ++a)
    ild[a] = fabsf(d[a]) < 1e-30f ? (d[a] < 0.0f ? -1e30f : 1e30f)
                                  : 1.0f / d[a];
  float t_best = t_init, front = 0.0f, ba = 0.0f, bb = 0.0f;
  int face = -1;
  unsigned long long pairs = 0;
  for (int j = 0; j < nt; ++j) {
    if (!slab(aabb + 8 * j, o, ild, t_best)) continue;
    pairs += TRI_LANES;
    for (int c = 0; c < TRI_LANES; ++c) {
      const int f = j * TRI_LANES + c;
      const float* F = tris + f;
      const float nx = ld(F), ny = ld(F + stride), nz = ld(F + 2 * stride);
      const float na = ld(F + 3 * stride);
      const float dn = d[0] * nx + d[1] * ny + d[2] * nz;
      const float pn = o[0] * nx + o[1] * ny + o[2] * nz - na;
      const bool bad = fabsf(dn) < DZ_EPS;
      const float t = -pn / (bad ? DZ_EPS : dn);
      if (bad || !(t > ZERO) || !(t < t_best)) continue;
      const float px = o[0] + t * d[0];
      const float py = o[1] + t * d[1];
      const float pz = o[2] + t * d[2];
      const float pu = ld(F + 10 * stride) > 0.0f ? py : px;
      const float pv = ld(F + 11 * stride) > 0.0f ? py : pz;
      const float ba_t = ld(F + 4 * stride) + ld(F + 5 * stride) * pu
                         + ld(F + 6 * stride) * pv;
      const float bb_t = ld(F + 7 * stride) + ld(F + 8 * stride) * pu
                         + ld(F + 9 * stride) * pv;
      const float bc_t = 1.0f - ba_t - bb_t;
      if (ba_t >= 0.0f && bb_t >= 0.0f && bc_t >= 0.0f) {
        t_best = t;
        face = f;
        front = dn <= 0.0f ? 1.0f : 0.0f;
        ba = ba_t;
        bb = bb_t;
      }
    }
  }
  t_out[i] = t_best;
  face_out[i] = face >= 0 ? face0 + face : -1;
  front_out[i] = front;
  ba_out[i] = ba;
  bb_out[i] = bb;
  if (stats) {
    atomicAdd(stats, (unsigned long long)nt);
    atomicAdd(stats + 1, pairs);
  }
}

}  // namespace

extern "C" {

int rtf_mesh_hit_launch(const float* rays8, int n, const float* tris,
                        long long stride, int nt, const float* aabb,
                        int face0, float* t_out, int* face_out,
                        float* front_out, float* ba_out, float* bb_out,
                        long long* stats, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_hit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rays8), n, tris, stride, nt, aabb,
      face0, t_out, face_out, front_out, ba_out, bb_out,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
