// Closest ray-triangle hit of local-space rays over one mesh slot's
// Morton-packed triangles, one thread per ray.
//
// Replaces the Pallas TPU kernel rtf_tpu/ops/pallas_mesh.py::_mesh_kernel
// (pallas_call pallas_mesh.py:330, behind mesh_closest_hit), which
// rtf_tpu/ops/trace.py::trace calls once per mesh instance for every
// closest-hit and every shadow ray of the XLA wavefront.  It computes what
// ops/mesh_hit.py::mesh_closest_hit_plain computes:
//   * per ray its local origin, direction and t_init, read in place: from
//     the rows of rays8 [N, 8] (ox oy oz dx dy dz t_init pad), or from the
//     trace's own [N, 3] origins and directions and [N] t_init
//     (mesh_closest_hit_rays), so a trace packs nothing;
//   * the scene's face rows [F_pad, 12] float32 (ops/mesh_hit.py::
//     MeshTree.faces: rows 0-11 of the packed table, face-major, three
//     float4 a face: unit normal, n.a, K, L, the two axis masks) and the
//     slot's box hierarchy (MeshTree: its root row, the groups, tiles and
//     16-face leaves, boxes padded on the host; box_walk.cuh);
//   -> t, face (packed id - the slot's first row + face0, -1 = no hit
//      before t_init), front (0/1), ba, bb, each [N].
// The table test is box_walk.cuh::tri, the Pallas kernel's own operation
// order (pallas_mesh.py:260-282); valid = !bad && t > 1e-3 && ba, bb, bc
// >= 0, front = dn <= 0.  The winner is the least t below t_init, then the
// least packed id: the Pallas kernel's lane-reduction rule
// (pallas_mesh.py:288-292), which the plain version's strict `<` over
// tiles in packed order and lowest tied column give.  A miss returns
// t = t_init, face -1, zeros.
//
// What bounds it on an H100: bytes, once the culls work.  A ray reads
// 28 B and writes 20 B; the slot's tables are read by every ray that
// enters them but stay in L1/L2.  The work is data-dependent: a ray that
// misses the slot's root box does one slab test of 26 operations, a ray
// with t_init <= 0 (the wrapper's padding rays, lanes nothing can hit
// below) none, and a ray that enters walks the hierarchy.
// What the design does about it:
//   * the TPU kernel's [8 rays x 128 faces] vreg layout and per-block tile
//     flags are gone: each thread walks the slot's hierarchy (box_walk.cuh:
//     root, groups of 8 tiles, tiles, 16-face leaves, near to far in its
//     direction's octant, each slab test capped by its best t), so it tests
//     the faces of the leaves its segment enters, not every face of every
//     tile it enters;
//   * the 12 floats a face test reads are three 16-byte loads of a
//     face-major copy made once per scene, not 12 strided scalars; a block
//     in which some ray enters the slot's root box first copies the
//     slot's rows into shared memory (where they fit in 48 KB: slots of up
//     to 1024 faces), which shortens the walk's chain of dependent loads;
//   * a walk is one thread's chain of dependent loads and tests, so the
//     few rays that walk set the launch's time (it hardly depends on how
//     many walk): the face loop is unrolled four ways (box_walk.cuh) so
//     that independent face tests overlap, and the counters are a
//     separate instantiation, so a launch without them has no counting
//     branches in its loops;
//   * the boxes are padded once on the host, not per test;
//   * the winner's barycentrics are kept from its test; nothing is read
//     again after the walk.
// Work counters (stats, optional): slab tests (all levels), ray-face
// pairs, root-box tests, rays that entered the root, then the group, tile
// and leaf slab tests, summed per thread and added once per thread, for
// the bound (chip_smoke.py).
// Built with --fmad=false and without --use_fast_math: IEEE division and
// no contraction into FMAs, so it rounds like the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_walk.cuh"

namespace {

constexpr int THREADS = 128;
enum Stat {
  STAT_SLABS = 0, STAT_PAIRS = 1, STAT_ROOTS = 2, STAT_WALKS = 3,
  STAT_GROUPS = 4, STAT_TILES = 5, STAT_LEAVES = 6, NSTAT = 7
};

// faces: the slot's nfaces rows [nfaces, 12] (its first row face_base);
// staged: copy them into shared memory in blocks where a ray walks;
// COUNT: add the work counters to stats
template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
mesh_hit_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                int ray_stride, const float* __restrict__ rt, int t_stride,
                int n, const float* __restrict__ faces, int nfaces, int staged,
                boxwalk::Levels L, int face_base, int face0,
                float* __restrict__ t_out, int* __restrict__ face_out,
                float* __restrict__ front_out, float* __restrict__ ba_out,
                float* __restrict__ bb_out,
                unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem4[];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < n;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float t_init = 0.0f;
  if (in) {
    for (int a = 0; a < 3; ++a) {
      o[a] = __ldg(ro + (long long)ray_stride * i + a);
      d[a] = __ldg(rd + (long long)ray_stride * i + a);
    }
    t_init = __ldg(rt + (long long)t_stride * i);
  }
  float ild[3];
  boxwalk::inv_dir(d, ild);
  // no face validates at t <= t_init <= 0 (t > 1e-3 is required): such a
  // ray (a padding ray) tests nothing
  const bool live = in && t_init > 0.0f;
  const bool enter = live && boxwalk::slab_row(L.roots, o, ild, t_init);
  const float* F = faces;
  bool ldg = true;
  if (staged && __syncthreads_or(enter)) {   // uniform in the block
    const float4* F4 = reinterpret_cast<const float4*>(faces);
    for (int q = threadIdx.x; q < 3 * nfaces; q += THREADS)
      smem4[q] = __ldg(F4 + q);
    __syncthreads();
    F = reinterpret_cast<const float*>(smem4);
    ldg = false;
  }
  if (!in) return;
  float t_best = t_init, dn_best = 1.0f, ba = 0.0f, bb = 0.0f;
  int face = -1;
  unsigned long long c_[boxwalk::NSTAT] = {};
  unsigned long long* const cnt = COUNT ? c_ : nullptr;
  unsigned long long pairs = 0;
  if (enter) {
    int bkey = -1;    // a face at exactly t_init loses
    boxwalk::walk<false, 4>(L, 0, o, d, ild, [&]() { return t_best; },
                         [&](int f, int key0) {
                           pairs += 1;
                           float t, dn, a, b, c;
                           if (!boxwalk::tri(F + 12 * (f - face_base), ldg,
                                             o, d, t, dn, a, b, c))
                             return false;
                           const int key = key0 + f;
                           if (t < t_best || (t == t_best && key < bkey)) {
                             t_best = t;
                             face = f;
                             bkey = key;
                             dn_best = dn;
                             ba = a;
                             bb = b;
                           }
                           return false;
                         }, cnt, nullptr);
  }
  t_out[i] = t_best;
  face_out[i] = face >= 0 ? face0 + (face - face_base) : -1;
  front_out[i] = face >= 0 && dn_best <= 0.0f ? 1.0f : 0.0f;
  ba_out[i] = ba;
  bb_out[i] = bb;
  if (COUNT) {
    const unsigned long long v[NSTAT] = {
        live + c_[boxwalk::GROUPS] + c_[boxwalk::TILES]
            + c_[boxwalk::LEAVES],
        pairs, live, enter, c_[boxwalk::GROUPS], c_[boxwalk::TILES],
        c_[boxwalk::LEAVES]};
    for (int s = 0; s < NSTAT; ++s)
      if (v[s]) atomicAdd(stats + s, v[s]);
  }
}

}  // namespace

extern "C" {

int rtf_mesh_hit_launch(const float* ro, const float* rd, int ray_stride,
                        const float* rt, int t_stride, int n,
                        const float* faces, int nfaces, int staged,
                        const float* root,
                        const float* groups, const float* tnodes,
                        const float* leaves, int face_base, int face0,
                        float* t_out, int* face_out, float* front_out,
                        float* ba_out, float* bb_out, long long* stats,
                        void* stream) {
  if (n <= 0) return 0;
  const size_t smem = staged ? sizeof(float) * 12 * (size_t)nfaces : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  auto kernel = stats ? mesh_hit_kernel<true> : mesh_hit_kernel<false>;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      ro, rd, ray_stride, rt, t_stride, n, faces, nfaces, staged,
      boxwalk::Levels{root, groups, tnodes, leaves}, face_base, face0,
      t_out, face_out, front_out, ba_out, bb_out,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
