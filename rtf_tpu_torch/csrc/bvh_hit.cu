// Closest ray-triangle hit of local-space rays against one mesh instance's
// BVH, one thread per ray.
//
// The port's kernel for rtf_tpu/ops/trace.py::bvh_traverse, the lock-step
// BVH walk that mesh_algo="bvh" takes (trace.py:161).  It reaches no
// pallas_call in rtf_tpu, where it is one XLA while_loop over the whole
// batch; here each thread runs its ray's loop to its own end.  It computes
// what ops/bvh_hit.py::bvh_closest_hit_plain computes:
//   * per ray its local origin, direction and t_init, read in place from
//     the trace's [N, 3] rows and [N] t_init;
//   * the arena's BVH (ops/bvh_hit.py::BvhWalk): nodes [N, 8] float32, two
//     float4 a node (bmin | first child id; bmax | first element << 8 |
//     faces tested), the faces in leaf order [E, 12], three float4 a face
//     (a | arena face id, b, c), and the slot's root node;
//   -> t, face (arena face id, -1 = no hit before t_init), front (0/1),
//      ba, bb, each [N].
// The walk is bvh_traverse's: pop the top node; test its box against the
// best t so far (rtf_tpu/ops/intersect.py::intersect_box_enter); a leaf
// tests its faces in order (intersect_triangle, the best t updated face by
// face); an inner node pushes its far child, then its near one (near: the
// child whose box the ray enters first, e1 <= e2 to the first child), the
// stack pointer clamped at depth - 1.  The plain version runs the same
// sequence per ray in lock step over the batch.
//
// What bounds it on an H100: neither bytes nor operations, but latency: a
// walk is one thread's chain of dependent loads (node, then its children,
// then the leaf's faces) and tests, and the launch waits for its longest
// walks.  A ray reads 28 B and writes 20 B; the tree (5.9 MB for 81,920
// faces) stays in L2.  What the design does about it, in this first
// version: each node is two 16-byte loads and each face three, read in
// leaf order (no index indirection); the ray's 1/d is computed once, not
// per box; the stack lives in registers or local memory (32 ints); the
// counters are a separate instantiation, so a launch without them has no
// counting code in its loop.
// Work counters (stats, optional): nodes popped, inner nodes entered, leaves
// entered, ray-face tests (summed per thread, added once per thread) and
// the most pops of one ray (atomicMax).
// Built with --fmad=false and without --use_fast_math: IEEE division and
// square root and no contraction into FMAs, so it rounds like the plain
// version's torch ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 32;
enum Stat {
  STAT_NODES = 0, STAT_INNER = 1, STAT_LEAVES = 2, STAT_FACES = 3,
  STAT_MAX_POPS = 4
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// intersect_box_enter: hit, and the entry distance (0 inside the box)
__device__ __forceinline__ bool box_enter(const Ray& r, float4 lo, float4 hi,
                                          float t_max, float* enter) {
  float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  float tenter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fminf(t0z, t1z));
  float texit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                      fmaxf(t0z, t1z));
  bool inside = r.ox >= lo.x && r.ox <= hi.x && r.oy >= lo.y &&
                r.oy <= hi.y && r.oz >= lo.z && r.oz <= hi.z;
  *enter = inside ? 0.f : tenter;
  return inside || (tenter <= texit && texit >= 0.f && tenter <= t_max);
}

__device__ __forceinline__ float inv_dir(float d) {
  float s = fabsf(d) < 1e-30f ? (d < 0.f ? -1e-30f : 1e-30f) : d;
  return 1.0f / s;
}

// the projected double area of (p0, p1, p2) across `axis`
__device__ __forceinline__ float area2(int axis, float p0x, float p0y,
                                       float p0z, float p1x, float p1y,
                                       float p1z, float p2x, float p2y,
                                       float p2z) {
  float f1x = p1x - p0x, f1y = p1y - p0y, f1z = p1z - p0z;
  float f2x = p2x - p0x, f2y = p2y - p0y, f2z = p2z - p0z;
  if (axis == 0) return f1y * f2z - f2y * f1z;
  if (axis == 1) return f1x * f2z - f2x * f1z;
  return f1x * f2y - f2x * f1y;
}

// intersect_triangle (rtf_tpu/ops/intersect.py), the plain version's order
__device__ __forceinline__ bool tri(const Ray& r, float4 A, float4 B,
                                    float4 C, float t_prev, float* t_out,
                                    bool* front, float* ba_out,
                                    float* bb_out) {
  float e1x = B.x - A.x, e1y = B.y - A.y, e1z = B.z - A.z;
  float e2x = C.x - A.x, e2y = C.y - A.y, e2z = C.z - A.z;
  float nx = e1y * e2z - e1z * e2y;
  float ny = e1z * e2x - e1x * e2z;
  float nz = e1x * e2y - e1y * e2x;
  float x = fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f);
  float rs = x > 0.f ? 1.0f / sqrtf(x) : 0.f;
  nx = nx * rs;
  ny = ny * rs;
  nz = nz * rs;
  float dz = r.dx * nx + r.dy * ny + r.dz * nz;
  float pz = (r.ox - A.x) * nx + (r.oy - A.y) * ny + (r.oz - A.z) * nz;
  float t = (-pz) / (fabsf(dz) < 1e-7f ? 1e-7f : dz);
  float px = r.ox + t * r.dx, py = r.oy + t * r.dy, pz3 = r.oz + t * r.dz;
  float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
  int axis = az > fmaxf(ax, ay) ? 2 : (ay > ax ? 1 : 0);
  float total = area2(axis, A.x, A.y, A.z, B.x, B.y, B.z, C.x, C.y, C.z);
  float s = 1.0f / (total == 0.f ? 1e-30f : total);
  float ba = area2(axis, px, py, pz3, B.x, B.y, B.z, C.x, C.y, C.z) * s;
  float bb = area2(axis, px, py, pz3, C.x, C.y, C.z, A.x, A.y, A.z) * s;
  float bc = 1.0f - ba - bb;
  *t_out = t;
  *front = dz <= 0.f;
  *ba_out = ba;
  *bb_out = bb;
  return fabsf(dz) >= 1e-7f && t > 1e-3f && t < t_prev && total != 0.f &&
         ba >= 0.f && bb >= 0.f && bc >= 0.f;
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
bvh_hit_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               int ray_stride, const float* __restrict__ t_init,
               int t_stride, int n, const float4* __restrict__ nodes,
               const float4* __restrict__ tris, int root, int depth,
               float* __restrict__ t_out, int* __restrict__ face_out,
               float* __restrict__ front_out, float* __restrict__ ba_out,
               float* __restrict__ bb_out,
               unsigned long long* __restrict__ stats) {
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float* o = ro + (size_t)i * ray_stride;
  const float* d = rd + (size_t)i * ray_stride;
  Ray r;
  r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
  r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  float t_best = t_init[(size_t)i * t_stride];
  int face = -1;
  bool front = false;
  float ba = 0.f, bb = 0.f;
  unsigned long long pops = 0, inner = 0, leaves = 0, faces = 0;

  int stack[MAX_DEPTH];
  stack[0] = root;
  int sp = 1;
  while (sp > 0) {
    int node = stack[--sp];
    if (COUNT) ++pops;
    float4 lo = nodes[2 * node], hi = nodes[2 * node + 1];
    float enter;
    if (!box_enter(r, lo, hi, t_best, &enter)) continue;
    int child = __float_as_int(lo.w);
    if (child < 0) {
      int word = __float_as_int(hi.w);
      int first = word >> 8, count = word & 255;
      if (COUNT) { ++leaves; faces += count; }
      for (int k = 0; k < count; ++k) {
        const float4* f = tris + 3 * (size_t)(first + k);
        float4 A = f[0], B = f[1], C = f[2];
        float tt, tba, tbb;
        bool fr;
        if (tri(r, A, B, C, t_best, &tt, &fr, &tba, &tbb)) {
          t_best = tt;
          face = __float_as_int(A.w);
          front = fr;
          ba = tba;
          bb = tbb;
        }
      }
    } else {
      if (COUNT) ++inner;
      float e1, e2;
      box_enter(r, nodes[2 * child], nodes[2 * child + 1], t_best, &e1);
      box_enter(r, nodes[2 * child + 2], nodes[2 * child + 3], t_best, &e2);
      bool near_first = e1 <= e2;
      int near = near_first ? child : child + 1;
      int far = near_first ? child + 1 : child;
      stack[min(sp, depth - 1)] = far;
      sp = min(sp + 1, depth - 1);
      stack[min(sp, depth - 1)] = near;
      sp = min(sp + 1, depth - 1);
    }
  }
  t_out[i] = t_best;
  face_out[i] = face;
  front_out[i] = front ? 1.f : 0.f;
  ba_out[i] = ba;
  bb_out[i] = bb;
  if (COUNT) {
    atomicAdd(stats + STAT_NODES, pops);
    atomicAdd(stats + STAT_INNER, inner);
    atomicAdd(stats + STAT_LEAVES, leaves);
    atomicAdd(stats + STAT_FACES, faces);
    atomicMax(stats + STAT_MAX_POPS, pops);
  }
}

}  // namespace

extern "C" {

int rtf_bvh_hit_launch(const float* ro, const float* rd, int ray_stride,
                       const float* t_init, int t_stride, int n,
                       const float* nodes, const float* tris, int root,
                       int depth, float* t, int* face, float* front,
                       float* ba, float* bb, long long* stats,
                       cudaStream_t stream) {
  if (depth < 1 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dim3 grid((n + THREADS - 1) / THREADS);
  if (stats) {
    bvh_hit_kernel<true><<<grid, THREADS, 0, stream>>>(
        ro, rd, ray_stride, t_init, t_stride, n, (const float4*)nodes,
        (const float4*)tris, root, depth, t, face, front, ba, bb,
        (unsigned long long*)stats);
  } else {
    bvh_hit_kernel<false><<<grid, THREADS, 0, stream>>>(
        ro, rd, ray_stride, t_init, t_stride, n, (const float4*)nodes,
        (const float4*)tris, root, depth, t, face, front, ba, bb, nullptr);
  }
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
