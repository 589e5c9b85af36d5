// Closest ray-triangle hit of local-space rays against one mesh instance's
// BVH: two walks, chosen per arena by ops/bvh_hit.py::bvh_walk.
//
// The port's kernels for rtf_tpu/ops/trace.py::bvh_traverse, the lock-step
// BVH walk that mesh_algo="bvh" takes (trace.py:161).  It reaches no
// pallas_call in rtf_tpu, where it is one XLA while_loop over the whole
// batch; here each ray's walk runs to its own end.  Both read, per ray,
// its local origin, direction and t_init in place from the trace's [N, 3]
// rows and [N] t_init, and write t, face (arena face id, -1 = no hit before
// t_init), front (0/1), ba, bb, each [N].
//
// bvh_wide_kernel, the walk of every tree the depth rule allows: a 4-wide
// tree collapsed from the binary one (ops/bvh_hit.py::collapse; the same
// leaves, each child box the binary node's, bit for bit).
//   * What bounds it on an H100: latency.  A ray reads 28 B and writes
//     20 B, the tables (1.5 MB on the 20,480-face ball) stay in L2, and a
//     launch waits for its longest walks: a chain of dependent loads and
//     tests.  The binary walk (below) loads a node, tests its box, loads
//     both children's boxes to order them and loads each again at its pop,
//     and normalises every face's normal in every test.
//   * A wide node is one 128-byte line (8 float4 rows of 4: children's
//     bmin x, y, z, bmax x, y, z, child words, the child count), so one
//     fetch gives four independent slab tests.  The children hit are pushed
//     with their keys (-inf where the origin is inside the box, else the
//     entry distance), sorted far to near (ties: the later slot first), and
//     re-checked at their pop against the best t only (key == -inf or key
//     <= t: rtf_tpu's `inside || tenter <= t_max`): no box is loaded twice.
//   * A face is one 64-byte row computed once (face_rows: corner a and the
//     face id; the unit normal and 1 / projected double area; the corners
//     projected perpendicular to the dominant axis; the axis), so a
//     ray-face test is its ray-dependent part only: the plane distance,
//     one IEEE division, two projected areas.  A leaf's faces are tested
//     two at a time (their arithmetic interleaves; the best t is taken in
//     order), and a leaf's rows are prefetched into L1 at its pop, so its
//     later pairs do not wait on L2.
//   * One thread a ray, its stack (8 bytes an entry: child word, key) in
//     local memory, whose top L1 holds.  Persistent threads with ray
//     refill, the stack in shared memory, one face at a time, no prefetch,
//     the top levels staged in shared memory and an 8-wide tree were each
//     measured against this walk in turns on an H100 and lost on a frame's
//     walks (PERF.md §6).
//   It computes what ops/bvh_hit.py::bvh_wide_closest_hit_plain computes,
//   bit for bit, outputs and counters.
//
// bvh_hit_kernel, the binary walk, for trees whose binary depth exceeds
// max_depth - 2 (where bvh_traverse's stack clamp can drop a node): one
// thread per ray; nodes [N, 8] float32, two float4 a node (bmin | first
// child id; bmax | first element << 8 | faces tested), the faces in leaf
// order [E, 12], three float4 a face (a | arena face id, b, c).  The walk
// is bvh_traverse's: pop the top node; test its box against the best t so
// far (rtf_tpu/ops/intersect.py::intersect_box_enter); a leaf tests its
// faces in order (intersect_triangle, the best t updated face by face); an
// inner node pushes its far child, then its near one (near: the child whose
// box the ray enters first, e1 <= e2 to the first child), the stack
// pointer clamped at depth - 1.  It equals ops/bvh_hit.py::
// bvh_closest_hit_plain bit for bit.
//
// Work counters (stats, optional; a separate instantiation, so a launch
// without them has no counting code): nodes popped, inner nodes entered,
// leaves entered, ray-face tests, box tests (summed per thread, added once
// per thread) and the most pops of one ray (atomicMax).
// Built with --fmad=false and without --use_fast_math: IEEE division and
// square root and no contraction into FMAs, so it rounds like the plain
// versions' torch ops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 32;
enum Stat {
  STAT_NODES = 0, STAT_INNER = 1, STAT_LEAVES = 2, STAT_FACES = 3,
  STAT_MAX_POPS = 4, STAT_BOXES = 5
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
    atomicAdd(stats + STAT_BOXES, pops + 2 * inner);
  }
}

// ---- the wide walk

constexpr int W = 4;              // children a wide node
constexpr int LOCAL_STACK = 96;   // stack entries a ray

// a hint to bring the 128-byte line at p into L1
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

struct Best {
  float t, ba, bb;
  int face;
  bool front;
};

// intersect_triangle's ray-dependent part on one face row (ops/bvh_hit.py::
// intersect_face_rows): A = a | face id, N = n | s, P = b u, b v, c u, c v,
// Q = a u, a v, flags (axis | 4 where the area is not 0), 0.  Returns
// whether the face is hit past the 1e-3 bias; the caller compares t with
// the best t.
__device__ __forceinline__ bool face_eval(const Ray& r, float4 A, float4 N,
                                          float4 P, float4 Q, float* t_out,
                                          float* ba_out, float* bb_out,
                                          bool* front) {
  float dz = r.dx * N.x + r.dy * N.y + r.dz * N.z;
  float pz = (r.ox - A.x) * N.x + (r.oy - A.y) * N.y + (r.oz - A.z) * N.z;
  float t = (-pz) / (fabsf(dz) < 1e-7f ? 1e-7f : dz);
  int flags = __float_as_int(Q.z);
  int axis = flags & 3;
  float pu = (axis == 0 ? r.oy : r.ox) + t * (axis == 0 ? r.dy : r.dx);
  float pv = (axis == 2 ? r.oy : r.oz) + t * (axis == 2 ? r.dy : r.dz);
  float ba = ((P.x - pu) * (P.w - pv) - (P.z - pu) * (P.y - pv)) * N.w;
  float bb = ((P.z - pu) * (Q.y - pv) - (Q.x - pu) * (P.w - pv)) * N.w;
  float bc = 1.0f - ba - bb;
  *t_out = t;
  *ba_out = ba;
  *bb_out = bb;
  *front = dz <= 0.f;
  return fabsf(dz) >= 1e-7f && t > 1e-3f && (flags & 4) && ba >= 0.f &&
         bb >= 0.f && bc >= 0.f;
}

__device__ __forceinline__ void face_take(bool valid, float t, float ba,
                                          float bb, bool front, float4 A,
                                          Best& h) {
  if (valid && t < h.t) {
    h.t = t;
    h.face = __float_as_int(A.w);
    h.front = front;
    h.ba = ba;
    h.bb = bb;
  }
}

// a wide node's child j against the ray: the sort key, +inf where missed
__device__ __forceinline__ float child_key(const Ray& r, const float* v,
                                           int j, float t_max) {
  float lx = v[j], ly = v[W + j], lz = v[2 * W + j];
  float hx = v[3 * W + j], hy = v[4 * W + j], hz = v[5 * W + j];
  float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  float tenter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                       fminf(t0z, t1z));
  float texit = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                      fmaxf(t0z, t1z));
  bool inside = r.ox >= lx && r.ox <= hx && r.oy >= ly && r.oy <= hy &&
                r.oz >= lz && r.oz <= hz;
  if (inside) return -INFINITY;
  return tenter <= texit && texit >= 0.f && tenter <= t_max ? tenter
                                                            : INFINITY;
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
bvh_wide_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                int ray_stride, const float* __restrict__ t_init,
                int t_stride, int n, const float4* __restrict__ wnodes,
                const float4* __restrict__ rows, int root,
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
  Best h;
  h.t = t_init[(size_t)i * t_stride];
  h.face = -1;
  h.front = false;
  h.ba = h.bb = 0.f;
  unsigned long long pops = 0, inner = 0, leaves = 0, faces = 0, boxes = 0;

  int2 stack[LOCAL_STACK];
  stack[0] = make_int2(root, __float_as_int(-INFINITY));
  int sp = 1;
  while (sp > 0) {
    int2 e = stack[--sp];
    if (COUNT) ++pops;
    float key = __int_as_float(e.y);
    if (!(key == -INFINITY || key <= h.t)) continue;
    int c = e.x;
    if (c >= 0) {
      float v[8 * W];
      const float4* nd = wnodes + (size_t)c * 2 * W;
#pragma unroll
      for (int q = 0; q < 2 * W; ++q) {
        float4 x = nd[q];
        v[4 * q] = x.x; v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
      }
      int cnt = __float_as_int(v[7 * W]);
      float k[W];
      int w[W], sl[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        k[j] = j < cnt ? child_key(r, v, j, h.t) : INFINITY;
        w[j] = __float_as_int(v[6 * W + j]);
        sl[j] = j;
      }
      // ascending by (key, slot): an insertion-sort network
#pragma unroll
      for (int a = 1; a < W; ++a) {
#pragma unroll
        for (int j = a; j > 0; --j) {
          if (k[j] < k[j - 1] || (k[j] == k[j - 1] && sl[j] < sl[j - 1])) {
            float tk = k[j]; k[j] = k[j - 1]; k[j - 1] = tk;
            int tw = w[j]; w[j] = w[j - 1]; w[j - 1] = tw;
            int ts = sl[j]; sl[j] = sl[j - 1]; sl[j - 1] = ts;
          }
        }
      }
#pragma unroll
      for (int j = W - 1; j >= 0; --j)
        if (k[j] != INFINITY)
          stack[sp++] = make_int2(w[j], __float_as_int(k[j]));
      if (COUNT) { ++inner; boxes += cnt; }
    } else {
      int payload = -(c + 2);
      int first = payload >> 8, count = payload & 255;
      if (COUNT) { ++leaves; faces += count; }
      const float4* f = rows + 4 * (size_t)first;
      for (int q = 0; q < count; q += 2) prefetch_l1(f + 4 * q);
      // two faces' arithmetic at once, taken in order
      for (int q = 0; q < count; q += 2) {
        bool two = q + 1 < count;
        const float4* g = two ? f + 4 : f;
        float4 A0 = f[0], N0 = f[1], P0 = f[2], Q0 = f[3];
        float4 A1 = g[0], N1 = g[1], P1 = g[2], Q1 = g[3];
        f += 8;
        float t0, ba0, bb0, t1, ba1, bb1;
        bool fr0, fr1;
        bool v0 = face_eval(r, A0, N0, P0, Q0, &t0, &ba0, &bb0, &fr0);
        bool v1 = face_eval(r, A1, N1, P1, Q1, &t1, &ba1, &bb1, &fr1);
        face_take(v0, t0, ba0, bb0, fr0, A0, h);
        face_take(two && v1, t1, ba1, bb1, fr1, A1, h);
      }
    }
  }
  t_out[i] = h.t;
  face_out[i] = h.face;
  front_out[i] = h.front ? 1.f : 0.f;
  ba_out[i] = h.ba;
  bb_out[i] = h.bb;
  if (COUNT) {
    atomicAdd(stats + STAT_NODES, pops);
    atomicAdd(stats + STAT_INNER, inner);
    atomicAdd(stats + STAT_LEAVES, leaves);
    atomicAdd(stats + STAT_FACES, faces);
    atomicMax(stats + STAT_MAX_POPS, pops);
    atomicAdd(stats + STAT_BOXES, boxes);
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

// stack_need: the stack entries the tree needs at most (collapse)
int rtf_bvh_wide_launch(const float* ro, const float* rd, int ray_stride,
                        const float* t_init, int t_stride, int n,
                        const float* wnodes, const float* rows, int root,
                        int stack_need, float* t, int* face, float* front,
                        float* ba, float* bb, long long* stats,
                        cudaStream_t stream) {
  if (stack_need < 1 || stack_need > LOCAL_STACK || root < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  dim3 grid((n + THREADS - 1) / THREADS);
  if (stats) {
    bvh_wide_kernel<true><<<grid, THREADS, 0, stream>>>(
        ro, rd, ray_stride, t_init, t_stride, n, (const float4*)wnodes,
        (const float4*)rows, root, t, face, front, ba, bb,
        (unsigned long long*)stats);
  } else {
    bvh_wide_kernel<false><<<grid, THREADS, 0, stream>>>(
        ro, rd, ray_stride, t_init, t_stride, n, (const float4*)wnodes,
        (const float4*)rows, root, t, face, front, ba, bb, nullptr);
  }
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
