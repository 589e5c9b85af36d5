// One sample wave, every bounce, one thread per ray.
//
// Replaces three Pallas TPU kernels:
//   * rtf_tpu/render/fused.py::_wave_kernel (pallas_call fused.py:1741, the
//     kernel behind fused_wave), immediates mesh variant, with its
//     surf_out/gi_from rows: the untextured variants wave_kernel<false, *, *>;
//   * rtf_tpu/render/fused_seg.py::_seg_hit_kernel (pallas_call
//     fused_seg.py:482) and _seg_shade_kernel (fused_seg.py:516, with its
//     15 gi_out rows), with the XLA texture segment between them
//     (_seg_texture, _seg_env): the textured variants wave_kernel<true, *, *>.
//     The TPU splits each bounce into a hit kernel, an XLA gather and a
//     shade kernel only because Pallas TPU has no vector gather; here each
//     thread reads the atlas itself, so a bounce stays in registers and a
//     wave is one launch.
// The third template flag is MXU: a mesh of more than 512 faces, which
// rtf_tpu runs on the same kernels with its MXU tables (fused.py::
// _mesh_closest_mxu, _mesh_anyhit_mxu; fused_seg.py's hit and shade kernels
// with has_mesh_tables), takes the Plücker pair test (plucker.cuh) over
// ops/mxu_pack.py's face rows: wave_kernel<*, *, true>; the immediates
// variants wave_kernel<*, *, false> take the projected-barycentric test
// (box_walk.cuh::tri) over the packed rows of ops/pack.py.  rtf_tpu tests
// a ray block against a whole 128-face tile in one matrix product (MXU) or
// against every baked face (immediates); one thread per ray wants fewer
// tests instead, so every variant walks one box hierarchy per mesh
// instance (box_walk.cuh: `walk`, shared with csrc/mesh_hit.cu, and in
// the MXU variants' launches whose walking blocks have little work,
// `walk_warp`, the same boxes in the same order as one loop): the
// instance's padded root box, then its groups of 8 tiles in the
// near-to-far order of the lane's own local direction's octant, within an
// entered group its tiles, within an entered tile its 16-face leaves (each
// level near to far), within an entered leaf its faces.  Every slab test is
// capped by the lane's current best t.  The winner is the least t, then
// the least key (MXU: rank * 128 + column, the tile's rank in the octant's
// visit order; immediates: the face's packed row), strictly below the best
// t from before the instance: exactly what the plain _mesh_closest_mxu and
// _mesh_closest compute (render/wave.py) and what a strict-< loop over the
// faces in key order finds, so the visit order changes only how early a
// lane stops, never the winner.  The boxes are padded, so a face at t <=
// cap lies inside every box on its path with a slab entry < t: an exactly
// tied face is still visited.  The levels that every entering ray reads
// (roots and groups) are staged in shared memory once per block where
// they fit in 48 KB (render/wave.py::smem_staged), else read from device
// memory by the same walk; tiles, leaves and faces stay in device memory
// (staging the tiles too was slower, PERF.md section 6).  The winner's
// normal, material, front and uv come from its shade row once per
// instance, from the barycentrics its test gave (MXU: normal = nc + ba
// (na - nc) + bb (nb - nc), uv = uv_c + ba (uv_a - uv_c) + bb (uv_b -
// uv_c); immediates: na ba + nb bb + nc bc, the same for uv), front =
// d . n <= 0 with the geometric normal.  rtf_tpu streams tables over 24
// MiB tile by tile from HBM only because of VMEM; here one table in device
// memory serves every size.
// The second template flag is GI (render/gi.py): a child wave passes 14 ray
// rows instead of 7, with its throughput, absorption and ray type
// (has_state), and a launch may ask for the GI rows: with surf_out the
// first-hit surface p, n, kd, k_eff (12 rows), with gi_from = k one photon
// query p, n, kd * k_eff (9 rows) per bounce b >= k; zero rows where the
// lane did not hit or never reached the bounce.  Launches that need
// neither run wave_kernel<*, false, *>, the code and registers the kernel
// had before GI.
// It computes what render/wave.py::wave_plain computes, with the same
// operations in the same order: closest hit with uv (spheres, planes, then
// the mesh's least t, then least key), kd/ks as the
// material colour times its texture map (checker, or in the textured
// variant a bilinear file texture), Blinn direct light with hard or
// adaptive disk soft shadows, Beer absorption, the environment on a miss
// (in the textured variant through its angular map), glossy perturbation,
// Schlick Fresnel/TIR and one Russian-roulette child per bounce.  Output
// is channel-major [5 + rows, N]: rad r, g, b, hit, z, then the GI rows.
//
// What bounds it on an H100: operations, not bytes.  A wave reads 28 B and
// writes 20 B per ray, but traces 1-5 closest-hit rays and as many shadow
// rays per ray, each against every primitive and the mesh faces of the
// leaves its segment enters: FP32 arithmetic and divergent control flow.
// A texture sample adds about 40 operations and four 16-byte texel loads
// that hit L2 (the atlas is a few MB): the textured wave is bound by
// operations too.
// What the design does about it:
//   * the TPU kernel's [nblk,16,8,128] packing, baked immediates, block
//     reach boxes and pl.when culls are gone; the scene is a few small
//     tables (render/scene_tables.py); the spheres, planes, mesh instances
//     and lights that every lane reads per bounce are staged in shared
//     memory once per block where they fit (render/wave.py::scene_staged;
//     2-7% faster than the read-only cache in interleaved pairs, PERF.md
//     section 6), else read from device memory by the same code;
//   * on the MXU tables a face's row holds only the pair test's 24
//     columns (96 B instead of 160; the winner's shading columns are a
//     table of their own, read once per instance), so more of the faces a
//     walk tests stay in L2; and each launch first orders its blocks
//     (block_order): the few blocks whose rays enter a mesh's root box
//     walk for several times as long as the rest, and start first instead
//     of forming the launch's tail; a closest hit's pair loop is unrolled
//     four ways, so that independent face tests overlap (PERF.md section
//     6);
//   * where a launch's walking blocks have little work (one_loop), their
//     own time sets the launch's, and on the MXU tables they walk in one
//     loop (box_walk.cuh::walk_warp): each iteration a lane makes one slab
//     test at its own level, group, tile or leaf, so the lanes of a warp
//     walk side by side instead of one lane's tiles, leaves and faces
//     after another's; a lane that enters a leaf holds it, and once 3 in
//     8 of the warp's lanes hold one they test their leaves' faces in one
//     loop together.  A lane never traverses while it holds a leaf, so
//     its own tests and caps are the nested walk's and the winner is
//     unchanged.  Where the walking work is large (many blocks, long
//     walks, or a mesh that fills the view) the launch is bound by
//     throughput, and the nested walk, which runs fewer instructions a
//     test and whose coherent lanes read the same rows, is faster; the
//     immediates (at most one group and four tiles) walk nested;
//   * each thread walks the mesh's box hierarchy with its own slab tests
//     capped by its own best t (above), so it tests the faces of the
//     16-face leaves its segment enters; the boxes are padded on the host
//     (1e-4 * (1 + the box's largest |coordinate|)), so a slab entry
//     rounded a hair past a triangle's own t cannot cull it: the culls are
//     conservative and the winner is the one the unculled loop would find;
//   * shadow rays stop at the first occluder; a thread stops when its ray
//     dies, which gives per lane what the TPU's block-wide while loop gives
//     (dead lanes contribute exactly zero there);
//   * the soft-shadow escalation is per thread: vis depends only on the
//     lane's own penumbra flag, so it equals the TPU's per-block pl.when;
//   * texture handling is a template flag: untextured scenes run the
//     untextured variant's code and registers.  A sample is four __ldg
//     float4 texel loads and the bilinear weights in FP32, in the plain
//     version's order; no texture objects, whose hardware filter keeps its
//     weights in 9-bit fixed point.  A missed lane samples nothing.
// Work counters (stats, STAT_* below) come from a separate instantiation
// of each variant (COUNT), so a launch without them runs no counting code.
// Built with --fmad=false and without --use_fast_math: IEEE division,
// sqrtf, expf, powf, sinf, cosf and asinf, and no contraction into FMAs,
// so the kernel rounds like the plain version's one-op-at-a-time
// arithmetic.  Shared-memory staging of the face rows is later work.
//
// RNG: fused.py::_rand01, bit for bit.  Lane i hashes (i % 1024) with the
// seed of its 1024-lane group, seed + (blk0 + i / 1024) * 7919 (int32
// wraparound, done here in uint32), whatever the CUDA block size.  That is
// also _seg_shade_kernel's compiled seed, seed + b*101 + program_id*7919.

#include <cuda_runtime.h>
#include <stdint.h>

#include "box_walk.cuh"
#include "plucker.cuh"

namespace {

constexpr float BIG = 1.0e30f;
constexpr float SENTINEL = 1.0e7f;
constexpr float ZERO = 1e-3f;      // reference bias epsilon
constexpr float PI_F = 3.141592653589793f;
constexpr float HALF_PI_F = 1.5707963267948966f;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float INV_2PI_F = 0.15915494309189535f;   // 0.5 / pi
constexpr float INV_PI_F = 0.3183098861837907f;
constexpr int RT_REFLECT = 1, RT_REFRACT = 2;
constexpr int INST_W = 24, FACE_W = 40, MAT_W = 24, LIGHT_W = 16;
constexpr int PAIR_W = 24, SHADE_W = 16;   // the MXU tables' face rows
constexpr int TEXMAP_W = 10, TEX_W = 10;
constexpr float TEX_FILE = 0.0f;
constexpr int THREADS = 128;

// work counters (optional): what chip_smoke.py turns into a FLOP bound
enum Stat {
  STAT_RAYS = 0,         // closest-hit rays traced
  STAT_HITS = 1,         // rays that hit and were shaded
  STAT_SHADOW = 2,       // shadow rays traced
  STAT_TILES = boxwalk::TILES,  // tile slab tests
  STAT_TRI_CLOSEST = 4,  // face tests (MXU: pair tests), closest hit
  STAT_TRI_SHADOW = 5,   // face tests (MXU: pair tests), shadow rays
  STAT_PRIM_SHADOW = 6,  // sphere/plane tests, shadow rays
  STAT_INST = 7,         // mesh-instance ray transforms
  STAT_TEX_FILE = 8,     // bilinear file-texture samples (kd, ks, env)
  STAT_TEX_CHECKER = 9,  // checker samples
  STAT_ENV = 10,         // environment-map uv computations
  // the walk's work, then clock64() cycles summed over lanes, then
  // warp-iterations and their active lanes (__popc(__activemask()),
  // counted once per warp)
  STAT_ROOT = 11,        // root-box slab tests
  STAT_GROUPS = boxwalk::GROUPS,  // group slab tests
  STAT_LEAVES = boxwalk::LEAVES,  // leaf slab tests
  STAT_CYC_ROOT = 14,    // cycles: instance transform and root-box test
  STAT_CYC_WALK = 15,    // cycles: group, tile and leaf walk
  STAT_CYC_PAIR = 16,    // cycles: face (pair) loops
  STAT_CYC_BOUNCES = 17, // cycles: the whole bounce loop
  STAT_WALK_ITERS = boxwalk::WALK_ITERS,  // warp-iterations of the walk's
  STAT_WALK_LANES = boxwalk::WALK_LANES,  // slab tests, active lanes
  STAT_PAIR_ITERS = boxwalk::PAIR_ITERS,  // the same of the face loops
  STAT_PAIR_LANES = boxwalk::PAIR_LANES,
  STAT_ROOT_IN = 22,     // root-box tests passed (lanes that walk)
  STAT_CYC_PRIM = 23,    // cycles: sphere and plane tests
  STAT_CYC_SHADOW = 24,  // cycles: shadow rays (includes their tests)
  STAT_CYC_LATER = 25,   // cycles: the bounce loop from bounce 1 on
  NSTAT = 26             // with stats_blocks each block's cycles (its
                         // longest lane) follow at 26 + block
};

// One launch's inputs, what the kernels receive by value.  rtf_wave_launch
// takes a pointer to them; the host fills their mirror, _build.py::
// WaveArgs, by field name, and its fields follow these one by one.
struct Args {
  const float* rays;   // [7, n]: o xyz, d xyz, alive; with has_state
                       // [14, n]: + tput rgb, absorb rgb, ray type
  int has_state;
  float* out;          // [5 + 12 surf_out + 9 (nbounce - gi_from), n]
  int surf_out, gi_from;   // gi_from < 0: no query rows
  unsigned long long* stats;  // [NSTAT] or null
  int n;
  uint32_t seed, blk0;
  int nbounce;
  const float* spheres; int ns;
  const float* planes; int np;
  const float* insts; int ni;
  const float* roots;  // [ni, 8] padded root boxes, group range
  const float* faces;  // [T * 128, 40]; MXU: [T * 128, 24] pair columns
  const float* groups; int ng;   // [ng, 24] groups of 8 tiles
  const float* tnodes;           // [T, 24] the walk's tile rows
  const float* leaves;           // [T * 8, 8] 16-face leaves
  const float* shade;  // MXU: [T * 128, 16] the winner's shading columns
  const int* order;    // the blocks' heavy-first order (block_order), or
                       // null: block b runs lanes 128 b..
  int staged;          // roots and groups in shared memory
  int scene_staged;    // spheres, planes, instances, lights too
  int stats_blocks;    // per-block cycles after the counters
  const float* mats;
  const float* lights; int nl;
  const float* texmaps;
  const float* textures;
  const float4* atlas; int atlas_w;
  int env_tm, env_l2;
  float env[3];
  float coef;
  int inverse_square, env_on_reflect_miss;
  float tot_thr, col_thr;
  int shadow_max, shadow_min;
  int need_uv, has_gloss;
};

struct Hit {
  float t, nx, ny, nz, u, v;
  int mtl;
  bool front;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
// the small tables every lane reads per bounce (spheres, planes, mesh
// instances, lights): shared memory where the launch staged them (`stage`),
// else device memory; generic loads serve both
__device__ __forceinline__ float scene_ld(const float* p) { return *p; }

__device__ __forceinline__ float rand01(uint32_t seed, uint32_t idx) {
  uint32_t x = (idx * 2654435761u) ^ seed;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-30f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float atan_poly(float r) {
  float r2 = r * r;
  return r * (0.99997726f + r2 * (-0.33262347f + r2 * (
      0.19354346f + r2 * (-0.11643287f + r2 * (
          0.05265332f + r2 * -0.01172120f)))));
}

// fused.py::_atan2 (the polynomial, not atan2f: checker edges depend on it)
__device__ __forceinline__ float atan2p(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  float a = atan_poly(mn / fmaxf(mx, 1e-30f));
  a = ay > ax ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float asinp(float x) {
  return atan2p(x, sqrtf(fmaxf(1.0f - x * x, 0.0f)));
}

__device__ __forceinline__ void mat3(const float* m, float x, float y,
                                     float z, float& rx, float& ry,
                                     float& rz) {
  rx = scene_ld(m + 0) * x + scene_ld(m + 1) * y + scene_ld(m + 2) * z;
  ry = scene_ld(m + 3) * x + scene_ld(m + 4) * y + scene_ld(m + 5) * z;
  rz = scene_ld(m + 6) * x + scene_ld(m + 7) * y + scene_ld(m + 8) * z;
}

__device__ __forceinline__ void to_local(const float* row, const float o[3],
                                         const float d[3], float lo[3],
                                         float ldir[3]) {
  mat3(row, o[0] - scene_ld(row + 9), o[1] - scene_ld(row + 10),
       o[2] - scene_ld(row + 11), lo[0], lo[1], lo[2]);
  mat3(row, d[0], d[1], d[2], ldir[0], ldir[1], ldir[2]);
}

__device__ __forceinline__ void offset_origin(const float p[3],
                                              const float n[3],
                                              const float d[3], float r[3]) {
  float scale = 1e-4f * (1.0f + fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])),
                                      fabsf(p[2])));
  float side = d[0] * n[0] + d[1] * n[1] + d[2] * n[2] >= 0.0f ? scale
                                                               : -scale;
  r[0] = p[0] + n[0] * side;
  r[1] = p[1] + n[1] * side;
  r[2] = p[2] + n[2] * side;
}

// sphere quadratic in the fused kernel's re-origined form (fused.py:991-1005)
__device__ __forceinline__ bool sphere(const float lo[3], const float l[3],
                                       float& t1, float& t2) {
  float a = fmaxf(l[0] * l[0] + l[1] * l[1] + l[2] * l[2], 1e-30f);
  float half_b = lo[0] * l[0] + lo[1] * l[1] + lo[2] * l[2];
  float tc = -half_b / a;
  float mx = lo[0] + tc * l[0];
  float my = lo[1] + tc * l[1];
  float mz = lo[2] + tc * l[2];
  float disc = 4.0f * a * (1.0f - (mx * mx + my * my + mz * mz));
  float s = sqrtf(fmaxf(disc, 0.0f)) / (2.0f * a);
  t1 = tc + s;
  t2 = tc - s;
  return disc >= ZERO;
}

__device__ __forceinline__ bool plane(const float lo[3], const float l[3],
                                      float& tp, float& hx, float& hy) {
  bool nz_ok = l[2] != 0.0f;
  tp = -(lo[2] / (nz_ok ? l[2] : 1e-30f));
  hx = lo[0] + tp * l[0];
  hy = lo[1] + tp * l[1];
  return nz_ok && hx >= -1.0f && hx <= 1.0f && hy >= -1.0f && hy <= 1.0f;
}

// ---- the mesh: one walk (box_walk.cuh) for the immediates and the MXU
// tables

// the hierarchy's levels for this launch: the block's shared-memory copies
// of the roots and groups where they were staged, else the tables in
// device memory (generic loads serve both)
__device__ __forceinline__ boxwalk::Levels levels(const Args& A) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  return boxwalk::Levels{A.staged ? sm : A.roots,
                         A.staged ? sm + boxwalk::ROOT_W * A.ni : A.groups,
                         A.tnodes, A.leaves};
}

// the small tables that every lane reads per bounce: spheres, planes,
// mesh instances, lights (scene_ld)
struct Scene {
  const float* spheres;
  const float* planes;
  const float* insts;
  const float* lights;
};

// copy the launch's staged tables into shared memory, every thread of the
// block behind one barrier (16-byte rows): the roots and groups
// (A.staged), then the small scene tables (A.scene_staged; the counterpart
// of the TPU kernel's baked immediates).  Returns where the scene tables
// are: in shared memory, or where they were staged not, in device memory.
__device__ __forceinline__ Scene stage(const Args& A) {
  extern __shared__ float4 smem4[];
  const int nr = A.staged ? 2 * A.ni : 0;
  const int nt = nr + (A.staged ? 6 * A.ng : 0);
  const int ns = 6 * A.ns, np = ns + 6 * A.np, ni = np + 6 * A.ni;
  const int n4 = nt + (A.scene_staged ? ni + 4 * A.nl : 0);
  if (n4 > 0) {   // the same for the whole launch
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      const int r = q - nt;
      const float* src = q < nr ? A.roots + 4 * q
          : q < nt ? A.groups + 4 * (q - nr)
          : r < ns ? A.spheres + 4 * r
          : r < np ? A.planes + 4 * (r - ns)
          : r < ni ? A.insts + 4 * (r - np)
          : A.lights + 4 * (r - ni);
      smem4[q] = __ldg(reinterpret_cast<const float4*>(src));
    }
    __syncthreads();
  }
  if (!A.scene_staged) return Scene{A.spheres, A.planes, A.insts, A.lights};
  const float* f = reinterpret_cast<const float*>(smem4 + nt);
  return Scene{f, f + 4 * ns, f + 4 * np, f + 4 * ni};
}

// one mesh instance in the lane's local frame: the root box; returns false
// where the segment [0, cap) misses it
__device__ __forceinline__ bool enter_instance(
    const Scene& S, const boxwalk::Levels& L, int k, const float o[3],
    const float d[3], float cap, float lo[3], float l[3], float ild[3],
    unsigned long long* cnt) {
  const long long c0 = cnt ? clock64() : 0;
  to_local(S.insts + INST_W * k, o, d, lo, l);
  boxwalk::inv_dir(l, ild);
  const bool in = boxwalk::slab_row(L.roots + boxwalk::ROOT_W * k, lo, ild,
                                    cap);
  if (cnt) {
    cnt[STAT_INST] += 1;
    cnt[STAT_ROOT] += 1;
    cnt[STAT_ROOT_IN] += in;
    cnt[STAT_CYC_ROOT] += clock64() - c0;
  }
  return in;
}

// the face test of either table: on the MXU tables the Plücker pair of
// face row f (plucker.cuh; s0-s2 = sa, sb, sc), on the immediates the
// projected-barycentric test (box_walk.cuh; s0-s2 = ba, bb, bc); validity
// without a t cap
template <bool MXU>
__device__ __forceinline__ bool face_test(const Args& A, int f,
                                          const float lo[3],
                                          const float l[3], const float c[3],
                                          float& t, float& s0, float& s1,
                                          float& s2, float& dn) {
  if constexpr (MXU)
    return plucker::pair(
        reinterpret_cast<const float4*>(A.faces + PAIR_W * f), true, l, c,
        lo, t, s0, s1, s2, dn);
  return boxwalk::tri(A.faces + FACE_W * f, true, lo, l, t, dn, s0, s1, s2);
}

// Whether this block walks instance k's MXU tables in one loop (box_walk.
// cuh::walk_warp) rather than nested.  The one loop shortens a walking
// block's own time but runs more instructions a test, so it wins where
// the walking blocks' work is small enough for their own time to set the
// launch's, and loses where it is large: many blocks walking long walks,
// or a mesh that fills the view, whose coherent lanes the nested walk
// keeps on the same rows.  That work is estimated as block_order's count
// of walking blocks (order[nb]) times a walk's slab tests, the instance's
// groups plus about 64 tiles and leaves; at most WALK_WORK picks the one
// loop on every view measured (PERF.md section 6).  A launch without a
// block order walks nested.
constexpr long long WALK_WORK = 200000;

template <bool MXU>
__device__ __forceinline__ bool one_loop(const Args& A,
                                         const boxwalk::Levels& L, int k) {
  return MXU && A.order
      && A.order[gridDim.x]
      * ((long long)L.roots[boxwalk::ROOT_W * k + 7] + 64) <= WALK_WORK;
}

// fused.py::_closest_hit's mesh part (_mesh_closest, _mesh_closest_mxu)
// for one ray: per instance the least t below the best so far, then the
// least key; the winner's normal, material, front and uv are read from its
// shade row once per instance.  Immediates face rows: 12-20 vertex
// normals a/b/c, 21-29 uvw a/b/c, 30 material; MXU shade rows: 0 nc, 3
// na - nc, 6 nb - nc, 9 material, 10 uv_c, 12 uv_a - uv_c, 14 uv_b - uv_c.
template <bool MXU>
__device__ void mesh_closest(const Args& A, const Scene& S, const float o[3],
                             const float d[3], Hit& h,
                             unsigned long long* cnt) {
  const boxwalk::Levels L = levels(A);
  float lo[3], l[3], ild[3];
  for (int k = 0; k < A.ni; ++k) {
    if (!enter_instance(S, L, k, o, d, h.t, lo, l, ild, cnt)) continue;
    const long long c0 = cnt ? clock64() : 0;
    long long cpair = 0;
    float c[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (MXU) plucker::cross_od(lo, l, c);
    // bkey -1: the best t is from before this instance, so a tie loses
    int best = -1, bkey = -1;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, bdn = 0.0f;
    auto cap = [&]() { return h.t; };
    auto face = [&](int f, int key0) {
      if (cnt) cnt[STAT_TRI_CLOSEST] += 1;
      float t, s0, s1, s2, dn;
      if (!face_test<MXU>(A, f, lo, l, c, t, s0, s1, s2, dn)) return false;
      const int key = key0 + f;
      if (t < h.t || (t == h.t && key < bkey)) {
        h.t = t;
        best = f;
        bkey = key;
        b0 = s0; b1 = s1; b2 = s2; bdn = dn;
      }
      return false;
    };
    // the MXU pair loop unrolled four ways (its independent face tests
    // overlap); the immediates' loop is faster as it is (PERF.md section 6)
    if (one_loop<MXU>(A, L, k))
      boxwalk::walk_warp<false, 4>(L, k, lo, l, ild, cap, face, cnt, &cpair);
    else
      boxwalk::walk<false, MXU ? 4 : 1>(L, k, lo, l, ild, cap, face, cnt,
                                        &cpair);
    if (cnt) {
      cnt[STAT_CYC_PAIR] += cpair;
      cnt[STAT_CYC_WALK] += clock64() - c0 - cpair;
    }
    if (best < 0) continue;
    const float* I = S.insts + INST_W * k;
    float lnx, lny, lnz;
    if constexpr (MXU) {
      const float* F = A.shade + SHADE_W * best;
      float ba, bb;
      plucker::bary(b0, b1, b2, ba, bb);
      lnx = ld(F + 0) + ba * ld(F + 3) + bb * ld(F + 6);
      lny = ld(F + 1) + ba * ld(F + 4) + bb * ld(F + 7);
      lnz = ld(F + 2) + ba * ld(F + 5) + bb * ld(F + 8);
      h.mtl = (int)ld(F + 9);
      if (A.need_uv) {
        h.u = ld(F + 10) + ba * ld(F + 12) + bb * ld(F + 14);
        h.v = ld(F + 11) + ba * ld(F + 13) + bb * ld(F + 15);
      }
    } else {
      const float* F = A.faces + FACE_W * best;
      lnx = ld(F + 12) * b0 + ld(F + 15) * b1 + ld(F + 18) * b2;
      lny = ld(F + 13) * b0 + ld(F + 16) * b1 + ld(F + 19) * b2;
      lnz = ld(F + 14) * b0 + ld(F + 17) * b1 + ld(F + 20) * b2;
      h.mtl = (int)ld(F + 30);
      if (A.need_uv) {
        h.u = ld(F + 21) * b0 + ld(F + 24) * b1 + ld(F + 27) * b2;
        h.v = ld(F + 22) * b0 + ld(F + 25) * b1 + ld(F + 28) * b2;
      }
    }
    mat3(I + 12, lnx, lny, lnz, h.nx, h.ny, h.nz);
    h.front = bdn <= 0.0f;
  }
}

// fused.py::_mesh_anyhit(_mxu) for one shadow ray: some face with
// 1e-14 < t < cap, over the same hierarchy (the first found in the walk's
// order: a boolean, the same in any order)
template <bool MXU>
__device__ bool mesh_anyhit(const Args& A, const Scene& S, const float o[3],
                            const float d[3], float cap,
                            unsigned long long* cnt) {
  const boxwalk::Levels L = levels(A);
  float lo[3], l[3], ild[3];
  for (int k = 0; k < A.ni; ++k) {
    if (!enter_instance(S, L, k, o, d, cap, lo, l, ild, cnt)) continue;
    const long long c0 = cnt ? clock64() : 0;
    long long cpair = 0;
    float c[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (MXU) plucker::cross_od(lo, l, c);
    auto shadow_cap = [&]() { return cap; };
    auto face = [&](int f, int) {
      if (cnt) cnt[STAT_TRI_SHADOW] += 1;
      float t, s0, s1, s2, dn;
      return face_test<MXU>(A, f, lo, l, c, t, s0, s1, s2, dn)
          && t > 1e-14f && t < cap;
    };
    const bool hit = one_loop<MXU>(A, L, k)
        ? boxwalk::walk_warp<true, 1>(L, k, lo, l, ild, shadow_cap, face,
                                      cnt, &cpair)
        : boxwalk::walk<true, 1>(L, k, lo, l, ild, shadow_cap, face, cnt,
                                 &cpair);
    if (cnt) {
      cnt[STAT_CYC_PAIR] += cpair;
      cnt[STAT_CYC_WALK] += clock64() - c0 - cpair;
    }
    if (hit) return true;
  }
  return false;
}

// fused.py::_closest_hit: primitives first, then the mesh
template <bool MXU>
__device__ void closest_hit(const Args& A, const Scene& S, const float o[3],
                            const float d[3], Hit& h,
                            unsigned long long* cnt) {
  h.t = BIG;
  h.nx = h.ny = h.nz = 0.0f;
  h.mtl = 0;
  h.front = false;
  h.u = h.v = 0.5f;
  float lo[3], l[3];
  const long long cp0 = cnt ? clock64() : 0;
  for (int i = 0; i < A.ns; ++i) {
    const float* Sp = S.spheres + INST_W * i;
    to_local(Sp, o, d, lo, l);
    float t1, t2;
    bool has = sphere(lo, l, t1, t2);
    bool back = has && t1 > ZERO && t2 < ZERO && t1 < h.t;
    bool frontal = has && t1 > ZERO && t2 > ZERO && t2 < h.t;
    if (frontal || back) {
      float ts = frontal ? t2 : t1;
      float hx = lo[0] + ts * l[0];
      float hy = lo[1] + ts * l[1];
      float hz = lo[2] + ts * l[2];
      h.t = ts;
      mat3(Sp + 12, hx, hy, hz, h.nx, h.ny, h.nz);
      h.mtl = (int)scene_ld(Sp + 21);
      h.front = frontal;
      if (A.need_uv) {
        h.u = 0.5f - atan2p(hx, hy) * INV_2PI_F;
        h.v = 0.5f + asinp(fminf(fmaxf(hz, -1.0f), 1.0f)) * INV_PI_F;
      }
    }
  }
  for (int i = 0; i < A.np; ++i) {
    const float* P = S.planes + INST_W * i;
    to_local(P, o, d, lo, l);
    float tp, hx, hy;
    bool in = plane(lo, l, tp, hx, hy);
    if (in && tp >= ZERO && tp < h.t) {
      h.t = tp;
      h.nx = scene_ld(P + 14);
      h.ny = scene_ld(P + 17);
      h.nz = scene_ld(P + 20);
      h.mtl = (int)scene_ld(P + 21);
      h.front = l[2] <= 0.0f;
      if (A.need_uv) {
        h.u = (hx + 1.0f) * 0.5f;
        h.v = (hy + 1.0f) * 0.5f;
      }
    }
  }
  if (cnt) cnt[STAT_CYC_PRIM] += clock64() - cp0;
  mesh_closest<MXU>(A, S, o, d, h, cnt);
  norm3(h.nx, h.ny, h.nz);
}

// the spheres and planes of a shadow ray
__device__ bool prim_occluded(const Args& A, const Scene& S, const float o[3],
                              const float d[3], float cap,
                              unsigned long long* cnt) {
  float lo[3], l[3];
  for (int i = 0; i < A.ns; ++i) {
    if (cnt) cnt[STAT_PRIM_SHADOW] += 1;
    to_local(S.spheres + INST_W * i, o, d, lo, l);
    float t1, t2;
    bool has = sphere(lo, l, t1, t2);
    float ts = t2 > ZERO ? t2 : t1;
    if (has && t1 > ZERO && ts > 1e-14f && ts < cap) return true;
  }
  for (int i = 0; i < A.np; ++i) {
    if (cnt) cnt[STAT_PRIM_SHADOW] += 1;
    to_local(S.planes + INST_W * i, o, d, lo, l);
    float tp, hx, hy;
    bool in = plane(lo, l, tp, hx, hy);
    if (in && tp >= ZERO && tp > 1e-14f && tp < cap) return true;
  }
  return false;
}

// shadow ray: any occluder with 1e-14 < t < cap (GenLight::Shadow)
template <bool MXU>
__device__ bool occluded(const Args& A, const Scene& S, const float o[3],
                         const float d[3], float cap,
                         unsigned long long* cnt) {
  if (!cnt)
    return prim_occluded(A, S, o, d, cap, cnt)
        || mesh_anyhit<MXU>(A, S, o, d, cap, cnt);
  const long long c0 = clock64();
  cnt[STAT_SHADOW] += 1;
  const bool prim = prim_occluded(A, S, o, d, cap, cnt);
  cnt[STAT_CYC_PRIM] += clock64() - c0;
  const bool occ = prim || mesh_anyhit<MXU>(A, S, o, d, cap, cnt);
  cnt[STAT_CYC_SHADOW] += clock64() - c0;
  return occ;
}

// ops/texture.py::sample_texmap_ch for one lane with a map (tm >= 0): the
// map's transform, the tiling, then the checker or (TEXTURED only) the
// bilinear file texture
template <bool TEXTURED>
__device__ __forceinline__ void sample_texmap(const Args& A, int tm, float u,
                                              float v, float out[3],
                                              unsigned long long* cnt) {
  const float* P = A.texmaps + TEXMAP_W * tm;
  const float du = u - ld(P + 6);
  const float dv = v - ld(P + 7);
  const float lu = ld(P + 0) * du + ld(P + 1) * dv - ld(P + 2) * ld(P + 8);
  const float lv = ld(P + 3) * du + ld(P + 4) * dv - ld(P + 5) * ld(P + 8);
  const float* X = A.textures + TEX_W * (int)ld(P + 9);
  const float tu = lu - floorf(lu);
  const float tv = lv - floorf(lv);
  if (TEXTURED && ld(X) == TEX_FILE) {
    if (cnt) cnt[STAT_TEX_FILE] += 1;
    const float w = ld(X + 1), h = ld(X + 2);
    const float x = w * tu, y = h * tv;
    const float flx = floorf(x), fly = floorf(y);
    const float fx = x - flx, fy = y - fly;
    const int wi = (int)w, hi = (int)h;
    const int ix = min(max((int)flx, 0), wi - 1);
    const int iy = min(max((int)fly, 0), hi - 1);
    const int ixp = ix + 1 >= wi ? 0 : ix + 1;
    const int iyp = iy + 1 >= hi ? 0 : iy + 1;
    const int r0 = (int)ld(X + 3);
    const float4* row = A.atlas + (long long)(r0 + iy) * A.atlas_w;
    const float4* rowp = A.atlas + (long long)(r0 + iyp) * A.atlas_w;
    const float4 c00 = __ldg(row + ix), c10 = __ldg(row + ixp);
    const float4 c01 = __ldg(rowp + ix), c11 = __ldg(rowp + ixp);
    const float w00 = (1.0f - fx) * (1.0f - fy);
    const float w10 = fx * (1.0f - fy);
    const float w01 = (1.0f - fx) * fy;
    const float w11 = fx * fy;
    out[0] = c00.x * w00 + c10.x * w10 + c01.x * w01 + c11.x * w11;
    out[1] = c00.y * w00 + c10.y * w10 + c01.y * w01 + c11.y * w11;
    out[2] = c00.z * w00 + c10.z * w10 + c01.z * w01 + c11.z * w11;
    return;
  }
  if (cnt) cnt[STAT_TEX_CHECKER] += 1;
  const bool odd = (tu <= 0.5f) != (tv <= 0.5f);
  for (int c = 0; c < 3; ++c) out[c] = odd ? ld(X + 7 + c) : ld(X + 4 + c);
}

// kd or ks: the material colour times its texture map
// (fused_seg.py::_seg_texture; fused.py::_select_surface_color)
template <bool TEXTURED>
__device__ __forceinline__ void surface_color(const Args& A, const float* M,
                                              int base, int tm_col,
                                              const Hit& h, bool need_uv,
                                              float out[3],
                                              unsigned long long* cnt) {
  for (int c = 0; c < 3; ++c) out[c] = ld(M + base + c);
  if (!need_uv) return;
  const int tm = (int)ld(M + tm_col);
  if (tm < 0) return;
  float tex[3];
  sample_texmap<TEXTURED>(A, tm, h.u, h.v, tex, cnt);
  for (int c = 0; c < 3; ++c) out[c] = out[c] * tex[c];
}

// ops/texture.py::env_uv_ch: angular-map uv of a direction
__device__ __forceinline__ void env_uv(const float d[3], bool l2, float& u,
                                       float& v) {
  const float z = asinf(fminf(fmaxf(-d[2], -1.0f), 1.0f)) / PI_F + 0.5f;
  float denom;
  if (l2) {
    denom = sqrtf(d[0] * d[0] + d[1] * d[1]) + 1e-10f;
  } else {
    denom = fabsf(d[0]) + fabsf(d[1]);
    denom = denom == 0.0f ? 1e-30f : denom;
  }
  const float x = d[0] / denom;
  const float y = d[1] / denom;
  u = 0.5f + z * 0.5f * (x - y);
  v = 0.5f + z * 0.5f * (x + y);
}

__device__ __forceinline__ void perturb(const float n[3], float gl,
                                        uint32_t seed, uint32_t idx,
                                        float r[3]) {
  bool par = fabsf(n[0]) > 0.9f;
  float ax = par ? 0.0f : 1.0f;
  float az = par ? 1.0f : 0.0f;
  float t1x = n[1] * az, t1y = n[2] * ax - n[0] * az, t1z = -n[1] * ax;
  norm3(t1x, t1y, t1z);
  float t2x = n[1] * t1z - n[2] * t1y;
  float t2y = n[2] * t1x - n[0] * t1z;
  float t2z = n[0] * t1y - n[1] * t1x;
  float rr = sqrtf(rand01(seed, idx)) * gl;
  float th = rand01(seed + 977u, idx) * TWO_PI_F;
  float rc = rr * cosf(th), rs = rr * sinf(th);
  r[0] = n[0] + t1x * rc + t2x * rs;
  r[1] = n[1] + t1y * rc + t2y * rs;
  r[2] = n[2] + t1z * rc + t2z * rs;
  norm3(r[0], r[1], r[2]);
}

// the GI rows of one lane at one bounce (GI variants only): with
// surf_out the first-hit surface p, n, kd, k_eff at bounce 0; with
// gi_from >= 0 the query p, n, kd * k_eff at each bounce b >= gi_from.
// nrm == nullptr writes zeros (a lane that did not hit at bounce b).
__device__ __forceinline__ void write_rows(const Args& A, int i, int b,
                                           const float* p, const float* nrm,
                                           const float* kd,
                                           const float* k_eff) {
  const int n = A.n;
  float* out = A.out + i;
  if (b == 0 && A.surf_out) {
    for (int a = 0; a < 3; ++a) {
      out[(5 + a) * n] = nrm ? p[a] : 0.0f;
      out[(8 + a) * n] = nrm ? nrm[a] : 0.0f;
      out[(11 + a) * n] = nrm ? kd[a] : 0.0f;
      out[(14 + a) * n] = nrm ? k_eff[a] : 0.0f;
    }
  }
  if (A.gi_from >= 0 && b >= A.gi_from) {
    const int r = 5 + (A.surf_out ? 12 : 0) + 9 * (b - A.gi_from);
    for (int a = 0; a < 3; ++a) {
      out[(r + a) * n] = nrm ? p[a] : 0.0f;
      out[(r + 3 + a) * n] = nrm ? nrm[a] : 0.0f;
      out[(r + 6 + a) * n] = nrm ? kd[a] * k_eff[a] : 0.0f;
    }
  }
}

// The heavy-first order of a launch's blocks (MXU tables): a block in
// which some live lane's ray enters a mesh instance's padded root box walks
// the mesh and takes several times as long as one that does not (8 times
// on average on the 327,680-face ball's frame, PERF.md section 6); those
// blocks take the first slots of `order`, the others the last, so that the
// walking blocks start with the launch instead of forming its tail.
// order[nb] and order[nb + 1] count the slots taken from each end (zero
// before the launch).  A lane's work and random stream follow its own
// index, so the outputs do not depend on the order.
__global__ void __launch_bounds__(THREADS)
block_order(const Args A, int* order) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  bool enter = false;
  if (i < A.n && A.rays[6 * A.n + i] > 0.0f) {
    float o[3], d[3], lo[3], l[3], ild[3];
    for (int a = 0; a < 3; ++a) {
      o[a] = A.rays[a * A.n + i];
      d[a] = A.rays[(3 + a) * A.n + i];
    }
    const Scene S{A.spheres, A.planes, A.insts, A.lights};
    const boxwalk::Levels L{A.roots, A.groups, A.tnodes, A.leaves};
    for (int k = 0; k < A.ni && !enter; ++k)
      enter = enter_instance(S, L, k, o, d, BIG, lo, l, ild, nullptr);
  }
  const int nb = gridDim.x;
  if (__syncthreads_or(enter)) {
    if (threadIdx.x == 0) order[atomicAdd(order + nb, 1)] = blockIdx.x;
  } else if (threadIdx.x == 0) {
    order[nb - 1 - atomicAdd(order + nb + 1, 1)] = blockIdx.x;
  }
}

// (THREADS, 1): at most THREADS threads a block, and no occupancy target,
// so ptxas gives each variant the registers it needs (126-199, no spill)
// instead of spilling to fit 64-80 (PERF.md section 6, PR 7)
template <bool TEXTURED, bool GI, bool MXU, bool COUNT>
__global__ void __launch_bounds__(THREADS, 1)
wave_kernel(const Args A) {
  // the immediates variants take no block order (their code, and so their
  // registers, stay as they were: 126-128, four blocks an SM)
  const int blk = MXU && A.order ? A.order[blockIdx.x] : (int)blockIdx.x;
  int i = blk * blockDim.x + threadIdx.x;
  const long long k0 = COUNT && A.stats_blocks ? clock64() : 0;
  const Scene S = stage(A);   // before any lane leaves: the one barrier
  if (i >= A.n) return;
  const int n = A.n;
  float o[3], d[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = A.rays[a * n + i];
    d[a] = A.rays[(3 + a) * n + i];
  }
  bool alive = A.rays[6 * n + i] > 0.0f;
  float tput[3] = {1.0f, 1.0f, 1.0f}, absorb[3] = {0.0f, 0.0f, 0.0f};
  int rtype = 0;
  if (GI && A.has_state) {  // a child wave (fused.py:1679-1688)
    for (int c = 0; c < 3; ++c) {
      tput[c] = A.rays[(7 + c) * n + i];
      absorb[c] = A.rays[(10 + c) * n + i];
    }
    rtype = (int)A.rays[13 * n + i];
  }
  int rows_done = 0;  // bounces whose GI rows are written (GI only)
  float acc[3] = {0.0f, 0.0f, 0.0f}, hit0 = 0.0f, z0 = BIG;
  // the counters: a separate instantiation (COUNT), so a launch without
  // them has no counting branches and no local-memory array
  unsigned long long cnt_[NSTAT] = {};
  unsigned long long* const cnt = COUNT ? cnt_ : nullptr;
  const uint32_t idx = (uint32_t)(i & 1023);
  const uint32_t seed0 = A.seed + (A.blk0 + (uint32_t)(i >> 10)) * 7919u;
  const bool need_uv = A.need_uv != 0;

  const long long cb = cnt ? clock64() : 0;
  long long cb1 = 0;   // the clock at bounce 1's start
  for (int b = 0; b < A.nbounce && alive; ++b) {
    const uint32_t seed = seed0 + (uint32_t)b * 101u;
    if (cnt && b == 1) cb1 = clock64();
    if (cnt) cnt[STAT_RAYS] += 1;
    Hit h;
    closest_hit<MXU>(A, S, o, d, h, cnt);
    const bool hit = h.t < BIG;
    float rad[3] = {0.0f, 0.0f, 0.0f};
    if (!hit) {
      // environment on a refraction-ray miss (main.cpp:634-636)
      bool env_ok = rtype == RT_REFRACT
          || (A.env_on_reflect_miss && rtype == RT_REFLECT);
      if (env_ok) {
        float env[3] = {A.env[0], A.env[1], A.env[2]};
        if (TEXTURED && A.env_tm >= 0) {  // fused_seg.py::_seg_env
          if (cnt) cnt[STAT_ENV] += 1;
          float eu, ev, tex[3];
          env_uv(d, A.env_l2 != 0, eu, ev);
          sample_texmap<TEXTURED>(A, A.env_tm, eu, ev, tex, cnt);
          for (int c = 0; c < 3; ++c) env[c] = A.env[c] * tex[c];
        }
        for (int c = 0; c < 3; ++c) rad[c] = 0.0f + tput[c] * env[c];
      }
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + rad[c];
      alive = false;
      break;
    }
    if (cnt) cnt[STAT_HITS] += 1;
    const float* M = A.mats + MAT_W * h.mtl;
    float kd[3], ks[3];
    surface_color<TEXTURED>(A, M, 0, 22, h, need_uv, kd, cnt);
    surface_color<TEXTURED>(A, M, 3, 23, h, need_uv, ks, cnt);
    const float nrm[3] = {h.nx, h.ny, h.nz};
    const float p[3] = {o[0] + h.t * d[0], o[1] + h.t * d[1],
                        o[2] + h.t * d[2]};
    float k_eff[3];
    for (int c = 0; c < 3; ++c)
      k_eff[c] = tput[c] * (h.front ? 1.0f
                            : expf(-absorb[c] * fminf(h.t, 1e4f)));
    if (GI) {
      write_rows(A, i, b, p, nrm, kd, k_eff);
      rows_done = b + 1;
    }
    const float gloss = ld(M + 6);
    const float ior = fmaxf(ld(M + 13), 1e-6f);
    const float vx = -d[0], vy = -d[1], vz = -d[2];
    for (int c = 0; c < 3; ++c) rad[c] = ld(M + 17 + c);

    for (int li = 0; li < A.nl; ++li) {
      const float* L = S.lights + LIGHT_W * li;
      const int kind = (int)scene_ld(L);
      if (kind == 0) {  // ambient
        if (h.front)
          for (int c = 0; c < 3; ++c)
            rad[c] = rad[c] + kd[c] * scene_ld(L + 1 + c) * A.coef;
        continue;
      }
      float lx, ly, lz, tmax, inv_r2 = 1.0f;
      if (kind == 1) {  // direct
        lx = -scene_ld(L + 4) + 0.0f;
        ly = -scene_ld(L + 5) + 0.0f;
        lz = -scene_ld(L + 6) + 0.0f;
        tmax = BIG;
      } else {          // point
        lx = scene_ld(L + 7) - p[0];
        ly = scene_ld(L + 8) - p[1];
        lz = scene_ld(L + 9) - p[2];
        tmax = 1.0f;
        if (A.inverse_square)
          inv_r2 = 1.0f / fmaxf(lx * lx + ly * ly + lz * lz, 1e-30f);
      }
      const float sd[3] = {lx, ly, lz};
      if (kind == 2) norm3(lx, ly, lz);
      float hx_ = lx + vx, hy_ = ly + vy, hz_ = lz + vz;
      norm3(hx_, hy_, hz_);
      const float cos_nl = fmaxf(h.nx * lx + h.ny * ly + h.nz * lz, 0.0f);
      const float cos_nh = fmaxf(h.nx * hx_ + h.ny * hy_ + h.nz * hz_, 0.0f);
      const float spec = powf(cos_nh, gloss);

      int nmin = 1, nmax = 1;
      const float size = scene_ld(L + 10);
      if (kind == 2 && size > 0.0f) {
        nmax = A.shadow_max > 1 ? A.shadow_max : 1;
        nmin = A.shadow_min > 1 ? A.shadow_min : 1;
        nmin = nmin < nmax ? nmin : nmax;
      }
      const bool soft = nmax > 1;
      float v1[3] = {0.0f, 0.0f, 0.0f}, v2[3] = {0.0f, 0.0f, 0.0f};
      if (soft) {  // disk basis around the light direction (lights.h:74-88)
        float ux = sd[0], uy = sd[1], uz = sd[2];
        norm3(ux, uy, uz);
        bool use_y = ux > 0.8f;
        v1[0] = use_y ? uz : 0.0f * ux;
        v1[1] = use_y ? 0.0f * ux : uz;
        v1[2] = use_y ? -ux : -uy;
        norm3(v1[0], v1[1], v1[2]);
        v2[0] = v1[1] * uz - v1[2] * uy;
        v2[1] = v1[2] * ux - v1[0] * uz;
        v2[2] = v1[0] * uy - v1[1] * ux;
      }
      float vis;
      if (!soft) {
        float so[3];
        offset_origin(p, nrm, sd, so);
        vis = occluded<MXU>(A, S, so, sd, tmax, cnt) ? 0.0f : 1.0f;
      } else {
        float sums[2] = {0.0f, 0.0f};   // first nmin samples, the rest
        for (int si = 0; si < nmax; ++si) {
          if (si == nmin) {
            // penumbra lanes (first samples disagree) take the rest
            bool pen = sums[0] > 0.0f && sums[0] < (float)nmin;
            if (!pen) break;
          }
          uint32_t s = seed + 811u * (uint32_t)si;
          float r = sqrtf(rand01(s + 17u, idx)) * size;
          float ang = rand01(s + 631u, idx) * TWO_PI_F;
          float ca = cosf(ang), sa = sinf(ang);
          float td[3];
          for (int a = 0; a < 3; ++a)
            td[a] = sd[a] + (v1[a] * r * ca + v2[a] * r * sa);
          float so[3];
          offset_origin(p, nrm, td, so);
          float lit = occluded<MXU>(A, S, so, td, tmax, cnt) ? 0.0f
                                                            : 1.0f;
          sums[si < nmin ? 0 : 1] = sums[si < nmin ? 0 : 1] + lit;
        }
        bool pen = nmax > nmin && sums[0] > 0.0f && sums[0] < (float)nmin;
        vis = pen ? (sums[0] + sums[1]) * (1.0f / (float)nmax)
                  : sums[0] * (1.0f / (float)nmin);
      }
      if (h.front)
        for (int c = 0; c < 3; ++c) {
          float lit_c = (kd[c] + ks[c] * spec) * scene_ld(L + 1 + c) * A.coef
              * inv_r2 * cos_nl;
          rad[c] = rad[c] + lit_c * vis;
        }
    }
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + rad[c] * k_eff[c];
    if (b == 0) {
      hit0 = 1.0f;
      z0 = h.t;
    }

    // ---- Fresnel split (main.cpp:577-610); glossy children use perturbed
    // normals for directions, the true normal for coefficients
    const float eta = h.front ? 1.0f / ior : ior;
    const float cos_i = h.nx * vx + h.ny * vy + h.nz * vz;
    float nr[3] = {h.nx, h.ny, h.nz}, nt[3] = {h.nx, h.ny, h.nz};
    float cos_r = cos_i, cos_t = cos_i;
    if (A.has_gloss) {
      const float rg = ld(M + 20), tg = ld(M + 21);
      float pr[3], pt[3];
      perturb(nrm, rg, seed + 2617u, idx, pr);
      perturb(nrm, tg, seed + 3499u, idx, pt);
      if (rg > 0.0f) for (int a = 0; a < 3; ++a) nr[a] = pr[a];
      if (tg > 0.0f) for (int a = 0; a < 3; ++a) nt[a] = pt[a];
      cos_r = nr[0] * vx + nr[1] * vy + nr[2] * vz;
      cos_t = nt[0] * vx + nt[1] * vy + nt[2] * vz;
    }
    const float sgn = cos_t > 0.0f ? 1.0f : -1.0f;
    const float yx = nt[0] * sgn, yy = nt[1] * sgn, yz = nt[2] * sgn;
    const float zx = vy * yz - vz * yy;
    const float zy = vz * yx - vx * yz;
    const float zz = vx * yy - vy * yx;
    float xx = yy * zz - yz * zy;
    float xy = yz * zx - yx * zz;
    float xz = yx * zy - yy * zx;
    norm3(xx, xy, xz);
    const float sin_i = sqrtf(fmaxf(1.0f - cos_i * cos_i, 0.0f));
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    const float sin_o = fminf(fmaxf(sin_t * eta, 0.0f), 1.0f);
    const float cos_o = sqrtf(fmaxf(1.0f - sin_o * sin_o, 0.0f));
    float tdx = -xx * sin_o - yx * cos_o;
    float tdy = -xy * sin_o - yy * cos_o;
    float tdz = -xz * sin_o - yz * cos_o;
    norm3(tdx, tdy, tdz);
    float rdx = 2.0f * cos_r * nr[0] - vx;
    float rdy = 2.0f * cos_r * nr[1] - vy;
    float rdz = 2.0f * cos_r * nr[2] - vz;
    norm3(rdx, rdy, rdz);
    const float em1 = eta - 1.0f, ep1 = eta + 1.0f;
    const float c0 = (em1 * em1) / (ep1 * ep1);
    const float r_c = c0 + (1.0f - c0) * powf(1.0f - fabsf(cos_i), 5.0f);
    const float t_c = 1.0f - r_c;
    const bool tot = (eta * sin_i) > A.tot_thr;
    float rk[3], tk[3], r_w[3], t_w[3];
    bool r_go = false, t_go = false;
    for (int c = 0; c < 3; ++c) {
      const float refl = ld(M + 7 + c), refr = ld(M + 10 + c);
      rk[c] = tot ? refl + refr : refl + refr * r_c;
      tk[c] = tot ? 0.0f : refr * t_c;
      r_w[c] = k_eff[c] * rk[c];
      t_w[c] = k_eff[c] * tk[c];
      r_go = r_go || rk[c] > A.col_thr;
      t_go = t_go || tk[c] > A.col_thr;
    }

    // ---- Russian-roulette continuation (integrator._rr_select)
    const float wr = r_go ? (r_w[0] + r_w[1] + r_w[2]) * (1.0f / 3.0f) : 0.0f;
    const float wt = t_go ? (t_w[0] + t_w[1] + t_w[2]) * (1.0f / 3.0f) : 0.0f;
    const float wsum = wr + wt;
    const float u = rand01(seed, idx) * fmaxf(wsum, 1e-30f);
    const bool take_r = (u < wr || wt <= 0.0f) && wr > 0.0f;
    const float scale = wsum / fmaxf(take_r ? wr : wt, 1e-30f);
    if (!(wsum > 0.0f)) {
      alive = false;
      break;
    }
    const float cd[3] = {take_r ? rdx : tdx, take_r ? rdy : tdy,
                         take_r ? rdz : tdz};
    offset_origin(p, nrm, cd, o);
    for (int c = 0; c < 3; ++c) {
      d[c] = cd[c];
      tput[c] = (take_r ? r_w[c] : t_w[c]) * scale;
      absorb[c] = ld(M + 14 + c);
    }
    rtype = take_r ? RT_REFLECT : RT_REFRACT;
  }
  if (cnt) {
    const long long ce = clock64();
    cnt_[STAT_CYC_BOUNCES] += ce - cb;
    if (cb1) cnt_[STAT_CYC_LATER] += ce - cb1;
  }

  A.out[0 * n + i] = acc[0];
  A.out[1 * n + i] = acc[1];
  A.out[2 * n + i] = acc[2];
  A.out[3 * n + i] = hit0;
  A.out[4 * n + i] = z0;
  if (GI) {
    // bounce 0 missed or never ran, and the bounces the lane never
    // reached: zero rows (fused.py:1224-1227 pre-zeroes them)
    for (int b = rows_done; b < A.nbounce; ++b)
      write_rows(A, i, b, nullptr, nullptr, nullptr, nullptr);
  }
  if (cnt)
    for (int s = 0; s < NSTAT; ++s)
      if (cnt_[s]) atomicAdd(A.stats + s, cnt_[s]);
  if (cnt && A.stats_blocks)
    atomicMax(A.stats + NSTAT + blk,
              (unsigned long long)(clock64() - k0));
}

// launch one variant with `smem` bytes of dynamic shared memory, its
// counting instantiation where the launch takes counters
template <bool TEXTURED, bool GI, bool MXU>
cudaError_t launch(int blocks, size_t smem, cudaStream_t st,
                   const Args& A) {
  if (A.stats)
    wave_kernel<TEXTURED, GI, MXU, true><<<blocks, THREADS, smem, st>>>(A);
  else
    wave_kernel<TEXTURED, GI, MXU, false><<<blocks, THREADS, smem, st>>>(A);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// _build.load refuses a library whose Args has another size than its mirror
int rtf_wave_args_size() { return (int)sizeof(Args); }

// args points to an Args; its type stays in the kernels' unnamed
// namespace, where a C++ signature would give this entry internal linkage
int rtf_wave_launch(const void* args, int textured, int mxu, int* order,
                    void* stream) {
  Args A = *static_cast<const Args*>(args);
  const int n = A.n;
  if (n <= 0) return 0;
  A.order = nullptr;
  int blocks = (n + THREADS - 1) / THREADS;
  const bool gi = A.has_state || A.surf_out || A.gi_from >= 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem =
      (A.staged ? sizeof(float) * (boxwalk::ROOT_W * A.ni
                                   + boxwalk::NODE_W * A.ng) : 0)
      + (A.scene_staged ? sizeof(float) * (INST_W * (A.ns + A.np + A.ni)
                                           + LIGHT_W * A.nl) : 0);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (mxu && order) {
    e = cudaMemsetAsync(order + blocks, 0, 2 * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    block_order<<<blocks, THREADS, 0, st>>>(A, order);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    A.order = order;
  }
  if (mxu) {
    if (textured && gi)
      e = launch<true, true, true>(blocks, smem, st, A);
    else if (textured)
      e = launch<true, false, true>(blocks, smem, st, A);
    else if (gi)
      e = launch<false, true, true>(blocks, smem, st, A);
    else
      e = launch<false, false, true>(blocks, smem, st, A);
  } else if (textured && gi) {
    e = launch<true, true, false>(blocks, smem, st, A);
  } else if (textured) {
    e = launch<true, false, false>(blocks, smem, st, A);
  } else if (gi) {
    e = launch<false, true, false>(blocks, smem, st, A);
  } else {
    e = launch<false, false, false>(blocks, smem, st, A);
  }
  return (int)e;
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
