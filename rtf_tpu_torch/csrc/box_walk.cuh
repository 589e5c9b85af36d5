// The box-hierarchy walk of one ray over one mesh slot, and the
// projected-barycentric triangle test of the packed tables, shared by the
// wave kernel (all eight variants, wave_kernel.cu) and mesh_closest_hit
// (mesh_hit.cu).
//
// The tables (ops/mxu_pack.py::walk_tables builds every one of them, boxes
// padded by 1e-4 * (1 + the box's largest |coordinate|)):
//   roots  [., 8]   per slot its root box (0-5), first group, group count;
//   groups [G, 24]  8 consecutive tiles of a slot: 0-5 box, 6 first tile,
//                   7 tile count, 8-15 (read in the slot's s-th group row)
//                   the s-th group of each octant's near-to-far order,
//                   16-23 per octant the near-to-far order of the group's
//                   tiles, three bits a step;
//   tnodes [T, 24]  128-face tiles: 0-5 box, 6 first face row, 7 face
//                   count, 8-15 per octant the tile's key base, 16-23 per
//                   octant the near-to-far order of its 8 leaves;
//   leaves [T*8, 8] 16 consecutive faces: 0-5 box, 6 first face row,
//                   7 face count (0: an empty box).
// A face's key is key base * 128 + its column in its tile.  On the MXU
// tables the key base is the tile's rank in the octant's visit order (the
// order of rtf_tpu's octant walk); on the packed tables (the immediates,
// mesh_closest_hit's slot tables) it is the tile's own index, so the key
// is the face's packed row.
//
// `walk` visits a slot's groups, within an entered group its tiles, within
// an entered tile its leaves, each level near to far in the octant of the
// ray's local direction and each behind a slab test of the segment
// [0, cap()) on the padded box, and calls face(f, key0) for each face f of
// an entered leaf (its key is key0 + f), for a shadow ray until face
// returns true.  `walk_warp` (the wave kernel's MXU variants, in launches
// whose walking blocks have little work: wave_kernel.cu::one_loop) visits
// the same boxes and faces in the same order, as one loop: every iteration
// a lane loads the next box of its own level (group, tile or leaf: columns
// 0-5 are the box at every level) and makes one slab test, so lanes at
// different levels run the same instructions side by side; a lane whose
// test enters a leaf holds it and stops, and once 3 in 8 of the warp's
// lanes in the loop hold one, those lanes run their faces in one loop
// together, then traverse on (the while-while traversal of Aila and Laine,
// HPG 2009, with a threshold in place of waiting for every lane).  A lane
// does not traverse while it holds a leaf, so its own slab and face tests,
// and the cap each reads, are those of `walk`; only the lanes' alignment
// in the warp differs.  A caller
// after the closest hit keeps the least t, then the least key, strictly
// below the best t from before the slot: the plain versions' winner and a
// strict-< flat loop's in key order.  The visit order then changes only
// how early a ray stops culling, never the winner: a face at t <= cap lies
// inside every padded box on its path with a slab entry < t, so an exactly
// tied face is still visited (tests/test_torch_mesh_tree.py and
// test_torch_mxu_tree.py check it on the tables; test_torch_warp_walk.py
// emulates `walk_warp`'s warps).
//
// Built with --fmad=false and without --use_fast_math: IEEE division and
// no contraction into FMAs, so each test rounds like the plain version's
// one-op-at-a-time arithmetic.
#pragma once

#include <stdint.h>

namespace boxwalk {

constexpr float BIG = 1.0e30f;
constexpr float ZERO = 1e-3f;      // reference bias epsilon
constexpr float DZ_EPS = 1e-7f;    // reference |dn| cutoff
constexpr int ROOT_W = 8, NODE_W = 24, LEAF_W = 8;
constexpr int TILE = 128, LEAF_FACES = 16, TILE_LEAVES = 8;

// the walk's counters, at these indices of the caller's counter array
// (the wave kernel's STAT_* layout): slab tests per level, and warp-
// iterations with their active lanes of the slab tests and the face loops
enum Stat {
  TILES = 3, GROUPS = 12, LEAVES = 13, WALK_ITERS = 18, WALK_LANES = 19,
  PAIR_ITERS = 20, PAIR_LANES = 21, NSTAT = 22
};

// the four levels of a launch; roots and groups may be shared-memory
// copies (generic loads serve both)
struct Levels {
  const float* roots;
  const float* groups;
  const float* tnodes;
  const float* leaves;
};

__device__ __forceinline__ void inv_dir(const float l[3], float r[3]) {
  for (int a = 0; a < 3; ++a)
    r[a] = fabsf(l[a]) < 1e-30f ? (l[a] < 0.0f ? -1e30f : 1e30f)
                                : 1.0f / l[a];
}

// slab test of [0, cap) against the box lo = (x0, y0, z0), hi = (x1, y1,
// z1)
__device__ __forceinline__ bool slab6(float x0, float y0, float z0,
                                      float x1, float y1, float z1,
                                      const float lo[3], const float ild[3],
                                      float cap) {
  const float b0[3] = {x0, y0, z0}, b1[3] = {x1, y1, z1};
  float tmin = 0.0f, tmax = BIG;
  for (int a = 0; a < 3; ++a) {
    float t0 = (b0[a] - lo[a]) * ild[a];
    float t1 = (b1[a] - lo[a]) * ild[a];
    tmin = fmaxf(tmin, fminf(t0, t1));
    tmax = fminf(tmax, fmaxf(t0, t1));
  }
  return tmax >= tmin && tmin < cap;
}

// the same on a row whose columns 0-5 hold the box
__device__ __forceinline__ bool slab_row(const float* B, const float lo[3],
                                         const float ild[3], float cap) {
  return slab6(B[0], B[1], B[2], B[3], B[4], B[5], lo, ild, cap);
}

// projected-barycentric triangle test of a face's rows 0-11 (ops/pack.py
// layout: unit normal, n.a, K, L, the two axis masks; three 16-byte
// aligned float4, in device memory through the read-only cache when ldg,
// else in shared memory) in the Pallas kernel's operation order
// (rtf_tpu/ops/pallas_mesh.py:260-282); returns the validity without a t
// cap
__device__ __forceinline__ bool tri(const float* F, bool ldg,
                                    const float lo[3], const float l[3],
                                    float& t, float& dn, float& ba,
                                    float& bb, float& bc) {
  const float4* F4 = reinterpret_cast<const float4*>(F);
  const float4 r0 = ldg ? __ldg(F4) : F4[0];
  const float4 r1 = ldg ? __ldg(F4 + 1) : F4[1];
  const float4 r2 = ldg ? __ldg(F4 + 2) : F4[2];
  dn = l[0] * r0.x + l[1] * r0.y + l[2] * r0.z;
  float pn = lo[0] * r0.x + lo[1] * r0.y + lo[2] * r0.z - r0.w;
  bool bad = fabsf(dn) < DZ_EPS;
  t = -pn / (bad ? DZ_EPS : dn);
  float hx = lo[0] + t * l[0];
  float hy = lo[1] + t * l[1];
  float hz = lo[2] + t * l[2];
  float pu = r2.z > 0.5f ? hy : hx;
  float pv = r2.w > 0.5f ? hy : hz;
  ba = r1.x + r1.y * pu + r1.z * pv;
  bb = r1.w + r2.x * pu + r2.y * pv;
  bc = 1.0f - ba - bb;
  return !bad && t > ZERO && ba >= 0.0f && bb >= 0.0f && bc >= 0.0f;
}

// one warp-iteration of a loop of the walk: counted once per warp, by its
// first active lane, with the number of active lanes
__device__ __forceinline__ void warp_step(unsigned long long* cnt, int it) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    cnt[it] += 1;
    cnt[it + 1] += __popc(m);
  }
}

__device__ __forceinline__ int octant(const float l[3]) {
  return (l[0] >= 0.0f ? 4 : 0) + (l[1] >= 0.0f ? 2 : 0)
      + (l[2] >= 0.0f ? 1 : 0);
}

// the faces of slot root k that the segment [0, cap()) may meet (local
// origin lo, direction l, 1 / l in ild), near to far; see the top of the
// file.  ANY (shadow rays): face() returns whether to stop, and walk
// returns whether it stopped; else (closest hit) every face of an entered
// leaf is tested, the loop unrolled UNROLL ways so that independent face
// tests can overlap, and walk returns false.  With cnt the counters above;
// the face loops' cycles go to *cpair.
template <bool ANY, int UNROLL, typename Cap, typename Face>
__device__ __forceinline__ bool walk(const Levels& L, int k,
                                     const float lo[3], const float l[3],
                                     const float ild[3], Cap cap, Face face,
                                     unsigned long long* cnt,
                                     long long* cpair) {
  const int oct = octant(l);
  const float* root = L.roots + ROOT_W * k;
  const int g0 = (int)root[6], ng = (int)root[7];
  for (int s = 0; s < ng; ++s) {
    const float* G = L.groups + NODE_W * (int)L.groups[NODE_W * (g0 + s)
                                                       + 8 + oct];
    if (cnt) {
      cnt[GROUPS] += 1;
      warp_step(cnt, WALK_ITERS);
    }
    if (!slab_row(G, lo, ild, cap())) continue;
    const int j0 = (int)G[6], nj = (int)G[7];
    const uint32_t tord = (uint32_t)G[16 + oct];
    for (int q = 0; q < nj; ++q) {
      const int j = j0 + (int)((tord >> (3 * q)) & 7u);
      const float* T = L.tnodes + NODE_W * j;
      if (cnt) {
        cnt[TILES] += 1;
        warp_step(cnt, WALK_ITERS);
      }
      if (!slab_row(T, lo, ild, cap())) continue;
      const int nl = ((int)T[7] + LEAF_FACES - 1) / LEAF_FACES;
      const int key0 = (int)T[8 + oct] * TILE - (int)T[6];
      const uint32_t lord = (uint32_t)T[16 + oct];
      for (int r = 0; r < nl; ++r) {
        const float4* Lf = reinterpret_cast<const float4*>(
            L.leaves + LEAF_W * (TILE_LEAVES * j
                                 + (int)((lord >> (3 * r)) & 7u)));
        const float4 b0 = __ldg(Lf), b1 = __ldg(Lf + 1);
        if (cnt) {
          cnt[LEAVES] += 1;
          warp_step(cnt, WALK_ITERS);
        }
        if (!slab6(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, lo, ild, cap()))
          continue;
        const int fa = (int)b1.z, fb = fa + (int)b1.w;
        const long long p0 = cnt ? clock64() : 0;
        bool stop = false;
        if constexpr (ANY) {
          for (int f = fa; f < fb && !stop; ++f) {
            if (cnt) warp_step(cnt, PAIR_ITERS);
            stop = face(f, key0);
          }
        } else {
#pragma unroll UNROLL
          for (int f = fa; f < fb; ++f) {
            if (cnt) warp_step(cnt, PAIR_ITERS);
            face(f, key0);
          }
        }
        if (cnt && cpair) *cpair += clock64() - p0;
        if (stop) return true;
      }
    }
  }
  return false;
}

// the same walk as one loop of one slab test a lane an iteration, with the
// entered leaf held until 3 in 8 of the warp's lanes hold one (see the top
// of the file); the same arguments, faces and return value as `walk`.
// Votes take __activemask(): lanes reach a walk at different bounces, and
// a lane that leaves the loop leaves the votes.
template <bool ANY, int UNROLL, typename Cap, typename Face>
__device__ __forceinline__ bool walk_warp(const Levels& L, int k,
                                          const float lo[3], const float l[3],
                                          const float ild[3], Cap cap,
                                          Face face, unsigned long long* cnt,
                                          long long* cpair) {
  const int oct = octant(l);
  const float* root = L.roots + ROOT_W * k;
  const int g0 = (int)root[6], ng = (int)root[7];
  // the lane's level (0 a group, 1 a tile, 2 a leaf, 3 done) and its step
  // at each: s of the slot's groups, q of the group's tiles, r of the
  // tile's leaves; the entered group's tiles (j0, nj, tord), the entered
  // tile's leaves (j, nl, lord) and its key0; the held leaf's faces fa to
  // fb (none where fa == fb)
  int lvl = ng > 0 ? 0 : 3, s = 0, q = 0, r = 0;
  int j0 = 0, nj = 0, j = 0, nl = 0, key0 = 0, fa = 0, fb = 0;
  uint32_t tord = 0, lord = 0;
  while (true) {
    const bool held = fa < fb;
    if (lvl == 3 && !held) break;
    // traverse on while no lane holds a leaf, or fewer than 3 in 8 of the
    // loop's lanes do (PERF.md section 6 measured waiting for every lane
    // and 1-6 in 8); else the holding lanes test their faces
    const unsigned m = __activemask();
    const unsigned trav = __ballot_sync(m, !held);
    const int nheld = __popc(m & ~trav);
    if (trav != 0u && (nheld == 0 || 8 * nheld < 3 * __popc(m))) {
      if (!held) {
        const int row = lvl == 0 ? (int)L.groups[NODE_W * (g0 + s) + 8 + oct]
            : lvl == 1 ? j0 + (int)((tord >> (3 * q)) & 7u)
            : TILE_LEAVES * j + (int)((lord >> (3 * r)) & 7u);
        const float* B = lvl == 0 ? L.groups + NODE_W * row
            : lvl == 1 ? L.tnodes + NODE_W * row : L.leaves + LEAF_W * row;
        const float4 b0 = reinterpret_cast<const float4*>(B)[0];
        const float4 b1 = reinterpret_cast<const float4*>(B)[1];
        if (cnt) {
          cnt[lvl == 0 ? GROUPS : lvl == 1 ? TILES : LEAVES] += 1;
          warp_step(cnt, WALK_ITERS);
        }
        const bool in = slab6(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, lo, ild,
                              cap());
        if (in && lvl == 0) {          // into the group's tiles
          j0 = (int)b1.z;
          nj = (int)b1.w;
          tord = (uint32_t)B[16 + oct];
          lvl = 1;
          q = 0;
        } else if (in && lvl == 1) {   // into the tile's leaves
          j = row;
          nl = ((int)b1.w + LEAF_FACES - 1) / LEAF_FACES;
          key0 = (int)B[8 + oct] * TILE - (int)b1.z;
          lord = (uint32_t)B[16 + oct];
          lvl = 2;
          r = 0;
        } else {                       // a miss, or a leaf to hold
          if (in) {
            fa = (int)b1.z;
            fb = fa + (int)b1.w;
          }
          if (lvl == 2) ++r;
          else if (lvl == 1) ++q;
          else ++s;
        }
        // climb out of the levels whose steps are spent
        if (lvl == 2 && r >= nl) {
          lvl = 1;
          ++q;
        }
        if (lvl == 1 && q >= nj) {
          lvl = 0;
          ++s;
        }
        if (lvl == 0 && s >= ng) lvl = 3;
      }
    } else if (held) {   // the lanes that hold a leaf test its faces
      const long long p0 = cnt ? clock64() : 0;
      bool stop = false;
      if constexpr (ANY) {
        for (int f = fa; f < fb && !stop; ++f) {
          if (cnt) warp_step(cnt, PAIR_ITERS);
          stop = face(f, key0);
        }
      } else {
#pragma unroll UNROLL
        for (int f = fa; f < fb; ++f) {
          if (cnt) warp_step(cnt, PAIR_ITERS);
          face(f, key0);
        }
      }
      fa = fb = 0;
      if (cnt && cpair) *cpair += clock64() - p0;
      if (stop) return true;
    }
  }
  return false;
}

}  // namespace boxwalk
