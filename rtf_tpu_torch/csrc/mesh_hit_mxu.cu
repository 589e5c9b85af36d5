// Dense closest ray-triangle hit over a Plücker triangle matrix: a TF32
// tensor-core filter of the edge signs, then the exact FP32 pair test of
// csrc/plucker.cuh on the few pairs the filter cannot reject.
//
// Replaces the Pallas TPU kernel rtf_tpu/ops/pallas_mesh_mxu.py::_kernel
// (pallas_call pallas_mesh_mxu.py:179, behind mesh_closest_hit_mxu).  It
// computes what ops/mesh_hit_mxu.py::mesh_closest_hit_mxu_plain computes,
// bit for bit:
//   * rays16 [N, 16] float32 rows: 0-2 d, 3-5 o x d, 6-8 o, 10 t_init
//     (padding rays have t_init = 0 and never hit);
//   * the faces as ops/mesh_hit_mxu.py::pack_faces packs the matrix
//     [ntiles, 16, 5 * tile] once: frags [G, 192], the sign blocks of G
//     groups of 8 faces (padded to whole 128-face stages), each face
//     scaled by a power of two and rounded to TF32, laid out as
//     mma.sync.m16n8k8 B fragments; rows [F, 24], the 22
//     exact rows of the pair test; fmap [F], each face's matrix index
//     (faces whose normal is zero never hit and are not there);
//   -> t, face (face0 + fmap, -1 = no hit before t_init), front (dn <= 0),
//      ba, bb of the winner, each [N].
// The winner is the least t, then the least matrix index: the plain
// version's rule (the lowest column among a tile's exact ties, tiles
// compared strictly).  Every valid pair with t < t_init is folded into its
// ray's best with one 64-bit atomicMin on (bits of t, face) in shared
// memory, so the order in which pairs are tested does not matter.
//
// What bounds it on an H100: operations.  Every ray meets every face.  In
// FP32 the pair's three six-term sums and the winding test are 39
// operations (5.73 ms on 480,256 rays x 20,480 faces at 67 TFLOP/s, and
// twice that in issue slots, since nothing may fuse into an FMA).  Here the
// sums run on the tensor cores (three m16n8k8 products per 16 rays x 8
// faces) and the filter costs each lane, per two pairs, 3 conversions, 3
// half-precision adds and 3 logic operations; the pairs it passes (0.15% of
// the frame's primary rays' pairs) take the FP32 test: about 190
// instructions a vote of 1,024 pairs in all.
//
// The filter.  A ray's row r = (d, o x d) is scaled by 2^-a_r so that its
// L1 norm is below 1 (+2^-21 for the FP32 sum it is measured with); each
// face's 6-vectors w_k by 2^-b_f so that every entry is below 1; so
// sum_i |r'_i w'_i| < 1 + 2^-21 for every pair, and a power of two changes
// no sign.  With e_k the exact scaled sum and D_k the tensor cores' value
// of (TF32 row) . (TF32 w_k) - EPS (the -EPS comes in as K row 6):
//   (1) TF32 rounding (ties away, relative error 2^-11 on each side):
//       |sum r~ w~ - e_k| <= ((1 + 2^-11)^2 - 1)(1 + 2^-21) < 2^-9.99
//       (with truncation instead, 2^-10 each side: < 2^-8.99);
//   (2) the tensor cores' FP32 accumulation of 8 exact products, partial
//       sums below 2, truncated or rounded, subnormal inputs flushed:
//       < 2^-18;
//   (3) the plain version's FP32 sum (6 rounded products, 5 rounded adds):
//       |fl(s_k) 2^-(a+b) - e_k| <= gamma_6 (1 + 2^-21) < 2^-21.4, plus
//       under 11 * 2^-150 * 2^120 from subnormals (a, b >= -60).
// So delta < 2^-8.98 even with truncation, and EPS = 2^-7 > 3.9 delta.  A
// pair is rejected where some D_k has its sign bit clear (D_k >= 0, so e_k
// > EPS - delta, so fl(s_k) > 0) and some D_j + 2 EPS has it set (D_j <
// -2 EPS, so e_j < -EPS + delta, so fl(s_j) < 0): its FP32 signs strictly
// disagree and the plain test rejects it too.  The D are rounded to FP16
// two pairs at a time (one logic operation then covers two pairs); that
// adds nothing: rounding to nearest keeps every sign (-0 included), and it
// is monotone with -2 EPS an FP16 value, so fp16(D) + 2 EPS < 0 only where
// D < -2 EPS.  A ray or face whose scale cannot be formed (zero or not
// finite) has zero fragments, so D = -EPS: never rejected, it takes the
// exact test with every face.  K row 7 rejects every pair of a ray that
// cannot hit (!(t_init > 1e-3)), and rows 6-7 every padding face.
//
// The design: a block of WARPS warps owns WARPS x 64 rays; each warp keeps
// its 64 rays as four TF32 A fragments in registers.  One producer warp
// streams the face fragments through a ring of STAGES stages of SG groups
// in shared memory by bulk asynchronous copies (cp.async.bulk on an
// mbarrier), so that the next stage lands while the warps compute on this
// one; no gather, no block-wide barrier per stage.  Per J = 2 groups of 8
// faces a warp loads its B fragments (one 16-byte and one 8-byte load a
// lane a group), runs three mma.sync per 16 rays (the s_a, s_b and s_c
// columns, so every lane holds the three signs of the same 4 pairs), and
// votes once; a 16 x 8 tile that holds a survivor is computed again and
// ballotted into the warp's ring queue in shared memory, and every 32
// entries each lane runs plucker::pair on one (ray, face) from the face's
// exact row.  At the end one more plucker::pair per winner gives s_a, s_b,
// s_c and dn, so front, ba and bb, bit for bit.  The block shape, the
// stage size and the groups a vote were chosen among builds timed on an
// H100; there the FP16 packing paid, FP16 products instead of TF32 barely.
// Built with --fmad=false: the exact test rounds like the plain version.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker.cuh"

namespace {

constexpr int WARPS = 4;                 // consumer warps a block
constexpr int MT = 4;                    // 16-ray m tiles a warp
constexpr int WRAYS = 16 * MT;           // rays a warp
constexpr int RAYS = WARPS * WRAYS;      // rays a block
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int FRAG = 192;                // floats of a group of 8 faces
constexpr int SG = 8;                    // groups a stage
constexpr int J = 2;                     // groups a vote
constexpr int PAD_GROUPS = 16;           // pack_faces pads to 16 groups
constexpr int STAGES = 4;
constexpr int QCAP = 256;                // queue entries a warp (a ring)
constexpr float EPS = 0.0078125f;        // 2^-7
constexpr float TWO_EPS = 2.0f * EPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t ONE = 0x3f800000u;    // 1.0f
constexpr int EXP_MIN = -60;

constexpr int RING_BYTES = STAGES * SG * FRAG * 4;
constexpr int SMEM_BYTES = 16 * STAGES + RING_BYTES + RAYS * 48 + RAYS * 8
                           + WARPS * QCAP * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// one bulk copy of `bytes` (a multiple of 16) into shared memory, counted
// on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d = a (16 x 8, TF32) x b (8 x 8, TF32), from a zero accumulator
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)), "f"(0.0f));
}

// the three products of a 16 x 8 tile: D of s_a, s_b and s_c of the same
// 4 pairs of this lane, from the group's B fragments (ab, c)
__device__ __forceinline__ void products(float da[4], float db[4],
                                         float dc[4], const uint32_t a[4],
                                         float4 ab, float2 c) {
  mma(da, a, ab.x, ab.y);
  mma(db, a, ab.z, ab.w);
  mma(dc, a, c.x, c.y);
}

__device__ __forceinline__ uint32_t h2u(__half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// the filter on two pairs (D of s_a, s_b, s_c of each) rounded to FP16:
// bit 15 set where the first pair is rejected, bit 31 the second
__device__ __forceinline__ uint32_t rejected2(float a0, float a1, float b0,
                                              float b1, float c0, float c1) {
  const __half2 ha = __floats2half2_rn(a0, a1);
  const __half2 hb = __floats2half2_rn(b0, b1);
  const __half2 hc = __floats2half2_rn(c0, c1);
  const __half2 te = __float2half2_rn(TWO_EPS);
  const uint32_t no_pos = h2u(ha) & h2u(hb) & h2u(hc);
  const uint32_t neg = h2u(__hadd2(ha, te)) | h2u(__hadd2(hb, te))
                       | h2u(__hadd2(hc, te));
  return ~no_pos & neg;
}

// some pair kept, from the AND of rejected2 words
__device__ __forceinline__ bool kept(uint32_t rej) {
  return (rej & 0x80008000u) != 0x80008000u;
}

// the filter on the 4 pairs of a tile's products: bit 15 pair 0, 31 pair
// 1, 47 pair 2, 63 pair 3
__device__ __forceinline__ uint64_t rejected4(const float da[4],
                                              const float db[4],
                                              const float dc[4]) {
  return rejected2(da[0], da[1], db[0], db[1], dc[0], dc[1])
         | static_cast<uint64_t>(
               rejected2(da[2], da[3], db[2], db[3], dc[2], dc[3])) << 32;
}

struct Ray {      // a ray staged in shared memory
  float4 dc;      // d, o x d [0]
  float4 co;      // o x d [1, 2], o [0, 1]
  float4 ot;      // o [2], t_init
};

// the exact pair test of queue entry e (ray, face), for lanes below
// `count`: a valid pair with t < t_init is folded into its ray's key;
// returns 1 for a valid pair
__device__ __forceinline__ int recheck(int2 e, int count, const Ray* rays,
                                       const float* __restrict__ rows,
                                       unsigned long long* keys) {
  if ((threadIdx.x & 31) >= count) return 0;
  const Ray r = rays[e.x];
  const float d[3] = {r.dc.x, r.dc.y, r.dc.z};
  const float c[3] = {r.dc.w, r.co.x, r.co.y};
  const float o[3] = {r.co.z, r.co.w, r.ot.x};
  float t, sa, sb, sc, dn;
  if (!plucker::pair(reinterpret_cast<const float4*>(rows + 24LL * e.y),
                     true, d, c, o, t, sa, sb, sc, dn))
    return 0;
  if (t < r.ot.y)
    atomicMin(keys + e.x,
              (static_cast<unsigned long long>(__float_as_uint(t)) << 32)
                  | static_cast<unsigned>(e.y));
  return 1;
}

// while the warp's ring queue holds 32 entries or more, each lane takes
// one through the exact test; returns (the new head, the lane's valid
// pairs)
__device__ __noinline__ int2 drain(const int2* queue, int head, int tail,
                                   const Ray* rays,
                                   const float* __restrict__ rows,
                                   unsigned long long* keys) {
  int valid = 0;
  __syncwarp();
  for (; tail - head >= 32; head += 32)
    valid += recheck(queue[(head + (threadIdx.x & 31)) & (QCAP - 1)], 32,
                     rays, rows, keys);
  return make_int2(head, valid);
}

// COUNT: add to stats[0..3] the pairs filtered (live rays x faces), the
// pairs re-checked, the valid pairs among them and the 16-ray x 8-face
// tiles that held a survivor
template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
mesh_hit_mxu_kernel(const float* __restrict__ rays16, int n,
                    const float* __restrict__ frags,
                    const float* __restrict__ rows,
                    const int* __restrict__ fmap, int nfaces, int face0,
                    float* t_out, int* face_out, float* front_out,
                    float* ba_out, float* bb_out,
                    unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  float* ring = reinterpret_cast<float*>(smem + 16 * STAGES);
  Ray* rays = reinterpret_cast<Ray*>(smem + 16 * STAGES + RING_BYTES);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(rays + RAYS);
  int2* queues = reinterpret_cast<int2*>(keys + RAYS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray0 = blockIdx.x * RAYS;
  // the fragments come in whole stages (pack_faces pads them)
  const int nstage = (nfaces + 8 * PAD_GROUPS - 1) / (8 * PAD_GROUPS)
                     * (PAD_GROUPS / SG);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int q = threadIdx.x; q < RAYS; q += THREADS) {
    const int i = ray0 + q;
    float v[11] = {};
    if (i < n)
      for (int k = 0; k < 11; ++k) v[k] = rays16[16LL * i + k];
    rays[q].dc = make_float4(v[0], v[1], v[2], v[3]);
    rays[q].co = make_float4(v[4], v[5], v[6], v[7]);
    rays[q].ot = make_float4(v[8], v[10], 0.0f, 0.0f);   // past n: dead
    keys[q] = ~0ULL;
  }
  __syncthreads();

  if (warp == WARPS) {
    // the producer: one lane keeps the ring full
    if (lane == 0)
      for (int s = 0; s < nstage; ++s) {
        const int slot = s % STAGES;
        if (s >= STAGES) bar_wait(empty + slot, ((s / STAGES) - 1) & 1);
        bulk_load(ring + slot * SG * FRAG, frags + (long long)s * SG * FRAG,
                  SG * FRAG * 4, full + slot);
      }
    return;
  }

  // this warp's rays as A fragments: lane (g, q) holds rows g and g + 8
  // of each m tile at columns q and q + 4.  Columns 0-5 are the scaled
  // row, column 6 is 1 for a live ray (it adds the faces' row 6, -EPS),
  // column 7 is 1 for a ray that cannot hit (it adds row 7: +1 to s_a and
  // -1 to s_b, so every pair is rejected)
  const int g = lane >> 2, q = lane & 3;
  const int wray = warp * WRAYS;
  uint32_t A[MT][4];
  int live_rays = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Ray& r = rays[wray + 16 * m + g + 8 * h];
      const float v[6] = {r.dc.x, r.dc.y, r.dc.z, r.dc.w, r.co.x, r.co.y};
      float l1 = fabsf(v[0]);
      for (int k = 1; k < 6; ++k) l1 = l1 + fabsf(v[k]);
      const bool live = r.ot.y > plucker::ZERO;
      const bool ok = live && isfinite(l1) && l1 > 0.0f;
      int e = 0;
      frexpf(ok ? l1 : 1.0f, &e);
      e = max(e, EXP_MIN);
      // columns q and q + 4, without indexing v by q
      const float lo = q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
      const float hi = q == 0 ? v[4] : q == 1 ? v[5] : 0.0f;
      A[m][h] = ok ? tf32(ldexpf(lo, -e)) : 0u;
      A[m][2 + h] = q == 2 ? (live ? ONE : 0u)
                  : q == 3 ? (live ? 0u : ONE)
                  : ok ? tf32(ldexpf(hi, -e)) : 0u;
      if (COUNT && q == 0 && live) ++live_rays;
    }

  int2* queue = queues + warp * QCAP;
  int head = 0, tail = 0;      // the ring queue: entries [head, tail)
  unsigned long long rechecked = 0, valid = 0, tiles = 0;

  for (int s = 0; s < nstage; ++s) {
    const int slot = s % STAGES;
    bar_wait(full + slot, (s / STAGES) & 1);
    const float* stage = ring + slot * SG * FRAG;
    for (int j = 0; j < SG; j += J) {
      // J groups of 8 faces, one vote; rej[u][m]: the rejected2 bits of
      // the lane's pairs 0 and 2, 1 and 3 in tile (u, m), ANDed
      float4 bab[J];
      float2 bc[J];
      uint32_t rej[J][MT];
#pragma unroll
      for (int u = 0; u < J; ++u) {
        bab[u] = reinterpret_cast<const float4*>(stage + (j + u) * FRAG)[lane];
        bc[u] = reinterpret_cast<const float2*>(
            stage + (j + u) * FRAG + 128)[lane];
      }
#pragma unroll
      for (int u = 0; u < J; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float da[4], db[4], dc[4];
          products(da, db, dc, A[m], bab[u], bc[u]);
          const uint64_t r = rejected4(da, db, dc);
          rej[u][m] = static_cast<uint32_t>(r)
                      & static_cast<uint32_t>(r >> 32);
        }
      uint32_t all = FULL;
#pragma unroll
      for (int u = 0; u < J; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) all &= rej[u][m];
      if (!__any_sync(FULL, kept(all))) continue;
      // a survivor: each tile that holds one is computed again and its
      // pairs are ballotted into the queue
#pragma unroll
      for (int u = 0; u < J; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (!__any_sync(FULL, kept(rej[u][m]))) continue;
          if (COUNT && lane == 0) ++tiles;
          float da[4], db[4], dc[4];
          products(da, db, dc, A[m], bab[u], bc[u]);
          const uint64_t r = rejected4(da, db, dc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool keep = !((r >> (16 * i + 15)) & 1);
            const unsigned bal = __ballot_sync(FULL, keep);
            if (keep)
              queue[(tail + __popc(bal & ((1u << lane) - 1u))) & (QCAP - 1)]
                  = make_int2(wray + 16 * m + g + 8 * (i >> 1),
                              (s * SG + j + u) * 8 + 2 * q + (i & 1));
            tail += __popc(bal);
          }
          if (tail - head >= 32) {
            if (COUNT) rechecked += (tail - head) / 32;
            const int2 hv = drain(queue, head, tail, rays, rows, keys);
            head = hv.x;
            valid += hv.y;
          }
        }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + slot);
  }
  if (tail > head) {
    __syncwarp();
    valid += recheck(queue[(head + lane) & (QCAP - 1)], tail - head, rays,
                     rows, keys);
    if (COUNT) rechecked += lane < tail - head;
  }
  __syncwarp();

  if (COUNT) {
    for (int o = 16; o > 0; o >>= 1) {
      live_rays += __shfl_xor_sync(FULL, live_rays, o);
      rechecked += __shfl_xor_sync(FULL, rechecked, o);
      valid += __shfl_xor_sync(FULL, valid, o);
    }
    if (lane == 0) {      // the q = 0 lanes counted each live ray once
      atomicAdd(stats + 0,
                static_cast<unsigned long long>(live_rays) * nfaces);
      atomicAdd(stats + 1, rechecked);
      atomicAdd(stats + 2, valid);
      atomicAdd(stats + 3, tiles);
    }
  }

  // the winners
  for (int k = lane; k < WRAYS; k += 32) {
    const int rl = wray + k, i = ray0 + rl;
    if (i >= n) break;
    const unsigned long long key = keys[rl];
    const Ray& r = rays[rl];
    float t = r.ot.y, ba = 0.0f, bb = 0.0f, fr = 0.0f;
    int face = -1;
    if (key != ~0ULL) {
      const int c = static_cast<int>(key & 0xffffffffu);
      const float d[3] = {r.dc.x, r.dc.y, r.dc.z};
      const float cc[3] = {r.dc.w, r.co.x, r.co.y};
      const float o[3] = {r.co.z, r.co.w, r.ot.x};
      float sa, sb, sc, dn;
      plucker::pair(reinterpret_cast<const float4*>(rows + 24LL * c), true,
                    d, cc, o, t, sa, sb, sc, dn);
      plucker::bary(sa, sb, sc, ba, bb);
      fr = dn <= 0.0f ? 1.0f : 0.0f;
      face = face0 + fmap[c];
    }
    t_out[i] = t;
    face_out[i] = face;
    front_out[i] = fr;
    ba_out[i] = ba;
    bb_out[i] = bb;
  }
}

}  // namespace

extern "C" {

int rtf_mesh_hit_mxu_launch(const float* rays16, int n, const float* frags,
                            const float* rows, const int* fmap, int nfaces,
                            int face0, float* t, int* face, float* front,
                            float* ba, float* bb, long long* stats,
                            void* stream) {
  if (n <= 0) return 0;
  auto kernel = stats ? mesh_hit_mxu_kernel<true>
                      : mesh_hit_mxu_kernel<false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (n + RAYS - 1) / RAYS;
  kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      rays16, n, frags, rows, fmap, nfaces, face0, t, face, front, ba, bb,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
