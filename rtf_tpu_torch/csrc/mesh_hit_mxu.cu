// Dense closest ray-triangle hit over a Plücker triangle matrix, one thread
// per ray, no culling.
//
// Replaces the Pallas TPU kernel rtf_tpu/ops/pallas_mesh_mxu.py::_kernel
// (pallas_call pallas_mesh_mxu.py:179, behind mesh_closest_hit_mxu).  It
// computes what ops/mesh_hit_mxu.py::mesh_closest_hit_mxu_plain computes:
//   * rays16 [N, 16] float32 rows: 0-2 d, 3-5 o x d, 6-8 o, 9 = 1,
//     10 t_init (padding rays have t_init = 0 and never hit);
//   * trim [ntiles, 16, 5 * tile] float32, pack_tri_matrix's layout: per
//     tile the column blocks [s_a | s_b | s_c | dn | on]; the kernel reads
//     rows 0-5 of the three sign blocks (w_a, w_b, w_c), rows 0-2 of the dn
//     block (n) and row 9 of the on block (n.a), so on = n.a - o . n, which
//     equals the matrix's o . (-n) + n.a exactly;
//   -> t, face (face0 + tile * tile_width + column, -1 = no hit before
//      t_init), front (dn <= 0), ba, bb of the winner, each [N].
// The pair test is plucker.cuh's, the TPU kernel's semantics: valid =
// inside & |dn| >= 1e-7 & t > 1e-3 & t < t_best.  A thread walks the faces
// in matrix order with a strict t < t_best, so it keeps the lowest column
// among a tile's exact ties and compares tiles strictly, the Pallas
// kernel's rule (pallas_mesh_mxu.py:136-151).  No tensor cores: the TPU
// computes the product at HIGHEST precision because a one-pass product
// loses the hit distance (pallas_mesh_mxu.py:121-122), and TF32 would too.
//
// What bounds it on an H100: operations.  Every ray meets every face (39
// FP32 operations a pair for the edge signs and the winding test, 17 more
// for the few pairs inside a winding), while a ray reads 64 B and writes
// 20 B and the matrix is read once per block from L2.
// What the design does about it: the TPU's [512 rays x 512 faces] matrix
// product per grid step becomes a per-thread loop; each block stages 256
// faces at a time in shared memory (24 KB, one coalesced read of the
// matrix columns per block), and every thread of the block reads the same
// face at the same time (a broadcast, no bank conflicts).
// Built with --fmad=false: no contraction into FMAs, so it rounds like the
// plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plucker.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STAGE = 256;     // faces staged in shared memory at a time

__global__ void __launch_bounds__(THREADS)
mesh_hit_mxu_kernel(const float* __restrict__ rays16, int n,
                    const float* __restrict__ trim, int ntiles, int tile,
                    int face0, float* t_out, int* face_out, float* front_out,
                    float* ba_out, float* bb_out) {
  __shared__ float4 sh[STAGE * plucker::FACE_FLOAT4];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  float d[3] = {0.0f, 0.0f, 0.0f}, c[3] = {0.0f, 0.0f, 0.0f};
  float o[3] = {0.0f, 0.0f, 0.0f}, t_best = 0.0f;
  if (live) {
    const float* R = rays16 + 16LL * i;
    for (int a = 0; a < 3; ++a) {
      d[a] = R[a];
      c[a] = R[3 + a];
      o[a] = R[6 + a];
    }
    t_best = R[10];
  }
  int best = -1;
  float bsa = 0.0f, bsb = 0.0f, bsc = 0.0f, bdn = 0.0f;
  const int nfaces = ntiles * tile;
  const long long row = 5LL * tile;          // a matrix row, in floats
  for (int f0 = 0; f0 < nfaces; f0 += STAGE) {
    __syncthreads();
    for (int q = threadIdx.x; q < STAGE; q += THREADS) {
      float w[4 * plucker::FACE_FLOAT4] = {};
      const int f = f0 + q;
      if (f < nfaces) {
        const int j = f / tile, col = f % tile;
        const float* M = trim + 16LL * row * j + col;
        for (int k = 0; k < 3; ++k)
          for (int r = 0; r < 6; ++r)
            w[6 * k + r] = M[r * row + k * tile];
        for (int r = 0; r < 3; ++r) w[18 + r] = M[r * row + 3 * tile];
        w[21] = M[9 * row + 4 * tile];
      }
      float4* S = sh + q * plucker::FACE_FLOAT4;
      for (int v = 0; v < plucker::FACE_FLOAT4; ++v)
        S[v] = make_float4(w[4 * v], w[4 * v + 1], w[4 * v + 2],
                           w[4 * v + 3]);
    }
    __syncthreads();
    if (!live) continue;
    const int nf = min(STAGE, nfaces - f0);
    for (int q = 0; q < nf; ++q) {
      float t, sa, sb, sc, dn;
      if (!plucker::pair(sh + q * plucker::FACE_FLOAT4, false, d, c, o, t,
                         sa, sb, sc, dn)
          || !(t < t_best))
        continue;
      t_best = t;
      best = f0 + q;
      bsa = sa; bsb = sb; bsc = sc; bdn = dn;
    }
  }
  if (!live) return;
  float ba = 0.0f, bb = 0.0f;
  if (best >= 0) plucker::bary(bsa, bsb, bsc, ba, bb);
  t_out[i] = t_best;
  face_out[i] = best >= 0 ? face0 + best : -1;
  front_out[i] = best >= 0 && bdn <= 0.0f ? 1.0f : 0.0f;
  ba_out[i] = ba;
  bb_out[i] = bb;
}

}  // namespace

extern "C" {

int rtf_mesh_hit_mxu_launch(const float* rays16, int n, const float* trim,
                            int ntiles, int tile, int face0, float* t,
                            int* face, float* front, float* ba, float* bb,
                            void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_hit_mxu_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rays16, n, trim, ntiles, tile, face0, t, face, front, ba, bb);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
