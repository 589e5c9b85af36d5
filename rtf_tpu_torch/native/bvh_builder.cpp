// The port's host library: the BVH builder and the PNG scanline unfilter
// in C++ (the port's copy of rtf_tpu/native/bvh_builder.cpp).
//
// rtf_bvh_build builds the tree of ops/bvh.py::build_bvh's NumPy builder
// (cy::BVH, cyBVH.h:122-142, 242-328) and gives the same arrays: a mean
// split on the widest axis that falls back to the other two axes, widest
// first, then to an arbitrary halving; a stable partition by center <=
// midpoint, the midpoint in float32 and the centres in float64; at most
// max_elems elements a leaf (up to 8 where no split separates them);
// children adjacent (child2 = child1 + 1) in depth-first order; node 0
// unused, the root node 1.  rtf_png_unfilter undoes PNG's five scanline
// filters (utils/png.py::unfilter_plain).
//
// A plain C interface with no state between calls: the caller allocates
// the outputs.  Every leaf holds at least one element, so n > 0 elements
// give at most 2n - 1 nodes, 2n with node 0.  Built by rtf_tpu_torch/
// _build.py::build_host with the system C++ compiler at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  const float* bmin;  // [n, 3] element bounds
  const float* bmax;
  const double* centers;  // [n, 3] split keys
  int32_t max_elems;
  int32_t* elems;  // [n] out: element ids, leaf-contiguous
  float* node_min;  // [nodes, 3] out
  float* node_max;
  int32_t* child;  // [nodes] out: first child, or -1 for a leaf
  int32_t* eoff;  // [nodes] out: a leaf's offset into elems
  int32_t* ecnt;  // [nodes] out: a leaf's element count
  int32_t nodes = 0;

  void bounds_of(int32_t lo, int32_t hi, float lo3[3], float hi3[3]) const {
    lo3[0] = lo3[1] = lo3[2] = 3.0e38f;
    hi3[0] = hi3[1] = hi3[2] = -3.0e38f;
    for (int32_t i = lo; i < hi; i++) {
      const int32_t e = elems[i];
      for (int a = 0; a < 3; a++) {
        lo3[a] = std::min(lo3[a], bmin[3 * e + a]);
        hi3[a] = std::max(hi3[a], bmax[3 * e + a]);
      }
    }
  }

  // MeanSplit (cyBVH.h:295-328): the widest axis, then the other two by
  // extent; a stable partition by center <= midpoint.  0: no split.
  int32_t find_split(int32_t lo, int32_t hi, const float lo3[3],
                     const float hi3[3]) {
    const int32_t cnt = hi - lo;
    if (cnt <= max_elems) return 0;
    const float d[3] = {hi3[0] - lo3[0], hi3[1] - lo3[1], hi3[2] - lo3[2]};
    int order[3];
    order[0] = d[0] >= d[1] ? (d[0] >= d[2] ? 0 : 2) : (d[1] >= d[2] ? 1 : 2);
    // the other two in axis order, the wider first (a tie keeps the
    // lower axis first, as the NumPy builder does)
    order[1] = order[0] == 0 ? 1 : 0;
    order[2] = order[0] == 2 ? 1 : 2;
    if (d[order[1]] < d[order[2]]) std::swap(order[1], order[2]);
    for (int s = 0; s < 3; s++) {
      const int axis = order[s];
      // the midpoint in float, as cy::BVH and the NumPy builder take it
      // (rtf_tpu's native builder takes it in double, and so splits
      // otherwise where a centre lies on the float midpoint)
      const float split = (lo3[axis] + hi3[axis]) * 0.5f;
      int32_t* b = elems + lo;
      const int32_t i = (int32_t)(std::stable_partition(
                            b, b + cnt,
                            [&](int32_t e) {
                              return centers[3 * e + axis] <= (double)split;
                            }) -
                        b);
      if (i > 0 && i < cnt) return i;
    }
    return 0;
  }

  int32_t alloc_node() {
    const int32_t id = nodes++;
    std::memset(node_min + 3 * id, 0, 12);
    std::memset(node_max + 3 * id, 0, 12);
    child[id] = -1;
    eoff[id] = 0;
    ecnt[id] = 0;
    return id;
  }

  struct Task {
    int32_t lo, hi, node;
    float lo3[3], hi3[3];
  };

  // depth first with an explicit stack (cy recurses): the left child is
  // taken next, so the node ids are ConvertTempData's
  void build(int32_t n) {
    for (int32_t i = 0; i < n; i++) elems[i] = i;
    alloc_node();  // node 0, unused
    Task t0{0, n, alloc_node(), {}, {}};
    bounds_of(0, n, t0.lo3, t0.hi3);
    std::vector<Task> stack{t0};
    while (!stack.empty()) {
      const Task t = stack.back();
      stack.pop_back();
      std::memcpy(node_min + 3 * t.node, t.lo3, 12);
      std::memcpy(node_max + 3 * t.node, t.hi3, 12);
      const int32_t cnt = t.hi - t.lo;
      int32_t i = find_split(t.lo, t.hi, t.lo3, t.hi3);
      if (i == 0 || i >= cnt) {
        if (cnt > 8) {
          i = cnt / 2;  // CY_BVH_MAX_ELEMENT_COUNT: halve anyway
        } else {
          eoff[t.node] = t.lo;
          ecnt[t.node] = cnt;
          continue;
        }
      }
      const int32_t c1 = alloc_node();
      const int32_t c2 = alloc_node();
      child[t.node] = c1;
      Task l{t.lo, t.lo + i, c1, {}, {}};
      Task r{t.lo + i, t.hi, c2, {}, {}};
      bounds_of(l.lo, l.hi, l.lo3, l.hi3);
      bounds_of(r.lo, r.hi, r.lo3, r.hi3);
      stack.push_back(r);
      stack.push_back(l);
    }
  }
};

}  // namespace

extern "C" {

// Build over n > 0 element boxes bmin, bmax [n, 3] with split keys centers
// [n, 3].  Writes node_min, node_max [2n, 3], child, eoff, ecnt [2n] and
// elems [n]; returns the node count (node 0 included).
int32_t rtf_bvh_build(const float* bmin, const float* bmax,
                      const double* centers, int32_t n, int32_t max_elems,
                      float* node_min, float* node_max, int32_t* child,
                      int32_t* eoff, int32_t* ecnt, int32_t* elems) {
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.centers = centers;
  b.max_elems = max_elems;
  b.elems = elems;
  b.node_min = node_min;
  b.node_max = node_max;
  b.child = child;
  b.eoff = eoff;
  b.ecnt = ecnt;
  b.build(n);
  return b.nodes;
}

// raw [h, stride + 1] (a filter byte, then the scanline) -> out [h, stride];
// returns -1, or the first row whose filter byte is not 0-4
int32_t rtf_png_unfilter(const uint8_t* raw, uint8_t* out, int32_t h,
                      int32_t stride, int32_t bpp) {
  const uint8_t* prev = nullptr;
  for (int32_t y = 0; y < h; y++) {
    const uint8_t f = raw[(size_t)y * (stride + 1)];
    const uint8_t* in = raw + (size_t)y * (stride + 1) + 1;
    uint8_t* o = out + (size_t)y * stride;
    switch (f) {
      case 0:
        std::memcpy(o, in, stride);
        break;
      case 1:  // Sub
        for (int32_t x = 0; x < stride; x++)
          o[x] = in[x] + (x >= bpp ? o[x - bpp] : 0);
        break;
      case 2:  // Up
        for (int32_t x = 0; x < stride; x++)
          o[x] = in[x] + (prev ? prev[x] : 0);
        break;
      case 3:  // Average
        for (int32_t x = 0; x < stride; x++) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          o[x] = in[x] + (uint8_t)((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int32_t x = 0; x < stride; x++) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = in[x] + (uint8_t)pred;
        }
        break;
      default:
        return y;
    }
    prev = o;
  }
  return -1;
}

}  // extern "C"
