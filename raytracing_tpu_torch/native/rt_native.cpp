// Native runtime components for raytracing_tpu_torch: the port's own copy
// of raytracing_tpu/native/rt_native.cpp, the same source.
//
// Host-side pieces that are not device compute: the BVH scene "compiler" and
// image serialization. Semantics intentionally mirror the NumPy fallback in
// ops/bvh.py (which itself mirrors the reference build: longest-axis median
// split over spans sorted by AABB min — reference
// src/accelerator/bvh_node.hpp:25-77) and utils/image_io.py (PPM per
// reference src/common/color.hpp:26-58). The flat skip-link output layout is
// documented in scene/types.py (BVH).
//
// Exposed via a C ABI for ctypes binding (rt_native.py); no Python headers
// needed. rt_native.py builds it with g++ -O3 -shared -fPIC into _build/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BuildCtx {
  const float* bmin;  // (n, 3) primitive AABB mins
  const float* bmax;  // (n, 3) primitive AABB maxes
  const int32_t* ids; // (n,) global primitive ids
  float* out_min;     // (2n-1, 3)
  float* out_max;     // (2n-1, 3)
  int32_t* out_prim;  // (2n-1,)
  int32_t* out_miss;  // (2n-1,)
  int32_t cursor = 0;
};

// Emit the subtree over idxs[lo, hi) in depth-first preorder; returns the
// subtree's node count. Recursion depth is O(log n) for median splits.
int32_t emit(BuildCtx& c, std::vector<int32_t>& idxs, int lo, int hi) {
  const int32_t slot = c.cursor++;
  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = lo; i < hi; ++i) {
    const int32_t p = idxs[i];
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], c.bmin[3 * p + a]);
      mx[a] = std::max(mx[a], c.bmax[3 * p + a]);
    }
  }
  std::memcpy(c.out_min + 3 * slot, mn, sizeof(mn));
  std::memcpy(c.out_max + 3 * slot, mx, sizeof(mx));

  if (hi - lo == 1) {
    c.out_prim[slot] = c.ids[idxs[lo]];
    return 1;
  }
  c.out_prim[slot] = -1;

  // longest axis of the node box (reference aabb.hpp:114-127)
  int axis = 0;
  float ext = mx[0] - mn[0];
  for (int a = 1; a < 3; ++a) {
    const float e = mx[a] - mn[a];
    if (e > ext) { ext = e; axis = a; }
  }
  // stable sort by AABB min along the axis (reference bvh_node.hpp:69;
  // stable to match the NumPy fallback's argsort(kind='stable'))
  std::stable_sort(idxs.begin() + lo, idxs.begin() + hi,
                   [&](int32_t a, int32_t b) {
                     return c.bmin[3 * a + axis] < c.bmin[3 * b + axis];
                   });
  const int mid = lo + (hi - lo) / 2;
  const int32_t nl = emit(c, idxs, lo, mid);
  const int32_t nr = emit(c, idxs, mid, hi);
  return 1 + nl + nr;
}

}  // namespace

extern "C" {

// Build the flat skip-link BVH. Arrays sized (n,3)/(n,); outputs sized
// (2n-1, 3)/(2n-1,). Returns the node count (2n-1), or -1 on bad input.
int32_t rt_bvh_build(const float* bmin, const float* bmax, const int32_t* ids,
                     int32_t n, float* out_min, float* out_max,
                     int32_t* out_prim, int32_t* out_miss) {
  if (n <= 0) return -1;
  BuildCtx c{bmin, bmax, ids, out_min, out_max, out_prim, out_miss};
  std::vector<int32_t> idxs(n);
  for (int32_t i = 0; i < n; ++i) idxs[i] = i;
  emit(c, idxs, 0, n);
  const int32_t k = c.cursor;  // == 2n-1

  // subtree sizes right-to-left, then miss links with an explicit stack
  std::vector<int64_t> size(k, 1);
  for (int32_t i = k - 1; i >= 0; --i) {
    if (out_prim[i] < 0) {
      const int32_t left = i + 1;
      const int32_t right = left + static_cast<int32_t>(size[left]);
      size[i] = 1 + size[left] + size[right];
    }
  }
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.push_back({0, -1});
  while (!stack.empty()) {
    auto [i, m] = stack.back();
    stack.pop_back();
    out_miss[i] = m;
    if (out_prim[i] < 0) {
      const int32_t left = i + 1;
      const int32_t right = left + static_cast<int32_t>(size[left]);
      stack.push_back({left, right});
      stack.push_back({right, m});
    }
  }
  return k;
}

// Serialize an (h, w, 3) u8 image as ASCII P3 PPM (reference
// color.hpp:26-58 / camera.hpp:36-37 format). Returns 0 on success.
int32_t rt_write_ppm(const char* path, const uint8_t* img, int32_t h, int32_t w) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "P3\n%d %d\n255\n", w, h);
  // Buffered formatting: ~12 bytes per pixel worst case.
  std::vector<char> buf;
  buf.reserve(static_cast<size_t>(h) * w * 12 + 64);
  char tmp[16];
  for (int64_t i = 0; i < static_cast<int64_t>(h) * w; ++i) {
    const uint8_t* px = img + 3 * i;
    const int len = std::snprintf(tmp, sizeof(tmp), "%d %d %d\n", px[0], px[1], px[2]);
    buf.insert(buf.end(), tmp, tmp + len);
  }
  const size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return written == buf.size() ? 0 : -1;
}

}  // extern "C"
