// idkengine_tpu native BVH core.
//
// Host-side (CPU) acceleration-structure builder and query engine for the
// TPU renderer: SweepSAH BLAS with Early-Split-Clipping pre-splitting,
// bottom-up refit, closest-first ray traversal, box queries, PLOC TLAS, and
// the moving-sphere collision routine. This is the native component that
// plays the role of the reference's AOT-compiled C# BVH layer
// (ref: IDKEngine/Source/Bvh/{BLAS,PreSplitting,TLAS,BVH}.cs and
// Source/Shapes/Intersections.cs) — re-implemented from its described
// algorithms, not translated.
//
// Layout invariants (chosen for TPU-friendly flattening, not identical to
// the reference):
//   - root is node 0
//   - interior node stores left child index; right child = left + 1
//   - leaf stores [first, first+count) range into tri_indices
//   - tri_indices maps leaf slots to original triangle ids (post pre-split
//     a triangle id may appear in several leaves)
//
// Build: g++ -O3 -march=native -shared -fPIC -o libidk_bvh.so bvh.cpp

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define IDK_BVH_SSE 1
#endif
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Build-time thread budget (ref: BLAS.cs Parallel.For / ExecuteMaybeThreaded
// threading). IDK_BUILD_THREADS=1 forces a deterministic serial build.
static int build_threads() {
  if (const char* e = std::getenv("IDK_BUILD_THREADS")) {
    int v = std::atoi(e);
    if (v > 0) return v;
  }
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? (int)hc : 1;
}

// Run fn(i) for i in [0, n) over the thread budget (static chunking).
template <typename Fn>
static void parallel_for(uint32_t n, Fn fn) {
  int nt = std::min<int>(build_threads(), std::max<uint32_t>(n, 1));
  if (nt <= 1 || n < 2) {
    for (uint32_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt - 1);
  uint32_t chunk = (n + nt - 1) / nt;
  for (int t = 1; t < nt; t++) {
    uint32_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { for (uint32_t i = lo; i < hi; i++) fn(i); });
  }
  for (uint32_t i = 0; i < std::min(n, chunk); i++) fn(i);
  for (auto& t : ts) t.join();
}

struct Vec3 {
  float x, y, z;
  Vec3() : x(0), y(0), z(0) {}
  Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return (&x)[i]; }
  float& operator[](int i) { return (&x)[i]; }
};
static inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 operator*(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline Vec3 operator*(float s, Vec3 a) { return a * s; }
static inline Vec3 operator*(Vec3 a, Vec3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline Vec3 vmin(Vec3 a, Vec3 b) { return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)}; }
static inline Vec3 vmax(Vec3 a, Vec3 b) { return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)}; }
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float length(Vec3 a) { return std::sqrt(dot(a, a)); }

struct AABB {
  Vec3 mn, mx;
  AABB() : mn(1e30f, 1e30f, 1e30f), mx(-1e30f, -1e30f, -1e30f) {}
  void grow(Vec3 p) { mn = vmin(mn, p); mx = vmax(mx, p); }
  void grow(const AABB& b) { mn = vmin(mn, b.mn); mx = vmax(mx, b.mx); }
  Vec3 extent() const { return mx - mn; }
  Vec3 center() const { return (mn + mx) * 0.5f; }
  // Half surface area — the SAH metric (ref: MyMath.cs HalvedArea).
  float half_area() const {
    Vec3 e = extent();
    if (e.x < 0) return 0.0f;
    return e.x * (e.y + e.z) + e.y * e.z;
  }
};

// ---------------------------------------------------------------------------
// Public node layout (must match numpy structured dtype on the Python side)
// ---------------------------------------------------------------------------
struct BlasNode {
  float mn[3];
  uint32_t left_or_first;  // interior: left child; leaf: first tri slot
  float mx[3];
  uint32_t count;          // 0 => interior, >0 => leaf triangle count
};
static_assert(sizeof(BlasNode) == 32, "node must be 32 bytes");

struct Fragment {
  AABB box;
  uint32_t tri;  // original triangle id
  // The centroid is NOT stored: the build is memory-bound on fragment
  // records (binning + physical partitioning stream/swap them every level),
  // and 28 B vs 40 B is a 30% traffic cut; box.center() is 3 adds + muls.
  Vec3 centroid() const { return box.center(); }
  float centroid_axis(int a) const { return 0.5f * (box.mn[a] + box.mx[a]); }
};
static_assert(sizeof(Fragment) == 28, "fragment must be 28 bytes");

// ---------------------------------------------------------------------------
// Pre-splitting: Early-Split-Clipping of large/empty-space triangles into
// multiple fragments before the SAH build (ref: Source/Bvh/PreSplitting.cs —
// priority cbrt(extent^2 * emptyArea), budget = SplitFactor * N, recursive
// splits snapped to global octree planes).
// ---------------------------------------------------------------------------

// Clip a convex polygon against the half-space axis<=pos / axis>=pos.
static int clip_poly(const Vec3* in, int n, int axis, float pos, bool keep_below, Vec3* out) {
  int m = 0;
  for (int i = 0; i < n; i++) {
    Vec3 a = in[i], b = in[(i + 1) % n];
    float da = a[axis] - pos, db = b[axis] - pos;
    bool ina = keep_below ? (da <= 0) : (da >= 0);
    bool inb = keep_below ? (db <= 0) : (db >= 0);
    if (ina) out[m++] = a;
    if (ina != inb) {
      float t = da / (da - db);
      out[m++] = a + (b - a) * t;
    }
  }
  return m;
}

static AABB poly_aabb(const Vec3* p, int n) {
  AABB b;
  for (int i = 0; i < n; i++) b.grow(p[i]);
  return b;
}

// Largest power-of-two-aligned split plane inside (lo, hi): the octree-plane
// snapping trick (ref: PreSplitting.cs GetNodeSize bit manipulation).
static float octree_split_pos(float lo, float hi) {
  if (!(lo < hi)) return 0.5f * (lo + hi);
  // Find the coarsest grid 2^k with a plane strictly inside (lo, hi).
  float size = hi - lo;
  int e = (int)std::floor(std::log2(size));
  for (int k = e + 1; k > e - 24; k--) {
    float cell = std::ldexp(1.0f, k);
    float plane = std::ceil(lo / cell) * cell;
    if (plane > lo && plane < hi) return plane;
  }
  return 0.5f * (lo + hi);
}

static void presplit_recurse(const Vec3* tri_poly_in, int n_in, uint32_t tri_id,
                             int splits_left, std::vector<Fragment>& out) {
  AABB box = poly_aabb(tri_poly_in, n_in);
  Vec3 e = box.extent();
  if (splits_left <= 0 || n_in < 3) {
    Fragment f;
    f.box = box;
    f.tri = tri_id;
    out.push_back(f);
    return;
  }
  int axis = 0;
  if (e.y > e.x) axis = 1;
  if (e.z > e[axis]) axis = 2;
  float pos = octree_split_pos(box.mn[axis], box.mx[axis]);
  Vec3 left[16], right[16];
  int nl = clip_poly(tri_poly_in, n_in, axis, pos, true, left);
  int nr = clip_poly(tri_poly_in, n_in, axis, pos, false, right);
  if (nl < 3 || nr < 3) {
    Fragment f;
    f.box = box;
    f.tri = tri_id;
    out.push_back(f);
    return;
  }
  int half = splits_left / 2;
  presplit_recurse(left, nl, tri_id, half, out);
  presplit_recurse(right, nr, tri_id, splits_left - 1 - half, out);
}

static void make_fragments(const float* verts, const uint32_t* idx, uint32_t ntris,
                           float split_factor, std::vector<Fragment>& frags) {
  frags.clear();
  if (split_factor <= 0.0f || ntris < 2) {
    frags.resize(ntris);
    parallel_for(ntris, [&](uint32_t t) {
      Vec3 p0(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]);
      Vec3 p1(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]);
      Vec3 p2(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2]);
      Fragment f;
      f.box.grow(p0); f.box.grow(p1); f.box.grow(p2);
      f.tri = t;
      frags[t] = f;
    });
    return;
  }
  // Priority per triangle: importance of splitting = f(size, empty area)
  // (ref: PreSplitting.cs:120-130 — cbrt(extent^2 * emptyArea)).
  std::vector<float> priority(ntris);
  parallel_for(ntris, [&](uint32_t t) {
    Vec3 p0(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]);
    Vec3 p1(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]);
    Vec3 p2(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2]);
    AABB b; b.grow(p0); b.grow(p1); b.grow(p2);
    float box_area = 2.0f * b.half_area();
    float tri_area = length(cross(p1 - p0, p2 - p0));  // 2x triangle area
    float empty = std::max(box_area - tri_area, 0.0f);
    Vec3 e = b.extent();
    float ext = std::max(e.x, std::max(e.y, e.z));
    priority[t] = std::cbrt(ext * ext * empty);
  });
  double total = 0.0;
  for (uint32_t t = 0; t < ntris; t++) total += priority[t];
  uint32_t budget = (uint32_t)(split_factor * (float)ntris);
  // Per-thread fragment buffers, concatenated in chunk order (deterministic
  // fragment stream regardless of thread count).
  int nt = build_threads();
  uint32_t chunk = (ntris + nt - 1) / nt;
  std::vector<std::vector<Fragment>> parts((ntris + chunk - 1) / chunk);
  parallel_for((uint32_t)parts.size(), [&](uint32_t p) {
    uint32_t lo = p * chunk, hi = std::min(ntris, lo + chunk);
    auto& out = parts[p];
    out.reserve((uint32_t)((hi - lo) * (1.0f + split_factor)));
    for (uint32_t t = lo; t < hi; t++) {
      Vec3 poly[3] = {
          Vec3(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]),
          Vec3(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]),
          Vec3(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2])};
      int nsplits = total > 0 ? (int)std::floor((double)budget * priority[t] / total) : 0;
      nsplits = std::min(nsplits, 12);  // cap fragment blowup per triangle
      presplit_recurse(poly, 3, t, nsplits, out);
    }
  });
  size_t n_total = 0;
  for (auto& p : parts) n_total += p.size();
  frags.reserve(n_total);
  for (auto& p : parts) frags.insert(frags.end(), p.begin(), p.end());
}

// Order-preserving float→uint key (ref: Algorithms.cs FloatToKey:15).
static inline uint32_t float_to_key(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// 3-pass 11-bit LSD radix sort of (key, payload) pairs (ref: Algorithms.cs
// RadixSort:45-113 — same digit width). Stable; O(n) per pass.
static void radix_sort_pairs(std::vector<uint64_t>& a) {
  const uint32_t n = (uint32_t)a.size();
  std::vector<uint64_t> b(n);
  uint64_t* src = a.data();
  uint64_t* dst = b.data();
  uint32_t hist[2048];
  for (int pass = 0; pass < 3; pass++) {
    int shift = 32 + pass * 11;
    std::memset(hist, 0, sizeof(hist));
    for (uint32_t i = 0; i < n; i++) hist[(src[i] >> shift) & 0x7FF]++;
    uint32_t sum = 0;
    for (int d = 0; d < 2048; d++) { uint32_t c = hist[d]; hist[d] = sum; sum += c; }
    for (uint32_t i = 0; i < n; i++) dst[hist[(src[i] >> shift) & 0x7FF]++] = src[i];
    std::swap(src, dst);
  }
  if (src != a.data()) std::memcpy(a.data(), src, n * sizeof(uint64_t));
}

// ---------------------------------------------------------------------------
// SweepSAH builder over fragments with three per-axis sorted index arrays
// (ref: BLAS.cs GetBuildData:128-157, Build:159-243, TrySplit:730-873).
//
// Parity notes vs the reference's post passes:
//  - RemoveEmptySubtrees (BLAS.cs:245-273): unnecessary here — TrySplit
//    only accepts splits strictly inside (lo, hi), so no empty child is
//    ever allocated; the compaction pass would be a no-op.
//  - OptimizeStackSize (BLAS.cs:875-937, SAH-bounded deep-level collapse):
//    its role (fewer, fatter leaves tuned for the traversal kernel) lives
//    in the packet layer's bottom-up leaf collapse
//    (idkengine_tpu/ops/packet_trace.py _collapse_leaves), which merges
//    sibling leaves up to the packet kernel's leaf-row capacity.
// ---------------------------------------------------------------------------

// Per-thread sweep/partition scratch: build_range recursions on different
// threads work on disjoint [lo,hi) ranges but index rcost by in-range
// position, so the buffers must be private.
struct BuildScratch {
  std::vector<float> rcost;
  std::vector<uint32_t> idx;
  std::vector<uint32_t> keys;  // per in-range position: packed 3-axis bin ids
};
static thread_local BuildScratch t_scratch;

// Exact-sweep threshold for the hybrid build: ranges larger than this are
// split with binned SAH (one fragment pass per level, single index array);
// at/below it the three axis-sorted arrays are materialised locally and the
// exact SweepSAH recursion finishes the subtree. Measured at 2.75M atrium
// fragments on one core (min/median of 5 interleaved reps): exact sweep
// everywhere 2260/2342 ms SAH 45.86; hybrid@64 1400/1614 ms SAH 45.01
// (binning acts as a mild regulariser here, so quality even improves);
// full binned 1742/2035 ms SAH 47.00. 64 is both fastest and best-quality.
// IDK_BVH_EXACT_MAX=0 forces full binned; a huge value restores pure sweep.
static uint32_t exact_sweep_max() {
  if (const char* e = std::getenv("IDK_BVH_EXACT_MAX")) {
    long v = std::atol(e);
    if (v >= 0) return (uint32_t)v;
  }
  return 64;
}

struct Builder {
  std::vector<Fragment>& frags;  // binned phase partitions records in place
  uint32_t max_leaf;
  float trav_cost;   // SAH traversal cost relative to intersection cost 1
  std::vector<BlasNode> nodes;     // preallocated 2n; n_nodes = high water
  std::atomic<uint32_t> n_nodes{1};
  std::atomic<int> live_threads{0};
  int max_threads = 1;
  // Three axis-sorted fragment index arrays, partitioned in place during the
  // recursion; axis_idx[0] doubles as the final leaf ordering.
  std::vector<uint32_t> axis_idx[3];
  std::vector<uint8_t> side;  // membership mask (disjoint ranges => safe)

  // Threaded recursion threshold (ref: BLAS.cs:221-231 spawns ≥2^13 tris).
  static constexpr uint32_t kSpawnMin = 1u << 13;

  Builder(std::vector<Fragment>& f, uint32_t ml, float tc)
      : frags(f), max_leaf(ml), trav_cost(tc) {}

  uint32_t exact_max = 1024;

  void build() {
    const uint32_t n = (uint32_t)frags.size();
    max_threads = build_threads();
    exact_max = exact_sweep_max();
    side.resize(n);
    nodes.resize(2 * n);
    if (n <= exact_max) {
      // Small build: 3 axis-sorted index arrays by centroid (float→key radix
      // sorts, one thread per axis; ref: BLAS.cs GetBuildData:128-157) feed
      // the exact SweepSAH recursion directly.
      parallel_for(3, [&](uint32_t a) {
        std::vector<uint64_t> pairs(n);
        for (uint32_t i = 0; i < n; i++)
          pairs[i] = ((uint64_t)float_to_key(frags[i].centroid_axis((int)a)) << 32) | i;
        radix_sort_pairs(pairs);
        axis_idx[a].resize(n);
        for (uint32_t i = 0; i < n; i++) axis_idx[a][i] = (uint32_t)pairs[i];
      });
      build_range(0, 0, n);
    } else {
      // Hybrid build: binned SAH over a single identity-ordered index array
      // at the top (no sorted-axis invariant to maintain), exact sweep for
      // subtrees ≤ exact_max (axis orders sorted on demand per subtree).
      for (int a = 0; a < 3; a++) axis_idx[a].resize(n);
      for (uint32_t i = 0; i < n; i++) axis_idx[0][i] = i;
      AABB box, cbox;
      for (uint32_t i = 0; i < n; i++) {
        box.grow(frags[i].box);
        cbox.grow(frags[i].centroid());
      }
      binned_range(0, 0, n, box, cbox);
    }
    nodes.resize(n_nodes.load());
  }

  uint32_t alloc_pair() { return n_nodes.fetch_add(2); }

  AABB range_box(uint32_t lo, uint32_t hi) const {
    AABB b;
    for (uint32_t i = lo; i < hi; i++) b.grow(frags[axis_idx[0][i]].box);
    return b;
  }

  void set_node(uint32_t ni, const AABB& b, uint32_t lof, uint32_t cnt) {
    BlasNode& nd = nodes[ni];
    nd.mn[0] = b.mn.x; nd.mn[1] = b.mn.y; nd.mn[2] = b.mn.z;
    nd.mx[0] = b.mx.x; nd.mx[1] = b.mx.y; nd.mx[2] = b.mx.z;
    nd.left_or_first = lof;
    nd.count = cnt;
  }

  // Full sweep over one axis: suffix pass accumulates right AABB half-areas,
  // prefix pass evaluates SAH(i) = Al*i + Ar*(n-i) (ref: BLAS.cs:752-805,
  // including the early-break: the left term is monotonically non-decreasing
  // in i, so once it alone exceeds the best cost no later split can win).
  bool sweep_axis(int axis, uint32_t lo, uint32_t hi,
                  float& best_cost, uint32_t& best_split, int& best_axis) {
    const uint32_t n = hi - lo;
    const std::vector<uint32_t>& ids = axis_idx[axis];
    std::vector<float>& rcost = t_scratch.rcost;
    if (rcost.size() < n + 1) rcost.resize(n + 1);
    AABB right;
    for (uint32_t i = n; i-- > 1;) {
      right.grow(frags[ids[lo + i]].box);
      rcost[i] = right.half_area() * (float)(n - i);
    }
    AABB left;
    bool improved = false;
    for (uint32_t i = 1; i < n; i++) {
      left.grow(frags[ids[lo + i - 1]].box);
      float lterm = left.half_area() * (float)i;
      if (lterm >= best_cost) break;  // early out (ref: BLAS.cs:781-786)
      float c = lterm + rcost[i];
      if (c < best_cost) {
        best_cost = c;
        best_split = lo + i;
        best_axis = axis;
        improved = true;
      }
    }
    return improved;
  }

  // Stable-partition the other two axis arrays to match the chosen split
  // (ref: BLAS.cs stable partition of 3 axis arrays).
  void partition_axes(int split_axis, uint32_t lo, uint32_t mid, uint32_t hi) {
    for (uint32_t i = lo; i < mid; i++) side[axis_idx[split_axis][i]] = 0;
    for (uint32_t i = mid; i < hi; i++) side[axis_idx[split_axis][i]] = 1;
    std::vector<uint32_t>& scratch_idx = t_scratch.idx;
    if (scratch_idx.size() < hi - lo) scratch_idx.resize(hi - lo);
    for (int a = 0; a < 3; a++) {
      if (a == split_axis) continue;
      std::vector<uint32_t>& ids = axis_idx[a];
      uint32_t w0 = lo, w1 = 0;
      for (uint32_t i = lo; i < hi; i++) {
        uint32_t f = ids[i];
        if (side[f] == 0) ids[w0++] = f;
        else scratch_idx[w1++] = f;
      }
      std::memcpy(&ids[mid], scratch_idx.data(), w1 * sizeof(uint32_t));
    }
  }

  void build_range(uint32_t node_index, uint32_t lo, uint32_t hi) {
    const uint32_t n = hi - lo;
    AABB box = range_box(lo, hi);
    if (n <= 1) {
      set_node(node_index, box, lo, n);
      return;
    }
    float parent_ha = std::max(box.half_area(), 1e-30f);
    float leaf_cost = (float)n;  // n intersection tests
    float best_cost = 3.4e38f;
    uint32_t best_split = 0;
    int best_axis = -1;
    for (int a = 0; a < 3; a++) sweep_axis(a, lo, hi, best_cost, best_split, best_axis);
    // Normalized split cost: traversal + children SAH relative to parent.
    float split_cost = trav_cost + best_cost / parent_ha;
    if (best_axis < 0 || (n <= max_leaf && leaf_cost <= split_cost)) {
      set_node(node_index, box, lo, n);
      return;
    }
    if (best_axis < 0 || best_split <= lo || best_split >= hi) {
      // degenerate (all centroids equal): median split
      best_axis = 0;
      best_split = lo + n / 2;
    }
    partition_axes(best_axis, lo, best_split, hi);
    uint32_t left = alloc_pair();
    set_node(node_index, box, left, 0);
    // Spawn the left subtree on its own thread for big ranges (ref:
    // BLAS.cs:221-231 threaded recursion). Atomic pair allocation keeps the
    // invariant children-index > parent-index that refit/collapse rely on.
    if (n >= kSpawnMin && live_threads.load(std::memory_order_relaxed) < max_threads - 1) {
      live_threads.fetch_add(1);
      std::thread t([this, left, lo, best_split] {
        build_range(left, lo, best_split);
        live_threads.fetch_sub(1);
      });
      build_range(left + 1, best_split, hi);
      t.join();
    } else {
      build_range(left, lo, best_split);
      build_range(left + 1, best_split, hi);
    }
  }

  // ---- Binned top phase -----------------------------------------------
  static constexpr int kBins = 32;  // 5 bits/axis pack into one u32 key
  // Ranges below this bin only the dominant centroid axis (IDK_BVH_ONE_AXIS
  // overrides). Default OFF: measured at 2.75M on one core, one-axis below
  // 4096 saves only 7% build time (the pass is memory-bound on the 28 B
  // fragment records, not min/max-bound) while SAH degrades 120.7 -> 127.3; one-axis
  // everywhere saves 18% at SAH 137.8. Kept as a knob + negative result.
  static uint32_t one_axis_max() {
    if (const char* e = std::getenv("IDK_BVH_ONE_AXIS")) {
      long v = std::atol(e);
      if (v >= 0) return (uint32_t)v;
    }
    return 0;
  }
  const uint32_t kOneAxisMax = one_axis_max();

  // Materialise the three axis-sorted arrays over [lo,hi) so the exact
  // sweep recursion can take over the subtree. Ties broken by fragment id
  // so the build stays deterministic (radix sort in the small path is
  // stable by construction).
  void sort_local_axes(uint32_t lo, uint32_t hi) {
    for (int a = 1; a < 3; a++)
      std::copy(axis_idx[0].begin() + lo, axis_idx[0].begin() + hi,
                axis_idx[a].begin() + lo);
    for (int a = 0; a < 3; a++)
      std::sort(axis_idx[a].begin() + lo, axis_idx[a].begin() + hi,
                [&, a](uint32_t x, uint32_t y) {
                  float cx = frags[x].centroid_axis(a), cy = frags[y].centroid_axis(a);
                  return cx < cy || (cx == cy && x < y);
                });
  }

  // Binned SAH split (Wald 2007 style): ONE pass over the range's fragments
  // bins them along the dominant centroid-extent axis (geometric box,
  // centroid box, count per bin); the SAH sweep then runs over bin
  // boundaries instead of elements, the partition is a two-pointer swap of
  // (id, key) pairs, and the children's boxes come from the bins — so no
  // per-level range_box recompute and no sorted-axis invariant to maintain.
  // Replaces the exact sweep only above exact_max; the reference's quality
  // bar (BLAS.cs TrySplit exact sweep) is preserved below it.
  void binned_range(uint32_t node_index, uint32_t lo, uint32_t hi,
                    const AABB& box, const AABB& cbox) {
    const uint32_t n = hi - lo;
    if (n <= 1) {
      set_node(node_index, box, lo, n);
      return;
    }
    if (exact_max && n <= exact_max) {
      sort_local_axes(lo, hi);
      build_range(node_index, lo, hi);
      return;
    }
    struct Bin { AABB box, cbox; uint32_t count = 0; };
    // Fewer bins for small ranges: the per-call bin zero-init dominates at
    // the tree's bottom, and with n ≈ nb the bin boundaries approach the
    // exact per-element sweep anyway.
    const int nb = n >= 2048 ? kBins : (n >= 256 ? 16 : 8);
    Vec3 ext = cbox.extent();
    float scale[3];
    for (int a = 0; a < 3; a++)
      scale[a] = ext[a] > 1e-30f ? (float)nb / ext[a] : 0.0f;
    // Below kOneAxisMax, bin ONLY the dominant centroid-extent axis (the
    // classic fast-binned-SAH reduction): the bin-accumulation pass is the
    // build's hot loop and 3-axis candidates cost 3x the min/max work for
    // a quality delta that all but vanishes once ranges are small. The top
    // of the tree (where a bad split is amortized over millions of rays)
    // keeps the full 3-axis sweep.
    int a_begin = 0, a_end = 3;
    if (n < kOneAxisMax) {
      int dax = 0;
      for (int a = 1; a < 3; a++)
        if (ext[a] > ext[dax]) dax = a;
      if (scale[dax] != 0.0f) { a_begin = dax; a_end = dax + 1; }
    }
    std::vector<uint32_t>& keys = t_scratch.keys;
    if (keys.size() < n) keys.resize(n);
    Bin bins[3][kBins];
#ifdef IDK_BVH_SSE
    // SIMD bin accumulation: a Fragment is 7 contiguous 4-byte words
    // (box.mn, box.mx, tri-as-bits), so two unaligned 4-lane loads cover it
    // and each bin grow is 4 min/max ops instead of 12 scalar ones. 4th
    // lanes carry neighbouring fields (mx.x, tri bits) — never read back.
    // The centroid vector is derived in-register: 0.5*(mn+mx); its 4th lane
    // mixes mx.x with tri bits (possibly NaN) but is never read back either.
    struct alignas(16) BinV { __m128 bmn, bmx, cmn, cmx; uint32_t count; };
    BinV bv[3][kBins];
    const __m128 vinf = _mm_set1_ps(1e30f), vninf = _mm_set1_ps(-1e30f);
    for (int a = a_begin; a < a_end; a++)
      for (int b = 0; b < nb; b++)
        bv[a][b] = {vinf, vninf, vinf, vninf, 0};
    static_assert(sizeof(Fragment) == 28, "SIMD loads assume 7-word layout");
    const __m128 vhalf = _mm_set1_ps(0.5f);
    // Fragments are partitioned PHYSICALLY (28-byte records, not index
    // arrays), so this pass streams the range sequentially. The index-array
    // variant turned every level below the first into random 28 B gathers
    // over the whole fragment array (ids get scrambled by partitioning) —
    // switching to physical partitioning measured 2020 -> ~800 ms for the
    // whole recursion at 2.75M fragments on one core.
    if (a_end - a_begin == 3) {
      for (uint32_t i = 0; i < n; i++) {
        const float* fp = (const float*)&frags[lo + i];
        __m128 fmn = _mm_loadu_ps(fp + 0);
        __m128 fmx = _mm_loadu_ps(fp + 3);
        __m128 fc = _mm_mul_ps(_mm_add_ps(fmn, fmx), vhalf);
        uint32_t key = 0;
        for (int a = 0; a < 3; a++) {
          int b = (int)((0.5f * (fp[a] + fp[3 + a]) - cbox.mn[a]) * scale[a]);
          b = std::min(std::max(b, 0), nb - 1);
          BinV& bn = bv[a][b];
          bn.bmn = _mm_min_ps(bn.bmn, fmn);
          bn.bmx = _mm_max_ps(bn.bmx, fmx);
          bn.cmn = _mm_min_ps(bn.cmn, fc);
          bn.cmx = _mm_max_ps(bn.cmx, fc);
          bn.count++;
          key |= (uint32_t)b << (5 * a);
        }
        keys[i] = key;
      }
    } else {
      const int a = a_begin;
      const float cmn = cbox.mn[a], sc = scale[a];
      for (uint32_t i = 0; i < n; i++) {
        const float* fp = (const float*)&frags[lo + i];
        __m128 fmn = _mm_loadu_ps(fp + 0);
        __m128 fmx = _mm_loadu_ps(fp + 3);
        __m128 fc = _mm_mul_ps(_mm_add_ps(fmn, fmx), vhalf);
        int b = (int)((0.5f * (fp[a] + fp[3 + a]) - cmn) * sc);
        b = std::min(std::max(b, 0), nb - 1);
        BinV& bn = bv[a][b];
        bn.bmn = _mm_min_ps(bn.bmn, fmn);
        bn.bmx = _mm_max_ps(bn.bmx, fmx);
        bn.cmn = _mm_min_ps(bn.cmn, fc);
        bn.cmx = _mm_max_ps(bn.cmx, fc);
        bn.count++;
        keys[i] = (uint32_t)b << (5 * a);
      }
    }
    for (int a = a_begin; a < a_end; a++)
      for (int b = 0; b < nb; b++) {
        float t[4];
        Bin& dst = bins[a][b];
        _mm_storeu_ps(t, bv[a][b].bmn); dst.box.mn = {t[0], t[1], t[2]};
        _mm_storeu_ps(t, bv[a][b].bmx); dst.box.mx = {t[0], t[1], t[2]};
        _mm_storeu_ps(t, bv[a][b].cmn); dst.cbox.mn = {t[0], t[1], t[2]};
        _mm_storeu_ps(t, bv[a][b].cmx); dst.cbox.mx = {t[0], t[1], t[2]};
        dst.count = bv[a][b].count;
      }
#else
    for (uint32_t i = 0; i < n; i++) {
      const Fragment& f = frags[lo + i];
      uint32_t key = 0;
      for (int a = a_begin; a < a_end; a++) {
        int b = (int)((f.centroid_axis(a) - cbox.mn[a]) * scale[a]);
        b = std::min(std::max(b, 0), nb - 1);
        Bin& bn = bins[a][b];
        bn.box.grow(f.box);
        bn.cbox.grow(f.centroid());
        bn.count++;
        key |= (uint32_t)b << (5 * a);
      }
      keys[i] = key;
    }
#endif
    float best_cost = 3.4e38f;
    int best_axis = -1, best_bin = -1;
    for (int a = a_begin; a < a_end; a++) {
      if (scale[a] == 0.0f) continue;
      float rc[kBins];
      AABB right;
      uint32_t rcnt = 0;
      for (int b = nb - 1; b >= 1; b--) {
        right.grow(bins[a][b].box);
        rcnt += bins[a][b].count;
        rc[b] = right.half_area() * (float)rcnt;
      }
      AABB left;
      uint32_t lcnt = 0;
      for (int b = 0; b < nb - 1; b++) {
        left.grow(bins[a][b].box);
        lcnt += bins[a][b].count;
        if (lcnt == 0 || lcnt == n) continue;
        float c = left.half_area() * (float)lcnt + rc[b + 1];
        if (c < best_cost) { best_cost = c; best_axis = a; best_bin = b; }
      }
    }
    // Same SAH leaf criterion as the exact sweep (ref: BLAS.cs TrySplit).
    float parent_ha = std::max(box.half_area(), 1e-30f);
    if (n <= max_leaf &&
        (best_axis < 0 || (float)n <= trav_cost + best_cost / parent_ha)) {
      set_node(node_index, box, lo, n);
      return;
    }
    uint32_t mid;
    AABB lbox, lcb, rbox, rcb;
    if (best_axis < 0) {
      // All centroids coincide on every axis (or no bin boundary separates
      // them): positional median split.
      mid = lo + n / 2;
      for (uint32_t k = lo; k < mid; k++) {
        lbox.grow(frags[k].box); lcb.grow(frags[k].centroid());
      }
      for (uint32_t k = mid; k < hi; k++) {
        rbox.grow(frags[k].box); rcb.grow(frags[k].centroid());
      }
    } else {
      // Two-pointer partition of (fragment, key) by chosen-axis bin.
      const int shift = 5 * best_axis;
      uint32_t i = 0, j = n;
      while (i < j) {
        if ((int)((keys[i] >> shift) & 31u) <= best_bin) {
          i++;
        } else {
          --j;
          std::swap(keys[i], keys[j]);
          std::swap(frags[lo + i], frags[lo + j]);
        }
      }
      mid = lo + i;
      for (int b = 0; b <= best_bin; b++) {
        lbox.grow(bins[best_axis][b].box); lcb.grow(bins[best_axis][b].cbox);
      }
      for (int b = best_bin + 1; b < nb; b++) {
        rbox.grow(bins[best_axis][b].box); rcb.grow(bins[best_axis][b].cbox);
      }
    }
    uint32_t left = alloc_pair();
    set_node(node_index, box, left, 0);
    if (n >= kSpawnMin && live_threads.load(std::memory_order_relaxed) < max_threads - 1) {
      live_threads.fetch_add(1);
      std::thread t([this, left, lo, mid, lbox, lcb] {
        binned_range(left, lo, mid, lbox, lcb);
        live_threads.fetch_sub(1);
      });
      binned_range(left + 1, mid, hi, rbox, rcb);
      t.join();
    } else {
      binned_range(left, lo, mid, lbox, lcb);
      binned_range(left + 1, mid, hi, rbox, rcb);
    }
  }
};

// ---------------------------------------------------------------------------
// Handle exposed through the C ABI
// ---------------------------------------------------------------------------
struct BlasHandle {
  std::vector<BlasNode> nodes;
  std::vector<uint32_t> tri_indices;   // leaf slot -> original triangle id
  std::vector<uint32_t> parents;       // per node (root -> 0xFFFFFFFF)
  uint32_t max_depth = 0;
  float sah_cost = 0.0f;
  double build_ms = 0.0;
};

static void compute_parents_depth(BlasHandle* h) {
  const uint32_t n = (uint32_t)h->nodes.size();
  h->parents.assign(n, 0xFFFFFFFFu);
  h->max_depth = 0;
  std::vector<std::pair<uint32_t, uint32_t>> stack;
  stack.push_back({0, 1});
  while (!stack.empty()) {
    auto [ni, depth] = stack.back();
    stack.pop_back();
    h->max_depth = std::max(h->max_depth, depth);
    const BlasNode& nd = h->nodes[ni];
    if (nd.count == 0) {
      h->parents[nd.left_or_first] = ni;
      h->parents[nd.left_or_first + 1] = ni;
      stack.push_back({nd.left_or_first, depth + 1});
      stack.push_back({nd.left_or_first + 1, depth + 1});
    }
  }
}

// Global SAH cost of the finished tree (ref: BLAS.cs ComputeGlobalSAH:629-657):
// sum over interior nodes of traversal cost * relative area + sum over leaves
// of (#tris) * relative area, normalized by root area.
static float compute_sah(const std::vector<BlasNode>& nodes, float trav_cost) {
  auto ha = [&](const BlasNode& n) {
    Vec3 e(n.mx[0] - n.mn[0], n.mx[1] - n.mn[1], n.mx[2] - n.mn[2]);
    if (e.x < 0) return 0.0f;
    return e.x * (e.y + e.z) + e.y * e.z;
  };
  float root_area = std::max(ha(nodes[0]), 1e-30f);
  double cost = 0.0;
  for (const BlasNode& n : nodes) {
    float a = ha(n) / root_area;
    cost += (n.count == 0) ? trav_cost * a : (double)n.count * a;
  }
  return (float)cost;
}

}  // namespace

extern "C" {

struct BlasView {
  const BlasNode* nodes;
  uint32_t node_count;
  const uint32_t* tri_indices;
  uint32_t tri_index_count;
  const uint32_t* parents;
  uint32_t max_depth;
  float sah_cost;
  double build_ms;
};

void* blas_build(const float* verts, uint32_t nverts, const uint32_t* idx,
                 uint32_t ntris, uint32_t max_leaf, float trav_cost,
                 float presplit_factor) {
  (void)nverts;
  auto t0 = std::chrono::steady_clock::now();
  const bool profile = std::getenv("IDK_BVH_PROFILE") != nullptr;
  auto lap = [&, t = t0](const char* what) mutable {
    if (!profile) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[bvh] %s %.0f ms\n", what,
                 std::chrono::duration<double, std::milli>(now - t).count());
    t = now;
  };
  auto* h = new BlasHandle();
  std::vector<Fragment> frags;
  make_fragments(verts, idx, ntris, presplit_factor, frags);
  lap("fragments");
  if (frags.empty()) {
    // Empty tree: single inverted-AABB node. count==0 normally means
    // "interior", so traversal must (and does) reject the root via the
    // always-failing AABB test before ever dereferencing children.
    BlasNode root{};
    root.mn[0] = root.mn[1] = root.mn[2] = 1e30f;
    root.mx[0] = root.mx[1] = root.mx[2] = -1e30f;
    h->nodes.push_back(root);
    h->parents.assign(1, 0xFFFFFFFFu);
    h->max_depth = 1;
    return h;
  }
  Builder b(frags, std::max(max_leaf, 1u), trav_cost);
  b.build();
  lap("recursion");
  h->nodes = std::move(b.nodes);
  // De-duplicate shared fragments inside each leaf (pre-split triangles may
  // produce several fragments landing in the same leaf;
  // ref: PreSplitting.cs leaf dedup :162-273).
  h->tri_indices.reserve(frags.size());
  for (BlasNode& nd : h->nodes) {
    if (nd.count == 0) continue;
    uint32_t first = (uint32_t)h->tri_indices.size();
    uint32_t lo = nd.left_or_first, hi = lo + nd.count;
    for (uint32_t i = lo; i < hi; i++) {
      uint32_t tri = frags[b.axis_idx[0][i]].tri;
      bool dup = false;
      for (uint32_t j = first; j < (uint32_t)h->tri_indices.size(); j++)
        if (h->tri_indices[j] == tri) { dup = true; break; }
      if (!dup) h->tri_indices.push_back(tri);
    }
    nd.left_or_first = first;
    nd.count = (uint32_t)h->tri_indices.size() - first;
  }
  lap("leaf dedup");
  compute_parents_depth(h);
  h->sah_cost = compute_sah(h->nodes, trav_cost);
  lap("parents+sah");
  h->build_ms = std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0).count();
  return h;
}

void blas_view(void* handle, BlasView* out) {
  auto* h = (BlasHandle*)handle;
  out->nodes = h->nodes.data();
  out->node_count = (uint32_t)h->nodes.size();
  out->tri_indices = h->tri_indices.data();
  out->tri_index_count = (uint32_t)h->tri_indices.size();
  out->parents = h->parents.data();
  out->max_depth = h->max_depth;
  out->sah_cost = h->sah_cost;
  out->build_ms = h->build_ms;
}

void blas_destroy(void* handle) { delete (BlasHandle*)handle; }

// Global EPO (Endpoint-Overlap, Aila et al. "On Quality Metrics of Bounding
// Volume Hierarchies"; ref: BLAS.cs ComputeGlobalEPO/ComputeEPOArea:536-627):
// for each node, the surface area of geometry NOT in its subtree that
// overlaps its box, area-weighted and normalized by total triangle area.
// Exact when node_count <= max_nodes; otherwise a strided node sample scaled
// by the stride (logging metric — SAH alone misses overlap pathologies).
static double polygon_area(const Vec3* p, int n) {
  if (n < 3) return 0.0;
  Vec3 acc(0, 0, 0);
  for (int i = 1; i + 1 < n; i++)
    acc = acc + cross(p[i] - p[0], p[i + 1] - p[0]);
  return 0.5 * length(acc);
}

// Area of triangle clipped to an AABB.
static double tri_area_in_box(Vec3 a, Vec3 b, Vec3 c, const BlasNode& nd) {
  Vec3 buf0[16], buf1[16];
  buf0[0] = a; buf0[1] = b; buf0[2] = c;
  int n = 3;
  Vec3* cur = buf0;
  Vec3* nxt = buf1;
  for (int axis = 0; axis < 3; axis++) {
    n = clip_poly(cur, n, axis, nd.mx[axis], true, nxt);
    std::swap(cur, nxt);
    if (n < 3) return 0.0;
    n = clip_poly(cur, n, axis, nd.mn[axis], false, nxt);
    std::swap(cur, nxt);
    if (n < 3) return 0.0;
  }
  return polygon_area(cur, n);
}

float blas_epo(void* handle, const float* verts, const uint32_t* idx,
               uint32_t ntris, uint32_t max_nodes) {
  auto* h = (BlasHandle*)handle;
  const uint32_t nn = (uint32_t)h->nodes.size();
  if (nn == 0 || ntris == 0) return 0.0f;
  double total_area = 0.0;
  for (uint32_t t = 0; t < ntris; t++) {
    Vec3 p0(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]);
    Vec3 p1(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]);
    Vec3 p2(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2]);
    total_area += 0.5 * length(cross(p1 - p0, p2 - p0));
  }
  if (total_area <= 0.0) return 0.0f;
  uint32_t stride = std::max(1u, (nn + max_nodes - 1) / std::max(max_nodes, 1u));
  uint32_t n_samples = (nn + stride - 1) / stride;
  std::vector<double> partial(n_samples, 0.0);
  parallel_for(n_samples, [&](uint32_t s) {
    uint32_t target = s * stride;
    const BlasNode& tn = h->nodes[target];
    auto overlaps = [&](const BlasNode& m) {
      return m.mn[0] <= tn.mx[0] && m.mx[0] >= tn.mn[0] &&
             m.mn[1] <= tn.mx[1] && m.mx[1] >= tn.mn[1] &&
             m.mn[2] <= tn.mx[2] && m.mx[2] >= tn.mn[2];
    };
    double epo = 0.0;
    uint32_t stack[128];
    int sp = 0;
    // With presplitting, tri_indices repeats a triangle id once per
    // referencing leaf — count each external triangle ONCE per target node
    // or the overlap area is inflated on split builds.
    std::vector<bool> seen(ntris, false);
    if (overlaps(h->nodes[0]) && target != 0) stack[sp++] = 0;
    while (sp > 0) {
      const BlasNode& m = h->nodes[stack[--sp]];
      if (m.count > 0) {
        for (uint32_t i = m.left_or_first; i < m.left_or_first + m.count; i++) {
          uint32_t t = h->tri_indices[i];
          if (t < ntris) {
            if (seen[t]) continue;
            seen[t] = true;
          }
          Vec3 p0(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]);
          Vec3 p1(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]);
          Vec3 p2(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2]);
          epo += tri_area_in_box(p0, p1, p2, tn);
        }
      } else {
        // descend, skipping the target's own subtree (membership == "reached
        // through the target node")
        for (uint32_t c = m.left_or_first; c <= m.left_or_first + 1; c++) {
          if (c == target) continue;
          if (overlaps(h->nodes[c]) && sp < 128) stack[sp++] = c;
        }
      }
    }
    partial[s] = epo;
  });
  double epo_sum = 0.0;
  for (double p : partial) epo_sum += p;
  return (float)(epo_sum * (double)stride / total_area);
}

// Bottom-up refit after vertex animation (ref: BLAS.cs Refit:276-293).
// Iterates nodes in reverse index order — children always have larger
// indices than parents under our allocation scheme.
void blas_refit(void* handle, const float* verts, const uint32_t* idx) {
  auto* h = (BlasHandle*)handle;
  if (h->nodes.size() == 1 && h->nodes[0].count == 0) return;  // empty tree
  for (uint32_t i = (uint32_t)h->nodes.size(); i-- > 0;) {
    BlasNode& nd = h->nodes[i];
    AABB b;
    if (nd.count > 0) {
      for (uint32_t s = nd.left_or_first; s < nd.left_or_first + nd.count; s++) {
        uint32_t t = h->tri_indices[s];
        for (int v = 0; v < 3; v++) {
          uint32_t vi = idx[3 * t + v];
          b.grow(Vec3(verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]));
        }
      }
    } else {
      const BlasNode& l = h->nodes[nd.left_or_first];
      const BlasNode& r = h->nodes[nd.left_or_first + 1];
      b.grow(Vec3(l.mn[0], l.mn[1], l.mn[2])); b.grow(Vec3(l.mx[0], l.mx[1], l.mx[2]));
      b.grow(Vec3(r.mn[0], r.mn[1], r.mn[2])); b.grow(Vec3(r.mx[0], r.mx[1], r.mx[2]));
    }
    nd.mn[0] = b.mn.x; nd.mn[1] = b.mn.y; nd.mn[2] = b.mn.z;
    nd.mx[0] = b.mx.x; nd.mx[1] = b.mx.y; nd.mx[2] = b.mx.z;
  }
}

// ---------------------------------------------------------------------------
// CPU traversal (ref: BLAS.cs:313-439) — collision/picking path.
// ---------------------------------------------------------------------------

static inline bool ray_box(Vec3 o, Vec3 inv_d, Vec3 mn, Vec3 mx, float tmax, float& tnear) {
  float t0 = (mn.x - o.x) * inv_d.x, t1 = (mx.x - o.x) * inv_d.x;
  float tmin_ = std::min(t0, t1), tmax_ = std::max(t0, t1);
  t0 = (mn.y - o.y) * inv_d.y; t1 = (mx.y - o.y) * inv_d.y;
  tmin_ = std::max(tmin_, std::min(t0, t1)); tmax_ = std::min(tmax_, std::max(t0, t1));
  t0 = (mn.z - o.z) * inv_d.z; t1 = (mx.z - o.z) * inv_d.z;
  tmin_ = std::max(tmin_, std::min(t0, t1)); tmax_ = std::min(tmax_, std::max(t0, t1));
  tnear = std::max(tmin_, 0.0f);
  return tmax_ >= tnear && tnear <= tmax;
}

// Möller–Trumbore (ref: IntersectionRoutines.glsl RayVsTriangle).
static inline bool ray_tri(Vec3 o, Vec3 d, Vec3 p0, Vec3 p1, Vec3 p2,
                           float& t, float& u, float& v) {
  Vec3 e1 = p1 - p0, e2 = p2 - p0;
  Vec3 p = cross(d, e2);
  float det = dot(e1, p);
  if (std::fabs(det) < 1e-12f) return false;
  float inv = 1.0f / det;
  Vec3 s = o - p0;
  u = dot(s, p) * inv;
  if (u < 0.0f || u > 1.0f) return false;
  Vec3 q = cross(s, e1);
  v = dot(d, q) * inv;
  if (v < 0.0f || u + v > 1.0f) return false;
  t = dot(e2, q) * inv;
  return t > 0.0f;
}

int blas_intersect_ray(void* handle, const float* verts, const uint32_t* idx,
                       const float* origin, const float* dir, float tmax,
                       float* out_t, float* out_u, float* out_v, uint32_t* out_tri) {
  auto* h = (BlasHandle*)handle;
  if (h->nodes.empty() || (h->nodes.size() == 1 && h->nodes[0].count == 0)) return 0;
  Vec3 o(origin[0], origin[1], origin[2]), d(dir[0], dir[1], dir[2]);
  Vec3 inv_d(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float best_t = tmax, bu = 0, bv = 0;
  uint32_t best_tri = 0xFFFFFFFFu;
  uint32_t stack[64];
  int sp = 0;
  float tn;
  if (!ray_box(o, inv_d, Vec3(h->nodes[0].mn[0], h->nodes[0].mn[1], h->nodes[0].mn[2]),
               Vec3(h->nodes[0].mx[0], h->nodes[0].mx[1], h->nodes[0].mx[2]), best_t, tn))
    return 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const BlasNode& nd = h->nodes[stack[--sp]];
    if (nd.count > 0) {
      for (uint32_t s = nd.left_or_first; s < nd.left_or_first + nd.count; s++) {
        uint32_t tri = h->tri_indices[s];
        Vec3 p0(verts[3 * idx[3 * tri]], verts[3 * idx[3 * tri] + 1], verts[3 * idx[3 * tri] + 2]);
        Vec3 p1(verts[3 * idx[3 * tri + 1]], verts[3 * idx[3 * tri + 1] + 1], verts[3 * idx[3 * tri + 1] + 2]);
        Vec3 p2(verts[3 * idx[3 * tri + 2]], verts[3 * idx[3 * tri + 2] + 1], verts[3 * idx[3 * tri + 2] + 2]);
        float t, u, v;
        if (ray_tri(o, d, p0, p1, p2, t, u, v) && t < best_t) {
          best_t = t; bu = u; bv = v; best_tri = tri;
        }
      }
    } else {
      // closest-first ordered descent (ref: BLAS.cs:313-386)
      uint32_t li = nd.left_or_first, ri = li + 1;
      float tl, tr;
      bool hl = ray_box(o, inv_d, Vec3(h->nodes[li].mn[0], h->nodes[li].mn[1], h->nodes[li].mn[2]),
                        Vec3(h->nodes[li].mx[0], h->nodes[li].mx[1], h->nodes[li].mx[2]), best_t, tl);
      bool hr = ray_box(o, inv_d, Vec3(h->nodes[ri].mn[0], h->nodes[ri].mn[1], h->nodes[ri].mn[2]),
                        Vec3(h->nodes[ri].mx[0], h->nodes[ri].mx[1], h->nodes[ri].mx[2]), best_t, tr);
      if (hl && hr) {
        if (tl > tr) { std::swap(li, ri); }
        stack[sp++] = ri;  // far pushed first
        stack[sp++] = li;
      } else if (hl) {
        stack[sp++] = li;
      } else if (hr) {
        stack[sp++] = ri;
      }
    }
  }
  if (best_tri == 0xFFFFFFFFu) return 0;
  *out_t = best_t; *out_u = bu; *out_v = bv; *out_tri = best_tri;
  return 1;
}

// Box query: writes unique triangle ids whose leaf AABB overlaps the box
// (ref: BLAS.cs Intersect(box):388-439). Returns count (clamped to cap).
uint32_t blas_intersect_box(void* handle, const float* bmin, const float* bmax,
                            uint32_t* out_tris, uint32_t cap) {
  auto* h = (BlasHandle*)handle;
  if (h->nodes.empty() || (h->nodes.size() == 1 && h->nodes[0].count == 0)) return 0;
  Vec3 qmn(bmin[0], bmin[1], bmin[2]), qmx(bmax[0], bmax[1], bmax[2]);
  uint32_t stack[64];
  int sp = 0;
  uint32_t count = 0;
  auto overlaps = [&](const BlasNode& n) {
    return n.mn[0] <= qmx.x && n.mx[0] >= qmn.x && n.mn[1] <= qmx.y &&
           n.mx[1] >= qmn.y && n.mn[2] <= qmx.z && n.mx[2] >= qmn.z;
  };
  if (!overlaps(h->nodes[0])) return 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const BlasNode& nd = h->nodes[stack[--sp]];
    if (nd.count > 0) {
      for (uint32_t s = nd.left_or_first; s < nd.left_or_first + nd.count && count < cap; s++)
        out_tris[count++] = h->tri_indices[s];
    } else {
      if (overlaps(h->nodes[nd.left_or_first])) stack[sp++] = nd.left_or_first;
      if (overlaps(h->nodes[nd.left_or_first + 1])) stack[sp++] = nd.left_or_first + 1;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// TLAS: PLOC (Parallel Locally-Ordered Clustering) over instance AABBs
// sorted by Morton code, search radius R (ref: Source/Bvh/TLAS.cs:52-140).
// Output uses the same BlasNode layout; leaves store the instance id in
// left_or_first with count = 1.
// ---------------------------------------------------------------------------

static uint32_t expand_bits10(uint32_t v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

void* tlas_build(const float* aabbs /* n*6: min3,max3 */, uint32_t n, uint32_t radius) {
  auto* h = new BlasHandle();
  if (n == 0) {
    h->nodes.push_back(BlasNode{});
    compute_parents_depth(h);
    return h;
  }
  struct Cluster { AABB box; uint32_t node; };
  // Scene bounds for Morton normalization
  AABB scene;
  std::vector<AABB> boxes(n);
  for (uint32_t i = 0; i < n; i++) {
    boxes[i].mn = Vec3(aabbs[6 * i], aabbs[6 * i + 1], aabbs[6 * i + 2]);
    boxes[i].mx = Vec3(aabbs[6 * i + 3], aabbs[6 * i + 4], aabbs[6 * i + 5]);
    scene.grow(boxes[i]);
  }
  Vec3 ext = scene.extent();
  Vec3 inv(ext.x > 0 ? 1.0f / ext.x : 0, ext.y > 0 ? 1.0f / ext.y : 0, ext.z > 0 ? 1.0f / ext.z : 0);
  std::vector<std::pair<uint32_t, uint32_t>> morton(n);  // (code, instance)
  for (uint32_t i = 0; i < n; i++) {
    Vec3 c = (boxes[i].center() - scene.mn) * inv;
    uint32_t qx = (uint32_t)std::min(std::max(c.x * 1024.0f, 0.0f), 1023.0f);
    uint32_t qy = (uint32_t)std::min(std::max(c.y * 1024.0f, 0.0f), 1023.0f);
    uint32_t qz = (uint32_t)std::min(std::max(c.z * 1024.0f, 0.0f), 1023.0f);
    morton[i] = {(expand_bits10(qx) << 2) | (expand_bits10(qy) << 1) | expand_bits10(qz), i};
  }
  std::stable_sort(morton.begin(), morton.end());
  // The finished tree has 2n-1 nodes (ref: TLAS.cs AllocateRequiredNodes),
  // but merge rounds may re-house non-adjacent sibling pairs, so build into
  // a generous scratch pool and BFS-repack into the final layout at the end.
  uint32_t total = 6 * n + 2;
  h->nodes.resize(total);
  uint32_t next_free = total;  // allocate downward in sibling pairs
  std::vector<Cluster> cur(n), nxt;
  for (uint32_t i = 0; i < n; i++) {
    uint32_t inst = morton[i].second;
    uint32_t ni = --next_free;
    BlasNode nd{};
    nd.mn[0] = boxes[inst].mn.x; nd.mn[1] = boxes[inst].mn.y; nd.mn[2] = boxes[inst].mn.z;
    nd.mx[0] = boxes[inst].mx.x; nd.mx[1] = boxes[inst].mx.y; nd.mx[2] = boxes[inst].mx.z;
    nd.left_or_first = inst;
    nd.count = 1;
    h->nodes[ni] = nd;
    cur[i] = {boxes[inst], ni};
  }
  // PLOC merge rounds
  while (cur.size() > 1) {
    uint32_t m = (uint32_t)cur.size();
    std::vector<uint32_t> best(m);
    for (uint32_t i = 0; i < m; i++) {
      float best_cost = 3.4e38f;
      uint32_t bj = i == 0 ? 1 : i - 1;
      uint32_t lo = i > radius ? i - radius : 0;
      uint32_t hi = std::min(i + radius + 1, m);
      for (uint32_t j = lo; j < hi; j++) {
        if (j == i) continue;
        AABB u = cur[i].box; u.grow(cur[j].box);
        float c = u.half_area();
        if (c < best_cost) { best_cost = c; bj = j; }
      }
      best[i] = bj;
    }
    nxt.clear();
    std::vector<uint8_t> merged(m, 0);
    for (uint32_t i = 0; i < m; i++) {
      if (merged[i]) continue;
      uint32_t j = best[i];
      if (best[j] == i && !merged[j]) {
        // mutual best match: merge. Children must be a contiguous pair —
        // re-house them if not adjacent.
        merged[i] = merged[j] = 1;
        uint32_t a = cur[i].node, b = cur[j].node;
        if (b != a + 1) {
          // allocate fresh adjacent pair, move nodes (subtrees keep indices;
          // only these two roots move, fine because children pointers inside
          // them are absolute).
          next_free -= 2;
          h->nodes[next_free] = h->nodes[a];
          h->nodes[next_free + 1] = h->nodes[b];
          a = next_free;
          b = next_free + 1;
        }
        AABB u = cur[i].box; u.grow(cur[j].box);
        next_free -= 1;
        uint32_t pi = next_free;
        BlasNode nd{};
        nd.mn[0] = u.mn.x; nd.mn[1] = u.mn.y; nd.mn[2] = u.mn.z;
        nd.mx[0] = u.mx.x; nd.mx[1] = u.mx.y; nd.mx[2] = u.mx.z;
        nd.left_or_first = a;
        nd.count = 0;
        h->nodes[pi] = nd;
        nxt.push_back({u, pi});
      } else {
        nxt.push_back(cur[i]);
        merged[i] = 1;
      }
    }
    cur.swap(nxt);
  }
  // BFS-repack into a dense tree rooted at index 0 with contiguous child
  // pairs (the device-flattening layout contract).
  {
    uint32_t root = cur[0].node;
    std::vector<BlasNode> packed;
    packed.reserve(2 * n - 1);
    packed.push_back(h->nodes[root]);
    for (uint32_t k = 0; k < (uint32_t)packed.size(); k++) {
      if (packed[k].count == 0) {
        uint32_t l = packed[k].left_or_first;
        uint32_t nl = (uint32_t)packed.size();
        packed.push_back(h->nodes[l]);
        packed.push_back(h->nodes[l + 1]);
        packed[k].left_or_first = nl;
      }
    }
    h->nodes = std::move(packed);
  }
  compute_parents_depth(h);
  h->sah_cost = compute_sah(h->nodes, 1.0f);
  return h;
}

// ---------------------------------------------------------------------------
// Collision: closest point on triangle + moving-sphere-vs-triangle-set
// sliding response (ref: Source/Shapes/Intersections.cs:38-94, 492-594).
// The scene-level sub-stepping loop lives in Python (idkengine_tpu.collision)
// and calls these per-instance primitives.
// ---------------------------------------------------------------------------

static Vec3 tri_closest_point(Vec3 p, Vec3 a, Vec3 b, Vec3 c) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return a;
  Vec3 bp = p - b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return b;
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) return a + ab * (d1 / (d1 - d3));
  Vec3 cp = p - c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return c;
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) return a + ac * (d2 / (d2 - d6));
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0)
    return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)));
  float denom = 1.0f / (va + vb + vc);
  return a + ab * (vb * denom) + ac * (vc * denom);
}

// For each candidate triangle, find the closest point to `center` within
// `radius`; returns index of deepest penetration or -1.
int sphere_vs_triangles(const float* verts, const uint32_t* idx,
                        const uint32_t* tris, uint32_t ntris,
                        const float* center, float radius,
                        float* out_closest, float* out_dist) {
  Vec3 c(center[0], center[1], center[2]);
  float best = radius;
  int best_i = -1;
  Vec3 best_p;
  for (uint32_t i = 0; i < ntris; i++) {
    uint32_t t = tris[i];
    Vec3 p0(verts[3 * idx[3 * t]], verts[3 * idx[3 * t] + 1], verts[3 * idx[3 * t] + 2]);
    Vec3 p1(verts[3 * idx[3 * t + 1]], verts[3 * idx[3 * t + 1] + 1], verts[3 * idx[3 * t + 1] + 2]);
    Vec3 p2(verts[3 * idx[3 * t + 2]], verts[3 * idx[3 * t + 2] + 1], verts[3 * idx[3 * t + 2] + 2]);
    Vec3 q = tri_closest_point(c, p0, p1, p2);
    float d = length(q - c);
    if (d < best) { best = d; best_i = (int)i; best_p = q; }
  }
  if (best_i >= 0) {
    out_closest[0] = best_p.x; out_closest[1] = best_p.y; out_closest[2] = best_p.z;
    *out_dist = best;
  }
  return best_i;
}

// ---------------------------------------------------------------------------
// Tree flatten / collapse helpers (host table builds)
//
// Native versions of the per-node Python loops in bvh/flatten.py and
// ops/packet_trace.py (thread_bvh, _collapse_leaves, _segment_roots,
// _subtree_extract, _collapse_wide). At the 2.8M-tri bench the builder tree
// has ~1M nodes and those Python loops dominated setup time; the semantics
// here are bit-identical to the Python fallbacks (which the tests compare).
// ---------------------------------------------------------------------------

// DFS preorder (left child first) + exclusive subtree end in DFS numbering.
void bvh_thread_links(const BlasNode* nodes, uint32_t n,
                      int64_t* order, int64_t* subtree_end) {
  std::vector<int64_t> dfs_index(n);
  std::vector<uint32_t> stack;
  stack.reserve(128);
  stack.push_back(0);
  int64_t pos = 0;
  while (!stack.empty()) {
    uint32_t ni = stack.back();
    stack.pop_back();
    order[pos] = ni;
    dfs_index[ni] = pos;
    pos++;
    if (nodes[ni].count == 0) {
      uint32_t l = nodes[ni].left_or_first;
      stack.push_back(l + 1);
      stack.push_back(l);
    }
  }
  for (int64_t i = (int64_t)n - 1; i >= 0; --i) {
    uint32_t ni = (uint32_t)order[i];
    if (nodes[ni].count > 0)
      subtree_end[i] = i + 1;
    else
      subtree_end[i] = subtree_end[dfs_index[nodes[ni].left_or_first + 1]];
  }
}

// Bottom-up collapse of sibling leaves into bigger leaves (<= max_leaf),
// then BFS repack dropping orphans. out/orig capacity n. Returns node count.
int64_t bvh_collapse_leaves(const BlasNode* nodes_in, uint32_t n,
                            uint32_t max_leaf, BlasNode* out, int64_t* orig) {
  std::vector<BlasNode> nodes(nodes_in, nodes_in + n);
  for (int64_t i = (int64_t)n - 1; i >= 0; --i) {
    if (nodes[i].count != 0) continue;
    uint32_t l = nodes[i].left_or_first;
    uint32_t cl = nodes[l].count, cr = nodes[l + 1].count;
    if (cl > 0 && cr > 0 && cl != 0xFFFFFFFFu && cr != 0xFFFFFFFFu &&
        cl + cr <= max_leaf) {
      nodes[i].count = cl + cr;
      nodes[i].left_or_first =
          std::min(nodes[l].left_or_first, nodes[l + 1].left_or_first);
      nodes[l].count = nodes[l + 1].count = 0xFFFFFFFFu;  // orphan marker
    }
  }
  out[0] = nodes[0];
  orig[0] = 0;
  int64_t n_out = 1;
  for (int64_t k = 0; k < n_out; ++k) {
    if (out[k].count == 0) {
      uint32_t l = out[k].left_or_first;
      out[k].left_or_first = (uint32_t)n_out;
      out[n_out] = nodes[l];
      out[n_out + 1] = nodes[l + 1];
      orig[n_out] = l;
      orig[n_out + 1] = l + 1;
      n_out += 2;
    }
  }
  return n_out;
}

// Minimal antichain of subtree roots whose packed tables fit `budget` bytes
// (same stack walk + footprint model as Python _segment_roots).
int64_t bvh_segment_roots(const BlasNode* nodes, uint32_t n, double budget,
                          int64_t leaves_per_row, int64_t* out_roots) {
  std::vector<int64_t> pairs_below(n, 0), leaves_below(n, 0);
  for (int64_t i = (int64_t)n - 1; i >= 0; --i) {
    if (nodes[i].count > 0) {
      leaves_below[i] = 1;
    } else {
      uint32_t l = nodes[i].left_or_first;
      pairs_below[i] = 1 + pairs_below[l] + pairs_below[l + 1];
      leaves_below[i] = leaves_below[l] + leaves_below[l + 1];
    }
  }
  int64_t count = 0;
  std::vector<uint32_t> stack;
  stack.push_back(0);
  while (!stack.empty()) {
    uint32_t i = stack.back();
    stack.pop_back();
    double foot =
        (double)(1 + (pairs_below[i] + 7) / 8) * 512.0 +
        (double)((leaves_below[i] + leaves_per_row - 1) / leaves_per_row) *
            512.0;
    if (foot <= budget || nodes[i].count > 0) {
      out_roots[count++] = i;
    } else {
      uint32_t l = nodes[i].left_or_first;
      stack.push_back(l);
      stack.push_back(l + 1);
    }
  }
  return count;
}

// Renumber the subtree at `root` into a fresh builder-layout array.
int64_t bvh_subtree_extract(const BlasNode* nodes, const int64_t* orig,
                            uint32_t root, BlasNode* out, int64_t* o_map) {
  out[0] = nodes[root];
  o_map[0] = orig[root];
  int64_t n_out = 1;
  for (int64_t k = 0; k < n_out; ++k) {
    if (out[k].count == 0) {
      uint32_t l = out[k].left_or_first;
      out[k].left_or_first = (uint32_t)n_out;
      out[n_out] = nodes[l];
      out[n_out + 1] = nodes[l + 1];
      o_map[n_out] = orig[l];
      o_map[n_out + 1] = orig[l + 1];
      n_out += 2;
    }
  }
  return n_out;
}

// Greedy 8-wide collapse (largest-area interior child expanded first),
// children sorted ascending centroid along the dominant axis. Outputs:
// kids (cap,8) with -1 = empty slot, axis_out/order_out (cap,),
// meta0_of (n,) pre-filled by caller with -1. Returns wide-node count W.
int64_t bvh_collapse_wide(const BlasNode* nodes, uint32_t n, int64_t* kids,
                          int64_t* axis_out, int64_t* order_out,
                          int64_t* meta0_of) {
  std::vector<double> area(n);
  std::vector<double> cx(n), cy(n), cz(n);
  for (uint32_t i = 0; i < n; ++i) {
    double ex = std::max((double)nodes[i].mx[0] - nodes[i].mn[0], 0.0);
    double ey = std::max((double)nodes[i].mx[1] - nodes[i].mn[1], 0.0);
    double ez = std::max((double)nodes[i].mx[2] - nodes[i].mn[2], 0.0);
    area[i] = ex * ey + ey * ez + ez * ex;
    cx[i] = 0.5 * ((double)nodes[i].mn[0] + nodes[i].mx[0]);
    cy[i] = 0.5 * ((double)nodes[i].mn[1] + nodes[i].mx[1]);
    cz[i] = 0.5 * ((double)nodes[i].mn[2] + nodes[i].mx[2]);
  }
  std::vector<uint32_t> order;  // binary id per wide node (BFS)
  std::vector<int64_t> wide_of(n, -1);
  order.push_back(0);
  int64_t W = 0;
  std::vector<uint32_t> ks;
  ks.reserve(8);
  for (size_t qi = 0; qi < order.size(); ++qi, ++W) {
    uint32_t b = order[qi];
    ks.clear();
    ks.push_back(nodes[b].left_or_first);
    ks.push_back(nodes[b].left_or_first + 1);
    while (ks.size() < 8) {
      int best = -1;
      double best_a = -1.0;
      for (size_t j = 0; j < ks.size(); ++j) {
        uint32_t k = ks[j];
        if (nodes[k].count == 0 && area[k] > best_a) {
          best_a = area[k];
          best = (int)j;
        }
      }
      if (best < 0) break;
      uint32_t k = ks[best];
      ks.erase(ks.begin() + best);
      ks.push_back(nodes[k].left_or_first);
      ks.push_back(nodes[k].left_or_first + 1);
    }
    double mnx = 1e300, mny = 1e300, mnz = 1e300;
    double mxx = -1e300, mxy = -1e300, mxz = -1e300;
    for (uint32_t k : ks) {
      mnx = std::min(mnx, cx[k]); mxx = std::max(mxx, cx[k]);
      mny = std::min(mny, cy[k]); mxy = std::max(mxy, cy[k]);
      mnz = std::min(mnz, cz[k]); mxz = std::max(mxz, cz[k]);
    }
    double dx = mxx - mnx, dy = mxy - mny, dz = mxz - mnz;
    int axis = 0;  // numpy argmax: first strict max
    double best_d = dx;
    if (dy > best_d) { best_d = dy; axis = 1; }
    if (dz > best_d) { best_d = dz; axis = 2; }
    const std::vector<double>& cc = axis == 0 ? cx : (axis == 1 ? cy : cz);
    std::stable_sort(ks.begin(), ks.end(),
                     [&](uint32_t a, uint32_t b2) { return cc[a] < cc[b2]; });
    for (size_t j = 0; j < 8; ++j)
      kids[8 * W + j] = j < ks.size() ? (int64_t)ks[j] : -1;
    axis_out[W] = axis;
    order_out[W] = b;
    for (uint32_t k : ks) {
      if (nodes[k].count == 0) {
        wide_of[k] = (int64_t)order.size();
        order.push_back(k);
      }
    }
  }
  for (uint32_t b = 0; b < n; ++b)
    if (wide_of[b] >= 0) meta0_of[b] = wide_of[b] * 4 + axis_out[wide_of[b]];
  meta0_of[0] = 0 * 4 + axis_out[0];
  return W;
}

// 4-wide collapse of a threaded binary tree (DFS order: interior node i
// has its left child at i + 1 and its right child at miss_link[i + 1]), the
// CUDA trace kernel's node table (see idkengine_tpu_torch/bvh/flatten.py
// bvh4_nodes for the record layout). Records follow in breadth-first order,
// record 0 for the root; each opens its binary node's subtree by replacing
// the open interior child of largest surface area (the first of equal ones)
// with its two children until four are open or all are leaves. rec (32
// int32 words a record) and src (the binary node of each child, -1 where
// empty) must hold one record per interior node of the n, plus one.
// Returns the record count and sets *depth (records on the longest path),
// or returns -1 when a leaf reference ~(first << leaf_bits | count - 1)
// does not fit 31 bits.
int64_t bvh_collapse4(const float* node_min, const float* node_max,
                      const int32_t* node_first, const int32_t* node_count,
                      const int32_t* miss_link, uint32_t n, uint32_t leaf_bits,
                      int32_t* rec, int64_t* src, int32_t* depth) {
  auto area = [&](int64_t i) {
    const float ex = node_max[3 * i] - node_min[3 * i];
    const float ey = node_max[3 * i + 1] - node_min[3 * i + 1];
    const float ez = node_max[3 * i + 2] - node_min[3 * i + 2];
    return ex * ey + ey * ez + ez * ex;
  };
  const int64_t max_count = int64_t(1) << leaf_bits;
  const int64_t max_slot = int64_t(1) << (31 - leaf_bits);
  std::vector<int64_t> roots{0};
  std::vector<int32_t> level{0};
  int32_t deepest = 0;
  for (size_t r = 0; r < roots.size(); ++r) {
    int64_t s[4] = {roots[r], -1, -1, -1};
    int open = 1;
    for (int step = 0; step < 3; ++step) {
      int best = -1;
      float best_area = 0.0f;
      for (int k = 0; k < open; ++k) {
        if (node_count[s[k]] != 0) continue;
        const float a = area(s[k]);
        if (best < 0 || a > best_area) best = k, best_area = a;
      }
      if (best < 0) break;
      const int64_t node = s[best];
      s[best] = node + 1;
      s[open++] = miss_link[node + 1];
    }
    int32_t* w = rec + 32 * r;
    std::fill(w, w + 32, 0);
    for (int k = 0; k < open; ++k) {
      const int64_t c = s[k];
      src[4 * r + k] = c;
      for (int axis = 0; axis < 3; ++axis) {
        std::memcpy(w + 8 * axis + k, node_min + 3 * c + axis, 4);
        std::memcpy(w + 8 * axis + 4 + k, node_max + 3 * c + axis, 4);
      }
      if (node_count[c] == 0) {
        w[24 + k] = (int32_t)roots.size();
        roots.push_back(c);
        level.push_back(level[r] + 1);
        deepest = std::max(deepest, level[r] + 1);
      } else {
        const int64_t first = node_first[c], count = node_count[c];
        if (count > max_count || first + count > max_slot) return -1;
        w[24 + k] = (int32_t)~((first << leaf_bits) | (count - 1));
      }
    }
    for (int k = open; k < 4; ++k) src[4 * r + k] = -1;
    w[28] = open;
  }
  *depth = deepest + 1;
  return (int64_t)roots.size();
}

}  // extern "C"
