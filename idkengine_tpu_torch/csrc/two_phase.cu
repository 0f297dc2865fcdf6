// Two-phase BVH traversal for Hopper (sm_90a), one ray per thread.
//
// Phase A (phase_a_kernel) replaces the TPU's two phase-A Pallas kernels:
//   K5a idkengine_tpu/ops/two_phase.py `_make_kernel_a` (resident tables),
//   K5b idkengine_tpu/ops/two_phase.py `_make_kernel_a_steered` (tables
//       split into VMEM-sized segments, steered per packet; global leaf ids).
// Both walk only interior nodes: a leaf child whose box the ray hits within
// [0, t_max] is never visited but appended to the ray's list of D leaf ids,
// and `cnt` counts every such leaf, those beyond D too (the overflow
// signal). As with K2, the segmentation exists only for the TPU's scoped
// VMEM, so one whole-scene kernel over the binary node records
// (trace_math.cuh) answers both contracts; a leaf id is its node index.
//
// A leaf is wanted when the ray hits every box on its root path within
// [0, t_max]; that set does not depend on the visiting order. So `cnt`
// equals the plain version's (ops/two_phase.py:phase_a_plain, a stackless
// DFS) exactly, and the lists hold the same sets where cnt <= D; only their
// order differs: this kernel appends near child first (by entry distance),
// the plain version in DFS order. A dead ray (t_max < 0) gets cnt 0. Lists
// are (R, D) row-major, -1 past the recorded entries. The stack holds
// pending far interior children, at most depth-1 of them; the wrapper
// refuses a tree deeper than TRACE_STACK_SIZE + 1.
//
// Phase B (phase_b_kernel) tests each ray's listed leaves: at most D leaves
// of at most max_leaf triangles, Möller–Trumbore in trace.cu's arithmetic
// (trace_math.cuh), strict t < t_best over the list in order, so the
// earlier entry wins a tie (the JAX package's argmin rule;
// two_phase.py:400-473 computes it in XLA, so it is no TPU kernel). Its
// plain version phase_b_closest_plain is its oracle: t, u and v are
// bit-equal.
//
// What bounds them: phase A is the traversal's dependent node fetches
// without the leaf tests; it prunes only by t_max, never by a hit, so a
// primary ray wants many more leaves than D and overflows into the one-phase
// fallback. Phase B reads up to D * max_leaf triangles per ray in scattered
// 36-byte gathers; the fallback is one trace.cu launch on all rays
// (non-overflow rays carry t_max = -1). Phase A over trace.cu's 4-wide
// table (14 record levels against 24, the leaf ids from
// SceneArrays.bvh4_child) was measured in eleven forms, with and without
// persistent warps, a shared ring, near-first order and an eager child-map
// load, and so was this walk with persistent warps: none was faster on
// the primaries, the shadow rays and the bounce batch together (the best
// wide form -7% on the primaries, +4% and +9% on the others; PERF.md), so
// this binary walk, one ray a thread, stays.

#include "trace_math.cuh"

namespace {

__global__ void __launch_bounds__(TRACE_BLOCK)
phase_a_kernel(const float4* __restrict__ nodes, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ t_max,
               int* __restrict__ lists, int* __restrict__ cnt_out, int d_slots,
               int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tmax = t_max[i];
  int* li = lists + (size_t)i * d_slots;
  int c = 0;
  auto emit = [&](int leaf) {
    if (c < d_slots) li[c] = leaf;
    ++c;
  };

  float tn;
  float4 a, b;
  if (!(tmax < 0.0f)) {  // t_max < 0 marks a dead ray
    const Ray r = load_ray(o, d, i);
    if (slab(nodes, 0, r, tmax, tn, a, b)) {
      if (__float_as_int(b.w) > 0) {
        emit(0);  // the root is a leaf
      } else {
        int stack[TRACE_STACK_SIZE];
        int sp = 0;
        int node = 0, link = __float_as_int(a.w);
        while (true) {
          float tl, tr;
          float4 la, lb, ra, rb;
          const bool hl = slab(nodes, node + 1, r, tmax, tl, la, lb);
          const bool hr = slab(nodes, link, r, tmax, tr, ra, rb);
          const bool left_near = tl <= tr;
          const int c_near = left_near ? node + 1 : link;
          const int c_far = left_near ? link : node + 1;
          const bool h_near = left_near ? hl : hr;
          const bool h_far = left_near ? hr : hl;
          const int near_count = __float_as_int(left_near ? lb.w : rb.w);
          const int far_count = __float_as_int(left_near ? rb.w : lb.w);
          const int near_link = __float_as_int(left_near ? la.w : ra.w);
          const int far_link = __float_as_int(left_near ? ra.w : la.w);
          if (h_near && near_count > 0) emit(c_near);
          if (h_far && far_count > 0) emit(c_far);
          const bool down_near = h_near && near_count == 0;
          const bool down_far = h_far && far_count == 0;
          if (down_near) {
            if (down_far) stack[sp++] = c_far;
            node = c_near;
            link = near_link;
          } else if (down_far) {
            node = c_far;
            link = far_link;
          } else if (sp > 0) {
            node = stack[--sp];
            link = __float_as_int(__ldg(nodes + 2 * node).w);
          } else {
            break;
          }
        }
      }
    }
  }
  for (int j = c < d_slots ? c : d_slots; j < d_slots; ++j) li[j] = -1;
  cnt_out[i] = c;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK)
phase_b_kernel(const int* __restrict__ node_first, const int* __restrict__ node_count,
               const float* __restrict__ p0, const float* __restrict__ e1,
               const float* __restrict__ e2, const int* __restrict__ lists,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, float* __restrict__ t_out,
               int* __restrict__ slot_out, float* __restrict__ u_out,
               float* __restrict__ v_out, bool* __restrict__ occ_out, int d_slots,
               int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tmax = t_max[i];
  float t_best = tmax;
  int best_slot = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (!(tmax < 0.0f)) {
    const Ray r = load_ray(o, d, i);
    const int* li = lists + (size_t)i * d_slots;
    for (int j = 0; j < d_slots; ++j) {
      const int leaf = li[j];
      if (leaf < 0) continue;
      const int first = __ldg(node_first + leaf);
      const int count = __ldg(node_count + leaf);
      for (int k = 0; k < count; ++k) {
        float t, u, v;
        if (triangle(p0, e1, e2, first + k, r, t, u, v) && t < t_best) {
          t_best = t;
          best_slot = first + k;
          best_u = u;
          best_v = v;
          if (ANY_HIT) break;
        }
      }
      if (ANY_HIT && best_slot >= 0) break;
    }
  }
  if (ANY_HIT) {
    occ_out[i] = best_slot >= 0;
  } else {
    t_out[i] = t_best;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

extern "C" {

// The binary layout's stack bound of phase A.
int idk_phase_a_stack_size() { return TRACE_STACK_SIZE; }

// Phase A: lists (n_rays, d_slots) i32 leaf node ids | -1, cnt (n_rays,)
// i32. All pointers are device pointers. Returns cudaGetLastError().
int idk_phase_a(const void* nodes, const void* o, const void* d, const void* t_max,
                void* lists, void* cnt, int d_slots, int n_rays, void* stream) {
  phase_a_kernel<<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float*)o, (const float*)d, (const float*)t_max,
      (int*)lists, (int*)cnt, d_slots, n_rays);
  return (int)cudaGetLastError();
}

// Phase B, closest hit over the listed leaves: (n_rays,) f32 t (t_max on a
// miss), i32 slot (-1), f32 u, f32 v. Returns cudaGetLastError().
int idk_phase_b_closest(const void* node_first, const void* node_count, const void* p0,
                        const void* e1, const void* e2, const void* lists, const void* o,
                        const void* d, const void* t_max, void* t_out, void* slot_out,
                        void* u_out, void* v_out, int d_slots, int n_rays, void* stream) {
  phase_b_kernel<false><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)node_first, (const int*)node_count, (const float*)p0, (const float*)e1,
      (const float*)e2, (const int*)lists, (const float*)o, (const float*)d,
      (const float*)t_max, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out,
      nullptr, d_slots, n_rays);
  return (int)cudaGetLastError();
}

// Phase B, occlusion over the listed leaves: occ_out (n_rays,) bool.
// Returns cudaGetLastError().
int idk_phase_b_any(const void* node_first, const void* node_count, const void* p0,
                    const void* e1, const void* e2, const void* lists, const void* o,
                    const void* d, const void* t_max, void* occ_out, int d_slots,
                    int n_rays, void* stream) {
  phase_b_kernel<true><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)node_first, (const int*)node_count, (const float*)p0, (const float*)e1,
      (const float*)e2, (const int*)lists, (const float*)o, (const float*)d,
      (const float*)t_max, nullptr, nullptr, nullptr, nullptr, (bool*)occ_out, d_slots,
      n_rays);
  return (int)cudaGetLastError();
}

}  // extern "C"
