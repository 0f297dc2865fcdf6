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
// (trace_math.cuh), strict t < t_best, the earlier triangle of a leaf and
// then the earlier list entry winning a tie (the JAX package's argmin rule;
// two_phase.py:400-473 computes it in XLA, so it is no TPU kernel). Its
// plain version phase_b_closest_plain is its oracle: t, slot, u and v are
// bit-equal.
//
// What bounds them: phase A is the traversal's dependent node fetches
// without the leaf tests; it prunes only by t_max, never by a hit, so a
// primary ray wants many more leaves than D and overflows into the one-phase
// fallback. Phase B reads up to D * max_leaf triangles per ray in scattered
// 48-byte gathers (tri_vec); the fallback is one trace.cu launch on all rays
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

// Phase B, a ray a thread: the ray's list entries in order, four at a
// time. The closest-hit kernel reads four entries, then the four leaves'
// first/count, independent loads in flight together, then their triangles
// (one 16-byte load for the four entries measured within 1% of four scalar
// ones, PERF.md); the any-hit kernel, which stops at its first hit, reads
// an entry's first/count only when it reaches the entry. Triangles come
// from tri_vec (three 16-byte loads each), in order, strict t < t_best from
// t_max, so the earlier triangle and then the earlier entry win a tie. A
// thread's work is the sum of its leaves' triangles, so a warp's lanes stay
// busy for about as long as each other. Measured against this and slower
// on every batch (PERF.md): the JAX package's dense pairs
// (two_phase.py:400-465), one list entry a lane and a group of D lanes a
// ray with a shuffle reduce and a ballot for any hit (a warp runs as long
// as its longest leaf, and lanes of empty entries idle), also with empty
// entries compacted out of the lanes and with persistent warps.
template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK)
phase_b_kernel(const int* __restrict__ node_first, const int* __restrict__ node_count,
               const float4* __restrict__ tri_vec, const int* __restrict__ lists,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max, float* __restrict__ t_out,
               int* __restrict__ slot_out, float* __restrict__ u_out,
               float* __restrict__ v_out, bool* __restrict__ occ_out, int d_slots,
               int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tmax = t_max[i];
  float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  if (!(tmax < 0.0f)) {  // t_max < 0 marks a dead ray
    const Ray r = load_ray(o, d, i);
    const int* li = lists + (size_t)i * d_slots;
    for (int j0 = 0; j0 < d_slots; j0 += 4) {
      int leaf[4], first[4], count[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) leaf[q] = j0 + q < d_slots ? __ldg(li + j0 + q) : -1;
      if (!ANY_HIT) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          first[q] = leaf[q] >= 0 ? __ldg(node_first + leaf[q]) : 0;
          count[q] = leaf[q] >= 0 ? __ldg(node_count + leaf[q]) : 0;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (ANY_HIT) {
          first[q] = leaf[q] >= 0 ? __ldg(node_first + leaf[q]) : 0;
          count[q] = leaf[q] >= 0 ? __ldg(node_count + leaf[q]) : 0;
        }
        for (int k = 0; k < count[q]; ++k) {
          float t, u, v;
          if (triangle_vec(tri_vec, first[q] + k, r, t, u, v) && t < t_best) {
            t_best = t;
            best_slot = first[q] + k;
            best_u = u;
            best_v = v;
            if (ANY_HIT) break;
          }
        }
        if (ANY_HIT && best_slot >= 0) break;
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

template <bool ANY_HIT>
int launch_phase_b(const void* node_first, const void* node_count, const void* tri_vec,
                   const void* lists, const void* o, const void* d, const void* t_max,
                   void* t_out, void* slot_out, void* u_out, void* v_out, void* occ_out,
                   int d_slots, int n_rays, void* stream) {
  phase_b_kernel<ANY_HIT><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)node_first, (const int*)node_count, (const float4*)tri_vec, (const int*)lists,
      (const float*)o, (const float*)d, (const float*)t_max, (float*)t_out, (int*)slot_out,
      (float*)u_out, (float*)v_out, (bool*)occ_out, d_slots, n_rays);
  return (int)cudaGetLastError();
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
// miss), i32 slot (-1), f32 u, f32 v. d_slots >= 1. Returns
// cudaGetLastError().
int idk_phase_b_closest(const void* node_first, const void* node_count, const void* tri_vec,
                        const void* lists, const void* o, const void* d, const void* t_max,
                        void* t_out, void* slot_out, void* u_out, void* v_out, int d_slots,
                        int n_rays, void* stream) {
  if (d_slots < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  return launch_phase_b<false>(node_first, node_count, tri_vec, lists, o, d, t_max, t_out,
                               slot_out, u_out, v_out, nullptr, d_slots, n_rays, stream);
}

// Phase B, occlusion over the listed leaves: occ_out (n_rays,) bool.
// d_slots >= 1. Returns cudaGetLastError().
int idk_phase_b_any(const void* node_first, const void* node_count, const void* tri_vec,
                    const void* lists, const void* o, const void* d, const void* t_max,
                    void* occ_out, int d_slots, int n_rays, void* stream) {
  if (d_slots < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  return launch_phase_b<true>(node_first, node_count, tri_vec, lists, o, d, t_max, nullptr,
                              nullptr, nullptr, nullptr, occ_out, d_slots, n_rays, stream);
}

}  // extern "C"
