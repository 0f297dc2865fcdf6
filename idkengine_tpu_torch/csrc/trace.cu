// Closest-hit and any-hit BVH traversal for Hopper (sm_90a), one ray per
// thread.
//
// Replaces the TPU packet tracer's Pallas kernels:
//   K1 idkengine_tpu/ops/packet_trace.py `_make_kernel` (whole-table scenes,
//      traversal body `_build_run_seg`),
//   K2 idkengine_tpu/ops/packet_trace.py `_make_kernel_steered_loop` (scenes
//      split into VMEM-sized segments, steered per packet), and
//   K4 idkengine_tpu/ops/packet_trace.py `_make_kernel_steered` (K2's
//      contract with K unrolled steer slots, a residual pass and a backstop;
//      chosen when IDK_STEER_LOOP=0).
// K2's and K4's segmentation exists only because a TPU segment must fit the
// ~16 MB scoped VMEM. Here the whole scene lies in device memory and one
// traversal computes every contract: Hit(t, slot, u, v) for the closest hit,
// and occlusion before t_max for the any-hit query.
//
// What bounds it: not bandwidth or arithmetic but the latency of dependent
// node fetches, and divergence between the rays of a warp. Each step reads
// a node record, then (at an interior) two child records, before it knows
// where to go next. At 2.8M triangles the node and triangle tables are a few
// hundred MB; the top of the tree stays in the 50 MB L2. What this first
// design does about it: near-first child order (by entry distance) so the
// closest-hit bound tightens early and far subtrees are culled when popped;
// 32-byte node records read as two float4 loads through the read-only path.
// Packet or warp-cooperative traversal, a wider tree and wavefront
// compaction are later work.
//
// Layout and arithmetic: trace_math.cuh (the binary node records of
// bvh/flatten.py:bvh2_nodes; the plain version's operation order, built
// with -fmad=false so that t, u and v are bit-equal with it).
//
// The stack holds the pending far children: at most depth-1 entries. The
// wrapper refuses a tree deeper than TRACE_STACK_SIZE + 1.
//
// A third entry point, idk_trace_closest_steps, replaces K1 with
// `debug_iters=True` (packet_trace.py:979, called from
// render/debug_view.py:53; the "K1-dbg" kernel): closest hits plus a
// per-ray count of traversal steps for the traversal-cost heatmap. The TPU
// kernel counts loop trips per packet; the JAX package's per-ray contract
// is its stackless trace_closest_steps (ops/trace.py:244-275), so
// trace_steps_kernel walks the threaded arrays (node_min, node_max,
// node_first, node_count, hit_link, miss_link) one node per step, exactly
// as that trace does: its counts match the plain version ray by ray, which
// a near-first stack walk would not. It is a debug kernel; its speed is
// only recorded.

#include <stdint.h>

#include "trace_math.cuh"

namespace {

template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK)
trace_kernel(const float4* __restrict__ nodes, const float* __restrict__ p0,
             const float* __restrict__ e1, const float* __restrict__ e2,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max, float* __restrict__ t_out,
             int* __restrict__ slot_out, float* __restrict__ u_out,
             float* __restrict__ v_out, bool* __restrict__ occ_out, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tmax = t_max[i];
  float t_best = tmax;
  int best_slot = -1;
  float best_u = 0.0f, best_v = 0.0f;

  if (!(tmax < 0.0f)) {  // t_max < 0 marks a dead ray
    const Ray r = load_ray(o, d, i);

    int stack_node[TRACE_STACK_SIZE];
    float stack_tn[TRACE_STACK_SIZE];
    int sp = 0;
    float tn;
    float4 a, b;
    int node = 0;
    bool live = slab(nodes, 0, r, t_best, tn, a, b);
    while (live) {
      const int count = __float_as_int(b.w);
      const int link = __float_as_int(a.w);
      bool descended = false;
      if (count > 0) {
        for (int k = 0; k < count; ++k) {
          float t, u, v;
          if (triangle(p0, e1, e2, link + k, r, t, u, v) && t < t_best) {
            t_best = t;
            best_slot = link + k;
            best_u = u;
            best_v = v;
            if (ANY_HIT) break;
          }
        }
        if (ANY_HIT && best_slot >= 0) break;
      } else {
        float tl, tr;
        float4 la, lb, ra, rb;
        const bool hl = slab(nodes, node + 1, r, t_best, tl, la, lb);
        const bool hr = slab(nodes, link, r, t_best, tr, ra, rb);
        if (hl && hr) {
          const bool left_near = tl <= tr;
          stack_node[sp] = left_near ? link : node + 1;
          stack_tn[sp] = left_near ? tr : tl;
          ++sp;
          node = left_near ? node + 1 : link;
          a = left_near ? la : ra;
          b = left_near ? lb : rb;
          descended = true;
        } else if (hl || hr) {
          node = hl ? node + 1 : link;
          a = hl ? la : ra;
          b = hl ? lb : rb;
          descended = true;
        }
      }
      if (descended) continue;
      // pop the nearest pending subtree that can still hold a closer hit
      live = false;
      while (sp > 0) {
        --sp;
        if (stack_tn[sp] <= t_best) {
          node = stack_node[sp];
          a = __ldg(nodes + 2 * node);
          b = __ldg(nodes + 2 * node + 1);
          live = true;
          break;
        }
      }
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

// One step per iteration, as ops/trace.py:_traverse: slab-test the pointed
// node against t_best; at a hit leaf test its triangles in order with
// strict <; follow hit_link at a hit interior node, else miss_link. Dead
// rays run too (one step at the root), as the plain version counts them.
__global__ void __launch_bounds__(TRACE_BLOCK)
trace_steps_kernel(const float* __restrict__ node_min, const float* __restrict__ node_max,
                   const int* __restrict__ node_first, const int* __restrict__ node_count,
                   const int* __restrict__ hit_link, const int* __restrict__ miss_link,
                   const float* __restrict__ p0, const float* __restrict__ e1,
                   const float* __restrict__ e2, const float* __restrict__ o,
                   const float* __restrict__ d, const float* __restrict__ t_max,
                   float* __restrict__ t_out, int* __restrict__ slot_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ steps_out, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max[i];
  int best_slot = -1, steps = 0;
  float best_u = 0.0f, best_v = 0.0f;
  int ptr = 0;
  while (ptr >= 0) {
    ++steps;
    const float* lo = node_min + 3 * ptr;
    const float* hi = node_max + 3 * ptr;
    float tn;
    const bool hit = slab_box(__ldg(lo), __ldg(lo + 1), __ldg(lo + 2), __ldg(hi),
                              __ldg(hi + 1), __ldg(hi + 2), r, t_best, tn);
    const int count = __ldg(node_count + ptr);
    if (hit && count > 0) {
      const int first = __ldg(node_first + ptr);
      for (int k = 0; k < count; ++k) {
        float t, u, v;
        if (triangle(p0, e1, e2, first + k, r, t, u, v) && t < t_best) {
          t_best = t;
          best_slot = first + k;
          best_u = u;
          best_v = v;
        }
      }
    }
    ptr = (hit && count == 0) ? __ldg(hit_link + ptr) : __ldg(miss_link + ptr);
  }
  t_out[i] = t_best;
  slot_out[i] = best_slot;
  u_out[i] = best_u;
  v_out[i] = best_v;
  steps_out[i] = steps;
}

}  // namespace

extern "C" {

int idk_trace_stack_size() { return TRACE_STACK_SIZE; }

// Closest hit per ray. All pointers are device pointers; outputs are
// (n_rays,) f32 t, i32 slot, f32 u, f32 v. Returns cudaGetLastError().
int idk_trace_closest(const void* nodes, const void* p0, const void* e1,
                      const void* e2, const void* o, const void* d,
                      const void* t_max, void* t_out, void* slot_out,
                      void* u_out, void* v_out, int n_rays, void* stream) {
  trace_kernel<false><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float*)p0, (const float*)e1, (const float*)e2,
      (const float*)o, (const float*)d, (const float*)t_max, (float*)t_out,
      (int*)slot_out, (float*)u_out, (float*)v_out, nullptr, n_rays);
  return (int)cudaGetLastError();
}

// Occlusion per ray: occ_out (n_rays,) bool, true where a triangle lies at
// 0 < t < t_max. Returns cudaGetLastError().
int idk_trace_any(const void* nodes, const void* p0, const void* e1,
                  const void* e2, const void* o, const void* d,
                  const void* t_max, void* occ_out, int n_rays, void* stream) {
  trace_kernel<true><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float*)p0, (const float*)e1, (const float*)e2,
      (const float*)o, (const float*)d, (const float*)t_max, nullptr, nullptr,
      nullptr, nullptr, (bool*)occ_out, n_rays);
  return (int)cudaGetLastError();
}

// Closest hit and traversal steps per ray over the threaded arrays
// (node_min/node_max (N,3) f32, node_first/node_count/hit_link/miss_link
// (N,) i32). Outputs (n_rays,) f32 t, i32 slot, f32 u, f32 v, i32 steps.
// Returns cudaGetLastError().
int idk_trace_closest_steps(const void* node_min, const void* node_max,
                            const void* node_first, const void* node_count,
                            const void* hit_link, const void* miss_link, const void* p0,
                            const void* e1, const void* e2, const void* o, const void* d,
                            const void* t_max, void* t_out, void* slot_out, void* u_out,
                            void* v_out, void* steps_out, int n_rays, void* stream) {
  trace_steps_kernel<<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)node_min, (const float*)node_max, (const int*)node_first,
      (const int*)node_count, (const int*)hit_link, (const int*)miss_link,
      (const float*)p0, (const float*)e1, (const float*)e2, (const float*)o,
      (const float*)d, (const float*)t_max, (float*)t_out, (int*)slot_out,
      (float*)u_out, (float*)v_out, (int*)steps_out, n_rays);
  return (int)cudaGetLastError();
}

}  // extern "C"
