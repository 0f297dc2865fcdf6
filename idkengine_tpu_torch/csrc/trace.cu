// Closest-hit and any-hit BVH traversal for Hopper (sm_90a) over a 4-wide
// node table, one ray per thread.
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
// traversal computes every contract: Hit(t, slot, u, v) for the closest hit
// (slot -1 and t = t_max on a miss), and occlusion before t_max for the
// any-hit query; t_max < 0 marks a dead ray.
//
// What bounds it: not bandwidth or arithmetic but the latency of dependent
// node fetches, and divergence between the rays of a warp. A binary tree of
// the 2.8M atrium is 24 levels deep, and each level costs a round trip to
// L2 before the ray knows where to go next. What this design does about it
// (each part kept because it measured faster on the card, PERF.md):
// - a 4-wide tree (bvh/flatten.py:bvh4_nodes) of about half the depth, whose
//   128-byte record holds the four children's boxes: one line fetch (eight
//   16-byte loads) serves four slab tests;
// - the hit children are ordered by entry distance with a five-exchange
//   sorting network on the distance's bits; the ray descends into the
//   nearest and pushes the others, far first; the closest query culls a
//   popped entry beyond its best hit, the any-hit query stops at its first
//   occluder;
// - the stack of (reference, entry distance) keeps each ray's newest
//   TRACE_RING entries in shared memory, a ring with one column per thread
//   (entry k of thread j at (k mod TRACE_RING) * TRACE_BLOCK + j, so a warp
//   touches 32 consecutive 8-byte words whatever each lane's depth), and
//   spills older entries to a local array. A whole stack in shared memory
//   (3 entries per record level, 43 KB a block at the atrium's depth 14)
//   left 5 blocks an SM and was slower than the binary kernel; a stack
//   wholly in local memory was slower on the primaries and bounces;
// - a leaf's triangles are read as three float4 loads a slot from tri_vec
//   (p0 | e1 | e2 | pad), not nine scalar loads from three arrays;
// - persistent warps (Aila and Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009): as many blocks as the card holds at
//   once, each warp taking its next 32 rays from a global counter once all
//   its lanes are done, so that no warp waits on a block's slowest one
//   (taking 64 or more at once was slower: the warps' tails grow).
// The stack holds 3 entries per record level (a record pushes at most 3 of
// its children); the wrapper refuses a tree deeper than
// (TRACE_RING + TRACE_SPILL) / 3 records.
//
// Counting (trace_kernel<ANY_HIT, true>, launched where the caller passes a
// counter row): each thread adds, in registers, its live rays, the 4-wide
// records they fetched and the triangles they tested; once its warp has no
// rays left, the warp sums them with shuffles and one lane adds the sums
// to the row (three 64-bit atomics a warp and launch). A null row launches
// trace_kernel<ANY_HIT, false>, whose code holds none of this.
//
// Layout and arithmetic: trace_math.cuh. The slab test is slab_box and the
// Möller–Trumbore test triangle_values, the plain version's form (XLA:CPU's
// fused multiply-adds through __fmaf_rn, nothing else contracted), so that
// t, u and v are bit-equal with it wherever both pick the same triangle;
// the wide records copy the binary nodes' f32 boxes bit for bit, so every
// slab test is the plain version's on that box. An empty child slot is
// never tested: the record's child count masks it (a sentinel box would
// pass CUDA's fminf, see trace_math.cuh). A leaf reference packs (first,
// count - 1) with the scene's leaf_bits, a launch argument
// (bvh/flatten.py:leaf_bits: the fewest bits, at least 5, that hold the
// largest leaf).
//
// A third entry point, idk_trace_closest_steps, replaces K1 with
// `debug_iters=True` (packet_trace.py:979, called from
// render/debug_view.py:53; the "K1-dbg" kernel): closest hits plus a
// per-ray count of traversal steps for the traversal-cost heatmap. The TPU
// kernel counts loop trips per packet; the JAX package's per-ray contract
// is its stackless trace_closest_steps (ops/trace.py:244-275), so
// trace_steps_kernel walks the threaded binary tree one node per step,
// exactly as that trace does: its counts match the plain version ray by
// ray, which a near-first stack walk would not. The walk is a chain of
// dependent node fetches, up to 1,123 a ray on the atrium's primaries. What
// its design does about that (each part measured against its alternative
// in the same process, PERF.md):
// - one aligned 32-byte record a node (bvh/flatten.py:thread_nodes: min.xyz
//   | miss_link | max.xyz | leaf word), two float4 loads from one sector,
//   in place of eight scalar loads from six arrays, and one dependent round
//   trip a step in place of two: the next node is the next record (a hit
//   interior node) or the miss link, which arrives with the box (-21%);
// - leaf triangles from tri_vec, three float4 loads a slot (-2%);
// - a leaf's triangles loaded four at a time, then tested in order
//   (leaf_batched; -10% on the debug view's rays, -13% on the primaries):
//   loaded one at a time, each triangle waits a round trip, which the
//   walk's tail, a few warps of long rays on an idle card, cannot hide.
// Persistent warps measured no faster here (+-1%), and loading the next
// record before the slab test resolves 7% slower; neither is kept. One ray
// a thread. idk_trace_closest_steps_capped is the JAX trace's `max_steps`
// (ops/trace.py:245): each ray stops after that many steps, the cap of
// the walk that the capped kernels below share with this one.
//
// Two more entry points, idk_trace_closest_capped and idk_trace_any_capped
// (trace_capped_kernel<ANY_HIT>), replace no Pallas kernel: they are the
// JAX package's XLA traces with a step cap, trace_closest and trace_any
// with `max_steps` (idkengine_tpu/ops/trace.py:122, 279), which its path
// tracer passes as PathTracerSettings.max_trace_steps. A ray stops after
// max_steps steps of the stackless binary walk, so the capped kernels walk
// the threaded records as the steps kernel does (walk_ray), one node a
// step; the 4-wide walk visits other nodes and could not stop where the
// JAX walk stops. The any-hit form also stops after the leaf that found an
// occluder, as the JAX any-hit step does.
//
// What bounds the capped kernels: instruction issue. Rays of a warp that
// start together walk the same records in lockstep (the stackless walk's
// order does not depend on the ray until the boxes differ), so their loads
// are shared, and a warp issues 44-47 instructions a step and 67-68 a
// triangle (trace_ab.py's STEP_INSTRUCTIONS, TRIANGLE_INSTRUCTIONS): on the
// atrium's batches the least time to issue those trips at the card's top
// clock is most of the measured time (PERF.md). Forms that add
// instructions or break the lockstep measured slower, and are not kept
// (PERF.md): persistent warps with per-lane ray refill (Aila and Laine's
// "replacing terminated rays"; at every idle lane, at 4 or 8, with the new
// rays staged in shared memory by cp.async), the next record's loads
// issued before the leaf, two or four triangles' loads at once (in
// registers or through shared memory by cp.async), an early-out of the
// triangle test on u, and other register limits. One ray a thread.
//
// The last two entry points, idk_trace_closest_two_level and
// idk_trace_any_two_level, replace no Pallas kernel either: they are the
// JAX package's two-level traces (idkengine_tpu/ops/trace.py:177
// trace_closest_two_level, :227 trace_any_two_level), XLA loops that trace
// the static scene and then each instance through its world->local affine.
// One launch walks the whole loop for a ray (two_level_kernel, uncapped:
// trace_kernel's persistent warps, ring and walk_wide; two_level_capped_kernel:
// trace_capped_kernel's walk_ray, a ray a thread), as the reference's
// USE_TLAS loop enters each BLAS from one shader (BVHIntersect.glsl). What
// bounds it is what bounds the walks it is made of; the loop of one launch
// a BLAS it replaces spent most of its time in its per-instance PyTorch
// glue (ray transform and box prune over every ray) and launches. The
// BLASes' tables travel in a kernel parameter (BlasTables), so a call
// copies nothing to the card; each instance's affine, box and slot offset
// are read from the caller's device tensors. The ray transform and the box
// prune round as ops/trace.py's to_instance and _box_prune, so each walk
// sees the loop's local ray and t_max and the result is the loop's bit
// for bit. Instances are taken in index order, so an equal-t tie goes to
// the earlier one, as in the loop; a TLAS walk would change that.

#include <stdint.h>

#include "trace_math.cuh"

#define TRACE_RING 16  // stack entries a ray keeps in shared memory (a power of 2)
#define TRACE_SPILL 80  // older entries, in local memory
#define TWO_LEVEL_MAX_BLAS 64  // distinct BLASes of a two-level call, the static scene's included
#define TWO_LEVEL_MAX_INSTANCES 1024  // instances of a two-level call

namespace {

// A thread's counts of the work of its rays (trace_kernel<ANY_HIT, true>).
struct WalkCounts {
  unsigned rays, nodes, tris;
};

constexpr int kMissKey = 0x7fffffff;  // above the bits of any entry distance (>= 0)

// Entry distance of a child as a sort key: its f32 bits (ordered as the
// floats, since the distance is clamped to >= 0), or kMissKey.
__device__ __forceinline__ int child_key(float lox, float loy, float loz, float hix,
                                         float hiy, float hiz, bool valid, const Ray& r,
                                         float t_best) {
  float tn;
  const bool hit = slab_box(lox, loy, loz, hix, hiy, hiz, r, t_best, tn);
  return (valid && hit) ? __float_as_int(tn) : kMissKey;
}

__device__ __forceinline__ void order(int& ka, int& ca, int& kb, int& cb) {
  const bool swap = kb < ka;
  const int k = swap ? kb : ka, c = swap ? cb : ca;
  kb = swap ? ka : kb;
  cb = swap ? ca : cb;
  ka = k;
  ca = c;
}

// A ray's stack: entry k lives in ring[(k mod TRACE_RING) * TRACE_BLOCK]
// (this thread's column of the block's shared ring) while it is among the
// newest TRACE_RING, and in spill[k - TRACE_RING] before that.
__device__ __forceinline__ void push(int2* ring, int2 (&spill)[TRACE_SPILL], int& sp,
                                     int2 e) {
  if (sp >= TRACE_RING)  // the ring's oldest entry moves out
    spill[sp - TRACE_RING] = ring[TRACE_BLOCK * (sp & (TRACE_RING - 1))];
  ring[TRACE_BLOCK * (sp & (TRACE_RING - 1))] = e;
  ++sp;
}

__device__ __forceinline__ int2 pop(int2* ring, int2 (&spill)[TRACE_SPILL], int& sp) {
  --sp;
  const int2 e = ring[TRACE_BLOCK * (sp & (TRACE_RING - 1))];
  if (sp >= TRACE_RING)  // the entry below the ring moves back in
    ring[TRACE_BLOCK * (sp & (TRACE_RING - 1))] = spill[sp - TRACE_RING];
  return e;
}

// The 4-wide walk of one live ray from the root record, with a fresh stack:
// a hit closer than t_best replaces (t_best, best_slot, best_u, best_v);
// the any-hit walk stops at its first. `ring` is this thread's column of
// the block's shared ring, `spill` the stack's older entries. COUNT adds
// each record fetched and each triangle tested to `counts`.
template <bool ANY_HIT, bool COUNT = false>
__device__ __forceinline__ void walk_wide(const float4* __restrict__ wide,
                                          const float4* __restrict__ tri_vec, const Ray& r,
                                          float& t_best, int& best_slot, float& best_u,
                                          float& best_v, int leaf_bits, int2* ring,
                                          int2 (&spill)[TRACE_SPILL], WalkCounts& counts) {
  int sp = 0;
  int code = 0;  // the root record
  for (;;) {
    if (code >= 0) {
      if constexpr (COUNT) ++counts.nodes;
      const float4* rec = wide + 8 * code;
      const float4 lx = __ldg(rec), hx = __ldg(rec + 1), ly = __ldg(rec + 2);
      const float4 hy = __ldg(rec + 3), lz = __ldg(rec + 4), hz = __ldg(rec + 5);
      const int4 ref = __ldg(reinterpret_cast<const int4*>(rec + 6));
      const int n = __ldg(reinterpret_cast<const int*>(rec + 7));
      int k0 = child_key(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, true, r, t_best);
      int k1 = child_key(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, n > 1, r, t_best);
      int k2 = child_key(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, n > 2, r, t_best);
      int k3 = child_key(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, n > 3, r, t_best);
      int c0 = ref.x, c1 = ref.y, c2 = ref.z, c3 = ref.w;
      order(k0, c0, k1, c1);
      order(k2, c2, k3, c3);
      order(k0, c0, k2, c2);
      order(k1, c1, k3, c3);
      order(k1, c1, k2, c2);
      if (k0 != kMissKey) {
        code = c0;  // descend into the nearest; push the others, far first
        if (k3 != kMissKey) push(ring, spill, sp, make_int2(c3, k3));
        if (k2 != kMissKey) push(ring, spill, sp, make_int2(c2, k2));
        if (k1 != kMissKey) push(ring, spill, sp, make_int2(c1, k1));
        continue;
      }
    } else {
      const int leaf = ~code;
      const int first = leaf >> leaf_bits;
      const int count = (leaf & ((1 << leaf_bits) - 1)) + 1;
      for (int k = 0; k < count; ++k) {
        float t, u, v;
        if constexpr (COUNT) ++counts.tris;
        if (triangle_vec(tri_vec, first + k, r, t, u, v) && t < t_best) {
          t_best = t;
          best_slot = first + k;
          best_u = u;
          best_v = v;
          if (ANY_HIT) break;
        }
      }
      if (ANY_HIT && best_slot >= 0) break;
    }
    // pop the nearest pending child that can still hold a closer hit
    bool live = false;
    while (sp > 0) {
      const int2 e = pop(ring, spill, sp);
      if (__int_as_float(e.y) <= t_best) {
        code = e.x;
        live = true;
        break;
      }
    }
    if (!live) break;
  }
}

// One ray; `ring` is this thread's column of the block's shared ring.
// COUNT adds a live ray and its walk's work to `counts`.
template <bool ANY_HIT, bool COUNT>
__device__ __forceinline__ void trace_ray(
    const float4* __restrict__ wide, const float4* __restrict__ tri_vec,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out, bool* __restrict__ occ_out, int i,
    int leaf_bits, int2* ring, WalkCounts& counts) {
  const float tmax = t_max[i];
  float t_best = tmax;
  int best_slot = -1;
  float best_u = 0.0f, best_v = 0.0f;

  if (!(tmax < 0.0f)) {  // t_max < 0 marks a dead ray
    if constexpr (COUNT) ++counts.rays;
    const Ray r = load_ray(o, d, i);
    int2 spill[TRACE_SPILL];
    walk_wide<ANY_HIT, COUNT>(wide, tri_vec, r, t_best, best_slot, best_u, best_v, leaf_bits,
                              ring, spill, counts);
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

// Persistent warps: each warp takes its next 32 rays from *next_ray (zero
// at launch) once all its lanes are done with the last 32. The ring is
// dynamic shared memory, TRACE_RING * TRACE_BLOCK entries a block. The
// explicit minimum of one block an SM lets ptxas spend 56 (any-hit) and
// 62 (closest) registers, where without it it holds to 48 (10 resident
// blocks an SM, not 8); the wider form measured 5-10% faster on the
// primaries, the shadow rays and the deferred frame's longest launch.
// COUNT adds the warp's WalkCounts to counts[0..2] (rays, nodes, tris) as
// the warp leaves.
template <bool ANY_HIT, bool COUNT>
__global__ void __launch_bounds__(TRACE_BLOCK, 1)
trace_kernel(const float4* __restrict__ wide, const float4* __restrict__ tri_vec,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max, float* __restrict__ t_out,
             int* __restrict__ slot_out, float* __restrict__ u_out, float* __restrict__ v_out,
             bool* __restrict__ occ_out, int* __restrict__ next_ray, int n_rays,
             int leaf_bits, unsigned long long* __restrict__ counts) {
  extern __shared__ int2 ring_smem[];
  int2* ring = ring_smem + threadIdx.x;
  const int lane = threadIdx.x & 31;
  WalkCounts c = {0u, 0u, 0u};
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int i = base + lane;
    if (i < n_rays)
      trace_ray<ANY_HIT, COUNT>(wide, tri_vec, o, d, t_max, t_out, slot_out, u_out, v_out,
                                occ_out, i, leaf_bits, ring, c);
    __syncwarp();
  }
  if constexpr (COUNT) {
    unsigned long long rays = c.rays, nodes = c.nodes, tris = c.tris;
    for (int off = 16; off > 0; off >>= 1) {
      rays += __shfl_down_sync(0xffffffffu, rays, off);
      nodes += __shfl_down_sync(0xffffffffu, nodes, off);
      tris += __shfl_down_sync(0xffffffffu, tris, off);
    }
    if (lane == 0) {
      atomicAdd(counts, rays);
      atomicAdd(counts + 1, nodes);
      atomicAdd(counts + 2, tris);
    }
  }
}

// The grid of a persistent-warp kernel: as many blocks as the card holds
// at once, no more than the rays need.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int n_rays, size_t smem, dim3& grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TRACE_BLOCK, smem);
  grid = grid_for(n_rays);
  if (per_sm > 0 && (unsigned)(per_sm * sms) < grid.x) grid = dim3((unsigned)(per_sm * sms));
  return err;
}

template <bool ANY_HIT, bool COUNT>
int launch_trace_kernel(const void* wide, const void* tri_vec, const void* o, const void* d,
                        const void* t_max, void* t_out, void* slot_out, void* u_out,
                        void* v_out, void* occ_out, void* next_ray, int n_rays, int leaf_bits,
                        void* stream, void* counts) {
  const size_t smem = (size_t)TRACE_RING * TRACE_BLOCK * sizeof(int2);
  dim3 grid;
  const cudaError_t err = persistent_grid(trace_kernel<ANY_HIT, COUNT>, n_rays, smem, grid);
  if (err != cudaSuccess) return (int)err;
  trace_kernel<ANY_HIT, COUNT><<<grid, TRACE_BLOCK, smem, (cudaStream_t)stream>>>(
      (const float4*)wide, (const float4*)tri_vec, (const float*)o, (const float*)d,
      (const float*)t_max, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out,
      (bool*)occ_out, (int*)next_ray, n_rays, leaf_bits, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

// `counts` null: the plain kernel; else the counting one, into counts[0..2].
template <bool ANY_HIT>
int launch_trace(const void* wide, const void* tri_vec, const void* o, const void* d,
                 const void* t_max, void* t_out, void* slot_out, void* u_out, void* v_out,
                 void* occ_out, void* next_ray, int n_rays, int stack_entries, int leaf_bits,
                 void* stream, void* counts) {
  if (stack_entries < 1 || stack_entries > TRACE_RING + TRACE_SPILL || leaf_bits < 5 ||
      leaf_bits > 30)
    return (int)cudaErrorInvalidValue;
  if (counts == nullptr)
    return launch_trace_kernel<ANY_HIT, false>(wide, tri_vec, o, d, t_max, t_out, slot_out,
                                               u_out, v_out, occ_out, next_ray, n_rays,
                                               leaf_bits, stream, nullptr);
  return launch_trace_kernel<ANY_HIT, true>(wide, tri_vec, o, d, t_max, t_out, slot_out, u_out,
                                            v_out, occ_out, next_ray, n_rays, leaf_bits,
                                            stream, counts);
}

// Triangles a leaf test of the steps kernel loads at once (72 registers, 7
// resident blocks an SM; 2, 3 and 6 measured slower, PERF.md).
constexpr int kStepsLeaf = 4;

// Tests a leaf's triangles first .. first + count - 1 in order with strict
// <, LEAF at a time: their loads (three float4 a slot, the last one's first
// float) issued together, then their tests in order.
template <int LEAF>
__device__ __forceinline__ void leaf_batched(const float4* __restrict__ tri_vec, const Ray& r,
                                             int first, int count, float& t_best,
                                             int& best_slot, float& best_u, float& best_v) {
  for (int k = 0; k < count; k += LEAF) {
    float4 ta[LEAF], tb[LEAF];
    float tc[LEAF];
#pragma unroll
    for (int j = 0; j < LEAF; ++j) {
      if (k + j < count) {
        const float4* tv = tri_vec + 3 * (first + k + j);
        ta[j] = __ldg(tv);
        tb[j] = __ldg(tv + 1);
        tc[j] = __ldg(reinterpret_cast<const float*>(tv + 2));
      }
    }
#pragma unroll
    for (int j = 0; j < LEAF; ++j) {
      float t, u, v;
      if (k + j < count &&
          triangle_values(ta[j].x, ta[j].y, ta[j].z, ta[j].w, tb[j].x, tb[j].y, tb[j].z,
                          tb[j].w, tc[j], r, t, u, v) &&
          t < t_best) {
        t_best = t;
        best_slot = first + k + j;
        best_u = u;
        best_v = v;
      }
    }
  }
}

// The stackless walk of ops/trace.py:_traverse over the threaded records,
// one node a step: slab-test the pointed node against t_best; at a hit
// leaf test its triangles in order with strict <; go to the next record at
// a hit interior node, else to the miss link. At most max_steps steps; the
// any-hit walk also stops after the leaf that found an occluder (the JAX
// package's _traversal_step with t_cut = t_max). Dead rays run too (one
// step at the root), as the plain version counts them. Returns the steps.
// LEAF > 1 (closest hits only) loads a leaf's triangles LEAF at a time
// (leaf_batched); LEAF = 1 loads each after the previous one's test.
template <bool ANY_HIT, int LEAF>
__device__ __forceinline__ int walk_ray(const float4* __restrict__ nodes,
                                        const float4* __restrict__ tri_vec, const Ray& r,
                                        float& t_best, int& best_slot, float& best_u,
                                        float& best_v, int max_steps, int leaf_bits) {
  static_assert(LEAF == 1 || !ANY_HIT, "a batched leaf tests past the first occluder");
  int steps = 0, ptr = 0;
  float4 a = __ldg(nodes), b = __ldg(nodes + 1);  // min.xyz | miss, max.xyz | leaf word
  while (steps < max_steps) {
    ++steps;
    float tn;
    const bool hit = slab_box(a.x, a.y, a.z, b.x, b.y, b.z, r, t_best, tn);
    const int word = __float_as_int(b.w);
    if (hit && word < 0) {
      const int leaf = ~word;
      const int first = leaf >> leaf_bits;
      const int count = (leaf & ((1 << leaf_bits) - 1)) + 1;
      if constexpr (LEAF > 1) {
        leaf_batched<LEAF>(tri_vec, r, first, count, t_best, best_slot, best_u, best_v);
      } else {
        for (int k = 0; k < count; ++k) {
          float t, u, v;
          if (triangle_vec(tri_vec, first + k, r, t, u, v) && t < t_best) {
            t_best = t;
            best_slot = first + k;
            best_u = u;
            best_v = v;
            if (ANY_HIT) break;
          }
        }
      }
      if (ANY_HIT && best_slot >= 0) break;
    }
    const int next = (hit && word == 0) ? ptr + 1 : __float_as_int(a.w);
    if (next < 0) break;
    a = __ldg(nodes + 2 * next);
    b = __ldg(nodes + 2 * next + 1);
    ptr = next;
  }
  return steps;
}

// CAPPED false walks with no cap (a constant, so that the uncapped kernel
// keeps 72 registers and 7 blocks an SM; the cap as an argument took 74
// and 6 blocks, 2% slower, PERF.md).
template <bool CAPPED>
__global__ void __launch_bounds__(TRACE_BLOCK)
trace_steps_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tri_vec,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ slot_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ steps_out, int n_rays,
                   int max_steps, int leaf_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max[i], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  steps_out[i] = walk_ray<false, kStepsLeaf>(nodes, tri_vec, r, t_best, best_slot, best_u,
                                             best_v, CAPPED ? max_steps : 0x7fffffff,
                                             leaf_bits);
  t_out[i] = t_best;
  slot_out[i] = best_slot;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

// The JAX package's capped traces (trace_closest / trace_any with
// max_steps): the same walk as trace_steps_kernel, stopped after max_steps
// node visits, so that a ray stops where the JAX walk stops. A ray a thread.
template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK)
trace_capped_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tri_vec,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, float* __restrict__ t_out,
                    int* __restrict__ slot_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, bool* __restrict__ occ_out, int n_rays,
                    int max_steps, int leaf_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max[i], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  walk_ray<ANY_HIT, 1>(nodes, tri_vec, r, t_best, best_slot, best_u, best_v, max_steps,
                       leaf_bits);
  if (ANY_HIT) {
    occ_out[i] = best_slot >= 0;
  } else {
    t_out[i] = t_best;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

template <bool CAPPED>
int launch_steps(const void* nodes, const void* tri_vec, const void* o, const void* d,
                 const void* t_max, void* t_out, void* slot_out, void* u_out, void* v_out,
                 void* steps_out, int n_rays, int max_steps, int leaf_bits, void* stream) {
  if (max_steps < 0 || leaf_bits < 5 || leaf_bits > 30) return (int)cudaErrorInvalidValue;
  trace_steps_kernel<CAPPED><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float4*)tri_vec, (const float*)o, (const float*)d,
      (const float*)t_max, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out,
      (int*)steps_out, n_rays, max_steps, leaf_bits);
  return (int)cudaGetLastError();
}

template <bool ANY_HIT>
int launch_capped(const void* nodes, const void* tri_vec, const void* o, const void* d,
                  const void* t_max, void* t_out, void* slot_out, void* u_out, void* v_out,
                  void* occ_out, int n_rays, int max_steps, int leaf_bits, void* stream) {
  if (max_steps < 0 || leaf_bits < 5 || leaf_bits > 30) return (int)cudaErrorInvalidValue;
  trace_capped_kernel<ANY_HIT><<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float4*)tri_vec, (const float*)o, (const float*)d,
      (const float*)t_max, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out,
      (bool*)occ_out, n_rays, max_steps, leaf_bits);
  return (int)cudaGetLastError();
}

// The distinct BLASes of a two-level call, the static scene's first, and
// the BLAS of each instance: a kernel parameter, so that a call copies
// nothing to the card and waits for nothing. nodes[b] is the 4-wide table
// (uncapped) or the threaded records (capped). Its size stays inside the
// 4 KB of kernel parameters that every CUDA 12 toolkit takes.
struct BlasTables {
  const float4* nodes[TWO_LEVEL_MAX_BLAS];
  const float4* tri_vec[TWO_LEVEL_MAX_BLAS];
  int leaf_bits[TWO_LEVEL_MAX_BLAS];
  unsigned short blas_of[TWO_LEVEL_MAX_INSTANCES];
};

// ops/trace.py:_box_prune for one instance's world box (lo.xyz | hi.xyz):
// whether a ray whose best hit so far lies at best_t must enter it. The
// slab test divides by the clamped direction (__fdiv_rn, not a product by
// the reciprocal), as the plain version does; torch.minimum and amax
// propagate a NaN, which then fails every comparison, so a NaN slab
// distance leaves the instance out.
__device__ __forceinline__ bool instance_needed(const float* __restrict__ box, const Ray& r,
                                                float best_t) {
  const float nx = clamped_dir(r.dx), ny = clamped_dir(r.dy), nz = clamped_dir(r.dz);
  const float t0x = __fdiv_rn(__fsub_rn(__ldg(box), r.ox), nx);
  const float t1x = __fdiv_rn(__fsub_rn(__ldg(box + 3), r.ox), nx);
  const float t0y = __fdiv_rn(__fsub_rn(__ldg(box + 1), r.oy), ny);
  const float t1y = __fdiv_rn(__fsub_rn(__ldg(box + 4), r.oy), ny);
  const float t0z = __fdiv_rn(__fsub_rn(__ldg(box + 2), r.oz), nz);
  const float t1z = __fdiv_rn(__fsub_rn(__ldg(box + 5), r.oz), nz);
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) || isnan(t1z))
    return false;
  const float tn =
      fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), 0.0f);
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tf >= tn && tn < best_t && best_t > 0.0f;
}

// One row of ops/trace.py:linear_map: fma(x2, m2, fma(x1, m1, x0 * m0)).
__device__ __forceinline__ float linear_row(float x0, float x1, float x2,
                                            const float* __restrict__ m) {
  return __fmaf_rn(x2, __ldg(m + 2), __fmaf_rn(x1, __ldg(m + 1), __fmul_rn(x0, __ldg(m))));
}

// ops/trace.py:to_instance: the world ray through an instance's (3,4)
// world->local affine `m` (row-major), the origin's rows plus m[:,3], the
// direction not normalised (t stays world-space), its clamped inverse as
// load_ray takes it.
__device__ __forceinline__ Ray to_instance(const float* __restrict__ m, const Ray& w) {
  Ray r;
  r.ox = __fadd_rn(linear_row(w.ox, w.oy, w.oz, m), __ldg(m + 3));
  r.oy = __fadd_rn(linear_row(w.ox, w.oy, w.oz, m + 4), __ldg(m + 7));
  r.oz = __fadd_rn(linear_row(w.ox, w.oy, w.oz, m + 8), __ldg(m + 11));
  r.dx = linear_row(w.dx, w.dy, w.dz, m);
  r.dy = linear_row(w.dx, w.dy, w.dz, m + 4);
  r.dz = linear_row(w.dx, w.dy, w.dz, m + 8);
  r.ix = inv_clamped(r.dx);
  r.iy = inv_clamped(r.dy);
  r.iz = inv_clamped(r.dz);
  return r;
}

// The two-level trace of one ray, ops/trace.py:two_level_closest /
// two_level_any, over walk(b, ray, t_best, slot, u, v), which walks BLAS b
// from its root with a fresh stack and budget. The static scene (BLAS 0)
// first; then, closest hits, each instance in index order whose box the
// ray must enter before its best hit so far, walked with that best hit as
// its t_max (a walk's hit is closer by the strict test, so it replaces the
// best hit, its slot moved by the instance's slot offset); any-hit, each
// instance in order, with no prune, until one occludes. An instance the
// loop would pass a dead ray is not walked; an any-hit ray with t_max <= 0
// or NaN can hit nothing (a hit needs 0 < t < t_max) and walks no instance.
template <bool ANY_HIT, typename Walk>
__device__ __forceinline__ void two_level_walks(const Ray& r, float& t_best, int& best_slot,
                                                float& best_u, float& best_v, int& inst,
                                                const float* __restrict__ inv,
                                                const float* __restrict__ boxes,
                                                const int* __restrict__ slot_off, int n_inst,
                                                const BlasTables& tables, Walk walk) {
  walk(0, r, t_best, best_slot, best_u, best_v);
  if (ANY_HIT && (best_slot >= 0 || !(t_best > 0.0f))) return;
  for (int k = 0; k < n_inst; ++k) {
    if (!ANY_HIT && !instance_needed(boxes + 6 * k, r, t_best)) continue;
    const Ray l = to_instance(inv + 12 * k, r);
    int s = -1;
    walk(tables.blas_of[k], l, t_best, s, best_u, best_v);
    if (s >= 0) {
      best_slot = ANY_HIT || slot_off == nullptr ? s : s + __ldg(slot_off + k);
      inst = k;
      if (ANY_HIT) return;
    }
  }
}

template <bool ANY_HIT>
__device__ __forceinline__ void store_two_level(int i, float t_best, int best_slot,
                                                float best_u, float best_v, int inst,
                                                float* __restrict__ t_out,
                                                int* __restrict__ slot_out,
                                                float* __restrict__ u_out,
                                                float* __restrict__ v_out,
                                                int* __restrict__ inst_out,
                                                bool* __restrict__ occ_out) {
  if (ANY_HIT) {
    occ_out[i] = best_slot >= 0;
  } else {
    t_out[i] = t_best;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
    inst_out[i] = inst;
  }
}

// The two-level trace without a step cap: trace_kernel's persistent warps,
// shared ring and 4-wide walk (walk_wide), the static scene's and then
// each instance's tables, one stack reused walk after walk. A dead ray
// (t_max < 0) walks nothing, as in every launch of the loop.
template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK, 1)
two_level_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_max, float* __restrict__ t_out,
                 int* __restrict__ slot_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ inst_out,
                 bool* __restrict__ occ_out, int* __restrict__ next_ray, int n_rays,
                 const float* __restrict__ inv, const float* __restrict__ boxes,
                 const int* __restrict__ slot_off, int n_inst,
                 const __grid_constant__ BlasTables tables) {
  extern __shared__ int2 ring_smem[];
  int2* ring = ring_smem + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int i = base + lane;
    if (i < n_rays) {
      const float tmax = t_max[i];
      float t_best = tmax, best_u = 0.0f, best_v = 0.0f;
      int best_slot = -1, inst = -1;
      if (!(tmax < 0.0f)) {
        const Ray r = load_ray(o, d, i);
        int2 spill[TRACE_SPILL];
        WalkCounts uncounted;
        two_level_walks<ANY_HIT>(
            r, t_best, best_slot, best_u, best_v, inst, inv, boxes, slot_off, n_inst, tables,
            [&](int b, const Ray& ray, float& tb, int& s, float& u, float& v) {
              walk_wide<ANY_HIT>(tables.nodes[b], tables.tri_vec[b], ray, tb, s, u, v,
                                 tables.leaf_bits[b], ring, spill, uncounted);
            });
      }
      store_two_level<ANY_HIT>(i, t_best, best_slot, best_u, best_v, inst, t_out, slot_out,
                               u_out, v_out, inst_out, occ_out);
    }
    __syncwarp();
  }
}

// The two-level trace with a step cap: trace_capped_kernel's walk
// (walk_ray over the threaded records, a ray a thread, dead rays walked as
// it walks them), each BLAS with a fresh budget of max_steps, as the loop
// gives every instance its own capped trace.
template <bool ANY_HIT>
__global__ void __launch_bounds__(TRACE_BLOCK)
two_level_capped_kernel(const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_max, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ inst_out,
                        bool* __restrict__ occ_out, int n_rays, int max_steps,
                        const float* __restrict__ inv, const float* __restrict__ boxes,
                        const int* __restrict__ slot_off, int n_inst,
                        const __grid_constant__ BlasTables tables) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  float t_best = t_max[i], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1, inst = -1;
  two_level_walks<ANY_HIT>(
      r, t_best, best_slot, best_u, best_v, inst, inv, boxes, slot_off, n_inst, tables,
      [&](int b, const Ray& ray, float& tb, int& s, float& u, float& v) {
        walk_ray<ANY_HIT, 1>(tables.nodes[b], tables.tri_vec[b], ray, tb, s, u, v, max_steps,
                             tables.leaf_bits[b]);
      });
  store_two_level<ANY_HIT>(i, t_best, best_slot, best_u, best_v, inst, t_out, slot_out, u_out,
                           v_out, inst_out, occ_out);
}

// max_steps < 0: no cap (two_level_kernel, whose stack must hold
// stack_entries); else the capped kernel. Refuses tables it cannot walk.
template <bool ANY_HIT>
int launch_two_level(const void* o, const void* d, const void* t_max, void* t_out,
                     void* slot_out, void* u_out, void* v_out, void* inst_out, void* occ_out,
                     void* next_ray, int n_rays, int stack_entries, int max_steps,
                     const void* inv, const void* boxes, const void* slot_off, int n_inst,
                     int n_blas, const BlasTables* tables, void* stream) {
  if (n_inst < 0 || n_inst > TWO_LEVEL_MAX_INSTANCES || n_blas < 1 ||
      n_blas > TWO_LEVEL_MAX_BLAS || tables == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < n_blas; ++b)
    if (tables->nodes[b] == nullptr || tables->tri_vec[b] == nullptr ||
        tables->leaf_bits[b] < 5 || tables->leaf_bits[b] > 30)
      return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_inst; ++k)
    if (tables->blas_of[k] >= n_blas) return (int)cudaErrorInvalidValue;
  const float* fo = (const float*)o;
  const float* fd = (const float*)d;
  const float* ft = (const float*)t_max;
  if (max_steps >= 0) {
    two_level_capped_kernel<ANY_HIT>
        <<<grid_for(n_rays), TRACE_BLOCK, 0, (cudaStream_t)stream>>>(
            fo, fd, ft, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out,
            (int*)inst_out, (bool*)occ_out, n_rays, max_steps, (const float*)inv,
            (const float*)boxes, (const int*)slot_off, n_inst, *tables);
    return (int)cudaGetLastError();
  }
  if (stack_entries < 1 || stack_entries > TRACE_RING + TRACE_SPILL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TRACE_RING * TRACE_BLOCK * sizeof(int2);
  dim3 grid;
  const cudaError_t err = persistent_grid(two_level_kernel<ANY_HIT>, n_rays, smem, grid);
  if (err != cudaSuccess) return (int)err;
  two_level_kernel<ANY_HIT><<<grid, TRACE_BLOCK, smem, (cudaStream_t)stream>>>(
      fo, fd, ft, (float*)t_out, (int*)slot_out, (float*)u_out, (float*)v_out, (int*)inst_out,
      (bool*)occ_out, (int*)next_ray, n_rays, (const float*)inv, (const float*)boxes,
      (const int*)slot_off, n_inst, *tables);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The interface of this library, for scripts that bind several versions
// (trace_ab.py): 7 = 6 with a counter row as the last argument of
// idk_trace_closest and idk_trace_any; 6 = 5 and the fused two-level
// traces; 5 = the wide
// tables with a leaf_bits argument, the
// threaded records of the steps kernel, the capped walks and the capped
// steps kernel; 4 = the same without the capped steps kernel; 3 = without
// the capped walks either. Libraries without this function are older:
// with idk_trace_stack_limit the wide tables with 5 count bits, without it
// the binary records.
int idk_trace_interface() { return 7; }

// The most stack entries a ray can hold (3 per record level of the tree).
int idk_trace_stack_limit() { return TRACE_RING + TRACE_SPILL; }

// Dynamic shared memory a trace_kernel block takes (the stack's ring).
int idk_trace_shared_bytes() { return TRACE_RING * TRACE_BLOCK * (int)sizeof(int2); }

// Closest hit per ray over the 4-wide records `wide` ((M,32) i32) and the
// leaf table tri_vec ((T,12) f32). All pointers are device pointers;
// outputs are (n_rays,) f32 t, i32 slot, f32 u, f32 v. `next_ray` is one
// zeroed i32; `stack_entries` the tree's stack depth (3 per record level);
// `leaf_bits` the count bits of a leaf reference (5-30). `counts`: null,
// or a device row of three u64 (rays, nodes, tris) to which the launch
// adds its live rays, the 4-wide records they fetched and the triangles
// they tested. Returns cudaGetLastError().
int idk_trace_closest(const void* wide, const void* tri_vec, const void* o, const void* d,
                      const void* t_max, void* t_out, void* slot_out, void* u_out, void* v_out,
                      void* next_ray, int n_rays, int stack_entries, int leaf_bits,
                      void* stream, void* counts) {
  return launch_trace<false>(wide, tri_vec, o, d, t_max, t_out, slot_out, u_out, v_out,
                             nullptr, next_ray, n_rays, stack_entries, leaf_bits, stream,
                             counts);
}

// Occlusion per ray: occ_out (n_rays,) bool, true where a triangle lies at
// 0 < t < t_max; `counts` as idk_trace_closest's. Returns
// cudaGetLastError().
int idk_trace_any(const void* wide, const void* tri_vec, const void* o, const void* d,
                  const void* t_max, void* occ_out, void* next_ray, int n_rays,
                  int stack_entries, int leaf_bits, void* stream, void* counts) {
  return launch_trace<true>(wide, tri_vec, o, d, t_max, nullptr, nullptr, nullptr, nullptr,
                            occ_out, next_ray, n_rays, stack_entries, leaf_bits, stream,
                            counts);
}

// Closest hit and traversal steps per ray over the threaded records
// `nodes` ((N,8) i32, bvh/flatten.py:thread_nodes) and tri_vec, each ray
// stopped after at most max_steps node visits (max_steps >= 0). Outputs
// (n_rays,) f32 t, i32 slot, f32 u, f32 v, i32 steps. Returns
// cudaGetLastError().
int idk_trace_closest_steps_capped(const void* nodes, const void* tri_vec, const void* o,
                                   const void* d, const void* t_max, void* t_out,
                                   void* slot_out, void* u_out, void* v_out, void* steps_out,
                                   int n_rays, int max_steps, int leaf_bits, void* stream) {
  return launch_steps<true>(nodes, tri_vec, o, d, t_max, t_out, slot_out, u_out, v_out,
                            steps_out, n_rays, max_steps, leaf_bits, stream);
}

// idk_trace_closest_steps_capped with no cap (interface 3 and 4's entry).
int idk_trace_closest_steps(const void* nodes, const void* tri_vec, const void* o,
                            const void* d, const void* t_max, void* t_out, void* slot_out,
                            void* u_out, void* v_out, void* steps_out, int n_rays,
                            int leaf_bits, void* stream) {
  return launch_steps<false>(nodes, tri_vec, o, d, t_max, t_out, slot_out, u_out, v_out,
                             steps_out, n_rays, 0, leaf_bits, stream);
}

// Closest hit per ray after at most max_steps node visits of the threaded
// walk (max_steps >= 0): outputs as idk_trace_closest_steps_capped
// without the steps. Returns cudaGetLastError().
int idk_trace_closest_capped(const void* nodes, const void* tri_vec, const void* o,
                             const void* d, const void* t_max, void* t_out, void* slot_out,
                             void* u_out, void* v_out, int n_rays, int max_steps,
                             int leaf_bits, void* stream) {
  return launch_capped<false>(nodes, tri_vec, o, d, t_max, t_out, slot_out, u_out, v_out,
                              nullptr, n_rays, max_steps, leaf_bits, stream);
}

// Occlusion per ray after at most max_steps node visits: occ_out (n_rays,)
// bool. Returns cudaGetLastError().
int idk_trace_any_capped(const void* nodes, const void* tri_vec, const void* o, const void* d,
                         const void* t_max, void* occ_out, int n_rays, int max_steps,
                         int leaf_bits, void* stream) {
  return launch_capped<true>(nodes, tri_vec, o, d, t_max, nullptr, nullptr, nullptr, nullptr,
                             occ_out, n_rays, max_steps, leaf_bits, stream);
}

// The two-level traces' limits and the size of their BlasTables, which a
// caller lays out as this file does.
int idk_two_level_max_blas() { return TWO_LEVEL_MAX_BLAS; }
int idk_two_level_max_instances() { return TWO_LEVEL_MAX_INSTANCES; }
int idk_two_level_tables_bytes() { return (int)sizeof(BlasTables); }

// Two-level closest hit per ray, one launch: the static scene (BLAS 0 of
// `tables`, a host pointer) and n_inst instances, instance k through the
// world->local affine inv[k] ((I,3,4) f32) into BLAS tables->blas_of[k],
// entered where its world box boxes[k] ((I,2,3) f32) passes the box prune;
// an instance's hit slot is moved by slot_off[k] ((I,) i32, or null for
// none). Outputs (n_rays,) f32 t, i32 slot, f32 u, f32 v, i32 instance (-1:
// the static scene or a miss). max_steps < 0: the uncapped walk of the
// 4-wide tables (`next_ray` one zeroed i32, stack_entries the deepest
// table's); else the capped walk of the threaded records. Returns
// cudaGetLastError().
int idk_trace_closest_two_level(const void* o, const void* d, const void* t_max, void* t_out,
                                void* slot_out, void* u_out, void* v_out, void* inst_out,
                                void* next_ray, int n_rays, int stack_entries, int max_steps,
                                const void* inv, const void* boxes, const void* slot_off,
                                int n_inst, int n_blas, const void* tables, void* stream) {
  return launch_two_level<false>(o, d, t_max, t_out, slot_out, u_out, v_out, inst_out, nullptr,
                                 next_ray, n_rays, stack_entries, max_steps, inv, boxes,
                                 slot_off, n_inst, n_blas, (const BlasTables*)tables, stream);
}

// Two-level occlusion per ray, one launch: occ_out (n_rays,) bool; the
// instances in order, with no box prune, until one occludes. Arguments as
// idk_trace_closest_two_level's. Returns cudaGetLastError().
int idk_trace_any_two_level(const void* o, const void* d, const void* t_max, void* occ_out,
                            void* next_ray, int n_rays, int stack_entries, int max_steps,
                            const void* inv, int n_inst, int n_blas, const void* tables,
                            void* stream) {
  return launch_two_level<true>(o, d, t_max, nullptr, nullptr, nullptr, nullptr, nullptr,
                                occ_out, next_ray, n_rays, stack_entries, max_steps, inv,
                                nullptr, nullptr, n_inst, n_blas, (const BlasTables*)tables,
                                stream);
}

}  // extern "C"
