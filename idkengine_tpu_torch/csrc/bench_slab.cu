// Probe P1 for Hopper (sm_90a): the wide-node traversal step without the
// traversal: 8 child slab tests a lane, a packet-wide reduce of the hit
// masks, and stack pushes steered by it, for a fixed number of steps.
//
// Replaces the TPU kernel of tools/bench_slab.py:31 `make(mode,
// reduce_mode)` (its pallas_call at :151), six variants: f32 or bf16 slab
// tests, each with the reduce `sum4`, `sum1` or `none`. One TPU packet,
// (rows, 128) lanes, becomes one CTA: min(1024, 128 rows) threads, each
// holding flat lanes t, t + threads, ... (rows 1, 2, 4, 8, 16, 32 or 64).
// The 64 x 128 node table, VMEM-resident on the TPU, is staged once into
// shared memory (32 KB); the TPU's 64-word SMEM stack is a shared array,
// zero-filled, with stack[0] = 1 as the tool sets it.
//
// Step i reads row i & 63 of the table at lane offset (i & 1) * 64 (the
// tool's lax.switch) and, for every lane and child ch < 8, tests the ray
// (o, 1/d) against the box at words 8 ch .. 8 ch + 5 with t_best = acc:
//   f32   t0 = (b0 - o) * inv, t1 = (b1 - o) * inv per axis; tn = max of
//         the axes' mins, tf = min of their maxes; tn = max(tn, 0);
//         hit = tf >= tn && tn <= t_best  (bench_slab.py:52-70);
//   bf16  the same with o, 1/d, the box and t_best rounded to bf16
//         (nearest even), every operation rounded to bf16, then
//         float(min(tf, t_best) - tn) >= 0  (:64-68). The kernel runs it
//         in __nv_bfloat162 instructions, children 2j and 2j + 1 in the
//         two halves of one instruction, against a bf16 copy of the table
//         made once before the loop (word c of the four pairs j of a half
//         row in one 16-byte row), and takes the compare in bf16
//         (__hge2_mask: the same as the float compare for every bf16
//         value). Each half rounds as the scalar bf16 operation does, so
//         every output is bit-equal to the scalar form and to the plain
//         version. Pair j's mask & 0x10001 is already the term of sum4's
//         sums[j] below.
// The 8 hits pack into m = OR hit_ch << ch. Then, as :89-134:
//   sum4  four packed sums, sums[k] = sum of h[2k] + (h[2k+1] << 16) over
//         the packet (counts stay below 2^16): a warp __reduce_add_sync
//         each, one shared-memory word per warp, one barrier, and a second
//         __reduce_add_sync; acc += (sums[0] & 1) * 1e-9;
//   sum1  one integer sum of m, the same way; sums = (sum, 0, 0, 0);
//   none  no reduce: acc += m * 1e-9.
// Thread 0 alone, the TPU's scalar unit, does the stack work: sp =
// stack[0]; with a reduce, for k < 2, if ((sums[k] >> k) + i) is even,
// stack[(sp + k) & 63] = int(row word 6 + k); without one, if (int(word 6)
// + i) is even, stack[sp & 63] = int(word 7).
//
// acc starts at 1e30, so its 1e-9 steps vanish and the tool's output is
// 1e30 everywhere; the state of the chain is written beside it: the stack,
// the last step's four sums, and each lane's packed mask m of the last 64
// steps (step i into plane i & 63), which keep the pushes and the reduces
// from being deleted and give the plain version something to hold the
// kernel to.
//
// What bounds it: issuing the slab tests. A child needs 6 subtracts and
// 6 multiplies (the float pipe) and 11 minima and maxima, one more against
// t_best and a compare (the ALU pipe, half the float rate on compute
// capability 9.0); bf16 pairs do two children an instruction. Over the 32
// warps of the 4,096-lane CTA that is 6,656 cycles a step in f32 and 3,328
// in bf16 on the one SM that runs it (bench_slab.py:needed_cycles_per_step;
// PERF.md has the measured cycles). The bytes are 0.3 MB. The kernel reads
// clock64() around the loop.
//
// Outputs: out (rows, 128) f32, stack (64,) i32, sums (4,) i32, masks
// (64, rows, 128) u8 (zero where fewer than 64 steps ran), cycles (1,) i64.

#include <cuda_bf16.h>

#include <cstring>

#include "probe_common.cuh"

namespace {

constexpr int TAB_ROWS = 64, TAB_COLS = 128;
enum Reduce { SUM4 = 0, SUM1 = 1, NONE = 2 };

struct RayF32 {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ bool slab_f32(const RayF32& r, const float* b, float t_best) {
  float t0 = (b[0] - r.ox) * r.ix;
  float t1 = (b[3] - r.ox) * r.ix;
  float tn = fminf(t0, t1);
  float tf = fmaxf(t0, t1);
  t0 = (b[1] - r.oy) * r.iy;
  t1 = (b[4] - r.oy) * r.iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (b[2] - r.oz) * r.iz;
  t1 = (b[5] - r.oz) * r.iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  tn = fmaxf(tn, 0.0f);
  return (tf >= tn) & (tn <= t_best);
}

// a ray's bf16 values, each in both halves of a pair
struct RayBf16x2 {
  __nv_bfloat162 ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ __nv_bfloat162 pair(float v) { return __float2bfloat162_rn(v); }

__device__ __forceinline__ __nv_bfloat162 as_pair(unsigned w) {
  __nv_bfloat162 p;
  memcpy(&p, &w, sizeof p);
  return p;
}

constexpr int BOX2_WORDS = TAB_ROWS * 2 * 6 * 4;  // (row, half, word c, pair j)

// Children 2j (low half) and 2j + 1 (high half) of a half row against one
// ray; box[c] is word c of the pair. Returns __hge2_mask's 0xFFFF for each
// half that hits.
__device__ __forceinline__ unsigned slab_bf16x2(const RayBf16x2& r, const unsigned* box,
                                                __nv_bfloat162 t_best) {
  __nv_bfloat162 t0 = __hmul2(__hsub2(as_pair(box[0]), r.ox), r.ix);
  __nv_bfloat162 t1 = __hmul2(__hsub2(as_pair(box[3]), r.ox), r.ix);
  __nv_bfloat162 tn = __hmin2(t0, t1);
  __nv_bfloat162 tf = __hmax2(t0, t1);
  t0 = __hmul2(__hsub2(as_pair(box[1]), r.oy), r.iy);
  t1 = __hmul2(__hsub2(as_pair(box[4]), r.oy), r.iy);
  tn = __hmax2(tn, __hmin2(t0, t1));
  tf = __hmin2(tf, __hmax2(t0, t1));
  t0 = __hmul2(__hsub2(as_pair(box[2]), r.oz), r.iz);
  t1 = __hmul2(__hsub2(as_pair(box[5]), r.oz), r.iz);
  tn = __hmax2(tn, __hmin2(t0, t1));
  tf = __hmin2(tf, __hmax2(t0, t1));
  tn = __hmax2(tn, pair(0.0f));
  return __hge2_mask(__hsub2(__hmin2(tf, t_best), tn), pair(0.0f));
}

template <bool BF16, int RED, int LPT>
__global__ void __launch_bounds__(CTA)
    probe_slab_kernel(const float* __restrict__ tab, const float* __restrict__ ox_p,
                      const float* __restrict__ oy_p, const float* __restrict__ oz_p,
                      const float* __restrict__ dx_p, const float* __restrict__ dy_p,
                      const float* __restrict__ dz_p, float* __restrict__ out,
                      int* __restrict__ stack_out, int* __restrict__ sums_out,
                      unsigned char* __restrict__ masks, long long* __restrict__ cycles,
                      int iters) {
  __shared__ float tab_s[TAB_ROWS * TAB_COLS];
  __shared__ __align__(16) unsigned box2_s[BF16 ? BOX2_WORDS : 4];
  __shared__ int stack[64];
  __shared__ unsigned slots[2][4][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nthreads = blockDim.x;
  const int lanes = nthreads * LPT;
  for (int f = t; f < TAB_ROWS * TAB_COLS; f += nthreads) tab_s[f] = tab[f];
  if constexpr (BF16) {
    for (int f = t; f < BOX2_WORDS; f += nthreads) {
      const int j = f & 3, c = (f >> 2) % 6, half_row = f / 24;
      const float* b = tab + (half_row >> 1) * TAB_COLS + (half_row & 1) * 64 + c;
      const __nv_bfloat162 p = __floats2bfloat162_rn(b[16 * j], b[16 * j + 8]);
      memcpy(&box2_s[f], &p, sizeof p);
    }
  }
  if (t < 64) stack[t] = t == 0 ? 1 : 0;
  for (int f = t; f < 2 * 4 * 32; f += nthreads) (&slots[0][0][0])[f] = 0;  // absent warps add 0
  RayF32 rf[LPT];
  RayBf16x2 rb[LPT];
  float acc[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int f = l * nthreads + t;
    rf[l] = RayF32{ox_p[f], oy_p[f], oz_p[f], 1.0f / dx_p[f], 1.0f / dy_p[f], 1.0f / dz_p[f]};
    rb[l] = RayBf16x2{pair(rf[l].ox), pair(rf[l].oy), pair(rf[l].oz),
                      pair(rf[l].ix), pair(rf[l].iy), pair(rf[l].iz)};
    acc[l] = 1e30f;
  }
  unsigned sums[4] = {0, 0, 0, 0};
  __syncthreads();
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int row = i & 63;
    const float* sl = tab_s + row * TAB_COLS + (i & 1) * 64;
    unsigned m[LPT];
    unsigned pairs[LPT][4];  // bf16: pair j's hits, child 2j at bit 0, 2j + 1 at bit 16
    if constexpr (BF16) {
      unsigned box[6][4];
      const uint4* b2 = reinterpret_cast<const uint4*>(box2_s) + (row * 2 + (i & 1)) * 6;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const uint4 q = b2[c];
        box[c][0] = q.x, box[c][1] = q.y, box[c][2] = q.z, box[c][3] = q.w;
      }
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const __nv_bfloat162 t_best = pair(acc[l]);
        unsigned x = 0;  // child 2j at bit 2j, child 2j + 1 at bit 16 + 2j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned w[6] = {box[0][j], box[1][j], box[2][j], box[3][j], box[4][j], box[5][j]};
          pairs[l][j] = slab_bf16x2(rb[l], w, t_best) & 0x00010001u;
          x |= pairs[l][j] << (2 * j);
        }
        m[l] = (x & 0x55u) | ((x >> 15) & 0xAAu);
      }
    } else {
      // every child of every lane unrolled: the compiler keeps box words in
      // registers across lanes and spills a few under the 64 registers a
      // 1,024-thread CTA allows, yet this ran faster than testing one child
      // for all lanes at a time, spill-free (PERF.md)
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        m[l] = 0;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) m[l] |= (unsigned)slab_f32(rf[l], sl + 8 * ch, acc[l]) << ch;
      }
    }
    if (i >= iters - 64) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) masks[(size_t)row * lanes + l * nthreads + t] = (unsigned char)m[l];
    }
    if (RED != NONE) {
      unsigned (*buf)[32] = slots[i & 1];
      if (RED == SUM4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          unsigned p = 0;
#pragma unroll
          for (int l = 0; l < LPT; ++l)
            p += BF16 ? pairs[l][k] : ((m[l] >> (2 * k)) & 1u) + (((m[l] >> (2 * k + 1)) & 1u) << 16);
          p = __reduce_add_sync(FULL_MASK, p);
          if (lane == 0) buf[k][warp] = p;
        }
      } else {
        unsigned p = 0;
#pragma unroll
        for (int l = 0; l < LPT; ++l) p += m[l];
        p = __reduce_add_sync(FULL_MASK, p);
        if (lane == 0) buf[0][warp] = p;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < (RED == SUM4 ? 4 : 1); ++k) sums[k] = __reduce_add_sync(FULL_MASK, buf[k][lane]);
#pragma unroll
      for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + (float)(sums[0] & 1u) * 1e-9f;
      if (t == 0) {
        const int sp = stack[0];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (((((int)sums[k] >> k) + i) & 1) == 0) stack[(sp + k) & 63] = (int)sl[6 + k];
      }
    } else {
#pragma unroll
      for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + (float)m[l] * 1e-9f;
      if (t == 0 && (((int)sl[6] + i) & 1) == 0) stack[stack[0] & 63] = (int)sl[7];
    }
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - c0;
  if (t < 64) stack_out[t] = stack[t];
  if (t < 4) sums_out[t] = (int)sums[t];
#pragma unroll
  for (int l = 0; l < LPT; ++l) out[l * nthreads + t] = acc[l];
}

template <bool BF16, int RED>
int launch_lpt(const void* const* p, int rows, int iters, cudaStream_t s) {
  const int lpt = rows > 8 ? rows / 8 : 1;
  const int threads = rows * 128 / lpt;
#define SLAB_ARGS                                                                           \
  (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],            \
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (float*)p[7], (int*)p[8], \
      (int*)p[9], (unsigned char*)p[10], (long long*)p[11], iters
  switch (lpt) {
    case 1: probe_slab_kernel<BF16, RED, 1><<<1, threads, 0, s>>>(SLAB_ARGS); break;
    case 2: probe_slab_kernel<BF16, RED, 2><<<1, threads, 0, s>>>(SLAB_ARGS); break;
    case 4: probe_slab_kernel<BF16, RED, 4><<<1, threads, 0, s>>>(SLAB_ARGS); break;
    case 8: probe_slab_kernel<BF16, RED, 8><<<1, threads, 0, s>>>(SLAB_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SLAB_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tab (64*128,) f32; ox, oy, oz, dx, dy, dz (rows*128,) f32; out
// (rows*128,) f32; stack (64,) i32; sums (4,) i32; masks (64*rows*128,) u8,
// zero-filled; cycles (1,) i64: device pointers. rows in {1, 2, 4, 8, 16,
// 32, 64}; bf16 0/1; reduce 0 sum4, 1 sum1, 2 none. Returns
// cudaGetLastError().
int idk_bench_slab(const void* tab, const void* ox, const void* oy, const void* oz,
                   const void* dx, const void* dy, const void* dz, void* out, void* stack,
                   void* sums, void* masks, void* cycles, int rows, int bf16, int reduce,
                   int iters, void* stream) {
  const void* p[12] = {tab, ox, oy, oz, dx, dy, dz, out, stack, sums, masks, cycles};
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || rows > 64 || (rows & (rows - 1)) != 0) return (int)cudaErrorInvalidValue;
  switch (reduce + 3 * (bf16 != 0)) {
    case SUM4: return launch_lpt<false, SUM4>(p, rows, iters, s);
    case SUM1: return launch_lpt<false, SUM1>(p, rows, iters, s);
    case NONE: return launch_lpt<false, NONE>(p, rows, iters, s);
    case 3 + SUM4: return launch_lpt<true, SUM4>(p, rows, iters, s);
    case 3 + SUM1: return launch_lpt<true, SUM1>(p, rows, iters, s);
    case 3 + NONE: return launch_lpt<true, NONE>(p, rows, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
