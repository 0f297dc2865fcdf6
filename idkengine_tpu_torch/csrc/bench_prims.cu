// Probes P5 and P6 for Hopper (sm_90a): what each building block of the
// traversal loop costs, per step of a loop-carried row chain.
//
// Replaces the TPU kernels of tools/bench_prims.py: `base_loop` (:54) with
// the bodies e, a, a2, b, d, d2 (:71-116), reached through the pallas_call
// at :31 (P5), and `extra()`'s `base_loop` (:158) with the body a4 (:203),
// through the pallas_call at :139 (P6). One TPU packet, (32, 128) lanes,
// becomes one CTA of 1024 threads with four lanes each (flat lanes t,
// t + 1024, ...). The 64 x 128 table, which the TPU kernel reads from
// VMEM, is staged once into shared memory (32 KB); the TPU's SMEM scratch
// is a zero-filled shared array of 256 words. Each of `iters` steps runs
// one body on (row, acc) and ends with row = next & 63; row starts at 1:
//   e   the floor: thread 0 alone reads smem[row & 15] and writes it plus
//       one to smem[(row + 1) & 15] (a dependent shared-memory chain; the
//       other threads wait at the end);
//   a   K loads tab[row, j] (one shared address for the whole CTA: a
//       broadcast), each added to every lane; then acc * 0.5;
//   a2  the same K loads summed as one scalar s; row + (s > 0); acc + 1e-9 s;
//   b   one row load tab[row, 32q + lane] a warp from global memory (L1),
//       then lane j's value broadcast to the warp with __shfl_sync, added
//       to every lane: the TPU's lane gather is a shuffle here, and adds
//       the same values in the same order as a;
//   d   one CTA sum of acc steers the row: row + (int(s) & 1) + 1;
//       acc * 0.99999;
//   d2  four CTA sums, of acc * (m + 1) for m < 4, in one barrier; t, the
//       sum of their (int(s) & 1), steers the row: row + t + 1;
//   a4  (P6) max(K / 4, 1) loads from each of the rows row + r (r < 4).
// The final row and the shared scratch are written out beside acc, so the
// chain's work cannot be deleted, and the plain version is held to them.
//
// The design (the forms measured and not kept are in PERF.md):
//   a, a2, a4  the table row is read with 16-byte broadcast loads (rows
//     are 512 bytes, tab_s 16-byte aligned) and a tail for k % 4; the
//     tool's K = 16 is unrolled at compile time (KC), every other k takes
//     the same code with a runtime trip count. Each lane adds in j order.
//   d, d2  the same-step rule: every warp takes step i's sums and holds
//     row_{i+1} before it starts step i + 1, as a traversal's lanes need
//     their reduce to pick the next node, with one barrier a step. Their
//     step loop is not unrolled: unrolled by two, as nvcc chose for d
//     before (495 cycles a step), a pass took step i + 1's sums before
//     step i's barrier and row. The sums keep _probe.cta_sum's order
//     (probe_common.cuh), bit for bit:
//     d   cta_sum_write, the barrier, cta_sum_read (a slot a lane, five
//         shuffle rounds: fewer shared wavefronts than any transposed read);
//     d2  a lane's four partials are those of the sums g, g ^ 1, g ^ 2,
//         g ^ 3 (g = lane / 8: the lane's multipliers m + 1, set once), so
//         one reduce-scatter (6 shuffles, no selects) leaves sum g in lanes
//         8g .. 8g + 7, and lane 8g's one store writes it, transposed
//         (quad_slot); after the barrier lane group g reads four of sum g's
//         slots with one 16-byte load, adds rounds 16 and 8 in registers
//         and folds rounds 4, 2, 1 with shuffles (quad_fold), and
//         __reduce_add_sync adds the four bits into every lane.
//
// What bounds it: issuing the step's instructions from 32 warps, or a
// step's latency (d, d2: folds, barrier, folds; e: the one thread's
// chain); the work is at most K + 1 float operations a lane and step
// (17 x 4,096 x 8,192 = 5.7e8 at K = 16: 8.5 us card-wide, 1.1 ms on one
// SM) and the bytes 64 KB. Each variant is held to the instructions its
// function needs (tools/bench_prims.py:needed_cycles_per_step). The
// kernel reads clock64() around the loop.
//
// Outputs: out (32, 128) f32 = acc, smem (256,) i32, row (1,) i32,
// cycles (1,) i64.

#include "probe_common.cuh"

namespace {

constexpr int LPT = 4;
constexpr int TAB_ROWS = 64, TAB_COLS = 128;
constexpr int TOOL_K = 16;  // the tool's K, unrolled at compile time
enum Body { E = 0, A = 1, A2 = 2, B = 3, D = 4, D2 = 5, A4 = 6 };

__device__ __forceinline__ void add_each(float (&acc)[LPT], float v) {
#pragma unroll
  for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + v;
}

// acc[l] + row[0] + row[1] + ... + row[n - 1] in every lane; n = KC where
// KC > 0 (known at compile time), else k
template <int KC>
__device__ __forceinline__ void add_row(float (&acc)[LPT], const float* row, int k) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int n = KC > 0 ? KC : k;
#pragma unroll
  for (int q = 0; q < (KC > 0 ? KC / 4 : n / 4); ++q) {
    const float4 f = r4[q];
    add_each(acc, f.x), add_each(acc, f.y), add_each(acc, f.z), add_each(acc, f.w);
  }
#pragma unroll
  for (int j = n & ~3; j < n; ++j) add_each(acc, row[j]);
}

// 0 + row[0] + row[1] + ... + row[n - 1]
template <int KC>
__device__ __forceinline__ float row_sum(const float* row, int k) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int n = KC > 0 ? KC : k;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < (KC > 0 ? KC / 4 : n / 4); ++q) {
    const float4 f = r4[q];
    s = s + f.x, s = s + f.y, s = s + f.z, s = s + f.w;
  }
#pragma unroll
  for (int j = n & ~3; j < n; ++j) s = s + row[j];
  return s;
}

// d2's slots, read four to a lane: lane r of a group of 8 reads slots r,
// r + 8, r + 16 and r + 24 as one float4, so warp w's slot lies at
// 4 (w % 8) + w / 8
__device__ __forceinline__ int quad_slot(int w) { return 4 * (w % 8) + w / 8; }

// after the barrier: the sum of the 32 slots at quad_slot in the
// butterfly's order (slot j plus slot j + 16, then + 8, ...) in every lane
// of each group of 8: rounds 16 and 8 in registers, 4, 2, 1 with shuffles
__device__ __forceinline__ float quad_fold(const float* slots) {
  const float4 f = reinterpret_cast<const float4*>(slots)[threadIdx.x & 7];
  float s = (f.x + f.z) + (f.y + f.w);
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1) s = s + __shfl_xor_sync(FULL_MASK, s, off);
  return s;
}

template <int BODY, int KC>
__global__ void __launch_bounds__(CTA)
    probe_prims_kernel(const float* __restrict__ tab, const float* __restrict__ x_in,
                       float* __restrict__ out, int* __restrict__ smem_out,
                       int* __restrict__ row_out, long long* __restrict__ cycles, int k,
                       int iters) {
  __shared__ __align__(16) float tab_s[TAB_ROWS * TAB_COLS];
  __shared__ int scratch[256];
  __shared__ __align__(16) float slots[2][4][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int f = t; f < TAB_ROWS * TAB_COLS; f += CTA) tab_s[f] = tab[f];
  if (t < 256) scratch[t] = 0;
  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = x_in[j * CTA + t];
  // d2: this lane's partials are those of the sums g ^ m, g = lane / 8
  float mult[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) mult[m] = (float)(((lane >> 3) ^ m) + 1);
  int row = 1;
  __syncthreads();
  const long long c0 = clock64();
  if (BODY == E) {
    if (t == 0) {
      for (int i = 0; i < iters; ++i) {
        const int v = scratch[row & 15];
        scratch[(row + 1) & 15] = v + 1;
        row = (row + 1) & 63;
      }
    }
  } else {
    auto step = [&](int i) {
      int nxt;
      if (BODY == A) {
        add_row<KC>(acc, tab_s + row * TAB_COLS, k);
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.5f;
        nxt = row + 1;
      } else if (BODY == A2) {
        const float s = row_sum<KC>(tab_s + row * TAB_COLS, k);
        nxt = row + (s > 0.0f ? 1 : 0);
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + 1e-9f * s;
      } else if (BODY == B) {
#pragma unroll
        for (int q = 0; q < TAB_COLS / 32; ++q) {
          if (q * 32 >= k) break;
          const float rv = __ldg(tab + row * TAB_COLS + q * 32 + lane);
          const int n = min(32, k - q * 32);
          for (int j = 0; j < n; ++j) {
            const float v = __shfl_sync(FULL_MASK, rv, j);
#pragma unroll
            for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + v;
          }
        }
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.5f;
        nxt = row + 1;
      } else if (BODY == D) {
        float* buf = slots[i & 1][0];
        cta_sum_write(thread_sum(acc), buf);
        __syncthreads();
        const float s = cta_sum_read(buf);
        nxt = row + ((int)s & 1) + 1;
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.99999f;
      } else if (BODY == D2) {
        float p[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float v[LPT];
#pragma unroll
          for (int l = 0; l < LPT; ++l) v[l] = acc[l] * mult[m];
          p[m] = thread_sum(v);
        }
        // the reduce-scatter: lane l ^ 16 (its g is g ^ 2) sends its p[2]
        // and p[3], partials of this lane's sums g and g ^ 1; lane l ^ 8
        // (g ^ 1) its p[1], of sum g
        p[0] = p[0] + __shfl_xor_sync(FULL_MASK, p[2], 16);
        p[1] = p[1] + __shfl_xor_sync(FULL_MASK, p[3], 16);
        p[0] = p[0] + __shfl_xor_sync(FULL_MASK, p[1], 8);
#pragma unroll
        for (int off = 4; off >= 1; off >>= 1) p[0] = p[0] + __shfl_xor_sync(FULL_MASK, p[0], off);
        if ((lane & 7) == 0) slots[i & 1][lane >> 3][quad_slot(warp)] = p[0];
        __syncthreads();
        const int bit = (int)quad_fold(slots[i & 1][lane >> 3]) & 1;
        const int tt = (int)__reduce_add_sync(FULL_MASK, (lane & 7) == 0 ? (unsigned)bit : 0u);
        nxt = row + tt + 1;
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.99999f;
      } else {  // A4
        constexpr int PER_ROW = KC > 0 ? (KC / 4 > 1 ? KC / 4 : 1) : 0;
        const int per_row = max(k / 4, 1);
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) add_row<PER_ROW>(acc, tab_s + ((row + r4) & 63) * TAB_COLS, per_row);
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.5f;
        nxt = row + 1;
      }
      row = nxt & 63;
    };
    if (BODY == D || BODY == D2) {
      // the same-step rule: no unrolled pass may take step i + 1's sums
      // before step i's barrier and row
#pragma unroll 1
      for (int i = 0; i < iters; ++i) step(i);
    } else {
      for (int i = 0; i < iters; ++i) step(i);
    }
  }
  __syncthreads();
  if (t == 0) {
    cycles[0] = clock64() - c0;
    row_out[0] = row;
  }
  if (t < 256) smem_out[t] = scratch[t];
#pragma unroll
  for (int j = 0; j < LPT; ++j) out[j * CTA + t] = acc[j];
}

template <int BODY, int KC = 0>
int launch(const void* tab, const void* x, void* out, void* smem, void* row, void* cycles, int k,
           int iters, cudaStream_t s) {
  probe_prims_kernel<BODY, KC><<<1, CTA, 0, s>>>((const float*)tab, (const float*)x,
                                                 (float*)out, (int*)smem, (int*)row,
                                                 (long long*)cycles, k, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tab (64*128,) f32, x (32*128,) f32, out (32*128,) f32, smem (256,) i32,
// row (1,) i32 and cycles (1,) i64 are device pointers; body 0..6 as Body;
// 1 <= k <= 128 (a, a2, a4 at k = 16 take the unrolled kernel). Returns
// cudaGetLastError().
int idk_bench_prims(const void* tab, const void* x, void* out, void* smem, void* row,
                    void* cycles, int body, int k, int iters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool tool_k = k == TOOL_K;
  switch (body) {
    case E: return launch<E>(tab, x, out, smem, row, cycles, k, iters, s);
    case A:
      return tool_k ? launch<A, TOOL_K>(tab, x, out, smem, row, cycles, k, iters, s)
                    : launch<A>(tab, x, out, smem, row, cycles, k, iters, s);
    case A2:
      return tool_k ? launch<A2, TOOL_K>(tab, x, out, smem, row, cycles, k, iters, s)
                    : launch<A2>(tab, x, out, smem, row, cycles, k, iters, s);
    case B: return launch<B>(tab, x, out, smem, row, cycles, k, iters, s);
    case D: return launch<D>(tab, x, out, smem, row, cycles, k, iters, s);
    case D2: return launch<D2>(tab, x, out, smem, row, cycles, k, iters, s);
    case A4:
      return tool_k ? launch<A4, TOOL_K>(tab, x, out, smem, row, cycles, k, iters, s)
                    : launch<A4>(tab, x, out, smem, row, cycles, k, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
