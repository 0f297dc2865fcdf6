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
//   d   one CTA sum of acc (probe_common.cuh, one barrier) steers the row:
//       row + (int(s) & 1) + 1; acc * 0.99999;
//   d2  four CTA sums, of acc * (k + 1) for k < 4, in one barrier;
//   a4  (P6) max(K / 4, 1) loads from each of the rows row + r (r < 4).
// The final row and the shared scratch are written out beside acc, so the
// chain's work cannot be deleted, and the plain version is held to them.
//
// What bounds it: issuing the step's loads, shuffles and barrier from 32
// warps, or for e the one thread's dependent chain; the work is at most
// K + 1 float operations a lane and step (17 x 4,096 x 8,192 = 5.7e8 at
// K = 16: 8.5 us card-wide, 1.1 ms on one SM) and the bytes 64 KB. On an
// H100 a step took 17.5 cycles (e) to 2,229 (d2) (PERF.md). The kernel
// reads clock64() around the loop.
//
// Outputs: out (32, 128) f32 = acc, smem (256,) i32, row (1,) i32,
// cycles (1,) i64.

#include "probe_common.cuh"

namespace {

constexpr int LPT = 4;
constexpr int TAB_ROWS = 64, TAB_COLS = 128;
enum Body { E = 0, A = 1, A2 = 2, B = 3, D = 4, D2 = 5, A4 = 6 };

template <int BODY>
__global__ void __launch_bounds__(CTA)
    probe_prims_kernel(const float* __restrict__ tab, const float* __restrict__ x_in,
                       float* __restrict__ out, int* __restrict__ smem_out,
                       int* __restrict__ row_out, long long* __restrict__ cycles, int k,
                       int iters) {
  __shared__ float tab_s[TAB_ROWS * TAB_COLS];
  __shared__ int scratch[256];
  __shared__ float slots[2][4][32];
  const int t = threadIdx.x, lane = t & 31;
  for (int f = t; f < TAB_ROWS * TAB_COLS; f += CTA) tab_s[f] = tab[f];
  if (t < 256) scratch[t] = 0;
  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = x_in[j * CTA + t];
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
    for (int i = 0; i < iters; ++i) {
      int nxt;
      if (BODY == A) {
        for (int j = 0; j < k; ++j) {
          const float v = tab_s[row * TAB_COLS + j];
#pragma unroll
          for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + v;
        }
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.5f;
        nxt = row + 1;
      } else if (BODY == A2) {
        float s = 0.0f;
        for (int j = 0; j < k; ++j) s = s + tab_s[row * TAB_COLS + j];
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
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float v[LPT];
#pragma unroll
          for (int l = 0; l < LPT; ++l) v[l] = acc[l] * (float)(m + 1);
          cta_sum_write(thread_sum(v), slots[i & 1][m]);
        }
        __syncthreads();
        int tt = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) tt = tt + ((int)cta_sum_read(slots[i & 1][m]) & 1);
        nxt = row + tt + 1;
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.99999f;
      } else {  // A4
        const int per_row = max(k / 4, 1);
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) {
          const int rr = (row + r4) & 63;
          for (int j = 0; j < per_row; ++j) {
            const float v = tab_s[rr * TAB_COLS + j];
#pragma unroll
            for (int l = 0; l < LPT; ++l) acc[l] = acc[l] + v;
          }
        }
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = acc[l] * 0.5f;
        nxt = row + 1;
      }
      row = nxt & 63;
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

template <int BODY>
int launch(const void* tab, const void* x, void* out, void* smem, void* row, void* cycles, int k,
           int iters, cudaStream_t s) {
  probe_prims_kernel<BODY><<<1, CTA, 0, s>>>((const float*)tab, (const float*)x, (float*)out,
                                             (int*)smem, (int*)row, (long long*)cycles, k,
                                             iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tab (64*128,) f32, x (32*128,) f32, out (32*128,) f32, smem (256,) i32,
// row (1,) i32 and cycles (1,) i64 are device pointers; body 0..6 as Body;
// 1 <= k <= 128. Returns cudaGetLastError().
int idk_bench_prims(const void* tab, const void* x, void* out, void* smem, void* row,
                    void* cycles, int body, int k, int iters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case E: return launch<E>(tab, x, out, smem, row, cycles, k, iters, s);
    case A: return launch<A>(tab, x, out, smem, row, cycles, k, iters, s);
    case A2: return launch<A2>(tab, x, out, smem, row, cycles, k, iters, s);
    case B: return launch<B>(tab, x, out, smem, row, cycles, k, iters, s);
    case D: return launch<D>(tab, x, out, smem, row, cycles, k, iters, s);
    case D2: return launch<D2>(tab, x, out, smem, row, cycles, k, iters, s);
    case A4: return launch<A4>(tab, x, out, smem, row, cycles, k, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
