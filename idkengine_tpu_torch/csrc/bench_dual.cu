// Probe P4 for Hopper (sm_90a): can independent reduce-to-scalar chains
// share one loop, and does consuming a reduce one step late hide it?
//
// Replaces the TPU kernels of tools/bench_dual.py: `kernel_d1` (:57),
// `kernel_dd(n)` (:70) and `kernel_dp(n)` (:95), each reached through the
// pallas_call at :35. One TPU packet, (32, 128) lanes, becomes one CTA of
// 1024 threads holding four lanes each (flat lanes t, t + 1024, ...). Each
// of `iters` steps, for each of n chains k: s = int(sum of acc_k over the
// packet), row_k = (row_k + (s & 1) + 1) & 63, acc_k *= 0.99999. With
// `defer` the step consumes the sum made in the step before (0 in the
// first) and then sums the new acc_k, as kernel_dp does. Chains start at
// row 1 + k with acc_k = x * (1 + 0.1 k).
//
// The sum is the CTA sum of probe_common.cuh: warp butterflies, one
// shared-memory slot per warp and chain, one barrier a step (the slots are
// double-buffered by step parity), then a butterfly over the 32 slots in
// every warp; the plain version adds in the same order, so rows agree bit
// for bit. The rows are written out: nothing else reads them, and nvcc
// would delete the reduce that only they consume.
//
// What bounds it: the CTA sum, not the work (two float operations a lane
// per chain and step: 6.7e7 a chain, 1 us at 67 TFLOP/s, 0.13 ms on one SM;
// 32 KB of bytes). Each sum has all 32 warps issue 10 shuffles; on an H100 a
// sum took about 500 cycles, and the chains' sums add instead of overlapping
// (PERF.md). The kernel reads clock64() around the loop.
//
// Outputs: out (32, 128) f32 = acc_0 + acc_1 + ... (the tool's output),
// rows (n,) int32 = each chain's final row, cycles (1,) int64.

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int LPT = 4;  // lanes a thread: 32 x 128 over 1024 threads

template <int NCH, bool DEFER>
__global__ void __launch_bounds__(CTA)
    probe_dual_kernel(const float* __restrict__ x_in, float* __restrict__ out,
                      int* __restrict__ rows_out, long long* __restrict__ cycles, int iters) {
  __shared__ float slots[2][NCH][32];
  const int t = threadIdx.x;
  float acc[NCH][LPT];
  int row[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float scale = (float)(1.0 + 0.1 * k);  // the tool's Python float, rounded once
    row[k] = 1 + k;
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[k][j] = x_in[j * CTA + t] * scale;  // x * 1 is x
  }
  __syncthreads();
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    float* buf = &slots[i & 1][0][0];
    if (!DEFER) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) cta_sum_write(thread_sum(acc[k]), buf + k * 32);
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float s;
      if (DEFER)
        s = i == 0 ? 0.0f : cta_sum_read(&slots[(i - 1) & 1][k][0]);
      else
        s = cta_sum_read(buf + k * 32);
      row[k] = (row[k] + ((int)s & 1) + 1) & 63;
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[k][j] = acc[k][j] * 0.99999f;
    }
    if (DEFER) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) cta_sum_write(thread_sum(acc[k]), buf + k * 32);
      __syncthreads();
    }
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - c0;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    float o = acc[0][j];
#pragma unroll
    for (int k = 1; k < NCH; ++k) o = o + acc[k][j];
    out[j * CTA + t] = o;
  }
  if (t == 0) {  // every thread holds the same rows
#pragma unroll
    for (int k = 0; k < NCH; ++k) rows_out[k] = row[k];
  }
}

template <int NCH, bool DEFER>
int launch(const void* x, void* out, void* rows, void* cycles, int iters, cudaStream_t s) {
  probe_dual_kernel<NCH, DEFER><<<1, CTA, 0, s>>>((const float*)x, (float*)out, (int*)rows,
                                                  (long long*)cycles, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (32*128,) f32, out (32*128,) f32, rows (n_chains,) i32 and cycles (1,)
// i64 are device pointers; (n_chains, defer) is one of the tool's five
// kernels: (1, 0) d1, (2, 0) dd2, (4, 0) dd4, (1, 1) dp1, (2, 1) dpd2.
// Returns cudaGetLastError().
int idk_bench_dual(const void* x, void* out, void* rows, void* cycles, int n_chains, int defer,
                   int iters, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_chains == 1 && !defer) return launch<1, false>(x, out, rows, cycles, iters, s);
  if (n_chains == 2 && !defer) return launch<2, false>(x, out, rows, cycles, iters, s);
  if (n_chains == 4 && !defer) return launch<4, false>(x, out, rows, cycles, iters, s);
  if (n_chains == 1 && defer) return launch<1, true>(x, out, rows, cycles, iters, s);
  if (n_chains == 2 && defer) return launch<2, true>(x, out, rows, cycles, iters, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
