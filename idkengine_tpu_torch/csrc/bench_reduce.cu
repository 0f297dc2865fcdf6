// Probe P3 for Hopper (sm_90a): a packet-wide reduce whose result steers
// the next step, in four forms.
//
// Replaces the TPU kernel of tools/bench_reduce.py:21 `make(mode)` (its
// pallas_call at :77). One TPU packet, (8, 128) lanes, becomes one CTA of
// 1024 threads, one lane each. Each of `iters` steps makes 8 threshold
// masks h[k] = x > k, packs them into m = OR h[k] << k, reduces over the
// CTA, adds the result to an integer accumulator and feeds its low bit
// back into x (x += (bits & 1) * 1e-6), so step i + 1 cannot start before
// step i's reduce is known everywhere. The forms, each a different CTA-wide
// mechanism:
//   sum4        bit k = (count of lanes with h[k]) > 0, the TPU's four
//               packed jnp.sum(h[2k] + (h[2k+1] << 16)) (counts stay below
//               2^16): eight __syncthreads_count CTA votes, one per child;
//   orroll      OR of m over every lane (the TPU's lane and sublane
//               rolls): a warp __reduce_or_sync, one shared-memory word per
//               warp, one barrier, then every warp __reduce_or_syncs the 32
//               words;
//   orroll_max  OR of m over row 0 (lanes 0-127, warps 0-3): warp
//               __reduce_or_sync, four words, one barrier;
//   sum1        the integer sum of m over every lane (not an OR, as the
//               tool says): warp __reduce_add_sync, one barrier, a second
//               __reduce_add_sync.
// Shared memory is double-buffered by step parity, so each step needs one
// barrier: a thread can rewrite a buffer only after the next step's
// barrier, which every thread reaches after reading it.
//
// What bounds it: the CTA-wide reduce in every step, not the work (about
// 20 integer operations a lane per step, 4.1e8 for 20,000 steps: 6 us at the
// card's 67 Tops/s, 1.2 ms on one SM; 8 KB of bytes). Each step waits for
// its reduce; on an H100 a step took 517-553 cycles with one warp-reduce
// round and 1,388 with eight CTA votes (PERF.md). The kernel reads clock64()
// around the loop and writes the cycles it took.
//
// Outputs: out (8, 128) int32 = the accumulator (wrapping as int32 does),
// x_out (8, 128) f32 = x after the last step (the chain's state), cycles
// (1,) int64.

#include "probe_common.cuh"

namespace {

enum Mode { SUM4 = 0, ORROLL = 1, ORROLL_MAX = 2, SUM1 = 3 };

template <int MODE>
__global__ void __launch_bounds__(CTA)
    probe_reduce_kernel(const float* __restrict__ x_in, int* __restrict__ out,
                        float* __restrict__ x_out, long long* __restrict__ cycles, int iters) {
  __shared__ unsigned part[2][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float x = x_in[t];
  unsigned acc = 0;
  __syncthreads();
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) m |= (unsigned)(x > (float)k) << k;
    unsigned bits = 0;
    unsigned* buf = part[i & 1];
    if (MODE == SUM4) {
#pragma unroll
      for (int k = 0; k < 8; ++k) bits |= (unsigned)(__syncthreads_count((m >> k) & 1u) > 0) << k;
    } else if (MODE == ORROLL) {
      const unsigned w = __reduce_or_sync(FULL_MASK, m);
      if (lane == 0) buf[warp] = w;
      __syncthreads();
      bits = __reduce_or_sync(FULL_MASK, buf[lane]);
    } else if (MODE == ORROLL_MAX) {
      const unsigned w = __reduce_or_sync(FULL_MASK, m);
      if (lane == 0 && warp < 4) buf[warp] = w;
      __syncthreads();
      bits = buf[0] | buf[1] | buf[2] | buf[3];
    } else {  // SUM1
      const unsigned w = __reduce_add_sync(FULL_MASK, m);
      if (lane == 0) buf[warp] = w;
      __syncthreads();
      bits = __reduce_add_sync(FULL_MASK, buf[lane]);
    }
    acc += bits;
    x = x + (float)(bits & 1u) * 1e-6f;
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - c0;
  out[t] = (int)acc;
  x_out[t] = x;
}

}  // namespace

extern "C" {

// x (1024,) f32, out (1024,) i32, x_out (1024,) f32 and cycles (1,) i64 are
// device pointers; mode 0..3 as Mode. Returns cudaGetLastError().
int idk_bench_reduce(const void* x, void* out, void* x_out, void* cycles, int mode, int iters,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  int* o = (int*)out;
  float* xo = (float*)x_out;
  long long* c = (long long*)cycles;
  switch (mode) {
    case SUM4: probe_reduce_kernel<SUM4><<<1, CTA, 0, s>>>(xi, o, xo, c, iters); break;
    case ORROLL: probe_reduce_kernel<ORROLL><<<1, CTA, 0, s>>>(xi, o, xo, c, iters); break;
    case ORROLL_MAX: probe_reduce_kernel<ORROLL_MAX><<<1, CTA, 0, s>>>(xi, o, xo, c, iters); break;
    case SUM1: probe_reduce_kernel<SUM1><<<1, CTA, 0, s>>>(xi, o, xo, c, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
