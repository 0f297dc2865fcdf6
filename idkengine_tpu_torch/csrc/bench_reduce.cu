// Probe P3 for Hopper (sm_90a): a packet-wide reduce whose result steers
// the next step, in four forms.
//
// Replaces the TPU kernel of tools/bench_reduce.py:21 `make(mode)` (its
// pallas_call at :77). One TPU packet, (8, 128) lanes, becomes one CTA of
// 1024 threads, one lane each. Each of `iters` steps makes 8 threshold
// masks h[k] = x > k, reduces them over the CTA into 8 bits, adds the bits
// to an integer accumulator and feeds their low bit back into x
// (x += (bits & 1) * 1e-6), so step i + 1 cannot start before step i's
// reduce is known everywhere. The forms, each a different CTA-wide
// mechanism, each with one barrier a step:
//   sum4        what the TPU computes: four packed counts
//               c[j] = h[2j] + (h[2j+1] << 16), each summed over the CTA
//               (a warp's __reduce_add_sync of each, four words a warp into
//               the step's buffer, the barrier, four __reduce_add_syncs of
//               the 32 warps' words in every warp); bit k = its 16-bit half
//               > 0 (a half counts at most 1,024 lanes);
//   orroll      OR of m = OR h[k] << k over every lane (the TPU's lane and
//               sublane rolls): a warp __reduce_or_sync, one word a warp,
//               the barrier, then every warp __reduce_or_syncs the 32 words;
//   orroll_max  OR of m over row 0 (lanes 0-127, warps 0-3): only those 4
//               warps make m (the other lanes only feed back), one word
//               each, the barrier, one 16-byte load of the 4 words;
//   sum1        the integer sum of m over every lane (not an OR, as the
//               tool says): as orroll with __reduce_add_sync.
// The buffer is double-buffered by step parity: a thread rewrites it only
// after the next step's barrier, which every thread reaches after reading it.
//
// What bounds it: the instructions each lane needs (bench_reduce.
// needed_cycles_per_step, on the half-rate ALU pipe: the 8 compares and
// their packing, the feedback, sum4's test of its 8 halves): 304 cycles a
// step (orroll, sum1), 464 (sum4), 112 (orroll_max, 4 warps of masks); and
// each step's chain through the reduce, the barrier and the feedback,
// which no throughput bound sees. On an H100 (PERF.md) sum4 made eight
// __syncthreads_count votes, eight CTA barriers a step, in 1,388 cycles;
// with one barrier, the packing by compare and select (x > 2j + 1 implies
// x > 2j) and the halves tested by one add (below) it takes 761, and
// orroll_max 285 (from 517), held there by that chain: with only four
// warps making masks a step is latency, not work.
// The kernel reads clock64() around the loop and writes the cycles it took.
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
  __shared__ __align__(16) unsigned part[2][32 * 4];  // step parity, a warp's 1 or 4 words
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float x = x_in[t];
  unsigned acc = 0;
  __syncthreads();
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) {
    unsigned bits;
    unsigned* buf = part[i & 1];
    if (MODE == SUM4) {
      uint4 w;  // the warp's four packed counts; x > 2j + 1 implies x > 2j
      w.x = __reduce_add_sync(FULL_MASK, x > 1.0f ? 0x10001u : (x > 0.0f ? 1u : 0u));
      w.y = __reduce_add_sync(FULL_MASK, x > 3.0f ? 0x10001u : (x > 2.0f ? 1u : 0u));
      w.z = __reduce_add_sync(FULL_MASK, x > 5.0f ? 0x10001u : (x > 4.0f ? 1u : 0u));
      w.w = __reduce_add_sync(FULL_MASK, x > 7.0f ? 0x10001u : (x > 6.0f ? 1u : 0u));
      if (lane == 0) reinterpret_cast<uint4*>(buf)[warp] = w;
      __syncthreads();
      const uint4 v = reinterpret_cast<const uint4*>(buf)[lane];
      const unsigned s[4] = {__reduce_add_sync(FULL_MASK, v.x), __reduce_add_sync(FULL_MASK, v.y),
                             __reduce_add_sync(FULL_MASK, v.z), __reduce_add_sync(FULL_MASK, v.w)};
      // a half (at most 1,024) plus 0x7fff reaches bit 15 of the half exactly when it
      // is > 0, and the low half never carries: bit 0 / 16 of u = low / high half > 0
      unsigned u = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) u |= ((s[j] + 0x7fff7fffu) >> 15 & 0x10001u) << (2 * j);
      bits = (u | u >> 15) & 0xffu;  // children 2j + 1 from bit 16 + 2j to bit 2j + 1
    } else if (MODE == ORROLL_MAX) {
      if (warp < 4) {  // row 0: the only lanes whose masks the reduce reads
        unsigned m = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) m |= (unsigned)(x > (float)k) << k;
        const unsigned w = __reduce_or_sync(FULL_MASK, m);
        if (lane == 0) buf[warp] = w;
      }
      __syncthreads();
      const uint4 v = reinterpret_cast<const uint4*>(buf)[0];
      bits = v.x | v.y | v.z | v.w;
    } else {  // ORROLL, SUM1
      unsigned m = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) m |= (unsigned)(x > (float)k) << k;
      const unsigned w =
          MODE == ORROLL ? __reduce_or_sync(FULL_MASK, m) : __reduce_add_sync(FULL_MASK, m);
      if (lane == 0) buf[warp] = w;
      __syncthreads();
      bits = MODE == ORROLL ? __reduce_or_sync(FULL_MASK, buf[lane])
                            : __reduce_add_sync(FULL_MASK, buf[lane]);
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
