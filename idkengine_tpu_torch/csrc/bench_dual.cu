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
// The sum is the CTA sum of probe_common.cuh, in its order: each warp folds
// its threads' partials with shuffles; then ONE warp reads the 32 warps'
// slots and adds them in registers in the butterfly's order (slot_fold),
// where every warp used to fold them again. That warp takes turns (warp
// q & 31 for step q): only the row needs the sum, and a row's step is
// (s & 1) + 1 added mod 64, so each warp sums the advances of its steps and
// the rows are added up after the loop, bit for bit the plain version's.
// So no warp's next step waits for a sum, where the TPU's one issuer takes
// every step's; in a traversal every lane needs the reduce to pick its next
// node, and the deferred form that waits every step is the one that carries
// over (PERF.md).
// The rows are written out: nothing else reads them, and nvcc would delete
// the reduce that only they consume.
//   same step (d1, dd2, dd4): slots double-buffered by step parity, one
//     __syncthreads() a step between the stores and that step's fold;
//   deferred (dp1, dpd2): a split-phase barrier. A step decays, sums and
//     stores its slots, and each warp's lane 0 arrives (after a __syncwarp)
//     on the step's mbarrier (32 arrivals a phase); the next step waits
//     for that phase right before its warp folds the slots. Steps run in
//     groups (pipe: four for one chain, two for two): the group's decays
//     and sums, their shuffle rounds interleaved, its stores and arrivals,
//     then its waits and folds, each for the step before its own (the
//     chain's planes do not depend on its sums). A warp that reads no
//     slots waits only for every SPARSE-th step: it needs the phases only
//     to know that the slots it overwrites were read.
//   Why that cannot hang or read a stale slot: a warp that starts a group
//   at step i0 has waited for step w >= i0 - SPARSE - 1, so every warp has
//   arrived for every step <= w, and a warp arrives for a step only after
//   reading the slots of its previous group's steps (<= the arriving group's
//   first step - 2). So a step s < i0 + pipe arrives on a barrier whose
//   previous phase (step s - NBAR) is complete, as NBAR >= SPARSE + pipe;
//   a waiter's barrier is never a phase past the one it waits for (its own
//   warp has not arrived for step q + NBAR), so the parity (q / NBAR) & 1 is
//   unambiguous; and ring position s % RING held step s - RING, read before
//   step w arrived, as RING >= SPARSE + 2 pipe + 1.
//
// What bounds it: each step's chain through the slots, not its work. What
// the function needs a chain and step (bench_dual.needed_cycles_per_step,
// bound by the shuffles): 3 adds a thread, a 5-round
// fold a warp (160 warp shuffles: 160 cycles at one shuffle a clock an
// SM), one fold of the slots and the decay: 165 cycles. A fold alone, with
// no store, reaches 176 cycles a step on an H100 (PERF.md); with each
// step's stores and arrivals dp1 takes 253, with the turn's fold 308, with
// the waits 419, and the same-step forms add the barrier and the fold to
// every step's chain (d1 509). Measured and not kept (PERF.md): the
// slots folded with shuffles, always by warp 0, every thread arriving,
// test_wait in place of try_wait, other group sizes, waits every 1, 4, 8
// or 16 steps, and the partials stored transposed for one warp to sum them all
// (no warp shuffles but 32 loads a lane in that warp). The kernel reads
// clock64() around the loop.
//
// Outputs: out (32, 128) f32 = acc_0 + acc_1 + ... (the tool's output),
// rows (n,) int32 = each chain's final row, cycles (1,) int64.

#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

constexpr int LPT = 4;  // lanes a thread: 32 x 128 over 1024 threads
constexpr int WARPS = CTA / 32;
// the deferred forms: pipe(NCH) steps' folds run together (the fastest
// measured: 4 for one chain, 2 for two); a warp that reads no slots waits
// for every SPARSE-th step only (the fastest measured: 32); step j arrives
// on mbarrier j % NBAR and stores its slots in ring position j % RING
constexpr int SPARSE = 32, MAX_PIPE = 4;
__host__ __device__ constexpr int pipe(int nch) { return nch == 1 ? 4 : 2; }
constexpr int NBAR = 64;  // >= SPARSE + pipe
constexpr int RING = 64;  // >= SPARSE + 2 pipe + 1
static_assert(NBAR >= SPARSE + MAX_PIPE && RING >= SPARSE + 2 * MAX_PIPE + 1, "see the header");

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// the warp's share of the rows' advance from one step's slots
template <int NCH>
__device__ __forceinline__ void advance(unsigned (&adv)[NCH], const float* slots) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) adv[k] += ((unsigned)(int)slot_fold(slots + k * 32) & 1u) + 1u;
}

// N deferred steps from step i0: each decays and sums every chain, the N x NCH
// warp folds run round by round together, the slots are stored and the steps
// arrived at; then each step waits for the step before and that step's warp
// folds its slots
template <int N, int NCH>
__device__ __forceinline__ void deferred_steps(float (&acc)[NCH][LPT], unsigned (&adv)[NCH],
                                               float (*slots)[NCH][32], unsigned long long* bar,
                                               int i0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float p[N][NCH];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) acc[k][j] = acc[k][j] * 0.99999f;
      p[n][k] = thread_sum(acc[k]);
    }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)  // warp_fold's rounds, interleaved
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int k = 0; k < NCH; ++k) p[n][k] = p[n][k] + __shfl_xor_sync(FULL_MASK, p[n][k], off);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int k = 0; k < NCH; ++k) slots[(i0 + n) % RING][k][warp] = p[n][k];  // every lane alike
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) mbar_arrive(&bar[(i0 + n) % NBAR]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int q = i0 + n - 1;
    if (q < 0) continue;
    const bool reads = warp == (q & 31);
    if (reads || q % SPARSE == SPARSE - 1) mbar_wait(&bar[q % NBAR], (q / NBAR) & 1);
    if (reads) advance(adv, &slots[q % RING][0][0]);
  }
}

template <int NCH, bool DEFER>
__global__ void __launch_bounds__(CTA)
    probe_dual_kernel(const float* __restrict__ x_in, float* __restrict__ out,
                      int* __restrict__ rows_out, long long* __restrict__ cycles, int iters) {
  __shared__ __align__(16) float slots[DEFER ? RING : 2][NCH][32];
  __shared__ unsigned long long bar[NBAR];
  __shared__ unsigned adv_s[NCH][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float acc[NCH][LPT];
  unsigned adv[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float scale = (float)(1.0 + 0.1 * k);  // the tool's Python float, rounded once
    adv[k] = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[k][j] = x_in[j * CTA + t] * scale;  // x * 1 is x
  }
  if (DEFER && t < NBAR) mbar_init(&bar[t], WARPS);
  __syncthreads();
  const long long c0 = clock64();
  if constexpr (DEFER) {
    constexpr int P = pipe(NCH);
    static_assert(P <= MAX_PIPE, "see NBAR and RING");
    int i = 0;
    for (; i < iters % P; ++i) deferred_steps<1>(acc, adv, slots, bar, i);
    for (; i < iters; i += P) deferred_steps<P>(acc, adv, slots, bar, i);
  } else {
    for (int i = 0; i < iters; ++i) {
      float* buf = &slots[i & 1][0][0];
#pragma unroll
      for (int k = 0; k < NCH; ++k) cta_sum_write(thread_sum(acc[k]), buf + k * 32);
      __syncthreads();
      if (warp == (i & 31)) advance(adv, buf);
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[k][j] = acc[k][j] * 0.99999f;
    }
  }
  __syncthreads();
  if (t == 0) cycles[0] = clock64() - c0;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) adv_s[k][warp] = adv[k];
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    float o = acc[0][j];
#pragma unroll
    for (int k = 1; k < NCH; ++k) o = o + acc[k][j];
    out[j * CTA + t] = o;
  }
  __syncthreads();
  if (t < NCH) {  // row_k: 1 + k, plus every step's advance (the deferred first step's is 1)
    unsigned row = 1u + t + (DEFER ? 1u : 0u);
    for (int w = 0; w < WARPS; ++w) row += adv_s[t][w];
    rows_out[t] = (int)(row & 63u);
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
