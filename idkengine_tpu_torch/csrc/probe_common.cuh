// What the Hopper probes (csrc/bench_*.cu) share: the CTA shape that holds
// one TPU packet, and the float32 sum over a CTA in the one order that the
// plain PyTorch versions repeat (idkengine_tpu_torch/tools/_probe.py
// `cta_sum`): each thread adds its lanes t, t + 1024, ... in order; each
// warp folds its 32 partials with an xor butterfly (16, 8, 4, 2, 1: first
// half plus second half, and IEEE addition commutes, so every lane ends
// with the same bits); lane 0 of each warp writes one shared-memory slot;
// after the caller's barrier every warp folds the 32 slots the same way
// (cta_sum_read), or one warp adds them in registers in that order
// (slot_fold). Built with -fmad=false, so the order is the one written here.
#pragma once

#include <cuda_runtime.h>

constexpr int CTA = 1024;  // threads of one probe CTA
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_fold(float p) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) p = p + __shfl_xor_sync(FULL_MASK, p, off);
  return p;
}

template <int LPT>
__device__ __forceinline__ float thread_sum(const float (&v)[LPT]) {
  float p = v[0];
#pragma unroll
  for (int j = 1; j < LPT; ++j) p = p + v[j];
  return p;
}

// first half of a CTA sum: the warp's sum of the threads' partials p into
// slots[warp] (32 slots); the caller's __syncthreads() must follow
__device__ __forceinline__ void cta_sum_write(float p, float* slots) {
  p = warp_fold(p);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = p;
}

// second half, after the barrier: the CTA's sum, in every thread
__device__ __forceinline__ float cta_sum_read(const float* slots) {
  return warp_fold(slots[threadIdx.x & 31]);
}

// the second half in one warp's registers, no shuffles: the 32 slots (16-byte
// aligned) read with broadcast 16-byte loads and added in the butterfly's
// order (slot j plus slot j + 16, then j + 8, ...), so the sum has the bits
// of cta_sum_read's, in every lane
__device__ __forceinline__ float slot_fold(const float* slots) {
  float v[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 f = reinterpret_cast<const float4*>(slots)[q];
    v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
  }
  // each round's bound spelled out: a loop bounded by the round's width left
  // v[] in local memory
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = v[j] + v[j + 16];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = v[j] + v[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j + 4];
  v[0] = v[0] + v[2], v[1] = v[1] + v[3];
  return v[0] + v[1];
}
