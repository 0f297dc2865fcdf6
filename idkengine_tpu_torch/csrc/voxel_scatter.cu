// Dense per-cell max-scatter for Hopper (sm_90a): the voxelizer's
// imageAtomicMax, one thread per update.
//
// Replaces TPU kernel K3, idkengine_tpu/ops/voxel_scatter.py:73
// `_make_kernel`, reached from `scatter_max_dense` (its pallas_call at :220).
// That kernel sorts the updates by cell, keeps each cell's max with a
// segmented scan and lands the deduplicated stream in dense blocks with
// one-hot matrix products, because the TPU has no atomics. Hopper has them,
// so none of that design is carried over.
//
// Contract: out (C, n_cells) f32 is zero-filled by the wrapper; each update i
// with 0 <= cell[i] < n_cells raises out[c, cell[i]] to vals[c, i] for every
// channel c; other cells are dropped. Non-negative floats order like their
// int bit patterns, so an integer atomicMax on the bits gives the exact max
// whatever order the updates land in. Against the zero fill any negative
// value (sign bit set, a negative int) loses, as it does in a float max over
// a zero-initialised grid, and -0.0 lands as +0.0. With bf16 each value is
// rounded to bfloat16 (nearest even) before the max; rounding is monotone,
// so this equals rounding the max.
//
// What bounds it: bytes. At the voxelizer's shapes (2^20 updates, C = 4,
// n_cells = 256^3) the function reads about 21 MB of updates and writes the
// 268 MB dense grid (the wrapper's zero fill; the kernel touches only the
// cells it raises), so about 86 us at 3.35 TB/s. The updates are read
// coalesced, channel by channel. What a later design would attack is atomic
// contention on hot voxels: many samples of one triangle fall into one cell,
// and their atomics to one address serialise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SCATTER_BLOCK 256

namespace {

__global__ void scatter_max_kernel(const int* __restrict__ cell,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, int n, int nch,
                                   long long n_cells, int bf16) {
  const long long i = (long long)blockIdx.x * SCATTER_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int c = __ldg(cell + i);
  if (c < 0 || (long long)c >= n_cells) return;
  for (int ch = 0; ch < nch; ++ch) {
    float v = __ldg(vals + (long long)ch * n + i);
    if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    const int bits = __float_as_int(v);
    // the cell starts at +0.0 (bits 0): a value with bits <= 0 cannot raise it
    if (bits > 0) atomicMax((int*)(out + (long long)ch * n_cells + c), bits);
  }
}

}  // namespace

extern "C" {

// cell (n,) i32, vals (nch, n) f32 and out (nch, n_cells) f32 are device
// pointers; out must be zero-filled. Returns cudaGetLastError().
int idk_scatter_max(const void* cell, const void* vals, void* out, int n, int nch,
                    long long n_cells, int bf16, void* stream) {
  const dim3 grid((unsigned)((n + SCATTER_BLOCK - 1) / SCATTER_BLOCK));
  scatter_max_kernel<<<grid, SCATTER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)cell, (const float*)vals, (float*)out, n, nch, n_cells, bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
