// Probe P2 for Hopper (sm_90a): a leaf's ray-triangle tests, as full
// Moller-Trumbore per triangle or as one bilinear form of ray features and
// triangle features.
//
// Replaces the two TPU kernels of tools/bench_mxu_leaf.py, `kernel_vpu`
// (:92) and `kernel_mxu` (:129), both reached through the pallas_call at
// :175. Each computes, for R rays (one (R/128, 128) packet) over V leaf
// visits of T triangles, the closest hit t_best and its slot vi * T + kk,
// and outputs t_best + slot (1e30 - 1 for a miss). One packet becomes one
// CTA: min(1024, R) threads, each holding rays t, t + threads, ... (one
// thread per ray, R/1024 rays a thread at the tool's R = 4096). The
// triangles are the same for every ray, so each CTA stages them into
// shared memory in chunks of visits (the tool's leaf table is 393 KB,
// more than a block's 227 KB) and every thread reads each triangle as a
// broadcast.
//
//   vpu_moller  leaf9 (V * nrow9, 128), 14 triangles of 9 floats (p0, e1,
//               e2) a row: the Moller-Trumbore test of :108-123 in its
//               order (built with -fmad=false), a hit taken where
//               0 <= u, 0 <= v, u + v <= 1, 0 < t < t_best; the plain
//               version repeats it, so t and slot agree bit for bit.
//   mxu_form    gfeat (V, 10, 128): per visit the 4T columns [det | u det
//               | v det | t det] of the triangles' features; each thread
//               makes its rays' features f = (d, o, o x d, 1) once and
//               evaluates the 10-term dot products with FFMA in f32
//               (a tensor-core mma form is later work), then the sign
//               checks of :154-159, t = t det / det, and the per-ray
//               argmin over the T triangles: the lowest triangle among
//               equal minima, taken where strictly below t_best (:159-166).
//               FFMA rounds once per term where the plain version rounds
//               twice, so the slots agree and t within `T_TOL` of
//               bench_mxu_leaf.py (1e-5 + 1e-5 |t|).
//
// What bounds it: operations, about 60 float operations a ray and
// triangle for vpu_moller and 95 for mxu_form (R T V = 3.4e7 pairs at the
// tool's sizes: 30 us and 48 us card-wide at 67 TFLOP/s, 4.0 and 6.3 ms on
// one SM); the bytes are 0.8 MB. On an H100 the two took 10.6 and 11.6 ms
// (PERF.md). The kernel reads clock64() around the visits.
//
// Outputs: out (R/128, 128) f32 = t_best + slot, t (R/128, 128) f32,
// slot (R/128, 128) i32 (-1 for a miss), cycles (1,) i64.

#include "probe_common.cuh"

namespace {

constexpr int TPR = 14;  // triangles in one leaf9 row
constexpr int LEAF_CHUNK = 16;  // visits staged at once: 16 x 3 rows x 512 B = 24 KB
constexpr int FEAT_CHUNK = 8;  // 8 x 10 rows x 512 B = 40 KB

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

template <int LPT>
__device__ __forceinline__ void load_rays(Ray (&r)[LPT], const float* const* planes) {
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int f = l * blockDim.x + threadIdx.x;
    r[l] = Ray{planes[0][f], planes[1][f], planes[2][f], planes[3][f], planes[4][f], planes[5][f]};
  }
}

template <int LPT>
__device__ __forceinline__ void store(float* out, float* t_out, int* slot_out,
                                      const float (&t_best)[LPT], const int (&slot)[LPT]) {
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int f = l * blockDim.x + threadIdx.x;
    out[f] = t_best[l] + (float)slot[l];
    t_out[f] = t_best[l];
    slot_out[f] = slot[l];
  }
}

struct Planes {
  const float* p[6];
};

template <int LPT>
__global__ void __launch_bounds__(CTA)
    probe_vpu_kernel(const float* __restrict__ leaf9, Planes rays, float* __restrict__ out,
                     float* __restrict__ t_out, int* __restrict__ slot_out,
                     long long* __restrict__ cycles, int n_tri, int n_visits) {
  __shared__ float leaf_s[LEAF_CHUNK * 3 * 128];
  const int nrow9 = (n_tri + TPR - 1) / TPR;
  Ray r[LPT];
  load_rays(r, rays.p);
  float t_best[LPT];
  int slot[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) t_best[l] = 1e30f, slot[l] = -1;
  __syncthreads();
  const long long c0 = clock64();
  for (int v0 = 0; v0 < n_visits; v0 += LEAF_CHUNK) {
    const int nv = min(LEAF_CHUNK, n_visits - v0);
    __syncthreads();  // the previous chunk is consumed
    for (int f = threadIdx.x; f < nv * nrow9 * 128; f += blockDim.x)
      leaf_s[f] = leaf9[(size_t)v0 * nrow9 * 128 + f];
    __syncthreads();
    for (int vc = 0; vc < nv; ++vc) {
      for (int kk = 0; kk < n_tri; ++kk) {
        const float* s = leaf_s + (vc * nrow9 + kk / TPR) * 128 + (kk % TPR) * 9;
        const float p0x = s[0], p0y = s[1], p0z = s[2];
        const float e1x = s[3], e1y = s[4], e1z = s[5];
        const float e2x = s[6], e2y = s[7], e2z = s[8];
        const int id = (v0 + vc) * n_tri + kk;
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          const Ray& q = r[l];
          const float pvx = q.dy * e2z - q.dz * e2y;
          const float pvy = q.dz * e2x - q.dx * e2z;
          const float pvz = q.dx * e2y - q.dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
          const float sx = q.ox - p0x, sy = q.oy - p0y, sz = q.oz - p0z;
          const float uu = (sx * pvx + sy * pvy + sz * pvz) * inv_det;
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float vv = (q.dx * qx + q.dy * qy + q.dz * qz) * inv_det;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = (uu >= 0.0f) & (uu <= 1.0f) & (vv >= 0.0f) & (uu + vv <= 1.0f) &
                          (tt > 0.0f) & (tt < t_best[l]);
          if (ok) t_best[l] = tt, slot[l] = id;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[0] = clock64() - c0;
  store(out, t_out, slot_out, t_best, slot);
}

template <int LPT>
__global__ void __launch_bounds__(CTA)
    probe_form_kernel(const float* __restrict__ gfeat, Planes rays, float* __restrict__ out,
                      float* __restrict__ t_out, int* __restrict__ slot_out,
                      long long* __restrict__ cycles, int n_tri, int n_visits) {
  __shared__ float feat_s[FEAT_CHUNK * 10 * 128];
  Ray r[LPT];
  load_rays(r, rays.p);
  float f[LPT][10];
  float t_best[LPT];
  int slot[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const Ray& q = r[l];
    f[l][0] = q.dx, f[l][1] = q.dy, f[l][2] = q.dz;
    f[l][3] = q.ox, f[l][4] = q.oy, f[l][5] = q.oz;
    f[l][6] = q.oy * q.dz - q.oz * q.dy;
    f[l][7] = q.oz * q.dx - q.ox * q.dz;
    f[l][8] = q.ox * q.dy - q.oy * q.dx;
    f[l][9] = 1.0f;
    t_best[l] = 1e30f, slot[l] = -1;
  }
  __syncthreads();
  const long long c0 = clock64();
  for (int v0 = 0; v0 < n_visits; v0 += FEAT_CHUNK) {
    const int nv = min(FEAT_CHUNK, n_visits - v0);
    __syncthreads();
    for (int i = threadIdx.x; i < nv * 10 * 128; i += blockDim.x)
      feat_s[i] = gfeat[(size_t)v0 * 10 * 128 + i];
    __syncthreads();
    for (int vc = 0; vc < nv; ++vc) {
      const float* g = feat_s + vc * 10 * 128;
      float tmin[LPT];
      int kmin[LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) tmin[l] = 1e30f, kmin[l] = 0;
      for (int kk = 0; kk < n_tri; ++kk) {
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          float form[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float* col = g + c * n_tri + kk;
            float a = f[l][0] * col[0];
#pragma unroll
            for (int j = 1; j < 10; ++j) a = __fmaf_rn(f[l][j], col[j * 128], a);
            form[c] = a;
          }
          const float det = form[0], udet = form[1], vdet = form[2], tdet = form[3];
          const bool pos = det > 0.0f;
          const bool ok = ((udet > 0.0f) == pos) & ((vdet > 0.0f) == pos) &
                          ((udet + vdet < det) == pos) & ((tdet > 0.0f) == pos) &
                          (fabsf(det) > 1e-12f);
          const float tt = ok ? tdet / det : 1e30f;
          if (tt < tmin[l]) tmin[l] = tt, kmin[l] = kk;
        }
      }
#pragma unroll
      for (int l = 0; l < LPT; ++l)
        if (tmin[l] < t_best[l]) t_best[l] = tmin[l], slot[l] = (v0 + vc) * n_tri + kmin[l];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[0] = clock64() - c0;
  store(out, t_out, slot_out, t_best, slot);
}

template <bool FORM>
int launch(const void* table, const void* const* p, int rows, int n_tri, int n_visits,
           cudaStream_t s) {
  if (rows < 1 || rows > 64 || (rows & (rows - 1)) != 0 || n_tri < 1 || n_tri > 32 ||
      n_visits < 1)
    return (int)cudaErrorInvalidValue;
  const Planes rays{{(const float*)p[0], (const float*)p[1], (const float*)p[2],
                     (const float*)p[3], (const float*)p[4], (const float*)p[5]}};
  const int lpt = rows > 8 ? rows / 8 : 1;
  const int threads = rows * 128 / lpt;
#define MXU_ARGS                                                                           \
  (const float*)table, rays, (float*)p[6], (float*)p[7], (int*)p[8], (long long*)p[9], n_tri, \
      n_visits
#define MXU_LAUNCH(L)                                                   \
  if (FORM)                                                            \
    probe_form_kernel<L><<<1, threads, 0, s>>>(MXU_ARGS);              \
  else                                                                 \
    probe_vpu_kernel<L><<<1, threads, 0, s>>>(MXU_ARGS);               \
  break;
  switch (lpt) {
    case 1: MXU_LAUNCH(1)
    case 2: MXU_LAUNCH(2)
    case 4: MXU_LAUNCH(4)
    case 8: MXU_LAUNCH(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MXU_LAUNCH
#undef MXU_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: leaf9 (n_visits * ceil(n_tri / 14) * 128,) f32 for idk_mxu_vpu,
// gfeat (n_visits * 10 * 128,) f32 for idk_mxu_form; ox, oy, oz, dx, dy, dz
// (rows*128,) f32; out, t (rows*128,) f32; slot (rows*128,) i32; cycles (1,)
// i64: device pointers. rows in {1, 2, 4, ..., 64}, 1 <= n_tri <= 32.
// Return cudaGetLastError().
int idk_mxu_vpu(const void* leaf9, const void* ox, const void* oy, const void* oz,
                const void* dx, const void* dy, const void* dz, void* out, void* t, void* slot,
                void* cycles, int rows, int n_tri, int n_visits, void* stream) {
  const void* p[10] = {ox, oy, oz, dx, dy, dz, out, t, slot, cycles};
  return launch<false>(leaf9, p, rows, n_tri, n_visits, (cudaStream_t)stream);
}

int idk_mxu_form(const void* gfeat, const void* ox, const void* oy, const void* oz,
                 const void* dx, const void* dy, const void* dz, void* out, void* t, void* slot,
                 void* cycles, int rows, int n_tri, int n_visits, void* stream) {
  const void* p[10] = {ox, oy, oz, dx, dy, dz, out, t, slot, cycles};
  return launch<true>(gfeat, p, rows, n_tri, n_visits, (cudaStream_t)stream);
}

}  // extern "C"
