// Batched balanced log-domain Sinkhorn with a per-pair eps schedule.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_sinkhorn.py
// (_sinkhorn_kernel).  One warp solves one pair: the cost matrix (at most
// 32 x 32) sits in shared memory, lane i owns row i for the f update and
// column i for the g update, and the whole annealing loop runs on chip.  Each
// pair loops for its own schedule length, so no batch-wide trip count is
// needed.  The loop is a chain of dependent exp/log rounds; accurate expf/logf
// are used (no fast-math) because ~70 rounds compound.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxAtoms = 32;
constexpr int kLd = kMaxAtoms + 1;     // odd row pitch: rows and columns both conflict-free
constexpr int kWarpsPerBlock = 4;

// -eps * logsumexp_k(h[k] - c[k * stride] / eps), max-shifted.
__device__ __forceinline__ float softmin(const float* c, int stride, const float* h,
                                         int count, float eps, float inv_eps) {
  float mx = -INFINITY;
#pragma unroll 4
  for (int k = 0; k < count; ++k) mx = fmaxf(mx, h[k] - c[k * stride] * inv_eps);
  float sum = 0.f;
#pragma unroll 4
  for (int k = 0; k < count; ++k) sum += expf(h[k] - c[k * stride] * inv_eps - mx);
  return -eps * (logf(sum) + mx);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sinkhorn_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                const float* __restrict__ log_b, const float* __restrict__ diam,
                float* __restrict__ f_out, float* __restrict__ g_out, int bsz, int n,
                int m, float blur, float log_scaling, int max_iters) {
  __shared__ float s_cost[kWarpsPerBlock][kMaxAtoms * kLd];
  __shared__ float s_hb[kWarpsPerBlock][kMaxAtoms];   // log_b + g / eps, by column
  __shared__ float s_ha[kWarpsPerBlock][kMaxAtoms];   // log_a + f / eps, by row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + warp;
  if (pair >= bsz) return;             // warps are independent: no block barrier below
  float* c = s_cost[warp];
  float* hb = s_hb[warp];
  float* ha = s_ha[warp];

  const float* cg = cost + (size_t)pair * n * m;
  for (int idx = lane; idx < n * m; idx += 32) c[(idx / m) * kLd + (idx % m)] = cg[idx];
  const bool row = lane < n, col = lane < m;
  const float la = row ? log_a[(size_t)pair * n + lane] : 0.f;
  const float lb = col ? log_b[(size_t)pair * m + lane] : 0.f;

  // schedule [d, d, d*s, d*s^2, ..., blur]: length ceil(log(blur/d)/log s) + 2
  const float d = diam[pair];
  const float ratio = logf(blur / fmaxf(d, 1e-30f)) / log_scaling;
  const float lane_iters = ceilf(fmaxf(ratio, 0.f)) + 2.f;
  const int iters = (int)fminf(lane_iters, (float)max_iters);
  const float d_floor = fmaxf(d, 1e-12f);
  auto eps_at = [&](int i) {
    const float k = (float)max(i - 1, 0);
    return ((float)i >= lane_iters - 1.f) ? blur : d_floor * expf(k * log_scaling);
  };

  float eps = eps_at(0), inv = 1.f / eps;
  if (col) hb[lane] = lb;
  if (row) ha[lane] = la;
  __syncwarp();
  float f = row ? softmin(c + lane * kLd, 1, hb, m, eps, inv) : 0.f;
  float g = col ? softmin(c + lane, kLd, ha, n, eps, inv) : 0.f;

  for (int i = 0; i < iters; ++i) {
    eps = eps_at(i);
    inv = 1.f / eps;
    __syncwarp();                      // every lane is done reading hb / ha
    if (col) hb[lane] = lb + g * inv;  // Jacobi: both updates read the old f and g
    if (row) ha[lane] = la + f * inv;
    __syncwarp();
    const float ft = row ? softmin(c + lane * kLd, 1, hb, m, eps, inv) : 0.f;
    const float gt = col ? softmin(c + lane, kLd, ha, n, eps, inv) : 0.f;
    f = 0.5f * (f + ft);
    g = 0.5f * (g + gt);
  }

  // final extrapolation at eps = blur, again from the loop's f and g
  inv = 1.f / blur;
  __syncwarp();
  if (col) hb[lane] = lb + g / blur;
  if (row) ha[lane] = la + f / blur;
  __syncwarp();
  if (row) f_out[(size_t)pair * n + lane] = softmin(c + lane * kLd, 1, hb, m, blur, inv);
  if (col) g_out[(size_t)pair * m + lane] = softmin(c + lane, kLd, ha, n, blur, inv);
}

}  // namespace

extern "C" int aspire_sinkhorn_f32(const float* cost, const float* log_a, const float* log_b,
                                   const float* diam, float* f, float* g, int bsz, int n,
                                   int m, float blur, float log_scaling, int max_iters,
                                   void* stream) {
  if (n > kMaxAtoms || m > kMaxAtoms || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (bsz + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sinkhorn_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      cost, log_a, log_b, diam, f, g, bsz, n, m, blur, log_scaling, max_iters);
  return (int)cudaGetLastError();
}

extern "C" const char* aspire_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
