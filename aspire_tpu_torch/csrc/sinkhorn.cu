// Batched balanced log-domain Sinkhorn with a per-pair eps schedule.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_sinkhorn.py
// (_sinkhorn_kernel).  The schedule [d, d, d*s, ..., blur] runs per pair for
// its own length, so no batch-wide trip count is needed: symmetric Jacobi
// updates with 0.5 averaging, log-weights floored at -1e5 by the caller, then
// (extrapolate = 1) the final step at eps = blur from the loop's f and g.  With
// extrapolate = 0 the kernel writes the loop's own f and g, before that step:
// the training loss takes the step itself, in PyTorch, where gradients flow.
//
// What bounds it: the rounds.  A pair is a few hundred exponentials a round,
// about 85 rounds long, each round's softmins needing the last round's
// potentials, so at the batches of a request (16 pairs) the time is the
// dependent chain of one round times the rounds, not the card's rate of
// exponentials (that governs from about a thousand pairs up).
//
// Pairs of at most 32 x 32 (every serving, training and query shape):
// sinkhorn_small_kernel, one block a pair, kLanes = 4 threads a softmin:
// threads [0, 4 side) the rows, [4 side, 8 side) the columns (at 20 x 20 five
// warps).  Thread (atom, sub) keeps in registers the cost of its row (column)
// at columns (rows) sub, sub + 4, ... -- kPer values -- so a round reads only
// the h of the other side from shared memory, laid out lane-major so that
// those kPer values are two 16-byte loads.  A softmin is the thread's kPer
// terms, two butterfly shuffles for the max, the base-2 exponentials on the
// special-function unit (ex2.approx / lg2.approx, log2(e) folded into 1/eps),
// two butterfly shuffles for the sum: every thread of an atom ends with the same
// sum (a + b == b + a) and all four store h.  h is double-buffered, so a round
// takes one block barrier; log2(e) / eps of every round and its reciprocal
// are tabulated once.  The chain of a round: store, barrier, loads, an FMA,
// kPer max steps, two shuffles, the exponentials, kPer adds, two shuffles, a
// log, the division (three FMAs, `div_by`), an FMA.
//
// Every kernel here takes a potential back from its scaled form by dividing
// by the factor that scaled the softmin's terms (log2(e) / eps, or 1 / eps),
// never by multiplying by eps or by a rounded 1 / factor: the rounding of
// either is common to every potential, and at blur 0.05 a factor off by ~5e-8
// moved OT scores near 78 by 5e-3 to 1.6e-2 (PERF.md); h is built from the
// potentials with that same factor, the final step's included.
//
// Variants measured on the H100 and not kept (PERF.md, section 6; B = 16): one
// thread doing its atom's row and column softmins (ptxas put the two chains one
// after the other: 14% slower), one of four threads storing h (15% slower), eps
// and 1/eps by expf and a division in each round (5% slower, though off the
// chain), with that thread 2 or 8 threads an atom (6% and 27% slower than 4),
// (max, sum) pairs merged in the butterfly (1% slower, 29% at B = 2048), the
// loop unrolled by two (9% slower); the accurate exp2f / log2f and 8 threads a
// softmin in benchmarks/torch_sinkhorn_ablation.py.  ex2.approx holds the plain
// version to 3e-4 where 1e-3 is allowed (chip_smoke.py).
//
// Wider pairs (up to 1024 atoms a side): sinkhorn_wide_kernel, one warp a
// pair, the cost in shared memory with an odd row pitch (rows and columns both
// conflict-free), lane l owning rows and columns l, l + 32, ... (kPer of each, a
// template: 2, 4, ... 32), potentials in registers (in shared memory they made
// the rounds 43% slower: the reads join each round's chain), accurate expf /
// logf.  Pairs a block: four, or as many as fit 227 KB.
//
// Every other pair (a side past 1024 atoms, or a cost past one block's shared
// memory: 240 x 240 and up, a query against a full-text document):
// sinkhorn_large_kernel, one block of 1024 threads a pair.  The cost stays in
// global memory, where L2 holds it, and is read at every half-round: the rows
// of cost for f, the rows of its transpose (a copy the wrapper makes) for g,
// so that both softmins read contiguous memory.  One warp a softmin, each
// lane an online (max, sum) of base-2 exponentials (ex2.approx / lg2.approx,
// log2(e) folded into 1 / eps, as the small kernel, and the sum's log divided
// by that same factor) merged by butterfly shuffles; f, g and h of both sides in shared memory, 8 (n + m) bytes (so
// n + m up to 29,056 atoms).  Same schedule, trip count and rounds as the
// other two.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 4;              // threads an atom in the small kernel
constexpr int kSmallSide = 32;         // the small kernel's largest side
constexpr int kTable = 128;            // rounds whose eps the small kernel tabulates
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxPairsPerBlock = 4;   // the wide kernel's warps a block
constexpr int kMaxSmem = 232448;       // shared memory one block can have

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x / y for a divisor that many divisions share, from r = 1 / y (rounded):
// the product x r corrected once by its residual x - (x r) y, which an FMA
// takes exactly, so the quotient is within an ulp of x / y (most often its
// correct rounding) and its error is its own, not r's, which would be common
// to every quotient.  Three FMA-pipe instructions in place of a division's
// reciprocal, refinement and range check.
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// The schedule of one pair: eps_at(i) for round i, and its length.
struct Schedule {
  float blur, log_scaling, d_floor, lane_iters;
  int iters;
  __device__ Schedule(float d, float blur_, float log_scaling_, int max_iters)
      : blur(blur_), log_scaling(log_scaling_), d_floor(fmaxf(d, 1e-12f)) {
    // [d, d, d*s, d*s^2, ..., blur]: length ceil(log(blur/d)/log s) + 2
    const float ratio = logf(blur / fmaxf(d, 1e-30f)) / log_scaling;
    lane_iters = ceilf(fmaxf(ratio, 0.f)) + 2.f;
    iters = (int)fminf(lane_iters, (float)max_iters);
  }
  __device__ float eps_at(int i) const {
    const float k = (float)max(i - 1, 0);
    return ((float)i >= lane_iters - 1.f) ? blur : d_floor * expf(k * log_scaling);
  }
};

// ---------------------------------------------------------------- small pairs
constexpr int kSlots = kSmallSide / kLanes;   // values of h one thread reads a round

// where atom j's h lies in its side's buffer: lane-major, so that thread `sub`
// finds its atoms j = sub, sub + kLanes, ... side by side (two 16-byte loads)
__device__ __forceinline__ int hpos(int j) { return (j % kLanes) * kSlots + j / kLanes; }

template <int kPer>   // cost values a thread holds: ceil(side / kLanes)
__global__ void __launch_bounds__(2 * kLanes * kSmallSide)
sinkhorn_small_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                      const float* __restrict__ log_b, const float* __restrict__ diam,
                      float* __restrict__ f_out, float* __restrict__ g_out, int n, int m,
                      float blur, float log_scaling, int max_iters, int extrapolate) {
  // log2(e) * h, h = log-weight + potential / eps: [buffer][a by row, b by column][hpos];
  // atoms past n (m) stay -inf, so the terms they give vanish
  __shared__ __align__(16) float h2[2][2][kSmallSide];
  // log2(e) / eps of the first kTable rounds and its reciprocal, computed once
  __shared__ float table[2][kTable];
  const int pair = blockIdx.x;
  // threads [0, half) own the rows, [half, 2 half) the columns
  const int half = kLanes * (n > m ? n : m);
  const bool by_col = threadIdx.x >= half;
  const int t = by_col ? threadIdx.x - half : threadIdx.x;
  const int atom = t / kLanes, sub = t % kLanes;
  const int other = by_col ? n : m;          // the side a softmin sums over
  const bool live = atom < (by_col ? m : n);
  const int mine = by_col ? 1 : 0;           // the side this thread publishes
  const float* cg = cost + (size_t)pair * n * m;
  float c[kPer];                             // row: c[atom][o], column: c[o][atom]
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int o = sub + kLanes * k;
    c[k] = live && o < other ? cg[by_col ? o * m + atom : atom * m + o] : 0.f;
  }
  const float lw2 = live ? (by_col ? log_b[(size_t)pair * m + atom]
                                   : log_a[(size_t)pair * n + atom]) * kLog2e : 0.f;
  for (int e = threadIdx.x; e < 2 * kSmallSide; e += blockDim.x) {
    const int side = e / kSmallSide, p = e % kSmallSide;
    const int j = p / kSlots + kLanes * (p % kSlots);   // hpos(j) == p
    const int len = side == 0 ? n : m;
    const float* lw = side == 0 ? log_a + (size_t)pair * n : log_b + (size_t)pair * m;
    h2[0][side][p] = j < len ? lw[j] * kLog2e : -INFINITY;
    h2[1][side][p] = j < len ? 0.f : -INFINITY;
  }
  const Schedule sched(diam[pair], blur, log_scaling, max_iters);
  for (int i = threadIdx.x; i < min(sched.iters + 1, kTable); i += blockDim.x) {
    const float inv2 = (1.f / sched.eps_at(i)) * kLog2e;
    table[0][i] = inv2;
    table[1][i] = 1.f / inv2;
  }
  auto inv2_of = [&](int i, float& inv2, float& r) {
    if (i < kTable) {
      inv2 = table[0][i];
      r = table[1][i];
    } else {
      inv2 = (1.f / sched.eps_at(i)) * kLog2e;
      r = 1.f / inv2;
    }
  };

  // -eps ln sum_o exp(h_b[o] - c[o] / eps) over the other side, from buffer b,
  // at inv2 = log2(e) / eps (r = 1 / inv2): -log2(sum_o 2^(h2_b[o] - c[o]
  // inv2)) / inv2
  auto softmin = [&](int b, float inv2, float r) {
    float hv[4 * ((kPer + 3) / 4)];
    const float4* hp = reinterpret_cast<const float4*>(&h2[b][1 - mine][sub * kSlots]);
#pragma unroll
    for (int q = 0; q < (kPer + 3) / 4; ++q) {
      const float4 v = hp[q];
      hv[4 * q] = v.x;
      hv[4 * q + 1] = v.y;
      hv[4 * q + 2] = v.z;
      hv[4 * q + 3] = v.w;
    }
    float tt[kPer], mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      tt[k] = fmaf(-c[k], inv2, hv[k]);
      mx = fmaxf(mx, tt[k]);
    }
#pragma unroll
    for (int w = 1; w < kLanes; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) sum += ex2(tt[k] - mx);
#pragma unroll
    for (int w = 1; w < kLanes; w <<= 1) sum += __shfl_xor_sync(kFull, sum, w);
    return div_by(-(lg2(sum) + mx), inv2, r);
  };
  int buf = 0;
  // h of the next round into the other buffer, then the round's one barrier
  // (the four threads of an atom hold the same value and all store it)
  auto publish = [&](float h) {
    buf ^= 1;
    if (live) h2[buf][mine][hpos(atom)] = h;
    __syncthreads();
  };

  __syncthreads();
  float inv2, r;
  inv2_of(0, inv2, r);
  float f = softmin(0, inv2, r);             // this thread's potential: f of its row or g
  for (int it = 0; it < sched.iters; ++it) {
    float inv2_next, r_next;
    inv2_of(it + 1, inv2_next, r_next);      // read ahead, off the chain
    publish(fmaf(f, inv2, lw2));             // Jacobi: every softmin reads the old f and g
    f = 0.5f * (f + softmin(buf, inv2, r));
    inv2 = inv2_next;
    r = r_next;
  }
  if (extrapolate) {                         // at eps = blur, again from the loop's f and g
    inv2 = (1.f / blur) * kLog2e;
    publish(fmaf(f, inv2, lw2));
    f = softmin(buf, inv2, 1.f / inv2);
  }
  if (live && sub == 0) (by_col ? g_out + (size_t)pair * m : f_out + (size_t)pair * n)[atom] = f;
}

template <int kPer>
int launch_small(const float* cost, const float* log_a, const float* log_b, const float* diam,
                 float* f, float* g, int bsz, int n, int m, float blur, float log_scaling,
                 int max_iters, int extrapolate, cudaStream_t stream) {
  const int side = n > m ? n : m;
  const int threads = (2 * kLanes * side + 31) / 32 * 32;   // whole warps for the shuffles
  sinkhorn_small_kernel<kPer><<<bsz, threads, 0, stream>>>(
      cost, log_a, log_b, diam, f, g, n, m, blur, log_scaling, max_iters, extrapolate);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- wide pairs
// floats a pair keeps in shared memory: cost [n][m | 1], then ha [n], hb [m]
__host__ __device__ inline int pair_floats(int n, int m) { return n * (m | 1) + n + m; }

// -eps * logsumexp_k(h[k] - c[k * stride] / eps), max-shifted, as
// -logsumexp_k(h[k] - c[k * stride] inv_eps) / inv_eps (r = 1 / inv_eps)
__device__ __forceinline__ float softmin(const float* c, int stride, const float* h,
                                         int count, float inv_eps, float r) {
  float mx = -INFINITY;
#pragma unroll 4
  for (int k = 0; k < count; ++k) mx = fmaxf(mx, h[k] - c[k * stride] * inv_eps);
  float sum = 0.f;
#pragma unroll 4
  for (int k = 0; k < count; ++k) sum += expf(h[k] - c[k * stride] * inv_eps - mx);
  return div_by(-(logf(sum) + mx), inv_eps, r);
}

template <int kPer>
__global__ void __launch_bounds__(kMaxPairsPerBlock * 32)
sinkhorn_wide_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                     const float* __restrict__ log_b, const float* __restrict__ diam,
                     float* __restrict__ f_out, float* __restrict__ g_out, int bsz, int n,
                     int m, float blur, float log_scaling, int max_iters, int extrapolate) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= bsz) return;             // warps are independent: no block barrier below
  const int ld = m | 1;
  float* c = smem + (size_t)warp * pair_floats(n, m);
  float* ha = c + n * ld;              // log_a + f / eps, by row
  float* hb = ha + n;                  // log_b + g / eps, by column

  const float* cg = cost + (size_t)pair * n * m;
  for (int idx = lane; idx < n * m; idx += 32) c[(idx / m) * ld + (idx % m)] = cg[idx];
  // atom r of this lane: row / column lane + 32 r
  float la[kPer], lb[kPer], f[kPer], g[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + 32 * r;
    la[r] = i < n ? log_a[(size_t)pair * n + i] : 0.f;
    lb[r] = i < m ? log_b[(size_t)pair * m + i] : 0.f;
  }
  const Schedule sched(diam[pair], blur, log_scaling, max_iters);
  // ha / hb from f / g at the 1 / eps that the round's softmins take
  auto write_h = [&](float inv) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = lane + 32 * r;
      if (i < m) hb[i] = lb[r] + g[r] * inv;
      if (i < n) ha[i] = la[r] + f[r] * inv;
    }
  };

  float inv = 1.f / sched.eps_at(0), r_inv = 1.f / inv;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + 32 * r;
    if (i < m) hb[i] = lb[r];
    if (i < n) ha[i] = la[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + 32 * r;
    f[r] = i < n ? softmin(c + i * ld, 1, hb, m, inv, r_inv) : 0.f;
    g[r] = i < m ? softmin(c + i, ld, ha, n, inv, r_inv) : 0.f;
  }

  for (int it = 0; it < sched.iters; ++it) {
    inv = 1.f / sched.eps_at(it);
    r_inv = 1.f / inv;
    __syncwarp();                      // every lane is done reading hb / ha
    write_h(inv);                      // Jacobi: both updates read the old f and g
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = lane + 32 * r;
      const float ft = i < n ? softmin(c + i * ld, 1, hb, m, inv, r_inv) : 0.f;
      const float gt = i < m ? softmin(c + i, ld, ha, n, inv, r_inv) : 0.f;
      f[r] = 0.5f * (f[r] + ft);
      g[r] = 0.5f * (g[r] + gt);
    }
  }

  if (extrapolate) {                   // at eps = blur, again from the loop's f and g
    inv = 1.f / blur;
    r_inv = 1.f / inv;
    __syncwarp();
    write_h(inv);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = lane + 32 * r;
    if (i < n)
      f_out[(size_t)pair * n + i] =
          extrapolate ? softmin(c + i * ld, 1, hb, m, inv, r_inv) : f[r];
    if (i < m)
      g_out[(size_t)pair * m + i] = extrapolate ? softmin(c + i, ld, ha, n, inv, r_inv) : g[r];
  }
}

template <int kPer>
int launch_wide(const float* cost, const float* log_a, const float* log_b, const float* diam,
                float* f, float* g, int bsz, int n, int m, float blur, float log_scaling,
                int max_iters, int extrapolate, cudaStream_t stream) {
  const long long per_pair = (long long)pair_floats(n, m) * (long long)sizeof(float);
  if (per_pair > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int fit = (int)(kMaxSmem / per_pair);
  const int pairs = fit < kMaxPairsPerBlock ? fit : kMaxPairsPerBlock;
  const int smem = (int)(pairs * per_pair);
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_wide_kernel<kPer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (bsz + pairs - 1) / pairs;
  sinkhorn_wide_kernel<kPer><<<blocks, pairs * 32, smem, stream>>>(
      cost, log_a, log_b, diam, f, g, bsz, n, m, blur, log_scaling, max_iters, extrapolate);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- large pairs
constexpr int kLargeThreads = 1024;

// -log2 sum_k 2^(h2[k] - c[k] inv2) / inv2 over `count` terms, by one warp:
// lane l an online (max, sum) over k = l, l + 32, ..., then a butterfly merge
// (every lane ends with the same value).  Dividing by the inv2 that scaled the
// terms, rather than multiplying by eps ln 2, keeps the rounding of inv2 from
// scaling every potential alike: at blur 0.05 that common factor (5e-8) put
// the OT scores of a 300 x 1,200 pair 6e-3 from f64, 6x the PyTorch solver.
__device__ __forceinline__ float warp_softmin(const float* __restrict__ c, const float* h2,
                                              int count, float inv2, int lane) {
  float mx = -INFINITY, sum = 0.f;
  for (int k = lane; k < count; k += 32) {
    const float x = fmaf(-c[k], inv2, h2[k]);
    if (x > mx) {
      sum = sum * ex2(mx - x) + 1.f;
      mx = x;
    } else {
      sum += ex2(x - mx);
    }
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, mx, w), s2 = __shfl_xor_sync(kFull, sum, w);
    const float top = fmaxf(mx, m2);   // a lane without terms holds (-inf, 0)
    sum = (mx == top ? sum : sum * ex2(mx - top)) + (m2 == top ? s2 : s2 * ex2(m2 - top));
    mx = top;
  }
  return -(lg2(sum) + mx) / inv2;
}

__global__ void __launch_bounds__(kLargeThreads)
sinkhorn_large_kernel(const float* __restrict__ cost, const float* __restrict__ cost_t,
                      const float* __restrict__ log_a, const float* __restrict__ log_b,
                      const float* __restrict__ diam, float* __restrict__ f_out,
                      float* __restrict__ g_out, int n, int m, float blur, float log_scaling,
                      int max_iters, int extrapolate) {
  extern __shared__ float smem_large[];
  float* f = smem_large;                   // [n]
  float* g = f + n;                        // [m]
  float* ha = g + m;                       // log2(e) (log_a + f / eps), [n]
  float* hb = ha + n;                      // log2(e) (log_b + g / eps), [m]
  const int pair = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const float* cg = cost + (size_t)pair * n * m;      // [n][m]: row i is f_i's
  const float* ctg = cost_t + (size_t)pair * n * m;   // [m][n]: row j is g_j's
  const float* la = log_a + (size_t)pair * n;
  const float* lb = log_b + (size_t)pair * m;
  const Schedule sched(diam[pair], blur, log_scaling, max_iters);

  // h of both sides: the log-weights (kind 0), or from f and g at the inv2
  // that the round's softmins take (1)
  auto publish = [&](int kind, float inv2) {
    for (int i = threadIdx.x; i < n + m; i += blockDim.x) {
      const bool row = i < n;
      const int j = row ? i : i - n;
      const float lw2 = (row ? la[j] : lb[j]) * kLog2e;
      (row ? ha : hb)[j] = kind == 0 ? lw2 : fmaf(row ? f[j] : g[j], inv2, lw2);
    }
    __syncthreads();
  };
  // every softmin of a round, a warp each: f_i over hb (rows of the cost),
  // g_j over ha (rows of its transpose); kind 0 sets f and g, 1 averages, 2
  // writes the results out
  auto softmins = [&](int kind, float inv2) {
    for (int item = warp; item < n + m; item += warps) {
      const bool row = item < n;
      const int j = row ? item : item - n;
      const float v = row ? warp_softmin(cg + (size_t)j * m, hb, m, inv2, lane)
                          : warp_softmin(ctg + (size_t)j * n, ha, n, inv2, lane);
      if (lane == 0) {
        float* p = row ? f + j : g + j;
        if (kind == 0) *p = v;
        else if (kind == 1) *p = 0.5f * (*p + v);
        else (row ? f_out + (size_t)pair * n : g_out + (size_t)pair * m)[j] = v;
      }
    }
    __syncthreads();
  };

  publish(0, 0.f);
  softmins(0, (1.f / sched.eps_at(0)) * kLog2e);
  for (int it = 0; it < sched.iters; ++it) {   // Jacobi: both sides read the old f and g
    const float inv2 = (1.f / sched.eps_at(it)) * kLog2e;
    publish(1, inv2);
    softmins(1, inv2);
  }
  if (extrapolate) {                       // at eps = blur, again from the loop's f and g
    const float inv2 = (1.f / blur) * kLog2e;
    publish(1, inv2);
    softmins(2, inv2);
    return;
  }
  for (int i = threadIdx.x; i < n + m; i += blockDim.x) {
    if (i < n) f_out[(size_t)pair * n + i] = f[i];
    else g_out[(size_t)pair * m + i - n] = g[i - n];
  }
}

}  // namespace

// the large-pair kernel; cost_t: the cost transposed, [bsz, m, n]
extern "C" int aspire_sinkhorn_large_f32(const float* cost, const float* cost_t,
                                         const float* log_a, const float* log_b,
                                         const float* diam, float* f, float* g, int bsz, int n,
                                         int m, float blur, float log_scaling, int max_iters,
                                         int extrapolate, void* stream) {
  if (bsz < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const long long smem = 8LL * ((long long)n + m);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_large_kernel<<<bsz, kLargeThreads, (int)smem, (cudaStream_t)stream>>>(
      cost, cost_t, log_a, log_b, diam, f, g, n, m, blur, log_scaling, max_iters, extrapolate);
  return (int)cudaGetLastError();
}

extern "C" int aspire_sinkhorn_f32(const float* cost, const float* log_a, const float* log_b,
                                   const float* diam, float* f, float* g, int bsz, int n,
                                   int m, float blur, float log_scaling, int max_iters,
                                   int extrapolate, void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const int side = n > m ? n : m;
  const cudaStream_t s = (cudaStream_t)stream;
#define ASPIRE_SINKHORN_SMALL(P)                                                   \
  if (side <= kLanes * (P))                                                        \
    return launch_small<P>(cost, log_a, log_b, diam, f, g, bsz, n, m, blur, log_scaling, \
                           max_iters, extrapolate, s);
#define ASPIRE_SINKHORN_WIDE(P)                                                    \
  if (side <= 32 * (P))                                                            \
    return launch_wide<P>(cost, log_a, log_b, diam, f, g, bsz, n, m, blur, log_scaling,  \
                          max_iters, extrapolate, s);
  static_assert(kLanes * 8 == kSmallSide, "the small kernel's cases cover 32 atoms");
  ASPIRE_SINKHORN_SMALL(1)
  ASPIRE_SINKHORN_SMALL(2)
  ASPIRE_SINKHORN_SMALL(3)
  ASPIRE_SINKHORN_SMALL(4)
  ASPIRE_SINKHORN_SMALL(5)
  ASPIRE_SINKHORN_SMALL(6)
  ASPIRE_SINKHORN_SMALL(7)
  ASPIRE_SINKHORN_SMALL(8)
  ASPIRE_SINKHORN_WIDE(2)
  ASPIRE_SINKHORN_WIDE(4)
  ASPIRE_SINKHORN_WIDE(8)
  ASPIRE_SINKHORN_WIDE(16)
  ASPIRE_SINKHORN_WIDE(32)
#undef ASPIRE_SINKHORN_SMALL
#undef ASPIRE_SINKHORN_WIDE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* aspire_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
