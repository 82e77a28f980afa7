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
// Wider pairs (up to 1024 atoms a side, the pair within one block's shared
// memory: 33 x 33 up to 239 x 239, an abstract's query against full-text
// candidates up to 55 x 1,024): sinkhorn_wide_kernel, a block a pair (so a
// batch of 16-20 pairs reaches 16-20 SMs, and a small pair's block of a few
// warps leaves room for several on an SM).  The cost is read from device
// memory once, into shared memory as [O][pitch] with O the shorter side.  A
// team of lanes an O atom walks its row (lane sub the L atoms sub, sub +
// team, ...; the team's (max, sum) merged by butterfly shuffles), a thread
// an L atom walks its column, the two walks side by side on separate warps;
// ops/sinkhorn_kernel.wide_plan picks the team from (n, m) so that the
// longest chain of terms a thread walks is shortest.  A softmin is the
// large-pair kernel's chain (16 terms in registers: their max first, one
// rescale of the sum a chunk, ex2.approx with log2(e) folded into 1 / eps,
// a tree of sums), its log-sum taken by the accurate log2f (one a softmin)
// and divided by its factor; eps of every round and its reciprocal
// tabulated once.  h of each side lies once in shared
// memory: after its walk each side arrives at a named barrier that the
// other side waits on before it overwrites the h that walk read, and one
// block barrier ends the round.
// What bounds it: the exponentials, 2 n m a round on an SM's
// special-function unit (16 a clock) and the walks' issue beside them; at
// 48 x 40 the chain of a round (a column's 40 terms, the barriers).
//
// Every other pair (a side past 1024 atoms, or a cost past one block's shared
// memory: 240 x 240 and up, a query against a full-text document):
// sinkhorn_cluster_kernel, a pair spread over a thread-block cluster of c <= 8
// blocks (ops/sinkhorn_kernel.cluster_plan picks c from the batch, so that
// B c fills the card's SMs where B allows).  The blocks split the pair's longer
// side L into slices; each holds the whole other side O and keeps its slice
// of the cost in shared memory for the whole loop, read from device memory
// once a call -- or, where the slice does not fit, keeps the rows that fit
// and reads the rest from device memory (L2 at a query's batches) each
// round.  A thread an L atom walks a column of the slice (its whole softmin
// over O), a team of lanes an O atom walks a row (a partial softmin over the
// slice), so no transposed copy is needed.  The O atoms' partials (max, sum)
// are merged across the cluster through distributed shared memory: cluster
// barrier, block r merges its share of the O atoms over the c blocks in rank
// order (max first, then the sum) and writes their h into every block,
// cluster barrier -- two barriers a round, each split into arrive and wait
// so that a block's own L atoms' update runs while the others arrive.  The
// L and the O walks run side by side on separate warps.  A
// softmin keeps 16 terms in registers: their max first, one rescale of the
// running sum a chunk, the exponentials (ex2.approx, log2(e) folded into
// 1 / eps) summed as a tree; its log-sum is divided by the factor that scaled
// its terms, as in the other kernels.  Same schedule, trip count and rounds;
// n + m up to 29,056 atoms (the route's limit), each n x m < 2^31.
// What bounds it: the walks' instruction issue (7-9 instructions a term, the
// exponentials 2 n m a round on the special-function unit among them) and the
// two cluster barriers a round; spreading a pair over c blocks is what puts a
// query's batch of 16-20 pairs on every SM.
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 4;              // threads an atom in the small kernel
constexpr int kSmallSide = 32;         // the small kernel's largest side
constexpr int kTable = 128;            // rounds whose eps the small kernel tabulates
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------- large pairs
constexpr int kClusterThreads = 512;   // threads a block of the large-pair kernel
constexpr int kClusterMax = 8;         // blocks a pair: the portable cluster size
constexpr int kChunk = 16;             // terms a thread holds in registers at once

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }

// the largest power of two up to 32 whose `rows` teams of lanes, beside the
// L atoms' units, fit a block's threads (at least 32 lanes of O units)
__host__ __device__ inline int team_for(int rows, int lw) {
  const int lw32 = (lw + 31) / 32 * 32;
  const int avail = kClusterThreads - lw32 > 32 ? kClusterThreads - lw32 : 32;
  int team = 32;
  while (team > 1 && rows * team > avail) team >>= 1;
  return team;
}

// One block's shared memory, in floats (mirrored by
// ops/sinkhorn_kernel.cluster_layout).  The c blocks of a pair split its
// longer side L (the columns when m >= n) into slices of at most lw atoms;
// every block holds the whole other side O.  The cost of O rows
// [0, res_rows) x the slice is resident, with a pitch of team x an odd
// number, so that both walks are free of bank conflicts (a warp reads 32
// neighbouring L atoms of one row, or 32 / team rows at team neighbouring L
// atoms each); the rows past res_rows are read from device memory (L2) each
// round.
struct ClusterLayout {
  int o_len, l_len, lw, team, pitch, floats;
  int h_o, h_l, o_part, l_part, p_o, p_l, tile;
};

__host__ __device__ inline ClusterLayout cluster_layout(int n, int m, int c, int res_rows) {
  ClusterLayout s;
  s.o_len = m >= n ? n : m;
  s.l_len = m >= n ? m : n;
  s.lw = (s.l_len + c - 1) / c;
  s.team = team_for(res_rows, s.lw);
  s.pitch = s.team * (((s.lw + s.team - 1) / s.team) | 1);
  s.h_o = 0;                                         // [O]
  s.h_l = pad16(s.o_len);                            // [lw]
  s.o_part = s.h_l + pad16(s.lw);                    // float2 [O]
  s.l_part = s.o_part + 2 * s.o_len;                 // float2 [lw]
  s.p_o = s.l_part + 2 * s.lw;                       // [ceil(O / c)]
  s.p_l = s.p_o + (s.o_len + c - 1) / c;             // [lw]
  s.tile = s.p_l + s.lw;                             // [res_rows][pitch]
  s.floats = s.tile + res_rows * s.pitch;
  return s;
}

// (max, sum) of two parts of a log-sum-exp in base 2 -> the whole; a part
// without terms is (-inf, 0)
__device__ __forceinline__ void merge_part(float& mx, float& sum, float m2, float s2) {
  const float top = fmaxf(mx, m2);
  sum = (mx == top ? sum : sum * ex2(mx - top)) + (m2 == top ? s2 : s2 * ex2(m2 - top));
  mx = top;
}

// a[u] = max (or sum) of a[u] and a[u + W] for u < W, then the same at W / 2,
// ... 1: a tree whose indices are constant, so that the array stays in
// registers
template <int W, bool kMax, int N>
__device__ __forceinline__ void tree(float (&a)[N]) {
  static_assert(2 * W <= N, "a level of the tree within the array");
#pragma unroll
  for (int u = 0; u < W; ++u) a[u] = kMax ? fmaxf(a[u], a[u + W]) : a[u] + a[u + W];
  if constexpr (W > 1) tree<W / 2, kMax>(a);
}

// N terms 2^(h[j hs] - c[j cs] inv2), j = k .. k + N - 1, into the online
// (max, sum): their max first, one rescale of the sum, the exponentials
// summed as a tree.  kMask: the terms from `count` on are -inf (their loads
// of c clamped to the last term).  kCUnit: cs is 1 (loads at constant
// offsets); kHUnit: hs is 1 and h + k 16-byte aligned (h in float4s, read
// past count within the shared memory that follows h).
template <int N, bool kMask, bool kCUnit, bool kHUnit>
__device__ __forceinline__ void chunk(const float* c, int cs, const float* h, int hs, int k,
                                      int count, float inv2, float& mx, float& sum) {
  float t[N], hv[N], cm[N / 2];
  if constexpr (kHUnit) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(h + k)[q];
      hv[4 * q] = v.x;
      hv[4 * q + 1] = v.y;
      hv[4 * q + 2] = v.z;
      hv[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) hv[u] = h[(kMask ? min(k + u, count - 1) : k + u) * hs];
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int j = kMask ? min(k + u, count - 1) : k + u;
    const float x = fmaf(-(kCUnit ? c[j] : c[j * cs]), inv2, hv[u]);
    t[u] = kMask && k + u >= count ? -INFINITY : x;
  }
#pragma unroll
  for (int u = 0; u < N / 2; ++u) cm[u] = fmaxf(t[u], t[u + N / 2]);
  if constexpr (N > 2) tree<N / 4, true>(cm);
  const float top = fmaxf(mx, cm[0]);
#pragma unroll
  for (int u = 0; u < N; ++u) t[u] = ex2(t[u] - top);   // ex2(-inf) = 0
  tree<N / 2, false>(t);
  sum = fmaf(sum, ex2(mx - top), t[0]);                 // 0 before the first chunk
  mx = top;
}

// the online (max, sum) continued over count terms: full chunks of kChunk,
// then the rest as one masked chunk of 8 or 16
template <bool kCUnit, bool kHUnit>
__device__ __forceinline__ void chain(const float* c, int cs, const float* h, int hs, int count,
                                      float inv2, float& mx, float& sum) {
  int k = 0;
  for (; k + kChunk <= count; k += kChunk)
    chunk<kChunk, false, kCUnit, kHUnit>(c, cs, h, hs, k, count, inv2, mx, sum);
  if (count - k > kChunk / 2)
    chunk<kChunk, true, kCUnit, kHUnit>(c, cs, h, hs, k, count, inv2, mx, sum);
  else if (count > k)
    chunk<kChunk / 2, true, kCUnit, kHUnit>(c, cs, h, hs, k, count, inv2, mx, sum);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A pair spread over a cluster of c blocks (rank r owns L atoms [L r / c,
// L (r + 1) / c)).  A round: each block walks its slice of the cost once,
// giving every O atom a partial softmin over the slice (`o_part`) and every
// L atom of the slice its whole softmin over O (`l_part`); then it updates
// its L atoms' potentials and h; after a cluster barrier block r merges the
// O atoms [O r / c, O (r + 1) / c) over the c blocks' partials in rank order
// (distributed shared memory), updates their potentials and writes their h
// into every block; a second cluster barrier.  Both softmins of a round read
// the last round's h (Jacobi).
__global__ void __launch_bounds__(kClusterThreads, 1)
sinkhorn_cluster_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                        const float* __restrict__ log_b, const float* __restrict__ diam,
                        float* __restrict__ f_out, float* __restrict__ g_out, int n, int m,
                        int res_rows, float blur, float log_scaling, int max_iters,
                        int extrapolate) {
  extern __shared__ __align__(16) float smem_c[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / cn;
  const ClusterLayout lay = cluster_layout(n, m, cn, res_rows);
  const bool by_cols = m >= n;                 // O the rows, L the columns
  const int O = lay.o_len, P = lay.pitch;
  const int l0 = lay.l_len * rank / cn, lw = lay.l_len * (rank + 1) / cn - l0;
  const int s0 = O * rank / cn, sw = O * (rank + 1) / cn - s0;   // the O atoms it merges
  const int so = by_cols ? m : 1, sl = by_cols ? 1 : m;          // (o, l) in the cost
  float* h_o = smem_c + lay.h_o;               // log2(e) (log-weight + potential / eps)
  float* h_l = smem_c + lay.h_l;
  float2* o_part = reinterpret_cast<float2*>(smem_c + lay.o_part);
  float2* l_part = reinterpret_cast<float2*>(smem_c + lay.l_part);
  float* p_o = smem_c + lay.p_o;               // potentials of the O atoms it merges
  float* p_l = smem_c + lay.p_l;               // potentials of its L atoms
  float* res = smem_c + lay.tile;              // cost (o, l) at o P + l, o < res_rows

  const float* cp = cost + (size_t)pair * n * m + l0 * sl;   // n x m < 2^31: 32-bit offsets
  const float* lw_o = by_cols ? log_a + (size_t)pair * n : log_b + (size_t)pair * m;
  const float* lw_l = (by_cols ? log_b + (size_t)pair * m : log_a + (size_t)pair * n) + l0;
  float* out_o = (by_cols ? f_out + (size_t)pair * n : g_out + (size_t)pair * m) + s0;
  float* out_l = (by_cols ? g_out + (size_t)pair * m : f_out + (size_t)pair * n) + l0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kClusterThreads / 32;
  const int lw32 = (lw + 31) / 32 * 32;
  const int rows_g = O - res_rows, team_g = team_for(rows_g, lay.lw);
  // threads [0, nl) walk the L atoms, [o_first, kClusterThreads) the O atoms:
  // apart, so that the two walks run side by side, where a warp is left for O
  const bool apart = lw32 <= kClusterThreads - 32;
  const int nl = apart ? lw32 : kClusterThreads, o_first = apart ? lw32 : 0;
  const float* glob = cp + res_rows * so;      // the rows read from device memory

  // the resident rows, a warp a row of the cost as it lies in memory
  if (by_cols) {
    for (int r = warp; r < res_rows; r += kWarps)
      for (int l = lane; l < lw; l += 32) aspire::cp_async4(res + r * P + l, cp + r * so + l);
  } else {
    for (int l = warp; l < lw; l += kWarps)
      for (int r = lane; r < res_rows; r += 32) aspire::cp_async4(res + r * P + l, cp + r + l * sl);
  }
  aspire::cp_async_commit();

  // The walk of rows [o_base, o_base + rows) of O, the cost (o, l) at
  // c[(o - o_base) co + l cl]: L units (lw32 threads, whole warps) continue
  // their (max, sum) down their column (from (-inf, 0) when `first`), O
  // units take a partial over the slice by `team` lanes (lane sub the atoms
  // sub, sub + team, ...) merged by shuffles, into `part`.
  auto l_walk = [&](const float* c, int co, int cl, int o_base, int rows, bool first,
                    float inv2) {
    for (int u = tid; u < lw; u += nl) {
      float mx = -INFINITY, sum = 0.f;
      if (!first) {
        mx = l_part[u].x;
        sum = l_part[u].y;
      }
      chain<false, true>(c + u * cl, co, h_o + o_base, 1, rows, inv2, mx, sum);
      l_part[u] = make_float2(mx, sum);
    }
  };
  auto o_walk = [&](const float* c, int co, int cl, int o_base, int rows, int team,
                    float2* part, float inv2) {
    const int tshift = __ffs(team) - 1;
    const int units = (rows * team + 31) / 32 * 32;   // whole warps: all lanes shuffle
    for (int u = tid - o_first; u < units; u += kClusterThreads - o_first) {
      const int item = u >> tshift, sub = u & (team - 1);
      const int count = item < rows && sub < lw ? (lw - sub + team - 1) >> tshift : 0;
      float mx = -INFINITY, sum = 0.f;
      const float* row = c + min(item, rows - 1) * co + sub * cl;
      if (team > 1)
        chain<false, false>(row, team * cl, h_l + sub, team, count, inv2, mx, sum);
      else if (cl == 1)
        chain<true, true>(row, 1, h_l, 1, count, inv2, mx, sum);
      else
        chain<false, true>(row, cl, h_l, 1, count, inv2, mx, sum);
      for (int w = 1; w < team; w <<= 1)
        merge_part(mx, sum, __shfl_xor_sync(kFull, mx, w), __shfl_xor_sync(kFull, sum, w));
      if (sub == 0 && item < rows) part[o_base + item] = make_float2(mx, sum);
    }
  };

  const Schedule sched(diam[pair], blur, log_scaling, max_iters);
  const int rounds = 1 + sched.iters + (extrapolate ? 1 : 0);
  // round 0 from the log-weights, rounds 1..iters the loop, then eps = blur
  auto inv2_at = [&](int round) {
    const float eps =
        round == 0 ? sched.eps_at(0) : round <= sched.iters ? sched.eps_at(round - 1) : blur;
    return (1.f / eps) * kLog2e;
  };
  for (int o = tid; o < O; o += kClusterThreads) h_o[o] = lw_o[o] * kLog2e;
  for (int l = tid; l < lw; l += kClusterThreads) h_l[l] = lw_l[l] * kLog2e;
  aspire::cp_async_wait<0>();
  __syncthreads();
  cluster_arrive();                            // stands for the barrier of a round -1

  for (int round = 0; round < rounds; ++round) {
    const float inv2 = inv2_at(round);
    // h of O from the last round's merge, whose reads of the partials are done
    cluster_wait();
    if (tid >= o_first) {
      if (res_rows > 0) o_walk(res, P, 1, 0, res_rows, lay.team, o_part, inv2);
      if (rows_g > 0) o_walk(glob, so, sl, res_rows, rows_g, team_g, o_part, inv2);
    }
    if (tid < nl) {
      if (res_rows > 0) l_walk(res, P, 1, 0, res_rows, true, inv2);
      if (rows_g > 0) l_walk(glob, so, sl, res_rows, rows_g, res_rows == 0, inv2);
    }
    cluster_arrive();                          // this block's partials written
    __syncthreads();                           // every walk of the block has read h_l

    const int kind = round == 0 ? 0 : round <= sched.iters ? 1 : 2;
    const bool last = round + 1 == rounds;
    const float inv2_next = last ? 0.f : inv2_at(round + 1);
    // a potential from its softmin: the first round sets it, the loop
    // averages, the final step writes the softmin out; the last round
    // writes the potential out, every other one returns next round's h
    auto update = [&](float* pot, float* out, int j, float top, float sum) {
      const float v = -(lg2(sum) + top) / inv2;   // divided by the factor that scaled the terms
      if (kind == 2) {
        out[j] = v;
        return v;
      }
      const float p = kind == 0 ? v : 0.5f * (pot[j] + v);
      pot[j] = p;
      if (last) out[j] = p;
      return p;
    };
    for (int j = tid; j < lw; j += kClusterThreads) {   // its own L atoms
      const float p = update(p_l, out_l, j, l_part[j].x, l_part[j].y);
      if (!last) h_l[j] = fmaf(p, inv2_next, lw_l[j] * kLog2e);
    }
    cluster_wait();                            // every block's partials written
    for (int j = tid; j < sw; j += kClusterThreads) {   // its share of O, over the c blocks
      float2 pr[kClusterMax];
      float top = -INFINITY, sum = 0.f;
#pragma unroll
      for (int r = 0; r < kClusterMax; ++r)
        if (r < cn) {
          pr[r] = cluster.map_shared_rank(o_part, r)[s0 + j];
          top = fmaxf(top, pr[r].x);
        }
#pragma unroll
      for (int r = 0; r < kClusterMax; ++r)   // max first, then summed in rank order
        if (r < cn) sum += pr[r].x == top ? pr[r].y : pr[r].y * ex2(pr[r].x - top);
      const float p = update(p_o, out_o, j, top, sum);
      if (!last) {
        const float h = fmaf(p, inv2_next, lw_o[s0 + j] * kLog2e);
#pragma unroll
        for (int r = 0; r < kClusterMax; ++r)
          if (r < cn) cluster.map_shared_rank(h_o, r)[s0 + j] = h;
      }
    }
    cluster_arrive();                          // this block's merge and h written
  }
  cluster_wait();                              // no block exits while another may read it
}

// the launch's shared memory, or an error for arguments the kernel refuses
int cluster_bytes(int n, int m, int c, int res_rows, int* bytes) {
  const int o_len = m >= n ? n : m, l_len = m >= n ? m : n;
  // the rows read from device memory start at a multiple of 4 (h in float4s)
  if (n < 1 || m < 1 || c < 1 || c > kClusterMax || c > l_len || res_rows < 0 ||
      res_rows > o_len || (res_rows % 4 != 0 && res_rows != o_len))
    return (int)cudaErrorInvalidValue;
  const long long b = 4LL * cluster_layout(n, m, c, res_rows).floats;
  if (b > kMaxSmem) return (int)cudaErrorInvalidValue;
  *bytes = (int)b;
  return (int)cudaFuncSetAttribute(sinkhorn_cluster_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
}

cudaLaunchConfig_t cluster_config(int blocks, int c, int bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ----------------------------------------------------------------- wide pairs
constexpr int kWideThreads = 1024;     // threads a block of the wide-pair kernel at most
constexpr int kWideTable = 160;        // rounds whose log2(e) / eps it tabulates at most
constexpr int kWidePer = 4;            // L atoms an L thread takes at most

// One block's shared memory for an n x m pair whose O atoms run `team` lanes
// a softmin, in floats (mirrored by ops/sinkhorn_kernel.wide_layout): h of
// O, h of L (16-byte aligned where one lane walks a row: it reads h of L in
// float4s), the schedule's table of `table` rounds, then the cost
// [O][pitch], O the shorter side.  The pitch is team x an odd number where
// that fits (the O teams' and the L threads' reads of the cost both free of
// bank conflicts), else L | 1, else L; the table takes what is left, up to
// kWideTable rounds (a round past it computes its eps).  Every pair of the
// route has a team whose layout fits (ops/sinkhorn_kernel.wide_plan).
struct WideLayout {
  int o_len, l_len, h_l, tab, table, pitch, tile, floats;
};

__host__ __device__ inline WideLayout wide_layout(int n, int m, int team) {
  WideLayout s;
  s.o_len = m >= n ? n : m;
  s.l_len = m >= n ? m : n;
  s.h_l = team == 1 ? (s.o_len + 3) / 4 * 4 : s.o_len;   // h of O at 0
  s.tab = s.h_l + s.l_len;                               // [2][table]
  const int room = kMaxSmem / 4 - s.tab;
  const int odd = team * (((s.l_len + team - 1) / team) | 1);
  s.pitch = s.o_len * odd <= room ? odd
            : s.o_len * (s.l_len | 1) <= room ? (s.l_len | 1) : s.l_len;
  const int spare = (room - s.o_len * s.pitch) / 2;
  s.table = spare < 0 ? 0 : spare < kWideTable ? spare : kWideTable;
  s.tile = s.tab + 2 * s.table;
  s.floats = s.tile + s.o_len * s.pitch;
  return s;
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A pair a block.  Threads [0, o_thr) are the O atoms' teams: `team` lanes
// an atom, lane sub walking the atom's row of the cost at the L atoms sub,
// sub + team, ... (a partial softmin), the team's partials merged by
// butterfly shuffles (`merge_part`: max first, then the sum).  Threads
// [o_thr, blockDim.x) are the L atoms: L thread u takes the atoms u, u + nl,
// ... (at most kPer), each walking its column over every O atom.  A round:
// both walks read the last round's h (Jacobi); each side then arrives at
// the barrier that the other side's writer waits on (1: every O walk has
// read h of L, 2: every L walk has read h of O), takes its potentials and
// overwrites its own h; one block barrier ends the round.  (h of each side
// once: two buffers of h of O did not leave room for 239 x 241.)
template <int kPer>
__global__ void __launch_bounds__(kWideThreads, 1)
sinkhorn_wide_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                     const float* __restrict__ log_b, const float* __restrict__ diam,
                     float* __restrict__ f_out, float* __restrict__ g_out, int n, int m,
                     int team, float blur, float log_scaling, int max_iters, int extrapolate) {
  extern __shared__ __align__(16) float smem_w[];
  const WideLayout lay = wide_layout(n, m, team);
  const int pair = blockIdx.x;
  const bool by_cols = m >= n;                 // O the rows, L the columns
  const int O = lay.o_len, L = lay.l_len, P = lay.pitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int o_thr = (O * team + 31) / 32 * 32, nl = threads - o_thr;
  float* h_o = smem_w;                         // log2(e) (log-weight + potential / eps)
  float* h_l = smem_w + lay.h_l;
  float* tab = smem_w + lay.tab;               // log2(e) / eps of a round, its reciprocal
  float* tile = smem_w + lay.tile;             // cost (o, l) at o P + l

  const float* cp = cost + (size_t)pair * n * m;   // n x m < 2^31: 32-bit offsets
  const float* lw_o = by_cols ? log_a + (size_t)pair * n : log_b + (size_t)pair * m;
  const float* lw_l = by_cols ? log_b + (size_t)pair * m : log_a + (size_t)pair * n;
  float* out_o = by_cols ? f_out + (size_t)pair * n : g_out + (size_t)pair * m;
  float* out_l = by_cols ? g_out + (size_t)pair * m : f_out + (size_t)pair * n;

  // the cost, read once: a warp a row as it lies in memory
  if (by_cols) {
    for (int o = warp; o < O; o += warps)
      for (int l = lane; l < L; l += 32) aspire::cp_async4(tile + o * P + l, cp + o * m + l);
  } else {
    for (int l = warp; l < L; l += warps)
      for (int o = lane; o < O; o += 32) aspire::cp_async4(tile + o * P + l, cp + l * m + o);
  }
  aspire::cp_async_commit();

  const Schedule sched(diam[pair], blur, log_scaling, max_iters);
  const int rounds = 1 + sched.iters + (extrapolate ? 1 : 0);
  // round 0 from the log-weights, rounds 1..iters the loop, then eps = blur
  auto inv2_at = [&](int round) {
    const float eps =
        round == 0 ? sched.eps_at(0) : round <= sched.iters ? sched.eps_at(round - 1) : blur;
    return (1.f / eps) * kLog2e;
  };
  for (int i = tid; i < min(rounds, lay.table); i += threads) {
    const float inv2 = inv2_at(i);
    tab[i] = inv2;
    tab[lay.table + i] = 1.f / inv2;
  }
  for (int o = tid; o < O; o += threads) h_o[o] = lw_o[o] * kLog2e;
  for (int l = tid; l < L; l += threads) h_l[l] = lw_l[l] * kLog2e;

  // an O thread: atom `item`, lane `sub` of its team; an L thread: atoms u + nl i
  const int tshift = __ffs(team) - 1;
  const int item = tid >> tshift, sub = tid & (team - 1), u = tid - o_thr;
  const bool o_side = tid < o_thr, o_live = o_side && item < O;
  const float lw2 = o_live ? lw_o[item] * kLog2e : 0.f;
  float lw2_l[kPer], p_l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int l = u + nl * i;
    lw2_l[i] = !o_side && l < L ? lw_l[l] * kLog2e : 0.f;
    p_l[i] = 0.f;
  }
  float p_o = 0.f;
  aspire::cp_async_wait<0>();
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    const bool in_tab = round < lay.table;
    const float inv2 = in_tab ? tab[round] : inv2_at(round);
    const float r = in_tab ? tab[lay.table + round] : 1.f / inv2;
    const int kind = round == 0 ? 0 : round <= sched.iters ? 1 : 2;
    const bool last = round + 1 == rounds;
    const float inv2_next =
        last ? 0.f : round + 1 < lay.table ? tab[round + 1] : inv2_at(round + 1);
    // a potential from its softmin, the log-sum divided by the factor that
    // scaled the terms: the loop averages, the first round and the final
    // step take the softmin itself.  The log-sum by log2f, not lg2.approx:
    // its error, divided by the small factors of the first rounds (eps near
    // the diameter), stayed in the potentials (B=4 1,024 x 55: OT scores
    // 2.59e-3 from f64 with lg2.approx, 1.25e-3 with log2f, at the same time)
    auto update = [&](float& p, float mx, float sum) {
      const float v = div_by(-(log2f(sum) + mx), inv2, r);
      p = kind == 1 ? 0.5f * (p + v) : v;
    };
    if (o_side) {
      float mx = -INFINITY, sum = 0.f;
      const int count = o_live ? (L - sub + team - 1) >> tshift : 0;
      const float* row = tile + min(item, O - 1) * P;
      if (team > 1)
        chain<false, false>(row + sub, team, h_l + sub, team, count, inv2, mx, sum);
      else
        chain<true, true>(row, 1, h_l, 1, count, inv2, mx, sum);
      for (int w = 1; w < team; w <<= 1)
        merge_part(mx, sum, __shfl_xor_sync(kFull, mx, w), __shfl_xor_sync(kFull, sum, w));
      bar_arrive(1, threads);                  // this thread has read h of L
      update(p_o, mx, sum);
      bar_sync(2, threads);                    // every L walk has read h of O
      if (o_live) {
        if (last) {
          if (sub == 0) out_o[item] = p_o;
        } else {
          h_o[item] = fmaf(p_o, inv2_next, lw2);
        }
      }
    } else {
      float pm[kPer], ps[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pm[i] = -INFINITY;
        ps[i] = 0.f;
        if (u + nl * i < L)
          chain<false, true>(tile + u + nl * i, P, h_o, 1, O, inv2, pm[i], ps[i]);
      }
      bar_arrive(2, threads);                  // this thread has read h of O
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (u + nl * i < L) update(p_l[i], pm[i], ps[i]);
      bar_sync(1, threads);                    // every O walk has read h of L
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int l = u + nl * i;
        if (l < L) {
          if (last)
            out_l[l] = p_l[i];
          else
            h_l[l] = fmaf(p_l[i], inv2_next, lw2_l[i]);
        }
      }
    }
    __syncthreads();
  }
}

// the launch's shared memory, or an error for a plan the kernel refuses
int wide_bytes(int n, int m, int team, int threads, int* bytes) {
  const int o_len = m >= n ? n : m, l_len = m >= n ? m : n;
  if (n < 1 || m < 1 || team < 1 || team > 32 || (team & (team - 1)) != 0 ||
      threads > kWideThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int nl = threads - (o_len * team + 31) / 32 * 32;
  if (nl < 32 || (l_len + nl - 1) / nl > kWidePer) return (int)cudaErrorInvalidValue;
  const long long b = 4LL * wide_layout(n, m, team).floats;
  if (b > kMaxSmem) return (int)cudaErrorInvalidValue;
  *bytes = (int)b;
  return 0;
}

template <int kPer>
int launch_wide(const float* cost, const float* log_a, const float* log_b, const float* diam,
                float* f, float* g, int bsz, int n, int m, int team, int threads, int bytes,
                float blur, float log_scaling, int max_iters, int extrapolate,
                cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel has to opt in
  const cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_wide_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_wide_kernel<kPer><<<bsz, threads, bytes, stream>>>(
      cost, log_a, log_b, diam, f, g, n, m, team, blur, log_scaling, max_iters, extrapolate);
  return (int)cudaGetLastError();
}

}  // namespace

// the large-pair kernel: bsz clusters of `cluster` blocks, res_rows of the
// shorter side resident (ops/sinkhorn_kernel.cluster_plan chooses both)
extern "C" int aspire_sinkhorn_large_f32(const float* cost, const float* log_a,
                                         const float* log_b, const float* diam, float* f,
                                         float* g, int bsz, int n, int m, int cluster,
                                         int res_rows, float blur, float log_scaling,
                                         int max_iters, int extrapolate, void* stream) {
  int bytes = 0;
  const int err = cluster_bytes(n, m, cluster, res_rows, &bytes);
  if (err != 0) return err;
  if (bsz < 1 || bsz > 0x7fffffff / cluster) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(bsz * cluster, cluster, bytes, (cudaStream_t)stream, &attr);
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, sinkhorn_cluster_kernel, cost, log_a, log_b, diam, f, g, n, m,
                         res_rows, blur, log_scaling, max_iters, extrapolate);
  return launched != cudaSuccess ? (int)launched : (int)cudaGetLastError();
}

// clusters of the large-pair kernel the card holds at once for these
// arguments (cudaOccupancyMaxActiveClusters), or minus an error
extern "C" int aspire_sinkhorn_cluster_capacity(int n, int m, int cluster, int res_rows) {
  int bytes = 0;
  const int err = cluster_bytes(n, m, cluster, res_rows, &bytes);
  if (err != 0) return -err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, bytes, 0, &attr);
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&count, sinkhorn_cluster_kernel, &cfg);
  return e != cudaSuccess ? -(int)e : count;
}

// the small pairs (up to 32 atoms a side)
extern "C" int aspire_sinkhorn_f32(const float* cost, const float* log_a, const float* log_b,
                                   const float* diam, float* f, float* g, int bsz, int n,
                                   int m, float blur, float log_scaling, int max_iters,
                                   int extrapolate, void* stream) {
  if (n < 1 || m < 1 || bsz < 1) return (int)cudaErrorInvalidValue;
  const int side = n > m ? n : m;
  const cudaStream_t s = (cudaStream_t)stream;
#define ASPIRE_SINKHORN_SMALL(P)                                                   \
  if (side <= kLanes * (P))                                                        \
    return launch_small<P>(cost, log_a, log_b, diam, f, g, bsz, n, m, blur, log_scaling, \
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
#undef ASPIRE_SINKHORN_SMALL
  return (int)cudaErrorInvalidValue;
}

// the wide pairs: bsz blocks of `threads`, the O atoms' teams of `team` lanes
// first (ops/sinkhorn_kernel.wide_plan chooses both)
extern "C" int aspire_sinkhorn_wide_f32(const float* cost, const float* log_a,
                                        const float* log_b, const float* diam, float* f,
                                        float* g, int bsz, int n, int m, int team, int threads,
                                        float blur, float log_scaling, int max_iters,
                                        int extrapolate, void* stream) {
  int bytes = 0;
  const int err = wide_bytes(n, m, team, threads, &bytes);
  if (err != 0) return err;
  if (bsz < 1) return (int)cudaErrorInvalidValue;
  const int o_len = m >= n ? n : m, l_len = m >= n ? m : n;
  const int per = (l_len + threads - (o_len * team + 31) / 32 * 32 - 1) /
                  (threads - (o_len * team + 31) / 32 * 32);
  const cudaStream_t s = (cudaStream_t)stream;
#define ASPIRE_SINKHORN_WIDE(K)                                                          \
  if (per <= (K))                                                                        \
    return launch_wide<K>(cost, log_a, log_b, diam, f, g, bsz, n, m, team, threads, bytes, \
                          blur, log_scaling, max_iters, extrapolate, s);
  static_assert(kWidePer == 4, "the wide kernel's cases cover 4 L atoms a thread");
  ASPIRE_SINKHORN_WIDE(1)
  ASPIRE_SINKHORN_WIDE(2)
  ASPIRE_SINKHORN_WIDE(4)
#undef ASPIRE_SINKHORN_WIDE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* aspire_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
