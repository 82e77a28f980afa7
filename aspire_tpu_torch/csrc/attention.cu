// Fused attention forward: softmax(q.k^T * scale + bias) . v, with or without
// dropout on the probabilities.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_attention.py
// (_fwd_kernel, built at dropout_p = 0 and at dropout_p > 0).  Rounding points
// follow the TPU kernel: scores, max, exp and sum in f32; the probabilities
// normalised in f32 and then cast to the compute type; with dropout, divided
// by (1 - p) in the compute type and the dropped ones zeroed; probs.v
// accumulated in f32 and cast on store.  To normalise before the cast without
// keeping a whole [rows, t] score block, the keys are walked twice: pass 1
// finds each row's max m and sum l, pass 2 recomputes the scores, normalises,
// casts and accumulates the context.  (An online softmax in one pass would
// cast unnormalised probabilities: another rounding, not this kernel.)
//
// What bounds it on an H100: at [30, 12, 512, 64] the three products (q.k^T
// twice, pd.v once) are 36 GFLOP, 0.037 ms on the bf16 tensor cores, and the
// bytes 0.028 ms; each of the 94 M scores then costs two exponentials, the
// normalisation and a cast, and with dropout a quarter of a Philox4x32-10
// call, the compare and the scale.  Measured (PERF.md), the walk itself --
// loads, products and barriers with the elementwise work taken out -- takes
// two thirds of the time without dropout: with 16 warps an SM (128 registers
// a thread) the latency of each step's products and loads is not hidden.  The
// design:
//
//   - a block owns 128 query rows of one (batch, head) as two warpgroups of
//     64; both products run on wgmma: S = q.k^T (m64n64k16, q and the key
//     tile read from shared memory, both K-major), and ctx += pd.v
//     (m64n64k16, pd as register A fragments packed straight from the score
//     accumulators, the value tile read as B MN-major);
//   - q (once) and the key tiles (pass 1), then key and value tiles (pass 2),
//     come by cp.async into the 128-byte swizzle that the wgmma descriptors
//     read, through a ring of kStages stages loaded kStages - 2 steps ahead
//     of use, with one block barrier a step; the keys' biases ride in the
//     same ring (-inf past t);
//   - each probability is expf(s - m) * (1 / l), the reciprocal taken once a
//     row, and with dropout pd = bf16(bf16(p) * (1 / bf16(1 - p))), the
//     reciprocal taken once a call (drop_prob_bf16).  That is the arithmetic
//     the backward's keys kernel (attention_bwd.cu) uses to recompute pd from
//     the m and l this kernel leaves in `stats`, so the two compute the same
//     pd from the same scores; and bf16(bf16(p) * (1 / bf16(1 - p))) is the
//     bf16 quotient bf16(p) / bf16(1 - p) exactly (attention_bwd.cu says
//     why);
//   - the exponentials of pass 1's sums take one special-function
//     instruction each (exp_sfu) in place of expf's eight; the cast inside
//     drop_prob_bf16 is done by integer instructions (round_bf16), since the
//     conversion unit is the one the exponentials need; the Philox rounds
//     that depend only on the row are taken once a thread (philox_row).
//
// Dropout is a compile-time mode (kDrop: 0 none, 1 Philox bits made in the
// kernel, 2 bits read from an operand).  The bits are a function of the
// element's position (common.cuh), so the backward, which tiles differently,
// recomputes the same mask.  A thread holds two neighbouring columns of a row
// in the accumulator layout while one Philox call covers four: the counter
// takes column / 4 all the same, and the two threads of a pair each make one
// call (rows g and g + 8) and swap halves (acc_bits).  Mode 0 compiles to the
// kernel without any of this.
//
// Tried on the H100 and slower (PERF.md): one warpgroup of 64 rows a
// block, three blocks an SM, with the next step's scores in flight during
// this step's elementwise work (12 warps an SM, 168 registers); the same with
// two warpgroups at one or two blocks an SM; the pd.v wait deferred to the
// next step; the scores in two halves of 32 keys; the next step's scores
// started with this step's pd.v; pd packed by integer instructions too.
//
// f32 without dropout and without a backward to feed (K2 in the evaluation's
// f32 encode) runs attention_tf32x3_kernel: one walk over the keys with an
// online softmax, both products on the tensor cores as split-TF32 (3xTF32)
// mma.sync products, at f32 accuracy.  An f32 forward that leaves the row
// statistics for the backward -- with dropout (K5a in f32) or without, a
// check path: training runs bf16 -- keeps attention_f32_kernel: one block of
// 64 rows, four warps, synchronous tile loads and plain FMAs, the f32
// backward's products.
#include "attention_tile.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

struct Strides { long long b, h, t; };

// ---------------------------------------------------------------- bf16 kernel
constexpr int kWg = 2;                    // warpgroups a block, 64 query rows each
constexpr int kBqWg = 64 * kWg;           // query rows a block
constexpr int kThreadsWg = 128 * kWg;
constexpr int kStages = 4;                // ring of key (and value) tiles
constexpr int kAhead = kStages - 2;       // steps loaded ahead of use
constexpr int kTileSw = kBk * kHd;        // elements of a swizzled [64][64] tile
// q [128][64], then a key and a value tile a stage (all in the 128-byte
// swizzle), then the keys' biases a stage; 1 KB to align the base
constexpr size_t kSmemBf16 = 1024 + (size_t)(kBqWg * kHd + 2 * kStages * kTileSw) * sizeof(bf16) +
                             (size_t)kStages * kBk * sizeof(float);

struct FwdArgs {
  const bf16 *q, *k, *v;
  const float* bias;
  bf16* out;
  float* stats;        // null, or [>= 2, b * heads, t]: each row's max and sum
  int t;
  Strides qs, ks, vs, os;
  float sm_scale;
  float inv_keep;      // 1 / (1 - p rounded to bf16)
  Drop drop;
};

// s = s * scale + bias of the column, in the accumulator layout (s[4 j + i]:
// rows g (i < 2) and g + 8, columns 8 j + 2 t + (i & 1))
__device__ __forceinline__ void scale_bias(float (&s)[32], const float* bias_s, float sm_scale,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * tq);
    s[4 * j] = s[4 * j] * sm_scale + b.x;
    s[4 * j + 1] = s[4 * j + 1] * sm_scale + b.y;
    s[4 * j + 2] = s[4 * j + 2] * sm_scale + b.x;
    s[4 * j + 3] = s[4 * j + 3] * sm_scale + b.y;
  }
}

// e^x for x <= 0 by one special-function instruction, 2^(x log2 e): a few f32
// ulps from expf, subnormal results flushed to zero.  For the row sums only:
// the probabilities that meet the backward's go through expf.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// online max and sum of the rows g (index 0) and g + 8 (index 1) over one tile
__device__ __forceinline__ void row_stats(const float (&s)[32], float (&m_run)[2],
                                          float (&l_run)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += exp_sfu(s[4 * j + 2 * h] - m_new) + exp_sfu(s[4 * j + 2 * h + 1] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run[h] = l_run[h] * exp_sfu(m_run[h] - m_new) + sum;
    m_run[h] = m_new;
  }
}

template <int kDrop>
__global__ void __launch_bounds__(kThreadsWg, 2) attention_bf16_kernel(const FwdArgs a) {
  extern __shared__ unsigned char smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fwd + ((1024 - smem_addr(smem_fwd) % 1024) % 1024));
  bf16* ring = qs + kBqWg * kHd;          // stage st: keys at ring + 2 st kTileSw, values after them
  float* bias_ring = reinterpret_cast<float*>(ring + 2 * kStages * kTileSw);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, t = a.t;
  const int q0 = blockIdx.x * kBqWg, head = blockIdx.y, b = blockIdx.z;
  const int plane = b * gridDim.y + head;
  const int row_g = q0 + wg * 64 + warp * 16 + g;   // the thread's rows row_g and row_g + 8
  const bf16* kg = a.k + b * a.ks.b + head * a.ks.h;
  const bf16* vg = a.v + b * a.vs.b + head * a.vs.h;
  const float* bg = a.bias + (long long)b * t;
  const bf16* qw = qs + wg * 64 * kHd;              // the warpgroup's rows of q
  const int n = (t + kBk - 1) / kBk;                // key tiles: steps 0 .. n - 1 walk them
                                                    // for the row stats, n .. 2n - 1 again

  // step s: the keys of its tile (and in pass 2 the values) and their biases
  // into stage s % kStages, which step s - kStages read
  auto load_step = [&](int s) {
    const int st = s % kStages, k0 = (s < n ? s : s - n) * kBk;
    bf16* kd = ring + 2 * st * kTileSw;
    load_tile_sw128_async<kBk, kThreadsWg>(kd, kg, a.ks.t, k0, t);
    if (s >= n) load_tile_sw128_async<kBk, kThreadsWg>(kd + kTileSw, vg, a.vs.t, k0, t);
    if (threadIdx.x < kBk) {
      float* bd = bias_ring + st * kBk + threadIdx.x;
      if (k0 + (int)threadIdx.x < t) cp_async4(bd, bg + k0 + threadIdx.x);
      else *bd = -INFINITY;               // keys past t: zero weight, no part in the max
    }
  };
  // waits for step s's stage, keeps step s + kAhead's in flight; one barrier a
  // step: the stage loaded here was last read in step s - 2, which every
  // thread finished (products waited for) before the previous step's barrier
  auto arrive = [&](int s) {
    if (s + kAhead < 2 * n) load_step(s + kAhead);
    cp_async_commit();
    cp_async_wait<kAhead>();
    fence_proxy_async();                  // the copies, seen by wgmma ...
    __syncthreads();                      // ... for everyone's copies
    return s % kStages;
  };
  // S = q.k^T of the warpgroup's 64 rows and the stage's 64 keys, scaled and biased
  auto scores = [&](float (&s)[32], int st) {
    const bf16* kt = ring + 2 * st * kTileSw;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wgmma_m64n64k16_ss(s, sw128_desc(qw + kk * 16), sw128_desc(kt + kk * 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    scale_bias(s, bias_ring + st * kBk, a.sm_scale, tq);
  };

  load_tile_sw128_async<kBqWg, kThreadsWg>(qs, a.q + b * a.qs.b + head * a.qs.h, a.qs.t, q0, t);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {      // q joins step 0's group
    if (s < 2 * n) load_step(s);
    cp_async_commit();
  }

  // pass 1: each row's max and sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    float s[32];
    scores(s, arrive(j));
    row_stats(s, m_run, l_run);
  }
  if (a.stats != nullptr && tq == 0) {    // a training forward leaves them for the backward
    const long long planes_t = (long long)gridDim.z * gridDim.y * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row_g + 8 * h < t) {
        float* st = a.stats + (long long)plane * t + row_g + 8 * h;
        st[0] = m_run[h];
        st[planes_t] = l_run[h];
      }
    }
  }
  const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};

  // pass 2: probabilities, mask, context
  const PhiloxRow prow = philox_row(a.drop, plane, row_g + 8 * (tq & 1));   // this thread's calls
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int st = arrive(n + j), k0 = j * kBk;
    float s[32];
    scores(s, st);
    unsigned pa[4][4];   // the A fragments of keys 16 kk .. + 15: normalised in f32, then cast
#pragma unroll
    for (int c = 0; c < 8; ++c) {          // 8-column accumulator tile c
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = expf(s[4 * c + i] - m_run[i >> 1]) * inv_l[i >> 1];
      if constexpr (kDrop != 0) {
        unsigned bits[4];
        acc_bits<kDrop>(a.drop, prow, plane, t, row_g, k0 + 8 * c, lane, bits);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = drop_prob_bf16(p[i], bits[i] >= a.drop.thresh, a.inv_keep);
      }
      // A layout: a0 (row g, keys 2t..), a1 (row g + 8), a2 / a3 the same 8 keys on
      pa[c >> 1][2 * (c & 1)] = pack_bf16(p[0], p[1]);
      pa[c >> 1][2 * (c & 1) + 1] = pack_bf16(p[2], p[3]);
    }
    const bf16* vt = ring + (2 * st + 1) * kTileSw;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      wgmma_m64n64k16<1>(o, pa[kk], sw128_desc(vt + kk * 16 * kHd), 1);
    wgmma_commit();
    wgmma_wait<0>();                      // the stage is read before step j + 2 reloads it
    wgmma_hold(o);
  }

  // the warpgroup's rows of q are read by no product any more: the warp
  // stages its 16 rows of the context there (swizzled, so that neither the
  // 4-byte writes nor the 16-byte reads meet a bank twice), then stores them
  // with 16-byte stores
  bf16* ow = qs + (wg * 64 + warp * 16) * kHd;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int off = ((c ^ g) << 3) + 2 * tq;
    *reinterpret_cast<unsigned*>(ow + g * kHd + off) = pack_bf16(o[4 * c], o[4 * c + 1]);
    *reinterpret_cast<unsigned*>(ow + (g + 8) * kHd + off) = pack_bf16(o[4 * c + 2], o[4 * c + 3]);
  }
  __syncwarp();
  bf16* og = a.out + b * a.os.b + head * a.os.h;
  const int row0 = q0 + wg * 64 + warp * 16;
#pragma unroll
  for (int idx = lane; idx < 16 * 8; idx += 32) {
    const int r = idx >> 3, c = idx & 7;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(og + (long long)(row0 + r) * a.os.t + (c << 3)) =
          *reinterpret_cast<const uint4*>(ow + r * kHd + ((c ^ (r & 7)) << 3));
  }
}

template <int kDrop>
int launch_bf16(const FwdArgs& a, int b, int nh, void* stream) {
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBf16);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.t + kBqWg - 1) / kBqWg, nh, b);
  attention_bf16_kernel<kDrop><<<grid, kThreadsWg, kSmemBf16, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- f32 kernel with dropout
// Plain FMAs so that the result is true f32.  A warp keeps its 16 x 64 scores
// and probabilities in shared memory; lane c owns columns c and c + 32 of both
// products; two lanes share a row of the softmax.
constexpr size_t kSmemF32 =
    (size_t)(3 * kBq * 65 + kWarps * kRows * 65 + kWarps * kRows * kLdS + kBk) * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int t,
                     long long qsb, long long qsh, long long qst,
                     long long ksb, long long ksh, long long kst,
                     long long vsb, long long vsh, long long vst,
                     long long osb, long long osh, long long ost, float sm_scale, Drop drop,
                     float* __restrict__ stats) {
  constexpr int ld = Cfg<float>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBq * ld;
  float* vs = ks + kBk * ld;
  float* ps = vs + kBk * ld;                       // [warps][16][ld] probabilities
  float* ss = ps + kWarps * kRows * ld;            // [warps][16][kLdS] scores
  float* bias_s = ss + kWarps * kRows * kLdS;      // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const float* qg = q + b * qsb + head * qsh;
  const float* kg = k + b * ksb + head * ksh;
  const float* vg = v + b * vsb + head * vsh;
  const float* bg = bias + (long long)b * t;

  float* qw = qs + warp * kRows * ld;
  float* pw = ps + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdS;

  load_tile<float>(qs, qg, qst, q0, t);
  __syncthreads();
  float o0[kRows], o1[kRows];   // columns lane and lane + 32 of the warp's 16 rows
  for (int r = 0; r < kRows; ++r) o0[r] = o1[r] = 0.f;

  // two lanes share a row: lane = 2 * row + half, columns half, half + 2, ...
  const int row = lane >> 1, half = lane & 1;
  float m_run = -INFINITY, l_run = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < t; k0 += kBk) {
      __syncthreads();                 // the previous tile is no longer read
      load_tile<float>(ks, kg, kst, k0, t);
      if (pass == 1) load_tile<float>(vs, vg, vst, k0, t);
      if (threadIdx.x < kBk)           // keys past t get -inf: zero weight, no part in the max
        bias_s[threadIdx.x] = (k0 + threadIdx.x < t) ? bg[k0 + threadIdx.x] : -INFINITY;
      __syncthreads();
      f32_abT(qw, ks, sw);
      __syncwarp();
      if (pass == 0) {
        float mx = -INFINITY;
        for (int c = half; c < kBk; c += 2)
          mx = fmaxf(mx, sw[row * kLdS + c] * sm_scale + bias_s[c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.f;
        for (int c = half; c < kBk; c += 2)
          sum += expf(sw[row * kLdS + c] * sm_scale + bias_s[c] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
      } else {
        for (int c = half; c < kBk; c += 2)
          pw[row * ld + c] = expf(sw[row * kLdS + c] * sm_scale + bias_s[c] - m_run) / l_run;
        __syncwarp();
        if constexpr (kDrop != 0) {
          // one item = four neighbouring columns of a row = one Philox call
          for (int idx = lane; idx < kRows * (kBk / 4); idx += 32) {
            const int r = idx / (kBk / 4), c4 = idx % (kBk / 4);
            const uint4 w = row_bits<kDrop>(drop, b * gridDim.y + head, t, q0 + warp * kRows + r,
                                            k0 / 4 + c4);
            const unsigned bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float* p = pw + r * ld + c4 * 4 + i;
              *p = bits[i] >= drop.thresh ? *p / drop.keep_div : 0.f;
            }
          }
          __syncwarp();
        }
        f32_ab(o0, o1, pw, ld, vs);
      }
      __syncwarp();                    // sw is rewritten by the next tile
    }
    if (pass == 0 && stats != nullptr && half == 0 && q0 + warp * kRows + row < t) {
      const long long planes_t = (long long)gridDim.z * gridDim.y * t;
      float* st = stats + (long long)(b * gridDim.y + head) * t + q0 + warp * kRows + row;
      st[0] = m_run;
      st[planes_t] = l_run;
    }
  }

  for (int r = 0; r < kRows; ++r) {
    sw[r * kLdS + lane] = o0[r];
    sw[r * kLdS + lane + 32] = o1[r];
  }
  __syncwarp();
  float* og = out + b * osb + head * osh;
  for (int idx = lane; idx < kRows * (kHd / 4); idx += 32) {
    const int r = idx / (kHd / 4), cv = (idx % (kHd / 4)) * 4;
    const int qrow = q0 + warp * kRows + r;
    if (qrow < t)
      *reinterpret_cast<float4*>(og + (long long)qrow * ost + cv) =
          make_float4(sw[r * kLdS + cv], sw[r * kLdS + cv + 1], sw[r * kLdS + cv + 2],
                      sw[r * kLdS + cv + 3]);
  }
}

// ------------------------------------------- f32 kernel without dropout: 3xTF32
// K2 in f32 (the evaluation's encode) on the tensor cores at f32 accuracy:
// both products by mma.sync m16n8k8 in TF32, each operand split into hi and
// lo parts in registers (tf32_split, common.cuh) and summed as lo.hi + hi.lo +
// hi.hi.  Without dropout the probabilities are not rounded before p.v, so
// the keys are walked once with an online softmax: per 64-key tile the
// running max m and sum l are updated, the context rescaled by exp(m - m'),
// and e = exp(s - m') (unnormalised) multiplied into it; the context is
// divided by l at the end -- sum(e v) / l where the two-pass form has
// sum((e / l) v), a difference of f32 roundings.  It serves the forward
// without a backward: a forward that must leave m and l for the f32 backward
// (training in f32, a check path) runs attention_f32_kernel, whose FMA
// products are the backward's.
//
// A warp owns 16 query rows (a block 64), and splits q's A fragments once,
// into shared memory.  Key and value tiles come by cp.async into a ring of
// kStagesTf32 stages.  The k order inside each 8-wide mma step is permuted so
// that no fragment needs a shuffle: A column tq holds element 2 tq and column
// tq + 4 element 2 tq + 1, so q's two elements are one float2 load, the
// score accumulator (c0, c1 = columns 2 tq, 2 tq + 1 of a row) is already
// p.v's A fragment, and B takes the same pairs: a key tile's float2 at (key
// g, dims 2 tq, + 1) for q.k^T, the value tile's rows 2 tq and 2 tq + 1 at
// column g for p.v.  Pitches: 72 floats for keys (conflict-free float2
// reads), 68 for values (conflict-free scalar reads of rows 2 tq, 2 tq + 1).
constexpr int kLdKf = 72, kLdVf = 68;
constexpr int kStageTf32 = kBk * (kLdKf + kLdVf) + kBk;   // floats: keys, values, biases
// 2: tile j + 1 loads while tile j is computed; 1: it loads after, and other
// blocks on the SM fill the wait (kBlocksTf32 of them)
constexpr int kStagesTf32 = 2, kBlocksTf32 = 2;
// the stages, then q's split A fragments: [warp][k-step][hi, lo][lane][4]
constexpr int kQFragTf32 = kWarps * (kHd / 8) * 2 * 32 * 4;
constexpr size_t kSmemTf32 = ((size_t)kStagesTf32 * kStageTf32 + kQFragTf32) * sizeof(float);

// c += a . b, a [16, 8] and b [8, 8] TF32 (low 13 bits zero), c f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += a_lo . b_hi + a_hi . b_lo: the cross terms of a split product whose
// b = (b0, b1) is split here
__device__ __forceinline__ void mma_cross(float (&c)[4], const float (&ah)[4], const float (&al)[4],
                                          float b0, float b1) {
  float bh0, bl0, bh1, bl1;
  tf32_split(b0, bh0, bl0);
  tf32_split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
}

// c += a_hi . b_hi
__device__ __forceinline__ void mma_hihi(float (&c)[4], const float (&ah)[4], float b0, float b1) {
  mma_tf32(c, ah, tf32_round(b0), tf32_round(b1));
}

__global__ void __launch_bounds__(kThreads, kBlocksTf32)
attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ bias,
                        float* __restrict__ out, int t, Strides qs, Strides ks, Strides vs,
                        Strides os, float sm_scale) {
  extern __shared__ __align__(16) float smem_tf32[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const int row_g = q0 + warp * kRows + g;          // the thread's rows row_g and row_g + 8
  const float* qg = q + b * qs.b + head * qs.h;
  const float* kg = k + b * ks.b + head * ks.h;
  const float* vg = v + b * vs.b + head * vs.h;
  const float* bg = bias + (long long)b * t;
  const int n = (t + kBk - 1) / kBk;

  // tile j's keys, values and biases into its stage (zeros and -inf past t)
  auto load = [&](int j) {
    float* kd = smem_tf32 + (j % kStagesTf32) * kStageTf32;
    float* vd = kd + kBk * kLdKf;
    float* bd = vd + kBk * kLdVf;
    const int k0 = j * kBk;
    for (int idx = threadIdx.x; idx < kBk * (kHd / 4); idx += kThreads) {
      const int r = idx / (kHd / 4), c = (idx % (kHd / 4)) * 4;
      const bool valid = k0 + r < t;
      cp_async16(kd + r * kLdKf + c, valid ? kg + (long long)(k0 + r) * ks.t + c : kg, valid);
      cp_async16(vd + r * kLdVf + c, valid ? vg + (long long)(k0 + r) * vs.t + c : vg, valid);
    }
    if (threadIdx.x < kBk) {
      if (k0 + (int)threadIdx.x < t) cp_async4(bd + threadIdx.x, bg + k0 + threadIdx.x);
      else bd[threadIdx.x] = -INFINITY;   // keys past t: zero weight, no part in the max
    }
  };
  load(0);
  cp_async_commit();

  // q's A fragments, split: a[0] / a[1] rows g / g + 8 at dim 8 kk + 2 tq,
  // a[2] / a[3] the same rows at dim 8 kk + 2 tq + 1.  Each thread keeps its
  // own in shared memory (one 16-byte load a part and k-step, no conflicts):
  // in registers they would take 64 a thread and push the walk into spills.
  float4* qfrag = reinterpret_cast<float4*>(smem_tf32 + kStagesTf32 * kStageTf32) +
                  warp * (kHd / 8) * 2 * 32 + lane;   // + (2 kk + part) * 32
#pragma unroll
  for (int kk = 0; kk < kHd / 8; ++kk) {
    float hi[4], lo[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_g + 8 * h;
      float2 x = make_float2(0.f, 0.f);
      if (row < t) x = *reinterpret_cast<const float2*>(qg + (long long)row * qs.t + 8 * kk + 2 * tq);
      tf32_split(x.x, hi[h], lo[h]);
      tf32_split(x.y, hi[2 + h], lo[2 + h]);
    }
    qfrag[2 * kk * 32] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    qfrag[(2 * kk + 1) * 32] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }

  float o[kHd / 8][4];
#pragma unroll
  for (int c = 0; c < kHd / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n; ++j) {
    if constexpr (kStagesTf32 == 2) {
      if (j + 1 < n) load(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // tile j's copies, everyone's
    const float* kt = smem_tf32 + (j % kStagesTf32) * kStageTf32;
    const float* vt = kt + kBk * kLdKf;
    const float* bt = vt + kBk * kLdVf;

    // s[c]: rows g, g + 8 at keys 8 c + 2 tq, + 1 (the accumulator layout).
    // The tensor cores add into an accumulator with truncation, up to an ulp
    // of the sum an addition: the cross terms of all k-steps go into their
    // own accumulator (a sum ~2^-11 the scores' size), the hi.hi terms into
    // s, and the two meet in one f32 addition.
    float s[kBk / 8][4], x[kBk / 8][4];
#pragma unroll
    for (int c = 0; c < kBk / 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[c][i] = x[c][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk) {
      const float4 h4 = qfrag[2 * kk * 32], l4 = qfrag[(2 * kk + 1) * 32];
      const float qh[4] = {h4.x, h4.y, h4.z, h4.w}, ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int c = 0; c < kBk / 8; ++c) {
        const float2 kv = *reinterpret_cast<const float2*>(kt + (8 * c + g) * kLdKf + 8 * kk + 2 * tq);
        mma_cross(x[c], qh, ql, kv.x, kv.y);
        mma_hihi(s[c], qh, kv.x, kv.y);
      }
    }
#pragma unroll
    for (int c = 0; c < kBk / 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[c][i] += x[c][i];
    // scale, bias, online max and sum of rows g (h = 0) and g + 8 (h = 1)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBk / 8; ++c) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * c + 2 * tq);
        s[c][2 * h] = s[c][2 * h] * sm_scale + bb.x;
        s[c][2 * h + 1] = s[c][2 * h + 1] * sm_scale + bb.y;
        mx = fmaxf(mx, fmaxf(s[c][2 * h], s[c][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kBk / 8; ++c) {
        s[c][2 * h] = expf(s[c][2 * h] - m_new);
        s[c][2 * h + 1] = expf(s[c][2 * h + 1] - m_new);
        sum += s[c][2 * h] + s[c][2 * h + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[h] = expf(m_run[h] - m_new);     // 0 on the first tile
      l_run[h] = l_run[h] * corr[h] + sum;
      m_run[h] = m_new;
    }
    // pv = e . v of this tile alone, in a fresh accumulator (its truncating
    // additions at the tile's size, not the whole sum's), cross terms over
    // the tile first and the hi.hi terms on top; e's k-step c is keys 8 c ..
    // + 7, its A fragment the accumulator's own values (a[0], a[1]: key 2 tq
    // of rows g, g + 8; a[2], a[3]: key 2 tq + 1)
    float pv[kHd / 8][4];
#pragma unroll
    for (int nn = 0; nn < kHd / 8; ++nn) pv[nn][0] = pv[nn][1] = pv[nn][2] = pv[nn][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kBk / 8; ++c) {
      float eh[4], el[4];
      tf32_split(s[c][0], eh[0], el[0]);
      tf32_split(s[c][2], eh[1], el[1]);
      tf32_split(s[c][1], eh[2], el[2]);
      tf32_split(s[c][3], eh[3], el[3]);
      const float* v0 = vt + (8 * c + 2 * tq) * kLdVf + g;
#pragma unroll
      for (int nn = 0; nn < kHd / 8; ++nn) mma_cross(pv[nn], eh, el, v0[8 * nn], v0[kLdVf + 8 * nn]);
    }
#pragma unroll
    for (int c = 0; c < kBk / 8; ++c) {
      const float eh[4] = {tf32_round(s[c][0]), tf32_round(s[c][2]), tf32_round(s[c][1]),
                           tf32_round(s[c][3])};
      const float* v0 = vt + (8 * c + 2 * tq) * kLdVf + g;
#pragma unroll
      for (int nn = 0; nn < kHd / 8; ++nn) mma_hihi(pv[nn], eh, v0[8 * nn], v0[kLdVf + 8 * nn]);
    }
#pragma unroll
    for (int nn = 0; nn < kHd / 8; ++nn) {
      o[nn][0] = fmaf(o[nn][0], corr[0], pv[nn][0]);
      o[nn][1] = fmaf(o[nn][1], corr[0], pv[nn][1]);
      o[nn][2] = fmaf(o[nn][2], corr[1], pv[nn][2]);
      o[nn][3] = fmaf(o[nn][3], corr[1], pv[nn][3]);
    }
    __syncthreads();                        // the stage is reloaded with tile j + kStagesTf32
    if constexpr (kStagesTf32 == 1) {
      if (j + 1 < n) load(j + 1);
      cp_async_commit();
    }
  }

  float* og = out + b * os.b + head * os.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < kHd / 8; ++c)
      *reinterpret_cast<float2*>(og + (long long)row * os.t + 8 * c + 2 * tq) =
          make_float2(o[c][2 * h] / l_run[h], o[c][2 * h + 1] / l_run[h]);
  }
}

int launch_tf32x3(const void* q, const void* k, const void* v, const void* bias, void* out,
                  int b, int nh, int t, const long long* s, float sm_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemTf32);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBq - 1) / kBq, nh, b);
  attention_tf32x3_kernel<<<grid, kThreads, kSmemTf32, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (float*)out, t,
      Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
      Strides{s[9], s[10], s[11]}, sm_scale);
  return (int)cudaGetLastError();
}

template <int kDrop>
int launch_f32(const void* q, const void* k, const void* v, const void* bias, void* out, int b,
               int nh, int t, const long long* s, float sm_scale, const Drop& drop, void* stats,
               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemF32);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBq - 1) / kBq, nh, b);
  attention_f32_kernel<kDrop><<<grid, kThreads, kSmemF32, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (float*)out, t, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], sm_scale, drop,
      (float*)stats);
  return (int)cudaGetLastError();
}

bool bad_grid(int b, int nh, int t) { return b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535; }

}  // namespace

// mode: 0 no dropout, 1 Philox bits from (seed, c0), 2 bits from the operand;
// keep_div: 1 - p rounded to the compute type; stats: null, or a [2 or more,
// b * nh, t] f32 array that receives each row's max (plane 0) and sum (plane
// 1) for the backward
extern "C" int aspire_attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                                     void* out, int b, int nh, int t, long long qsb, long long qsh,
                                     long long qst, long long ksb, long long ksh, long long kst,
                                     long long vsb, long long vsh, long long vst, long long osb,
                                     long long osh, long long ost, float sm_scale, int mode,
                                     unsigned long long seed, unsigned c0, unsigned thresh,
                                     float keep_div, const void* bits, void* stats, void* stream) {
  if (bad_grid(b, nh, t)) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.bias = (const float*)bias; a.out = (bf16*)out; a.stats = (float*)stats; a.t = t;
  a.qs = {qsb, qsh, qst}; a.ks = {ksb, ksh, kst}; a.vs = {vsb, vsh, vst}; a.os = {osb, osh, ost};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;            // as the backward takes it (attention_bwd.cu)
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits};
  if (mode == 0) return launch_bf16<0>(a, b, nh, stream);
  if (mode == 1) return launch_bf16<1>(a, b, nh, stream);
  if (mode == 2 && bits != nullptr) return launch_bf16<2>(a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int aspire_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int b, int nh, int t, long long qsb, long long qsh,
                                    long long qst, long long ksb, long long ksh, long long kst,
                                    long long vsb, long long vsh, long long vst, long long osb,
                                    long long osh, long long ost, float sm_scale, int mode,
                                    unsigned long long seed, unsigned c0, unsigned thresh,
                                    float keep_div, const void* bits, void* stats, void* stream) {
  if (bad_grid(b, nh, t)) return (int)cudaErrorInvalidValue;
  const long long s[12] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  const Drop drop = {seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits};
  // the inference forward (no row statistics wanted) on the tensor cores; the
  // forward that leaves m and l for the FMA backward keeps that backward's FMA
  // products, so that the two compute the same probabilities
  if (mode == 0 && stats == nullptr)
    return launch_tf32x3(q, k, v, bias, out, b, nh, t, s, sm_scale, stream);
  if (mode == 0) return launch_f32<0>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  if (mode == 1) return launch_f32<1>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  if (mode == 2 && bits != nullptr)
    return launch_f32<2>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  return (int)cudaErrorInvalidValue;
}
