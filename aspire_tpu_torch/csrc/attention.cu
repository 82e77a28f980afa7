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
//     read, through a ring of kStagesW stages loaded kStagesW - 2 steps ahead
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
// The bf16 kernel is one template over the head width (64, 128, 192, 256:
// wider heads than 64 are padded to the next of them by the wrapper), so the
// rounding, the Philox mapping and the statistics are the 64-wide kernel's at
// every width; the bf16 kernel section below says how the tile follows it.
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
// f32 runs on the tensor cores as split-TF32 (3xTF32) mma.sync products at
// f32 accuracy, at every head width: at 64 attention_tf32x3_kernel walks the
// keys once (the inference forward), attention_tf32x3_walk_kernel twice (the
// forward that leaves the row statistics for the backward, and every forward
// with dropout); at 128, 192 and 256 the walk kernel does both, instantiated
// at the width; see the f32 section below.
#include "attention_tile.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

struct Strides { long long b, h, t; };

// ---------------------------------------------------------------- bf16 kernel
// The kernel is one template over the head width kW (64, 128, 192, 256).  A
// [rows][kW] operand lies in shared memory as kW / 64 column blocks of
// [rows][64] in the 128-byte swizzle (load_tile_sw128_async): q.k^T steps its
// descriptors over the blocks (K-major, kW / 16 k-steps), pd.v takes one
// m64n64k16 product a block (the value tile MN-major) into kW / 64
// accumulators of 32 floats.  Shared memory and registers set the tile a
// width takes (BfCfg):
//   - 64: 64-key tiles, 4 stages (82 KB), 2 blocks an SM at 128 registers;
//   - 128: 64-key tiles, 4 stages (162 KB): the context is 64 registers a
//     thread and the block one an SM either way, so the ring is deep;
//   - 192: 64-key tiles, 3 stages (194 KB: a fourth would pass 227 KB);
//   - 256: q for 128 rows is 64 KB and a stage of 64 keys 64 KB, so 32-key
//     tiles (m64n32k16 scores, 16 a thread) and 4 stages of 32 KB (194 KB);
//     the context takes 128 registers.
// Two warpgroups a block at every width: the key and value tiles are loaded
// once for 128 query rows.
constexpr int kWg = 2;                    // warpgroups a block, 64 query rows each
constexpr int kBqWg = 64 * kWg;           // query rows a block
constexpr int kThreadsWg = 128 * kWg;

template <int kW> struct BfCfg;           // keys a tile, stages of the ring, blocks an SM
template <> struct BfCfg<64> { static constexpr int bk = 64, stages = 4, blocks = 2; };
template <> struct BfCfg<128> { static constexpr int bk = 64, stages = 4, blocks = 1; };
template <> struct BfCfg<192> { static constexpr int bk = 64, stages = 3, blocks = 1; };
template <> struct BfCfg<256> { static constexpr int bk = 32, stages = 4, blocks = 1; };

// q [128][kW], then a key and a value tile [bk][kW] a stage (all in the
// 128-byte swizzle), then the keys' biases a stage; 1 KB to align the base
template <int kW>
constexpr size_t smem_bf16() {
  using C = BfCfg<kW>;
  return 1024 + (size_t)(kBqWg * kW + 2 * C::stages * C::bk * kW) * sizeof(bf16) +
         (size_t)C::stages * C::bk * sizeof(float);
}
static_assert(smem_bf16<64>() == 83968, "the 64-wide kernel keeps its layout");
static_assert(smem_bf16<192>() <= 232448 && smem_bf16<256>() <= 232448, "one block fits");

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
// rows g (i < 2) and g + 8, columns 8 j + 2 t + (i & 1)), kN 8-column tiles
template <int kN>
__device__ __forceinline__ void scale_bias(float (&s)[4 * kN], const float* bias_s, float sm_scale,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
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
template <int kN>
__device__ __forceinline__ void row_stats(const float (&s)[4 * kN], float (&m_run)[2],
                                          float (&l_run)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j)
      sum += exp_sfu(s[4 * j + 2 * h] - m_new) + exp_sfu(s[4 * j + 2 * h + 1] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run[h] = l_run[h] * exp_sfu(m_run[h] - m_new) + sum;
    m_run[h] = m_new;
  }
}

// S += A . B of one k-step, the score tile 64 (32 at width 256) keys wide
__device__ __forceinline__ void wgmma_scores(float (&s)[32], unsigned long long a,
                                             unsigned long long b, int accumulate) {
  wgmma_m64n64k16_ss(s, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_scores(float (&s)[16], unsigned long long a,
                                             unsigned long long b, int accumulate) {
  wgmma_m64n32k16_ss(s, a, b, accumulate);
}

template <int kW, int kDrop>
__global__ void __launch_bounds__(kThreadsWg, BfCfg<kW>::blocks) attention_bf16_kernel(const FwdArgs a) {
  constexpr int kBkW = BfCfg<kW>::bk, kStagesW = BfCfg<kW>::stages;
  constexpr int kAhead = kStagesW - 2;    // steps loaded ahead of use
  constexpr int kCb = kW / 64;            // column blocks of a row
  constexpr int kTileW = kBkW * kW;       // elements of a key (value) tile
  constexpr int kN = kBkW / 8;            // 8-column accumulator tiles of a score tile
  extern __shared__ unsigned char smem_fwd[];
  bf16* qs = reinterpret_cast<bf16*>(smem_fwd + ((1024 - smem_addr(smem_fwd) % 1024) % 1024));
  bf16* ring = qs + kBqWg * kW;           // stage st: keys at ring + 2 st kTileW, values after them
  float* bias_ring = reinterpret_cast<float*>(ring + 2 * kStagesW * kTileW);

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, t = a.t;
  const int q0 = blockIdx.x * kBqWg, head = blockIdx.y, b = blockIdx.z;
  const int plane = b * gridDim.y + head;
  const int row_g = q0 + wg * 64 + warp * 16 + g;   // the thread's rows row_g and row_g + 8
  const bf16* kg = a.k + b * a.ks.b + head * a.ks.h;
  const bf16* vg = a.v + b * a.vs.b + head * a.vs.h;
  const float* bg = a.bias + (long long)b * t;
  const bf16* qw = qs + wg * 64 * 64;               // the warpgroup's rows of q (in each block)
  const int n = (t + kBkW - 1) / kBkW;              // key tiles: steps 0 .. n - 1 walk them
                                                    // for the row stats, n .. 2n - 1 again

  // step s: the keys of its tile (and in pass 2 the values) and their biases
  // into stage s % kStagesW, which step s - kStagesW read
  auto load_step = [&](int s) {
    const int st = s % kStagesW, k0 = (s < n ? s : s - n) * kBkW;
    bf16* kd = ring + 2 * st * kTileW;
    load_tile_sw128_async<kBkW, kThreadsWg, kW>(kd, kg, a.ks.t, k0, t);
    if (s >= n) load_tile_sw128_async<kBkW, kThreadsWg, kW>(kd + kTileW, vg, a.vs.t, k0, t);
    if (threadIdx.x < kBkW) {
      float* bd = bias_ring + st * kBkW + threadIdx.x;
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
    return s % kStagesW;
  };
  // S = q.k^T of the warpgroup's 64 rows and the stage's keys, scaled and biased
  auto scores = [&](float (&s)[4 * kN], int st) {
    const bf16* kt = ring + 2 * st * kTileW;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk)
      wgmma_scores(s, kmajor_desc<kBqWg>(qw, kk), kmajor_desc<kBkW>(kt, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    scale_bias<kN>(s, bias_ring + st * kBkW, a.sm_scale, tq);
  };

  load_tile_sw128_async<kBqWg, kThreadsWg, kW>(qs, a.q + b * a.qs.b + head * a.qs.h, a.qs.t, q0, t);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {      // q joins step 0's group
    if (s < 2 * n) load_step(s);
    cp_async_commit();
  }

  // pass 1: each row's max and sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    float s[4 * kN];
    scores(s, arrive(j));
    row_stats<kN>(s, m_run, l_run);
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
  float o[kCb][32];                       // the context, a 64-column block each
#pragma unroll
  for (int cb = 0; cb < kCb; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int st = arrive(n + j), k0 = j * kBkW;
    float s[4 * kN];
    scores(s, st);
    unsigned pa[kBkW / 16][4];   // the A fragments of keys 16 kk .. + 15: normalised in f32, then cast
#pragma unroll
    for (int c = 0; c < kN; ++c) {        // 8-column accumulator tile c
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
    const bf16* vt = ring + (2 * st + 1) * kTileW;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBkW / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < kCb; ++cb)
        wgmma_m64n64k16<1>(o[cb], pa[kk], sw128_desc(vt + cb * kBkW * 64 + kk * 16 * 64), 1);
    wgmma_commit();
    wgmma_wait<0>();                      // the stage is read before step j + 2 reloads it
#pragma unroll
    for (int cb = 0; cb < kCb; ++cb) wgmma_hold(o[cb]);
  }

  // the warpgroup's rows of q are read by no product any more: the warp
  // stages its 16 rows of each column block of the context there (swizzled,
  // so that neither the 4-byte writes nor the 16-byte reads meet a bank
  // twice), then stores them with 16-byte stores
  bf16* og = a.out + b * a.os.b + head * a.os.h;
  const int row0 = q0 + wg * 64 + warp * 16;
#pragma unroll
  for (int cb = 0; cb < kCb; ++cb) {
    bf16* ow = qs + cb * kBqWg * 64 + (wg * 64 + warp * 16) * 64;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int off = ((c ^ g) << 3) + 2 * tq;
      *reinterpret_cast<unsigned*>(ow + g * 64 + off) = pack_bf16(o[cb][4 * c], o[cb][4 * c + 1]);
      *reinterpret_cast<unsigned*>(ow + (g + 8) * 64 + off) =
          pack_bf16(o[cb][4 * c + 2], o[cb][4 * c + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int idx = lane; idx < 16 * 8; idx += 32) {
      const int r = idx >> 3, c = idx & 7;
      if (row0 + r < t)
        *reinterpret_cast<uint4*>(og + (long long)(row0 + r) * a.os.t + cb * 64 + (c << 3)) =
            *reinterpret_cast<const uint4*>(ow + r * 64 + ((c ^ (r & 7)) << 3));
    }
  }
}

template <int kW, int kDrop>
int launch_bf16(const FwdArgs& a, int b, int nh, void* stream) {
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<kW, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bf16<kW>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.t + kBqWg - 1) / kBqWg, nh, b);
  attention_bf16_kernel<kW, kDrop><<<grid, kThreadsWg, smem_bf16<kW>(), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kDrop>
int launch_bf16_at(int hd, const FwdArgs& a, int b, int nh, void* stream) {
  switch (hd) {
    case 64: return launch_bf16<64, kDrop>(a, b, nh, stream);
    case 128: return launch_bf16<128, kDrop>(a, b, nh, stream);
    case 192: return launch_bf16<192, kDrop>(a, b, nh, stream);
    case 256: return launch_bf16<256, kDrop>(a, b, nh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------- f32 kernels: 3xTF32
// Both products on the tensor cores at f32 accuracy: mma.sync m16n8k8 in
// TF32, each operand split into hi and lo parts in registers (tf32_split,
// common.cuh) and summed as lo.hi + hi.lo + hi.hi (attention_tile.cuh).  A
// warp owns 16 query rows (a block 64); key and value tiles come by cp.async
// into a ring of kStagesTf32 stages.  The k order inside each 8-wide mma step
// is permuted (attention_tile.cuh), so that no fragment needs a shuffle: q's
// two elements of a step are one float2, the score accumulator is already
// p.v's A fragment, and B takes the same pairs: a key tile's float2 at (key
// g, dims 2 tq, + 1) for q.k^T, the value tile's rows 2 tq and 2 tq + 1 at
// column g for p.v.  Pitches: 72 floats for keys (conflict-free float2
// reads), 68 for values (conflict-free scalar reads of rows 2 tq, 2 tq + 1).
//
// attention_tf32x3_kernel (K2 in f32, the evaluation's encode: no dropout, no
// backward to feed) walks the keys once with an online softmax: per 64-key
// tile the running max m and sum l are updated, the context rescaled by
// exp(m - m'), and e = exp(s - m') (unnormalised) multiplied into it; the
// context is divided by l at the end -- sum(e v) / l where the two-walk form
// has sum((e / l) v), a difference of f32 roundings.  q's split A fragments
// sit in shared memory (in registers they would take 64 a thread and push the
// walk into spills).
//
// attention_tf32x3_walk_kernel<64, kDrop, 2> (K5a in f32, and the f32 forward
// at p = 0 whose gradient is wanted) leaves each row's m and l for the
// backward and walks the keys twice: pass 1 the online m and l, pass 2 the
// same scores again, p = exp(s - m) * (1 / l) with the final m and l, the
// mask, p.v.  The backward's rows kernel (attention_bwd.cu) recomputes p from
// those m and l with the same score tile (tf32x3_scores) and the same
// arithmetic, so its p is this kernel's bit for bit.  That is why not one
// walk: the one-walk p of a key, e rescaled tile after tile, is a few ulps
// from exp(s - m) / l, and in a row where one key takes nearly all the weight,
// delta = rowsum(g * ctx) then carries that mismatch times g.v (of order 10)
// into every ds of the row: the f32 backward's dq read 2.3e-6 of its largest
// value against a 2e-6 limit so (PERF.md).  With dropout, pd = keep ? p * (1 /
// (1 - p_drop)) : 0, the product taken before the select; the mask words come
// as in the bf16 kernel (acc_bits).  Its products sum each k-step in a fresh
// accumulator added by f32 additions (tf32x3_abT, mma3_add): the gradients
// are held to 2e-6 of the f32 plain version's, and 8 truncating additions a
// score at the score's size read 2.0e-6 of dk's largest value against f32
// products whose own error there is 1.1e-6 (PERF.md).  Pass 2 takes a tile in
// two halves of 32 keys (registers).  q's fragments sit unsplit in shared
// memory and are split at each use, which keeps the block at 88 KB: two
// blocks an SM.
//
// Heads of 128, 192 and 256 run the same walk kernel at their width kW: both
// walks as above for a forward with dropout or with statistics, and for the
// inference forward (K2 in f32 at those widths) one walk with the online
// softmax, summed as attention_tf32x3_kernel sums (the scores' cross terms
// and hi.hi terms of all k-steps in two accumulators; the tile's e . v in a
// fresh one, folded into the rescaled context), but an 8-column tile of the
// context at a time: the 64-wide kernel's whole tile sum would be another kW /
// 2 registers; divided by l at the end.  Every product is the 64-wide
// kernels' split TF32 on mma.sync m16n8k8, none on the FP32 lanes.  A warp
// owns 16 query rows and all kW columns of their context (kW / 2 registers a
// thread: 64, 96, 128), a block 64 rows.  q's fragments stay unsplit in shared
// memory (64 x kW floats: 32, 48, 64 KB; split they would be twice that), and
// the key and value tiles, two stages of Tf32Cfg's keys at pitches kW + 8 and
// kW + 4 (conflict-free float2 and scalar reads, as at 64), take the rest:
//   - 128: 32-key tiles, 99 KB, two blocks an SM (8 warps, as at 64);
//   - 192: 16-key tiles, 98 KB, two blocks an SM (32-key tiles: 147 KB);
//   - 256: 16-key tiles, 130 KB, one block an SM (q alone is 64 KB; the
//     context takes 128 registers a thread, and 32-key tiles spilled up to
//     472 bytes).
// The scores come from tf32x3_scores at the width: a score is the same
// sequence of k-steps at any tile, so the backward's kernels, which tile the
// keys otherwise, recompute these probabilities bit for bit.  The other
// layouts considered for 192 and 256 -- two warps sharing 16 rows, each with
// half the context's columns and the score tile handed over in shared memory,
// or a grid axis of column halves recomputing the scores -- are not needed
// while a warp's whole context fits beside a 16- or 32-key score tile.  Tried
// at 128 and no faster (PERF.md): the inference forward with q's fragments
// and each tile's keys and values split once in shared memory, 8 warps a
// block of 128 rows, 16-key tiles (0.1349 ms against 0.1339 at [16, 6, 256,
// 128]), though it issues about a third fewer instructions.
constexpr int kLdKf = 72, kLdVf = 68;
constexpr int kStageTf32 = kBk * (kLdKf + kLdVf) + kBk;   // floats: keys, values, biases
// 2: tile j + 1 loads while tile j is computed; 1: it loads after, and other
// blocks on the SM fill the wait (kBlocksTf32 of them)
constexpr int kStagesTf32 = 2, kBlocksTf32 = 2;
// the stages, then q's A fragments: K2 split, [warp][k-step][hi, lo][lane][4];
// the forward with statistics unsplit, [warp][k-step][lane][4]
constexpr int kQFragTf32 = kWarps * (kHd / 8) * 2 * 32 * 4;
constexpr size_t kSmemTf32 = ((size_t)kStagesTf32 * kStageTf32 + kQFragTf32) * sizeof(float);
constexpr size_t kSmemStats = ((size_t)kStagesTf32 * kStageTf32 + kQFragTf32 / 2) * sizeof(float);

// the walk kernel's tile at each width: keys a tile, keys a part of pass 2,
// blocks an SM
template <int kW> struct Tf32Cfg;
template <> struct Tf32Cfg<64> { static constexpr int bk = kBk, part = 32, blocks = kBlocksTf32; };
template <> struct Tf32Cfg<128> { static constexpr int bk = 32, part = 16, blocks = 2; };
template <> struct Tf32Cfg<192> { static constexpr int bk = 16, part = 8, blocks = 2; };
template <> struct Tf32Cfg<256> { static constexpr int bk = 16, part = 8, blocks = 1; };

template <int kW> __host__ __device__ constexpr int ld_kf() { return kW + 8; }   // kLdKf at 64
template <int kW> __host__ __device__ constexpr int ld_vf() { return kW + 4; }   // kLdVf at 64
// floats of a stage: keys, values, biases
template <int kW>
__host__ __device__ constexpr int stage_tf32() {
  return Tf32Cfg<kW>::bk * (ld_kf<kW>() + ld_vf<kW>() + 1);
}
// the stages, then q's unsplit A fragments [warp][k-step][lane][4]
template <int kW>
__host__ __device__ constexpr size_t smem_walk() {
  return ((size_t)kStagesTf32 * stage_tf32<kW>() + kWarps * (kW / 8) * 32 * 4) * sizeof(float);
}
static_assert(stage_tf32<64>() == kStageTf32 && smem_walk<64>() == kSmemStats,
              "the 64-wide forward keeps its layout");
static_assert(2 * (smem_walk<128>() + 1024) <= 233472 && 2 * (smem_walk<192>() + 1024) <= 233472 &&
                  smem_walk<256>() <= 232448,
              "the wide forwards fit their blocks an SM");

// the keys (and values) of the tile from key k0 on and their biases into a
// stage, by cp.async (zeros and -inf past t)
template <int kW>
__device__ __forceinline__ void load_kv_tf32(float* kd, const float* kg, const float* vg,
                                             const float* bg, long long kst, long long vst, int k0,
                                             int t, bool values) {
  constexpr int bk = Tf32Cfg<kW>::bk, ldk = ld_kf<kW>(), ldv = ld_vf<kW>();
  load_tile_f32_async<ldk, bk, kW>(kd, kg, kst, k0, t);
  if (values) load_tile_f32_async<ldv, bk, kW>(kd + bk * ldk, vg, vst, k0, t);
  float* bd = kd + bk * (ldk + ldv);
  if (threadIdx.x < bk) {
    if (k0 + (int)threadIdx.x < t) cp_async4(bd + threadIdx.x, bg + k0 + threadIdx.x);
    else bd[threadIdx.x] = -INFINITY;   // keys past t: zero weight, no part in the max
  }
}

// step j's stage once everyone's copies have landed; with two stages, step
// j + 1's loads are started first
template <int kStage, typename Load>
__device__ __forceinline__ const float* arrive_tf32(float* smem, int j, int steps, Load load) {
  if constexpr (kStagesTf32 == 2) {
    if (j + 1 < steps) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return smem + (j % kStagesTf32) * kStage;
}

// after step j's reads: the stage is free (with one stage, step j + 1's loads
// start now)
template <typename Load>
__device__ __forceinline__ void release_tf32(int j, int steps, Load load) {
  __syncthreads();
  if constexpr (kStagesTf32 == 1) {
    if (j + 1 < steps) load(j + 1);
    cp_async_commit();
  }
}

// one tile of the online softmax of rows g (h = 0) and g + 8 (h = 1): s, the
// scaled and biased scores, becomes e = exp(s - m') with m' the new running
// max; l = l exp(m - m') + the tile's sum of e; corr = exp(m - m') (0 on the
// first tile)
template <int kN>
__device__ __forceinline__ void online_softmax(float (&s)[kN][4], float (&m_run)[2],
                                               float (&l_run)[2], float (&corr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kN; ++c) mx = fmaxf(mx, fmaxf(s[c][2 * h], s[c][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      s[c][2 * h] = expf(s[c][2 * h] - m_new);
      s[c][2 * h + 1] = expf(s[c][2 * h + 1] - m_new);
      sum += s[c][2 * h] + s[c][2 * h + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[h] = expf(m_run[h] - m_new);
    l_run[h] = l_run[h] * corr[h] + sum;
    m_run[h] = m_new;
  }
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

// kWalks 2: the forward that leaves m and l (stats, when not null) and every
// forward with dropout; kWalks 1 (the wide widths only, kDrop 0): the
// inference forward, one walk with the online softmax
template <int kW, int kDrop, int kWalks>
__global__ void __launch_bounds__(kThreads, Tf32Cfg<kW>::blocks)
attention_tf32x3_walk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             float* __restrict__ out, int t, Strides qs, Strides ks, Strides vs,
                             Strides os, float sm_scale, const Drop drop, float inv_keep,
                             float* __restrict__ stats) {
  static_assert(kWalks == 2 || (kDrop == 0 && kW > kHd), "one walk: the wide inference forward");
  constexpr int kBkW = Tf32Cfg<kW>::bk, kPart = Tf32Cfg<kW>::part / 8;   // n-tiles of a part
  constexpr int kLdK = ld_kf<kW>(), kLdV = ld_vf<kW>(), kStage = stage_tf32<kW>();
  extern __shared__ __align__(16) float smem_tf32[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const int plane = b * gridDim.y + head;
  const int row_g = q0 + warp * kRows + g;          // the thread's rows row_g and row_g + 8
  const float* kg = k + b * ks.b + head * ks.h;
  const float* vg = v + b * vs.b + head * vs.h;
  const float* bg = bias + (long long)b * t;
  // steps 0 .. n - 1 walk the key tiles, with two walks n .. 2n - 1 again
  const int n = (t + kBkW - 1) / kBkW, steps = kWalks * n;

  auto load = [&](int j) {
    load_kv_tf32<kW>(smem_tf32 + (j % kStagesTf32) * kStage, kg, vg, bg, ks.t, vs.t,
                     (j < n ? j : j - n) * kBkW, t, kWalks == 1 || j >= n);
  };
  load(0);
  cp_async_commit();
  // each thread reads back only its own fragments: no barrier
  float4* qfrag = reinterpret_cast<float4*>(smem_tf32 + kStagesTf32 * kStage) +
                  warp * (kW / 8) * 32 + lane;
  store_row_frags<kW>(qfrag, q + b * qs.b + head * qs.h, qs.t, row_g, t, tq);
  auto qa = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(qfrag[kk * 32], hi, lo); };

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  if constexpr (kWalks == 1) {
    constexpr int kN = kBkW / 8;          // 8-key n-tiles of a tile
    float o[kW / 8][4];
#pragma unroll
    for (int c = 0; c < kW / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float* kt = arrive_tf32<kStage>(smem_tf32, j, steps, load);
      const float* vt = kt + kBkW * kLdK;
      const float* bt = vt + kBkW * kLdV;
      // the scores as the 64-wide inference kernel sums them: the cross
      // terms of all k-steps in one accumulator, the hi.hi terms in another,
      // the two met by one f32 addition
      float s[kN][4], x[kN][4];
#pragma unroll
      for (int c = 0; c < kN; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[c][i] = x[c][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kW / 8; ++kk) {
        float qh[4], ql[4];
        qa(kk, qh, ql);
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const float2 kv = *reinterpret_cast<const float2*>(kt + (8 * c + g) * kLdK + 8 * kk + 2 * tq);
          mma_cross(x[c], qh, ql, kv.x, kv.y);
          mma_hihi(s[c], qh, kv.x, kv.y);
        }
      }
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * c + 2 * tq);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[c][i] = (s[c][i] + x[c][i]) * sm_scale + ((i & 1) ? bb.y : bb.x);
      }
      float corr[2];
      online_softmax<kN>(s, m_run, l_run, corr);   // s: e = exp(s - m')
      // e . v of the tile in a fresh accumulator an 8-column tile nn at a
      // time (the cross terms over the tile, then hi.hi), folded into the
      // rescaled context as the 64-wide kernel folds its tile sum
      float eh[kN][4], el[kN][4];
#pragma unroll
      for (int c = 0; c < kN; ++c) split_frag(make_float4(s[c][0], s[c][2], s[c][1], s[c][3]), eh[c], el[c]);
#pragma unroll
      for (int nn = 0; nn < kW / 8; ++nn) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const float* v0 = vt + (8 * c + 2 * tq) * kLdV + 8 * nn + g;
          mma_cross(pv, eh[c], el[c], v0[0], v0[kLdV]);
        }
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          const float* v0 = vt + (8 * c + 2 * tq) * kLdV + 8 * nn + g;
          mma_hihi(pv, eh[c], v0[0], v0[kLdV]);
        }
        o[nn][0] = fmaf(o[nn][0], corr[0], pv[0]);
        o[nn][1] = fmaf(o[nn][1], corr[0], pv[1]);
        o[nn][2] = fmaf(o[nn][2], corr[1], pv[2]);
        o[nn][3] = fmaf(o[nn][3], corr[1], pv[3]);
      }
      release_tf32(j, steps, load);
    }
#pragma unroll
    for (int c = 0; c < kW / 8; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[c][i] /= l_run[i >> 1];
    store_rows_f32<kW>(o, out + b * os.b + head * os.h, os.t, row_g, t, tq);
    return;
  }

  // pass 1: each row's max and sum
  for (int j = 0; j < n; ++j) {
    const float* kt = arrive_tf32<kStage>(smem_tf32, j, steps, load);
    float s[kBkW / 8][4], corr[2];
    tf32x3_scores<kLdK, kBkW / 8, kW>(s, qa, kt, kt + kBkW * (kLdK + kLdV), sm_scale, g, tq);
    online_softmax<kBkW / 8>(s, m_run, l_run, corr);
    release_tf32(j, steps, load);
  }
  if (stats != nullptr && tq == 0) {    // a training forward leaves them for the backward
    const long long planes_t = (long long)gridDim.z * gridDim.y * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row_g + 8 * h < t) {
        float* st = stats + (long long)plane * t + row_g + 8 * h;
        st[0] = m_run[h];
        st[planes_t] = l_run[h];
      }
    }
  }
  const float inv_l[2] = {1.f / l_run[0], 1.f / l_run[1]};

  // pass 2: probabilities, mask, context
  const PhiloxRow prow = philox_row(drop, plane, row_g + 8 * (tq & 1));   // this thread's calls
  float o[kW / 8][4];
#pragma unroll
  for (int c = 0; c < kW / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  for (int j = n; j < steps; ++j) {
    const float* kt = arrive_tf32<kStage>(smem_tf32, j, steps, load);
    const float* vt = kt + kBkW * kLdK;
#pragma unroll 1
    for (int c0 = 0; c0 < kBkW / 8; c0 += kPart) {
      float s[kPart][4];
      tf32x3_scores<kLdK, kPart, kW>(s, qa, kt + 8 * c0 * kLdK,
                                     kt + kBkW * (kLdK + kLdV) + 8 * c0, sm_scale, g, tq);
#pragma unroll
      for (int c = 0; c < kPart; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[c][i] = expf(s[c][i] - m_run[i >> 1]) * inv_l[i >> 1];
        if constexpr (kDrop != 0) {
          unsigned bits[4];
          acc_bits<kDrop>(drop, prow, plane, t, row_g, (j - n) * kBkW + 8 * (c0 + c), lane, bits);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float kept = s[c][i] * inv_keep;   // before the select: no branch
            s[c][i] = bits[i] >= drop.thresh ? kept : 0.f;
          }
        }
      }
      // o += pd.v, each k-step of 8 keys in a fresh accumulator (mma3_add):
      // pd's A fragment of step c is (s[c][0], s[c][2], s[c][1], s[c][3]), B
      // the value tile's rows 8 c + 2 tq, + 1 at column 8 nn + g
#pragma unroll
      for (int c = 0; c < kPart; ++c) {
        float ph[4], pl[4];
        split_frag(make_float4(s[c][0], s[c][2], s[c][1], s[c][3]), ph, pl);
        const float* v0 = vt + (8 * (c0 + c) + 2 * tq) * kLdV + g;
#pragma unroll
        for (int nn = 0; nn < kW / 8; ++nn) mma3_add(o[nn], ph, pl, v0[8 * nn], v0[kLdV + 8 * nn]);
      }
    }
    release_tf32(j, steps, load);
  }
  store_rows_f32<kW>(o, out + b * os.b + head * os.h, os.t, row_g, t, tq);
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

template <int kW, int kDrop, int kWalks>
int launch_walk(const void* q, const void* k, const void* v, const void* bias, void* out, int b,
                int nh, int t, const long long* s, float sm_scale, const Drop& drop, void* stats,
                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_tf32x3_walk_kernel<kW, kDrop, kWalks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_walk<kW>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBq - 1) / kBq, nh, b);
  attention_tf32x3_walk_kernel<kW, kDrop, kWalks>
      <<<grid, kThreads, smem_walk<kW>(), (cudaStream_t)stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (float*)out, t,
          Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
          Strides{s[9], s[10], s[11]}, sm_scale, drop, 1.f / drop.keep_div, (float*)stats);
  return (int)cudaGetLastError();
}

// the inference forward (no row statistics wanted) walks the keys once; the
// forward that leaves m and l for the backward, and every forward with
// dropout, twice
template <int kW>
int launch_f32_at(int mode, const void* q, const void* k, const void* v, const void* bias,
                  void* out, int b, int nh, int t, const long long* s, float sm_scale,
                  const Drop& drop, void* stats, void* stream) {
  if (mode == 0 && stats == nullptr) {
    if constexpr (kW == kHd) return launch_tf32x3(q, k, v, bias, out, b, nh, t, s, sm_scale, stream);
    else return launch_walk<kW, 0, 1>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  }
  if (mode == 0) return launch_walk<kW, 0, 2>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  if (mode == 1) return launch_walk<kW, 1, 2>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  if (mode == 2 && drop.bits != nullptr)
    return launch_walk<kW, 2, 2>(q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
  return (int)cudaErrorInvalidValue;
}

bool bad_grid(int b, int nh, int t) { return b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535; }

}  // namespace

// hd: the head width, 64, 128, 192 or 256; mode: 0 no dropout, 1 Philox bits
// from (seed, c0), 2 bits from the operand;
// plane0: the place of plane 0 in the whole batch (its Philox counter);
// keep_div: 1 - p rounded to the compute type; stats: null, or a [2 or more,
// b * nh, t] f32 array that receives each row's max (plane 0) and sum (plane
// 1) for the backward
extern "C" int aspire_attention_bf16(const void* q, const void* k, const void* v, const void* bias,
                                     void* out, int b, int nh, int t, int hd, long long qsb, long long qsh,
                                     long long qst, long long ksb, long long ksh, long long kst,
                                     long long vsb, long long vsh, long long vst, long long osb,
                                     long long osh, long long ost, float sm_scale, int mode,
                                     unsigned long long seed, unsigned c0, unsigned thresh,
                                     unsigned plane0, float keep_div, const void* bits,
                                     void* stats, void* stream) {
  if (bad_grid(b, nh, t)) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
  a.bias = (const float*)bias; a.out = (bf16*)out; a.stats = (float*)stats; a.t = t;
  a.qs = {qsb, qsh, qst}; a.ks = {ksb, ksh, kst}; a.vs = {vsb, vsh, vst}; a.os = {osb, osh, ost};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;            // as the backward takes it (attention_bwd.cu)
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits, plane0, 0u};
  if (mode == 0) return launch_bf16_at<0>(hd, a, b, nh, stream);
  if (mode == 1) return launch_bf16_at<1>(hd, a, b, nh, stream);
  if (mode == 2 && bits != nullptr) return launch_bf16_at<2>(hd, a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int aspire_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int b, int nh, int t, int hd, long long qsb,
                                    long long qsh, long long qst, long long ksb, long long ksh,
                                    long long kst, long long vsb, long long vsh, long long vst,
                                    long long osb, long long osh, long long ost, float sm_scale,
                                    int mode, unsigned long long seed, unsigned c0,
                                    unsigned thresh, unsigned plane0, float keep_div,
                                    const void* bits, void* stats, void* stream) {
  if (bad_grid(b, nh, t)) return (int)cudaErrorInvalidValue;
  const long long s[12] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
  const Drop drop = {seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits, plane0, 0u};
  switch (hd) {
    case 64: return launch_f32_at<64>(mode, q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
    case 128: return launch_f32_at<128>(mode, q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
    case 192: return launch_f32_at<192>(mode, q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
    case 256: return launch_f32_at<256>(mode, q, k, v, bias, out, b, nh, t, s, sm_scale, drop, stats, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
