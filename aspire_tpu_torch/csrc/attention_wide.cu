// Fused attention at head widths above 64 in f32: softmax(q.k^T * scale +
// bias) [dropout] . v, forward and backward.  (bf16 heads of every width run
// csrc/attention.cu and csrc/attention_bwd.cu, on wgmma.)
//
// Takes the place of the TPU kernels aspire_tpu/ops/pallas_attention.py
// (_fwd_kernel and _bwd_kernel) at the widths that the f32 kernels of
// csrc/attention.cu and csrc/attention_bwd.cu do not take: the Pallas kernels
// hold whole [t, hd] heads of any hd, those one width.  The wrapper pads a
// head of width 64 < hd <= 256 with zero columns to kHd = 128, 192 or 256
// (ops/attention_kernel.py `head_route`), which changes no result.
//
// What bounds it: the products.  At [4, 6, 512, 128] the forward's three
// products of 2 t t hd (q.k^T in each of two walks, pd.v) are 4.8 GFLOP and the
// backward's seven (scores and dpd in each of its two kernels, dq, dk, dv)
// 11.3.  This first design runs every product on the FP32 lanes (67 TFLOP/s
// at most), in true f32, fed from shared memory, and is simple rather than
// fast:
//
//   - every operand tile lives in shared memory as f32, rows of kHd + 4
//     floats (16-byte rows, and the float4 reads of 8 neighbouring rows fall
//     on 32 different banks);
//   - a block of 256 threads, ty = thread / 16 and tx = thread % 16, computes
//     a [64 query rows, 32 keys] tile of scores: thread (ty, tx) the rows
//     ty + 16 i (i < 4) at the keys tx + 16 j (j < 2), each score one chain
//     of FMAs over d = 0, 1, ... kHd - 1 (`dot_tile`).  Every kernel here
//     computes its scores with that one function, so the backward recomputes
//     the forward's scores and probabilities bit for bit;
//   - a [rows, kHd] sum (context, dq, dk, dv) is owned by thread (ty, tx) at
//     the rows ty + 16 i and the columns 4 tx + 64 c .. + 3, read from a
//     [rows][keys] tile of probabilities (or ds) in shared memory.
//
// Rounding follows csrc/attention.cu: the forward walks the keys twice, first
// each row's max m and sum l (online, expf), then probs = expf(s - m) * (1 /
// l), with dropout probs * (1 / (1 - p)), the dropped ones zero, and ctx =
// pd . v summed in f32.  m and l go to planes 0 and 1 of the [3, b * heads, t]
// statistics when asked for.  The mask word of an element is keyed on
// (plane, query row, key / 4) (common.cuh), a Philox4x32-10 call an element
// (four threads share a call's counter; each keeps its own word), or read
// from the bits operand.
//
// The backward is two launches, as the f32 one of attention_bwd.cu: a rows
// kernel (delta = rowsum(g * ctx) into plane 2, then dq = ds . k) and a keys
// kernel (dk = ds^T . q, dv = pd^T . g), each recomputing scores and dpd =
// g . v^T; probs is f32, dprobs = keep ? dpd * (1 / (1 - p)) : 0 in f32, ds =
// probs * (dprobs - delta) * scale in f32, and dv reads the forward's pd.
#include "common.cuh"

namespace {

using namespace aspire;

constexpr int kBq = 64;              // query rows a tile
constexpr int kBk = 32;              // keys a tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kLdS = kBk + 1;        // pitch of a [rows][keys] tile

struct Strides { long long b, h, t; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// rows r0 .. r0 + rows - 1 of a [t, kHd] head into dst [rows][kHd + 4] as f32,
// zeros past t
template <int kHd>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ld, int r0, int rows,
                                          int t) {
  constexpr int kQuads = kHd / 4;
  for (int idx = threadIdx.x; idx < rows * kQuads; idx += kThreads) {
    const int r = idx / kQuads, c = (idx % kQuads) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) v = load4(src + (long long)(r0 + r) * ld + c);
    *reinterpret_cast<float4*>(dst + r * (kHd + 4) + c) = v;
  }
}

// s[i][j] = a_row(ty + 16 i) . b_row(tx + 16 j), each a chain of FMAs in d order
template <int kHd>
__device__ __forceinline__ void dot_tile(float (&s)[4][2], const float* a, const float* b, int ty,
                                         int tx) {
  constexpr int kLd = kHd + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHd; d += 4) {
    float4 x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 2; ++j) y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum over k < kBk of w[ty + 16 i][k] * m[k][4 tx + 64 c .. + 3]:
// w a [kBq][kLdS] tile, m a [kBk][kHd + 4] one
template <int kHd>
__device__ __forceinline__ void acc_rows(float4 (&acc)[4][kHd / 64], const float* w, const float* m,
                                         int ty, int tx) {
  constexpr int kLd = kHd + 4;
#pragma unroll 4
  for (int k = 0; k < kBk; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = w[(ty + 16 * i) * kLdS + k];
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(m + k * kLd + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][c].x = fmaf(p[i], v.x, acc[i][c].x);
        acc[i][c].y = fmaf(p[i], v.y, acc[i][c].y);
        acc[i][c].z = fmaf(p[i], v.z, acc[i][c].z);
        acc[i][c].w = fmaf(p[i], v.w, acc[i][c].w);
      }
    }
  }
}

// acc[i][c] += sum over r < kBq of w[r][ty + 16 i] * m[r][4 tx + 64 c .. + 3]:
// the keys' sums, w a [kBq][kLdS] tile, m a [kBq][kHd + 4] one
template <int kHd>
__device__ __forceinline__ void acc_keys(float4 (&acc)[2][kHd / 64], const float* w, const float* m,
                                         int ty, int tx) {
  constexpr int kLd = kHd + 4;
#pragma unroll 4
  for (int r = 0; r < kBq; ++r) {
    float p[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) p[i] = w[r * kLdS + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(m + r * kLd + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][c].x = fmaf(p[i], v.x, acc[i][c].x);
        acc[i][c].y = fmaf(p[i], v.y, acc[i][c].y);
        acc[i][c].z = fmaf(p[i], v.z, acc[i][c].z);
        acc[i][c].w = fmaf(p[i], v.w, acc[i][c].w);
      }
    }
  }
}

// sum / max over the 16 threads of a row (lanes tx = 0 .. 15 of a half warp);
// every lane ends with the same value
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int w = 1; w < 16; w <<= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int w = 1; w < 16; w <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

// whether element (row, col) of a plane is kept: mode 0 no dropout, 1 Philox
// words, 2 the bits operand ([planes, t, t]; rows and keys past t count as kept)
__device__ __forceinline__ bool kept(const Drop& d, int mode, int plane, int t, int row, int col) {
  if (mode == 0) return true;
  unsigned word;
  if (mode == 1) {
    const uint4 w = drop_words(d, (unsigned)plane, (unsigned)row, (unsigned)col >> 2);
    const int sel = col & 3;
    word = sel == 0 ? w.x : sel == 1 ? w.y : sel == 2 ? w.z : w.w;
  } else {
    word = (row < t && col < t) ? d.bits[((long long)plane * t + row) * t + col] : 0xFFFFFFFFu;
  }
  return word >= d.thresh;
}

// the score of a dot product: what every kernel here computes from dot_tile
__device__ __forceinline__ float score(float dot, float sm_scale, float bias) {
  return fmaf(dot, sm_scale, bias);
}

// pd: the probability as the context's product takes it
__device__ __forceinline__ float drop_prob(float probs, bool keep, bool dropout, float inv_keep) {
  if (!dropout) return probs;
  const float k = probs * inv_keep;
  return keep ? k : 0.f;
}

struct Args {
  const void *q, *k, *v, *g, *out;
  const float* bias;
  void *o, *dq, *dk, *dv;  // forward: o; backward: dq, dk, dv
  float* stats;            // [3][b * heads][t]: m, l, delta (forward: null or m, l)
  int t, mode;
  Strides qs, ks, vs, gs, os, dqs, dks, dvs;
  float sm_scale;
  float inv_keep;          // 1 / (1 - p rounded to the compute type)
  float inv_keep32;        // 1 / (1 - p) in f32
  Drop drop;
};

__device__ __forceinline__ const float* head(const void* p, const Strides& s, int b, int h) {
  return reinterpret_cast<const float*>(p) + b * s.b + h * s.h;
}
__device__ __forceinline__ float* head(void* p, const Strides& s, int b, int h) {
  return reinterpret_cast<float*>(p) + b * s.b + h * s.h;
}

// key tile k0 .. k0 + kBk - 1 of a head's bias into bias_s (-inf past t)
__device__ __forceinline__ void load_bias(float* bias_s, const float* bg, int k0, int t) {
  if (threadIdx.x < kBk) {
    const int key = k0 + threadIdx.x;
    bias_s[threadIdx.x] = key < t ? bg[key] : -INFINITY;
  }
}

template <int kHd>
constexpr size_t fwd_smem() {
  return ((size_t)(kBq + 2 * kBk) * (kHd + 4) + kBq * kLdS + kBk) * sizeof(float);
}
template <int kHd>
constexpr size_t rows_smem() {
  return ((size_t)(2 * kBq + 2 * kBk) * (kHd + 4) + kBq * kLdS + kBk + 3 * kBq) * sizeof(float);
}
template <int kHd>
constexpr size_t keys_smem() {
  return ((size_t)(2 * kBq + 2 * kBk) * (kHd + 4) + 2 * kBq * kLdS + kBk + 3 * kBq) *
         sizeof(float);
}

// ------------------------------------------------------------------- forward
// grid (ceil(t / kBq), heads, batch)
template <int kHd>
__global__ void __launch_bounds__(kThreads) attention_wide_fwd_kernel(const Args a) {
  constexpr int kLd = kHd + 4;
  extern __shared__ __align__(16) float smem_wide[];
  float* qs = smem_wide;                 // [kBq][kLd]
  float* ks = qs + kBq * kLd;            // [kBk][kLd]
  float* vs = ks + kBk * kLd;            // [kBk][kLd]
  float* ps = vs + kBk * kLd;            // [kBq][kLdS]
  float* bias_s = ps + kBq * kLdS;       // [kBk]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * kBq, hh = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + hh;
  const float* kg = head(a.k, a.ks, b, hh);
  const float* vg = head(a.v, a.vs, b, hh);
  const float* bg = a.bias + (long long)b * t;
  const int n = (t + kBk - 1) / kBk;
  load_rows<kHd>(qs, head(a.q, a.qs, b, hh), a.qs.t, q0, kBq, t);

  // walk 1: each row's max and sum
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    __syncthreads();                     // the last tile's readers are done
    load_rows<kHd>(ks, kg, a.ks.t, j * kBk, kBk, t);
    load_bias(bias_s, bg, j * kBk, t);
    __syncthreads();
    float s[4][2];
    dot_tile<kHd>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s0 = score(s[i][0], a.sm_scale, bias_s[tx]);
      const float s1 = score(s[i][1], a.sm_scale, bias_s[tx + 16]);
      const float m_new = fmaxf(m[i], row_max(fmaxf(s0, s1)));
      const float sum = row_sum(expf(s0 - m_new) + expf(s1 - m_new));
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (a.stats != nullptr && tx == 0) {   // a training forward leaves them for the backward
    const long long planes_t = (long long)gridDim.z * gridDim.y * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < t) {
        a.stats[(long long)plane * t + row] = m[i];
        a.stats[planes_t + (long long)plane * t + row] = l[i];
      }
    }
  }
  float inv_l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_l[i] = 1.f / l[i];

  // walk 2: probabilities, mask, context
  float4 o[4][kHd / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j) {
    const int k0 = j * kBk;
    __syncthreads();
    load_rows<kHd>(ks, kg, a.ks.t, k0, kBk, t);
    load_rows<kHd>(vs, vg, a.vs.t, k0, kBk, t);
    load_bias(bias_s, bg, k0, t);
    __syncthreads();
    float s[4][2];
    dot_tile<kHd>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int row = q0 + ty + 16 * i, key = tx + 16 * jj;
        const float probs = expf(score(s[i][jj], a.sm_scale, bias_s[key]) - m[i]) * inv_l[i];
        const bool keep = kept(a.drop, a.mode, plane, t, row, k0 + key);
        ps[(ty + 16 * i) * kLdS + key] = drop_prob(probs, keep, a.mode != 0, a.inv_keep);
      }
    __syncthreads();
    acc_rows<kHd>(o, ps, vs, ty, tx);
  }
  float* og = head(a.o, a.os, b, hh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) store4(og + (long long)row * a.os.t + 4 * tx + 64 * c, o[i][c]);
  }
}

// ------------------------------------------------------------ backward, rows
// delta and dq of kBq query rows; grid (ceil(t / kBq), heads, batch)
template <int kHd>
__global__ void __launch_bounds__(kThreads) attention_wide_rows_kernel(const Args a) {
  constexpr int kLd = kHd + 4;
  extern __shared__ __align__(16) float smem_wide[];
  float* qs = smem_wide;                 // [kBq][kLd]
  float* gs = qs + kBq * kLd;            // [kBq][kLd]
  float* ks = gs + kBq * kLd;            // [kBk][kLd]
  float* vs = ks + kBk * kLd;            // [kBk][kLd]
  float* ds = vs + kBk * kLd;            // [kBq][kLdS]
  float* bias_s = ds + kBq * kLdS;       // [kBk]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * kBq, hh = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + hh;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  float* st = a.stats + (long long)plane * t;
  const float* kg = head(a.k, a.ks, b, hh);
  const float* vg = head(a.v, a.vs, b, hh);
  const float* ctx = head(a.out, a.os, b, hh);
  const float* bg = a.bias + (long long)b * t;
  const int n = (t + kBk - 1) / kBk;
  load_rows<kHd>(qs, head(a.q, a.qs, b, hh), a.qs.t, q0, kBq, t);
  load_rows<kHd>(gs, head(a.g, a.gs, b, hh), a.gs.t, q0, kBq, t);
  __syncthreads();

  // delta = rowsum(g * ctx): the thread's columns, then the row's 16 threads;
  // rows past t take (m, 1 / l, delta) = (0, 1, 0)
  float m[4], inv_l[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    float sum = 0.f;
    if (row < t) {
#pragma unroll
      for (int c = 0; c < kHd / 64; ++c) {
        const float4 gv = *reinterpret_cast<const float4*>(gs + r * kLd + 4 * tx + 64 * c);
        const float4 ov = load4(ctx + (long long)row * a.os.t + 4 * tx + 64 * c);
        sum = fmaf(gv.x, ov.x, sum);
        sum = fmaf(gv.y, ov.y, sum);
        sum = fmaf(gv.z, ov.z, sum);
        sum = fmaf(gv.w, ov.w, sum);
      }
    }
    delta[i] = row_sum(sum);
    m[i] = row < t ? st[row] : 0.f;
    inv_l[i] = row < t ? 1.f / st[planes_t + row] : 1.f;
    if (row < t && tx == 0) st[2 * planes_t + row] = delta[i];
  }

  float4 dq[4][kHd / 64];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) dq[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j) {
    const int k0 = j * kBk;
    __syncthreads();
    load_rows<kHd>(ks, kg, a.ks.t, k0, kBk, t);
    load_rows<kHd>(vs, vg, a.vs.t, k0, kBk, t);
    load_bias(bias_s, bg, k0, t);
    __syncthreads();
    float s[4][2], dp[4][2];
    dot_tile<kHd>(s, qs, ks, ty, tx);
    dot_tile<kHd>(dp, gs, vs, ty, tx);    // dpd = g . v^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int row = q0 + ty + 16 * i, key = tx + 16 * jj;
        const float probs = expf(score(s[i][jj], a.sm_scale, bias_s[key]) - m[i]) * inv_l[i];
        const float kept_d = dp[i][jj] * a.inv_keep32;
        const float dprobs = a.mode == 0 ? dp[i][jj]
                             : kept(a.drop, a.mode, plane, t, row, k0 + key) ? kept_d : 0.f;
        ds[(ty + 16 * i) * kLdS + key] = probs * (dprobs - delta[i]) * a.sm_scale;
      }
    __syncthreads();
    acc_rows<kHd>(dq, ds, ks, ty, tx);   // dq += ds . k
  }
  float* dqg = head(a.dq, a.dqs, b, hh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c)
      store4(dqg + (long long)row * a.dqs.t + 4 * tx + 64 * c, dq[i][c]);
  }
}

// ------------------------------------------------------------ backward, keys
// dk and dv of kBk keys, walking the query tiles; grid (ceil(t / kBk), heads,
// batch); after the rows kernel (delta)
template <int kHd>
__global__ void __launch_bounds__(kThreads) attention_wide_keys_kernel(const Args a) {
  constexpr int kLd = kHd + 4;
  extern __shared__ __align__(16) float smem_wide[];
  float* ks = smem_wide;                 // [kBk][kLd]
  float* vs = ks + kBk * kLd;            // [kBk][kLd]
  float* qs = vs + kBk * kLd;            // [kBq][kLd]
  float* gs = qs + kBq * kLd;            // [kBq][kLd]
  float* pds = gs + kBq * kLd;           // [kBq][kLdS]
  float* ds = pds + kBq * kLdS;          // [kBq][kLdS]
  float* bias_s = ds + kBq * kLdS;       // [kBk]
  float* row_s = bias_s + kBk;           // m, 1 / l, delta of the tile's rows: [3][kBq]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = blockIdx.x * kBk, hh = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + hh;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* st = a.stats + (long long)plane * t;
  const float* qg = head(a.q, a.qs, b, hh);
  const float* gg = head(a.g, a.gs, b, hh);
  const int n = (t + kBq - 1) / kBq;
  load_rows<kHd>(ks, head(a.k, a.ks, b, hh), a.ks.t, k0, kBk, t);
  load_rows<kHd>(vs, head(a.v, a.vs, b, hh), a.vs.t, k0, kBk, t);
  load_bias(bias_s, a.bias + (long long)b * t, k0, t);

  float4 dk[2][kHd / 64], dv[2][kHd / 64];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c)
      dk[i][c] = dv[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j) {
    const int q0 = j * kBq;
    __syncthreads();
    load_rows<kHd>(qs, qg, a.qs.t, q0, kBq, t);
    load_rows<kHd>(gs, gg, a.gs.t, q0, kBq, t);
    if (threadIdx.x < kBq) {
      const int row = q0 + threadIdx.x;
      const bool valid = row < t;
      row_s[threadIdx.x] = valid ? st[row] : 0.f;
      row_s[kBq + threadIdx.x] = valid ? 1.f / st[planes_t + row] : 1.f;
      row_s[2 * kBq + threadIdx.x] = valid ? st[2 * planes_t + row] : 0.f;
    }
    __syncthreads();
    float s[4][2], dp[4][2];
    dot_tile<kHd>(s, qs, ks, ty, tx);
    dot_tile<kHd>(dp, gs, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = ty + 16 * i, row = q0 + r, key = tx + 16 * jj;
        const float probs =
            expf(score(s[i][jj], a.sm_scale, bias_s[key]) - row_s[r]) * row_s[kBq + r];
        const bool keep = kept(a.drop, a.mode, plane, t, row, k0 + key);
        const float kept_d = dp[i][jj] * a.inv_keep32;
        const float dprobs = a.mode == 0 ? dp[i][jj] : keep ? kept_d : 0.f;
        pds[r * kLdS + key] = drop_prob(probs, keep, a.mode != 0, a.inv_keep);
        ds[r * kLdS + key] = probs * (dprobs - row_s[2 * kBq + r]) * a.sm_scale;
      }
    __syncthreads();
    acc_keys<kHd>(dv, pds, gs, ty, tx);   // dv += pd^T . g
    acc_keys<kHd>(dk, ds, qs, ty, tx);    // dk += ds^T . q
  }
  float* dkg = head(a.dk, a.dks, b, hh);
  float* dvg = head(a.dv, a.dvs, b, hh);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t) continue;
#pragma unroll
    for (int c = 0; c < kHd / 64; ++c) {
      store4(dkg + (long long)key * a.dks.t + 4 * tx + 64 * c, dk[i][c]);
      store4(dvg + (long long)key * a.dvs.t + 4 * tx + 64 * c, dv[i][c]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int blocks, int nh, int b, const Args& a, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, nh, b), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kHd>
int forward(const Args& a, int b, int nh, void* stream) {
  return launch(attention_wide_fwd_kernel<kHd>, fwd_smem<kHd>(), (a.t + kBq - 1) / kBq, nh, b,
                a, stream);
}

template <int kHd>
int backward(const Args& a, int b, int nh, void* stream) {
  const int err = launch(attention_wide_rows_kernel<kHd>, rows_smem<kHd>(),
                         (a.t + kBq - 1) / kBq, nh, b, a, stream);
  if (err != 0) return err;
  return launch(attention_wide_keys_kernel<kHd>, keys_smem<kHd>(), (a.t + kBk - 1) / kBk, nh, b,
                a, stream);
}

static_assert(keys_smem<256>() <= 232448, "the widest keys kernel fits one block");

bool bad_args(int b, int nh, int t, int mode, const void* bits) {
  return b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535 || mode < 0 || mode > 2 ||
         (mode == 2 && bits == nullptr);
}

int forward_at(int hd, const Args& a, int b, int nh, void* stream) {
  switch (hd) {
    case 128: return forward<128>(a, b, nh, stream);
    case 192: return forward<192>(a, b, nh, stream);
    case 256: return forward<256>(a, b, nh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int backward_at(int hd, const Args& a, int b, int nh, void* stream) {
  switch (hd) {
    case 128: return backward<128>(a, b, nh, stream);
    case 192: return backward<192>(a, b, nh, stream);
    case 256: return backward<256>(a, b, nh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args forward_args(const void* q, const void* k, const void* v, const void* bias, void* out, int t,
                  const long long* s, float sm_scale, int mode, unsigned long long seed,
                  unsigned c0, unsigned thresh, unsigned plane0, float keep_div, const void* bits,
                  void* stats) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.bias = (const float*)bias; a.o = out;
  a.stats = (float*)stats; a.t = t; a.mode = mode;
  a.qs = {s[0], s[1], s[2]}; a.ks = {s[3], s[4], s[5]}; a.vs = {s[6], s[7], s[8]};
  a.os = {s[9], s[10], s[11]};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;
  a.inv_keep32 = 1.f / keep_div;
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits, plane0, 0u};
  return a;
}

Args backward_args(const void* q, const void* k, const void* v, const void* bias, const void* g,
                   const void* out, void* dq, void* dk, void* dv, void* stats, int t,
                   const long long* s, float sm_scale, int mode, unsigned long long seed,
                   unsigned c0, unsigned thresh, unsigned plane0, float keep_div,
                   float keep_div32, const void* bits) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.g = g; a.out = out; a.bias = (const float*)bias;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = (float*)stats; a.t = t; a.mode = mode;
  a.qs = {s[0], s[1], s[2]}; a.ks = {s[3], s[4], s[5]}; a.vs = {s[6], s[7], s[8]};
  a.gs = {s[9], s[10], s[11]}; a.os = {s[12], s[13], s[14]}; a.dqs = {s[15], s[16], s[17]};
  a.dks = {s[18], s[19], s[20]}; a.dvs = {s[21], s[22], s[23]};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;
  a.inv_keep32 = 1.f / keep_div32;
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div32, (const unsigned*)bits, plane0, 0u};
  return a;
}

}  // namespace

// q, k, v, out: [b, nh, t, hd] at the 12 strides (batch, head, token) of q, k,
// v, out; hd the padded width (128, 192 or 256); mode: 0 no dropout, 1 Philox
// bits from (seed, c0, plane0), 2 bits from the operand; keep_div: 1 - p
// rounded to the compute type; stats: null, or [3, b * nh, t] f32 that
// receives each row's max (plane 0) and sum (plane 1)
extern "C" int aspire_attention_wide_f32(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int b, int nh, int t, int hd,
                                         const long long* strides, float sm_scale, int mode,
                                         unsigned long long seed, unsigned c0, unsigned thresh,
                                         unsigned plane0, float keep_div, const void* bits,
                                         void* stats, void* stream) {
  if (bad_args(b, nh, t, mode, bits)) return (int)cudaErrorInvalidValue;
  const Args a = forward_args(q, k, v, bias, out, t, strides, sm_scale, mode, seed, c0, thresh,
                              plane0, keep_div, bits, stats);
  return forward_at(hd, a, b, nh, stream);
}

// two launches: rows (delta into plane 2 of stats, dq), then keys (dk, dv);
// the 24 strides are those of q, k, v, g, out, dq, dk, dv; stats holds the
// forward's m and l
extern "C" int aspire_attention_wide_bwd_f32(const void* q, const void* k, const void* v,
                                             const void* bias, const void* g, const void* out,
                                             void* dq, void* dk, void* dv, void* stats, int b,
                                             int nh, int t, int hd, const long long* strides,
                                             float sm_scale, int mode, unsigned long long seed,
                                             unsigned c0, unsigned thresh, unsigned plane0,
                                             float keep_div, float keep_div32, const void* bits,
                                             void* stream) {
  if (bad_args(b, nh, t, mode, bits)) return (int)cudaErrorInvalidValue;
  const Args a = backward_args(q, k, v, bias, g, out, dq, dk, dv, stats, t, strides, sm_scale,
                               mode, seed, c0, thresh, plane0, keep_div, keep_div32, bits);
  return backward_at(hd, a, b, nh, stream);
}
