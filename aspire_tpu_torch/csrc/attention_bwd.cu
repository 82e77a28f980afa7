// Fused attention backward: dq, dk, dv of softmax(q.k^T * scale + bias)
// [dropout] . v for a cotangent g, with or without dropout.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_attention.py
// (_bwd_kernel).  Nothing [t, t]-shaped is saved by the forward: probabilities
// and mask are recomputed here from q, k, v, bias and the seed.  The TPU kernel
// holds a whole [t, t] head in fast memory; at t = 512 that is 1 MB of f32 and
// does not fit a block's 227 KB, so this is tiled, in two kernels and without
// float atomics (the result is the same from run to run):
//
//   rows kernel  one block per 64 query rows: delta of its rows, then one walk
//                over the key tiles computing ds and dq = ds . k.  It writes
//                delta to plane 2 of the [3, b * heads, t] f32 statistics.
//   keys kernel  one block per 64 keys, walking the query tiles: recomputes
//                probs, the dropped probabilities pd and ds for a [64 rows, 64
//                keys] tile, puts pd and ds through shared memory and adds
//                dv += pd^T . g and dk += ds^T . q, each warp owning 16 keys.
//
// Each row's softmax max m and sum l come from the forward, which leaves them
// in planes 0 and 1 of the statistics (2 floats a row), so probs =
// exp(s - m) / l is the forward's value bit for bit.  delta is taken as
// rowsum(g * ctx) from the forward's output ctx, not as rowsum(dprobs * probs):
// the two are equal up to the rounding of pd and of ctx to the compute type
// (exactly equal terms in f32, where pd = probs / (1 - p) is not rounded), and
// it saves a walk over the keys with its two products and its mask.
//
// With dpd = g . v^T:  dprobs = keep ? dpd / (1 - p) : 0 (f32),
// ds = probs * (dprobs - delta) * scale, cast to the compute type after the
// multiplication by scale.  Rounding points: probs f32; pd as in the forward
// (cast, divided by (1 - p) in the compute type, cast); dpd f32; f32
// accumulation in all products; outputs cast on store.  The mask comes from
// the element's position (common.cuh), so both kernels and the forward see the
// same one whatever their tiling.  The bias gets no gradient here (the wrapper
// returns none for it).
//
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, f32
// accumulate); f32 runs them as plain FMAs.  Operations bound it at BERT
// shapes: five products of 2 * t * t * 64 are needed, this design computes
// seven (scores and dpd in both kernels), the price of keeping nothing
// [t, t]-shaped anywhere.
#include "attention_tile.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

struct Strides { long long b, h, t; };

struct BwdArgs {
  const void *q, *k, *v, *g, *out;
  const float* bias;
  void *dq, *dk, *dv;
  float* stats;            // [3][b * heads][t]: m, l (from the forward), delta
  int t;
  Strides qs, ks, vs, gs, os, dqs, dks, dvs;
  float sm_scale;
  Drop drop;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, const Strides& s, int b, int head) {
  return reinterpret_cast<const T*>(p) + b * s.b + head * s.h;
}
template <typename T>
__device__ __forceinline__ T* head_ptr(void* p, const Strides& s, int b, int head) {
  return reinterpret_cast<T*>(p) + b * s.b + head * s.h;
}

// =================================================================== bf16 ====
// One [16 rows, 64 keys] tile of a warp, in the accumulator layout: packs pd
// and ds as the A fragments of the 16-key chunks.
template <int kDrop>
__device__ __forceinline__ void bwd_tile(const unsigned (&qa)[4][4], const unsigned (&ga)[4][4],
                                         const bf16* ks, const bf16* vs, const float* bias_s,
                                         const float (&m)[2], const float (&l)[2],
                                         const float (&delta)[2], float sm_scale, const Drop& drop,
                                         int plane, int t, int row_g, int k0, int lane,
                                         unsigned (&pd)[4][4], unsigned (&ds)[4][4]) {
  float s[8][4], dpd[8][4];
  mma_abT(s, qa, ks, lane);
  scale_bias(s, bias_s, sm_scale, lane & 3);
  mma_abT(dpd, ga, vs, lane);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned bits[4];
    if constexpr (kDrop != 0) acc_bits<kDrop>(drop, plane, t, row_g, k0 + nt * 8, lane, bits);
    float pdv[4], dsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      const float probs = expf(s[nt][i] - m[h]) / l[h];
      float dprobs = dpd[nt][i];
      pdv[i] = probs;
      if constexpr (kDrop != 0) {
        const bool keep = bits[i] >= drop.thresh;
        dprobs = keep ? dprobs / drop.keep_div32 : 0.f;
        pdv[i] = drop_prob_bf16(probs, keep, drop.keep_div);
      }
      dsv[i] = (probs * (dprobs - delta[h])) * sm_scale;
    }
    pd[nt / 2][(nt % 2) * 2] = pack_bf16(pdv[0], pdv[1]);
    pd[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(pdv[2], pdv[3]);
    ds[nt / 2][(nt % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
    ds[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
  }
}

// stage a warp's [16, 64] f32 accumulator as bf16 in its rows of `stage`, then
// store the rows below t with 16-byte stores
__device__ __forceinline__ void store_acc_bf16(const float (&acc)[8][4], bf16* stage_w, bf16* dst,
                                               long long stride, int row0, int t, int lane) {
  constexpr int ld = Cfg<bf16>::ld;
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(stage_w + g * ld + col) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<unsigned*>(stage_w + (g + 8) * ld + col) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < kRows * (kHd / 8); idx += 32) {
    const int r = idx / (kHd / 8), cv = (idx % (kHd / 8)) * 8;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * stride + cv) =
          *reinterpret_cast<const uint4*>(stage_w + r * ld + cv);
  }
}

constexpr size_t kSmemRowsBf16 = (size_t)(4 * 64 * 72) * sizeof(bf16) + 2 * 64 * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_rows_bf16_kernel(BwdArgs a) {
  constexpr int ld = Cfg<bf16>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + 64 * ld;
  bf16* ks = gs + 64 * ld;
  bf16* vs = ks + 64 * ld;
  float* bias_s = reinterpret_cast<float*>(vs + 64 * ld);
  float* d_s = bias_s + 64;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const bf16* kg = head_ptr<bf16>(a.k, a.ks, b, head);
  const bf16* vg = head_ptr<bf16>(a.v, a.vs, b, head);
  const float* bg = a.bias + (long long)b * t;
  float* st = a.stats + (long long)plane * t;

  load_tile<bf16>(qs, head_ptr<bf16>(a.q, a.qs, b, head), a.qs.t, q0, t);
  load_tile<bf16>(gs, head_ptr<bf16>(a.g, a.gs, b, head), a.gs.t, q0, t);
  load_tile<bf16>(ks, head_ptr<bf16>(a.out, a.os, b, head), a.os.t, q0, t);   // ctx, for delta
  __syncthreads();
  unsigned qa[4][4], ga[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(qa[kk], frag_addr(qs + warp * kRows * ld + kk * 16, ld, lane, true));
    ldmatrix_x4(ga[kk], frag_addr(gs + warp * kRows * ld + kk * 16, ld, lane, true));
  }
  {
    // delta = rowsum(g * ctx): two lanes a row, 32 columns each
    const int r = warp * kRows + (lane >> 1), c0 = (lane & 1) * 32;
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      sum += __bfloat162float(gs[r * ld + c0 + c]) * __bfloat162float(ks[r * ld + c0 + c]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      d_s[r] = sum;
      if (q0 + r < t) st[2 * planes_t + q0 + r] = sum;
    }
  }
  __syncwarp();
  const int row_g = q0 + warp * kRows + g;
  float m[2], l[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {      // rows past t: q and g are zero there, any finite values do
    const bool valid = row_g + 8 * h < t;
    m[h] = valid ? st[row_g + 8 * h] : 0.f;
    l[h] = valid ? st[planes_t + row_g + 8 * h] : 1.f;
    delta[h] = d_s[warp * kRows + g + 8 * h];
  }

  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nt][i] = 0.f;

  for (int k0 = 0; k0 < t; k0 += kBk) {
    __syncthreads();
    load_tile<bf16>(ks, kg, a.ks.t, k0, t);
    load_tile<bf16>(vs, vg, a.vs.t, k0, t);
    if (threadIdx.x < kBk)
      bias_s[threadIdx.x] = (k0 + threadIdx.x < t) ? bg[k0 + threadIdx.x] : -INFINITY;
    __syncthreads();
    unsigned pd[4][4], ds[4][4];
    bwd_tile<kDrop>(qa, ga, ks, vs, bias_s, m, l, delta, a.sm_scale, a.drop, plane, t, row_g, k0,
                    lane, pd, ds);
    mma_ab(dq, ds, ks, lane);
  }
  // the q tile is dead (it lives in qa): stage dq in the warp's rows of it
  store_acc_bf16(dq, qs + warp * kRows * ld, head_ptr<bf16>(a.dq, a.dqs, b, head), a.dqs.t,
                 q0 + warp * kRows, t, lane);
}

constexpr size_t kSmemKeysBf16 = (size_t)(6 * 64 * 72) * sizeof(bf16) + 4 * 64 * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_keys_bf16_kernel(BwdArgs a) {
  constexpr int ld = Cfg<bf16>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + 64 * ld;
  bf16* qs = vs + 64 * ld;
  bf16* gs = qs + 64 * ld;
  bf16* pds = gs + 64 * ld;    // [row][key] dropped probabilities of the tile
  bf16* dss = pds + 64 * ld;   // [row][key] ds of the tile
  float* bias_s = reinterpret_cast<float*>(dss + 64 * ld);
  float* m_s = bias_s + 64;
  float* l_s = m_s + 64;
  float* d_s = l_s + 64;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kBk, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head;
  const bf16* qg = head_ptr<bf16>(a.q, a.qs, b, head);
  const bf16* gg = head_ptr<bf16>(a.g, a.gs, b, head);
  const float* st = a.stats + (long long)plane * t;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;

  load_tile<bf16>(ks, head_ptr<bf16>(a.k, a.ks, b, head), a.ks.t, k0, t);
  load_tile<bf16>(vs, head_ptr<bf16>(a.v, a.vs, b, head), a.vs.t, k0, t);
  if (threadIdx.x < kBk)
    bias_s[threadIdx.x] =
        (k0 + threadIdx.x < t) ? a.bias[(long long)b * t + k0 + threadIdx.x] : -INFINITY;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nt][i] = dv[nt][i] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kBq) {
    __syncthreads();               // the previous tile is no longer read
    load_tile<bf16>(qs, qg, a.qs.t, q0, t);
    load_tile<bf16>(gs, gg, a.gs.t, q0, t);
    if (threadIdx.x < kBq) {       // rows past t: q and g are zero there, any finite stats do
      const bool valid = q0 + threadIdx.x < t;
      m_s[threadIdx.x] = valid ? st[q0 + threadIdx.x] : 0.f;
      l_s[threadIdx.x] = valid ? st[planes_t + q0 + threadIdx.x] : 1.f;
      d_s[threadIdx.x] = valid ? st[2 * planes_t + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    unsigned qa[4][4], ga[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(qa[kk], frag_addr(qs + warp * kRows * ld + kk * 16, ld, lane, true));
      ldmatrix_x4(ga[kk], frag_addr(gs + warp * kRows * ld + kk * 16, ld, lane, true));
    }
    const int r0 = warp * kRows + g;
    const float m[2] = {m_s[r0], m_s[r0 + 8]}, l[2] = {l_s[r0], l_s[r0 + 8]};
    const float delta[2] = {d_s[r0], d_s[r0 + 8]};
    unsigned pd[4][4], ds[4][4];
    bwd_tile<kDrop>(qa, ga, ks, vs, bias_s, m, l, delta, a.sm_scale, a.drop, plane, t, q0 + r0, k0,
                    lane, pd, ds);
    // A-fragment layout -> [row][key]: register 0 (row g, keys 16j + 2t),
    // 1 (row g + 8), 2 (row g, keys 16j + 8 + 2t), 3 (row g + 8)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = (r0 + 8 * (i & 1)) * ld + j * 16 + 8 * (i >> 1) + 2 * tq;
        *reinterpret_cast<unsigned*>(pds + off) = pd[j][i];
        *reinterpret_cast<unsigned*>(dss + off) = ds[j][i];
      }
    }
    __syncthreads();
    // the warp's 16 keys: dv += pd^T . g, dk += ds^T . q, contraction over the 64 rows
    unsigned pt[4][4], dt[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4_trans(pt[kk], frag_addr(pds + kk * 16 * ld + warp * 16, ld, lane, false));
      ldmatrix_x4_trans(dt[kk], frag_addr(dss + kk * 16 * ld + warp * 16, ld, lane, false));
    }
    mma_ab(dv, pt, gs, lane);
    mma_ab(dk, dt, qs, lane);
  }
  __syncthreads();                 // pds and dss are free: stage the outputs there
  store_acc_bf16(dv, pds + warp * kRows * ld, head_ptr<bf16>(a.dv, a.dvs, b, head), a.dvs.t,
                 k0 + warp * kRows, t, lane);
  store_acc_bf16(dk, dss + warp * kRows * ld, head_ptr<bf16>(a.dk, a.dks, b, head), a.dks.t,
                 k0 + warp * kRows, t, lane);
}

// ==================================================================== f32 ====
// Elementwise work on a warp's [16, 64] tile goes by items of four neighbouring
// columns (one Philox call): lane handles rows (lane / 16) + 2 i, i = 0..7, and
// columns 4 (lane % 16) .. + 3; the 16 lanes of a half warp share a row.
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// sw: q.k^T, dw: g.v^T of the warp's tile (pitch kLdS); writes pd and ds
// (pitch kLdS; either may alias its input tile).
template <int kDrop>
__device__ __forceinline__ void bwd_items_f32(const float* sw, const float* dw,
                                              const float* bias_s, const float (&m)[8],
                                              const float (&l)[8], const float (&delta)[8],
                                              float sm_scale, const Drop& drop, int plane, int t,
                                              int row0, int k0, int lane, float* pd_w,
                                              float* ds_w) {
  const int c4 = lane & 15;
  const float4 bias4 = *reinterpret_cast<const float4*>(bias_s + 4 * c4);
  const float bias[4] = {bias4.x, bias4.y, bias4.z, bias4.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (lane >> 4) + 2 * i;
    const float4 s4 = *reinterpret_cast<const float4*>(sw + r * kLdS + 4 * c4);
    const float4 d4 = *reinterpret_cast<const float4*>(dw + r * kLdS + 4 * c4);
    const float s[4] = {s4.x, s4.y, s4.z, s4.w}, dpd[4] = {d4.x, d4.y, d4.z, d4.w};
    unsigned bits[4] = {0u, 0u, 0u, 0u};
    if constexpr (kDrop != 0) {
      const uint4 w = row_bits<kDrop>(drop, plane, t, row0 + r, k0 / 4 + c4);
      bits[0] = w.x; bits[1] = w.y; bits[2] = w.z; bits[3] = w.w;
    }
    float pd[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float probs = expf(s[e] * sm_scale + bias[e] - m[i]) / l[i];
      float dprobs = dpd[e];
      pd[e] = probs;
      if constexpr (kDrop != 0) {
        const bool keep = bits[e] >= drop.thresh;
        dprobs = keep ? dprobs / drop.keep_div32 : 0.f;
        pd[e] = keep ? probs / drop.keep_div : 0.f;
      }
      ds[e] = (probs * (dprobs - delta[i])) * sm_scale;
    }
    *reinterpret_cast<float4*>(pd_w + r * kLdS + 4 * c4) = make_float4(pd[0], pd[1], pd[2], pd[3]);
    *reinterpret_cast<float4*>(ds_w + r * kLdS + 4 * c4) = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

__device__ __forceinline__ void store_acc_f32(const float (&o0)[kRows], const float (&o1)[kRows],
                                              float* stage_w, float* dst, long long stride,
                                              int row0, int t, int lane) {
  __syncwarp();
  for (int r = 0; r < kRows; ++r) {
    stage_w[r * kLdS + lane] = o0[r];
    stage_w[r * kLdS + lane + 32] = o1[r];
  }
  __syncwarp();
  for (int idx = lane; idx < kRows * (kHd / 4); idx += 32) {
    const int r = idx / (kHd / 4), cv = (idx % (kHd / 4)) * 4;
    if (row0 + r < t)
      *reinterpret_cast<float4*>(dst + (long long)(row0 + r) * stride + cv) =
          *reinterpret_cast<const float4*>(stage_w + r * kLdS + cv);
  }
}

constexpr size_t kSmemRowsF32 =
    (size_t)(4 * 64 * 65 + 3 * kWarps * kRows * kLdS + 64) * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_rows_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + 64 * 65;
  float* ks = gs + 64 * 65;
  float* vs = ks + 64 * 65;
  float* ss = vs + 64 * 65;                    // [warps][16][kLdS] q.k^T
  float* dd = ss + kWarps * kRows * kLdS;      // [warps][16][kLdS] g.v^T, then ds
  float* pp = dd + kWarps * kRows * kLdS;      // [warps][16][kLdS] pd (not used for dq)
  float* bias_s = pp + kWarps * kRows * kLdS;  // [64], 16-byte aligned

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* kg = head_ptr<float>(a.k, a.ks, b, head);
  const float* vg = head_ptr<float>(a.v, a.vs, b, head);
  const float* bg = a.bias + (long long)b * t;
  float* st = a.stats + (long long)plane * t;
  float* sw = ss + warp * kRows * kLdS;
  float* dw = dd + warp * kRows * kLdS;
  float* pw = pp + warp * kRows * kLdS;
  const float* qw = qs + warp * kRows * 65;
  const float* gw = gs + warp * kRows * 65;

  load_tile<float>(qs, head_ptr<float>(a.q, a.qs, b, head), a.qs.t, q0, t);
  load_tile<float>(gs, head_ptr<float>(a.g, a.gs, b, head), a.gs.t, q0, t);
  load_tile<float>(ks, head_ptr<float>(a.out, a.os, b, head), a.os.t, q0, t);   // ctx, for delta
  __syncthreads();

  float o0[kRows], o1[kRows];
  for (int r = 0; r < kRows; ++r) o0[r] = o1[r] = 0.f;
  const int row0 = q0 + warp * kRows, c4 = lane & 15;
  float m[8], l[8], delta[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // delta = rowsum(g * ctx): the 16 lanes of a half warp share a row
    const int r = (lane >> 4) + 2 * i;
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sum += gw[r * 65 + 4 * c4 + e] * ks[(warp * kRows + r) * 65 + 4 * c4 + e];
    delta[i] = half_warp_sum(sum);
    const bool valid = row0 + r < t;   // rows past t: q and g are zero, any finite values do
    m[i] = valid ? st[row0 + r] : 0.f;
    l[i] = valid ? st[planes_t + row0 + r] : 1.f;
    if (c4 == 0 && valid) st[2 * planes_t + row0 + r] = delta[i];
  }

  for (int k0 = 0; k0 < t; k0 += kBk) {
    __syncthreads();
    load_tile<float>(ks, kg, a.ks.t, k0, t);
    load_tile<float>(vs, vg, a.vs.t, k0, t);
    if (threadIdx.x < kBk)
      bias_s[threadIdx.x] = (k0 + threadIdx.x < t) ? bg[k0 + threadIdx.x] : -INFINITY;
    __syncthreads();
    f32_abT(qw, ks, sw);
    f32_abT(gw, vs, dw);
    __syncwarp();
    bwd_items_f32<kDrop>(sw, dw, bias_s, m, l, delta, a.sm_scale, a.drop, plane, t, row0, k0,
                         lane, pw, dw);
    __syncwarp();
    f32_ab(o0, o1, dw, kLdS, ks);            // dq += ds . k
    __syncwarp();
  }
  store_acc_f32(o0, o1, sw, head_ptr<float>(a.dq, a.dqs, b, head), a.dqs.t, row0, t, lane);
}

constexpr size_t kSmemKeysF32 =
    (size_t)(4 * 64 * 65 + 2 * kWarps * kRows * kLdS + 2 * 64 * kLdS + 4 * 64) * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_keys_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + 64 * 65;
  float* qs = vs + 64 * 65;
  float* gs = qs + 64 * 65;
  float* ss = gs + 64 * 65;                    // [warps][16][kLdS] q.k^T
  float* dd = ss + kWarps * kRows * kLdS;      // [warps][16][kLdS] g.v^T
  float* pds = dd + kWarps * kRows * kLdS;     // [64 rows][kLdS] pd of the tile
  float* dss = pds + 64 * kLdS;                // [64 rows][kLdS] ds of the tile
  float* bias_s = dss + 64 * kLdS;             // 16-byte aligned
  float* m_s = bias_s + 64;
  float* l_s = m_s + 64;
  float* d_s = l_s + 64;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kBk, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head;
  const float* qg = head_ptr<float>(a.q, a.qs, b, head);
  const float* gg = head_ptr<float>(a.g, a.gs, b, head);
  const float* st = a.stats + (long long)plane * t;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  float* sw = ss + warp * kRows * kLdS;
  float* dw = dd + warp * kRows * kLdS;

  load_tile<float>(ks, head_ptr<float>(a.k, a.ks, b, head), a.ks.t, k0, t);
  load_tile<float>(vs, head_ptr<float>(a.v, a.vs, b, head), a.vs.t, k0, t);
  if (threadIdx.x < kBk)
    bias_s[threadIdx.x] =
        (k0 + threadIdx.x < t) ? a.bias[(long long)b * t + k0 + threadIdx.x] : -INFINITY;

  // the warp's 16 keys, columns lane and lane + 32
  float dk0[kRows], dk1[kRows], dv0[kRows], dv1[kRows];
  for (int r = 0; r < kRows; ++r) dk0[r] = dk1[r] = dv0[r] = dv1[r] = 0.f;

  for (int q0 = 0; q0 < t; q0 += kBq) {
    __syncthreads();
    load_tile<float>(qs, qg, a.qs.t, q0, t);
    load_tile<float>(gs, gg, a.gs.t, q0, t);
    if (threadIdx.x < kBq) {
      const bool valid = q0 + threadIdx.x < t;
      m_s[threadIdx.x] = valid ? st[q0 + threadIdx.x] : 0.f;
      l_s[threadIdx.x] = valid ? st[planes_t + q0 + threadIdx.x] : 1.f;
      d_s[threadIdx.x] = valid ? st[2 * planes_t + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    f32_abT(qs + warp * kRows * 65, ks, sw);
    f32_abT(gs + warp * kRows * 65, vs, dw);
    __syncwarp();
    float m[8], l[8], delta[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * kRows + (lane >> 4) + 2 * i;
      m[i] = m_s[r]; l[i] = l_s[r]; delta[i] = d_s[r];
    }
    bwd_items_f32<kDrop>(sw, dw, bias_s, m, l, delta, a.sm_scale, a.drop, plane, t,
                         q0 + warp * kRows, k0, lane, pds + warp * kRows * kLdS,
                         dss + warp * kRows * kLdS);
    __syncthreads();
    // dv[key][c] += sum_row pd[row][key] g[row][c];  dk likewise with ds and q
    for (int row = 0; row < kBq; ++row) {
      const float g0 = gs[row * 65 + lane], g1 = gs[row * 65 + lane + 32];
      const float x0 = qs[row * 65 + lane], x1 = qs[row * 65 + lane + 32];
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        const float p = pds[row * kLdS + warp * kRows + kk];
        const float d = dss[row * kLdS + warp * kRows + kk];
        dv0[kk] = fmaf(p, g0, dv0[kk]);
        dv1[kk] = fmaf(p, g1, dv1[kk]);
        dk0[kk] = fmaf(d, x0, dk0[kk]);
        dk1[kk] = fmaf(d, x1, dk1[kk]);
      }
    }
  }
  __syncthreads();
  store_acc_f32(dv0, dv1, sw, head_ptr<float>(a.dv, a.dvs, b, head), a.dvs.t, k0 + warp * kRows,
                t, lane);
  store_acc_f32(dk0, dk1, dw, head_ptr<float>(a.dk, a.dks, b, head), a.dks.t, k0 + warp * kRows,
                t, lane);
}

template <typename RowsFn, typename KeysFn>
int launch(RowsFn rows, size_t smem_rows, KeysFn keys, size_t smem_keys, const BwdArgs& a, int b,
           int nh, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_rows);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_keys);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, nh, b);
  rows<<<grid, kThreads, smem_rows, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  keys<<<grid, kThreads, smem_keys, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: (batch, head, token) of q, k, v, g, out, dq, dk, dv; stats: the
// [3, b * nh, t] f32 array whose planes 0 and 1 the forward filled (plane 2 is
// scratch for delta); mode as in the forward
#define ASPIRE_ATTENTION_BWD(NAME, ROWS, SMEM_ROWS, KEYS, SMEM_KEYS)                           \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* bias,           \
                      const void* g, const void* out, void* dq, void* dk, void* dv,            \
                      void* stats, int b, int nh, int t, const long long* strides,             \
                      float sm_scale, int mode,                                                \
                      unsigned long long seed, unsigned c0, unsigned thresh, float keep_div,   \
                      float keep_div32, const void* bits, void* stream) {                      \
    if (b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535) return (int)cudaErrorInvalidValue;\
    BwdArgs a;                                                                                 \
    a.q = q; a.k = k; a.v = v; a.g = g; a.out = out; a.bias = (const float*)bias;              \
    a.dq = dq; a.dk = dk; a.dv = dv; a.stats = (float*)stats; a.t = t;                         \
    Strides* dst[8] = {&a.qs, &a.ks, &a.vs, &a.gs, &a.os, &a.dqs, &a.dks, &a.dvs};             \
    for (int i = 0; i < 8; ++i)                                                                \
      *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};               \
    a.sm_scale = sm_scale;                                                                     \
    a.drop = Drop{seed, c0, thresh, keep_div, keep_div32, (const unsigned*)bits};              \
    if (mode == 0)                                                                             \
      return launch(ROWS<0>, SMEM_ROWS, KEYS<0>, SMEM_KEYS, a, b, nh, stream);                 \
    if (mode == 1)                                                                             \
      return launch(ROWS<1>, SMEM_ROWS, KEYS<1>, SMEM_KEYS, a, b, nh, stream);                 \
    if (mode == 2 && bits != nullptr)                                                          \
      return launch(ROWS<2>, SMEM_ROWS, KEYS<2>, SMEM_KEYS, a, b, nh, stream);                 \
    return (int)cudaErrorInvalidValue;                                                         \
  }

ASPIRE_ATTENTION_BWD(aspire_attention_bwd_bf16, bwd_rows_bf16_kernel, kSmemRowsBf16,
                     bwd_keys_bf16_kernel, kSmemKeysBf16)
ASPIRE_ATTENTION_BWD(aspire_attention_bwd_f32, bwd_rows_f32_kernel, kSmemRowsF32,
                     bwd_keys_f32_kernel, kSmemKeysF32)
