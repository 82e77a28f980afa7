// Fused attention backward: dq, dk, dv of softmax(q.k^T * scale + bias)
// [dropout] . v for a cotangent g, with or without dropout.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_attention.py
// (_bwd_kernel).  Nothing [t, t]-shaped is saved by the forward: probabilities
// and mask are recomputed here from q, k, v, bias and the seed.  The TPU kernel
// holds a whole [t, t] head in fast memory; at t = 512 that is 1 MB of f32 and
// does not fit a block's 227 KB, so this is tiled and, without float atomics,
// gives the same result from run to run.
//
// What bounds it on an H100: five products of 2 t t 64 each (scores, dpd = g.v^T,
// dv, dk, dq), 0.061 ms on the bf16 tensor cores at [30, 12, 512, 64], against
// 0.014 ms to read q, k, v, g, ctx once and write dq, dk, dv.  Next come one
// Philox4x32-10 call for every four elements of the mask and one exp an
// element, and, in this design, 2 x 189 MB of ds scratch at that shape (0.113
// ms).  So each product is computed once, the mask is drawn once, the tensor
// cores run asynchronously beside the elementwise work, and tile loads overlap
// the math.
//
// bf16, three launches a backward (at 64-wide heads; the wider ones take the
// same three steps on wgmma alone, below the 64-wide kernels):
//
//   delta  delta = rowsum(g * ctx) of every row, into plane 2 of the
//          [3, b * heads, t] f32 statistics (8 lanes a row, one pass over g
//          and the forward's output ctx).
//   keys   one block (one warpgroup) per 64 keys, warp w owning keys 16 w ..
//          + 15, walking the query tiles.  The tile is computed transposed, keys
//          as the M dimension of wgmma: the warps' k and v rows are register A
//          operands for the whole walk, S^T = k.q^T and dpd^T = v.g^T come once
//          per tile (wgmma m64n16k16, q and g tiles read as B K-major), the mask
//          is drawn once, and pd^T and ds^T leave the accumulator as the
//          register A operands of dv += pd^T.g and dk += ds^T.q (m64n64k16, the
//          same q and g tiles read as B MN-major), with no trip through shared
//          memory.  16 query rows a step, two steps in flight: step c + 1's
//          scores run on the tensor cores while step c's mask is drawn and its
//          elementwise work is done.  ds^T also goes, through a warp's rows of
//          shared memory and 16-byte stores, to a bf16 scratch [b * heads, tp,
//          tp] (tp = t rounded up to 64; keys as rows, query rows contiguous,
//          zeros past t).  q and g (in the 128-byte swizzle that wgmma reads)
//          and each row's statistics are double-buffered: cp.async brings tile
//          i + 1 while tile i is computed.
//   dq     one block per 64 query rows, one warp per 16, walking the key tiles:
//          dq = ds . k from the scratch on mma.sync (ldmatrix.trans gives ds's A
//          fragments from ds^T), ds^T and k tiles double-buffered by cp.async.
//
// The mask word of an element is keyed on (plane, query row, key / 4)
// (common.cuh), the forward's.  In the transposed tile one Philox call's four
// words belong to four keys held by four lanes: the four lanes of a quad column
// each make one of the four calls the quad needs and swap words by three xor
// shuffles (acc_bits_t), so each word is drawn once.
//
// Each row's softmax max m and sum l come from the forward, which leaves them
// in planes 0 and 1 of the statistics.  delta is taken as rowsum(g * ctx), not
// as rowsum(dprobs * probs): the two are equal up to the rounding of pd and of
// ctx to the compute type, and it saves a walk over the keys.
//
// Rounding: scores, exp, probs and dpd f32; probs = exp(s - m) * (1 / l), the
// reciprocal taken once a row, which is the forward's exp(s - m) / l or one f32
// ulp from it, so a pd rounded to bf16 can differ from the forward's by one
// bf16 ulp where the f32 value lies within an ulp of a rounding midpoint.
// pd = bf16(bf16(probs) * (1 / bf16(1 - p))), the reciprocal taken once a call:
// the exact quotient of an 8-bit mantissa by bf16(1 - p) is never within 2^-17
// of a bf16 midpoint unless 1 - p is a power of two (then the reciprocal is
// exact), so this is bf16(bf16(probs) / bf16(1 - p)) as the forward divides.
// dprobs = keep ? dpd * (1 / (1 - p)) : 0 in f32 (one f32 ulp from the
// division); ds = probs * (dprobs - delta) * scale, cast to bf16 once and used
// by dk and dq alike.  f32 accumulation in all products; outputs cast on store.
// The bias gets no gradient here (the wrapper returns none for it).
//
// f32 (training with --no-bf16-compute) runs two launches on the tensor cores
// as split-TF32 products: at 64-wide heads a rows kernel (delta, dq) and a
// keys kernel (dk, dv), each computing scores and dpd, seven products in all;
// at 128, 192 and 256 a scores kernel (delta, then ds and pd of every tile
// into an f32 scratch) and a gradients kernel (dq, dk, dv from the scratch),
// five products; see the f32 sections below.
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
  bf16* scratch;           // bf16: ds^T, [b * heads][tp][tp]
  float* scratch32;        // f32 at heads wider than 64: ds, then pd, [2][b * heads][tp][tp]
  int t;
  Strides qs, ks, vs, gs, os, dqs, dks, dvs;
  float sm_scale;
  float inv_keep;          // 1 / (1 - p rounded to the compute type)
  float inv_keep32;        // 1 / (1 - p) in f32
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
constexpr int kLd = Cfg<bf16>::ld;
constexpr int kDeltaRows = 32;   // rows a block of the delta pass (8 lanes a row)

__device__ __forceinline__ int padded(int t) { return (t + 63) & ~63; }

// kW: the head width; lane c of a row takes columns 8 c .. + 7 of each 64
template <int kW>
__global__ void __launch_bounds__(kDeltaRows * 8) bwd_delta_bf16_kernel(BwdArgs a) {
  const int head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int row = blockIdx.x * kDeltaRows + (threadIdx.x >> 3), c = (threadIdx.x & 7) * 8;
  float sum = 0.f;
  if (row < t) {
#pragma unroll
    for (int cb = 0; cb < kW / 64; ++cb) {
      const uint4 gv = *reinterpret_cast<const uint4*>(head_ptr<bf16>(a.g, a.gs, b, head) +
                                                       (long long)row * a.gs.t + cb * 64 + c);
      const uint4 ov = *reinterpret_cast<const uint4*>(head_ptr<bf16>(a.out, a.os, b, head) +
                                                       (long long)row * a.os.t + cb * 64 + c);
      const bf16* gp = reinterpret_cast<const bf16*>(&gv);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += __bfloat162float(gp[i]) * __bfloat162float(op[i]);
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (row < t && (threadIdx.x & 7) == 0) {
    const long long planes_t = (long long)gridDim.z * gridDim.y * t;
    a.stats[2 * planes_t + (long long)(b * gridDim.y + head) * t + row] = sum;
  }
}

// x[idx] for an index known only at run time, without local memory
__device__ __forceinline__ unsigned pick(const unsigned (&x)[4], int idx) {
  return (idx & 2) ? ((idx & 1) ? x[3] : x[2]) : ((idx & 1) ? x[1] : x[0]);
}

// Bits of a thread's four elements of one transposed accumulator tile [16 keys,
// 8 query rows] (keys key0 .. + 15, key0 a multiple of 16; rows row0 .. + 7):
// element i is (key key0 + g + 8 (i >> 1), row row0 + 2 t + (i & 1)) for g =
// lane / 4, t = lane % 4.  Every word it needs is word w = g % 4 of a call, so
// the four lanes of a quad column (same t and g / 4, w = 0..3) need the same
// four calls: lane w makes call w = (row row0 + 2 t + (w & 1), keys key0 +
// 8 (w >> 1) + 4 (g / 4) .. + 3) and the four swap words in three xor
// shuffles.  The whole warp must call this together.  kMode 2: read from the
// bits operand, a [planes, t, t] array; positions past t count as kept.
template <int kMode>
__device__ __forceinline__ void acc_bits_t(const Drop& d, int plane, int t, int key0, int row0,
                                           int lane, unsigned (&bits)[4]) {
  const int g = lane >> 2, tq = lane & 3;
  if constexpr (kMode == 1) {
    const int w = g & 3;
    const uint4 c = drop_words(d, (unsigned)plane, (unsigned)(row0 + 2 * tq + (w & 1)),
                               (unsigned)((key0 >> 2) + 2 * (w >> 1) + (g >> 2)));
    const unsigned word[4] = {c.x, c.y, c.z, c.w};
    // round j: lane w gets word w of call w ^ j from lane w ^ j (4 j lanes away)
    unsigned got[4];
    got[0] = pick(word, w);
#pragma unroll
    for (int j = 1; j < 4; ++j) got[j] = __shfl_xor_sync(0xffffffffu, pick(word, w ^ j), 4 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) bits[i] = pick(got, i ^ w);   // element i is call i
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + g + 8 * (i >> 1), row = row0 + 2 * tq + (i & 1);
      bits[i] = (row < t && key < t) ? d.bits[((long long)plane * t + row) * t + key]
                                     : 0xffffffffu;
    }
  }
}

// stage a warp's [16, 64] f32 accumulator as bf16 in its rows of `stage`, then
// store the rows below t with 16-byte stores
__device__ __forceinline__ void store_acc_bf16(const float (&acc)[8][4], bf16* stage_w, bf16* dst,
                                               long long stride, int row0, int t, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(stage_w + g * kLd + col) = pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<unsigned*>(stage_w + (g + 8) * kLd + col) = pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < kRows * (kHd / 8); idx += 32) {
    const int r = idx / (kHd / 8), cv = (idx % (kHd / 8)) * 8;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * stride + cv) =
          *reinterpret_cast<const uint4*>(stage_w + r * kLd + cv);
  }
}

// m, 1 / l and delta of one query row; rows past t (q and g are zero there)
// take 0, 1, 0, any finite values do
struct RowStats { float m, inv_l, delta; };
__device__ __forceinline__ RowStats load_row_stats(const float* st, long long planes_t, int row,
                                                   int t) {
  if (row >= t) return {0.f, 1.f, 0.f};
  return {st[row], 1.f / st[planes_t + row], st[2 * planes_t + row]};
}

// q and g tiles [2 buffers][64 rows][64] in the 128-byte swizzle, k and v
// tiles [64][kLd] (k's rows become the ds^T staging once its fragments are
// loaded), statistics [2 buffers][m, 1/l, delta][64]; 1 KB to align the base
constexpr int kTileSw = 64 * kHd;   // elements of a swizzled tile
constexpr size_t kSmemKeysBf16 = 1024 + (size_t)4 * kTileSw * sizeof(bf16) +
                                 (size_t)2 * 64 * kLd * sizeof(bf16) + 2 * 3 * 64 * sizeof(float);

// S^T = k . q^T and dpd^T = v . g^T for 16 query rows (q and g tiles from
// those rows on), one commit group
__device__ __forceinline__ void start_scores(float (&s)[8], float (&dp)[8],
                                             const unsigned (&ka)[4][4], const unsigned (&va)[4][4],
                                             const bf16* q, const bf16* g) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n16k16<0>(s, ka[kk], sw128_desc(q + kk * 16), kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n16k16<0>(dp, va[kk], sw128_desc(g + kk * 16), kk);
  wgmma_commit();
}

template <int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_keys_bf16_kernel(BwdArgs a) {
  extern __shared__ unsigned char smem_keys[];
  bf16* qs = reinterpret_cast<bf16*>(smem_keys + ((1024 - smem_addr(smem_keys) % 1024) % 1024));
  bf16* gs = qs + 2 * kTileSw;
  bf16* ks = gs + 2 * kTileSw;
  bf16* vs = ks + 64 * kLd;
  float* st_s = reinterpret_cast<float*>(vs + 64 * kLd);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kBk, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, tp = padded(t), kw = k0 + warp * 16;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* st = a.stats + (long long)plane * t;
  const bf16* qg = head_ptr<bf16>(a.q, a.qs, b, head);
  const bf16* gg = head_ptr<bf16>(a.g, a.gs, b, head);
  bf16* ds_g = a.scratch + ((long long)plane * tp + kw) * tp;   // the warp's 16 rows of ds^T
  bf16* ds_w = ks + warp * 16 * kLd;                             // their staging

  load_tile_async(ks, head_ptr<bf16>(a.k, a.ks, b, head), a.ks.t, k0, t);
  load_tile_async(vs, head_ptr<bf16>(a.v, a.vs, b, head), a.vs.t, k0, t);
  load_tile_sw128_async(qs, qg, a.qs.t, 0, t);
  load_tile_sw128_async(gs, gg, a.gs.t, 0, t);
  cp_async_commit();
  if (threadIdx.x < kBq) {
    const RowStats r = load_row_stats(st, planes_t, threadIdx.x, t);
    st_s[threadIdx.x] = r.m;
    st_s[64 + threadIdx.x] = r.inv_l;
    st_s[128 + threadIdx.x] = r.delta;
  }
  // bias of the warp's keys g and g + 8, the rows of its transposed tile
  const float bias0 = kw + g < t ? a.bias[(long long)b * t + kw + g] : -INFINITY;
  const float bias1 = kw + g + 8 < t ? a.bias[(long long)b * t + kw + g + 8] : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();
  unsigned ka[4][4], va[4][4];   // the warp's 16 keys of k and v as A fragments, d in 4 chunks
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(ka[kk], frag_addr(ks + warp * 16 * kLd + kk * 16, kLd, lane, true));
    ldmatrix_x4(va[kk], frag_addr(vs + warp * 16 * kLd + kk * 16, kLd, lane, true));
  }

  float dk[32], dv[32];   // [64 keys, 64] accumulators of the warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (t + kBq - 1) / kBq;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, q0 = it * kBq;
    const bool more = it + 1 < n_tiles;
    RowStats next = {0.f, 1.f, 0.f};
    if (more) {                   // tile it + 1 into the other buffers, in flight during the math
      load_tile_sw128_async(qs + (buf ^ 1) * kTileSw, qg, a.qs.t, q0 + kBq, t);
      load_tile_sw128_async(gs + (buf ^ 1) * kTileSw, gg, a.gs.t, q0 + kBq, t);
      if (threadIdx.x < kBq) next = load_row_stats(st, planes_t, q0 + kBq + threadIdx.x, t);
    }
    cp_async_commit();
    cp_async_wait<1>();           // tile it has landed (this thread's copies) ...
    fence_proxy_async();          // ... seen by wgmma ...
    __syncthreads();              // ... for everyone's copies
    const bf16* qb = qs + buf * kTileSw;
    const bf16* gb = gs + buf * kTileSw;
    const float* sb = st_s + buf * 192;
    // 16 query rows a step, two steps in flight: S^T and dpd^T of step c + 1
    // [64 keys, 16 rows] are computed by wgmma while step c's mask is drawn and
    // its elementwise work and its dv, dk products run (q and g rows are B
    // K-major for S^T and dpd^T, MN-major for dv and dk)
    float s[2][8], dp[2][8];
    start_scores(s[0], dp[0], ka, va, qb, gb);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < 3) start_scores(s[(c + 1) & 1], dp[(c + 1) & 1], ka, va, qb + (c + 1) * 16 * kHd,
                              gb + (c + 1) * 16 * kHd);
      unsigned bits[2][4];
      if constexpr (kDrop != 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc_bits_t<kDrop>(a.drop, plane, t, kw, q0 + c * 16 + nt * 8, lane, bits[nt]);
      }
      if (c < 3) wgmma_wait<1>(); else wgmma_wait<0>();   // step c's scores (and step c - 1's dv, dk)
      wgmma_hold(s[c & 1]);
      wgmma_hold(dp[c & 1]);
      unsigned pa[4], da[4];   // pd^T and ds^T of the step as A fragments
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = c * 16 + nt * 8 + 2 * tq;   // the thread's rows r, r + 1 of the tile
        const float2 m2 = *reinterpret_cast<const float2*>(sb + r);
        const float2 il2 = *reinterpret_cast<const float2*>(sb + 64 + r);
        const float2 d2 = *reinterpret_cast<const float2*>(sb + 128 + r);
        float pdv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = (i & 1) ? m2.y : m2.x, inv_l = (i & 1) ? il2.y : il2.x;
          const float delta = (i & 1) ? d2.y : d2.x;
          const float sv = s[c & 1][4 * nt + i] * a.sm_scale + ((i >> 1) ? bias1 : bias0);
          const float probs = expf(sv - m) * inv_l;
          float dprobs = dp[c & 1][4 * nt + i];
          pdv[i] = probs;
          if constexpr (kDrop != 0) {
            const bool keep = bits[nt][i] >= a.drop.thresh;
            dprobs = keep ? dprobs * a.inv_keep32 : 0.f;
            pdv[i] = keep ? __bfloat162float(__float2bfloat16_rn(probs)) * a.inv_keep : 0.f;
          }
          dsv[i] = (probs * (dprobs - delta)) * a.sm_scale;
        }
        // A layout: a0 (key g, rows 2t..), a1 (key g + 8), a2 / a3 the same 8 rows on
        pa[2 * nt] = pack_bf16(pdv[0], pdv[1]);
        pa[2 * nt + 1] = pack_bf16(pdv[2], pdv[3]);
        da[2 * nt] = pack_bf16(dsv[0], dsv[1]);
        da[2 * nt + 1] = pack_bf16(dsv[2], dsv[3]);
        *reinterpret_cast<unsigned*>(ds_w + g * kLd + r) = da[2 * nt];
        *reinterpret_cast<unsigned*>(ds_w + (g + 8) * kLd + r) = da[2 * nt + 1];
      }
      wgmma_fence();
      wgmma_m64n64k16<1>(dv, pa, sw128_desc(gb + c * 16 * kHd), 1);
      wgmma_m64n64k16<1>(dk, da, sw128_desc(qb + c * 16 * kHd), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();              // the tile's buffers and the A registers are read
    wgmma_hold(dv);
    wgmma_hold(dk);
    __syncwarp();
    // the warp's 16 rows of ds^T for this tile's 64 query rows: 16-byte stores
#pragma unroll
    for (int idx = lane; idx < 16 * 8; idx += 32) {
      const int r = idx >> 3, cv = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(ds_g + (long long)r * tp + q0 + cv) =
          *reinterpret_cast<const uint4*>(ds_w + r * kLd + cv);
    }
    if (more && threadIdx.x < kBq) {   // buffer buf ^ 1 was last read before this tile's barrier
      float* nb = st_s + (buf ^ 1) * 192;
      nb[threadIdx.x] = next.m;
      nb[64 + threadIdx.x] = next.inv_l;
      nb[128 + threadIdx.x] = next.delta;
    }
    __syncthreads();              // buffers buf are free for tile it + 2
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i >> 2][i & 3] = dv[i];
  store_acc_bf16(acc, ds_w, head_ptr<bf16>(a.dv, a.dvs, b, head), a.dvs.t, kw, t, lane);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i >> 2][i & 3] = dk[i];
  store_acc_bf16(acc, ds_w, head_ptr<bf16>(a.dk, a.dks, b, head), a.dks.t, kw, t, lane);
}

// ds^T and k tiles, [2 buffers][64][kLd] each
constexpr size_t kSmemDqBf16 = (size_t)4 * 64 * kLd * sizeof(bf16);

__global__ void __launch_bounds__(kThreads) bwd_dq_bf16_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* dss = reinterpret_cast<bf16*>(smem_raw);   // [key][query row]
  bf16* kss = dss + 2 * 64 * kLd;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, tp = padded(t);
  const bf16* ds_g = a.scratch + (long long)plane * tp * tp + q0;   // column q0 of key row 0
  const bf16* kg = head_ptr<bf16>(a.k, a.ks, b, head);

  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nt][i] = 0.f;

  load_tile_async(dss, ds_g, tp, 0, tp);
  load_tile_async(kss, kg, a.ks.t, 0, t);
  cp_async_commit();
  const int n_tiles = tp / kBk;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = it * kBk;
    if (it + 1 < n_tiles) {
      load_tile_async(dss + (buf ^ 1) * 64 * kLd, ds_g, tp, k0 + kBk, tp);
      load_tile_async(kss + (buf ^ 1) * 64 * kLd, kg, a.ks.t, k0 + kBk, t);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* db = dss + buf * 64 * kLd;
    const bf16* kb = kss + buf * 64 * kLd;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // ds of the warp's 16 rows and keys 16 kk.. from ds^T
      unsigned da[4];
      ldmatrix_x4_trans(da, frag_addr(db + kk * 16 * kLd + warp * 16, kLd, lane, false));
      mma_ab_chunk(dq, da, kb, kk, lane);
    }
    __syncthreads();
  }
  store_acc_bf16(dq, dss + warp * 16 * kLd, head_ptr<bf16>(a.dq, a.dqs, b, head), a.dqs.t,
                 q0 + warp * 16, t, lane);
}

template <int kDrop>
int launch_bf16(const BwdArgs& a, int b, int nh, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bwd_keys_bf16_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemKeysBf16);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  bwd_delta_bf16_kernel<kHd><<<dim3((a.t + kDeltaRows - 1) / kDeltaRows, nh, b), kDeltaRows * 8,
                               0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.t + 63) / 64, nh, b);
  bwd_keys_bf16_kernel<kDrop><<<grid, kThreads, kSmemKeysBf16, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_bf16_kernel<<<grid, kThreads, kSmemDqBf16, s>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16, heads of 128 to 256
// The same three launches at the wide widths kW (128, 192, 256), with the
// products on wgmma and every [rows][kW] operand in shared memory as kW / 64
// column blocks in the 128-byte swizzle (load_tile_sw128_async):
//
//   delta  bwd_delta_bf16_kernel<kW>, 8 lanes a row, kW / 64 loads a lane.
//   keys   bwd_keys_wide_kernel: one warpgroup per 64 keys, walking the query
//          tiles as the 64-wide keys kernel does (S^T = k.q^T and dpd^T =
//          v.g^T of 16 query rows a step, the next step's in flight, the mask
//          drawn once, the same elementwise arithmetic), but k and v are read
//          from shared memory as A descriptors (m64n16k16, both operands
//          K-major) and the kernel keeps dv alone: dv += pd^T . g, one
//          m64n64k16 a column block (g MN-major).  ds^T goes to the scratch.
//   ds     bwd_ds_wide_kernel: dq = ds . k (blocks [0, tp / 64): 64 query
//          rows each) and dk = ds^T . q (blocks [tp / 64, 2 tp / 64): 64 keys
//          each) in one launch, both from the scratch: A a [64][64] tile of
//          ds^T (MN-major for dq, K-major for dk), B the [64][kW] tile of k or
//          q (MN-major), m64n64k16 a column block, through a 4-stage cp.async
//          ring.
//
// Why dk leaves the keys kernel: its accumulator is kW / 2 registers a
// thread, as dv's is, and at 256 the two alone are 256, past the 255 a
// thread can have; k and v as register A fragments would be another kW / 2.
// ds^T is in the scratch for dq anyway: dk reads it once more (at [30, 6,
// 512, 128] 94 MB, 0.03 ms of bytes) in place of a second accumulator, and
// every product is still computed once (five of 2 t t kW).  Shared memory
// of the keys kernel: k, v, two buffers of q and g, staging: 108 KB at 128
// (two blocks an SM), 156 KB at 192, 204 KB at 256 (one).
template <int kW>
constexpr size_t smem_keys_wide() {
  return 1024 + (size_t)6 * 64 * kW * sizeof(bf16) + 2 * 3 * 64 * sizeof(float) +
         (size_t)kWarps * 16 * kLd * sizeof(bf16);
}
static_assert(smem_keys_wide<256>() <= 232448, "the widest keys kernel fits one block");

constexpr int kStagesDs = 4;              // the ds kernel's ring
template <int kW>
constexpr size_t smem_ds_wide() {
  return 1024 + (size_t)kStagesDs * (64 * 64 + 64 * kW) * sizeof(bf16) +
         (size_t)kWarps * 16 * kLd * sizeof(bf16);
}

// S^T = k . q^T and dpd^T = v . g^T of 64 keys and 16 query rows, k and v
// read from shared memory: k, v the [64][kW] key tiles, q, g the query
// tiles (64 rows a column block) from the step's first row on; one commit group
template <int kW>
__device__ __forceinline__ void start_scores_wide(float (&s)[8], float (&dp)[8], const bf16* k,
                                                  const bf16* v, const bf16* q, const bf16* g) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kW / 16; ++kk)
    wgmma_m64n16k16_ss(s, kmajor_desc<64>(k, kk), kmajor_desc<64>(q, kk), kk);
#pragma unroll
  for (int kk = 0; kk < kW / 16; ++kk)
    wgmma_m64n16k16_ss(dp, kmajor_desc<64>(v, kk), kmajor_desc<64>(g, kk), kk);
  wgmma_commit();
}

// a warp's 16 rows of a [64, kW] accumulator (acc[cb]: columns 64 cb ..) as
// bf16, staged a column block at a time in its rows of `stage`
template <int kW>
__device__ __forceinline__ void store_wide_bf16(const float (&acc)[kW / 64][32], bf16* stage_w,
                                                bf16* dst, long long stride, int row0, int t,
                                                int lane) {
#pragma unroll
  for (int cb = 0; cb < kW / 64; ++cb) {
    float tile[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) tile[i >> 2][i & 3] = acc[cb][i];
    store_acc_bf16(tile, stage_w, dst + cb * 64, stride, row0, t, lane);
  }
}

template <int kW, int kDrop>
__global__ void __launch_bounds__(kThreads) bwd_keys_wide_kernel(BwdArgs a) {
  constexpr int kCb = kW / 64, kTile = 64 * kW;
  extern __shared__ unsigned char smem_kw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_kw + ((1024 - smem_addr(smem_kw) % 1024) % 1024));
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;                  // [2 buffers][kTile]
  bf16* gs = qs + 2 * kTile;              // [2 buffers][kTile]
  float* st_s = reinterpret_cast<float*>(gs + 2 * kTile);   // [2 buffers][m, 1/l, delta][64]
  bf16* stage = reinterpret_cast<bf16*>(st_s + 2 * 192);     // [warp][16][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kBk, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, tp = padded(t), kw = k0 + warp * 16;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* st = a.stats + (long long)plane * t;
  const bf16* qg = head_ptr<bf16>(a.q, a.qs, b, head);
  const bf16* gg = head_ptr<bf16>(a.g, a.gs, b, head);
  bf16* ds_g = a.scratch + ((long long)plane * tp + kw) * tp;   // the warp's 16 rows of ds^T
  bf16* ds_w = stage + warp * 16 * kLd;                          // their staging

  load_tile_sw128_async<64, kThreads, kW>(ks, head_ptr<bf16>(a.k, a.ks, b, head), a.ks.t, k0, t);
  load_tile_sw128_async<64, kThreads, kW>(vs, head_ptr<bf16>(a.v, a.vs, b, head), a.vs.t, k0, t);
  load_tile_sw128_async<64, kThreads, kW>(qs, qg, a.qs.t, 0, t);
  load_tile_sw128_async<64, kThreads, kW>(gs, gg, a.gs.t, 0, t);
  cp_async_commit();
  if (threadIdx.x < kBq) {
    const RowStats r = load_row_stats(st, planes_t, threadIdx.x, t);
    st_s[threadIdx.x] = r.m;
    st_s[64 + threadIdx.x] = r.inv_l;
    st_s[128 + threadIdx.x] = r.delta;
  }
  // bias of the warp's keys g and g + 8, the rows of its transposed tile
  const float bias0 = kw + g < t ? a.bias[(long long)b * t + kw + g] : -INFINITY;
  const float bias1 = kw + g + 8 < t ? a.bias[(long long)b * t + kw + g + 8] : -INFINITY;

  float dv[kCb][32];   // [64 keys, kW] of the warpgroup, a 64-column block each
#pragma unroll
  for (int cb = 0; cb < kCb; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[cb][i] = 0.f;

  const int n_tiles = (t + kBq - 1) / kBq;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, q0 = it * kBq;
    const bool more = it + 1 < n_tiles;
    RowStats next = {0.f, 1.f, 0.f};
    if (more) {                   // tile it + 1 into the other buffers, in flight during the math
      load_tile_sw128_async<64, kThreads, kW>(qs + (buf ^ 1) * kTile, qg, a.qs.t, q0 + kBq, t);
      load_tile_sw128_async<64, kThreads, kW>(gs + (buf ^ 1) * kTile, gg, a.gs.t, q0 + kBq, t);
      if (threadIdx.x < kBq) next = load_row_stats(st, planes_t, q0 + kBq + threadIdx.x, t);
    }
    cp_async_commit();
    cp_async_wait<1>();           // tile it (and the key tiles) landed: this thread's copies ...
    fence_proxy_async();          // ... seen by wgmma ...
    __syncthreads();              // ... for everyone's copies
    const bf16* qb = qs + buf * kTile;
    const bf16* gb = gs + buf * kTile;
    const float* sb = st_s + buf * 192;
    // 16 query rows a step, two steps in flight (as the 64-wide keys kernel)
    float s[2][8], dp[2][8];
    start_scores_wide<kW>(s[0], dp[0], ks, vs, qb, gb);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < 3) start_scores_wide<kW>(s[(c + 1) & 1], dp[(c + 1) & 1], ks, vs,
                                       qb + (c + 1) * 16 * 64, gb + (c + 1) * 16 * 64);
      unsigned bits[2][4];
      if constexpr (kDrop != 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc_bits_t<kDrop>(a.drop, plane, t, kw, q0 + c * 16 + nt * 8, lane, bits[nt]);
      }
      if (c < 3) wgmma_wait<1>(); else wgmma_wait<0>();   // step c's scores (and step c - 1's dv)
      wgmma_hold(s[c & 1]);
      wgmma_hold(dp[c & 1]);
      unsigned pa[4];   // pd^T of the step as an A fragment
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = c * 16 + nt * 8 + 2 * tq;   // the thread's rows r, r + 1 of the tile
        const float2 m2 = *reinterpret_cast<const float2*>(sb + r);
        const float2 il2 = *reinterpret_cast<const float2*>(sb + 64 + r);
        const float2 d2 = *reinterpret_cast<const float2*>(sb + 128 + r);
        float pdv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m = (i & 1) ? m2.y : m2.x, inv_l = (i & 1) ? il2.y : il2.x;
          const float delta = (i & 1) ? d2.y : d2.x;
          const float sv = s[c & 1][4 * nt + i] * a.sm_scale + ((i >> 1) ? bias1 : bias0);
          const float probs = expf(sv - m) * inv_l;
          float dprobs = dp[c & 1][4 * nt + i];
          pdv[i] = probs;
          if constexpr (kDrop != 0) {
            const bool keep = bits[nt][i] >= a.drop.thresh;
            dprobs = keep ? dprobs * a.inv_keep32 : 0.f;
            pdv[i] = keep ? __bfloat162float(__float2bfloat16_rn(probs)) * a.inv_keep : 0.f;
          }
          dsv[i] = (probs * (dprobs - delta)) * a.sm_scale;
        }
        // A layout: a0 (key g, rows 2t..), a1 (key g + 8), a2 / a3 the same 8 rows on
        pa[2 * nt] = pack_bf16(pdv[0], pdv[1]);
        pa[2 * nt + 1] = pack_bf16(pdv[2], pdv[3]);
        *reinterpret_cast<unsigned*>(ds_w + g * kLd + r) = pack_bf16(dsv[0], dsv[1]);
        *reinterpret_cast<unsigned*>(ds_w + (g + 8) * kLd + r) = pack_bf16(dsv[2], dsv[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < kCb; ++cb)
        wgmma_m64n64k16<1>(dv[cb], pa, sw128_desc(gb + cb * 64 * 64 + c * 16 * 64), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();              // the tile's buffers and the A registers are read
#pragma unroll
    for (int cb = 0; cb < kCb; ++cb) wgmma_hold(dv[cb]);
    __syncwarp();
    // the warp's 16 rows of ds^T for this tile's 64 query rows: 16-byte stores
#pragma unroll
    for (int idx = lane; idx < 16 * 8; idx += 32) {
      const int r = idx >> 3, cv = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(ds_g + (long long)r * tp + q0 + cv) =
          *reinterpret_cast<const uint4*>(ds_w + r * kLd + cv);
    }
    if (more && threadIdx.x < kBq) {   // buffer buf ^ 1 was last read before this tile's barrier
      float* nb = st_s + (buf ^ 1) * 192;
      nb[threadIdx.x] = next.m;
      nb[64 + threadIdx.x] = next.inv_l;
      nb[128 + threadIdx.x] = next.delta;
    }
    __syncthreads();              // buffers buf are free for tile it + 2
  }
  store_wide_bf16<kW>(dv, ds_w, head_ptr<bf16>(a.dv, a.dvs, b, head), a.dvs.t, kw, t, lane);
}

// dq of 64 query rows (blocks [0, tp / 64)) or dk of 64 keys (the rest) from
// the ds^T scratch: the contraction walks 64 keys (dq) or 64 query rows (dk)
// a step
template <int kW>
__global__ void __launch_bounds__(kThreads) bwd_ds_wide_kernel(BwdArgs a) {
  constexpr int kCb = kW / 64, kStage = 64 * 64 + 64 * kW;   // elements: ds^T tile, k or q tile
  constexpr int kAhead = kStagesDs - 2;
  extern __shared__ unsigned char smem_dsw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_dsw + ((1024 - smem_addr(smem_dsw) % 1024) % 1024));
  bf16* stage = ring + kStagesDs * kStage;  // [warp][16][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, tp = padded(t), n = tp / 64;
  const bool dq = (int)blockIdx.x < n;
  const int r0 = (dq ? blockIdx.x : blockIdx.x - n) * 64;   // the block's query rows or keys
  const bf16* ds_p = a.scratch + (long long)plane * tp * tp;  // ds^T: [keys][query rows]
  // B: k's rows (dq) or q's rows (dk), the contraction's index
  const bf16* bsrc = dq ? head_ptr<bf16>(a.k, a.ks, b, head) : head_ptr<bf16>(a.q, a.qs, b, head);
  const long long bstride = dq ? a.ks.t : a.qs.t;

  // step i: ds^T rows i * 64 .. at columns r0 .. (dq: [keys][rows], read as A
  // MN-major) or rows r0 .. at columns i * 64 .. (dk: [keys][rows], A K-major),
  // and rows i * 64 .. of k or q
  auto load_step = [&](int i) {
    bf16* d = ring + (i % kStagesDs) * kStage;
    if (dq) load_tile_sw128_async<64, kThreads, 64>(d, ds_p + r0, tp, i * 64, tp);
    else load_tile_sw128_async<64, kThreads, 64>(d, ds_p + i * 64, tp, r0, tp);
    load_tile_sw128_async<64, kThreads, kW>(d + 64 * 64, bsrc, bstride, i * 64, t);
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < n) load_step(i);
    cp_async_commit();
  }
  float acc[kCb][32];
#pragma unroll
  for (int cb = 0; cb < kCb; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  for (int i = 0; i < n; ++i) {
    // one barrier a step, as the forward's ring: the stage loaded here was
    // last read in step i - 2, whose products every thread waited for
    if (i + kAhead < n) load_step(i + kAhead);
    cp_async_commit();
    cp_async_wait<kAhead>();
    fence_proxy_async();
    __syncthreads();
    const bf16* at = ring + (i % kStagesDs) * kStage;
    const bf16* bt = at + 64 * 64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int cb = 0; cb < kCb; ++cb) {
        const unsigned long long db = sw128_desc(bt + cb * 64 * 64 + kk * 16 * 64);
        if (dq) wgmma_m64n64k16_ss<1, 1>(acc[cb], sw128_desc(at + kk * 16 * 64), db, 1);
        else wgmma_m64n64k16_ss<0, 1>(acc[cb], sw128_desc(at + kk * 16), db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < kCb; ++cb) wgmma_hold(acc[cb]);
  }
  bf16* dst = dq ? head_ptr<bf16>(a.dq, a.dqs, b, head) : head_ptr<bf16>(a.dk, a.dks, b, head);
  store_wide_bf16<kW>(acc, stage + warp * 16 * kLd, dst, dq ? a.dqs.t : a.dks.t, r0 + warp * 16,
                      t, lane);
}

template <int kW, int kDrop>
int launch_bf16_wide(const BwdArgs& a, int b, int nh, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bwd_keys_wide_kernel<kW, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_keys_wide<kW>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_ds_wide_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_ds_wide<kW>());
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  bwd_delta_bf16_kernel<kW><<<dim3((a.t + kDeltaRows - 1) / kDeltaRows, nh, b), kDeltaRows * 8,
                              0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.t + 63) / 64;
  bwd_keys_wide_kernel<kW, kDrop><<<dim3(tiles, nh, b), kThreads, smem_keys_wide<kW>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_ds_wide_kernel<kW><<<dim3(2 * tiles, nh, b), kThreads, smem_ds_wide<kW>(), s>>>(a);
  return (int)cudaGetLastError();
}

template <int kDrop>
int launch_bf16_at(int hd, const BwdArgs& a, int b, int nh, void* stream) {
  switch (hd) {
    case 64: return launch_bf16<kDrop>(a, b, nh, stream);
    case 128: return launch_bf16_wide<128, kDrop>(a, b, nh, stream);
    case 192: return launch_bf16_wide<192, kDrop>(a, b, nh, stream);
    case 256: return launch_bf16_wide<256, kDrop>(a, b, nh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ==================================================================== f32 ====
// Two launches a backward, each product split TF32 (3xTF32) on mma.sync
// m16n8k8 (attention_tile.cuh), seven products in all: the scores and dpd
// are computed in both kernels rather than handed over in an f32 ds scratch
// ([b * heads, t, t] f32 is 377 MB written and read at [30, 12, 512, 64],
// 0.23 ms of bytes, against about 0.15 ms for two products at the split-TF32
// rate).
//
//   rows  one block per 64 query rows, one warp per 16, walking the key tiles
//         (keys, values and biases by cp.async, two stages): delta =
//         rowsum(g * ctx) of the warp's rows first (into plane 2 of the
//         statistics, for the keys kernel), then per tile the scores through
//         tf32x3_scores -- the forward's own score tile, so that p = exp(s -
//         m) * (1 / l) is the forward's bit for bit -- dpd = g.v^T, ds, and
//         dq += ds . k, ds's A fragments straight from its accumulator.
//   keys  one block per 64 keys, one warp per 16, walking the query tiles
//         (q, g and the rows' m, 1 / l, delta, two stages): the tile
//         transposed, keys as the M dimension, S^T = k.q^T and dpd^T = v.g^T,
//         then pd^T and ds^T straight from the accumulators as the A
//         fragments of dv += pd^T . g and dk += ds^T . q.  The mask words of
//         the transposed tile come as in the bf16 keys kernel (acc_bits_t).
//
// q and g (rows kernel), k and v (keys kernel) of the warp's 16 rows sit
// unsplit in shared memory as A fragments and are split at each use; the
// tiles walked over have a pitch of 72 floats (float2 B reads without
// conflicts, the scalar B reads of dq, dk, dv two-way), and a warp takes a
// tile in four parts of 16 keys or rows, one after the other: the keys
// kernel's dk and dv sums (64 registers) stay beside its scores without
// spills (in halves of 32 it spilled up to 92 bytes and read 0.52 ms against
// 0.43 at [4, 12, 512, 64], PERF.md).  The sums over keys
// (dq) and rows (dk, dv) take a fresh tensor-core accumulator every k-step of
// 8 and add it by FADD (mma3_add), so that the truncating additions stay at
// the size of 8 products.  Blocks of 107 and 108 KB: two an SM.
constexpr int kLdT = 72;                              // pitch of the walked tiles
constexpr int kPartF32 = kBk / 32;                    // the 8-wide n-tiles of a quarter tile
constexpr int kFragF32 = kWarps * (kHd / 8) * 32 * 4;   // a block's rows as A fragments
constexpr int kStageRows = 2 * kBk * kLdT + kBk;      // keys, values, biases
constexpr int kStageKeys = 2 * kBq * kLdT + 3 * kBq;  // q, g, then m, 1 / l, delta
constexpr size_t kSmemRowsF32 = ((size_t)2 * kStageRows + 2 * kFragF32) * sizeof(float);
constexpr size_t kSmemKeysF32 = ((size_t)2 * kStageKeys + 2 * kFragF32) * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads, 2) bwd_rows_tf32x3_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, row_g = q0 + warp * kRows + g;
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* kg = head_ptr<float>(a.k, a.ks, b, head);
  const float* vg = head_ptr<float>(a.v, a.vs, b, head);
  const float* bg = a.bias + (long long)b * t;
  float* st = a.stats + (long long)plane * t;
  const int n = (t + kBk - 1) / kBk;

  auto load = [&](int j) {
    float* kd = smem_rows + (j & 1) * kStageRows;
    load_tile_f32_async<kLdT>(kd, kg, a.ks.t, j * kBk, t);
    load_tile_f32_async<kLdT>(kd + kBk * kLdT, vg, a.vs.t, j * kBk, t);
    float* bd = kd + 2 * kBk * kLdT;
    if (threadIdx.x < kBk) {
      if (j * kBk + (int)threadIdx.x < t) cp_async4(bd + threadIdx.x, bg + j * kBk + threadIdx.x);
      else bd[threadIdx.x] = -INFINITY;   // keys past t: zero weight
    }
  };
  load(0);
  cp_async_commit();
  // each thread reads back only its own fragments: no barrier
  float4* qfrag = reinterpret_cast<float4*>(smem_rows + 2 * kStageRows) + warp * (kHd / 8) * 32 + lane;
  float4* gfrag = qfrag + kFragF32 / 4;
  const float* gsrc = head_ptr<float>(a.g, a.gs, b, head);
  store_row_frags(qfrag, head_ptr<float>(a.q, a.qs, b, head), a.qs.t, row_g, t, tq);
  store_row_frags(gfrag, gsrc, a.gs.t, row_g, t, tq);
  auto qa = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(qfrag[kk * 32], hi, lo); };
  auto ga = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(gfrag[kk * 32], hi, lo); };

  // delta = rowsum(g * ctx) of rows row_g (h = 0) and row_g + 8: the thread's
  // 16 columns, then the quad's sum; the forward's m and 1 / l.  Rows past t
  // (q and g are zero there) take (m, 1 / l, delta) = (0, 1, 0).
  float m[2], inv_l[2], delta[2];
  const float* ctx = head_ptr<float>(a.out, a.os, b, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    const bool valid = row < t;
    float sum = 0.f;
    if (valid) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(gsrc + (long long)row * a.gs.t + 16 * tq + 4 * i);
        const float4 ov = *reinterpret_cast<const float4*>(ctx + (long long)row * a.os.t + 16 * tq + 4 * i);
        sum += gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m[h] = valid ? st[row] : 0.f;
    inv_l[h] = valid ? 1.f / st[planes_t + row] : 1.f;   // the forward's 1 / l
    delta[h] = sum;
    if (valid && tq == 0) st[2 * planes_t + row] = sum;
  }

  const PhiloxRow prow = philox_row(a.drop, plane, row_g + 8 * (tq & 1));   // this thread's calls
  float dq[kHd / 8][4];
#pragma unroll
  for (int c = 0; c < kHd / 8; ++c) dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                      // tile j's copies, everyone's
    const float* kt = smem_rows + (j & 1) * kStageRows;
    // the tile in four parts of 16 keys, one after the other (registers)
#pragma unroll 1
    for (int c0 = 0; c0 < kBk / 8; c0 += kPartF32) {
      float dp[kPartF32][4], s[kPartF32][4];
      tf32x3_abT<kLdT, kPartF32>(dp, ga, kt + (kBk + 8 * c0) * kLdT, g, tq);   // dpd = g.v^T
      tf32x3_scores<kLdT, kPartF32>(s, qa, kt + 8 * c0 * kLdT, kt + 2 * kBk * kLdT + 8 * c0,
                                          a.sm_scale, g, tq);
#pragma unroll
      for (int c = 0; c < kPartF32; ++c) {
        unsigned bits[4];
        if constexpr (kDrop != 0)
          acc_bits<kDrop>(a.drop, prow, plane, t, row_g, j * kBk + 8 * (c0 + c), lane, bits);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float probs = expf(s[c][i] - m[i >> 1]) * inv_l[i >> 1];
          float dprobs = dp[c][i];
          if constexpr (kDrop != 0) {
            const float kept = dprobs * a.inv_keep32;   // before the select: no branch
            dprobs = bits[i] >= a.drop.thresh ? kept : 0.f;
          }
          s[c][i] = (probs * (dprobs - delta[i >> 1])) * a.sm_scale;   // ds
        }
      }
      // dq += ds . k: k-step c is keys 8 c .. + 7 (ds's A fragment (c0, c2,
      // c1, c3) of its accumulator tile c), B the key tile's rows 8 c + 2 tq,
      // + 1 at dims 8 nn + g
#pragma unroll
      for (int c = 0; c < kPartF32; ++c) {
        float dh[4], dl[4];
        split_frag(make_float4(s[c][0], s[c][2], s[c][1], s[c][3]), dh, dl);
        const float* k0 = kt + (8 * (c0 + c) + 2 * tq) * kLdT + g;
#pragma unroll
        for (int nn = 0; nn < kHd / 8; ++nn) mma3_add(dq[nn], dh, dl, k0[8 * nn], k0[kLdT + 8 * nn]);
      }
    }
    __syncthreads();                      // the stage is reloaded with tile j + 2
  }
  store_rows_f32(dq, head_ptr<float>(a.dq, a.dqs, b, head), a.dqs.t, row_g, t, tq);
}

template <int kDrop>
__global__ void __launch_bounds__(kThreads, 2) bwd_keys_tf32x3_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem_keys_f32[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kBk, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head;
  const int kw = k0 + warp * 16;          // the warp's keys; the thread's kw + g and kw + g + 8
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* st = a.stats + (long long)plane * t;
  const float* qg = head_ptr<float>(a.q, a.qs, b, head);
  const float* gg = head_ptr<float>(a.g, a.gs, b, head);
  const int n = (t + kBq - 1) / kBq;

  auto load = [&](int i) {
    float* d = smem_keys_f32 + (i & 1) * kStageKeys;
    load_tile_f32_async<kLdT>(d, qg, a.qs.t, i * kBq, t);
    load_tile_f32_async<kLdT>(d + kBq * kLdT, gg, a.gs.t, i * kBq, t);
  };
  // m, 1 / l (the forward's, as it takes it) and delta of a query row; rows
  // past t (q and g are zero there) take 0, 1, 0
  auto row_stats = [&](int row, float (&r)[3]) {
    const bool valid = row < t;
    r[0] = valid ? st[row] : 0.f;
    r[1] = valid ? 1.f / st[planes_t + row] : 1.f;
    r[2] = valid ? st[2 * planes_t + row] : 0.f;
  };
  auto put_stats = [&](int i, const float (&r)[3]) {
    float* d = smem_keys_f32 + (i & 1) * kStageKeys + 2 * kBq * kLdT + threadIdx.x;
    d[0] = r[0];
    d[kBq] = r[1];
    d[2 * kBq] = r[2];
  };
  load(0);
  cp_async_commit();
  if (threadIdx.x < kBq) {
    float r[3];
    row_stats(threadIdx.x, r);
    put_stats(0, r);
  }
  float4* kfrag = reinterpret_cast<float4*>(smem_keys_f32 + 2 * kStageKeys) + warp * (kHd / 8) * 32 + lane;
  float4* vfrag = kfrag + kFragF32 / 4;
  store_row_frags(kfrag, head_ptr<float>(a.k, a.ks, b, head), a.ks.t, kw + g, t, tq);
  store_row_frags(vfrag, head_ptr<float>(a.v, a.vs, b, head), a.vs.t, kw + g, t, tq);
  auto ka = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(kfrag[kk * 32], hi, lo); };
  auto va = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(vfrag[kk * 32], hi, lo); };
  // bias of the thread's keys, the rows of its transposed tile
  const float bias0 = kw + g < t ? a.bias[(long long)b * t + kw + g] : -INFINITY;
  const float bias1 = kw + g + 8 < t ? a.bias[(long long)b * t + kw + g + 8] : -INFINITY;

  float dk[kHd / 8][4], dv[kHd / 8][4];
#pragma unroll
  for (int c = 0; c < kHd / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[c][i] = dv[c][i] = 0.f;
  for (int it = 0; it < n; ++it) {
    const bool more = it + 1 < n;
    float next[3] = {0.f, 1.f, 0.f};
    if (more) {                           // tile it + 1, in flight during the math
      load(it + 1);
      if (threadIdx.x < kBq) row_stats((it + 1) * kBq + threadIdx.x, next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                      // tile it's copies and statistics, everyone's
    const float* qt = smem_keys_f32 + (it & 1) * kStageKeys;
    const float* gt = qt + kBq * kLdT;
    const float* sb = gt + kBq * kLdT;
    // the tile in four parts of 16 rows, one after the other (registers):
    // S^T = k.q^T and dpd^T = v.g^T of the warp's 16 keys, s[c] holding keys
    // g, g + 8 at rows 8 c + 2 tq, + 1
#pragma unroll 1
    for (int c0 = 0; c0 < kBq / 8; c0 += kPartF32) {
      float s[kPartF32][4], dp[kPartF32][4];
      tf32x3_abT<kLdT, kPartF32>(s, ka, qt + 8 * c0 * kLdT, g, tq);
      tf32x3_abT<kLdT, kPartF32>(dp, va, gt + 8 * c0 * kLdT, g, tq);
#pragma unroll
      for (int c = 0; c < kPartF32; ++c) {
        unsigned bits[4];
        if constexpr (kDrop != 0)
          acc_bits_t<kDrop>(a.drop, plane, t, kw, it * kBq + 8 * (c0 + c), lane, bits);
        const int r = 8 * (c0 + c) + 2 * tq;
        const float2 m2 = *reinterpret_cast<const float2*>(sb + r);
        const float2 il2 = *reinterpret_cast<const float2*>(sb + kBq + r);
        const float2 d2 = *reinterpret_cast<const float2*>(sb + 2 * kBq + r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = s[c][i] * a.sm_scale + ((i >> 1) ? bias1 : bias0);
          const float probs = expf(sv - ((i & 1) ? m2.y : m2.x)) * ((i & 1) ? il2.y : il2.x);
          float pd = probs, dprobs = dp[c][i];
          if constexpr (kDrop != 0) {
            const bool keep = bits[i] >= a.drop.thresh;
            const float kept_p = probs * a.inv_keep, kept_d = dprobs * a.inv_keep32;
            pd = keep ? kept_p : 0.f;
            dprobs = keep ? kept_d : 0.f;
          }
          s[c][i] = pd;
          dp[c][i] = (probs * (dprobs - ((i & 1) ? d2.y : d2.x))) * a.sm_scale;   // ds^T
        }
      }
      // dv += pd^T . g and dk += ds^T . q: k-step c is rows 8 c .. + 7, B the
      // g and q tiles' rows 8 c + 2 tq, + 1 at dims 8 nn + g
#pragma unroll
      for (int c = 0; c < kPartF32; ++c) {
        float ph[4], pl[4], dh[4], dl[4];
        split_frag(make_float4(s[c][0], s[c][2], s[c][1], s[c][3]), ph, pl);
        split_frag(make_float4(dp[c][0], dp[c][2], dp[c][1], dp[c][3]), dh, dl);
        const float* g0 = gt + (8 * (c0 + c) + 2 * tq) * kLdT + g;
        const float* q0 = qt + (8 * (c0 + c) + 2 * tq) * kLdT + g;
#pragma unroll
        for (int nn = 0; nn < kHd / 8; ++nn) {
          mma3_add(dv[nn], ph, pl, g0[8 * nn], g0[kLdT + 8 * nn]);
          mma3_add(dk[nn], dh, dl, q0[8 * nn], q0[kLdT + 8 * nn]);
        }
      }
    }
    if (more && threadIdx.x < kBq) put_stats(it + 1, next);   // last read before this tile's barrier
    __syncthreads();                      // buffers it & 1 are free for tile it + 2
  }
  store_rows_f32(dv, head_ptr<float>(a.dv, a.dvs, b, head), a.dvs.t, kw + g, t, tq);
  store_rows_f32(dk, head_ptr<float>(a.dk, a.dks, b, head), a.dks.t, kw + g, t, tq);
}

int launch_f32(void (*rows)(BwdArgs), void (*keys)(BwdArgs), const BwdArgs& a, int b, int nh,
               void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemRowsF32);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(keys, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemKeysF32);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + 63) / 64, nh, b);
  rows<<<grid, kThreads, kSmemRowsF32, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  keys<<<grid, kThreads, kSmemKeysF32, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- f32, heads of 128 to 256
// Two launches, every product split TF32 on mma.sync m16n8k8 as at 64, none on
// the FP32 lanes; five products of 2 t t kW (the scores, dpd, dq, dk, dv), each
// computed once, with ds and pd handed over through an f32 scratch [2, b *
// heads, tp, tp] (tp = t rounded up to 64; row-major: query rows, keys) that
// the wrapper allocates and frees on return:
//
//   scores  bwd_scores_f32_kernel: one block of 8 warps per 64 query rows,
//           walking the key tiles (keys, values, biases by cp.async, two
//           stages): warp w owns rows 16 (w % 4) .. + 15 and half of each
//           tile's keys.  delta = rowsum(g * ctx) of its rows first, then per
//           tile the scores through tf32x3_scores -- the forward's own score
//           function, so p = exp(s - m) * (1 / l) is the forward's bit for bit
//           for all three gradients -- dpd = g . v^T, the mask, pd = keep ? p
//           (1 / (1 - p_drop)) : 0 and ds = p (dprobs - delta) scale, both
//           stored to the scratch by float2 stores straight from the
//           accumulators.  No sum lives across the walk, so two warps share
//           a row group's fragments and tiles: 8 warps an SM from one block.
//   grads   bwd_grads_f32_kernel: blocks [0, tp / 64) dq = ds . k of 64 query
//           rows, [tp / 64, 2 tp / 64) dk = ds^T . q of 64 keys, the rest dv =
//           pd^T . g of 64 keys; a warp's 16 rows and all kW columns (kW / 2
//           registers a thread), the contraction walked 32 rows at a time (a
//           scratch tile and a tile of k, q or g, two stages by cp.async), each
//           k-step of 8 in a fresh accumulator added in f32 (mma3_add).
//
// Why this split.  The 64-wide design cannot be instantiated wider: its keys
// kernel holds dk and dv for a warp's 16 keys, kW floats a thread (256 at
// 256), and its rows kernel dq beside the score tiles.  The bf16 wide split
// (bwd_keys_wide_kernel) keeps dv in a transposed keys kernel, whose S^T = k .
// q^T is another product order than the forward's scores; here every
// probability comes from tf32x3_scores (ds for dq and dk, pd for dv), and the
// kernel that makes them holds no sum, so its tile is set by shared memory
// alone.  The price is pd
// beside ds in the scratch: at [4, 6, 512, 128] 2 x 25 MB written once, ds
// read twice and pd once, about 0.038 ms of bytes at 3.35 TB/s, in place of
// two recomputed products (the 64-wide design's seven against five).  Shared
// memory: the scores kernel's q and g fragments (2 x 64 x kW floats) and two
// stages of key tiles (64 keys at 128, 32 at 192, 16 at 256): 201, 196 and 194
// KB, one block an SM; the grads kernel 53, 69 and 85 KB, two blocks an SM.
template <int kW> struct F32WideCfg;       // keys a tile of the scores kernel
template <> struct F32WideCfg<128> { static constexpr int bk = 64; };
template <> struct F32WideCfg<192> { static constexpr int bk = 32; };
template <> struct F32WideCfg<256> { static constexpr int bk = 16; };
constexpr int kThreadsScores = 2 * kThreads;   // 8 warps: two a row group

template <int kW> __host__ __device__ constexpr int ld_scores() { return kW + 8; }   // float2 B reads
template <int kW>
__host__ __device__ constexpr int stage_scores() {
  return F32WideCfg<kW>::bk * (2 * ld_scores<kW>() + 1);
}
template <int kW>
__host__ __device__ constexpr size_t smem_scores() {
  return ((size_t)2 * stage_scores<kW>() + 2 * kWarps * (kW / 8) * 32 * 4) * sizeof(float);
}
static_assert(smem_scores<128>() <= 232448 && smem_scores<192>() <= 232448 &&
                  smem_scores<256>() <= 232448,
              "the scores kernel fits one block");

template <int kW, int kDrop>
__global__ void __launch_bounds__(kThreadsScores, 1) bwd_scores_f32_kernel(BwdArgs a) {
  constexpr int kBkS = F32WideCfg<kW>::bk, kLd = ld_scores<kW>(), kStage = stage_scores<kW>();
  constexpr int kN = kBkS / 16;           // 8-key n-tiles of a warp's half tile
  extern __shared__ __align__(16) float smem_sc[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int rw = warp & 3, half = warp >> 2;   // the warp's row group and half of a tile
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, row_g = q0 + rw * kRows + g, tp = padded(t);
  const long long planes_t = (long long)gridDim.z * gridDim.y * t;
  const float* kg = head_ptr<float>(a.k, a.ks, b, head);
  const float* vg = head_ptr<float>(a.v, a.vs, b, head);
  const float* bg = a.bias + (long long)b * t;
  const float* st = a.stats + (long long)plane * t;
  float* ds_g = a.scratch32 + (long long)plane * tp * tp;                  // [rows][keys]
  float* pd_g = ds_g + (long long)gridDim.z * gridDim.y * tp * tp;
  const int n = tp / kBkS;                // every key of the scratch's rows gets written

  auto load = [&](int j) {
    float* kd = smem_sc + (j & 1) * kStage;
    load_tile_f32_async<kLd, kBkS, kW, kThreadsScores>(kd, kg, a.ks.t, j * kBkS, t);
    load_tile_f32_async<kLd, kBkS, kW, kThreadsScores>(kd + kBkS * kLd, vg, a.vs.t, j * kBkS, t);
    float* bd = kd + 2 * kBkS * kLd;
    if (threadIdx.x < kBkS) {
      if (j * kBkS + (int)threadIdx.x < t) cp_async4(bd + threadIdx.x, bg + j * kBkS + threadIdx.x);
      else bd[threadIdx.x] = -INFINITY;   // keys past t: zero weight
    }
  };
  load(0);
  cp_async_commit();
  // the row groups' A fragments, q by warps 0-3 and g by warps 4-7; the first
  // tile's barrier orders the stores before any read
  float4* qfrag = reinterpret_cast<float4*>(smem_sc + 2 * kStage) + rw * (kW / 8) * 32 + lane;
  float4* gfrag = qfrag + kWarps * (kW / 8) * 32;
  const float* gsrc = head_ptr<float>(a.g, a.gs, b, head);
  if (half == 0) store_row_frags<kW>(qfrag, head_ptr<float>(a.q, a.qs, b, head), a.qs.t, row_g, t, tq);
  else store_row_frags<kW>(gfrag, gsrc, a.gs.t, row_g, t, tq);
  auto qa = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(qfrag[kk * 32], hi, lo); };
  auto ga = [&](int kk, float (&hi)[4], float (&lo)[4]) { split_frag(gfrag[kk * 32], hi, lo); };

  // delta = rowsum(g * ctx) of rows row_g (h = 0) and row_g + 8: the thread's
  // kW / 4 columns, then the quad's sum; the forward's m and 1 / l.  Rows past
  // t (q and g are zero there) take (m, 1 / l, delta) = (0, 1, 0).
  float m[2], inv_l[2], delta[2];
  bool valid[2];
  const float* ctx = head_ptr<float>(a.out, a.os, b, head);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    valid[h] = row < t;
    float sum = 0.f;
    if (valid[h]) {
#pragma unroll
      for (int i = 0; i < kW / 16; ++i) {
        const int col = 4 * (tq + 4 * i);
        const float4 gv = *reinterpret_cast<const float4*>(gsrc + (long long)row * a.gs.t + col);
        const float4 ov = *reinterpret_cast<const float4*>(ctx + (long long)row * a.os.t + col);
        sum += gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m[h] = valid[h] ? st[row] : 0.f;
    inv_l[h] = valid[h] ? 1.f / st[planes_t + row] : 1.f;   // the forward's 1 / l
    delta[h] = sum;
  }

  const PhiloxRow prow = philox_row(a.drop, plane, row_g + 8 * (tq & 1));   // this thread's calls
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                      // tile j's copies, everyone's
    const float* kt = smem_sc + (j & 1) * kStage + half * 8 * kN * kLd;   // the warp's keys
    const float* vt = kt + kBkS * kLd;
    const float* bt = smem_sc + (j & 1) * kStage + 2 * kBkS * kLd + half * 8 * kN;
    const int key0 = j * kBkS + half * 8 * kN;
    float s[kN][4], dp[kN][4];
    tf32x3_abT<kLd, kN, kW>(dp, ga, vt, g, tq);                      // dpd = g.v^T
    tf32x3_scores<kLd, kN, kW>(s, qa, kt, bt, a.sm_scale, g, tq);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      unsigned bits[4];
      if constexpr (kDrop != 0)
        acc_bits<kDrop>(a.drop, prow, plane, t, row_g, key0 + 8 * c, lane, bits);
      float pd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float probs = expf(s[c][i] - m[i >> 1]) * inv_l[i >> 1];
        float dprobs = dp[c][i];
        pd[i] = probs;
        if constexpr (kDrop != 0) {
          const bool keep = bits[i] >= a.drop.thresh;
          const float kept_p = probs * a.inv_keep, kept_d = dprobs * a.inv_keep32;
          pd[i] = keep ? kept_p : 0.f;
          dprobs = keep ? kept_d : 0.f;
        }
        if (!valid[i >> 1]) pd[i] = 0.f;     // rows past t: dv must not see them
        s[c][i] = (probs * (dprobs - delta[i >> 1])) * a.sm_scale;   // ds
      }
      const int key = key0 + 8 * c + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long at = (long long)(row_g + 8 * h) * tp + key;
        *reinterpret_cast<float2*>(ds_g + at) = make_float2(s[c][2 * h], s[c][2 * h + 1]);
        *reinterpret_cast<float2*>(pd_g + at) = make_float2(pd[2 * h], pd[2 * h + 1]);
      }
    }
    __syncthreads();                      // the stage is reloaded with tile j + 2
  }
}

constexpr int kStepG = 32;                // contraction rows a step of the grads kernel
constexpr int kLdGA = 40;                 // dq's A tile [64 rows][32 keys]: float2 reads
constexpr int kLdGAT = 68;                // dk's, dv's [32 query rows][64 keys]: scalar reads
constexpr int kTileGA = 64 * kLdGA;       // floats of either A tile (>= 32 x 68)
template <int kW>
__host__ __device__ constexpr int stage_grads() { return kTileGA + kStepG * (kW + 4); }
template <int kW>
__host__ __device__ constexpr size_t smem_grads() {
  return (size_t)2 * stage_grads<kW>() * sizeof(float);
}

template <int kW>
__global__ void __launch_bounds__(kThreads, 2) bwd_grads_f32_kernel(BwdArgs a) {
  constexpr int kLdB = kW + 4, kStage = stage_grads<kW>();   // B: conflict-free scalar reads
  extern __shared__ __align__(16) float smem_gr[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int plane = b * gridDim.y + head, tp = padded(t), n64 = tp / 64;
  const int role = blockIdx.x / n64;      // 0: dq, 1: dk, 2: dv
  const int r0 = (blockIdx.x % n64) * 64; // the block's query rows (dq) or keys
  const float* src = a.scratch32 + (long long)plane * tp * tp +
                     (role == 2 ? (long long)gridDim.z * gridDim.y * tp * tp : 0);   // ds or pd
  const float* bsrc = role == 0 ? head_ptr<float>(a.k, a.ks, b, head)
                    : role == 1 ? head_ptr<float>(a.q, a.qs, b, head)
                                : head_ptr<float>(a.g, a.gs, b, head);
  const long long bstride = role == 0 ? a.ks.t : role == 1 ? a.qs.t : a.gs.t;

  // step i: the contraction's rows i * 32 .. of the scratch tile (dq: rows r0
  // .., keys i * 32 ..; dk, dv: query rows i * 32 .., keys r0 ..) and of k,
  // q or g
  auto load = [&](int i) {
    float* d = smem_gr + (i & 1) * kStage;
    if (role == 0) load_tile_f32_async<kLdGA, 64, kStepG>(d, src + i * kStepG, tp, r0, tp);
    else load_tile_f32_async<kLdGAT, kStepG, 64>(d, src + r0, tp, i * kStepG, tp);
    load_tile_f32_async<kLdB, kStepG, kW>(d + kTileGA, bsrc, bstride, i * kStepG, t);
  };
  float acc[kW / 8][4];
#pragma unroll
  for (int c = 0; c < kW / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  load(0);
  cp_async_commit();
  const int n = tp / kStepG;
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                      // step i's copies, everyone's
    const float* at = smem_gr + (i & 1) * kStage;
    const float* bt = at + kTileGA;
#pragma unroll 1
    for (int c = 0; c < kStepG / 8; ++c) {   // not unrolled: its loads spilled at 192 and 256
      // the A fragment of k-step c: (row g, element 2 tq), (row g + 8, 2 tq),
      // (row g, 2 tq + 1), (row g + 8, 2 tq + 1) of the warp's 16 rows
      float4 av;
      if (role == 0) {
        const float2 x0 = *reinterpret_cast<const float2*>(at + (warp * 16 + g) * kLdGA + 8 * c + 2 * tq);
        const float2 x1 = *reinterpret_cast<const float2*>(at + (warp * 16 + g + 8) * kLdGA + 8 * c + 2 * tq);
        av = make_float4(x0.x, x1.x, x0.y, x1.y);
      } else {
        const float* x = at + (8 * c + 2 * tq) * kLdGAT + warp * 16 + g;
        av = make_float4(x[0], x[8], x[kLdGAT], x[kLdGAT + 8]);
      }
      float ah[4], al[4];
      split_frag(av, ah, al);
      const float* b0 = bt + (8 * c + 2 * tq) * kLdB + g;
#pragma unroll
      for (int nn = 0; nn < kW / 8; ++nn) mma3_add(acc[nn], ah, al, b0[8 * nn], b0[kLdB + 8 * nn]);
    }
    __syncthreads();                      // the stage is reloaded with step i + 2
  }
  float* dst = role == 0 ? head_ptr<float>(a.dq, a.dqs, b, head)
             : role == 1 ? head_ptr<float>(a.dk, a.dks, b, head)
                         : head_ptr<float>(a.dv, a.dvs, b, head);
  const long long dstride = role == 0 ? a.dqs.t : role == 1 ? a.dks.t : a.dvs.t;
  store_rows_f32<kW>(acc, dst, dstride, r0 + warp * 16 + g, t, tq);
}

template <int kW, int kDrop>
int launch_f32_wide(const BwdArgs& a, int b, int nh, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(bwd_scores_f32_kernel<kW, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_scores<kW>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_grads_f32_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_grads<kW>());
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (a.t + 63) / 64;
  bwd_scores_f32_kernel<kW, kDrop><<<dim3(tiles, nh, b), kThreadsScores, smem_scores<kW>(), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_grads_f32_kernel<kW><<<dim3(3 * tiles, nh, b), kThreads, smem_grads<kW>(), s>>>(a);
  return (int)cudaGetLastError();
}

template <int kDrop>
int launch_f32_at(int hd, const BwdArgs& a, int b, int nh, void* stream) {
  switch (hd) {
    case 64:
      return launch_f32(bwd_rows_tf32x3_kernel<kDrop>, bwd_keys_tf32x3_kernel<kDrop>, a, b, nh,
                        stream);
    case 128: return launch_f32_wide<128, kDrop>(a, b, nh, stream);
    case 192: return launch_f32_wide<192, kDrop>(a, b, nh, stream);
    case 256: return launch_f32_wide<256, kDrop>(a, b, nh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* bias, const void* g,
                  const void* out, void* dq, void* dk, void* dv, void* stats, void* scratch, int t,
                  const long long* strides, float sm_scale, unsigned long long seed, unsigned c0,
                  unsigned thresh, unsigned plane0, float keep_div, float keep_div32,
                  const void* bits) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.g = g; a.out = out; a.bias = (const float*)bias;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = (float*)stats; a.t = t;
  a.scratch = (bf16*)scratch;
  a.scratch32 = (float*)scratch;
  Strides* dst[8] = {&a.qs, &a.ks, &a.vs, &a.gs, &a.os, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;
  a.inv_keep32 = 1.f / keep_div32;
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div32, (const unsigned*)bits, plane0, 0u};
  return a;
}

bool bad_grid(int b, int nh, int t) { return b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535; }

}  // namespace

// strides: (batch, head, token) of q, k, v, g, out, dq, dk, dv; stats: the
// [3, b * nh, t] f32 array whose planes 0 and 1 the forward filled (plane 2
// receives delta where a kernel hands it on); hd: the head width, 64, 128, 192
// or 256; scratch: bf16 [b * nh, tp, tp] (ds^T) in bf16, f32 [2, b * nh, tp,
// tp] (ds, pd) in f32 at heads wider than 64, ignored (may be null) in f32 at
// 64, with tp = t rounded up to 64; mode and plane0 as in the forward.  bf16
// launches three kernels (delta, keys, dq; at the wide widths delta, keys,
// ds), f32 two (rows, keys; at the wide widths scores, grads).
extern "C" int aspire_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* g, const void* out,
                                         void* dq, void* dk, void* dv, void* stats, void* scratch,
                                         int b, int nh, int t, int hd, const long long* strides,
                                         float sm_scale, int mode, unsigned long long seed,
                                         unsigned c0, unsigned thresh, unsigned plane0,
                                         float keep_div, float keep_div32, const void* bits,
                                         void* stream) {
  if (bad_grid(b, nh, t) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, g, out, dq, dk, dv, stats, scratch, t, strides,
                              sm_scale, seed, c0, thresh, plane0, keep_div, keep_div32, bits);
  if (mode == 0) return launch_bf16_at<0>(hd, a, b, nh, stream);
  if (mode == 1) return launch_bf16_at<1>(hd, a, b, nh, stream);
  if (mode == 2 && bits != nullptr) return launch_bf16_at<2>(hd, a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int aspire_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* bias, const void* g, const void* out, void* dq,
                                        void* dk, void* dv, void* stats, void* scratch, int b,
                                        int nh, int t, int hd, const long long* strides,
                                        float sm_scale, int mode, unsigned long long seed,
                                        unsigned c0, unsigned thresh, unsigned plane0,
                                        float keep_div, float keep_div32, const void* bits,
                                        void* stream) {
  if (bad_grid(b, nh, t) || (hd != kHd && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, g, out, dq, dk, dv, stats, scratch, t, strides,
                              sm_scale, seed, c0, thresh, plane0, keep_div, keep_div32, bits);
  if (mode == 0) return launch_f32_at<0>(hd, a, b, nh, stream);
  if (mode == 1) return launch_f32_at<1>(hd, a, b, nh, stream);
  if (mode == 2 && bits != nullptr) return launch_f32_at<2>(hd, a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}
