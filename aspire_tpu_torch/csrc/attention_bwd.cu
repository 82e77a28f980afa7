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
// bf16, three launches a backward:
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
// f32 keeps the two-kernel design of plain FMAs (a check path; training runs
// bf16): a rows kernel (delta, dq) and a keys kernel (dk, dv), each computing
// scores and dpd, seven products in all.
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
  bf16* scratch;           // bf16 only: ds^T, [b * heads][tp][tp]
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

__global__ void __launch_bounds__(kDeltaRows * 8) bwd_delta_bf16_kernel(BwdArgs a) {
  const int head = blockIdx.y, b = blockIdx.z, t = a.t;
  const int row = blockIdx.x * kDeltaRows + (threadIdx.x >> 3), c = (threadIdx.x & 7) * 8;
  float sum = 0.f;
  if (row < t) {
    const uint4 gv = *reinterpret_cast<const uint4*>(head_ptr<bf16>(a.g, a.gs, b, head) +
                                                     (long long)row * a.gs.t + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(head_ptr<bf16>(a.out, a.os, b, head) +
                                                     (long long)row * a.os.t + c);
    const bf16* gp = reinterpret_cast<const bf16*>(&gv);
    const bf16* op = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += __bfloat162float(gp[i]) * __bfloat162float(op[i]);
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
  bwd_delta_bf16_kernel<<<dim3((a.t + kDeltaRows - 1) / kDeltaRows, nh, b), kDeltaRows * 8, 0,
                          s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.t + 63) / 64, nh, b);
  bwd_keys_bf16_kernel<kDrop><<<grid, kThreads, kSmemKeysBf16, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_bf16_kernel<<<grid, kThreads, kSmemDqBf16, s>>>(a);
  return (int)cudaGetLastError();
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

BwdArgs make_args(const void* q, const void* k, const void* v, const void* bias, const void* g,
                  const void* out, void* dq, void* dk, void* dv, void* stats, void* scratch, int t,
                  const long long* strides, float sm_scale, unsigned long long seed, unsigned c0,
                  unsigned thresh, float keep_div, float keep_div32, const void* bits) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.g = g; a.out = out; a.bias = (const float*)bias;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = (float*)stats; a.scratch = (bf16*)scratch; a.t = t;
  Strides* dst[8] = {&a.qs, &a.ks, &a.vs, &a.gs, &a.os, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.sm_scale = sm_scale;
  a.inv_keep = 1.f / keep_div;
  a.inv_keep32 = 1.f / keep_div32;
  a.drop = Drop{seed, c0, thresh, keep_div, keep_div32, (const unsigned*)bits};
  return a;
}

bool bad_grid(int b, int nh, int t) { return b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535; }

}  // namespace

// strides: (batch, head, token) of q, k, v, g, out, dq, dk, dv; stats: the
// [3, b * nh, t] f32 array whose planes 0 and 1 the forward filled (plane 2
// receives delta); scratch: bf16 [b * nh, tp, tp] with tp = t rounded up to 64
// (ds^T, bf16 only); mode as in the forward.  bf16 launches three kernels
// (delta, keys, dq), f32 two (rows, keys).
extern "C" int aspire_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* g, const void* out,
                                         void* dq, void* dk, void* dv, void* stats, void* scratch,
                                         int b, int nh, int t, const long long* strides,
                                         float sm_scale, int mode, unsigned long long seed,
                                         unsigned c0, unsigned thresh, float keep_div,
                                         float keep_div32, const void* bits, void* stream) {
  if (bad_grid(b, nh, t) || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, g, out, dq, dk, dv, stats, scratch, t, strides,
                              sm_scale, seed, c0, thresh, keep_div, keep_div32, bits);
  if (mode == 0) return launch_bf16<0>(a, b, nh, stream);
  if (mode == 1) return launch_bf16<1>(a, b, nh, stream);
  if (mode == 2 && bits != nullptr) return launch_bf16<2>(a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int aspire_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* bias, const void* g, const void* out, void* dq,
                                        void* dk, void* dv, void* stats, int b, int nh, int t,
                                        const long long* strides, float sm_scale, int mode,
                                        unsigned long long seed, unsigned c0, unsigned thresh,
                                        float keep_div, float keep_div32, const void* bits,
                                        void* stream) {
  if (bad_grid(b, nh, t)) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, bias, g, out, dq, dk, dv, stats, nullptr, t, strides,
                              sm_scale, seed, c0, thresh, keep_div, keep_div32, bits);
  if (mode == 0) return launch_f32(bwd_rows_f32_kernel<0>, bwd_keys_f32_kernel<0>, a, b, nh, stream);
  if (mode == 1) return launch_f32(bwd_rows_f32_kernel<1>, bwd_keys_f32_kernel<1>, a, b, nh, stream);
  if (mode == 2 && bits != nullptr)
    return launch_f32(bwd_rows_f32_kernel<2>, bwd_keys_f32_kernel<2>, a, b, nh, stream);
  return (int)cudaErrorInvalidValue;
}
