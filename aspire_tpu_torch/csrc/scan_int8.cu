// First-stage corpus scan over one dense bucket, int8 rows (K7) or bf16 rows
// (K8), for queries that fill whole groups of 128 query columns: per document
// and query the largest
//   rs[row] * (x_row . q_col) + rb[row] + qadd[col]
// over the document's S sentence rows and the query's columns.  int8 rows:
// rs = 2 scale[row], rb = -|x|^2 with +inf norms of pads folded to -1e30 first
// (so that 0 * sims - inf never meets +inf); bf16 rows: rs = 2, rb = -|x|^2
// (+inf norms give -inf and lose the max).  qadd = -|q_j|^2 at valid query
// sentences, -1e30 at padded ones.  Only [n_docs, queries] leaves the kernel.
//
// Takes the place of the TPU kernels of aspire_tpu/ops/pallas_scan.py for such
// queries: _scan_int8_kernel (a batch of 8 or more queries of up to 16
// sentences, 4 of up to 32, ..., or a batch of full-text queries whose groups
// of 128 sentences join it as extra queries) and _scan_kernel (a bf16 query of
// 65 or more sentences: a full-text query of 300 is three groups of one
// launch).  Rows upcast int8 -> bf16 (exact) or read as bf16, the query
// rounded to bf16 by the caller and never quantised, bf16 x bf16 products with
// f32 accumulation.  Narrower queries (a single abstract's: one read of the
// rows bounds them) run csrc/scan.cu's kernel; ops/scan_kernel.py chooses by
// shape (`scan_wide`).
//
// What bounds it: the product on this card's bf16 tensor cores (2 * rows * D
// * columns operations: at 32 queries of 16 sentences on the 109,440-document
// bucket of 12 rows 1.03e12, at 8 int8 queries of 300 sentences -- five groups
// of 64 each, 2,560 columns -- on a bucket of 840 documents of 1,200 rows
// 3.96e12), or near it the one read of the rows (a
// bf16 query of 300 sentences: 1.55 GB read for 5.9e11 operations at that
// bucket).  The design is a GEMM whose epilogue is the maximum:
//
//   M = the bucket's rows, in spans of `span` rows whatever S is (common.cuh;
//       ops/scan_kernel.span_rows), walked in tiles of 128 rows; a span's
//       maxima are merged in shared memory, and a document that straddles two
//       spans is merged in device memory by an atomic max;
//   N = one group of 128 query columns, kept in shared memory for the block's
//       whole life (192 KB at D = 768), so the query is read once a block;
//   K = D, in stages of 64 bytes a row: 64 int8 or 32 bf16.
//
// A block is persistent: it owns one column group and walks every
// (gridDim / groups)-th span, so the blocks of one span in different groups
// run side by side and all but the first find its rows in L2: a query's groups
// read the bucket from device memory once.  One producer warp loads the query
// group once and then the [128 rows, 64 bytes] row tiles by TMA into a ring of
// mbarrier-guarded stages (three fit beside the query at D = 768).  Two
// consumer warpgroups take 64 rows each: a thread reads 16 contiguous bytes of
// each of its two rows from the stage (conflict-free), frees the stage at once,
// converts int8 bytes to bf16 in registers by integer and FP32-pipe
// instructions (`int8x4_to_bf16x2`, common.cuh) and issues `wgmma m64n128k16`
// with A from those registers and B from the swizzled query -- four a stage for
// int8, two for bf16; the next stage's conversion overlaps the products in
// flight (two register buffers, one product group outstanding).
//
// The k order: the 16 bytes a thread reads hold, for each k16 step of a stage,
// the four elements its A fragment owns (int8: word j is step j's logical
// columns 2t, 2t+1, 2t+8, 2t+9; bf16: words 2j and 2j + 1 are step j's 2t, 2t+1
// and 2t+8, 2t+9).  The sum over k does not change when both operands take the
// same permutation, so the rows stay as stored and the caller permutes the
// query's k once a call (`int8_k_order` in ops/scan_kernel.py, by stage
// width W = 64 or 32): logical position 16 j + l of a W-chunk holds physical
// column (W / 4) ((l % 8) / 2) + 4 j + (l % 2) + 2 (l / 8).
//
// Epilogue, once a tile, two ways chosen by the walk a document's maximum
// would take (S rows times the 16-column pairs of a query):
//   short (S * pairs < 64; documents of 12 or 24 rows): max_j(rs * acc + qadd)
//       + rb per row and 16-column pair of tiles, in registers and across the
//       quad, into a [128, 8] row-maxima tile in shared memory; then one thread
//       a (document, query) of the tile takes the maximum over its rows and
//       pairs into the span's maxima -- no atomics;
//   long (documents of hundreds of rows, or a query of 128 columns): a row's
//       maximum over its query's pairs in registers; where a warp's 16 rows lie
//       in one document they are merged across the warp by shuffles and one
//       shared-memory atomic a query, else each row's goes by an atomic.
// benchmarks/torch_scan_int8_ablation.py takes it apart on the card.  Tried
// on the short documents and slower (int8 rows): fetching rows straight into
// registers several stages ahead, clusters of four blocks sharing each row
// tile by TMA multicast, the rows' terms loaded a tile ahead, L2 prefetch of
// the next tile, a segmented warp scan or match/redux in place of per-row
// atomics, the two warpgroups on separate 64-row tiles with a ring and a
// producer warp each.
#include <math.h>

#include "common.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

constexpr int kTiles = 16;                  // 8-column tiles of a column group
constexpr int kCols = 8 * kTiles;           // a group's columns: 128, the wgmma's N
constexpr int kRows = 128;                  // rows a tile: two warpgroups of 64
constexpr int kRowBytes = 64;               // bytes of a row a stage
constexpr int kStageBytes = kRows * kRowBytes;   // one row tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kMaxStages = 12;              // where shared memory allows: 3 at D = 768
constexpr int kLongWalk = 64;               // S * pairs from which the epilogue is "long"
constexpr int kDocs = 64;                   // documents a span of short ones
constexpr float kNeg = -1e30f;
constexpr size_t kSmemLimit = 232448;       // a block's shared memory on this card

// byte offsets of a block's shared memory from a 1024-byte boundary: the
// query group [Dp / 64][cols][64] bf16 (128-byte swizzle), the ring of row
// tiles, a tile's row maxima [kRows][cols / 16] (the short epilogue's), the
// span's maxima [documents a span touches][queries], the barriers.  Without
// the row maxima, and with the two or three documents a span of long ones
// touches, a fourth stage fits beside the query at D = 768.
struct Layout {
  size_t ring, rowmax, docmax, bars, total;
};

__host__ __device__ inline int span_slots(int span, int S) {
  const int docs = (span + S - 2) / S + 1;
  return docs < kSpanDocs ? docs : kSpanDocs;
}

__host__ __device__ inline Layout layout(int cols, int dp, int queries, int stages, int slots,
                                         bool rowmax) {
  Layout l;
  l.ring = (size_t)cols * dp * 2;
  l.rowmax = l.ring + (size_t)stages * kStageBytes;
  l.docmax = l.rowmax + (rowmax ? (size_t)kRows * (cols / 16) * 4 : 0);
  l.bars = (l.docmax + (size_t)slots * queries * 4 + 7) / 8 * 8;
  l.total = l.bars + (size_t)(2 * stages + 1) * 8;
  return l;
}

// keeps the compiler from reusing registers an asynchronous product still reads
template <int kSteps>
__device__ __forceinline__ void hold_a(unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// T: signed char (int8 rows, scales) or bf16 (scales null).  map_rows: [n_docs
// * S, D] T, boxes [128][64 bytes]; map_q: [groups * 128, Dp] bf16 with k
// permuted, boxes [128][64] in the 128-byte swizzle; scales, norms: [n_docs,
// S]; qadd: [groups * 128]; out: [n_docs, out_cols] holding -inf.  A query
// holds `tpq` neighbouring 8-column tiles (tpq even, 16 % tpq == 0).  kLong:
// spans of `span` rows and the long epilogue; else (S * pairs a query <
// kLongWalk, span = kDocs * S) spans of kDocs whole documents and the short
// epilogue, the first design's code.
template <typename T, bool kLong>
__global__ void __launch_bounds__(kThreads, 1)
scan_wide_kernel(const __grid_constant__ CUtensorMap map_rows,
                 const __grid_constant__ CUtensorMap map_q, const float* __restrict__ scales,
                 const float* __restrict__ norms, const float* __restrict__ qadd,
                 float* __restrict__ out, int n_docs, int S, int D, int tpq, int groups,
                 int out_cols, int stages, int span) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kSteps = kInt8 ? 4 : 2;     // k16 steps a stage
  constexpr int kStageK = 16 * kSteps;      // k a stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const int dp = (D + 63) / 64 * 64, kchunks = (D + kStageK - 1) / kStageK;
  const int qg = kTiles / tpq, ppq = tpq / 2;   // queries a group, 16-column pairs a query
  const int slots = kLong ? span_slots(span, S) : kDocs;
  const Layout lay = layout(kCols, dp, qg, stages, slots, !kLong);
  bf16* qs = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + lay.ring;
  float* rowmax = reinterpret_cast<float*>(base + lay.rowmax);
  float* docmax = reinterpret_cast<float*>(base + lay.docmax);
  auto* full = reinterpret_cast<unsigned long long*>(base + lay.bars);
  unsigned long long* empty = full + stages;
  unsigned long long* qbar = empty + stages;
  const int group = blockIdx.x % groups;
  const int first = blockIdx.x / groups, step = gridDim.x / groups;
  const int total_rows = n_docs * S;
  const int n_units = kLong ? (total_rows + span - 1) / span : (n_docs + kDocs - 1) / kDocs;
  // a unit's first row and rows
  auto unit_rows = [&](int unit, int& row0, int& rows) {
    if constexpr (kLong) {
      const Span sp = span_of(unit, span, total_rows, S);
      row0 = sp.row0;
      rows = sp.rows;
    } else {
      row0 = unit * kDocs * S;
      rows = min(kDocs, n_docs - unit * kDocs) * S;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);               // the producer's arrival, plus the tile bytes
      mbar_init(empty + s, kConsumers / 32);   // one arrival from each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // g counts the stages this block has gone through: slot g % stages, phase
  // (g / stages) % 2
  if (threadIdx.x >= kConsumers) {          // the producer warp: one thread issues the loads
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, (unsigned)(kCols * dp * 2));
      for (int c = 0; c < dp / 64; ++c)
        tma_load(qs + (size_t)c * kCols * 64, &map_q, qbar, c * 64, group * kCols);
      int g = 0;
      for (int unit = first; unit < n_units; unit += step) {
        int row0, rows;
        unit_rows(unit, row0, rows);
        for (int r = 0; r < rows; r += kRows)
          for (int c = 0; c < kchunks; ++c, ++g) {
            const int s = g % stages;
            if (g >= stages) mbar_wait(empty + s, (g / stages - 1) & 1);
            mbar_expect_tx(full + s, kStageBytes);
            tma_load(ring + (size_t)s * kStageBytes, &map_rows, full + s, c * kStageK,
                     row0 + r);
          }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int my_row = wg * 64 + warp * 16 + (lane >> 2);   // and my_row + 8, of a tile
  float qa[2 * kTiles];                     // qadd at this thread's columns
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    qa[2 * j] = qadd[group * kCols + 8 * j + 2 * tq];
    qa[2 * j + 1] = qadd[group * kCols + 8 * j + 2 * tq + 1];
  }
  for (int i = threadIdx.x; i < slots * qg; i += kConsumers) docmax[i] = -INFINITY;
  consumers_sync();
  mbar_wait(qbar, 0);

  // the stages this block goes through, over all tiles of all its spans
  int total = 0;
  for (int unit = first; unit < n_units; unit += step) {
    int row0, rows;
    unit_rows(unit, row0, rows);
    total += (rows + kRows - 1) / kRows * kchunks;
  }

  float acc[4 * kTiles];
#pragma unroll
  for (int i = 0; i < 4 * kTiles; ++i) acc[i] = 0.f;
  unsigned a0[4][4], a1[4][4];
  uint4 lo, hi;                             // stage g's bytes of this thread's two rows
  int g = 0;
  // stage g's bytes into registers, and its slot back to the producer
  auto fetch = [&]() {
    const int s = g % stages;
    mbar_wait(full + s, (g / stages) & 1);
    const unsigned char* src = ring + (size_t)s * kStageBytes + my_row * kRowBytes + 16 * tq;
    lo = *reinterpret_cast<const uint4*>(src);
    hi = *reinterpret_cast<const uint4*>(src + 8 * kRowBytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  // bf16 rows: words 2j and 2j + 1 of a row's 16 bytes are step j's A
  // fragment registers
  auto words = [&](unsigned (&a)[4][4]) {
    a[0][0] = lo.x; a[0][2] = lo.y; a[1][0] = lo.z; a[1][2] = lo.w;
    a[0][1] = hi.x; a[0][3] = hi.y; a[1][1] = hi.z; a[1][3] = hi.w;
  };
  // stage g (k chunk c of a tile) with its A fragments in `cur` (int8: its
  // bytes in lo, hi, converted here): the products issued; the products of
  // the stage before (A in `prev`) are done when it returns, and the next
  // stage's bytes are fetched -- int8 into lo, hi before that wait, bf16 into
  // `prev` after it, so that no register a product in flight reads is written
  auto stage = [&](int c, unsigned (&cur)[4][4], unsigned (&prev)[4][4]) {
    if constexpr (kInt8) {
      const unsigned lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        int8x4_to_bf16x2(lw[j], cur[j][0], cur[j][2]);
        int8x4_to_bf16x2(hw[j], cur[j][1], cur[j][3]);
      }
    }
    wgmma_fence();
    // the stage's k in the query's [Dp / 64][cols][64] tiles
    const bf16* qc = qs + (size_t)(c * kStageK / 64) * kCols * 64 + c * kStageK % 64;
#pragma unroll
    for (int j = 0; j < kSteps; ++j)        // a k16 step is 32 bytes along the swizzled rows
      wgmma_m64n128k16<0>(acc, cur[j], sw128_desc(qc + j * 16), c > 0 || j > 0);
    wgmma_commit();
    if constexpr (kInt8) {
      if (++g < total) fetch();
      wgmma_wait<1>();
      hold_a<kSteps>(prev);
    } else {
      wgmma_wait<1>();
      hold_a<kSteps>(prev);
      if (++g < total) {
        fetch();
        words(prev);
      }
    }
  };
  if (total > 0) {
    fetch();
    if constexpr (!kInt8) words(a0);
  }
  bool flip = false;                        // bf16: a tile of odd stages leaves the next in a1

  for (int unit = first; unit < n_units; unit += step) {
    Span sp;                                // kLong
    int rows, doc0 = 0;                     // else: kDocs documents from doc0
    long long row0;
    if constexpr (kLong) {
      sp = span_of(unit, span, total_rows, S);
      rows = sp.rows;
      row0 = sp.row0;
    } else {
      doc0 = unit * kDocs;
      rows = min(kDocs, n_docs - doc0) * S;
      row0 = (long long)doc0 * S;
    }
    for (int r0 = 0; r0 < rows; r0 += kRows) {
      // the rows' epilogue terms, loaded before the products; rows past the
      // span's last are read as its last and left out below
      int rl[2];
      float rs[2], rb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rl[h] = r0 + my_row + 8 * h;
        const long long row = row0 + min(rl[h], rows - 1);
        const float nrm = norms[row];
        if constexpr (kInt8) {
          rs[h] = 2.f * scales[row];
          rb[h] = isfinite(nrm) ? -nrm : kNeg;
        } else {
          rs[h] = 2.f;
          rb[h] = -nrm;
        }
      }
      // a tile's stages, the A fragments alternating between a0 and a1 (bf16:
      // a tile of an odd number of stages leaves the next tile's first in a1)
      auto stages_of_tile = [&](unsigned (&x)[4][4], unsigned (&y)[4][4]) {
        int c = 0;
        for (; c + 1 < kchunks; c += 2) {
          stage(c, x, y);
          stage(c + 1, y, x);
        }
        if (c < kchunks) stage(c, x, y);
      };
      if (kInt8 || !flip)
        stages_of_tile(a0, a1);
      else
        stages_of_tile(a1, a0);
      flip ^= kchunks & 1;
      wgmma_wait<0>();
      wgmma_hold(acc);

      // a thread holds rows my_row (h = 0) and my_row + 8 (h = 1) at columns
      // 8 j + 2 t, + 1 of each 8-column tile j (acc[4 j + 2 h], + 1); the
      // maximum over the 16 columns of a pair of tiles p (a query is one or
      // more pairs):
      auto pair_max = [&](int h, int p) {
        return fmaxf(fmaxf(fmaf(rs[h], acc[8 * p + 2 * h], qa[4 * p]),
                           fmaf(rs[h], acc[8 * p + 2 * h + 1], qa[4 * p + 1])),
                     fmaxf(fmaf(rs[h], acc[8 * p + 4 + 2 * h], qa[4 * p + 2]),
                           fmaf(rs[h], acc[8 * p + 5 + 2 * h], qa[4 * p + 3])));
      };
      if constexpr (kLong) {
        // a row's maximum over its query's pairs (+ rb, the same for the
        // quad); the warp's 16 rows merged by shuffles where they lie in one
        // document, else each row's by an atomic
        const int wrow = r0 + wg * 64 + warp * 16;
        const int w0 = sp.off + wrow;
        const bool one_doc = wrow + 15 < rows && w0 / S == (w0 + 15) / S;
        float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int p = 0; p < kTiles / 2; ++p) {   // pairs in order: query p / ppq
          m[0] = fmaxf(m[0], pair_max(0, p));
          m[1] = fmaxf(m[1], pair_max(1, p));
          if ((p + 1) % ppq != 0) continue;      // the same for every thread
          const int q = p / ppq;
          m[0] += rb[0];
          m[1] += rb[1];
          if (one_doc) {
            float w = fmaxf(m[0], m[1]);
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
            if (lane == 0) atomic_max_float(&docmax[w0 / S * qg + q], w);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
              m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
              if (tq == 0 && rl[h] < rows)
                atomic_max_float(&docmax[(sp.off + rl[h]) / S * qg + q], m[h]);
            }
          }
          m[0] = m[1] = -INFINITY;
        }
        continue;
      }
      // short: each row's pair maxima to rowmax; then one thread a (document,
      // query) of the tile takes the maximum over its rows and pairs
      consumers_sync();                     // the tile before's rowmax has been read
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int p = 0; p < kTiles / 2; ++p) {
          float v = pair_max(h, p);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (tq == 0) rowmax[(my_row + 8 * h) * (kTiles / 2) + p] = v + rb[h];
        }
      }
      consumers_sync();
      // the tile's rows are [a, e), counted from the start of the span's
      // first document
      const int a = r0, e = min(r0 + kRows, rows), d0 = a / S;
      for (int i = threadIdx.x; i < ((e - 1) / S - d0 + 1) * qg; i += kConsumers) {
        const int d = d0 + i / qg, q = i % qg;
        const int rz = min((d + 1) * S, e) - a;
        float m = docmax[d * qg + q];
        for (int r = max(d * S, a) - a; r < rz; ++r)
          for (int p = q * ppq; p < (q + 1) * ppq; ++p)
            m = fmaxf(m, rowmax[r * (kTiles / 2) + p]);
        docmax[d * qg + q] = m;
      }
    }
    consumers_sync();
    if constexpr (kLong) {
      flush_span(sp, S, docmax, qg, out, out_cols, group * qg, threadIdx.x, kConsumers);
    } else {
      for (int i = threadIdx.x; i < rows / S * qg; i += kConsumers) {
        out[(size_t)(doc0 + i / qg) * out_cols + group * qg + i % qg] = docmax[i];
        docmax[i] = -INFINITY;
      }
    }
    consumers_sync();
  }
}

template <typename T>
int launch(const void* sents, const float* scales, const float* norms, const void* q,
           const float* qadd, float* out, int n_docs, int S, int D, int tpq, int groups,
           int out_cols, int span, int blocks, cudaStream_t stream) {
  const int dp = (D + 63) / 64 * 64, qg = kTiles / tpq;
  const bool long_walk = S * (tpq / 2) >= kLongWalk || span != kDocs * S;
  const int slots = long_walk ? span_slots(span, S) : kDocs;
  int stages = kMaxStages;
  while (stages > 2 && 1024 + layout(kCols, dp, qg, stages, slots, !long_walk).total > kSmemLimit)
    --stages;
  const size_t smem = 1024 + layout(kCols, dp, qg, stages, slots, !long_walk).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map_rows, map_q;
  if (!make_map(&map_rows,
                sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                sizeof(T), sents, (long long)n_docs * S, D, kRows, kRowBytes / sizeof(T),
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, (long long)groups * kCols, dp,
                kCols, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = long_walk ? scan_wide_kernel<T, true> : scan_wide_kernel<T, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<groups * blocks, kThreads, smem, stream>>>(map_rows, map_q, scales, norms, qadd, out,
                                                      n_docs, S, D, tpq, groups, out_cols,
                                                      stages, span);
  return (int)cudaGetLastError();
}

bool bad_args(int n_docs, int S, int D, int tq, int groups, int out_cols, int span,
              int blocks) {
  // a span touches at most (span + S - 2) / S + 1 documents
  return n_docs < 1 || S < 1 || D < 32 || D % 32 != 0 || D > 768 || tq < 2 || tq % 2 != 0 ||
         kTiles % tq != 0 || groups < 1 || out_cols < groups * (kTiles / tq) || span < 1 ||
         ((long long)span + S - 2) / S + 1 > kSpanDocs || blocks < 1 ||
         (long long)groups * blocks > 0x7fffffffll || (long long)n_docs * S > 0x7fffffffll ||
         (long long)groups * kCols > 0x7fffffffll;
}

}  // namespace

// sents [n_docs, S, D] int8 or bf16, D <= 768; scales (int8), norms [n_docs,
// S] f32; q [groups * 128, Dp] bf16, Dp = D rounded up to 64, k permuted by
// stage (int8_k_order: 64 wide for int8 rows, 32 for bf16); qadd [groups *
// 128] f32; out [n_docs, out_cols] f32 filled with -inf.  tq: 8-column tiles a
// query; groups: column groups of 128; out_cols >= groups * 16 / tq; span:
// rows a span, touching at most kSpanDocs documents; blocks: a group's
// persistent blocks.
extern "C" int aspire_scan_int8_wide(const void* sents, const void* scales, const void* norms,
                                     const void* q, const void* qadd, void* out, int n_docs,
                                     int S, int D, int tq, int groups, int out_cols, int span,
                                     int blocks, void* stream) {
  if (bad_args(n_docs, S, D, tq, groups, out_cols, span, blocks))
    return (int)cudaErrorInvalidValue;
  return launch<signed char>(sents, (const float*)scales, (const float*)norms, q,
                             (const float*)qadd, (float*)out, n_docs, S, D, tq, groups,
                             out_cols, span, blocks, (cudaStream_t)stream);
}

extern "C" int aspire_scan_bf16_wide(const void* sents, const void* norms, const void* q,
                                     const void* qadd, void* out, int n_docs, int S, int D,
                                     int tq, int groups, int out_cols, int span, int blocks,
                                     void* stream) {
  if (bad_args(n_docs, S, D, tq, groups, out_cols, span, blocks))
    return (int)cudaErrorInvalidValue;
  return launch<bf16>(sents, nullptr, (const float*)norms, q, (const float*)qadd, (float*)out,
                      n_docs, S, D, tq, groups, out_cols, span, blocks, (cudaStream_t)stream);
}
