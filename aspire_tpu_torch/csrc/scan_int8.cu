// First-stage corpus scan over one int8 dense bucket for a batch of queries
// that fills whole groups of 128 query columns: per document and query the
// largest
//   2 scale[row] * (x_row . q_col) + rb[row] + qadd[col]
// over the document's S sentence rows and the query's columns, with
// rb = -|x|^2 (+inf norms of pads folded to -1e30 first, so that 0 * sims -
// inf never meets +inf) and qadd = -|q_j|^2 at valid query sentences, -1e30
// at padded ones.  Only [n_docs, queries] leaves the kernel.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_scan.py
// (_scan_int8_kernel) for such batches: rows upcast int8 -> bf16 (exact), the
// query rounded to bf16 by the caller and never quantised, bf16 x bf16
// products with f32 accumulation.  Narrower batches (a single query, bound by
// the one read of the rows) run csrc/scan.cu's kernel; ops/scan_kernel.py
// chooses by shape (`int8_wide`).
//
// What bounds it: at 32 queries of 16 sentences the product (2 * rows * D *
// 512 operations, 1.03e12 at the 109,440-document bucket of 12 rows) on this
// card's bf16 tensor cores.  The design is a GEMM whose epilogue is the
// maximum:
//
//   M = the bucket's rows, in units of 64 whole documents (a unit's maxima are
//       merged in shared memory; documents of 12 or 24 rows straddle tiles),
//       walked in tiles of 128 rows;
//   N = one group of 128 query columns, kept in shared memory for the block's
//       whole life (192 KB at D = 768), so the query is read once a block;
//   K = D, in stages of 64.
//
// A block is persistent: it owns one column group and walks every
// (gridDim / groups)-th unit, so the blocks of one unit in different groups
// run side by side and all but the first find its rows in L2.  One producer
// warp loads the query group once and then the [128, 64] int8 row tiles by
// TMA into a ring of mbarrier-guarded stages (three fit beside the query at
// D = 768).  Two consumer warpgroups take 64 rows each: a thread reads 16
// contiguous bytes of each of its two rows from the stage (conflict-free),
// frees the stage at once, converts the bytes to bf16 in registers by integer
// and FP32-pipe instructions (`int8x4_to_bf16x2`, common.cuh) and issues four
// `wgmma m64n128k16` with A from those registers and B from the swizzled
// query; the next stage's conversion overlaps the products in flight (two
// register buffers, one product group outstanding).
//
// The k order: the 16 bytes a thread reads hold, for each of the four k16
// steps of a stage, the four elements its A fragment owns (word j: logical
// columns 2t, 2t+1 and 2t+8, 2t+9 of step j).  The sum over k does not change
// when both operands take the same permutation, so the rows stay as stored and
// the caller permutes the query's k once a call (`int8_k_order` in
// ops/scan_kernel.py): logical position 16 j + l of a 64-chunk holds physical
// column 16 ((l % 8) / 2) + 4 j + (l % 2) + 2 (l / 8).
//
// Epilogue, once a tile: max_j(rs * acc + qadd) + rb per row and 16-column
// pair of tiles, in registers and across the quad, into a [128, 8] row-maxima
// tile in shared memory; then one thread a (document, query) of the tile takes
// the maximum over its rows and pairs into the unit's maxima -- no atomics
// ([docs, queries] written once a unit).  benchmarks/torch_scan_int8_ablation.py
// takes it apart on the card: the rows' path alone (TMA, three stages, no
// products) is under half of its time, and the conversions, the products and
// the epilogue add to it rather than hide behind it.  Tried and slower:
// fetching rows straight into registers several stages ahead, clusters of
// four blocks sharing each row tile by TMA multicast, the rows' terms loaded a
// tile ahead, L2 prefetch of the next tile, a segmented warp scan or
// match/redux in place of per-row atomics (which this epilogue replaced), the
// two warpgroups on separate 64-row tiles with a ring and a producer warp each
// (one's epilogue under the other's products).
#include <math.h>

#include "common.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

constexpr int kTiles = 16;                  // 8-column tiles of a column group
constexpr int kCols = 8 * kTiles;           // a group's columns: 128, the wgmma's N
constexpr int kDocs = 64;                   // documents a unit
constexpr int kRows = 128;                  // rows a tile: two warpgroups of 64
constexpr int kK = 64;                      // k a stage
constexpr int kStageBytes = kRows * kK;     // one int8 row tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kMaxStages = 12;              // where shared memory allows: 3 at D = 768
constexpr float kNeg = -1e30f;
constexpr size_t kSmemLimit = 232448;       // a block's shared memory on this card

// byte offsets of a block's shared memory from a 1024-byte boundary: the
// query group [D / 64][cols][64] bf16 (128-byte swizzle), the ring of row
// tiles, a tile's row maxima [kRows][cols / 16], the unit's maxima
// [kDocs][queries], the barriers
struct Layout {
  size_t ring, rowmax, docmax, bars, total;
};

__host__ __device__ inline Layout layout(int cols, int dp, int queries, int stages) {
  Layout l;
  l.ring = (size_t)cols * dp * 2;
  l.rowmax = l.ring + (size_t)stages * kStageBytes;
  l.docmax = l.rowmax + (size_t)kRows * (cols / 16) * 4;
  l.bars = (l.docmax + (size_t)kDocs * queries * 4 + 7) / 8 * 8;
  l.total = l.bars + (size_t)(2 * stages + 1) * 8;
  return l;
}

// keeps the compiler from reusing registers an asynchronous product still reads
__device__ __forceinline__ void hold_a(unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// map_rows: [n_docs * S, D] int8, boxes [128][64]; map_q: [groups * 128, Dp]
// bf16 with k permuted, boxes [128][64] in the 128-byte swizzle; scales,
// norms: [n_docs, S]; qadd: [groups * 128]; out: [n_docs, out_cols].  A query
// holds `tpq` neighbouring 8-column tiles (tpq even, 16 % tpq == 0).
__global__ void __launch_bounds__(kThreads, 1)
scan_int8_kernel(const __grid_constant__ CUtensorMap map_rows,
                 const __grid_constant__ CUtensorMap map_q, const float* __restrict__ scales,
                 const float* __restrict__ norms, const float* __restrict__ qadd,
                 float* __restrict__ out, int n_docs, int S, int D, int tpq, int groups,
                 int out_cols, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const int dp = (D + kK - 1) / kK * kK, kchunks = dp / kK;
  const int qg = kTiles / tpq;              // queries a group
  const Layout lay = layout(kCols, dp, qg, stages);
  bf16* qs = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + lay.ring;
  float* rowmax = reinterpret_cast<float*>(base + lay.rowmax);
  float* docmax = reinterpret_cast<float*>(base + lay.docmax);
  auto* full = reinterpret_cast<unsigned long long*>(base + lay.bars);
  unsigned long long* empty = full + stages;
  unsigned long long* qbar = empty + stages;
  const int group = blockIdx.x % groups;
  const int first = blockIdx.x / groups, step = gridDim.x / groups;
  const int n_units = (n_docs + kDocs - 1) / kDocs;
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
      for (int c = 0; c < kchunks; ++c)
        tma_load(qs + (size_t)c * kCols * kK, &map_q, qbar, c * kK, group * kCols);
      int g = 0;
      for (int unit = first; unit < n_units; unit += step) {
        const int row0 = unit * kDocs * S;
        const int rows_here = min(kDocs, n_docs - unit * kDocs) * S;
        for (int r = 0; r < rows_here; r += kRows)
          for (int c = 0; c < kchunks; ++c, ++g) {
            const int s = g % stages;
            if (g >= stages) mbar_wait(empty + s, (g / stages - 1) & 1);
            mbar_expect_tx(full + s, kStageBytes);
            tma_load(ring + (size_t)s * kStageBytes, &map_rows, full + s, c * kK, row0 + r);
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
  for (int i = threadIdx.x; i < kDocs * qg; i += kConsumers) docmax[i] = -INFINITY;
  consumers_sync();
  mbar_wait(qbar, 0);

  // the stages this block goes through, over all tiles of all its units
  int total = 0;
  for (int unit = first; unit < n_units; unit += step)
    total += (min(kDocs, n_docs - unit * kDocs) * S + kRows - 1) / kRows * kchunks;

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
    const unsigned char* src = ring + (size_t)s * kStageBytes + my_row * kK + 16 * tq;
    lo = *reinterpret_cast<const uint4*>(src);
    hi = *reinterpret_cast<const uint4*>(src + 8 * kK);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  // stage g (k chunk c of a tile): its A fragments into `cur`, four products
  // issued, the next stage's bytes fetched; the products of the stage before
  // (A in `prev`) are done when it returns
  auto stage = [&](int c, unsigned (&cur)[4][4], unsigned (&prev)[4][4]) {
    const unsigned lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int8x4_to_bf16x2(lw[j], cur[j][0], cur[j][2]);
      int8x4_to_bf16x2(hw[j], cur[j][1], cur[j][3]);
    }
    wgmma_fence();
    const bf16* qc = qs + (size_t)c * kCols * kK;
#pragma unroll
    for (int j = 0; j < 4; ++j)             // a k16 step is 32 bytes along the swizzled rows
      wgmma_m64n128k16<0>(acc, cur[j], sw128_desc(qc + j * 16), c > 0 || j > 0);
    wgmma_commit();
    if (++g < total) fetch();
    wgmma_wait<1>();
    hold_a(prev);
  };
  if (total > 0) fetch();

  for (int unit = first; unit < n_units; unit += step) {
    const int doc0 = unit * kDocs;
    const int docs_here = min(kDocs, n_docs - doc0), rows_here = docs_here * S;
    const long long row0 = (long long)doc0 * S;
    for (int r0 = 0; r0 < rows_here; r0 += kRows) {
      // the rows' epilogue terms, loaded before the products; rows past the
      // unit's last are read as its last and left out below
      int rl[2];
      float rs[2], rb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rl[h] = r0 + my_row + 8 * h;
        const long long row = row0 + min(rl[h], rows_here - 1);
        const float nrm = norms[row];
        rs[h] = 2.f * scales[row];
        rb[h] = isfinite(nrm) ? -nrm : kNeg;
      }
      int c = 0;
      for (; c + 1 < kchunks; c += 2) {
        stage(c, a0, a1);
        stage(c + 1, a1, a0);
      }
      if (c < kchunks) stage(c, a0, a1);
      wgmma_wait<0>();
      wgmma_hold(acc);

      // a thread holds rows my_row (h = 0) and my_row + 8 (h = 1) at columns
      // 8 j + 2 t, + 1 of each 8-column tile j (acc[4 j + 2 h], + 1).  Each
      // row's maximum over the 16 columns of each pair of tiles (a query is
      // one or more pairs), in registers and across the quad, goes to rowmax;
      // then one thread a (document, query) of the tile takes the maximum over
      // its rows and pairs into the unit's maxima.
      consumers_sync();                     // the tile before's rowmax has been read
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int p = 0; p < kTiles / 2; ++p) {
          float v = fmaxf(fmaxf(fmaf(rs[h], acc[8 * p + 2 * h], qa[4 * p]),
                                fmaf(rs[h], acc[8 * p + 2 * h + 1], qa[4 * p + 1])),
                          fmaxf(fmaf(rs[h], acc[8 * p + 4 + 2 * h], qa[4 * p + 2]),
                                fmaf(rs[h], acc[8 * p + 5 + 2 * h], qa[4 * p + 3])));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (tq == 0) rowmax[(my_row + 8 * h) * (kTiles / 2) + p] = v + rb[h];
        }
      }
      consumers_sync();
      const int last = min(r0 + kRows, rows_here);   // the unit's rows in this tile end here
      const int d0 = r0 / S, ppq = tpq / 2;        // pairs a query
      for (int i = threadIdx.x; i < ((last - 1) / S - d0 + 1) * qg; i += kConsumers) {
        const int d = d0 + i / qg, q = i % qg;
        const int rz = min((d + 1) * S, last) - r0;
        float m = docmax[d * qg + q];
        for (int r = max(d * S, r0) - r0; r < rz; ++r)
          for (int p = q * ppq; p < (q + 1) * ppq; ++p)
            m = fmaxf(m, rowmax[r * (kTiles / 2) + p]);
        docmax[d * qg + q] = m;
      }
    }
    consumers_sync();
    for (int i = threadIdx.x; i < docs_here * qg; i += kConsumers) {
      out[(size_t)(doc0 + i / qg) * out_cols + group * qg + i % qg] = docmax[i];
      docmax[i] = -INFINITY;
    }
    consumers_sync();
  }
}

int launch(const void* sents, const float* scales, const float* norms, const void* q,
              const float* qadd, float* out, int n_docs, int S, int D, int tpq, int groups,
              int out_cols, cudaStream_t stream) {
  const int dp = (D + kK - 1) / kK * kK, qg = kTiles / tpq;
  int stages = kMaxStages;
  while (stages > 2 && 1024 + layout(kCols, dp, qg, stages).total > kSmemLimit) --stages;
  const size_t smem = 1024 + layout(kCols, dp, qg, stages).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map_rows, map_q;
  if (!make_map(&map_rows, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, sents, (long long)n_docs * S, D,
                kRows, kK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, (long long)groups * kCols, dp,
                kCols, kK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = scan_int8_kernel;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_units = (n_docs + kDocs - 1) / kDocs;
  const int fit = sm_count() / groups;     // blocks of a group that run at once
  const int per_group = fit < 1 ? 1 : (fit < n_units ? fit : n_units);
  kernel<<<groups * per_group, kThreads, smem, stream>>>(
      map_rows, map_q, scales, norms, qadd, out, n_docs, S, D, tpq, groups, out_cols, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// sents [n_docs, S, D] int8, D <= 768; scales, norms [n_docs, S] f32; q
// [groups * 128, Dp] bf16, Dp = D rounded up to 64, k permuted
// (int8_k_order); qadd [groups * 128] f32; out [n_docs, out_cols] f32.  tq:
// 8-column tiles a query; groups: column groups of 128; out_cols >= groups *
// 16 / tq.
extern "C" int aspire_scan_int8_wide(const void* sents, const void* scales, const void* norms,
                                     const void* q, const void* qadd, void* out, int n_docs,
                                     int S, int D, int tq, int groups, int out_cols,
                                     void* stream) {
  if (n_docs < 1 || S < 1 || D < 32 || D % 32 != 0 || D > 768 || tq < 2 || tq % 2 != 0 ||
      kTiles % tq != 0 || groups < 1 || out_cols < groups * (kTiles / tq) ||
      (long long)n_docs * S > 0x7fffffffll || (long long)groups * kCols > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  return launch(sents, (const float*)scales, (const float*)norms, q, (const float*)qadd,
                (float*)out, n_docs, S, D, tq, groups, out_cols, (cudaStream_t)stream);
}
