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
// The columns are packed (`pack_kernel`, from the queries' lengths on the
// device): a query takes ceil(q_len / 4) 4-column units (one at q_len = 0;
// ceil(q_len / 8) 8-column tiles for the long epilogue), filled by its real
// sentences alone, and the queries fill the groups in order, at most 16 a
// group, a query that does not fit left opening the next group.  A plan in
// device memory holds the live groups G and, a group, the query of each unit
// (-1 past them).  A batch of full queries of 16, 32, 64 or 128 sentences
// takes the columns and groups of a query a power of two of columns.
//
// A block is persistent and the grid is one block an SM, whatever G is: block
// b owns column group b % G and walks every (gridDim / G)-th span from b / G
// (the last gridDim % G blocks idle), so the blocks of one span in different
// groups run side by side and all but the first find its rows in L2: a query's
// groups read the bucket from device memory once.  One producer warp loads the query
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
// Epilogue, once a tile, the maximum over each query's own tiles (the plan's),
// two ways chosen by the walk a document's maximum would take with a query a
// power of two of columns (S rows times its 16-column pairs):
//   short (S * pairs < 64; documents of 12 or 24 rows): max(rs * acc + qadd)
//       per row and 4-column unit by a reduce-scatter across the quad's pairs
//       (the units laid out so that a lane ends with 8 in order), then per row
//       and query, in registers by runs of a query's units and across the
//       quad by a segmented scan, + rb into a [128, 16] tile of row maxima a
//       query slot in shared memory; then one thread a (document, slot) of the
//       tile takes the maximum over its rows and stores it, or, for the
//       document that runs on into the next tile, leaves it there to merge --
//       no atomics;
//   long (documents of hundreds of rows, or a query of 128 columns): a row's
//       maximum over its query's tiles in registers; where a warp's 16 rows lie
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
constexpr int kUnits = kCols / 4;           // 4-column units of a group
constexpr int kSlots = 16;                  // queries a group at most
constexpr int kPlanHead = 3;                // the plan: G, 128 G, the real sentences

// byte offsets of a block's shared memory from a 1024-byte boundary: the
// query group [Dp / 64][cols][64] bf16 (128-byte swizzle), the ring of row
// tiles, a tile's row maxima [kRows][kSlots] (short), the maxima (long: the
// span's [documents a span touches][queries a group]; short: two halves of
// [kSlots], a tile's last document's carried to the next tile, and the one
// before's), each query slot's out column (long), the barriers.  Without the row
// maxima, and with the two or three documents a span of long ones touches, a
// fourth stage fits beside the query at D = 768.
struct Layout {
  size_t ring, rowmax, docmax, qcols, bars, total;
};

__host__ __device__ inline int span_slots(int span, int S) {
  const int docs = (span + S - 2) / S + 1;
  return docs < kSpanDocs ? docs : kSpanDocs;
}

__host__ __device__ inline Layout layout(int dp, int qslots, int stages, int slots,
                                         bool rowmax) {
  Layout l;
  l.ring = (size_t)kCols * dp * 2;
  l.rowmax = l.ring + (size_t)stages * kStageBytes;
  l.docmax = l.rowmax + (rowmax ? (size_t)kRows * kSlots * 4 : 0);
  l.qcols = l.docmax + (rowmax ? (size_t)2 * kSlots * 4 : (size_t)slots * qslots * 4);
  l.bars = (l.qcols + (size_t)kSlots * 4 + 7) / 8 * 8;
  l.total = l.bars + (size_t)(2 * stages + 1) * 8;
  return l;
}

// position p of the query operand's row holds the stored column k_phys(p) (the
// k order of ops/scan_kernel.int8_k_order, stages of `width` k)
__device__ __forceinline__ int k_phys(int p, int width) {
  const int r = p % width, j = r / 16, l = r % 16;
  return p - r + (width / 4) * ((l % 8) / 2) + 4 * j + (l % 2) + 2 * (l / 8);
}

// Column e of a group's 4-column unit u lies at column 4 u + e where units go
// by 8 (the long epilogue), and at 8 (u % 16) + 4 (u / 16) + e where they go by
// 4 (the short): the half u / 16 of 8-column tile u % 16, so that after one
// reduce-scatter of a row's values over the quad lane t holds units 8 t ..
// 8 t + 7 in order.
// The wide kernel's operands from a batch q [B, qmax, D] f32, qadd [B, qmax]
// (read at real sentences) and lens [B] (int32, or int64 where lens64), all on
// the device: grid (groups, kCols / columns a block).  A query takes
// max(1, ceil(len / unit)) units of `unit` columns (unit 4 or 8), and the
// queries fill the groups' kCols columns in order, at most kSlots a group, one
// that does not fit opening the next group.  Every block lays out the same plan
// (one thread, in order: B is a batch) and writes its columns of a live group
// -- packed [groups * kCols, dp] bf16 in the k order, the real sentences
// rounded to nearest even and zeros elsewhere, qa [groups * kCols] (-1e30 at
// pad columns), both at their units' places -- and block (g, 0) its group's
// unit owners of the plan.
__global__ void __launch_bounds__(256)
pack_kernel(const float* __restrict__ q, const float* __restrict__ qadd,
            const void* __restrict__ lens, int lens64, bf16* __restrict__ packed,
            float* __restrict__ qa, int* __restrict__ plan, int B, int qmax, int D, int dp,
            int width, int unit) {
  // a 4-column unit's query, its first unit and the query's length
  __shared__ int own[kUnits], first[kUnits], len[kUnits];
  __shared__ int chunk[256];                // lengths, a block's worth at a time
  __shared__ int live;
  const int g = blockIdx.x, per = unit / 4;
  int grp = 0, used = 0, nq = 0, sentences = 0;   // thread 0's walk
  if (threadIdx.x < kUnits) own[threadIdx.x] = -1;
  for (int b0 = 0; b0 < B; b0 += 256) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      const long long raw = lens64 ? static_cast<const long long*>(lens)[b]
                                   : static_cast<const int*>(lens)[b];
      chunk[threadIdx.x] = (int)min(max(raw, 0ll), (long long)qmax);
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < 256 && b0 + i < B; ++i) {
        const int n = chunk[i], t = (n > 0 ? (n + unit - 1) / unit : 1) * per;
        if (used + t > kUnits || nq == kSlots) {
          ++grp;
          used = nq = 0;
        }
        if (grp == g)
          for (int k = 0; k < t; ++k) {
            own[used + k] = b0 + i;
            first[used + k] = used;
            len[used + k] = n;
          }
        used += t;
        ++nq;
        sentences += n;
      }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    live = grp + 1;
    if (blockIdx.y == 0 && g < live)
      for (int u = 0; u < kUnits; ++u) plan[kPlanHead + g * kUnits + u] = own[u];
    if (blockIdx.y == 0 && g == 0) {
      plan[0] = live;
      plan[1] = live * kCols;
      plan[2] = sentences;
    }
  }
  __syncthreads();
  if (g >= live) return;                    // a group the batch leaves empty is never read
  // column c of the group holds sentence s of query own[u], or a pad
  auto source = [&](int c, int& b, int& s) {
    const int u = unit == 8 ? c / 4 : kTiles * ((c % 8) / 4) + c / 8;
    b = own[u];
    s = 4 * (u - first[u]) + c % 4;
    if (s >= len[u]) b = -1;
  };
  const int rows = kCols / gridDim.y, c0 = blockIdx.y * rows, chunks = dp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int c = c0 + i / chunks, p0 = (i % chunks) * 8;
    int b, s;
    source(c, b, s);
    const float* src = b >= 0 ? q + ((size_t)b * qmax + s) * D : nullptr;
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k0 = k_phys(p0 + 2 * e, width), k1 = k_phys(p0 + 2 * e + 1, width);
      w[e] = pack_bf16(src != nullptr && k0 < D ? src[k0] : 0.f,
                       src != nullptr && k1 < D ? src[k1] : 0.f);
    }
    *reinterpret_cast<uint4*>(packed + (size_t)(g * kCols + c) * dp + p0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int c = c0 + threadIdx.x; c < c0 + rows; c += blockDim.x) {
    int b, s;
    source(c, b, s);
    qa[g * kCols + c] = b >= 0 ? qadd[(size_t)b * qmax + s] : kNeg;
  }
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
// permuted (`pack_kernel`'s), boxes [128][64] in the 128-byte swizzle; scales,
// norms: [n_docs, S]; qadd: [groups * 128]; plan: G and each live group's
// units' queries (`pack_kernel`); out: [n_docs, out_cols] holding -inf, a
// query's column its index.  qslots: the query slots of the long epilogue's
// maxima (at least the queries a group holds).  kLong: spans of `span` rows and
// the long epilogue; else (span = kDocs * S) spans of kDocs whole documents and
// the short epilogue.
template <typename T, bool kLong>
__global__ void __launch_bounds__(kThreads, 1)
scan_wide_kernel(const __grid_constant__ CUtensorMap map_rows,
                 const __grid_constant__ CUtensorMap map_q, const float* __restrict__ scales,
                 const float* __restrict__ norms, const float* __restrict__ qadd,
                 const int* __restrict__ plan, float* __restrict__ out, int n_docs, int S,
                 int D, int qslots, int out_cols, int stages, int span) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kSteps = kInt8 ? 4 : 2;     // k16 steps a stage
  constexpr int kStageK = 16 * kSteps;      // k a stage
  const int groups = plan[0];               // the live column groups
  const int group = blockIdx.x % groups;
  const int first = blockIdx.x / groups, step = gridDim.x / groups;
  const int total_rows = n_docs * S;
  const int n_units = kLong ? (total_rows + span - 1) / span : (n_docs + kDocs - 1) / kDocs;
  if (first >= step || first >= n_units) return;   // a block the batch leaves idle
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const int dp = (D + 63) / 64 * 64, kchunks = (D + kStageK - 1) / kStageK;
  const int slots = kLong ? span_slots(span, S) : kDocs;
  const Layout lay = layout(dp, qslots, stages, slots, !kLong);
  bf16* qs = reinterpret_cast<bf16*>(base);
  unsigned char* ring = base + lay.ring;
  float* rowmax = reinterpret_cast<float*>(base + lay.rowmax);
  float* docmax = reinterpret_cast<float*>(base + lay.docmax);
  int* qcols = reinterpret_cast<int*>(base + lay.qcols);
  auto* full = reinterpret_cast<unsigned long long*>(base + lay.bars);
  unsigned long long* empty = full + stages;
  unsigned long long* qbar = empty + stages;
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
  // the group's queries, from the plan's unit owners (a 4-column unit's query,
  // -1 past them).  Long (units by 8, two a tile): bit j of `ends` marks tile j
  // as the last of its query (the same for every thread), query slot k's out
  // column qcols[k].  Short (units by 4): this lane's units 8 tq + i, i < 8, as
  // bit masks -- brk: unit i closes a run of one query (or of pads) in the
  // lane, endq: it is its query's last, lastm: the lane's last run --, slot4 (4
  // bits an i: the query's slot), whether the lane's first run goes on from the
  // lane before (cont_in); and this thread's slot of the per-document pass,
  // my_slot, with its query's out column my_col (-1: no query)
  const int* owner = plan + kPlanHead + group * kUnits;
  unsigned ends = 0, brk = 0, endq = 0, slot4 = 0;
  int nq = 0, my_col = -1;
  const int my_slot = threadIdx.x % kSlots;
  if constexpr (kLong) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int o = owner[2 * j];
      if (o >= 0 && (j + 1 == kTiles || owner[2 * j + 2] != o)) {
        ends |= 1u << j;
        if (threadIdx.x == 0) qcols[nq] = o;
        ++nq;
      }
    }
  } else {
    int prev = -1;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int o = owner[u], next = u + 1 < kUnits ? owner[u + 1] : -1;
      if (o >= 0 && o != prev) {
        if (nq == my_slot) my_col = o;
        ++nq;
      }
      if (u / 8 == tq) {
        const int i = u % 8;
        if (i == 7 || next != o) brk |= 1u << i;
        if (o >= 0 && next != o) endq |= 1u << i;
        slot4 |= (unsigned)((nq - 1) & (kSlots - 1)) << (4 * i);
      }
      prev = o;
    }
  }
  const bool cont_in = !kLong && tq > 0 && owner[8 * tq] >= 0 &&
                       owner[8 * tq - 1] == owner[8 * tq];
  const unsigned b7 = brk & 0x7fu;
  const bool single = b7 == 0u;             // the lane holds one run
  const unsigned lastm = single ? 0xffu : 0xffu & ~((2u << (31 - __clz(b7))) - 1u);
  if constexpr (kLong)
    for (int i = threadIdx.x; i < slots * qslots; i += kConsumers) docmax[i] = -INFINITY;
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
      // 8 j + 2 t, + 1 of each 8-column tile j (acc[4 j + 2 h], + 1); their
      // maximum:
      auto tile_max = [&](int h, int j) {
        return fmaxf(fmaf(rs[h], acc[4 * j + 2 * h], qa[2 * j]),
                     fmaf(rs[h], acc[4 * j + 2 * h + 1], qa[2 * j + 1]));
      };
      if constexpr (kLong) {
        // a row's maximum over its query's tiles (+ rb, the same for the
        // quad); the warp's 16 rows merged by shuffles where they lie in one
        // document, else each row's by an atomic
        const int wrow = r0 + wg * 64 + warp * 16;
        const int w0 = sp.off + wrow;
        const bool one_doc = wrow + 15 < rows && w0 / S == (w0 + 15) / S;
        float m[2] = {-INFINITY, -INFINITY};
        int k = 0;                               // the query's slot
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          m[0] = fmaxf(m[0], tile_max(0, j));
          m[1] = fmaxf(m[1], tile_max(1, j));
          if (!((ends >> j) & 1u)) continue;     // the same for every thread
          m[0] += rb[0];
          m[1] += rb[1];
          if (one_doc) {
            float w = fmaxf(m[0], m[1]);
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
            if (lane == 0) atomic_max_float(&docmax[w0 / S * qslots + k], w);
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
              m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
              if (tq == 0 && rl[h] < rows)
                atomic_max_float(&docmax[(sp.off + rl[h]) / S * qslots + k], m[h]);
            }
          }
          m[0] = m[1] = -INFINITY;
          ++k;
        }
        continue;
      }
      // short: each row's unit maxima by a reduce-scatter over the quad's
      // pairs (lane t ends with units 8 t .. 8 t + 7, in order), then each
      // query's maximum over its units: in the lane by runs, across the lanes
      // by a segmented scan of their last runs; the lane of a query's last unit
      // stores it (+ rb) into a [128, 16] tile of row maxima a query slot.
      // Then one thread a (document, slot) of the tile takes the maximum over
      // its rows and stores it, or, for the document that runs on into the
      // next tile, leaves it there to merge -- no atomics
      consumers_sync();                     // the tile before's rowmax has been read
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool up1 = tq & 1;            // keeps the upper half of the tiles
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float lo = tile_max(h, j), hi = tile_max(h, j + 8);
          v[j] = fmaxf(up1 ? hi : lo, __shfl_xor_sync(0xffffffffu, up1 ? lo : hi, 1));
        }
        // the lane's last run, carried over the lanes before where its query
        // began there (fresh: it begins in this lane)
        float y = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if ((lastm >> i) & 1u) y = fmaxf(y, v[i]);
        int fresh = !(single && cont_in);
#pragma unroll
        for (int d = 1; d < 4; d <<= 1) {
          const float yp = __shfl_up_sync(0xffffffffu, y, d, 4);
          const int fp = __shfl_up_sync(0xffffffffu, fresh, d, 4);
          if (tq >= d && !fresh) {
            y = fmaxf(y, yp);
            fresh = fp;
          }
        }
        const float yin = __shfl_up_sync(0xffffffffu, y, 1, 4);
        float m = cont_in ? yin : -INFINITY;
        float* row = rowmax + (my_row + 8 * h) * kSlots;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          m = fmaxf(m, v[i]);
          if ((brk >> i) & 1u) {
            if ((endq >> i) & 1u) row[(slot4 >> (4 * i)) & (kSlots - 1)] = m + rb[h];
            m = -INFINITY;
          }
        }
      }
      consumers_sync();
      // the tile's rows are [a, e), counted from the start of the span's
      // first document; thread i takes document d0 + i / 16 at its slot; a
      // document begun in the tile before starts from its carried maxima, one
      // that runs on into the next leaves its own
      const int a = r0, e = min(r0 + kRows, rows), d0 = a / S;
      const int items = ((e - 1) / S - d0 + 1) * kSlots;
      const float* carried = docmax + ((r0 / kRows + 1) & 1) * kSlots;
      float* carry = docmax + ((r0 / kRows) & 1) * kSlots;
      if (my_col >= 0)
        for (int i = threadIdx.x; i < items; i += kConsumers) {
          const int d = d0 + i / kSlots, rz = min((d + 1) * S, e) - a;
          float m = d * S < a ? carried[my_slot] : -INFINITY;
          for (int r = max(d * S, a) - a; r < rz; ++r) m = fmaxf(m, rowmax[r * kSlots + my_slot]);
          if ((d + 1) * S > e)
            carry[my_slot] = m;
          else
            out[(size_t)(doc0 + d) * out_cols + my_col] = m;
        }
    }
    consumers_sync();
    if constexpr (kLong) {
      // the span's maxima to out: stored where the document lies inside the
      // span, merged by an atomic max where it straddles two; each slot back
      // to -inf
      for (int i = threadIdx.x; i < sp.docs * nq; i += kConsumers) {
        const int d = i / nq, k = i % nq, start = d * S - sp.off;
        float* o = out + (size_t)(sp.doc0 + d) * out_cols + qcols[k];
        float& v = docmax[d * qslots + k];
        if (start >= 0 && start + S <= sp.rows)
          *o = v;
        else
          atomic_max_float(o, v);
        v = -INFINITY;
      }
      consumers_sync();
    }
  }
}

template <typename T>
int launch(const void* sents, const float* scales, const float* norms, const float* q,
           const float* qadd, const void* lens, int lens64, bf16* packed, float* qa, int* plan,
           float* out, int n_docs, int S, int D, int bsz, int qmax, int tq, int groups, int span,
           int blocks, cudaStream_t stream) {
  const int dp = (D + 63) / 64 * 64;
  // the walk a document's maximum would take with a query of tq tiles
  const bool long_walk = S * (tq / 2) >= kLongWalk || span != kDocs * S;
  const int slots = long_walk ? span_slots(span, S) : kDocs;
  const int qslots = bsz < kSlots ? bsz : kSlots;
  int stages = kMaxStages;
  while (stages > 2 && 1024 + layout(dp, qslots, stages, slots, !long_walk).total > kSmemLimit)
    --stages;
  const size_t smem = 1024 + layout(dp, qslots, stages, slots, !long_walk).total;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map_rows, map_q;
  if (!make_map(&map_rows,
                sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                sizeof(T), sents, (long long)n_docs * S, D, kRows, kRowBytes / sizeof(T),
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, packed, (long long)groups * kCols,
                dp, kCols, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  auto kernel = long_walk ? scan_wide_kernel<T, true> : scan_wide_kernel<T, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pack_kernel<<<dim3(groups, 4), 256, 0, stream>>>(q, qadd, lens, lens64, packed, qa, plan, bsz,
                                                   qmax, D, dp, kRowBytes / sizeof(T),
                                                   long_walk ? 8 : 4);
  kernel<<<blocks, kThreads, smem, stream>>>(map_rows, map_q, scales, norms, qa, plan, out,
                                             n_docs, S, D, qslots, bsz, stages, span);
  return (int)cudaGetLastError();
}

// groups: the host's bound on the live groups, tq: on a query's tiles (the
// layout of a query a power of two of columns); every live group needs a block
bool bad_args(int n_docs, int S, int D, int bsz, int qmax, int tq, int groups, int span,
              int blocks) {
  // a span touches at most (span + S - 2) / S + 1 documents
  return n_docs < 1 || S < 1 || D < 32 || D % 32 != 0 || D > 768 || bsz < 1 || qmax < 1 ||
         qmax > 8 * tq || tq < 2 || tq % 2 != 0 || kTiles % tq != 0 || groups < 1 ||
         (long long)bsz * tq > (long long)groups * kTiles || span < 1 ||
         ((long long)span + S - 2) / S + 1 > kSpanDocs || blocks < groups ||
         (long long)n_docs * S > 0x7fffffffll || (long long)groups * kCols > 0x7fffffffll;
}

}  // namespace

// sents [n_docs, S, D] int8 or bf16, D <= 768; scales (int8), norms [n_docs,
// S] f32; q [bsz, qmax, D] f32, qadd [bsz, qmax] f32 (read at real sentences)
// and lens [bsz] (int32, or int64 where lens64) on the device; scratch the
// kernel fills: packed [groups * 128, Dp] bf16 (Dp = D rounded up to 64), qa
// [groups * 128] f32, plan [3 + groups * 16] int32 (G, 128 G and the real
// sentences first); out [n_docs, bsz] f32 filled with -inf.  tq: 8-column
// tiles of a query a power of two of columns; groups: column groups of 128 at
// tq tiles a query, a bound on the packed ones; span: rows a span, touching at
// most kSpanDocs documents; blocks: the persistent blocks, at least groups.
extern "C" int aspire_scan_int8_wide(const void* sents, const void* scales, const void* norms,
                                     const void* q, const void* qadd, const void* lens,
                                     void* packed, void* qa, void* plan, void* out, int n_docs,
                                     int S, int D, int bsz, int qmax, int lens64, int tq,
                                     int groups, int span, int blocks, void* stream) {
  if (bad_args(n_docs, S, D, bsz, qmax, tq, groups, span, blocks))
    return (int)cudaErrorInvalidValue;
  return launch<signed char>(sents, (const float*)scales, (const float*)norms, (const float*)q,
                             (const float*)qadd, lens, lens64, (bf16*)packed, (float*)qa,
                             (int*)plan, (float*)out, n_docs, S, D, bsz, qmax, tq, groups,
                             span, blocks, (cudaStream_t)stream);
}

extern "C" int aspire_scan_bf16_wide(const void* sents, const void* norms, const void* q,
                                     const void* qadd, const void* lens, void* packed, void* qa,
                                     void* plan, void* out, int n_docs, int S, int D, int bsz,
                                     int qmax, int lens64, int tq, int groups, int span,
                                     int blocks, void* stream) {
  if (bad_args(n_docs, S, D, bsz, qmax, tq, groups, span, blocks))
    return (int)cudaErrorInvalidValue;
  return launch<bf16>(sents, nullptr, (const float*)norms, (const float*)q, (const float*)qadd,
                      lens, lens64, (bf16*)packed, (float*)qa, (int*)plan, (float*)out, n_docs,
                      S, D, bsz, qmax, tq, groups, span, blocks, (cudaStream_t)stream);
}
