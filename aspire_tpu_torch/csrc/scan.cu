// First-stage corpus scans over one dense bucket: per document the largest
//   rs[row] * (x_row . q_col) + rb[row] + qadd[col]
// over the document's S sentence rows and over the columns of one query.
//
// Takes the place of two TPU kernels of aspire_tpu/ops/pallas_scan.py:
//   _scan_kernel       rows bf16 or f32, one query:   rs = 2, rb = -|x|^2
//                      (+inf norms give -inf and lose the max);
//   _scan_int8_kernel  rows int8 upcast to bf16 (exact), a batch of queries:
//                      rs = 2 * scale, rb = -|x|^2 with +inf norms folded to
//                      -1e30 first, so that 0 * sims - inf never meets +inf.
//                      Batches that fill groups of 128 query columns run
//                      csrc/scan_int8.cu instead (ops/scan_kernel.py chooses
//                      by shape); this kernel takes the narrower ones, the
//                      single query among them.
// Both products are bf16 x bf16 with f32 accumulation (mma.sync m16n8k16); the
// query is rounded to bf16 by the caller and never quantised.  qadd carries
// the per-column term: -|q_j|^2 (or 0) at valid query sentences, -1e30 at
// padded ones.  Only [n_docs, queries] leaves the kernel.
//
// What bounds it: one query column group reads every row once, so a single
// query is bound by device memory; at 32 queries of 16 sentences the product
// (2 * rows * D * 512 operations) passes the memory time and the tensor cores
// bound it.  The design: a block owns one span of the bucket's flat rows
// (common.cuh: `span` rows whatever S is, so that a bucket of a few hundred
// documents of 1,200 sentences still fills the card) and one group of up to
// 128 query columns, which it keeps in shared memory for its whole life.  Its
// eight warps take the span's rows 32 at a time.  A warp reads its rows'
// fragments straight from device memory -- 16 contiguous bytes a lane for
// bf16, 8 for int8, converted in registers by integer and FP32-pipe
// instructions (`int8x4_to_bf16x2`, common.cuh) -- by pairing k indices so that
// what one lane loads in one instruction is what it owns in two mma steps (the
// query fragments are read from shared memory under the same pairing, so the
// product is unchanged).  Every query column of the group is accumulated in
// registers while the rows go by once.  Blocks that share rows and differ in
// column group are neighbours in the grid, so the groups after the first find
// the rows in the L2 cache.  Per row and query the maximum over the query's
// columns is taken in registers and across the four lanes of a quad; where a
// warp's 32 rows lie in one document they are merged across the warp by
// shuffles and one atomic a query, else each row's goes to its document by a
// shared-memory atomic.  A span's document maxima leave once, stored where
// the document lies wholly inside it and merged by a device-memory atomic max
// where it straddles two spans (ops/scan_kernel.py fills the output with -inf).
// Queries wider than a group (csrc/scan_int8.cu takes full groups up to
// D = 768) are several column groups of one launch.
//
// f32 rows (scan_f32_kernel, a check path: the index's scan stores bf16 or
// int8) take the true-f32 product by FMAs, never TF32, with the query kept
// in f32.  The same block layout (64 whole documents, one column group);
// the rows go by in chunks of 256 against 16 query columns at a time, both
// staged through shared memory 32 k at a time, a 4 x 4 tile a thread.
#include <math.h>

#include "common.cuh"

namespace {

using namespace aspire;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDocs = 64;             // documents a span of short ones, a block of the f32 scan
constexpr int kPad = 32;              // bf16 added to a query row's pitch: with D % 64 == 0 the
                                      // eight lanes of a 16-byte load phase hit 32 distinct banks
constexpr float kNeg = -1e30f;

// A fragments of rows `lo` (g) and `hi` (g + 8) for the two mma steps of one
// 32-wide k chunk: a lane's eight elements k = 8t .. 8t+7 stand for the
// logical columns (2t, 2t+1), (2t+8, 2t+9) of step 0 and of step 1.
__device__ __forceinline__ void load_a(const __nv_bfloat16* lo, const __nv_bfloat16* hi,
                                       unsigned (&a)[2][4]) {
  const uint4 l = *reinterpret_cast<const uint4*>(lo);
  const uint4 h = *reinterpret_cast<const uint4*>(hi);
  a[0][0] = l.x; a[0][1] = h.x; a[0][2] = l.y; a[0][3] = h.y;
  a[1][0] = l.z; a[1][1] = h.z; a[1][2] = l.w; a[1][3] = h.w;
}

__device__ __forceinline__ void load_a(const signed char* lo, const signed char* hi,
                                       unsigned (&a)[2][4]) {
  const uint2 l = *reinterpret_cast<const uint2*>(lo);
  const uint2 h = *reinterpret_cast<const uint2*>(hi);
  int8x4_to_bf16x2(l.x, a[0][0], a[0][2]);
  int8x4_to_bf16x2(h.x, a[0][1], a[0][3]);
  int8x4_to_bf16x2(l.y, a[1][0], a[1][2]);
  int8x4_to_bf16x2(h.y, a[1][1], a[1][3]);
}

// sents: [n_docs, S, D] of T; scales (int8 only), norms: [n_docs, S];
// q: [groups * 8 * NT, D] bf16; qadd: [groups * 8 * NT]; out: [n_docs, out_cols]
// holding -inf.  A query holds `tq` neighbouring 8-column tiles (tq even,
// NT % tq == 0).  Block b takes span b / groups and column group b % groups.
// kLong: spans of `span` rows whose documents may straddle two spans, and a
// warp's 32 rows may lie in one document; else (documents of fewer than 32
// rows, span = kDocs * S) spans of kDocs whole documents, the first design's
// blocks, by its code.
template <typename T, int NT, bool kLong>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ sents, const float* __restrict__ scales,
            const float* __restrict__ norms, const __nv_bfloat16* __restrict__ q,
            const float* __restrict__ qadd, float* __restrict__ out, int n_docs, int S, int D,
            int tq, int groups, int out_cols, int span) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kColsGroup = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = D + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);            // [kColsGroup][pitch]
  float* qadd_s = reinterpret_cast<float*>(qs + (size_t)kColsGroup * pitch);   // [kColsGroup]
  float* docmax = qadd_s + kColsGroup;                                   // [kSpanDocs][qg]
  const int group = blockIdx.x % groups;
  const int qg = NT / tq;              // queries a group
  const int tid = threadIdx.x;

  const __nv_bfloat16* qsrc = q + (size_t)group * kColsGroup * D;
  const int vec_row = D / 8;
  for (int i = tid; i < kColsGroup * vec_row; i += kThreads) {
    const int r = i / vec_row, c = (i % vec_row) * 8;
    *reinterpret_cast<uint4*>(qs + (size_t)r * pitch + c) =
        *reinterpret_cast<const uint4*>(qsrc + (size_t)r * D + c);
  }
  for (int i = tid; i < kColsGroup; i += kThreads) qadd_s[i] = qadd[group * kColsGroup + i];
  for (int i = tid; i < kSpanDocs * qg; i += kThreads) docmax[i] = -INFINITY;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  Span sp;                             // kLong
  long long doc0 = 0, row0;            // else: the span's first document; its first row
  int rows_here, off = 0;              // row r of the span lies in document (off + r) / S
  if constexpr (kLong) {
    sp = span_of(blockIdx.x / groups, span, n_docs * S, S);
    rows_here = sp.rows;
    off = sp.off;
    row0 = sp.row0;
  } else {
    doc0 = (long long)(blockIdx.x / groups) * kDocs;
    rows_here = (int)min((long long)kDocs, n_docs - doc0) * S;
    row0 = doc0 * S;
  }

  for (int chunk = warp; chunk * 32 < rows_here; chunk += kWarps) {
    float acc[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.f;

    // rows past the span's last are read as its last and left out below
    int rl[4];
    const T* rowp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rl[i] = chunk * 32 + i * 8 + g;
      rowp[i] = sents + (size_t)(row0 + min(rl[i], rows_here - 1)) * D + t * 8;
    }
    const __nv_bfloat16* qrow = qs + (size_t)g * pitch + t * 8;

#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 32) {
      unsigned a[2][2][4];
      load_a(rowp[0] + k0, rowp[1] + k0, a[0]);
      load_a(rowp[2] + k0, rowp[3] + k0, a[1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = *reinterpret_cast<const uint4*>(qrow + (size_t)nt * 8 * pitch + k0);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16_16816(acc[m][nt], a[m][0], b.x, b.y);
          mma_bf16_16816(acc[m][nt], a[m][1], b.z, b.w);
        }
      }
    }

    // a lane holds rows g (+ 8) of each 16-row tile at columns 2t, 2t+1 of
    // each 8-column tile
    const int c0 = off + chunk * 32;          // the chunk's first row, from its document's start
    if (kLong && chunk * 32 + 31 < rows_here && c0 / S == (c0 + 31) / S) {
      // the warp's 32 rows lie in one document: each query's maximum over
      // them by shuffles, one atomic a query
      float w[NT / 2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) w[p] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = row0 + rl[i];
        const float norm = norms[row];
        float rs = 2.f, rb = -norm;
        if constexpr (kInt8) {
          rs = 2.f * scales[row];
          rb = isfinite(norm) ? -norm : kNeg;
        }
        const int m = i >> 1, h = (i & 1) * 2;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          w[j / 2] = fmaxf(w[j / 2], rs * acc[m][j][h] + rb + qadd_s[j * 8 + 2 * t]);
          w[j / 2] = fmaxf(w[j / 2], rs * acc[m][j][h + 1] + rb + qadd_s[j * 8 + 2 * t + 1]);
        }
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) w[p] = fmaxf(w[p], __shfl_xor_sync(0xffffffffu, w[p], o));
        if (lane == 0) atomic_max_float(&docmax[c0 / S * qg + 2 * p / tq], w[p]);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = rl[i] < rows_here;
      const int r = min(rl[i], rows_here - 1);
      const float norm = norms[row0 + r];
      float rs = 2.f, rb = -norm;
      if constexpr (kInt8) {
        rs = 2.f * scales[row0 + r];
        rb = isfinite(norm) ? -norm : kNeg;
      }
      const int doc = (off + r) / S;          // of the span's documents
      const int m = i >> 1, h = (i & 1) * 2;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        float v = -INFINITY;
#pragma unroll
        for (int j = nt; j < nt + 2; ++j) {
          v = fmaxf(v, rs * acc[m][j][h] + rb + qadd_s[j * 8 + 2 * t]);
          v = fmaxf(v, rs * acc[m][j][h + 1] + rb + qadd_s[j * 8 + 2 * t + 1]);
        }
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t == 0 && valid) atomic_max_float(&docmax[doc * qg + nt / tq], v);
      }
    }
  }
  __syncthreads();
  if constexpr (kLong) {
    flush_span(sp, S, docmax, qg, out, out_cols, group * qg, tid, kThreads);
  } else {
    for (int i = tid; i < rows_here / S * qg; i += kThreads)
      out[(size_t)(doc0 + i / qg) * out_cols + group * qg + i % qg] = docmax[i];
  }
}

constexpr int kF32Rows = 256;         // rows of a chunk of the f32 scan
constexpr int kF32Cols = 16;          // query columns of a chunk
constexpr int kF32K = 32;             // k staged a step
constexpr int kF32Loads = kF32Rows * kF32K / 4 / kThreads;   // float4 row loads a thread a step
constexpr int kF32QLoads = kF32Cols * kF32K / kThreads;      // query loads a thread a step

// The f32 scan: the same [n_docs, out_cols] result as scan_kernel, with q in
// f32 ([groups * cols_group, D]) and the product in f32 FMAs.  Thread
// (ty, tx) of 256 owns rows 4 ty .. 4 ty + 3 of a chunk and its columns
// 4 tx .. 4 tx + 3, so that one shared-memory read feeds four FMAs.  The rows
// arrive by 16-byte loads into registers one k step ahead of the product.
__global__ void __launch_bounds__(kThreads)
scan_f32_kernel(const float* __restrict__ sents, const float* __restrict__ norms,
                const float* __restrict__ q, const float* __restrict__ qadd,
                float* __restrict__ out, int n_docs, int S, int D, int cols_group, int tq,
                int groups, int out_cols) {
  __shared__ float xs[kF32Rows][kF32K + 1];             // odd pitch: no bank conflicts
  __shared__ __align__(16) float qs[kF32K][kF32Cols];
  extern __shared__ float dyn[];
  float* qadd_s = dyn;                      // [cols_group]
  const int qg = cols_group / (8 * tq);     // queries a group
  float* docmax = qadd_s + cols_group;      // [kDocs][qg]
  const int group = blockIdx.x % groups;
  const long long doc0 = (long long)(blockIdx.x / groups) * kDocs;
  const int tid = threadIdx.x, ty = tid >> 2, tx = tid & 3;
  for (int i = tid; i < cols_group; i += kThreads) qadd_s[i] = qadd[group * cols_group + i];
  for (int i = tid; i < kDocs * qg; i += kThreads) docmax[i] = -INFINITY;
  __syncthreads();

  const int docs_here = (int)min((long long)kDocs, n_docs - doc0);
  const int rows_here = docs_here * S;
  const float* rows = sents + (size_t)doc0 * S * D;
  const float* qgrp = q + (size_t)group * cols_group * D;
  for (int r0 = 0; r0 < rows_here; r0 += kF32Rows) {
    for (int c0 = 0; c0 < cols_group; c0 += kF32Cols) {
      float4 xr[kF32Loads];
      float qr[kF32QLoads];
      // rows past the block's last are read as its last and left out below
      auto fetch = [&](int k0) {
#pragma unroll
        for (int j = 0; j < kF32Loads; ++j) {
          const int i = j * kThreads + tid, r = i >> 3, c4 = i & 7;
          xr[j] = *reinterpret_cast<const float4*>(
              rows + (size_t)min(r0 + r, rows_here - 1) * D + k0 + 4 * c4);
        }
#pragma unroll
        for (int j = 0; j < kF32QLoads; ++j) {
          const int i = j * kThreads + tid;
          qr[j] = qgrp[(size_t)(c0 + (i & 15)) * D + k0 + (i >> 4)];
        }
      };
      float acc[4][4] = {};
      fetch(0);
      for (int k0 = 0; k0 < D; k0 += kF32K) {
#pragma unroll
        for (int j = 0; j < kF32Loads; ++j) {
          const int i = j * kThreads + tid, r = i >> 3, c4 = i & 7;
          xs[r][4 * c4] = xr[j].x;
          xs[r][4 * c4 + 1] = xr[j].y;
          xs[r][4 * c4 + 2] = xr[j].z;
          xs[r][4 * c4 + 3] = xr[j].w;
        }
#pragma unroll
        for (int j = 0; j < kF32QLoads; ++j) {
          const int i = j * kThreads + tid;
          qs[i >> 4][i & 15] = qr[j];
        }
        __syncthreads();
        if (k0 + kF32K < D) fetch(k0 + kF32K);
#pragma unroll 8
        for (int k = 0; k < kF32K; ++k) {
          const float4 b = *reinterpret_cast<const float4*>(&qs[k][4 * tx]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = xs[4 * ty + r][k];
            acc[r][0] = fmaf(a, b.x, acc[r][0]);
            acc[r][1] = fmaf(a, b.y, acc[r][1]);
            acc[r][2] = fmaf(a, b.z, acc[r][2]);
            acc[r][3] = fmaf(a, b.w, acc[r][3]);
          }
        }
        __syncthreads();
      }
      // a thread's four columns lie in one query (a query takes 16 or more)
      const int col = c0 + 4 * tx;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = r0 + 4 * ty + r;
        if (rl >= rows_here) continue;
        const float nrm = norms[doc0 * S + rl];
        float v = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) v = fmaxf(v, 2.f * acc[r][c] - nrm + qadd_s[col + c]);
        atomic_max_float(&docmax[(rl / S) * qg + col / (8 * tq)], v);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < docs_here * qg; i += kThreads)
    out[(size_t)(doc0 + i / qg) * out_cols + group * qg + i % qg] = docmax[i];
}

template <typename T, int NT>
int launch_nt(const void* sents, const float* scales, const float* norms, const void* q,
              const float* qadd, float* out, int n_docs, int S, int D, int tq, int groups,
              int out_cols, int span, cudaStream_t stream) {
  const size_t smem = (size_t)8 * NT * (D + kPad) * sizeof(__nv_bfloat16) + 8 * NT * sizeof(float) +
                      (size_t)kSpanDocs * (NT / tq) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = S < 32 && span == kDocs * S ? scan_kernel<T, NT, false> : scan_kernel<T, NT, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long spans = ((long long)n_docs * S + span - 1) / span;
  const long long blocks = (long long)groups * spans;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)sents, scales, norms, (const __nv_bfloat16*)q, qadd, out, n_docs, S, D, tq,
      groups, out_cols, span);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* sents, const float* scales, const float* norms, const void* q,
           const float* qadd, float* out, int n_docs, int S, int D, int nt, int tq, int groups,
           int out_cols, int span, void* stream) {
  // a span touches at most (span + S - 2) / S + 1 documents
  if (n_docs < 1 || S < 1 || D < 32 || D % 32 != 0 || tq < 2 || tq % 2 != 0 || nt % tq != 0 ||
      groups < 1 || out_cols < groups * (nt / tq) || span < 1 ||
      ((long long)span + S - 2) / S + 1 > kSpanDocs || (long long)n_docs * S > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nt) {
    case 2: return launch_nt<T, 2>(sents, scales, norms, q, qadd, out, n_docs, S, D, tq, groups, out_cols, span, s);
    case 4: return launch_nt<T, 4>(sents, scales, norms, q, qadd, out, n_docs, S, D, tq, groups, out_cols, span, s);
    case 8: return launch_nt<T, 8>(sents, scales, norms, q, qadd, out, n_docs, S, D, tq, groups, out_cols, span, s);
    case 16: return launch_nt<T, 16>(sents, scales, norms, q, qadd, out, n_docs, S, D, tq, groups, out_cols, span, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_f32(const float* sents, const float* norms, const float* q, const float* qadd,
               float* out, int n_docs, int S, int D, int nt, int tq, int groups, int out_cols,
               void* stream) {
  if (n_docs < 1 || S < 1 || D < 32 || D % kF32K != 0 || tq < 2 || tq % 2 != 0 ||
      nt % tq != 0 || nt > 16 || groups < 1 || out_cols < groups * (nt / tq))
    return (int)cudaErrorInvalidValue;
  const int cols_group = 8 * nt;
  const size_t smem = (size_t)(cols_group + kDocs * (nt / tq)) * sizeof(float);
  const long long blocks = (long long)groups * ((n_docs + kDocs - 1) / kDocs);
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  scan_f32_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      sents, norms, q, qadd, out, n_docs, S, D, cols_group, tq, groups, out_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// nt: 8-column tiles a group (2, 4, 8 or 16); tq: tiles a query; groups: column
// groups; out: [n_docs, out_cols] filled with -inf, out_cols >= groups * nt /
// tq; span: rows a span, touching at most kSpanDocs documents.
extern "C" int aspire_scan_bf16(const void* sents, const void* norms, const void* q,
                                const void* qadd, void* out, int n_docs, int S, int D, int nt,
                                int tq, int groups, int out_cols, int span, void* stream) {
  return launch<__nv_bfloat16>(sents, nullptr, (const float*)norms, q, (const float*)qadd,
                               (float*)out, n_docs, S, D, nt, tq, groups, out_cols, span,
                               stream);
}

extern "C" int aspire_scan_int8(const void* sents, const void* scales, const void* norms,
                                const void* q, const void* qadd, void* out, int n_docs, int S,
                                int D, int nt, int tq, int groups, int out_cols, int span,
                                void* stream) {
  return launch<signed char>(sents, (const float*)scales, (const float*)norms, q,
                             (const float*)qadd, (float*)out, n_docs, S, D, nt, tq, groups,
                             out_cols, span, stream);
}

extern "C" int aspire_scan_f32(const void* sents, const void* norms, const void* q,
                               const void* qadd, void* out, int n_docs, int S, int D, int nt,
                               int tq, int groups, int out_cols, void* stream) {
  return launch_f32((const float*)sents, (const float*)norms, (const float*)q,
                    (const float*)qadd, (float*)out, n_docs, S, D, nt, tq, groups, out_cols,
                    stream);
}
