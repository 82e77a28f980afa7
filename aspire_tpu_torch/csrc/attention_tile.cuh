// What the attention forward (attention.cu) and backward (attention_bwd.cu)
// share: tile sizes, the tile loaders (asynchronous bf16 into the padded or
// the wgmma layout, asynchronous f32), the mma.sync product of a warp's 16 rows
// with a 64-row tile that the backward's dq kernel runs, and the f32 kernels'
// split-TF32 products at every head width, the score tile among them.
#pragma once

#include <math.h>

#include "common.cuh"

namespace aspire {

constexpr int kHd = 64;        // head width
constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBq / kWarps;   // 16 query rows per warp

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int ld = 72; };   // 16-byte rows, skewed banks

// rows [row0, row0 + 64) of a [t, 64] bf16 matrix into a [64][72] tile without
// waiting: the copies join the thread's open group; zero past t
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int t) {
  constexpr int ld = Cfg<__nv_bfloat16>::ld;
  for (int idx = threadIdx.x; idx < kBk * (kHd / 8); idx += kThreads) {
    const int r = idx / (kHd / 8), cv = (idx % (kHd / 8)) * 8;
    const bool valid = row0 + r < t;
    cp_async16(dst + r * ld + cv, valid ? src + (long long)(row0 + r) * stride + cv : src, valid);
  }
}

// kTileRows rows from row0 on of a [t, kW] matrix into the 128-byte-swizzled
// layout that wgmma descriptors read (common.cuh): rows of 128 bytes, dst
// 1024-byte aligned; a row wider than 64 goes to kW / 64 column blocks of
// [kTileRows][64], block cb at dst + cb * kTileRows * 64 (a K-major operand
// steps its descriptor over the blocks, an MN-major one takes a product a
// block).  The block's first kNThreads threads share the copies.
template <int kTileRows = kBk, int kNThreads = kThreads, int kW = kHd>
__device__ __forceinline__ void load_tile_sw128_async(__nv_bfloat16* dst,
                                                      const __nv_bfloat16* src, long long stride,
                                                      int row0, int t) {
  constexpr unsigned kChunks = kW / 8;   // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kTileRows * (int)kChunks; idx += kNThreads) {
    // unsigned: at kW = 64 a shift and a mask, and the block index folds
    // away (a signed division cost the 64-wide kernels registers)
    const int r = (unsigned)idx / kChunks, c = (unsigned)idx % kChunks;
    const bool valid = row0 + r < t;
    cp_async16(dst + (c >> 3) * kTileRows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3),
               valid ? src + (long long)(row0 + r) * stride + (c << 3) : src, valid);
  }
}

// The descriptor of k-step kk (16 columns) of a K-major operand stored as
// column blocks of kRows rows (load_tile_sw128_async): block kk / 4, 32 bytes
// a step inside it
template <int kRows>
__device__ __forceinline__ unsigned long long kmajor_desc(const __nv_bfloat16* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kRows * 64 + (kk & 3) * 16);
}

// acc[16, 64] += a[16, 16] . b[16j .. 16j + 15] for a tile b[64][64] ([k][n],
// pitch 72) in shared memory; a is the A fragment of the j-th 16 of the
// contraction.
__device__ __forceinline__ void mma_ab_chunk(float (&acc)[kHd / 8][4], const unsigned (&a)[4],
                                             const __nv_bfloat16* b, int j, int lane) {
  constexpr int ld = Cfg<__nv_bfloat16>::ld;
#pragma unroll
  for (int np = 0; np < kHd / 16; ++np) {
    unsigned bfr[4];               // b is [k][n]: transposed on load
    ldmatrix_x4_trans(bfr, frag_addr(b + j * 16 * ld + np * 16, ld, lane, true));
    mma_bf16_16816(acc[2 * np], a, bfr[0], bfr[1]);
    mma_bf16_16816(acc[2 * np + 1], a, bfr[2], bfr[3]);
  }
}

// ---- f32 building blocks: split-TF32 (3xTF32) mma.sync products ----------
// mma.sync m16n8k8 TF32: with g = lane / 4 and t = lane % 4 a thread holds
// A[16, 8] as a0 = (row g, k t), a1 = (row g + 8, k t), a2 = (row g, k t + 4),
// a3 = (row g + 8, k t + 4); B[8, 8] as b0 = (k t, col g), b1 = (k t + 4,
// col g); C as c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, the
// same).  The f32 kernels permute k inside each step: slot t is element 2t and
// slot t + 4 element 2t + 1, so that an accumulator tile (c0, c2, c1, c3) is
// the A fragment of a product that contracts over its columns, and a row's two
// elements of a step are one float2.

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

// acc += a . b of one k-step in a fresh accumulator (cross terms, then hi.hi),
// added to acc by f32 additions: the tensor cores' truncating additions stay
// at the size of eight products, for sums over hundreds of rows or keys
__device__ __forceinline__ void mma3_add(float (&acc)[4], const float (&ah)[4],
                                         const float (&al)[4], float b0, float b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_cross(c, ah, al, b0, b1);
  mma_hihi(c, ah, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

// the split A fragment (hi, lo) of four f32 values in slot order
__device__ __forceinline__ void split_frag(const float4 x, float (&hi)[4], float (&lo)[4]) {
  tf32_split(x.x, hi[0], lo[0]);
  tf32_split(x.y, hi[1], lo[1]);
  tf32_split(x.z, hi[2], lo[2]);
  tf32_split(x.w, hi[3], lo[3]);
}

// The A fragments of a warp's 16 rows (rows row_g and row_g + 8 of this
// thread) of a [t, kW] f32 matrix, unsplit, into shared memory at frag (this
// warp's, + lane): k-step kk at frag[kk * 32], slots (row g dim 2t, row g + 8
// dim 2t, row g dim 2t + 1, row g + 8 dim 2t + 1) of dims 8 kk ..; rows past t
// are zero.  One float4 a step and a lane, read without bank conflicts.  The
// f32 helpers from here on take the head width kW (64, 128, 192, 256; 64 by
// default, where each is the code the 64-wide kernels were built from).
template <int kW = kHd>
__device__ __forceinline__ void store_row_frags(float4* frag, const float* src, long long stride,
                                                int row_g, int t, int tq) {
#pragma unroll
  for (int kk = 0; kk < kW / 8; ++kk) {
    float2 x[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_g + 8 * h;
      x[h] = row < t ? *reinterpret_cast<const float2*>(src + (long long)row * stride + 8 * kk + 2 * tq)
                     : make_float2(0.f, 0.f);
    }
    frag[kk * 32] = make_float4(x[0].x, x[1].x, x[0].y, x[1].y);
  }
}

// rows [row0, row0 + kTileRows) of a [t, kW] f32 matrix with row pitch
// `stride` into a [kTileRows][ld] tile by cp.async, joining the thread's open
// group; zero past t.  The block's first kNThreads threads share the copies.
template <int ld, int kTileRows = kBk, int kW = kHd, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* src, long long stride,
                                                    int row0, int t) {
  for (int idx = threadIdx.x; idx < kTileRows * (kW / 4); idx += kNThreads) {
    const int r = idx / (kW / 4), c = (idx % (kW / 4)) * 4;
    const bool valid = row0 + r < t;
    cp_async16(dst + r * ld + c, valid ? src + (long long)(row0 + r) * stride + c : src, valid);
  }
}

// A.B^T of a warp's 16 rows of A (a(kk, hi, lo) gives the split A fragment
// of k-step kk) and 8 kN rows of a tile from bt on (rows of kLdB floats), in
// the accumulator layout: s[c] holds rows g, g + 8 at tile rows 8 c + 2 t, + 1.
// The tensor cores add into an accumulator with truncation (up to an ulp of
// the sum an addition, always towards zero), so each k-step's sum (cross
// terms, then hi.hi) goes into a fresh accumulator, added to s by f32
// additions (mma3_add): the result is as good as an FMA loop's and its error
// has no bias, which the training kernels need, whose gradients carry a
// score's bias into every ds.  (K2 in f32, whose context averages the scores,
// sums all k-steps in one accumulator, attention.cu.)
template <int kLdB, int kN, int kW = kHd, typename AFrag>
__device__ __forceinline__ void tf32x3_abT(float (&s)[kN][4], AFrag a, const float* bt, int g,
                                           int tq) {
#pragma unroll
  for (int c = 0; c < kN; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[c][i] = 0.f;
  if constexpr (kW == kHd) {
#pragma unroll
    for (int kk = 0; kk < kW / 8; ++kk) {
      float ah[4], al[4];
      a(kk, ah, al);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float2 bv = *reinterpret_cast<const float2*>(bt + (8 * c + g) * kLdB + 8 * kk + 2 * tq);
        mma3_add(s[c], ah, al, bv.x, bv.y);
      }
    }
  } else {
    // the same, eight k-steps unrolled at a time (the 64-wide kernels keep
    // the whole unroll, and their code): wider, a whole unroll hoisted the
    // tile's loads into spills
#pragma unroll 8
    for (int kk = 0; kk < kW / 8; ++kk) {
      float ah[4], al[4];
      a(kk, ah, al);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float2 bv = *reinterpret_cast<const float2*>(bt + (8 * c + g) * kLdB + 8 * kk + 2 * tq);
        mma3_add(s[c], ah, al, bv.x, bv.y);
      }
    }
  }
}

// The scores of a warp's 16 query rows and 8 kN keys (kt: their rows of
// kLdK f32, bt: their biases), q.k^T * sm_scale + bias in the accumulator
// layout.  The forward and the backward kernel that recomputes its
// probabilities (the rows kernel at 64, the scores kernel wider) take their
// scores from here, so that the backward's probabilities are the forward's bit
// for bit (an element's arithmetic does not depend on kN, the tile or the
// pitch: the k-steps of kW columns in order, each a fresh accumulator added in
// f32).
template <int kLdK, int kN, int kW = kHd, typename QFrag>
__device__ __forceinline__ void tf32x3_scores(float (&s)[kN][4], QFrag qa, const float* kt,
                                              const float* bt, float sm_scale, int g, int tq) {
  tf32x3_abT<kLdK, kN, kW>(s, qa, kt, g, tq);
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * c + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[c][i] = s[c][i] * sm_scale + ((i & 1) ? bb.y : bb.x);
  }
}

// a warp's [16, kW] f32 accumulator (rows row_g, row_g + 8 of this thread,
// dims 8 c + 2 t, + 1), the rows below t, by float2 stores
template <int kW = kHd>
__device__ __forceinline__ void store_rows_f32(const float (&o)[kW / 8][4], float* dst,
                                               long long stride, int row_g, int t, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_g + 8 * h;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < kW / 8; ++c)
      *reinterpret_cast<float2*>(dst + (long long)row * stride + 8 * c + 2 * tq) =
          make_float2(o[c][2 * h], o[c][2 * h + 1]);
  }
}

}  // namespace aspire
