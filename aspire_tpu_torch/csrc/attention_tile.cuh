// What the attention forward (attention.cu) and backward (attention_bwd.cu)
// share: tile sizes, the tile loaders (plain, and asynchronous into the padded
// or the wgmma layout), and the mma.sync products of a warp's 16 rows with a
// 64-row tile.
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
constexpr int kLdS = 68;       // pitch of the f32 kernels' score rows (float4 reads)

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int ld = 72; };   // 16-byte rows, skewed banks
template <> struct Cfg<float> { static constexpr int ld = 65; };           // odd pitch: k[c][d] by lane c

// rows [row0, row0 + 64) of a [t, 64] matrix with row pitch `stride`; zero past t
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0,
                                          int t) {
  constexpr int vec = 16 / sizeof(T), per_row = kHd / vec, ld = Cfg<T>::ld;
  for (int idx = threadIdx.x; idx < kBk * per_row; idx += kThreads) {
    const int r = idx / per_row, cv = (idx % per_row) * vec;
    const bool valid = row0 + r < t;
    const T* p = src + (long long)(row0 + r) * stride + cv;
    if constexpr (sizeof(T) == 2) {
      copy16(dst + r * ld + cv, p, valid);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) v = *reinterpret_cast<const float4*>(p);
      float* o = reinterpret_cast<float*>(dst) + r * ld + cv;
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
  }
}

// ---- asynchronous copies (cp.async, 16 bytes, L2 only) ----------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)   // zero-fill when invalid
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// load_tile for bf16 without waiting: the copies join the thread's open group
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int row0, int t) {
  constexpr int ld = Cfg<__nv_bfloat16>::ld;
  for (int idx = threadIdx.x; idx < kBk * (kHd / 8); idx += kThreads) {
    const int r = idx / (kHd / 8), cv = (idx % (kHd / 8)) * 8;
    const bool valid = row0 + r < t;
    cp_async16(dst + r * ld + cv, valid ? src + (long long)(row0 + r) * stride + cv : src, valid);
  }
}

// the same into the 128-byte-swizzled layout that wgmma descriptors read
// (common.cuh): 64 rows of 128 bytes, dst 1024-byte aligned
__device__ __forceinline__ void load_tile_sw128_async(__nv_bfloat16* dst,
                                                      const __nv_bfloat16* src, long long stride,
                                                      int row0, int t) {
  for (int idx = threadIdx.x; idx < kBk * 8; idx += kThreads) {
    const int r = idx >> 3, c = idx & 7;
    const bool valid = row0 + r < t;
    cp_async16(dst + r * kHd + ((c ^ (r & 7)) << 3),
               valid ? src + (long long)(row0 + r) * stride + (c << 3) : src, valid);
  }
}

// acc[16, 64] = a[16, 64] . b^T for a tile b[64][64] (row-major, pitch 72) in
// shared memory; a as the four A fragments of the warp's 16 rows.
__device__ __forceinline__ void mma_abT(float (&acc)[kBk / 8][4], const unsigned (&a)[kHd / 16][4],
                                        const __nv_bfloat16* b, int lane) {
  constexpr int ld = Cfg<__nv_bfloat16>::ld;
#pragma unroll
  for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int np = 0; np < kBk / 16; ++np) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      unsigned bfr[4];             // b is [n][k]: B fragments without a transpose
      ldmatrix_x4(bfr, frag_addr(b + np * 16 * ld + kk * 16, ld, lane, false));
      mma_bf16_16816(acc[2 * np], a[kk], bfr[0], bfr[1]);
      mma_bf16_16816(acc[2 * np + 1], a[kk], bfr[2], bfr[3]);
    }
  }
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

// s = s * scale + bias of the column, in the accumulator layout
__device__ __forceinline__ void scale_bias(float (&s)[kBk / 8][4], const float* bias_s,
                                           float sm_scale, int tq) {
#pragma unroll
  for (int nt = 0; nt < kBk / 8; ++nt) {
    const float b0 = bias_s[nt * 8 + 2 * tq], b1 = bias_s[nt * 8 + 2 * tq + 1];
    s[nt][0] = s[nt][0] * sm_scale + b0;
    s[nt][1] = s[nt][1] * sm_scale + b1;
    s[nt][2] = s[nt][2] * sm_scale + b0;
    s[nt][3] = s[nt][3] * sm_scale + b1;
  }
}

// online max and sum of the rows g (index 0) and g + 8 (index 1) over one tile
__device__ __forceinline__ void row_stats(const float (&s)[kBk / 8][4], float (&m_run)[2],
                                          float (&l_run)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
      sum += expf(s[nt][2 * h] - m_new) + expf(s[nt][2 * h + 1] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run[h] = l_run[h] * expf(m_run[h] - m_new) + sum;
    m_run[h] = m_new;
  }
}

// ---- f32 building blocks: plain FMAs, a warp's 16 rows, lane c owns columns
// c and c + 32 of a product ---------------------------------------------------

// out[16][kLdS] = a[16][65] . b[64][65]^T
__device__ __forceinline__ void f32_abT(const float* a, const float* b, float* out) {
  const int lane = threadIdx.x & 31;
  float a0[kRows], a1[kRows];
  for (int r = 0; r < kRows; ++r) a0[r] = a1[r] = 0.f;
  const float* b0 = b + lane * 65;
  const float* b1 = b + (lane + 32) * 65;
  for (int d = 0; d < kHd; ++d) {
    const float x0 = b0[d], x1 = b1[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a[r * 65 + d];
      a0[r] = fmaf(av, x0, a0[r]);
      a1[r] = fmaf(av, x1, a1[r]);
    }
  }
  for (int r = 0; r < kRows; ++r) {
    out[r * kLdS + lane] = a0[r];
    out[r * kLdS + lane + 32] = a1[r];
  }
}

// o0/o1[16] += p[16][ldp] . b[64][65]: columns lane and lane + 32
__device__ __forceinline__ void f32_ab(float (&o0)[kRows], float (&o1)[kRows], const float* p,
                                       int ldp, const float* b) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < kBk; ++j) {
    const float v0 = b[j * 65 + lane], v1 = b[j * 65 + lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pv = p[r * ldp + j];
      o0[r] = fmaf(pv, v0, o0[r]);
      o1[r] = fmaf(pv, v1, o1[r]);
    }
  }
}

}  // namespace aspire
