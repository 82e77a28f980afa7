// Shared helpers of the aspire_tpu_torch CUDA kernels.  The sources include
// no PyTorch header: each exposes plain C functions that launch on the stream
// they are given, allocate nothing, do not synchronise, and return the
// cudaError_t of the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aspire {

// 16-byte vector load from global memory into `n = 16 / sizeof(T)` elements of
// shared memory (zero-filled when `valid` is false).
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, bool valid) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (valid) v = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- tensor-core building blocks (bf16 in, f32 accumulate) ------------------
// mma.sync m16n8k16: a warp multiplies A[16, 16] (row-major fragments) by
// B[16, 8] and adds into C[16, 8].  With g = lane / 4 and t = lane % 4 a thread
// holds  A: a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same cols),
//           a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9);
//        B: b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g);
//        C: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, cols 2t, 2t+1).
// ldmatrix.x4 loads four 8x8 bf16 blocks; lane l supplies the address of one
// 16-byte block row (lanes 0-7 for the first block, 8-15 the second, ...).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Block (row-of-16 x col-of-16) of a bf16 matrix in shared memory, as ldmatrix
// wants its lane addresses.  `a_order`: blocks in the order (r, c), (r+8, c),
// (r, c+8), (r+8, c+8) -- an A fragment, or with .trans the B fragments of two
// neighbouring 8-column tiles from a [k][n] matrix.  Otherwise (r, c),
// (r, c+8), (r+8, c), (r+8, c+8) -- the B fragments of two 8-column tiles from
// a [n][k] matrix.
__device__ __forceinline__ unsigned frag_addr(const __nv_bfloat16* base, int ld, int lane,
                                              bool a_order) {
  const int lo = (lane >> 3) & 1, hi = lane >> 4;
  const int r = (lane & 7) + (a_order ? lo : hi) * 8;
  const int c = (a_order ? hi : lo) * 8;
  return smem_addr(base + r * ld + c);
}

}  // namespace aspire
