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

// ---- warpgroup products (wgmma, sm_90a) -------------------------------------
// A warpgroup (four consecutive warps) multiplies A[64, 16] by B[16, N] into an
// f32 accumulator D[64, N] held in registers.  Warp w of the group holds rows
// 16 w .. + 15 of A and of D in the mma.sync m16n8k16 layouts above: A as four
// registers, D as four floats for each 8-column tile j (d[4 j + i] is c_i of
// tile j).  B is read from shared memory through a descriptor: a tile whose
// rows are 128 bytes, 1024-byte aligned, with the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8) (the 128-byte swizzle).  Such a tile of [n][64]
// bf16 is B K-major (rows are n; start at chunk 2 kk for k-step kk) and, read
// the other way, a [k][64] tile is B MN-major (kTransB = 1; start at row 16 kk).
// Both have 8-row groups 1024 bytes apart.
__device__ __forceinline__ unsigned long long sw128_desc(const void* smem_ptr) {
  const unsigned long long addr = smem_addr(smem_ptr);
  return ((addr & 0x3FFFFull) >> 4)        // start address
         | (1ull << 16)                    // leading byte offset (unused by these layouts)
         | ((1024ull >> 4) << 32)          // stride byte offset: 8-row groups
         | (1ull << 62);                   // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// keeps the compiler from touching accumulator registers across an
// asynchronous product (reads after a wait stay after it)
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[8] (D[64, 16]) = (accumulate ? d : 0) + a . B
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], const unsigned (&a)[4],
                                                unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB));
}

// d[32] (D[64, 64]) = (accumulate ? d : 0) + a . B
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB));
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


// ---- dropout bits: Philox4x32-10, keyed on the element's position -----------
// One call gives the 32-bit words of four neighbouring columns of one row:
//   key     = the call's 64-bit seed (low word, high word)
//   counter = (kind << 24 | site, batch * heads + head, row, column / 4)
// with kind 0 for hidden dropout (second word 0) and 1 for attention, so the
// two never share a counter.  Word (column % 4) belongs to the column.  An
// element is kept when its word >= round(p * 2^32), compared unsigned.
// ops/philox.py computes the same words in plain PyTorch.
struct Drop {
  unsigned long long seed;
  unsigned c0;            // kind << 24 | site
  unsigned thresh;        // round(p * 2^32)
  float keep_div;         // 1 - p rounded to the compute type (forward divides by it)
  float keep_div32;       // 1 - p in f32 (the backward's division)
  const unsigned* bits;   // explicit bits operand (mode 2), else null
};

__device__ __forceinline__ uint4 philox4x32_10(unsigned c0, unsigned c1, unsigned c2, unsigned c3,
                                               unsigned k0, unsigned k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint4 drop_words(const Drop& d, unsigned plane, unsigned row,
                                            unsigned col4) {
  return philox4x32_10(d.c0, plane, row, col4, (unsigned)d.seed, (unsigned)(d.seed >> 32));
}

// Bits of a thread's four elements of one 8-column mma accumulator tile (rows
// g and g + 8, columns col0 + 2t, + 1; col0 a multiple of 8).  kMode 1: one
// Philox call a thread -- the even thread of a pair makes row g's call, the odd
// one row g + 8's, and they swap the two words the other needs.  The whole warp
// must call this together.  kMode 2: read from the bits operand, a [planes, t, t]
// array; positions past t count as kept.
template <int kMode>
__device__ __forceinline__ void acc_bits(const Drop& d, int plane, int t, int row_g, int col0,
                                         int lane, unsigned (&bits)[4]) {
  const int tq = lane & 3;
  if constexpr (kMode == 1) {
    const int odd = tq & 1;
    const uint4 w = drop_words(d, (unsigned)plane, (unsigned)(row_g + 8 * odd),
                               (unsigned)((col0 + 2 * (tq - odd)) >> 2));
    const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    bits[0] = odd ? r0 : w.x;
    bits[1] = odd ? r1 : w.y;
    bits[2] = odd ? w.z : r0;
    bits[3] = odd ? w.w : r1;
  } else {
    const int col = col0 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_g + 8 * h;
      const unsigned* p = d.bits + ((long long)plane * t + row) * t + col;
      bits[2 * h] = (row < t && col < t) ? p[0] : 0xffffffffu;
      bits[2 * h + 1] = (row < t && col + 1 < t) ? p[1] : 0xffffffffu;
    }
  }
}

// Bits of four neighbouring columns col4 * 4 .. + 3 of one row of a [t, t] plane.
template <int kMode>
__device__ __forceinline__ uint4 row_bits(const Drop& d, int plane, int t, int row, int col4) {
  if constexpr (kMode == 1) {
    return drop_words(d, (unsigned)plane, (unsigned)row, (unsigned)col4);
  } else {
    unsigned w[4];
    const unsigned* p = d.bits + ((long long)plane * t + row) * t + col4 * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = (row < t && col4 * 4 + i < t) ? p[i] : 0xffffffffu;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dropped probability in bf16: the normalised f32 value is cast, divided by
// (1 - p) in the compute type and cast again; dropped elements are zero
__device__ __forceinline__ float drop_prob_bf16(float p, bool keep, float keep_div) {
  const float cast = __bfloat162float(__float2bfloat16_rn(p));
  return keep ? cast / keep_div : 0.f;
}

}  // namespace aspire
