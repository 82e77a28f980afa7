// Shared helpers of the aspire_tpu_torch CUDA kernels.  The sources include
// no PyTorch header: each exposes plain C functions that launch on the stream
// they are given, allocate nothing, do not synchronise, and return the
// cudaError_t of the launch.
#pragma once

#include <math.h>
#include <cuda.h>            // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aspire {

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

// ---- split TF32 (3xTF32): f32 products on the TF32 tensor cores -------------
// x = hi + lo with hi = x rounded to TF32 (10 stored mantissa bits, nearest,
// ties away from zero: cvt.rna) and lo = the remainder x - hi (exact in f32),
// itself rounded to TF32.  The tensor cores read only a TF32 operand's top 19
// bits, so each part is rounded here rather than left to truncation (and the
// cvt's 13 low "don't care" bits are cleared, so that lo is exact).  a.b is
// then summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in an f32 accumulator, the
// dropped a_lo.b_lo and lo's rounding about 2^-22 of the product.  The tensor
// cores add into their accumulator with truncation (up to an ulp of the sum
// an addition, always towards zero), so the kernels keep each tensor-core sum
// short -- a stage of k, a tile of keys, the cross terms apart from or before
// hi.hi -- and add those sums with f32 additions.
__device__ __forceinline__ float tf32_round(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// ---- asynchronous copies (cp.async) -----------------------------------------
// 16 bytes through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)   // zero-fill when invalid
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes through L1 (cp.async takes 4 and 8 only with .ca)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// makes this thread's generic-proxy writes to shared memory (cp.async results
// after their wait, plain stores) visible to the async proxy that wgmma reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d[64] (D[64, 128]) = (accumulate ? d : 0) + a . B
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const unsigned (&a)[4],
                                                 unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB));
}

// d[32] (D[64, 64]) = (accumulate ? d : 0) + A . B, A [64, 16] read from
// shared memory through a descriptor as B is; K-major unless kTransA
// (kTransB): an A stored [k][m] (a B stored [k][n]) in the 128-byte swizzle
// is read MN-major, 16 rows a k-step
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], unsigned long long desc_a,
                                                   unsigned long long desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[16] (D[64, 32]) = (accumulate ? d : 0) + A . B, both K-major from shared memory
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], unsigned long long desc_a,
                                                   unsigned long long desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[8] (D[64, 16]) = (accumulate ? d : 0) + A . B, both K-major from shared memory
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], unsigned long long desc_a,
                                                   unsigned long long desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ---- mbarriers and TMA loads (sm_90) ----------------------------------------
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrives and adds `bytes` to the transactions the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// the box at (column c0, row c1) of a 2-D tensor map into shared memory, in the
// map's swizzle; rows and columns past the end arrive as zeros and count in
// the barrier's bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned long long* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// ---- host side of TMA --------------------------------------------------------
// streaming multiprocessors of the current device: persistent grids
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 1;
  }
  return count;
}

// cuTensorMapEncodeTiled lives in libcuda; the runtime's entry-point query
// reaches it, so that the library links no libcuda
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// the tensor map of a row-major [rows, cols] matrix of `elem_bytes`-byte
// elements read in boxes of [box_rows][box_cols] (zeros past the last row and
// column); the 128-byte swizzle wants box_cols * elem_bytes == 128
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                     long long rows, long long cols, int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// two floats -> one register of two bf16 (lo in the low half), round to nearest even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Four int8 of a word -> two registers of two bf16 (exact), by integer and
// FP32-pipe instructions instead of the conversion unit: byte i xor 0x80 is
// x_i + 128 in [0, 255]; put in the low mantissa of 2^23 it is the f32
// 2^23 + 128 + x_i, and subtracting 2^23 + 128 leaves x_i exactly.  An integer
// of at most 8 significant bits is its own bf16, so the f32's upper half is the
// bf16; one prmt takes the upper halves of two.  lo gets bytes 0, 1 (byte 0 in
// the low half), hi bytes 2, 3.
__device__ __forceinline__ void int8x4_to_bf16x2(unsigned word, unsigned& lo, unsigned& hi) {
  const unsigned u = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
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
// plane0 and row0 are added to a kernel's own plane and row, so that a data
// rank that holds rows of a larger batch draws the words of their place in
// it (0 and 0 on one process).  ops/philox.py computes the same words in
// plain PyTorch.
struct Drop {
  unsigned long long seed;
  unsigned c0;            // kind << 24 | site
  unsigned thresh;        // round(p * 2^32)
  float keep_div;         // 1 - p rounded to the compute type (forward divides by it)
  float keep_div32;       // 1 - p in f32 (the backward's division)
  const unsigned* bits;   // explicit bits operand (mode 2), else null
  unsigned plane0;        // the first plane's place in the whole batch (attention)
  unsigned row0;          // the first row's place in the whole batch (hidden dropout)
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
  return philox4x32_10(d.c0, plane + d.plane0, row + d.row0, col4, (unsigned)d.seed,
                       (unsigned)(d.seed >> 32));
}

// The rounds of a row's calls that do not depend on the column: with the
// counter (c0, plane, row, column / 4), round 1 (but for one xor with column /
// 4), the M0 product of round 2 and the M1 product of round 3 are the row's, so
// a kernel that makes many calls for one row takes them once (philox_row) and
// row_words(d, philox_row(d, plane, row), col4) == drop_words(d, plane, row, col4).
struct PhiloxRow {
  unsigned x1;         // round 1's third word before the xor with column / 4
  unsigned c1;         // round 1's second word
  unsigned c2, c3;     // round 2's third and fourth words
  unsigned hi3, lo3;   // round 3's M1 product of c2
};

__device__ __forceinline__ PhiloxRow philox_row(const Drop& d, unsigned plane, unsigned row) {
  const unsigned k0 = (unsigned)d.seed, k1 = (unsigned)(d.seed >> 32);
  plane += d.plane0;
  row += d.row0;
  const unsigned hi0 = __umulhi(0xD2511F53u, d.c0), lo0 = 0xD2511F53u * d.c0;
  const unsigned c0 = __umulhi(0xCD9E8D57u, row) ^ plane ^ k0;
  const unsigned c2 = __umulhi(0xD2511F53u, c0) ^ lo0 ^ (k1 + 0xBB67AE85u);
  return {hi0 ^ k1, 0xCD9E8D57u * row, c2, 0xD2511F53u * c0, __umulhi(0xCD9E8D57u, c2),
          0xCD9E8D57u * c2};
}

__device__ __forceinline__ uint4 row_words(const Drop& d, const PhiloxRow& r, unsigned col4) {
  unsigned k0 = (unsigned)d.seed + 2 * 0x9E3779B9u, k1 = (unsigned)(d.seed >> 32) + 2 * 0xBB67AE85u;
  // the rest of round 2
  const unsigned x = r.x1 ^ col4;
  unsigned c0 = __umulhi(0xCD9E8D57u, x) ^ r.c1 ^ (k0 - 0x9E3779B9u), c1 = 0xCD9E8D57u * x;
  // round 3, its M1 product the row's
  const unsigned hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
  c0 = r.hi3 ^ c1 ^ k0;
  c1 = r.lo3;
  unsigned c2 = hi0 ^ r.c3 ^ k1, c3 = lo0;
#pragma unroll
  for (int i = 3; i < 10; ++i) {
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
    const unsigned h0 = __umulhi(0xD2511F53u, c0), l0 = 0xD2511F53u * c0;
    const unsigned h1 = __umulhi(0xCD9E8D57u, c2), l1 = 0xCD9E8D57u * c2;
    const unsigned n0 = h1 ^ c1 ^ k0, n2 = h0 ^ c3 ^ k1;
    c0 = n0; c1 = l1; c2 = n2; c3 = l0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Bits of a thread's four elements of one 8-column mma accumulator tile (rows
// g and g + 8, columns col0 + 2t, + 1; col0 a multiple of 8).  kMode 1: one
// Philox call a thread -- the even thread of a pair makes row g's call, the odd
// one row g + 8's (r = philox_row of that row), and they swap the two words the
// other needs.  The whole warp must call this together.  kMode 2: read from the
// bits operand, a [planes, t, t] array; positions past t count as kept.
template <int kMode>
__device__ __forceinline__ void acc_bits(const Drop& d, const PhiloxRow& r, int plane, int t,
                                         int row_g, int col0, int lane, unsigned (&bits)[4]) {
  const int tq = lane & 3;
  if constexpr (kMode == 1) {
    const int odd = tq & 1;
    const uint4 w = row_words(d, r, (unsigned)((col0 + 2 * (tq - odd)) >> 2));
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

// x rounded to the nearest bf16, ties to even, for finite x: what
// __float2bfloat16_rn gives, by integer instructions (the conversion
// instruction's unit is the one expf's exp2 needs)
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// dropped probability in bf16, before the cast of its product's A operand: the
// normalised f32 value cast to bf16 and multiplied by inv_keep = 1 / bf16(1 - p)
// (taken once a call), which after that cast is bf16(p) / bf16(1 - p) exactly
// (attention_bwd.cu); dropped elements are zero.  The backward's keys kernel
// recomputes pd with the same arithmetic.
__device__ __forceinline__ float drop_prob_bf16(float p, bool keep, float inv_keep) {
  const float kept = round_bf16(p) * inv_keep;   // taken either way: a select, not a branch
  return keep ? kept : 0.f;
}

// ---- corpus scans (scan.cu, scan_int8.cu): spans of rows ---------------------
// max into a float in shared or device memory (holding -inf or a value), by
// the ordering of the bit patterns: as signed ints for values >= 0, reversed
// as unsigned for < 0
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  v += 0.f;                            // -0 -> +0
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// A scan's unit of work is a span of the bucket's flat [n_docs * S] rows,
// `span` rows long whatever S is (ops/scan_kernel.span_rows), so that a
// bucket of a few hundred long documents still gives every SM its share.  A
// span keeps the maxima of the documents it touches in shared memory, at
// most kSpanDocs of them; a document that straddles two spans is merged
// across them in device memory.
constexpr int kSpanDocs = 66;

struct Span {
  int row0, doc0;                      // its first row and the document that holds it
  int rows, docs;                      // its rows and the documents they touch
  int off;                             // the place of its first row in that document: row
                                       // r of the span lies in its document (off + r) / S
};

// 32-bit throughout: the launchers take at most 2^31 - 1 rows a bucket
__device__ __forceinline__ Span span_of(int unit, int span, int total_rows, int S) {
  Span sp;
  sp.row0 = unit * span;
  sp.rows = min(span, total_rows - sp.row0);
  sp.doc0 = sp.row0 / S;
  sp.off = sp.row0 - sp.doc0 * S;
  sp.docs = (sp.off + sp.rows - 1) / S + 1;
  return sp;
}

// The span's maxima docmax [docs][qg] into out [n_docs, out_cols] at columns
// col0 ..: a document wholly inside the span is stored, one that straddles
// spans is merged by an atomic max (the caller fills out with -inf first);
// each slot goes back to -inf.  Thread tid of nthreads.
__device__ __forceinline__ void flush_span(const Span& sp, int S, float* docmax, int qg,
                                           float* out, int out_cols, int col0, int tid,
                                           int nthreads) {
  for (int i = tid; i < sp.docs * qg; i += nthreads) {
    const int d = i / qg, start = d * S - sp.off;   // the document's first row in the span
    float* o = out + (size_t)(sp.doc0 + d) * out_cols + col0 + i % qg;
    if (start >= 0 && start + S <= sp.rows)
      *o = docmax[i];
    else
      atomic_max_float(o, docmax[i]);
    docmax[i] = -INFINITY;
  }
}

}  // namespace aspire
