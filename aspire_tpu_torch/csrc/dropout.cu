// Hidden dropout: out = keep ? x * (1 / (1 - p)) : 0, the mask made in the
// kernel.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_dropout.py
// (_apply_kernel).  The same pass serves forward (on x) and backward (on the
// cotangent): nothing mask-shaped is stored between them, the backward makes
// the same bits again from (seed, site, row, column).  Device memory bounds it:
// one read and one write of the tensor, so every thread moves 16 bytes at a
// time and makes one Philox call per four elements (common.cuh).  The factor
// 1 / (1 - p) is rounded to x's type and multiplied, not divided by.  Mode 2
// reads the bits from an operand of x's shape instead.
#include "common.cuh"

namespace {

using namespace aspire;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float scaled(float x, float scale) { return x * scale; }
__device__ __forceinline__ __nv_bfloat16 scaled(__nv_bfloat16 x, float scale) {
  return __float2bfloat16_rn(__bfloat162float(x) * scale);
}

// x, out: [rows, h] contiguous, h a multiple of the vector width
template <typename T, int kMode>
__global__ void __launch_bounds__(256)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n_vec, int h, float scale,
               Drop drop) {
  constexpr int n = Vec<T>::n;
  const T zero = T(0.f);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e0 = i * n;
    const unsigned row = (unsigned)(e0 / h), col = (unsigned)(e0 % h);
    alignas(16) T v[n];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + e0);
#pragma unroll
    for (int part = 0; part < n / 4; ++part) {
      uint4 w;
      if constexpr (kMode == 1) {
        w = drop_words(drop, 0u, row, col / 4 + part);
      } else {
        w = *reinterpret_cast<const uint4*>(drop.bits + e0 + 4 * part);
      }
      const unsigned bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * part + j] = bits[j] >= drop.thresh ? scaled(v[4 * part + j], scale) : zero;
    }
    *reinterpret_cast<uint4*>(out + e0) = *reinterpret_cast<const uint4*>(v);
  }
}

template <typename T>
int launch(const void* x, void* out, long long rows, int h, int mode, float scale,
           const Drop& drop, void* stream) {
  constexpr int n = Vec<T>::n;
  if (rows < 1 || h < 1 || h % n != 0 || rows + drop.row0 > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  const long long n_vec = rows * (h / n);
  const long long want = (n_vec + 255) / 256;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  if (mode == 1)
    dropout_kernel<T, 1><<<blocks, 256, 0, (cudaStream_t)stream>>>((const T*)x, (T*)out, n_vec, h,
                                                                    scale, drop);
  else if (mode == 2 && drop.bits != nullptr)
    dropout_kernel<T, 2><<<blocks, 256, 0, (cudaStream_t)stream>>>((const T*)x, (T*)out, n_vec, h,
                                                                    scale, drop);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 1 Philox bits from (seed, c0), 2 bits from the operand ([rows, h] uint32);
// row0: the place of row 0 in the whole batch (its Philox counter)
#define ASPIRE_DROPOUT(NAME, T)                                                                \
  extern "C" int NAME(const void* x, void* out, const void* bits, long long rows, int h,       \
                      int mode, unsigned long long seed, unsigned c0, unsigned thresh,         \
                      unsigned row0, float scale, void* stream) {                              \
    const Drop drop = {seed, c0, thresh, 0.f, 0.f, (const unsigned*)bits, 0u, row0};           \
    return launch<T>(x, out, rows, h, mode, scale, drop, stream);                              \
  }

ASPIRE_DROPOUT(aspire_dropout_bf16, __nv_bfloat16)
ASPIRE_DROPOUT(aspire_dropout_f32, float)
