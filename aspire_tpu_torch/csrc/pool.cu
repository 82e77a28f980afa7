// Per-sentence token sums: out[b, s, :] = sum over tokens t with
// sent_ids[b, t] == s of hidden[b, t, :], in f32, added in t order.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_pool.py
// (_pool_kernel), which multiplies a one-hot [S, T] matrix built on chip by the
// hidden block.  Here the one-hot matrix is never formed: a block owns one
// example and a slice of 128 columns, keeps a [max_sents, 128] f32 tile in
// shared memory, walks the tokens in order and adds each token's slice into the
// row its sentence id names.  Ids need not come in runs; ids outside
// [0, max_sents) (-1 marks "no sentence") add nowhere.  A column's sums are made
// by one thread in token order, so the result does not depend on the launch.
// Device memory bounds the work (one read of hidden, one small write); the loop
// over t is serial in each thread, so the loads are started eight tokens ahead.
// Counts and the division stay outside, as on the TPU.
#include "common.cuh"

namespace {

using namespace aspire;

constexpr int kThreads = 64;          // two neighbouring columns a thread
constexpr int kCols = 2 * kThreads;
constexpr int kAhead = 8;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// hidden: [b, t, h] contiguous, h even; sent_ids: [b, t]; out: [b, max_sents, h]
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ hidden, const int* __restrict__ sent_ids,
            float* __restrict__ out, int t, int h, int max_sents) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tile = reinterpret_cast<float2*>(smem);                      // [max_sents][kThreads]
  int* ids = reinterpret_cast<int*>(tile + (size_t)max_sents * kThreads);   // [t]
  const int ex = blockIdx.x, tx = threadIdx.x;
  const int col = blockIdx.y * kCols + 2 * tx;
  for (int i = tx; i < t; i += kThreads) ids[i] = sent_ids[(size_t)ex * t + i];
  for (int s = 0; s < max_sents; ++s) tile[s * kThreads + tx] = make_float2(0.f, 0.f);
  __syncthreads();
  if (col >= h) return;
  const T* src = hidden + (size_t)ex * t * h + col;
  for (int t0 = 0; t0 < t; t0 += kAhead) {
    float2 v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      v[j] = t0 + j < t ? load2(src + (size_t)(t0 + j) * h) : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = t0 + j < t ? ids[t0 + j] : -1;
      if (s >= 0 && s < max_sents) {
        float2 acc = tile[s * kThreads + tx];
        acc.x += v[j].x;
        acc.y += v[j].y;
        tile[s * kThreads + tx] = acc;
      }
    }
  }
  float* dst = out + (size_t)ex * max_sents * h + col;
  for (int s = 0; s < max_sents; ++s)
    *reinterpret_cast<float2*>(dst + (size_t)s * h) = tile[s * kThreads + tx];
}

template <typename T>
int launch(const void* hidden, const void* sent_ids, void* out, int b, int t, int h,
           int max_sents, void* stream) {
  const size_t smem = (size_t)max_sents * kThreads * sizeof(float2) + (size_t)t * sizeof(int);
  if (b < 1 || t < 1 || h < 2 || h % 2 != 0 || max_sents < 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b, (h + kCols - 1) / kCols);
  pool_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)hidden, (const int*)sent_ids, (float*)out, t, h, max_sents);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aspire_pool_bf16(const void* hidden, const void* sent_ids, void* out, int b, int t,
                                int h, int max_sents, void* stream) {
  return launch<__nv_bfloat16>(hidden, sent_ids, out, b, t, h, max_sents, stream);
}

extern "C" int aspire_pool_f32(const void* hidden, const void* sent_ids, void* out, int b, int t,
                               int h, int max_sents, void* stream) {
  return launch<float>(hidden, sent_ids, out, b, t, h, max_sents, stream);
}
