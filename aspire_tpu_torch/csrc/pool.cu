// Per-sentence token sums: out[b, s, :] = sum over tokens t with
// sent_ids[b, t] == s of hidden[b, t, :], in f32.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_pool.py
// (_pool_kernel), which multiplies a one-hot [S, T] matrix built on chip by the
// hidden block.  Here the one-hot matrix is never formed.  Device memory bounds
// the work: one read of hidden (25 MB at the encode shape [64, 256, 768] bf16),
// one write of [b, S, h] f32.  So the design is about bytes in flight.
//
// A block owns one example, a slice of 32 * kVec columns (a lane loads kVec
// neighbouring columns of a token, 16 bytes where the width allows) and a tile
// of `stile` sentences.  Its four warps split the tokens into four contiguous
// chunks of C = ceil(t / 4); each warp starts the loads of 16 tokens at once.
// A warp keeps the running sum of the current run of equal ids in registers
// and adds it into its own [stile, cols] f32 partial in shared memory only
// when the id changes.  The id is the same across the warp, so the branch is
// uniform.  Ids need not come in runs; ids outside [0, max_sents) add nowhere.
// When all four warps are done the partials are merged in warp order and
// written once.  Sentences past one tile go to further blocks (grid z), each
// reading the example again, so no count of tokens or sentences is refused.
//
// The order of the f32 additions, which the result depends on and which
// ops/pool_kernel.py's tests model in PyTorch:
//   run      = ((x_i + x_i+1) + ...) over a run of equal ids within a chunk,
//              in token order;
//   partial  = ((0 + run_1) + run_2) + ... over the runs of one sentence in
//              one chunk, in token order;
//   out      = ((partial_0 + partial_1) + partial_2) + partial_3.
// It does not depend on the launch: two launches give the same bits.  Counts
// and the division stay outside, as on the TPU.
#include <limits.h>

#include "common.cuh"

namespace {

using namespace aspire;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kAhead = 16;            // tokens a warp loads at once

// kWords 32-bit words of one lane's columns of one token
template <int kWords>
__device__ __forceinline__ void load_words(unsigned (&w)[kWords], const void* p) {
  if constexpr (kWords == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

// the words as kVec floats (a bf16 is the upper half of its f32)
template <typename T, int kVec, int kWords>
__device__ __forceinline__ void to_float(const unsigned (&w)[kWords], float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 2) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      v[i] = __uint_as_float(w[i]);
    }
  }
}

// hidden: [b, t, h] contiguous, h % kVec == 0; sent_ids: [b, t];
// out: [b, max_sents, h]; shared memory: [kWarps][stile][32 kVec] f32
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const T* __restrict__ hidden, const int* __restrict__ sent_ids,
            float* __restrict__ out, int t, int h, int max_sents, int stile) {
  constexpr int kCols = 32 * kVec;
  constexpr int kWords = kVec * (int)sizeof(T) / 4;
  extern __shared__ __align__(16) float part[];
  const int ex = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kCols, s0 = blockIdx.z * stile;
  const int sn = min(stile, max_sents - s0);
  float* mine = part + (size_t)warp * stile * kCols;
  for (int i = lane; i < sn * kCols / 2; i += 32)
    reinterpret_cast<float2*>(mine)[i] = make_float2(0.f, 0.f);
  __syncwarp();

  const int chunk = (t + kWarps - 1) / kWarps;
  const int tb = min(t, warp * chunk), te = min(t, tb + chunk);
  const int col = col0 + lane * kVec;
  const bool live = col < h;
  const T* src = hidden + (size_t)ex * t * h + col;
  const int* ids = sent_ids + (size_t)ex * t;
  float* row = mine + lane * kVec;
  int cur = INT_MIN;                  // the current run's id; INT_MIN: none yet
  float sum[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) sum[i] = 0.f;
  auto flush = [&]() {
    if (cur >= s0 && cur < s0 + sn && live) {
      float* p = row + (size_t)(cur - s0) * kCols;
#pragma unroll
      for (int i = 0; i < kVec; i += 2) {
        float2 a = *reinterpret_cast<float2*>(p + i);
        a.x += sum[i];
        a.y += sum[i + 1];
        *reinterpret_cast<float2*>(p + i) = a;
      }
    }
  };
  for (int t0 = tb; t0 < te; t0 += kAhead) {
    unsigned w[kAhead][kWords];
    int id[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool in = t0 + j < te;
      id[j] = in ? ids[t0 + j] : INT_MIN;
      if (in && live) {
        load_words(w[j], src + (size_t)(t0 + j) * h);
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) w[j][i] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j < te) {
        float v[kVec];
        to_float<T, kVec>(w[j], v);
        if (id[j] != cur) {
          flush();
          cur = id[j];
#pragma unroll
          for (int i = 0; i < kVec; ++i) sum[i] = v[i];
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) sum[i] += v[i];
        }
      }
    }
  }
  flush();
  __syncthreads();

  // merge the four partials in warp order; two columns a step
  const size_t warp_stride = (size_t)stile * kCols;
  for (int i = threadIdx.x; i < sn * kCols / 2; i += kThreads) {
    const int s = i / (kCols / 2), c = (i % (kCols / 2)) * 2;
    if (col0 + c >= h) continue;
    const float* p = part + (size_t)s * kCols + c;
    float2 acc = *reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 b = *reinterpret_cast<const float2*>(p + w * warp_stride);
      acc.x += b.x;
      acc.y += b.y;
    }
    *reinterpret_cast<float2*>(out + ((size_t)ex * max_sents + s0 + s) * h + col0 + c) = acc;
  }
}

template <typename T, int kVec>
int launch_vec(const void* hidden, const void* sent_ids, void* out, int b, int t, int h,
               int max_sents, int stile, cudaStream_t stream) {
  constexpr int kCols = 32 * kVec;
  const size_t smem = (size_t)kWarps * stile * kCols * sizeof(float);
  if (smem > 227 * 1024 || h % kVec != 0 || (size_t)hidden % (kVec * sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long col_blocks = (h + kCols - 1) / kCols;
  const long long s_blocks = (max_sents + stile - 1) / stile;
  if (col_blocks > 65535 || s_blocks > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = pool_kernel<T, kVec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, (unsigned)col_blocks, (unsigned)s_blocks);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)hidden, (const int*)sent_ids, (float*)out,
                                           t, h, max_sents, stile);
  return (int)cudaGetLastError();
}

// vec: columns a lane loads (bf16: 8 or 2; f32: 4 or 2); stile: sentences a
// block (ops/pool_kernel.py plans both)
template <typename T>
int launch(const void* hidden, const void* sent_ids, void* out, int b, int t, int h,
           int max_sents, int vec, int stile, void* stream) {
  if (b < 1 || t < 1 || h < 2 || h % 2 != 0 || max_sents < 1 || stile < 1 || stile > max_sents)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 2)
    return launch_vec<T, 2>(hidden, sent_ids, out, b, t, h, max_sents, stile, s);
  constexpr int kWide = (int)(16 / sizeof(T));
  if (vec == kWide)
    return launch_vec<T, kWide>(hidden, sent_ids, out, b, t, h, max_sents, stile, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int aspire_pool_bf16(const void* hidden, const void* sent_ids, void* out, int b, int t,
                                int h, int max_sents, int vec, int stile, void* stream) {
  return launch<__nv_bfloat16>(hidden, sent_ids, out, b, t, h, max_sents, vec, stile, stream);
}

extern "C" int aspire_pool_f32(const void* hidden, const void* sent_ids, void* out, int b, int t,
                               int h, int max_sents, int vec, int stile, void* stream) {
  return launch<float>(hidden, sent_ids, out, b, t, h, max_sents, vec, stile, stream);
}
