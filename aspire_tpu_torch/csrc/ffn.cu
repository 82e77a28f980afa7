// Fused FFN forward: gelu_erf(x.W1 + b1).W2 + b2, the [rows, inter]
// intermediate never written to device memory.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_ffn.py (_fwd_kernel).
// A block owns 32 rows and all 768 output columns: the [32, 768] f32
// accumulator lives in registers (96 a thread in the 256 math threads).  The
// intermediate axis is walked in chunks of 64: pre = x_blk.W1[:, chunk] + b1
// in f32, exact (erf) gelu in f32, cast to the compute type, then
// acc += h.W2[chunk, :].  Rows past the end are masked, not padded.
//
// The weights are re-read by every row block; they fit the L2 cache, and what
// a block waits for is the latency of those reads.  So the weight tiles of a
// chunk (first the k-tiles of W1[:, chunk], then the row pieces of
// W2[chunk, :]) form one stream of stages that runs through a ring of four
// shared-memory slots filled by cp.async, three stages ahead of the math.
// Two extra warps do nothing but issue those copies, so that a copy waiting
// for the load unit never holds up a warp that has math to issue.
//
// bf16 runs both products on the tensor cores (mma.sync m16n8k16 fed by
// ldmatrix, f32 accumulate); f32 runs them as plain FMAs so that the result is
// true f32.
#include <cuda_pipeline.h>
#include <math.h>

#include "common.cuh"

namespace {

using aspire::copy16;
using aspire::frag_addr;
using aspire::ldmatrix_x4;
using aspire::ldmatrix_x4_trans;
using aspire::mma_bf16_16816;
using aspire::pack_bf16;
using aspire::to_float;

constexpr int kHid = 768;      // model width (compile time: sizes the register accumulator)
constexpr int kBm = 32;        // rows per block
constexpr int kFc = 64;        // chunk of the intermediate axis
constexpr int kConsumers = 256;   // warps that do the math
constexpr int kProducers = 64;    // warps that only keep the weight loads in flight
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 4;     // ring slots; loads run kStages - 1 stages ahead (six measured no faster)
constexpr int kLdX = kHid + 8;     // x block rows; also W2 piece rows
constexpr int kLdW1 = kFc + 8;     // W1 tile rows; also the activation rows
constexpr int kLdOut = kHid + 4;   // f32 staging rows for the store

// Stage sizes by type, chosen so that a ring slot is 24832 bytes for both.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kt = 128;   // k-rows of W1 per stage of the first product
  static constexpr int pk = 16;    // k-rows of W2 per stage of the second product
};
template <> struct Cfg<float> {
  static constexpr int kt = 64;
  static constexpr int pk = 8;
};

// elements of one ring slot: room for a W1 tile or a W2 piece, whichever is larger
template <typename T>
struct Slot {
  static constexpr int elems =
      Cfg<T>::kt * kLdW1 > Cfg<T>::pk * kLdX ? Cfg<T>::kt * kLdW1 : Cfg<T>::pk * kLdX;
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(kBm * kLdX + kBm * kLdW1 + kStages * Slot<T>::elems) * sizeof(T);
}
static_assert(smem_bytes<__nv_bfloat16>() >= (size_t)kBm * kLdOut * sizeof(float),
              "the bf16 store stages a [32, 772] f32 tile over the whole buffer");
static_assert(smem_bytes<float>() <= 232448, "shared memory of one block");

// asynchronous copy of kRows rows of kCols elements (pitch src_ld -> kDstLd), by the producers
template <typename T, int kRows, int kCols, int kDstLd>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, long long src_ld) {
  constexpr int vec = 16 / sizeof(T), per_row = kCols / vec;
#pragma unroll
  for (int idx = threadIdx.x - kConsumers; idx < kRows * per_row; idx += kProducers) {
    const int r = idx / per_row, cv = (idx % per_row) * vec;
    __pipeline_memcpy_async(dst + r * kDstLd + cv, src + r * src_ld + cv, 16);
  }
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// The two products of one block, by type.  `first` adds one k-tile of W1 to
// the chunk's pre-activation, `activate` turns it into the activation in
// shared memory, `second` adds one row piece of W2 to the output accumulator.
template <typename T> struct Math;

template <> struct Math<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int kt = Cfg<bf16>::kt, pk = Cfg<bf16>::pk;
  // Tensor cores through mma.sync m16n8k16, operands through ldmatrix (see common.cuh
  // for the fragment layouts; with g = lane / 4, t = lane % 4 an accumulator holds
  // (row g, cols 2t, 2t+1) and (row g + 8, same cols) of its 16 x 8 tile).
  // first product: warp (wr, wc) owns rows 16 wr.., columns 16 wc.. of the [32, 64] chunk;
  // second: warp owns output columns [96 * warp, 96 * warp + 96), both 16-row tiles
  float pacc[2][4];
  float oacc[2][12][4];
  int warp, lane, wr, wc;

  __device__ void init() {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wr = warp >> 2;
    wc = warp & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][j][e] = 0.f;
  }
  __device__ void first(int s, const bf16* xs, const bf16* tile) {
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kt / 16; ++kk) {
      unsigned a[4], b[4];             // the tile is [k][n]: transposed on load
      ldmatrix_x4(a, frag_addr(xs + wr * 16 * kLdX + s * kt + kk * 16, kLdX, lane, true));
      ldmatrix_x4_trans(b, frag_addr(tile + kk * 16 * kLdW1 + wc * 16, kLdW1, lane, true));
      mma_bf16_16816(pacc[0], a, b[0], b[1]);
      mma_bf16_16816(pacc[1], a, b[2], b[3]);
    }
  }
  // bias, gelu and the cast run on the accumulator registers; the activation goes to
  // shared memory as the A operand of the second product
  __device__ void activate(const bf16* b1c, bf16* hs) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = wc * 16 + nt * 8 + 2 * t, row = wr * 16 + g;
      const float bias0 = to_float(b1c[col]), bias1 = to_float(b1c[col + 1]);
      *reinterpret_cast<unsigned*>(hs + row * kLdW1 + col) =
          pack_bf16(gelu_erf(pacc[nt][0] + bias0), gelu_erf(pacc[nt][1] + bias1));
      *reinterpret_cast<unsigned*>(hs + (row + 8) * kLdW1 + col) =
          pack_bf16(gelu_erf(pacc[nt][2] + bias0), gelu_erf(pacc[nt][3] + bias1));
    }
  }
  __device__ void second(int p, const bf16* hs, const bf16* piece) {
    static_assert(pk == 16, "one mma k-step per piece");
    unsigned a0[4], a1[4];
    ldmatrix_x4(a0, frag_addr(hs + p * pk, kLdW1, lane, true));
    ldmatrix_x4(a1, frag_addr(hs + 16 * kLdW1 + p * pk, kLdW1, lane, true));
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      unsigned b[4];
      ldmatrix_x4_trans(b, frag_addr(piece + warp * 96 + j * 16, kLdX, lane, true));
      mma_bf16_16816(oacc[0][2 * j], a0, b[0], b[1]);
      mma_bf16_16816(oacc[0][2 * j + 1], a0, b[2], b[3]);
      mma_bf16_16816(oacc[1][2 * j], a1, b[0], b[1]);
      mma_bf16_16816(oacc[1][2 * j + 1], a1, b[2], b[3]);
    }
  }
  // stage the f32 tile over the (now dead) buffers, then bias, cast and store rows
  __device__ void stage_out(float* stage) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        float* dst = stage + (i * 16 + g) * kLdOut + warp * 96 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(oacc[i][j][0], oacc[i][j][1]);
        *reinterpret_cast<float2*>(dst + 8 * kLdOut) = make_float2(oacc[i][j][2], oacc[i][j][3]);
      }
  }
  static __device__ void store(bf16* out, const bf16* b2, int row0, int valid, const float* stage) {
    constexpr int vec = 8, per_row = kHid / vec;
    for (int idx = threadIdx.x; idx < kBm * per_row; idx += kThreads) {
      const int r = idx / per_row, cv = (idx % per_row) * vec;
      if (r >= valid) continue;
      __align__(16) bf16 vals[vec];
#pragma unroll
      for (int e = 0; e < vec; ++e)
        vals[e] = __float2bfloat16_rn(stage[r * kLdOut + cv + e] + to_float(b2[cv + e]));
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * kHid + cv) =
          *reinterpret_cast<const uint4*>(vals);
    }
  }
};

template <> struct Math<float> {
  static constexpr int kt = Cfg<float>::kt, pk = Cfg<float>::pk;
  // thread (ty, tx): rows 8 * ty .. 8 * ty + 7; column tx of a chunk for the first
  // product, columns tx + 64 * j of the output for the second.  A warp has one ty, so
  // its reads of x and of the activation are broadcasts.
  float pacc[8];
  float oacc[8][12];
  int ty, tx;

  __device__ void init() {
    ty = threadIdx.x >> 6;
    tx = threadIdx.x & 63;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 12; ++j) oacc[r][j] = 0.f;
  }
  __device__ void first(int s, const float* xs, const float* tile) {
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) pacc[r] = 0.f;
    }
    for (int kk = 0; kk < kt; ++kk) {
      const float w = tile[kk * kLdW1 + tx];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        pacc[r] = fmaf(xs[(ty * 8 + r) * kLdX + s * kt + kk], w, pacc[r]);
    }
  }
  __device__ void activate(const float* b1c, float* hs) {
    const float bias1 = b1c[tx];
#pragma unroll
    for (int r = 0; r < 8; ++r) hs[(ty * 8 + r) * kLdW1 + tx] = gelu_erf(pacc[r] + bias1);
  }
  __device__ void second(int p, const float* hs, const float* piece) {
    for (int kk = 0; kk < pk; ++kk) {
      float hv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) hv[r] = hs[(ty * 8 + r) * kLdW1 + p * pk + kk];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float w = piece[kk * kLdX + tx + 64 * j];
#pragma unroll
        for (int r = 0; r < 8; ++r) oacc[r][j] = fmaf(hv[r], w, oacc[r][j]);
      }
    }
  }
  __device__ void stage_out(float*) {}
  __device__ void store(float* out, const float* b2, int row0, int valid, const float*) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (ty * 8 + r >= valid) continue;
#pragma unroll
      for (int j = 0; j < 12; ++j)
        out[(long long)(row0 + ty * 8 + r) * kHid + tx + 64 * j] = oacc[r][j] + b2[tx + 64 * j];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
           const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int rows,
           int inter) {
  constexpr int kt = Cfg<T>::kt, pk = Cfg<T>::pk;
  constexpr int s1 = kHid / kt, s2 = kFc / pk, per_chunk = s1 + s2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);          // [32][kLdX]
  T* hs = xs + kBm * kLdX;                         // [32][kLdW1] activation, compute type
  T* ring = hs + kBm * kLdW1;                      // [kStages][slot]

  const int row0 = blockIdx.x * kBm;
  const int valid = min(kBm, rows - row0);
  {
    constexpr int vec = 16 / sizeof(T), per_row = kHid / vec;
    for (int idx = threadIdx.x; idx < kBm * per_row; idx += kThreads) {
      const int r = idx / per_row, cv = (idx % per_row) * vec;
      copy16(xs + r * kLdX + cv, x + (long long)(row0 + r) * kHid + cv, r < valid);
    }
  }

  const int total = (inter / kFc) * per_chunk;
  const bool producer = threadIdx.x >= kConsumers;
  // stage g: chunk g / per_chunk; its first s1 stages are k-tiles of W1, the rest pieces of W2
  auto fetch = [&](int g) {
    if (g < total && producer) {
      const int chunk = g / per_chunk, s = g % per_chunk;
      T* slot = ring + (g % kStages) * Slot<T>::elems;
      if (s < s1)
        load_rows_async<T, kt, kFc, kLdW1>(
            slot, w1 + (long long)(s * kt) * inter + chunk * kFc, inter);
      else
        load_rows_async<T, pk, kHid, kLdX>(
            slot, w2 + (long long)(chunk * kFc + (s - s1) * pk) * kHid, kHid);
    }
    __pipeline_commit();               // an empty group past the end keeps the count uniform
  };

  Math<T> math;
  if (!producer) math.init();
  for (int g = 0; g < kStages - 1; ++g) fetch(g);
  for (int g = 0; g < total; ++g) {
    __pipeline_wait_prior(kStages - 2);   // a producer's part of stage g has landed
    __syncthreads();                      // ... everyone's has, and stage g - 1 is no longer read
    fetch(g + kStages - 1);               // refills the slot of stage g - 1
    if (producer) continue;
    const int chunk = g / per_chunk, s = g % per_chunk;
    const T* slot = ring + (g % kStages) * Slot<T>::elems;
    if (s < s1) {
      math.first(s, xs, slot);
      if (s == s1 - 1) math.activate(b1 + chunk * kFc, hs);
    } else {
      math.second(s - s1, hs, slot);
    }
  }
  // stage the f32 tile over the (now dead) buffers, then bias, cast and store rows
  float* stage = reinterpret_cast<float*>(smem_raw);
  __syncthreads();
  if (!producer) math.stage_out(stage);
  __syncthreads();
  if constexpr (sizeof(T) == 2) {
    Math<T>::store(out, b2, row0, valid, stage);
  } else {
    if (!producer) math.store(out, b2, row0, valid, stage);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int rows, int hidden, int inter, void* stream) {
  if (hidden != kHid || inter < kFc || inter % kFc || rows < 1) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T>();
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kBm - 1) / kBm;
  ffn_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2, (T*)out, rows, inter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aspire_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int rows, int hidden, int inter,
                               void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, rows, hidden, inter, stream);
}

extern "C" int aspire_ffn_f32(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int rows, int hidden, int inter,
                              void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, rows, hidden, inter, stream);
}
