// FFN forward: out = gelu_erf(x.W1 + b1).W2 + b2, as two launches of one
// tiled product with two epilogues:
//
//   launch 1   H = bf16(gelu_erf(x.W1 + b1))     [rows, inter]
//   launch 2   out = bf16(H.W2 + b2)             [rows, hidden]
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_ffn.py (_fwd_kernel),
// which keeps the intermediate in fast memory.  Here it goes through device
// memory once, in the compute type: at 4096 rows x 3072 that is 25 MB written
// and read again (0.015 ms at the byte rate, and much of it stays in the 50 MB
// L2), against the 38.7 GFLOP of the two products (0.039 ms on the bf16 tensor
// cores), which bound it.  The rounding is the fused kernel's: f32
// pre-activation, exact erf gelu in f32, the activation rounded to x's type
// before the second product, f32 accumulation, biases added in f32.
//
// Why not one fused kernel on this card: wgmma works on 64-row tiles, so a
// block that owned its rows' whole [64, 768] output would hold 384 f32
// accumulators a thread in one warpgroup, and 4096 rows would give only 64
// blocks for 132 SMs.  Two launches of a plain tiled product fill the card.
//
// The product (ffn_bf16_kernel): C[M, N] = A[M, K] . B[N, K]^T, both operands
// K-major -- x or H by rows, the weights in nn.Linear's [out, in] layout.  A
// block computes [128, kBn] tiles of C: two consumer warpgroups of 64 rows run
// wgmma m64nNk16 with A and B read from shared memory through descriptors, and
// one producer warp keeps a ring of [128][64] A and [kBn][64] B stages full
// with TMA loads (128-byte swizzle, rows past the end arrive as zeros), each
// stage guarded by a full and an empty mbarrier, so no block-wide barrier
// stands in the loop.  The grid is persistent: a block walks its tiles and the
// producer runs on into the next tile while the consumers do the epilogue
// (bias, exact gelu, cast, stores straight from the accumulator registers;
// rows and columns past the end masked).  M is any count; N and K multiples of
// 64 (the wrapper pads other widths with zeros, which is exact).
//
// Tiles, chosen on the H100 at 4096 and 16384 rows of 768 -> 3072 -> 768
// (PERF.md): launch 1 (K = 768, an epilogue of 12.6 M erf) 128 x 128
// with three stages and two blocks an SM, so that one block's epilogue runs
// beside the other's products; launch 2 (K = 3072) 128 x 192 with five stages,
// one block an SM: 4 x 32 tiles at 4096 rows fill the 132 SMs once.  A first
// design fed by cp.async from every thread with a block barrier a stage read
// 0.146 ms at 4096 rows; this one 0.091 ms.
//
// f32 (a check path: serving and training run bf16) takes the same two
// launches with a plain FMA tile product, 64 x 64 a block, true f32.
#include <math.h>

#include "common.cuh"

namespace {

using namespace aspire;
using bf16 = __nv_bfloat16;

constexpr int kBk = 64;                  // k a stage: one 128-byte swizzled row

// A block's tile and pipeline: two consumer warpgroups of 64 rows each over
// kBn columns and one producer warp, a ring of kStages stages, kOcc blocks an SM
template <int kBn_, int kStages_, int kOcc_ = 1>
struct Tile {
  static constexpr int kWgM = 2, kBn = kBn_, kStages = kStages_, kOcc = kOcc_;
  static constexpr int kBm = 64 * kWgM, kThreads = 128 * kWgM + 32;
  static constexpr int kTileA = kBm * kBk, kTileB = kBn * kBk;   // elements
  static constexpr unsigned kStageBytes = (kTileA + kTileB) * sizeof(__nv_bfloat16);
  // + 1 KB so that the ring can start on a 1024-byte boundary (the swizzle's
  // unit), then a full and an empty barrier a stage
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
  static_assert(kSmem * kOcc <= 233472 - 1024 * kOcc, "shared memory of an SM");
  static_assert(kTileA * 2 % 1024 == 0 && kTileB * 2 % 1024 == 0, "1024-byte aligned tiles");
};
// the tiles of the two launches
using Launch1 = Tile<128, 3, 2>;
using Launch2 = Tile<192, 5>;

enum Epilogue { kGelu = 0, kBias = 1 };

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// D[64, N] += A[64, 16] . B[16, N], A and B read from shared memory through
// descriptors, both K-major; D in the mma.sync layouts of common.cuh, N / 2
// floats a thread
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], unsigned long long desc_a,
                                         unsigned long long desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], unsigned long long desc_a,
                                            unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], unsigned long long desc_a,
                                            unsigned long long desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// C[M, N] = epilogue(A[M, K] . B[N, K]^T + bias), A and B read by TMA through
// their tensor maps (boxes of [kBm][64] and [kBn][64]).  Persistent: block b
// computes tiles b, b + gridDim.x, ... (column tiles fastest), and the producer
// runs on into the next tile's stages while the consumers finish a tile.
template <int kEpi, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kOcc)
ffn_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const bf16* __restrict__ bias,
                bf16* __restrict__ c_mat, int m, int n, int k) {
  constexpr int kBm = Cfg::kBm, kBn = Cfg::kBn, kStages = Cfg::kStages, kWgM = Cfg::kWgM;
  constexpr int kSlot = Cfg::kTileA + Cfg::kTileB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024);
  // stage s: the A tile at ring + s kSlot, the B tile after it
  auto* full = reinterpret_cast<unsigned long long*>(ring + kStages * kSlot);
  unsigned long long* empty = full + kStages;
  const int ktiles = k / kBk, col_tiles = (n + kBn - 1) / kBn;
  const int tiles = col_tiles * ((m + kBm - 1) / kBm);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);            // the producer's arrival, plus the tile bytes
      mbar_init(empty + s, 4 * kWgM);    // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // g counts the stages this block has gone through, over all its tiles:
  // slot g % kStages, barrier phase (g / kStages) % 2
  if (wg == kWgM) {                      // the producer warp: one thread issues the loads
    if (threadIdx.x == kWgM * 128) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / col_tiles * kBm, col0 = tile % col_tiles * kBn;
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + s, (g / kStages - 1) & 1);
          mbar_expect_tx(full + s, Cfg::kStageBytes);
          bf16* slot = ring + s * kSlot;
          tma_load(slot, &map_a, full + s, kt * kBk, row0);
          tma_load(slot + Cfg::kTileA, &map_b, full + s, kt * kBk, col0);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float acc[kBn / 2];
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / col_tiles * kBm, col0 = tile % col_tiles * kBn;
#pragma unroll
    for (int i = 0; i < kBn / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      const int s = g % kStages;
      mbar_wait(full + s, (g / kStages) & 1);
      const bf16* a_tile = ring + s * kSlot + wg * 64 * kBk;
      const bf16* b_tile = ring + s * kSlot + Cfg::kTileA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)   // a k-step is 32 bytes along the swizzled rows
        wgmma_ss<kBn>(acc, sw128_desc(a_tile + kk * 16), sw128_desc(b_tile + kk * 16));
      wgmma_commit();
      wgmma_wait<1>();                   // stage g - 1's products are done: free its slot
      if (kt > 0 && lane == 0) mbar_arrive(empty + (g - 1) % kStages);
    }
    wgmma_wait<0>();
    wgmma_hold(acc);
    if (lane == 0) mbar_arrive(empty + (g - 1) % kStages);   // the tile's last stage

    // thread (warp w of the warpgroup, lane q * 4 + t) holds rows q and q + 8 of
    // the warp's 16 at columns 8 j + 2 t, + 1 (acc[4 j + 0..3])
    const int row = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col >= n) continue;            // n is even: col + 1 < n as well
      const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                    acc[4 * j + 3] + b1};
      if constexpr (kEpi == kGelu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = gelu_erf(v[i]);
      }
      if (row < m)
        *reinterpret_cast<unsigned*>(c_mat + (size_t)row * n + col) = pack_bf16(v[0], v[1]);
      if (row + 8 < m)
        *reinterpret_cast<unsigned*>(c_mat + (size_t)(row + 8) * n + col) = pack_bf16(v[2], v[3]);
    }
  }
}

// f32: C[M, N] = A[M, K] . B[N, K]^T by FMAs, a 64 x 64 tile a block, 4 x 4 a thread
constexpr int kFt = 64, kFk = 16, kThreads = 256;

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ a_mat, const float* __restrict__ b_mat,
                const float* __restrict__ bias, float* __restrict__ c_mat, int m, int n, int k) {
  __shared__ float as[kFk][kFt + 4];     // [k][row]
  __shared__ float bs[kFk][kFt + 4];     // [k][column]
  const int row0 = blockIdx.y * kFt, col0 = blockIdx.x * kFt;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kFk) {
    for (int i = threadIdx.x; i < kFt * kFk; i += kThreads) {
      const int r = i / kFk, kk = i % kFk;
      as[kk][r] = row0 + r < m ? a_mat[(size_t)(row0 + r) * k + k0 + kk] : 0.f;
      bs[kk][r] = col0 + r < n ? b_mat[(size_t)(col0 + r) * k + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFk; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty * 4 + i];
        bv[i] = bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= n) continue;
      float v = acc[i][j] + bias[col];
      if constexpr (kEpi == kGelu) v = gelu_erf(v);
      c_mat[(size_t)row * n + col] = v;
    }
  }
}

template <typename T>
struct Gemm;

template <>
struct Gemm<bf16> {
  template <int kEpi, class Cfg>
  static cudaError_t run(const bf16* a, const bf16* b, const bf16* bias, bf16* c, int m, int n,
                         int k, cudaStream_t stream) {
    CUtensorMap map_a, map_b;
    if (!make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, m, k, Cfg::kBm, kBk,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, n, k, Cfg::kBn, kBk,
                  CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    // above 48 KB of dynamic shared memory a kernel has to opt in
    cudaError_t err = cudaFuncSetAttribute(ffn_bf16_kernel<kEpi, Cfg>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Cfg::kSmem);
    if (err != cudaSuccess) return err;
    const long long tiles =
        (long long)((n + Cfg::kBn - 1) / Cfg::kBn) * ((m + Cfg::kBm - 1) / Cfg::kBm);
    const int slots = sm_count() * Cfg::kOcc;
    const int grid = (int)(tiles < slots ? tiles : slots);
    ffn_bf16_kernel<kEpi, Cfg><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(map_a, map_b, bias,
                                                                           c, m, n, k);
    return cudaGetLastError();
  }
};

template <>
struct Gemm<float> {
  template <int kEpi, class>
  static cudaError_t run(const float* a, const float* b, const float* bias, float* c, int m,
                         int n, int k, cudaStream_t stream) {
    const dim3 grid((n + kFt - 1) / kFt, (m + kFt - 1) / kFt);
    ffn_f32_kernel<kEpi><<<grid, kThreads, 0, stream>>>(a, b, bias, c, m, n, k);
    return cudaGetLastError();
  }
};

// x [rows, hidden], w1 [inter, hidden], b1 [inter], w2 [hidden, inter], b2 [hidden],
// h [rows, inter] scratch, out [rows, hidden]
template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* h, void* out, int rows, int hidden, int inter, void* stream) {
  if (rows < 1 || rows > 65535 * 64 || hidden < 64 || hidden % 64 || inter < 64 || inter % 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = Gemm<T>::template run<kGelu, Launch1>((const T*)x, (const T*)w1,
                                                          (const T*)b1, (T*)h, rows, inter,
                                                          hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)Gemm<T>::template run<kBias, Launch2>((const T*)h, (const T*)w2, (const T*)b2,
                                                    (T*)out, rows, hidden, inter, s);
}

}  // namespace

extern "C" int aspire_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h, void* out, int rows, int hidden,
                               int inter, void* stream) {
  return launch<bf16>(x, w1, b1, w2, b2, h, out, rows, hidden, inter, stream);
}

extern "C" int aspire_ffn_f32(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* h, void* out, int rows, int hidden,
                              int inter, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, h, out, rows, hidden, inter, stream);
}
