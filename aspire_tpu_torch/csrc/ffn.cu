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
// f32 (the evaluation's encode, as the JAX package runs it) takes three
// launches: a split of x and both weights into TF32 hi and lo parts, then the
// same two products on the tensor cores as three TF32 products each
// (ffn_tf32x3_kernel below), at f32 accuracy.  On the FP32 lanes the two
// products' 38.7 GFLOP at 4096 rows would take 0.58 ms at best; as 3 x 38.7
// GFLOP of TF32 they take 0.23 ms at best.
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

// ---- f32 at f32 accuracy on the tensor cores: split TF32 (3xTF32) ----------
// Each f32 operand is split as x = hi + lo, hi = tf32(x) and lo = tf32(x - hi)
// (tf32_split, common.cuh), and a product is summed as lo.hi + hi.lo + hi.hi
// into one f32 accumulator, the small cross terms first; lo.lo (~2^-22 of the
// product) is dropped.  Both operands come split from device memory: x and
// the weights by one split_tf32_kernel launch a call into the wrapper's
// scratch, the activation H by launch 1's epilogue, which stores hi and lo.
// So both wgmma operands are read from shared memory (K-major, as TF32 wgmma
// wants them) through descriptors, and the pipeline is the bf16 kernel's: a
// persistent grid, a TMA producer warp, an mbarrier ring, two consumer
// warpgroups of 64 rows.  A k-stage is one 128-byte swizzled row: 32 floats.
constexpr int kBkF = 32;

template <int kBn_, int kStages_>
struct TileF32 {
  static constexpr int kWgM = 2, kBn = kBn_, kStages = kStages_;
  static constexpr int kBm = 64 * kWgM, kThreads = 128 * kWgM + 32;
  static constexpr int kTileA = kBm * kBkF, kTileB = kBn * kBkF;   // floats
  // a stage: A hi, A lo, B hi, B lo
  static constexpr unsigned kStageBytes = 2 * (kTileA + kTileB) * sizeof(float);
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages;
  static_assert(kSmem <= 232448, "shared memory of a block");
  static_assert(kTileA * 4 % 1024 == 0 && kTileB * 4 % 1024 == 0, "1024-byte aligned tiles");
};
// launch 1 (K = 768, N = 3072 at BERT-base): 128 x 128 tiles, three stages;
// launch 2 (N = 768): 128 x 96, four stages, so that 4096 rows make 256 tiles
// (1.9 waves of 132 SMs) rather than 192 (1.45)
using Launch1F32 = TileF32<128, 3>;
using Launch2F32 = TileF32<96, 4>;

// D[64, N] = (accumulate ? D : 0) + A[64, 8] . B[8, N] in TF32, A and B read
// from shared memory through descriptors, both K-major
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], unsigned long long desc_a,
                                           unsigned long long desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], unsigned long long desc_a,
                                             unsigned long long desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], unsigned long long desc_a,
                                             unsigned long long desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// C = epilogue(A[M, K] . B[N, K]^T + bias) with A and B each given as TF32 hi
// and lo parts (four tensor maps, boxes of [kBm][32] and [kBn][32]).  kGelu
// stores gelu_erf(.) split into c_hi and c_lo (launch 2's A); kBias stores the
// f32 result into c_hi.
template <int kEpi, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
ffn_tf32x3_kernel(const __grid_constant__ CUtensorMap map_ah,
                  const __grid_constant__ CUtensorMap map_al,
                  const __grid_constant__ CUtensorMap map_bh,
                  const __grid_constant__ CUtensorMap map_bl, const float* __restrict__ bias,
                  float* __restrict__ c_hi, float* __restrict__ c_lo, int m, int n, int k) {
  constexpr int kBm = Cfg::kBm, kBn = Cfg::kBn, kStages = Cfg::kStages, kWgM = Cfg::kWgM;
  constexpr int kTileA = Cfg::kTileA, kTileB = Cfg::kTileB, kSlot = 2 * (kTileA + kTileB);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024);
  // stage s at ring + s kSlot: A hi, A lo, B hi, B lo
  auto* full = reinterpret_cast<unsigned long long*>(ring + kStages * kSlot);
  unsigned long long* empty = full + kStages;
  const int ktiles = k / kBkF, col_tiles = (n + kBn - 1) / kBn;
  const int tiles = col_tiles * ((m + kBm - 1) / kBm);
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kWgM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgM) {                      // the producer warp: one thread issues the loads
    if (threadIdx.x == kWgM * 128) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / col_tiles * kBm, col0 = tile % col_tiles * kBn;
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + s, (g / kStages - 1) & 1);
          mbar_expect_tx(full + s, Cfg::kStageBytes);
          float* slot = ring + s * kSlot;
          tma_load(slot, &map_ah, full + s, kt * kBkF, row0);
          tma_load(slot + kTileA, &map_al, full + s, kt * kBkF, row0);
          tma_load(slot + 2 * kTileA, &map_bh, full + s, kt * kBkF, col0);
          tma_load(slot + 2 * kTileA + kTileB, &map_bl, full + s, kt * kBkF, col0);
        }
      }
    }
    return;
  }

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  // The tensor cores add into their accumulator with truncation, so a sum
  // carried over all of K in the wgmma accumulator drifts by up to an ulp an
  // addition (1152 additions at K = 3072: ~5e-5 on O(1) outputs, ten times
  // the FMA kernel's error, measured on the H100).  So each stage's products
  // go into a fresh accumulator `part` -- its cross terms first, a sum ~2^-11
  // the size of the hi.hi terms added on top -- and the tile's sum `acc` takes
  // part by f32 additions, rounded to nearest.
  float acc[kBn / 2], part[kBn / 2];
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile / col_tiles * kBm, col0 = tile % col_tiles * kBn;
#pragma unroll
    for (int i = 0; i < kBn / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      const int s = g % kStages;
      mbar_wait(full + s, (g / kStages) & 1);
      const float* a_hi = ring + s * kSlot + wg * 64 * kBkF;
      const float* a_lo = a_hi + kTileA;
      const float* b_hi = ring + s * kSlot + 2 * kTileA;
      const float* b_lo = b_hi + kTileB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBkF / 8; ++kk) {   // a k-step is 32 bytes along the swizzled rows
        wgmma_tf32<kBn>(part, sw128_desc(a_lo + kk * 8), sw128_desc(b_hi + kk * 8), kk > 0);
        wgmma_tf32<kBn>(part, sw128_desc(a_hi + kk * 8), sw128_desc(b_lo + kk * 8), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBkF / 8; ++kk)
        wgmma_tf32<kBn>(part, sw128_desc(a_hi + kk * 8), sw128_desc(b_hi + kk * 8), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(part);
      if (lane == 0) mbar_arrive(empty + s);   // the stage is read: free its slot
#pragma unroll
      for (int i = 0; i < kBn / 2; ++i) acc[i] += part[i];
    }

    // thread (warp w of the warpgroup, lane q * 4 + t) holds rows q and q + 8 of
    // the warp's 16 at columns 8 j + 2 t, + 1 (acc[4 j + 0..3])
    const int row = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col >= n) continue;            // n is even: col + 1 < n as well
      const float b0 = bias[col], b1 = bias[col + 1];
      float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0,
                    acc[4 * j + 3] + b1};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= m) continue;
        const size_t at = (size_t)(row + 8 * h) * n + col;
        if constexpr (kEpi == kGelu) {
          float hi[2], lo[2];
          tf32_split(gelu_erf(v[2 * h]), hi[0], lo[0]);
          tf32_split(gelu_erf(v[2 * h + 1]), hi[1], lo[1]);
          *reinterpret_cast<float2*>(c_hi + at) = make_float2(hi[0], hi[1]);
          *reinterpret_cast<float2*>(c_lo + at) = make_float2(lo[0], lo[1]);
        } else {
          *reinterpret_cast<float2*>(c_hi + at) = make_float2(v[2 * h], v[2 * h + 1]);
        }
      }
    }
  }
}

// hi and lo parts of up to three f32 arrays (x and the two weights), one
// array per blockIdx.y, float4 at a time
struct SplitSeg {
  const float4* src;
  float4 *hi, *lo;
  long long n4;
};

__global__ void __launch_bounds__(256)
split_tf32_kernel(const SplitSeg s0, const SplitSeg s1, const SplitSeg s2) {
  const SplitSeg s = blockIdx.y == 0 ? s0 : (blockIdx.y == 1 ? s1 : s2);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < s.n4; i += gridDim.x * 256ll) {
    const float4 x = s.src[i];
    float4 hi, lo;
    tf32_split(x.x, hi.x, lo.x);
    tf32_split(x.y, hi.y, lo.y);
    tf32_split(x.z, hi.z, lo.z);
    tf32_split(x.w, hi.w, lo.w);
    s.hi[i] = hi;
    s.lo[i] = lo;
  }
}

// C = epilogue(A . B^T + bias) from the parts A = a_hi + a_lo [m, k] and
// B = b_hi + b_lo [n, k]
template <int kEpi, class Cfg>
cudaError_t gemm_tf32x3(const float* a_hi, const float* a_lo, const float* b_hi,
                        const float* b_lo, const float* bias, float* c_hi, float* c_lo, int m,
                        int n, int k, cudaStream_t stream) {
  CUtensorMap map[4];
  const float* parts[4] = {a_hi, a_lo, b_hi, b_lo};
  for (int i = 0; i < 4; ++i)
    if (!make_map(map + i, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, parts[i], i < 2 ? m : n, k,
                  i < 2 ? Cfg::kBm : Cfg::kBn, kBkF, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_tf32x3_kernel<kEpi, Cfg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((n + Cfg::kBn - 1) / Cfg::kBn) * ((m + Cfg::kBm - 1) / Cfg::kBm);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  ffn_tf32x3_kernel<kEpi, Cfg><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      map[0], map[1], map[2], map[3], bias, c_hi, c_lo, m, n, k);
  return cudaGetLastError();
}

// C = epilogue(A . B^T + bias), A [m, k] and B [n, k] bf16
template <int kEpi, class Cfg>
cudaError_t gemm_bf16(const bf16* a, const bf16* b, const bf16* bias, bf16* c, int m, int n,
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

bool bad_widths(int rows, int hidden, int inter) {
  return rows < 1 || rows > 65535 * 64 || hidden < 64 || hidden % 64 || inter < 64 ||
         inter % 64;
}

// x [rows, hidden], w1 [inter, hidden], b1 [inter], w2 [hidden, inter], b2 [hidden],
// h [rows, inter] scratch, out [rows, hidden]
int launch_bf16(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
                bf16* h, bf16* out, int rows, int hidden, int inter, void* stream) {
  if (bad_widths(rows, hidden, inter)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = gemm_bf16<kGelu, Launch1>(x, w1, b1, h, rows, inter, hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_bf16<kBias, Launch2>(h, w2, b2, out, rows, hidden, inter, s);
}

// f32: three launches -- the split of x, w1 and w2 into `split` ([2, rows,
// hidden], [2, inter, hidden], [2, hidden, inter]: hi parts, then lo parts),
// then the two products, the first storing the activation's parts into h
// ([2, rows, inter])
int launch_f32(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, float* split, float* h, float* out, int rows, int hidden,
               int inter, void* stream) {
  if (bad_widths(rows, hidden, inter)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t nx = (size_t)rows * hidden, nw = (size_t)inter * hidden, nh = (size_t)rows * inter;
  float* xs = split;
  float* w1s = xs + 2 * nx;
  float* w2s = w1s + 2 * nw;
  auto seg = [](const float* src, float* parts, size_t count) {
    return SplitSeg{reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(parts),
                    reinterpret_cast<float4*>(parts + count), (long long)(count / 4)};
  };
  split_tf32_kernel<<<dim3(4 * sm_count(), 3), 256, 0, s>>>(seg(x, xs, nx), seg(w1, w1s, nw),
                                                           seg(w2, w2s, nw));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = gemm_tf32x3<kGelu, Launch1F32>(xs, xs + nx, w1s, w1s + nw, b1, h, h + nh, rows, inter,
                                       hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_tf32x3<kBias, Launch2F32>(h, h + nh, w2s, w2s + nw, b2, out, nullptr, rows,
                                             hidden, inter, s);
}

}  // namespace

extern "C" int aspire_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* h, void* out, int rows, int hidden,
                               int inter, void* stream) {
  return launch_bf16((const bf16*)x, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
                     (const bf16*)b2, (bf16*)h, (bf16*)out, rows, hidden, inter, stream);
}

// split: f32 scratch of 2 (rows + 2 inter) hidden floats; h: 2 rows inter floats
extern "C" int aspire_ffn_f32(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* split, void* h, void* out, int rows,
                              int hidden, int inter, void* stream) {
  return launch_f32((const float*)x, (const float*)w1, (const float*)b1, (const float*)w2,
                    (const float*)b2, (float*)split, (float*)h, (float*)out, rows, hidden, inter,
                    stream);
}
