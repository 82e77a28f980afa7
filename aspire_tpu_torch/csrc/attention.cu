// Fused attention forward: softmax(q.k^T * scale + bias) . v, with or without
// dropout on the probabilities.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_attention.py
// (_fwd_kernel, built at dropout_p = 0 and at dropout_p > 0).  One block owns
// 64 query rows of one (batch, head); each of its 4 warps owns 16 of them.
// Keys and values stream through shared memory in tiles of 64.  The scores of a
// tile live only on chip.  Rounding points follow the TPU kernel: scores, max,
// exp, sum and the division in f32; the normalised probabilities are cast to
// the compute type; probs.v accumulates in f32 and is cast on store.  To divide
// before the cast without keeping a whole [64, t] score block, the keys are
// walked twice: pass 1 finds each row's max and sum, pass 2 recomputes the
// scores, normalises, casts and accumulates the context.
//
// Dropout is a compile-time mode (kDrop: 0 none, 1 Philox bits made in the
// kernel, 2 bits read from an operand).  The cast probability is divided by
// (1 - p) in the compute type and cast again, dropped ones are zeroed, and the
// result feeds the second product.  The bits are a function of the element's
// position (common.cuh), so the backward, which tiles differently, recomputes
// the same mask.  In the bf16 kernel a thread holds two neighbouring columns of
// a row in the mma accumulator layout while one Philox call covers four: the
// counter takes column / 4 all the same, and the two threads of a pair each
// make one call (rows g and g + 8) and swap halves (acc_bits).  Mode 0 compiles
// to the kernel without any of this.
//
// bf16 runs both products on the tensor cores (mma.sync m16n8k16 fed by
// ldmatrix, f32 accumulate) with scores and probabilities in registers; f32
// runs them as plain FMAs so that the result is true f32.
#include "attention_tile.cuh"

namespace {

using namespace aspire;

// ---------------------------------------------------------------- bf16 kernel
// Both products run on the tensor cores (mma.sync m16n8k16, f32 accumulate).
// A warp's scores for 16 rows x 64 keys come out of the first product in the
// accumulator layout, in which the softmax runs (a row is spread over the four
// threads of a quad); cast to bf16 pairs they are exactly the A fragments of
// the second product, so neither scores nor probabilities touch shared memory.
template <int kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int t,
                      long long qsb, long long qsh, long long qst,
                      long long ksb, long long ksh, long long kst,
                      long long vsb, long long vsh, long long vst,
                      long long osb, long long osh, long long ost, float sm_scale, Drop drop,
                      float* __restrict__ stats) {
  using bf16 = __nv_bfloat16;
  constexpr int ld = Cfg<bf16>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBq * ld;
  bf16* vs = ks + kBk * ld;
  float* bias_s = reinterpret_cast<float*>(vs + kBk * ld);   // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const bf16* qg = q + b * qsb + head * qsh;
  const bf16* kg = k + b * ksb + head * ksh;
  const bf16* vg = v + b * vsb + head * vsh;
  const float* bg = bias + (long long)b * t;
  bf16* qw = qs + warp * kRows * ld;

  load_tile<bf16>(qs, qg, qst, q0, t);
  __syncthreads();
  unsigned qa[kHd / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) ldmatrix_x4(qa[kk], frag_addr(qw + kk * 16, ld, lane, true));

  float oacc[kHd / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHd / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[nt][i] = 0.f;
  // running max and sum of rows g (index 0) and g + 8 (index 1)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < t; k0 += kBk) {
      __syncthreads();                 // the previous tile is no longer read
      load_tile<bf16>(ks, kg, kst, k0, t);
      if (pass == 1) load_tile<bf16>(vs, vg, vst, k0, t);
      if (threadIdx.x < kBk)           // keys past t get -inf: zero weight, no part in the max
        bias_s[threadIdx.x] = (k0 + threadIdx.x < t) ? bg[k0 + threadIdx.x] : -INFINITY;
      __syncthreads();

      float s[kBk / 8][4];
      mma_abT(s, qa, ks, lane);
      scale_bias(s, bias_s, sm_scale, tq);

      if (pass == 0) {
        row_stats(s, m_run, l_run);
      } else {
#pragma unroll
        for (int j = 0; j < kBk / 16; ++j) {
          // normalised in f32, then cast: the A fragment of keys 16j .. 16j + 15
          unsigned pa[4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int nt = 2 * j + u;
            float p[4];
            p[0] = expf(s[nt][0] - m_run[0]) / l_run[0];
            p[1] = expf(s[nt][1] - m_run[0]) / l_run[0];
            p[2] = expf(s[nt][2] - m_run[1]) / l_run[1];
            p[3] = expf(s[nt][3] - m_run[1]) / l_run[1];
            if constexpr (kDrop != 0) {
              unsigned bits[4];
              acc_bits<kDrop>(drop, b * gridDim.y + head, t, q0 + warp * kRows + g, k0 + nt * 8,
                              lane, bits);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                p[i] = drop_prob_bf16(p[i], bits[i] >= drop.thresh, drop.keep_div);
            }
            pa[2 * u] = pack_bf16(p[0], p[1]);
            pa[2 * u + 1] = pack_bf16(p[2], p[3]);
          }
          mma_ab_chunk(oacc, pa, vs, j, lane);
        }
      }
    }
    if (pass == 0 && stats != nullptr && tq == 0) {
      // a training forward leaves each row's max and sum for the backward
      const long long planes_t = (long long)gridDim.z * gridDim.y * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + warp * kRows + g + 8 * h;
        if (row < t) {
          float* st = stats + (long long)(b * gridDim.y + head) * t + row;
          st[0] = m_run[h];
          st[planes_t] = l_run[h];
        }
      }
    }
  }

  // the warp's rows of the q tile are dead (they live in qa): stage the output there
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kHd / 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    *reinterpret_cast<unsigned*>(qw + g * ld + col) = pack_bf16(oacc[nt][0], oacc[nt][1]);
    *reinterpret_cast<unsigned*>(qw + (g + 8) * ld + col) = pack_bf16(oacc[nt][2], oacc[nt][3]);
  }
  __syncwarp();
  bf16* og = out + b * osb + head * osh;
  for (int idx = lane; idx < kRows * (kHd / 8); idx += 32) {
    const int r = idx / (kHd / 8), cv = (idx % (kHd / 8)) * 8;
    const int qrow = q0 + warp * kRows + r;
    if (qrow < t)
      *reinterpret_cast<uint4*>(og + (long long)qrow * ost + cv) =
          *reinterpret_cast<const uint4*>(qw + r * ld + cv);
  }
}

// ----------------------------------------------------------------- f32 kernel
// Plain FMAs so that the result is true f32.  A warp keeps its 16 x 64 scores
// and probabilities in shared memory; lane c owns columns c and c + 32 of both
// products; two lanes share a row of the softmax.
constexpr size_t kSmemF32 =
    (size_t)(3 * kBq * 65 + kWarps * kRows * 65 + kWarps * kRows * kLdS + kBk) * sizeof(float);
constexpr size_t kSmemBf16 = (size_t)(3 * kBq * 72) * sizeof(__nv_bfloat16) + kBk * sizeof(float);

template <int kDrop>
__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int t,
                     long long qsb, long long qsh, long long qst,
                     long long ksb, long long ksh, long long kst,
                     long long vsb, long long vsh, long long vst,
                     long long osb, long long osh, long long ost, float sm_scale, Drop drop,
                     float* __restrict__ stats) {
  constexpr int ld = Cfg<float>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBq * ld;
  float* vs = ks + kBk * ld;
  float* ps = vs + kBk * ld;                       // [warps][16][ld] probabilities
  float* ss = ps + kWarps * kRows * ld;            // [warps][16][kLdS] scores
  float* bias_s = ss + kWarps * kRows * kLdS;      // [64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBq, head = blockIdx.y, b = blockIdx.z;
  const float* qg = q + b * qsb + head * qsh;
  const float* kg = k + b * ksb + head * ksh;
  const float* vg = v + b * vsb + head * vsh;
  const float* bg = bias + (long long)b * t;

  float* qw = qs + warp * kRows * ld;
  float* pw = ps + warp * kRows * ld;
  float* sw = ss + warp * kRows * kLdS;

  load_tile<float>(qs, qg, qst, q0, t);
  __syncthreads();
  float o0[kRows], o1[kRows];   // columns lane and lane + 32 of the warp's 16 rows
  for (int r = 0; r < kRows; ++r) o0[r] = o1[r] = 0.f;

  // two lanes share a row: lane = 2 * row + half, columns half, half + 2, ...
  const int row = lane >> 1, half = lane & 1;
  float m_run = -INFINITY, l_run = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < t; k0 += kBk) {
      __syncthreads();                 // the previous tile is no longer read
      load_tile<float>(ks, kg, kst, k0, t);
      if (pass == 1) load_tile<float>(vs, vg, vst, k0, t);
      if (threadIdx.x < kBk)           // keys past t get -inf: zero weight, no part in the max
        bias_s[threadIdx.x] = (k0 + threadIdx.x < t) ? bg[k0 + threadIdx.x] : -INFINITY;
      __syncthreads();
      f32_abT(qw, ks, sw);
      __syncwarp();
      if (pass == 0) {
        float mx = -INFINITY;
        for (int c = half; c < kBk; c += 2)
          mx = fmaxf(mx, sw[row * kLdS + c] * sm_scale + bias_s[c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.f;
        for (int c = half; c < kBk; c += 2)
          sum += expf(sw[row * kLdS + c] * sm_scale + bias_s[c] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
      } else {
        for (int c = half; c < kBk; c += 2)
          pw[row * ld + c] = expf(sw[row * kLdS + c] * sm_scale + bias_s[c] - m_run) / l_run;
        __syncwarp();
        if constexpr (kDrop != 0) {
          // one item = four neighbouring columns of a row = one Philox call
          for (int idx = lane; idx < kRows * (kBk / 4); idx += 32) {
            const int r = idx / (kBk / 4), c4 = idx % (kBk / 4);
            const uint4 w = row_bits<kDrop>(drop, b * gridDim.y + head, t, q0 + warp * kRows + r,
                                            k0 / 4 + c4);
            const unsigned bits[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float* p = pw + r * ld + c4 * 4 + i;
              *p = bits[i] >= drop.thresh ? *p / drop.keep_div : 0.f;
            }
          }
          __syncwarp();
        }
        f32_ab(o0, o1, pw, ld, vs);
      }
      __syncwarp();                    // sw is rewritten by the next tile
    }
    if (pass == 0 && stats != nullptr && half == 0 && q0 + warp * kRows + row < t) {
      const long long planes_t = (long long)gridDim.z * gridDim.y * t;
      float* st = stats + (long long)(b * gridDim.y + head) * t + q0 + warp * kRows + row;
      st[0] = m_run;
      st[planes_t] = l_run;
    }
  }

  for (int r = 0; r < kRows; ++r) {
    sw[r * kLdS + lane] = o0[r];
    sw[r * kLdS + lane + 32] = o1[r];
  }
  __syncwarp();
  float* og = out + b * osb + head * osh;
  for (int idx = lane; idx < kRows * (kHd / 4); idx += 32) {
    const int r = idx / (kHd / 4), cv = (idx % (kHd / 4)) * 4;
    const int qrow = q0 + warp * kRows + r;
    if (qrow < t)
      *reinterpret_cast<float4*>(og + (long long)qrow * ost + cv) =
          make_float4(sw[r * kLdS + cv], sw[r * kLdS + cv + 1], sw[r * kLdS + cv + 2],
                      sw[r * kLdS + cv + 3]);
  }
}

template <typename T, typename KernelFn>
int launch(KernelFn kernel, size_t smem, const void* q, const void* k, const void* v,
           const void* bias, void* out, int b, int nh, int t, const long long* s,
           float sm_scale, const Drop& drop, void* stats, void* stream) {
  if (b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBq - 1) / kBq, nh, b);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, t, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], sm_scale, drop, (float*)stats);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 no dropout, 1 Philox bits from (seed, c0), 2 bits from the operand;
// stats: null, or a [2 or more, b * nh, t] f32 array that receives each row's
// max (plane 0) and sum (plane 1) for the backward
#define ASPIRE_ATTENTION(NAME, T, KERNEL, SMEM)                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* bias,           \
                      void* out, int b, int nh, int t, long long qsb, long long qsh,           \
                      long long qst, long long ksb, long long ksh, long long kst,              \
                      long long vsb, long long vsh, long long vst, long long osb,              \
                      long long osh, long long ost, float sm_scale, int mode,                  \
                      unsigned long long seed, unsigned c0, unsigned thresh, float keep_div,   \
                      const void* bits, void* stats, void* stream) {                           \
    const long long s[12] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};      \
    const Drop drop = {seed, c0, thresh, keep_div, keep_div, (const unsigned*)bits};           \
    if (mode == 0)                                                                             \
      return launch<T>(KERNEL<0>, SMEM, q, k, v, bias, out, b, nh, t, s, sm_scale, drop,       \
                       stats, stream);                                                         \
    if (mode == 1)                                                                             \
      return launch<T>(KERNEL<1>, SMEM, q, k, v, bias, out, b, nh, t, s, sm_scale, drop,       \
                       stats, stream);                                                         \
    if (mode == 2 && bits != nullptr)                                                          \
      return launch<T>(KERNEL<2>, SMEM, q, k, v, bias, out, b, nh, t, s, sm_scale, drop,       \
                       stats, stream);                                                         \
    return (int)cudaErrorInvalidValue;                                                         \
  }

ASPIRE_ATTENTION(aspire_attention_bf16, __nv_bfloat16, attention_bf16_kernel, kSmemBf16)
ASPIRE_ATTENTION(aspire_attention_f32, float, attention_f32_kernel, kSmemF32)
