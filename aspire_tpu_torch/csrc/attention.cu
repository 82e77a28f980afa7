// Fused attention forward without dropout: softmax(q.k^T * scale + bias) . v.
//
// Takes the place of the TPU kernel aspire_tpu/ops/pallas_attention.py
// (_fwd_kernel built at dropout_p = 0).  One block owns 64 query rows of one
// (batch, head); each of its 4 warps owns 16 of them.  Keys and values stream
// through shared memory in tiles of 64.  The scores of a tile live only on
// chip.  Rounding points follow the TPU kernel: scores, max, exp, sum
// and the division in f32; the normalised probabilities are cast to the
// compute type; probs.v accumulates in f32 and is cast on store.  To divide
// before the cast without keeping a whole [64, t] score block, the keys are
// walked twice: pass 1 finds each row's max and sum, pass 2 recomputes the
// scores, normalises, casts and accumulates the context.
//
// bf16 runs both products on the tensor cores (mma.sync m16n8k16 fed by
// ldmatrix, f32 accumulate) with scores and probabilities in registers; f32
// runs them as plain FMAs so that the result is true f32.
#include <math.h>

#include "common.cuh"

namespace {

using aspire::copy16;

constexpr int kHd = 64;        // head width
constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBq / kWarps;   // 16 query rows per warp
constexpr int kLdS = 68;       // pitch of the f32 kernel's score rows (float4 reads on store)

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int ld = 72; };   // 16-byte rows, skewed banks
template <> struct Cfg<float> { static constexpr int ld = 65; };           // odd pitch: k[c][d] by lane c

// rows [row0, row0 + 64) of a [t, 64] matrix with row pitch `stride`; zero past t
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0,
                                          int t) {
  constexpr int vec = 16 / sizeof(T), per_row = kHd / vec, ld = Cfg<T>::ld;
  for (int idx = threadIdx.x; idx < kBk * per_row; idx += kThreads) {
    const int r = idx / per_row, cv = (idx % per_row) * vec;
    const bool valid = row0 + r < t;
    const T* p = src + (long long)(row0 + r) * stride + cv;
    if constexpr (sizeof(T) == 2) {
      copy16(dst + r * ld + cv, p, valid);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) v = *reinterpret_cast<const float4*>(p);
      float* o = reinterpret_cast<float*>(dst) + r * ld + cv;
      o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
  }
}

// ---------------------------------------------------------------- bf16 kernel
// Both products run on the tensor cores (mma.sync m16n8k16, f32 accumulate).
// A warp's scores for 16 rows x 64 keys come out of the first product in the
// accumulator layout, in which the softmax runs (a row is spread over the four
// threads of a quad); cast to bf16 pairs they are exactly the A fragments of
// the second product, so neither scores nor probabilities touch shared memory.
__global__ void __launch_bounds__(kThreads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int t,
                      long long qsb, long long qsh, long long qst,
                      long long ksb, long long ksh, long long kst,
                      long long vsb, long long vsh, long long vst,
                      long long osb, long long osh, long long ost, float sm_scale) {
  using bf16 = __nv_bfloat16;
  using aspire::frag_addr;
  using aspire::ldmatrix_x4;
  using aspire::ldmatrix_x4_trans;
  using aspire::mma_bf16_16816;
  using aspire::pack_bf16;
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
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          unsigned bfr[4];             // k is [key][hd]: B fragments without a transpose
          ldmatrix_x4(bfr, frag_addr(ks + np * 16 * ld + kk * 16, ld, lane, false));
          mma_bf16_16816(s[2 * np], qa[kk], bfr[0], bfr[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt) {
        const float b0 = bias_s[nt * 8 + 2 * tq], b1 = bias_s[nt * 8 + 2 * tq + 1];
        s[nt][0] = s[nt][0] * sm_scale + b0;
        s[nt][1] = s[nt][1] * sm_scale + b1;
        s[nt][2] = s[nt][2] * sm_scale + b0;
        s[nt][3] = s[nt][3] * sm_scale + b1;
      }

      if (pass == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kBk / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[h], mx);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < kBk / 8; ++nt)
            sum += expf(s[nt][2 * h] - m_new) + expf(s[nt][2 * h + 1] - m_new);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l_run[h] = l_run[h] * expf(m_run[h] - m_new) + sum;
          m_run[h] = m_new;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kBk / 16; ++j) {
          // normalised in f32, then cast: the A fragment of keys 16j .. 16j + 15
          unsigned pa[4];
          pa[0] = pack_bf16(expf(s[2 * j][0] - m_run[0]) / l_run[0],
                            expf(s[2 * j][1] - m_run[0]) / l_run[0]);
          pa[1] = pack_bf16(expf(s[2 * j][2] - m_run[1]) / l_run[1],
                            expf(s[2 * j][3] - m_run[1]) / l_run[1]);
          pa[2] = pack_bf16(expf(s[2 * j + 1][0] - m_run[0]) / l_run[0],
                            expf(s[2 * j + 1][1] - m_run[0]) / l_run[0]);
          pa[3] = pack_bf16(expf(s[2 * j + 1][2] - m_run[1]) / l_run[1],
                            expf(s[2 * j + 1][3] - m_run[1]) / l_run[1]);
#pragma unroll
          for (int np = 0; np < kHd / 16; ++np) {
            unsigned bfr[4];           // v is [key][hd]: transposed on load
            ldmatrix_x4_trans(bfr, frag_addr(vs + j * 16 * ld + np * 16, ld, lane, true));
            mma_bf16_16816(oacc[2 * np], pa, bfr[0], bfr[1]);
            mma_bf16_16816(oacc[2 * np + 1], pa, bfr[2], bfr[3]);
          }
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
struct AccF32 {
  float o0[kRows], o1[kRows];   // columns lane and lane + 32 of the warp's 16 rows

  __device__ void init() {
    for (int r = 0; r < kRows; ++r) o0[r] = o1[r] = 0.f;
  }
  // s[16, 64] = q_w . k_tile^T
  __device__ void scores(const float* qw, const float* ks, float* sw) {
    const int lane = threadIdx.x & 31;
    float a0[kRows], a1[kRows];
    for (int r = 0; r < kRows; ++r) a0[r] = a1[r] = 0.f;
    const float* k0 = ks + lane * 65;
    const float* k1 = ks + (lane + 32) * 65;
    for (int d = 0; d < kHd; ++d) {
      const float x0 = k0[d], x1 = k1[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * 65 + d];
        a0[r] = fmaf(qv, x0, a0[r]);
        a1[r] = fmaf(qv, x1, a1[r]);
      }
    }
    for (int r = 0; r < kRows; ++r) {
      sw[r * kLdS + lane] = a0[r];
      sw[r * kLdS + lane + 32] = a1[r];
    }
  }
  // o += p_w[16, 64] . v_tile[64, 64]
  __device__ void context(const float* pw, const float* vs) {
    const int lane = threadIdx.x & 31;
    for (int j = 0; j < kBk; ++j) {
      const float v0 = vs[j * 65 + lane], v1 = vs[j * 65 + lane + 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * 65 + j];
        o0[r] = fmaf(p, v0, o0[r]);
        o1[r] = fmaf(p, v1, o1[r]);
      }
    }
  }
  __device__ void store(float* sw) {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < kRows; ++r) {
      sw[r * kLdS + lane] = o0[r];
      sw[r * kLdS + lane + 32] = o1[r];
    }
  }
};

constexpr size_t kSmemF32 =
    (size_t)(3 * kBq * 65 + kWarps * kRows * 65 + kWarps * kRows * kLdS + kBk) * sizeof(float);
constexpr size_t kSmemBf16 = (size_t)(3 * kBq * 72) * sizeof(__nv_bfloat16) + kBk * sizeof(float);

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int t,
                     long long qsb, long long qsh, long long qst,
                     long long ksb, long long ksh, long long kst,
                     long long vsb, long long vsh, long long vst,
                     long long osb, long long osh, long long ost, float sm_scale) {
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
  AccF32 acc;
  acc.init();

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
      acc.scores(qw, ks, sw);
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
        acc.context(pw, vs);
      }
      __syncwarp();                    // sw is rewritten by the next tile
    }
  }

  acc.store(sw);
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
           float sm_scale, void* stream) {
  if (b < 1 || nh < 1 || t < 1 || nh > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kBq - 1) / kBq, nh, b);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, t, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define ASPIRE_ATTENTION(NAME, T, KERNEL, SMEM)                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* bias,           \
                      void* out, int b, int nh, int t, long long qsb, long long qsh,           \
                      long long qst, long long ksb, long long ksh, long long kst,              \
                      long long vsb, long long vsh, long long vst, long long osb,              \
                      long long osh, long long ost, float sm_scale, void* stream) {            \
    const long long s[12] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};      \
    return launch<T>(KERNEL, SMEM, q, k, v, bias, out, b, nh, t, s, sm_scale, stream);         \
  }

ASPIRE_ATTENTION(aspire_attention_bf16, __nv_bfloat16, attention_bf16_kernel, kSmemBf16)
ASPIRE_ATTENTION(aspire_attention_f32, float, attention_f32_kernel, kSmemF32)
