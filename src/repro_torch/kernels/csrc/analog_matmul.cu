// Fused analog MVM for Hopper (sm_90a): DAC quantization of x (eq. 1),
// a true-fp32 MVM against the effective weights, an optional per-column
// offset, and per-column ADC quantization (eq. 2) in the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/analog_matmul.py::analog_matmul
// (bodies _analog_matmul_kernel and _analog_matmul_off_kernel).
//
// What bounds it on this card:
// * Decode (M <= 8, one token per request) reads every weight once and does
//   2*M flops per weight: it is bound by weight bytes over HBM bandwidth.
//   The GEMV-shaped kernel gives each lane four neighbouring columns (one
//   16-byte load per K row, a warp reads 512 contiguous bytes), holds all M
//   rows of those columns in registers, reads the DAC-quantized x chunk from
//   shared memory, and splits K over the 8 warps of a block and over
//   blocks, so that a projection with N = 2048 still puts a few blocks on
//   every SM and keeps enough loads in flight.
// * Prefill in true fp32 is bound by the fp32 FMA rate of the CUDA cores:
//   the ADC contract (ADC_TIE_BREAK = 1 - 2^-16) forbids TF32, so the tensor
//   cores are not used. The tiled kernel stages 64x16 x and 16x64 W tiles
//   in shared memory (x quantized as it is staged), gives each thread a 4x4
//   register tile, and splits K over blocks when the output alone has too
//   few tiles to fill the card.
// * Split K (split_k.cuh): each split writes its fp32 partial sum to a
//   scratch buffer the wrapper allocates, and analog_finish_kernel adds the
//   splits in a fixed order (deterministic run to run) before the epilogue.
//
// The host asks analog_matmul_plan for the mapping and the split of a shape,
// allocates the scratch it needs, and launches with analog_matmul_f32, which
// picks the same mapping from M.
//
// Arithmetic follows the reference op for op: IEEE division (never build
// with --use_fast_math), rintf (round half to even, like jnp.round), and
// min(max(.)) for clip. Ragged M, N and K are masked, not padded. beta is a
// device pointer so that no host sync is needed per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace {

constexpr float kTieBreak = 1.0f - 1.0f / 65536.0f;
constexpr int kMaxM = 8;  // most decode rows (the GEMV's M) of one launch

// decode (GEMV) mapping
constexpr int kGvWarps = 8;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvVec = 4;                 // columns per lane: one float4
constexpr int kGvCols = 32 * kGvVec;      // 128 columns per block
constexpr int kGvChunk = 512;             // K rows of x_q staged per pass

// prefill (tiled) mapping
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float dac_quant(float x, float beta, float up,
                                           float down) {
  // (beta/qi) * round(clip(x, -beta, beta) * (qi/beta))
  return down * rintf(fminf(fmaxf(x, -beta), beta) * up);
}

__device__ __forceinline__ float adc_quant(float y, float bound, float qo) {
  const float b = fmaxf(bound, 1e-8f);
  const float inv = (qo / b) * kTieBreak;
  const float v = (b / qo) * rintf(y * inv);
  return fminf(fmaxf(v, -b), b);
}

// The epilogue of one output element, or its partial sum when K is split.
__device__ __forceinline__ void store_out(float y, int m, int n, int N,
                                          const float* __restrict__ bound,
                                          const float* __restrict__ col_off,
                                          float* __restrict__ out,
                                          float* __restrict__ part,
                                          int M, int split, float qo) {
  if (part != nullptr) {
    part[((size_t)split * M + m) * N + n] = y;
    return;
  }
  if (col_off != nullptr) y = y + col_off[n];
  out[(size_t)m * N + n] = adc_quant(y, bound[n], qo);
}

// kM rows (the decode batch) are a template parameter, so that each thread
// holds exactly kM x kGvVec accumulators in registers.
template <int kM, bool kVec>
__global__ void __launch_bounds__(kGvThreads)
analog_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ beta_p,
                   const float* __restrict__ bound,
                   const float* __restrict__ col_off,
                   float* __restrict__ out, float* __restrict__ part, int K,
                   int N, int k_per_split, float qi, float qo) {
  __shared__ float xs[kM][kGvChunk];
  __shared__ float red[kGvWarps][kGvCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kGvCols + lane * kGvVec;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const float beta = fmaxf(*beta_p, 1e-8f);
  const float up = qi / beta, down = beta / qi;

  float acc[kM][kGvVec];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) acc[m][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kGvChunk) {
    const int kc = min(kGvChunk, k_end - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kM * kc; i += kGvThreads) {
      const int m = i / kc, k = i - m * kc;
      xs[m][k] = dac_quant(x[(size_t)m * K + k0 + k], beta, up, down);
    }
    __syncthreads();
    const float* wp = w + (size_t)k0 * N + n0;
#pragma unroll 4
    for (int k = warp; k < kc; k += kGvWarps) {
      float wv[kGvVec];
      if (kVec) {  // N % 4 == 0: n0 < N covers all four columns
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 < N) t = *reinterpret_cast<const float4*>(wp + (size_t)k * N);
        wv[0] = t.x; wv[1] = t.y; wv[2] = t.z; wv[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < kGvVec; ++j)
          wv[j] = (n0 + j < N) ? wp[(size_t)k * N + j] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int j = 0; j < kGvVec; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }
  // fixed-order reduction over the warps' K slices, one row at a time
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) red[warp][lane * kGvVec + j] = acc[m][j];
    __syncthreads();
    for (int c = threadIdx.x; c < kGvCols; c += kGvThreads) {
      const int n = blockIdx.x * kGvCols + c;
      if (n >= N) continue;
      float y = 0.f;
      for (int s = 0; s < kGvWarps; ++s) y += red[s][c];
      store_out(y, m, n, N, bound, col_off, out, part, kM, blockIdx.y, qo);
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads)
analog_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ beta_p,
                    const float* __restrict__ bound,
                    const float* __restrict__ col_off,
                    float* __restrict__ out, float* __restrict__ part, int M,
                    int K, int N, int k_per_split, float qi, float qo) {
  __shared__ float xs[kBK][kBM + 4];  // transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const float beta = fmaxf(*beta_p, 1e-8f);
  const float up = qi / beta, down = beta / qi;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kTiledThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      // quantized zero is zero, so masked elements add nothing
      xs[c][r] = (gm < M && gk < k_end)
                     ? dac_quant(x[(size_t)gm * K + gk], beta, up, down)
                     : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kTiledThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < k_end && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + j * (kBN / kTN);
      if (gn >= N) continue;
      store_out(acc[i][j], gm, gn, N, bound, col_off, out, part, M,
                blockIdx.z, qo);
    }
  }
}

// Adds the K splits of every element in split order, then the epilogue.
__global__ void analog_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ bound,
                                     const float* __restrict__ col_off,
                                     float* __restrict__ out, int M, int N,
                                     int splits, float qo) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[(size_t)s * total + i];
  const int n = (int)(i % N);
  if (col_off != nullptr) y = y + col_off[n];
  out[i] = adc_quant(y, bound[n], qo);
}

// Output tiles of one launch of the mapping that M selects: GEMV column
// blocks for M <= kMaxM, kBM x kBN tiles otherwise.
long long output_tiles(int M, int N) {
  if (M <= kMaxM) return (N + kGvCols - 1) / kGvCols;
  return (long long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
}

}  // namespace

// The launch plan of an [M, K] @ [K, N] call on a card with `sms` SMs:
// *mapping is 0 for the GEMV-shaped decode kernel (M <= 8) and 1 for the
// tiled kernel; K is split into *splits ranges of *k_per_split rows.
// Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int analog_matmul_plan(int M, int K, int N, int sms, int* mapping,
                                  int* splits, int* k_per_split) {
  if (M <= 0 || K <= 0 || N <= 0 || sms <= 0 ||
      (M > kMaxM && (M + kBM - 1) / kBM > 65535))
    return (int)cudaErrorInvalidValue;
  *mapping = M <= kMaxM ? 0 : 1;
  plan_split_k(output_tiles(M, N), K, sms, kBK, splits, k_per_split);
  return 0;
}

// Runs the mapping that M selects (see analog_matmul_plan) with K split into
// `splits` ranges of `k_per_split` rows; with splits > 1, `part` is fp32
// scratch of splits * M * N elements. col_off may be null. Returns the
// launches' cudaGetLastError() (0 on success).
extern "C" int analog_matmul_f32(const void* x, const void* w,
                                 const void* beta, const void* bound,
                                 const void* col_off, void* out, void* part,
                                 int M, int K, int N, int in_bits,
                                 int out_bits, int splits, int k_per_split,
                                 void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || in_bits < 2 || in_bits > 24 ||
      out_bits < 2 || out_bits > 24 || splits < 1 || splits > 65535 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  const float qi = (float)((1 << (in_bits - 1)) - 1);
  const float qo = (float)((1 << (out_bits - 1)) - 1);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)beta;
  const float* bnd = (const float*)bound;
  const float* off = (const float*)col_off;
  float* o = (float*)out;
  float* p = (float*)part;
  if (M <= kMaxM) {
    dim3 grid((N + kGvCols - 1) / kGvCols, splits);
    const bool vec = (N % kGvVec) == 0 && ((uintptr_t)w % 16) == 0;
#define ANALOG_GEMV(MM)                                                    \
  case MM:                                                                 \
    if (vec)                                                               \
      analog_gemv_kernel<MM, true><<<grid, kGvThreads, 0, s>>>(            \
          xf, wf, bf, bnd, off, o, p, K, N, k_per_split, qi, qo);          \
    else                                                                   \
      analog_gemv_kernel<MM, false><<<grid, kGvThreads, 0, s>>>(           \
          xf, wf, bf, bnd, off, o, p, K, N, k_per_split, qi, qo);          \
    break;
    switch (M) {
      ANALOG_GEMV(1) ANALOG_GEMV(2) ANALOG_GEMV(3) ANALOG_GEMV(4)
      ANALOG_GEMV(5) ANALOG_GEMV(6) ANALOG_GEMV(7) ANALOG_GEMV(8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ANALOG_GEMV
  } else {
    if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    analog_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(
        xf, wf, bf, bnd, off, o, p, M, K, N, k_per_split, qi, qo);
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    analog_finish_kernel<<<(unsigned)((total + threads - 1) / threads),
                           threads, 0, s>>>(p, bnd, off, o, M, N, splits,
                                            qo);
  }
  return (int)cudaGetLastError();
}
