// Packed-int4 weight x fp32 activation matmul for Hopper (sm_90a): the
// Table-3 digital deployment. y = (x @ (nibble - 8)) * scale[col].
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py::int4_matmul
// (body _int4_matmul_kernel).
//
// Layout: byte [k, j] of w_packed [K, N/2] holds column 2j in the low nibble
// and column 2j+1 in the high nibble, each storing int4 + 8. As on the TPU,
// the per-column scale multiplies the fp32 accumulator on exit.
//
// What bounds it on this card:
// * Decode (M <= 8) reads every packed byte once and does 4*M flops per
//   byte: it is bound by weight bytes (K*N/2) over HBM bandwidth, an eighth
//   of the fp32 weight bytes of the analog kernel, so the whole matrix of a
//   small projection is about what the card keeps in flight at once. The
//   GEMV-shaped kernel gives each lane four neighbouring bytes (eight
//   columns, one 4-byte load per K row), holds all M rows of them in
//   registers, reads x from shared memory, and splits K over the 8 warps
//   of a block and over blocks so that every SM gets several blocks.
// * Prefill accumulates in true fp32 on the CUDA cores and is bound by their
//   FMA rate. The tiled kernel unpacks a 16x64 weight tile into shared
//   memory as it is staged, gives each thread a 4x4 register tile, and
//   splits K over blocks when the output has too few tiles.
// * Split K (split_k.cuh): each split writes its fp32 partial sum to
//   scratch, and int4_finish_kernel adds the splits in a fixed order, then
//   scales.
// Ragged M and K, and N up to the packed width, are masked, not padded.
//
// The host asks int4_matmul_plan for the mapping and the split of a shape,
// allocates the scratch it needs, and launches with int4_matmul_f32, which
// picks the same mapping from M.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace {

constexpr int kMaxM = 8;  // most decode rows (the GEMV's M) of one launch

// decode (GEMV) mapping
constexpr int kGvWarps = 8;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvBytes = 4;                  // packed bytes per lane
constexpr int kGvLaneCols = 2 * kGvBytes;    // 8 columns per lane
constexpr int kGvCols = 32 * kGvLaneCols;    // 256 columns per block
constexpr int kGvChunk = 512;                // K rows of x staged per pass

// prefill (tiled) mapping
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float nib(unsigned v, int shift) {
  return (float)((int)((v >> shift) & 0xFu) - 8);
}

// The epilogue of one output element, or its partial sum when K is split.
__device__ __forceinline__ void store_out(float y, int m, int n, int N,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out,
                                          float* __restrict__ part, int M,
                                          int split) {
  if (part != nullptr)
    part[((size_t)split * M + m) * N + n] = y;
  else
    out[(size_t)m * N + n] = y * scale[n];
}

// kM rows (the decode batch) are a template parameter, so that each thread
// holds exactly kM x kGvLaneCols accumulators in registers.
template <int kM, bool kVec>
__global__ void __launch_bounds__(kGvThreads)
int4_gemv_kernel(const float* __restrict__ x,
                 const uint8_t* __restrict__ wp,
                 const float* __restrict__ scale, float* __restrict__ out,
                 float* __restrict__ part, int K, int N, int k_per_split) {
  __shared__ float xs[kM][kGvChunk];
  __shared__ float red[kGvWarps][kGvCols];
  const int NH = N / 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * (kGvCols / 2) + lane * kGvBytes;  // first byte
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[kM][kGvLaneCols];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int c = 0; c < kGvLaneCols; ++c) acc[m][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kGvChunk) {
    const int kc = min(kGvChunk, k_end - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kM * kc; i += kGvThreads) {
      const int m = i / kc, k = i - m * kc;
      xs[m][k] = x[(size_t)m * K + k0 + k];
    }
    __syncthreads();
    const uint8_t* bp = wp + (size_t)k0 * NH + j0;
#pragma unroll 4
    for (int k = warp; k < kc; k += kGvWarps) {
      // four bytes; a missing byte reads as 0x88, two zero int4s
      unsigned v = 0x88888888u;
      if (kVec) {  // NH % 4 == 0: j0 < NH covers all four bytes
        if (j0 < NH)
          v = *reinterpret_cast<const uint32_t*>(bp + (size_t)k * NH);
      } else {
#pragma unroll
        for (int b = 0; b < kGvBytes; ++b)
          if (j0 + b < NH)
            v = (v & ~(0xFFu << (8 * b))) |
                ((unsigned)bp[(size_t)k * NH + b] << (8 * b));
      }
      float wv[kGvLaneCols];
#pragma unroll
      for (int c = 0; c < kGvLaneCols; ++c) wv[c] = nib(v, 4 * c);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int c = 0; c < kGvLaneCols; ++c)
          acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
      }
    }
  }
  // fixed-order reduction over the warps' K slices, one row at a time
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kGvLaneCols; ++c)
      red[warp][lane * kGvLaneCols + c] = acc[m][c];
    __syncthreads();
    for (int c = threadIdx.x; c < kGvCols; c += kGvThreads) {
      const int n = blockIdx.x * kGvCols + c;
      if (n >= N) continue;
      float y = 0.f;
      for (int s = 0; s < kGvWarps; ++s) y += red[s][c];
      store_out(y, m, n, N, scale, out, part, kM, blockIdx.y);
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads)
int4_tiled_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ wp,
                  const float* __restrict__ scale, float* __restrict__ out,
                  float* __restrict__ part, int M, int K, int N,
                  int k_per_split) {
  __shared__ float xs[kBK][kBM + 4];  // transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int NH = N / 2;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) acc[i][jj] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kTiledThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < k_end) ? x[(size_t)gm * K + gk] : 0.f;
    }
    // one packed byte (two columns) per thread and step
    for (int i = tid; i < kBK * (kBN / 2); i += kTiledThreads) {
      const int r = i / (kBN / 2), c = i % (kBN / 2);
      const int gk = k0 + r, gj = n0 / 2 + c;
      float lo = 0.f, hi = 0.f;
      if (gk < k_end && gj < NH) {
        const unsigned b = wp[(size_t)gk * NH + gj];
        lo = nib(b, 0);
        hi = nib(b, 4);
      }
      ws[r][2 * c] = lo;
      ws[r][2 * c + 1] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) b[jj] = ws[kk][tx + jj * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int jj = 0; jj < kTN; ++jj)
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) {
      const int gn = n0 + tx + jj * (kBN / kTN);
      if (gn >= N) continue;
      store_out(acc[i][jj], gm, gn, N, scale, out, part, M, blockIdx.z);
    }
  }
}

// Adds the K splits of every element in split order, then scales.
__global__ void int4_finish_kernel(const float* __restrict__ part,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[(size_t)s * total + i];
  out[i] = y * scale[i % N];
}

// Output tiles of one launch of the mapping that M selects: GEMV column
// blocks for M <= kMaxM, kBM x kBN tiles otherwise.
long long output_tiles(int M, int N) {
  if (M <= kMaxM) return (N + kGvCols - 1) / kGvCols;
  return (long long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
}

}  // namespace

// The launch plan of an [M, K] @ [K, N] call (N unpacked) on a card with
// `sms` SMs: *mapping is 0 for the GEMV-shaped decode kernel (M <= 8) and 1
// for the tiled kernel; K is split into *splits ranges of *k_per_split rows.
// Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int int4_matmul_plan(int M, int K, int N, int sms, int* mapping,
                                int* splits, int* k_per_split) {
  if (M <= 0 || K <= 0 || N <= 0 || (N % 2) != 0 || sms <= 0 ||
      (M > kMaxM && (M + kBM - 1) / kBM > 65535))
    return (int)cudaErrorInvalidValue;
  *mapping = M <= kMaxM ? 0 : 1;
  plan_split_k(output_tiles(M, N), K, sms, kBK, splits, k_per_split);
  return 0;
}

// Runs the mapping that M selects (see int4_matmul_plan) with K split into
// `splits` ranges of `k_per_split` rows; N is the unpacked width (even).
// With splits > 1, `part` is fp32 scratch of splits * M * N elements.
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int int4_matmul_f32(const void* x, const void* w_packed,
                               const void* scale, void* out, void* part,
                               int M, int K, int N, int splits,
                               int k_per_split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N % 2) != 0 || splits < 1 ||
      splits > 65535 || k_per_split <= 0 ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* wb = (const uint8_t*)w_packed;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  float* p = (float*)part;
  if (M <= kMaxM) {
    dim3 grid((N + kGvCols - 1) / kGvCols, splits);
    const bool vec =
        ((N / 2) % kGvBytes) == 0 && ((uintptr_t)w_packed % 4) == 0;
#define INT4_GEMV(MM)                                                      \
  case MM:                                                                 \
    if (vec)                                                               \
      int4_gemv_kernel<MM, true><<<grid, kGvThreads, 0, s>>>(              \
          xf, wb, sc, o, p, K, N, k_per_split);                            \
    else                                                                   \
      int4_gemv_kernel<MM, false><<<grid, kGvThreads, 0, s>>>(             \
          xf, wb, sc, o, p, K, N, k_per_split);                            \
    break;
    switch (M) {
      INT4_GEMV(1) INT4_GEMV(2) INT4_GEMV(3) INT4_GEMV(4)
      INT4_GEMV(5) INT4_GEMV(6) INT4_GEMV(7) INT4_GEMV(8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef INT4_GEMV
  } else {
    if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    int4_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(xf, wb, sc, o, p, M, K,
                                                     N, k_per_split);
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    int4_finish_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(p, sc, o, M, N, splits);
  }
  return (int)cudaGetLastError();
}
