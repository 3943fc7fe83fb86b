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
// Nibbles become floats without an int-to-float conversion (I2F issues at
// an eighth of the FFMA rate on sm_90): the nibble is placed in the low
// mantissa bits of 2^23 (0x4B000000 | nibble, by PRMT or LOP3) and
// 2^23 + 8 is subtracted, which is exactly nibble - 8.
//
// What bounds it on this card, and the two mappings:
// * "gemv", decode (M <= 8): reads every packed byte once and does 4*M
//   flops per byte, so packed weight bytes (K*N/2) over HBM bandwidth bound
//   it. Each lane takes four neighbouring bytes (eight columns) of a K row
//   and keeps the loads of kGvRows K rows in flight, the next group's
//   issued before the current one is used (the first before x is staged);
//   all M rows of its columns accumulate in registers, x comes from shared
//   memory, and K is split over the 8 warps of a block and over blocks so
//   that every SM gets several blocks.
// * "mma", prefill (M > 8; mvm_mma.cuh): the tensor cores with a 2xTF32
//   split. The int4 weight is exact in TF32; x is split in registers into
//   x_hi + x_lo, so each K tile takes x_hi * w + x_lo * w on mma.sync, and
//   the 32-deep tiles are promoted into fp32 by round-to-nearest adds: the
//   result stays inside the fp32 dot error bound. At the bound, 2*2MKN TF32
//   flops at 495 TFLOP/s against the packed bytes.
// * Split K (split_k.cuh): each split writes its fp32 partial sum to
//   scratch, and int4_finish_kernel adds the splits in a fixed order, then
//   scales.
// Ragged M and K, and N up to the packed width, are masked (zero-filled x,
// 0x88 bytes in the GEMV), not padded by the caller.
//
// The host asks int4_matmul_plan for the mapping, the split and the scratch
// of a shape, allocates the scratch, and launches with int4_matmul_f32,
// which picks the same mapping from M.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mvm_mma.cuh"
#include "split_k.cuh"

namespace {

constexpr int kMaxM = 8;  // most decode rows (the GEMV's M) of one launch

enum Mapping { kGemv = 0, kMma = 1 };

// decode (GEMV) mapping
constexpr int kGvWarps = 8;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvBytes = 4;                  // packed bytes per lane
constexpr int kGvLaneCols = 2 * kGvBytes;    // 8 columns per lane
constexpr int kGvCols = 32 * kGvLaneCols;    // 256 columns per block
constexpr int kGvChunk = 512;                // K rows of x staged per pass
constexpr int kGvRows = 8;                   // K rows in flight per lane
constexpr int kGvStep = 16;                  // split granularity of K
constexpr uint32_t kZeroBytes = 0x88888888u; // four bytes of zero int4s

// prefill (mma) mapping: staged packed rows padded to 80 bytes so that the
// B fragments' words (rows t and t + 4) hit distinct banks
constexpr int kWBytes = mvm::kBN / 2;          // packed bytes of a tile row
constexpr int kWStride = kWBytes + 16;
constexpr int kWTileBytes = mvm::kBK * kWStride;

constexpr float kMagic = 8388616.0f;  // 2^23 + 8

// nibble c (0..7) of v as the float nibble - 8
__device__ __forceinline__ float nib(uint32_t v, int c) {
  return __uint_as_float(0x4B000000u | ((v >> (4 * c)) & 0xFu)) - kMagic;
}

// the eight columns of four packed bytes as floats: w[2b] from the low and
// w[2b + 1] from the high nibble of byte b (one PRMT and one FADD each)
__device__ __forceinline__ void unpack8(uint32_t v, float (&w)[8]) {
  const uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    w[2 * b] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | b)) -
               kMagic;
    w[2 * b + 1] =
        __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | b)) - kMagic;
  }
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

// The four packed bytes of this lane in K rows warp-strided from `k`, or
// kZeroBytes past `kc` (and past the packed width).
template <bool kVec>
__device__ __forceinline__ void load_rows(uint32_t (&v)[kGvRows],
                                          const uint8_t* __restrict__ bp,
                                          int k, int kc, int NH, int j0) {
#pragma unroll
  for (int i = 0; i < kGvRows; ++i) {
    const int r = k + i * kGvWarps;
    v[i] = kZeroBytes;
    if (r >= kc) continue;
    const uint8_t* row = bp + (size_t)r * NH;
    if (kVec) {  // NH % 4 == 0: j0 < NH covers all four bytes
      if (j0 < NH) v[i] = __ldg(reinterpret_cast<const uint32_t*>(row));
    } else {
#pragma unroll
      for (int b = 0; b < kGvBytes; ++b)
        if (j0 + b < NH)
          v[i] = (v[i] & ~(0xFFu << (8 * b))) | ((uint32_t)row[b] << (8 * b));
    }
  }
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
    const uint8_t* bp = wp + (size_t)k0 * NH + j0;
    uint32_t v[kGvRows];
    load_rows<kVec>(v, bp, warp, kc, NH, j0);  // in flight while x stages
    __syncthreads();
    for (int i = threadIdx.x; i < kM * kc; i += kGvThreads) {
      const int m = i / kc, k = i - m * kc;
      xs[m][k] = x[(size_t)m * K + k0 + k];
    }
    __syncthreads();
    for (int kb = warp; kb < kc; kb += kGvWarps * kGvRows) {
      uint32_t nv[kGvRows];
      load_rows<kVec>(nv, bp, kb + kGvWarps * kGvRows, kc, NH, j0);
#pragma unroll
      for (int i = 0; i < kGvRows; ++i) {
        const int k = kb + i * kGvWarps;
        if (k >= kc) break;
        float wv[kGvLaneCols];
        unpack8(v[i], wv);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float xv = xs[m][k];
#pragma unroll
          for (int c = 0; c < kGvLaneCols; ++c)
            acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < kGvRows; ++i) v[i] = nv[i];
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

// Stages the packed tile g[r0 + r][c0 + c] (r < kBK, c < kWBytes) of
// [K, NH] bytes into s[r * kWStride + c] in copies of kW bytes (16 or 4:
// cp.async, NH and the base aligned to them; 1: plain loads), zero past
// rlim rows and clim bytes.
template <int kW>
__device__ __forceinline__ void stage_packed(uint8_t* s, const uint8_t* g,
                                             int NH, int r0, int rlim,
                                             int c0, int clim) {
  constexpr int kPer = kWBytes / kW, kCopies = mvm::kBK * kPer;
#pragma unroll
  for (int it = 0; it < (kCopies + mvm::kThreads - 1) / mvm::kThreads;
       ++it) {
    const int i = threadIdx.x + it * mvm::kThreads;
    if (kCopies % mvm::kThreads != 0 && i >= kCopies) break;
    const int r = i / kPer, c = (i % kPer) * kW;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    const uint8_t* src = ok ? g + (size_t)(r0 + r) * NH + c0 + c : g;
    if constexpr (kW == 1)
      s[r * kWStride + c] = ok ? *src : 0;
    else
      mvm::cp_async<kW>(s + r * kWStride + c, src, ok);
  }
}

// One 32-deep K tile of the mma mapping: A is x, split into x_hi + x_lo in
// registers, B the int4 weights (exact in TF32). Masked K rows of x are
// zero, so the zero-filled bytes there (nibble - 8 = -8) add nothing.
template <int kBMm, bool kVecX, int kWCopy>
struct Int4Tile {
  using S = mvm::Shape<kBMm>;
  float* a_s;    // ring of x tiles [kStages][kBMm][kAStride]
  uint8_t* w_s;  // ring of packed tiles [kStages][kBK][kWStride]
  const float* x;
  const uint8_t* wp;
  int M, K, NH, m0, n0, k_end;
  mvm::Frag<kBMm> f;

  __device__ void stage(int slot, int k0) {
    mvm::stage_f32<kBMm, mvm::kBK, mvm::kAStride, kVecX>(
        a_s + slot * S::kAFloats, x, K, m0, M, k0, k_end);
    stage_packed<kWCopy>(w_s + slot * kWTileBytes, wp, NH, k0, k_end,
                         n0 / 2, NH);
  }

  // the tile's products into acc (set with `fresh`); x_hi products first,
  // so that the two products of an accumulator are not back to back
  __device__ void compute(int slot, float (&acc)[S::kMT][mvm::kNT][4],
                          bool fresh) {
    const float* A = a_s + slot * S::kAFloats;
    const uint8_t* B = w_s + slot * kWTileBytes;
#pragma unroll
    for (int kk = 0; kk < mvm::kBK; kk += 8) {
      uint32_t ah[S::kMT][4], al[S::kMT][4];
#pragma unroll
      for (int mi = 0; mi < S::kMT; ++mi) {
        const float* p =
            A + (f.wm * S::kWM + mi * 16 + f.g) * mvm::kAStride + kk + f.t;
        mvm::split_tf32(p[0], ah[mi][0], al[mi][0]);
        mvm::split_tf32(p[8 * mvm::kAStride], ah[mi][1], al[mi][1]);
        mvm::split_tf32(p[4], ah[mi][2], al[mi][2]);
        mvm::split_tf32(p[8 * mvm::kAStride + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < mvm::kNT; ++nj) {
        // the word of columns wn*32 + nj*8 .. +7 in rows t and t + 4
        const uint8_t* q =
            B + (kk + f.t) * kWStride + (f.wn * mvm::kWN + nj * 8) / 2;
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(q);
        const uint32_t v1 =
            *reinterpret_cast<const uint32_t*>(q + 4 * kWStride);
        const uint32_t b0 = __float_as_uint(nib(v0, f.g));
        const uint32_t b1 = __float_as_uint(nib(v1, f.g));
#pragma unroll
        for (int mi = 0; mi < S::kMT; ++mi) {
          if (fresh && kk == 0)
            mvm::mma_tf32_first(acc[mi][nj], ah[mi], b0, b1);
          else
            mvm::mma_tf32(acc[mi][nj], ah[mi], b0, b1);
        }
#pragma unroll
        for (int mi = 0; mi < S::kMT; ++mi)
          mvm::mma_tf32(acc[mi][nj], al[mi], b0, b1);
      }
    }
  }
};

template <int kBMm, bool kVecX, int kWCopy>
__global__ void __launch_bounds__(mvm::kThreads, 1)
int4_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ part, int M, int K, int N,
                int k_per_split) {
  using S = mvm::Shape<kBMm>;
  extern __shared__ __align__(16) unsigned char smem[];
  Int4Tile<kBMm, kVecX, kWCopy> tile;
  tile.a_s = reinterpret_cast<float*>(smem);
  tile.w_s = reinterpret_cast<uint8_t*>(tile.a_s +
                                        mvm::kStages * S::kAFloats);
  tile.x = x;
  tile.wp = wp;
  tile.M = M;
  tile.K = K;
  tile.NH = N / 2;
  tile.m0 = blockIdx.y * kBMm;
  tile.n0 = blockIdx.x * mvm::kBN;
  const int k_begin = blockIdx.z * k_per_split;
  tile.k_end = min(K, k_begin + k_per_split);

  float tot[S::kMT][mvm::kNT][4];
  mvm::mainloop<S::kMT>(tile, k_begin, tile.k_end, true, tot);

  const mvm::Frag<kBMm>& f = tile.f;
#pragma unroll
  for (int mi = 0; mi < S::kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < mvm::kNT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = tile.m0 + f.row(mi, e), n = tile.n0 + f.col(nj, e);
        if (m < M && n < N)
          store_out(tot[mi][nj][e], m, n, N, scale, out, part, M,
                    blockIdx.z);
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

// the mma mapping's block rows: 64 for M <= 64 (the engine's chunk), else 128
int mma_rows(int M) { return M <= 64 ? 64 : 128; }

template <int kBMm>
int mma_smem_bytes() {
  return mvm::kStages * (mvm::Shape<kBMm>::kAFloats * 4 + kWTileBytes);
}

// Output tiles of one launch of the mapping that M selects.
long long output_tiles(int M, int N) {
  if (M <= kMaxM) return (N + kGvCols - 1) / kGvCols;
  return (long long)((N + mvm::kBN - 1) / mvm::kBN) *
         ((M + mma_rows(M) - 1) / mma_rows(M));
}

template <int kBMm, bool kVecX, int kWCopy>
int launch_mma(dim3 grid, cudaStream_t s, const float* x, const uint8_t* wp,
               const float* scale, float* out, float* part, int M, int K,
               int N, int k_per_split) {
  static unsigned told = 0;
  const int bytes = mma_smem_bytes<kBMm>();
  cudaError_t err =
      mvm::allow_smem(int4_mma_kernel<kBMm, kVecX, kWCopy>, bytes, told);
  if (err != cudaSuccess) return (int)err;
  int4_mma_kernel<kBMm, kVecX, kWCopy><<<grid, mvm::kThreads, bytes, s>>>(
      x, wp, scale, out, part, M, K, N, k_per_split);
  return 0;
}

// the copy width of the packed tile (16, 4 or 1 bytes) and of x, by row
// alignment; picks the instantiation
template <int kBMm>
int launch_mma_rows(dim3 grid, cudaStream_t s, const float* x,
                    const uint8_t* wp, const float* scale, float* out,
                    float* part, int M, int K, int N, int k_per_split) {
  const int NH = N / 2;
  const bool vx = (K % 4) == 0 && ((uintptr_t)x % 16) == 0;
  const int wc = (NH % 16 == 0 && (uintptr_t)wp % 16 == 0) ? 16
                 : (NH % 4 == 0 && (uintptr_t)wp % 4 == 0) ? 4
                                                            : 1;
#define INT4_MMA(VX, WC)                                                  \
  if (vx == VX && wc == WC)                                               \
    return launch_mma<kBMm, VX, WC>(grid, s, x, wp, scale, out, part, M,  \
                                    K, N, k_per_split);
  INT4_MMA(true, 16) INT4_MMA(true, 4) INT4_MMA(true, 1)
  INT4_MMA(false, 16) INT4_MMA(false, 4) INT4_MMA(false, 1)
#undef INT4_MMA
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch plan of an [M, K] @ [K, N] call (N unpacked) on a card with
// `sms` SMs: *mapping is 0 for the GEMV-shaped decode kernel (M <= 8) and 1
// for the tensor-core kernel; K is split into *splits ranges of
// *k_per_split rows; *scratch is the fp32 scratch (elements) the launch
// needs. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int int4_matmul_plan(int M, int K, int N, int sms, int* mapping,
                                int* splits, int* k_per_split,
                                long long* scratch) {
  if (M <= 0 || K <= 0 || N <= 0 || (N % 2) != 0 || sms <= 0 ||
      (M > kMaxM && (M + mma_rows(M) - 1) / mma_rows(M) > 65535))
    return (int)cudaErrorInvalidValue;
  if (M <= kMaxM)
    plan_split_k(output_tiles(M, N), K, sms, kGvStep, kBlocksPerSm,
                 kMinSplitRows, splits, k_per_split);
  else
    plan_split_k(output_tiles(M, N), K, sms, mvm::kBK, kMmaBlocksPerSm,
                 kMmaMinSplitRows, splits, k_per_split);
  *mapping = M <= kMaxM ? kGemv : kMma;
  *scratch = *splits > 1 ? (long long)*splits * M * N : 0;
  return 0;
}

// Runs the mapping that M selects (see int4_matmul_plan) with K split into
// `splits` ranges of `k_per_split` rows; N is the unpacked width (even).
// With splits > 1, `scratch` holds splits * M * N fp32 partial sums (else
// null). Returns the launches' first error (0 on success).
extern "C" int int4_matmul_f32(const void* x, const void* w_packed,
                               const void* scale, void* out, void* scratch,
                               int M, int K, int N, int splits,
                               int k_per_split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N % 2) != 0 || splits < 1 ||
      splits > 65535 || k_per_split <= 0 ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K ||
      (splits > 1) != (scratch != nullptr) ||
      (M > kMaxM && splits > 1 && k_per_split % mvm::kBK != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* wb = (const uint8_t*)w_packed;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  float* p = (float*)scratch;
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
    const int rows = mma_rows(M);
    dim3 grid((N + mvm::kBN - 1) / mvm::kBN, (M + rows - 1) / rows, splits);
    const int err =
        rows == 64 ? launch_mma_rows<64>(grid, s, xf, wb, sc, o, p, M, K, N,
                                         k_per_split)
                   : launch_mma_rows<128>(grid, s, xf, wb, sc, o, p, M, K, N,
                                          k_per_split);
    if (err) return err;
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    int4_finish_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(p, sc, o, M, N, splits);
  }
  return (int)cudaGetLastError();
}
