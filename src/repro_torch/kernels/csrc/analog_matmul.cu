// Fused analog MVM for Hopper (sm_90a): DAC quantization of x (eq. 1), an
// MVM against the effective weights with fp32 accuracy, an optional
// per-column offset, and per-column ADC quantization (eq. 2) in the
// epilogue, against a bound that is either given or folded from the
// weights the kernel streams anyway: bound[n] = (lam * beta) *
// max_k |w[k, n]| (kernels/ref.py::adc_bound's op order, bit for bit).
//
// Replaces the TPU kernel src/repro/kernels/analog_matmul.py::analog_matmul
// (bodies _analog_matmul_kernel and _analog_matmul_off_kernel).
//
// What bounds it on this card, and the three mappings:
// * "gemv", decode (M <= 8): reads every weight once and does 2*M flops per
//   weight, so weight bytes over HBM bandwidth bound it. Each lane takes
//   four neighbouring columns (one 16-byte load per K row, a warp reads 512
//   contiguous bytes), holds all M rows of them in registers, reads the
//   DAC-quantized x chunk from shared memory, and K is split over the 8
//   warps of a block and over blocks, so that a projection with N = 2048
//   still puts a few blocks on every SM. Folding the bound costs one max
//   per weight in registers and one more round of the warp reduction.
// * "mma", prefill with in_bits <= 12 (mvm_mma.cuh): the tensor cores with
//   a 2xTF32 split. A small pre-pass quantizes x to the integer lattice
//   n = rint(clip(x) * qi / beta) (exact in TF32 while |n| < 2^11) into an
//   [M, Kp] scratch, zero past K; each 32-deep K tile then takes n * w_hi +
//   n * w_lo on mma.sync, promoted into fp32 by round-to-nearest adds, and
//   the epilogue multiplies by beta / qi before col_off and the ADC. The
//   column max comes from the W fragments already in registers. At the
//   bound, 2*2MKN TF32 flops at 495 TFLOP/s against the weight bytes.
// * "tiled", prefill with in_bits > 12, where n is not exact in TF32: the
//   CUDA cores in true fp32, 64x64 block tiles, 4x4 per thread, bound by
//   the 67 TFLOP/s fp32 rate.
// * Split K (split_k.cuh): each split writes its fp32 partial sum (and,
//   when the bound is folded, its partial column max) to scratch, and
//   analog_finish_kernel adds the splits in a fixed order (deterministic
//   run to run) and takes the max before the epilogue.
//
// The host asks analog_matmul_plan for the mapping (from M and in_bits, never
// from a failure), the split and the scratch of a shape, allocates the
// scratch, and launches with analog_matmul_f32, which picks the same mapping.
//
// Arithmetic follows the reference op for op: IEEE division (never build
// with --use_fast_math), rintf (round half to even, like jnp.round), and
// min(max(.)) for clip. Ragged M, N and K are masked (zero-filled), not
// padded by the caller. beta is a device pointer so that no host sync is
// needed per call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mvm_mma.cuh"
#include "split_k.cuh"

namespace {

constexpr float kTieBreak = 1.0f - 1.0f / 65536.0f;
constexpr int kMaxM = 8;          // most decode rows (the GEMV's M) of a launch
constexpr int kMaxExactBits = 12; // widest DAC whose lattice is exact in TF32

enum Mapping { kGemv = 0, kMma = 1, kTiled = 2 };

// decode (GEMV) mapping
constexpr int kGvWarps = 8;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvVec = 4;                 // columns per lane: one float4
constexpr int kGvCols = 32 * kGvVec;      // 128 columns per block
constexpr int kGvChunk = 512;             // K rows of x_q staged per pass
constexpr int kGvStep = 16;               // split granularity of K

// prefill on the CUDA cores (tiled) mapping
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kTiledThreads = (kBM / kTM) * (kBN / kTN);  // 256

// prefill on the tensor cores (mma) mapping: staged W rows padded so that
// the B fragments (rows t, t + 4; columns g) hit 32 distinct banks
constexpr int kWStride = mvm::kBN + 8;
constexpr int kWFloats = mvm::kBK * kWStride;

int mapping_of(int M, int in_bits) {
  if (M <= kMaxM) return kGemv;
  return in_bits <= kMaxExactBits ? kMma : kTiled;
}

// the mma mapping's block rows: 64 for M <= 64 (the engine's chunk), else 128
int mma_rows(int M) { return M <= 64 ? 64 : 128; }

// row stride of the lattice scratch: K rounded up to whole K tiles
int lattice_stride(int K) {
  return (K + mvm::kBK - 1) / mvm::kBK * mvm::kBK;
}

template <int kBMm>
int mma_smem_bytes() {
  return mvm::kStages * (mvm::Shape<kBMm>::kAFloats + kWFloats) * 4;
}

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

// The epilogue of one output element against its ADC bound `bnd`, or its
// partial sum when K is split (then `bnd` is not read).
__device__ __forceinline__ void store_out(float y, int m, int n, int N,
                                          float bnd,
                                          const float* __restrict__ col_off,
                                          float* __restrict__ out,
                                          float* __restrict__ part,
                                          int M, int split, float qo) {
  if (part != nullptr) {
    part[((size_t)split * M + m) * N + n] = y;
    return;
  }
  if (col_off != nullptr) y = y + col_off[n];
  out[(size_t)m * N + n] = adc_quant(y, bnd, qo);
}

// kM rows (the decode batch) are a template parameter, so that each thread
// holds exactly kM x kGvVec accumulators in registers. bound == nullptr:
// fold the bound from the weights with lam (pmax: the split's column max).
template <int kM, bool kVec>
__global__ void __launch_bounds__(kGvThreads)
analog_gemv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ beta_p,
                   const float* __restrict__ bound,
                   const float* __restrict__ col_off,
                   float* __restrict__ out, float* __restrict__ part,
                   float* __restrict__ pmax, int K, int N, int k_per_split,
                   float qi, float qo, float lam) {
  __shared__ float xs[kM][kGvChunk];
  __shared__ float red[kGvWarps][kGvCols];
  __shared__ float bnd_s[kGvCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kGvCols + lane * kGvVec;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool fold = bound == nullptr;
  const float beta = fmaxf(*beta_p, 1e-8f);
  const float up = qi / beta, down = beta / qi;

  float acc[kM][kGvVec], cmax[kGvVec];
#pragma unroll
  for (int j = 0; j < kGvVec; ++j) {
    cmax[j] = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[m][j] = 0.f;
  }

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
      for (int j = 0; j < kGvVec; ++j) cmax[j] = fmaxf(cmax[j], fabsf(wv[j]));
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float xv = xs[m][k];
#pragma unroll
        for (int j = 0; j < kGvVec; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
  }
  if (fold) {  // the column max over the warps' K slices
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) red[warp][lane * kGvVec + j] = cmax[j];
    __syncthreads();
    const float lb = lam * *beta_p;
    for (int c = threadIdx.x; c < kGvCols; c += kGvThreads) {
      const int n = blockIdx.x * kGvCols + c;
      if (n >= N) continue;
      float mx = 0.f;
      for (int s = 0; s < kGvWarps; ++s) mx = fmaxf(mx, red[s][c]);
      if (part != nullptr)
        pmax[(size_t)blockIdx.y * N + n] = mx;
      else
        bnd_s[c] = lb * mx;
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
      const float bnd =
          part != nullptr ? 0.f : (fold ? bnd_s[c] : bound[n]);
      store_out(y, m, n, N, bnd, col_off, out, part, kM, blockIdx.y, qo);
    }
  }
}

__global__ void __launch_bounds__(kTiledThreads)
analog_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ beta_p,
                    const float* __restrict__ bound,
                    const float* __restrict__ col_off,
                    float* __restrict__ out, float* __restrict__ part,
                    float* __restrict__ pmax, int M, int K, int N,
                    int k_per_split, float qi, float qo, float lam) {
  __shared__ float xs[kBK][kBM + 4];  // transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool fold = bound == nullptr;
  const float beta = fmaxf(*beta_p, 1e-8f);
  const float up = qi / beta, down = beta / qi;

  float acc[kTM][kTN], cmax[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    cmax[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) acc[i][j] = 0.f;
  }

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
      for (int j = 0; j < kTN; ++j) {
        b[j] = ws[kk][tx + j * (kBN / kTN)];
        cmax[j] = fmaxf(cmax[j], fabsf(b[j]));
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float lb = lam * *beta_p;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int gn = n0 + tx + j * (kBN / kTN);
    if (gn >= N) continue;
    // every ty holds the same max; the first row of M tiles writes it
    if (fold && part != nullptr && ty == 0 && blockIdx.y == 0)
      pmax[(size_t)blockIdx.z * N + gn] = cmax[j];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty * kTM + i;
      if (gm >= M) continue;
      const float bnd =
          part != nullptr ? 0.f : (fold ? lb * cmax[j] : bound[gn]);
      store_out(acc[i][j], gm, gn, N, bnd, col_off, out, part, M,
                blockIdx.z, qo);
    }
  }
}

// DAC lattice of x: xq[m][k] = rint(clip(x, -beta, beta) * (qi / beta)) for
// k < K, 0 up to the row stride Kp (whole K tiles, zero past K).
__global__ void analog_lattice_kernel(const float* __restrict__ x,
                                      const float* __restrict__ beta_p,
                                      float* __restrict__ xq, int M, int K,
                                      int Kp, float qi) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * Kp) return;
  const int m = (int)(i / Kp), k = (int)(i % Kp);
  const float beta = fmaxf(*beta_p, 1e-8f);
  xq[i] = k < K ? rintf(fminf(fmaxf(x[(size_t)m * K + k], -beta), beta) *
                        (qi / beta))
                : 0.f;
}

// One 32-deep K tile of the mma mapping: A is the lattice n (exact in
// TF32), B the weights, split into w_hi + w_lo in registers.
template <int kBMm, bool kVecW>
struct AnalogTile {
  using S = mvm::Shape<kBMm>;
  float* a_s;  // ring of lattice tiles [kStages][kBMm][kAStride]
  float* w_s;  // ring of weight tiles [kStages][kBK][kWStride]
  const float* xq;
  const float* w;
  int M, Kp, N, m0, n0, k_end;
  mvm::Frag<kBMm> f;
  float cmax[mvm::kNT];  // max |w| of column g of each n8 tile

  __device__ void stage(int slot, int k0) {
    mvm::stage_f32<kBMm, mvm::kBK, mvm::kAStride, true>(
        a_s + slot * S::kAFloats, xq, Kp, m0, M, k0, Kp);
    mvm::stage_f32<mvm::kBK, mvm::kBN, kWStride, kVecW>(
        w_s + slot * kWFloats, w, N, k0, k_end, n0, N);
  }

  // the tile's products into acc (set with `fresh`); hi products first,
  // so that the two products of an accumulator are not back to back
  __device__ void compute(int slot, float (&acc)[S::kMT][mvm::kNT][4],
                          bool fresh) {
    const float* A = a_s + slot * S::kAFloats;
    const float* B = w_s + slot * kWFloats;
#pragma unroll
    for (int kk = 0; kk < mvm::kBK; kk += 8) {
      uint32_t a[S::kMT][4];
#pragma unroll
      for (int mi = 0; mi < S::kMT; ++mi) {
        const float* p =
            A + (f.wm * S::kWM + mi * 16 + f.g) * mvm::kAStride + kk + f.t;
        a[mi][0] = __float_as_uint(p[0]);
        a[mi][1] = __float_as_uint(p[8 * mvm::kAStride]);
        a[mi][2] = __float_as_uint(p[4]);
        a[mi][3] = __float_as_uint(p[8 * mvm::kAStride + 4]);
      }
#pragma unroll
      for (int nj = 0; nj < mvm::kNT; ++nj) {
        const float* q = B + (kk + f.t) * kWStride + f.wn * mvm::kWN +
                         nj * 8 + f.g;
        const float w0 = q[0], w1 = q[4 * kWStride];
        if (f.wm == 0)  // the other warp row sees the same columns
          cmax[nj] = fmaxf(cmax[nj], fmaxf(fabsf(w0), fabsf(w1)));
        uint32_t h0, l0, h1, l1;
        mvm::split_tf32(w0, h0, l0);
        mvm::split_tf32(w1, h1, l1);
#pragma unroll
        for (int mi = 0; mi < S::kMT; ++mi) {
          if (fresh && kk == 0)
            mvm::mma_tf32_first(acc[mi][nj], a[mi], h0, h1);
          else
            mvm::mma_tf32(acc[mi][nj], a[mi], h0, h1);
        }
#pragma unroll
        for (int mi = 0; mi < S::kMT; ++mi)
          mvm::mma_tf32(acc[mi][nj], a[mi], l0, l1);
      }
    }
  }
};

template <int kBMm, bool kVecW>
__global__ void __launch_bounds__(mvm::kThreads, 1)
analog_mma_kernel(const float* __restrict__ xq, const float* __restrict__ w,
                  const float* __restrict__ beta_p,
                  const float* __restrict__ bound,
                  const float* __restrict__ col_off,
                  float* __restrict__ out, float* __restrict__ part,
                  float* __restrict__ pmax, int M, int K, int Kp, int N,
                  int k_per_split, float qi, float qo, float lam,
                  int promote) {
  using S = mvm::Shape<kBMm>;
  extern __shared__ __align__(16) unsigned char smem[];
  AnalogTile<kBMm, kVecW> tile;
  tile.a_s = reinterpret_cast<float*>(smem);
  tile.w_s = tile.a_s + mvm::kStages * S::kAFloats;
  tile.xq = xq;
  tile.w = w;
  tile.M = M;
  tile.Kp = Kp;
  tile.N = N;
  tile.m0 = blockIdx.y * kBMm;
  tile.n0 = blockIdx.x * mvm::kBN;
  const int k_begin = blockIdx.z * k_per_split;
  tile.k_end = min(K, k_begin + k_per_split);
#pragma unroll
  for (int j = 0; j < mvm::kNT; ++j) tile.cmax[j] = 0.f;

  float tot[S::kMT][mvm::kNT][4];
  mvm::mainloop<S::kMT>(tile, k_begin, tile.k_end, promote != 0, tot);

  // column max: over the four lanes that share column g, then published to
  // shared memory (the ring is free) by the warps of the first M half
  const bool fold = bound == nullptr;
  const mvm::Frag<kBMm>& f = tile.f;
  float* cmax_s = reinterpret_cast<float*>(smem);
  if (fold) {
#pragma unroll
    for (int nj = 0; nj < mvm::kNT; ++nj) {
      float v = tile.cmax[nj];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (f.wm == 0 && f.t == 0) cmax_s[f.wn * mvm::kWN + nj * 8 + f.g] = v;
    }
    __syncthreads();
    if (part != nullptr && blockIdx.y == 0)
      for (int c = threadIdx.x; c < mvm::kBN; c += mvm::kThreads)
        if (tile.n0 + c < N)
          pmax[(size_t)blockIdx.z * N + tile.n0 + c] = cmax_s[c];
  }
  const float beta = fmaxf(*beta_p, 1e-8f);
  const float down = beta / qi, lb = lam * *beta_p;
#pragma unroll
  for (int mi = 0; mi < S::kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < mvm::kNT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = tile.m0 + f.row(mi, e), c = f.col(nj, e);
        const int n = tile.n0 + c;
        if (m >= M || n >= N) continue;
        const float bnd =
            part != nullptr ? 0.f : (fold ? lb * cmax_s[c] : bound[n]);
        store_out(tot[mi][nj][e] * down, m, n, N, bnd, col_off, out, part, M,
                  blockIdx.z, qo);
      }
}

// Adds the K splits of every element in split order, takes the folded
// bound's column max over the splits, then the epilogue.
__global__ void analog_finish_kernel(const float* __restrict__ part,
                                     const float* __restrict__ pmax,
                                     const float* __restrict__ beta_p,
                                     const float* __restrict__ bound,
                                     const float* __restrict__ col_off,
                                     float* __restrict__ out, int M, int N,
                                     int splits, float qo, float lam) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[(size_t)s * total + i];
  const int n = (int)(i % N);
  float bnd;
  if (bound != nullptr) {
    bnd = bound[n];
  } else {
    float mx = 0.f;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pmax[(size_t)s * N + n]);
    bnd = (lam * *beta_p) * mx;
  }
  if (col_off != nullptr) y = y + col_off[n];
  out[i] = adc_quant(y, bnd, qo);
}

// Output tiles of one launch of a mapping.
long long output_tiles(int mapping, int M, int N) {
  if (mapping == kGemv) return (N + kGvCols - 1) / kGvCols;
  if (mapping == kMma)
    return (long long)((N + mvm::kBN - 1) / mvm::kBN) *
           ((M + mma_rows(M) - 1) / mma_rows(M));
  return (long long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
}

// fp32 scratch a launch needs: the lattice of the mma mapping, then the
// splits' partial sums [splits, M, N] and column maxes [splits, N].
long long scratch_floats(int mapping, int M, int K, int N, int splits) {
  long long n = mapping == kMma ? (long long)M * lattice_stride(K) : 0;
  if (splits > 1) n += (long long)splits * (M + 1) * N;
  return n;
}

template <int kBMm, bool kVecW>
int launch_mma(dim3 grid, cudaStream_t s, const float* xq, const float* w,
               const float* beta, const float* bound, const float* off,
               float* out, float* part, float* pmax, int M, int K, int Kp,
               int N, int k_per_split, float qi, float qo, float lam,
               int promote) {
  static unsigned told = 0;
  const int bytes = mma_smem_bytes<kBMm>();
  cudaError_t err =
      mvm::allow_smem(analog_mma_kernel<kBMm, kVecW>, bytes, told);
  if (err != cudaSuccess) return (int)err;
  analog_mma_kernel<kBMm, kVecW><<<grid, mvm::kThreads, bytes, s>>>(
      xq, w, beta, bound, off, out, part, pmax, M, K, Kp, N, k_per_split, qi,
      qo, lam, promote);
  return 0;
}

}  // namespace

// The launch plan of an [M, K] @ [K, N] call with an in_bits DAC on a card
// with `sms` SMs: *mapping is 0 for the GEMV-shaped decode kernel (M <= 8),
// 1 for the tensor-core kernel (M > 8, in_bits <= 12) and 2 for the tiled
// CUDA-core kernel (M > 8, in_bits > 12); K is split into *splits ranges of
// *k_per_split rows; *scratch is the fp32 scratch (elements) the launch
// needs. Returns 0, or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int analog_matmul_plan(int M, int K, int N, int in_bits, int sms,
                                  int* mapping, int* splits,
                                  int* k_per_split, long long* scratch) {
  if (M <= 0 || K <= 0 || N <= 0 || sms <= 0 || in_bits < 2 || in_bits > 24)
    return (int)cudaErrorInvalidValue;
  const int map = mapping_of(M, in_bits);
  if ((map == kMma && (M + mma_rows(M) - 1) / mma_rows(M) > 65535) ||
      (map == kTiled && (M + kBM - 1) / kBM > 65535))
    return (int)cudaErrorInvalidValue;
  const long long tiles = output_tiles(map, M, N);
  if (map == kMma)
    plan_split_k(tiles, K, sms, mvm::kBK, kMmaBlocksPerSm, kMmaMinSplitRows,
                 splits, k_per_split);
  else
    plan_split_k(tiles, K, sms, map == kGemv ? kGvStep : kBK, kBlocksPerSm,
                 kMinSplitRows, splits, k_per_split);
  *mapping = map;
  *scratch = scratch_floats(map, M, K, N, *splits);
  return 0;
}

// Runs the mapping that M and in_bits select (see analog_matmul_plan) with K
// split into `splits` ranges of `k_per_split` rows. `scratch` holds the
// plan's scratch elements (null when it needs none). bound == null folds the
// ADC bound from the weights: (lam * beta) * max_k |w[k, n]|. col_off may be
// null. promote = 0 lets the tensor cores carry the whole K range of the mma
// mapping (to measure what promotion buys; the port passes 1). Returns the
// launches' first error (0 on success).
extern "C" int analog_matmul_f32(const void* x, const void* w,
                                 const void* beta, const void* bound,
                                 const void* col_off, void* out,
                                 void* scratch, int M, int K, int N,
                                 int in_bits, int out_bits, float lam,
                                 int splits, int k_per_split, int promote,
                                 void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || in_bits < 2 || in_bits > 24 ||
      out_bits < 2 || out_bits > 24 || splits < 1 || splits > 65535 ||
      k_per_split <= 0 || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K)
    return (int)cudaErrorInvalidValue;
  const int map = mapping_of(M, in_bits);
  if ((scratch_floats(map, M, K, N, splits) > 0) != (scratch != nullptr) ||
      (map == kMma && splits > 1 && k_per_split % mvm::kBK != 0))
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
  float* sc = (float*)scratch;
  float* xq = nullptr;
  if (map == kMma) {
    xq = sc;
    sc += (size_t)M * lattice_stride(K);
  }
  float* p = splits > 1 ? sc : nullptr;
  float* pm = splits > 1 ? sc + (size_t)splits * M * N : nullptr;
  if (map == kGemv) {
    dim3 grid((N + kGvCols - 1) / kGvCols, splits);
    const bool vec = (N % kGvVec) == 0 && ((uintptr_t)w % 16) == 0;
#define ANALOG_GEMV(MM)                                                    \
  case MM:                                                                 \
    if (vec)                                                               \
      analog_gemv_kernel<MM, true><<<grid, kGvThreads, 0, s>>>(            \
          xf, wf, bf, bnd, off, o, p, pm, K, N, k_per_split, qi, qo, lam); \
    else                                                                   \
      analog_gemv_kernel<MM, false><<<grid, kGvThreads, 0, s>>>(           \
          xf, wf, bf, bnd, off, o, p, pm, K, N, k_per_split, qi, qo, lam); \
    break;
    switch (M) {
      ANALOG_GEMV(1) ANALOG_GEMV(2) ANALOG_GEMV(3) ANALOG_GEMV(4)
      ANALOG_GEMV(5) ANALOG_GEMV(6) ANALOG_GEMV(7) ANALOG_GEMV(8)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ANALOG_GEMV
  } else if (map == kMma) {
    const int kp = lattice_stride(K), rows = mma_rows(M);
    const size_t lat = (size_t)M * kp;
    analog_lattice_kernel<<<(unsigned)((lat + 255) / 256), 256, 0, s>>>(
        xf, bf, xq, M, K, kp, qi);
    dim3 grid((N + mvm::kBN - 1) / mvm::kBN, (M + rows - 1) / rows, splits);
    const bool vec = (N % 4) == 0 && ((uintptr_t)w % 16) == 0;
    int err;
    if (rows == 64)
      err = vec ? launch_mma<64, true>(grid, s, xq, wf, bf, bnd, off, o, p,
                                       pm, M, K, kp, N, k_per_split, qi, qo,
                                       lam, promote)
                : launch_mma<64, false>(grid, s, xq, wf, bf, bnd, off, o, p,
                                        pm, M, K, kp, N, k_per_split, qi, qo,
                                        lam, promote);
    else
      err = vec ? launch_mma<128, true>(grid, s, xq, wf, bf, bnd, off, o, p,
                                        pm, M, K, kp, N, k_per_split, qi, qo,
                                        lam, promote)
                : launch_mma<128, false>(grid, s, xq, wf, bf, bnd, off, o, p,
                                         pm, M, K, kp, N, k_per_split, qi,
                                         qo, lam, promote);
    if (err) return err;
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    analog_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(
        xf, wf, bf, bnd, off, o, p, pm, M, K, N, k_per_split, qi, qo, lam);
  }
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const int threads = 256;
    analog_finish_kernel<<<(unsigned)((total + threads - 1) / threads),
                           threads, 0, s>>>(p, pm, bf, bnd, off, o, M, N,
                                            splits, qo, lam);
  }
  return (int)cudaGetLastError();
}
