// The tensor-core prefill mapping shared by analog_matmul.cu and
// int4_matmul.cu: an [M, K] @ [K, N] product on mma.sync.m16n8k8 with TF32
// operands that still holds fp32 accuracy.
//
// Why TF32 is exact enough here. A TF32 operand keeps 11 significant bits,
// and the product of two TF32 values is exact in fp32. Each kernel has one
// operand that is exact in TF32 already (the DAC lattice integer n with
// |n| < 2^11 in analog_matmul, the int4 weight in int4_matmul) and splits the
// other into v = hi + lo with hi = tf32(v), lo = tf32(v - hi), which leaves
// at most 2^-22 |v| out. So each fp32 product becomes two exact TF32
// products (a 2xTF32 split), about four fp32 roundings of error.
//
// The tensor core's own fp32 adds truncate, so a bias would grow with K if
// it carried the whole sum. The K loop therefore runs in 32-deep tiles: the
// mma accumulator of a tile starts at zero and is added into the running
// sum by ordinary round-to-nearest FADDs ("promotion"), so the sum over K
// behaves like a CUDA-core fp32 dot.
//
// Why mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
// shared memory, and the weights are stored [K, N] (N-major).
//
// Block tile kBM x 128 (kBM = 128, or 64 for M <= 64), 8 warps in a 2 x 4
// grid, each warp (kBM / 2) x 32 of m16n8 tiles; K in 32-deep tiles through
// a 4-deep ring of cp.async copies in dynamic shared memory (16-byte copies
// where the rows are aligned, 4-byte ones otherwise, zero-filled past the
// edges). Staged rows are padded so that fragment reads hit 32 distinct
// banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mvm {

constexpr int kBN = 128;            // block tile columns
constexpr int kBK = 32;             // K rows of a staged tile: one span
constexpr int kStages = 4;          // depth of the cp.async ring
constexpr int kWarps = 8;           // 2 (M) x 4 (N)
constexpr int kThreads = 32 * kWarps;
constexpr int kWN = kBN / 4;        // columns of a warp tile
constexpr int kNT = kWN / 8;        // n8 tiles of a warp tile
constexpr int kAStride = kBK + 4;   // floats of a staged A row

template <int kBM>
struct Shape {
  static constexpr int kWM = kBM / 2;   // rows of a warp tile
  static constexpr int kMT = kWM / 16;  // m16 tiles of a warp tile
  static constexpr int kAFloats = kBM * kAStride;
};

// fp32 -> TF32, round to nearest with ties away (the low 13 bits cleared).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo in TF32 with |v - hi - lo| <= 2^-22 |v| (v - hi is exact).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b: the same product from a zero accumulator, so that a span's
// first product needs no zeroed registers.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// Copies kBytes (16, 8 or 4) global -> shared; zero-fills them when !valid
// (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stages the fp32 tile g[r0 + r][c0 + c] (r < kRows, c < kCols) of a
// row-major matrix with leading dimension ld into s[r * kStride + c];
// elements with r0 + r >= rlim or c0 + c >= clim become zero. kVec: 16-byte
// copies (ld, c0 and clim multiples of 4, g 16-byte aligned), else 4-byte.
template <int kRows, int kCols, int kStride, bool kVec>
__device__ __forceinline__ void stage_f32(float* s, const float* g, int ld,
                                          int r0, int rlim, int c0,
                                          int clim) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kPer = kCols / kW, kCopies = kRows * kPer;
#pragma unroll
  for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) break;
    const int r = i / kPer, c = (i % kPer) * kW;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    const float* src = ok ? g + (size_t)(r0 + r) * ld + c0 + c : g;
    cp_async<4 * kW>(s + r * kStride + c, src, ok);
  }
}

// Coordinates of this thread in the block tile.
template <int kBM>
struct Frag {
  int g, t;    // lane / 4 and lane % 4: fragment row / column groups
  int wm, wn;  // warp row and column in the 2 x 4 warp grid
  __device__ Frag() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane >> 2;
    t = lane & 3;
    wm = warp / 4;
    wn = warp % 4;
  }
  // row in the block tile of accumulator element e of m16 tile mi
  __device__ int row(int mi, int e) const {
    return wm * Shape<kBM>::kWM + mi * 16 + g + (e >> 1) * 8;
  }
  // column in the block tile of accumulator element e of n8 tile nj
  __device__ int col(int nj, int e) const {
    return wn * kWN + nj * 8 + 2 * t + (e & 1);
  }
};

// The block's K loop over [k_begin, k_end) in kBK-deep tiles through the
// ring. tile.stage(slot, k0) issues the copies of the tile at k0 into ring
// slot `slot`; tile.compute(slot, acc, fresh) adds the tile's products into
// acc, or with `fresh` sets acc to them. With `promote`, acc starts every
// tile afresh and is added into tot by round-to-nearest FADDs; without it,
// the tensor cores carry the whole range and tot takes it once at the end.
// The ring is free on return.
template <int kMT, class Tile>
__device__ __forceinline__ void mainloop(Tile& tile, int k_begin, int k_end,
                                         bool promote,
                                         float (&tot)[kMT][kNT][4]) {
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) tile.stage(s, k_begin + s * kBK);
    cp_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < tiles) tile.stage(next % kStages, k_begin + next * kBK);
    cp_commit();
    tile.compute(kt % kStages, acc, promote || kt == 0);
    if (promote) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[i][j][e] += acc[i][j][e];
    }
  }
  if (!promote) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] = acc[i][j][e];
  }
  cp_wait<0>();
  __syncthreads();
}

// Lets `kernel` use `bytes` of dynamic shared memory on the current device
// (above 48 KB this must precede the launch). `done` is the caller's flag
// word for this kernel, bit d set once device d has been told.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace mvm
