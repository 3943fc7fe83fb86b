// Chunked Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel), extended to the whole of the JAX package's
// models/mamba2.py::_ssd_with_state: the incoming state h0 and the final
// state are folded in, so the sequence is read once.
//
// Inputs, in the mixer's own layout (element strides; the last dimension
// of each is contiguous): x [B, S, H, P], dt [B, S, H], a [H] (negative),
// b / c [B, S, G, N] (head h reads group h / (H / G); the groups are never
// repeated to heads), h0 [B*H, N, P] contiguous or null (zero state).
// Outputs: y [B, S, H, P] and the final state [B*H, N, P], contiguous fp32.
//
// Per chunk of L tokens, with cums the inclusive cumulative sum of dt * a
// inside the chunk, total = cums_{L-1} and h_c the state entering chunk c:
//   y_t     = sum_{r <= t} (C_t . B_r) exp(min(cums_t - cums_r, 0)) dt_r x_r
//             + exp(cums_t) (C_t . h_c)
//   S_c     = sum_r B_r^T (w_r x_r),  w_r = exp(total - cums_r) dt_r
//   h_{c+1} = exp(total) h_c + S_c
// A ragged last chunk is padded with dt = x = b = c = 0, which leaves the
// state as it was; the padded rows' y is not written.
//
// Only the [N, P] recurrence over chunks is sequential. The chunk summary
// S_c, C B^T and the intra-chunk y do not depend on h_c, so a scan of more
// than 32 tokens runs at L = 64 as three launches:
//   1. chunk pass, grid (H + G, chunks, B): a block per (row, chunk, head)
//      writes S_c [N, P] and total to the scratch; a block per (row,
//      chunk, group) writes C B^T [L, L] once for all of the group's heads.
//   2. state pass, grid (N P / 1024, H, B): each thread owns 4 elements of
//      one state and runs h_{c+1} = exp(total_c) h_c + S_c over the chunks,
//      writing each entering state h_c over S_c and the final state out.
//      It loads 8 chunks' S_c and totals ahead of the chain; being
//      elementwise over (row, head, N P), it fills the card at batch 1.
//   3. output pass, grid (H, chunks, B): y = (C B^T ⊙ decay) (dt x)
//      + exp(cums) (C h_c). The first product runs while C and h_c are
//      still being copied in; they come in two 64-wide tiles along N, the
//      second into the buffers the first product is done with, so that
//      three blocks fit on an SM.
// A scan of at most 32 tokens (one chunk at L = 32), as every chunk
// forward of the continuous engine at its chunk of 32 is, is one launch
// with no scratch, grid (P / 16, H, B): each block does all of the chunk
// for 16 columns of P (the SSD is independent across P) and recomputes its
// [L, L] C B^T. It is bound by latency, not work: its 4 warps split the k
// steps of C B^T and of y between them (partial sums reduced in shared
// memory in a fixed order), so that no warp runs a long chain of dependent
// mma. At 2 x 32 on an H100 it takes well under half the three passes'
// time; the same kernel at L = 64 lost to the passes at 2 x 48, so a
// longer scan takes the passes.
//
// The chunk products are [M, K] x [K, N] products in shared memory with K
// = L or N, on the tensor cores by mma.sync.m16n8k8 in split TF32: each
// fp32 operand v = hi + lo (hi = tf32(v), lo = tf32(v - hi)) and each
// product hi*lo + lo*hi + hi*hi (3xTF32), the small ones first, which keeps
// about fp32 accuracy (plain TF32 would not). K is at most 128, so no
// promotion of the accumulators is needed for the 2e-4 tolerance. The
// cumulative sums are a warp scan in a fixed order; there are no atomics,
// so two runs give the same bits. Tiles are staged by cp.async (16-byte
// copies where the strides allow), rows padded so that fragment reads hit
// 32 distinct banks. expf (not __expf), no fast math.
//
// What bounds it on this card. The work is operations: per token and head
// L P (intra-chunk y) + 2 N P (C h and S_c) products plus L N / (H / G)
// for C B^T, against 4 (P + 2 N G / H + 1) bytes read and 4 P written. The
// passes add the scratch: N P floats per chunk and head (S_c, overwritten
// by h_c), written twice and read twice, which is the state pass's whole
// traffic and bounds it by bytes. The chunk and output passes are bound by
// staging (every head's block copies its group's B or C and C B^T from L2)
// and by mma issue (each k step splits its fragments: a cvt, a sub and a
// cvt per element); the one-chunk kernel by latency.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mvm_mma.cuh"

namespace {

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;        // chunk, state and output passes
constexpr int kOneThreads = 128;     // the one-chunk kernel: 4 warps
constexpr int kSlice = 16;           // P columns of a one-chunk block
constexpr int kAhead = 8;            // chunks the state pass loads ahead
constexpr int kOneChunk = 32;        // L of a scan in one launch
constexpr int kMultiChunk = 64;      // L of the three passes
// padded row lengths (floats) of the staged operands: 4 mod 32 for rows
// read along K, 8 or 24 mod 32 for rows read across the fragment's M or N
constexpr int kLdK = kMaxN + 4;      // C or B rows read along N
constexpr int kLdBT = kMaxN + 8;     // B rows read across N (B^T operand)
constexpr int kLdP = kMaxP + 8;      // x or state rows read across P
constexpr int kLdS = kSlice + 8;     // a one-chunk block's rows of P
constexpr int kNTile = 64;           // N of a tile of C in the output pass
constexpr int kLdT = kNTile + 4;     // C rows of one such tile, along N

struct Strides {                     // element strides of the leading dims
  long long b, s, h;
};

struct Args {
  const float* x;
  Strides xs;
  const float* dt;
  Strides ds;
  const float* a;
  const float* b;
  Strides bs;
  const float* c;
  Strides cs;
  const float* h0;
  float* y;
  float* h_out;
  int S, H, P, N, G, chunks;
};

// ---------------------------------------------------------------------------
// building blocks
// ---------------------------------------------------------------------------

// acc[mi][nj] += sum_k A[m][k] B[k][n] over the warp tile whose m16 tile mi
// starts at row m0 + 16 mi and n8 tile nj at column n0 + 8 nj, for the
// 8-deep k steps k0 = kb, kb + ks, ... below K; A[m][k] is at A[m * kSAM +
// k * kSAK] and B[k][n] at B[k * kSBK + n * kSBN] in shared memory. Tiles
// at rows >= mlim or columns >= nlim are skipped (the test is
// warp-uniform). 3xTF32: acc += lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b).
template <int kMT, int kNT, int kSAM, int kSAK, int kSBK, int kSBN>
__device__ __forceinline__ void warp_mma(float (&acc)[kMT][kNT][4],
                                         const float* A, const float* B,
                                         int m0, int n0, int K, int mlim,
                                         int nlim, int kb = 0, int ks = 8) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k0 = kb; k0 < K; k0 += ks) {
    uint32_t ah[kMT][4] = {}, al[kMT][4] = {};
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      if (m0 + 16 * mi >= mlim) continue;
      const float* p = A + (m0 + 16 * mi + g) * kSAM + (k0 + t) * kSAK;
      mvm::split_tf32(p[0], ah[mi][0], al[mi][0]);
      mvm::split_tf32(p[8 * kSAM], ah[mi][1], al[mi][1]);
      mvm::split_tf32(p[4 * kSAK], ah[mi][2], al[mi][2]);
      mvm::split_tf32(p[8 * kSAM + 4 * kSAK], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
      if (n0 + 8 * nj >= nlim) continue;
      const float* q = B + (k0 + t) * kSBK + (n0 + 8 * nj + g) * kSBN;
      uint32_t bh0, bl0, bh1, bl1;
      mvm::split_tf32(q[0], bh0, bl0);
      mvm::split_tf32(q[4 * kSBK], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if (m0 + 16 * mi >= mlim) continue;
        mvm::mma_tf32(acc[mi][nj], al[mi], bh0, bh1);
        mvm::mma_tf32(acc[mi][nj], ah[mi], bl0, bl1);
        mvm::mma_tf32(acc[mi][nj], ah[mi], bh0, bh1);
      }
    }
  }
}

// Calls f(row, col, element) for each accumulator element of the warp
// tile (tiles skipped as in warp_mma); element e of an m16n8 tile lies at
// row g + 8 (e / 2), column 2 t + e % 2.
template <int kMT, int kNT, class F>
__device__ __forceinline__ void for_acc(float (&acc)[kMT][kNT][4], int m0,
                                        int n0, int mlim, int nlim, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
      if (m0 + 16 * mi >= mlim || n0 + 8 * nj >= nlim) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + 16 * mi + g + 8 * (e >> 1), n0 + 8 * nj + 2 * t + (e & 1),
          acc[mi][nj][e]);
    }
}

// y = intra + exp(cums_row) inter over the warp tile (all its tiles)
template <int kMT, int kNT>
__device__ __forceinline__ void add_carried(float (&intra)[kMT][kNT][4],
                                            const float (&inter)[kMT][kNT][4],
                                            const float* cum_s, int m0) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float ec = expf(cum_s[m0 + 16 * mi + g + 8 * half]);
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e)
          intra[mi][nj][e] = __fadd_rn(intra[mi][nj][e],
                                       __fmul_rn(ec, inter[mi][nj][e]));
    }
}

// Writes the warp tile's accumulators to out[row * ld + col] for rows <
// rows, two neighbouring columns per 8-byte store (ld and out even).
template <int kMT, int kNT>
__device__ __forceinline__ void store_acc(const float (&acc)[kMT][kNT][4],
                                          float* out, long long ld, int m0,
                                          int n0, int mlim, int nlim,
                                          int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj) {
      if (m0 + 16 * mi >= mlim || n0 + 8 * nj >= nlim) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + 16 * mi + g + 8 * half;
        if (r < rows)
          *reinterpret_cast<float2*>(out + r * ld + n0 + 8 * nj + 2 * t) =
              make_float2(acc[mi][nj][2 * half], acc[mi][nj][2 * half + 1]);
      }
    }
}

// Issues cp.async copies of `rows` rows of `cols` floats from g (row stride
// gs elements) into s (row stride ld); rows >= valid are zero-filled (g is
// then not read). 16-byte copies where g and gs are 16-byte aligned.
__device__ __forceinline__ void stage_rows(float* s, int ld, const float* g,
                                           long long gs, int rows, int valid,
                                           int cols) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(g) | (uintptr_t)(gs * 4)) & 15) == 0;
  if (vec) {
    const int per = cols >> 2;
    for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
      const int r = i / per, col = (i - r * per) << 2;
      const bool ok = r < valid;
      mvm::cp_async<16>(s + r * ld + col, ok ? g + r * gs + col : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, col = i - r * cols;
      const bool ok = r < valid;
      mvm::cp_async<4>(s + r * ld + col, ok ? g + r * gs + col : g, ok);
    }
  }
}

// cum_s[t] = sum_{r <= t} dt_s[r] * a for t < L, by one warp: each lane sums
// its L / 32 consecutive terms, then a shuffle scan of the lanes' sums; the
// order is fixed, so every pass gets the same bits.
template <int L>
__device__ __forceinline__ void chunk_cums(const float* dt_s, float a,
                                           float* cum_s) {
  constexpr int E = L / 32;
  const int lane = threadIdx.x & 31;
  float v[E], run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run = __fadd_rn(run, __fmul_rn(dt_s[lane * E + e], a));
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = __fadd_rn(incl, o);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) cum_s[lane * E + e] = __fadd_rn(excl, v[e]);
}

__device__ __forceinline__ const float* tok(const float* p, Strides st,
                                            int row, int t, int h) {
  return p + row * st.b + (long long)t * st.s + h * st.h;
}

// dt of the chunk's tokens [c0, c0 + len) into dt_s[0, L), zero past len
__device__ __forceinline__ void load_dt(const Args& p, int row, int head,
                                        int c0, int len, int L,
                                        float* dt_s) {
  for (int t = threadIdx.x; t < L; t += blockDim.x)
    dt_s[t] = t < len ? *tok(p.dt, p.ds, row, c0 + t, head) : 0.f;
}

// ---------------------------------------------------------------------------
// a scan of one chunk: one launch
// ---------------------------------------------------------------------------

namespace one {                      // smem layout, floats
constexpr int L = kOneChunk, kLdM = L + 4, kLdY = kSlice + 4;
// C B^T and y are one 32 x 32 and one 32 x 16 warp tile: the 4 warps
// split the k steps of each and their partial sums meet in red before a
// fixed-order reduction
constexpr int kParts = kOneThreads / 32;
constexpr int kRedCb = kParts * L * kLdM, kRedY = kParts * L * kLdY;
constexpr int kC = 0, kB = kC + L * kLdK, kM = kB + L * kLdK,
              kRed = kM + L * kLdM,
              kDx = kRed + (kRedCb > kRedY ? kRedCb : kRedY),
              kWx = kDx + L * kLdS, kH = kWx + L * kLdS,
              kDt = kH + kMaxN * kLdS, kCum = kDt + L, kFloats = kCum + L;
}  // namespace one

__global__ void __launch_bounds__(kOneThreads)
ssd_one_kernel(Args p) {
  constexpr int L = one::L, kLdM = one::kLdM, kLdY = one::kLdY;
  constexpr int kParts = one::kParts;
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem + one::kC;       // [L][kLdK] C
  float* b_s = smem + one::kB;       // [L][kLdK] B
  float* m_s = smem + one::kM;       // [L][kLdM] (C B^T) ⊙ decay
  float* red = smem + one::kRed;     // partial sums of C B^T, then of y
  float* dx_s = smem + one::kDx;     // [L][kLdS] x, then dt x
  float* wx_s = smem + one::kWx;     // [L][kLdS] w x
  float* h_s = smem + one::kH;       // [N][kLdS] h0
  float* dt_s = smem + one::kDt;
  float* cum_s = smem + one::kCum;

  const int p0 = blockIdx.x * kSlice, head = blockIdx.y, row = blockIdx.z;
  const int H = p.H, P = p.P, N = p.N, len = p.S;
  const int grp = head / (H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t z = (size_t)row * H + head;
  const bool has_h0 = p.h0 != nullptr;

  // two copy groups: C and B for C B^T first, then x and h0
  stage_rows(c_s, kLdK, tok(p.c, p.cs, row, 0, grp), p.cs.s, L, len, N);
  stage_rows(b_s, kLdK, tok(p.b, p.bs, row, 0, grp), p.bs.s, L, len, N);
  mvm::cp_commit();
  stage_rows(dx_s, kLdS, tok(p.x, p.xs, row, 0, head) + p0, p.xs.s, L, len,
             kSlice);
  if (has_h0)
    stage_rows(h_s, kLdS, p.h0 + z * N * P + p0, P, N, N, kSlice);
  mvm::cp_commit();
  load_dt(p, row, head, 0, len, L, dt_s);
  mvm::cp_wait<1>();
  __syncthreads();
  if (warp == 0) chunk_cums<L>(dt_s, p.a[head], cum_s);
  {  // C B^T: each warp the 32 x 32 tile over every 4th k step
    float acc[2][4][4] = {};
    warp_mma<2, 4, kLdK, 1, 1, kLdK>(acc, c_s, b_s, 0, 0, N, L, L, 8 * warp,
                                     8 * kParts);
    store_acc(acc, red + warp * L * kLdM, kLdM, 0, 0, L, L, L);
  }
  mvm::cp_wait<0>();
  __syncthreads();
  const float total = cum_s[L - 1];
  for (int e = tid; e < L * L; e += kOneThreads) {
    const int t = e / L, r = e - t * L;
    float v = red[t * kLdM + r];
#pragma unroll
    for (int q = 1; q < kParts; ++q)
      v = __fadd_rn(v, red[q * L * kLdM + t * kLdM + r]);
    m_s[t * kLdM + r] =
        r <= t ? __fmul_rn(v, expf(fminf(__fsub_rn(cum_s[t], cum_s[r]),
                                         0.f)))
               : 0.f;
  }
  for (int e = tid; e < L * kSlice; e += kOneThreads) {
    const int t = e / kSlice, q = e - t * kSlice;
    const float xv = dx_s[t * kLdS + q];
    const float w = __fmul_rn(expf(__fsub_rn(total, cum_s[t])), dt_s[t]);
    wx_s[t * kLdS + q] = __fmul_rn(w, xv);
    dx_s[t * kLdS + q] = __fmul_rn(dt_s[t], xv);
  }
  __syncthreads();
  {  // y [L][16] = intra + exp(cums) inter: each warp every 4th k step
    float intra[2][2][4] = {}, inter[2][2][4] = {};
    warp_mma<2, 2, kLdM, 1, kLdS, 1>(intra, m_s, dx_s, 0, 0, L, L, kSlice,
                                     8 * warp, 8 * kParts);
    if (has_h0)
      warp_mma<2, 2, kLdK, 1, kLdS, 1>(inter, c_s, h_s, 0, 0, N, L, kSlice,
                                       8 * warp, 8 * kParts);
    add_carried(intra, inter, cum_s, 0);
    store_acc(intra, red + warp * L * kLdY, kLdY, 0, 0, L, kSlice, L);
  }
  {  // final state [N][16] = exp(total) h0 + B^T (w x); warps 4 x 1
    const float etot = expf(total);
    const int m0 = warp * 32;
    float acc[2][2][4] = {};
    warp_mma<2, 2, 1, kLdK, kLdS, 1>(acc, b_s, wx_s, m0, 0, L, N, kSlice);
    if (has_h0)
      for_acc(acc, m0, 0, N, kSlice, [&](int n, int q, float& v) {
        v = __fadd_rn(__fmul_rn(etot, h_s[n * kLdS + q]), v);
      });
    store_acc(acc, p.h_out + z * N * P + p0, P, m0, 0, N, kSlice, N);
  }
  __syncthreads();
  float* y = p.y + ((size_t)row * len * H + head) * P + p0;
  for (int e = tid; e < len * kSlice; e += kOneThreads) {
    const int t = e / kSlice, q = e - t * kSlice;
    float v = red[t * kLdY + q];
#pragma unroll
    for (int part = 1; part < kParts; ++part)
      v = __fadd_rn(v, red[part * L * kLdY + t * kLdY + q]);
    y[(size_t)t * H * P + q] = v;
  }
}

// ---------------------------------------------------------------------------
// a scan of several chunks: chunk, state and output passes
// ---------------------------------------------------------------------------

// where each pass finds its part of the scratch (floats)
struct Scratch {
  float* sums;                       // [B*H][chunks][N*P] S_c, then h_c
  float* cbs;                        // [B][chunks][G][L*L] C B^T
  float* tots;                       // [B*H][chunks] total
};

long long scratch_floats(int B, int H, int N, int P, int G, int chunks,
                         int L) {
  return (long long)B * chunks *
         ((long long)H * N * P + (long long)G * L * L + H);
}

Scratch carve(float* base, int B, int H, int N, int P, int G, int chunks,
              int L) {
  Scratch s;
  s.sums = base;
  s.cbs = s.sums + (size_t)B * H * chunks * N * P;
  s.tots = s.cbs + (size_t)B * chunks * G * L * L;
  return s;
}

template <int L>
struct ChunkSmem {                   // floats
  static constexpr int kHead = L * kLdBT + L * kLdP + 3 * L;
  static constexpr int kGroup = 2 * L * kLdK;
  static constexpr int kFloats = kHead > kGroup ? kHead : kGroup;
};

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(Args p, Scratch sc) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.y, row = blockIdx.z;
  const int H = p.H, P = p.P, N = p.N, C = p.chunks;
  const int c0 = chunk * L, len = min(L, p.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5;

  if (blockIdx.x < H) {              // S_c and total of one head
    const int head = blockIdx.x, grp = head / (H / p.G);
    float* bt_s = smem;              // [L][kLdBT] B
    float* xw_s = bt_s + L * kLdBT;  // [L][kLdP] x, then w x
    float* dt_s = xw_s + L * kLdP;
    float* cum_s = dt_s + L;
    float* w_s = cum_s + L;
    stage_rows(bt_s, kLdBT, tok(p.b, p.bs, row, c0, grp), p.bs.s, L, len, N);
    stage_rows(xw_s, kLdP, tok(p.x, p.xs, row, c0, head), p.xs.s, L, len, P);
    mvm::cp_commit();
    load_dt(p, row, head, c0, len, L, dt_s);
    __syncthreads();
    if (warp == 0) chunk_cums<L>(dt_s, p.a[head], cum_s);
    __syncthreads();
    const float total = cum_s[L - 1];
    if (tid < L)
      w_s[tid] = __fmul_rn(expf(__fsub_rn(total, cum_s[tid])), dt_s[tid]);
    if (tid == 0) sc.tots[((size_t)row * H + head) * C + chunk] = total;
    mvm::cp_wait<0>();
    __syncthreads();
    for (int e = tid; e < L * P; e += kThreads) {
      const int t = e / P, q = e - t * P;
      xw_s[t * kLdP + q] = __fmul_rn(w_s[t], xw_s[t * kLdP + q]);
    }
    __syncthreads();
    // S_c [N][P] = B^T (w x); warps 4 (N) x 2 (P), 32 x 32 each
    const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
    float acc[2][4][4] = {};
    warp_mma<2, 4, 1, kLdBT, kLdP, 1>(acc, bt_s, xw_s, m0, n0, L, N, P);
    store_acc(acc, sc.sums + (((size_t)row * H + head) * C + chunk) * N * P,
              P, m0, n0, N, P, N);
  } else {                           // C B^T of one group
    const int grp = blockIdx.x - H;
    float* c_s = smem;               // [L][kLdK]
    float* b_s = c_s + L * kLdK;     // [L][kLdK]
    stage_rows(c_s, kLdK, tok(p.c, p.cs, row, c0, grp), p.cs.s, L, len, N);
    stage_rows(b_s, kLdK, tok(p.b, p.bs, row, c0, grp), p.bs.s, L, len, N);
    mvm::cp_commit();
    mvm::cp_wait<0>();
    __syncthreads();
    // [L][L]; warps 2 x 4
    constexpr int MT = L / 32, NT = L / 32;
    const int m0 = (warp >> 2) * 16 * MT, n0 = (warp & 3) * 8 * NT;
    float acc[MT][NT][4] = {};
    warp_mma<MT, NT, kLdK, 1, 1, kLdK>(acc, c_s, b_s, m0, n0, N, L, L);
    store_acc(acc, sc.cbs + (((size_t)row * C + chunk) * p.G + grp) * L * L,
              L, m0, n0, L, L, L);
  }
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ h0, Scratch sc,
                 float* __restrict__ h_out, int H, int NP, int C) {
  const int head = blockIdx.y, row = blockIdx.z;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  const size_t z = (size_t)row * H + head;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  if (h0 != nullptr)
    h = load4(h0 + z * NP + e, (reinterpret_cast<uintptr_t>(h0) & 15) == 0);
  float* s = sc.sums + z * C * NP + e;
  const float* tt = sc.tots + z * C;
  for (int c0 = 0; c0 < C; c0 += kAhead) {
    float4 v[kAhead];
    float d[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < C) {
        v[j] = *reinterpret_cast<const float4*>(s + (size_t)(c0 + j) * NP);
        d[j] = expf(tt[c0 + j]);
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < C) {
        *reinterpret_cast<float4*>(s + (size_t)(c0 + j) * NP) = h;
        h.x = __fadd_rn(__fmul_rn(d[j], h.x), v[j].x);
        h.y = __fadd_rn(__fmul_rn(d[j], h.y), v[j].y);
        h.z = __fadd_rn(__fmul_rn(d[j], h.z), v[j].z);
        h.w = __fadd_rn(__fmul_rn(d[j], h.w), v[j].w);
      }
  }
  *reinterpret_cast<float4*>(h_out + z * NP + e) = h;
}

template <int L>
struct OutSmem {                     // floats
  static constexpr int kLdM = L + 4;
  // C and h_c come in tiles of kNTile along N; the second tile reuses the
  // regions of C B^T and x once the intra-chunk product is done, so that 3
  // blocks fit on an SM
  static constexpr int kA = L * kLdM > L * kLdT ? L * kLdM : L * kLdT;
  static constexpr int kB = (L > kNTile ? L : kNTile) * kLdP;
  static constexpr int kM = 0, kDx = kM + kA, kC = kDx + kB,
                       kH = kC + L * kLdT, kDt = kH + kNTile * kLdP,
                       kCum = kDt + L, kFloats = kCum + L;
};

template <int L>
__global__ void __launch_bounds__(kThreads, 3)
ssd_output_kernel(Args p, Scratch sc) {
  using Sm = OutSmem<L>;
  constexpr int kLdM = Sm::kLdM;
  extern __shared__ __align__(16) float smem[];
  float* m_s = smem + Sm::kM;        // [L][kLdM] C B^T, then ⊙ decay
  float* dx_s = smem + Sm::kDx;      // [L][kLdP] x, then dt x
  float* c_s = smem + Sm::kC;        // [L][kLdT] C, first N tile
  float* h_s = smem + Sm::kH;        // [kNTile][kLdP] h_c, first N tile
  float* dt_s = smem + Sm::kDt;
  float* cum_s = smem + Sm::kCum;

  const int head = blockIdx.x, chunk = blockIdx.y, row = blockIdx.z;
  const int H = p.H, P = p.P, N = p.N, C = p.chunks;
  const int grp = head / (H / p.G);
  const int c0 = chunk * L, len = min(L, p.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* cg = tok(p.c, p.cs, row, c0, grp);
  const float* hg = sc.sums + (((size_t)row * H + head) * C + chunk) * N * P;
  const int n1 = min(N, kNTile);     // rows of N in the first tile

  // copy groups: the intra-chunk operands, then the first N tile of C and
  // h_c; the second tile goes in once the intra-chunk product is done
  stage_rows(m_s, kLdM, sc.cbs + (((size_t)row * C + chunk) * p.G + grp) *
                                     L * L, L, L, L, L);
  stage_rows(dx_s, kLdP, tok(p.x, p.xs, row, c0, head), p.xs.s, L, len, P);
  mvm::cp_commit();
  stage_rows(c_s, kLdT, cg, p.cs.s, L, len, n1);
  stage_rows(h_s, kLdP, hg, P, n1, n1, P);
  mvm::cp_commit();
  load_dt(p, row, head, c0, len, L, dt_s);
  __syncthreads();
  if (warp == 0) chunk_cums<L>(dt_s, p.a[head], cum_s);
  mvm::cp_wait<1>();
  __syncthreads();
  for (int e = tid; e < L * L; e += kThreads) {
    const int t = e / L, r = e - t * L;
    m_s[t * kLdM + r] =
        r <= t ? __fmul_rn(m_s[t * kLdM + r],
                           expf(fminf(__fsub_rn(cum_s[t], cum_s[r]), 0.f)))
               : 0.f;
  }
  for (int e = tid; e < L * P; e += kThreads) {
    const int t = e / P, q = e - t * P;
    dx_s[t * kLdP + q] = __fmul_rn(dt_s[t], dx_s[t * kLdP + q]);
  }
  __syncthreads();
  // y [L][P] = intra + exp(cums) inter; warps 2 (L) x 4 (P), (L / 2) x 16
  constexpr int MT = L / 32;
  const int m0 = (warp >> 2) * 16 * MT, n0 = (warp & 3) * 16;
  float intra[MT][2][4] = {}, inter[MT][2][4] = {};
  // (C B^T) ⊙ decay is lower triangular: rows below m0 + 16 MT need no
  // columns past it
  warp_mma<MT, 2, kLdM, 1, kLdP, 1>(intra, m_s, dx_s, m0, n0,
                                    m0 + 16 * MT, L, P);
  __syncthreads();                   // m_s and dx_s are free
  if (N > kNTile) {
    stage_rows(m_s, kLdT, cg + kNTile, p.cs.s, L, len, N - kNTile);
    stage_rows(dx_s, kLdP, hg + kNTile * P, P, N - kNTile, N - kNTile, P);
  }
  mvm::cp_commit();
  mvm::cp_wait<1>();
  __syncthreads();
  warp_mma<MT, 2, kLdT, 1, kLdP, 1>(inter, c_s, h_s, m0, n0, n1, L, P);
  if (N > kNTile) {
    mvm::cp_wait<0>();
    __syncthreads();
    warp_mma<MT, 2, kLdT, 1, kLdP, 1>(inter, m_s, dx_s, m0, n0, N - kNTile,
                                      L, P);
  }
  add_carried(intra, inter, cum_s, m0);
  store_acc(intra, p.y + (((size_t)row * p.S + c0) * H + head) * P,
            (long long)H * P, m0, n0, L, P, len);
}

// ---------------------------------------------------------------------------
// plan and launch
// ---------------------------------------------------------------------------

struct Plan {
  int chunk, chunks, launches;
  int blocks[3];                     // thread blocks of each launch
  int smem;                          // largest dynamic shared memory, bytes
  long long scratch;                 // bytes
};

bool shape_ok(int B, int S, int H, int P, int N, int G) {
  return B > 0 && B <= 65535 && S > 0 && H > 0 && H <= 65535 && G > 0 &&
         H % G == 0 && P >= 16 && P <= kMaxP && P % 16 == 0 && N >= 16 &&
         N <= kMaxN && N % 16 == 0 &&
         (S + kMultiChunk - 1) / kMultiChunk <= 65535;
}

template <int L>
int multi_smem() {
  const int a = ChunkSmem<L>::kFloats, o = OutSmem<L>::kFloats;
  return 4 * (a > o ? a : o);
}

Plan make_plan(int B, int S, int H, int P, int N, int G, bool passes) {
  Plan q{};
  q.chunk = passes || S > kOneChunk ? kMultiChunk : kOneChunk;
  q.chunks = (S + q.chunk - 1) / q.chunk;
  if (q.chunk == kOneChunk) {        // one short chunk: one launch
    q.launches = 1;
    q.blocks[0] = P / kSlice * H * B;
    q.smem = 4 * one::kFloats;
    return q;
  }
  q.launches = 3;
  q.blocks[0] = (H + G) * q.chunks * B;
  q.blocks[1] = (N * P / 4 + kThreads - 1) / kThreads * H * B;
  q.blocks[2] = H * q.chunks * B;
  q.smem = multi_smem<kMultiChunk>();
  q.scratch = 4 * scratch_floats(B, H, N, P, G, q.chunks, q.chunk);
  return q;
}

cudaError_t launch_one(const Args& p, int B, cudaStream_t st) {
  static unsigned told = 0;
  const int smem = 4 * one::kFloats;
  cudaError_t err = mvm::allow_smem(ssd_one_kernel, smem, told);
  if (err != cudaSuccess) return err;
  ssd_one_kernel<<<dim3(p.P / kSlice, p.H, B), kOneThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_multi(const Args& p, int B, float* scratch,
                         cudaStream_t st) {
  static unsigned told_chunk = 0, told_out = 0;
  const Scratch sc = carve(scratch, B, p.H, p.N, p.P, p.G, p.chunks, L);
  const int smem_a = 4 * ChunkSmem<L>::kFloats;
  const int smem_o = 4 * OutSmem<L>::kFloats;
  cudaError_t err = mvm::allow_smem(ssd_chunk_kernel<L>, smem_a, told_chunk);
  if (err == cudaSuccess)
    err = mvm::allow_smem(ssd_output_kernel<L>, smem_o, told_out);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<L><<<dim3(p.H + p.G, p.chunks, B), kThreads, smem_a,
                        st>>>(p, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np = p.N * p.P;
  ssd_state_kernel<<<dim3((np / 4 + kThreads - 1) / kThreads, p.H, B),
                     kThreads, 0, st>>>(p.h0, sc, p.h_out, p.H, np,
                                        p.chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_kernel<L><<<dim3(p.H, p.chunks, B), kThreads, smem_o, st>>>(
      p, sc);
  return cudaGetLastError();
}

}  // namespace

// The launch plan of one scan: the chunk length L, the device launches (1
// for a single chunk, else 3), the thread blocks of each launch (0 past
// the last), the largest dynamic shared memory of a thread block, and the
// bytes of device scratch the caller must pass (0: none). Nonzero
// `passes` plans the three passes even for a single chunk (to time the
// two against each other). Returns cudaErrorInvalidValue for a shape the
// kernel does not take (P and N multiples of 16 up to 64 and 128, H a
// multiple of G, B up to 65535, at most 65535 chunks), else 0.
extern "C" int ssd_scan_plan(int B, int S, int H, int P, int N, int G,
                             int passes, int* chunk, int* launches,
                             int* blocks, int* smem, long long* scratch) {
  if (!shape_ok(B, S, H, P, N, G)) return (int)cudaErrorInvalidValue;
  const Plan q = make_plan(B, S, H, P, N, G, passes != 0);
  *chunk = q.chunk;
  *launches = q.launches;
  for (int i = 0; i < 3; ++i) blocks[i] = q.blocks[i];
  *smem = q.smem;
  *scratch = q.scratch;
  return 0;
}

// One scan (see the note at the top) on `stream`. Strides are in elements;
// `chunk` must be the plan's for the same `passes` and `scratch` hold the
// plan's scratch bytes (16-byte aligned; null when the plan needs none).
// Returns the first launch's error from cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for arguments it cannot take.
extern "C" int ssd_scan(const void* x, long long x_sb, long long x_ss,
                        long long x_sh, const void* dt, long long dt_sb,
                        long long dt_ss, long long dt_sh, const void* a,
                        const void* b, long long b_sb, long long b_ss,
                        long long b_sg, const void* c, long long c_sb,
                        long long c_ss, long long c_sg, const void* h0,
                        void* y, void* h_out, int B, int S, int H, int P,
                        int N, int G, int chunk, int passes,
                        void* scratch, void* stream) {
  if (!shape_ok(B, S, H, P, N, G) || x == nullptr || dt == nullptr ||
      a == nullptr || b == nullptr || c == nullptr || y == nullptr ||
      h_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan q = make_plan(B, S, H, P, N, G, passes != 0);
  if (chunk != q.chunk || (q.scratch > 0 && scratch == nullptr) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Args p{(const float*)x,  Strides{x_sb, x_ss, x_sh},
               (const float*)dt, Strides{dt_sb, dt_ss, dt_sh},
               (const float*)a,  (const float*)b,
               Strides{b_sb, b_ss, b_sg}, (const float*)c,
               Strides{c_sb, c_ss, c_sg}, (const float*)h0,
               (float*)y,        (float*)h_out,
               S, H, P, N, G, q.chunks};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (q.launches == 1)
    err = launch_one(p, B, st);
  else
    err = launch_multi<kMultiChunk>(p, B, (float*)scratch, st);
  return (int)err;
}
