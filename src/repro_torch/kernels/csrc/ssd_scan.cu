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
// inside the chunk and h the state entering it:
//   y_t  = sum_{r <= t} (C_t . B_r) exp(min(cums_t - cums_r, 0)) dt_r x_r
//          + exp(cums_t) (C_t . h)
//   h'   = exp(cums_{L-1}) h + sum_r exp(cums_{L-1} - cums_r) dt_r B_r x_r^T
// A ragged last chunk is padded with dt = x = b = c = 0, which leaves the
// state as it was; the padded rows' y is not written.
//
// Design (a simple kernel first; speed is later work):
// * One thread block per (row, head) walks its chunks in order; the TPU's
//   sequential grid axis over chunks becomes this loop, and the [N, P]
//   fp32 state lives in shared memory for the whole sequence.
// * One chunk's B, C (rows padded to N + 1 floats, so that 16 threads
//   reading one column of 16 rows hit 16 banks), x, dt and the masked
//   [L, L] matrix (C B^T) ⊙ decay are staged in shared memory.
// * 256 threads as a 16 x 16 grid; each thread keeps a small register tile
//   of each product: 2 x 2 of C B^T, 2 x (P / 16) of y, (N / 16) x (P / 16)
//   of the state update, so a value loaded from shared memory feeds
//   several FMAs.
// * fp32 FMAs on the CUDA cores only (no TF32, no tensor cores), expf (not
//   __expf), no fast math.
//
// What bounds it on this card: operations. Per token and head it does
// L * N (C B^T) + L * P (intra-chunk y) + 2 * N * P (C h and the state
// update) FMAs, about 22.5 k at L 32, N 128, P 64, against 4 * (P + 2 N / H
// + 1) bytes read. With one block per (row, head) the grid is small at
// batch 1 (24 blocks at mamba2-130m on 132 SMs); splitting the sequence
// (chunk states in parallel, then a short pass over [N, P] summaries) and
// one C B^T shared by the heads of a group are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kSide = 16;
constexpr int kChunk = 32;         // L: tokens per chunk
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Strides {                   // element strides of the three leading dims
  long long b, s, h;
};

int smem_floats(int P, int N) {
  return N * P                     // state
         + 2 * kChunk * (N + 1)    // B and C of one chunk
         + kChunk * P              // x of one chunk
         + kChunk * (kChunk + 1)   // (C B^T) ⊙ decay
         + 4 * kChunk;             // dt, cums, exp(cums), state weights
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, Strides xs,
                const float* __restrict__ dt, Strides ds,
                const float* __restrict__ a,
                const float* __restrict__ bm, Strides bs,
                const float* __restrict__ cm, Strides cs,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N,
                int G) {
  extern __shared__ float smem[];
  constexpr int L = kChunk;
  const int head = blockIdx.x, row = blockIdx.y;
  const int grp = head / (H / G);
  const int ldb = N + 1, ldm = L + 1;
  float* h_s = smem;                  // [N][P]
  float* b_s = h_s + N * P;           // [L][ldb]
  float* c_s = b_s + L * ldb;         // [L][ldb]
  float* x_s = c_s + L * ldb;         // [L][P]
  float* m_s = x_s + L * P;           // [L][ldm]
  float* dt_s = m_s + L * ldm;        // [L]
  float* cum_s = dt_s + L;            // [L]
  float* ec_s = cum_s + L;            // [L] exp(cums)
  float* w_s = ec_s + L;              // [L] exp(total - cums) * dt

  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;
  const int np = P / kSide, nn = N / kSide;
  const float a_h = a[head];
  const size_t state0 = ((size_t)row * H + head) * N * P;

  for (int e = tid; e < N * P; e += kThreads)
    h_s[e] = h0 != nullptr ? h0[state0 + e] : 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int len = min(L, S - c0);
    for (int e = tid; e < L * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      float bv = 0.f, cv = 0.f;
      if (t < len) {
        const long long tok = c0 + t;
        bv = bm[row * bs.b + tok * bs.s + grp * bs.h + n];
        cv = cm[row * cs.b + tok * cs.s + grp * cs.h + n];
      }
      b_s[t * ldb + n] = bv;
      c_s[t * ldb + n] = cv;
    }
    for (int e = tid; e < L * P; e += kThreads) {
      const int t = e / P, p = e - t * P;
      x_s[e] = t < len ? x[row * xs.b + (c0 + t) * xs.s + head * xs.h + p]
                       : 0.f;
    }
    if (tid < L)
      dt_s[tid] = tid < len ? dt[row * ds.b + (c0 + tid) * ds.s + head * ds.h]
                            : 0.f;
    __syncthreads();

    if (tid == 0) {                   // inclusive cumsum of dt * a
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(dt_s[t], a_h));
        cum_s[t] = acc;
      }
    }
    __syncthreads();
    const float total = cum_s[L - 1];
    if (tid < L) {
      ec_s[tid] = expf(cum_s[tid]);
      w_s[tid] = __fmul_rn(expf(__fsub_rn(total, cum_s[tid])), dt_s[tid]);
    }

    // (C B^T) ⊙ exp(min(cums_t - cums_r, 0)) on r <= t, 0 above
    {
      float g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int n = 0; n < N; ++n) {
        float cv[2], bv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) cv[i] = c_s[(ty + kSide * i) * ldb + n];
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = b_s[(tx + kSide * j) * ldb + n];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + kSide * i, r = tx + kSide * j;
          const float decay =
              expf(fminf(__fsub_rn(cum_s[t], cum_s[r]), 0.f));
          m_s[t * ldm + r] = r <= t ? __fmul_rn(g[i][j], decay) : 0.f;
        }
    }
    __syncthreads();

    // y of the chunk's rows from the state entering it
    {
      float intra[2][kMaxP / kSide], inter[2][kMaxP / kSide];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j) intra[i][j] = inter[i][j] = 0.f;
      for (int r = 0; r < L; ++r) {
        const float mv0 = m_s[ty * ldm + r];
        const float mv1 = m_s[(ty + kSide) * ldm + r];
        const float d = dt_s[r];
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j) {
          if (j < np) {
            const float dx = __fmul_rn(d, x_s[r * P + tx + kSide * j]);
            intra[0][j] = fmaf(mv0, dx, intra[0][j]);
            intra[1][j] = fmaf(mv1, dx, intra[1][j]);
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        const float cv0 = c_s[ty * ldb + n];
        const float cv1 = c_s[(ty + kSide) * ldb + n];
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j) {
          if (j < np) {
            const float hv = h_s[n * P + tx + kSide * j];
            inter[0][j] = fmaf(cv0, hv, inter[0][j]);
            inter[1][j] = fmaf(cv1, hv, inter[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ty + kSide * i;
        if (t < len) {
          float* yr = y + (((size_t)row * S + c0 + t) * H + head) * P;
#pragma unroll
          for (int j = 0; j < kMaxP / kSide; ++j)
            if (j < np)
              yr[tx + kSide * j] =
                  __fadd_rn(intra[i][j], __fmul_rn(ec_s[t], inter[i][j]));
        }
      }
    }
    __syncthreads();                  // every read of the old state is done

    // h' = exp(total) h + sum_r B_r^T (w_r x_r); each thread owns its
    // (n, p) elements of the state
    {
      const float etot = expf(total);
      float acc[kMaxN / kSide][kMaxP / kSide];
#pragma unroll
      for (int i = 0; i < kMaxN / kSide; ++i)
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < L; ++r) {
        const float w = w_s[r];
        float xw[kMaxP / kSide];
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j)
          xw[j] = j < np ? __fmul_rn(w, x_s[r * P + tx + kSide * j]) : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxN / kSide; ++i) {
          if (i < nn) {
            const float bv = b_s[r * ldb + ty + kSide * i];
#pragma unroll
            for (int j = 0; j < kMaxP / kSide; ++j)
              acc[i][j] = fmaf(bv, xw[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxN / kSide; ++i)
#pragma unroll
        for (int j = 0; j < kMaxP / kSide; ++j)
          if (i < nn && j < np) {
            float* hp = h_s + (ty + kSide * i) * P + tx + kSide * j;
            *hp = __fadd_rn(__fmul_rn(etot, *hp), acc[i][j]);
          }
    }
    __syncthreads();                  // the next chunk overwrites the tiles
  }

  for (int e = tid; e < N * P; e += kThreads) h_out[state0 + e] = h_s[e];
}

bool shape_ok(int B, int S, int H, int P, int N, int G) {
  return B > 0 && B <= 65535 && S > 0 && H > 0 && G > 0 && H % G == 0 &&
         P >= kSide && P <= kMaxP && P % kSide == 0 && N >= kSide &&
         N <= kMaxN && N % kSide == 0 &&
         4 * smem_floats(P, N) <= kMaxSmem;
}

}  // namespace

// The launch plan of one scan: the chunk length, the threads of a block and
// its dynamic shared memory in bytes. Returns cudaErrorInvalidValue for a
// shape the kernel does not take (P and N multiples of 16 up to 64 and 128,
// H a multiple of G, B up to 65535), else 0.
extern "C" int ssd_scan_plan(int B, int S, int H, int P, int N, int G,
                             int* chunk, int* threads, int* smem) {
  if (!shape_ok(B, S, H, P, N, G)) return (int)cudaErrorInvalidValue;
  *chunk = kChunk;
  *threads = kThreads;
  *smem = 4 * smem_floats(P, N);
  return 0;
}

// One scan (see the note at the top). Strides are in elements; `chunk` must
// be the plan's. Returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int ssd_scan(const void* x, long long x_sb, long long x_ss,
                        long long x_sh, const void* dt, long long dt_sb,
                        long long dt_ss, long long dt_sh, const void* a,
                        const void* b, long long b_sb, long long b_ss,
                        long long b_sg, const void* c, long long c_sb,
                        long long c_ss, long long c_sg, const void* h0,
                        void* y, void* h_out, int B, int S, int H, int P,
                        int N, int G, int chunk, void* stream) {
  if (!shape_ok(B, S, H, P, N, G) || chunk != kChunk || x == nullptr ||
      dt == nullptr || a == nullptr || b == nullptr || c == nullptr ||
      y == nullptr || h_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * smem_floats(P, N);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)H, (unsigned)B);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, Strides{x_sb, x_ss, x_sh}, (const float*)dt,
      Strides{dt_sb, dt_ss, dt_sh}, (const float*)a, (const float*)b,
      Strides{b_sb, b_ss, b_sg}, (const float*)c, Strides{c_sb, c_ss, c_sg},
      (const float*)h0, (float*)y, (float*)h_out, S, H, P, N, G);
  return (int)cudaGetLastError();
}
