// Paged flash-prefill attention for Hopper (sm_90a): one query chunk per row
// scored in place against the block-paged KV pool.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py::
// paged_flash_prefill (body _paged_prefill_kernel).
//
// q [B, S, H, hd] fp32; the pool, tables and cursors as in
// paged_attention.cu. Column i of row b sits at logical position pos[b] + i
// (pos is the pre-chunk write cursor; the chunk's own K/V are already in
// the pool) and attends start[b] <= j <= pos[b] + i. The kernel only reads
// the pool, through the read table tbl (never the write table wtbl).
//
// Design (a simple kernel first; speed is later work):
// * One thread block per (row, kv head, tile of kQTile query vectors); a
//   kv head's query vectors are its G = H / KV heads at each of the S
//   columns, (column, head) in row-major order. The TPU's sequential grid
//   axis over blocks becomes a loop inside the block over the row's live
//   blocks, start / bs .. (pos + last column of the tile) / bs, in order;
//   each block reads tbl, pos and start itself (no host sync per layer).
//   Blocks past the tile's last column are wholly masked for it, which
//   leaves the online softmax exactly as it was, so they are skipped.
// * K and V of the kv head are staged into shared memory as fp32 (int8
//   dequantized right after the load); the online softmax runs in fp32 in
//   the reference's op order (-1e30 mask, m = -inf at start, expf without
//   fast math, acc / max(l, 1e-30)). No split-K: the chunk gives a row
//   S * H independent softmax rows already.
//
// What bounds it on this card: the live K/V bytes of each row, read once
// per tile (the 50 MB L2 serves the tiles after the first); per key the
// work is 4 * hd flops for each of the S * G query vectors, far below the
// fp32 rate at chunk 32.

#include "paged_common.cuh"

namespace {

constexpr int kQTile = 32;   // query vectors of one thread block

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kPagedThreads)
paged_prefill_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
                     const int* __restrict__ tbl, const int* __restrict__ pos,
                     const int* __restrict__ start, float* __restrict__ out,
                     int S, int H, int KV, int hd, int bs, int NB, int P,
                     float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KV, ld = hd + 1;
  const int r0 = blockIdx.z * kQTile;
  const int nr = min(kQTile, S * G - r0);
  float* q_s = smem;                   // [kQTile][hd]
  float* acc_s = q_s + kQTile * hd;    // [kQTile][hd]
  float* k_s = acc_s + kQTile * hd;    // [bs][ld]
  float* v_s = k_s + bs * ld;          // [bs][ld]
  float* p_s = v_s + bs * ld;          // [kQTile][bs]
  float* m_s = p_s + kQTile * bs;      // [kQTile]
  float* l_s = m_s + kQTile;           // [kQTile]
  float* c_s = l_s + kQTile;           // [kQTile]

  const int p_b = pos[b], s_b = start[b];
  const int first = s_b / bs;
  const int last = min((p_b + (r0 + nr - 1) / G) / bs, NB - 1);
  for (int e = threadIdx.x; e < nr * hd; e += blockDim.x) {
    const int r = r0 + e / hd, d = e % hd;
    const int col = r / G, g = r - col * G;
    q_s[e] = q[(((size_t)b * S + col) * H + (size_t)h * G + g) * hd + d];
    acc_s[e] = 0.f;
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    m_s[r] = neg_inf();
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = first; j <= last; ++j) {
    const int phys = min(max(tbl[(size_t)b * NB + j], 0), P - 1);
    stage_block<T, kQuant>(kp, vp, ksc, vsc, phys, h, KV, hd, bs, k_s, v_s,
                           ld);
    __syncthreads();
    auto valid = [&](int r, int t) {
      const int jp = j * bs + t;
      return jp >= s_b && jp <= p_b + (r0 + r) / G;
    };
    for (int e = threadIdx.x; e < nr * bs; e += blockDim.x) {
      const int r = e / bs, t = e - r * bs;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + t * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[e] = valid(r, t) ? __fmul_rn(s, scale) : -1e30f;
    }
    __syncthreads();
    flash_update(p_s, m_s, l_s, c_s, acc_s, v_s, nr, bs, hd, ld, valid);
  }

  for (int e = threadIdx.x; e < nr * hd; e += blockDim.x) {
    const int rr = e / hd, d = e - rr * hd;
    const int r = r0 + rr, col = r / G, g = r - col * G;
    out[(((size_t)b * S + col) * H + (size_t)h * G + g) * hd + d] =
        acc_s[e] / fmaxf(l_s[rr], 1e-30f);
  }
}

int smem_bytes(int hd, int bs) {
  return 4 * (2 * kQTile * hd + 2 * bs * (hd + 1) + kQTile * bs +
              3 * kQTile);
}

template <typename T, bool kQuant>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const void* q,
                   const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* tbl, const void* pos,
                   const void* start, void* out, int S, int H, int KV,
                   int hd, int bs, int NB, int P, float scale) {
  auto kernel = paged_prefill_kernel<T, kQuant>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPagedThreads, smem, s>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const float*)ks,
      (const float*)vs, (const int*)tbl, (const int*)pos,
      (const int*)start, (float*)out, S, H, KV, hd, bs, NB, P, scale);
  return cudaSuccess;
}

}  // namespace

// One paged prefill chunk (see the note at the top). kv_dtype: 0 fp32,
// 1 bf16, 2 int8 (k_scale / v_scale then required, else ignored).
// Returns the launch's cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int paged_prefill(const void* q, const void* kp, const void* vp,
                             const void* k_scale, const void* v_scale,
                             const void* tbl, const void* pos,
                             const void* start, void* out, int B, int S,
                             int H, int KV, int hd, int bs, int NB, int P,
                             float scale, int kv_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      bs <= 0 || NB <= 0 || P <= 0 || KV > 65535 || kv_dtype < 0 ||
      kv_dtype > 2 ||
      (kv_dtype == kKvI8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)S * (H / KV) + kQTile - 1) / kQTile;
  const int smem = smem_bytes(hd, bs);
  if (tiles > 65535 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(B, KV, (unsigned)tiles);
  cudaError_t err;
  if (kv_dtype == kKvF32)
    err = launch<float, false>(grid, smem, s, q, kp, vp, k_scale, v_scale,
                               tbl, pos, start, out, S, H, KV, hd, bs, NB, P,
                               scale);
  else if (kv_dtype == kKvBF16)
    err = launch<__nv_bfloat16, false>(grid, smem, s, q, kp, vp, k_scale,
                                       v_scale, tbl, pos, start, out, S, H,
                                       KV, hd, bs, NB, P, scale);
  else
    err = launch<int8_t, true>(grid, smem, s, q, kp, vp, k_scale, v_scale,
                               tbl, pos, start, out, S, H, KV, hd, bs, NB,
                               P, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
