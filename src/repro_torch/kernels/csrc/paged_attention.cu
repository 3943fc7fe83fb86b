// Paged flash-decode attention for Hopper (sm_90a): one GQA decode step per
// row against the block-paged KV pool, with split-K partials and a
// fixed-order merge.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_flash_decode (body _paged_decode_kernel, second pass merge_splits).
//
// q [B, H, hd] fp32; pool kp / vp [P, bs, KV, hd] fp32, bf16 or int8 (then
// with fp32 scales [P, bs, KV]); tbl [B, NB] and pos / start [B] int32.
// Row b attends logical positions start[b] <= j <= pos[b].
//
// Design (a simple kernel first; speed is later work):
// * One thread block per (row, kv head, split). The TPU's sequential grid
//   axis over blocks becomes a loop inside the block over the split's live
//   logical blocks, in order. Each block reads tbl, pos and start from
//   device memory and computes its live range itself, max(start / bs,
//   split start) .. min(pos / bs, split end), so dead blocks are never
//   read and no host sync is needed per layer. Physical indices are
//   clamped into the pool, as the TPU's index map clamps them.
// * A block stages K and V of its kv head (bs x hd) into shared memory as
//   fp32, dequantizing int8 right after the load, scores the G = H / KV
//   query heads of the group against them and runs the online softmax in
//   fp32 with the reference's op order: the -1e30 mask, m = -inf at start,
//   expf (no fast math), acc / max(l, 1e-30).
// * With num_splits > 1 each split writes its partial (acc, m, l); a dead
//   split writes m = -inf, l = 0, acc = 0. paged_merge_kernel combines the
//   splits of every output element in split order, so results are the
//   same run to run.
//
// What bounds it on this card: the bytes of the live K/V (and scales) it
// reads, once per row and kv head, over HBM bandwidth; the flops (4 * G *
// hd per key) are far below the fp32 rate. At B = 8 and one split the grid
// is only B * KV blocks, which is why split-K exists.

#include "paged_common.cuh"

namespace {

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kPagedThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ tbl, const int* __restrict__ pos,
                    const int* __restrict__ start, float* __restrict__ out,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int H, int KV, int hd,
                    int bs, int NB, int P, int nbs, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int nsp = gridDim.z;
  const int G = H / KV, ld = hd + 1;
  float* q_s = smem;                // [G][hd]
  float* acc_s = q_s + G * hd;      // [G][hd]
  float* k_s = acc_s + G * hd;      // [bs][ld]
  float* v_s = k_s + bs * ld;       // [bs][ld]
  float* p_s = v_s + bs * ld;       // [G][bs]
  float* m_s = p_s + G * bs;        // [G]
  float* l_s = m_s + G;             // [G]
  float* c_s = l_s + G;             // [G]

  const int p_b = pos[b], s_b = start[b];
  const int first = max(s_b / bs, sp * nbs);
  const int last = min(min(p_b / bs, NB - 1), min((sp + 1) * nbs, NB) - 1);
  const float* qb = q + ((size_t)b * H + (size_t)h * G) * hd;
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    q_s[e] = qb[e];
    acc_s[e] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = neg_inf();
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int j = first; j <= last; ++j) {
    const int phys = min(max(tbl[(size_t)b * NB + j], 0), P - 1);
    stage_block<T, kQuant>(kp, vp, ksc, vsc, phys, h, KV, hd, bs, k_s, v_s,
                           ld);
    __syncthreads();
    for (int e = threadIdx.x; e < G * bs; e += blockDim.x) {
      const int g = e / bs, t = e - g * bs;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + t * ld;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      const int jp = j * bs + t;
      p_s[e] = (jp >= s_b && jp <= p_b) ? __fmul_rn(s, scale) : -1e30f;
    }
    __syncthreads();
    flash_update(p_s, m_s, l_s, c_s, acc_s, v_s, G, bs, hd, ld,
                 [&](int, int t) {
                   const int jp = j * bs + t;
                   return jp >= s_b && jp <= p_b;
                 });
  }

  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd, d = e - g * hd;
    const size_t hq = (size_t)h * G + g;
    if (o_part == nullptr)
      out[((size_t)b * H + hq) * hd + d] = acc_s[e] / fmaxf(l_s[g], 1e-30f);
    else
      o_part[(((size_t)b * nsp + sp) * H + hq) * hd + d] = acc_s[e];
  }
  if (o_part != nullptr) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      const size_t i = ((size_t)b * nsp + sp) * H + (size_t)h * G + g;
      m_part[i] = m_s[g];
      l_part[i] = l_s[g];
    }
  }
}

// Combines the splits of every output element in split order:
// out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = exp(m_s - max m).
__global__ void paged_merge_kernel(const float* __restrict__ o_part,
                                   const float* __restrict__ m_part,
                                   const float* __restrict__ l_part,
                                   float* __restrict__ out, int B, int H,
                                   int hd, int nsp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * hd) return;
  const int d = (int)(i % hd);
  const size_t bh = i / hd;
  const size_t hh = bh % H, b = bh / H;
  float mt = neg_inf();
  for (int s = 0; s < nsp; ++s) mt = fmaxf(mt, m_part[(b * nsp + s) * H + hh]);
  float lt = 0.f, o = 0.f;
  for (int s = 0; s < nsp; ++s) {
    const size_t si = (b * nsp + s) * H + hh;
    const float w = expf(m_part[si] - mt);
    lt = __fadd_rn(lt, __fmul_rn(l_part[si], w));
    o = __fadd_rn(o, __fmul_rn(o_part[si * hd + d], w));
  }
  out[i] = o / fmaxf(lt, 1e-30f);
}

int smem_bytes(int G, int hd, int bs) {
  return 4 * (2 * G * hd + 2 * bs * (hd + 1) + G * bs + 3 * G);
}

template <typename T, bool kQuant>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const void* q,
                   const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* tbl, const void* pos,
                   const void* start, void* out, void* o_part, void* m_part,
                   void* l_part, int H, int KV, int hd, int bs, int NB,
                   int P, int nbs, float scale) {
  auto kernel = paged_decode_kernel<T, kQuant>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kPagedThreads, smem, s>>>(
      (const float*)q, (const T*)kp, (const T*)vp, (const float*)ks,
      (const float*)vs, (const int*)tbl, (const int*)pos,
      (const int*)start, (float*)out, (float*)o_part, (float*)m_part,
      (float*)l_part, H, KV, hd, bs, NB, P, nbs, scale);
  return cudaSuccess;
}

}  // namespace

// One paged decode step (see the note at the top). kv_dtype: 0 fp32,
// 1 bf16, 2 int8 (k_scale / v_scale then required, else ignored). With
// num_splits > 1, o_part [B, S, H, hd] and m_part / l_part [B, S, H] are
// fp32 scratch and the merge writes out; with one split they are null.
// Returns the launches' cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it cannot take.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* k_scale, const void* v_scale,
                            const void* tbl, const void* pos,
                            const void* start, void* out, void* o_part,
                            void* m_part, void* l_part, int B, int H, int KV,
                            int hd, int bs, int NB, int P, int num_splits,
                            float scale, int kv_dtype, void* stream) {
  const bool split = num_splits > 1;
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bs <= 0 ||
      NB <= 0 || P <= 0 || num_splits < 1 || num_splits > 65535 ||
      KV > 65535 ||
      split != (o_part != nullptr) || split != (m_part != nullptr) ||
      split != (l_part != nullptr) || kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == kKvI8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(H / KV, hd, bs);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int nbs = (NB + num_splits - 1) / num_splits;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(B, KV, num_splits);
  cudaError_t err;
  if (kv_dtype == kKvF32)
    err = launch<float, false>(grid, smem, s, q, kp, vp, k_scale, v_scale,
                               tbl, pos, start, out, o_part, m_part, l_part,
                               H, KV, hd, bs, NB, P, nbs, scale);
  else if (kv_dtype == kKvBF16)
    err = launch<__nv_bfloat16, false>(grid, smem, s, q, kp, vp, k_scale,
                                       v_scale, tbl, pos, start, out, o_part,
                                       m_part, l_part, H, KV, hd, bs, NB, P,
                                       nbs, scale);
  else
    err = launch<int8_t, true>(grid, smem, s, q, kp, vp, k_scale, v_scale,
                               tbl, pos, start, out, o_part, m_part, l_part,
                               H, KV, hd, bs, NB, P, nbs, scale);
  if (err != cudaSuccess) return (int)err;
  if (split) {
    const size_t total = (size_t)B * H * hd;
    const int threads = 256;
    paged_merge_kernel<<<(unsigned)((total + threads - 1) / threads),
                         threads, 0, s>>>(
        (const float*)o_part, (const float*)m_part, (const float*)l_part,
        (float*)out, B, H, hd, num_splits);
  }
  return (int)cudaGetLastError();
}
