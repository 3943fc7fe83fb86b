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
// What bounds it on this card: the live K/V bytes (8 rows x 512 tokens of
// llama-3.2-1b's bf16 pool are 8.4 MB, 2.5 us at 3.35 TB/s) cost less
// than a launch; what set the first design's time was latency: one
// thread block of 4 warps per (row, kv head) staged each 16-token block
// behind barriers and ran the softmax with one thread per query head,
// about 6.8 us per block on an H100. This design is bound by instruction
// issue on the 64 of 132 SMs that 8 rows x 8 kv heads fill: about 4x the
// byte bound at 8 x 2048 tokens of the bf16 pool.
//
// Design (paged_common.cuh has the shared warp loop and merge):
// * One thread block per (row, kv head, split, tile of query heads); the
//   tile holds the G = H / KV heads of the kv head when they fit the
//   lanes (every model here: one tile). Each block reads tbl, pos and
//   start from device memory and computes its live range itself,
//   max(start / bs, split start) .. min(pos / bs, split end), so dead
//   blocks are never read and no host sync is needed per layer. Physical
//   indices are clamped into the pool, as the TPU's index map clamps them.
// * Inside the block up to kDecodeWarps warps take strided shares of the
//   live blocks, each with its own cp.async ring and online softmax; at
//   G 4 and hd 64 a warp's lanes are 4 heads x 4 key lanes x 2 chunk
//   lanes, 4 keys and 32 elements of a row per lane.
// * With num_splits > 1 each split writes its warp-merged partial (acc, m,
//   l); a dead split writes m = -inf, l = 0, acc = 0. paged_merge_kernel
//   combines the splits of every output element in split order, so
//   results are the same run to run.

#include "paged_common.cuh"

constexpr int kDecodeWarps = 8;
static_assert(32 * kDecodeWarps <= kMaxThreads, "see __launch_bounds__");

namespace {

template <typename T, bool kQuant, int kCpl, int kKeys>
__global__ void __launch_bounds__(kMaxThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ tbl, const int* __restrict__ pos,
                    const int* __restrict__ start, float* __restrict__ out,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int H, int KV, int hd,
                    int bs, int NB, int P, int nbs, int qtiles, float scale,
                    PagedPlan p) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int sp = blockIdx.z / qtiles, qt = blockIdx.z - sp * qtiles;
  const int nsp = gridDim.z / qtiles;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const LanePos lp = lane_pos(p, threadIdx.x & 31);
  const int g0 = qt * p.lq, nr = min(p.lq, G - g0);
  const bool active = lp.lq_ < nr;

  const int p_b = pos[b], s_b = start[b];
  const int first = max(s_b / bs, sp * nbs);
  const int last = min(min(p_b / bs, NB - 1), min((sp + 1) * nbs, NB) - 1);
  const size_t hq0 = (size_t)h * G + g0;          // first query head
  LaneState<kCpl> st;
  init_lane(st, q + ((size_t)b * H + hq0 + lp.lq_) * hd, active, hd, p, lp);
  attend_share<T, kQuant, kCpl, kKeys>(
      smem + warp * kStages * p.stage, kp, vp, ksc, vsc,
      tbl + (size_t)b * NB, h, KV, hd, bs, P, first, last, warp, warps, s_b,
      p_b, active, scale, p, lp, st);
  merge_block(smem, st, hd, nr, p, lp,
              [&](int r, int d, float acc, float l, float m) {
                const size_t hq = hq0 + r;
                if (o_part == nullptr) {
                  out[((size_t)b * H + hq) * hd + d] = acc / fmaxf(l, 1e-30f);
                  return;
                }
                const size_t i = ((size_t)b * nsp + sp) * H + hq;
                o_part[i * hd + d] = acc;
                if (d == 0) {
                  m_part[i] = m;
                  l_part[i] = l;
                }
              });
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

bool plan_for(int H, int KV, int hd, int bs, int kv_dtype, uintptr_t addr,
              PagedPlan* p) {
  const int elem = kv_dtype == kKvF32 ? 4 : kv_dtype == kKvBF16 ? 2 : 1;
  return make_plan(H / KV, hd, bs, elem, kv_dtype == kKvI8, kDecodeWarps,
                   addr, p);
}

template <typename T, bool kQuant>
cudaError_t launch(dim3 grid, const PagedPlan& p, cudaStream_t s,
                   const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* tbl,
                   const void* pos, const void* start, void* out,
                   void* o_part, void* m_part, void* l_part, int H, int KV,
                   int hd, int bs, int NB, int P, int nbs, int qtiles,
                   float scale) {
  return with_shape(p, [&](auto cpl, auto keys) {
    auto kernel = paged_decode_kernel<T, kQuant, decltype(cpl)::value,
                                      decltype(keys)::value>;
    cudaError_t err = allow_smem(kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 32 * p.warps, p.smem, s>>>(
        (const float*)q, (const T*)kp, (const T*)vp, (const float*)ks,
        (const float*)vs, (const int*)tbl, (const int*)pos,
        (const int*)start, (float*)out, (float*)o_part, (float*)m_part,
        (float*)l_part, H, KV, hd, bs, NB, P, nbs, qtiles, scale, p);
    return cudaSuccess;
  });
}

}  // namespace

// The plan of a decode launch for H query heads on KV kv heads of width hd,
// pool blocks of bs tokens and pool type kv_dtype (16-byte aligned pool):
// warps of a thread block, query heads of its tile, and the lanes of a warp
// over heads, keys and row chunks. Returns 0, or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int paged_decode_plan(int H, int KV, int hd, int bs, int kv_dtype,
                                 int* warps, int* tile, int* lk, int* ld,
                                 int* stages) {
  PagedPlan p;
  if (H <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || bs <= 0 ||
      kv_dtype < 0 || kv_dtype > 2 || !plan_for(H, KV, hd, bs, kv_dtype, 0, &p))
    return (int)cudaErrorInvalidValue;
  *warps = p.warps;
  *tile = p.lq;
  *lk = p.lk;
  *ld = p.ld;
  *stages = kStages;
  return 0;
}

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
      NB <= 0 || P <= 0 || num_splits < 1 || KV > 65535 ||
      split != (o_part != nullptr) || split != (m_part != nullptr) ||
      split != (l_part != nullptr) || kv_dtype < 0 || kv_dtype > 2 ||
      (kv_dtype == kKvI8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  PagedPlan p;
  if (!plan_for(H, KV, hd, bs, kv_dtype, (uintptr_t)kp | (uintptr_t)vp, &p))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV, qtiles = (G + p.lq - 1) / p.lq;
  if ((long long)num_splits * qtiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int nbs = (NB + num_splits - 1) / num_splits;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(B, KV, num_splits * qtiles);
  cudaError_t err;
  if (kv_dtype == kKvF32)
    err = launch<float, false>(grid, p, s, q, kp, vp, k_scale, v_scale, tbl,
                               pos, start, out, o_part, m_part, l_part, H,
                               KV, hd, bs, NB, P, nbs, qtiles, scale);
  else if (kv_dtype == kKvBF16)
    err = launch<__nv_bfloat16, false>(grid, p, s, q, kp, vp, k_scale,
                                       v_scale, tbl, pos, start, out, o_part,
                                       m_part, l_part, H, KV, hd, bs, NB, P,
                                       nbs, qtiles, scale);
  else
    err = launch<int8_t, true>(grid, p, s, q, kp, vp, k_scale, v_scale, tbl,
                               pos, start, out, o_part, m_part, l_part, H,
                               KV, hd, bs, NB, P, nbs, qtiles, scale);
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
