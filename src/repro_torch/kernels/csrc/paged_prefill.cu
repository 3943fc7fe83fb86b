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
// What bounds it on this card: per key the work is 4 * hd flops for each
// of the S * H query vectors (about 4 us of fp32 FMAs at llama-3.2-1b's
// 2 x 32 chunk over 512 tokens on an H100), and the live K/V bytes are
// fewer; what set the first design's time was latency: one thread block
// of 4 warps per 32 query vectors, each 16-token block staged behind
// barriers, scored with one thread per (query, key) and run through the
// softmax with one thread per query vector, about 15 us per block, on 64
// of 132 SMs. This design is bound by instruction issue: each of the 16
// query lanes that read a chunk widens its own copy of a bf16 or int8
// element, as many instructions as the FMAs (6.5-10x the operation bound
// at 512-2048 tokens of the bf16 pool).
//
// Design (paged_common.cuh has the shared warp loop and merge):
// * One thread block per (row, kv head, tile of query vectors); a kv
//   head's query vectors are its G = H / KV heads at each of the S
//   columns, (column, head) in row-major order, and a tile is as many as
//   the lanes of a warp hold with one vector a lane group: 16 at hd 64
//   (4 columns of G 4), so llama-3.2-1b's 2 x 32 chunk gives 128 blocks.
//   Each block reads tbl, pos and start itself (no host sync per layer)
//   and walks the row's live blocks start / bs .. (pos + last column of
//   the tile) / bs; blocks past the tile's last column are wholly masked
//   for it, which leaves the online softmax exactly as it was, so they
//   are skipped. The tiles of a row re-read its K/V from the 50 MB L2.
// * Inside the block kPrefillWarps (8) warps take strided shares of those
//   blocks, each with its own cp.async ring and online softmax; a warp's
//   lanes are 16 query vectors x 2 chunk lanes at hd 64, each lane
//   scoring all keys of a staged block against its half of a row (the
//   16 query lanes of a chunk read the same shared address). No split-K
//   across thread blocks: the chunk gives a row S * H softmax rows
//   already.

#include "paged_common.cuh"

constexpr int kPrefillWarps = 8;
static_assert(32 * kPrefillWarps <= kMaxThreads, "see __launch_bounds__");

namespace {

template <typename T, bool kQuant, int kCpl, int kKeys>
__global__ void __launch_bounds__(kMaxThreads)
paged_prefill_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
                     const int* __restrict__ tbl, const int* __restrict__ pos,
                     const int* __restrict__ start, float* __restrict__ out,
                     int S, int H, int KV, int hd, int bs, int NB, int P,
                     float scale, PagedPlan p) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const LanePos lp = lane_pos(p, threadIdx.x & 31);
  const int r0 = blockIdx.z * p.lq;
  const int nr = min(p.lq, S * G - r0);
  const int r = r0 + lp.lq_, col = r / G, g = r - col * G;
  const bool active = lp.lq_ < nr;

  const int p_b = pos[b], s_b = start[b];
  const int first = s_b / bs;
  const int last = min((p_b + (r0 + nr - 1) / G) / bs, NB - 1);
  LaneState<kCpl> st;
  init_lane(st,
            q + (((size_t)b * S + col) * H + (size_t)h * G + g) * hd,
            active, hd, p, lp);
  attend_share<T, kQuant, kCpl, kKeys>(
      smem + warp * kStages * p.stage, kp, vp, ksc, vsc,
      tbl + (size_t)b * NB, h, KV, hd, bs, P, first, last, warp, warps, s_b,
      p_b + col, active, scale, p, lp, st);
  merge_block(smem, st, hd, nr, p, lp,
              [&](int i, int d, float acc, float l, float) {
                const int ri = r0 + i, ci = ri / G, gi = ri - ci * G;
                out[(((size_t)b * S + ci) * H + (size_t)h * G + gi) * hd +
                    d] = acc / fmaxf(l, 1e-30f);
              });
}

bool plan_for(int hd, int bs, int kv_dtype, uintptr_t addr, PagedPlan* p) {
  const int elem = kv_dtype == kKvF32 ? 4 : kv_dtype == kKvBF16 ? 2 : 1;
  // a tile holds as many query vectors as the lanes of a warp hold
  return make_plan(0, hd, bs, elem, kv_dtype == kKvI8, kPrefillWarps, addr,
                   p);
}

template <typename T, bool kQuant>
cudaError_t launch(dim3 grid, const PagedPlan& p, cudaStream_t s,
                   const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* tbl,
                   const void* pos, const void* start, void* out, int S,
                   int H, int KV, int hd, int bs, int NB, int P,
                   float scale) {
  return with_shape(p, [&](auto cpl, auto keys) {
    auto kernel = paged_prefill_kernel<T, kQuant, decltype(cpl)::value,
                                       decltype(keys)::value>;
    cudaError_t err = allow_smem(kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 32 * p.warps, p.smem, s>>>(
        (const float*)q, (const T*)kp, (const T*)vp, (const float*)ks,
        (const float*)vs, (const int*)tbl, (const int*)pos,
        (const int*)start, (float*)out, S, H, KV, hd, bs, NB, P, scale, p);
    return cudaSuccess;
  });
}

}  // namespace

// The plan of a prefill launch for rows of width hd, pool blocks of bs
// tokens and pool type kv_dtype (16-byte aligned pool): warps of a thread
// block, query vectors of its tile, and the lanes of a warp over keys and
// row chunks. Returns 0, or cudaErrorInvalidValue for a shape the kernel
// does not take.
extern "C" int paged_prefill_plan(int hd, int bs, int kv_dtype, int* warps,
                                  int* tile, int* lk, int* ld, int* stages) {
  PagedPlan p;
  if (hd <= 0 || bs <= 0 || kv_dtype < 0 || kv_dtype > 2 ||
      !plan_for(hd, bs, kv_dtype, 0, &p))
    return (int)cudaErrorInvalidValue;
  *warps = p.warps;
  *tile = p.lq;
  *lk = p.lk;
  *ld = p.ld;
  *stages = kStages;
  return 0;
}

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
  PagedPlan p;
  if (!plan_for(hd, bs, kv_dtype, (uintptr_t)kp | (uintptr_t)vp, &p))
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)S * (H / KV) + p.lq - 1) / p.lq;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(B, KV, (unsigned)tiles);
  cudaError_t err;
  if (kv_dtype == kKvF32)
    err = launch<float, false>(grid, p, s, q, kp, vp, k_scale, v_scale, tbl,
                               pos, start, out, S, H, KV, hd, bs, NB, P,
                               scale);
  else if (kv_dtype == kKvBF16)
    err = launch<__nv_bfloat16, false>(grid, p, s, q, kp, vp, k_scale,
                                       v_scale, tbl, pos, start, out, S, H,
                                       KV, hd, bs, NB, P, scale);
  else
    err = launch<int8_t, true>(grid, p, s, q, kp, vp, k_scale, v_scale, tbl,
                               pos, start, out, S, H, KV, hd, bs, NB, P,
                               scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
