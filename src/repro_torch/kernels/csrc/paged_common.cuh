// What the paged-attention kernels share: the pool's element types, the
// per-warp plan of a thread block, and the warp-split flash loop with its
// fixed-order merge.
//
// The pool is [P, bs, KV, hd] (fp32, bf16, or int8 with fp32 [P, bs, KV]
// scales); logical block j of row b lives at physical block tbl[b, j].
// Both kernels replace Pallas TPU kernels whose grid walks a row's pool
// blocks in order with one online softmax in VMEM
// (src/repro/kernels/paged_attention.py, paged_prefill.py).
//
// What bounds them on this card: at the engine's shapes neither bytes nor
// flops but latency. A key loop that stages each 16-token block, waits at
// a barrier, scores with one thread per (query, key) and runs the softmax
// with one thread per query row took about 6.8 us per block for decode on
// an H100. So the design splits the key loop over warps, keeps each
// warp's loop free of block-wide barriers and loads ahead; what is left
// is instruction issue (widening bf16 or int8 elements and shared loads
// cost about as many instructions as the FMAs) and, at short contexts,
// the first load and the merge:
//
// * Warps own strided shares of the live blocks. Warp w of a thread block
//   takes blocks first + w, first + w + W, ... and keeps its own online
//   softmax state in registers. Its loop has no __syncthreads().
// * Each warp stages its blocks with cp.async into its own ring of
//   kStages buffers (K rows, V rows, int8 scales), 16-byte copies where
//   the rows allow, issued kStages - 1 blocks ahead of the block it
//   computes; the table entries of 32 blocks come in one load and are
//   shuffled out. The pool's raw type is staged; int8 is dequantized as
//   __fmul_rn(float(int8), scale) when read, before any other use.
// * Inside a warp the 32 lanes are lq x lk x ld: lq query vectors, lk
//   lanes splitting the block's keys, ld lanes splitting a row into
//   8-element chunks (2 or 4 a lane, read as 16-byte shared loads for
//   bf16). A dot product finishes with __shfl_xor_sync over the ld lanes.
//   The chunks and keys of a lane are compile-time counts, so the loop
//   over a block's keys is straight-line and their loads and FMA chains
//   interleave. Every lane runs its own online softmax over its keys, so
//   the max and sum need no shuffles inside the loop: lanes and warps are
//   merged once, at the end.
// * The merge: the lk lanes of a query by shuffles, then the W warps
//   through shared memory in warp order, both with the weights
//   exp(m_i - max m) of merge_splits. A state that saw no key (m = -inf,
//   l = 0, acc = 0) gets weight 0, also when every state is empty. No
//   atomics: results are the same run to run.
// * Op order as the reference where it shapes values: logits are
//   __fmul_rn(dot, scale), masked keys -1e30, m = -inf at the start, expf
//   (no fast math), acc / max(l, 1e-30). Only the order of sums inside a
//   dot product and across keys differs from the plain version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int kChunk = 8;                // pool elements a lane reads at once
constexpr int kMaxThreads = 256;         // 8 warps
constexpr int kDefaultSmem = 48 * 1024;  // above: opt in per kernel
constexpr int kMaxSmem = 227 * 1024;     // what a block may use
constexpr int kStages = 2;               // pool blocks in flight per warp

enum KvDtype { kKvF32 = 0, kKvBF16 = 1, kKvI8 = 2 };

// How a thread block runs: its warps and the lanes of each warp, and the
// byte layout of a warp's staging ring. The kernels are instantiated for
// cpl (chunks of a row a lane holds: 2 or 4) and keys (keys a lane scores
// per softmax update: 4 or 16); the plan picks the instantiation.
struct PagedPlan {
  int warps;       // warps of a thread block
  int lq, lk, ld;  // lanes over query vectors, keys, row chunks (product 32)
  int cpl, keys;   // the instantiation
  int row;         // bytes of one staged row (padded against bank conflicts)
  int stage;       // bytes of one stage: bs K rows, bs V rows, scales
  int copy;        // bytes of one cp.async (16, 8, 4), or 0: element copies
  int copy_shift;  // log2 of the copies of a row, or -1 if not a power of 2
  int zero;        // 1 when the staged rows' tails past hd must be zeros
  int smem;        // dynamic shared memory of a thread block
};

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// The plan for blocks of `qv` query vectors (0: as many as the lanes
// hold, which is what a prefill tile takes), at most `max_warps` warps.
// `addr` ORs the pool's base pointers, for the copy width. Returns false
// for a shape that does not fit.
inline bool make_plan(int qv, int hd, int bs, int elem, bool quant,
                      int max_warps, uintptr_t addr, PagedPlan* p) {
  const int nchunk = (hd + kChunk - 1) / kChunk;
  p->ld = 1;
  while ((nchunk + p->ld - 1) / p->ld > 4) {
    p->ld *= 2;
    if (p->ld > 32) return false;
  }
  p->cpl = (nchunk + p->ld - 1) / p->ld <= 2 ? 2 : 4;
  const int lanes_q = 32 / p->ld;
  int lq = 1;
  while (lq < qv && lq < lanes_q) lq *= 2;
  p->lq = qv > 0 ? lq : lanes_q;
  p->lk = 32 / (p->lq * p->ld);
  p->keys = (bs + p->lk - 1) / p->lk <= 4 ? 4 : 16;
  const int chunk = kChunk * elem;
  const int rowbytes = hd * elem;
  // a row holds the ld * cpl chunks the lanes read; rows are shifted by
  // ld chunks, so that the lk lanes reading one chunk column of
  // consecutive rows hit different banks
  p->row = align16(p->ld * p->cpl * chunk) + align16(p->ld * chunk);
  p->zero = rowbytes < p->ld * p->cpl * chunk;
  p->stage = 2 * bs * p->row + (quant ? 2 * align16(bs * 4) : 0);
  p->copy = 0;
  for (int c = 16; c >= 4; c /= 2)
    if (rowbytes % c == 0 && addr % c == 0) {
      p->copy = c;
      break;
    }
  p->copy_shift = -1;
  if (p->copy)
    for (int sh = 0; sh < 31; ++sh)
      if ((1 << sh) == rowbytes / p->copy) p->copy_shift = sh;
  for (p->warps = max_warps; p->warps >= 1; p->warps /= 2) {
    const long long ring = (long long)p->warps * kStages * p->stage;
    const long long merge = (long long)p->warps * p->lq * (hd + 2) * 4;
    const long long smem = ring > merge ? ring : merge;
    if (smem <= kMaxSmem) {
      p->smem = (int)smem;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000);
}

// ---------------------------------------------------------------------------
// staging: cp.async of one pool block into a warp's stage
// ---------------------------------------------------------------------------

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <int kBytes>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          int rows, int rowbytes,
                                          size_t src_stride, int dst_stride,
                                          int shift, int lane) {
  const int per_row = rowbytes / kBytes;
  for (int u = lane; u < rows * per_row; u += 32) {
    const int t = shift >= 0 ? u >> shift : u / per_row;
    const int c = u - t * per_row;
    cp_async<kBytes>(dst + t * dst_stride + c * kBytes,
                     src + t * src_stride + c * kBytes);
  }
}

// Stages K and V rows of kv head h of physical block `phys` (and their
// scales when quantized) into `dst`; the warp's lanes share the copies.
template <typename T, bool kQuant>
__device__ __forceinline__ void stage_block(
    char* dst, const T* __restrict__ kp, const T* __restrict__ vp,
    const float* __restrict__ ksc, const float* __restrict__ vsc, int phys,
    int h, int KV, int hd, int bs, const PagedPlan& p, int lane) {
  const int rowbytes = hd * (int)sizeof(T);
  const size_t stride = (size_t)KV * rowbytes;     // bytes between tokens
  const size_t base = ((size_t)phys * bs * KV + h) * rowbytes;
  const char* ks = (const char*)kp + base;
  const char* vs = (const char*)vp + base;
  char* kd = dst;
  char* vd = dst + bs * p.row;
  const int sh = p.copy_shift;
  if (p.copy == 16) {
    copy_rows<16>(kd, ks, bs, rowbytes, stride, p.row, sh, lane);
    copy_rows<16>(vd, vs, bs, rowbytes, stride, p.row, sh, lane);
  } else if (p.copy == 8) {
    copy_rows<8>(kd, ks, bs, rowbytes, stride, p.row, sh, lane);
    copy_rows<8>(vd, vs, bs, rowbytes, stride, p.row, sh, lane);
  } else if (p.copy == 4) {
    copy_rows<4>(kd, ks, bs, rowbytes, stride, p.row, sh, lane);
    copy_rows<4>(vd, vs, bs, rowbytes, stride, p.row, sh, lane);
  } else {                               // rows of odd widths: plain copies
    for (int e = lane; e < bs * hd; e += 32) {
      const int t = e / hd, d = e - t * hd;
      ((T*)(kd + t * p.row))[d] = ((const T*)(ks + t * stride))[d];
      ((T*)(vd + t * p.row))[d] = ((const T*)(vs + t * stride))[d];
    }
  }
  if (kQuant) {
    float* kd_s = (float*)(dst + 2 * bs * p.row);
    float* vd_s = kd_s + align16(bs * 4) / 4;
    const size_t s0 = (size_t)phys * bs * KV + h;
    for (int t = lane; t < bs; t += 32) {
      cp_async<4>(kd_s + t, ksc + s0 + (size_t)t * KV);
      cp_async<4>(vd_s + t, vsc + s0 + (size_t)t * KV);
    }
  }
}

// ---------------------------------------------------------------------------
// the lane's flash loop
// ---------------------------------------------------------------------------

// One 8-element chunk of a staged row as fp32 (bf16 widens exactly).
__device__ __forceinline__ void load_chunk(const float* s, float v[kChunk]) {
  const float4 a = ((const float4*)s)[0], b = ((const float4*)s)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* s,
                                           float v[kChunk]) {
  const uint4 u = *(const uint4*)s;
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_chunk(const int8_t* s, float v[kChunk]) {
  const uint2 u = *(const uint2*)s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = (float)(int8_t)(u.x >> (8 * i));
    v[4 + i] = (float)(int8_t)(u.y >> (8 * i));
  }
}

// What one lane carries: its query vector's kCpl chunks, and the online
// softmax over the keys it has seen (running max m, sum of exponentials
// l, unnormalized output acc on the same chunks).
template <int kCpl>
struct LaneState {
  float q[kCpl][kChunk];
  float acc[kCpl][kChunk];
  float m, l;
};

// Where a lane sits: query vector lq_, key lane lk_, chunk lane ld_. The
// lane's chunks of a row are ld_, ld_ + ld, ...
struct LanePos {
  int lq_, lk_, ld_;
};

__device__ __forceinline__ LanePos lane_pos(const PagedPlan& p, int lane) {
  return {lane / (p.ld * p.lk), (lane / p.ld) % p.lk, lane % p.ld};
}

// Loads the lane's chunks of query row `qrow` (zeros past hd, and for a
// lane without a query) and clears the softmax state.
template <int kCpl>
__device__ __forceinline__ void init_lane(LaneState<kCpl>& st,
                                          const float* qrow, bool active,
                                          int hd, const PagedPlan& p,
                                          LanePos lp) {
#pragma unroll
  for (int c = 0; c < kCpl; ++c) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int d = (lp.ld_ + p.ld * c) * kChunk + e;
      st.q[c][e] = active && d < hd ? qrow[d] : 0.f;
      st.acc[c][e] = 0.f;
    }
  }
  st.m = neg_inf();
  st.l = 0.f;
}

// The lane's share of one staged block: keys t = lk_ + lk * k, kKeys at a
// time with one softmax update each. A key is valid for the lane's query
// when t < bs and s_b <= j * bs + t <= lim; the position test is made only
// in an edge block. The code is straight-line over keys and chunks (a key
// past the block reads row 0 and is masked), so that the loads and FMA
// chains of different keys interleave.
template <typename T, bool kQuant, int kCpl, int kKeys>
__device__ __forceinline__ void attend_block(const char* stg, int j, int bs,
                                             int s_b, int lim, bool active,
                                             float scale, const PagedPlan& p,
                                             LanePos lp,
                                             LaneState<kCpl>& st) {
  const float* ksc = (const float*)(stg + 2 * bs * p.row);
  const float* vsc = ksc + align16(bs * 4) / 4;
  const int cofs = lp.ld_ * kChunk * (int)sizeof(T);   // lane's first chunk
  const int cstep = p.ld * kChunk * (int)sizeof(T);    // between its chunks
  const char* kst = stg + cofs;
  const char* vst = stg + bs * p.row + cofs;
  const int kpl = (bs + p.lk - 1) / p.lk;              // keys of this lane
  const int j0 = j * bs;
  const bool edge = j0 < s_b || j0 + bs - 1 > lim || !active;
  for (int k0 = 0; k0 < kpl; k0 += kKeys) {
    float s[kKeys];
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int t = lp.lk_ + p.lk * (k0 + k);
      const int tr = t < bs ? t : 0;
      const char* kr = kst + tr * p.row;
      const float ks = kQuant ? ksc[tr] : 1.f;
      float part[kCpl];
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        float kv[kChunk];
        load_chunk((const T*)(kr + c * cstep), kv);
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          a = fmaf(st.q[c][e], kQuant ? __fmul_rn(kv[e], ks) : kv[e], a);
        part[c] = a;
      }
      float dot = part[0];
#pragma unroll
      for (int c = 1; c < kCpl; ++c) dot += part[c];
      s[k] = dot;
    }
    for (int o = 1; o < p.ld; o *= 2)
#pragma unroll
      for (int k = 0; k < kKeys; ++k)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    unsigned valid = 0;
    float mx = st.m;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int t = lp.lk_ + p.lk * (k0 + k);
      const int jp = j0 + t;
      const bool ok =
          t < bs && (!edge || (active && jp >= s_b && jp <= lim));
      s[k] = ok ? __fmul_rn(s[k], scale) : -1e30f;
      valid |= (unsigned)ok << k;
      mx = fmaxf(mx, s[k]);
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      s[k] = (valid >> k) & 1u ? expf(s[k] - mx) : 0.f;
      sum += s[k];
    }
    const float corr = expf(st.m - mx);
    st.l = __fadd_rn(__fmul_rn(st.l, corr), sum);
    st.m = mx;
#pragma unroll
    for (int c = 0; c < kCpl; ++c)
#pragma unroll
      for (int e = 0; e < kChunk; ++e) st.acc[c][e] *= corr;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      const int t = lp.lk_ + p.lk * (k0 + k);
      const int tr = t < bs ? t : 0;
      const char* vr = vst + tr * p.row;
      const float vs = kQuant ? vsc[tr] : 1.f;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        float vv[kChunk];
        load_chunk((const T*)(vr + c * cstep), vv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          st.acc[c][e] = fmaf(s[k], kQuant ? __fmul_rn(vv[e], vs) : vv[e],
                              st.acc[c][e]);
      }
    }
  }
}

// The warp's loop over its share of logical blocks first + warp, + warps,
// ... <= last of one row (tbl_row), staged kStages - 1 blocks ahead into
// the warp's ring `ring`. No block-wide barrier inside.
template <typename T, bool kQuant, int kCpl, int kKeys>
__device__ __forceinline__ void attend_share(
    char* ring, const T* __restrict__ kp, const T* __restrict__ vp,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    const int* __restrict__ tbl_row, int h, int KV, int hd, int bs, int P,
    int first, int last, int warp, int warps, int s_b, int lim, bool active,
    float scale, const PagedPlan& p, LanePos lp, LaneState<kCpl>& st) {
  const int lane = threadIdx.x & 31;
  const int j1 = first + warp;
  const int n = last >= j1 ? (last - j1) / warps + 1 : 0;
  int phys_of = 0;            // lane i: the physical block of share i % 32
  if (p.zero) {               // the rows' tails past hd read as zeros
    for (int x = lane; x < kStages * p.stage / 4; x += 32)
      ((float*)ring)[x] = 0.f;
    __syncwarp();
  }
  auto issue = [&](int i) {
    if (i % 32 == 0) {
      const int jj = j1 + (i + lane) * warps;
      phys_of = jj <= last ? tbl_row[jj] : 0;
    }
    int phys = __shfl_sync(0xffffffffu, phys_of, i % 32);
    phys = min(max(phys, 0), P - 1);
    stage_block<T, kQuant>(ring + (i % kStages) * p.stage, kp, vp, ksc, vsc,
                           phys, h, KV, hd, bs, p, lane);
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    attend_block<T, kQuant, kCpl, kKeys>(ring + (i % kStages) * p.stage,
                                         j1 + i * warps, bs, s_b, lim,
                                         active, scale, p, lp, st);
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Weight of a state with max m in a merge whose max is mt (0 when every
// state is empty, mt = -inf).
__device__ __forceinline__ float merge_weight(float m, float mt) {
  return mt == neg_inf() ? 0.f : expf(m - mt);
}

// Merges the lk lanes of each query vector and chunk (shuffles), then
// the warps (through shared memory `smem`, in warp order) and calls
// emit(r, d, acc, l, m) once for every query vector r < nr of the block
// and element d < hd, with the merged unnormalized output, sum and max.
// Starts with a block-wide barrier: every warp must be done with its
// ring, which the merge reuses.
template <int kCpl, typename Emit>
__device__ __forceinline__ void merge_block(char* smem, LaneState<kCpl>& st,
                                            int hd, int nr,
                                            const PagedPlan& p, LanePos lp,
                                            Emit emit) {
  if (p.lk > 1) {
    float mt = st.m;
    for (int o = p.ld; o < p.ld * p.lk; o *= 2)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float w = merge_weight(st.m, mt);
    st.l *= w;
#pragma unroll
    for (int c = 0; c < kCpl; ++c)
#pragma unroll
      for (int e = 0; e < kChunk; ++e) st.acc[c][e] *= w;
    for (int o = p.ld; o < p.ld * p.lk; o *= 2) {
      st.l += __shfl_xor_sync(0xffffffffu, st.l, o);
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          st.acc[c][e] += __shfl_xor_sync(0xffffffffu, st.acc[c][e], o);
    }
    st.m = mt;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  float* acc_s = (float*)smem;                     // [warps][lq][hd]
  float* m_s = acc_s + warps * p.lq * hd;          // [warps][lq]
  float* l_s = m_s + warps * p.lq;                 // [warps][lq]
  if (lp.lk_ == 0) {
    const int i = warp * p.lq + lp.lq_;
    if (lp.ld_ == 0) {
      m_s[i] = st.m;
      l_s[i] = st.l;
    }
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int d = (lp.ld_ + p.ld * c) * kChunk + e;
        if (d < hd) acc_s[i * hd + d] = st.acc[c][e];
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < nr * hd; x += blockDim.x) {
    const int r = x / hd, d = x - r * hd;
    float mt = neg_inf();
    for (int w = 0; w < warps; ++w) mt = fmaxf(mt, m_s[w * p.lq + r]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < warps; ++w) {
      const int i = w * p.lq + r;
      const float wt = merge_weight(m_s[i], mt);
      l = __fadd_rn(l, __fmul_rn(l_s[i], wt));
      acc = __fadd_rn(acc, __fmul_rn(acc_s[i * hd + d], wt));
    }
    emit(r, d, acc, l, mt);
  }
}

// Calls f(cpl, keys) with the plan's instantiation as
// std::integral_constant tags.
template <int V>
using Int = std::integral_constant<int, V>;
template <typename F>
inline cudaError_t with_shape(const PagedPlan& p, F f) {
  if (p.cpl == 2)
    return p.keys == 4 ? f(Int<2>{}, Int<4>{}) : f(Int<2>{}, Int<16>{});
  return p.keys == 4 ? f(Int<4>{}, Int<4>{}) : f(Int<4>{}, Int<16>{});
}

// Raises a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB. The limit is set once per kernel and device, so that
// a launch inside CUDA-graph capture (after a warm-up launch) makes no
// runtime call but the launch itself.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  struct Set {
    const void* fn;
    int dev, bytes;
  };
  static Set done[64];
  static int n_done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_done; ++i)
    if (done[i].fn == (const void*)kernel && done[i].dev == dev &&
        done[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && n_done < 64)
    done[n_done++] = {(const void*)kernel, dev, bytes};
  return err;
}
