// What the paged-attention kernels share: the pool's element types, the
// staging of one physical KV block into shared memory, and the online
// softmax update of one block for a tile of query vectors.
//
// The pool is [P, bs, KV, hd] (fp32, bf16, or int8 with fp32 [P, bs, KV]
// scales); logical block j of row b lives at physical block tbl[b, j].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kPagedThreads = 128;             // threads of every block
constexpr int kDefaultSmem = 48 * 1024;        // above: opt in per kernel
constexpr int kMaxSmem = 227 * 1024;           // what a block may use

enum KvDtype { kKvF32 = 0, kKvBF16 = 1, kKvI8 = 2 };

__device__ __forceinline__ float kv_to_float(float v) { return v; }
__device__ __forceinline__ float kv_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float kv_to_float(int8_t v) { return (float)v; }

__device__ __forceinline__ float neg_inf() { return __int_as_float((int)0xff800000); }

// Stages the K and V rows of kv head h of physical block `phys` as fp32
// into k_s / v_s ([bs][ld], ld = hd + 1 so that threads reading one column
// of different rows hit different banks), dequantizing right after the
// load when kQuant.
template <typename T, bool kQuant>
__device__ __forceinline__ void stage_block(
    const T* __restrict__ kp, const T* __restrict__ vp,
    const float* __restrict__ ksc, const float* __restrict__ vsc,
    int phys, int h, int KV, int hd, int bs, float* k_s, float* v_s,
    int ld) {
  for (int e = threadIdx.x; e < bs * hd; e += blockDim.x) {
    const int t = e / hd, d = e - t * hd;
    const size_t row = ((size_t)phys * bs + t) * KV + h;
    float kv = kv_to_float(kp[row * hd + d]);
    float vv = kv_to_float(vp[row * hd + d]);
    if (kQuant) {
      kv = __fmul_rn(kv, ksc[row]);
      vv = __fmul_rn(vv, vsc[row]);
    }
    k_s[t * ld + d] = kv;
    v_s[t * ld + d] = vv;
  }
}

// One block of the flash loop for nr query vectors, in the reference's op
// order. On entry p_s[r][t] holds the scaled logit of query r and key t,
// or -1e30 where (r, t) is masked (valid(r, t) false); m_s / l_s / acc_s
// are the running max, sum of exponentials and unnormalized output. On
// exit they hold the state after this block. c_s is scratch [nr].
template <typename Valid>
__device__ __forceinline__ void flash_update(
    float* p_s, float* m_s, float* l_s, float* c_s, float* acc_s,
    const float* v_s, int nr, int bs, int hd, int ld, Valid valid) {
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    float* pr = p_s + r * bs;
    float mx = m_s[r];
    for (int t = 0; t < bs; ++t) mx = fmaxf(mx, pr[t]);
    float sum = 0.f;
    for (int t = 0; t < bs; ++t) {
      const float p = valid(r, t) ? expf(pr[t] - mx) : 0.f;
      pr[t] = p;
      sum += p;
    }
    const float corr = expf(m_s[r] - mx);
    l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
    m_s[r] = mx;
    c_s[r] = corr;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const float* pr = p_s + r * bs;
    float pv = 0.f;
    for (int t = 0; t < bs; ++t) pv = fmaf(pr[t], v_s[t * ld + d], pv);
    acc_s[e] = __fadd_rn(__fmul_rn(acc_s[e], c_s[r]), pv);
  }
  __syncthreads();
}

// Raises a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
