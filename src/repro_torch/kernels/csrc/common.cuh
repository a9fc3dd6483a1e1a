// Shared device code of the port's Hopper kernels (sm_90a): element
// conversion, a block-wide sum, the Z w row-dot pass both Krasulina kernels
// start with, and the R-round circulant gossip on a shared-memory tile.
//
// Every kernel reads f32 or bf16 and does its arithmetic in f32; `dtype`
// codes on the C interface are 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;   // threads per block, every kernel
constexpr int kMaxTerms = 32;   // longest one-round schedule accepted

// One-round circulant schedule, passed to the kernel by value:
// out[i] = sum_k weights[k] * h[(i - shifts[k]) mod n], shifts in [0, n).
struct Schedule {
  int n_terms;
  int shifts[kMaxTerms];
  float weights[kMaxTerms];
};

inline int make_schedule(int n_terms, const int* shifts, const float* weights,
                         Schedule* out) {
  if (n_terms < 1 || n_terms > kMaxTerms) return 1;
  out->n_terms = n_terms;
  for (int k = 0; k < n_terms; ++k) {
    out->shifts[k] = shifts[k];
    out->weights[k] = weights[k];
  }
  return 0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum of `v` over the block, returned to every thread. `scratch` holds at
// least 33 floats of shared memory; the call may be repeated.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  const float total = scratch[32];
  __syncthreads();
  return total;
}

// Launch 1 of both Krasulina kernels. Grid (B + 1, G): block (b < B, g)
// writes s[g, b] = z[g, b, :] . w[g, :]; block (B, g) writes
// nrm2[g] = ||w[g, :]||^2. `w_stride` is 0 when all G groups share one w.
template <typename T>
__global__ void row_dot_kernel(const T* __restrict__ w, long long w_stride,
                               const T* __restrict__ z, int B, long long d,
                               float* __restrict__ s,
                               float* __restrict__ nrm2) {
  __shared__ float scratch[33];
  const int b = blockIdx.x, g = blockIdx.y;
  const T* wg = w + g * w_stride;
  const T* row = b < B ? z + ((long long)g * B + b) * d : wg;
  float acc = 0.f;
  for (long long j = threadIdx.x; j < d; j += blockDim.x)
    acc += to_f32(row[j]) * to_f32(wg[j]);
  acc = block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    if (b < B)
      s[(long long)g * B + b] = acc;
    else
      nrm2[g] = acc;
  }
}

// R rounds of h <- sum_k w_k * roll(h, s_k, axis=0) on an [n, bd] f32 tile
// in shared memory, ping-ponging between `cur` and `nxt`. The caller has
// filled `cur` and synchronised; the result is in the returned buffer, and
// every thread may read it on return.
__device__ __forceinline__ float* gossip_rounds(float* cur, float* nxt, int n,
                                                int bd, const Schedule& sched,
                                                int rounds) {
  const int total = n * bd;
  for (int r = 0; r < rounds; ++r) {
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int i = idx / bd, c = idx - i * bd;
      float acc = 0.f;
      for (int k = 0; k < sched.n_terms; ++k) {
        int src = i - sched.shifts[k];
        if (src < 0) src += n;
        acc += sched.weights[k] * cur[src * bd + c];
      }
      nxt[idx] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
// `granted` remembers the largest size already granted to this kernel, so
// steady-state launches (and launches inside a CUDA graph capture) make no
// attribute call.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace repro
