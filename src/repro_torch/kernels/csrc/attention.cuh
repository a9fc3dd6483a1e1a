// The masks shared by the attention kernels (flash_attention.cu and
// flash_attention_sm90.cu): which (query, key) pairs are live, and which key
// tiles of a query tile hold a live pair.
//
// Query i and key j are positions i and j, both counted from 0. A pair is live
// when the key lies before Sk and passes every mask that is on: causal
// (j <= i), sliding window (j > i - window) and chunked-local (same chunk).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

struct Mask {
  int causal, window, chunk;
  __device__ __forceinline__ bool live(int qp, int kp, int sk) const {
    return kp < sk && (!causal || kp <= qp) && (!window || kp > qp - window) &&
           (!chunk || kp / chunk == qp / chunk);
  }
};

// Key tiles [*lo, *hi) of width kTile that hold a live pair for query rows
// [q0, q1] (the `pl.when(live)` skip of the Pallas kernel).
template <int kTile>
__device__ __forceinline__ void key_tiles(const Mask& m, int q0, int q1, int sk,
                                          int* lo, int* hi) {
  int first = 0, last = sk - 1;
  if (m.causal) last = min(last, q1);
  if (m.chunk) {
    last = min(last, (q1 / m.chunk + 1) * m.chunk - 1);
    first = max(first, (q0 / m.chunk) * m.chunk);
  }
  if (m.window) first = max(first, q0 - m.window + 1);
  *lo = first / kTile;
  *hi = last < first ? *lo : last / kTile + 1;
}

// Maximum and sum over the four lanes that hold one row of an mma fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two floats rounded to bf16 and packed low-first, as an mma A register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

}  // namespace repro
