// Mini-batch Krasulina pseudo-gradient (Alg. 2 steps 3-5), for G groups:
//   s = Z w,  xi = Z^T s / B - (mean(s^2) / max(||w||^2, 1e-30)) w
// with w [G, d] (or one w shared by all groups), Z [G, B, d] -> xi [G, d].
//
// Replaces: src/repro/kernels/krasulina_update.py, krasulina_xi_pallas
// (body `_kernel`).
//
// Bound on the H100: bytes. The work is 4 flops per element of Z against 4
// (f32) or 2 (bf16) bytes read, so Z's one read at 3.35 TB/s is the least
// time.
//
// Design: the TPU kernel streams B-tiles of Z through one core and carries
// Z^T s and sum(s^2) in scratch across the sequential grid. Blocks on
// Hopper run in parallel and in no order, and xi needs a reduction over all
// of d (s) before any column of it can be formed, so this is two launches:
//   1. row_dot_kernel: one block per row of Z computes s[g, b], and one
//      more block per group computes ||w_g||^2 (deterministic block sums, no
//      atomics).
//   2. xi_tile_kernel: a grid over 64-column tiles of d; each block reduces
//      its [B, 64] slab of Z against s with 4 row lanes (coalesced 64-wide
//      row segments), recomputes sum(s^2) from the B values of s (L2-hot),
//      and writes its xi columns once.
// Z is read twice (once per launch). A one-read design (a persistent kernel
// with a grid-wide barrier, or Z tiles kept in shared memory across both
// phases) is future work.
#include "common.cuh"

namespace repro {

constexpr int kTileD = 64;                   // xi columns per block
constexpr int kRowLanes = kThreads / kTileD;  // rows of Z reduced in parallel

template <typename T>
__global__ void xi_tile_kernel(const T* __restrict__ w, long long w_stride,
                               const T* __restrict__ z, int B, long long d,
                               const float* __restrict__ s,
                               const float* __restrict__ nrm2,
                               T* __restrict__ out) {
  __shared__ float scratch[33];
  __shared__ float part[kRowLanes][kTileD];
  const int g = blockIdx.y;
  const int tx = threadIdx.x % kTileD, ty = threadIdx.x / kTileD;
  const long long col = (long long)blockIdx.x * kTileD + tx;
  const float* sg = s + (long long)g * B;
  float s2 = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) s2 += sg[b] * sg[b];
  s2 = block_sum(s2, scratch);
  float acc = 0.f;
  if (col < d) {
    const T* zg = z + (long long)g * B * d;
    for (int b = ty; b < B; b += kRowLanes)
      acc += to_f32(zg[(long long)b * d + col]) * sg[b];
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < d) {
    float zts = 0.f;
    for (int r = 0; r < kRowLanes; ++r) zts += part[r][tx];
    const float coeff = (s2 / B) / fmaxf(nrm2[g], 1e-30f);
    const float wv = to_f32(w[g * w_stride + col]);
    out[(long long)g * d + col] = from_f32<T>(zts / B - coeff * wv);
  }
}

template <typename T>
static int launch(const void* w, long long w_stride, const void* z, int G,
                  int B, long long d, float* s, float* nrm2, void* out,
                  cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* zp = static_cast<const T*>(z);
  row_dot_kernel<T><<<dim3(B + 1, G), kThreads, 0, stream>>>(wp, w_stride, zp,
                                                             B, d, s, nrm2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + kTileD - 1) / kTileD);
  xi_tile_kernel<T><<<dim3(tiles, G), kThreads, 0, stream>>>(
      wp, w_stride, zp, B, d, s, nrm2, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro

// s: [G, B] and nrm2: [G] f32 scratch from the caller. Returns 0 on success,
// else the CUDA error code of the failed launch.
extern "C" int krasulina_xi_launch(const void* w, long long w_stride,
                                   const void* z, int G, int B, long long d,
                                   float* s, float* nrm2, void* out, int dtype,
                                   void* stream) {
  if (G < 1 || G > 65535 || B < 1 || d < 1 || w_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(w, w_stride, z, G, B, d, s, nrm2, out, st);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(w, w_stride, z, G, B, d, s, nrm2, out,
                                        st);
  return (int)cudaErrorInvalidValue;
}
