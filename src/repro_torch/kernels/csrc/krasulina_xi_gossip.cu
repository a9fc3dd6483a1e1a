// Fused D-Krasulina consensus step: per-node pseudo-gradients
//   xi_n = Z_n^T s_n / Bn - (mean(s_n^2) / max(||w_n||^2, 1e-30)) w_n,
//   s_n = Z_n w_n,
// followed by R rounds of circulant gossip over the node axis (eq. 17),
// for w [N, d] and Z [N, Bn, d] -> [N, d].
//
// Replaces: src/repro/kernels/krasulina_update.py, krasulina_xi_gossip_pallas
// (body `_xi_gossip_kernel`).
//
// Bound on the H100: bytes. Z is 4 flops per element against 4 (f32) or 2
// (bf16) bytes, and the gossip rounds run on a resident tile, so the least
// time is one read of Z and w and one write of the [N, d] result at
// 3.35 TB/s.
//
// Design: the TPU kernel runs a two-phase sequential grid, carrying s and
// ||w||^2 in scratch from phase 0 into phase 1. Hopper blocks cannot carry
// anything across a grid, so this is two launches:
//   1. row_dot_kernel (common.cuh): s[n, b] for every row of Z and
//      ||w_n||^2, one block each.
//   2. xi_gossip_tile_kernel: a grid over [N, bd] column tiles. Each block
//      copies s into shared memory, forms the xi tile for all N nodes in
//      shared memory, runs all R gossip rounds there (ping-pong buffers,
//      one __syncthreads per round) and writes the tile once. The [N, d]
//      consensus state never makes a round trip through HBM between rounds.
// Z is read twice (once per launch); a one-read design is future work.
// R = 0 returns the plain xi.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void xi_gossip_tile_kernel(const T* __restrict__ w,
                                      const T* __restrict__ z, int N, int Bn,
                                      long long d, int bd,
                                      const float* __restrict__ s,
                                      const float* __restrict__ nrm2,
                                      Schedule sched, int rounds,
                                      T* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_sh = smem;            // [N, Bn]
  float* coeff = s_sh + N * Bn;  // [N]
  float* cur = coeff + N;        // [N, bd]
  float* nxt = cur + N * bd;     // [N, bd]
  for (int idx = threadIdx.x; idx < N * Bn; idx += blockDim.x) s_sh[idx] = s[idx];
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s2 = 0.f;
    for (int b = 0; b < Bn; ++b) s2 += s_sh[n * Bn + b] * s_sh[n * Bn + b];
    coeff[n] = s2 / (Bn * fmaxf(nrm2[n], 1e-30f));
  }
  __syncthreads();
  const long long c0 = (long long)blockIdx.x * bd;
  const int total = N * bd;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx / bd, c = idx - n * bd;
    const long long col = c0 + c;
    float v = 0.f;  // pad columns stay zero: the rolls move rows, not columns
    if (col < d) {
      const T* zn = z + (long long)n * Bn * d + col;
      const float* sn = s_sh + n * Bn;
      float zts = 0.f;
      for (int b = 0; b < Bn; ++b) zts += to_f32(zn[(long long)b * d]) * sn[b];
      v = zts / Bn - coeff[n] * to_f32(w[(long long)n * d + col]);
    }
    cur[idx] = v;
  }
  __syncthreads();
  const float* h = gossip_rounds(cur, nxt, N, bd, sched, rounds);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx / bd, c = idx - n * bd;
    const long long col = c0 + c;
    if (col < d) out[(long long)n * d + col] = from_f32<T>(h[idx]);
  }
}

template <typename T>
static int launch(const void* w, const void* z, int N, int Bn, long long d,
                  int bd, float* s, float* nrm2, const Schedule& sched,
                  int rounds, void* out, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* zp = static_cast<const T*>(z);
  row_dot_kernel<T><<<dim3(Bn + 1, N), kThreads, 0, stream>>>(wp, d, zp, Bn,
                                                              d, s, nrm2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(N * Bn + N + 2 * N * bd) * sizeof(float);
  static size_t granted = 0;
  err = allow_smem(xi_gossip_tile_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  xi_gossip_tile_kernel<T><<<tiles, kThreads, smem, stream>>>(
      wp, zp, N, Bn, d, bd, s, nrm2, sched, rounds, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro

// s: [N, Bn] and nrm2: [N] f32 scratch from the caller. Returns 0 on
// success, else the CUDA error code of the failed launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int krasulina_xi_gossip_launch(const void* w, const void* z, int N,
                                          int Bn, long long d, int bd,
                                          float* s, float* nrm2, void* out,
                                          int dtype, int rounds, int n_terms,
                                          const int* shifts,
                                          const float* weights, void* stream) {
  repro::Schedule sched;
  if (N < 1 || N > 65535 || Bn < 1 || d < 1 || bd < 1 || rounds < 0 ||
      repro::make_schedule(n_terms, shifts, weights, &sched))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(w, z, N, Bn, d, bd, s, nrm2, sched, rounds,
                                out, st);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(w, z, N, Bn, d, bd, s, nrm2, sched,
                                        rounds, out, st);
  return (int)cudaErrorInvalidValue;
}
