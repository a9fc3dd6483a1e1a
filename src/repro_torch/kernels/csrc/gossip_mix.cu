// R rounds of circulant gossip consensus (paper eq. 17) over the node axis
// of an [n, d] buffer:  h <- sum_k w_k * roll(h, s_k, axis=0), R times.
//
// Replaces: src/repro/kernels/consensus.py, gossip_mix_pallas (body `_kernel`).
//
// Bound on the H100: bytes. Each round is (deg + 1) multiply-adds per
// element, so the work is a few flops per byte, far below the card's
// ~20 f32 flops per byte of HBM bandwidth; the least time is one read of x
// and one write of out at 3.35 TB/s.
//
// Design: as on the TPU, a block keeps one [n, bd] column tile resident for
// all R rounds, so x is read once and out written once whatever R is. The
// tile lives in shared memory as f32 in two buffers (ping-pong, one
// __syncthreads per round). Unlike the TPU grid, the column tiles are
// independent blocks that run in parallel; bd is chosen by the wrapper so
// that there are about as many tiles as SMs and the two buffers fit in
// shared memory. Ragged columns are zero in the tile and never written.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void gossip_mix_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  int n, long long d, int bd, Schedule sched,
                                  int rounds) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + n * bd;
  const long long c0 = (long long)blockIdx.x * bd;
  const int total = n * bd;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / bd, c = idx - i * bd;
    const long long col = c0 + c;
    cur[idx] = col < d ? to_f32(x[(long long)i * d + col]) : 0.f;
  }
  __syncthreads();
  const float* h = gossip_rounds(cur, nxt, n, bd, sched, rounds);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / bd, c = idx - i * bd;
    const long long col = c0 + c;
    if (col < d) out[(long long)i * d + col] = from_f32<T>(h[idx]);
  }
}

template <typename T>
static int launch(const void* x, void* out, int n, long long d, int bd,
                  const Schedule& sched, int rounds, cudaStream_t stream) {
  const size_t smem = 2ull * n * bd * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(gossip_mix_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  gossip_mix_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, bd, sched, rounds);
  return (int)cudaGetLastError();
}

}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int gossip_mix_launch(const void* x, void* out, int n, long long d,
                                 int bd, int dtype, int rounds, int n_terms,
                                 const int* shifts, const float* weights,
                                 void* stream) {
  repro::Schedule sched;
  if (n < 1 || d < 1 || bd < 1 || rounds < 0 ||
      repro::make_schedule(n_terms, shifts, weights, &sched))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch<float>(x, out, n, d, bd, sched, rounds, s);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(x, out, n, d, bd, sched, rounds, s);
  return (int)cudaErrorInvalidValue;
}
