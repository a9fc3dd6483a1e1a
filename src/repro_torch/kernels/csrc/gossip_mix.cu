// R rounds of circulant gossip consensus (paper eq. 17) over the node axis
// of an [n, d] buffer, h <- sum_k w_k * roll(h, s_k, axis=0) R times, applied
// as ONE pass of the composed schedule: eq. 17 is linear, so R rounds of a
// circulant are one circulant with at most n taps
// (out[i] = sum_t w_t * x[(i - s_t) mod n]). The wrapper composes the
// schedule once (`core.mixing.compose_schedule`) and passes the taps.
//
// Replaces: src/repro/kernels/consensus.py, gossip_mix_pallas (body `_kernel`).
//
// Bound on the H100: bytes. At most n multiply-adds per element, a few flops
// per byte, far below the card's balance point; the least time is one read
// of x and one write of out at 3.35 TB/s.
//
// Design: the launcher spreads the taps into a table of one weight per shift
// (zero for a shift with no tap), passed by value. A block stages one [n, bd]
// column tile of x in shared memory as f32, and the table beside it, and
// synchronises once. Each thread owns
// one column and kRows consecutive rows: it walks the n source rows of the
// tile once, each value read from shared memory feeding kRows f32 FMAs with
// the weights of shifts (i - j) mod n, and writes its elements once, in x's
// dtype. The wrapper picks bd, a power of two, so that there are at least as
// many tiles as SMs and at most 256 threads to a block. Running the R rounds
// one by one on the tile instead costs R (deg + 1) dependent passes over it,
// with a barrier each.
#include "common.cuh"

namespace repro {

// The largest node count that the repository's configs, tests and benchmarks
// mix over (the composed schedule has at most n taps).
constexpr int kMaxNodes = 64;
constexpr int kRows = 4;  // output rows per thread

// The composed schedule, passed to the kernel by value: weight[k] is the
// weight of shift k mod n, for k < 2 n + kRows, so that output row i reads
// source row j with weight[i - j + n] and no modulo.
struct Taps {
  float weight[2 * kMaxNodes + kRows];
};

// Threads of a block: bd columns times ceil(n / kRows) row groups.
inline int block_threads(int n, int bd) {
  return bd * ((n + kRows - 1) / kRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                      long long d, int bd, Taps taps) {
  extern __shared__ float smem[];
  float* weight = smem;  // taps.weight
  float* tile = smem + 2 * n + kRows;  // [n, bd]
  const int c = threadIdx.x & (bd - 1);
  const int i0 = (threadIdx.x >> (__ffs(bd) - 1)) * kRows;
  const long long col = (long long)blockIdx.x * bd + c;
  // the tile's loads first, so that the table copy overlaps their latency
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = i0 + r < n && col < d ? to_f32(x[(long long)(i0 + r) * d + col])
                                 : 0.f;
  for (int k = threadIdx.x; k < 2 * n + kRows; k += blockDim.x)
    weight[k] = taps.weight[k];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (i0 + r < n) tile[(i0 + r) * bd + c] = v[r];
  __syncthreads();
  float acc[kRows] = {};
  for (int j = 0; j < n; ++j) {
    const float v = tile[j * bd + c];
    const float* w = weight + i0 - j + n;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(w[r], v, acc[r]);
  }
  if (col >= d) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (i0 + r < n) out[(long long)(i0 + r) * d + col] = from_f32<T>(acc[r]);
}

template <typename T>
static int launch(const void* x, void* out, int n, long long d, int bd,
                  const Taps& taps, cudaStream_t stream) {
  const size_t smem = ((size_t)n * bd + 2 * n + kRows) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(gossip_mix_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  gossip_mix_kernel<T><<<tiles, block_threads(n, bd), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, bd, taps);
  return (int)cudaGetLastError();
}

}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take: bd not a
// power of two, more than kThreads threads to a block, more than kMaxNodes
// nodes, more taps than nodes, or a shift outside [0, n)).
extern "C" int gossip_mix_launch(const void* x, void* out, int n, long long d,
                                 int bd, int dtype, int n_taps,
                                 const int* shifts, const float* weights,
                                 void* stream) {
  if (n < 1 || n > repro::kMaxNodes || d < 1 || bd < 1 || (bd & (bd - 1)) ||
      repro::block_threads(n, bd) > repro::kThreads || n_taps < 1 ||
      n_taps > n)
    return (int)cudaErrorInvalidValue;
  repro::Taps taps = {};
  for (int t = 0; t < n_taps; ++t) {
    if (shifts[t] < 0 || shifts[t] >= n) return (int)cudaErrorInvalidValue;
    for (int k = shifts[t]; k < 2 * n + repro::kRows; k += n)
      taps.weight[k] += weights[t];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return repro::launch<float>(x, out, n, d, bd, taps, s);
  if (dtype == 1)
    return repro::launch<__nv_bfloat16>(x, out, n, d, bd, taps, s);
  return (int)cudaErrorInvalidValue;
}
