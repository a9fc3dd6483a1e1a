// R rounds of circulant gossip consensus (paper eq. 17) over the node axis
// of an [n, d] buffer, h <- sum_k w_k * roll(h, s_k, axis=0) R times. Up to
// 64 nodes it is applied as ONE pass of the composed schedule: eq. 17 is
// linear, so R rounds of a circulant are one circulant with at most n taps
// (out[i] = sum_t w_t * x[(i - s_t) mod n]). The wrapper composes the
// schedule once (`core.mixing.compose_schedule`) and passes the taps.
//
// Replaces: src/repro/kernels/consensus.py, gossip_mix_pallas (body `_kernel`).
//
// Bound on the H100: bytes. At most n multiply-adds per element, a few flops
// per byte, far below the card's balance point; the least time is one read
// of x and one write of out at 3.35 TB/s.
//
// Two designs, picked by the node count in kernels/consensus.py
// (`gossip_design`):
//
// composed (n <= kMaxNodes = 64): the launcher spreads the taps into a table
// of one weight per shift (zero for a shift with no tap), passed by value. A
// block stages one [n, bd] column tile of x in shared memory as f32, and the
// table beside it, and synchronises once. Each thread owns one column and
// kRows consecutive rows: it walks the n source rows of the tile once, each
// value read from shared memory feeding kRows f32 FMAs with the weights of
// shifts (i - j) mod n, and writes its elements once, in x's dtype. The
// wrapper picks bd, a power of two, so that there are at least as many tiles
// as SMs and at most 256 threads to a block. Running the R rounds one by one
// on the tile instead costs R (deg + 1) dependent passes over it, with a
// barrier each.
//
// rounds (n > 64, where the composed schedule would need more than kMaxNodes
// taps): as on the TPU, a block keeps one [n, bd] column tile resident in
// shared memory for all R rounds, as f32 in two buffers (ping-pong, one
// __syncthreads per round), and applies the one-round schedule R times
// (`gossip_rounds`, common.cuh), so x is still read once and out written
// once. The wrapper sizes bd with `_cuda.tile_width` (two f32 [n, bd] tiles
// in shared memory; about 900 nodes at most, at 32 columns); the Pallas
// kernel likewise holds its [n, block_d] tile in VMEM.
#include "common.cuh"

namespace repro {

constexpr int kComposed = 0, kRounds = 1;  // the C `design` argument

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

// ------------------------------------------------------------------- rounds

template <typename T>
__global__ void gossip_mix_rounds_kernel(const T* __restrict__ x,
                                         T* __restrict__ out, int n,
                                         long long d, int bd, Schedule sched,
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
static int launch_rounds(const void* x, void* out, int n, long long d, int bd,
                         const Schedule& sched, int rounds,
                         cudaStream_t stream) {
  const size_t smem = 2ull * n * bd * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(gossip_mix_rounds_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  gossip_mix_rounds_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, bd, sched, rounds);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_design(int design, const void* x, void* out, int n,
                         long long d, int bd, int rounds, int n_terms,
                         const int* shifts, const float* weights,
                         cudaStream_t stream) {
  if (design == kRounds) {
    Schedule sched;
    if (rounds < 0 || make_schedule(n_terms, shifts, weights, &sched))
      return (int)cudaErrorInvalidValue;
    for (int t = 0; t < n_terms; ++t)
      if (shifts[t] < 0 || shifts[t] >= n) return (int)cudaErrorInvalidValue;
    return launch_rounds<T>(x, out, n, d, bd, sched, rounds, stream);
  }
  if (design != kComposed || n > kMaxNodes || (bd & (bd - 1)) ||
      block_threads(n, bd) > kThreads || n_terms < 1 || n_terms > n)
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  for (int t = 0; t < n_terms; ++t) {
    if (shifts[t] < 0 || shifts[t] >= n) return (int)cudaErrorInvalidValue;
    for (int k = shifts[t]; k < 2 * n + kRows; k += n)
      taps.weight[k] += weights[t];
  }
  return launch<T>(x, out, n, d, bd, taps, stream);
}

}  // namespace repro

// design 0 = composed: (n_terms, shifts, weights) are the taps of the
// composed R-round schedule (at most n <= kMaxNodes of them, shifts in
// [0, n); `rounds` is not read), bd a power of two with at most kThreads
// threads to a block. design 1 = rounds: (n_terms, shifts, weights) are the
// one-round schedule (shifts in [0, n)), run `rounds` times on the resident
// tile. Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the design does not take).
extern "C" int gossip_mix_launch(const void* x, void* out, int n, long long d,
                                 int bd, int dtype, int design, int rounds,
                                 int n_terms, const int* shifts,
                                 const float* weights, void* stream) {
  if (n < 1 || d < 1 || bd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_design<float>(design, x, out, n, d, bd, rounds,
                                       n_terms, shifts, weights, s);
  if (dtype == 1)
    return repro::launch_design<__nv_bfloat16>(design, x, out, n, d, bd,
                                               rounds, n_terms, shifts,
                                               weights, s);
  return (int)cudaErrorInvalidValue;
}
