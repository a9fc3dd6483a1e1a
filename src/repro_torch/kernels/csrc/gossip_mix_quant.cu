// R rounds of QUANTIZED circulant gossip consensus (paper eq. 17 with the
// Section VI wire) over the node axis of an [n, d] buffer, with one
// compressor scale per [n, bd] column tile ("tile" statistics):
//
//   q = sign(h) * mean|h|                                  (sign)
//   q = clip(rint(h / s), -127, 127) * s,
//       s = max(max|h|, 1e-12) / 127                       (int8)
//   h <- w_0 * h + sum_{k: s_k != 0} w_k * roll(q, s_k, axis=0),  R times.
//
// Replaces: src/repro/kernels/consensus.py, gossip_mix_quant_pallas (body
// `_quant_kernel`).
//
// Bound on the H100: bytes. A round is a tile reduction plus (deg + 1)
// multiply-adds and one compression per element: a few operations per byte,
// far below the card's ~20 f32 operations per byte of HBM bandwidth. The
// least time is one read of x and one write of out at 3.35 TB/s.
//
// Design (cluster-tile): one thread-block cluster of C blocks per statistic
// tile. The tile width bd is part of the result (it sets which values share
// a scale), so it is the caller's block_d, never chosen from the SM count.
// But the columns of a tile are independent apart from that one scalar: the
// rolls move rows, never columns. So block r of the cluster holds all n rows
// of columns [r cw, (r + 1) cw) of the tile, cw = ceil(bd / C), for all R
// rounds (x read once, out written once): each thread one column and V rows
// of it in registers, the compressed values in shared memory. Each round:
//   1. each block reduces |h| over its values (an f64 sum for sign, an f32
//      maximum for int8): a butterfly of shuffles in each warp, then one
//      over the warps' results, so every thread holds the block's partial;
//   2. C threads of the block store it into slot [r % 2][own rank] of every
//      block of the cluster with st.async, which completes 8 bytes of that
//      block's mbarrier for the round's parity: a block waits for its own C
//      partials, not for a barrier across the cluster;
//   3. every thread combines the C partials of its slot in rank order
//      0..C-1, in f64, so every block holds the same scale;
//   4. each thread compresses its values once into shared memory, and after
//      one block barrier mixes them: h = w_0 h + sum_k w_k q[(i - s_k) mod n]
//      (self term from its registers; the schedule's first terms too).
// Only pushes cross blocks, and each is complete before its receiver's wait
// returns: no block can leave while a peer still writes its shared memory,
// and no closing barrier is needed. Two slots, by round parity, are enough:
// a block writes a slot again two rounds later, only after it has received
// every peer's partial of the round between, which each peer sends after
// reading that slot. A split arrive (relaxed) at the start, waited on after
// x is loaded, makes sure that every block of the cluster runs and has
// initialised its mbarriers before the first remote store. The wrapper
// picks C, the largest of 16, 8, 4, 2, 1 that leaves each block at least 32
// columns (d = 3072, bd = 512: 96 blocks of [10, 32] in place of 6 of
// [10, 512]); the launcher picks V, one row to a thread while the grid fits
// about 1,024 threads to an SM (one wave of clusters), else 2, 4, ... A
// block's slice is padded to a power of two, so a thread's row and column
// come from one shift, and no index is divided.
//
// Numbers: the plain version (kernels/ref.py) rounds every product and sum
// on its own, in the schedule's order, and divides correctly rounded. The
// kernel does the same (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA; __fdiv_rn; rintf rounds half to even like torch.round), so an int8
// level never flips on an ulp of difference. The sign scale's sum of |h| is
// taken in f64 by both and rounded to f32 once, so it does not depend on
// the order of the sum, and a value near 0 never changes sign between them.
// Columns past d or past the block's slice are zero; they add nothing to the
// sum or the max, and columns at or past valid_d (zero by the caller's
// contract) are left out of the mean's count.
//
// The earlier design, one 256-thread block per statistic tile (6 busy SMs at
// d = 3072, each neighbour value compressed once per term), stays as
// `resident-tile` so that a run can time it beside the cluster design; the
// wrappers of the main path never launch it.
#include "common.cuh"
#include "hopper.cuh"
#include "sync.cuh"

namespace repro {

constexpr int kSign = 0, kInt8 = 1;     // the C `quant` argument
constexpr int kClusterTile = 0, kResidentTile = 1;  // the C `design` argument
constexpr int kMaxCluster = 16;  // the largest (non-portable) cluster
constexpr int kMaxThreads = 1024;  // threads of a cluster-tile block
constexpr int kMaxValues = 16;  // tile values a cluster-tile thread holds
constexpr int kFastTerms = 8;  // schedule terms kept in registers

template <int Q>
__device__ __forceinline__ float compress(float v, float scale) {
  if (Q == kSign) return __fmul_rn((float)((v > 0.f) - (v < 0.f)), scale);
  const float level = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return __fmul_rn(level, scale);
}

// The f32 scale of one round from the tile's |h| statistic (f64).
template <int Q>
__device__ __forceinline__ float tile_scale(double stat, float count) {
  if (Q == kSign) return __fdiv_rn(__double2float_rn(stat), count);
  return __fdiv_rn(fmaxf((float)stat, 1e-12f), 127.f);
}

// ------------------------------------------------------ cluster-tile design

// Thread t of a block holds column t % CW of the block's slice and rows
// t / CW + k * (threads / CW), k < V, of the tile in registers; CW, the
// slice's width padded to a power of two (2^cw_log), divides the thread
// count, so a thread's column and rows follow from one shift at the start
// and additions after it.
template <typename T, int Q, int V>
__global__ void __launch_bounds__(kMaxThreads)
    gossip_mix_quant_cluster_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int n, long long d,
                                    int bd, int C, int cw, int cw_log,
                                    long long valid_d, Schedule sched,
                                    int rounds) {
  using namespace sm90;
  extern __shared__ float q[];  // [n, CW]: the compressed values
  __shared__ double slot[2][kMaxCluster];  // the cluster's partials, by rank
  __shared__ double warp_part[kMaxThreads / 32];
  __shared__ __align__(8) uint64_t arrived[2];  // slot[p] is complete
  const bool clustered = C > 1 && rounds > 0;
  if (clustered) {
    if (threadIdx.x == 0) {
      mbar_init(&arrived[0], 1);
      mbar_init(&arrived[1], 1);
      fence_barrier_init();
    }
    cluster_arrive_relaxed();
  }
  const unsigned rank = C > 1 ? cluster_rank() : 0u;
  const long long t0 = (long long)(blockIdx.x / C) * bd;  // the tile's column
  const int lo = (int)rank * cw;                          // the slice's column
  const long long left = d - t0 - lo;
  const int width = left <= 0 ? 0 : (int)min((long long)min(cw, bd - lo), left);
  const int c = threadIdx.x & ((1 << cw_log) - 1);
  const int i0 = threadIdx.x >> cw_log, step = blockDim.x >> cw_log;
  const T* xc = x + t0 + lo + c;
  float h[V];  // rows i0 + k step of column c
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = i0 + k * step;
    h[k] = i < n && c < width ? to_f32(xc[(long long)i * d]) : 0.f;
  }
  // the mean's count: n rows times the tile's columns below valid_d
  long long valid = valid_d - t0;
  valid = valid < 0 ? 0 : (valid > bd ? bd : valid);
  const float count = fmaxf((float)n * (float)valid, 1.f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // the schedule's first kFastTerms terms in registers
  int shift_of[kFastTerms];
  float weight_of[kFastTerms];
#pragma unroll
  for (int k = 0; k < kFastTerms; ++k) {
    shift_of[k] = k < sched.n_terms ? sched.shifts[k] : 0;
    weight_of[k] = k < sched.n_terms ? sched.weights[k] : 0.f;
  }
  // every block of the cluster runs and has initialised its mbarriers
  if (clustered) cluster_wait();
  for (int r = 0; r < rounds; ++r) {
    const int p = r & 1;
    if (clustered && threadIdx.x == 0)
      mbar_arrive_expect_tx(&arrived[p], 8u * C);
    double part;  // sign: sum of |h| (f64); int8: max |h| (exact in f32)
    if (Q == kSign) {
      part = 0.0;
#pragma unroll
      for (int k = 0; k < V; ++k) part += (double)fabsf(h[k]);
    } else {
      float m = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(h[k]));
      part = m;
    }
    // the block's partial: a butterfly in each warp, then over the warps;
    // every lane ends with the same bits
    for (int o = 16; o > 0; o >>= 1) {
      const double other = __shfl_xor_sync(0xffffffffu, part, o);
      part = Q == kSign ? part + other : fmax(part, other);
    }
    if (n_warps > 1) {
      if (lane == 0) warp_part[warp] = part;
      __syncthreads();
      part = lane < n_warps ? warp_part[lane] : 0.0;
      for (int o = 16; o > 0; o >>= 1) {
        const double other = __shfl_xor_sync(0xffffffffu, part, o);
        part = Q == kSign ? part + other : fmax(part, other);
      }
    }
    double stat = part;
    if (clustered) {
      if (warp == 0 && lane < C)
        st_async_f64(&slot[p][rank], &arrived[p], lane, part);
      mbar_wait(&arrived[p], (r >> 1) & 1);
      stat = slot[p][0];  // in rank order, the same in every block
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < C)
          stat = Q == kSign ? stat + slot[p][k] : fmax(stat, slot[p][k]);
    }
    const float scale = tile_scale<Q>(stat, count);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + k * step;
      if (i < n) q[(i << cw_log) + c] = compress<Q>(h[k], scale);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + k * step;
      if (i >= n) continue;
      float acc = 0.f;
      auto add_term = [&](int t, int shift, float weight) {
        int src = i - shift;
        if (src < 0) src += n;
        const float term =
            __fmul_rn(weight, shift == 0 ? h[k] : q[(src << cw_log) + c]);
        acc = t == 0 ? term : __fadd_rn(acc, term);
      };
#pragma unroll
      for (int t = 0; t < kFastTerms; ++t)
        if (t < sched.n_terms) add_term(t, shift_of[t], weight_of[t]);
      for (int t = kFastTerms; t < sched.n_terms; ++t)
        add_term(t, sched.shifts[t], sched.weights[t]);
      h[k] = acc;
    }
    // q is written again after the next round's first barrier (more than
    // one warp) or after this one (one warp)
    if (n_warps == 1) __syncwarp();
  }
  if (c < width) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + k * step;
      if (i < n) out[(long long)i * d + t0 + lo + c] = from_f32<T>(h[k]);
    }
  }
}

// The shape of a block holding n rows of a slice padded to 2^cw_log
// columns: V, the rows a thread holds (a power of two up to kMaxValues), and
// the threads (a multiple of 32 and of the padded width, at most
// kMaxThreads). One row to a thread where the whole grid of `blocks` fits
// about 1,024 threads to an SM, so that every cluster runs in one wave;
// else 2, 4, ... Returns false for a slice it cannot hold.
inline bool cluster_block_shape(int n, int cw_log, long long blocks, int* V,
                                int* threads) {
  static int sms = 0;
  if (sms == 0) {
    int device;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 132;
  }
  const int width = 1 << cw_log;
  for (int v = 1; v <= kMaxValues; v *= 2) {
    int t = (n + v - 1) / v * width;
    t = (t + 31) / 32 * 32;
    if (t > kMaxThreads) continue;
    *V = v;
    *threads = t;
    if (blocks * t <= 1024ll * sms) return true;
  }
  return *threads > 0;
}

template <typename T, int Q, int V>
static int launch_cluster(const void* x, void* out, int n, long long d, int bd,
                          int C, int cw, int cw_log, int threads,
                          long long valid_d, const Schedule& sched,
                          int rounds, cudaStream_t stream) {
  auto kernel = gossip_mix_quant_cluster_kernel<T, Q, V>;
  const size_t smem = (size_t)n * sizeof(float) << cw_log;
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  // clusters of more than 8 blocks are "non-portable": opt in once, on the
  // first launch (made outside any graph capture)
  static bool non_portable = false;
  if (C > 8 && !non_portable) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((d + bd - 1) / bd * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<T*>(out), n, d, bd, C, cw, cw_log,
                           valid_d, sched, rounds);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int Q>
static int launch_cluster_tile(const void* x, void* out, int n, long long d,
                               int bd, int C, long long valid_d,
                               const Schedule& sched, int rounds,
                               cudaStream_t stream) {
  const int cw = (bd + C - 1) / C;
  int cw_log = 3;  // the slice padded to a power of two, at least 8
  while ((1 << cw_log) < cw) ++cw_log;
  int V = 0, threads = 0;
  if (!cluster_block_shape(n, cw_log, (d + bd - 1) / bd * C, &V, &threads))
    return (int)cudaErrorInvalidValue;
#define REPRO_V_CASE(W)                                                  \
  case W:                                                                \
    return launch_cluster<T, Q, W>(x, out, n, d, bd, C, cw, cw_log,      \
                                   threads, valid_d, sched, rounds, stream);
  switch (V) {
    REPRO_V_CASE(1)
    REPRO_V_CASE(2)
    REPRO_V_CASE(4)
    REPRO_V_CASE(8)
    REPRO_V_CASE(16)
  }
#undef REPRO_V_CASE
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ resident-tile design

template <typename T, int Q>
__global__ void gossip_mix_quant_tile_kernel(const T* __restrict__ x,
                                             T* __restrict__ out, int n,
                                             long long d, int bd,
                                             long long valid_d, Schedule sched,
                                             int rounds) {
  extern __shared__ float smem[];
  __shared__ double scratch[33];
  float* cur = smem;
  float* nxt = smem + n * bd;
  const long long c0 = (long long)blockIdx.x * bd;
  const int total = n * bd;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / bd, c = idx - i * bd;
    const long long col = c0 + c;
    cur[idx] = col < d ? to_f32(x[(long long)i * d + col]) : 0.f;
  }
  long long valid = valid_d - c0;
  valid = valid < 0 ? 0 : (valid > bd ? bd : valid);
  const float count = fmaxf((float)n * (float)valid, 1.f);
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    float scale;
    if (Q == kSign) {
      double part = 0.0;
      for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
        part += (double)fabsf(cur[idx]);
      scale = tile_scale<Q>(block_sum(part, scratch), count);
    } else {
      float part = 0.f;
      for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
        part = fmaxf(part, fabsf(cur[idx]));
      scale = tile_scale<Q>(
          block_max(part, reinterpret_cast<float*>(scratch)), count);
    }
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int i = idx / bd, c = idx - i * bd;
      float acc = 0.f;
      for (int k = 0; k < sched.n_terms; ++k) {
        const int shift = sched.shifts[k];
        int src = i - shift;
        if (src < 0) src += n;
        const float v = cur[src * bd + c];
        const float term =
            __fmul_rn(sched.weights[k], shift == 0 ? v : compress<Q>(v, scale));
        acc = k == 0 ? term : __fadd_rn(acc, term);
      }
      nxt[idx] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx / bd, c = idx - i * bd;
    const long long col = c0 + c;
    if (col < d) out[(long long)i * d + col] = from_f32<T>(cur[idx]);
  }
}

template <typename T, int Q>
static int launch_resident_tile(const void* x, void* out, int n, long long d,
                                int bd, long long valid_d,
                                const Schedule& sched, int rounds,
                                cudaStream_t stream) {
  const size_t smem = 2ull * n * bd * sizeof(float);
  static size_t granted = 0;
  cudaError_t err =
      allow_smem(gossip_mix_quant_tile_kernel<T, Q>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  gossip_mix_quant_tile_kernel<T, Q><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, bd, valid_d, sched,
      rounds);
  return (int)cudaGetLastError();
}

template <typename T, int Q>
static int launch_design(int design, const void* x, void* out, int n,
                         long long d, int bd, int C, long long valid_d,
                         const Schedule& sched, int rounds,
                         cudaStream_t stream) {
  if (design == kClusterTile)
    return launch_cluster_tile<T, Q>(x, out, n, d, bd, C, valid_d, sched,
                                     rounds, stream);
  if (design == kResidentTile && C == 1)
    return launch_resident_tile<T, Q>(x, out, n, d, bd, valid_d, sched,
                                      rounds, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_quant(int quant, int design, const void* x, void* out, int n,
                        long long d, int bd, int C, long long valid_d,
                        const Schedule& sched, int rounds,
                        cudaStream_t stream) {
  if (quant == kSign)
    return launch_design<T, kSign>(design, x, out, n, d, bd, C, valid_d, sched,
                                   rounds, stream);
  if (quant == kInt8)
    return launch_design<T, kInt8>(design, x, out, n, d, bd, C, valid_d, sched,
                                   rounds, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). `valid_d`:
// columns at or past it are pad (zero) and leave the mean's count; pass d
// when every column is valid. `quant`: 0 = sign, 1 = int8. `cluster`: the
// blocks per statistic tile, 1, 2, 4, 8 or 16. `design`: 0 = cluster-tile,
// 1 = resident-tile (the earlier kernel, cluster 1 only).
extern "C" int gossip_mix_quant_launch(const void* x, void* out, int n,
                                       long long d, int bd, long long valid_d,
                                       int quant, int dtype, int rounds,
                                       int n_terms, const int* shifts,
                                       const float* weights, int cluster,
                                       int design, void* stream) {
  repro::Schedule sched;
  if (n < 1 || d < 1 || bd < 1 || valid_d < 0 || valid_d > d || rounds < 0 ||
      cluster < 1 || cluster > repro::kMaxCluster ||
      (cluster & (cluster - 1)) || cluster > bd ||
      repro::make_schedule(n_terms, shifts, weights, &sched))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_quant<float>(quant, design, x, out, n, d, bd, cluster,
                                      valid_d, sched, rounds, s);
  if (dtype == 1)
    return repro::launch_quant<__nv_bfloat16>(quant, design, x, out, n, d, bd,
                                              cluster, valid_d, sched, rounds,
                                              s);
  return (int)cudaErrorInvalidValue;
}
