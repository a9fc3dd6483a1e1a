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
// Design: one block per statistic tile. The tile width bd is part of the
// result (it sets which values share a scale), so it is the caller's
// block_d, never chosen from the SM count. The block keeps the [n, bd] tile
// in shared memory as f32 in two buffers (ping-pong) for all R rounds, so x
// is read once and out written once. Every round first reduces the whole
// tile (sum or max of |h|, warp shuffles then a shared scratch), because
// no column can be mixed before the scale is known; then each output
// element forms its neighbours' compressed values on the fly from the
// current buffer and the scale, so no third buffer holds q. The self term
// (shift 0) stays uncompressed.
//
// Numbers: the plain version (kernels/ref.py) rounds every product and sum
// on its own, in the schedule's order, and divides correctly rounded. The
// kernel does the same (__fmul_rn / __fadd_rn cannot be contracted into an
// FMA; __fdiv_rn; rintf rounds half to even like torch.round), so an int8
// level never flips on an ulp of difference. The sign scale's sum of |h| is
// taken in f64 by both and rounded to f32 once, so it does not depend on
// the order of the sum, and a value near 0 never changes sign between them.
// Columns past d are zero in the tile; they add nothing to the sum or the
// max, and columns at or past valid_d (zero by the caller's contract) are
// left out of the mean's count.
//
// At d = 3072 and bd = 512 this is 6 blocks on 132 SMs: the statistic tile
// is the unit of work. Spreading a tile over a thread-block cluster is
// later work.
#include "common.cuh"

namespace repro {

constexpr int kSign = 0, kInt8 = 1;  // the C `quant` argument

template <int Q>
__device__ __forceinline__ float compress(float v, float scale) {
  if (Q == kSign) return __fmul_rn((float)((v > 0.f) - (v < 0.f)), scale);
  const float level = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return __fmul_rn(level, scale);
}

template <typename T, int Q>
__global__ void gossip_mix_quant_kernel(const T* __restrict__ x,
                                        T* __restrict__ out, int n,
                                        long long d, int bd, long long valid_d,
                                        Schedule sched, int rounds) {
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
  // the mean's count: n rows times the tile's columns below valid_d
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
      scale = __fdiv_rn(__double2float_rn(block_sum(part, scratch)), count);
    } else {
      float part = 0.f;
      for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
        part = fmaxf(part, fabsf(cur[idx]));
      scale = __fdiv_rn(
          fmaxf(block_max(part, reinterpret_cast<float*>(scratch)), 1e-12f),
          127.f);
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
static int launch(const void* x, void* out, int n, long long d, int bd,
                  long long valid_d, const Schedule& sched, int rounds,
                  cudaStream_t stream) {
  const size_t smem = 2ull * n * bd * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(gossip_mix_quant_kernel<T, Q>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + bd - 1) / bd);
  gossip_mix_quant_kernel<T, Q><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, d, bd, valid_d, sched,
      rounds);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_quant(int quant, const void* x, void* out, int n,
                        long long d, int bd, long long valid_d,
                        const Schedule& sched, int rounds,
                        cudaStream_t stream) {
  if (quant == kSign)
    return launch<T, kSign>(x, out, n, d, bd, valid_d, sched, rounds, stream);
  if (quant == kInt8)
    return launch<T, kInt8>(x, out, n, d, bd, valid_d, sched, rounds, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). `valid_d`:
// columns at or past it are pad (zero) and leave the mean's count; pass d
// when every column is valid. `quant`: 0 = sign, 1 = int8.
extern "C" int gossip_mix_quant_launch(const void* x, void* out, int n,
                                       long long d, int bd, long long valid_d,
                                       int quant, int dtype, int rounds,
                                       int n_terms, const int* shifts,
                                       const float* weights, void* stream) {
  repro::Schedule sched;
  if (n < 1 || d < 1 || bd < 1 || valid_d < 0 || valid_d > d || rounds < 0 ||
      repro::make_schedule(n_terms, shifts, weights, &sched))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_quant<float>(quant, x, out, n, d, bd, valid_d, sched,
                                      rounds, s);
  if (dtype == 1)
    return repro::launch_quant<__nv_bfloat16>(quant, x, out, n, d, bd, valid_d,
                                              sched, rounds, s);
  return (int)cudaErrorInvalidValue;
}
