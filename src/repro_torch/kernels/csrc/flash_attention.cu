// Blockwise (flash) attention with causal, sliding-window and chunked-local
// masks: out = softmax(scale * q k^T + mask) v, per (batch, head), with the
// softmax statistics carried online over key tiles so no [Sq, Sk] score
// matrix is ever stored.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
// pallas_call at :116, body `_flash_kernel` at :27), for f32 and for the
// bf16 calls that flash_attention_sm90.cu does not take (head dims other
// than 64, 128 and 256, or pointers not 16-byte aligned); `flash_variant` in
// kernels/flash_attention.py picks by shape.
//
// q, k, v, out: [B*H, S, D] contiguous, f32 or bf16, D <= 256 (GQA heads
// already repeated by the caller). Query i and key j are positions i and j,
// both counted from 0 (a prefix alignment when Sq < Sk). Keys at or past Sk
// are masked, and a row whose keys are all masked outputs 0, as in
// `attention_ref`. (The Pallas kernel pads Sk with zero keys, which a causal
// call with Sq > Sk can see, and gives a fully masked row the mean of the
// visited values.)
//
// Bound on the H100: at a 512-token causal prefill of 32 heads (D = 128)
// the kernel must read q, k, v and write out, 16.8 MB, or 5.0 us at
// 3.35 TB/s, against 2.1 GFLOP (2.2 us at 989 TFLOP/s bf16): bytes. At
// S = 4096 the causal products are 137 GFLOP (139 us) against 134 MB
// (40 us): operations on the tensor cores. recurrentgemma-9b's local
// attention (B = 2, 16 heads, D = 256, S = 4096, window 2048) is operations
// too: 4 * B * H * D flops for each of ~6.3M live (q, k) pairs, 0.21
// TFLOP (0.21 ms at 989 TFLOP/s), against 268 MB (80 us).
//
// Design: one block per (b*h, 64-row query tile); a loop inside the block
// over 64-key tiles takes the place of the TPU's sequential kv grid axis
// and keeps the running max, sum and output accumulator in registers. Only
// key tiles that hold a live (q, k) pair are visited (the `pl.when(live)`
// skip): for a causal mask, the tiles up to the diagonal. Blocks with the
// most tiles are scheduled first. Each q, k, v element is read from device
// memory once per query tile that needs it, and out is written once.
//  * bf16: four warps, 16 query rows each. Q k^T and P v run on the tensor
//    cores with `mma.sync.m16n8k16` (bf16 inputs, f32 accumulation); the
//    score fragment is rescaled and exponentiated in registers and rounded
//    to bf16 as the A operand of P v (as `blockwise_attention` rounds p to
//    v's dtype). K is staged in (dynamic) shared memory row-major, V
//    transposed, both with padded rows so that the fragment loads hit
//    distinct banks. Up to D = 128 the Q fragments stay in registers; at
//    D = 256 the output accumulator alone takes 128 f32 registers a
//    thread, so Q stays in shared memory and each 16-deep slice of its
//    fragment is loaded where the Q k^T loop needs it (104 KB of shared
//    memory a block, above the 48 KB static limit: the launch sets the
//    dynamic limit).
//  * f32: 256 threads, four per query row, plain f32 FMAs (no TF32: the
//    reference's f32 tolerance is 2e-5). Q, K, V and the probability tile sit
//    in shared memory (209 KB at D = 256, with the dynamic limit set); the
//    output accumulator is sized by the head-dim bucket (128 or 256).
// This bf16 path uses Ampere's mma.sync and plain loads between barriers;
// flash_attention_sm90.cu is the wgmma, TMA and warp-specialised kernel, and
// takes every aligned bf16 call at D = 64, 128 and 256 (recurrentgemma-9b's
// among them): here D = 256 serves unaligned tensors only.
#include "attention.cuh"
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace repro {

constexpr int kTileQ = 64;  // query rows per block
constexpr int kTileK = 64;  // keys per inner-loop tile

// Online-softmax update of one query row: the running max `m`, the new
// tile's maximum `mx` (already reduced over the row); returns the factor
// that rescales the old sum and accumulator. A row with no live key so far
// keeps m = -inf, and masked scores are -inf, so they contribute exactly 0.
__device__ __forceinline__ float rescale(float* m, float mx) {
  const float m_new = fmaxf(*m, mx);
  const float corr = *m == -INFINITY ? 0.f : expf(*m - m_new);
  *m = m_new;
  return corr;
}

__device__ __forceinline__ float prob(float s, float m) {
  return s == -INFINITY ? 0.f : expf(s - m);
}

// ---------------------------------------------------------------- bf16 path

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d[0..3] += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a [64, DP] tile; rows
// past `rows` and columns past D are zero. With `transpose` the tile is
// stored column-major (tile[c * stride + r]). `vec`: D % 8 == 0 and 16-byte
// aligned pointers, so eight elements move as one 16-byte load.
template <int DP>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          int rows, int r0, int D, int vec,
                                          __nv_bfloat16* tile, int stride,
                                          bool transpose) {
  constexpr int kChunks = kTileQ * DP / 8;  // 8 columns per chunk
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int c = threadIdx.x; c < kChunks; c += blockDim.x) {
    const int r = c / (DP / 8), col = (c % (DP / 8)) * 8;
    const int gr = r0 + r;
    alignas(16) __nv_bfloat16 e[8];
    if (vec && gr < rows && col < D) {
      *reinterpret_cast<uint4*>(e) =
          *reinterpret_cast<const uint4*>(src + (long long)gr * D + col);
    } else {
      for (int i = 0; i < 8; ++i)
        e[i] = (gr < rows && col + i < D) ? src[(long long)gr * D + col + i]
                                          : zero;
    }
    if (transpose) {
      for (int i = 0; i < 8; ++i) tile[(col + i) * stride + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(tile + r * stride + col) =
          *reinterpret_cast<uint4*>(e);
    }
  }
}

// The bf16 kernel's layout for the head-dim bucket DP: K rows at stride
// DP + 8, V transposed at stride kTileK + 8, and (DP > 128) Q rows at
// stride DP + 8 for the whole block's life.
template <int DP>
struct Bf16Smem {
  static constexpr int kStr = DP + 8;       // K (and Q) row stride
  static constexpr int vStr = kTileK + 8;   // transposed V row stride
  static constexpr bool kQInSmem = DP > 128;
  static constexpr int kElems = kTileK * kStr;
  static constexpr int vElems = DP * vStr;
  static constexpr int qElems = kQInSmem ? kTileQ * kStr : 0;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (size_t)(kElems + vElems + qElems);
};

// The A fragment of Q's 16-deep slice `s` for the warp's rows wr, wr + 8.
__device__ __forceinline__ void q_fragment(const __nv_bfloat16* tile,
                                           int stride, int wr, int tig, int s,
                                           uint32_t* a) {
  a[0] = ld32(tile + wr * stride + s * 16 + tig * 2);
  a[1] = ld32(tile + (wr + 8) * stride + s * 16 + tig * 2);
  a[2] = ld32(tile + wr * stride + s * 16 + 8 + tig * 2);
  a[3] = ld32(tile + (wr + 8) * stride + s * 16 + 8 + tig * 2);
}

template <int DP>
__global__ void __launch_bounds__(128)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int Sq, int Sk, int D,
                      Mask mask, float scale, int vec) {
  using L = Bf16Smem<DP>;
  constexpr int kStr = L::kStr, vStr = L::vStr;
  constexpr int kSteps = DP / 16;    // 16-deep slices of the head dim
  constexpr int nTiles = DP / 8;     // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* vt = ks + L::kElems;
  __nv_bfloat16* qs = L::kQInSmem ? vt + L::vElems : ks;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;  // longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const long long qoff = (long long)bh * Sq * D, koff = (long long)bh * Sk * D;

  // Q fragments (A operand, 16 rows per warp): in registers throughout up
  // to DP = 128 (staged through the K tile), else read from qs per slice.
  load_tile<DP>(q + qoff, Sq, q0, D, vec, qs, kStr, false);
  __syncthreads();
  const int wr = warp * 16 + g;
  uint32_t qf[L::kQInSmem ? 1 : kSteps][4];
  if constexpr (!L::kQInSmem) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) q_fragment(qs, kStr, wr, tig, s, qf[s]);
  }

  float o[nTiles][4];
#pragma unroll
  for (int n = 0; n < nTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + wr, q0 + wr + 8};

  int lo, hi;
  key_tiles<kTileK>(mask, q0, min(q0 + kTileQ, Sq) - 1, Sk, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();  // every warp is done with the previous tiles
    load_tile<DP>(k + koff, Sk, k0, D, vec, ks, kStr, false);
    load_tile<DP>(v + koff, Sk, k0, D, vec, vt, vStr, true);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 column tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t qa[4];
      const uint32_t* a = qf[0];
      if constexpr (L::kQInSmem) {
        q_fragment(qs, kStr, wr, tig, st, qa);
        a = qa;
      } else {
        a = qf[st];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kStr + st * 16 + tig * 2;
        mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }
    // scale and mask; element e of tile n is row qrow[e >> 1], key
    // k0 + n * 8 + tig * 2 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + tig * 2 + (e & 1);
        const float val = mask.live(qrow[e >> 1], kp, Sk) ? s[n][e] * scale
                                                          : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float corr = rescale(&m[h], quad_max(mx[h]));
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < nTiles; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = prob(s[n][e], m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = p;
      }
    }
    // O += P V: the score fragments of key tiles 2j and 2j + 1 are exactly
    // the A fragment of the 16-key slice j.
#pragma unroll
    for (int j = 0; j < kTileK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < nTiles; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * vStr + j * 16 + tig * 2;
        mma_bf16(o[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
    if (qrow[h] >= Sq) continue;
    __nv_bfloat16* orow = out + qoff + (long long)qrow[h] * D;
#pragma unroll
    for (int n = 0; n < nTiles; ++n) {
      const int c = n * 8 + tig * 2;
      if (c < D) orow[c] = __float2bfloat16(o[n][2 * h] / denom);
      if (c + 1 < D) orow[c + 1] = __float2bfloat16(o[n][2 * h + 1] / denom);
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kF32Threads = 256;  // four threads per query row

__device__ __forceinline__ void load_rows_f32(const float* __restrict__ src,
                                              int rows, int r0, int D,
                                              float* tile, int stride) {
  for (int i = threadIdx.x; i < kTileQ * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    tile[r * stride + c] = r0 + r < rows ? src[(long long)(r0 + r) * D + c] : 0.f;
  }
}

// DMAX: the head-dim bucket (128 or 256), which sizes the accumulator.
template <int DMAX>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Sq, int Sk, int D, Mask mask, float scale) {
  constexpr int kCols = DMAX / 4;  // output columns a thread owns
  extern __shared__ float smem[];
  const int qkStr = D + 1;  // odd stride: the rows of a warp hit distinct banks
  float* qs = smem;                      // [64][D + 1]
  float* ks = qs + kTileQ * qkStr;       // [64][D + 1]
  float* vs = ks + kTileK * qkStr;       // [64][D]
  float* ps = vs + kTileK * D;           // [64][65]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qp = q0 + r;
  const long long qoff = (long long)bh * Sq * D, koff = (long long)bh * Sk * D;

  load_rows_f32(q + qoff, Sq, q0, D, qs, qkStr);
  // thread (r, c4) owns scores of keys c4 + 4j and output columns c4 + 4i
  float o[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  int lo, hi;
  key_tiles<kTileK>(mask, q0, min(q0 + kTileQ, Sq) - 1, Sk, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();
    load_rows_f32(k + koff, Sk, k0, D, ks, qkStr);
    load_rows_f32(v + koff, Sk, k0, D, vs, D);
    __syncthreads();

    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[r * qkStr + d];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s[j] = fmaf(qv, ks[(c4 + 4 * j) * qkStr + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = mask.live(qp, k0 + c4 + 4 * j, Sk) ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = rescale(&m, quad_max(mx));
    l *= corr;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[i] *= corr;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = prob(s[j], m);
      l += p;
      ps[r * (kTileK + 1) + c4 + 4 * j] = p;
    }
    __syncwarp();  // a row's four threads share one warp
    for (int kk = 0; kk < kTileK; ++kk) {
      const float p = ps[r * (kTileK + 1) + kk];
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (c4 + 4 * i < D) o[i] = fmaf(p, vs[kk * D + c4 + 4 * i], o[i]);
    }
  }
  const float denom = fmaxf(quad_sum(l), 1e-30f);
  if (qp < Sq) {
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      if (c4 + 4 * i < D)
        out[qoff + (long long)qp * D + c4 + 4 * i] = o[i] / denom;
  }
}

template <int DMAX>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int BH, int Sq, int Sk, int D, const Mask& mask,
                      float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2ull * kTileQ * (D + 1) + kTileK * D +
                       kTileQ * (kTileK + 1));
  static size_t granted = 0;
  cudaError_t err = allow_smem(flash_f32_kernel<DMAX>, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + kTileQ - 1) / kTileQ);
  flash_f32_kernel<DMAX><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, D, mask,
      scale);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       int BH, int Sq, int Sk, int D, const Mask& mask,
                       float scale, int vec, cudaStream_t stream) {
  static size_t granted = 0;
  cudaError_t err =
      allow_smem(flash_bf16_kernel<DP>, Bf16Smem<DP>::kBytes, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + kTileQ - 1) / kTileQ);
  flash_bf16_kernel<DP><<<grid, 128, Bf16Smem<DP>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq,
      Sk, D, mask, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take). `vec` says
// that D % 8 == 0 and every pointer is 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int Sq,
                                      int Sk, int D, int causal, int window,
                                      int chunk, float scale, int dtype,
                                      int vec, void* stream) {
  if (BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > 256 || window < 0 ||
      chunk < 0 || (Sq + repro::kTileQ - 1) / repro::kTileQ > 65535)
    return (int)cudaErrorInvalidValue;
  const repro::Mask mask{causal != 0, window, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 128
               ? repro::launch_f32<128>(q, k, v, out, BH, Sq, Sk, D, mask,
                                        scale, s)
               : repro::launch_f32<256>(q, k, v, out, BH, Sq, Sk, D, mask,
                                        scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return repro::launch_bf16<32>(q, k, v, out, BH, Sq, Sk, D, mask, scale,
                                  vec, s);
  if (D <= 64)
    return repro::launch_bf16<64>(q, k, v, out, BH, Sq, Sk, D, mask, scale,
                                  vec, s);
  if (D <= 128)
    return repro::launch_bf16<128>(q, k, v, out, BH, Sq, Sk, D, mask, scale,
                                   vec, s);
  return repro::launch_bf16<256>(q, k, v, out, BH, Sq, Sk, D, mask, scale,
                                 vec, s);
}
