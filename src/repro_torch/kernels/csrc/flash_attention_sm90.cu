// Blockwise (flash) attention for bf16 prefill on Hopper: out = softmax(scale
// q k^T + mask) v per (batch, head), for head dims 64 and 128, with the causal,
// sliding-window and chunked-local masks and ragged Sq and Sk.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
// pallas_call at :116, body `_flash_kernel` at :27), for bf16 at D = 64 and
// 128; flash_attention.cu keeps the other head dims (mma.sync) and f32.
//
// q, k, v, out: [B*H, S, D] contiguous bf16, 16-byte aligned (GQA heads
// already repeated by the caller). It computes what `attention_ref` computes:
// scale 1/sqrt(D), query and key positions both counted from 0, keys at or
// past Sk masked, a fully masked row 0.
//
// Bound on the H100: at granite-8b's 512-token prefill (B = 1, H = 32,
// D = 128, causal) reading q, k, v and writing out moves 16.8 MB, 5.0 us at
// 3.35 TB/s, against 2.1 GFLOP of causal products (2.2 us at 989 TFLOP/s):
// bytes. At S = 4096 the 137 GFLOP (139 us) bound it: operations, so the
// tensor cores have to be kept busy.
//
// Design (one CTA per (b*h, 128-row query tile), heaviest tiles first):
//  * Warp specialisation: two consumer warpgroups own 64 query rows each; a
//    producer warpgroup, of which one thread issues every copy, hands its
//    registers to them with `setmaxnreg` (24 + 2 x 240 per thread fill the
//    SM's 65,536; the CTA can only share out what it was launched with, 384 x
//    168).
//  * TMA in, with mbarriers: the producer loads Q once, then K and V tiles of
//    128 keys into a two-stage ring in shared memory; "full" barriers (one for
//    K, one for V, so S = Q K^T can start before V lands) and an "empty"
//    barrier per stage order the ring. The tensor maps are 3-D ([B*H, S, D]),
//    so a tile past Sq or Sk is zero-filled within its own head. Tiles use the
//    128-byte swizzle, so a D = 128 tile arrives as two 64-column boxes and
//    each wgmma descriptor addresses its half.
//  * S = Q K^T with wgmma m64n128k16, A = Q and B = K both from shared memory
//    (K's rows run along the reduction, so no transposed copy).
//  * O += P V with wgmma m64nDk16, A = P from registers: the S accumulator,
//    rescaled, exponentiated and packed to bf16, is already the A fragment.
//    B = V as stored ([keys, D]) through the transpose bit.
//  * Softmax: the scale and log2(e) folded into one FMA before ex2; the
//    element mask only on tiles that cross a mask edge (the causal diagonal,
//    the window's or chunk's edge tiles, the Sk edge); -inf guards keep a
//    fully masked row at 0.
//  * Epilogue: divide by l, round to bf16, store from registers.
// Not done: overlapping one warpgroup's softmax with the other's products
// (ping-pong), or with the next tile's S = Q K^T within a warpgroup; a
// persistent grid.
#include "attention.cuh"
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace repro {
namespace {

constexpr int kBM = 128;  // query rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;  // keys per tile
constexpr int kStages = 2;  // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreadsSm90 = 32 * kConsumerWarps + 128;  // + the producer WG
constexpr uint32_t kHalf = 128 * 128;  // bytes of 128 rows of one 64-col box

template <int D>
struct Layout {
  static constexpr int kHalves = D / 64;
  static constexpr uint32_t kTile = kHalves * kHalf;  // Q, K or V tile bytes
  static constexpr uint32_t kK = kTile;               // offsets from the base
  static constexpr uint32_t kV = kK + kStages * kTile;
  static constexpr uint32_t kBars = kV + kStages * kTile;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    sm90::wgmma_m64n128k16_rs_tb(o, a, db);
  else
    sm90::wgmma_m64n64k16_rs_tb(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                      Mask mask, float scale_log2) {
  using namespace sm90;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  int lo, hi;
  key_tiles<kBN>(mask, q0, min(q0 + kBM, Sq) - 1, Sk, &lo, &hi);
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, L::kTile);
      for (int h = 0; h < L::kHalves; ++h)
        tma_load_3d(base + h * kHalf, &tq, q_full, 64 * h, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        const int k0 = (lo + i) * kBN;
        uint8_t* kt = base + L::kK + st * L::kTile;
        uint8_t* vt = base + L::kV + st * L::kTile;
        mbar_arrive_expect_tx(&k_full[st], L::kTile);
        for (int h = 0; h < L::kHalves; ++h)
          tma_load_3d(kt + h * kHalf, &tk, &k_full[st], 64 * h, k0, bh);
        mbar_arrive_expect_tx(&v_full[st], L::kTile);
        for (int h = 0; h < L::kHalves; ++h)
          tma_load_3d(vt + h * kHalf, &tv, &v_full[st], 64 * h, k0, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // rows of this warpgroup, and the row of accumulator elements 0, 1 of
    // each 8-column block (elements 2, 3 are 8 rows below)
    const int r0w = q0 + 64 * wg, r1w = r0w + 63;
    const int row0 = r0w + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(base) + 64 * 128 * wg;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = (lo + i) * kBN;
      const uint32_t k_addr = smem_u32(base + L::kK + st * L::kTile);
      const uint32_t v_addr = smem_u32(base + L::kV + st * L::kTile);

      // S = Q K^T: D / 16 steps of 16 along the head dim; step kk lies in
      // the 64-column half kk / 4, 32 bytes per step into its 128-byte rows
      float s[64];
      mbar_wait(&k_full[st], phase);
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        wgmma_m64n128k16_ss(s, desc_sw128(q_addr + off, 16, 1024),
                            desc_sw128(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      // the element mask, on tiles that cross a mask edge only
      const bool interior =
          k0 + kBN <= Sk && (!mask.causal || k0 + kBN - 1 <= r0w) &&
          (!mask.window || k0 > r1w - mask.window) &&
          (!mask.chunk || (k0 / mask.chunk == (k0 + kBN - 1) / mask.chunk &&
                           r0w / mask.chunk == r1w / mask.chunk &&
                           k0 / mask.chunk == r0w / mask.chunk));
      if (!interior) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!mask.live(row0 + 8 * (e >> 1), k0 + 8 * j + col0 + (e & 1),
                           Sk))
              s[4 * j + e] = -INFINITY;
      }

      // online softmax in base 2: p = 2^(s * scale log2(e) - m_use), where
      // m_use is the running max in the same units (0 while the row has no
      // live key, so that masked scores give exactly 0 and nothing is NaN)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      float neg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = ex2((m[h] - m_use) * scale_log2);
        m[h] = m_new;
        l[h] *= corr;
        neg[h] = -m_use * scale_log2;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * h] *= corr;
          o[4 * j + 2 * h + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, neg[e >> 1]));
          l[e >> 1] += p;
          s[4 * j + e] = p;
        }
      // P in bf16: the accumulator blocks 2 kk and 2 kk + 1 are the A
      // fragment of the 16-key slice kk
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: 16 keys (two 8-row groups of 1024 bytes) per step; the
      // 64-column halves of V are kHalf bytes apart
      mbar_wait(&v_full[st], phase);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], desc_sw128(v_addr + kk * 2048, kHalf, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    __nv_bfloat16* ob = out + (long long)bh * Sq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = quad_sum(l[h]);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      const int row = row0 + 8 * h;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = ob + (long long)row * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// A [BH, S, D] bf16 tensor as a 3-D map with 128-row, 64-column boxes and
// the 128-byte swizzle; elements outside it load as zeros.
int encode_map(sm90::EncodeTiled encode, CUtensorMap* map, const void* ptr,
               int BH, int S, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : 1;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, const Mask& mask, float scale, cudaStream_t stream) {
  sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (encode_map(encode, &tq, q, BH, Sq, D) ||
      encode_map(encode, &tk, k, BH, Sk, D) ||
      encode_map(encode, &tv, v, BH, Sk, D))
    return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  cudaError_t err = allow_smem(flash_sm90_kernel<D>, Layout<D>::kSmem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + kBM - 1) / kBM);
  flash_sm90_kernel<D><<<grid, kThreadsSm90, Layout<D>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, mask,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take: D other than
// 64 or 128, or a pointer that is not 16-byte aligned).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int Sq, int Sk, int D, int causal,
                                           int window, int chunk, float scale,
                                           void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
  if (BH < 1 || Sq < 1 || Sk < 1 || (D != 64 && D != 128) || window < 0 ||
      chunk < 0 || (align & 15) ||
      (Sq + repro::kBM - 1) / repro::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const repro::Mask mask{causal != 0, window, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return repro::launch<64>(q, k, v, out, BH, Sq, Sk, mask, scale, s);
  return repro::launch<128>(q, k, v, out, BH, Sq, Sk, mask, scale, s);
}
