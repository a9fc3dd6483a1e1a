// Blockwise (flash) attention for bf16 prefill on Hopper: out = softmax(scale
// q k^T + mask) v per (batch, head), for head dims 64, 128 and 256, with the
// causal, sliding-window and chunked-local masks and ragged Sq and Sk.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (the
// pallas_call at :116, body `_flash_kernel` at :27), for bf16 at D = 64, 128
// and 256; flash_attention.cu keeps the other head dims and unaligned
// tensors (mma.sync) and f32.
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
// tensor cores have to be kept busy. recurrentgemma-9b's local attention
// (B = 2, 16 heads, D = 256, S = 4096, window 2048) is operations too: 4 B H
// D flops for each of ~6.3M live (q, k) pairs, 0.21 TFLOP (0.208 ms) against
// 268 MB (80 us).
//
// Design (one CTA per (b*h, 128-row query tile), heaviest tiles first):
//  * Warp specialisation: two consumer warpgroups own 64 query rows each. At
//    D = 64 and 128 a producer warpgroup, of which one thread issues every
//    copy, hands its registers to them with `setmaxnreg` (24 + 2 x 240 per
//    thread fill the SM's 65,536; the CTA can only share out what it was
//    launched with, 384 x 168). At D = 256 there is no producer: ptxas
//    allocates the consumers' code within the launch bound's 168 registers
//    whatever `setmaxnreg` grants at run time, and there it spilled the
//    128-register O accumulator around every S = Q K^T (644 bytes). With 256
//    threads the bound is 255 and the kernel takes 207 registers, no spill
//    (tools/flash_d256_probe.py); thread 0 issues the copies, polling the
//    ring's "empty" barrier after S and after the softmax and waiting on it
//    only at the end of a tile.
//  * TMA in, with mbarriers: Q once, then K and V tiles of 128 keys (64 at
//    D = 256) into a two-stage ring in shared memory; "full" barriers (one
//    for K, one for V, so S = Q K^T can start before V lands) and an "empty"
//    barrier per stage order the ring. The tensor maps are 3-D ([B*H, S, D]),
//    so a tile past Sq or Sk is zero-filled within its own head. Tiles use the
//    128-byte swizzle, so a tile arrives as D / 64 boxes of 64 columns and
//    each wgmma descriptor addresses its box. At D = 256: Q 64 KB, the ring
//    2 x (32 + 32) KB, 197,688 bytes in all of the 232,448 a block may use
//    (128-key tiles would need 64 + 256 KB).
//  * S = Q K^T with wgmma m64n128k16 (m64n64k16 at D = 256), A = Q and B = K
//    both from shared memory (K's rows run along the reduction, so no
//    transposed copy).
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
constexpr int kStages = 2;  // K/V ring depth
constexpr int kConsumerWarps = 8;

// Shared memory of one CTA at head dim D: the Q tile, then the K and V rings.
// Every tile is D / 64 boxes of 64 columns (128-byte rows); a Q box holds kBM
// rows, a K or V box kBN. D = 256 takes 64-key tiles: 128-key ones would need
// 64 + 2 x 2 x 64 KB, above the 227 KB a block can use.
template <int D>
struct Layout {
  // a producer warpgroup that hands its registers to the consumers (D = 64,
  // 128), or none (D = 256: thread 0 issues the copies)
  static constexpr bool kProducer = D != 256;
  static constexpr int kThreads = 32 * kConsumerWarps + (kProducer ? 128 : 0);
  static constexpr int kBN = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int kBoxes = D / 64;
  static constexpr uint32_t kQBox = kBM * 128;  // bytes of one 64-column box
  static constexpr uint32_t kKVBox = kBN * 128;
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr uint32_t kKVTile = kBoxes * kKVBox;
  static constexpr uint32_t kK = kQTile;  // offsets from the base
  static constexpr uint32_t kV = kK + kStages * kKVTile;
  static constexpr uint32_t kBars = kV + kStages * kKVTile;
  static constexpr size_t kSmem = 1024 + kBars + 8 * (1 + 3 * kStages);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128)
    sm90::wgmma_m64n128k16_ss(s, da, db, accumulate);
  else
    sm90::wgmma_m64n64k16_ss(s, da, db, accumulate);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 256)
    sm90::wgmma_m64n256k16_rs_tb(o, a, db);
  else if constexpr (D == 128)
    sm90::wgmma_m64n128k16_rs_tb(o, a, db);
  else
    sm90::wgmma_m64n64k16_rs_tb(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                      Mask mask, float scale_log2) {
  using namespace sm90;
  using L = Layout<D>;
  constexpr int kBN = L::kBN;
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

  // The copies, all from one thread: Q once, then the K and V of tile i
  // into stage i % kStages once all consumer warps have released it
  auto load_q = [&] {
    tma_prefetch_map(&tq);
    tma_prefetch_map(&tk);
    tma_prefetch_map(&tv);
    mbar_arrive_expect_tx(q_full, L::kQTile);
    for (int h = 0; h < L::kBoxes; ++h)
      tma_load_3d(base + h * L::kQBox, &tq, q_full, 64 * h, q0, bh);
  };
  auto load_kv = [&](int i) {
    const int st = i % kStages;
    const int k0 = (lo + i) * kBN;
    uint8_t* kt = base + L::kK + st * L::kKVTile;
    uint8_t* vt = base + L::kV + st * L::kKVTile;
    mbar_arrive_expect_tx(&k_full[st], L::kKVTile);
    for (int h = 0; h < L::kBoxes; ++h)
      tma_load_3d(kt + h * L::kKVBox, &tk, &k_full[st], 64 * h, k0, bh);
    mbar_arrive_expect_tx(&v_full[st], L::kKVTile);
    for (int h = 0; h < L::kBoxes; ++h)
      tma_load_3d(vt + h * L::kKVBox, &tv, &v_full[st], 64 * h, k0, bh);
  };
  // parity of the phase of `empty` that frees the stage of tile i
  auto freed = [](int i) { return (uint32_t)(((i / kStages) & 1) ^ 1); };

  const int wg = threadIdx.x / 128;
  if (L::kProducer && wg == 2) {
    // ------------------------------------------------------------ producer
    if constexpr (L::kProducer) reg_dealloc<24>();
    if (threadIdx.x == 256) {
      load_q();
      for (int i = 0; i < n_tiles; ++i) {
        mbar_wait(&empty[i % kStages], freed(i));
        load_kv(i);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (L::kProducer) reg_alloc<240>();
    // without a producer, thread 0 loads the tiles ahead: the first
    // kStages now, then tile i + 1 in iteration i, as soon as both
    // warpgroups have released tile i - 1 (polled after S and after the
    // softmax, so that it waits for the other warpgroup only at the end)
    const bool loader = !L::kProducer && threadIdx.x == 0;
    int next = kStages;
    auto load_next = [&](int i, bool block) {
      if (!loader || next >= n_tiles || next > i + 1) return;
      if (block)
        mbar_wait(&empty[next % kStages], freed(next));
      else if (!mbar_try_wait(&empty[next % kStages], freed(next)))
        return;
      load_kv(next++);
    };
    if (loader) {
      load_q();
      for (int i = 0; i < min(kStages, n_tiles); ++i) load_kv(i);
    }
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
      const uint32_t k_addr = smem_u32(base + L::kK + st * L::kKVTile);
      const uint32_t v_addr = smem_u32(base + L::kV + st * L::kKVTile);

      // S = Q K^T: D / 16 steps of 16 along the head dim; step kk lies in
      // the 64-column box kk / 4, 32 bytes per step into its 128-byte rows
      float s[kBN / 2];
      mbar_wait(&k_full[st], phase);
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_qk<kBN>(s, desc_sw128(q_addr + (kk / 4) * L::kQBox + off, 16,
                                    1024),
                      desc_sw128(k_addr + (kk / 4) * L::kKVBox + off, 16,
                                 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      load_next(i, false);

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

      load_next(i, false);

      // O += P V: 16 keys (two 8-row groups of 1024 bytes) per step; the
      // 64-column boxes of V are kKVBox bytes apart
      mbar_wait(&v_full[st], phase);
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<D>(o, pa[kk],
                    desc_sw128(v_addr + kk * 2048, L::kKVBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      if (lane == 0) mbar_arrive(&empty[st]);
      load_next(i, true);
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

// A [BH, S, D] bf16 tensor as a 3-D map with `rows`-row, 64-column boxes
// and the 128-byte swizzle; elements outside it load as zeros.
int encode_map(sm90::EncodeTiled encode, CUtensorMap* map, const void* ptr,
               int BH, int S, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
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
  constexpr int kBN = Layout<D>::kBN;
  if (encode_map(encode, &tq, q, BH, Sq, D, kBM) ||
      encode_map(encode, &tk, k, BH, Sk, D, kBN) ||
      encode_map(encode, &tv, v, BH, Sk, D, kBN))
    return (int)cudaErrorInvalidValue;
  static size_t granted = 0;
  cudaError_t err = allow_smem(flash_sm90_kernel<D>, Layout<D>::kSmem, &granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Sq + kBM - 1) / kBM);
  flash_sm90_kernel<D><<<grid, Layout<D>::kThreads, Layout<D>::kSmem,
                                stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, mask,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Returns 0 on success, else the CUDA error code of the launch (or
// cudaErrorInvalidValue for arguments the kernel does not take: D other than
// 64, 128 or 256, or a pointer that is not 16-byte aligned).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int BH,
                                           int Sq, int Sk, int D, int causal,
                                           int window, int chunk, float scale,
                                           void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
  if (BH < 1 || Sq < 1 || Sk < 1 || (D != 64 && D != 128 && D != 256) ||
      window < 0 || chunk < 0 || (align & 15) ||
      (Sq + repro::kBM - 1) / repro::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const repro::Mask mask{causal != 0, window, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return repro::launch<64>(q, k, v, out, BH, Sq, Sk, mask, scale, s);
  if (D == 128)
    return repro::launch<128>(q, k, v, out, BH, Sq, Sk, mask, scale, s);
  return repro::launch<256>(q, k, v, out, BH, Sq, Sk, mask, scale, s);
}

// Dynamic shared memory a CTA of head dim D asks for (0 for a D the kernel
// does not take), for `tools/flash_d256_probe.py`.
extern "C" int flash_attention_sm90_smem_bytes(int D) {
  return D == 64    ? (int)repro::Layout<64>::kSmem
         : D == 128 ? (int)repro::Layout<128>::kSmem
         : D == 256 ? (int)repro::Layout<256>::kSmem
                    : 0;
}
