// Mini-batch Krasulina pseudo-gradient (Alg. 2 steps 3-5), for G groups:
//   s = Z w,  xi = Z^T s / B - (mean(s^2) / max(||w||^2, 1e-30)) w
// with w [G, d] (or one w shared by all groups), Z [G, B, d] -> xi [G, d].
//
// Replaces: src/repro/kernels/krasulina_update.py, krasulina_xi_pallas
// (body `_kernel`).
//
// Bound on the H100: bytes. The work is 4 flops per element of Z against 4
// (f32) or 2 (bf16) bytes read, so one read of Z and w and one write of xi
// at 3.35 TB/s is the least time.
//
// xi needs a reduction over all of d (s and ||w||^2) before any column of it
// can be formed. The TPU kernel carries Z^T s and sum(s^2) in scratch across
// its sequential grid; Hopper blocks run in parallel and in no order. Two
// designs, picked by shape in kernels/krasulina_update.py (`xi_design`):
//
// cluster-slab (one launch; Z, w and xi each cross HBM once): one
// thread-block cluster of C blocks (256 threads each) per group g, C the
// largest of 16, 8, 4, 2 whose slab fits a block's shared memory among those
// that run every cluster in the fewest waves (`cudaOccupancyMaxActiveClusters`;
// 16 at G = 10, B = 100, d = 3072: 160 blocks, so some SMs hold two).
//   1. Block r holds columns [r cw, (r + 1) cw) of Z_g and of w_g (or of the
//      shared w) in shared memory, bf16 as bf16: the lanes of warp 0 ask the
//      TMA for the w slice and for the [B, cw] slab, in boxes of at most
//      256 x 256 (at least four where B allows), all at once, each box
//      completing its own mbarrier, so the dots of a box start as soon as
//      it lands. The relaxed cluster arrive made after the mbarriers'
//      initialisation is waited on while the loads are in flight: every
//      block of the cluster has its mbarriers ready before any remote store.
//   2. The block's partial s[b] over its columns and partial ||w||^2, f32,
//      a few threads to a row (one more "row" is w itself), rows of several
//      column boxes summed box by box in a fixed order.
//   3. The block pushes its B + 1 partials into slot [r] of every block of
//      the cluster (itself included) with st.async, 16 bytes at a time, each
//      store completing the receiver's own mbarrier: a block waits for its C
//      slots only, with no barrier across the cluster.
//   4. Every block sums the C slots in rank order 0..C-1 (and every warp
//      sum(s^2) in one fixed order), so every block of a cluster, and every
//      run, gets the same bits: no float atomics, no global scratch, no
//      grid barrier and no barrier word.
//   5. Each block forms xi for its columns from the slab it still holds
//      (one thread per four columns and run of rows, the runs summed in
//      order) and writes them once.
// A block waits for all C pushes into its own shared memory before it
// leaves, so no block exits while a peer still writes to it.
// The phases run one after another in each block, and the chain of their
// latencies, not the bytes, sets the time at the main path's shape: bf16
// takes as long as f32, and a block that shares its SM with another (160
// blocks on 132 SMs) finishes last. tools/xi_slab_probe.py times the
// kernel cut after each phase, and over G.
//
// two-pass (the earlier design; shapes whose slab does not fit one block's
// shared memory even at C = 16, a row stride the TMA cannot take, or w or Z
// not 16-byte aligned):
//   1. row_dot_kernel (common.cuh): one block per row of Z computes s[g, b],
//      and one more block per group ||w_g||^2.
//   2. xi_tile_kernel: a grid over 64-column tiles of d; each block reduces
//      its [B, 64] slab of Z against s with 4 row lanes, recomputes sum(s^2)
//      from the B values of s (L2-hot), and writes its xi columns once.
//   Z is read twice, once per launch.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "sync.cuh"

namespace repro {

constexpr int kClusterSlab = 0, kTwoPass = 1;  // the C `design` argument
constexpr int kSlabThreads = 256;
constexpr int kBoxMax = 256;    // elements along one dimension of a TMA box
constexpr int kMaxCluster = 16;  // the largest (non-portable) cluster
constexpr int kMinRowBoxes = 4;  // boxes down a slice where B allows
constexpr int kMaxRowRuns = 8;   // runs of rows a column's sum is split into
constexpr size_t kSmemBytes = 232448;  // shared memory a block may opt into

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline long long round_up(long long v, long long a) { return cdiv(v, a) * a; }

// The geometry of one cluster-slab launch, computed on the host and passed
// by value, so that the kernel divides nothing. A block's slice of a group
// is cw = nbc * bc columns (ceil(d / C) rounded up to a multiple of 8), in
// nbc column boxes of bc <= 256, and B rows in nbr row boxes of br <= 256
// rows (at least kMinRowBoxes boxes in all where B allows, so the dots start
// early; br a multiple of what keeps every box on a 128-byte boundary).
// Shared memory, in bytes from a 128-byte aligned base: nb + 2 mbarriers
// (the Z boxes, the w slice, the exchange); the nbc boxes of w, each on a
// 128-byte boundary; the slab, column box j at j * colbox with its rows
// contiguous, bc elements apart; then f32: the partials of each column box
// [nbc, B + 1], the block's own [E4] (B + 1 padded to 4), the receive slots
// [C, E4], the final s and ||w||^2 [E4] with sum(s^2) after them, and,
// where a column's rows are split over nrg threads, their sums [nrg, cw].
// kernels/krasulina_update.py (`xi_slab_shape`, `xi_slab_smem`) mirrors it.
struct SlabArgs {
  int B, C, cw, bc, nbc, br, nbr, E4, nrg, shared_w;
  long long d;
  int wbox, colbox, w, slab, upart, part, recv, fin, red, total;
};

inline SlabArgs slab_args(int B, long long d, int C, int elem, int shared_w) {
  SlabArgs a;
  a.B = B;
  a.C = C;
  a.d = d;
  a.shared_w = shared_w;
  const long long per = cdiv(d, C);
  a.nbc = (int)cdiv(per, kBoxMax);
  a.bc = (int)round_up(cdiv(per, a.nbc), 8);
  a.cw = a.nbc * a.bc;
  int step = 1;  // rows that make a whole number of 128-byte lines
  while ((long long)step * a.bc * elem % 128) step *= 2;
  const long long want = cdiv(kMinRowBoxes, a.nbc);
  long long nbr = cdiv(B, kBoxMax);
  if (want > nbr) nbr = want < B ? want : B;
  a.br = (int)round_up(cdiv(B, nbr), step);
  if (a.br > kBoxMax) a.br = kBoxMax;
  a.nbr = (int)cdiv(B, a.br);
  a.E4 = (int)round_up(B + 1, 4);
  const int quads = a.cw / 4;
  a.nrg = quads >= kSlabThreads ? 1 : kSlabThreads / quads;
  if (a.nrg > kMaxRowRuns) a.nrg = kMaxRowRuns;
  const long long nb = (long long)a.nbr * a.nbc;
  a.wbox = (int)round_up((long long)a.bc * elem, 128);
  a.colbox = a.nbr * a.br * a.bc * elem;
  a.w = (int)round_up(8 * (nb + 2), 128);
  a.slab = a.w + a.nbc * a.wbox;
  a.upart = a.slab + a.nbc * a.colbox;
  a.part = a.upart + (int)round_up(4ll * a.nbc * (B + 1), 16);
  a.recv = a.part + 4 * a.E4;
  a.fin = a.recv + 4 * C * a.E4;
  a.red = a.fin + 4 * (a.E4 + 4);
  const long long total =
      a.red + (a.nrg > 1 ? 4ll * a.nrg * a.cw : 0) + 128;  // + base alignment
  a.total = total > (long long)kSmemBytes ? -1 : (int)total;
  return a;
}

// Four consecutive elements (16-byte aligned for f32, 8 for bf16) as f32,
// and stored from f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(p);
  pair[0] = __floats2bfloat162_rn(v.x, v.y);
  pair[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void fma4(float4& a, float4 x, float4 y) {
  a.x = fmaf(x.x, y.x, a.x);
  a.y = fmaf(x.y, y.y, a.y);
  a.z = fmaf(x.z, y.z, a.z);
  a.w = fmaf(x.w, y.w, a.w);
}
__device__ __forceinline__ void fma4(float4& a, float4 x, float y) {
  a.x = fmaf(x.x, y, a.x);
  a.y = fmaf(x.y, y, a.y);
  a.z = fmaf(x.z, y, a.z);
  a.w = fmaf(x.w, y, a.w);
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T>
__global__ void __launch_bounds__(kSlabThreads, 3)
    xi_cluster_slab_kernel(const __grid_constant__ CUtensorMap zmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ SlabArgs A,
                           T* __restrict__ out) {
  using namespace sm90;
  if (threadIdx.x == 0) {  // the descriptors' fetch under the params' one
    tma_prefetch_map(&wmap);
    tma_prefetch_map(&zmap);
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int B = A.B, C = A.C, bc = A.bc, E = B + 1, E4 = A.E4;
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // Z boxes, w, exchange
  const int nb = A.nbr * A.nbc;
  uint64_t* wfull = full + nb;
  uint64_t* xfull = full + nb + 1;
  const unsigned char* slab = base + A.slab;
  float* part = reinterpret_cast<float*>(base + A.part);
  // the dots of each column box; with one box, the block's partials
  float* upart = A.nbc == 1 ? part : reinterpret_cast<float*>(base + A.upart);
  float* recv = reinterpret_cast<float*>(base + A.recv);
  float* fin = reinterpret_cast<float*>(base + A.fin);
  float* red = reinterpret_cast<float*>(base + A.red);
  const unsigned rank = cluster_rank();
  const int g = blockIdx.x / C;
  const long long c0 = (long long)rank * A.cw;
  const long long left = A.d - c0;
  // the slice's columns inside d, and the column boxes that hold any
  const int width = left <= 0 ? 0 : (int)(left < A.cw ? left : A.cw);
  const int live = (width + bc - 1) / bc;
  const int lane = threadIdx.x & 31;
  const int box_bytes = A.br * bc * (int)sizeof(T);
  if (threadIdx.x < 32) {  // every load of the block in flight at once
    if (lane == 0) {
      for (int k = 0; k < nb; ++k) mbar_init(&full[k], 1);
      mbar_init(wfull, live > 0 ? live : 1);
      mbar_init(xfull, 1);
      fence_barrier_init();
      // the C peers' pushes may land before this arrival: the phase
      // completes when both are in
      mbar_arrive_expect_tx(xfull, 4u * C * E4);
    }
    __syncwarp();
    // lane t asks the TMA for w box t (t < live), then for Z box
    // (row box i, column box j), w and Z of group g
    for (int t = lane; t < live * (A.nbr + 1); t += 32) {
      if (t < live) {
        mbar_arrive_expect_tx(wfull, (uint32_t)(bc * sizeof(T)));
        tma_load_3d(base + A.w + t * A.wbox, &wmap, wfull,
                    (int)(c0 + t * bc), 0, A.shared_w ? 0 : g);
      } else {
        const int j = (t - live) / A.nbr, i = t - live - j * A.nbr;
        uint64_t* bar = &full[j * A.nbr + i];
        mbar_arrive_expect_tx(bar, (uint32_t)box_bytes);
        tma_load_3d(base + A.slab + j * A.colbox + i * box_bytes, &zmap, bar,
                    (int)(c0 + j * bc), i * A.br, g);
      }
    }
  }
  // the padding of the partials (all of them in a slice past d)
  for (int b = (live > 0 ? E : 0) + threadIdx.x; b < E4; b += kSlabThreads)
    part[b] = 0.f;
  cluster_arrive_relaxed();
  __syncthreads();  // the mbarriers are initialised
  // every peer has initialised its mbarriers before any push (step 3): the
  // cluster barrier completes while the loads are in flight
  cluster_wait();
  // 1. partial dots: unit (j, b) is row b of column box j (row B is w
  // itself, for ||w||^2), `lanes` threads to a unit (a power of two up to
  // 32, more where units are few), four columns at a time, two chains; a
  // group of lanes starts at its own quad of the row, so that the lanes of a
  // quarter warp read distinct banks
  const int units = E * live, quads = bc / 4;
  int lanes = 1;
  while (lanes < 32 && lanes < quads && units * lanes * 2 <= kSlabThreads)
    lanes *= 2;
  const int sub = threadIdx.x & (lanes - 1);
  const int rot = ((lane / lanes) * lanes) % quads;
  for (int u0 = 0; u0 < units; u0 += kSlabThreads / lanes) {
    const int u = u0 + threadIdx.x / lanes;
    const int j = u / E, b = u - j * E;
    float acc = 0.f;
    if (u < units) {
      const T* wr = reinterpret_cast<const T*>(base + A.w + j * A.wbox);
      const T* zr = wr;
      mbar_wait(wfull, 0);
      if (b < B) {
        mbar_wait(&full[j * A.nbr + b / A.br], 0);
        zr = reinterpret_cast<const T*>(slab + j * A.colbox) + b * bc;
      }
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      int k = sub;
      for (; k + lanes < quads; k += 2 * lanes) {
        int q0 = k + rot, q1 = k + lanes + rot;
        q0 = q0 >= quads ? q0 - quads : q0;
        q1 = q1 >= quads ? q1 - quads : q1;
        fma4(a0, load4(zr + 4 * q0), load4(wr + 4 * q0));
        fma4(a1, load4(zr + 4 * q1), load4(wr + 4 * q1));
      }
      if (k < quads) {
        int q0 = k + rot;
        q0 = q0 >= quads ? q0 - quads : q0;
        fma4(a0, load4(zr + 4 * q0), load4(wr + 4 * q0));
      }
      a0 = add4(a0, a1);
      acc = (a0.x + a0.y) + (a0.z + a0.w);
    }
    for (int o = lanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (u < units && sub == 0) upart[j * E + b] = acc;
  }
  __syncthreads();
  // 2. with several column boxes, the block's partials over them, in box
  // order
  if (A.nbc > 1) {
    for (int b = threadIdx.x; b < E; b += kSlabThreads) {
      float acc = 0.f;
      for (int j = 0; j < live; ++j) acc += upart[j * E + b];
      part[b] = acc;
    }
    __syncthreads();
  }
  // 3. push the partials into slot [rank] of every block of the cluster
  // (itself included), 16 bytes a store
  const int per_peer = E4 / 4;
  for (int t = threadIdx.x; t < C * per_peer; t += kSlabThreads) {
    const int peer = t / per_peer, q = t - peer * per_peer;
    st_async_v4(recv + rank * E4 + 4 * q, xfull, (unsigned)peer,
                *reinterpret_cast<const float4*>(part + 4 * q));
  }
  // 4. the C slots in rank order: every block of the cluster, and every
  // run, gets the same bits (no float atomics)
  mbar_wait(xfull, 0);
  for (int b = threadIdx.x; b < E; b += kSlabThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) v[r] = r < C ? recv[r * E4 + b] : 0.f;
    float acc = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) acc += v[r];
    fin[b] = acc;
  }
  __syncthreads();
  // 5. xi = Z^T s / B - coeff w on the slab: thread t takes quad t % nq of
  // the slice (nq = cw / 4) and the rg-th of nrg runs of rpg rows (rg =
  // t / nq; rpg a multiple of 4, so s is read four rows at a time), two
  // chains; the runs' sums meet in `red` and add up in run order, one
  // thread to a column. Every warp sums s^2 for coeff in one fixed order
  // (lane-strided, then a butterfly), so all get the same bits.
  const int nq = A.cw / 4, qpb = bc / 4, nrg = A.nrg, live_q = live * qpb;
  const int rpg = ((B + nrg - 1) / nrg + 3) & ~3;
  T* og = out + (long long)g * A.d + c0;
  auto column_sum = [&](int q, int rg) {
    const int j = q / qpb, c = 4 * (q - j * qpb);
    const T* zc = reinterpret_cast<const T*>(slab + j * A.colbox) + c;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    const int b1 = min(B, (rg + 1) * rpg);
    int b = rg * rpg;
    for (; b + 4 <= b1; b += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(fin + b);
      const float4 z0 = load4(zc + b * bc), z1 = load4(zc + (b + 1) * bc);
      const float4 z2 = load4(zc + (b + 2) * bc), z3 = load4(zc + (b + 3) * bc);
      fma4(a0, z0, s4.x);
      fma4(a1, z1, s4.y);
      fma4(a0, z2, s4.z);
      fma4(a1, z3, s4.w);
    }
    for (; b < b1; ++b) fma4(a0, load4(zc + b * bc), fin[b]);
    return add4(a0, a1);
  };
  auto coefficient = [&]() {
    float s2 = 0.f;
    for (int b = lane; b < B; b += 32) s2 = fmaf(fin[b], fin[b], s2);
    for (int o = 16; o > 0; o >>= 1)
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    return s2 / B / fmaxf(fin[B], 1e-30f);
  };
  const float inv_b = 1.f / B;
  if (nrg > 1) {  // cw < 4 kSlabThreads: one pass
    const int rg = threadIdx.x / nq, q = threadIdx.x - rg * nq;
    if (rg < nrg && q < live_q)
      store4(red + rg * A.cw + 4 * q, column_sum(q, rg));
    const float coeff = coefficient();
    __syncthreads();
    for (int c = threadIdx.x; c < width; c += kSlabThreads) {
      float acc = red[c];
      for (int r = 1; r < nrg; ++r) acc += red[r * A.cw + c];
      const int j = c / bc;
      const float wv = to_f32(
          reinterpret_cast<const T*>(base + A.w + j * A.wbox)[c - j * bc]);
      og[c] = from_f32<T>(acc * inv_b - coeff * wv);
    }
  } else {
    const float coeff = coefficient();
    for (int q = threadIdx.x; q < live_q; q += kSlabThreads) {
      const float4 acc = column_sum(q, 0);
      const int j = q / qpb, cc = 4 * (q - j * qpb), c = j * bc + cc;
      if (c >= width) break;
      const float4 w4 =
          load4(reinterpret_cast<const T*>(base + A.w + j * A.wbox) + cc);
      const float4 x = make_float4(acc.x * inv_b - coeff * w4.x,
                                   acc.y * inv_b - coeff * w4.y,
                                   acc.z * inv_b - coeff * w4.z,
                                   acc.w * inv_b - coeff * w4.w);
      if (c + 4 <= width) {
        store4(og + c, x);  // d and cw are multiples of 4: aligned
      } else {
        og[c] = from_f32<T>(x.x);
        if (c + 1 < width) og[c + 1] = from_f32<T>(x.y);
        if (c + 2 < width) og[c + 2] = from_f32<T>(x.z);
      }
    }
  }
}

// The clusters of `C` blocks with `smem` bytes each that the card holds at
// once, asked once per (C, smem) and remembered.
template <typename K>
static int clusters_resident(K kernel, int C, size_t smem) {
  struct Entry {
    int C;
    size_t smem;
    int active;
  };
  constexpr int kSeen = 64;
  static Entry seen[kSeen];
  static int n_seen = 0;
  for (int k = 0; k < n_seen && k < kSeen; ++k)
    if (seen[k].C == C && seen[k].smem == smem) return seen[k].active;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(kSlabThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size the card cannot hold: not an error here
    active = 0;
  }
  seen[n_seen++ % kSeen] = Entry{C, smem, active};
  return active;
}

template <typename T>
static int launch_cluster_slab(const void* w, long long w_stride,
                               const void* z, int G, int B, long long d,
                               void* out, int* cluster, cudaStream_t stream) {
  auto kernel = xi_cluster_slab_kernel<T>;
  if (((d * (long long)sizeof(T)) & 15) ||
      ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(w)) &
       15) ||
      (w_stride != 0 && w_stride != d))
    return (int)cudaErrorInvalidValue;
  // clusters of more than 8 blocks are "non-portable": opt in once, and
  // grant the largest slab that fits (both outside any graph capture, at
  // the first launch)
  static bool opted = false;
  cudaError_t err;
  if (!opted) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kSmemBytes)) != cudaSuccess)
      return (int)err;
    opted = true;
  }
  // C: the fewest waves of clusters, then the larger C
  SlabArgs best;
  long long best_waves = 0;
  best.C = 0;
  for (int C = kMaxCluster; C >= 2; C /= 2) {
    const SlabArgs a = slab_args(B, d, C, sizeof(T), w_stride == 0);
    if (a.total < 0) continue;
    const int active = clusters_resident(kernel, C, a.total);
    if (active < 1) continue;
    const long long waves = cdiv(G, active);
    if (best.C == 0 || waves < best_waves) {
      best = a;
      best_waves = waves;
    }
  }
  if (best.C == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap zmap, wmap;
  int ierr = sm90::encode_rows<T>(&zmap, z, G, B, d, best.bc, best.br);
  if (ierr == cudaSuccess)
    ierr = sm90::encode_rows<T>(&wmap, w, w_stride ? G : 1, 1, d, best.bc);
  if (ierr != cudaSuccess) return ierr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(G * best.C));
  cfg.blockDim = dim3(kSlabThreads);
  cfg.dynamicSmemBytes = best.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)best.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, zmap, wmap, best,
                           static_cast<T*>(out));
  if (err != cudaSuccess) return (int)err;
  *cluster = best.C;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ two-pass

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
static int launch_two_pass(const void* w, long long w_stride, const void* z,
                           int G, int B, long long d, float* s, float* nrm2,
                           void* out, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* zp = static_cast<const T*>(z);
  if (s == nullptr || nrm2 == nullptr) return (int)cudaErrorInvalidValue;
  row_dot_kernel<T><<<dim3(B + 1, G), kThreads, 0, stream>>>(wp, w_stride, zp,
                                                             B, d, s, nrm2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((d + kTileD - 1) / kTileD);
  xi_tile_kernel<T><<<dim3(tiles, G), kThreads, 0, stream>>>(
      wp, w_stride, zp, B, d, s, nrm2, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_design(int design, const void* w, long long w_stride,
                         const void* z, int G, int B, long long d, float* s,
                         float* nrm2, void* out, int* cluster,
                         cudaStream_t stream) {
  if (design == kClusterSlab)
    return launch_cluster_slab<T>(w, w_stride, z, G, B, d, out, cluster,
                                  stream);
  if (design == kTwoPass)
    return launch_two_pass<T>(w, w_stride, z, G, B, d, s, nrm2, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro

// design 0 = cluster-slab: `s` and `nrm2` are not read; `*cluster` receives
// the blocks per cluster of the launch. design 1 = two-pass: s [G, B] and
// nrm2 [G] are f32 scratch from the caller; `*cluster` is not written.
// `w_stride` is 0 when all G groups share one w, else d. Returns 0 on
// success, else the CUDA error code of the failed launch (or
// cudaErrorInvalidValue for arguments the design does not take).
extern "C" int krasulina_xi_launch(const void* w, long long w_stride,
                                   const void* z, int G, int B, long long d,
                                   float* s, float* nrm2, void* out, int dtype,
                                   int design, int* cluster, void* stream) {
  if (G < 1 || G > 65535 || B < 1 || d < 1 || w_stride < 0 ||
      cluster == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_design<float>(design, w, w_stride, z, G, B, d, s,
                                       nrm2, out, cluster, st);
  if (dtype == 1)
    return repro::launch_design<__nv_bfloat16>(design, w, w_stride, z, G, B,
                                               d, s, nrm2, out, cluster, st);
  return (int)cudaErrorInvalidValue;
}
