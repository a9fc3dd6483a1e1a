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
// (bf16) bytes, and the gossip runs on a resident tile, so the least time is
// one read of Z and w and one write of the [N, d] result at 3.35 TB/s.
//
// xi needs a reduction over all of d (s and ||w||^2) before any column of it
// can be formed. The TPU kernel carries it in scratch across a sequential
// grid; Hopper blocks run in parallel. Two designs, picked by shape in
// kernels/krasulina_update.py (`xi_gossip_design`):
//
// one-read (one launch, Z read once): one block of 512 threads per
// [N, Bn, bd] column slab, bd the narrowest power of two from 32 that needs
// no more tiles than SMs (d = 3072: 96 blocks of 32 columns), all resident
// at once (a cooperative launch).
//   1. Thread 0 asks the TMA for the w tile, then the slab, one [bd, Bn]
//      box per node, each completing its own mbarrier, so every load of the
//      block is in flight together and node n's dots start as soon as its
//      box lands. Both stay in shared memory, bf16 as bf16.
//   2. Each block writes its partial s [N, Bn] and ||w_n||^2 [N] over its
//      own columns to a global scratch, 32 tiles of an entry side by side
//      (one 128-byte line). Four columns to a load, several threads to a
//      row where rows are fewer than threads.
//   3. Grid barrier. Block k sums a fixed slice of the N Bn + N entries
//      over all tiles, one warp per entry in a fixed order (lanes over
//      tiles, then a shuffle tree), and writes the final values: the result
//      is the same bits in every run, with no float atomics.
//   4. Grid barrier. Every block reads the final s and ||w||^2 and forms its
//      xi tile from the slab it still holds (one thread per column and
//      node, four partial sums over the rows; each thread forms its node's
//      mean(s^2) too, from the same loads of s).
//   5. The R rounds are linear, so the wrapper composes them into one
//      circulant of at most N taps (`gossip_taps`), applied in one pass to
//      the xi tile (each thread four output rows of one column, each xi
//      value read once for all four); the tile is written once.
// The grid barrier (sync.cuh) is one atomic per block on a word that the
// wrapper allocates once per stream and never resets, so launches on two
// streams never share one and a CUDA graph's replay needs no memset; the
// launcher checks the grid against the occupancy first. tools/xi_gossip_phases.py times each step on the card.
//
// two-pass (the earlier design; shapes whose slab does not fit one block's
// shared memory, more than 64 nodes or 256 rows per node, a row stride the
// TMA cannot take, more than 256 columns to a tile, or w or Z not 16-byte
// aligned):
//   1. row_dot_kernel (common.cuh): s[n, b] for every row of Z and
//      ||w_n||^2, one block each.
//   2. xi_gossip_tile_kernel: a grid over [N, bd] column tiles. Each block
//      copies s into shared memory, forms the xi tile for all N nodes in
//      shared memory, runs the R gossip rounds there one by one (ping-pong
//      buffers, one __syncthreads per round) and writes the tile once.
//   Z is read twice, once per launch.
// R = 0 returns the plain xi.
#include "common.cuh"
#include "hopper.cuh"
#include "sync.cuh"

namespace repro {

constexpr int kOneRead = 0, kTwoPass = 1;  // the C `design` argument
constexpr int kOneReadThreads = 512;
constexpr int kMaxTaps = 64;  // kMaxNodes of gossip_mix.cu
constexpr int kRows = 4;      // gossip output rows per thread
constexpr int kMaxTiles = 5 * 32;  // column tiles the reduction takes

// The composed schedule by shift, passed by value: out[i] = sum_s
// weight[s] * xi[(i - s) mod N], s in [0, N).
struct Taps {
  float weight[kMaxTaps];
};

// Four consecutive elements (16-byte aligned for f32, 8 for bf16) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__host__ __device__ constexpr size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// Byte offsets of the one-read block's shared memory from a 128-byte
// aligned base: N + 1 mbarriers; the w tile [N, bd] and node n's [Bn, bd]
// box of Z at slab + n * node, in w's and Z's type, each on a 128-byte
// boundary, where the TMA writes it; then f32 xi [N, bd], the final s
// [N, Bn4] (each node's Bn values padded to a multiple of 4) with ||w||^2
// [N] after it, and the gossip's weight table [2 N + kRows].
// kernels/krasulina_update.py (`one_read_smem`) mirrors it.
struct OneReadLayout {
  size_t node, w, slab, xi, s, table, total;
  __host__ __device__ OneReadLayout(int N, int Bn, int bd, int elem) {
    node = round_up((size_t)Bn * bd * elem, 128);
    w = round_up(8ull * (N + 1), 128);
    slab = w + round_up((size_t)N * bd * elem, 128);
    xi = slab + N * node;
    s = xi + 4ull * N * bd;
    table = s + 4ull * ((size_t)N * round_up(Bn, 4) + N);
    total = table + 4ull * (2 * N + kRows);
  }
};

// BD, the block's columns, is a power of two from 32 to 256, known at
// compile time so that every shared-memory offset below is a shift or an
// immediate; 512 threads are 512 / BD groups of one thread per column.
template <typename T, int BD>
__global__ void __launch_bounds__(kOneReadThreads, 1)
    xi_gossip_one_read_kernel(const __grid_constant__ CUtensorMap zmap,
                              const __grid_constant__ CUtensorMap wmap, int N,
                              int Bn, long long d, float* __restrict__ part,
                              float* __restrict__ fin, unsigned* bar,
                              Taps taps, T* __restrict__ out) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  constexpr int bd = BD;
  const OneReadLayout L(N, Bn, bd, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // per node, then w
  const T* ws = reinterpret_cast<const T*>(base + L.w);  // [N, bd]
  const unsigned char* slab = base + L.slab;  // node n: [Bn, bd] at n * node
  float* xs = reinterpret_cast<float*>(base + L.xi);
  float* ss = reinterpret_cast<float*>(base + L.s);
  float* table = reinterpret_cast<float*>(base + L.table);
  const int tile = blockIdx.x, tiles = gridDim.x;
  const long long c0 = (long long)tile * bd;
  const int rows = N * Bn, E = rows + N, Bn4 = (Bn + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int c = threadIdx.x % bd, group = threadIdx.x / bd;
  constexpr int groups = kOneReadThreads / bd;
  const bool in_d = c0 + c < d;
  if (threadIdx.x == 0) {  // every load of the block in flight, w first
    tma_prefetch_map(&wmap);
    tma_prefetch_map(&zmap);
    for (int n = 0; n <= N; ++n) mbar_init(&full[n], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&full[N], (uint32_t)(N * bd * sizeof(T)));
    tma_load_3d(base + L.w, &wmap, &full[N], (int)c0, 0, 0);
    const uint32_t box = (uint32_t)Bn * bd * sizeof(T);
    for (int n = 0; n < N; ++n) {
      mbar_arrive_expect_tx(&full[n], box);
      tma_load_3d(base + L.slab + n * L.node, &zmap, &full[n], (int)c0, 0,
                  n);
    }
  }
  for (int k = threadIdx.x; k < 2 * N + kRows; k += blockDim.x)
    table[k] = taps.weight[k % N];
  __syncthreads();  // the mbarriers are initialised
  mbar_wait(&full[N], 0);  // the w tile is in
  // 1. partial s over this block's columns, rows in node order, by `lanes`
  // threads to a row (a power of two up to 32: more where rows are few),
  // four columns at a time. A thread's partial for entry j goes to
  // part[(tile / 32, j, tile % 32)], so that step 2 reads 32 tiles of one
  // entry in one 128-byte line.
  float* mine = part + (long long)(tile >> 5) * E * 32 + (tile & 31);
  const int quads = bd / 4;
  int lanes = 1;
  while (lanes < 32 && lanes < quads && rows * lanes * 2 <= (int)blockDim.x)
    lanes *= 2;
  const int sub = threadIdx.x & (lanes - 1);
  for (int r0 = 0; r0 < rows; r0 += blockDim.x / lanes) {
    const int r = r0 + threadIdx.x / lanes;
    float acc = 0.f;
    if (r < rows) {
      const int n = r / Bn;
      mbar_wait(&full[n], 0);
      const T* zr =
          reinterpret_cast<const T*>(slab + n * L.node) + (r - n * Bn) * bd;
      const T* wr = ws + n * bd;
      // a lane starts at its own group of four columns, so that the eight
      // lanes of each 128-byte phase of a warp's loads hit 32 banks
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < quads / lanes; ++j) {
        const int k = 4 * ((lane + j * lanes) & (quads - 1));
        const float4 z4 = load4(zr + k), w4 = load4(wr + k);
        a.x = fmaf(z4.x, w4.x, a.x);
        a.y = fmaf(z4.y, w4.y, a.y);
        a.z = fmaf(z4.z, w4.z, a.z);
        a.w = fmaf(z4.w, w4.w, a.w);
      }
      acc = (a.x + a.y) + (a.z + a.w);
    }
    for (int o = lanes / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (r < rows && sub == 0) mine[r * 32] = acc;
  }
  for (int n = warp; n < N; n += n_warps) {
    float acc = 0.f;
    for (int k = lane; k < bd; k += 32) {
      const float v = to_f32(ws[n * bd + k]);
      acc = fmaf(v, v, acc);
    }
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) mine[(rows + n) * 32] = acc;
  }
  grid_sync(bar, tiles);
  // 2. block `tile` reduces a slice of the entries over all tiles, one warp
  // to an entry: lane l sums tiles l, l + 32, ... (all its loads issued
  // first), then a shuffle tree; a fixed order, so the same bits every run
  const int per = (E + tiles - 1) / tiles;
  const int j1 = min(E, (tile + 1) * per);
  for (int j = tile * per + warp; j < j1; j += n_warps) {
    float v[kMaxTiles / 32];
#pragma unroll
    for (int k = 0; k < kMaxTiles / 32; ++k)
      v[k] = lane + 32 * k < tiles
                 ? __ldcg(part + ((long long)k * E + j) * 32 + lane)
                 : 0.f;
    float acc = v[0];
#pragma unroll
    for (int k = 1; k < kMaxTiles / 32; ++k) acc += v[k];
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) fin[j] = acc;
  }
  grid_sync(bar, tiles);
  // 3. the final s and ||w||^2, then xi = Z^T s / Bn - coeff w on the slab
  for (int j = threadIdx.x; j < E; j += blockDim.x) {
    const int n = j / Bn;  // s[n, b] at n Bn4 + b; ||w||^2 after them
    ss[j < rows ? j + n * (Bn4 - Bn) : N * Bn4 + j - rows] = __ldcg(fin + j);
  }
  __syncthreads();
  const float inv_bn = 1.f / Bn;
  for (int n = group; n < N; n += groups) {
    const T* zc = reinterpret_cast<const T*>(slab + n * L.node) + c;
    const float* sn = ss + n * Bn4;
    // four chains each of Z^T s and of sum(s^2), so the loads and FMAs
    // overlap; every thread of node n forms the same coefficient
    float a[4] = {}, q[4] = {};
    int b = 0;
    for (; b + 8 <= Bn; b += 8) {  // eight rows' loads issued together
      float zv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) zv[k] = to_f32(zc[(b + k) * bd]);
      const float4 s4[2] = {*reinterpret_cast<const float4*>(sn + b),
                            *reinterpret_cast<const float4*>(sn + b + 4)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[0] = fmaf(zv[4 * h], s4[h].x, a[0]);
        a[1] = fmaf(zv[4 * h + 1], s4[h].y, a[1]);
        a[2] = fmaf(zv[4 * h + 2], s4[h].z, a[2]);
        a[3] = fmaf(zv[4 * h + 3], s4[h].w, a[3]);
        q[0] = fmaf(s4[h].x, s4[h].x, q[0]);
        q[1] = fmaf(s4[h].y, s4[h].y, q[1]);
        q[2] = fmaf(s4[h].z, s4[h].z, q[2]);
        q[3] = fmaf(s4[h].w, s4[h].w, q[3]);
      }
    }
    for (; b < Bn; ++b) {
      a[0] = fmaf(to_f32(zc[b * bd]), sn[b], a[0]);
      q[0] = fmaf(sn[b], sn[b], q[0]);
    }
    const float zts = (a[0] + a[1]) + (a[2] + a[3]);
    const float s2 = (q[0] + q[1]) + (q[2] + q[3]);
    const float coeff = s2 / (Bn * fmaxf(ss[N * Bn4 + n], 1e-30f));
    xs[n * bd + c] = zts * inv_bn - coeff * to_f32(ws[n * bd + c]);
  }
  __syncthreads();
  // 4. the composed gossip, one pass: a thread's kRows outputs of column c
  // share each xi value it reads; then the one write of the tile
  for (int i0 = group * kRows; i0 < N; i0 += groups * kRows) {
    float acc[kRows] = {};
    // row i0 + k takes weight table[i0 + k - j + N] of source row j: a
    // window that slides down one entry per j, so one new weight a step
    float wt[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) wt[k] = table[i0 + k + N];
    for (int j = 0; j < N; ++j) {
      const float v = xs[j * bd + c];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = fmaf(wt[k], v, acc[k]);
#pragma unroll
      for (int k = kRows - 1; k > 0; --k) wt[k] = wt[k - 1];
      wt[0] = table[i0 - j - 1 + N];
    }
    if (!in_d) continue;
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (i0 + k < N)
        out[(long long)(i0 + k) * d + c0 + c] = from_f32<T>(acc[k]);
  }
}

template <typename T, int BD>
static int launch_one_read(const void* w, const void* z, int N, int Bn,
                           long long d, float* scratch, unsigned* bar,
                           const Taps& taps, void* out, cudaStream_t stream) {
  auto kernel = xi_gossip_one_read_kernel<T, BD>;
  constexpr int bd = BD;
  const long long tiles = (d + bd - 1) / bd;
  if (N > kMaxTaps || Bn > 256 || tiles > kMaxTiles ||
      ((d * (long long)sizeof(T)) & 15) ||
      ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(w)) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap zmap, wmap;
  int err = sm90::encode_rows<T>(&zmap, z, N, Bn, d, bd);
  if (err == cudaSuccess) err = sm90::encode_rows<T>(&wmap, w, 1, N, d, bd);
  if (err != cudaSuccess) return err;
  const size_t smem = OneReadLayout(N, Bn, bd, sizeof(T)).total + 128;
  static size_t granted = 0;
  cudaError_t cerr = allow_smem(kernel, smem, &granted);
  if (cerr != cudaSuccess) return (int)cerr;
  // every block must be resident at once for the grid barrier; the
  // cooperative launch refuses a grid that is not, and so does this check,
  // made once per shared-memory size
  static size_t checked_smem = 0;
  static long long resident = 0;
  if (checked_smem != smem) {
    int device, sms, per_sm;
    if ((cerr = cudaGetDevice(&device)) != cudaSuccess ||
        (cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       device)) != cudaSuccess ||
        (cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kOneReadThreads, smem)) != cudaSuccess)
      return (int)cerr;
    resident = (long long)per_sm * sms;
    checked_smem = smem;
  }
  if (tiles > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  float* part = scratch;
  float* fin = scratch + (tiles + 31) / 32 * 32 * ((long long)N * Bn + N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kOneReadThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cerr = cudaLaunchKernelEx(&cfg, kernel, zmap, wmap, N, Bn, d, part, fin,
                            bar, taps, static_cast<T*>(out));
  if (cerr != cudaSuccess) return (int)cerr;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ two-pass

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
static int launch_two_pass(const void* w, const void* z, int N, int Bn,
                           long long d, int bd, float* scratch,
                           const Schedule& sched, int rounds, void* out,
                           cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  const T* zp = static_cast<const T*>(z);
  float* s = scratch;
  float* nrm2 = scratch + (long long)N * Bn;
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

template <typename T>
static int launch_design(int design, const void* w, const void* z, int N,
                         int Bn, long long d, int bd, float* scratch,
                         unsigned* bar, int rounds, int n_terms,
                         const int* shifts, const float* weights, void* out,
                         cudaStream_t stream) {
  if (design == kOneRead) {
    if (n_terms < 1 || n_terms > N || N > kMaxTaps || bar == nullptr)
      return (int)cudaErrorInvalidValue;
    Taps taps = {};
    for (int t = 0; t < n_terms; ++t) {
      if (shifts[t] < 0 || shifts[t] >= N) return (int)cudaErrorInvalidValue;
      taps.weight[shifts[t]] += weights[t];
    }
    switch (bd) {
      case 32:
        return launch_one_read<T, 32>(w, z, N, Bn, d, scratch, bar, taps,
                                      out, stream);
      case 64:
        return launch_one_read<T, 64>(w, z, N, Bn, d, scratch, bar, taps,
                                      out, stream);
      case 128:
        return launch_one_read<T, 128>(w, z, N, Bn, d, scratch, bar, taps,
                                       out, stream);
      case 256:
        return launch_one_read<T, 256>(w, z, N, Bn, d, scratch, bar, taps,
                                       out, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  Schedule sched;
  if (design != kTwoPass || make_schedule(n_terms, shifts, weights, &sched))
    return (int)cudaErrorInvalidValue;
  return launch_two_pass<T>(w, z, N, Bn, d, bd, scratch, sched, rounds, out,
                            stream);
}

}  // namespace repro

// design 0 = one-read: (n_terms, shifts, weights) are the taps of the
// composed R-round schedule (at most N <= 64, shifts in [0, N); `rounds` is
// not read); `scratch` holds ceil(tiles / 32) x (N Bn + N) x 32 f32
// partials then N Bn + N final values; `bar` is the grid barrier's word
// (zero before the first launch, never reset). design 1 = two-pass:
// (n_terms, shifts, weights) are the one-round schedule run `rounds` times;
// `scratch` holds s [N, Bn] then ||w||^2 [N]; `bar` is not read. Returns 0
// on success, else the CUDA error code of the failed launch (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int krasulina_xi_gossip_launch(const void* w, const void* z, int N,
                                          int Bn, long long d, int bd,
                                          float* scratch, unsigned* bar,
                                          void* out, int dtype, int design,
                                          int rounds, int n_terms,
                                          const int* shifts,
                                          const float* weights, void* stream) {
  if (N < 1 || N > 65535 || Bn < 1 || d < 1 || bd < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_design<float>(design, w, z, N, Bn, d, bd, scratch,
                                       bar, rounds, n_terms, shifts, weights,
                                       out, st);
  if (dtype == 1)
    return repro::launch_design<__nv_bfloat16>(design, w, z, N, Bn, d, bd,
                                               scratch, bar, rounds, n_terms,
                                               shifts, weights, out, st);
  return (int)cudaErrorInvalidValue;
}
