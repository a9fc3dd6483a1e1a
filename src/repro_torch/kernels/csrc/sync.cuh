// Synchronisation across blocks on Hopper (sm_90a), written as inline PTX:
// the start of a thread-block cluster, stores into a peer block's shared
// memory (distributed shared memory) that complete the peer's mbarrier, and
// a grid-wide barrier for a grid whose blocks are all resident at once.
//
// Every spin traps after about ten seconds of the SM's clock, as the
// mbarrier waits of hopper.cuh do, so a fault ends the launch with an error
// instead of hanging the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr long long kSpinLimit = 20000000000ll;  // SM clocks, ~10 s

// ------------------------------------------------------------------ cluster

// This block's rank in its cluster (0 in a launch without clusters).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Arrival at the cluster barrier that orders nothing: used at the start, to
// learn later (cluster_wait) that every block of the cluster is running and
// its shared memory may be written.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Waits until every thread of the cluster has arrived. Every thread of every
// block calls arrive and wait in turn (the instructions are .aligned: whole
// warps).
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores v at the address of `p` in the shared memory of the cluster's block
// `rank` and, once it is there, completes 8 bytes of the transaction count
// of that block's mbarrier at the address of `bar` (st.async): the receiver
// waits on its own mbarrier for the data, with no barrier across the
// cluster.
__device__ __forceinline__ void st_async_f64(double* p, uint64_t* bar,
                                             unsigned rank, double v) {
  const uint32_t lp = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  const uint32_t lb = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rp)
               : "r"(lp), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(lb), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(rp),
      "l"(__double_as_longlong(v)), "r"(rb)
      : "memory");
}

// The same for four floats at a 16-byte aligned address: 16 bytes of the
// receiver's transaction count.
__device__ __forceinline__ void st_async_v4(float* p, uint64_t* bar,
                                            unsigned rank, float4 v) {
  const uint32_t lp = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  const uint32_t lb = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rp)
               : "r"(lp), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(lb), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(rp),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rb)
      : "memory");
}

// --------------------------------------------------------------------- grid

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_acq_rel_gpu(unsigned* p,
                                                         unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Barrier over all `n_blocks` blocks of the grid, which must all be
// resident at once (a cooperative launch, or a grid checked against the
// occupancy). `bar` is one word in device memory, zero before its first use
// and never reset: block 0 adds 2^31 - (n_blocks - 1) to it and every other
// block 1, so one barrier adds exactly 2^31. The top bit flips when the last
// block arrives, and the low bits are 0 again; a block waits until the top
// bit differs from the one its own addition saw. So the next launch, or a
// CUDA graph's replay, needs no memset, but launches that share the word
// must not run concurrently. One atomic per block, release and acquire: the
// writes of any thread before the barrier are visible to every thread after
// it (read them with ld.global.cg, __ldcg, which skips the SM's L1).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (n_blocks - 1) : 1u;
    const unsigned seen = atom_add_acq_rel_gpu(bar, add);
    const long long t0 = clock64();
    while (((ld_acquire_gpu(bar) ^ seen) & 0x80000000u) == 0)
      if (clock64() - t0 > kSpinLimit) __trap();
  }
  __syncthreads();
}

}  // namespace repro
