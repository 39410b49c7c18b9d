// Staging of device-memory slices into a warp's shared memory, with
// completion on an mbarrier: the ring that the persistent kernels (K1,
// K2) keep one unit ahead of their compute.
//
// Two routes fill a stage, chosen once per launch by the launcher:
//
// * bulk — lane 0 posts the unit's byte count on the stage's barrier
//   (`mbarrier.arrive.expect_tx`) and issues one `cp.async.bulk` per
//   contiguous piece.  The copy engine moves the bytes and completes the
//   transaction on the barrier; the warp spends one instruction per piece
//   and no registers.  Every piece must start 16-byte aligned and be a
//   multiple of 16 bytes long.
// * words — every lane issues 4-byte `cp.async` copies of its share of
//   the words, for pieces whose addresses or sizes the bulk copy refuses.
//
// Pieces too small or too ragged for either rule (the 8-byte deferred id
// rows) always take the words route.  Each lane then arrives on the
// barrier once its own `cp.async` copies have landed
// (`cp.async.mbarrier.arrive.noinc`), so a barrier is initialised for 32
// arrivals, plus lane 0's expect-tx arrival on the bulk route.  A warp
// waits for a stage with `wait(bar, parity)`, the parity being the number
// of times that stage has been filled before, mod 2.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stage {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Barrier for one stage: 32 lanes' copy arrivals, plus lane 0's byte
// count on the bulk route.  Call from one lane, then `init_fence`.
__device__ __forceinline__ void init(uint64_t* bar, bool bulk) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(bulk ? 33 : 32)
               : "memory");
}

__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Order this thread's earlier generic-proxy writes to shared memory
// before later copy-engine writes to the same bytes: every lane that
// wrote into a stage calls it, then the warp syncs, then lane 0 issues
// the bulk copies that refill the stage.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Lane 0 of the bulk route, before the unit's bulk copies: post the
// unit's byte count on the barrier (one arrival).
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// One contiguous piece by the copy engine (16-byte aligned, bytes % 16 == 0).
__device__ __forceinline__ void bulk(int* dst, const int* src, uint32_t bytes, uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// One int by a 4-byte cp.async.
__device__ __forceinline__ void word(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem(dst)), "l"(src) : "memory");
}

// `n` ints by 4-byte cp.async, strided over the lanes.
__device__ __forceinline__ void words(int* dst, const int* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) word(dst + i, src + i);
}

// Every lane, after issuing its share of the unit: arrive on the barrier
// once this lane's cp.async copies have landed.
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem(bar)) : "memory");
}

// Block until the barrier's phase with this parity has completed; the
// staged bytes are then visible to the waiting lanes.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// Whether a piece can take the bulk route: 16-byte aligned base, and a
// per-object stride (in ints) that keeps every object's slice aligned.
inline bool bulk_ok(const void* base, long long stride_ints) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (stride_ints & 3) == 0;
}

// Launch shape of a persistent kernel whose warps each need `per_warp`
// bytes of dynamic shared memory: of max_warps, max_warps / 2, ... 1 warps
// per block, the one that keeps the most warps resident on an SM (the
// first on a tie), and as many blocks as the card keeps resident, never
// more than n objects need.
struct Grid {
  int warps;
  unsigned blocks;
  size_t smem;
};
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t per_warp, int max_warps, long long n, Grid* g) {
  int dev = 0, sms = 0, best = 0, best_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int w = max_warps; w >= 1; w /= 2) {
    const size_t smem = per_warp * w;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
        cudaSuccess) {
      (void)cudaGetLastError();  // above the card's limit: not a candidate
      continue;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, w * 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm * w > best_per_sm * best) {
      best = w;
      best_per_sm = per_sm;
    }
  }
  if (best == 0) return cudaErrorInvalidConfiguration;
  g->warps = best;
  g->smem = per_warp * best;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g->smem);
  if (err != cudaSuccess) return err;
  long long blocks = (n + best - 1) / best;
  if (blocks > (long long)best_per_sm * sms) blocks = (long long)best_per_sm * sms;
  g->blocks = (unsigned)blocks;
  return cudaSuccess;
}

}  // namespace stage
