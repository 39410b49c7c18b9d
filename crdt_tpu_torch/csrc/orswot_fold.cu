// Sequential anti-entropy fold over R replica fleets (K3).
//
// Replaces: crdt_tpu/ops/orswot_pallas.py::fold_merge — R-1 pairwise
// `_merge_tile` steps plus the defer-plunger self-merge, with the
// accumulator kept out of the fleet planes.  Bit-exact with the
// sequential fold of pairwise merges, flags included, also where a
// capacity overflows (where the union-aligned fold, K1, leaves its
// outputs unspecified).
//
// Bound on this card: bytes.  It reads R states and writes one (at R=8,
// A=64, M=16, D=2 with 32-bit counters: 9 x 4,936 B = 44.4 KB per object),
// 2.78 GB per 62,500-object chunk, 0.83 ms at 3.35 TB/s.  Its integer
// work (compares, selects and maxes over each valid slot's row, R merges
// per object: about 4.4e9 operations on that chunk, counted by
// chip_smoke.py's k3_ops) would take 0.27 ms at the INT32 rate, so the
// bytes bound it; what it reaches is held back by the latency and issue
// of each merge's id-plane passes and votes (PERF.md §5 has its phases).
//
// What held the first design back: one warp merged one object and left,
// so nothing but an L2 prefetch overlapped the next replica's loads; the
// accumulator ping-ponged through a device-memory scratch the wrapper
// allocated per call (2 x 4,936 B per object, 617 MB per chunk); and each
// step ran the first merge design (orswot::merge_object), which computes
// each slot's merged row three times from memory and scans all slots for
// every output slot.  This design:
//
// * persistent warps (`stage::persistent_grid`): each warp walks objects
//   first, first + warps, ...;
// * the replicas streamed through a two-stage ring per warp
//   (`orswot_stage.cuh`): one unit is one replica's slice of one object
//   (clock, ids, dots, deferred clocks and ids, laid out as K2's sides),
//   filled one unit ahead of the compute by bulk copies where the
//   launcher finds every piece aligned, else by per-lane 4-byte
//   cp.async.  The ring runs across objects, so the next object's
//   replica 0 lands during this object's last step, plunger and store;
// * the accumulator kept in shared memory between steps, in two
//   ping-pong buffers at (m_cap, d_cap): step t merges the accumulator
//   (replica 0 in its stage, for the first step) with the staged replica
//   t+1 into the other buffer;
// * each step is the staged merge K2 runs (orswot_merge_body.cuh): one
//   __match_any_sync for the alignment, each valid slot's merged row
//   computed once over its own input row with the set clocks, the row
//   and the aligned dot in registers, the slots walked by ballot, and
//   compaction by inverted rank;
// * the plunger (a = b = the accumulator) merges the accumulator with a
//   copy of it in the free buffer, so writing merged a-rows in place
//   cannot reach the b-rows they match, and writes the output straight
//   to device memory (without the plunger the last buffer is copied
//   out).  Each merge call site writes one address space only, so its
//   stores are plain shared or global stores.
//
// Shared memory per warp at the north star (A=64, M=m_cap=16, D=d_cap=2):
// two stages and two accumulator buffers of 4,944 B each, 496 B of id
// scratch and two mbarriers, 20,288 B: ten resident warps per SM (five
// blocks of two warps in the card's 228 KB), with 126 registers a thread
// in the A = 64 instantiation.  Widths whose footprint exceeds the card's
// shared memory per block (from about A = 216 at M = m_cap = 64, D = 2)
// take the direct route, the first design in persistent warps:
// orswot::merge_object from device memory, the accumulator in a
// device-memory scratch the wrapper allocates for that route only.  The
// launcher picks the route from the widths before launching;
// `orswot_fold_plan` reports it.
//
// PERF.md §6 holds its times on the H100 beside the first design's.
#include "orswot_merge_body.cuh"

// Phase clocks (build with -DORSWOT_PHASE_CLOCKS; crdt_tpu_torch/tools/
// k3_phases.py): clock64() stamps at the phase boundaries of every merge
// (alignment, dedup with the clock join, dot rule and replay, rank,
// member store, deferred pack) and of the fold around them (waiting for a
// staged replica, releasing and refilling stages, the plunger's copy),
// summed per warp and added into one device-wide total per phase at warp
// exit.
enum FoldPhase { FP_WAIT = staged::MP_N, FP_ISSUE, FP_COPY, N_PHASES };
#ifdef ORSWOT_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[N_PHASES];
struct Clocks {
  long long ph[N_PHASES];
  long long t;
  __device__ __forceinline__ void start() {
    for (int p = 0; p < N_PHASES; ++p) ph[p] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    ph[p] += now - t;
    t = now;
  }
  __device__ __forceinline__ void flush(int lane) {
    if (lane == 0)
      for (int p = 0; p < N_PHASES; ++p) atomicAdd(&g_phase_cycles[p], (unsigned long long)ph[p]);
  }
};
extern "C" int orswot_fold_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[N_PHASES] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)err;
}
#else
struct Clocks {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

namespace {

constexpr int MAX_WARPS = 4;  // most warps per block (stage::persistent_grid may take fewer)
constexpr int STAGES = 2;     // replica units in flight per warp

// One warp's shared area (int offsets): two mbarriers, then STAGES stages
// and two accumulator buffers of `slot` ints each (a replica at (M, D) or
// the accumulator at (m_cap, d_cap), whichever is larger), then the
// merges' id-plane scratch.
struct Layout {
  staged::Scratch X;
  int slot, stages, acc, scratch, total;
};
__host__ __device__ inline Layout layout(int A, int M, int D, int m_cap, int d_cap) {
  const int rep = staged::side_layout(A, M, D).total;
  const int acc = staged::side_layout(A, m_cap, d_cap).total;
  const int mx = M > m_cap ? M : m_cap, dx = D > d_cap ? D : d_cap;
  Layout L;
  L.slot = rep > acc ? rep : acc;
  L.stages = 4;
  L.acc = L.stages + STAGES * L.slot;
  L.scratch = L.acc + 2 * L.slot;
  L.X = staged::scratch_layout(mx, mx, dx, dx);
  L.total = L.scratch + L.X.total;
  return L;
}

template <int APL>
__global__ void __launch_bounds__(32 * MAX_WARPS, 4) orswot_fold_kernel(
    const int* __restrict__ clock, const int* __restrict__ ids, const int* __restrict__ dots,
    const int* __restrict__ dids, const int* __restrict__ dclocks,
    int* __restrict__ oc, int* __restrict__ oi, int* __restrict__ od,
    int* __restrict__ odi, int* __restrict__ odc, int* __restrict__ over,
    int R, long long n, int A_rt, int M, int D, int m_cap, int d_cap, int plunger, int bulk) {
  const int A = APL > 0 ? 32 * APL : A_rt;
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * warps + warp;
  const long long stride = (long long)gridDim.x * warps;
  if (first >= n) return;  // the ragged edge: a whole warp with no object
  const Layout L = layout(A, M, D, m_cap, d_cap);
  const staged::Side su = staged::side_layout(A, M, D);
  int* w = smem + warp * L.total;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w);
  int* scratch = w + L.scratch;
  Clocks clocks;
  clocks.start();

  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) stage::init(&bars[s], bulk);
    stage::init_fence();
  }
  __syncwarp();

  // This warp's stream of units — replica 0..R-1 of its first object, then
  // of the next — fills the stages in turn; `issue` sends the next unit.
  long long i_obj = first;  // the next unit to issue: replica i_r of object i_obj,
  int i_r = 0, i_s = 0;     // into stage i_s
  auto issue = [&]() {
    const long long obj = i_obj;
    const long long row = (long long)i_r * n + obj;
    int* st = w + L.stages + i_s * L.slot;
    uint64_t* bar = &bars[i_s];
    if (++i_r == R) {
      i_r = 0;
      i_obj += stride;
    }
    if (++i_s == STAGES) i_s = 0;
    if (obj >= n) return;
    if (bulk) {
      if (lane == 0) {
        stage::expect(bar, (uint32_t)((A + M + M * A + D * A) * sizeof(int)));
        stage::bulk(st + su.clock, clock + row * A, A * sizeof(int), bar);
        stage::bulk(st + su.ids, ids + row * M, M * sizeof(int), bar);
        stage::bulk(st + su.dots, dots + row * M * A, M * A * sizeof(int), bar);
        stage::bulk(st + su.dclocks, dclocks + row * D * A, D * A * sizeof(int), bar);
      }
    } else {
      stage::words(st + su.clock, clock + row * A, A, lane);
      stage::words(st + su.ids, ids + row * M, M, lane);
      stage::words(st + su.dots, dots + row * M * A, M * A, lane);
      stage::words(st + su.dclocks, dclocks + row * D * A, D * A, lane);
    }
    stage::words(st + su.dids, dids + row * D, D, lane);
    stage::arrive(bar);
  };
  // wait for the next unit to land; returns its stage
  int c_s = 0;          // the stage the next unit lands in
  uint32_t c_par = 0;   // and the parity of its fill
  auto land = [&]() {
    stage::wait(&bars[c_s], c_par);
    int* st = w + L.stages + c_s * L.slot;
    if (++c_s == STAGES) {
      c_s = 0;
      c_par ^= 1u;
    }
    clocks.mark(FP_WAIT);
    return st;
  };
  // a merge wrote rows into the stages it read: every lane orders its
  // writes before the copy engine's, then the warp syncs and the stages
  // are free
  auto release = [&]() {
    if (bulk) stage::fence_async();
    __syncwarp();
  };

  for (int u = 0; u < STAGES; ++u) issue();
  clocks.mark(FP_ISSUE);
  for (long long obj = first; obj < n; obj += stride) {
    const orswot::OutView out{oc + obj * A, oi + obj * m_cap, od + obj * m_cap * A,
                              odi + obj * d_cap, odc + obj * d_cap * A};
    // replica 0 seeds the accumulator where it lands
    int* acc_base = land();
    staged::SideView acc = staged::side_at(acc_base, A, M, D);
    bool in_stage = true;  // the accumulator still sits in its stage
    int nb = 0;            // the accumulator buffer the next step writes
    int flags = 0;
    for (int t = 0; t < R - 1; ++t) {
      const staged::SideView other = staged::side_at(land(), A, M, D);
      int* buf = w + L.acc + nb * L.slot;
      flags |= staged::merge<APL>(acc, other, staged::out_at(buf, A, m_cap, d_cap), A, m_cap,
                                  d_cap, scratch, L.X, lane, clocks);
      release();
      if (in_stage) issue();  // the accumulator's stage is free too
      issue();
      clocks.mark(FP_ISSUE);
      in_stage = false;
      acc = staged::side_at(buf, A, m_cap, d_cap);
      acc_base = buf;
      nb ^= 1;
    }
    if (plunger) {
      // a = b = the accumulator: b is a copy of it in the free buffer
      int* copy = w + L.acc + nb * L.slot;
      const int total = staged::side_layout(A, acc.M, acc.D).total;
      for (int i = lane; i < total; i += 32) copy[i] = acc_base[i];
      __syncwarp();
      clocks.mark(FP_COPY);
      flags |= staged::merge<APL>(acc, staged::side_at(copy, A, acc.M, acc.D), out, A, m_cap,
                                  d_cap, scratch, L.X, lane, clocks);
    } else {
      // the accumulator is the result (R == 1: the replica itself, at
      // M == m_cap, D == d_cap): out to device memory
      for (int x = lane; x < A; x += 32) out.clock[x] = acc.clock[x];
      for (int i = lane; i < m_cap; i += 32) out.ids[i] = acc.ids[i];
      for (int i = lane; i < m_cap * A; i += 32) out.dots[i] = acc.dots[i];
      for (int i = lane; i < d_cap; i += 32) out.d_ids[i] = acc.dids[i];
      for (int i = lane; i < d_cap * A; i += 32) out.d_clocks[i] = acc.dclocks[i];
      clocks.mark(FP_COPY);
    }
    if (lane == 0) {
      over[2 * obj] = flags & 1;
      over[2 * obj + 1] = (flags >> 1) & 1;
    }
    if (in_stage) {  // R == 1: the accumulator's stage is free once its writes are ordered
      release();
      issue();
    } else {
      __syncwarp();  // every lane is done with the buffers and scratch
    }
    clocks.mark(FP_ISSUE);
  }
  clocks.flush(lane);
}

// Ints of one unpadded state at widths (M, D): a slot of the direct
// route's accumulator scratch.
__host__ __device__ inline long long state_ints(int A, int M, int D) {
  return (long long)A + M + (long long)M * A + D + (long long)D * A;
}

__host__ __device__ inline int direct_scratch_ints(int M, int D, int m_cap, int d_cap, int A) {
  const int m = M > m_cap ? M : m_cap, d = D > d_cap ? D : d_cap;
  return orswot::merge_scratch_ints(m, m, d, d, A);
}

__device__ orswot::OutView out_at(int* base, int A, int m_cap, int d_cap) {
  int* c = base;
  int* i = c + A;
  int* dt = i + m_cap;
  int* di = dt + (long long)m_cap * A;
  int* dc = di + d_cap;
  return orswot::OutView{c, i, dt, di, dc};
}

// The route for widths whose footprint does not fit: persistent warps,
// each folding its objects one at a time through orswot::merge_object
// from device memory, the accumulator ping-ponging between two slots of
// `acc_buf` per object (the first design).
__global__ void __launch_bounds__(32 * MAX_WARPS) orswot_fold_direct_kernel(
    const int* __restrict__ clock, const int* __restrict__ ids, const int* __restrict__ dots,
    const int* __restrict__ dids, const int* __restrict__ dclocks,
    int* __restrict__ oc, int* __restrict__ oi, int* __restrict__ od,
    int* __restrict__ odi, int* __restrict__ odc, int* __restrict__ over,
    int* __restrict__ acc_buf, int R, long long n, int A, int M, int D,
    int m_cap, int d_cap, int plunger) {
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * warps;
  int* scratch = smem + warp * direct_scratch_ints(M, D, m_cap, d_cap, A);
  const long long slot = state_ints(A, m_cap, d_cap);
  const int steps = (R - 1) + (plunger ? 1 : 0);
  for (long long obj = (long long)blockIdx.x * warps + warp; obj < n; obj += stride) {
    auto replica = [&](int r) {
      const long long row = (long long)r * n + obj;
      return orswot::StateView{clock + row * A, ids + row * M, dots + row * M * A,
                               dids + row * D, dclocks + row * D * A, M, D};
    };
    const orswot::OutView out{oc + obj * A, oi + obj * m_cap, od + obj * m_cap * A,
                              odi + obj * d_cap, odc + obj * d_cap * A};
    int* mine = acc_buf + obj * 2 * slot;
    int flags = 0;
    orswot::StateView acc = replica(0);
    for (int t = 0; t < steps; ++t) {
      const orswot::StateView other = t < R - 1 ? replica(t + 1) : acc;
      const orswot::OutView dst =
          t == steps - 1 ? out : out_at(mine + (t % 2) * slot, A, m_cap, d_cap);
      flags |= orswot::merge_object(acc, other, dst, A, m_cap, d_cap, scratch, lane);
      __syncwarp();  // dst becomes the next step's input for every lane
      acc = orswot::StateView{dst.clock, dst.ids, dst.dots, dst.d_ids, dst.d_clocks,
                              m_cap, d_cap};
    }
    if (steps == 0) {  // R == 1 without plunger: the replica itself (M == m_cap, D == d_cap)
      for (int x = lane; x < A; x += 32) out.clock[x] = acc.clock[x];
      for (int i = lane; i < m_cap; i += 32) out.ids[i] = acc.ids[i];
      for (long long i = lane; i < (long long)m_cap * A; i += 32) out.dots[i] = acc.dots[i];
      for (int i = lane; i < d_cap; i += 32) out.d_ids[i] = acc.d_ids[i];
      for (long long i = lane; i < (long long)d_cap * A; i += 32) out.d_clocks[i] = acc.d_clocks[i];
    }
    if (lane == 0) {
      over[2 * obj] = flags & 1;
      over[2 * obj + 1] = (flags >> 1) & 1;
    }
    __syncwarp();  // every lane is done with the scratch before the next object
  }
}

enum Route { WORDS = 0, BULK = 1, DIRECT = 2 };

inline bool bulk_route(const void* clock, const void* ids, const void* dots,
                       const void* dclocks, int A, int M, int D) {
  return stage::bulk_ok(clock, A) && stage::bulk_ok(ids, M) &&
         stage::bulk_ok(dots, (long long)M * A) && stage::bulk_ok(dclocks, (long long)D * A);
}

// Staged (bulk copies where every piece is aligned, else per-lane
// cp.async) when one warp's footprint fits the card's shared memory per
// block, else direct.
inline int route_for(const void* clock, const void* ids, const void* dots, const void* dclocks,
                     int A, int M, int D, int m_cap, int d_cap, int* route) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = (long long)layout(A, M, D, m_cap, d_cap).total * sizeof(int);
  *route = bytes > limit ? DIRECT
                         : (bulk_route(clock, ids, dots, dclocks, A, M, D) ? BULK : WORDS);
  return 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t per_warp, long long n, void* stream, Args... args) {
  stage::Grid g;
  const cudaError_t err = stage::persistent_grid(kernel, per_warp, MAX_WARPS, n, &g);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, g.warps * 32, g.smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Ints of the direct route's accumulator scratch per object (the wrapper
// allocates it only when `orswot_fold_plan` reports that route).
extern "C" long long orswot_fold_acc_ints(int A, int m_cap, int d_cap) {
  return 2 * state_ints(A, m_cap, d_cap);
}

// The instantiation, alignment path and route a launch with these
// arguments takes: 100 * (1 one __match_any_sync for the member
// alignment of a fold step, accumulator at m_cap against a replica at M;
// 0 the lane-parallel loops) + 10 * (actors per lane at compile time, 0
// for run-time A) + route (0 staged by per-lane cp.async, 1 staged by
// bulk copies, 2 direct from device memory); negative: a CUDA error.
extern "C" int orswot_fold_plan(const void* clock, const void* ids, const void* dots,
                                const void* dclocks, int A, int M, int D, int m_cap,
                                int d_cap) {
  int route = 0;
  const int err = route_for(clock, ids, dots, dclocks, A, M, D, m_cap, d_cap, &route);
  if (err) return -err;
  if (route == DIRECT) return DIRECT;
  return 100 * staged::one_match(m_cap, M) + 10 * (A == 64 ? 2 : 0) + route;
}

extern "C" int orswot_fold_launch(
    const void* clock, const void* ids, const void* dots, const void* dids,
    const void* dclocks, void* oc, void* oi, void* od, void* odi, void* odc, void* over,
    void* acc_buf, int R, long long n, int A, int M, int D, int m_cap, int d_cap,
    int plunger, void* stream) {
  if (n <= 0) return 0;
  int route = 0;
  const int err = route_for(clock, ids, dots, dclocks, A, M, D, m_cap, d_cap, &route);
  if (err) return err;
  const int *c_ = (const int*)clock, *i_ = (const int*)ids, *d_ = (const int*)dots,
            *di_ = (const int*)dids, *dc_ = (const int*)dclocks;
  int *oc_ = (int*)oc, *oi_ = (int*)oi, *od_ = (int*)od, *odi_ = (int*)odi, *odc_ = (int*)odc,
      *over_ = (int*)over;
  if (route == DIRECT) {
    if (acc_buf == nullptr) return (int)cudaErrorInvalidValue;
    return launch(orswot_fold_direct_kernel,
                  (size_t)direct_scratch_ints(M, D, m_cap, d_cap, A) * sizeof(int), n, stream,
                  c_, i_, d_, di_, dc_, oc_, oi_, od_, odi_, odc_, over_, (int*)acc_buf, R, n, A,
                  M, D, m_cap, d_cap, plunger);
  }
  const size_t per_warp = (size_t)layout(A, M, D, m_cap, d_cap).total * sizeof(int);
  const int bulk = route == BULK ? 1 : 0;
#define ORSWOT_K3_LAUNCH(APL)                                                                   \
  return launch(orswot_fold_kernel<APL>, per_warp, n, stream, c_, i_, d_, di_, dc_, oc_, oi_,   \
                od_, odi_, odc_, over_, R, n, A, M, D, m_cap, d_cap, plunger, bulk)
  if (A == 64) ORSWOT_K3_LAUNCH(2);
  ORSWOT_K3_LAUNCH(0);
#undef ORSWOT_K3_LAUNCH
}
