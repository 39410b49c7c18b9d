// Pairwise ORSWOT merge over a batch of objects (K2).
//
// Replaces: crdt_tpu/ops/orswot_pallas.py::merge (its tile body
// `_merge_tile`), the body of the `unrolled`/`pallas` pairwise merge.
//
// Bound on this card: bytes.  Per object it reads two states and writes
// one (at A=64, M=16, D=2 with 32-bit counters: 3 x 4,936 B), and does a
// few integer compares, selects and maxes per counter — far below the
// H100's integer rate per byte, and no products, so the tensor cores have
// nothing to do here.  At 62,500 objects that is 0.93 GB, 0.28 ms at
// 3.35 TB/s.
//
// What held the first design back: each slot's merged row (dot rule and
// replay) was recomputed from device memory three times (flags,
// liveness, output), the output pass scanned all S = Ma + Mb slots for
// each of the m_cap output slots, and a warp merged one object and left,
// so nothing overlapped the next object's loads.  This design:
//
// * persistent warps with a two-stage ring per warp (`orswot_stage.cuh`):
//   a stage holds both sides' slices of one object, and object i+1 lands
//   while object i is merged — by bulk copies where the launcher finds
//   every piece aligned, else by per-lane 4-byte cp.async;
// * each slot's merged row computed once, written over its own input row
//   in the stage (an a-slot's row is read only by that slot, a b-only
//   slot's row only by that slot, and the b rows a-slots match are never
//   b-only), and read from there for liveness and output; at A = 64 the
//   set clocks and the slot's row and aligned dot sit in registers, and
//   the valid slots are walked by ballot;
// * compaction by inverted rank: each live slot names its output slot.
//   Two live slots with one id (possible only when a side is already
//   invalid) are found with one vote, and that object alone takes the
//   exact rule of `_merge_tile` (ids summed as id + 1, rows maxed).
//
// Widths whose two stages do not fit the card's shared memory (wide A at
// wide M: from A = 217 at M = 64) take the first design's merge instead,
// in persistent warps reading both sides straight from device memory
// through orswot::merge_object, with shared memory for ids, flags and the
// two set clocks only, so any A fits.  The launcher picks it from the
// widths; `orswot_merge_plan` reports which route a launch takes.
//
// The per-object merge itself lives in orswot_merge_body.cuh, which K3
// (orswot_fold.cu) shares: K2 stages both sides and has the merge write
// straight to device memory.
#include "orswot_merge_body.cuh"

namespace {

constexpr int MAX_WARPS = 4;  // most warps per block (stage::persistent_grid may take fewer)

// One warp's shared area (int offsets): two mbarriers, two stages of
// (a, b), then the merge's id-plane scratch.
struct Layout {
  staged::Side a, b;
  staged::Scratch X;
  int stage, scratch, total;
};
__host__ __device__ inline Layout layout(int A, int Ma, int Mb, int Da, int Db, int m_cap) {
  Layout L;
  L.a = staged::side_layout(A, Ma, Da);
  L.b = staged::side_layout(A, Mb, Db);
  L.stage = L.a.total + L.b.total;
  L.X = staged::scratch_layout(Ma, Mb, Da, Db);
  L.scratch = 4 + 2 * L.stage;  // two mbarriers, then the stages
  L.total = L.scratch + L.X.total;
  return L;
}

// Registers capped at 128 a thread, more than the shared memory lets
// reside anyway; without the bound ptxas chose 72 registers and spilled
// in the A = 64 instantiation.
template <int APL>
__global__ void __launch_bounds__(32 * MAX_WARPS, 4) orswot_merge_kernel(
    const int* __restrict__ ca, const int* __restrict__ ia, const int* __restrict__ da,
    const int* __restrict__ dia, const int* __restrict__ dca,
    const int* __restrict__ cb, const int* __restrict__ ib, const int* __restrict__ db,
    const int* __restrict__ dib, const int* __restrict__ dcb,
    int* __restrict__ oc, int* __restrict__ oi, int* __restrict__ od,
    int* __restrict__ odi, int* __restrict__ odc, int* __restrict__ over,
    long long n, int A_rt, int Ma, int Mb, int Da, int Db, int m_cap, int d_cap, int bulk) {
  const int A = APL > 0 ? 32 * APL : A_rt;
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * warps + warp;
  const long long stride = (long long)gridDim.x * warps;
  if (first >= n) return;  // the ragged edge: a whole warp with no object
  const Layout L = layout(A, Ma, Mb, Da, Db, m_cap);
  int* w = smem + warp * L.total;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w);

  if (lane == 0) {
    stage::init(&bars[0], bulk);
    stage::init(&bars[1], bulk);
    stage::init_fence();
  }
  __syncwarp();

  // both sides of this warp's it-th object into stage it % 2
  auto issue = [&](long long it) {
    const long long obj = first + it * stride;
    if (obj >= n) return;
    int* st = w + 4 + (int)(it & 1) * L.stage;
    uint64_t* bar = &bars[it & 1];
    int* sb_ = st + L.a.total;
    const long long ma = (long long)Ma * A, mb = (long long)Mb * A;
    if (bulk) {
      if (lane == 0) {
        stage::expect(bar, (uint32_t)((2 * A + Ma + Mb + ma + mb + (Da + Db) * A) * sizeof(int)));
        stage::bulk(st + L.a.clock, ca + obj * A, A * sizeof(int), bar);
        stage::bulk(st + L.a.ids, ia + obj * Ma, Ma * sizeof(int), bar);
        stage::bulk(st + L.a.dots, da + obj * ma, ma * sizeof(int), bar);
        stage::bulk(st + L.a.dclocks, dca + obj * Da * A, Da * A * sizeof(int), bar);
        stage::bulk(sb_ + L.b.clock, cb + obj * A, A * sizeof(int), bar);
        stage::bulk(sb_ + L.b.ids, ib + obj * Mb, Mb * sizeof(int), bar);
        stage::bulk(sb_ + L.b.dots, db + obj * mb, mb * sizeof(int), bar);
        stage::bulk(sb_ + L.b.dclocks, dcb + obj * Db * A, Db * A * sizeof(int), bar);
      }
    } else {
      stage::words(st + L.a.clock, ca + obj * A, A, lane);
      stage::words(st + L.a.ids, ia + obj * Ma, Ma, lane);
      stage::words(st + L.a.dots, da + obj * ma, ma, lane);
      stage::words(st + L.a.dclocks, dca + obj * Da * A, Da * A, lane);
      stage::words(sb_ + L.b.clock, cb + obj * A, A, lane);
      stage::words(sb_ + L.b.ids, ib + obj * Mb, Mb, lane);
      stage::words(sb_ + L.b.dots, db + obj * mb, mb, lane);
      stage::words(sb_ + L.b.dclocks, dcb + obj * Db * A, Db * A, lane);
    }
    stage::words(st + L.a.dids, dia + obj * Da, Da, lane);
    stage::words(sb_ + L.b.dids, dib + obj * Db, Db, lane);
    stage::arrive(bar);
  };

  issue(0);
  issue(1);
  long long it = 0;
  for (long long obj = first; obj < n; obj += stride, ++it) {
    stage::wait(&bars[it & 1], (uint32_t)((it >> 1) & 1));
    int* st = w + 4 + (int)(it & 1) * L.stage;
    const orswot::OutView o{oc + obj * A, oi + obj * m_cap, od + obj * m_cap * A,
                            odi + obj * d_cap, odc + obj * d_cap * A};
    const int flags = staged::merge<APL>(staged::side_at(st, A, Ma, Da),
                                         staged::side_at(st + L.a.total, A, Mb, Db), o, A,
                                         m_cap, d_cap, w + L.scratch, L.X, lane,
                                         staged::NoMarks{});
    if (lane == 0) {
      over[2 * obj] = flags & 1;
      over[2 * obj + 1] = (flags >> 1) & 1;
    }
    // the merge wrote its rows into this stage: every lane orders its
    // writes before the copy engine's, then the stage is free for object
    // it + 2
    if (bulk) stage::fence_async();
    __syncwarp();
    issue(it + 2);
  }
}

// The route for widths whose stages do not fit: persistent warps, each
// merging its objects one at a time from device memory (the first design).
__global__ void __launch_bounds__(32 * MAX_WARPS) orswot_merge_direct_kernel(
    const int* __restrict__ ca, const int* __restrict__ ia, const int* __restrict__ da,
    const int* __restrict__ dia, const int* __restrict__ dca,
    const int* __restrict__ cb, const int* __restrict__ ib, const int* __restrict__ db,
    const int* __restrict__ dib, const int* __restrict__ dcb,
    int* __restrict__ oc, int* __restrict__ oi, int* __restrict__ od,
    int* __restrict__ odi, int* __restrict__ odc, int* __restrict__ over,
    long long n, int A, int Ma, int Mb, int Da, int Db, int m_cap, int d_cap) {
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * warps;
  int* scratch = smem + warp * orswot::merge_scratch_ints(Ma, Mb, Da, Db, A);
  for (long long obj = (long long)blockIdx.x * warps + warp; obj < n; obj += stride) {
    const orswot::StateView a{ca + obj * A, ia + obj * Ma, da + obj * Ma * A,
                              dia + obj * Da, dca + obj * Da * A, Ma, Da};
    const orswot::StateView b{cb + obj * A, ib + obj * Mb, db + obj * Mb * A,
                              dib + obj * Db, dcb + obj * Db * A, Mb, Db};
    const orswot::OutView o{oc + obj * A, oi + obj * m_cap, od + obj * m_cap * A,
                            odi + obj * d_cap, odc + obj * d_cap * A};
    const int flags = orswot::merge_object(a, b, o, A, m_cap, d_cap, scratch, lane);
    if (lane == 0) {
      over[2 * obj] = flags & 1;
      over[2 * obj + 1] = (flags >> 1) & 1;
    }
    __syncwarp();  // every lane is done with the scratch before the next object
  }
}

inline bool bulk_route(const void* const* ptrs, int A, int Ma, int Mb, int Da, int Db) {
  const long long strides[8] = {A, Ma, (long long)Ma * A, (long long)Da * A,
                                A, Mb, (long long)Mb * A, (long long)Db * A};
  for (int p = 0; p < 8; ++p)
    if (!stage::bulk_ok(ptrs[p], strides[p])) return false;
  return true;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t per_warp, long long n, void* stream, Args... args) {
  stage::Grid g;
  const cudaError_t err = stage::persistent_grid(kernel, per_warp, MAX_WARPS, n, &g);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, g.warps * 32, g.smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

enum Route { WORDS = 0, BULK = 1, DIRECT = 2 };

// Staged (bulk copies where every piece is aligned, else per-lane
// cp.async) when one warp's stages fit the card's shared memory per
// block, else direct.
inline int route_for(const void* const* ptrs, int A, int Ma, int Mb, int Da, int Db, int m_cap,
                     int* route) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = (long long)layout(A, Ma, Mb, Da, Db, m_cap).total * sizeof(int);
  *route = bytes > limit ? DIRECT : (bulk_route(ptrs, A, Ma, Mb, Da, Db) ? BULK : WORDS);
  return 0;
}

}  // namespace

// The instantiation, alignment path and route a launch with these
// arguments takes: 100 * (1 one __match_any_sync for the member
// alignment, 0 the lane-parallel loops) + 10 * (actors per lane at
// compile time, 0 for run-time A) + route (0 staged by per-lane cp.async,
// 1 staged by bulk copies, 2 direct from device memory); negative: a CUDA
// error.
extern "C" int orswot_merge_plan(const void* ca, const void* ia, const void* da,
                                 const void* dca, const void* cb, const void* ib,
                                 const void* db, const void* dcb, int A, int Ma, int Mb,
                                 int Da, int Db, int m_cap) {
  const void* ptrs[8] = {ca, ia, da, dca, cb, ib, db, dcb};
  int route = 0;
  const int err = route_for(ptrs, A, Ma, Mb, Da, Db, m_cap, &route);
  if (err) return -err;
  if (route == DIRECT) return DIRECT;
  return 100 * staged::one_match(Ma, Mb) + 10 * (A == 64 ? 2 : 0) + route;
}

extern "C" int orswot_merge_launch(
    const void* ca, const void* ia, const void* da, const void* dia, const void* dca,
    const void* cb, const void* ib, const void* db, const void* dib, const void* dcb,
    void* oc, void* oi, void* od, void* odi, void* odc, void* over,
    long long n, int A, int Ma, int Mb, int Da, int Db, int m_cap, int d_cap,
    void* stream) {
  if (n <= 0) return 0;
  const void* ptrs[8] = {ca, ia, da, dca, cb, ib, db, dcb};
  int route = 0;
  const int err = route_for(ptrs, A, Ma, Mb, Da, Db, m_cap, &route);
  if (err) return err;
  const int *ia_ = (const int*)ia, *ca_ = (const int*)ca, *da_ = (const int*)da,
            *dia_ = (const int*)dia, *dca_ = (const int*)dca, *cb_ = (const int*)cb,
            *ib_ = (const int*)ib, *db_ = (const int*)db, *dib_ = (const int*)dib,
            *dcb_ = (const int*)dcb;
  int *oc_ = (int*)oc, *oi_ = (int*)oi, *od_ = (int*)od, *odi_ = (int*)odi, *odc_ = (int*)odc,
      *over_ = (int*)over;
  if (route == DIRECT)
    return launch(orswot_merge_direct_kernel,
                  (size_t)orswot::merge_scratch_ints(Ma, Mb, Da, Db, A) * sizeof(int), n, stream,
                  ca_, ia_, da_, dia_, dca_, cb_, ib_, db_, dib_, dcb_, oc_, oi_, od_, odi_, odc_,
                  over_, n, A, Ma, Mb, Da, Db, m_cap, d_cap);
  const size_t per_warp = (size_t)layout(A, Ma, Mb, Da, Db, m_cap).total * sizeof(int);
  const int bulk = route == BULK ? 1 : 0;
#define ORSWOT_K2_LAUNCH(APL)                                                                  \
  return launch(orswot_merge_kernel<APL>, per_warp, n, stream, ca_, ia_, da_, dia_, dca_, cb_, \
                ib_, db_, dib_, dcb_, oc_, oi_, od_, odi_, odc_, over_, n, A, Ma, Mb, Da, Db,  \
                m_cap, d_cap, bulk)
  if (A == 64) ORSWOT_K2_LAUNCH(2);
  ORSWOT_K2_LAUNCH(0);
#undef ORSWOT_K2_LAUNCH
}
