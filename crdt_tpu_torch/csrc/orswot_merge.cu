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
//   b-only), and read from there for liveness and output;
// * compaction by inverted rank: each live slot names its output slot.
//   Two live slots with one id (possible only when a side is already
//   invalid) are found with one vote, and that object alone takes the
//   exact rule of `_merge_tile` (ids summed as id + 1, rows maxed).
//
// Widths whose two stages do not fit the card's shared memory (wide A at
// wide M: from A = 217 at M = 64) take the first design's kernel instead:
// one warp per object reading both sides straight from device memory
// through orswot::merge_object, with shared memory for ids, flags and the
// two set clocks only, so any A fits.  The launcher picks it from the
// widths; `orswot_merge_plan` reports which route a launch takes.
//
// K3 (orswot_fold.cu) keeps calling orswot::merge_object of the header.
#include "orswot_stage.cuh"
#include "orswot_tile.cuh"

namespace {

using orswot::EMPTY;
using orswot::FULL;
using orswot::ZERO;
using stage::pad4;

constexpr int MAX_WARPS = 4;  // most warps per block (stage::persistent_grid may take fewer)

// One side's slice of one object in a stage (int offsets).
struct Side {
  int clock, ids, dots, dclocks, dids, total;
};
__host__ __device__ inline Side side_layout(int A, int M, int D) {
  Side s;
  s.clock = 0;
  s.ids = pad4(A);
  s.dots = s.ids + pad4(M);
  s.dclocks = s.dots + pad4(M * A);
  s.dids = s.dclocks + pad4(D * A);
  s.total = s.dids + pad4(D);
  return s;
}

// One warp's shared area (int offsets): two stages of (a, b), then the
// id-plane scratch.
struct Layout {
  Side a, b;
  int stage, id, jm, live, rank, src, did, dlive, ahead, total;
};
__host__ __device__ inline Layout layout(int A, int Ma, int Mb, int Da, int Db, int m_cap) {
  Layout L;
  L.a = side_layout(A, Ma, Da);
  L.b = side_layout(A, Mb, Db);
  L.stage = L.a.total + L.b.total;
  const int S = Ma + Mb, dn = Da + Db;
  int o = 4 + 2 * L.stage;  // two mbarriers, then the stages
  L.id = o;                 // [S] candidate ids: a's slots, then b's unmatched
  o += pad4(S);
  L.jm = o;  // [Ma] an a-slot's matching b-slot: -1 none, -2 several
  o += pad4(Ma);
  L.live = o;  // [S] survives the replay
  o += pad4(S);
  L.rank = o;  // [S] rank among live slots by id
  o += pad4(S);
  L.src = o;  // [m_cap] slot filling each output slot, -1 none
  o += pad4(m_cap);
  L.did = o;  // [dn] deferred ids, a's rows then b's
  o += pad4(dn);
  L.dlive = o;
  o += pad4(dn);
  L.ahead = o;
  o += pad4(dn);
  L.total = o;
  return L;
}

// Whether the member alignment is one __match_any_sync (a's ids in lanes
// 0..Ma-1, b's in the lanes after them) rather than the lane-parallel loops.
__host__ __device__ inline bool one_match(int Ma, int Mb) {
  return Ma + Mb <= 32 && Ma < 32 && Mb < 32;
}

// f(x) for this lane's actor columns x = lane + 32 j < A.
template <int APL, typename F>
__device__ __forceinline__ void each_col(int A, int lane, F&& f) {
  if constexpr (APL > 0) {
#pragma unroll
    for (int j = 0; j < APL; ++j) f(lane + 32 * j);
  } else {
    for (int x = lane; x < A; x += 32) f(x);
  }
}

// Keep-first dedup of the deferred union (`orswot.rs:141-148`): d_live[k]
// for k < dn.  orswot::dedup_rows with the actor loop at compile-time
// width; the header's copy stays as K3 was built with it.
template <int APL, typename RowFn>
__device__ __forceinline__ void dedup(const int* did, int* d_live, int dn, int A, int lane,
                                      RowFn rows) {
  for (int k = 0; k < dn; ++k) {
    const int id = did[k];
    bool dup = false;
    if (id != EMPTY) {
      const int* rk = rows(k);
      for (int i = 0; i < k && !dup; ++i) {
        if (did[i] != id) continue;
        const int* ri = rows(i);
        bool eq = true;
        each_col<APL>(A, lane, [&](int x) { eq &= ri[x] == rk[x]; });
        dup = orswot::warp_all(eq);
      }
    }
    if (lane == 0) d_live[k] = (id != EMPTY && !dup) ? 1 : 0;
  }
  __syncwarp();
}

// The flagged rows, in slot order, into d_cap output rows; returns the
// flagged count.  orswot::slot_ranks + pack_rows in one pass over the
// rows; the header's copies stay as K3 was built with them.
template <int APL, typename RowFn>
__device__ __forceinline__ int pack(const int* flags, const int* src_ids, int n, int* out_ids,
                                    int* out_rows, int d_cap, int A, int lane, RowFn rows) {
  int taken = 0;
  for (int k = 0; k < n && taken < d_cap; ++k) {
    if (!flags[k]) continue;
    if (lane == 0) out_ids[taken] = src_ids[k];
    const int* r = rows(k);
    int* o = out_rows + taken * A;
    each_col<APL>(A, lane, [&](int x) { o[x] = r[x]; });
    ++taken;
  }
  for (int k = taken; k < d_cap; ++k) {
    if (lane == 0) out_ids[k] = EMPTY;
    int* o = out_rows + k * A;
    each_col<APL>(A, lane, [&](int x) { o[x] = ZERO; });
  }
  int count = 0;
  for (int k = 0; k < n; ++k) count += flags[k];
  return count;
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
  int* s_id = w + L.id;
  int* s_jm = w + L.jm;
  int* s_live = w + L.live;
  int* s_rank = w + L.rank;
  int* s_src = w + L.src;
  int* s_did = w + L.did;
  int* s_dlive = w + L.dlive;
  int* s_ahead = w + L.ahead;
  const int S = Ma + Mb, dn = Da + Db;

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
    const int* a_clock = st + L.a.clock;
    const int* a_ids = st + L.a.ids;
    int* a_dots = st + L.a.dots;
    const int* a_dcl = st + L.a.dclocks;
    const int* a_dids = st + L.a.dids;
    const int* b_clock = st + L.a.total + L.b.clock;
    const int* b_ids = st + L.a.total + L.b.ids;
    int* b_dots = st + L.a.total + L.b.dots;
    const int* b_dcl = st + L.a.total + L.b.dclocks;
    const int* b_dids = st + L.a.total + L.b.dids;

    // --- member alignment: a's slots, then b's slots no a-slot matched ---
    for (int k = lane; k < dn; k += 32) s_did[k] = k < Da ? a_dids[k] : b_dids[k - Da];
    if (one_match(Ma, Mb)) {
      // one match over the lanes: lanes 0..Ma-1 hold a's ids, lanes
      // Ma..Ma+Mb-1 b's; an a lane's peers past Ma are its matching b-slots
      const int v = lane < Ma ? a_ids[lane] : (lane < Ma + Mb ? b_ids[lane - Ma] : EMPTY - 1);
      const unsigned peers = __match_any_sync(FULL, v);
      if (lane < Ma) {
        const unsigned bp = (peers >> Ma) & ((1u << Mb) - 1u);
        s_id[lane] = v;
        s_jm[lane] = v == EMPTY || bp == 0 ? -1 : ((bp & (bp - 1)) ? -2 : __ffs(bp) - 1);
      } else if (lane < Ma + Mb) {
        const bool matched = (peers & ((1u << Ma) - 1u)) != 0;
        s_id[lane] = v != EMPTY && !matched ? v : EMPTY;
      }
    } else {
      for (int s = lane; s < Ma; s += 32) s_id[s] = a_ids[s];
      for (int j = lane; j < Mb; j += 32) {
        const int id = b_ids[j];
        bool matched = false;
        for (int i = 0; i < Ma; ++i) matched |= (a_ids[i] != EMPTY && a_ids[i] == id);
        s_id[Ma + j] = (id != EMPTY && !matched) ? id : EMPTY;
      }
      for (int i = lane; i < Ma; i += 32) {
        const int id = a_ids[i];
        int jm = -1;
        if (id != EMPTY)
          for (int j = 0; j < Mb; ++j)
            if (b_ids[j] == id) jm = jm == -1 ? j : -2;
        s_jm[i] = jm;
      }
    }
    __syncwarp();

    // --- deferred union + dedup, keep first (`orswot.rs:141-148`) ---
    auto rows = [&](int k) { return k < Da ? a_dcl + k * A : b_dcl + (k - Da) * A; };
    dedup<APL>(s_did, s_dlive, dn, A, lane, rows);

    // --- clock join (`orswot.rs:153`); rows still ahead of it ---
    each_col<APL>(A, lane, [&](int x) { oc[obj * A + x] = orswot::imax(a_clock[x], b_clock[x]); });
    for (int k = 0; k < dn; ++k) {
      bool ahead = false;
      if (s_dlive[k]) {
        const int* r = rows(k);
        bool covered = true;
        each_col<APL>(A, lane, [&](int x) {
          covered &= r[x] <= orswot::imax(a_clock[x], b_clock[x]);
        });
        ahead = !orswot::warp_all(covered);
      }
      if (lane == 0) s_ahead[k] = ahead ? 1 : 0;
    }

    // the aligned other-side dot of a-slot i at actor x: the matching b
    // row's (ids are unique per side in valid state); several matching
    // rows take `_align_against`'s max over all of them
    auto e2_at = [&](int i, int x) {
      const int jm = s_jm[i];
      if (jm >= 0) return b_dots[jm * A + x];
      int e2 = ZERO;
      if (jm == -2)
        for (int j = 0; j < Mb; ++j)
          if (b_ids[j] == a_ids[i]) e2 = orswot::imax(e2, b_dots[j * A + x]);
      return e2;
    };
    auto slot_row = [&](int s) { return s < Ma ? a_dots + s * A : b_dots + (s - Ma) * A; };

    // --- dot rule + replay, once per slot, over its own row; survivors
    // are the non-empty rows ---
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int sn = S - s0 < 32 ? S - s0 : 32;
      // the chunk's slots that a live deferred row cites
      bool cited = false;
      if (lane < sn && s_id[s0 + lane] != EMPTY) {
        const int id = s_id[s0 + lane];
        for (int k = 0; k < dn; ++k) cited |= s_dlive[k] && s_did[k] == id;
      }
      const unsigned cmask = __ballot_sync(FULL, cited);
      unsigned ml = 0;
      for (int jj = 0; jj < sn; ++jj) {
        const int s = s0 + jj;
        const int id = s_id[s];
        if (id == EMPTY) continue;
        int* row = slot_row(s);
        const bool is_cited = (cmask >> jj) & 1u;
        // the dot rule (`orswot.rs:92-138`) in the closed form K1 uses
        // (orswot_fold_aligned.cu): out = e1 == e2 ? e1 : max(e1 - oc,
        // e2 - sc), with oc = 0 for an a-row the other side lacks that
        // keeps whole; b-only rows take e2 - sc
        bool whole = false;
        if (s < Ma) {
          bool keep1 = false, p2 = false;
          each_col<APL>(A, lane, [&](int x) {
            keep1 |= row[x] > b_clock[x];
            p2 |= e2_at(s, x) != ZERO;
          });
          whole = orswot::warp_any(keep1) && !orswot::warp_any(p2);
        }
        bool ne = false;
        each_col<APL>(A, lane, [&](int x) {
          int v;
          if (s < Ma) {
            const int e1 = row[x], e = e2_at(s, x), oc = whole ? ZERO : b_clock[x];
            v = e1 == e ? e1 : orswot::imax(orswot::sub1(e1, oc), orswot::sub1(e, a_clock[x]));
          } else {
            v = orswot::sub1(row[x], a_clock[x]);
          }
          if (is_cited) {  // `orswot.rs:155`: the join of the live rows citing it
            int rm = ZERO;
            for (int k = 0; k < dn; ++k)
              if (s_dlive[k] && s_did[k] == id) rm = orswot::imax(rm, rows(k)[x]);
            v = orswot::sub1(v, rm);
          }
          row[x] = v;
          ne |= v != ZERO;
        });
        ml |= (orswot::warp_any(ne) ? 1u : 0u) << jj;
      }
      if (lane < sn) s_live[s0 + lane] = (ml >> lane) & 1u;
    }
    __syncwarp();

    // --- canonical compaction: rank by ascending id among live slots ---
    int my_live = 0;
    bool dup = false;
    for (int s = lane; s < S; s += 32) {
      int r = 0, same = 0;
      if (s_live[s]) {
        const int key = s_id[s];
        for (int t = 0; t < S; ++t) {
          r += (s_live[t] && s_id[t] < key) ? 1 : 0;
          same += (s_live[t] && s_id[t] == key) ? 1 : 0;
        }
        ++my_live;
      }
      s_rank[s] = r;
      dup |= same > 1;
    }
    const int n_live = __reduce_add_sync(FULL, my_live);
    int* orows = od + obj * m_cap * A;
    if (!orswot::warp_any(dup)) {
      // live slots have distinct ranks: each fills its own output slot
      for (int k = lane; k < m_cap; k += 32) s_src[k] = -1;
      __syncwarp();
      for (int s = lane; s < S; s += 32)
        if (s_live[s] && s_rank[s] < m_cap) s_src[s_rank[s]] = s;
      __syncwarp();
      for (int k = lane; k < m_cap; k += 32)
        oi[obj * m_cap + k] = s_src[k] >= 0 ? s_id[s_src[k]] : EMPTY;
      for (int k = 0; k < m_cap; ++k) {
        const int s = s_src[k];
        const int* row = s >= 0 ? slot_row(s) : nullptr;
        each_col<APL>(A, lane, [&](int x) { orows[k * A + x] = row ? row[x] : ZERO; });
      }
    } else {
      // `_select` of `_merge_tile`: output slot k takes every live slot of
      // rank k, ids summed as id + 1, rows maxed
      __syncwarp();
      for (int k = 0; k < m_cap; ++k) {
        int first_s = -1, idsum = 0;
        for (int s = 0; s < S; ++s)
          if (s_live[s] && s_rank[s] == k) {
            if (first_s < 0) first_s = s;
            idsum += s_id[s] + 1;
          }
        if (lane == 0) oi[obj * m_cap + k] = idsum - 1;
        each_col<APL>(A, lane, [&](int x) {
          int v = ZERO;
          if (first_s >= 0)
            for (int s = first_s; s < S; ++s)
              if (s_live[s] && s_rank[s] == k) v = orswot::imax(v, slot_row(s)[x]);
          orows[k * A + x] = v;
        });
      }
    }

    // --- deferred rows still ahead, first-occurrence order, into d_cap ---
    const int n_ahead = pack<APL>(s_ahead, s_did, dn, odi + obj * d_cap, odc + obj * d_cap * A,
                                  d_cap, A, lane, rows);
    if (lane == 0) {
      over[2 * obj] = n_live > m_cap ? 1 : 0;
      over[2 * obj + 1] = n_ahead > d_cap ? 1 : 0;
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
  const long long staged = (long long)layout(A, Ma, Mb, Da, Db, m_cap).total * sizeof(int);
  *route = staged > limit ? DIRECT : (bulk_route(ptrs, A, Ma, Mb, Da, Db) ? BULK : WORDS);
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
  return 100 * one_match(Ma, Mb) + 10 * (A == 64 ? 2 : 0) + route;
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
