// Union-aligned anti-entropy fold over R replica fleets (K1).
//
// Replaces: crdt_tpu/ops/orswot_fold_aligned.py::fold_merge — the fold
// that builds one union table of member ids per object, aligns each
// replica onto it once, runs R-1 elementwise dot-rule steps (each with
// the deferred union, dedup, replay and compaction to d_cap), the
// optional plunger self-step, then one ascending-id rank selection into
// m_cap slots.  With no overflow flagged it equals the sequential fold
// bit for bit; where a flag is set its outputs are unspecified.  The
// member flag also covers the union outgrowing u_cap.
//
// Bound on this card: bytes.  It reads R states and writes one (at R=8,
// A=64, M=16, D=2 with 32-bit counters: 44.4 KB per object), 2.78 GB per
// 62,500-object chunk, 0.83 ms at 3.35 TB/s.  The work per counter is a
// handful of integer compares, selects and maxes — no products, so the
// tensor cores have nothing to do here; the integer pipes and the memory
// system are the whole machine.
//
// What held the first design back was that each warp alternated between
// loading a replica and computing on it, and that the compute itself was
// long chains of shared-memory loads over run-time widths.  This design:
//
// * persistent warps: the grid is as large as the card keeps resident,
//   and each warp walks objects first, first + warps, ...;
// * a ring of shared-memory stages per warp, filled ahead by the copy
//   engine (`orswot_stage.cuh`): one unit is one replica's slice of one
//   object (set clock, member rows, deferred rows and ids), so replica
//   r+1 lands while step r runs, and the next object's replica 0 lands
//   during the plunger step and the compaction.  All R member-id rows of
//   the next object are staged one object ahead, since the union needs
//   them before replica 0 is aligned.  The launcher picks, once per
//   launch from the base pointers and widths, bulk copies or per-lane
//   4-byte cp.async for the same stages;
// * the accumulator [U, A], the joined clock and the deferred table held
//   in registers at compile-time widths (A = 64: two actors per lane;
//   u_cap <= 16 slots; at most DM = 2 deferred rows per side), so every
//   pass of a step (dot rule, dedup, replay, retention) is straight-line
//   register code with a few warp votes; the replica side is read
//   straight from the stage through the union-slot -> row map.  The dot
//   rule takes a closed form with two votes per slot, and the plunger's
//   member rule is the identity.  Other widths take the same kernel with
//   the accumulator and deferred table in shared memory;
// * id-plane work in parallel: the union is built 32 candidates at a
//   time with __match_any_sync, the alignment map is one __match_any_sync
//   over the union and member ids (a lane-parallel scan for wider
//   tables), the final rank is lane-parallel over the <= U union slots,
//   and every live slot writes its own output row (one coalesced 128-byte
//   line per 32 actors).
//
// PERF.md §6 holds its times on the H100 beside the first design's, with
// the registers of each instantiation and the phase split of
// crdt_tpu_torch/tools/k1_phases.py.
#include <type_traits>

#include "orswot_stage.cuh"
#include "orswot_tile.cuh"

// Phase clocks (build with -DORSWOT_PHASE_CLOCKS; crdt_tpu_torch/tools/
// k1_phases.py): clock64() stamps at the phase boundaries, summed per
// warp and added into one device-wide total per phase at warp exit.
// A fold step is split into its member dot rule, deferred dedup, replay
// and retention; the plunger step counts as one phase.
enum Phase {
  P_IDS, P_UNION, P_ISSUE, P_WAIT, P_ALIGN, P_RULE, P_DEDUP, P_REPLAY, P_RETAIN, P_PLUNGER,
  P_STORE, N_PHASES
};
#ifdef ORSWOT_PHASE_CLOCKS
__device__ unsigned long long g_phase_cycles[N_PHASES];
#define PHASE_START() long long ph_[N_PHASES] = {}; long long ph_t_ = clock64()
#define PHASE_MARK(p) do { const long long t_ = clock64(); ph_[p] += t_ - ph_t_; ph_t_ = t_; } while (0)
#define PHASE_FLUSH(lane)                                                          \
  do {                                                                             \
    if ((lane) == 0)                                                               \
      for (int p_ = 0; p_ < N_PHASES; ++p_)                                        \
        atomicAdd(&g_phase_cycles[p_], (unsigned long long)ph_[p_]);               \
  } while (0)
extern "C" int orswot_fold_aligned_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[N_PHASES] = {};
    err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)err;
}
#else
#define PHASE_START() do {} while (0)
#define PHASE_MARK(p) do {} while (0)
#define PHASE_FLUSH(lane) do {} while (0)
#endif

namespace {

using orswot::EMPTY;
using orswot::FULL;
using orswot::ZERO;
using stage::pad4;

constexpr int STAGES = 2;     // replica units in flight per warp (3 measured no faster)
constexpr int MAX_WARPS = 4;  // most warps per block (stage::persistent_grid may take fewer)
constexpr int MIN_BLOCKS = 4; // blocks per SM the register budget must allow: 16 warps
constexpr int DM = 2;  // deferred rows per side the register instantiation holds

// Whether the alignment map is one __match_any_sync per replica (the
// `ub` union slots in lanes 0..ub-1, the M member ids in the lanes after
// them) rather than the lane-parallel scan: registers instantiation only.
__host__ __device__ constexpr bool one_match(int ub, int M) { return ub > 0 && M <= 32 - ub; }

// One replica's slice of one object in a stage (int offsets).
struct Unit {
  int clock, dots, dclocks, dids, total;
};
__host__ __device__ inline Unit unit_layout(int A, int M, int D) {
  Unit u;
  u.clock = 0;
  u.dots = pad4(A);
  u.dclocks = u.dots + pad4(M * A);
  u.dids = u.dclocks + pad4(D * A);
  u.total = u.dids + pad4(D);
  return u;
}

// One warp's shared area (int offsets); `slots` union slots, and the
// accumulator's planes only where it lives in shared memory.
struct Layout {
  int stage, ids, zero, uni, inv, live, rank, dids, drows, cat, dlive, ahead, drank, acc, clk,
      total;
};
__host__ __device__ inline Layout layout(int slots, int A, int D, int d_cap, int R, int M,
                                         bool smem_acc) {
  const int dmax = D > d_cap ? D : d_cap, dn = 2 * dmax;
  Layout L;
  int o = pad4(2 * (STAGES + 2));  // the mbarriers: STAGES units, two id rows
  L.stage = o;
  o += STAGES * unit_layout(A, M, D).total;
  L.ids = o;
  o += 2 * pad4(R * M);
  L.zero = o;  // a row of ZERO: the replica row of a slot the replica lacks
  o += pad4(A);
  L.uni = o;
  o += pad4(slots);
  L.inv = o;
  o += pad4(slots);
  L.live = o;
  o += pad4(slots);
  L.rank = o;
  o += pad4(slots);
  L.dids = o;
  o += pad4(dmax);
  L.drows = o;
  o += pad4(dmax * A);
  L.cat = o;
  o += pad4(dn);
  L.dlive = o;
  o += pad4(dn);
  L.ahead = o;
  o += pad4(dn);
  L.drank = o;
  o += pad4(dn);
  L.acc = o;
  if (smem_acc) o += pad4(slots * A);
  L.clk = o;
  if (smem_acc) o += pad4(A);
  L.total = o;
  return L;
}

// The accumulator: member rows on union slots and the joined clock, each
// lane holding its own actor columns x = lane + 32 j.
template <int UB, int APL>
struct Acc {  // registers, compile-time widths
  int v[UB][APL];
  int c[APL];
  __device__ __forceinline__ void bind(int*, int*, int, int) {}
  __device__ __forceinline__ int& at(int u, int j) { return v[u][j]; }
  __device__ __forceinline__ int& clk(int j) { return c[j]; }
};
template <>
struct Acc<0, 0> {  // shared memory, run-time widths
  int* v;
  int* c;
  int A, lane;
  __device__ __forceinline__ void bind(int* v_, int* c_, int A_, int lane_) {
    v = v_;
    c = c_;
    A = A_;
    lane = lane_;
  }
  __device__ __forceinline__ int& at(int u, int j) { return v[u * A + lane + 32 * j]; }
  __device__ __forceinline__ int& clk(int j) { return c[lane + 32 * j]; }
};

// f(u, jj) for the slots u = u0 + jj of one 32-slot chunk: unrolled over
// all UB slots when the slot count is a compile-time constant.
template <int UB, typename F>
__device__ __forceinline__ void each_slot(int u0, int un, F&& f) {
  if constexpr (UB > 0) {
#pragma unroll
    for (int jj = 0; jj < UB; ++jj) f(jj, jj);
  } else {
    for (int jj = 0; jj < un; ++jj) f(u0 + jj, jj);
  }
}

// f(j, x) for this lane's actor columns x = lane + 32 j < A.
template <int APL, typename F>
__device__ __forceinline__ void each_col(int apl, int A, int lane, F&& f) {
  if constexpr (APL > 0) {
#pragma unroll
    for (int j = 0; j < APL; ++j) f(j, lane + 32 * j);
  } else {
    for (int j = 0; j < apl; ++j) {
      const int x = lane + 32 * j;
      if (x < A) f(j, x);
    }
  }
}

template <int UB, int APL>
__global__ void __launch_bounds__(32 * MAX_WARPS, MIN_BLOCKS) orswot_fold_aligned_kernel(
    const int* __restrict__ clock, const int* __restrict__ ids, const int* __restrict__ dots,
    const int* __restrict__ dids, const int* __restrict__ dclocks,
    int* __restrict__ oc, int* __restrict__ oi, int* __restrict__ od,
    int* __restrict__ odi, int* __restrict__ odc, int* __restrict__ over,
    int R, long long n, int A_rt, int M, int D, int m_cap, int d_cap, int U,
    int plunger, int bulk) {
  constexpr bool REG = APL > 0;
  const int A = REG ? 32 * APL : A_rt;
  const int apl = REG ? APL : (A_rt + 31) / 32;
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * warps + warp;
  const long long stride = (long long)gridDim.x * warps;
  if (first >= n) return;  // the ragged edge: a whole warp with no object
  const int slots = REG ? UB : U;
  const Layout L = layout(slots, A, D, d_cap, R, M, !REG);
  const Unit un = unit_layout(A, M, D);
  int* w = smem + warp * L.total;
  uint64_t* bars = reinterpret_cast<uint64_t*>(w);  // [STAGES] units, [2] id rows
  int* s_union = w + L.uni;  // union ids (EMPTY past the last)
  int* s_inv = w + L.inv;    // union slot -> offset in w of the replica's row for it
  int* s_live = w + L.live;
  int* s_rank = w + L.rank;
  int* s_dids = w + L.dids;    // the accumulator's deferred table
  int* s_drows = w + L.drows;
  int* s_cat = w + L.cat;      // one step's deferred union: ids, live, ahead, rank
  int* s_dlive = w + L.dlive;
  int* s_ahead = w + L.ahead;
  int* s_drank = w + L.drank;
  const int rm_ints = pad4(R * M);

  if (lane == 0) {
    for (int b = 0; b < STAGES + 2; ++b) stage::init(&bars[b], bulk);
    stage::init_fence();
  }
  for (int x = lane; x < A; x += 32) w[L.zero + x] = ZERO;
  __syncwarp();

  // replica r of object obj into stage s
  auto issue_unit = [&](int s, long long obj, int r) {
    if (obj >= n) return;
    int* st = w + L.stage + s * un.total;
    uint64_t* bar = &bars[s];
    const long long row = (long long)r * n + obj;
    if (bulk) {
      if (lane == 0) {
        stage::expect(bar, (uint32_t)((A + M * A + D * A) * sizeof(int)));
        stage::bulk(st + un.clock, clock + row * A, A * sizeof(int), bar);
        stage::bulk(st + un.dots, dots + row * M * A, M * A * sizeof(int), bar);
        stage::bulk(st + un.dclocks, dclocks + row * D * A, D * A * sizeof(int), bar);
      }
    } else {
      stage::words(st + un.clock, clock + row * A, A, lane);
      stage::words(st + un.dots, dots + row * M * A, M * A, lane);
      stage::words(st + un.dclocks, dclocks + row * D * A, D * A, lane);
    }
    stage::words(st + un.dids, dids + row * D, D, lane);
    stage::arrive(bar);
  };
  // the R member-id rows of this warp's it-th object, into id buffer it % 2
  auto issue_ids = [&](long long it) {
    const long long obj = first + it * stride;
    if (obj >= n) return;
    int* dst = w + L.ids + (int)(it & 1) * rm_ints;
    uint64_t* bar = &bars[STAGES + (it & 1)];
    if (bulk) {
      if (lane == 0) {
        stage::expect(bar, (uint32_t)(R * M * sizeof(int)));
        for (int r = 0; r < R; ++r)
          stage::bulk(dst + r * M, ids + ((long long)r * n + obj) * M, M * sizeof(int), bar);
      }
    } else {
      for (int i = lane; i < R * M; i += 32) {
        const int r = i / M;
        stage::word(dst + i, ids + ((long long)r * n + obj) * M + (i - r * M));
      }
    }
    stage::arrive(bar);
  };

  Acc<UB, APL> acc;
  acc.bind(w + L.acc, w + L.clk, A, lane);

  PHASE_START();
  issue_ids(0);
  for (int q = 0; q < STAGES; ++q) issue_unit(q, first + (q / R) * stride, q % R);
  int cs = 0;          // the stage the next unit lands in
  uint32_t cpar = 0;   // and the parity of its fill
  long long it = 0;
  for (long long obj = first; obj < n; obj += stride, ++it) {
    __syncwarp();  // every lane is done with the other id buffer
    issue_ids(it + 1);
    stage::wait(&bars[STAGES + (it & 1)], (uint32_t)((it >> 1) & 1));
    const int* s_ids = w + L.ids + (int)(it & 1) * rm_ints;
    PHASE_MARK(P_IDS);

    // --- union of member ids, first-occurrence order (`_build_union`) ---
    // 32 candidates at a time: a candidate is new iff it is the first of
    // its id within the chunk (__match_any_sync) and not yet in the
    // union.  This places exactly the ids, in exactly the slots, of the
    // one-at-a-time build; only the count past u_cap may differ (a repeat
    // of an id that found no slot counts again, as in `_build_union`),
    // and both counts exceed u_cap together.
    for (int u = lane; u < slots; u += 32) s_union[u] = EMPTY;
    __syncwarp();
    int n_union = 0;
    for (int c0 = 0; c0 < R * M; c0 += 32) {
      const int c = c0 + lane;
      const int cand = c < R * M ? s_ids[c] : EMPTY;
      const unsigned peers = __match_any_sync(FULL, cand);
      bool is_new = cand != EMPTY && (peers & ((1u << lane) - 1u)) == 0;
      const int filled = n_union < U ? n_union : U;
      for (int u = 0; u < filled && is_new; ++u) is_new = s_union[u] != cand;
      const unsigned ball = __ballot_sync(FULL, is_new);
      const int slot = n_union + __popc(ball & ((1u << lane) - 1u));
      if (is_new && slot < U) s_union[slot] = cand;
      n_union += __popc(ball);
      __syncwarp();
    }
    bool m_over = n_union > U, d_over = false;
    const int n_eff = n_union < U ? n_union : U;  // valid union slots
    const int nu = REG ? UB : n_eff;              // slots the passes walk
    PHASE_MARK(P_UNION);

    // replica row feeding union slot u at actor x (`_align_to_union`),
    // through the map the alignment wrote: no branch, so the loads of all
    // slots issue back to back
    auto e2_at = [&](int u, int x) { return w[s_inv[u] + x]; };
    int acc_d = D;  // rows in the accumulator's deferred table (shared memory)
    // the register instantiation's deferred table: DM ids (uniform) and
    // rows (this lane's columns), EMPTY / ZERO past its last row
    constexpr int NJ = REG ? APL : 1;
    int dq_id[DM], dq_row[DM][NJ];
    // this lane's union slot id (register instantiation: slot = lane)
    const int my_uid = REG && lane < n_eff ? s_union[lane] : EMPTY;

    // One fold step: self = the accumulator, other = the staged replica
    // (or the accumulator itself for the plunger).  `_step_members`, then
    // `_step_deferred`.
    auto step = [&](auto self_tag, const int* st) {
      constexpr bool SELF = decltype(self_tag)::value;
      auto e2 = [&](int u, int j, int x) {
        if constexpr (SELF) return acc.at(u, j);
        else return e2_at(u, x);
      };
      auto crep = [&](int j, int x) {
        if constexpr (SELF) return acc.clk(j);
        else return st[un.clock + x];
      };
      // member dot rule (`orswot.rs:92-138`) in one closed form per slot,
      // with x - c meaning x > c ? x : 0 (`sub1`):
      //   out = e1 == e2 ? e1 : max(e1 - oc, e2 - sc),
      // where oc is 0 for a row only self has dots in (p1, !p2) that keeps
      // whole (keep1: a dot the other's clock does not cover).  Both sides
      // present: common = e1 when equal, else 0, and the rule's
      // max(common, (e1 - common) - oc, (e2 - common) - sc) reduces to the
      // above.  Other side only: e1 == 0, so out = e2 - sc.  Self only:
      // e2 == 0, so out = keep1 ? e1 : 0 (oc = 0 keeps every dot; without
      // keep1 every dot is <= oc).  Neither: 0.  Two votes per slot.  The
      // plunger merges the accumulator with itself (e1 == e2 everywhere),
      // where the rule is the identity.  Survivors are counted before the
      // replay.
      int n_surv = 0;
      for (int u0 = 0; u0 < nu; u0 += 32) {
        const int cn = nu - u0 < 32 ? nu - u0 : 32;
        each_slot<UB>(u0, cn, [&](int u, int) {
          bool ne = false;
          if constexpr (SELF) {
            each_col<APL>(apl, A, lane, [&](int j, int) { ne |= acc.at(u, j) != ZERO; });
          } else {
            bool keep1 = false, p2 = false;
            each_col<APL>(apl, A, lane, [&](int j, int x) {
              keep1 |= acc.at(u, j) > crep(j, x);
              p2 |= e2(u, j, x) != ZERO;
            });
            const bool whole = orswot::warp_any(keep1) && !orswot::warp_any(p2);
            each_col<APL>(apl, A, lane, [&](int j, int x) {
              const int e1 = acc.at(u, j), e = e2(u, j, x), oc = whole ? ZERO : crep(j, x);
              const int v =
                  e1 == e ? e1 : orswot::imax(orswot::sub1(e1, oc), orswot::sub1(e, acc.clk(j)));
              acc.at(u, j) = v;
              ne |= v != ZERO;
            });
          }
          n_surv += orswot::warp_any(ne) ? 1 : 0;
        });
      }
      m_over |= n_surv > m_cap;
      if constexpr (!SELF)
        each_col<APL>(apl, A, lane, [&](int j, int x) {
          acc.clk(j) = orswot::imax(acc.clk(j), crep(j, x));
        });
      PHASE_MARK(SELF ? P_PLUNGER : P_RULE);

      if constexpr (REG) {
        // deferred union in registers: the accumulator's DM rows, then the
        // other side's, EMPTY-padded (padding is never live, so the order
        // of the real rows, and with it every rank, is that of the
        // concatenation).  For the plunger the second copy of each row is
        // a duplicate of the first and never live, so it is left out.
        constexpr int DN = 2 * DM;
        int cid[DN], crow[DN][NJ];
#pragma unroll
        for (int k = 0; k < DM; ++k) {
          cid[k] = dq_id[k];
          cid[DM + k] = EMPTY;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            crow[k][j] = dq_row[k][j];
            crow[DM + k][j] = ZERO;
          }
          if constexpr (!SELF) {
            if (k < D) {
              cid[DM + k] = st[un.dids + k];
              each_col<APL>(apl, A, lane,
                            [&](int j, int x) { crow[DM + k][j] = st[un.dclocks + k * A + x]; });
            }
          }
        }
        // keep-first dedup: one reduction carries every pair's "rows differ"
        unsigned diff = 0;
#pragma unroll
        for (int k = 1; k < DN; ++k)
#pragma unroll
          for (int i = 0; i < k; ++i) {
            bool d = false;
#pragma unroll
            for (int j = 0; j < NJ; ++j) d |= crow[i][j] != crow[k][j];
            diff |= (d ? 1u : 0u) << (i * DN + k);
          }
        diff = orswot::warp_or(diff);
        unsigned live = 0;
#pragma unroll
        for (int k = 0; k < DN; ++k) {
          bool lv = cid[k] != EMPTY;
#pragma unroll
          for (int i = 0; i < k; ++i) lv &= !(cid[i] == cid[k] && !((diff >> (i * DN + k)) & 1u));
          live |= (lv ? 1u : 0u) << k;
        }
        PHASE_MARK(SELF ? P_PLUNGER : P_DEDUP);
        // replay: the union slot each live row cites, by one ballot over
        // the lanes' union ids
        unsigned cite[DN], cited = 0;
#pragma unroll
        for (int k = 0; k < DN; ++k) {
          cite[k] = __ballot_sync(FULL, ((live >> k) & 1u) && my_uid == cid[k]);
          cited |= cite[k];
        }
        if (cited)
          each_slot<UB>(0, nu, [&](int u, int) {
            if (!((cited >> u) & 1u)) return;
            each_col<APL>(apl, A, lane, [&](int j, int) {
              int rm = ZERO;
#pragma unroll
              for (int k = 0; k < DN; ++k)
                if ((cite[k] >> u) & 1u) rm = orswot::imax(rm, crow[k][j]);
              acc.at(u, j) = orswot::sub1(acc.at(u, j), rm);
            });
          });
        PHASE_MARK(SELF ? P_PLUNGER : P_REPLAY);
        // retain live rows still ahead of the joined clock, first
        // occurrence first, into d_cap rows
        unsigned nc = 0;
#pragma unroll
        for (int k = 0; k < DN; ++k) {
          bool c = false;
#pragma unroll
          for (int j = 0; j < NJ; ++j) c |= crow[k][j] > acc.clk(j);
          nc |= (c ? 1u : 0u) << k;
        }
        unsigned rest = live & orswot::warp_or(nc);
        d_over |= __popc(rest) > d_cap;
#pragma unroll
        for (int i = 0; i < DM; ++i) {
          int src = -1;
          if (i < d_cap && rest) {
            src = __ffs(rest) - 1;
            rest &= rest - 1;
          }
          dq_id[i] = EMPTY;
#pragma unroll
          for (int j = 0; j < NJ; ++j) dq_row[i][j] = ZERO;
#pragma unroll
          for (int k = 0; k < DN; ++k)
            if (src == k) {
              dq_id[i] = cid[k];
#pragma unroll
              for (int j = 0; j < NJ; ++j) dq_row[i][j] = crow[k][j];
            }
        }
      } else {
        // deferred union: the accumulator's rows, then the other side's
        const int o_d = SELF ? acc_d : D;
        const int dn = acc_d + o_d;
        const int* o_rows = SELF ? s_drows : st + un.dclocks;
        const int* o_ids = SELF ? s_dids : st + un.dids;
        auto rows = [&](int k) { return k < acc_d ? s_drows + k * A : o_rows + (k - acc_d) * A; };
        for (int k = lane; k < dn; k += 32) s_cat[k] = k < acc_d ? s_dids[k] : o_ids[k - acc_d];
        __syncwarp();
        orswot::dedup_rows<0>(s_cat, s_dlive, dn, A, lane, rows);
        PHASE_MARK(SELF ? P_PLUNGER : P_DEDUP);

        // replay: subtract the join of the live rows citing each member;
        // a ballot names the slots any live row cites
        for (int u0 = 0; u0 < nu; u0 += 32) {
          const int cn = nu - u0 < 32 ? nu - u0 : 32;
          bool cited = false;
          if (u0 + lane < n_eff) {
            const int id = s_union[u0 + lane];
            for (int k = 0; k < dn; ++k) cited |= s_dlive[k] && s_cat[k] == id;
          }
          const unsigned cmask = __ballot_sync(FULL, cited);
          if (cmask == 0) continue;
          each_slot<UB>(u0, cn, [&](int u, int jj) {
            if (!((cmask >> jj) & 1u)) return;
            const int id = s_union[u];
            each_col<APL>(apl, A, lane, [&](int j, int x) {
              int rm = ZERO;
              for (int k = 0; k < dn; ++k)
                if (s_dlive[k] && s_cat[k] == id) rm = orswot::imax(rm, rows(k)[x]);
              acc.at(u, j) = orswot::sub1(acc.at(u, j), rm);
            });
          });
        }

        PHASE_MARK(SELF ? P_PLUNGER : P_REPLAY);

        // retain rows still ahead of the joined clock, compact to d_cap in
        // place: the row of rank i comes from slot k >= i, so no row is
        // overwritten before it is read (for the plunger the second copy of
        // each row is a duplicate, never live)
        for (int k = 0; k < dn; ++k) {
          bool ahead = false;
          if (s_dlive[k]) {
            const int* rk = rows(k);
            bool covered = true;
            each_col<APL>(apl, A, lane, [&](int j, int x) { covered &= rk[x] <= acc.clk(j); });
            ahead = !orswot::warp_all(covered);
          }
          if (lane == 0) s_ahead[k] = ahead ? 1 : 0;
        }
        __syncwarp();
        const int n_ahead = orswot::slot_ranks(s_ahead, s_drank, dn, lane);
        d_over |= n_ahead > d_cap;
        for (int i = 0; i < d_cap; ++i) {
          int src = -1;
          for (int k = 0; k < dn; ++k)
            if (s_ahead[k] && s_drank[k] == i) src = k;
          const int* rs = src >= 0 ? rows(src) : nullptr;
          for (int x = lane; x < A; x += 32) s_drows[i * A + x] = rs ? rs[x] : ZERO;
          if (lane == 0) s_dids[i] = src >= 0 ? s_cat[src] : EMPTY;
        }
        acc_d = d_cap;
        __syncwarp();
      }
      PHASE_MARK(SELF ? P_PLUNGER : P_RETAIN);
    };

    for (int r = 0; r < R; ++r) {
      stage::wait(&bars[cs], cpar);
      PHASE_MARK(P_WAIT);
      const int* st = w + L.stage + cs * un.total;
      const int* rid = s_ids + r * M;
      // union slot -> offset of replica r's row for it (the ZERO row if
      // none), lane-parallel over slots.  Union ids are distinct, so a
      // valid replica has at most one row per slot; several rows with one
      // id (an invalid replica) are joined into the first of them here,
      // as `_align_to_union`'s max does — no other slot reads them.
      const int row0 = L.stage + cs * un.total + un.dots;
      bool dirty = false;  // rows of this stage joined in place (an invalid replica)
      if (one_match(UB, M)) {
        // one match over the lanes: lanes 0..UB-1 hold the union ids,
        // lanes UB..UB+M-1 the replica's member ids; a union lane's peers
        // past UB are the rows carrying its id
        const int mi = lane - UB;
        const int v = lane < UB ? my_uid : (mi < M ? rid[mi] : EMPTY - 1);
        const unsigned rows_of = (__match_any_sync(FULL, v) >> UB) & ((1u << M) - 1u);
        const bool has = lane < n_eff && rows_of != 0;
        if (lane < UB) s_inv[lane] = has ? row0 + (__ffs(rows_of) - 1) * A : L.zero;
        __syncwarp();
        for (unsigned dups = __ballot_sync(FULL, has && (rows_of & (rows_of - 1)) != 0); dups;
             dups &= dups - 1) {
          dirty = true;
          const int ud = __ffs(dups) - 1;
          const unsigned more = __shfl_sync(FULL, rows_of, ud);
          int* keep = w + s_inv[ud];
          for (unsigned m = more & (more - 1); m; m &= m - 1)
            for (int x = lane; x < A; x += 32)
              keep[x] = orswot::imax(keep[x], w[row0 + (__ffs(m) - 1) * A + x]);
        }
      } else {
        for (int u0 = 0; u0 < nu; u0 += 32) {
          const int u = u0 + lane;
          int m = -1;
          bool dup = false;
          if (u < n_eff) {
            const int id = s_union[u];
            for (int k = 0; k < M; ++k)
              if (rid[k] == id) {
                dup |= m >= 0;
                if (m < 0) m = k;
              }
          }
          if (u < nu) s_inv[u] = m >= 0 ? row0 + m * A : L.zero;
          __syncwarp();
          for (unsigned dups = __ballot_sync(FULL, dup); dups; dups &= dups - 1) {
            dirty = true;
            const int ud = u0 + __ffs(dups) - 1;
            const int id = s_union[ud];
            int* keep = w + s_inv[ud];
            for (int k = 0; k < M; ++k)
              if (rid[k] == id && w + row0 + k * A != keep)
                for (int x = lane; x < A; x += 32)
                  keep[x] = orswot::imax(keep[x], w[row0 + k * A + x]);
          }
        }
        __syncwarp();
      }
      if (r == 0) {  // the accumulator starts as replica 0
        for (int u0 = 0; u0 < nu; u0 += 32) {
          const int cn = nu - u0 < 32 ? nu - u0 : 32;
          each_slot<UB>(u0, cn, [&](int u, int) {
            each_col<APL>(apl, A, lane, [&](int j, int x) { acc.at(u, j) = e2_at(u, x); });
          });
        }
        each_col<APL>(apl, A, lane, [&](int j, int x) { acc.clk(j) = st[un.clock + x]; });
        if constexpr (REG) {
#pragma unroll
          for (int k = 0; k < DM; ++k) {
            dq_id[k] = k < D ? st[un.dids + k] : EMPTY;
            each_col<APL>(apl, A, lane, [&](int j, int x) {
              dq_row[k][j] = ZERO;
              if (k < D) dq_row[k][j] = st[un.dclocks + k * A + x];
            });
          }
        } else {
          for (int k = lane; k < D; k += 32) s_dids[k] = st[un.dids + k];
          for (int i = lane; i < D * A; i += 32) s_drows[i] = st[un.dclocks + i];
        }
        acc_d = D;
        PHASE_MARK(P_ALIGN);
      } else {
        PHASE_MARK(P_ALIGN);
        step(std::false_type{}, st);
      }
      // rows joined in place: every lane orders its writes before the copy
      // engine's, then the stage is free for the unit STAGES ahead
      if (bulk && dirty) stage::fence_async();
      __syncwarp();
      int rn = r + STAGES;  // the unit STAGES ahead in this warp's stream
      long long on = obj;
      while (rn >= R) {
        rn -= R;
        on += stride;
      }
      issue_unit(cs, on, rn);
      if (++cs == STAGES) {
        cs = 0;
        cpar ^= 1u;
      }
      PHASE_MARK(P_ISSUE);
    }
    if (plunger) step(std::true_type{}, nullptr);

    // --- canonical compaction: ascending member id into m_cap slots ---
    // union ids are distinct, so live slots have distinct ranks: each
    // live slot of rank k < m_cap fills output slot k, and slots from the
    // live count up stay empty
    int* orows = od + obj * m_cap * A;
    for (int u0 = 0; u0 < nu; u0 += 32) {
      const int cn = nu - u0 < 32 ? nu - u0 : 32;
      each_slot<UB>(u0, cn, [&](int u, int) {
        bool ne = false;
        each_col<APL>(apl, A, lane, [&](int j, int) { ne |= acc.at(u, j) != ZERO; });
        ne = orswot::warp_any(ne);
        if (lane == 0) s_live[u] = ne ? 1 : 0;
      });
    }
    __syncwarp();
    int my_live = 0;
    for (int u = lane; u < nu; u += 32) {
      int rk = 0;
      if (s_live[u]) {
        const int key = s_union[u];
        for (int t = 0; t < n_eff; ++t) rk += (s_live[t] && s_union[t] < key) ? 1 : 0;
        if (rk < m_cap) oi[obj * m_cap + rk] = key;
        ++my_live;
      }
      s_rank[u] = rk;
    }
    const int n_live = __reduce_add_sync(FULL, my_live);
    for (int k = n_live + lane; k < m_cap; k += 32) oi[obj * m_cap + k] = EMPTY;
    __syncwarp();
    for (int u0 = 0; u0 < nu; u0 += 32) {
      const int cn = nu - u0 < 32 ? nu - u0 : 32;
      each_slot<UB>(u0, cn, [&](int u, int) {
        const int rk = s_rank[u];
        if (!s_live[u] || rk >= m_cap) return;
        each_col<APL>(apl, A, lane, [&](int j, int x) { orows[rk * A + x] = acc.at(u, j); });
      });
    }
    for (int k = n_live; k < m_cap; ++k)
      for (int x = lane; x < A; x += 32) orows[k * A + x] = ZERO;
    each_col<APL>(apl, A, lane, [&](int j, int x) { oc[obj * A + x] = acc.clk(j); });
    if constexpr (REG) {
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < d_cap) {
          if (lane == 0) odi[obj * d_cap + k] = dq_id[k];
          each_col<APL>(apl, A, lane,
                        [&](int j, int x) { odc[(obj * d_cap + k) * A + x] = dq_row[k][j]; });
        }
    } else {
      for (int k = lane; k < d_cap; k += 32) odi[obj * d_cap + k] = s_dids[k];
      for (int i = lane; i < d_cap * A; i += 32) odc[obj * d_cap * A + i] = s_drows[i];
    }
    if (lane == 0) {
      over[2 * obj] = m_over ? 1 : 0;
      over[2 * obj + 1] = d_over ? 1 : 0;
    }
    PHASE_MARK(P_STORE);
  }
  PHASE_FLUSH(lane);
}

// Which instantiation takes these widths: the accumulator in registers at
// the north-star widths (A = 64, two actors per lane; u_cap <= 16; at most
// DM deferred rows per side), in shared memory otherwise.  (Register instantiations for 32 union slots
// or A = 32 spilled under ptxas, so those widths take shared memory.)
struct Plan {
  int ub, apl;
};
inline Plan plan_for(int A, int U, int D, int d_cap) {
  return A == 64 && U <= 16 && D <= DM && d_cap <= DM ? Plan{16, 2} : Plan{0, 0};
}

inline size_t per_warp_bytes(Plan p, int A, int D, int d_cap, int U, int R, int M) {
  return (size_t)layout(p.ub ? p.ub : U, A, D, d_cap, R, M, p.ub == 0).total * sizeof(int);
}

inline bool bulk_route(const void* clock, const void* ids, const void* dots,
                       const void* dclocks, int A, int M, int D) {
  return stage::bulk_ok(clock, A) && stage::bulk_ok(ids, M) &&
         stage::bulk_ok(dots, (long long)M * A) && stage::bulk_ok(dclocks, (long long)D * A);
}

template <int UB, int APL>
int launch(const void* clock, const void* ids, const void* dots, const void* dids,
           const void* dclocks, void* oc, void* oi, void* od, void* odi, void* odc, void* over,
           int R, long long n, int A, int M, int D, int m_cap, int d_cap, int U, int plunger,
           int bulk, void* stream) {
  auto kernel = orswot_fold_aligned_kernel<UB, APL>;
  const size_t per_warp = per_warp_bytes(Plan{UB, APL}, A, D, d_cap, U, R, M);
  stage::Grid g;
  const cudaError_t err = stage::persistent_grid(kernel, per_warp, MAX_WARPS, n, &g);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g.blocks, g.warps * 32, g.smem, (cudaStream_t)stream>>>(
      (const int*)clock, (const int*)ids, (const int*)dots, (const int*)dids,
      (const int*)dclocks, (int*)oc, (int*)oi, (int*)od, (int*)odi, (int*)odc, (int*)over,
      R, n, A, M, D, m_cap, d_cap, U, plunger, bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes one object's warp needs (the wrapper refuses shapes
// above the card's per-block limit before launching).
extern "C" long long orswot_fold_aligned_smem_per_warp(int A, int D, int d_cap, int U, int R,
                                                       int M, int m_cap) {
  (void)m_cap;
  return (long long)per_warp_bytes(plan_for(A, U, D, d_cap), A, D, d_cap, U, R, M);
}

// The instantiation, alignment path and copy route a launch with these
// arguments takes: 10000 * (1 one __match_any_sync per replica for the
// alignment map, 0 the lane-parallel scan) + 100 * (union slots in
// registers, 0 for shared memory) + 10 * (actors per lane, 0 for shared
// memory) + (1 bulk copies, 0 per-lane cp.async).
extern "C" int orswot_fold_aligned_plan(const void* clock, const void* ids, const void* dots,
                                        const void* dclocks, int A, int M, int D, int d_cap,
                                        int U) {
  const Plan p = plan_for(A, U, D, d_cap);
  return 10000 * one_match(p.ub, M) + 100 * p.ub + 10 * p.apl +
         (bulk_route(clock, ids, dots, dclocks, A, M, D) ? 1 : 0);
}

extern "C" int orswot_fold_aligned_launch(
    const void* clock, const void* ids, const void* dots, const void* dids,
    const void* dclocks, void* oc, void* oi, void* od, void* odi, void* odc, void* over,
    int R, long long n, int A, int M, int D, int m_cap, int d_cap, int U, int plunger,
    void* stream) {
  if (n <= 0) return 0;
  const int bulk = bulk_route(clock, ids, dots, dclocks, A, M, D) ? 1 : 0;
  const Plan p = plan_for(A, U, D, d_cap);
#define ORSWOT_K1_LAUNCH(UB, APL)                                                            \
  return launch<UB, APL>(clock, ids, dots, dids, dclocks, oc, oi, od, odi, odc, over, R, n, A, \
                         M, D, m_cap, d_cap, U, plunger, bulk, stream)
  if (p.ub == 16) ORSWOT_K1_LAUNCH(16, 2);
  ORSWOT_K1_LAUNCH(0, 0);
#undef ORSWOT_K1_LAUNCH
}
