// The staged per-object ORSWOT merge that K2 (orswot_merge.cu) and K3
// (orswot_fold.cu) share: one warp merges one object whose two sides sit
// in the warp's shared memory, into an output that lies in device memory
// (K2, K3's last step) or in shared memory (K3's accumulator).
//
// Steps, as `_merge_tile` of crdt_tpu/ops/orswot_pallas.py orders them:
//
// * member alignment — one __match_any_sync when Ma + Mb <= 32 (a's ids
//   in lanes 0..Ma-1, b's in the lanes after them), else lane-parallel
//   loops over the id planes;
// * keep-first dedup of the deferred union, the clock join and the rows
//   still ahead of it;
// * the dot rule and the deferred replay, each valid slot's merged row
//   computed once and written over its own input row (an a-slot's row is
//   read only by that slot, a b-only slot's row only by that slot, and
//   the b rows a-slots match are never b-only), then read from there for
//   liveness and output.  The valid slots are walked by ballot, their ids
//   shuffled from the lane that holds them; at compile-time A the set
//   clocks and the slot's row and aligned dot sit in registers;
// * compaction by inverted rank, ranks and stores walked by ballot: each
//   live slot writes its own output slot.  Two live slots with one id
//   (possible only when a side is already invalid) are found with one
//   vote, and that object alone takes the exact rule of `_merge_tile`'s
//   `_select` (ids summed as id + 1, rows maxed).
//
// The sides' member rows are written in place, so a caller whose copy
// engine refills a side's stage next orders those writes first
// (`stage::fence_async` on every lane, then the warp sync).  The output
// must not alias either side; a self-merge (a = b) passes a copy as b.
#pragma once

#include "orswot_stage.cuh"
#include "orswot_tile.cuh"

namespace staged {

using orswot::each_col;
using orswot::each_jx;
using orswot::EMPTY;
using orswot::FULL;
using orswot::ZERO;
using stage::pad4;

// One side's slice of one object in shared memory (int offsets).
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

// A side laid out by side_layout(A, M, D) at `base`; its member rows are
// written in place by the merge.
struct SideView {
  const int* clock;
  const int* ids;
  int* dots;
  const int* dclocks;
  const int* dids;
  int M, D;
};
__device__ __forceinline__ SideView side_at(int* base, int A, int M, int D) {
  const Side s = side_layout(A, M, D);
  return SideView{base + s.clock, base + s.ids, base + s.dots, base + s.dclocks, base + s.dids,
                  M, D};
}

// An output laid out by side_layout(A, m_cap, d_cap) at `base`.
__device__ __forceinline__ orswot::OutView out_at(int* base, int A, int m_cap, int d_cap) {
  const Side s = side_layout(A, m_cap, d_cap);
  return orswot::OutView{base + s.clock, base + s.ids, base + s.dots, base + s.dids,
                         base + s.dclocks};
}

// The id-plane scratch of one merge (int offsets), for sides of at most
// Ma and Mb member rows and Da and Db deferred rows.
struct Scratch {
  int id, jm, live, rank, did, dlive, ahead, total;
};
__host__ __device__ inline Scratch scratch_layout(int Ma, int Mb, int Da, int Db) {
  const int S = Ma + Mb, dn = Da + Db;
  Scratch X;
  int o = 0;
  X.id = o;  // [S] candidate ids: a's slots, then b's unmatched
  o += pad4(S);
  X.jm = o;  // [Ma] an a-slot's matching b-slot: -1 none, -2 several
  o += pad4(Ma);
  X.live = o;  // [S] survives the replay
  o += pad4(S);
  X.rank = o;  // [S] rank among live slots by id
  o += pad4(S);
  X.did = o;  // [dn] deferred ids, a's rows then b's
  o += pad4(dn);
  X.dlive = o;
  o += pad4(dn);
  X.ahead = o;
  o += pad4(dn);
  X.total = o;
  return X;
}

// Whether the member alignment is one __match_any_sync (a's ids in lanes
// 0..Ma-1, b's in the lanes after them) rather than the lane-parallel loops.
__host__ __device__ inline bool one_match(int Ma, int Mb) {
  return Ma + Mb <= 32 && Ma < 32 && Mb < 32;
}

// The merge's phases, for a caller that times them (`marks.mark(p)` at
// the end of each; K3's -DORSWOT_PHASE_CLOCKS build); NoMarks compiles to
// nothing.
enum MergePhase { MP_ALIGN, MP_DEDUP, MP_RULE, MP_RANK, MP_STORE, MP_PACK, MP_N };
struct NoMarks {
  __device__ __forceinline__ void mark(int) {}
};

// Pairwise merge of one object from two staged sides into `o`, with the
// id-plane scratch at `scratch` (offsets X, sized for these sides).
// Returns the overflow flags (bit 0 members, bit 1 deferred).  The last
// writes to `o` are not yet synced across the warp.
template <int APL, typename Marks>
__device__ __forceinline__ int merge(const SideView& a, const SideView& b,
                                     const orswot::OutView& o, int A_rt, int m_cap, int d_cap,
                                     int* scratch, const Scratch& X, int lane, Marks&& marks) {
  const int A = APL > 0 ? 32 * APL : A_rt;
  const int Ma = a.M, Mb = b.M, Da = a.D, Db = b.D;
  const int S = Ma + Mb, dn = Da + Db;
  int* s_id = scratch + X.id;
  int* s_jm = scratch + X.jm;
  int* s_live = scratch + X.live;
  int* s_rank = scratch + X.rank;
  int* s_did = scratch + X.did;
  int* s_dlive = scratch + X.dlive;
  int* s_ahead = scratch + X.ahead;
  const int* a_clock = a.clock;
  const int* a_ids = a.ids;
  int* a_dots = a.dots;
  const int* a_dcl = a.dclocks;
  const int* b_clock = b.clock;
  const int* b_ids = b.ids;
  int* b_dots = b.dots;
  const int* b_dcl = b.dclocks;

  // --- member alignment: a's slots, then b's slots no a-slot matched ---
  for (int k = lane; k < dn; k += 32) s_did[k] = k < Da ? a.dids[k] : b.dids[k - Da];
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
  marks.mark(MP_ALIGN);

  // --- deferred union + dedup, keep first (`orswot.rs:141-148`) ---
  auto rows = [&](int k) { return k < Da ? a_dcl + k * A : b_dcl + (k - Da) * A; };
  orswot::dedup_rows<APL>(s_did, s_dlive, dn, A, lane, rows);

  // --- clock join (`orswot.rs:153`); rows still ahead of it ---
  // At compile-time A this lane's columns of both set clocks stay in
  // registers for the rest of the merge.
  constexpr int NJ = APL > 0 ? APL : 1;
  int ac[NJ], bc[NJ];
  if constexpr (APL > 0) {
#pragma unroll
    for (int j = 0; j < APL; ++j) {
      ac[j] = a_clock[lane + 32 * j];
      bc[j] = b_clock[lane + 32 * j];
    }
  }
  auto a_clk = [&](int j, int x) {
    if constexpr (APL > 0) return ac[j];
    else return a_clock[x];
  };
  auto b_clk = [&](int j, int x) {
    if constexpr (APL > 0) return bc[j];
    else return b_clock[x];
  };
  each_jx<APL>(A, lane,
               [&](int j, int x) { o.clock[x] = orswot::imax(a_clk(j, x), b_clk(j, x)); });
  for (int k = 0; k < dn; ++k) {
    bool ahead = false;
    if (s_dlive[k]) {
      const int* r = rows(k);
      bool covered = true;
      each_jx<APL>(A, lane, [&](int j, int x) {
        covered &= r[x] <= orswot::imax(a_clk(j, x), b_clk(j, x));
      });
      ahead = !orswot::warp_all(covered);
    }
    if (lane == 0) s_ahead[k] = ahead ? 1 : 0;
  }
  marks.mark(MP_DEDUP);

  auto slot_row = [&](int s) { return s < Ma ? a_dots + s * A : b_dots + (s - Ma) * A; };

  // --- dot rule + replay, once per slot, over its own row; survivors
  // are the non-empty rows.  32 slots at a time: each lane holds one
  // slot's id and matching b-slot, and the warp walks the valid slots of
  // the chunk by their ballot ---
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int sn = S - s0 < 32 ? S - s0 : 32;
    const int my_id = lane < sn ? s_id[s0 + lane] : EMPTY;
    const int my_jm = s0 + lane < Ma ? s_jm[s0 + lane] : -1;
    // the chunk's slots that a live deferred row cites
    bool cited = false;
    if (my_id != EMPTY)
      for (int k = 0; k < dn; ++k) cited |= s_dlive[k] && s_did[k] == my_id;
    const unsigned cmask = __ballot_sync(FULL, cited);
    unsigned ml = 0;
    for (unsigned todo = __ballot_sync(FULL, my_id != EMPTY); todo; todo &= todo - 1) {
      const int jj = __ffs(todo) - 1;
      const int s = s0 + jj;
      const int id = __shfl_sync(FULL, my_id, jj);
      const int jm = __shfl_sync(FULL, my_jm, jj);
      int* row = slot_row(s);
      // the aligned other-side dot of this a-slot at actor x: the matching
      // b row's (ids are unique per side in valid state); several matching
      // rows take `_align_against`'s max over all of them
      auto e2 = [&](int x) {
        if (jm >= 0) return b_dots[jm * A + x];
        int e = ZERO;
        if (jm == -2)
          for (int j = 0; j < Mb; ++j)
            if (b_ids[j] == id) e = orswot::imax(e, b_dots[j * A + x]);
        return e;
      };
      // this lane's columns of the slot's row and aligned dot: held in
      // registers across both passes at compile-time A, else re-read
      int r1[NJ], r2[NJ];
      if constexpr (APL > 0) {
#pragma unroll
        for (int j = 0; j < APL; ++j) {
          r1[j] = row[lane + 32 * j];
          r2[j] = s < Ma ? e2(lane + 32 * j) : ZERO;
        }
      }
      auto e1_at = [&](int j, int x) {
        if constexpr (APL > 0) return r1[j];
        else return row[x];
      };
      auto e2_at = [&](int j, int x) {
        if constexpr (APL > 0) return r2[j];
        else return e2(x);
      };
      // the dot rule (`orswot.rs:92-138`) in the closed form K1 uses
      // (orswot_fold_aligned.cu): out = e1 == e2 ? e1 : max(e1 - oc,
      // e2 - sc), with oc = 0 for an a-row the other side lacks that
      // keeps whole; b-only rows take e2 - sc
      bool whole = false;
      if (s < Ma) {
        bool keep1 = false, p2 = false;
        each_jx<APL>(A, lane, [&](int j, int x) {
          keep1 |= e1_at(j, x) > b_clk(j, x);
          p2 |= e2_at(j, x) != ZERO;
        });
        whole = orswot::warp_any(keep1) && !orswot::warp_any(p2);
      }
      const bool is_cited = (cmask >> jj) & 1u;
      bool ne = false;
      each_jx<APL>(A, lane, [&](int j, int x) {
        const int e1 = e1_at(j, x);
        int v;
        if (s < Ma) {
          const int e = e2_at(j, x), oc = whole ? ZERO : b_clk(j, x);
          v = e1 == e ? e1 : orswot::imax(orswot::sub1(e1, oc), orswot::sub1(e, a_clk(j, x)));
        } else {
          v = orswot::sub1(e1, a_clk(j, x));
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
  marks.mark(MP_RULE);

  // --- canonical compaction: rank by ascending id among live slots.
  // Each lane ranks its slot of a chunk against the live slots of every
  // chunk, walked by ballot with their ids shuffled across the lanes ---
  int n_live = 0;
  bool dup = false;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const bool mine = c0 + lane < S && s_live[c0 + lane];
    const int key = mine ? s_id[c0 + lane] : EMPTY;
    int r = 0, same = 0;
    for (int t0 = 0; t0 < S; t0 += 32) {
      const bool live_t = t0 + lane < S && s_live[t0 + lane];
      const int id_t = live_t ? s_id[t0 + lane] : EMPTY;
      for (unsigned m = __ballot_sync(FULL, live_t); m; m &= m - 1) {
        const int other = __shfl_sync(FULL, id_t, __ffs(m) - 1);
        r += other < key ? 1 : 0;
        same += other == key ? 1 : 0;
      }
    }
    if (c0 + lane < S) s_rank[c0 + lane] = r;
    n_live += __popc(__ballot_sync(FULL, mine));
    dup |= mine && same > 1;
  }
  __syncwarp();
  int* orows = o.dots;
  const bool any_dup = orswot::warp_any(dup);
  marks.mark(MP_RANK);
  if (!any_dup) {
    // live slots have distinct ranks 0..n_live-1: each of rank below
    // m_cap writes its id and row to its own output slot, and the slots
    // from n_live up are empty
    for (int c0 = 0; c0 < S; c0 += 32) {
      const bool mine = c0 + lane < S && s_live[c0 + lane];
      const int rk = mine ? s_rank[c0 + lane] : m_cap;
      if (rk < m_cap) o.ids[rk] = s_id[c0 + lane];
      for (unsigned m = __ballot_sync(FULL, rk < m_cap); m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        const int k = __shfl_sync(FULL, rk, t);
        const int* row = slot_row(c0 + t);
        each_col<APL>(A, lane, [&](int x) { orows[k * A + x] = row[x]; });
      }
    }
    for (int k = n_live + lane; k < m_cap; k += 32) o.ids[k] = EMPTY;
    for (int k = n_live; k < m_cap; ++k)
      each_col<APL>(A, lane, [&](int x) { orows[k * A + x] = ZERO; });
  } else {
    // `_select` of `_merge_tile`: output slot k takes every live slot of
    // rank k, ids summed as id + 1, rows maxed
    for (int k = 0; k < m_cap; ++k) {
      int first_s = -1, idsum = 0;
      for (int s = 0; s < S; ++s)
        if (s_live[s] && s_rank[s] == k) {
          if (first_s < 0) first_s = s;
          idsum += s_id[s] + 1;
        }
      if (lane == 0) o.ids[k] = idsum - 1;
      each_col<APL>(A, lane, [&](int x) {
        int v = ZERO;
        if (first_s >= 0)
          for (int s = first_s; s < S; ++s)
            if (s_live[s] && s_rank[s] == k) v = orswot::imax(v, slot_row(s)[x]);
        orows[k * A + x] = v;
      });
    }
  }

  marks.mark(MP_STORE);

  // --- deferred rows still ahead, first-occurrence order, into d_cap ---
  const int n_ahead =
      orswot::pack_rows<APL>(s_ahead, s_did, dn, o.d_ids, o.d_clocks, d_cap, A, lane, rows);
  marks.mark(MP_PACK);
  return (n_live > m_cap ? 1 : 0) | (n_ahead > d_cap ? 2 : 0);
}

}  // namespace staged
