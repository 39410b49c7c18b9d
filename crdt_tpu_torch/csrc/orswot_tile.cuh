// Per-object ORSWOT device functions: the vocabulary of all three
// kernels (views, votes, the biased-counter operations, the loops over a
// lane's actor columns, the deferred-table dedup, rank and pack), and
// merge_object — the first design's merge straight from device memory,
// which only the direct routes of K2 and K3 still take (widths whose
// stages exceed shared memory).  The staged merge is in
// orswot_merge_body.cuh.
//
// One warp owns one object.  The actor axis (A) is strided over the 32
// lanes: lane l owns actors l, l+32, l+64, ...  Reductions over actors
// (`_nonempty`, `_all`, "any novel dot") are warp votes.  The small
// slot axes (member ids, deferred ids, ranks) are walked by every lane
// in the same order, on values kept in a per-warp scratch area of
// shared memory, so every branch on them is warp-uniform.
//
// Counters are biased int32 (`x ^ 0x8000_0000`, order-preserving), so
// counter 0 is INT_MIN (ZERO below) and every counter operation of the
// merge is a signed compare, max or select — exact over the full uint32
// range.  Member ids are int32 with EMPTY = -1.
//
// Semantics follow `orswot.rs:89-156` as the JAX package's
// `crdt_tpu/ops/orswot_pallas.py::_merge_tile` computes them, including
// its corner cases (duplicate live keys sum their ids and max their
// clocks in the rank selection, exactly as the one-hot masked reductions
// there do).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace orswot {

constexpr int EMPTY = -1;
constexpr int ZERO = INT_MIN;  // biased counter 0
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int sub1(int a, int b) { return a > b ? a : ZERO; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ bool warp_any(bool p) { return __any_sync(FULL, p) != 0; }
__device__ __forceinline__ bool warp_all(bool p) { return __all_sync(FULL, p) != 0; }
// OR of a few per-lane flag bits across the warp, in one reduction
__device__ __forceinline__ unsigned warp_or(unsigned bits) {
  return __reduce_or_sync(FULL, bits);
}

// Read-only view of one object's state.  Rows are A counters long.
struct StateView {
  const int* clock;     // [A]
  const int* ids;       // [M]
  const int* dots;      // [M][A]
  const int* d_ids;     // [D]
  const int* d_clocks;  // [D][A]
  int M;
  int D;
};

// Output slots of one object.
struct OutView {
  int* clock;     // [A]
  int* ids;       // [m_cap]
  int* dots;      // [m_cap][A]
  int* d_ids;     // [d_cap]
  int* d_clocks;  // [d_cap][A]
};

// The three-way dot rule (`orswot.rs:92-138`) for one actor lane of a
// member row: e1 = self's dot, e2 = other's aligned dot, sc / oc = the
// self / other set clocks at that actor.  p1, p2, keep1 are the row's
// warp-reduced flags.
__device__ __forceinline__ int dot_rule(int e1, int e2, int sc, int oc,
                                        bool p1, bool p2, bool keep1) {
  if (p1 && p2) {
    const int common = (e1 == e2) ? e1 : ZERO;
    const int c1 = sub1(sub1(e1, common), oc);
    const int c2 = sub1(sub1(e2, common), sc);
    return imax(common, imax(c1, c2));
  }
  if (p1) return keep1 ? e1 : ZERO;
  return sub1(e2, sc);
}

// Scratch ints one warp needs for merge_object with these table sizes.
__host__ __device__ inline int merge_scratch_ints(int Ma, int Mb, int Da, int Db, int A) {
  return 5 * (Ma + Mb) + 3 * (Da + Db) + 2 * A;
}


// Deferred row k of the union of a's and b's deferred tables.
__device__ __forceinline__ const int* drow(const StateView& a, const StateView& b,
                                           int k, int A) {
  return k < a.D ? a.d_clocks + (long long)k * A
                 : b.d_clocks + (long long)(k - a.D) * A;
}

// f(x) for this lane's actor columns x = lane + 32 j < A: APL columns per
// lane at compile time, or a loop over run-time A (APL = 0).
template <int APL, typename F>
__device__ __forceinline__ void each_col(int A, int lane, F&& f) {
  if constexpr (APL > 0) {
#pragma unroll
    for (int j = 0; j < APL; ++j) f(lane + 32 * j);
  } else {
    for (int x = lane; x < A; x += 32) f(x);
  }
}

// f(j, x) for the same columns, with j the column's index in this lane
// (always 0 at run-time A).
template <int APL, typename F>
__device__ __forceinline__ void each_jx(int A, int lane, F&& f) {
  if constexpr (APL > 0) {
#pragma unroll
    for (int j = 0; j < APL; ++j) f(j, lane + 32 * j);
  } else {
    for (int x = lane; x < A; x += 32) f(0, x);
  }
}

// Dedup the concatenated deferred ids (keep first of equal (id, clock)
// rows, `orswot.rs:141-148`): writes d_live[k] for k < dn.  `rows(k)`
// returns row k.
template <int APL, typename RowFn>
__device__ __forceinline__ void dedup_rows(const int* did, int* d_live, int dn, int A, int lane,
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
        dup = warp_all(eq);
      }
    }
    if (lane == 0) d_live[k] = (id != EMPTY && !dup) ? 1 : 0;
  }
  __syncwarp();
}

// Exclusive running count of flags[k] over k < n into rank[k] (slot
// order); returns the total.  Every lane computes the same values; lane 0
// writes them.
__device__ __forceinline__ int slot_ranks(const int* flags, int* rank, int n, int lane) {
  int run = 0;
  for (int k = 0; k < n; ++k) {
    if (lane == 0) rank[k] = run;
    run += flags[k];
  }
  __syncwarp();
  return run;
}

// The flagged rows, in slot order, into d_cap output rows (the rest
// empty); returns the flagged count.
template <int APL, typename RowFn>
__device__ __forceinline__ int pack_rows(const int* flags, const int* src_ids, int n,
                                         int* out_ids, int* out_rows, int d_cap, int A, int lane,
                                         RowFn rows) {
  int taken = 0;
  for (int k = 0; k < n && taken < d_cap; ++k) {
    if (!flags[k]) continue;
    if (lane == 0) out_ids[taken] = src_ids[k];
    const int* r = rows(k);
    int* o = out_rows + (long long)taken * A;
    each_col<APL>(A, lane, [&](int x) { o[x] = r[x]; });
    ++taken;
  }
  for (int k = taken; k < d_cap; ++k) {
    if (lane == 0) out_ids[k] = EMPTY;
    int* o = out_rows + (long long)k * A;
    each_col<APL>(A, lane, [&](int x) { o[x] = ZERO; });
  }
  int count = 0;
  for (int k = 0; k < n; ++k) count += flags[k];
  return count;
}

// Pairwise merge of one object: `_merge_tile` of orswot_pallas.py.
// Member alignment, the dot rule, deferred union + dedup, clock join,
// deferred replay, retention of still-ahead rows, then compaction:
// members by ascending id into m_cap slots, deferred rows in
// first-occurrence order into d_cap slots.  Returns the overflow flags
// (bit 0 members, bit 1 deferred).  `o` must not alias `a` or `b`.
// `scratch` holds merge_scratch_ints(...) ints private to this warp.
__device__ int merge_object(const StateView a, const StateView b, const OutView o,
                            int A, int m_cap, int d_cap, int* scratch, int lane) {
  const int Ma = a.M, Mb = b.M, S = Ma + Mb, dn = a.D + b.D;
  int* s_id = scratch;        // [S]  ids_cat (EMPTY where not a candidate)
  int* s_jm = s_id + S;       // [S]  a-slot's matching b-slot: -1 none, -2 several
  int* s_flag = s_jm + S;     // [S]  bit0 p1, bit1 p2, bit2 keep1
  int* s_live = s_flag + S;   // [S]  survives the replay
  int* s_rank = s_live + S;   // [S]  rank among live slots by id
  int* s_did = s_rank + S;    // [dn] deferred ids, a's rows then b's
  int* s_dlive = s_did + dn;  // [dn] valid and not a duplicate
  int* s_ahead = s_dlive + dn;  // [dn] still ahead of the joined clock
  int* s_ca = s_ahead + dn;     // [A]  a's clock, each lane its own columns
  int* s_cb = s_ca + A;         // [A]  b's clock

  // --- member alignment: a's slots, then b's slots no a-slot matched ---
  for (int s = lane; s < Ma; s += 32) s_id[s] = a.ids[s];
  for (int k = lane; k < dn; k += 32) s_did[k] = k < a.D ? a.d_ids[k] : b.d_ids[k - a.D];
  __syncwarp();
  for (int j = lane; j < Mb; j += 32) {
    const int id = b.ids[j];
    bool matched = false;
    for (int i = 0; i < Ma; ++i) matched |= (s_id[i] != EMPTY && s_id[i] == id);
    s_id[Ma + j] = (id != EMPTY && !matched) ? id : EMPTY;
  }
  for (int i = lane; i < Ma; i += 32) {
    const int id = s_id[i];
    int jm = -1;
    if (id != EMPTY)
      for (int j = 0; j < Mb; ++j)
        if (b.ids[j] == id) jm = jm == -1 ? j : -2;
    s_jm[i] = jm;
  }
  __syncwarp();

  // --- deferred union + dedup, keep first (`orswot.rs:141-148`) ---
  auto rows = [&](int k) { return drow(a, b, k, A); };
  dedup_rows<0>(s_did, s_dlive, dn, A, lane, rows);

  // --- clock join (`orswot.rs:153`); rows still ahead of it ---
  for (int x = lane; x < A; x += 32) {
    s_ca[x] = a.clock[x];
    s_cb[x] = b.clock[x];
    o.clock[x] = imax(s_ca[x], s_cb[x]);
  }
  for (int k = 0; k < dn; ++k) {
    bool ahead = false;
    if (s_dlive[k]) {
      const int* r = rows(k);
      bool covered = true;
      for (int x = lane; x < A; x += 32) covered &= (r[x] <= imax(s_ca[x], s_cb[x]));
      ahead = !warp_all(covered);
    }
    if (lane == 0) s_ahead[k] = ahead ? 1 : 0;
  }
  __syncwarp();

  // the aligned other-side dot of a-slot i at actor x: the matching b
  // row's (ids are unique per side in valid state); several matching
  // rows take `_align_against`'s max over all of them
  auto e2_at = [&](int i, int x) {
    const int jm = s_jm[i];
    if (jm >= 0) return b.dots[(long long)jm * A + x];
    int e2 = ZERO;
    if (jm == -2)
      for (int j = 0; j < Mb; ++j)
        if (b.ids[j] == s_id[i]) e2 = imax(e2, b.dots[(long long)j * A + x]);
    return e2;
  };
  // join of the live deferred clocks citing `id`, at actor x
  auto rm_at = [&](int id, int x) {
    int rm = ZERO;
    for (int k = 0; k < dn; ++k)
      if (s_dlive[k] && s_did[k] == id) rm = imax(rm, rows(k)[x]);
    return rm;
  };
  // slot s's member dot after the rule and the replay (`orswot.rs:155`)
  auto slot_dot = [&](int s, int x, int flags) {
    const int id = s_id[s];
    int v;
    if (s < Ma) {
      v = dot_rule(a.dots[(long long)s * A + x], e2_at(s, x), s_ca[x], s_cb[x],
                   flags & 1, flags & 2, flags & 4);
    } else {
      v = sub1(b.dots[(long long)(s - Ma) * A + x], s_ca[x]);
    }
    return sub1(v, rm_at(id, x));
  };

  // --- dot rule + replay per slot; survivors are the non-empty rows ---
  for (int s = 0; s < S; ++s) {
    const int id = s_id[s];
    int flags = 0;
    bool live = false;
    if (id != EMPTY) {
      if (s < Ma) {
        // p1 (any dot), p2 (any aligned dot), keep1 (a dot other's clock
        // does not cover), reduced over the actor axis in one go
        unsigned bits = 0;
        for (int x = lane; x < A; x += 32) {
          const int e1 = a.dots[(long long)s * A + x];
          bits |= (e1 != ZERO ? 1u : 0u) | (e2_at(s, x) != ZERO ? 2u : 0u) |
                  (e1 <= s_cb[x] ? 0u : 4u);
        }
        flags = (int)warp_or(bits);
      }
      bool ne = false;
      for (int x = lane; x < A; x += 32) ne |= slot_dot(s, x, flags) != ZERO;
      live = warp_any(ne);
    }
    if (lane == 0) {
      s_flag[s] = flags;
      s_live[s] = live ? 1 : 0;
    }
  }
  __syncwarp();

  // --- canonical compaction: rank by ascending id among live slots ---
  for (int s = lane; s < S; s += 32) {
    int r = 0;
    if (s_live[s]) {
      const int key = s_id[s];
      for (int t = 0; t < S; ++t) r += (s_live[t] && s_id[t] < key) ? 1 : 0;
    }
    s_rank[s] = r;
  }
  __syncwarp();
  int n_live = 0;
  for (int s = 0; s < S; ++s) n_live += s_live[s];
  for (int k = 0; k < m_cap; ++k) {
    int first = -1, count = 0, idsum = 0;
    for (int s = 0; s < S; ++s) {
      if (s_live[s] && s_rank[s] == k) {
        if (first < 0) first = s;
        ++count;
        idsum += s_id[s] + 1;
      }
    }
    if (lane == 0) o.ids[k] = idsum - 1;
    int* orow = o.dots + (long long)k * A;
    for (int x = lane; x < A; x += 32) {
      int v = ZERO;
      if (count == 1) {
        v = slot_dot(first, x, s_flag[first]);
      } else if (count > 1) {
        for (int s = first; s < S; ++s)
          if (s_live[s] && s_rank[s] == k) v = imax(v, slot_dot(s, x, s_flag[s]));
      }
      orow[x] = v;
    }
  }

  // --- deferred rows still ahead, first-occurrence order, into d_cap ---
  const int n_ahead = pack_rows<0>(s_ahead, s_did, dn, o.d_ids, o.d_clocks, d_cap, A, lane, rows);
  __syncwarp();
  return (n_live > m_cap ? 1 : 0) | (n_ahead > d_cap ? 2 : 0);
}

}  // namespace orswot

// Each kernel's shared library exports this beside its launcher, so the
// Python wrapper can name the error a launcher returned.
extern "C" const char* orswot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
