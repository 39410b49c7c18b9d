// wire_ingest — bulk wire codec: blobs straight into dense planes and
// dense planes straight back to blobs, on the host.
//
// The port's own copy of the JAX package's native codec legs for ORSWOT,
// MVReg, LWWReg, GSet, VClock/GCounter and PNCounter
// (crdt_tpu_torch imports nothing of that package).  The wire format is
// the framework's serde codec (crdt_tpu_torch/utils/serde.py, a
// deterministic varint/tag format — deliberately NOT the reference's
// bincode): states arrive and leave as byte blobs.  Decoding them one by
// one into scalar objects and packing those is three orders of magnitude
// too slow for fleet-sized rounds, so this translation unit parses the
// blobs IN PARALLEL directly into the dense planes, and encodes planes
// back to blobs byte-identical to ``to_binary`` — no Python objects.
//
// Fast-path grammar (the subset covering integer actors/members — the
// dense batches' native domain; any blob outside it is flagged for the
// Python fallback, never mis-parsed):
//
//   ORSWOT    := 0x26 clock_body entries deferred
//   clock_body:= uv n, n * pair
//   pair      := 0x03 uv zz(actor) 0x03 uv zz(counter)
//   entries   := uv n, n * ( 0x03 uv zz(member) 0x20 clock_body )
//   deferred  := uv n, n * ( clock_key uv m, m * (0x03 uv zz(member)) )
//   clock_key := 0x08 uv k, k * ( 0x08 uv(2) 0x03 uv zz(actor)
//                                            0x03 uv zz(counter) )
//
// (uv = unsigned LEB128 varint, zz = zigzag; tags from serde.py: 0x03 int,
// 0x08 tuple, 0x20 vclock, 0x26 orswot.)
//
// Identity interning: the caller guarantees a Universe whose actor index
// IS the actor value (< A) and whose member id IS the member value
// (int32).  Counters beyond the counter dtype flag the blob for fallback
// (the Python path raises OverflowError at the numpy conversion; the fast
// path must never silently wrap a causal counter).  Counters are written
// and read UNSIGNED (0 = absent); the caller moves them to and from the
// biased device domain.
//
// Per-object status codes (status[i]):
//   0 ok    1 fallback (structure outside the fast-path grammar)
//   2 member overflow (> M)      3 deferred overflow (> D)
//   4 actor out of range (>= A or negative)
//
// Each object writes only its own rows, so the object loops are
// embarrassingly parallel: a team of std::threads takes blocks of 1024
// objects from a shared cursor (the JAX package's codec uses OpenMP; plain
// threads need no OpenMP runtime from the compiler).  Every entry point
// takes ``threads``: the team size, or 0 for the host's hardware threads.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread
// (crdt_tpu_torch/_build.py, at first use, into build/crdt_tpu_torch/).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>


namespace {

constexpr uint8_t kTagInt = 0x03;
constexpr uint8_t kTagTuple = 0x08;
constexpr uint8_t kTagVClock = 0x20;
constexpr uint8_t kTagPNCounter = 0x23;  // 0x22 (gcounter) arrives as the
                                         // clockish codec's tag parameter
constexpr uint8_t kTagLWW = 0x24;
constexpr uint8_t kTagMVReg = 0x25;
constexpr uint8_t kTagOrswot = 0x26;
constexpr uint8_t kTagGSet = 0x28;
constexpr int32_t kEmpty = -1;

// body(i) for every i in [0, n), on ``nt`` threads (the caller's among
// them) taking blocks of kGrain indices from a shared cursor
constexpr int64_t kGrain = 1024;

template <typename F>
void parallel_for(int64_t n, int nt, const F& body) {
  const int64_t blocks = (n + kGrain - 1) / kGrain;
  if (nt > blocks) nt = static_cast<int>(blocks);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) body(i);
    return;
  }
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      const int64_t lo = next.fetch_add(kGrain);
      if (lo >= n) return;
      const int64_t hi = lo + kGrain < n ? lo + kGrain : n;
      for (int64_t i = lo; i < hi; ++i) body(i);
    }
  };
  std::vector<std::thread> team;
  team.reserve(static_cast<size_t>(nt - 1));
  for (int t = 1; t < nt; ++t) team.emplace_back(work);
  work();
  for (std::thread& t : team) t.join();
}

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;

  bool byte(uint8_t want) {
    if (p >= end || *p != want) return false;
    ++p;
    return true;
  }

  // unsigned LEB128, capped at the u64 range — anything longer (or any
  // byte contributing bits past 2^64) is a legitimate big-int payload
  // the fast path hands to Python rather than silently truncating
  bool uv(uint64_t* out) {
    uint64_t v = 0;
    int shift = 0;
    for (int i = 0; i < 10; ++i) {
      if (p >= end) return false;
      uint8_t b = *p++;
      if (shift == 63 && (b & 0x7F) > 1) return false;  // bits >= 2^64
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        *out = v;
        return true;
      }
      shift += 7;
    }
    return false;
  }

  // a zigzagged NON-NEGATIVE int (actors/members/counters are never
  // negative in valid states; negative means fallback)
  bool nonneg(uint64_t* out) {
    uint64_t z;
    if (!byte(kTagInt) || !uv(&z)) return false;
    if (z & 1) return false;  // negative
    *out = z >> 1;
    return true;
  }
};

// defined with the egress helpers below; declared here for the parsers'
// canonical-order checks
bool varint_bytes_less(uint64_t za, uint64_t zb);

// deferred section: uv groups, each a
// clock-key tuple + member/key list.  One dense row per (clock, id)
// pair; the witnessing clock is decoded once into a thread-local
// scratch row and copied to every row buffered under it (matches
// from_scalar's layout: `for member in members: one row sharing the
// clock columns`).
template <typename C>
int parse_deferred_section(Cursor& c, int64_t A, int64_t D, int32_t* d_ids,
                           C* d_clocks) {
  constexpr uint64_t kCounterMax = static_cast<uint64_t>(~C{0});
  uint64_t n;
  if (!c.uv(&n)) return 1;
  static thread_local std::vector<C> scratch;
  int64_t drow = 0;
  // canonical-order enforcement (same rationale as the entry/key checks:
  // to_binary emits groups strictly ascending in encoded clock-key
  // bytes and members strictly ascending within a group — a duplicate
  // group or member would buffer extra dense rows where the Python
  // decode dedupes via dict/set, so non-canonical input falls back)
  const uint8_t* prev_key = nullptr;
  size_t prev_key_len = 0;
  for (uint64_t q = 0; q < n; ++q) {
    const uint8_t* key_start = c.p;
    if (!c.byte(kTagTuple)) return 1;
    uint64_t k;
    if (!c.uv(&k)) return 1;
    scratch.assign(static_cast<size_t>(A), C{0});
    for (uint64_t i = 0; i < k; ++i) {
      uint64_t two, actor, counter;
      if (!c.byte(kTagTuple) || !c.uv(&two) || two != 2) return 1;
      if (!c.nonneg(&actor) || !c.nonneg(&counter)) return 1;
      if (actor >= static_cast<uint64_t>(A)) return 4;
      if (counter > kCounterMax) return 1;
      scratch[actor] = static_cast<C>(counter);
    }
    const size_t key_len = static_cast<size_t>(c.p - key_start);
    if (q > 0) {
      // strictly ascending encoded clock-key bytes (the egress group
      // comparator: memcmp, shorter-is-less on shared-prefix tie)
      const size_t m_ = prev_key_len < key_len ? prev_key_len : key_len;
      const int cmp = std::memcmp(prev_key, key_start, m_);
      if (!(cmp < 0 || (cmp == 0 && prev_key_len < key_len))) return 1;
    }
    prev_key = key_start;
    prev_key_len = key_len;
    uint64_t m;
    if (!c.uv(&m)) return 1;
    uint64_t prev_member = 0;
    for (uint64_t j = 0; j < m; ++j) {
      uint64_t member;
      if (!c.nonneg(&member)) return 1;
      if (member > 0x7FFFFFFFull) return 1;
      if (j > 0 && !varint_bytes_less(prev_member << 1, member << 1))
        return 1;
      prev_member = member;
      if (drow >= D) return 3;
      std::memcpy(d_clocks + drow * A, scratch.data(), sizeof(C) * A);
      d_ids[drow] = static_cast<int32_t>(member);
      ++drow;
    }
  }
  return 0;
}

// one full ORSWOT value from the cursor (tag 0x26 through the deferred
// section, NO end-of-blob check)
template <typename C>
int parse_orswot_value(Cursor& c, int64_t A, int64_t M, int64_t D, C* clock,
                       int32_t* ids, C* dots, int32_t* d_ids, C* d_clocks) {
  // counters beyond the counter dtype are NOT wrapped: the Python path
  // (numpy conversion) raises OverflowError, so the fast path flags the
  // blob for fallback and lets that exact behavior happen
  constexpr uint64_t kCounterMax = static_cast<uint64_t>(~C{0});
  if (!c.byte(kTagOrswot)) return 1;

  uint64_t n;
  // set clock
  if (!c.uv(&n)) return 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t actor, counter;
    if (!c.nonneg(&actor) || !c.nonneg(&counter)) return 1;
    if (actor >= static_cast<uint64_t>(A)) return 4;
    if (counter > kCounterMax) return 1;
    clock[actor] = static_cast<C>(counter);
  }

  // member entries (dense slots in wire order — the same order the
  // Python fallback's from_binary hands from_scalar).  Members must be
  // strictly ascending in encoded-key-bytes order — what to_binary
  // always emits; a duplicate would silently yield two live slots where
  // the Python dict decode dedupes into one, so anything non-canonical
  // falls back to the Python path (which dedupes/handles it ITS way)
  if (!c.uv(&n)) return 1;
  if (n > static_cast<uint64_t>(M)) return 2;
  uint64_t prev_member = 0;
  for (uint64_t e = 0; e < n; ++e) {
    uint64_t member;
    if (!c.nonneg(&member)) return 1;
    if (member > 0x7FFFFFFFull) return 1;  // beyond int32 id space
    if (e > 0 && !varint_bytes_less(prev_member << 1, member << 1)) return 1;
    prev_member = member;
    ids[e] = static_cast<int32_t>(member);
    if (!c.byte(kTagVClock)) return 1;
    uint64_t k;
    if (!c.uv(&k)) return 1;
    C* row = dots + e * A;
    for (uint64_t i = 0; i < k; ++i) {
      uint64_t actor, counter;
      if (!c.nonneg(&actor) || !c.nonneg(&counter)) return 1;
      if (actor >= static_cast<uint64_t>(A)) return 4;
      if (counter > kCounterMax) return 1;
      row[actor] = static_cast<C>(counter);
    }
  }

  // deferred: one dense row per (clock, member) pair
  return parse_deferred_section<C>(c, A, D, d_ids, d_clocks);
}

template <typename C>
int parse_one(const uint8_t* buf, int64_t lo, int64_t hi, int64_t A,
              int64_t M, int64_t D, C* clock, int32_t* ids, C* dots,
              int32_t* d_ids, C* d_clocks) {
  Cursor c{buf + lo, buf + hi};
  int st = parse_orswot_value<C>(c, A, M, D, clock, ids, dots, d_ids,
                                 d_clocks);
  if (st) return st;
  if (c.p != c.end) return 1;  // trailing bytes: not a lone ORSWOT blob
  return 0;
}

template <typename C>
void clear_orswot_row(int64_t A, int64_t M, int64_t D, C* clock, int32_t* ids,
                      C* dots, int32_t* d_ids, C* d_clocks) {
  std::memset(clock, 0, sizeof(C) * A);
  std::memset(dots, 0, sizeof(C) * M * A);
  std::memset(d_clocks, 0, sizeof(C) * D * A);
  for (int64_t j = 0; j < M; ++j) ids[j] = kEmpty;
  for (int64_t j = 0; j < D; ++j) d_ids[j] = kEmpty;
}

// ``clear`` != 0: zero each object's output rows before parsing, so the
// caller may hand REUSED buffers (the pipelined loop's staging planes —
// a fresh np.zeros alloc per chunk page-faults ~GBs and was the measured
// ingest collapse of the JAX package's loop).  0 keeps the contract
// (caller pre-zeroed the planes) and skips the memset pass.
template <typename C>
int64_t ingest_impl(const uint8_t* buf, const int64_t* offsets, int64_t n,
                    int64_t A, int64_t M, int64_t D, C* clock, int32_t* ids,
                    C* dots, int32_t* d_ids, C* d_clocks, uint8_t* status,
                    int64_t clear, int nt) {
  std::atomic<int64_t> bad{0};
  parallel_for(n, nt, [&](int64_t i) {
    if (clear)
      clear_orswot_row<C>(A, M, D, clock + i * A, ids + i * M,
                          dots + i * M * A, d_ids + i * D, d_clocks + i * D * A);
    int st = parse_one<C>(buf, offsets[i], offsets[i + 1], A, M, D,
                          clock + i * A, ids + i * M, dots + i * M * A,
                          d_ids + i * D, d_clocks + i * D * A);
    status[i] = static_cast<uint8_t>(st);
    if (st != 0) {
      // leave the row pristine for the Python fallback / error report
      clear_orswot_row<C>(A, M, D, clock + i * A, ids + i * M,
                          dots + i * M * A, d_ids + i * D, d_clocks + i * D * A);
      bad.fetch_add(1);
    }
  });
  return bad.load();
}

// ---- bulk wire EGRESS: dense planes -> serde blobs -------------------------
//
// The inverse direction, byte-identical to
// `to_binary(batch.to_scalar(uni)[i])` for identity universes.  Three
// distinct deterministic orderings must be reproduced exactly
// (serde.py):
//   * pair/item lists sort by the ENCODED BYTES of the key
//     (enc_pairs_sorted / enc_items_sorted — python bytes comparison:
//     lexicographic, shorter-prefix-first),
//   * ClockKey tuples (deferred keys) sort their (actor, counter) pairs
//     by repr(actor) — DECIMAL-STRING order for ints (vclock.py key()),
//   * deferred GROUPS sort by the encoded bytes of the whole clock-key
//     tuple.

struct Emitter {
  uint8_t* p;      // nullptr = counting pass
  int64_t count = 0;

  void byte(uint8_t b) {
    if (p) *p++ = b;
    ++count;
  }

  void uv(uint64_t v) {
    while (true) {
      uint8_t b = v & 0x7F;
      v >>= 7;
      if (v) {
        byte(b | 0x80);
      } else {
        byte(b);
        return;
      }
    }
  }

  void tagged_nonneg(uint64_t v) {  // 0x03 + zigzag varint
    byte(kTagInt);
    uv(v << 1);
  }
};

inline int write_varint(uint64_t v, uint8_t* out) {
  int n = 0;
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out[n++] = b | 0x80;
    } else {
      out[n++] = b;
      return n;
    }
  }
}

// python-bytes comparison of two encoded varints (zigzagged values):
// lexicographic, shorter-prefix-first
inline bool varint_bytes_less(uint64_t za, uint64_t zb) {
  uint8_t a[10], b[10];
  int la = write_varint(za, a), lb = write_varint(zb, b);
  int m = la < lb ? la : lb;
  int c = std::memcmp(a, b, static_cast<size_t>(m));
  if (c) return c < 0;
  return la < lb;
}

// repr-string (decimal) comparison of two non-negative ints —
// vclock.py's ClockKey pair order
inline bool decimal_repr_less(uint64_t a, uint64_t b) {
  char sa[24], sb[24];
  int la = std::snprintf(sa, sizeof(sa), "%llu",
                         static_cast<unsigned long long>(a));
  int lb = std::snprintf(sb, sizeof(sb), "%llu",
                         static_cast<unsigned long long>(b));
  int m = la < lb ? la : lb;
  int c = std::memcmp(sa, sb, static_cast<size_t>(m));
  if (c) return c < 0;
  return la < lb;
}

// emit one vclock BODY (uv n + sorted pairs) from a dense counter row.
// ``sorted=false`` skips the order work — the SIZE of the body is
// order-invariant, so the counting pass never pays for sorts.
template <typename C>
void emit_clock_body(Emitter& e, const C* row, int64_t A,
                     std::vector<int64_t>& idx, bool sorted = true) {
  idx.clear();
  for (int64_t a = 0; a < A; ++a)
    if (row[a]) idx.push_back(a);
  // keys are 0x03 + varint(2a): shared tag, so encoded-bytes order is
  // the varint-bytes order of 2a
  if (sorted)
    std::sort(idx.begin(), idx.end(), [](int64_t x, int64_t y) {
      return varint_bytes_less(static_cast<uint64_t>(x) << 1,
                               static_cast<uint64_t>(y) << 1);
    });
  e.uv(static_cast<uint64_t>(idx.size()));
  for (int64_t a : idx) {
    e.tagged_nonneg(static_cast<uint64_t>(a));
    e.tagged_nonneg(static_cast<uint64_t>(row[a]));
  }
}

// the encoded clock-KEY tuple for a deferred group (0x08 uv k + pairs
// as 2-tuples, pair order = decimal repr of the actor)
template <typename C>
void emit_clock_key(Emitter& e, const C* row, int64_t A,
                    std::vector<int64_t>& idx, bool sorted = true) {
  idx.clear();
  for (int64_t a = 0; a < A; ++a)
    if (row[a]) idx.push_back(a);
  if (sorted)
    std::sort(idx.begin(), idx.end(), [](int64_t x, int64_t y) {
      return decimal_repr_less(static_cast<uint64_t>(x),
                               static_cast<uint64_t>(y));
    });
  e.byte(kTagTuple);
  e.uv(static_cast<uint64_t>(idx.size()));
  for (int64_t a : idx) {
    e.byte(kTagTuple);
    e.uv(2);
    e.tagged_nonneg(static_cast<uint64_t>(a));
    e.tagged_nonneg(static_cast<uint64_t>(row[a]));
  }
}

// deferred section on egress: group live
// rows by identical clock rows; each group is (encoded clock key,
// sorted member blobs); groups sort by the encoded clock-key bytes.
// D is small (a handful of rows), so the quadratic grouping is free.
template <typename C>
void emit_deferred_section(Emitter& e, const int32_t* d_ids,
                           const C* d_clocks, int64_t A, int64_t D,
                           std::vector<int64_t>& scratch, bool sizing) {
  std::vector<int64_t> rows;
  for (int64_t r = 0; r < D; ++r)
    if (d_ids[r] != kEmpty) rows.push_back(r);
  std::vector<char> used(rows.size(), 0);
  struct Group {
    const C* crow;                   // the witnessing clock's dense row
    std::vector<uint8_t> key;        // encoded clock-key tuple (write pass)
    std::vector<int64_t> members;    // member values, deduped
  };
  std::vector<Group> groups;
  for (size_t i = 0; i < rows.size(); ++i) {
    if (used[i]) continue;
    Group g;
    g.crow = d_clocks + rows[i] * A;
    g.members.push_back(d_ids[rows[i]]);
    for (size_t j = i + 1; j < rows.size(); ++j) {
      if (used[j]) continue;
      const C* orow = d_clocks + rows[j] * A;
      bool same = true;
      for (int64_t a = 0; a < A; ++a)
        if (g.crow[a] != orow[a]) {
          same = false;
          break;
        }
      if (same) {
        used[j] = 1;
        g.members.push_back(d_ids[rows[j]]);
      }
    }
    // python set() deduplicates members buffered under one clock (dense
    // rows never legitimately repeat a (clock, member) pair, but match
    // to_binary on any input); dedup changes the SIZE, so both passes
    // run it — the sort is its implementation, members lists are tiny
    std::sort(g.members.begin(), g.members.end(), [](int64_t x, int64_t y) {
      return varint_bytes_less(static_cast<uint64_t>(x) << 1,
                               static_cast<uint64_t>(y) << 1);
    });
    g.members.erase(std::unique(g.members.begin(), g.members.end()),
                    g.members.end());
    if (!sizing) {
      // stage the encoded clock key for the cross-group sort
      Emitter cnt{nullptr};
      emit_clock_key(cnt, g.crow, A, scratch);
      g.key.resize(static_cast<size_t>(cnt.count));
      Emitter w{g.key.data()};
      emit_clock_key(w, g.crow, A, scratch);
    }
    groups.push_back(std::move(g));
  }
  if (!sizing)
    std::sort(groups.begin(), groups.end(),
              [](const Group& x, const Group& y) {
                size_t m = x.key.size() < y.key.size() ? x.key.size()
                                                       : y.key.size();
                int c = std::memcmp(x.key.data(), y.key.data(), m);
                if (c) return c < 0;
                return x.key.size() < y.key.size();
              });
  e.uv(static_cast<uint64_t>(groups.size()));
  for (const Group& g : groups) {
    if (sizing) {
      emit_clock_key(e, g.crow, A, scratch, false);
    } else {
      for (uint8_t b : g.key) e.byte(b);
    }
    e.uv(static_cast<uint64_t>(g.members.size()));
    for (int64_t m : g.members)
      e.tagged_nonneg(static_cast<uint64_t>(static_cast<uint32_t>(m)));
  }
}

template <typename C>
int64_t encode_one(const C* clock, const int32_t* ids, const C* dots,
                   const int32_t* d_ids, const C* d_clocks, int64_t A,
                   int64_t M, int64_t D, uint8_t* out) {
  // out == nullptr is the counting pass: every blob's SIZE is
  // order-invariant, so the sorts (and group-key staging buffers) are
  // skipped there — the write pass alone pays for ordering
  const bool sizing = (out == nullptr);
  Emitter e{out};
  std::vector<int64_t> scratch;
  e.byte(kTagOrswot);
  emit_clock_body(e, clock, A, scratch, !sizing);

  // entries: member keys sorted by encoded bytes (0x03 + varint(2m))
  std::vector<int64_t> slots;
  for (int64_t s = 0; s < M; ++s)
    if (ids[s] != kEmpty) slots.push_back(s);
  if (!sizing)
    std::sort(slots.begin(), slots.end(), [&](int64_t x, int64_t y) {
      return varint_bytes_less(
          static_cast<uint64_t>(static_cast<uint32_t>(ids[x])) << 1,
          static_cast<uint64_t>(static_cast<uint32_t>(ids[y])) << 1);
    });
  e.uv(static_cast<uint64_t>(slots.size()));
  for (int64_t s : slots) {
    e.tagged_nonneg(static_cast<uint64_t>(static_cast<uint32_t>(ids[s])));
    e.byte(kTagVClock);
    emit_clock_body(e, dots + s * A, A, scratch, !sizing);
  }

  // deferred section
  emit_deferred_section(e, d_ids, d_clocks, A, D, scratch, sizing);
  return e.count;
}

template <typename C>
void encode_impl(const C* clock, const int32_t* ids, const C* dots,
                 const int32_t* d_ids, const C* d_clocks, int64_t n,
                 int64_t A, int64_t M, int64_t D, int64_t* offsets,
                 uint8_t* buf, int nt) {
  if (buf == nullptr) {
    // pass 1: per-object sizes into offsets[1..n] (caller prefix-sums)
    parallel_for(n, nt, [&](int64_t i) {
      offsets[i + 1] = encode_one<C>(clock + i * A, ids + i * M,
                                     dots + i * M * A, d_ids + i * D,
                                     d_clocks + i * D * A, A, M, D, nullptr);
    });
    return;
  }
  parallel_for(n, nt, [&](int64_t i) {
    encode_one<C>(clock + i * A, ids + i * M, dots + i * M * A,
                  d_ids + i * D, d_clocks + i * D * A, A, M, D,
                  buf + offsets[i]);
  });
}

int team(int64_t threads) {
  if (threads > 0) return static_cast<int>(threads);
  const unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 1;
}

}  // namespace

extern "C" {

int64_t orswot_ingest_wire_u32(const uint8_t* buf, const int64_t* offsets,
                               int64_t n, int64_t A, int64_t M, int64_t D,
                               uint32_t* clock, int32_t* ids, uint32_t* dots,
                               int32_t* d_ids, uint32_t* d_clocks,
                               uint8_t* status, int64_t clear,
                               int64_t threads) {
  return ingest_impl<uint32_t>(buf, offsets, n, A, M, D, clock, ids, dots,
                               d_ids, d_clocks, status, clear, team(threads));
}

int64_t orswot_ingest_wire_u64(const uint8_t* buf, const int64_t* offsets,
                               int64_t n, int64_t A, int64_t M, int64_t D,
                               uint64_t* clock, int32_t* ids, uint64_t* dots,
                               int32_t* d_ids, uint64_t* d_clocks,
                               uint8_t* status, int64_t clear,
                               int64_t threads) {
  return ingest_impl<uint64_t>(buf, offsets, n, A, M, D, clock, ids, dots,
                               d_ids, d_clocks, status, clear, team(threads));
}

// two passes: buf == nullptr writes each blob's size to offsets[1..n]
// (the caller prefix-sums them); then buf receives blob i at offsets[i]
void orswot_encode_wire_u32(const uint32_t* clock, const int32_t* ids,
                            const uint32_t* dots, const int32_t* d_ids,
                            const uint32_t* d_clocks, int64_t n, int64_t A,
                            int64_t M, int64_t D, int64_t* offsets,
                            uint8_t* buf, int64_t threads) {
  encode_impl<uint32_t>(clock, ids, dots, d_ids, d_clocks, n, A, M, D,
                        offsets, buf, team(threads));
}

void orswot_encode_wire_u64(const uint64_t* clock, const int32_t* ids,
                            const uint64_t* dots, const int32_t* d_ids,
                            const uint64_t* d_clocks, int64_t n, int64_t A,
                            int64_t M, int64_t D, int64_t* offsets,
                            uint8_t* buf, int64_t threads) {
  encode_impl<uint64_t>(clock, ids, dots, d_ids, d_clocks, n, A, M, D,
                        offsets, buf, team(threads));
}

}  // extern "C"

// ---- the flat types: MVReg, GSet, LWWReg, VClock/GCounter, PNCounter -------
//
//   MVREG     := 0x25 uv n, n * ( clock_body, 0x03 zz(val) )  pair blobs
//                sorted by their full encoded bytes
//   GSET      := 0x28 uv n, n * (0x03 zz(member))  items sorted by bytes
//   LWWREG    := 0x24 0x03 zz(val) 0x03 zz(marker)
//   VCLOCK    := 0x20 clock_body     GCOUNTER := 0x22 clock_body
//   PNCOUNTER := 0x23 clock_body clock_body   (P then N)
//
// Dense layouts: MVReg clocks[K, A] + vals[K] (a slot is live iff its
// clock is non-empty); GSet a 0/1 byte per member id < U; LWW vals[N] and
// markers[N], both u64 (markers are timestamps); clocks[N, A];
// PNCounter planes[N, 2, A].  Payload ids (MVReg/LWW vals, GSet members)
// live in the identity registry's int32 space.  Status codes as the
// ORSWOT legs: 1 fallback, 4 actor out of range; 2 is MVReg's antichain
// overflow (> K values) and GSet's bitmap overflow (id >= U).  Outputs
// arrive zeroed and a row with a nonzero status is zeroed again.

namespace {

// a clock body into a zeroed dense row; duplicate actor keys keep the
// last counter, as the other legs' dense scatter (to_binary never emits
// them)
template <typename C>
int parse_clock_body(Cursor& c, int64_t A, C* row) {
  constexpr uint64_t kCounterMax = static_cast<uint64_t>(~C{0});
  uint64_t n;
  if (!c.uv(&n)) return 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t actor, counter;
    if (!c.nonneg(&actor) || !c.nonneg(&counter)) return 1;
    if (actor >= static_cast<uint64_t>(A)) return 4;
    if (counter > kCounterMax) return 1;
    row[actor] = static_cast<C>(counter);
  }
  return 0;
}

template <typename C>
int parse_mvreg_one(Cursor& c, int64_t K, int64_t A, C* clocks, C* vals) {
  constexpr uint64_t kCounterMax = static_cast<uint64_t>(~C{0});
  if (!c.byte(kTagMVReg)) return 1;
  uint64_t n;
  if (!c.uv(&n)) return 1;
  if (n > static_cast<uint64_t>(K)) return 2;
  for (uint64_t j = 0; j < n; ++j) {
    int st = parse_clock_body(c, A, clocks + j * A);
    if (st) return st;
    uint64_t val;
    if (!c.nonneg(&val)) return 1;
    if (val > 0x7FFFFFFFull || val > kCounterMax) return 1;
    vals[j] = static_cast<C>(val);
  }
  return 0;
}

int parse_gset_one(Cursor& c, int64_t U, uint8_t* bits) {
  if (!c.byte(kTagGSet)) return 1;
  uint64_t n;
  if (!c.uv(&n)) return 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t member;
    if (!c.nonneg(&member)) return 1;
    // past the int32 id space the Python path raises its own error
    if (member > 0x7FFFFFFFull) return 1;
    if (member >= static_cast<uint64_t>(U)) return 2;
    bits[member] = 1;
  }
  return 0;
}

int parse_lww_one(Cursor& c, uint64_t* val, uint64_t* marker) {
  if (!c.byte(kTagLWW)) return 1;
  if (!c.nonneg(val) || *val > 0x7FFFFFFFull) return 1;
  return c.nonneg(marker) ? 0 : 1;
}

// parse(cursor, i) -> status for every blob, on the team; a blob must be
// consumed whole.  clear(i) zeroes row i after a nonzero status.
template <typename P, typename Z>
int64_t ingest_rows(const uint8_t* buf, const int64_t* offsets, int64_t n,
                    uint8_t* status, int nt, const P& parse, const Z& clear) {
  std::atomic<int64_t> bad{0};
  parallel_for(n, nt, [&](int64_t i) {
    Cursor c{buf + offsets[i], buf + offsets[i + 1]};
    int st = parse(c, i);
    if (st == 0 && c.p != c.end) st = 1;
    status[i] = static_cast<uint8_t>(st);
    if (st) {
      clear(i);
      bad.fetch_add(1);
    }
  });
  return bad.load();
}

// the two egress passes: buf == nullptr writes each blob's size to
// offsets[1..n] (the caller prefix-sums them), then blob i lands at
// buf + offsets[i].  enc(i, out) returns the size; out == nullptr sizes.
template <typename E>
void encode_rows(int64_t n, int64_t* offsets, uint8_t* buf, int nt,
                 const E& enc) {
  parallel_for(n, nt, [&](int64_t i) {
    if (buf == nullptr)
      offsets[i + 1] = enc(i, nullptr);
    else
      enc(i, buf + offsets[i]);
  });
}

bool bytes_less(const std::vector<uint8_t>& x, const std::vector<uint8_t>& y) {
  const size_t m = x.size() < y.size() ? x.size() : y.size();
  const int c = std::memcmp(x.data(), y.data(), m);
  return c ? c < 0 : x.size() < y.size();
}

template <typename C>
int64_t mvreg_encode_one(const C* clocks, const C* vals, int64_t K, int64_t A,
                         uint8_t* out) {
  const bool sizing = (out == nullptr);
  std::vector<int64_t> scratch;
  std::vector<std::vector<uint8_t>> blobs;  // each live slot's pair blob
  int64_t blob_bytes = 0, n_live = 0;
  for (int64_t j = 0; j < K; ++j) {
    const C* row = clocks + j * A;
    if (std::all_of(row, row + A, [](C x) { return x == 0; })) continue;
    ++n_live;
    Emitter cnt{nullptr};
    emit_clock_body(cnt, row, A, scratch, false);
    cnt.tagged_nonneg(static_cast<uint64_t>(vals[j]));
    blob_bytes += cnt.count;
    if (sizing) continue;
    std::vector<uint8_t> b(static_cast<size_t>(cnt.count));
    Emitter w{b.data()};
    emit_clock_body(w, row, A, scratch);
    w.tagged_nonneg(static_cast<uint64_t>(vals[j]));
    blobs.push_back(std::move(b));
  }
  Emitter e{out};
  e.byte(kTagMVReg);
  e.uv(static_cast<uint64_t>(n_live));
  if (sizing) return e.count + blob_bytes;
  std::sort(blobs.begin(), blobs.end(), bytes_less);
  for (const auto& b : blobs)
    for (uint8_t x : b) e.byte(x);
  return e.count;
}

int64_t gset_encode_one(const uint8_t* bits, int64_t U, uint8_t* out) {
  Emitter e{out};
  std::vector<int64_t> members;
  for (int64_t m = 0; m < U; ++m)
    if (bits[m]) members.push_back(m);
  if (out != nullptr)
    std::sort(members.begin(), members.end(), [](int64_t x, int64_t y) {
      return varint_bytes_less(static_cast<uint64_t>(x) << 1,
                               static_cast<uint64_t>(y) << 1);
    });
  e.byte(kTagGSet);
  e.uv(static_cast<uint64_t>(members.size()));
  for (int64_t m : members) e.tagged_nonneg(static_cast<uint64_t>(m));
  return e.count;
}

// VClock/GCounter (planes == 1, under ``tag``) and PNCounter (planes == 2)
template <typename C>
int64_t clocks_encode_one(uint8_t tag, const C* row, int64_t planes, int64_t A,
                          uint8_t* out) {
  Emitter e{out};
  std::vector<int64_t> scratch;
  e.byte(tag);
  for (int64_t p = 0; p < planes; ++p)
    emit_clock_body(e, row + p * A, A, scratch, out != nullptr);
  return e.count;
}

template <typename C>
int64_t mvreg_ingest(const uint8_t* buf, const int64_t* offsets, int64_t n,
                     int64_t K, int64_t A, C* clocks, C* vals, uint8_t* status,
                     int64_t threads) {
  return ingest_rows(
      buf, offsets, n, status, team(threads),
      [&](Cursor& c, int64_t i) {
        return parse_mvreg_one<C>(c, K, A, clocks + i * K * A, vals + i * K);
      },
      [&](int64_t i) {
        std::memset(clocks + i * K * A, 0, sizeof(C) * K * A);
        std::memset(vals + i * K, 0, sizeof(C) * K);
      });
}

template <typename C>
void mvreg_encode(const C* clocks, const C* vals, int64_t n, int64_t K,
                  int64_t A, int64_t* offsets, uint8_t* buf, int64_t threads) {
  encode_rows(n, offsets, buf, team(threads), [&](int64_t i, uint8_t* out) {
    return mvreg_encode_one<C>(clocks + i * K * A, vals + i * K, K, A, out);
  });
}

// VClock/GCounter rows (planes == 1, the blob's tag ``tag``) or PNCounter
// rows (planes == 2, tag 0x23)
template <typename C>
int64_t clocks_ingest(const uint8_t* buf, const int64_t* offsets, int64_t n,
                      uint8_t tag, int64_t planes, int64_t A, C* out,
                      uint8_t* status, int64_t threads) {
  const int64_t w = planes * A;
  return ingest_rows(
      buf, offsets, n, status, team(threads),
      [&](Cursor& c, int64_t i) {
        if (!c.byte(tag)) return 1;
        for (int64_t p = 0; p < planes; ++p) {
          int st = parse_clock_body(c, A, out + i * w + p * A);
          if (st) return st;
        }
        return 0;
      },
      [&](int64_t i) { std::memset(out + i * w, 0, sizeof(C) * w); });
}

template <typename C>
void clocks_encode(const C* rows, int64_t n, uint8_t tag, int64_t planes,
                   int64_t A, int64_t* offsets, uint8_t* buf, int64_t threads) {
  encode_rows(n, offsets, buf, team(threads), [&](int64_t i, uint8_t* out) {
    return clocks_encode_one<C>(tag, rows + i * planes * A, planes, A, out);
  });
}

}  // namespace

extern "C" {

#define FLAT_LEGS(C, S)                                                       \
  int64_t mvreg_ingest_wire_##S(const uint8_t* buf, const int64_t* offsets,   \
                                int64_t n, int64_t K, int64_t A, C* clocks,   \
                                C* vals, uint8_t* status, int64_t threads) {  \
    return mvreg_ingest<C>(buf, offsets, n, K, A, clocks, vals, status,       \
                           threads);                                          \
  }                                                                           \
  void mvreg_encode_wire_##S(const C* clocks, const C* vals, int64_t n,       \
                             int64_t K, int64_t A, int64_t* offsets,          \
                             uint8_t* buf, int64_t threads) {                 \
    mvreg_encode<C>(clocks, vals, n, K, A, offsets, buf, threads);            \
  }                                                                           \
  int64_t clockish_ingest_wire_##S(const uint8_t* buf, const int64_t* offsets, \
                                   int64_t n, int64_t tag, int64_t A,         \
                                   C* clocks, uint8_t* status,                \
                                   int64_t threads) {                         \
    return clocks_ingest<C>(buf, offsets, n, static_cast<uint8_t>(tag), 1, A, \
                            clocks, status, threads);                         \
  }                                                                           \
  void clockish_encode_wire_##S(const C* clocks, int64_t n, int64_t tag,      \
                                int64_t A, int64_t* offsets, uint8_t* buf,    \
                                int64_t threads) {                            \
    clocks_encode<C>(clocks, n, static_cast<uint8_t>(tag), 1, A, offsets, buf, \
                     threads);                                                \
  }                                                                           \
  int64_t pncounter_ingest_wire_##S(const uint8_t* buf,                       \
                                    const int64_t* offsets, int64_t n,        \
                                    int64_t A, C* planes, uint8_t* status,    \
                                    int64_t threads) {                        \
    return clocks_ingest<C>(buf, offsets, n, kTagPNCounter, 2, A, planes,     \
                            status, threads);                                 \
  }                                                                           \
  void pncounter_encode_wire_##S(const C* planes, int64_t n, int64_t A,       \
                                 int64_t* offsets, uint8_t* buf,              \
                                 int64_t threads) {                           \
    clocks_encode<C>(planes, n, kTagPNCounter, 2, A, offsets, buf, threads);  \
  }

FLAT_LEGS(uint32_t, u32)
FLAT_LEGS(uint64_t, u64)
#undef FLAT_LEGS

int64_t gset_ingest_wire(const uint8_t* buf, const int64_t* offsets, int64_t n,
                         int64_t U, uint8_t* bits, uint8_t* status,
                         int64_t threads) {
  return ingest_rows(
      buf, offsets, n, status, team(threads),
      [&](Cursor& c, int64_t i) { return parse_gset_one(c, U, bits + i * U); },
      [&](int64_t i) { std::memset(bits + i * U, 0, static_cast<size_t>(U)); });
}

void gset_encode_wire(const uint8_t* bits, int64_t n, int64_t U,
                      int64_t* offsets, uint8_t* buf, int64_t threads) {
  encode_rows(n, offsets, buf, team(threads), [&](int64_t i, uint8_t* out) {
    return gset_encode_one(bits + i * U, U, out);
  });
}

int64_t lww_ingest_wire_u64(const uint8_t* buf, const int64_t* offsets,
                            int64_t n, uint64_t* vals, uint64_t* markers,
                            uint8_t* status, int64_t threads) {
  return ingest_rows(
      buf, offsets, n, status, team(threads),
      [&](Cursor& c, int64_t i) {
        return parse_lww_one(c, vals + i, markers + i);
      },
      [&](int64_t i) { vals[i] = markers[i] = 0; });
}

void lww_encode_wire_u64(const uint64_t* vals, const uint64_t* markers,
                         int64_t n, int64_t* offsets, uint8_t* buf,
                         int64_t threads) {
  encode_rows(n, offsets, buf, team(threads), [&](int64_t i, uint8_t* out) {
    Emitter e{out};
    e.byte(kTagLWW);
    e.tagged_nonneg(vals[i]);
    e.tagged_nonneg(markers[i]);
    return e.count;
  });
}

}  // extern "C"

// ---- the Map legs: Map<K, MVReg>, Map<K, Orswot>, Map<K, Map<K2, MVReg>> ---
//
//   MAP     := 0x27 valtype clock_body entries deferred
//   valtype := 0x50 uv(len) name            (a registered class: "MVReg",
//              | 0x51 valtype                "Orswot"; 0x51 = MapOf(inner))
//   entries := uv n, n * ( 0x03 zz(key) clock_body VALUE )   keys ascending
//              in encoded bytes
//   deferred as the ORSWOT's section (clock keys -> key ids).
//
// The entry clock is a raw clock body (no 0x20 tag); the value arrives
// fully tagged and is parsed and emitted by the MVReg and ORSWOT legs'
// own routines (a nested Map's value recurses into parse_map_value).
// Dense planes: the map's clock[A], keys[K], eclocks[K, A], d_keys[D],
// d_clocks[D, A] around the value planes of each key slot.  Status: 0 ok,
// 1 fallback, 2 key overflow (> K), 3 deferred overflow (> D), 4 actor out
// of range, 5 a value's own overflow (antichain, members, deferred rows,
// or an inner map's keys or deferred rows).  The caller hands ids filled
// with -1 and counters zeroed; a row with a nonzero status is cleared
// again.

namespace {

constexpr uint8_t kTagMap = 0x27;
constexpr uint8_t kMVRegHdr[] = {0x50, 0x05, 'M', 'V', 'R', 'e', 'g'};
constexpr uint8_t kOrswotHdr[] = {0x50, 0x06, 'O', 'r', 's', 'w', 'o', 't'};
constexpr uint8_t kMapMVRegHdr[] = {0x51, 0x50, 0x05, 'M', 'V', 'R', 'e', 'g'};

// a value's capacity overflow is the value's (5), never the map's (2, 3)
inline int value_status(int st) { return st == 2 || st == 3 ? 5 : st; }

// one dense plane of a leg: its base, one object's row in bytes, and
// whether it holds ids (cleared to -1) or counters (cleared to 0)
struct Plane {
  void* base;
  int64_t row_bytes;
  bool ids;
};

void clear_row(const Plane& p, int64_t i) {
  std::memset(static_cast<char*>(p.base) + i * p.row_bytes, p.ids ? 0xFF : 0,
              static_cast<size_t>(p.row_bytes));
}

// one Map value from the cursor: tag, val_type header, map clock, the
// key loop (key, raw entry clock body, one value through
// ``parse_val(cursor, slot)``) and the deferred section
template <typename C, typename ParseVal>
int parse_map_value(Cursor& c, const uint8_t* hdr, size_t hdr_len, int64_t A,
                    int64_t K, int64_t D, C* clock, int32_t* keys, C* eclocks,
                    int32_t* d_keys, C* d_clocks, const ParseVal& parse_val) {
  if (!c.byte(kTagMap)) return 1;
  if (c.end - c.p < static_cast<int64_t>(hdr_len) ||
      std::memcmp(c.p, hdr, hdr_len) != 0)
    return 1;
  c.p += hdr_len;
  int st = parse_clock_body(c, A, clock);
  if (st) return st;
  uint64_t n;
  if (!c.uv(&n)) return 1;
  if (n > static_cast<uint64_t>(K)) return 2;
  // strictly ascending keys, as to_binary emits them: a duplicate would
  // give two live slots where the Python decode keeps one
  uint64_t prev_key = 0;
  for (uint64_t e = 0; e < n; ++e) {
    uint64_t key;
    if (!c.nonneg(&key)) return 1;
    if (key > 0x7FFFFFFFull) return 1;
    if (e > 0 && !varint_bytes_less(prev_key << 1, key << 1)) return 1;
    prev_key = key;
    keys[e] = static_cast<int32_t>(key);
    st = parse_clock_body(c, A, eclocks + e * A);
    if (st) return st;
    st = parse_val(c, static_cast<int64_t>(e));
    if (st) return st;
  }
  return parse_deferred_section<C>(c, A, D, d_keys, d_clocks);
}

// one Map blob: the map's own planes at object i, the value planes in
// ``vplanes`` (for clearing), each value through ``parse_val(c, i, slot)``
template <typename C, typename ParseVal>
int64_t map_ingest(const uint8_t* buf, const int64_t* offsets, int64_t n,
                   const uint8_t* hdr, size_t hdr_len, int64_t A, int64_t K,
                   int64_t D, C* clock, int32_t* keys, C* eclocks,
                   int32_t* d_keys, C* d_clocks, std::vector<Plane> planes,
                   uint8_t* status, int64_t threads,
                   const ParseVal& parse_val) {
  const int64_t c = static_cast<int64_t>(sizeof(C));
  planes.insert(planes.end(), {{clock, A * c, false},
                               {keys, K * 4, true},
                               {eclocks, K * A * c, false},
                               {d_keys, D * 4, true},
                               {d_clocks, D * A * c, false}});
  return ingest_rows(
      buf, offsets, n, status, team(threads),
      [&](Cursor& cur, int64_t i) {
        return parse_map_value<C>(
            cur, hdr, hdr_len, A, K, D, clock + i * A, keys + i * K,
            eclocks + i * K * A, d_keys + i * D, d_clocks + i * D * A,
            [&](Cursor& cv, int64_t e) { return parse_val(cv, i, e); });
      },
      [&](int64_t i) {
        for (const Plane& p : planes) clear_row(p, i);
      });
}

// one Map value's bytes (the inverse of parse_map_value); out == nullptr
// is the counting pass, which skips the key sort.  ``emit_val(slot, out)``
// writes one value and returns its size.
template <typename C, typename EmitVal>
int64_t map_encode_one(const C* clock, const int32_t* keys, const C* eclocks,
                       const int32_t* d_keys, const C* d_clocks,
                       const uint8_t* hdr, size_t hdr_len, int64_t A,
                       int64_t K, int64_t D, uint8_t* out,
                       const EmitVal& emit_val) {
  const bool sizing = (out == nullptr);
  Emitter e{out};
  std::vector<int64_t> scratch;
  e.byte(kTagMap);
  for (size_t i = 0; i < hdr_len; ++i) e.byte(hdr[i]);
  emit_clock_body(e, clock, A, scratch, !sizing);
  std::vector<int64_t> slots;
  for (int64_t s = 0; s < K; ++s)
    if (keys[s] != kEmpty) slots.push_back(s);
  if (!sizing)
    std::sort(slots.begin(), slots.end(), [&](int64_t x, int64_t y) {
      return varint_bytes_less(
          static_cast<uint64_t>(static_cast<uint32_t>(keys[x])) << 1,
          static_cast<uint64_t>(static_cast<uint32_t>(keys[y])) << 1);
    });
  e.uv(static_cast<uint64_t>(slots.size()));
  for (int64_t s : slots) {
    e.tagged_nonneg(static_cast<uint64_t>(static_cast<uint32_t>(keys[s])));
    emit_clock_body(e, eclocks + s * A, A, scratch, !sizing);
    const int64_t m = emit_val(s, e.p);
    if (e.p) e.p += m;
    e.count += m;
  }
  emit_deferred_section(e, d_keys, d_clocks, A, D, scratch, sizing);
  return e.count;
}

template <typename C, typename EmitVal>
void map_encode(const C* clock, const int32_t* keys, const C* eclocks,
                const int32_t* d_keys, const C* d_clocks, int64_t n,
                const uint8_t* hdr, size_t hdr_len, int64_t A, int64_t K,
                int64_t D, int64_t* offsets, uint8_t* buf, int64_t threads,
                const EmitVal& emit_val) {
  encode_rows(n, offsets, buf, team(threads), [&](int64_t i, uint8_t* out) {
    return map_encode_one<C>(
        clock + i * A, keys + i * K, eclocks + i * K * A, d_keys + i * D,
        d_clocks + i * D * A, hdr, hdr_len, A, K, D, out,
        [&](int64_t s, uint8_t* p) { return emit_val(i * K + s, p); });
  });
}

}  // namespace

extern "C" {

#define MAP_LEGS(C, S)                                                        \
  int64_t map_mvreg_ingest_wire_##S(                                          \
      const uint8_t* buf, const int64_t* offsets, int64_t n, int64_t A,       \
      int64_t K, int64_t D, int64_t KV, C* clock, int32_t* keys, C* eclocks,  \
      C* vclocks, C* vvals, int32_t* d_keys, C* d_clocks, uint8_t* status,    \
      int64_t threads) {                                                      \
    return map_ingest<C>(                                                     \
        buf, offsets, n, kMVRegHdr, sizeof(kMVRegHdr), A, K, D, clock, keys,  \
        eclocks, d_keys, d_clocks,                                            \
        {{vclocks, int64_t(sizeof(C)) * K * KV * A, false},                   \
         {vvals, int64_t(sizeof(C)) * K * KV, false}},                        \
        status, threads, [&](Cursor& c, int64_t i, int64_t e) {              \
          const int64_t s = i * K + e;                                        \
          return value_status(parse_mvreg_one<C>(c, KV, A, vclocks + s * KV * A, \
                                                 vvals + s * KV));            \
        });                                                                   \
  }                                                                           \
  void map_mvreg_encode_wire_##S(                                             \
      const C* clock, const int32_t* keys, const C* eclocks,                  \
      const C* vclocks, const C* vvals, const int32_t* d_keys,                \
      const C* d_clocks, int64_t n, int64_t A, int64_t K, int64_t D,          \
      int64_t KV, int64_t* offsets, uint8_t* buf, int64_t threads) {          \
    map_encode<C>(clock, keys, eclocks, d_keys, d_clocks, n, kMVRegHdr,       \
                  sizeof(kMVRegHdr), A, K, D, offsets, buf, threads,          \
                  [&](int64_t s, uint8_t* p) {                                \
                    return mvreg_encode_one<C>(vclocks + s * KV * A,          \
                                               vvals + s * KV, KV, A, p);     \
                  });                                                         \
  }                                                                           \
  int64_t map_orswot_ingest_wire_##S(                                         \
      const uint8_t* buf, const int64_t* offsets, int64_t n, int64_t A,       \
      int64_t K, int64_t D, int64_t MV, int64_t DV, C* clock, int32_t* keys,  \
      C* eclocks, C* vclock, int32_t* vids, C* vdots, int32_t* vdids,         \
      C* vdclocks, int32_t* d_keys, C* d_clocks, uint8_t* status,             \
      int64_t threads) {                                                      \
    const int64_t c = sizeof(C);                                              \
    return map_ingest<C>(                                                     \
        buf, offsets, n, kOrswotHdr, sizeof(kOrswotHdr), A, K, D, clock,      \
        keys, eclocks, d_keys, d_clocks,                                      \
        {{vclock, c * K * A, false},                                          \
         {vids, 4 * K * MV, true},                                            \
         {vdots, c * K * MV * A, false},                                      \
         {vdids, 4 * K * DV, true},                                           \
         {vdclocks, c * K * DV * A, false}},                                  \
        status, threads, [&](Cursor& cur, int64_t i, int64_t e) {            \
          const int64_t s = i * K + e;                                        \
          return value_status(parse_orswot_value<C>(                          \
              cur, A, MV, DV, vclock + s * A, vids + s * MV,                  \
              vdots + s * MV * A, vdids + s * DV, vdclocks + s * DV * A));    \
        });                                                                   \
  }                                                                           \
  void map_orswot_encode_wire_##S(                                            \
      const C* clock, const int32_t* keys, const C* eclocks,                  \
      const C* vclock, const int32_t* vids, const C* vdots,                   \
      const int32_t* vdids, const C* vdclocks, const int32_t* d_keys,         \
      const C* d_clocks, int64_t n, int64_t A, int64_t K, int64_t D,          \
      int64_t MV, int64_t DV, int64_t* offsets, uint8_t* buf,                 \
      int64_t threads) {                                                      \
    map_encode<C>(clock, keys, eclocks, d_keys, d_clocks, n, kOrswotHdr,      \
                  sizeof(kOrswotHdr), A, K, D, offsets, buf, threads,         \
                  [&](int64_t s, uint8_t* p) {                                \
                    return encode_one<C>(vclock + s * A, vids + s * MV,       \
                                         vdots + s * MV * A, vdids + s * DV,  \
                                         vdclocks + s * DV * A, A, MV, DV, p); \
                  });                                                         \
  }                                                                           \
  int64_t map_map_mvreg_ingest_wire_##S(                                      \
      const uint8_t* buf, const int64_t* offsets, int64_t n, int64_t A,       \
      int64_t K, int64_t D, int64_t K2, int64_t D2, int64_t KV, C* clock,     \
      int32_t* keys, C* eclocks, C* iclock, int32_t* ikeys, C* ieclocks,      \
      C* vclocks, C* vvals, int32_t* id_keys, C* id_clocks, int32_t* d_keys,  \
      C* d_clocks, uint8_t* status, int64_t threads) {                        \
    const int64_t c = sizeof(C);                                              \
    return map_ingest<C>(                                                     \
        buf, offsets, n, kMapMVRegHdr, sizeof(kMapMVRegHdr), A, K, D, clock,  \
        keys, eclocks, d_keys, d_clocks,                                      \
        {{iclock, c * K * A, false},                                          \
         {ikeys, 4 * K * K2, true},                                           \
         {ieclocks, c * K * K2 * A, false},                                   \
         {vclocks, c * K * K2 * KV * A, false},                               \
         {vvals, c * K * K2 * KV, false},                                     \
         {id_keys, 4 * K * D2, true},                                         \
         {id_clocks, c * K * D2 * A, false}},                                 \
        status, threads, [&](Cursor& cur, int64_t i, int64_t e) {            \
          const int64_t s = i * K + e;                                        \
          return value_status(parse_map_value<C>(                             \
              cur, kMVRegHdr, sizeof(kMVRegHdr), A, K2, D2, iclock + s * A,   \
              ikeys + s * K2, ieclocks + s * K2 * A, id_keys + s * D2,        \
              id_clocks + s * D2 * A, [&](Cursor& cv, int64_t e2) {           \
                const int64_t t = s * K2 + e2;                                \
                return value_status(parse_mvreg_one<C>(                       \
                    cv, KV, A, vclocks + t * KV * A, vvals + t * KV));        \
              }));                                                            \
        });                                                                   \
  }                                                                           \
  void map_map_mvreg_encode_wire_##S(                                         \
      const C* clock, const int32_t* keys, const C* eclocks,                  \
      const C* iclock, const int32_t* ikeys, const C* ieclocks,               \
      const C* vclocks, const C* vvals, const int32_t* id_keys,               \
      const C* id_clocks, const int32_t* d_keys, const C* d_clocks,           \
      int64_t n, int64_t A, int64_t K, int64_t D, int64_t K2, int64_t D2,     \
      int64_t KV, int64_t* offsets, uint8_t* buf, int64_t threads) {          \
    map_encode<C>(                                                            \
        clock, keys, eclocks, d_keys, d_clocks, n, kMapMVRegHdr,              \
        sizeof(kMapMVRegHdr), A, K, D, offsets, buf, threads,                 \
        [&](int64_t s, uint8_t* p) {                                          \
          return map_encode_one<C>(                                           \
              iclock + s * A, ikeys + s * K2, ieclocks + s * K2 * A,          \
              id_keys + s * D2, id_clocks + s * D2 * A, kMVRegHdr,            \
              sizeof(kMVRegHdr), A, K2, D2, p, [&](int64_t s2, uint8_t* p2) { \
                const int64_t t = s * K2 + s2;                                \
                return mvreg_encode_one<C>(vclocks + t * KV * A,              \
                                           vvals + t * KV, KV, A, p2);        \
              });                                                             \
        });                                                                   \
  }

MAP_LEGS(uint32_t, u32)
MAP_LEGS(uint64_t, u64)
#undef MAP_LEGS

}  // extern "C"
