// fused_ot: up to k phases of the OT solver (paper Algorithm 2) for a
// whole batch in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel fused_ot_phases
// (src/repro/kernels/fused_phase.py:334, body _ot_kernel at :230). Each
// phase: rounds in which every row with free supply proposes all of it to
// one hash-random admissible column with hi-cluster capacity left, and
// columns grant FIFO by row order (exclusive prefix of the amounts); then
// push (the displaced hi flow is stripped bottom rows first) and relabel
// (granted units land one level down, an emptied hi cluster collapses,
// rows of B' with supply left rise by one). It equals the stepped core
// (core/transport.run_ot_phases) bit for bit: the salt of round r is
// phases*7919 + r, the propose rule is propose.cuh's, the grant of a row
// is clip(cap[t] - (excl - base[t]), 0, amt) with excl the exclusive
// prefix of the amounts over the lane's rows and base[t] the least excl
// among the proposers of column t, the round cap is the caller's
// max_rounds, and the phase condition is checked before every phase.
//
// What bounds it: each round reads c_int once for every row that still
// proposes; a phase reads and rewrites f_hi and f_lo only in the row
// tiles of the columns that granted and hold flow there; the state is
// copied in and out once per launch. Between the steps the grid waits at
// a barrier.
//
// Design: a persistent cooperative kernel (every block that can be
// resident at once), the state and scratch in global memory. Barriers:
//
//   2 at entry (copy the state in | column sums, free supply), then per
//   phase: set-up | 2 per round (propose | grant) | push | relabel
//
// so at most 2 + sum over phases of (3 + 2 * rounds of the phase), the
// rounds of a phase being those of its longest-running lane.
//
// Rounds sized to the live proposers. Within a phase y_b and ya_hi are
// fixed, rem and cap only fall, so a row that does not propose in round r
// never proposes again in the phase; one that proposes and gets all of
// its amount has nothing left. Round r + 1's candidates are round r's
// proposers with supply left, listed by the grant step in row order
// (round 0's are every row of the lanes that take the phase). The list
// is flat: each lane's rows are one contiguous, row-ordered run of it
// (lstart, lcount), so the grant step of a lane walks only its run and
// its FIFO prefix is the reference's (rows off the run have amount 0).
// The proposal (prop) and the supply left (lrem) are kept by list
// position, so an entry is three independent loads.
//   propose  over the list: one warp per row when it has at least as many
//            rows as resident warps, else one block per row (8 warps
//            split the columns, merge through shared memory);
//   grant    one block per live lane, over its run, in tiles of 1024
//            entries (a run of one tile stays in registers), three
//            passes with a block barrier between: the exclusive prefix
//            and an atomicMin into the column's base; the grants from
//            the capacity at the round's start, and the ranks of the
//            rows that keep supply (the next run's place is reserved with
//            one atomicAdd); then the grants are applied: added at once
//            to f_lo and to its tile sum (nothing reads f_lo before the
//            phase's end, and f_lo + granted is what the reference
//            writes), subtracted from cap with atomicSub (a round's
//            grants to a column sum to at most its capacity, so only
//            the last can empty it), and the next run written in row
//            order.
// Loop control is uniform: the round loop ends when no lane takes round
// r (live[r % 3], counted by the grant step of round r - 1 and read after
// the barrier; the counter of round r + 1 is cleared at the start of
// round r, two barriers after its last reader).
//
// End of a phase, limited to the columns that granted and the tiles that
// hold flow. A column with no grant keeps its f_hi and f_lo columns,
// ya_hi and free_a (disp = 0, no collapse), so it is not read. The first
// grant of a column marks its group of 32 adjacent columns (a warp's
// coalesced 128 bytes) and lists the group once. The launch keeps the
// sums of f_hi and f_lo over each (group, tile of kRows rows) and column
// (hsum, lsum); f_hi, f_lo >= 0, so a zero sum is an empty tile. Work
// items are (group, tile), one warp each, lane = column:
//   push     per item, the sum of f_hi below the tile from hsum; the rows
//            bottom-up while some lane still strips (take = min(max(disp
//            - S_i, 0), f) with S_i the sum below row i; addition mod
//            2^32 is associative, so any order of the partial sums gives
//            the reference's bits), f_hi -= take, freed += take; a
//            collapsing column moves f_lo into f_hi over the tiles where
//            either holds flow. Tiles without work are not read. The new
//            tile sums go to hnew;
//   relabel  y_b, free_b = rem + freed, the free supply of the next
//            phase; per listed column free_a, ya_hi, hsum from hnew (lsum
//            cleared where the column collapsed) and the column sum:
//            fsum - min(max(disp, 0), fsum), or the sum of hnew after a
//            collapse.
// The entry copies f_hi and f_lo by the same items and computes hsum and
// lsum on the way.
//
// Workspace (fused_ot_workspace(B, nb, na), 16-byte aligned pieces;
// G = ceil(na / 32) groups, T = ceil(nb / kRows) tiles):
//   rem, prop, excl, freed  (B, nb) i32      supply left, proposal (by
//                                            list position), prefix then
//                                            grant (runs of more than one
//                                            tile), stripped hi flow
//   cand, lrem              (2, B*nb) i32    candidate lists and their
//                                            supply, by round parity
//   cap, cap0, colfhi, base, ccoll, cfa, cnew  (B, na) i32
//   avail                   (B, na) u8       cap > 0
//   gflag, glist            (B*G) i32        group marked / listed
//   hsum, lsum, hnew        (B*G*T*32) i32   tile sums
//   lstart, lcount          (2, B) i32       each lane's run, by parity
//   lane_on, done           (B) i32
//   free_sum                (2, B) i32       by phase parity
//   counters                8 i32            live (3), cand_len (3), glen
// about 4 B (8 nb + 8 na) + B na + 12 B nb na / kRows bytes (3/64 of one
// flow matrix for the tile sums). No allocation inside the kernel.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "propose.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                 // entries per thread, grant
constexpr int kTile = kThreads * kItems;  // entries per grant tile
constexpr int kRows = 64;                 // rows per column tile
constexpr int kChunk = 8;                 // rows loaded at once

struct Args {
  const int *c;  // (B, nb, na) costs in units of eps
  // the state as given (read only) ...
  const int *yb_in, *yahi_in, *fb_in, *fa_in, *fhi_in, *flo_in, *ph_in,
      *rd_in;
  // ... the per-lane limits ...
  const int *thr, *cap_lim;
  // ... and the state as returned, updated in place by the kernel
  int *yb, *yahi, *fb, *fa, *fhi, *flo, *ph, *rd;
  // scratch (see the workspace layout above)
  int *rem, *prop, *excl, *freed, *cand, *lrem;
  int *cap, *cap0, *colfhi, *base, *ccoll, *cfa, *cnew;
  unsigned char *avail;
  int *gflag, *glist, *hsum, *lsum, *hnew, *lstart, *lcount, *lane_on, *done,
      *free_sum;
  int *live, *cand_len, *glen;
  int B, nb, na, k, max_rounds, G, T;
};

struct Layout {
  long long rem, prop, excl, freed, cand, lrem, cap, cap0, colfhi, base,
      ccoll, cfa, cnew, avail, gflag, glist, hsum, lsum, hnew, lstart, lcount,
      lane_on, done, free_sum, counters, total;
};

long long align16(long long x) { return (x + 15) & ~15ll; }

Layout workspace_layout(int B, int nb, int na) {
  const long long Bm = (long long)B * nb, Bn = (long long)B * na;
  const long long BG = (long long)B * ((na + 31) / 32);
  const long long T = (nb + kRows - 1) / kRows;
  Layout l;
  long long at = 0;
  auto take = [&at](long long bytes) {
    const long long here = at;
    at = align16(at + bytes);
    return here;
  };
  l.rem = take(4 * Bm);
  l.prop = take(4 * Bm);
  l.excl = take(4 * Bm);
  l.freed = take(4 * Bm);
  l.cand = take(8 * Bm);
  l.lrem = take(8 * Bm);
  l.cap = take(4 * Bn);
  l.cap0 = take(4 * Bn);
  l.colfhi = take(4 * Bn);
  l.base = take(4 * Bn);
  l.ccoll = take(4 * Bn);
  l.cfa = take(4 * Bn);
  l.cnew = take(4 * Bn);
  l.avail = take(Bn);
  l.gflag = take(4 * BG);
  l.glist = take(4 * BG);
  l.hsum = take(4 * BG * T * 32);
  l.lsum = take(4 * BG * T * 32);
  l.hnew = take(4 * BG * T * 32);
  l.lstart = take(8ll * B);
  l.lcount = take(8ll * B);
  l.lane_on = take(4ll * B);
  l.done = take(4ll * B);
  l.free_sum = take(8ll * B);
  l.counters = take(4 * 8);
  l.total = at;
  return l;
}

__device__ __forceinline__ bool lane_runs(const Args &a, const int *fs,
                                          int b) {
  const int ph = __ldcg(a.ph + b);
  return __ldcg(fs + b) > a.thr[b] && ph < a.cap_lim[b] &&
         ph - a.ph_in[b] < a.k;
}

// int32 arithmetic that wraps, as the reference's
__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((uint32_t)x + (uint32_t)y);
}
__device__ __forceinline__ int wrap_sub(int x, int y) {
  return (int)((uint32_t)x - (uint32_t)y);
}

// Exclusive scan of v over the block (uint32, wrapping); total gets the
// block's sum. Every thread calls it; s_w holds kWarps words.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t *s_w,
                                               uint32_t &total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_w[warp] = incl;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = s_w[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before + incl - v;
}

// One thread's share of a row's scan: the columns from `first` in steps
// of `step` (4-column groups when kVec). Column j is admissible if
// y_b + ya_hi[j] == c[j] + 1 and avail[j] (visit, propose.cuh). ya_hi and
// avail are written by other blocks between barriers, so they are read
// from L2.
template <bool kVec>
__device__ __forceinline__ void scan_row(const int *__restrict__ crow,
                                         const int *ya,
                                         const unsigned char *av, int yb,
                                         uint32_t base, int n, int first,
                                         int step, unsigned long long &best,
                                         bool &any) {
  if constexpr (kVec) {
    const int4 *c4 = reinterpret_cast<const int4 *>(crow);
    const int4 *ya4 = reinterpret_cast<const int4 *>(ya);
    const uchar4 *av4 = reinterpret_cast<const uchar4 *>(av);
#pragma unroll 2
    for (int q = first; q < (n >> 2); q += step) {
      const int4 cv = __ldg(c4 + q);
      const int4 yv = __ldcg(ya4 + q);
      const uchar4 avv = __ldcg(av4 + q);
      const int j = q << 2;
      visit(cv.x, yb, yv.x, avv.x, base, j, best, any);
      visit(cv.y, yb, yv.y, avv.y, base, j + 1, best, any);
      visit(cv.z, yb, yv.z, avv.z, base, j + 2, best, any);
      visit(cv.w, yb, yv.w, avv.w, base, j + 3, best, any);
    }
  } else {
#pragma unroll 4
    for (int j = first; j < n; j += step)
      visit(__ldg(crow + j), yb, __ldcg(ya + j), __ldcg(av + j), base, j,
            best, any);
  }
}

__device__ __forceinline__ unsigned long long warp_min(
    unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Adds v to cnt[b] over the warp: one atomicAdd when every lane has the
// same b (the common case), else one per lane with v != 0.
__device__ __forceinline__ void warp_add(int *cnt, int b, int v) {
  const int b0 = __shfl_sync(0xFFFFFFFFu, b, 0);
  if (__all_sync(0xFFFFFFFFu, b == b0)) {
    const int s = __reduce_add_sync(0xFFFFFFFFu, v);
    if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(cnt + b0, s);
  } else if (v != 0) {
    atomicAdd(cnt + b, v);
  }
}

// The row x = b * nb + i of the candidate at list position t in round r.
__device__ __forceinline__ int cand_row(const Args &a, int r, int t) {
  return r == 0 ? t : __ldcg(a.cand + (long long)(r & 1) * a.B * a.nb + t);
}

// The propose step of round r: every candidate row with supply left
// writes its column (or -1) to prop at its list position.
template <bool kVec>
__device__ void propose_step(const Args &a, int r, int len,
                             unsigned long long *s_best, int *s_any) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nb, na = a.na;
  if (len >= (int)gridDim.x * kWarps) {
    // one warp per candidate row
    for (int t = blockIdx.x * kWarps + warp; t < len;
         t += gridDim.x * kWarps) {
      const int x = cand_row(a, r, t);
      const int b = x / nb, i = x - b * nb;
      if (r == 0 && !__ldcg(a.lane_on + b)) continue;
      int col = -1;
      if (r > 0 || __ldcg(a.rem + x) > 0) {
        unsigned long long best = ~0ull;
        bool any = false;
        scan_row<kVec>(a.c + (long long)x * na, a.yahi + (long long)b * na,
                       a.avail + (long long)b * na, __ldcg(a.yb + x),
                       (uint32_t)i * kH1 +
                           round_salt(__ldcg(a.ph + b), r) * kH3,
                       na, lane, 32, best, any);
        best = warp_min(best);
        if (__any_sync(0xFFFFFFFFu, any)) col = (int)(best & 0xFFFFFFFFull);
      }
      if (lane == 0) a.prop[t] = col;
    }
  } else {
    // one block per candidate row
    for (int t = blockIdx.x; t < len; t += gridDim.x) {
      const int x = cand_row(a, r, t);
      const int b = x / nb, i = x - b * nb;
      // the same on every thread of the block
      if (r == 0 && !__ldcg(a.lane_on + b)) continue;
      if (r == 0 && __ldcg(a.rem + x) <= 0) {
        if (threadIdx.x == 0) a.prop[t] = -1;
        continue;
      }
      unsigned long long best = ~0ull;
      bool any = false;
      scan_row<kVec>(a.c + (long long)x * na, a.yahi + (long long)b * na,
                     a.avail + (long long)b * na, __ldcg(a.yb + x),
                     (uint32_t)i * kH1 +
                         round_salt(__ldcg(a.ph + b), r) * kH3,
                     na, threadIdx.x, kThreads, best, any);
      best = warp_min(best);
      any = __any_sync(0xFFFFFFFFu, any);
      if (lane == 0) {
        s_best[warp] = best;
        s_any[warp] = any;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        bool row_any = false;
        for (int w = 0; w < kWarps; ++w) {
          best = s_best[w] < best ? s_best[w] : best;
          row_any = row_any || s_any[w];
        }
        a.prop[t] = row_any ? (int)(best & 0xFFFFFFFFull) : -1;
      }
      __syncthreads();
    }
  }
}

// One entry of a lane's run: its row, the column it proposed (-1: none)
// and the amount (its supply left, 0 when it did not propose).
struct Entry {
  int x, p, amt;
};

// Entries by list position: the row, its proposal and its supply are
// three independent loads (round 0's list is the identity, its supply
// rem).
__device__ __forceinline__ void load_tile(const Args &a, const int *list,
                                          const int *lrem, int r, int start,
                                          int len, int t0,
                                          Entry (&en)[kItems]) {
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int t = t0 + threadIdx.x * kItems + u;
    en[u] = {-1, -1, 0};
    if (t < len) {
      const int pos = start + t;
      const int x = r == 0 ? pos : __ldcg(list + pos);
      const int p = __ldcg(a.prop + pos);
      const int amt = __ldcg((r == 0 ? a.rem : lrem) + pos);
      en[u] = {x, p, p >= 0 ? amt : 0};
    }
  }
}

// The grant step of round r for lane b, by one whole block, over the
// lane's run of the round's list, in tiles of kTile entries (a run of one
// tile keeps its entries in registers from pass to pass).
__device__ void grant_lane(const Args &a, int b, int r, uint32_t *s_w,
                           int *s_int) {
  const int nb = a.nb, na = a.na;
  const long long Bm = (long long)a.B * nb, col0 = (long long)b * na;
  const int start = r == 0 ? b * nb : __ldcg(a.lstart + (r & 1) * a.B + b);
  const int len = r == 0 ? nb : __ldcg(a.lcount + (r & 1) * a.B + b);
  const int *list = a.cand + (long long)(r & 1) * Bm;
  int *next = a.cand + (long long)((r + 1) & 1) * Bm;
  const int *lrem = a.lrem + (long long)(r & 1) * Bm;
  int *next_rem = a.lrem + (long long)((r + 1) & 1) * Bm;
  const bool one = len <= kTile;
  Entry en[kItems];
  int ex[kItems];
  // pass 1: exclusive prefix of the amounts in row order; the columns'
  // bases
  uint32_t carry = 0;
  bool any = false;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    load_tile(a, list, lrem, r, start, len, t0, en);
    uint32_t sum = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) sum += (uint32_t)en[u].amt;
    uint32_t total;
    uint32_t e = carry + block_scan(sum, s_w, total);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      ex[u] = (int)e;
      if (en[u].p >= 0) {
        if (!one) a.excl[en[u].x] = (int)e;
        atomicMin(a.base + col0 + en[u].p, (int)e);
        any = true;
      }
      e += (uint32_t)en[u].amt;
    }
    carry += total;
  }
  if (!__syncthreads_or(any)) {
    // no row proposed: the lane's rounds of the phase have ended
    if (threadIdx.x == 0) {
      a.rd[b] += 1;
      a.done[b] = 1;
    }
    return;
  }
  // pass 2: the grants, FIFO by row order, from the capacity at the
  // round's start; the ranks of the rows that keep supply
  int g[kItems], rank[kItems], cap0[kItems];
  carry = 0;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    if (!one) {
      load_tile(a, list, lrem, r, start, len, t0, en);
#pragma unroll
      for (int u = 0; u < kItems; ++u)
        if (en[u].p >= 0) ex[u] = __ldcg(a.excl + en[u].x);
    }
    uint32_t keep = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int p = en[u].p;
      g[u] = 0;
      if (p < 0) continue;
      const int prefix = wrap_sub(ex[u], __ldcg(a.base + col0 + p));
      g[u] = min(max(wrap_sub(__ldcg(a.cap + col0 + p), prefix), 0),
                 en[u].amt);
      cap0[u] = __ldcg(a.cap0 + col0 + p);
      if (!one) a.excl[en[u].x] = g[u];
      rank[u] = (int)keep;
      keep += wrap_sub(en[u].amt, g[u]) > 0;
    }
    uint32_t total;
    const uint32_t before = carry + block_scan(keep, s_w, total);
#pragma unroll
    for (int u = 0; u < kItems; ++u) rank[u] += (int)before;
    carry += total;
  }
  // the next run's place: every read of cap and base is done
  if (threadIdx.x == 0) {
    const int at = carry ? atomicAdd(a.cand_len + (r + 1) % 3, (int)carry)
                         : 0;
    s_int[0] = at;
    a.lstart[((r + 1) & 1) * a.B + b] = at;
    a.lcount[((r + 1) & 1) * a.B + b] = (int)carry;
    a.rd[b] += 1;
    atomicAdd(a.live + (r + 1) % 3, 1);
  }
  __syncthreads();
  // pass 3: the grants into rem, f_lo and its tile sums, cap and avail;
  // the next run, a stable compaction
  const int at = s_int[0];
  carry = 0;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    uint32_t keep = 0;
    if (!one) {
      load_tile(a, list, lrem, r, start, len, t0, en);
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        g[u] = en[u].p >= 0 ? __ldcg(a.excl + en[u].x) : 0;
        cap0[u] = en[u].p >= 0 ? __ldcg(a.cap0 + col0 + en[u].p) : 0;
        rank[u] = (int)keep;
        keep += en[u].p >= 0 && wrap_sub(en[u].amt, g[u]) > 0;
      }
      uint32_t total;
      const uint32_t before = carry + block_scan(keep, s_w, total);
#pragma unroll
      for (int u = 0; u < kItems; ++u) rank[u] += (int)before;
      carry += total;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int p = en[u].p;
      if (p < 0) continue;
      const int x = en[u].x, left = wrap_sub(en[u].amt, g[u]);
      a.base[col0 + p] = INT_MAX;
      if (g[u] != 0) {
        a.rem[x] = left;
        // one grant per row and round: no other thread writes the cell
        atomicAdd(a.flo + (long long)x * na + p, g[u]);
        const int i = x - b * nb;
        atomicAdd(a.lsum + (((long long)b * a.G + p / 32) * a.T +
                            i / kRows) * 32 + (p & 31),
                  g[u]);
        // the grants of a round sum to at most the column's capacity, so
        // only the last can empty it
        const int old = atomicSub(a.cap + col0 + p, g[u]);
        if (wrap_sub(old, g[u]) <= 0) a.avail[col0 + p] = 0;
        // the column's first grant of the phase lists its group once
        const long long grp = (long long)b * a.G + p / 32;
        if (old == cap0[u] && !atomicExch(a.gflag + grp, 1))
          a.glist[atomicAdd(a.glen, 1)] = (int)grp;
      }
      if (left > 0) {
        next[at + rank[u]] = x;
        next_rem[at + rank[u]] = left;
      }
    }
  }
}

// A column's end of phase: what the reference's push and relabel give it,
// from its capacity before and after the rounds.
struct ColEnd {
  int disp, fa2, newsum;
  bool coll;
};

__device__ __forceinline__ ColEnd column_end(const Args &a, long long x) {
  const int yahi = __ldcg(a.yahi + x), fa = __ldcg(a.fa + x);
  const int fsum = __ldcg(a.colfhi + x);
  const int g_a = wrap_sub(__ldcg(a.cap0 + x), __ldcg(a.cap + x));
  const int use_free = min(g_a, yahi == 0 ? fa : 0);
  ColEnd e;
  e.disp = wrap_sub(g_a, use_free);
  e.fa2 = wrap_sub(fa, use_free);
  // f_hi >= 0, so the strip takes min(disp, column sum) in all
  e.newsum = wrap_sub(fsum, min(max(e.disp, 0), fsum));
  e.coll = wrap_add(yahi == 0 ? e.fa2 : 0, e.newsum) == 0 && g_a > 0;
  return e;
}

template <bool kVec>
// Two blocks per SM (at most 128 registers a thread): unbounded, the
// compiler takes 200 and the grid halves, which slows the propose scans
// more than it speeds the column work.
__global__ void __launch_bounds__(kThreads, 2) fused_ot_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long s_best[kWarps];
  __shared__ int s_any[kWarps];
  __shared__ uint32_t s_w[kWarps];
  __shared__ int s_int[2];
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long gwarp = gtid >> 5, nwarps = gsize >> 5;
  const int B = a.B, nb = a.nb, na = a.na, G = a.G, T = a.T;
  const long long Bm = (long long)B * nb, Bn = (long long)B * na;
  const long long BG = (long long)B * G;

  // copy the state in, f_hi and f_lo by (group, tile) with the tile sums
  for (long long w = gwarp; w < BG * T; w += nwarps) {
    const long long grp = w / T;
    const int t = (int)(w - grp * T);
    const int b = (int)(grp / G), j = (int)(grp - (long long)b * G) * 32 +
                                       lane;
    int s = 0, sl = 0;
    if (j < na) {
      const long long e0 = (long long)b * nb * na + j;
      const int *__restrict__ hi_in = a.fhi_in + e0;
      const int *__restrict__ lo_in = a.flo_in + e0;
      int *__restrict__ hi = a.fhi + e0;
      int *__restrict__ lo = a.flo + e0;
      const int i1 = min(nb, (t + 1) * kRows);
      for (int i0 = t * kRows; i0 < i1; i0 += kChunk) {
        int h[kChunk], l[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const long long e = (long long)(i0 + u) * na;
          h[u] = i0 + u < i1 ? hi_in[e] : 0;
          l[u] = i0 + u < i1 ? lo_in[e] : 0;
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (i0 + u >= i1) break;
          const long long e = (long long)(i0 + u) * na;
          hi[e] = h[u];
          lo[e] = l[u];
          s = wrap_add(s, h[u]);
          sl = wrap_add(sl, l[u]);
        }
      }
    }
    a.hsum[w * 32 + lane] = s;
    a.lsum[w * 32 + lane] = sl;
  }
  for (long long x = gtid; x < Bm; x += gsize) {
    a.yb[x] = a.yb_in[x];
    a.fb[x] = a.fb_in[x];
    a.freed[x] = 0;
  }
  for (long long x = gtid; x < Bn; x += gsize) {
    a.yahi[x] = a.yahi_in[x];
    a.fa[x] = a.fa_in[x];
    a.base[x] = INT_MAX;
  }
  for (long long x = gtid; x < BG; x += gsize) a.gflag[x] = 0;
  for (long long b = gtid; b < B; b += gsize) {
    a.ph[b] = a.ph_in[b];
    a.rd[b] = a.rd_in[b];
    a.free_sum[b] = 0;
    a.free_sum[B + b] = 0;
  }
  if (gtid < 8) a.live[gtid] = 0;  // live, cand_len and glen
  grid.sync();
  // column sums of f_hi from the tile sums; free supply per lane
  for (long long x = gtid; x < Bn; x += gsize) {
    const long long b = x / na;
    const int j = (int)(x - b * na);
    const int *ts = a.hsum + ((b * G + j / 32) * T) * 32 + (j & 31);
    int s = 0;
    for (int t = 0; t < T; ++t) s = wrap_add(s, __ldcg(ts + t * 32));
    a.colfhi[x] = s;
  }
  for (long long x0 = gtid - lane; x0 < Bm; x0 += gsize) {
    const long long x = x0 + lane;
    warp_add(a.free_sum, x < Bm ? (int)(x / nb) : 0,
             x < Bm ? a.fb[x] : 0);
  }
  grid.sync();

  for (int p = 0; p < a.k; ++p) {
    const int *fs = a.free_sum + (p & 1) * B;
    int *fs_next = a.free_sum + ((p + 1) & 1) * B;
    // phase set-up; the same decision in every block
    bool any_on = false;
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      any_on = any_on || lane_runs(a, fs, b);
    if (!__syncthreads_or(any_on)) break;
    for (long long b = gtid; b < B; b += gsize) {
      const bool on = lane_runs(a, fs, (int)b);
      a.lane_on[b] = on;
      a.done[b] = !on;
      fs_next[b] = 0;
      if (on) atomicAdd(a.live, 1);
    }
    for (long long x = gtid; x < Bm; x += gsize) a.rem[x] = a.fb[x];
    for (long long x = gtid; x < Bn; x += gsize) {
      // hi-cluster capacity available to M'
      const int c0 = wrap_add(a.yahi[x] == 0 ? a.fa[x] : 0, a.colfhi[x]);
      a.cap0[x] = c0;
      a.cap[x] = c0;
      a.avail[x] = c0 > 0;
    }
    if (gtid == 0) *a.glen = 0;
    grid.sync();

    for (int r = 0; r < a.max_rounds; ++r) {
      // no lane takes round r: every lane's rounds have ended
      if (__ldcg(a.live + r % 3) == 0) break;
      if (gtid == 0) {
        a.live[(r + 1) % 3] = 0;
        a.cand_len[(r + 1) % 3] = 0;
      }
      const int len = r == 0 ? (int)Bm : __ldcg(a.cand_len + r % 3);
      propose_step<kVec>(a, r, len, s_best, s_any);
      grid.sync();
      for (int b = blockIdx.x; b < B; b += gridDim.x)
        if (!__ldcg(a.done + b)) grant_lane(a, b, r, s_w, s_int);
      grid.sync();
    }

    // the column work, over (group, tile) items of the listed groups
    const long long items = (long long)__ldcg(a.glen) * T;
    if (gtid == 0) a.live[0] = 0;  // the next set-up counts into it
    // push: strip the displaced hi flow bottom rows first; relabel: an
    // emptied hi cluster moves f_lo into f_hi. The tile sums of f_hi and
    // f_lo say which tiles hold flow: a tile without any is not read.
    for (long long w = gwarp; w < items; w += nwarps) {
      const int grp = __ldcg(a.glist + w / T);
      const int t = (int)(w % T);
      const int b = grp / G, j = (grp - b * G) * 32 + lane;
      const long long x = (long long)b * na + j;
      const bool on = j < na;
      if (t == 0 && lane == 0) a.gflag[grp] = 0;
      ColEnd ce{0, 0, 0, false};
      if (on) ce = column_end(a, x);
      if (t == 0 && on) {
        a.ccoll[x] = ce.coll;
        a.cfa[x] = ce.fa2;
        a.cnew[x] = ce.newsum;
      }
      const int d = ce.disp;
      const bool coll = ce.coll;
      const long long ti = (long long)grp * T * 32 + lane;
      const int hs = __ldcg(a.hsum + ti + t * 32);
      const int ls = coll ? __ldcg(a.lsum + ti + t * 32) : 0;
      // the sum of f_hi below the tile, where a lane may strip here
      int below = 0;
      if (__any_sync(0xFFFFFFFFu, hs != 0 && (coll || d > 0))) {
#pragma unroll 8
        for (int u = t + 1; u < T; ++u)
          below = wrap_add(below, __ldcg(a.hsum + ti + u * 32));
      }
      const bool moves = coll && (hs != 0 || ls != 0);
      int taken = 0;
      if (__any_sync(0xFFFFFFFFu,
                     moves || (hs != 0 && wrap_sub(d, below) > 0))) {
        int *__restrict__ fhi = a.fhi + (long long)b * nb * na + j;
        int *__restrict__ flo = a.flo + (long long)b * nb * na + j;
        int *freed = a.freed + (long long)b * nb;
        const int i0 = t * kRows, i1 = min(nb, (t + 1) * kRows);
        const bool rd_hi = hs != 0, rd_lo = moves && ls != 0;
        // bottom-up, until no lane strips any more and none moves
        for (int top = i1; top > i0; top -= kChunk) {
          if (!__any_sync(0xFFFFFFFFu, moves || wrap_sub(d, below) > 0))
            break;
          const int lo_i = max(i0, top - kChunk);
          int f[kChunk], lo[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int i = top - 1 - u;
            const long long e = (long long)i * na;
            f[u] = (rd_hi && i >= lo_i) ? __ldcg(fhi + e) : 0;
            lo[u] = (rd_lo && i >= lo_i) ? __ldcg(flo + e) : 0;
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int i = top - 1 - u;
            if (i < lo_i) break;  // the same on every lane
            const long long e = (long long)i * na;
            const int take = min(max(wrap_sub(d, below), 0), f[u]);
            below = wrap_add(below, f[u]);
            if (moves) {
              if (lo[u] != f[u]) fhi[e] = lo[u];
              if (lo[u] != 0) flo[e] = 0;
            } else if (take != 0) {
              fhi[e] = wrap_sub(f[u], take);
            }
            if (take != 0) {
              atomicAdd(freed + i, take);
              taken = wrap_add(taken, take);
            }
          }
        }
      }
      // the tile's new f_hi sum: a collapsing column's is its f_lo's
      a.hnew[ti + t * 32] = coll ? ls : wrap_sub(hs, taken);
    }
    grid.sync();
    // relabel the rows of B'; free supply of the next phase; the column
    // sums of the collapsed columns
    for (long long x0 = gtid - lane; x0 < Bm; x0 += gsize) {
      const long long x = x0 + lane;
      int b = 0, f = 0;
      if (x < Bm) {
        b = (int)(x / nb);
        f = a.fb[x];
        if (__ldcg(a.lane_on + b)) {
          const int rem = __ldcg(a.rem + x);
          if (f > 0 && rem > 0) a.yb[x] += 1;
          f = wrap_add(rem, __ldcg(a.freed + x));
          a.fb[x] = f;
          a.freed[x] = 0;
        }
      }
      warp_add(fs_next, b, f);
    }
    // the listed columns: free_a, ya_hi, the tile sums and the column
    // sum of f_hi (a collapsed column's from its new tile sums, its f_lo
    // tile sums cleared)
    for (long long q = gtid; q < items / T * 32; q += gsize) {
      const int grp = __ldcg(a.glist + q / 32);
      const int b = grp / G, j = (grp - b * G) * 32 + (int)(q & 31);
      const long long x = (long long)b * na + j;
      if (j >= na) continue;
      const bool coll = __ldcg(a.ccoll + x);
      const long long ti = (long long)grp * T * 32 + (q & 31);
      a.fa[x] = __ldcg(a.cfa + x);
      int s = 0;
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        const int h = __ldcg(a.hnew + ti + t * 32);
        a.hsum[ti + t * 32] = h;
        if (coll) a.lsum[ti + t * 32] = 0;
        s = wrap_add(s, h);
      }
      if (coll) a.yahi[x] -= 1;
      a.colfhi[x] = coll ? s : __ldcg(a.cnew + x);
    }
    for (long long b = gtid; b < B; b += gsize)
      if (a.lane_on[b]) a.ph[b] += 1;
    grid.sync();
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// int32 tensors: c (B, nb, na); the state in (y_b, free_b (B, nb); ya_hi,
// free_a (B, na); f_hi, f_lo (B, nb, na); phases, rounds (B)); threshold,
// phase_cap (B); the state out, same shapes; ws a workspace of
// fused_ot_workspace(B, nb, na) bytes. ``vec`` != 0 selects the 16-byte
// loads (the caller checks na % 4 == 0 and 16-byte alignment of c and
// ya_hi). Returns the cudaError_t of the launch.
extern "C" long long fused_ot_workspace(int B, int nb, int na) {
  return workspace_layout(B, nb, na).total;
}

extern "C" int fused_ot_launch(
    const void *c, const void *yb_in, const void *yahi_in,
    const void *fb_in, const void *fa_in, const void *fhi_in,
    const void *flo_in, const void *ph_in, const void *rd_in,
    const void *thr, const void *cap_lim, void *yb, void *yahi, void *fb,
    void *fa, void *fhi, void *flo, void *ph, void *rd, void *ws, int B,
    int nb, int na, int k, int max_rounds, int vec, void *stream) {
  if (B == 0 || nb == 0 || na == 0 || k <= 0) return (int)cudaSuccess;
  // rows and groups are numbered in int32
  if ((long long)B * nb >= INT_MAX || (long long)B * na >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Layout l = workspace_layout(B, nb, na);
  char *w = static_cast<char *>(ws);
  Args a;
  a.c = static_cast<const int *>(c);
  a.yb_in = static_cast<const int *>(yb_in);
  a.yahi_in = static_cast<const int *>(yahi_in);
  a.fb_in = static_cast<const int *>(fb_in);
  a.fa_in = static_cast<const int *>(fa_in);
  a.fhi_in = static_cast<const int *>(fhi_in);
  a.flo_in = static_cast<const int *>(flo_in);
  a.ph_in = static_cast<const int *>(ph_in);
  a.rd_in = static_cast<const int *>(rd_in);
  a.thr = static_cast<const int *>(thr);
  a.cap_lim = static_cast<const int *>(cap_lim);
  a.yb = static_cast<int *>(yb);
  a.yahi = static_cast<int *>(yahi);
  a.fb = static_cast<int *>(fb);
  a.fa = static_cast<int *>(fa);
  a.fhi = static_cast<int *>(fhi);
  a.flo = static_cast<int *>(flo);
  a.ph = static_cast<int *>(ph);
  a.rd = static_cast<int *>(rd);
  auto i32 = [w](long long off) { return reinterpret_cast<int *>(w + off); };
  a.rem = i32(l.rem);
  a.prop = i32(l.prop);
  a.excl = i32(l.excl);
  a.freed = i32(l.freed);
  a.cand = i32(l.cand);
  a.lrem = i32(l.lrem);
  a.cap = i32(l.cap);
  a.cap0 = i32(l.cap0);
  a.colfhi = i32(l.colfhi);
  a.base = i32(l.base);
  a.ccoll = i32(l.ccoll);
  a.cfa = i32(l.cfa);
  a.cnew = i32(l.cnew);
  a.avail = reinterpret_cast<unsigned char *>(w + l.avail);
  a.gflag = i32(l.gflag);
  a.glist = i32(l.glist);
  a.hsum = i32(l.hsum);
  a.lsum = i32(l.lsum);
  a.hnew = i32(l.hnew);
  a.lstart = i32(l.lstart);
  a.lcount = i32(l.lcount);
  a.lane_on = i32(l.lane_on);
  a.done = i32(l.done);
  a.free_sum = i32(l.free_sum);
  a.live = i32(l.counters);
  a.cand_len = a.live + 3;
  a.glen = a.live + 6;
  a.B = B;
  a.nb = nb;
  a.na = na;
  a.k = k;
  a.max_rounds = max_rounds;
  a.G = (na + 31) / 32;
  a.T = (nb + kRows - 1) / kRows;

  void (*kernel)(Args) = vec ? fused_ot_kernel<true> : fused_ot_kernel<false>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every resident block, but no more than one warp per row or per
  // (group, tile) item needs
  const long long items = (long long)B * a.G * a.T;
  const long long want =
      (std::max<long long>((long long)B * nb, items) + kWarps - 1) / kWarps;
  const int grid = (int)std::min<long long>((long long)per_sm * sms,
                                            std::max<long long>(want, 1));
  void *args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel,
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
