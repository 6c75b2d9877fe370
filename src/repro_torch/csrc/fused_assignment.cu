// fused_assignment: up to k phases of the assignment solver (paper
// Algorithm 1) for a whole batch in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel fused_assignment_phases
// (src/repro/kernels/fused_phase.py:181, body _assignment_kernel at :87).
// Each phase: (I) greedy maximal matching M' on the admissible subgraph
// of the free rows B' by hash-keyed propose/accept rounds, (II) push (add
// M' to M, displacing the old partners of M' columns), (III) relabel
// (y_a -= 1 on M' columns, y_b += 1 on rows of B' still free). It equals
// the stepped core (core/pushrelabel.run_assignment_phases) bit for bit:
// the salt of round r is phases*7919 + r, a row proposes the first
// column of minimum key, the lowest proposing row wins a column, the
// round cap is min(m, n) + 1 of the bucket's shape, and the phase
// condition free > threshold & phases < phase_cap & phases - start < k is
// checked before every phase, lane by lane.
//
// What bounds it: a propose round reads the c_int row of every row that
// still proposes (4 bytes per element); the rest of the state is a few
// vectors. Late in a solve few rows are left, so a round lasts as long as
// the scan of one row and the barrier after it: the time goes to
// latency, not bytes.
//
// Two paths, one algorithm; kernels/ops.py::fused_assignment_route picks
// one per launch from (B, m, n, the SM count) and passes it as `cluster`:
//
//   - the grid path (cluster 0): the whole bucket in lockstep on the whole
//     card, a grid barrier a step. It brings every SM to a round of one
//     large lane (the B = 1 Fig. 1 bucket, 10 000^2, whose early rounds
//     read up to 400 MB), but every step of every lane pays a whole-card
//     barrier and a chain of L2 round trips, and a phase lasts as long as
//     its longest lane's matching.
//   - the per-lane path (cluster C in 1..8): each lane alone in a
//     thread-block cluster of C blocks, from its state in to termination
//     or k phases, its loop state in shared memory and a cluster barrier
//     a step; no lane waits for another. Bounded by a block's shared
//     memory (8 bytes a column and 20 a row over C: m = n up to ~22 000)
//     and m <= 65535 (its won packs round and row in 32 bits), and by C
//     SMs' reads in a lane's early rounds. See "The per-lane path" below.
//
// The grid path. A persistent cooperative kernel (every block that can be
// resident at once; cudaLaunchCooperativeKernel refuses more), the state
// and scratch in global memory, grid.sync() between steps. Per chunk:
//
//   2 barriers at entry (copy the state in | count the free rows), then
//   per phase: set-up | round 0 | round 1 | ... | round R | push, relabel
//
// one barrier after each step, so at most 2 + sum over phases of
// (2 + rounds of the phase) barriers, where the rounds of a phase are
// those of its longest-running lane, its last (empty) round included.
//
// One barrier per round: accept is folded into the next round.
//   - won (B, n) holds, per column, (round << 32) | row of the column's
//     winner in this phase, ~0 while no row took it; proposers atomicMin
//     into it, so the lowest proposing row of a round wins, and a column
//     is proposed to in one round only (it is taken in that round). So
//     "available at the start of round r" is exactly (won >> 32) >= r,
//     whether or not another row of round r has proposed to it yet: the
//     scan needs no snapshot and no avail array.
//   - At the start of round r + 1, a row that proposed in round r reads
//     won[prop]: if its low word is the row, the row is matched in M' and
//     leaves; otherwise it proposes again.
//   - Push derives M' from prop and won alone (row i won iff
//     won[prop[i]] names it; column j is new in M' iff won[j] != ~0), so
//     it is right whichever round resolved a proposal or none did. (None
//     is left in practice: every round with proposals matches a row and
//     takes a column, so a lane has at most min(m, n) such rounds and its
//     round min(m, n), the cap's last, proposes nothing.)
//
// Propose work sized to the live rows. Within a phase y_b, y_a are fixed
// and the available columns only shrink, so a row that does not propose
// in round r never proposes again in the phase. Round r + 1's candidates
// are round r's proposers (each appends its row to a list); round 0's are
// B', listed at set-up. After the barrier every block reads the list's
// length and makes the same choice: with at least as many candidates as
// resident warps, one warp per row; with fewer, one block per row, its 8
// warps splitting the columns and merging their minima through shared
// memory. No step of a round walks rows off the list or all columns.
// Appends take one atomicAdd per block and step (a warp-per-row step
// lists up to 8 rows at once; a block-per-row block keeps its rows in
// shared memory until the round's end), so the list counter is not a
// point of contention.
//
// Loop control is uniform across blocks: the round loop ends when round
// r - 1 listed no proposer (read from its counter right after the
// barrier, and nothing writes that counter until two rounds later), the
// phase loop when no lane takes the phase (read from the free counts
// right after the barrier). Per-lane flags (any row proposed, the lane's
// matching done, its round count) are kept by one thread per lane.
// Counters by parity (or round mod 3 where a counter is read by every
// block at the start of a round) let a round reset the buffers of a
// round whose readers have all passed a barrier since.
//
// The result is deterministic although the list order is not: a row's
// proposal is the packed first minimum (key << 32) | col over its
// available columns, which do not depend on the order in which other rows
// of the round run; a column's winner is an atomicMin.
//
// The per-lane path. Cluster q takes lanes q, q + Q, ... (Q clusters, as
// many as can be resident, at most B), so a lane runs out on its own. Row
// i of the lane lives in block i % C: its match_ba, y_b, prop and the
// block's candidate lists, in shared memory. won and y_a of every column
// are copied into each block: a scan reads them for every column, a
// proposal writes one, so a proposal writes its key into the C copies
// (red.shared::cluster.min through mapa) and every scan reads its own
// block's. won is 32 bits, (round << 16) | row: a 64-bit atom.min on
// another block's shared memory is not atomic on the H100 (a test of it
// loses updates; the 32-bit one loses none). y_a changes at relabel only,
// and each block relabels its copy. Per lane:
//
//   1 barrier at entry (state in, free rows counted), then per phase:
//   round 0 | round 1 | ... | round R | push, relabel
//
// one cluster barrier after each step. Round r's proposers are round
// r + 1's candidates, listed by the block that owns the row; the counts
// that end a loop (a round's proposers, a phase's free rows) are written
// into every block (st.shared::cluster), so every block of the cluster
// takes the same branches and passes the same barriers. A block scans
// its candidates a warp a row, or, with fewer candidates than warps, the
// warps split over the rows and merge their minima through shared memory.
// Inside the loop only the cost rows are read from device memory, in the
// grid path's 16-byte __ldg loads, eight in flight a thread; match_ab is
// written to the state out as columns are taken, the rest of the state
// at the end. It needs no workspace. It is built for one and for two
// blocks an SM; the launcher takes the second where the lanes outnumber
// the first's resident clusters (15 clusters of 8 on an H100). Each
// build is the faster on its side of that line: the 2-block build at
// B = 16 (12.3 against 17.7 ms at 1024^2), the 1-block build, with more
// registers a thread, at B = 2-8 (by a median 6 %, n = 1024 and 4096;
// PERF.md section 6).
//
// Workspace of the grid path (fused_assignment_workspace, 16-byte aligned
// pieces):
//   won      (B, n) u64    winner of each column in this phase, ~0
//   prop     (B, m) i32    last column a row of B' proposed to, -1
//   cand     (2, B*m) i32  candidate rows b*m + i, by round parity
//   cand_len (3) i32       list lengths, by round mod 3
//   lane_on, done (B) i32  the lane takes the phase / its matching ended
//   any_prop (2, B) i32    some row of the lane proposed, by round parity
//   free_cnt (2, B) i32    free valid rows, by phase parity

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
constexpr unsigned long long kFree = ~0ull;  // won[] of an untaken column

struct Args {
  const int *c;  // (B, m, n) costs in units of eps
  // the state as given (read only) ...
  const int *mba_in, *mab_in, *yb_in, *ya_in, *ph_in, *rd_in, *sni_in;
  // ... the per-lane limits ...
  const int *thr, *cap, *mvalid;
  // ... and the state as returned, updated in place by the kernel
  int *mba, *mab, *yb, *ya, *ph, *rd, *sni;
  // scratch (see the workspace layout above)
  unsigned long long *won;
  int *prop, *cand, *cand_len, *lane_on, *done, *any_prop, *free_cnt;
  int B, m, n, k, vec;
};

// Offsets, in bytes, of the scratch arrays in one workspace.
struct Layout {
  long long won, prop, cand, cand_len, lane_on, done, any_prop, free_cnt,
      total;
};

__host__ __device__ long long align16(long long x) { return (x + 15) & ~15ll; }

Layout workspace_layout(int B, int m, int n) {
  const long long Bm = (long long)B * m, Bn = (long long)B * n;
  Layout l;
  long long at = 0;
  auto take = [&at](long long bytes) {
    const long long here = at;
    at = align16(at + bytes);
    return here;
  };
  l.won = take(8 * Bn);
  l.prop = take(4 * Bm);
  l.cand = take(8 * Bm);
  l.cand_len = take(4 * 3);
  l.lane_on = take(4ll * B);
  l.done = take(4ll * B);
  l.any_prop = take(8ll * B);
  l.free_cnt = take(8ll * B);
  l.total = at;
  return l;
}

// The phase condition of lane b, from the free count of this phase.
__device__ __forceinline__ bool lane_runs(const Args &a, const int *fc,
                                          int b) {
  const int ph = a.ph[b];
  return __ldcg(fc + b) > a.thr[b] && ph < a.cap[b] &&
         ph - a.ph_in[b] < a.k;
}

// One thread's share of a row's scan in round r: the columns from
// `first` in steps of `step` (in 4-column groups when kVec). Column j is
// admissible if y_b + y_a[j] == c[j] + 1 and it was available at the
// start of the round. Folds (key << 32) | j into `best` (visit,
// propose.cuh).
template <bool kVec>
__device__ __forceinline__ void scan_row(const int *__restrict__ crow,
                                         const int *ya,
                                         const unsigned long long *won,
                                         int yb, uint32_t base, int n,
                                         uint32_t r, int first, int step,
                                         unsigned long long &best,
                                         bool &any) {
  if constexpr (kVec) {
    const int4 *c4 = reinterpret_cast<const int4 *>(crow);
    const int4 *ya4 = reinterpret_cast<const int4 *>(ya);
    // two columns per 16 bytes: (lo, hi) words, little-endian
    const uint4 *w4 = reinterpret_cast<const uint4 *>(won);
#pragma unroll 2
    for (int q = first; q < (n >> 2); q += step) {
      const int4 cv = __ldg(c4 + q);
      const int4 yv = ya4[q];
      const uint4 w01 = __ldcg(w4 + 2 * q);
      const uint4 w23 = __ldcg(w4 + 2 * q + 1);
      const int j = q << 2;
      visit(cv.x, yb, yv.x, w01.y >= r, base, j, best, any);
      visit(cv.y, yb, yv.y, w01.w >= r, base, j + 1, best, any);
      visit(cv.z, yb, yv.z, w23.y >= r, base, j + 2, best, any);
      visit(cv.w, yb, yv.w, w23.w >= r, base, j + 3, best, any);
    }
  } else {
#pragma unroll 4
    for (int j = first; j < n; j += step) {
      const bool av = (uint32_t)(__ldcg(won + j) >> 32) >= r;
      visit(__ldg(crow + j), yb, ya[j], av, base, j, best, any);
    }
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

// Appends x to list where pred, with one atomicAdd on *len per block.
// Every thread of the block calls it.
__device__ __forceinline__ void block_append(bool pred, int x, int *list,
                                             int *len, int *s_cnt,
                                             int *s_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, pred);
  if (lane == 0) s_cnt[warp] = __popc(ball);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cnt[w];
      s_cnt[w] = total;
      total += c;
    }
    *s_base = total ? atomicAdd(len, total) : 0;
  }
  __syncthreads();
  if (pred)
    list[*s_base + s_cnt[warp] + __popc(ball & ((1u << lane) - 1u))] = x;
}

// Adds to cnt[b] the lanes of the warp where pred (b may differ between
// lanes). Every lane of the warp calls it.
__device__ __forceinline__ void warp_count(int *cnt, int b, bool pred) {
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, pred);
  if (!ball) return;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, b) & ball;
  if (pred && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(cnt + b, __popc(peers));
}

// A proposal of row i (lane b) for column col in round r.
__device__ __forceinline__ void propose(const Args &a, int x, int b, int i,
                                        int col, int r, int *ap) {
  a.prop[x] = col;
  atomicMin(a.won + (long long)b * a.n + col,
            ((unsigned long long)(uint32_t)r << 32) | (uint32_t)i);
  if (!__ldcg(ap + b)) ap[b] = 1;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_assignment_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long s_best[kWarps];
  __shared__ int s_any[kWarps], s_cnt[kWarps], s_new[kWarps];
  __shared__ int s_base;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B, m = a.m, n = a.n;
  const int Bm = B * m;  // the launcher checks that it fits
  const long long Bn = (long long)B * n;

  // copy the state in; zero the counters
  for (long long x = gtid; x < Bm; x += gsize) {
    a.mba[x] = a.mba_in[x];
    a.yb[x] = a.yb_in[x];
  }
  for (long long x = gtid; x < Bn; x += gsize) {
    a.mab[x] = a.mab_in[x];
    a.ya[x] = a.ya_in[x];
  }
  for (long long b = gtid; b < B; b += gsize) {
    a.ph[b] = a.ph_in[b];
    a.rd[b] = a.rd_in[b];
    a.sni[b] = a.sni_in[b];
    a.free_cnt[b] = 0;
    a.free_cnt[B + b] = 0;
  }
  if (gtid < 2) a.cand_len[gtid] = 0;
  grid.sync();
  // the warp's rows are consecutive: x0 is the same on every lane
  for (long long x0 = gtid - lane; x0 < Bm; x0 += gsize) {
    const int x = (int)(x0 + lane);
    const int b = x < Bm ? x / m : 0;
    warp_count(a.free_cnt, b,
               x < Bm && a.mba_in[x] < 0 && x - b * m < a.mvalid[b]);
  }
  grid.sync();

  const int mm_cap = min(m, n) + 1;
  for (int p = 0; p < a.k; ++p) {
    const int *fc = a.free_cnt + (p & 1) * B;
    int *fc_next = a.free_cnt + ((p + 1) & 1) * B;
    // phase set-up; the same decision in every block
    bool any_on = false;
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      any_on = any_on || lane_runs(a, fc, b);
    if (!__syncthreads_or(any_on)) break;
    for (long long b = gtid; b < B; b += gsize) {
      const bool on = lane_runs(a, fc, (int)b);
      a.lane_on[b] = on;
      a.done[b] = !on;
      a.any_prop[b] = 0;
      a.any_prop[B + b] = 0;
      fc_next[b] = 0;
    }
    for (long long x = gtid; x < Bn; x += gsize) a.won[x] = kFree;
    // round 0's candidates: B', the free valid rows of the lanes on
    for (long long x0 = (long long)blockIdx.x * kThreads; x0 < Bm;
         x0 += gsize) {
      const int x = (int)(x0 + threadIdx.x);
      bool in_bp = false;
      if (x < Bm) {
        const int b = x / m;
        in_bp = a.mba[x] < 0 && x - b * m < a.mvalid[b] &&
                lane_runs(a, fc, b);
        if (in_bp) a.prop[x] = -1;
      }
      block_append(in_bp, x, a.cand, a.cand_len, s_cnt, &s_base);
    }
    grid.sync();

    // (I) greedy maximal matching: one barrier per propose round
    for (int r = 0; r < mm_cap; ++r) {
      const int len = __ldcg(a.cand_len + r % 3);
      // round r - 1 had no proposer: every lane's matching is maximal
      if (r > 0 && len == 0) break;
      // per lane: a lane whose rows proposed nothing in round r - 1 is
      // done; a lane not done takes round r (and counts it)
      for (long long b = gtid; b < B; b += gsize) {
        int *ap_prev = a.any_prop + ((r + 1) & 1) * B;
        bool done = a.done[b];
        if (r > 0) {
          done = done || !__ldcg(ap_prev + b);
          ap_prev[b] = 0;
        }
        a.done[b] = done;
        if (!done) a.rd[b] += 1;
      }
      if (gtid == 0) a.cand_len[(r + 2) % 3] = 0;
      const int *list = a.cand + (r & 1) * Bm;
      int *next = a.cand + ((r + 1) & 1) * Bm;
      int *next_len = a.cand_len + (r + 1) % 3;
      int *ap = a.any_prop + (r & 1) * B;

      if (len >= (int)gridDim.x * kWarps) {
        // one warp per candidate row, kWarps rows per block and step
        for (int t0 = blockIdx.x * kWarps; t0 < len;
             t0 += gridDim.x * kWarps) {
          const int t = t0 + warp;
          int x = -1, col = -1;
          if (t < len) {
            x = __ldcg(list + t);
            const int b = x / m, i = x - b * m;
            const unsigned long long *won = a.won + (long long)b * n;
            const bool matched =
                r > 0 && (uint32_t)__ldcg(won + __ldcg(a.prop + x)) ==
                             (uint32_t)i;
            if (!matched) {
              unsigned long long best = ~0ull;
              bool any = false;
              scan_row<kVec>(a.c + (long long)x * n, a.ya + (long long)b * n,
                             won, a.yb[x],
                             (uint32_t)i * kH1 + round_salt(a.ph[b], r) * kH3,
                             n, (uint32_t)r, lane, 32, best, any);
              best = warp_min(best);
              if (__any_sync(0xFFFFFFFFu, any))
                col = (int)(best & 0xFFFFFFFFull);
            }
            if (lane == 0 && col >= 0) propose(a, x, b, i, col, r, ap);
          }
          block_append(lane == 0 && col >= 0, x, next, next_len, s_cnt,
                       &s_base);
        }
      } else {
        // one block per candidate row; fewer than kWarps rows per block,
        // buffered in s_new and appended once
        int n_new = 0;
        for (int t = blockIdx.x; t < len; t += gridDim.x) {
          const int x = __ldcg(list + t);
          const int b = x / m, i = x - b * m;
          const unsigned long long *won = a.won + (long long)b * n;
          // the same on every thread of the block
          if (r > 0 &&
              (uint32_t)__ldcg(won + __ldcg(a.prop + x)) == (uint32_t)i)
            continue;
          unsigned long long best = ~0ull;
          bool any = false;
          scan_row<kVec>(a.c + (long long)x * n, a.ya + (long long)b * n,
                         won, a.yb[x],
                         (uint32_t)i * kH1 + round_salt(a.ph[b], r) * kH3,
                         n, (uint32_t)r, threadIdx.x, kThreads, best, any);
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
            if (row_any) {
              propose(a, x, b, i, (int)(best & 0xFFFFFFFFull), r, ap);
              s_new[n_new++] = x;
            }
          }
          __syncthreads();
        }
        if (threadIdx.x == 0 && n_new > 0) {
          const int at = atomicAdd(next_len, n_new);
          for (int j = 0; j < n_new; ++j) next[at + j] = s_new[j];
        }
      }
      grid.sync();
    }

    // (II) push and (III) relabel, on the lanes that took the phase; the
    // free rows of every lane are counted for the next phase
    for (long long x0 = gtid - lane; x0 < Bm; x0 += gsize) {
      const int x = (int)(x0 + lane);
      int b = 0;
      bool free_now = false;
      if (x < Bm) {
        b = x / m;
        const int i = x - b * m;
        const bool row_ok = i < a.mvalid[b];
        const unsigned long long *won = a.won + (long long)b * n;
        const int old = a.mba[x];
        int now = old;
        if (a.lane_on[b]) {
          const bool in_bp = old < 0 && row_ok;
          int w = -1;
          if (in_bp) {
            const int pc = __ldcg(a.prop + x);
            if (pc >= 0 && (uint32_t)__ldcg(won + pc) == (uint32_t)i) w = pc;
          }
          const bool displaced = old >= 0 && __ldcg(won + old) != kFree;
          now = w >= 0 ? w : (displaced ? -1 : old);
          a.mba[x] = now;
          if (in_bp && w < 0) a.yb[x] += 1;
        }
        free_now = now < 0 && row_ok;
      }
      warp_count(fc_next, b, free_now);
    }
    // a column is taken only on a lane that took the phase
    for (long long x = gtid; x < Bn; x += gsize) {
      const unsigned long long w = __ldcg(a.won + x);
      if (w != kFree) {
        a.mab[x] = (int)(uint32_t)w;
        a.ya[x] -= 1;
      }
    }
    for (long long b = gtid; b < B; b += gsize)
      if (a.lane_on[b]) {
        a.ph[b] += 1;
        a.sni[b] += __ldcg(fc + b);  // |B'|: the free valid rows
      }
    // the next set-up lists into cand_len[0], its round 0 into [1]
    if (gtid < 2) a.cand_len[gtid] = 0;
    grid.sync();
  }
}

// ---- the per-lane path ----------------------------------------------------

constexpr int kLaneThreads = 512;
// loads of a row that a thread has in flight at once
constexpr int kLaneBatch = 8;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
// won of the per-lane path: (round << 16) | row in 32 bits, so the lane
// takes m <= 65535 (and so fewer than 65535 rounds)
constexpr uint32_t kLaneFree = ~0u;
constexpr int kLaneMaxRows = 65535;

// Offsets, in bytes, of a block's pieces of a lane in dynamic shared
// memory: won and y_a of every column (each block holds a copy), then
// match_ba, y_b, prop and the two candidate lists of the block's rows
// (row i lives in block i % C, at i / C).
struct LaneLayout {
  long long won, ya, mba, yb, prop, cand0, cand1, total;
};

__host__ __device__ LaneLayout lane_layout(int m, int n, int C) {
  const long long rows = (m + C - 1) / C;
  LaneLayout l;
  long long at = 0;
  auto take = [&at](long long bytes) {
    const long long here = at;
    at = align16(at + bytes);
    return here;
  };
  l.won = take(4ll * n);
  l.ya = take(4ll * n);
  l.mba = take(4 * rows);
  l.yb = take(4 * rows);
  l.prop = take(4 * rows);
  l.cand0 = take(4 * rows);
  l.cand1 = take(4 * rows);
  l.total = at;
  return l;
}

// Another block's shared memory, in explicit shared::cluster addresses
// (mapa, then st / atom on that window), not through generic pointers.
__device__ __forceinline__ uint32_t cluster_addr(const void *p,
                                                 uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void cluster_min(const uint32_t *p, uint32_t rank,
                                            uint32_t v) {
  asm volatile("red.shared::cluster.min.u32 [%0], %1;"
               :
               : "r"(cluster_addr(p, rank)), "r"(v)
               : "memory");
}

// scan_row on the per-lane path: y_a and the 32-bit won in shared memory.
template <bool kVec>
__device__ __forceinline__ void scan_lane_row(const int *__restrict__ crow,
                                              const int *ya,
                                              const uint32_t *won, int yb,
                                              uint32_t base, int n,
                                              uint32_t r, int first, int step,
                                              unsigned long long &best,
                                              bool &any) {
  // kLaneBatch loads of the row in flight before the first is used: a
  // row of a few KB is one round trip to L2, not one per pair of loads
  if constexpr (kVec) {
    const int4 *c4 = reinterpret_cast<const int4 *>(crow);
    const int4 *ya4 = reinterpret_cast<const int4 *>(ya);
    const uint4 *w4 = reinterpret_cast<const uint4 *>(won);
    const int n4 = n >> 2;
    for (int q0 = first; q0 < n4; q0 += kLaneBatch * step) {
      int4 cv[kLaneBatch];
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int q = q0 + u * step;
        if (q < n4) cv[u] = __ldg(c4 + q);
      }
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int q = q0 + u * step;
        if (q < n4) {
          const int4 yv = ya4[q];
          const uint4 wv = w4[q];
          const int j = q << 2;
          visit(cv[u].x, yb, yv.x, (wv.x >> 16) >= r, base, j, best, any);
          visit(cv[u].y, yb, yv.y, (wv.y >> 16) >= r, base, j + 1, best,
                any);
          visit(cv[u].z, yb, yv.z, (wv.z >> 16) >= r, base, j + 2, best,
                any);
          visit(cv[u].w, yb, yv.w, (wv.w >> 16) >= r, base, j + 3, best,
                any);
        }
      }
    }
  } else {
    for (int j0 = first; j0 < n; j0 += kLaneBatch * step) {
      int cv[kLaneBatch];
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int j = j0 + u * step;
        if (j < n) cv[u] = __ldg(crow + j);
      }
#pragma unroll
      for (int u = 0; u < kLaneBatch; ++u) {
        const int j = j0 + u * step;
        if (j < n)
          visit(cv[u], yb, ya[j], (won[j] >> 16) >= r, base, j, best, any);
      }
    }
  }
}

// Writes v into slot [rank] of `arr` in every block of the cluster.
// Threads 0 .. C - 1 of the block call it.
__device__ __forceinline__ void all_gather(int *arr, int rank, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;"
               :
               : "r"(cluster_addr(arr + rank, threadIdx.x)), "r"(v)
               : "memory");
}

// One thread block cluster runs one lane at a time, from its state in to
// termination or k phases, then takes the lane gridDim.x / C further on.
// Every decision that ends a loop reads values that every thread of the
// cluster computes alike (the all-gathered counts, ph), so all blocks pass
// the same cluster barriers. kMinBlocks 2 caps the registers so that two
// blocks fit an SM and twice the clusters can be resident.
template <bool kVec, int kMinBlocks>
__global__ void __launch_bounds__(kLaneThreads, kMinBlocks)
fused_assignment_lane_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_best[kLaneWarps];
  __shared__ int s_any[kLaneWarps];
  __shared__ int s_len[2];                  // the block's lists, by parity
  __shared__ int s_cnt[2][kMaxCluster];     // proposers, by round parity
  __shared__ int s_free[kMaxCluster];       // free valid rows
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Q = gridDim.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = a.m, n = a.n;
  const LaneLayout l = lane_layout(m, n, C);
  uint32_t *won = reinterpret_cast<uint32_t *>(smem + l.won);
  int *ya = reinterpret_cast<int *>(smem + l.ya);
  int *mba = reinterpret_cast<int *>(smem + l.mba);
  int *yb = reinterpret_cast<int *>(smem + l.yb);
  int *prop = reinterpret_cast<int *>(smem + l.prop);
  int *cand0 = reinterpret_cast<int *>(smem + l.cand0);
  int *cand1 = reinterpret_cast<int *>(smem + l.cand1);
  // the block's rows: i = li * C + rank for li < nl
  const int nl = rank < m ? (m - rank + C - 1) / C : 0;
  const int mm_cap = min(m, n) + 1;

  // every block of the cluster runs before any touches another's memory
  cluster.sync();
  for (int b = blockIdx.x / C; b < a.B; b += Q) {
    const long long rb = (long long)b * m, cb = (long long)b * n;
    const int thr = a.thr[b], cap = a.cap[b], mv = a.mvalid[b];
    int ph = a.ph_in[b], rd = a.rd_in[b], sni = a.sni_in[b];
    // the lane's state in: every column into each block, the block's rows
    for (int j = tid; j < n; j += kLaneThreads) {
      won[j] = kLaneFree;
      ya[j] = a.ya_in[cb + j];
    }
    for (int j = rank * kLaneThreads + tid; j < n; j += C * kLaneThreads)
      a.mab[cb + j] = a.mab_in[cb + j];
    int nfree = 0;
    for (int l0 = 0; l0 < nl; l0 += kLaneThreads) {
      const int li = l0 + tid, i = li * C + rank;
      bool f = false;
      if (li < nl) {
        const int v = a.mba_in[rb + i];
        mba[li] = v;
        yb[li] = a.yb_in[rb + i];
        f = v < 0 && i < mv;
      }
      nfree += __syncthreads_count(f);
    }
    if (tid < C) all_gather(s_free, rank, nfree);
    cluster.sync();

    for (int p = 0; p < a.k; ++p) {
      int free_total = 0;
      for (int q = 0; q < C; ++q) free_total += s_free[q];
      if (!(free_total > thr && ph < cap)) break;
      // round 0's candidates: the block's rows of B'
      if (tid == 0) s_len[0] = s_len[1] = 0;
      __syncthreads();
      for (int li = tid; li < nl; li += kLaneThreads) {
        if (mba[li] < 0 && li * C + rank < mv) {
          prop[li] = -1;
          cand0[atomicAdd(&s_len[0], 1)] = li;
        }
      }
      __syncthreads();

      // (I) greedy maximal matching: one cluster barrier per round
      for (int r = 0; r < mm_cap; ++r) {
        if (r > 0) {
          int proposed = 0;
          for (int q = 0; q < C; ++q) proposed += s_cnt[(r - 1) & 1][q];
          if (proposed == 0) break;   // round r - 1 had no proposer
        }
        ++rd;
        const int *list = (r & 1) ? cand1 : cand0;
        int *next = (r & 1) ? cand0 : cand1;
        int *next_len = &s_len[(r + 1) & 1];
        const int len = s_len[r & 1];
        const uint32_t salt = round_salt(ph, r) * kH3;
        // the warps of a group scan one row: a warp per row with at least
        // as many rows as warps, else the warps split over the rows
        const int G = len >= kLaneWarps ? 1 : kLaneWarps / max(len, 1);
        const int per_pass = kLaneWarps / G;
        for (int t0 = 0; t0 < len; t0 += per_pass) {
          const int t = t0 + warp / G, g = warp % G;
          int li = -1, i = 0;
          unsigned long long best = ~0ull;
          bool any = false;
          if (warp < per_pass * G && t < len) {
            li = list[t];
            i = li * C + rank;
            // a row that proposed in round r - 1 and won leaves
            if (r > 0 && (won[prop[li]] & 0xFFFFu) == (uint32_t)i) li = -1;
            if (li >= 0)
              scan_lane_row<kVec>(a.c + (rb + i) * n, ya, won, yb[li],
                                  (uint32_t)i * kH1 + salt, n, (uint32_t)r,
                                  g * 32 + lane, G * 32, best, any);
          }
          best = warp_min(best);
          any = __any_sync(0xFFFFFFFFu, any);
          if (G > 1) {
            if (lane == 0) {
              s_best[warp] = best;
              s_any[warp] = any;
            }
            __syncthreads();
            if (g == 0 && li >= 0) {
              for (int w = warp + 1; w < warp + G; ++w) {
                best = s_best[w] < best ? s_best[w] : best;
                any = any || s_any[w];
              }
            }
            __syncthreads();
          }
          if (g == 0 && li >= 0 && any) {
            const int col = (int)(best & 0xFFFFFFFFull);
            // the lowest proposing row of the earliest round wins: into
            // every block's copy of won
            if (lane < C)
              cluster_min(won + col, lane, ((uint32_t)r << 16) | (uint32_t)i);
            if (lane == 0) {
              prop[li] = col;
              next[atomicAdd(next_len, 1)] = li;
            }
          }
        }
        __syncthreads();
        if (tid < C) all_gather(s_cnt[r & 1], rank, *next_len);
        // this round's list is round r + 2's; every thread has read it
        if (tid == 0) s_len[r & 1] = 0;
        cluster.sync();
      }

      // (II) push and (III) relabel
      nfree = 0;
      for (int l0 = 0; l0 < nl; l0 += kLaneThreads) {
        const int li = l0 + tid, i = li * C + rank;
        bool f = false;
        if (li < nl) {
          const bool row_ok = i < mv;
          const int old = mba[li];
          const bool in_bp = old < 0 && row_ok;
          int w = -1;
          if (in_bp) {
            const int pc = prop[li];
            if (pc >= 0 && (won[pc] & 0xFFFFu) == (uint32_t)i) w = pc;
          }
          const bool displaced = old >= 0 && won[old] != kLaneFree;
          const int now = w >= 0 ? w : (displaced ? -1 : old);
          mba[li] = now;
          if (in_bp && w < 0) yb[li] += 1;
          f = now < 0 && row_ok;
        }
        nfree += __syncthreads_count(f);
      }
      // every row has read won; each block relabels its own copy
      for (int j = tid; j < n; j += kLaneThreads) {
        const uint32_t w = won[j];
        if (w != kLaneFree) {
          ya[j] -= 1;
          if ((j / kLaneThreads) % C == rank)
            a.mab[cb + j] = (int)(w & 0xFFFFu);
          won[j] = kLaneFree;
        }
      }
      ph += 1;
      sni += free_total;  // |B'|: the free valid rows
      if (tid < C) all_gather(s_free, rank, nfree);
      cluster.sync();
    }

    // the lane's state out
    for (int li = tid; li < nl; li += kLaneThreads) {
      a.mba[rb + li * C + rank] = mba[li];
      a.yb[rb + li * C + rank] = yb[li];
    }
    for (int j = rank * kLaneThreads + tid; j < n; j += C * kLaneThreads)
      a.ya[cb + j] = ya[j];
    if (rank == 0 && tid == 0) {
      a.ph[b] = ph;
      a.rd[b] = rd;
      a.sni[b] = sni;
    }
    // no block loads the next lane (or exits) while another reads its
    // shared memory
    cluster.sync();
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// int32 tensors: c (B, m, n); the state in (match_ba, y_b (B, m);
// match_ab, y_a (B, n); phases, rounds, sum_ni (B)); threshold,
// phase_cap, m_valid (B); the state out, same shapes; ws a workspace of
// fused_assignment_workspace(B, m, n) bytes (the grid path's; the
// per-lane path reads none and takes null). ``vec`` != 0 selects the
// 16-byte loads (the caller checks n % 4 == 0 and 16-byte alignment of
// c; y_a and the workspace are allocated aligned). ``cluster`` 0 takes
// the grid path, C in 1..8 the per-lane path in clusters of C blocks
// (kernels/ops.py::fused_assignment_route chooses). Returns the
// cudaError_t of the launch.
extern "C" long long fused_assignment_workspace(int B, int m, int n) {
  return workspace_layout(B, m, n).total;
}

namespace {

// Dynamic shared memory a block of `kernel` may take on this device (its
// opt-in limit less its static part), or -1 if the device cannot say.
long long lane_smem_max(void (*kernel)(Args)) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kernel) != cudaSuccess)
    return -1;
  return (long long)optin - (long long)fa.sharedSizeBytes;
}

}  // namespace

// The per-lane path's shared memory, for kernels/ops.py's rule to be held
// against: a block's dynamic bytes for a lane of (m, n) in clusters of C,
// and the most that a block may take on the current device (-1 if the
// device cannot say).
extern "C" long long fused_assignment_lane_smem(int m, int n, int C) {
  return lane_layout(m, n, C).total;
}

extern "C" long long fused_assignment_lane_smem_max() {
  return lane_smem_max(fused_assignment_lane_kernel<true, 1>);
}

namespace {

int launch_grid(Args &a, void *ws, cudaStream_t stream) {
  const Layout l = workspace_layout(a.B, a.m, a.n);
  char *w = static_cast<char *>(ws);
  a.won = reinterpret_cast<unsigned long long *>(w + l.won);
  a.prop = reinterpret_cast<int *>(w + l.prop);
  a.cand = reinterpret_cast<int *>(w + l.cand);
  a.cand_len = reinterpret_cast<int *>(w + l.cand_len);
  a.lane_on = reinterpret_cast<int *>(w + l.lane_on);
  a.done = reinterpret_cast<int *>(w + l.done);
  a.any_prop = reinterpret_cast<int *>(w + l.any_prop);
  a.free_cnt = reinterpret_cast<int *>(w + l.free_cnt);

  void (*kernel)(Args) = a.vec ? fused_assignment_kernel<true>
                               : fused_assignment_kernel<false>;
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
  // every resident block, but no more than one warp per row needs
  const long long want = ((long long)a.B * a.m + kWarps - 1) / kWarps;
  const int grid = (int)std::min<long long>((long long)per_sm * sms,
                                            std::max<long long>(want, 1));
  void *args[] = {&a};
  e = cudaLaunchCooperativeKernel((void *)kernel, dim3(grid),
                                  dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cfg`'s shape of `kernel` can be resident, with
// its dynamic shared memory set for `smem` bytes.
cudaError_t lane_clusters(void (*kernel)(Args), long long smem,
                          const cudaLaunchConfig_t &cfg, int *clusters) {
  *clusters = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, (void *)kernel, &cfg);
}

int launch_lanes(Args &a, int C, cudaStream_t stream) {
  if (C < 1 || C > kMaxCluster || a.m > kLaneMaxRows)
    return (int)cudaErrorInvalidValue;
  void (*one)(Args) = a.vec ? fused_assignment_lane_kernel<true, 1>
                            : fused_assignment_lane_kernel<false, 1>;
  void (*two)(Args) = a.vec ? fused_assignment_lane_kernel<true, 2>
                            : fused_assignment_lane_kernel<false, 2>;
  const long long smem = lane_layout(a.m, a.n, C).total;
  // a lane that does not fit C blocks is the grid path's (the two builds
  // have the same static shared memory)
  if (smem > lane_smem_max(one)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * a.B);
  cfg.blockDim = dim3(kLaneThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the 1-block build, unless the lanes outnumber its resident clusters
  // and the 2-block build holds more
  void (*kernel)(Args) = one;
  int clusters = 0, clusters2 = 0;
  cudaError_t e = lane_clusters(one, smem, cfg, &clusters);
  if (e == cudaSuccess && clusters < a.B)
    e = lane_clusters(two, smem, cfg, &clusters2);
  if (e != cudaSuccess) return (int)e;
  if (clusters2 > clusters) {
    kernel = two;
    clusters = clusters2;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  // every cluster that can be resident, no more than one a lane
  cfg.gridDim = dim3(C * std::min(a.B, clusters));
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_assignment_launch(
    const void *c, const void *mba_in, const void *mab_in,
    const void *yb_in, const void *ya_in, const void *ph_in,
    const void *rd_in, const void *sni_in, const void *thr,
    const void *cap, const void *mvalid, void *mba, void *mab, void *yb,
    void *ya, void *ph, void *rd, void *sni, void *ws, int B, int m, int n,
    int k, int vec, int cluster, void *stream) {
  if (B == 0 || m == 0 || n == 0 || k <= 0) return (int)cudaSuccess;
  // rows are numbered b * m + i in int32
  if ((long long)B * m >= INT_MAX) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.c = static_cast<const int *>(c);
  a.mba_in = static_cast<const int *>(mba_in);
  a.mab_in = static_cast<const int *>(mab_in);
  a.yb_in = static_cast<const int *>(yb_in);
  a.ya_in = static_cast<const int *>(ya_in);
  a.ph_in = static_cast<const int *>(ph_in);
  a.rd_in = static_cast<const int *>(rd_in);
  a.sni_in = static_cast<const int *>(sni_in);
  a.thr = static_cast<const int *>(thr);
  a.cap = static_cast<const int *>(cap);
  a.mvalid = static_cast<const int *>(mvalid);
  a.mba = static_cast<int *>(mba);
  a.mab = static_cast<int *>(mab);
  a.yb = static_cast<int *>(yb);
  a.ya = static_cast<int *>(ya);
  a.ph = static_cast<int *>(ph);
  a.rd = static_cast<int *>(rd);
  a.sni = static_cast<int *>(sni);
  a.B = B;
  a.m = m;
  a.n = n;
  a.k = k;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cluster > 0 ? launch_lanes(a, cluster, s) : launch_grid(a, ws, s);
}
