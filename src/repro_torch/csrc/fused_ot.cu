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
// is clip(cap[t] - (excl - base[t]), 0, amt) with base[t] the least
// exclusive prefix among the proposers of column t, the round cap is
// nb + na + 2, and the phase condition is checked before every phase.
//
// What bounds it: each round reads c_int once for every row that still
// proposes; each phase reads f_hi, f_lo and the grants and writes the two
// flow matrices (4 bytes per element each). Between the steps the grid
// waits at a barrier.
//
// Design: a persistent cooperative kernel, as fused_assignment.cu. The
// flow matrices are (B, nb, na) int32, 64 MB each at 4096 x 4096, so the
// state lives in global memory (and L2); a cluster of blocks sharing
// distributed shared memory holds at most 16 x 227 KB, too little for one
// lane at the sizes the solver is used at. Steps of a round, with a grid
// barrier after each:
//   propose  one warp per row (propose.cuh, avail = cap > 0);
//   grant    one block per lane: an exclusive scan of the amounts over
//            the rows in row order (int32, wrapping as the reference's
//            cumsum), an atomicMin of each proposer's prefix into its
//            column's base, the grants, then the columns' capacity.
// After the rounds, one thread per column walks its rows bottom-up (so
// neighbouring threads read neighbouring addresses) to strip the
// displaced flow, fold the grants into f_lo / f_hi and collapse; then one
// pass over the rows. The column sums of f_hi are kept from phase to
// phase, so a phase reads the flow matrices once.

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

struct Args {
  const int *c;  // (B, nb, na) costs in units of eps
  // the state as given (read only) ...
  const int *yb_in, *yahi_in, *fb_in, *fa_in, *fhi_in, *flo_in, *ph_in,
      *rd_in;
  // ... the per-lane limits ...
  const int *thr, *cap_lim;
  // ... and the state as returned, updated in place by the kernel
  int *yb, *yahi, *fb, *fa, *fhi, *flo, *ph, *rd;
  // scratch (see workspace_layout)
  int *rem;       // (B, nb) supply not granted yet this phase
  int *prop;      // (B, nb) proposed column, -1
  int *excl;      // (B, nb) exclusive prefix of the proposed amounts
  int *freed;     // (B, nb) hi flow stripped off the row this phase
  int *cap;       // (B, na) hi-cluster capacity left this phase
  int *cap0;      // (B, na) capacity at the start of the phase
  int *colfhi;    // (B, na) column sums of f_hi
  int *base;      // (B, na) least prefix among the column's proposers
  int *colgrant;  // (B, na) units granted by the column this round
  int *granted;   // (B, nb, na) units granted this phase, kept at 0
  int *wsum;      // (B, 32) warp totals of the grant step's scan
  int *lane_on;   // (B) the lane takes this phase
  int *done;      // (B) no row of the lane proposes any more
  int *any_prop;  // (B) some row of the lane proposed this round
  int *free_sum;  // (2, B) free supply, by phase parity
  unsigned char *avail;  // (B, na) cap > 0
  int B, nb, na, k, max_rounds;
};

struct Layout {
  long long rem, prop, excl, freed, cap, cap0, colfhi, base, colgrant,
      granted, wsum, lane_on, done, any_prop, free_sum, avail, total;
};

long long align16(long long x) { return (x + 15) & ~15ll; }

Layout workspace_layout(int B, int nb, int na) {
  const long long Bm = (long long)B * nb, Bn = (long long)B * na;
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
  l.cap = take(4 * Bn);
  l.cap0 = take(4 * Bn);
  l.colfhi = take(4 * Bn);
  l.base = take(4 * Bn);
  l.colgrant = take(4 * Bn);
  l.granted = take(4 * Bm * na);
  l.wsum = take(4ll * 32 * B);
  l.lane_on = take(4ll * B);
  l.done = take(4ll * B);
  l.any_prop = take(4ll * B);
  l.free_sum = take(8ll * B);
  l.avail = take(Bn);
  l.total = at;
  return l;
}

__device__ __forceinline__ bool lane_runs(const Args &a, const int *fs,
                                          int b) {
  const int ph = a.ph[b];
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

// The grant step of one round for lane b, by one whole block.
__device__ void grant_lane(const Args &a, int b) {
  const int nb = a.nb, na = a.na;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = (long long)b * nb, col0 = (long long)b * na;
  int *wsum = a.wsum + 32ll * b;
  // exclusive prefix of amt over the rows, tile by tile in row order
  uint32_t carry = 0;
  for (int t0 = 0; t0 < nb; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    uint32_t v = 0;
    if (i < nb && a.prop[row0 + i] >= 0) v = (uint32_t)a.rem[row0 + i];
    uint32_t incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t o = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) wsum[warp] = (int)incl;
    __syncthreads();
    uint32_t before = carry, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t s = (uint32_t)__ldcg(wsum + w);
      if (w < warp) before += s;
      total += s;
    }
    if (i < nb) a.excl[row0 + i] = (int)(before + incl - v);
    carry += total;
    __syncthreads();
  }
  // base of each column: the least prefix among its proposers
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int t = a.prop[row0 + i];
    if (t >= 0) atomicMin(&a.base[col0 + t], a.excl[row0 + i]);
  }
  __syncthreads();
  // grants, FIFO by row order
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int t = a.prop[row0 + i];
    if (t < 0) continue;
    const int amt = a.rem[row0 + i];
    const int prefix = wrap_sub(a.excl[row0 + i], __ldcg(a.base + col0 + t));
    const int g = min(max(wrap_sub(a.cap[col0 + t], prefix), 0),
                           amt);
    if (g != 0) {
      a.rem[row0 + i] = wrap_sub(amt, g);
      const long long e = (row0 + i) * na + t;
      a.granted[e] = wrap_add(a.granted[e], g);
      atomicAdd(&a.colgrant[col0 + t], g);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < na; j += blockDim.x) {
    const int g = __ldcg(a.colgrant + col0 + j);
    if (g != 0) {
      const int cap = wrap_sub(a.cap[col0 + j], g);
      a.cap[col0 + j] = cap;
      a.avail[col0 + j] = cap > 0;
      a.colgrant[col0 + j] = 0;
    }
    a.base[col0 + j] = INT_MAX;
  }
  if (threadIdx.x == 0) {
    if (!a.done[b]) {
      a.rd[b] += 1;
      if (!a.any_prop[b]) a.done[b] = 1;
    }
    a.any_prop[b] = 0;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) fused_ot_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const long long gwarp = gtid >> 5, nwarps = gsize >> 5;
  const int lane = threadIdx.x & 31;
  const int B = a.B, nb = a.nb, na = a.na;
  const long long Bm = (long long)B * nb, Bn = (long long)B * na;

  // copy the state in; zero the grants and the per-lane counters
  for (long long x = gtid; x < Bm * na; x += gsize) {
    a.fhi[x] = a.fhi_in[x];
    a.flo[x] = a.flo_in[x];
    a.granted[x] = 0;
  }
  for (long long x = gtid; x < Bm; x += gsize) {
    a.yb[x] = a.yb_in[x];
    a.fb[x] = a.fb_in[x];
    a.freed[x] = 0;
  }
  for (long long x = gtid; x < Bn; x += gsize) {
    a.yahi[x] = a.yahi_in[x];
    a.fa[x] = a.fa_in[x];
    a.colgrant[x] = 0;
    a.base[x] = INT_MAX;
  }
  for (long long b = gtid; b < B; b += gsize) {
    a.ph[b] = a.ph_in[b];
    a.rd[b] = a.rd_in[b];
    a.free_sum[b] = 0;
    a.free_sum[B + b] = 0;
    a.any_prop[b] = 0;
  }
  grid.sync();
  // column sums of f_hi; free supply per lane
  for (long long x = gtid; x < Bn; x += gsize) {
    const long long b = x / na, j = x % na;
    const int *col = a.fhi + b * nb * na + j;
    int s = 0;
    for (int i = 0; i < nb; ++i) s = wrap_add(s, col[(long long)i * na]);
    a.colfhi[x] = s;
  }
  for (long long x = gtid; x < Bm; x += gsize) {
    const int f = a.fb[x];
    if (f != 0) atomicAdd(&a.free_sum[x / nb], f);
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
    }
    for (long long x = gtid; x < Bm; x += gsize) a.rem[x] = a.fb[x];
    for (long long x = gtid; x < Bn; x += gsize) {
      // hi-cluster capacity available to M'
      const int c0 =
          wrap_add(a.yahi[x] == 0 ? a.fa[x] : 0, a.colfhi[x]);
      a.cap0[x] = c0;
      a.cap[x] = c0;
      a.avail[x] = c0 > 0;
    }
    grid.sync();

    for (int r = 0; r < a.max_rounds; ++r) {
      bool running = false;
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        running = running || !a.done[b];
      if (!__syncthreads_or(running)) break;
      // propose: one warp per row with supply left
      for (long long w = gwarp; w < Bm; w += nwarps) {
        const int b = (int)(w / nb), i = (int)(w % nb);
        int col = -1;
        if (!a.done[b] && a.rem[w] > 0) {
          const uint32_t base =
              (uint32_t)i * kH1 + round_salt(a.ph[b], r) * kH3;
          const RowPick pick = propose_row<kVec, false>(
              a.c + w * (long long)na, a.yahi + (long long)b * na,
              a.avail + (long long)b * na, a.yb[w], base, na, lane);
          if (pick.any) col = (int)(pick.best & 0xFFFFFFFFull);
        }
        if (lane == 0) {
          a.prop[w] = col;
          if (col >= 0) a.any_prop[b] = 1;
        }
      }
      grid.sync();
      // grant: one block per lane
      for (int b = blockIdx.x; b < B; b += gridDim.x) grant_lane(a, b);
      grid.sync();
    }

    // push: strip the displaced hi flow bottom rows first; relabel:
    // granted units land at ya_hi - 1, an emptied hi cluster collapses
    for (long long x = gtid; x < Bn; x += gsize) {
      const long long b = x / na, j = x % na;
      if (!a.lane_on[b]) continue;
      const int yahi = a.yahi[x], fa = a.fa[x], fsum = a.colfhi[x];
      const int g_a = wrap_sub(a.cap0[x], a.cap[x]);  // units granted
      const int hi_free = yahi == 0 ? fa : 0;
      const int use_free = min(g_a, hi_free);
      const int disp = wrap_sub(g_a, use_free);
      // f_hi >= 0, so the strip takes min(disp, column sum) in all
      const int fa2 = wrap_sub(fa, use_free);
      const int hi_left =
          wrap_add(yahi == 0 ? fa2 : 0,
                   wrap_sub(fsum, min(max(disp, 0), fsum)));
      const bool collapse = hi_left == 0 && g_a > 0;
      int *fhi = a.fhi + b * nb * na + j;
      int *flo = a.flo + b * nb * na + j;
      int *gr = a.granted + b * nb * na + j;
      int below = 0, newsum = 0;
      for (int i = nb - 1; i >= 0; --i) {
        const long long e = (long long)i * na;
        const int f = fhi[e];
        const int take = min(max(wrap_sub(disp, below), 0), f);
        below = wrap_add(below, f);
        const int g = gr[e];
        const int lo = wrap_add(flo[e], g);
        const int hi = collapse ? lo : wrap_sub(f, take);
        if (hi != f) fhi[e] = hi;
        if (collapse) {
          if (flo[e] != 0) flo[e] = 0;
        } else if (g != 0) {
          flo[e] = lo;
        }
        if (g != 0) gr[e] = 0;
        newsum = wrap_add(newsum, hi);
        if (take != 0) atomicAdd(&a.freed[b * nb + i], take);
      }
      a.colfhi[x] = newsum;
      a.fa[x] = fa2;
      if (collapse) a.yahi[x] = yahi - 1;
    }
    grid.sync();
    for (long long x = gtid; x < Bm; x += gsize) {
      const long long b = x / nb;
      int f = a.fb[x];
      if (a.lane_on[b]) {
        const int rem = a.rem[x];
        if (f > 0 && rem > 0) a.yb[x] += 1;
        f = wrap_add(rem, __ldcg(a.freed + x));
        a.fb[x] = f;
        a.freed[x] = 0;
      }
      if (f != 0) atomicAdd(&fs_next[b], f);
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
  a.rem = reinterpret_cast<int *>(w + l.rem);
  a.prop = reinterpret_cast<int *>(w + l.prop);
  a.excl = reinterpret_cast<int *>(w + l.excl);
  a.freed = reinterpret_cast<int *>(w + l.freed);
  a.cap = reinterpret_cast<int *>(w + l.cap);
  a.cap0 = reinterpret_cast<int *>(w + l.cap0);
  a.colfhi = reinterpret_cast<int *>(w + l.colfhi);
  a.base = reinterpret_cast<int *>(w + l.base);
  a.colgrant = reinterpret_cast<int *>(w + l.colgrant);
  a.granted = reinterpret_cast<int *>(w + l.granted);
  a.wsum = reinterpret_cast<int *>(w + l.wsum);
  a.lane_on = reinterpret_cast<int *>(w + l.lane_on);
  a.done = reinterpret_cast<int *>(w + l.done);
  a.any_prop = reinterpret_cast<int *>(w + l.any_prop);
  a.free_sum = reinterpret_cast<int *>(w + l.free_sum);
  a.avail = reinterpret_cast<unsigned char *>(w + l.avail);
  a.B = B;
  a.nb = nb;
  a.na = na;
  a.k = k;
  a.max_rounds = max_rounds;

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
  // every resident block, but no more than one warp per row needs
  const long long want = ((long long)B * nb + kWarps - 1) / kWarps;
  const int grid = (int)std::min<long long>((long long)per_sm * sms,
                                            std::max<long long>(want, 1));
  void *args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel,
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
