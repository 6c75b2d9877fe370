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
// column of minimum key (propose.cuh), the lowest proposing row wins a
// column, the round cap is min(m, n) + 1 of the bucket's shape, and the
// phase condition free > threshold & phases < phase_cap & phases - start
// < k is checked before every phase, lane by lane.
//
// What bounds it: each propose round reads c_int once for every row that
// still proposes (4 bytes per element); the rest of the state is a few
// vectors. Between the steps of a round the grid waits at a barrier.
//
// Design: TPU VMEM held the whole state of one lane; at the full width
// (B = 1, 10 000 x 10 000, 400 MB of c_int) nothing like it exists on the
// card, and one block per lane would put the solve on one of 132 SMs. So
// this is a persistent cooperative kernel: the grid is every block that
// can be resident at once (cudaLaunchCooperativeKernel refuses more), the
// state and scratch stay in global memory, and cooperative_groups'
// grid.sync() separates the steps: phase set-up | propose | accept | ...
// | push and relabel. Every loop decision (another phase, another round)
// is taken by each block from the same global flags right after a
// barrier, and nothing writes those flags before the next barrier, so all
// blocks leave every loop together. Lanes that have stopped are masked.
// Propose is one warp per row (propose.cuh); accept is an atomicMin of the
// row index into a per-column winner array, double-buffered so one round
// resets the other's. Counters read after atomics go through L2 (__ldcg).

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "propose.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct Args {
  const int *c;  // (B, m, n) costs in units of eps
  // the state as given (read only) ...
  const int *mba_in, *mab_in, *yb_in, *ya_in, *ph_in, *rd_in, *sni_in;
  // ... the per-lane limits ...
  const int *thr, *cap, *mvalid;
  // ... and the state as returned, updated in place by the kernel
  int *mba, *mab, *yb, *ya, *ph, *rd, *sni;
  // scratch (see workspace_layout)
  int *mprime_b;           // (B, m) M' partner of each row, -1
  int *mprime_a;           // (B, n) M' partner of each column, -1
  int *winners;            // (2, B, n) lowest proposing row, INT_MAX
  int *prop;               // (B, m) proposed column, -1
  int *lane_on;            // (B) the lane takes this phase
  int *done;               // (B) the lane's matching is maximal
  int *any_prop;           // (B) some row of the lane proposed this round
  int *free_cnt;           // (2, B) free valid rows, by phase parity
  unsigned char *avail;    // (B, n) column not matched in M' yet
  unsigned char *active;   // (B, m) row in B' not matched in M' yet
  int B, m, n, k, vec;
};

// Offsets, in bytes, of the scratch arrays in one workspace.
struct Layout {
  long long mprime_b, mprime_a, winners, prop, lane_on, done, any_prop,
      free_cnt, avail, active, total;
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
  l.mprime_b = take(4 * Bm);
  l.mprime_a = take(4 * Bn);
  l.winners = take(8 * Bn);
  l.prop = take(4 * Bm);
  l.lane_on = take(4ll * B);
  l.done = take(4ll * B);
  l.any_prop = take(4ll * B);
  l.free_cnt = take(8ll * B);
  l.avail = take(Bn);
  l.active = take(Bm);
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_assignment_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const long long gwarp = gtid >> 5, nwarps = gsize >> 5;
  const int lane = threadIdx.x & 31;
  const int B = a.B, m = a.m, n = a.n;
  const long long Bm = (long long)B * m, Bn = (long long)B * n;

  // copy the state in; zero the per-lane counters
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
    a.any_prop[b] = 0;
  }
  grid.sync();
  for (long long x = gtid; x < Bm; x += gsize) {
    const int b = (int)(x / m);
    if (a.mba[x] < 0 && (int)(x % m) < a.mvalid[b])
      atomicAdd(&a.free_cnt[b], 1);
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
      fc_next[b] = 0;
    }
    for (long long x = gtid; x < Bm; x += gsize) {
      const int b = (int)(x / m);
      a.active[x] = lane_runs(a, fc, b) && a.mba[x] < 0 &&
                    (int)(x % m) < a.mvalid[b];
      a.mprime_b[x] = -1;
    }
    for (long long x = gtid; x < Bn; x += gsize) {
      a.avail[x] = 1;
      a.mprime_a[x] = -1;
      a.winners[x] = INT_MAX;
    }
    grid.sync();

    // (I) greedy maximal matching: propose / accept rounds
    for (int r = 0; r < mm_cap; ++r) {
      int *win = a.winners + (r & 1) * Bn;
      int *win_next = a.winners + ((r + 1) & 1) * Bn;
      bool running = false;
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        running = running || !a.done[b];
      if (!__syncthreads_or(running)) break;
      // propose: one warp per row; the branch is the same for the warp
      for (long long w = gwarp; w < Bm; w += nwarps) {
        const int b = (int)(w / m), i = (int)(w % m);
        int col = -1;
        if (a.active[w] && !a.done[b]) {
          const uint32_t base =
              (uint32_t)i * kH1 + round_salt(a.ph[b], r) * kH3;
          const RowPick pick = propose_row<kVec, false>(
              a.c + w * (long long)n, a.ya + (long long)b * n,
              a.avail + (long long)b * n, a.yb[w], base, n, lane);
          if (pick.any) col = (int)(pick.best & 0xFFFFFFFFull);
        }
        if (lane == 0) {
          a.prop[w] = col;
          if (col >= 0) {
            atomicMin(&win[(long long)b * n + col], i);
            a.any_prop[b] = 1;
          }
        }
      }
      grid.sync();
      // accept: the lowest proposing row wins the column
      for (long long x = gtid; x < Bm; x += gsize) {
        const int col = a.prop[x];
        if (col < 0) continue;
        const int b = (int)(x / m), i = (int)(x % m);
        const long long bc = (long long)b * n + col;
        if (__ldcg(win + bc) == i) {
          a.mprime_b[x] = col;
          a.mprime_a[bc] = i;
          a.avail[bc] = 0;
          a.active[x] = 0;
        }
      }
      for (long long x = gtid; x < Bn; x += gsize) win_next[x] = INT_MAX;
      for (long long b = gtid; b < B; b += gsize) {
        if (!a.done[b]) {
          a.rd[b] += 1;
          if (!a.any_prop[b]) a.done[b] = 1;
        }
        a.any_prop[b] = 0;
      }
      grid.sync();
    }

    // (II) push and (III) relabel, on the lanes that took the phase; the
    // free rows of every lane are counted for the next phase
    for (long long x = gtid; x < Bm; x += gsize) {
      const int b = (int)(x / m);
      const bool row_ok = (int)(x % m) < a.mvalid[b];
      const int old = a.mba[x];
      int now = old;
      if (a.lane_on[b]) {
        const int w = a.mprime_b[x];
        const bool won = w >= 0;
        const bool displaced =
            old >= 0 && a.mprime_a[(long long)b * n + old] >= 0;
        now = won ? w : (displaced ? -1 : old);
        a.mba[x] = now;
        const bool in_bp = old < 0 && row_ok;
        if (in_bp) {
          atomicAdd(&a.sni[b], 1);
          if (!won) a.yb[x] += 1;
        }
      }
      if (now < 0 && row_ok) atomicAdd(&fc_next[b], 1);
    }
    for (long long x = gtid; x < Bn; x += gsize) {
      const int w = a.mprime_a[x];
      if (w >= 0 && a.lane_on[x / n]) {
        a.mab[x] = w;
        a.ya[x] -= 1;
      }
    }
    for (long long b = gtid; b < B; b += gsize)
      if (a.lane_on[b]) a.ph[b] += 1;
    grid.sync();
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// int32 tensors: c (B, m, n); the state in (match_ba, y_b (B, m);
// match_ab, y_a (B, n); phases, rounds, sum_ni (B)); threshold,
// phase_cap, m_valid (B); the state out, same shapes; ws a workspace of
// fused_assignment_workspace(B, m, n) bytes. ``vec`` != 0 selects the
// 16-byte loads (the caller checks n % 4 == 0 and 16-byte alignment of
// c and y_a). Returns the cudaError_t of the launch.
extern "C" long long fused_assignment_workspace(int B, int m, int n) {
  return workspace_layout(B, m, n).total;
}

extern "C" int fused_assignment_launch(
    const void *c, const void *mba_in, const void *mab_in,
    const void *yb_in, const void *ya_in, const void *ph_in,
    const void *rd_in, const void *sni_in, const void *thr,
    const void *cap, const void *mvalid, void *mba, void *mab, void *yb,
    void *ya, void *ph, void *rd, void *sni, void *ws, int B, int m, int n,
    int k, int vec, void *stream) {
  if (B == 0 || m == 0 || n == 0 || k <= 0) return (int)cudaSuccess;
  const Layout l = workspace_layout(B, m, n);
  char *w = static_cast<char *>(ws);
  Args a;
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
  a.mprime_b = reinterpret_cast<int *>(w + l.mprime_b);
  a.mprime_a = reinterpret_cast<int *>(w + l.mprime_a);
  a.winners = reinterpret_cast<int *>(w + l.winners);
  a.prop = reinterpret_cast<int *>(w + l.prop);
  a.lane_on = reinterpret_cast<int *>(w + l.lane_on);
  a.done = reinterpret_cast<int *>(w + l.done);
  a.any_prop = reinterpret_cast<int *>(w + l.any_prop);
  a.free_cnt = reinterpret_cast<int *>(w + l.free_cnt);
  a.avail = reinterpret_cast<unsigned char *>(w + l.avail);
  a.active = reinterpret_cast<unsigned char *>(w + l.active);
  a.B = B;
  a.m = m;
  a.n = n;
  a.k = k;
  a.vec = vec;

  void (*kernel)(Args) = vec ? fused_assignment_kernel<true>
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
  const long long want = ((long long)B * m + kThreads / 32 - 1) /
                         (kThreads / 32);
  const int grid = (int)std::min<long long>((long long)per_sm * sms,
                                            std::max<long long>(want, 1));
  void *args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel,
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
