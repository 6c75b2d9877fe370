// slack_propose: fused slack + admissibility + hash-keyed first-min over
// the columns of every live (instance, row), for Hopper (sm_90a).
//
// Replaces the Pallas kernels slack_propose and slack_propose_batched
// (src/repro/kernels/slack_propose.py): one kernel, the unbatched form is
// B = 1. It reproduces repro.core.matching._propose_dense exactly: the
// proposal is the FIRST column of minimum masked key over all n columns
// (a non-admissible column holds key 0xFFFFFFFF), and a row proposes iff
// it is active and has an admissible column. Partial results are the
// packed value (key << 32) | col as uint64, whose minimum over any split
// of the columns, merged in any order, is that first minimum; the
// admissible flag is merged beside it (a non-admissible column and an
// admissible one whose key is 0xFFFFFFFF pack alike).
//
// What bounds it: it reads the live rows of c_int once, 4 n bytes each,
// the vectors once, and writes 12 bytes per row. A round with R live rows
// of n = 10 000 columns needs 40 KB x R: 0.11 ms at 9 500 rows, 2 us at
// the 169 rows of a late Fig. 1 round (3.35 TB/s). The hash is a dozen
// integer operations per admissible entry (1-5 % of them), so bytes bound
// it. But most rounds of the stepped route have ~170 live rows (their
// mean over the Fig. 1 solve: PERF.md), and with one warp per row such a
// round is paced by one warp's walk of 40 KB, a chain of ~20 dependent
// load batches, not by bytes.
//
// Design: a persistent grid, one 1024-thread block per SM, that spreads
// the live rows, and each live row over many warps:
// - Rank. Every block reads the whole `active` vector (16 flags a thread,
//   one 16-byte load where aligned) and ranks the live rows by a block
//   scan, 16 384 rows per pass. The live row of rank q belongs to block
//   q mod G: every block gets the same number of rows, give or take one.
//   Inactive rows get col = -1, key = 0xFFFFFFFF from the block that owns
//   their 16-row slot (slot mod G) and are not read.
// - Split. A block cuts its R rows into P column parts; P (at most 32, a
//   part at least 64 loads) minimises ceil(R P / 32) x (1 + load batches a
//   part), the rounds of its warps' longest walk, each counted with one
//   batch of item overhead. A late round (R = 1-2) spreads a row over 32
//   or 16 warps, a round at 95 % live rows of 10 000 columns cuts a row
//   in 4, and short rows (1024 columns) stay whole.
// - Merge. Warp w takes items w, w + 32, ...; each reduces its part (16-
//   or 4-byte loads, consecutive lanes on consecutive addresses) by a
//   butterfly, then merges into its row's shared-memory slot (atomicMin of
//   the packed value, atomicOr of the flag). A ticket counts the parts;
//   the warp that brings the last one writes col and key. Every row has
//   its own slot within a pass, so no slot is reused while in flight.
// The grid never launches warps for rows that do no work, and a pass has
// four block barriers, none inside the row walk. A late round then costs
// the rank and list (a 16-byte load, three barriers) plus the walk of one
// or two parts of ~80 quads; a round at 95 % live rows stays a stream of
// c at the 64 registers of a 1024-thread block (see scan_part). Rows are
// counted in 32 bits: B m < 2^31.

#include <cstdint>
#include <cuda_runtime.h>

#include "propose.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kFlags = 16;                  // active flags a thread ranks
constexpr int kChunk = kThreads * kFlags;   // rows ranked per pass
constexpr int kMinPart = 64;                // loads a part at least holds
constexpr int kBatch = 32 * 4;              // a warp's loads per batch
constexpr int kDeepLoads = 6;               // loads of c a lane, long parts
constexpr unsigned kFull = 0xFFFFFFFFu;

// Bit i set iff byte i of w is not zero.
__device__ __forceinline__ unsigned byte_mask(unsigned w) {
  return ((w & 0xFFu) ? 1u : 0u) | ((w & 0xFF00u) ? 2u : 0u) |
         ((w & 0xFF0000u) ? 4u : 0u) | ((w & 0xFF000000u) ? 8u : 0u);
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

__device__ __forceinline__ void put(int *col, long long *key, int row,
                                    unsigned long long best, bool any) {
  col[row] = any ? (int)(best & 0xFFFFFFFFull) : -1;
  key[row] = (long long)(best >> 32);
}

// Column parts per row for a block holding `rows` rows of `units` loads
// (quads or columns): the P in [1, max_parts] of least
// ceil(rows P / 32) * (1 + ceil(units / (P * kBatch))); ties go to the
// smaller P. Lane l prices P = l + 1; every lane returns the choice.
__device__ __forceinline__ int choose_parts(int rows, int units,
                                            int max_parts, int lane) {
  const unsigned p = lane + 1;
  unsigned long long packed = ~0ull;
  if ((int)p <= max_parts) {
    const unsigned steps = ((unsigned)rows * p + kWarps - 1) / kWarps;
    const unsigned batches = ((unsigned)units + p * kBatch - 1) / (p * kBatch);
    packed = ((unsigned long long)steps * (1 + batches) << 6) | p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, packed, off);
    packed = other < packed ? other : packed;
  }
  return (int)(packed & 63);
}

// The packed minimum and admissible flag of one warp over loads
// [lo, hi) of a row (quads of 16 bytes with kVec, else single columns),
// each lane taking every 32nd load. With kDeep, a long part (two deep
// batches or more, 16-byte path) is walked in batches of kDeepLoads loads
// of c a lane issued together, y_a and avail read from L1 as each quad is
// visited: 6 quads of c in flight a lane without spilling at 64
// registers, where the 4-quad loop below holds c, y_a and avail for 4
// quads. The launcher drops that loop (kDeep false) where rows are too
// short for it ever to run: its mere presence slowed the 4-quad loop on
// 1024-column rows by ~7 % on an H100 (PERF.md).
template <bool kVec, bool kDeep>
__device__ __forceinline__ RowPick scan_part(
    const int *__restrict__ crow, const int *__restrict__ ya,
    const unsigned char *__restrict__ av, int yb, uint32_t base, int lo,
    int hi, int lane) {
  unsigned long long best = ~0ull;
  bool any = false;
  if constexpr (kVec) {
    const int4 *c4 = reinterpret_cast<const int4 *>(crow);
    const int4 *ya4 = reinterpret_cast<const int4 *>(ya);
    const uchar4 *av4 = reinterpret_cast<const uchar4 *>(av);
    int q = lo + lane;
    const bool deep = kDeep && hi - lo >= 2 * kDeepLoads * 32;
    for (; deep && q + (kDeepLoads - 1) * 32 < hi; q += kDeepLoads * 32) {
      int4 cv[kDeepLoads];
#pragma unroll
      for (int u = 0; u < kDeepLoads; ++u) cv[u] = __ldg(c4 + q + 32 * u);
#pragma unroll
      for (int u = 0; u < kDeepLoads; ++u) {
        const int qu = q + 32 * u;
        const int4 yv = __ldg(ya4 + qu);
        const uchar4 avv = __ldg(av4 + qu);
        const int j = qu << 2;
        visit(cv[u].x, yb, yv.x, avv.x, base, j, best, any);
        visit(cv[u].y, yb, yv.y, avv.y, base, j + 1, best, any);
        visit(cv[u].z, yb, yv.z, avv.z, base, j + 2, best, any);
        visit(cv[u].w, yb, yv.w, avv.w, base, j + 3, best, any);
      }
    }
#pragma unroll 4
    for (; q < hi; q += 32) {
      const int4 cv = __ldg(c4 + q);
      const int4 yv = __ldg(ya4 + q);
      const uchar4 avv = __ldg(av4 + q);
      const int j = q << 2;
      visit(cv.x, yb, yv.x, avv.x, base, j, best, any);
      visit(cv.y, yb, yv.y, avv.y, base, j + 1, best, any);
      visit(cv.z, yb, yv.z, avv.z, base, j + 2, best, any);
      visit(cv.w, yb, yv.w, avv.w, base, j + 3, best, any);
    }
  } else {
#pragma unroll 4
    for (int j = lo + lane; j < hi; j += 32) {
      visit(__ldg(crow + j), yb, __ldg(ya + j), __ldg(av + j), base, j, best,
            any);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFull, best, off);
    best = other < best ? other : best;
  }
  return RowPick{best, (bool)__any_sync(kFull, any)};
}

// Per owned row of a pass, in shared memory.
struct RowSlot {
  unsigned long long best;  // packed minimum merged so far
  int row;                  // b * m + i
  int any;                  // an admissible column was seen
  int ticket;               // parts merged
};

template <bool kVec, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
slack_propose_kernel(const int *__restrict__ c, const int *__restrict__ y_b,
                     const int *__restrict__ y_a,
                     const unsigned char *__restrict__ avail,
                     const unsigned char *__restrict__ active,
                     const int *__restrict__ salt, int *__restrict__ col,
                     long long *__restrict__ key, int B, int m, int n) {
  extern __shared__ RowSlot s_slot[];
  __shared__ int s_scan[kWarps];
  __shared__ int s_live, s_count;

  const int rows = B * m;  // < 2^31: the launcher checks
  const int G = gridDim.x;
  const int bid = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool flags_vec = (reinterpret_cast<uintptr_t>(active) & 15) == 0;
  const int units = kVec ? (n >> 2) : n;
  const int max_parts = max(1, min(kWarps, units / kMinPart));
  int carry = 0;  // live rows of the earlier passes

  for (int base = 0; base < rows; base += kChunk) {
    // -- rank: this thread's 16 flags, a block scan of their counts
    const int r0 = base + threadIdx.x * kFlags;
    unsigned mask = 0;
    if (flags_vec && r0 + kFlags <= rows) {
      const uint4 v = __ldg(reinterpret_cast<const uint4 *>(active + r0));
      mask = byte_mask(v.x) | (byte_mask(v.y) << 4) |
             (byte_mask(v.z) << 8) | (byte_mask(v.w) << 12);
    } else {
#pragma unroll
      for (int k = 0; k < kFlags; ++k) {
        if (r0 + k < rows && __ldg(active + r0 + k)) mask |= 1u << k;
      }
    }
    const int cnt = __popc(mask);
    const int incl = warp_inclusive_scan(cnt, lane);
    if (lane == 31) s_scan[warp] = incl;
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    if (warp == 0) {
      const int v = s_scan[lane];
      const int iv = warp_inclusive_scan(v, lane);
      s_scan[lane] = iv - v;
      if (lane == 31) s_live = iv;
    }
    __syncthreads();
    const int live = s_live;

    // inactive rows: answered by the block that owns their 16-row slot
    if ((base / kFlags + (int)threadIdx.x) % G == bid) {
#pragma unroll
      for (int k = 0; k < kFlags; ++k) {
        if (r0 + k < rows && !((mask >> k) & 1u)) {
          col[r0 + k] = -1;
          key[r0 + k] = 0xFFFFFFFFll;
        }
      }
    }
    // live rows: the one of global rank q belongs to block q mod G
    int q = carry + s_scan[warp] + incl - cnt;
    for (unsigned mm = mask; mm; mm &= mm - 1, ++q) {
      if (q % G == bid) {
        RowSlot &slot = s_slot[atomicAdd(&s_count, 1)];
        slot.best = ~0ull;
        slot.row = r0 + (__ffs(mm) - 1);
        slot.any = 0;
        slot.ticket = 0;
      }
    }
    __syncthreads();

    // -- split and merge: items (row, part) over the block's 32 warps
    const int R = s_count;
    const int P = R > 0 ? choose_parts(R, units, max_parts, lane) : 1;
    const int part = units / P;
    const int extra = units - part * P;  // the first `extra` parts get +1
    int ri = warp / P;
    int p = warp - ri * P;
    for (int it = warp; it < R * P; it += kWarps) {
      RowSlot &slot = s_slot[ri];
      const int row = slot.row;
      const int b = row / m;
      const int lo = p * part + min(p, extra);
      const int hi = lo + part + (p < extra ? 1 : 0);
      // y_b and salt load beside the row's first batch, not before it
      const uint32_t hbase = (uint32_t)(row - b * m) * kH1 +
                             (uint32_t)__ldg(salt + b) * kH3;
      const RowPick pick = scan_part<kVec, kDeep>(
          c + (long long)row * n, y_a + (long long)b * n,
          avail + (long long)b * n, __ldg(y_b + row), hbase, lo, hi, lane);
      if (lane == 0) {
        if (P == 1) {
          put(col, key, row, pick.best, pick.any);
        } else {
          atomicMin(&slot.best, pick.best);
          if (pick.any) atomicOr(&slot.any, 1);
          __threadfence_block();
          if (atomicAdd(&slot.ticket, 1) == P - 1) {
            __threadfence_block();
            put(col, key, row, atomicMin(&slot.best, ~0ull),
                atomicOr(&slot.any, 0) != 0);
          }
        }
      }
      p += kWarps;  // the next item, kWarps further on
      ri += p / P;
      p -= (p / P) * P;
    }
    carry += live;
    __syncthreads();
  }
}

int g_sms[64];  // SM count per device, read once

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors: c (B, m, n) int32, y_b (B, m) int32, y_a (B, n) int32,
// avail (B, n) bool, active (B, m) bool, salt (B,) int32; outputs col
// (B, m) int32 and key (B, m) int64. ``vec`` != 0 selects the 16-byte
// path (the caller checks n % 4 == 0 and 16-byte alignment). Returns the
// cudaError_t of the launch.
extern "C" int slack_propose_launch(const void *c, const void *y_b,
                                    const void *y_a, const void *avail,
                                    const void *active, const void *salt,
                                    void *col, void *key, int B, int m,
                                    int n, int vec, void *stream) {
  const long long rows = (long long)B * m;
  if (rows == 0) return (int)cudaSuccess;
  if (rows >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  // one block per SM (at least 64 blocks, so a pass's owned rows fit a
  // small slot array), never more blocks than rows
  const long long blocks = g_sms[dev] > 64 ? g_sms[dev] : 64;
  const int grid = (int)(rows < blocks ? rows : blocks);
  const long long per_pass = rows < kChunk ? rows : kChunk;
  const size_t smem = (size_t)((per_pass + grid - 1) / grid)
                      * sizeof(RowSlot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int *ci = static_cast<const int *>(c);
  const int *ybi = static_cast<const int *>(y_b);
  const int *yai = static_cast<const int *>(y_a);
  const unsigned char *avi = static_cast<const unsigned char *>(avail);
  const unsigned char *aci = static_cast<const unsigned char *>(active);
  const int *si = static_cast<const int *>(salt);
  int *co = static_cast<int *>(col);
  long long *ko = static_cast<long long *>(key);
  if (vec && n / 4 >= 2 * kDeepLoads * 32) {
    slack_propose_kernel<true, true><<<grid, kThreads, smem, s>>>(
        ci, ybi, yai, avi, aci, si, co, ko, B, m, n);
  } else if (vec) {
    slack_propose_kernel<true, false><<<grid, kThreads, smem, s>>>(
        ci, ybi, yai, avi, aci, si, co, ko, B, m, n);
  } else {
    slack_propose_kernel<false, false><<<grid, kThreads, smem, s>>>(
        ci, ybi, yai, avi, aci, si, co, ko, B, m, n);
  }
  return (int)cudaGetLastError();
}
