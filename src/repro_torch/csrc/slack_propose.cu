// slack_propose: fused slack + admissibility + hash-keyed first-min over
// the columns of every (instance, row), for Hopper (sm_90a).
//
// Replaces the Pallas kernels slack_propose and slack_propose_batched
// (src/repro/kernels/slack_propose.py): one kernel, the unbatched form is
// B = 1. It reproduces repro.core.matching._propose_dense exactly: the
// proposal is the FIRST column of minimum masked key over all n columns
// (a non-admissible column holds key 0xFFFFFFFF), and a row proposes iff
// it is active and has an admissible column. Each thread reduces the
// packed value (key << 32) | col as uint64, which gives that first minimum
// exactly, together with an any-admissible flag.
//
// What bounds it: it reads c_int once, 4 bytes per (active row, column),
// and writes 12 bytes per row: at m = n = 10 000 that is 400 MB, about
// 0.12 ms at 3.35 TB/s. The hash is a dozen integer ops per element and
// is computed only for admissible entries (1-5 % of them on the solver's
// path), so the kernel is bound by bytes.
//
// Design: one warp per (instance, row), the scan of propose.cuh (shared
// with the fused kernels). The warp strides over the row in 16-byte loads
// (int4 of c_int and y_a, uchar4 of avail) when the row is 16-byte
// aligned, else in 4-byte loads; consecutive lanes touch consecutive
// addresses, so every load is coalesced. y_a and avail are shared by all
// rows of an instance and stay in L1/L2. A __shfl_xor butterfly reduces
// the 32 partial minima. Rows that are not active skip the read entirely
// (their answer is -1 whatever c_int holds), so a late round in which few
// rows still propose reads few bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "propose.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
slack_propose_kernel(const int *__restrict__ c, const int *__restrict__ y_b,
                     const int *__restrict__ y_a,
                     const unsigned char *__restrict__ avail,
                     const unsigned char *__restrict__ active,
                     const int *__restrict__ salt, int *__restrict__ col,
                     long long *__restrict__ key, int B, int m, int n) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * m) return;  // the whole warp leaves together
  const int b = (int)(warp / m);
  const int i = (int)(warp % m);
  if (!active[warp]) {
    if (lane == 0) {
      col[warp] = -1;
      key[warp] = 0xFFFFFFFFll;
    }
    return;
  }
  const int *crow = c + warp * (long long)n;
  const int *ya = y_a + (long long)b * n;
  const unsigned char *av = avail + (long long)b * n;
  const int yb = y_b[warp];
  const uint32_t base = (uint32_t)i * kH1 + (uint32_t)salt[b] * kH3;

  const RowPick pick =
      propose_row<kVec, true>(crow, ya, av, yb, base, n, lane);
  if (lane == 0) {
    col[warp] = pick.any ? (int)(pick.best & 0xFFFFFFFFull) : -1;
    key[warp] = (long long)(pick.best >> 32);
  }
}

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
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int *ci = static_cast<const int *>(c);
  const int *ybi = static_cast<const int *>(y_b);
  const int *yai = static_cast<const int *>(y_a);
  const unsigned char *avi = static_cast<const unsigned char *>(avail);
  const unsigned char *aci = static_cast<const unsigned char *>(active);
  const int *si = static_cast<const int *>(salt);
  int *co = static_cast<int *>(col);
  long long *ko = static_cast<long long *>(key);
  if (vec) {
    slack_propose_kernel<true><<<grid, block, 0, s>>>(ci, ybi, yai, avi, aci,
                                                      si, co, ko, B, m, n);
  } else {
    slack_propose_kernel<false><<<grid, block, 0, s>>>(ci, ybi, yai, avi,
                                                       aci, si, co, ko, B, m,
                                                       n);
  }
  return (int)cudaGetLastError();
}
