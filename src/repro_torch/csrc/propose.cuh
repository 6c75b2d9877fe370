// One warp proposes for one row: over the columns j with
// y_b + y_a[j] == c[j] + 1 and avail[j], the first column of minimum key
// mix(base + j*H2), where base = row*H1 + salt*H3.
//
// This is repro.core.matching._propose_dense exactly: the answer is the
// FIRST minimum over all n masked keys (a column that is not admissible
// holds key 0xFFFFFFFF), and the row proposes iff it has an admissible
// column. Each lane reduces the packed value (key << 32) | col as uint64,
// a __shfl_xor butterfly reduces the 32 partial minima, and __any_sync
// the admissible flags. Every lane of the warp must call it.
//
// kVec: the row and y_a are read in 16-byte loads (int4) and avail in
// 4-byte loads (uchar4); the caller checks n % 4 == 0 and 16-byte
// alignment. kReadOnly: y_a and avail do not change while the kernel
// runs, so they may go through the read-only cache (__ldg). c always
// does.

#pragma once

#include "hash.cuh"

struct RowPick {
  unsigned long long best;  // (key << 32) | col of the first minimum
  bool any;                 // the row has an admissible column
};

static __device__ __forceinline__ void visit(int cij, int yb, int yaj,
                                             unsigned char avj,
                                             uint32_t base, int j,
                                             unsigned long long &best,
                                             bool &any) {
  const bool adm = (yb + yaj == cij + 1) && avj;
  const uint32_t key = adm ? mix(base + (uint32_t)j * kH2) : 0xFFFFFFFFu;
  const unsigned long long packed =
      ((unsigned long long)key << 32) | (unsigned long long)(uint32_t)j;
  best = packed < best ? packed : best;
  any = any || adm;
}

template <bool kReadOnly, class T>
static __device__ __forceinline__ T load(const T *p) {
  if constexpr (kReadOnly) return __ldg(p);
  return *p;
}

template <bool kVec, bool kReadOnly>
static __device__ __forceinline__ RowPick propose_row(
    const int *__restrict__ crow, const int *ya, const unsigned char *av,
    int yb, uint32_t base, int n, int lane) {
  unsigned long long best = ~0ull;
  bool any = false;
  if constexpr (kVec) {
    const int n4 = n >> 2;
    const int4 *c4 = reinterpret_cast<const int4 *>(crow);
    const int4 *ya4 = reinterpret_cast<const int4 *>(ya);
    const uchar4 *av4 = reinterpret_cast<const uchar4 *>(av);
#pragma unroll 4
    for (int q = lane; q < n4; q += 32) {
      const int4 cv = __ldg(c4 + q);
      const int4 yv = load<kReadOnly>(ya4 + q);
      const uchar4 avv = load<kReadOnly>(av4 + q);
      const int j = q << 2;
      visit(cv.x, yb, yv.x, avv.x, base, j, best, any);
      visit(cv.y, yb, yv.y, avv.y, base, j + 1, best, any);
      visit(cv.z, yb, yv.z, avv.z, base, j + 2, best, any);
      visit(cv.w, yb, yv.w, avv.w, base, j + 3, best, any);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      visit(__ldg(crow + j), yb, load<kReadOnly>(ya + j),
            load<kReadOnly>(av + j), base, j, best, any);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    best = other < best ? other : best;
  }
  return RowPick{best, (bool)__any_sync(0xFFFFFFFFu, any)};
}
