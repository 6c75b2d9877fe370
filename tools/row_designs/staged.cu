// A redesign of sinkhorn_row_update (src/repro_torch/csrc/sinkhorn_row.cu)
// for Hopper that was measured and not shipped: rows of c staged in shared
// memory by bulk asynchronous copies. tools/row_kernel_designs.py builds
// it, holds it against the plain version and times it beside the shipped
// kernel; PERF.md (section 6) gives the numbers and where its time goes.
// Kept so a next attempt starts from it.
//
// Design. A persistent grid, one block per SM, each block owning the
// contiguous rows [R k / G, R (k + 1) / G) of the R = B m rows. One
// producer thread streams units of c into a ring of S stages with the 1-D
// bulk copy (cp.async.bulk, completion counted in bytes on an mbarrier per
// stage): kParts whole rows where they fit 16 KB, else one row, else one
// segment of a longer row (a 4 KB copy costs nearly what a 16 KB one
// does). The lane's g is copied once per lane that the block's range
// enters, into one of two slots with their own full / empty mbarriers,
// when it fits (n <= 8192); a longer row carries its g segment in the
// stage. Consumer warps form groups of kParts; group q takes every
// kGroups-th unit, its warps a row each or a quarter of the row's columns
// each (meeting at a named barrier and double-buffered (max, sum) slots at
// the row's end). A warp loads its share (at most kSpan float4 a lane)
// into registers and hands the stage back before the exps. Each term goes
// through lse_push into one of four independent (max, sum) pairs.
//
// The ring's parity rule: the stage of the block's t-th item is t mod S,
// waited on with parity (t / S) & 1. A parity wait is exact only while the
// barrier is at most one phase from the one awaited, and a group skips the
// other groups' units: it could reach item t while the stage still waits
// for item t - S, whose phase has the other parity, and pass at once. So
// the producer publishes t in the stage's item word after issuing it, and
// a consumer waits for its own t there before the parity wait. Every
// consumer warp waits on every active lane's g slot in order, so no slot's
// phase runs two ahead of a waiter. tests/test_torch_kernel_plans.py
// models the ring, the plan and the row ranges.
//
// Build flags: -DROW_NO_EXP replaces the exp chain by a plain sum (the
// data path alone); -DROW_STAMPS records %globaltimer stamps per block
// (entry, first landing, last issue, exit), read by row_design_stamps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kSumFloor = 1e-30f;
constexpr int kConsumerWarps = 16;
constexpr int kParts = 4;  // warps that share a unit
constexpr int kSpan = 8;   // float4 a lane of a warp's share of a unit
constexpr int kGroups = kConsumerWarps / kParts;
constexpr int kStagedThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxStages = 32;
// shared memory before the g slots: full and empty barriers [0, 512), g
// full and empty [512, 544), the stages' item words [768, 1024), the
// groups' part slots [1024, 1280)
constexpr int kItemOffset = 768;
constexpr int kSlotOffset = 1024;
constexpr int kBarrierBytes = 2048;
constexpr int kSmemLimit = 227 * 1024;  // a block's opt-in maximum

#ifdef ROW_STAMPS
constexpr int kStampBlocks = 1024;
__device__ unsigned long long g_stamps[kStampBlocks][4];
static __device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) \
  if (blockIdx.x < kStampBlocks) g_stamps[blockIdx.x][k] = now_ns()
#define STAMP_MAX(k) \
  if (blockIdx.x < kStampBlocks) atomicMax(&g_stamps[blockIdx.x][k], now_ns())
#else
#define STAMP(k)
#define STAMP_MAX(k)
#endif

// Push one term z into the running pair (mx, s): s = sum exp(z_k - mx).
// One exp per term: exp(smaller - larger) rescales whichever side is
// smaller. Both -inf: the sum stays 0 (it is 0 while mx is -inf). The exp
// is taken unconditionally and the guard is a select, so consecutive
// pushes of independent pairs interleave (a branch around the exp would
// serialise them).
static __device__ __forceinline__ void lse_push(float z, float &mx,
                                                float &s) {
  const float hi = fmaxf(mx, z);
  const float e = expf(fminf(mx, z) - hi);
  s = hi == -INFINITY ? 0.f : (z > mx ? fmaf(s, e, 1.f) : s + e);
  mx = hi;
}

// Merge the pair (m2, s2) into (mx, s).
static __device__ __forceinline__ void lse_merge(float m2, float s2,
                                                 float &mx, float &s) {
  const float hi = fmaxf(mx, m2);
  if (hi == -INFINITY) {
    s = 0.f;  // both empty: no exp(-inf - -inf)
  } else {
    s = s * expf(mx - hi) + s2 * expf(m2 - hi);
  }
  mx = hi;
}

static __device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint32_t bar,
                                                 uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

// One arrival that also announces ``bytes`` of bulk copies to come.
static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity ``parity`` to complete. A wait that lasts
// tens of seconds can only be a broken ring: trap, so the launch fails
// instead of holding the card.
static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      t0 = clock64();
    } else if ((spin & 1023) == 0 && clock64() - t0 > (1ll << 36)) {
      __trap();
    }
  }
}

static __device__ __forceinline__ void publish(uint32_t word,
                                               long long t) {
  asm volatile("st.release.cta.shared.b64 [%0], %1;" ::"r"(word), "l"(t)
               : "memory");
}

// Wait until the stage's item word says ``t``: the producer issued item
// t, so the stage's earlier items have landed and been released.
static __device__ __forceinline__ void wait_issued(uint32_t word,
                                                   long long t) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    long long v;
    asm volatile("ld.acquire.cta.shared.b64 %0, [%1];"
                 : "=l"(v)
                 : "r"(word)
                 : "memory");
    if (v == t) return;
    if (spin == 0) {
      t0 = clock64();
    } else if ((spin & 1023) == 0 && clock64() - t0 > (1ll << 36)) {
      __trap();
    }
  }
}

static __device__ __forceinline__ void bulk_copy(uint32_t dst,
                                                 const void *src,
                                                 uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct StagedArgs {
  const float *c, *g, *log_nu, *reg;
  const unsigned char *active;
  const float *f_in;
  float *f_out;
  int B, m, n;
  int seg;           // floats of c per segment (a multiple of 4)
  int nseg;          // segments per row
  int rows;          // rows per unit (> 1 only when nseg == 1)
  int stages;        // S
  int stage_bytes;   // the unit's c, then (g_whole == 0) the g segment
  int g_whole;       // the lane's g staged once, in one of two slots
  int g_slot_bytes;  // bytes of a g slot (0 unless g_whole)
};

// kChains independent (max, sum) pairs per lane: term k of a row goes to
// pair k mod kChains.
constexpr int kChains = 4;

// The four terms of a float4 into the lane's four pairs.
static __device__ __forceinline__ void push4(const float4 &cv,
                                             const float4 &gv, float inv_reg,
                                             float (&mx)[kChains],
                                             float (&s)[kChains]) {
#ifdef ROW_NO_EXP
  mx[0] = fmaxf(mx[0], (gv.x - cv.x) + (gv.y - cv.y) + (gv.z - cv.z) +
                           (gv.w - cv.w));
  s[0] += 1.f;
#else
  lse_push((gv.x - cv.x) * inv_reg, mx[0], s[0]);
  lse_push((gv.y - cv.y) * inv_reg, mx[1], s[1]);
  lse_push((gv.z - cv.z) * inv_reg, mx[2], s[2]);
  lse_push((gv.w - cv.w) * inv_reg, mx[3], s[3]);
#endif
}

// Merge the lane's pairs and the warp's lanes (every lane gets the
// warp's pair); reset the lane's pairs.
static __device__ __forceinline__ void warp_pair(float (&mx)[kChains],
                                                 float (&s)[kChains],
                                                 float &wm, float &ws) {
  lse_merge(mx[1], s[1], mx[0], s[0]);
  lse_merge(mx[3], s[3], mx[2], s[2]);
  lse_merge(mx[2], s[2], mx[0], s[0]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xFFFFFFFFu, mx[0], off);
    const float s2 = __shfl_xor_sync(0xFFFFFFFFu, s[0], off);
    lse_merge(m2, s2, mx[0], s[0]);
  }
  wm = mx[0];
  ws = s[0];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    mx[k] = -INFINITY;
    s[k] = 0.f;
  }
}

static __device__ __forceinline__ float row_f(float mx, float s, float r,
                                              float log_nu) {
  return r * (log_nu - (mx + logf(fmaxf(s, kSumFloor))));
}

__global__ void __launch_bounds__(kStagedThreads, 1)
sinkhorn_row_staged_kernel(const StagedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  if (threadIdx.x == 0) STAMP(0);
  const uint32_t full0 = base, empty0 = base + 8 * kMaxStages;
  const uint32_t gfull0 = base + 16 * kMaxStages, gempty0 = gfull0 + 16;
  const uint32_t item0 = base + kItemOffset;
  // a group's column parts of a row: [group][row parity][part] (max, sum)
  float2 *slots = reinterpret_cast<float2 *>(smem + kSlotOffset);
  const int g_off = kBarrierBytes;
  const int stage_off = g_off + 2 * a.g_slot_bytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = a.m, n = a.n, S = a.stages, nseg = a.nseg, k = a.rows;
  if (warp == kConsumerWarps) {
    // the producer warp sets up the ring, a stage per lane
    for (int st = lane; st < S; st += 32) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kParts);
      reinterpret_cast<volatile long long *>(smem + kItemOffset)[st] = -1;
    }
    if (lane < 2) {
      mbar_init(gfull0 + 8 * lane, 1);
      mbar_init(gempty0 + 8 * lane, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long R = (long long)a.B * m;
  const long long r0 = R * blockIdx.x / gridDim.x;
  const long long r1 = R * (blockIdx.x + 1) / gridDim.x;
  if (r0 >= r1) return;
  const int b0 = (int)(r0 / m), b1 = (int)((r1 - 1) / m);

  if (warp == kConsumerWarps) {
    // the producer: one thread walks the block's units of active rows
    if (lane != 0) return;
    long long t = 0;  // items (unit segments) issued
    int q = 0;        // active lanes entered
    for (int b = b0; b <= b1; ++b) {
      if (a.active != nullptr && !a.active[b]) continue;
      const long long lo = max(r0, (long long)b * m);
      const long long hi = min(r1, (long long)(b + 1) * m);
      const float *gb = a.g + (long long)b * n;
      if (a.g_whole) {
        const int slot = q & 1;
        mbar_wait(gempty0 + 8 * slot, ((q >> 1) & 1) ^ 1);
        mbar_expect_tx(gfull0 + 8 * slot, 4u * n);
        bulk_copy(base + g_off + slot * a.g_slot_bytes, gb, 4u * n,
                  gfull0 + 8 * slot);
      }
      for (long long row = lo; row < hi; row += k) {
        const int rows_in = (int)min((long long)k, hi - row);
        const float *crow = a.c + row * n;
        for (int sg = 0; sg < nseg; ++sg, ++t) {
          const int st = (int)(t % S);
          const uint32_t par = (uint32_t)((t / S) & 1);
          mbar_wait(empty0 + 8 * st, par ^ 1);
          const int j0 = sg * a.seg;
          // a unit of several rows has one segment: its rows are contiguous
          const uint32_t bytes = 4u * min(a.seg, n - j0) * rows_in;
          const uint32_t dst = base + stage_off + st * a.stage_bytes;
          const uint32_t full = full0 + 8 * st;
          if (a.g_whole) {
            mbar_expect_tx(full, bytes);
            bulk_copy(dst, crow + j0, bytes, full);
          } else {
            mbar_expect_tx(full, 2 * bytes);
            bulk_copy(dst, crow + j0, bytes, full);
            bulk_copy(dst + 4 * a.seg, gb + j0, bytes, full);
          }
          publish(item0 + 8 * st, t);
        }
      }
      ++q;
    }
    STAMP(2);
    return;
  }

  // the consumers: group ``group`` takes the block's units u with
  // u mod kGroups == group; its kParts warps share each unit, by rows
  // (k > 1: warp ``part`` reduces rows part, part + kParts, ...) or by
  // columns (k == 1: warp ``part`` reduces the part-th quarter of every
  // segment, and the parts meet in ``slots`` at the end of the row)
  const int group = warp / kParts, part = warp % kParts;
  float mx[kChains], s[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    mx[c] = -INFINITY;
    s[c] = 0.f;
  }
  long long aunit = 0;  // units of the block before this lane
  int q = 0, rpar = 0;
  for (int b = b0; b <= b1; ++b) {
    const long long lo = max(r0, (long long)b * m);
    const long long hi = min(r1, (long long)(b + 1) * m);
    if (a.active != nullptr && !a.active[b]) {
      for (long long row = lo + threadIdx.x; row < hi;
           row += kConsumerWarps * 32)
        a.f_out[row] = a.f_in[row];
      continue;
    }
    const int slot = q & 1;
    if (a.g_whole) mbar_wait(gfull0 + 8 * slot, (q >> 1) & 1);
    const float r = a.reg[b];
    const float inv_reg = 1.f / r;
    const long long units = (hi - lo + k - 1) / k;
    for (long long u = (group - aunit % kGroups + kGroups) % kGroups;
         u < units; u += kGroups) {
      const long long row0 = lo + u * k;
      const int rows_in = (int)min((long long)k, hi - row0);
      for (int sg = 0; sg < nseg; ++sg) {
        const long long t = (aunit + u) * nseg + sg;
        const int st = (int)(t % S);
        wait_issued(item0 + 8 * st, t);
        mbar_wait(full0 + 8 * st, (uint32_t)((t / S) & 1));
        if (t == 0 && lane == 0) STAMP(1);
        const unsigned char *stage = smem + stage_off + st * a.stage_bytes;
        const float4 *c4 = reinterpret_cast<const float4 *>(stage);
        const float4 *g4 =
            a.g_whole ? reinterpret_cast<const float4 *>(
                            smem + g_off + slot * a.g_slot_bytes) +
                            sg * (a.seg >> 2)
                      : reinterpret_cast<const float4 *>(stage + 4 * a.seg);
        const int len4 = min(a.seg, n - sg * a.seg) >> 2;
        // the warp's span of the item: its row (k > 1) or its quarter of
        // the segment (k == 1), at most kSpan float4 a lane
        const int q0 = k > 1 ? part * len4 : len4 * part / kParts;
        const int q1 = k > 1 ? (part < rows_in ? q0 + len4 : q0)
                             : len4 * (part + 1) / kParts;
        const int g0 = k > 1 ? 0 : q0;
        float4 cv[kSpan];
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
          const int j = q0 + lane + 32 * i;
          cv[i] = j < q1 ? c4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        if (a.g_whole) {
          // c is in registers and g in its slot: hand the stage back now
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
#pragma unroll
        for (int i = 0; i < kSpan; ++i) {
          const int j = lane + 32 * i;
          if (q0 + j < q1) {
            push4(cv[i], g4[g0 + j], inv_reg, mx, s);
          }
        }
        if (!a.g_whole) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
        if (k > 1 && part < rows_in) {
          float wm, ws;
          warp_pair(mx, s, wm, ws);
          if (lane == 0)
            a.f_out[row0 + part] = row_f(wm, ws, r, a.log_nu[row0 + part]);
        }
      }
      if (k == 1) {
        float wm, ws;
        warp_pair(mx, s, wm, ws);
        float2 *mine = slots + (group * 2 + rpar) * kParts;
        if (lane == 0) mine[part] = make_float2(wm, ws);
        asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(kParts * 32)
                     : "memory");
        if (part == 0 && lane == 0) {
          float pm = mine[0].x, ps = mine[0].y;
#pragma unroll
          for (int p = 1; p < kParts; ++p) lse_merge(mine[p].x, mine[p].y,
                                                     pm, ps);
          a.f_out[row0] = row_f(pm, ps, r, a.log_nu[row0]);
        }
        rpar ^= 1;
      }
    }
    if (a.g_whole) {
      __syncwarp();
      if (lane == 0) mbar_arrive(gempty0 + 8 * slot);
    }
    aunit += units;
    ++q;
  }
  if (lane == 0) STAMP_MAX(3);
}

int g_sms[64];
bool g_smem_set[64];

}  // namespace

// c (B, m, n), g (B, n), log_nu (B, m), reg (B,) f32 device pointers of
// contiguous tensors (n % 4 == 0, c and g 16-byte aligned), active (B,)
// bool or null, f_in (B, m) (read for the lanes active marks off), f_out
// (B, m); seg, unit_rows, stages, stage_bytes, g_slot_bytes from
// row_kernel_designs.staged_plan(n). Returns the cudaError_t of the launch.
extern "C" int row_design_launch(const void *c, const void *g,
                                 const void *log_nu, const void *reg,
                                 const void *active, const void *f_in,
                                 void *f_out, int B, int m, int n, int seg,
                                 int unit_rows, int stages, int stage_bytes,
                                 int g_slot_bytes, void *stream) {
  const long long rows = (long long)B * m;
  if (rows == 0) return (int)cudaSuccess;
  const long long smem = kBarrierBytes + 2ll * g_slot_bytes +
                         (long long)stages * stage_bytes;
  const int g_whole = g_slot_bytes > 0;
  const int nseg = seg > 0 ? (n + seg - 1) / seg : 0;
  if (n <= 0 || n % 4 != 0 || seg <= 0 || seg % 4 != 0 || unit_rows < 1 ||
      (unit_rows > 1 && (nseg != 1 || unit_rows != kParts)) ||
      stages < 2 || stages > kMaxStages || stage_bytes % 128 != 0 ||
      g_slot_bytes % 128 != 0 ||
      stage_bytes < 4ll * seg * unit_rows * (g_whole ? 1 : 2) ||
      (g_whole && g_slot_bytes < 4ll * n) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (!g_smem_set[dev]) {
    err = cudaFuncSetAttribute(sinkhorn_row_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev] = true;
  }
  StagedArgs a{static_cast<const float *>(c),
               static_cast<const float *>(g),
               static_cast<const float *>(log_nu),
               static_cast<const float *>(reg),
               static_cast<const unsigned char *>(active),
               static_cast<const float *>(f_in),
               static_cast<float *>(f_out),
               B, m, n, seg, nseg, unit_rows, stages, stage_bytes, g_whole,
               g_slot_bytes};
  const int grid = (int)(rows < g_sms[dev] ? rows : g_sms[dev]);
  sinkhorn_row_staged_kernel<<<grid, kStagedThreads, (size_t)smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#ifdef ROW_STAMPS
// The stamps of the launches since the last call, ns: (blocks, 4) uint64
// into ``host``; then zero them.
extern "C" int row_design_stamps(void *host, int blocks) {
  static unsigned long long zero[kStampBlocks][4];
  if (blocks > kStampBlocks) blocks = kStampBlocks;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps,
                                         sizeof(g_stamps[0]) * blocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
}
#endif
