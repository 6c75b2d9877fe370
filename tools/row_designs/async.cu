// A redesign of sinkhorn_row_update (src/repro_torch/csrc/sinkhorn_row.cu)
// for Hopper that was measured and not shipped: the Ampere-style second
// design, c read through per-warp rings of 16-byte cp.async copies.
// tools/row_kernel_designs.py builds it, holds it against the plain
// version and times it beside the shipped kernel; PERF.md (section 6)
// gives the numbers. Kept so a next attempt starts from it.
//
// Design. A grid of kBlocksPerSm blocks an SM of kWarps warps; each warp
// walks rows (lane b = row / m) with a stride of all the grid's warps. A
// lane keeps kDepth of its float4 of c in flight in its own slots of
// shared memory (cp.async.cg, one commit group per float4, wait_group
// kDepth - 1 before each use; a lane reads only what it copied, so no
// barrier), reads g with __ldg, and pushes each term into one (max, sum)
// pair as the shipped kernel does; the warp merges by a butterfly. In
// flight an SM: kBlocksPerSm x kWarps x kDepth x 512 bytes.
//
// Build flag: -DROW_NO_EXP replaces the exp chain by a plain sum (the
// data path alone).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kSumFloor = 1e-30f;
constexpr int kWarps = 16;

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

// Butterfly over the warp, then f = reg (log_nu - lse) from lane 0.
static __device__ __forceinline__ void finish_row(float mx, float s,
                                                  float r, float log_nu,
                                                  float *f, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xFFFFFFFFu, mx, off);
    const float s2 = __shfl_xor_sync(0xFFFFFFFFu, s, off);
    lse_merge(m2, s2, mx, s);
  }
  if (lane == 0) {
    const float lse = mx + logf(fmaxf(s, kSumFloor));
    *f = r * (log_nu - lse);
  }
}

static __device__ __forceinline__ void cp_async16(void *dst,
                                                  const void *src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int kDepth>
__global__ void __launch_bounds__(kWarps * 32)
sinkhorn_row_async_kernel(const float *__restrict__ c,
                          const float *__restrict__ g,
                          const float *__restrict__ log_nu,
                          const float *__restrict__ reg,
                          float *__restrict__ f_out, int B, int m, int n) {
  extern __shared__ __align__(16) float4 ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4 *mine = ring + warp * kDepth * 32 + lane;
  const long long R = (long long)B * m;
  const long long stride = (long long)gridDim.x * kWarps;
  const int n4 = n >> 2;
  const int cnt = n4 > lane ? (n4 - lane + 31) / 32 : 0;  // float4 a lane
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < R;
       row += stride) {
    const int b = (int)(row / m);
    const float r = reg[b];
    const float inv_reg = 1.f / r;
    const float4 *c4 = reinterpret_cast<const float4 *>(c + row * n) + lane;
    const float4 *g4 =
        reinterpret_cast<const float4 *>(g + (long long)b * n) + lane;
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (i < cnt) cp_async16(mine + 32 * i, c4 + 32 * i);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    float mx = -INFINITY, s = 0.f;
    for (int i = 0; i < cnt; ++i) {
      asm volatile("cp.async.wait_group %0;" ::"n"(kDepth - 1) : "memory");
      const int slot = i & (kDepth - 1);
      const float4 cv = mine[32 * slot];
      const float4 gv = __ldg(g4 + 32 * i);
#ifdef ROW_NO_EXP
      mx = fmaxf(mx, (gv.x - cv.x) + (gv.y - cv.y) + (gv.z - cv.z) +
                         (gv.w - cv.w));
      s += 1.f;
#else
      lse_push((gv.x - cv.x) * inv_reg, mx, s);
      lse_push((gv.y - cv.y) * inv_reg, mx, s);
      lse_push((gv.z - cv.z) * inv_reg, mx, s);
      lse_push((gv.w - cv.w) * inv_reg, mx, s);
#endif
      // the slot's value is used: refill it
      if (i + kDepth < cnt) cp_async16(mine + 32 * slot, c4 + 32 * (i + kDepth));
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    finish_row(mx, s, r, log_nu[row], f_out + row, lane);
  }
}

int g_sms[64];

template <int kDepth>
int launch(const float *c, const float *g, const float *log_nu,
           const float *reg, float *f_out, int B, int m, int n,
           int blocks_per_sm, cudaStream_t stream) {
  const long long rows = (long long)B * m;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = kWarps * kDepth * 32 * 16;
  err = cudaFuncSetAttribute(sinkhorn_row_async_kernel<kDepth>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)g_sms[dev] * blocks_per_sm;
  const long long need = (rows + kWarps - 1) / kWarps;
  if (grid > need) grid = need;
  sinkhorn_row_async_kernel<kDepth><<<(int)grid, kWarps * 32, smem, stream>>>(
      c, g, log_nu, reg, f_out, B, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// c (B, m, n), g (B, n), log_nu (B, m), reg (B,), f_out (B, m) f32 device
// pointers of contiguous tensors (n % 4 == 0, c and g 16-byte aligned);
// depth 2, 4 or 8 float4 a lane in flight, blocks_per_sm blocks of 16
// warps an SM. Returns the cudaError_t of the launch.
extern "C" int row_design_launch(const void *c, const void *g,
                                 const void *log_nu, const void *reg,
                                 void *f_out, int B, int m, int n, int depth,
                                 int blocks_per_sm, void *stream) {
  if ((long long)B * m == 0) return (int)cudaSuccess;
  if (n <= 0 || n % 4 != 0 || blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  const float *cf = static_cast<const float *>(c);
  const float *gf = static_cast<const float *>(g);
  const float *lf = static_cast<const float *>(log_nu);
  const float *rf = static_cast<const float *>(reg);
  float *fo = static_cast<float *>(f_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 2:
      return launch<2>(cf, gf, lf, rf, fo, B, m, n, blocks_per_sm, st);
    case 4:
      return launch<4>(cf, gf, lf, rf, fo, B, m, n, blocks_per_sm, st);
    case 8:
      return launch<8>(cf, gf, lf, rf, fo, B, m, n, blocks_per_sm, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
