// sinkhorn_row_update: the log-domain Sinkhorn f-update over a batch, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel sinkhorn_row_update
// (src/repro/kernels/sinkhorn_step.py:50), which the reference batches
// with vmap; here the batch is a grid axis. For lane b and row i:
//
//   f[b, i] = reg[b] * (log_nu[b, i] - LSE_j((g[b, j] - c[b, i, j]) / reg[b]))
//
// with z = (g - c) * (1 / reg) as the Pallas kernel forms it, an online
// logsumexp over the columns (a running max and a sum scaled to it), and
// the final sum floored at 1e-30 (the Pallas kernel's 1e-38 is subnormal
// and flushes to zero where subnormals are flushed; no fast math here).
// Where both maxima of a merge are -inf the merge gives sum 0 instead of
// exp(-inf - -inf) = NaN, the guard the Pallas kernel takes with
// isfinite.
//
// What bounds it: it reads c once, 4 B m n bytes, plus g, log_nu and f:
// at B = 1, 4096 x 4096 that is 64 MB, 0.020 ms at 3.35 TB/s. It takes one
// exp per element (16.8 M at 4096^2, a few microseconds on the SFUs), so
// it is bound by bytes.
//
// Design: one warp per (lane, row). The warp strides over the row in
// 16-byte loads (float4 of c and g) when n % 4 == 0 and the operands are
// 16-byte aligned, else in 4-byte loads; consecutive threads read
// consecutive addresses. Each thread keeps its own (max, sum) pair with one
// exp per element, and a __shfl_xor butterfly merges the 32 pairs. Rows of
// a lane that ``active`` marks off read nothing: the warp copies f_in to
// f_out for them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kSumFloor = 1e-30f;

// Push one term z into the running pair (mx, s): s = sum exp(z_k - mx).
// One exp per term: exp(smaller - larger) rescales whichever side is
// smaller. Both -inf: the term adds 0.
static __device__ __forceinline__ void lse_push(float z, float &mx,
                                                float &s) {
  const float hi = fmaxf(mx, z);
  const float e = hi == -INFINITY ? 0.f : expf(fminf(mx, z) - hi);
  s = z > mx ? fmaf(s, e, 1.f) : s + e;
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

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sinkhorn_row_kernel(const float *__restrict__ c, const float *__restrict__ g,
                    const float *__restrict__ log_nu,
                    const float *__restrict__ reg,
                    const unsigned char *__restrict__ active,
                    const float *__restrict__ f_in, float *__restrict__ f_out,
                    int B, int m, int n) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * m) return;  // the whole warp leaves together
  const int b = (int)(row / m);
  if (active != nullptr && !active[b]) {
    if (lane == 0) f_out[row] = f_in[row];
    return;
  }
  const float r = reg[b];
  const float inv_reg = 1.f / r;
  const float *crow = c + row * (long long)n;
  const float *gb = g + (long long)b * n;

  float mx = -INFINITY, s = 0.f;
  if constexpr (kVec) {
    const int n4 = n >> 2;
    const float4 *c4 = reinterpret_cast<const float4 *>(crow);
    const float4 *g4 = reinterpret_cast<const float4 *>(gb);
#pragma unroll 4
    for (int q = lane; q < n4; q += 32) {
      const float4 cv = __ldg(c4 + q);
      const float4 gv = __ldg(g4 + q);
      lse_push((gv.x - cv.x) * inv_reg, mx, s);
      lse_push((gv.y - cv.y) * inv_reg, mx, s);
      lse_push((gv.z - cv.z) * inv_reg, mx, s);
      lse_push((gv.w - cv.w) * inv_reg, mx, s);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) {
      lse_push((__ldg(gb + j) - __ldg(crow + j)) * inv_reg, mx, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xFFFFFFFFu, mx, off);
    const float s2 = __shfl_xor_sync(0xFFFFFFFFu, s, off);
    lse_merge(m2, s2, mx, s);
  }
  if (lane == 0) {
    const float lse = mx + logf(fmaxf(s, kSumFloor));
    f_out[row] = r * (log_nu[row] - lse);
  }
}

}  // namespace

// C interface for ctypes. Pointers are device pointers of contiguous
// tensors: c (B, m, n) f32, g (B, n) f32, log_nu (B, m) f32, reg (B,)
// f32, active (B,) bool or null (every lane active), f_in (B, m) f32 (read
// only for the rows of lanes that active marks off; may be null when
// active is), f_out (B, m) f32. ``vec`` != 0 selects the 16-byte path
// (the caller checks n % 4 == 0 and 16-byte alignment of c and g).
// Returns the cudaError_t of the launch.
extern "C" int sinkhorn_row_launch(const void *c, const void *g,
                                   const void *log_nu, const void *reg,
                                   const void *active, const void *f_in,
                                   void *f_out, int B, int m, int n, int vec,
                                   void *stream) {
  const long long rows = (long long)B * m;
  if (rows == 0) return (int)cudaSuccess;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *cf = static_cast<const float *>(c);
  const float *gf = static_cast<const float *>(g);
  const float *lf = static_cast<const float *>(log_nu);
  const float *rf = static_cast<const float *>(reg);
  const unsigned char *af = static_cast<const unsigned char *>(active);
  const float *fi = static_cast<const float *>(f_in);
  float *fo = static_cast<float *>(f_out);
  if (vec) {
    sinkhorn_row_kernel<true><<<grid, block, 0, st>>>(cf, gf, lf, rf, af, fi,
                                                      fo, B, m, n);
  } else {
    sinkhorn_row_kernel<false><<<grid, block, 0, st>>>(cf, gf, lf, rf, af,
                                                       fi, fo, B, m, n);
  }
  return (int)cudaGetLastError();
}
