// cost_matrix: pairwise sqeuclidean / euclidean / l1 costs between point
// clouds, batched, for Hopper (sm_90a).
//
// Replaces the Pallas kernels cost_matrix and cost_matrix_batched
// (src/repro/kernels/cost_matrix.py): one kernel, the unbatched form is
// B = 1. sqeuclidean and euclidean keep the Gram identity of
// _sqeuclid_tile, max(|x|^2 + |y|^2 - 2 x.y, 0) and sqrt(d + 1e-30), with
// |x|^2, |y|^2 and the dot product all formed inside the kernel; l1 streams
// the feature axis. Plain fp32 FMA: no tensor cores, no TF32, no fast math
// (integer costs are floored from these floats downstream).
//
// What bounds it: it writes 4 B m n bytes and does about 2 B m n d
// operations. On the paper's 2-D point clouds (d = 2) that is 0.5 flop
// per byte written, far below the card's ~20 fp32 flop per byte, so it is
// bound by the write of the output (400 MB at m = n = 10 000: 0.12 ms at
// 3.35 TB/s). With l1 on 784-pixel images (d = 784) it is bound by
// operations.
//
// Design: a 64 x 64 output tile per block of 16 x 16 threads, each thread
// owning a 4 x 4 sub-tile (rows ty + 16 r, cols tx + 16 c, so 16
// neighbouring threads store 16 neighbouring floats). The feature axis is
// walked in chunks of 16 staged through shared memory k-major, so the
// inner loop reads x values as warp broadcasts and y values from 16
// consecutive banks. Chunks stop at d, so d = 2 costs two steps, not 16.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;

template <int kMetric>  // 0 sqeuclidean, 1 euclidean, 2 l1
__global__ void __launch_bounds__(kThreads)
cost_matrix_kernel(const float *__restrict__ x, const float *__restrict__ y,
                   float *__restrict__ out, int m, int n, int d) {
  __shared__ float xs[kChunk][kTile];
  __shared__ float ys[kChunk][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * 16 + tx;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const float *xb = x + (long long)b * m * d;
  const float *yb = y + (long long)b * n * d;

  float acc[4][4];
  float x2[4], y2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    x2[r] = 0.f;
    y2[r] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kn = min(kChunk, d - k0);
    // stage the (64 x kn) slices of x and y, k-major; 0 outside the data
#pragma unroll
    for (int e = 0; e < (kTile * kChunk) / kThreads; ++e) {
      const int idx = t + e * kThreads;
      const int r = idx / kChunk, kk = idx % kChunk;
      const bool kin = kk < kn;
      const int xr = row0 + r, yr = col0 + r;
      xs[kk][r] = (kin && xr < m) ? xb[(long long)xr * d + k0 + kk] : 0.f;
      ys[kk][r] = (kin && yr < n) ? yb[(long long)yr * d + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float xv[4], yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = ys[kk][tx + 16 * q];
      if (kMetric == 2) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += fabsf(xv[r] - yv[q]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x2[r] = fmaf(xv[r], xv[r], x2[r]);
          y2[r] = fmaf(yv[r], yv[r], y2[r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xv[r], yv[q], acc[r][q]);
        }
      }
    }
    __syncthreads();
  }

  // y2[q] above accumulated the squares of y column tx + 16 q
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= m) continue;
    float *orow = out + ((long long)b * m + row) * n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = col0 + tx + 16 * q;
      if (cc >= n) continue;
      float v = acc[r][q];
      if (kMetric != 2) {
        // (|x|^2 + |y|^2) - 2 g, rounded step by step as the reference
        v = __fsub_rn(__fadd_rn(x2[r], y2[q]), __fmul_rn(2.f, v));
        v = fmaxf(v, 0.f);
        if (kMetric == 1) v = __fsqrt_rn(__fadd_rn(v, 1e-30f));
      }
      orow[cc] = v;
    }
  }
}

}  // namespace

// C interface for ctypes: x (B, m, d), y (B, n, d) float32 contiguous,
// out (B, m, n) float32; metric 0 sqeuclidean, 1 euclidean, 2 l1.
// Returns the cudaError_t of the launch.
extern "C" int cost_matrix_launch(const void *x, const void *y, void *out,
                                  int B, int m, int n, int d, int metric,
                                  void *stream) {
  if ((long long)B * m * n == 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(16, 16);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float *>(x);
  const float *yf = static_cast<const float *>(y);
  float *of = static_cast<float *>(out);
  switch (metric) {
    case 0:
      cost_matrix_kernel<0><<<grid, block, 0, s>>>(xf, yf, of, m, n, d);
      break;
    case 1:
      cost_matrix_kernel<1><<<grid, block, 0, s>>>(xf, yf, of, m, n, d);
      break;
    case 2:
      cost_matrix_kernel<2><<<grid, block, 0, s>>>(xf, yf, of, m, n, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
