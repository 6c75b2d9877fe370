// cost_matrix: pairwise sqeuclidean / euclidean / l1 costs between point
// clouds, batched, for Hopper (sm_90a).
//
// Replaces the Pallas kernels cost_matrix and cost_matrix_batched
// (src/repro/kernels/cost_matrix.py): one kernel family, the unbatched
// form is B = 1. sqeuclidean and euclidean keep the Gram identity of
// _sqeuclid_tile, max(|x|^2 + |y|^2 - 2 x.y, 0) and sqrt(d + 1e-30), with
// |x|^2, |y|^2 and the dot product all formed inside the kernel; l1 streams
// the feature axis. Plain fp32: no tensor cores, no TF32, no fast math
// (integer costs are floored from these floats downstream).
//
// What bounds it: it writes 4 B m n bytes and does B m n d terms, one FFMA
// each for sqeuclidean and euclidean, two FADDs (x - y, then + |.|) for
// l1. On the paper's 2-D point clouds (d = 2) that is far below the
// card's ~20 fp32 operations per byte, so it is bound by the write of the
// output (400 MB at m = n = 10 000: 0.12 ms at 3.35 TB/s). With l1 on
// 784-pixel images (d = 784) it is bound by fp32 instruction issue.
//
// Two instances, picked by the launcher from d:
//
// Points (d <= 16). No shared memory: each thread holds the y points of
// four consecutive columns and their |y|^2 in registers, walks a
// contiguous range of rows (a grid sized to fill the card once) and writes
// one float4 a row with a streaming store (scalar stores where n % 4 !=
// 0). The arithmetic per element is fixed term by term, whatever the
// tiling: fmaf chains over k from 0 for x.y, |x|^2 and |y|^2, the rounded
// (|x|^2 + |y|^2) - 2 g epilogue, and l1's += |x - y| in order of k. The
// integer costs are floored from these floats, so a new layout must not
// move a bit (chip_smoke's out_sha256 rows check it against a parent).
//
// Images (d > 16). A 128 x 128 output tile per block of 256 threads, 8 x 8
// per thread (rows ty + 16 i, columns tx + 16 j). The feature axis goes in
// chunks of 16, double-buffered in shared memory by cp.async (16-byte
// copies where d % 4 == 0 and x, y are 16-byte aligned, else 4-byte
// ones), each row's 16 floats as four 16-byte units at unit
// 4 r + (u ^ ((r >> 1) & 3)): the copies of a quarter-warp (two rows, four
// units each) and the 16-byte reads of eight neighbouring columns both
// fall in eight distinct bank groups; the rows' reads are broadcasts.
// Per 4 features a thread makes 16 shared loads for 256 terms. |x|^2 and
// |y|^2 are summed once per tile row from shared memory. The 64
// accumulators, 32 x values and 4 y values of a thread need 168-216
// registers, so one block an SM: two blocks cap a thread at 128, and the
// kernel then spilled and ran slower.

#include <cuda_runtime.h>

namespace {

constexpr int kPointsThreads = 128;  // column quads per points block
constexpr int kTile = 128;           // images: output tile edge
constexpr int kChunk = 16;           // images: features per chunk
constexpr int kImgThreads = 256;

template <int kMetric>  // 0 sqeuclidean, 1 euclidean, 2 l1
static __device__ __forceinline__ float finish(float x2, float y2,
                                               float acc) {
  if (kMetric == 2) return acc;
  // (|x|^2 + |y|^2) - 2 g, rounded step by step as the reference
  float v = __fsub_rn(__fadd_rn(x2, y2), __fmul_rn(2.f, acc));
  v = fmaxf(v, 0.f);
  if (kMetric == 1) v = __fsqrt_rn(__fadd_rn(v, 1e-30f));
  return v;
}

template <int kMetric, int kD>
__global__ void __launch_bounds__(kPointsThreads)
cost_points_kernel(const float *__restrict__ x, const float *__restrict__ y,
                   float *__restrict__ out, int m, int n, int d,
                   int rows_per_block) {
  const int b = blockIdx.z;
  const int j0 = 4 * (blockIdx.x * kPointsThreads + threadIdx.x);
  if (j0 >= n) return;
  const int i0 = blockIdx.y * rows_per_block;
  const int i1 = min(m, i0 + rows_per_block);
  const float *xb = x + (long long)b * m * d;
  const float *yb = y + (long long)b * n * d;

  float yv[4][kD], y2[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    y2[q] = 0.f;
    const bool in = j0 + q < n;
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      yv[q][k] = 0.f;
      if (k < d) {
        yv[q][k] = in ? __ldg(yb + (long long)(j0 + q) * d + k) : 0.f;
        if (kMetric != 2) y2[q] = fmaf(yv[q][k], yv[q][k], y2[q]);
      }
    }
  }
  const bool vec = (n & 3) == 0;
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float *xr = xb + (long long)i * d;
    float xv[kD], x2 = 0.f;
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      xv[k] = 0.f;
      if (k < d) {
        xv[k] = __ldg(xr + k);
        if (kMetric != 2) x2 = fmaf(xv[k], xv[k], x2);
      }
    }
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        if (k < d) {
          if (kMetric == 2) {
            acc += fabsf(xv[k] - yv[q][k]);
          } else {
            acc = fmaf(xv[k], yv[q][k], acc);
          }
        }
      }
      o[q] = finish<kMetric>(x2, y2[q], acc);
    }
    float *orow = out + ((long long)b * m + i) * n + j0;
    if (vec) {
      __stcs(reinterpret_cast<float4 *>(orow),
             make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < n) __stcs(orow + q, o[q]);
    }
  }
}

static __device__ __forceinline__ unsigned smem_u32(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of ``size`` bytes; ``src_bytes`` < size fills the rest with 0
template <int kSize>
static __device__ __forceinline__ void cp_async(void *dst, const void *src,
                                                int src_bytes) {
  if (kSize == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

// the 16-byte unit of (row r, unit u) in a chunk of a 128-row tile
static __device__ __forceinline__ int unit(int r, int u) {
  return 4 * r + (u ^ ((r >> 1) & 3));
}

// Copy the chunk of features [k0, k0 + 16) of the tile's 128 rows of
// ``src`` (rows row0.., ``rows`` valid, ``d`` features) into ``dst``;
// features past d and rows past ``rows`` read as 0.
template <bool kAligned>
static __device__ __forceinline__ void load_chunk(float *dst,
                                                  const float *src, int row0,
                                                  int rows, int d, int k0) {
  const int t = threadIdx.x;
  if (kAligned) {
#pragma unroll
    for (int e = 0; e < (kTile * kChunk / 4) / kImgThreads; ++e) {
      const int v = t + e * kImgThreads;
      const int r = v >> 2, u = v & 3, k = k0 + 4 * u;
      const bool in = row0 + r < rows && k < d;  // d % 4 == 0
      cp_async<16>(dst + 4 * unit(r, u),
                   in ? src + (long long)(row0 + r) * d + k : src,
                   in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < (kTile * kChunk) / kImgThreads; ++e) {
      const int v = t + e * kImgThreads;
      const int r = v >> 4, kk = v & 15, k = k0 + kk;
      const bool in = row0 + r < rows && k < d;
      cp_async<4>(dst + 4 * unit(r, kk >> 2) + (kk & 3),
                  in ? src + (long long)(row0 + r) * d + k : src,
                  in ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kMetric, bool kAligned>
__global__ void __launch_bounds__(kImgThreads, 1)
cost_images_kernel(const float *__restrict__ x, const float *__restrict__ y,
                   float *__restrict__ out, int m, int n, int d) {
  __shared__ __align__(16) float xs[2][kTile * kChunk];
  __shared__ __align__(16) float ys[2][kTile * kChunk];
  __shared__ float norms[2][kTile];  // |x|^2 of the tile rows, |y|^2 cols
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const float *xb = x + (long long)b * m * d;
  const float *yb = y + (long long)b * n * d;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // row t of x (t < 128) or row t - 128 of y

  const int chunks = (d + kChunk - 1) / kChunk;
  load_chunk<kAligned>(xs[0], xb, row0, m, d, 0);
  load_chunk<kAligned>(ys[0], yb, col0, n, d, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < chunks) {
      load_chunk<kAligned>(xs[buf ^ 1], xb, row0, m, d, (ch + 1) * kChunk);
      load_chunk<kAligned>(ys[buf ^ 1], yb, col0, n, d, (ch + 1) * kChunk);
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int kn = min(kChunk, d - ch * kChunk);
    const float *xc = xs[buf], *yc = ys[buf];
    if (kMetric != 2) {
      const float *own = t < kTile ? xc : yc;
      const int r = t & (kTile - 1);
      for (int kk = 0; kk < kn; ++kk) {
        const float v = own[4 * unit(r, kk >> 2) + (kk & 3)];
        norm = fmaf(v, v, norm);
      }
    }
    // features past d read as 0 and add exact zeros
    for (int u = 0; u < (kn + 3) / 4; ++u) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4 *>(xc +
                                                  4 * unit(ty + 16 * i, u));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 yv =
            *reinterpret_cast<const float4 *>(yc + 4 * unit(tx + 16 * j, u));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = acc[i][j];
          if (kMetric == 2) {
            a += fabsf(xv[i].x - yv.x);
            a += fabsf(xv[i].y - yv.y);
            a += fabsf(xv[i].z - yv.z);
            a += fabsf(xv[i].w - yv.w);
          } else {
            a = fmaf(xv[i].x, yv.x, a);
            a = fmaf(xv[i].y, yv.y, a);
            a = fmaf(xv[i].z, yv.z, a);
            a = fmaf(xv[i].w, yv.w, a);
          }
          acc[i][j] = a;
        }
      }
    }
    __syncthreads();
  }

  if (kMetric != 2) {
    norms[t >> 7][t & (kTile - 1)] = norm;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    if (row >= m) continue;
    float *orow = out + ((long long)b * m + row) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = tx + 16 * j, col = col0 + cc;
      if (col < n)
        orow[col] = finish<kMetric>(norms[0][r], norms[1][cc], acc[i][j]);
    }
  }
}

// Rows a points block walks: the (column tile, lane) pairs times the row
// ranges fill the ``slots`` resident blocks of the card once, never more.
int points_rows_per_block(int B, int m, int n, long long slots) {
  const long long tiles =
      (long long)(((n + 3) / 4 + kPointsThreads - 1) / kPointsThreads) * B;
  long long row_blocks = slots / tiles;
  if (row_blocks < 1) row_blocks = 1;
  if (row_blocks > m) row_blocks = m;
  return (int)((m + row_blocks - 1) / row_blocks);
}

int g_sms[64];

template <int kMetric>
cudaError_t launch_points(const float *x, const float *y, float *out, int B,
                          int m, int n, int d, cudaStream_t s) {
  void (*kernel)(const float *, const float *, float *, int, int, int,
                 int) = d <= 2   ? cost_points_kernel<kMetric, 2>
                        : d <= 4 ? cost_points_kernel<kMetric, 4>
                        : d <= 8 ? cost_points_kernel<kMetric, 8>
                                 : cost_points_kernel<kMetric, 16>;
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPointsThreads, 0);
  if (err != cudaSuccess) return err;
  const int rows = points_rows_per_block(
      B, m, n, (long long)g_sms[dev] * (per_sm > 0 ? per_sm : 1));
  const int quads = (n + 3) / 4;
  const dim3 grid((quads + kPointsThreads - 1) / kPointsThreads,
                  (m + rows - 1) / rows, B);
  kernel<<<grid, kPointsThreads, 0, s>>>(x, y, out, m, n, d, rows);
  return cudaGetLastError();
}

template <int kMetric>
cudaError_t launch_images(const float *x, const float *y, float *out, int B,
                          int m, int n, int d, int aligned, cudaStream_t s) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, B);
  if (aligned) {
    cost_images_kernel<kMetric, true><<<grid, kImgThreads, 0, s>>>(
        x, y, out, m, n, d);
  } else {
    cost_images_kernel<kMetric, false><<<grid, kImgThreads, 0, s>>>(
        x, y, out, m, n, d);
  }
  return cudaGetLastError();
}

template <int kMetric>
cudaError_t launch(const float *x, const float *y, float *out, int B, int m,
                   int n, int d, int aligned, cudaStream_t s) {
  return d <= 16 ? launch_points<kMetric>(x, y, out, B, m, n, d, s)
                 : launch_images<kMetric>(x, y, out, B, m, n, d, aligned, s);
}

}  // namespace

// C interface for ctypes: x (B, m, d), y (B, n, d) float32 contiguous,
// out (B, m, n) float32; metric 0 sqeuclidean, 1 euclidean, 2 l1.
// d <= 16 takes the points instance; d > 16 the images instance, with
// 16-byte copies when ``aligned`` (the caller checks d % 4 == 0 and
// 16-byte alignment of x and y). Returns the cudaError_t of the launch.
extern "C" int cost_matrix_launch(const void *x, const void *y, void *out,
                                  int B, int m, int n, int d, int metric,
                                  int aligned, void *stream) {
  if ((long long)B * m * n == 0) return (int)cudaSuccess;
  if (B > 65535 || (m + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float *>(x);
  const float *yf = static_cast<const float *>(y);
  float *of = static_cast<float *>(out);
  switch (metric) {
    case 0:
      return (int)launch<0>(xf, yf, of, B, m, n, d, aligned, s);
    case 1:
      return (int)launch<1>(xf, yf, of, B, m, n, d, aligned, s);
    case 2:
      return (int)launch<2>(xf, yf, of, B, m, n, d, aligned, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
