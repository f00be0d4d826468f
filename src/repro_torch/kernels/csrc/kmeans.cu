// K-means kernels of the selection hot path (paper §3.1), for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/kmeans.py:
//   kmeans_pairwise_dist  <- kmeans_pairwise_dist_kernel (kmeans.py:67)
//   kmeans_lloyd          <- kmeans_lloyd_kernel         (kmeans.py:127)
// Plain versions: repro_torch/kernels/ref.py. Python wrappers:
// repro_torch/kernels/kmeans.py (launch) and kernels/ops.py (checks).
//
// What bounds them on the H100. At the main path's shapes (a client's
// N = 2500 PCA features of width D = P = 200; K = 10 centres per class in
// farthest-point init, K = 100 label-masked slots in Lloyd) both kernels
// do 2*N*K*D multiply-adds over a few MB of input: the f32 FMA rate
// bounds them at ~1.5 us (Lloyd) and ~0.15 us (init step), memory at
// ~1 us and ~0.6 us. Far below that, a launch and the serial grid tail
// dominate: the problem is a few dozen blocks wide.
//
// What the design does about it. A simple, exact first version:
//   * The x.c product is a tiled shared-memory f32 FMA loop: a block
//     computes a 64-row x 64-column tile, 256 threads each owning a 4x4
//     strided micro-tile (rows ty+16i, columns tx+16j, so neighbouring
//     threads read neighbouring shared words), over 16-wide slices of D.
//     Ragged N, K and D are masked at the load (zero fill contributes 0
//     to every dot and norm), so the wrapper pads nothing. The norms
//     ||x||^2 and ||c||^2 are accumulated from the same shared tiles.
//     No tensor cores: f32 results must track the plain version to 2e-3,
//     and TF32 would not (a wgmma/TF32x3 version is later work).
//   * The TPU Lloyd kernel carries `sums`/`counts` in a block pinned to
//     (0,0) across a grid that runs in order. Hopper runs blocks in any
//     order, and `_lloyd_iterate` exits on the bit-exact test
//     `new_c == c`, so the sums must be the same bits on every run: no
//     float atomics. Lloyd is two launches. Pass 1 (one block per 64
//     rows) loops over 64-column tiles of K, adds the additive mask,
//     keeps a per-row running (min, argmin) with the lowest index winning
//     ties (jnp.argmin semantics), reduces it across the 16 threads that
//     share a row with warp shuffles, and writes assign, mindist and the
//     row weight (min(lmask) <= 0). Pass 2 (one block per cluster and
//     128-column slice of D) walks the rows in ascending order and sums
//     the rows assigned to its cluster: a fixed order, so fixed bits.
//
// Every entry point returns cudaGetLastError(); the wrapper raises on a
// non-zero value. Launches go on the caller's stream and do not sync.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // rows of x per tile
constexpr int BN = 64;        // centroids per tile
constexpr int BK = 16;        // slice of D per shared-memory stage
constexpr int TM = 4;         // rows per thread (strided by 16)
constexpr int TN = 4;         // centroids per thread (strided by 16)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int SUM_THREADS = 128;
constexpr int SUM_CHUNK = 1024;

// acc[i][j] = x[row0 + ty + 16 i] . c[col0 + tx + 16 j], x2[i] = ||x row||^2,
// c2[j] = ||c row||^2; rows >= n, centroids >= k and columns >= d read as 0.
__device__ __forceinline__ void tile_dots(
    const float* __restrict__ x, const float* __restrict__ c,
    long long n, int k, int d, long long row0, int col0,
    float (*xs)[BM + 1], float (*cs)[BN + 1],
    float acc[TM][TN], float x2[TM], float c2[TN]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    x2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) c2[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      const long long gr = row0 + r;
      const int gc = col0 + r;
      xs[kk][r] = (gr < n && gk < d) ? x[gr * d + gk] : 0.f;
      cs[kk][r] = (gc < k && gk < d) ? c[(long long)gc * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) x2[i] = fmaf(a[i], a[i], x2[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) c2[j] = fmaf(b[j], b[j], c2[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
pairwise_dist_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ out, long long n, int k, int d) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float cs[BK][BN + 1];
  const long long row0 = (long long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[TM][TN], x2[TM], c2[TN];
  tile_dots(x, c, n, k, d, row0, col0, xs, cs, acc, x2, c2);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx + 16 * j;
      if (r < n && cc < k)
        out[r * k + cc] = (x2[i] + c2[j]) - 2.f * acc[i][j];
    }
  }
}

// (v, i) beats (bv, bi) when smaller, or equal with a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
lloyd_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ lmask, int* __restrict__ assign,
                    float* __restrict__ mindist, int* __restrict__ weight,
                    long long n, int k, int d) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float cs[BK][BN + 1];
  const long long row0 = (long long)blockIdx.x * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float best[TM], mmin[TM];
  int besti[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    besti[i] = 0x7fffffff;
    mmin[i] = INFINITY;
  }
  for (int col0 = 0; col0 < k; col0 += BN) {
    float acc[TM][TN], x2[TM], c2[TN];
    tile_dots(x, c, n, k, d, row0, col0, xs, cs, acc, x2, c2);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long r = row0 + ty + 16 * i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int cc = col0 + tx + 16 * j;
        if (cc >= k) continue;
        const float m = lmask[r * k + cc];
        const float v = ((x2[i] + c2[j]) - 2.f * acc[i][j]) + m;
        if (better(v, cc, best[i], besti[i])) {
          best[i] = v;
          besti[i] = cc;
        }
        mmin[i] = fminf(mmin[i], m);
      }
    }
  }
  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, besti[i], off);
      const float om = __shfl_xor_sync(0xffffffffu, mmin[i], off);
      if (better(ov, oi, best[i], besti[i])) {
        best[i] = ov;
        besti[i] = oi;
      }
      mmin[i] = fminf(mmin[i], om);
    }
    const long long r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      assign[r] = besti[i];
      mindist[r] = best[i];
      weight[r] = mmin[i] <= 0.f ? 1 : 0;
    }
  }
}

// sums[cl, col] = sum over rows r (ascending) with weight[r] and
// assign[r] == cl of x[r, col]; counts[cl] = the number of such rows.
__global__ void __launch_bounds__(SUM_THREADS)
lloyd_sums_kernel(const float* __restrict__ x, const int* __restrict__ assign,
                  const int* __restrict__ weight, float* __restrict__ sums,
                  float* __restrict__ counts, long long n, int k, int d) {
  __shared__ unsigned char take[SUM_CHUNK];
  const int cl = blockIdx.x;
  const int col = blockIdx.y * SUM_THREADS + threadIdx.x;
  float acc = 0.f;
  long long cnt = 0;
  for (long long n0 = 0; n0 < n; n0 += SUM_CHUNK) {
    const int m = (int)((n - n0) < SUM_CHUNK ? (n - n0) : SUM_CHUNK);
    for (int t = threadIdx.x; t < m; t += SUM_THREADS)
      take[t] = (weight[n0 + t] != 0 && assign[n0 + t] == cl) ? 1 : 0;
    __syncthreads();
    for (int t = 0; t < m; ++t) {
      if (take[t]) {                 // the same branch for the whole block
        if (col < d) acc += x[(n0 + t) * d + col];
        ++cnt;
      }
    }
    __syncthreads();
  }
  if (col < d) sums[(long long)cl * d + col] = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[cl] = (float)cnt;
}

}  // namespace

extern "C" int repro_kmeans_pairwise_dist(const float* x, const float* c,
                                          float* out, long long n, int k,
                                          int d, cudaStream_t stream) {
  if (n > 0 && k > 0) {
    dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)((k + BN - 1) / BN));
    pairwise_dist_kernel<<<grid, THREADS, 0, stream>>>(x, c, out, n, k, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_kmeans_lloyd(const float* x, const float* c,
                                  const float* lmask, int* assign,
                                  float* mindist, int* weight, float* sums,
                                  float* counts, long long n, int k, int d,
                                  cudaStream_t stream) {
  if (n > 0 && k > 0) {
    lloyd_assign_kernel<<<(unsigned)((n + BM - 1) / BM), THREADS, 0,
                          stream>>>(x, c, lmask, assign, mindist, weight, n,
                                    k, d);
  }
  if (k > 0 && d > 0) {
    dim3 grid((unsigned)k, (unsigned)((d + SUM_THREADS - 1) / SUM_THREADS));
    lloyd_sums_kernel<<<grid, SUM_THREADS, 0, stream>>>(x, assign, weight,
                                                        sums, counts, n, k, d);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
