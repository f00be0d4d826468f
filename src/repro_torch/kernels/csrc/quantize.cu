// Per-tensor affine int8 quantizer of the transport layer, for sm_90a.
//
// Replaces the Pallas TPU kernel quantize_affine_kernel of
// src/repro/kernels/quantize.py:81 (the int8 SelectedKnowledge codec).
// Plain version: repro_torch/kernels/ref.py quantize_affine_ref, whose
// result this kernel reproduces BYTE FOR BYTE (and so does
// repro.kernels.ref.quantize_affine_ref): the wire bytes must not depend
// on the engine that produced them.
//
// What bounds it on the H100. It reads the (N, D) f32 payload and writes
// it back as int8: at the main path's N = 100 slots x D = 16384 that is
// 6.5 MB in and 1.6 MB out, ~2.4 us at 3.35 TB/s. Memory bound.
//
// What the design does about it. The global masked (min, max) must be
// known before any element can be quantized. The TPU kernel ran a
// two-phase grid in order with the statistics pinned to block (0,0);
// Hopper runs blocks in any order, so here it is two launches:
//   1. minmax: a grid-stride loop over rows (whole masked rows are
//      skipped, not read), threads striding the columns, a shared-memory
//      reduction, one (min, max) partial per block.
//   2. quantize: every block first reduces all partials itself (min and
//      max are exact and order-free, so every block gets the same bits;
//      no atomics and no third launch), derives (xmin, scale) exactly as
//      ref.affine_params_from_minmax does, then quantizes its rows.
// x is read twice; a single-pass version (keeping the payload in shared
// memory or L2) is later work.
//
// Rounding is pinned down op by op: __fsub_rn / __fmul_rn (and -fmad=false
// for the whole file) so no contraction changes a rounding, one IEEE
// reciprocal 1/scale (__fdiv_rn, never __fdividef), scale = rng * f32(1/255)
// (never rng / 255), and rintf (half to even, as jnp.round / torch.round).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTS = 1024;      // blocks of the minmax launch
constexpr float BIG = 1e30f;         // ref.BIG: the empty-min sentinel

__device__ __forceinline__ void block_minmax(float& mn, float& mx) {
  __shared__ float smin[THREADS];
  __shared__ float smax[THREADS];
  smin[threadIdx.x] = mn;
  smax[threadIdx.x] = mx;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      smin[threadIdx.x] = fminf(smin[threadIdx.x], smin[threadIdx.x + s]);
      smax[threadIdx.x] = fmaxf(smax[threadIdx.x], smax[threadIdx.x + s]);
    }
    __syncthreads();
  }
  mn = smin[0];
  mx = smax[0];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
minmax_kernel(const float* __restrict__ x, const uint8_t* __restrict__ rowmask,
              float* __restrict__ partials, long long n, long long d) {
  float mn = BIG, mx = -BIG;
  for (long long r = blockIdx.x; r < n; r += gridDim.x) {
    if (!rowmask[r]) continue;       // the same branch for the whole block
    const float* row = x + r * d;
    for (long long j = threadIdx.x; j < d; j += THREADS) {
      const float v = row[j];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
  }
  block_minmax(mn, mx);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = mn;
    partials[2 * blockIdx.x + 1] = mx;
  }
}

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x,
                const uint8_t* __restrict__ rowmask,
                const float* __restrict__ partials, int nparts,
                int8_t* __restrict__ q, float* __restrict__ params,
                long long n, long long d) {
  float mn = BIG, mx = -BIG;
  for (int p = threadIdx.x; p < nparts; p += THREADS) {
    mn = fminf(mn, partials[2 * p]);
    mx = fmaxf(mx, partials[2 * p + 1]);
  }
  block_minmax(mn, mx);
  // ref.affine_params_from_minmax, op for op
  const bool has = mx >= mn;
  const float xmin = has ? mn : 0.f;
  const float rng = has ? __fsub_rn(mx, xmin) : 0.f;
  const float scale = rng > 0.f ? __fmul_rn(rng, (float)(1.0 / 255.0)) : 1.f;
  const float inv = __fdiv_rn(1.f, scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    params[0] = xmin;
    params[1] = scale;
  }
  for (long long r = blockIdx.x; r < n; r += gridDim.x) {
    const bool ok = rowmask[r] != 0;
    const float* row = x + r * d;
    int8_t* qrow = q + r * d;
    for (long long j = threadIdx.x; j < d; j += THREADS) {
      float t = -128.f;
      if (ok) {
        t = rintf(__fmul_rn(__fsub_rn(row[j], xmin), inv));
        t = __fsub_rn(t, 128.f);
        t = fminf(fmaxf(t, -128.f), 127.f);
      }
      qrow[j] = (int8_t)t;
    }
  }
}

}  // namespace

// params (2 f32, device): xmin, scale. partials: 2 * MAX_PARTS f32 scratch.
extern "C" int repro_quantize_affine(const float* x, const uint8_t* rowmask,
                                     int8_t* q, float* params,
                                     float* partials, long long n,
                                     long long d, cudaStream_t stream) {
  const int blocks = (int)(n < 1 ? 1 : (n < MAX_PARTS ? n : MAX_PARTS));
  minmax_kernel<<<blocks, THREADS, 0, stream>>>(x, rowmask, partials, n, d);
  quantize_kernel<<<blocks, THREADS, 0, stream>>>(x, rowmask, partials,
                                                  blocks, q, params, n, d);
  return (int)cudaGetLastError();
}

extern "C" int repro_quantize_max_parts() { return MAX_PARTS; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
