// Per-tensor affine int8 quantizer of the transport layer, for sm_90a.
//
// Replaces the Pallas TPU kernel quantize_affine_kernel of
// src/repro/kernels/quantize.py:81 (the int8 SelectedKnowledge codec).
// Plain version: repro_torch/kernels/ref.py quantize_affine_ref, whose
// result this kernel reproduces BYTE FOR BYTE (and so does
// repro.kernels.ref.quantize_affine_ref), non-finite payloads included:
// the wire bytes must not depend on the engine that produced them.
//
// What bounds it on the H100: bytes. It must read the valid rows of the
// (N, D) f32 payload once and write all N x D int8 codes once. At the main
// path's N = 100 slots x D = 16384 that is 1.3 MB in (20 valid rows) or
// 5.2 MB (80), and 1.6 MB out: 0.9 or 2.0 us at 3.35 TB/s. Work this short
// is bound by the latency of the few dependent trips to memory it needs
// (the mask, the payload, a grid-wide barrier, the partials) unless the
// whole card takes part in each.
//
// What the design does about it. One cooperative launch of one wave: one
// block of 256 threads on every SM (planned on the host from the occupancy
// query: kernels/quantize.py plan_quantize; more warps an SM only add to
// the scalar work of the walk below and to the barrier):
//   1. Every block reads the row mask (N bytes; the first 256 rows once,
//      kept in registers) and takes an equal span of the valid rows'
//      elements and an equal span of the masked rows'. It fills its masked
//      span with -128 (16-byte stores of 0x80, no read of x), then loads
//      its valid span with 16-byte loads, eight in flight per thread,
//      folding them into a (min, max) partial; on the resident route it
//      also keeps the span in shared memory.
//   2. One grid-wide barrier (cooperative_groups this_grid().sync()).
//   3. Every block reduces all partials itself (one warp reads them, all
//      in flight at once): min and max are exact and order-free, so every
//      block gets the same (xmin, scale) bits; no float atomics and no
//      second launch.
//   4. Every block quantizes its span from shared memory (resident) or
//      from L2 (a payload past one wave's shared memory; x was read in
//      step 1 and the 50 MB L2 holds it) and writes 16 codes per 16-byte
//      store. Rows not 16-byte aligned (D % 4 != 0, a payload off a 16-byte
//      base, a span edge) take scalar heads and tails.
// x is read from HBM once on the resident route. Where the time goes, phase
// by phase: tools/quantize_phases.py.
//
// Non-finite payloads: the min/max propagate NaN (PTX min.NaN / max.NaN,
// as torch.amin / torch.amax), so a NaN in a valid row gives (0, 1); a code
// computed from NaN is 0, the byte the plain version's cast to int8 gives on
// the CPU and on the card. A zero minimum is -0.0 where a valid -0.0 is
// present (XLA's min, which the plain version pins); the max's zero sign
// reaches no byte.
//
// Rounding is pinned down op by op: __fsub_rn / __fmul_rn (and -fmad=false
// for the whole file) so no contraction changes a rounding, one IEEE
// reciprocal 1/scale (__fdiv_rn, never __fdividef), scale = rng * f32(1/255)
// (never rng / 255), and rounding half to even (as jnp.round / torch.round),
// by the exact magic-constant add of code() below.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;            // 16-byte loads in flight per thread
constexpr int PARTS = 8;             // partials in flight per lane
constexpr float BIG = 1e30f;         // ref.BIG: the masked rows' sentinel

struct Scratch {
  int warp_count[WARPS];
  int vrows[THREADS];                // the valid rows of one walk step
  int mrows[THREADS];                // the masked rows of one walk step
  float red[2][WARPS];
};

// min.NaN.f32 orders -0.0 below +0.0 on sm_90 (either operand order gives
// -0.0), so the minimum's zero sign does not depend on the order of the
// reduction; the card tests' signed-zero cases hold it
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void fold(float v, float& mn, float& mx) {
  mn = nan_min(mn, v);
  mx = nan_max(mx, v);
}

// x as the quantize step reads it: from shared memory (RESIDENT) or from
// global memory through the read-only path
template <bool RESIDENT>
__device__ __forceinline__ float read_x(const float* p) {
  if constexpr (RESIDENT) return *p;
  else return __ldg(p);
}

template <bool RESIDENT>
__device__ __forceinline__ float4 read_x4(const float* p) {
  if constexpr (RESIDENT) return *reinterpret_cast<const float4*>(p);
  else return __ldg(reinterpret_cast<const float4*>(p));
}

// exclusive prefix count of ``p`` over the block; ``total`` gets the sum
__device__ int block_scan(bool p, int& total, Scratch& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(0xffffffffu, p);
  if (lane == 0) sh.warp_count[w] = __popc(ball);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const int c = sh.warp_count[i];
    before += i < w ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + __popc(ball & ((1u << lane) - 1u));
}

// The valid rows laid end to end (valid row of rank k holds elements
// [k*d, k*d + d)) and the masked rows likewise: calls
// mfn(row, c0, c1) for each row piece [c0, c1) of the masked span [m0, m1)
// and then vfn(row, c0, c1, off) for each piece of the valid span
// [v0, v1), ``off`` being the piece's start in that span. Called by the
// whole block; one step of the walk takes THREADS rows, and the first
// step's mask comes in ``ok0`` (read once by the kernel).
template <class VFn, class MFn>
__device__ void walk(const uint8_t* __restrict__ mask, bool ok0, int n,
                     int d, int v0, int v1, int m0, int m1, Scratch& sh,
                     VFn&& vfn, MFn&& mfn) {
  const int vk0 = v0 / d, vk1 = v1 > v0 ? (v1 - 1) / d : -1;
  const int mk0 = m0 / d, mk1 = m1 > m0 ? (m1 - 1) / d : -1;
  int vbefore = 0;                   // valid rows before the step
  for (int base = 0; base < n; base += THREADS) {
    const int mbefore = base - vbefore;
    if (vbefore > vk1 && mbefore > mk1) break;
    const int r = base + threadIdx.x;
    const bool in = r < n;
    const bool ok = base == 0 ? ok0 : in && mask[r] != 0;
    int nv;
    const int pv = block_scan(ok, nv, sh);
    const int nm = min(n - base, THREADS) - nv;
    const int vlo = max(vk0, vbefore), vhi = min(vk1, vbefore + nv - 1);
    const int mlo = max(mk0, mbefore), mhi = min(mk1, mbefore + nm - 1);
    const int vk = vbefore + pv, mk = mbefore + threadIdx.x - pv;
    if (ok && vk >= vlo && vk <= vhi) sh.vrows[vk - vlo] = r;
    if (in && !ok && mk >= mlo && mk <= mhi) sh.mrows[mk - mlo] = r;
    __syncthreads();
    for (int k = mlo; k <= mhi; ++k) {
      const int e0 = max(m0, k * d), e1 = min(m1, k * d + d);
      mfn(sh.mrows[k - mlo], e0 - k * d, e1 - k * d);
    }
    for (int k = vlo; k <= vhi; ++k) {
      const int e0 = max(v0, k * d), e1 = min(v1, k * d + d);
      vfn(sh.vrows[k - vlo], e0 - k * d, e1 - k * d, e0 - v0);
    }
    __syncthreads();
    vbefore += nv;
  }
}

// Step 1 for one valid piece: ``len`` elements at src = x + r*d + c0,
// folded into (mn, mx) and, when RESIDENT, staged at ``dst``
template <bool RESIDENT>
__device__ void load_piece(const float* __restrict__ src, int len,
                           float* dst, float& mn, float& mx) {
  const int t = threadIdx.x;
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - mis) & 3, len);
  const int n4 = (len - head) >> 2;
  const int tail = head + (n4 << 2);
  if (t < head) {
    const float v = __ldg(src + t);
    fold(v, mn, mx);
    if (RESIDENT) dst[t] = v;
  }
  if (t < len - tail) {
    const float v = __ldg(src + tail + t);
    fold(v, mn, mx);
    if (RESIDENT) dst[tail + t] = v;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float* out = dst + head;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int i = t; i < n4; i += THREADS * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i + u * THREADS < n4) v[u] = __ldg(s4 + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = i + u * THREADS;
      if (j >= n4) break;
      fold(v[u].x, mn, mx);
      fold(v[u].y, mn, mx);
      fold(v[u].z, mn, mx);
      fold(v[u].w, mn, mx);
      if (RESIDENT) {
        if (out_aligned) {
          reinterpret_cast<float4*>(out)[j] = v[u];
        } else {
          out[4 * j] = v[u].x;
          out[4 * j + 1] = v[u].y;
          out[4 * j + 2] = v[u].z;
          out[4 * j + 3] = v[u].w;
        }
      }
    }
  }
}

// one code, in the low byte of the result: clip(rint(y) - 128, -128, 127)
// of ref.quantize_affine_ref with y = (v - xmin) * inv, op for op, as
// rint(clip(y, 0, 255)) - 128 (the same, rint being monotone), without the
// conversion unit (a quarter of the FMA rate): for c in [0, 255],
// c + 1.5 * 2^23 + 128 rounds c to the nearest integer k, ties to even
// (the constant is even), and its low byte is that of k - 128. NaN gives
// 0, the byte the plain version's cast to int8 gives for it.
__device__ __forceinline__ uint32_t code(float v, float xmin, float inv) {
  const float y = __fmul_rn(__fsub_rn(v, xmin), inv);
  const float c = fminf(fmaxf(y, 0.f), 255.f);
  const uint32_t bits = __float_as_uint(__fadd_rn(c, 12583040.f));
  return y == y ? bits : 0u;
}

// the low bytes of four codes as one word, the first lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Step 4 for one valid piece: ``len`` elements, read from ``stg`` (staged)
// or ``src`` (x, via L2), codes to ``out`` = q + r*d + c0, 16 a store where
// out is 16-byte aligned (q's base is)
template <bool RESIDENT>
__device__ void quantize_piece(const float* __restrict__ src,
                               const float* stg, int8_t* __restrict__ out,
                               int len, float xmin, float inv) {
  const int t = threadIdx.x;
  const int mis = (int)(reinterpret_cast<uintptr_t>(out) & 15);
  const int lead = min((16 - mis) & 15, len);
  const int n16 = (len - lead) >> 4;
  const int tail = lead + (n16 << 4);
  const float* from = RESIDENT ? stg : src;
  if (t < lead) out[t] = (int8_t)code(read_x<RESIDENT>(from + t), xmin, inv);
  if (t < len - tail)
    out[tail + t] = (int8_t)code(read_x<RESIDENT>(from + tail + t), xmin,
                                 inv);
  for (int g = t; g < n16; g += THREADS) {
    const float* p = from + lead + 16 * g;
    float v[16];
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w = read_x4<RESIDENT>(p + 4 * u);
        v[4 * u] = w.x;
        v[4 * u + 1] = w.y;
        v[4 * u + 2] = w.z;
        v[4 * u + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = read_x<RESIDENT>(p + u);
    }
    uint32_t word[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      word[u] = pack4(code(v[4 * u], xmin, inv),
                      code(v[4 * u + 1], xmin, inv),
                      code(v[4 * u + 2], xmin, inv),
                      code(v[4 * u + 3], xmin, inv));
    }
    reinterpret_cast<uint4*>(out + lead)[g] =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// a masked piece: ``len`` codes of -128 at ``out``, no read of x
__device__ void fill_piece(int8_t* __restrict__ out, int len) {
  const int t = threadIdx.x;
  const int mis = (int)(reinterpret_cast<uintptr_t>(out) & 15);
  const int lead = min((16 - mis) & 15, len);
  const int n16 = (len - lead) >> 4;
  const int tail = lead + (n16 << 4);
  if (t < lead) out[t] = -128;
  if (t < len - tail) out[tail + t] = -128;
  const uint4 fill = make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                                0x80808080u);
  for (int g = t; g < n16; g += THREADS)
    reinterpret_cast<uint4*>(out + lead)[g] = fill;
}

__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// params: 2 f32 (xmin, scale); partials: (min, max) per block, 8-byte
// aligned. Indices are 32-bit: the plan refuses a payload of 2^31
// elements or more.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
quantize_affine_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ mask,
                       int8_t* __restrict__ q, float* __restrict__ params,
                       float* __restrict__ partials, int n, int d) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ Scratch sh;
  const int grid = gridDim.x, b = blockIdx.x, lane = threadIdx.x & 31;
  // the mask of the first THREADS rows, read once (a read of the mask
  // waits on the memory's latency, about as long as a phase of this kernel)
  const bool ok0 = (int)threadIdx.x < n && mask[threadIdx.x] != 0;
  int nvalid = __syncthreads_count(ok0);
  for (int base = THREADS; base < n; base += THREADS) {
    const int r = base + threadIdx.x;
    nvalid += __syncthreads_count(r < n && mask[r] != 0);
  }
  // this block's spans of the valid and of the masked elements, in whole
  // 16-element stores
  const int nv = nvalid * d, nm = (n - nvalid) * d;
  const int vspan = ((nv + grid - 1) / grid + 15) & ~15;
  const int mspan = ((nm + grid - 1) / grid + 15) & ~15;
  const int v0 = min(b * vspan, nv), v1 = min(v0 + vspan, nv);
  const int m0 = min(b * mspan, nm), m1 = min(m0 + mspan, nm);

  // 1. the masked rows' fill, then the valid span's loads and statistics
  float mn = __int_as_float(0x7f800000), mx = -mn;     // +inf, -inf
  walk(mask, ok0, n, d, v0, v1, m0, m1, sh,
       [&](int r, int c0, int c1, int off) {
         load_piece<RESIDENT>(x + (size_t)r * d + c0, c1 - c0, stage + off,
                              mn, mx);
       },
       [&](int r, int c0, int c1) {
         fill_piece(q + (size_t)r * d + c0, c1 - c0);
       });
  warp_minmax(mn, mx);
  if (lane == 0) {
    sh.red[0][threadIdx.x >> 5] = mn;
    sh.red[1][threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      mn = nan_min(mn, sh.red[0][i]);
      mx = nan_max(mx, sh.red[1][i]);
    }
    partials[2 * b] = mn;
    partials[2 * b + 1] = mx;
  }

  // 2. every block's partial is written
  cg::this_grid().sync();

  // 3. one warp a block reduces every partial, in the same order in every
  // block (a read of the partials by every warp of every block queues on
  // the few L2 lines that hold them)
  if (threadIdx.x < 32) {
    mn = __int_as_float(0x7f800000);
    mx = -mn;
    const float2* pairs = reinterpret_cast<const float2*>(partials);
    for (int p0 = 0; p0 < grid; p0 += 32 * PARTS) {
      float2 v[PARTS];               // all in flight: one trip to L2
#pragma unroll
      for (int u = 0; u < PARTS; ++u) {
        const int p = p0 + u * 32 + lane;
        v[u] = p < grid ? __ldcg(pairs + p) : make_float2(mn, mx);
      }
#pragma unroll
      for (int u = 0; u < PARTS; ++u) {
        mn = nan_min(mn, v[u].x);
        mx = nan_max(mx, v[u].y);
      }
    }
    warp_minmax(mn, mx);
    if (lane == 0) {
      sh.red[0][0] = mn;
      sh.red[1][0] = mx;
    }
  }
  __syncthreads();
  mn = sh.red[0][0];
  mx = sh.red[1][0];
  if (nvalid < n) {                  // the plain version's where(valid, x,
    mn = nan_min(mn, BIG);           // BIG) puts the sentinels in only when
    mx = nan_max(mx, -BIG);          // some row is masked
  }
  // ref.affine_params_from_minmax, op for op
  const bool has = mx >= mn;
  const float xmin = has ? mn : 0.f;
  const float rng = has ? __fsub_rn(mx, xmin) : 0.f;
  const float scale = rng > 0.f ? __fmul_rn(rng, (float)(1.0 / 255.0)) : 1.f;
  const float inv = __fdiv_rn(1.f, scale);
  if (b == 0 && threadIdx.x == 0) {
    params[0] = xmin;
    params[1] = scale;
  }

  // 4. the codes of this block's valid span
  walk(mask, ok0, n, d, v0, v1, 0, 0, sh,
       [&](int r, int c0, int c1, int off) {
         quantize_piece<RESIDENT>(x + (size_t)r * d + c0, stage + off,
                                  q + (size_t)r * d + c0, c1 - c0, xmin, inv);
       },
       [](int, int, int) {});
}

const void* kernel_for(int resident) {
  return resident ? (const void*)quantize_affine_kernel<true>
                  : (const void*)quantize_affine_kernel<false>;
}

cudaError_t allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// scratch (device f32): xmin, scale, then 2 per block of ``grid``. The plan
// (grid, smem, resident) comes from kernels/quantize.py plan_quantize; a
// grid that cannot be co-resident is refused by the launch, never split.
extern "C" int repro_quantize_affine(const float* x, const uint8_t* mask,
                                     int8_t* q, float* scratch, int n, int d,
                                     int grid, int smem, int resident,
                                     cudaStream_t stream) {
  const void* fn = kernel_for(resident);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  float* params = scratch;
  float* partials = scratch + 2;
  void* args[] = {(void*)&x, (void*)&mask, (void*)&q, (void*)&params,
                  (void*)&partials, (void*)&n, (void*)&d};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args,
                                    (size_t)smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// blocks of THREADS that fit on one SM at ``smem`` dynamic bytes (< 0: a
// CUDA error, negated)
extern "C" int repro_quantize_blocks_per_sm(int resident, int smem) {
  const void* fn = kernel_for(resident);
  cudaError_t err = allow_smem(fn, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                        (size_t)smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// the dynamic shared memory one block of the resident route may take on
// the current device: the opt-in maximum less the static shared memory
extern "C" int repro_quantize_max_smem() {
  cudaFuncAttributes attr;
  int dev = 0, optin = 0;
  if (cudaFuncGetAttributes(&attr, kernel_for(1)) != cudaSuccess
      || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return -1;
  return optin - (int)attr.sharedSizeBytes;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
