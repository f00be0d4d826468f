// Flash-decode: one query token against a ring-buffer KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel flash_decode_kernel of
// src/repro/kernels/decode_attention.py:59 (the attention of every decode
// step). Plain version: repro_torch/kernels/ref.py flash_decode_ref.
// q (B,1,H,D), caches (B,S,KV,D), valid (B,S) bool, in the reference's
// layout; query head h reads kv head h / G with G = H / KV.
//
// What bounds it on the H100. Bytes: every step streams both caches once,
// 2*B*S*KV*D elements, and does about one multiply-add per element per
// query head (G = 4 for llama3.2-1b), far below the card's ~295 FLOP/byte
// ridge. At the serve shape (B=32, S=32768, KV=8, D=64, bf16) that is
// 2.15 GB: 0.64 ms at 3.35 TB/s.
//
// What the design does about it, and what it leaves for later. One block
// per (b, kv head): at the serve shape B*KV = 256 blocks, about two per SM
// on the 132 SMs, so no split of S (and no combine pass) is needed there.
// The block streams the cache in tiles of T positions: K and V are read in
// their own dtype with 16-byte loads where the row allows it, converted to
// f32 in registers on the way into shared memory (no f32 copy of a bf16
// cache is made in device memory), and read once. The G query heads ride
// as rows: each score (g, t) is a D-long f32 dot product from shared
// memory, one warp per head runs the online softmax of the tile, and each
// thread keeps its (head, column) outputs of P.V in registers. Every slot
// is read, valid or not: the mask is applied per slot, so the work does not
// depend on the data. Overlapping a tile's loads with the previous tile's
// arithmetic (cp.async / TMA double buffering), and a split of S for a
// small B*KV (long_500k has B = 1), are later work.
//
// Precision follows the plain version: a slot whose valid flag is false
// gets the logit -1e30 (all false: uniform weights over the S slots, as in
// the reference); a cache element is read as q's dtype (the reference's
// cache.astype(q.dtype): exact for a bf16 cache under f32 q, rounded to
// bf16 for an f32 cache under bf16 q); scores are f32 dot products times
// 1/sqrt(D); exp is the accurate expf; p is rounded to q's dtype before
// P.V; the output is acc / max(l, 1e-30) in q's dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GD = 8192;         // G * DMAX the registers hold
constexpr int NI = MAX_GD / THREADS; // outputs per thread, at most
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16_rn(x); }

// x as the dtype TQ would hold it, in f32
template <typename TQ, typename TC>
__device__ __forceinline__ float as_q(TC x) {
  return to_f<TQ>(from_f<TQ>(to_f<TC>(x)));
}

template <int DMAX> struct Tile { static constexpr int T = DMAX <= 64 ? 128 : 64; };

template <int DMAX>
size_t smem_bytes(int G) {
  constexpr int T = Tile<DMAX>::T;
  // k: T x (DMAX+1), v: T x DMAX, q: G x DMAX, p: G x (T+1), m/l/corr: 3G
  return sizeof(float) * ((size_t)T * (DMAX + 1) + (size_t)T * DMAX +
                          (size_t)G * DMAX + (size_t)G * (T + 1) + 3 * G);
}

// one cache row (D elements at src) -> f32 in dst, as q's dtype
template <typename TQ, typename TC>
__device__ __forceinline__ void load_row_part(const TC* __restrict__ src,
                                              float* dst, int part, int D,
                                              bool vec) {
  constexpr int VEC = 16 / sizeof(TC);
  if (vec) {                          // 16-byte loads: D % VEC == 0
    const uint4 raw = reinterpret_cast<const uint4*>(src)[part];
    const TC* e = reinterpret_cast<const TC*>(&raw);
#pragma unroll
    for (int u = 0; u < VEC; ++u) dst[part * VEC + u] = as_q<TQ, TC>(e[u]);
  } else {
    dst[part] = as_q<TQ, TC>(src[part]);
  }
}

template <typename TQ, typename TC, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc,
                    const uint8_t* __restrict__ valid, TQ* __restrict__ out,
                    int S, int H, int KV, int D, float scale, int vec) {
  constexpr int T = Tile<DMAX>::T;
  constexpr int KS = DMAX + 1;
  constexpr int VEC = 16 / sizeof(TC);
  const int G = H / KV;
  const int PS = T + 1;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + T * KS;
  float* sq = sv + T * DMAX;
  float* sp = sq + G * DMAX;
  float* sm = sp + G * PS;            // running max per head
  float* sl = sm + G;                 // running sum per head
  float* sc = sl + G;                 // this tile's rescale per head

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* vrow = valid + (long long)b * S;

  for (int i = threadIdx.x; i < G * DMAX; i += THREADS) {
    const int g = i / DMAX, d = i % DMAX;
    sq[i] = d < D ? to_f<TQ>(q[((long long)b * H + kvh * G + g) * D + d])
                  : 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    sm[g] = NEG;
    sl[g] = 0.f;
  }
  // zero the padding columns of the tiles once (they are never loaded)
  for (int i = threadIdx.x; i < T * DMAX; i += THREADS) {
    const int t = i / DMAX, d = i % DMAX;
    if (d >= D) {
      sk[t * KS + d] = 0.f;
      sv[t * DMAX + d] = 0.f;
    }
  }

  float acc[NI];
#pragma unroll
  for (int n = 0; n < NI; ++n) acc[n] = 0.f;

  const int parts = vec ? D / VEC : D;          // loads per cache row
  const long long row_stride = (long long)KV * D;
  const TC* kbase = kc + ((long long)b * S * KV + kvh) * D;
  const TC* vbase = vc + ((long long)b * S * KV + kvh) * D;

  for (long long t0 = 0; t0 < S; t0 += T) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < T * parts; i += THREADS) {
      const int t = i / parts, part = i % parts;
      const long long pos = t0 + t;
      if (pos < S) {
        load_row_part<TQ, TC>(kbase + pos * row_stride, sk + t * KS, part, D,
                              vec);
        load_row_part<TQ, TC>(vbase + pos * row_stride, sv + t * DMAX, part,
                              D, vec);
      } else {
        const int w = vec ? VEC : 1;
        for (int u = 0; u < w; ++u) {
          sk[t * KS + part * w + u] = 0.f;
          sv[t * DMAX + part * w + u] = 0.f;
        }
      }
    }
    __syncthreads();

    // scores (g, t): f32 dot products, masked by the valid flags
    for (int i = threadIdx.x; i < G * T; i += THREADS) {
      const int g = i / T, t = i % T;
      const long long pos = t0 + t;
      float s = 0.f;
      const float* kr = sk + t * KS;
      const float* qr = sq + g * DMAX;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      sp[g * PS + t] = (pos < S && vrow[pos]) ? s * scale : NEG;
    }
    __syncthreads();

    // online softmax of the tile, one warp per head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sp[g * PS + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float p = t0 + t < S ? expf(sp[g * PS + t] - m_new) : 0.f;
        psum += p;
        sp[g * PS + t] = to_f<TQ>(from_f<TQ>(p));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + psum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // acc(g, d) = acc * corr_g + sum_t p(g, t) v(t, d)
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int i = threadIdx.x + n * THREADS;
      if (i < G * DMAX) {
        const int g = i / DMAX, d = i % DMAX;
        const float* pr = sp + g * PS;
        float a = acc[n] * sc[g];
#pragma unroll 8
        for (int t = 0; t < T; ++t) a = fmaf(pr[t], sv[t * DMAX + d], a);
        acc[n] = a;
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int g = i / DMAX, d = i % DMAX;
    if (i < G * DMAX && d < D)
      out[((long long)b * H + kvh * G + g) * D + d] =
          from_f<TQ>(acc[n] / fmaxf(sl[g], 1e-30f));
  }
}

template <typename TQ, typename TC, int DMAX>
int launch(const void* q, const void* kc, const void* vc,
           const uint8_t* valid, void* out, int B, int S, int H, int KV,
           int D, float scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G * DMAX > MAX_GD) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<DMAX>(G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TC, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int VEC = 16 / sizeof(TC);
  const int vec = (D % VEC == 0) &&
                  ((uintptr_t)kc % 16 == 0) && ((uintptr_t)vc % 16 == 0);
  flash_decode_kernel<TQ, TC, DMAX><<<B * KV, THREADS, smem, stream>>>(
      (const TQ*)q, (const TC*)kc, (const TC*)vc, valid, (TQ*)out, S, H, KV,
      D, scale, vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int dispatch(const void* q, const void* kc, const void* vc,
             const uint8_t* valid, void* out, int B, int S, int H, int KV,
             int D, float scale, cudaStream_t st) {
  if (D <= 32) return launch<TQ, TC, 32>(q, kc, vc, valid, out, B, S, H, KV, D, scale, st);
  if (D <= 64) return launch<TQ, TC, 64>(q, kc, vc, valid, out, B, S, H, KV, D, scale, st);
  if (D <= 128) return launch<TQ, TC, 128>(q, kc, vc, valid, out, B, S, H, KV, D, scale, st);
  return launch<TQ, TC, 256>(q, kc, vc, valid, out, B, S, H, KV, D, scale, st);
}

}  // namespace

// q_dtype / cache_dtype: 0 = f32, 1 = bf16 (out has q's). valid is (B,S)
// bool, one byte a slot. The caller checks shapes (D <= 256, H % KV == 0,
// (H/KV) * D within repro_flash_decode_max_gd()) and contiguity.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, const void* valid,
                                  void* out, int q_dtype, int cache_dtype,
                                  int B, int S, int H, int KV, int D,
                                  float scale, cudaStream_t stream) {
  if (B == 0) return 0;
  const uint8_t* vm = (const uint8_t*)valid;
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch<float, float>(q, kc, vc, vm, out, B, S, H, KV, D, scale, stream);
  if (q_dtype == 0)
    return dispatch<float, __nv_bfloat16>(q, kc, vc, vm, out, B, S, H, KV, D, scale, stream);
  if (cache_dtype == 0)
    return dispatch<__nv_bfloat16, float>(q, kc, vc, vm, out, B, S, H, KV, D, scale, stream);
  return dispatch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, vm, out, B, S, H, KV, D, scale, stream);
}

extern "C" int repro_flash_decode_max_gd() { return MAX_GD; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
