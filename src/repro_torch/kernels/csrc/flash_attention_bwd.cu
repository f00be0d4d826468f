// Backward of the blocked GQA flash attention (prefill), for sm_90a.
//
// The gradient of the prefill kernel of flash_attention.cu (which replaces
// the Pallas TPU kernel flash_attention_kernel of
// src/repro/kernels/flash_attention.py:89). The TPU side has no Pallas
// backward: the reference differentiates its attention through the jnp
// custom VJP _sdpa_flash_bwd (src/repro/models/layers.py:139-188), which
// recomputes the score chunks from the forward's softmax statistics. This
// file is that VJP as kernels. Plain version: repro_torch/kernels/ref.py
// flash_attention_bwd_ref (its port, op for op).
//
// Inputs, in the reference's layout: q, dO, O (B,S,H,D), k, v (B,S,KV,D),
// all f32 or all bf16; lse (B,H,S) f32, the forward's log-sum-exp of each
// row's scaled logits (flash_attention.cu). Outputs dq (B,S,H,D), dk, dv
// (B,S,KV,D) in the input type. Three launches, none with an atomic, so
// the same inputs give the same bits:
//   1. attn_bwd_dot_kernel: Dd = rowsum(dO * O) in f32, (B,H,S), one warp a
//      row, the lanes' partial sums folded by a fixed shuffle tree;
//   2. attn_bwd_dkdv_kernel: one block per (batch, kv head, tile of BK
//      keys). It walks the folded (query, head) rows of its kv group (row
//      r = query r / G, head kvh*G + r % G, so the G query heads that read
//      this kv head are visited in a fixed order) in tiles of BQ rows,
//      from the first row the causal mask lets see the tile to the last
//      the window does, and for each tile recomputes S = Q.K^T and
//      dP = dO.V^T, then p = exp(s * scale - lse) (0 where masked) and
//      ds = p * (dp - Dd) * scale, and adds P^T.dO to dV and dS^T.Q to dK
//      in f32 registers;
//   3. attn_bwd_dq_kernel: one block per (batch, kv head, tile of BQ
//      folded rows), walking the key tiles the rows can see, recomputing
//      p and ds the same way and adding dS.K to dQ in f32 registers.
// The masks are the forward's: a key counts if ki < S (the true length:
// nothing is padded), qi >= ki when causal, qi - ki < window when window
// > 0. As in the reference, p and ds are rounded to the input type before
// they enter the products (p to dV, ds to dK and dQ); every sum is f32,
// and f32 never goes through TF32 (these are CUDA-core FMAs).
//
// What bounds it on the H100. Operations: the backward repeats the
// forward's two products and adds three (dP, dV, dK in kernel 2; S, dP and
// dQ again in kernel 3), 7 x 2 x B x S x S x H x D FLOPs over the causal
// half, against a few bytes a FLOP of q, k, v, O, dO and the outputs. At
// the training shape (llama3.2-1b, B=4, S=4096, H=32, KV=8, D=64, causal)
// that is 0.96 TFLOP, 0.97 ms at the tensor cores' bf16 rate. This first
// design stays on the CUDA cores (f32 FMAs from shared memory tiles, a 4x4
// register micro-tile per thread), far from that bound; wgmma with TMA
// is the next step (ROADMAP Queue 2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;         // a 16 x 16 grid of threads

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

// x rounded to the input type and back (the reference's p16 / ds16)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// tiles by head dim: BQ folded rows and BK keys, shared memory under 227 KB
template <int DMAX> struct Tiles {
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;
  static constexpr int BK = DMAX <= 128 ? 64 : 32;
  static constexpr int QS = DMAX + 1;          // padded: no bank conflicts
  static constexpr int PS = BK + 16;
};

template <int DMAX>
constexpr size_t dkdv_smem() {
  using Tl = Tiles<DMAX>;
  // k, v, q, dO tiles; p and ds; lse, Dd and the query index of each row
  return sizeof(float) * (2 * Tl::BK * Tl::QS + 2 * Tl::BQ * Tl::QS +
                          2 * Tl::BQ * Tl::PS + 2 * Tl::BQ) +
         sizeof(int) * Tl::BQ;
}

template <int DMAX>
constexpr size_t dq_smem() {
  using Tl = Tiles<DMAX>;
  return sizeof(float) * (2 * Tl::BK * Tl::QS + 2 * Tl::BQ * Tl::QS +
                          Tl::BQ * Tl::PS + 2 * Tl::BQ) +
         sizeof(int) * Tl::BQ;
}

// 1. Dd[b, h, qi] = sum_d dO[b, qi, h, d] * O[b, qi, h, d], in f32
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dot_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                    float* __restrict__ dd, long long rows, int S, int H,
                    int D) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;             // a whole warp leaves together
  const T* a = dout + row * D;
  const T* o = out + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f<T>(a[d]), to_f<T>(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % H, bq = row / H;   // row = (b * S + qi) * H + h
    const long long qi = bq % S, b = bq / S;
    dd[(b * H + h) * S + qi] = acc;
  }
}

// Load BQ folded rows starting at r0 (of the kv group kvh of batch b) of q
// and dO into shared memory, with each row's lse, Dd and query index (-1 for
// a row past the end). Every thread of the block takes part.
template <typename T, int DMAX>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, float* sq,
    float* sdo, float* slse, float* sdd, int* sqi, long long r0,
    long long row_end, int b, int kvh, int G, int S, int H, int D) {
  using Tl = Tiles<DMAX>;
  for (int i = threadIdx.x; i < Tl::BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    const long long row = r0 + r;
    float x = 0.f, y = 0.f;
    if (row < row_end && d < D) {
      const long long qi = row / G;
      const int h = kvh * G + (int)(row % G);
      const long long off = (((long long)b * S + qi) * H + h) * D + d;
      x = to_f<T>(q[off]);
      y = to_f<T>(dout[off]);
    }
    sq[r * Tl::QS + d] = x;
    sdo[r * Tl::QS + d] = y;
  }
  for (int r = threadIdx.x; r < Tl::BQ; r += THREADS) {
    const long long row = r0 + r;
    if (row < row_end) {
      const long long qi = row / G;
      const int h = kvh * G + (int)(row % G);
      const long long st = ((long long)b * H + h) * S + qi;
      slse[r] = lse[st];
      sdd[r] = dd[st];
      sqi[r] = (int)qi;
    } else {
      slse[r] = 0.f;
      sdd[r] = 0.f;
      sqi[r] = -1;
    }
  }
}

// Load BK keys from k0 of k and v (kv head kvh of batch b); keys past S are
// zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_keys(const T* __restrict__ k,
                                          const T* __restrict__ v, float* sk,
                                          float* sv, long long k0, int b,
                                          int kvh, int S, int KV, int D) {
  using Tl = Tiles<DMAX>;
  for (int i = threadIdx.x; i < Tl::BK * DMAX; i += THREADS) {
    const int c = i / DMAX, d = i % DMAX;
    const long long ki = k0 + c;
    float kx = 0.f, vx = 0.f;
    if (ki < S && d < D) {
      const long long off = (((long long)b * S + ki) * KV + kvh) * D + d;
      kx = to_f<T>(k[off]);
      vx = to_f<T>(v[off]);
    }
    sk[c * Tl::QS + d] = kx;
    sv[c * Tl::QS + d] = vx;
  }
}

// The tile's p and ds (rows ty + 16i, keys tx + 16j of this thread), from
// the scores S = Q.K^T and dP = dO.V^T of the tiles in shared memory; both
// rounded to the input type and stored in sp (if not null) and sds.
template <typename T, int DMAX>
__device__ __forceinline__ void probs_and_ds(
    const float* sq, const float* sdo, const float* sk, const float* sv,
    const float* slse, const float* sdd, const int* sqi, float* sp,
    float* sds, long long k0, int S, int D, int causal, int window,
    float scale) {
  using Tl = Tiles<DMAX>;
  constexpr int RI = Tl::BQ / 16, NJ = Tl::BK / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RI][NJ], dp[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], ov[RI], kv[NJ], vv[NJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = sq[(ty + 16 * i) * Tl::QS + d];
      ov[i] = sdo[(ty + 16 * i) * Tl::QS + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = sk[(tx + 16 * j) * Tl::QS + d];
      vv[j] = sv[(tx + 16 * j) * Tl::QS + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const long long qi = sqi[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      const long long ki = k0 + c;
      bool ok = qi >= 0 && ki < S;
      if (causal) ok = ok && qi >= ki;
      if (window > 0) ok = ok && qi - ki < window;
      const float p = ok ? expf(s[i][j] * scale - slse[r]) : 0.f;
      const float ds = p * (dp[i][j] - sdd[r]) * scale;
      if (sp != nullptr) sp[r * Tl::PS + c] = round_to<T>(p);
      sds[r * Tl::PS + c] = round_to<T>(ds);
    }
  }
}

// 2. dK, dV of one tile of BK keys of one (batch, kv head)
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dd, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KV, int D,
                     int causal, int window, float scale) {
  using Tl = Tiles<DMAX>;
  constexpr int KI = Tl::BK / 16, NC = DMAX / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + Tl::BK * Tl::QS;
  float* sq = sv + Tl::BK * Tl::QS;
  float* sdo = sq + Tl::BQ * Tl::QS;
  float* sp = sdo + Tl::BQ * Tl::QS;
  float* sds = sp + Tl::BQ * Tl::PS;
  float* slse = sds + Tl::BQ * Tl::PS;
  float* sdd = slse + Tl::BQ;
  int* sqi = reinterpret_cast<int*>(sdd + Tl::BQ);

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long k0 = (long long)blockIdx.x * Tl::BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_keys<T, DMAX>(k, v, sk, sv, k0, b, kvh, S, KV, D);

  // the queries that can see a key of this tile: from k0 when causal, up
  // to the tile's last key + window - 1 with a window
  const long long klast = (k0 + Tl::BK < S ? k0 + Tl::BK : S) - 1;
  long long qlo = causal ? k0 : 0, qhi = S - 1;
  if (window > 0 && klast + window - 1 < qhi) qhi = klast + window - 1;
  const long long row_end = (qhi + 1) * G;

  float adk[KI][NC], adv[KI][NC];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (long long r0 = qlo * G; r0 < row_end; r0 += Tl::BQ) {
    __syncthreads();                   // the previous rows are consumed
    load_rows<T, DMAX>(q, dout, lse, dd, sq, sdo, slse, sdd, sqi, r0,
                       row_end, b, kvh, G, S, H, D);
    __syncthreads();
    probs_and_ds<T, DMAX>(sq, sdo, sk, sv, slse, sdd, sqi, sp, sds, k0, S,
                          D, causal, window, scale);
    __syncthreads();
    // dV += P^T.dO, dK += dS^T.Q over the tile's rows, in row order
    for (int r = 0; r < Tl::BQ; ++r) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = sp[r * Tl::PS + ty + 16 * i];
        dsv[i] = sds[r * Tl::PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float ov = sdo[r * Tl::QS + tx + 16 * c];
        const float qv = sq[r * Tl::QS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          adv[i][c] = fmaf(pv[i], ov, adv[i][c]);
          adk[i][c] = fmaf(dsv[i], qv, adk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const long long ki = k0 + ty + 16 * i;
    if (ki >= S) continue;
    const long long base = (((long long)b * S + ki) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk[base + d] = from_f<T>(adk[i][c]);
        dv[base + d] = from_f<T>(adv[i][c]);
      }
    }
  }
}

// 3. dQ of one tile of BQ folded rows of one (batch, kv head)
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dd, T* __restrict__ dq, int S,
                   int H, int KV, int D, int causal, int window,
                   float scale) {
  using Tl = Tiles<DMAX>;
  constexpr int RI = Tl::BQ / 16, NC = DMAX / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + Tl::BK * Tl::QS;
  float* sq = sv + Tl::BK * Tl::QS;
  float* sdo = sq + Tl::BQ * Tl::QS;
  float* sds = sdo + Tl::BQ * Tl::QS;
  float* slse = sds + Tl::BQ * Tl::PS;
  float* sdd = slse + Tl::BQ;
  int* sqi = reinterpret_cast<int*>(sdd + Tl::BQ);

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long nrows = (long long)S * G;
  // heaviest row tiles (the last queries) first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * Tl::BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DMAX>(q, dout, lse, dd, sq, sdo, slse, sdd, sqi, r0, nrows,
                     b, kvh, G, S, H, D);

  const long long last = (r0 + Tl::BQ < nrows ? r0 + Tl::BQ : nrows) - 1;
  const long long qlo = r0 / G, qhi = last / G;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  if (causal) kend = qhi + 1 < S ? qhi + 1 : S;

  float adq[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.f;

  for (long long k0 = kbeg; k0 < kend; k0 += Tl::BK) {
    __syncthreads();                   // the previous keys are consumed
    load_keys<T, DMAX>(k, v, sk, sv, k0, b, kvh, S, KV, D);
    __syncthreads();
    probs_and_ds<T, DMAX>(sq, sdo, sk, sv, slse, sdd, sqi, nullptr, sds, k0,
                          S, D, causal, window, scale);
    __syncthreads();
    // dQ += dS.K over the tile's keys, in key order
    for (int c = 0; c < Tl::BK; ++c) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = sds[(ty + 16 * i) * Tl::PS + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float kv = sk[c * Tl::QS + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < RI; ++i) adq[i][cc] = fmaf(dsv[i], kv, adq[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long row = r0 + ty + 16 * i;
    if (row >= nrows) continue;
    const long long qi = row / G;
    const int h = kvh * G + (int)(row % G);
    T* o = dq + (((long long)b * S + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) o[d] = from_f<T>(adq[i][cc]);
    }
  }
}

template <typename T, int DMAX>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* dd, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int D,
               int causal, int window, float scale, cudaStream_t stream) {
  using Tl = Tiles<DMAX>;
  const long long rows = (long long)B * S * H;
  attn_bwd_dot_kernel<T><<<(unsigned)((rows + THREADS / 32 - 1) /
                                      (THREADS / 32)),
                           THREADS, 0, stream>>>(
      (const T*)dout, (const T*)out, dd, rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t s_kv = dkdv_smem<DMAX>(), s_q = dq_smem<DMAX>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_q);
  if (err != cudaSuccess) return (int)err;

  dim3 gkv((unsigned)((S + Tl::BK - 1) / Tl::BK), (unsigned)(B * KV));
  attn_bwd_dkdv_kernel<T, DMAX><<<gkv, THREADS, s_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
      (T*)dk, (T*)dv, S, H, KV, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long nrows = (long long)S * (H / KV);
  dim3 gq((unsigned)((nrows + Tl::BQ - 1) / Tl::BQ), (unsigned)(B * KV));
  attn_bwd_dq_kernel<T, DMAX><<<gq, THREADS, s_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
      (T*)dq, S, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* dd, void* dq, void* dk, void* dv, int B, int S,
                 int H, int KV, int D, int causal, int window, float scale,
                 cudaStream_t st) {
  if (D <= 32)
    return launch_bwd<T, 32>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                             H, KV, D, causal, window, scale, st);
  if (D <= 64)
    return launch_bwd<T, 64>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                             H, KV, D, causal, window, scale, st);
  if (D <= 128)
    return launch_bwd<T, 128>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                              H, KV, D, causal, window, scale, st);
  return launch_bwd<T, 256>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                            H, KV, D, causal, window, scale, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out, dout and the three gradients
// share it); lse and dd (B, H, S) f32, dd a scratch the first launch fills.
// The caller checks shapes (D <= 256, H % KV == 0, B * KV <= 65535) and
// contiguity. Returns the first launch error, 0 if none.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int H, int KV, int D, int causal,
    int window, float scale, cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, out, dout, (const float*)lse,
                               (float*)dd, dq, dk, dv, B, S, H, KV, D,
                               causal, window, scale, stream);
  return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse,
                                     (float*)dd, dq, dk, dv, B, S, H, KV, D,
                                     causal, window, scale, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
