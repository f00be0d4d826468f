// Blocked GQA flash attention (prefill), forward only, for sm_90a.
//
// Replaces the Pallas TPU kernel flash_attention_kernel of
// src/repro/kernels/flash_attention.py:89 (the prefill attention of every
// attention layer). Plain version: repro_torch/kernels/ref.py
// flash_attention_ref. q (B,S,H,D), k/v (B,S,KV,D), f32 or bf16, in the
// reference's layout; query head h reads kv head h / G with G = H / KV.
//
// What bounds it on the H100. Operations: at the serve shape (llama3.2-1b,
// B=1, S=32768, H=32, KV=8, D=64, causal) it does 2*B*S^2*H*D = 4.4e12
// multiply-adds' worth of FLOPs on 0.5 GB of q/k/v/out, far above the
// card's ~295 FLOP/byte ridge. The least time is the tensor cores' bf16
// rate (989 TFLOP/s): 4.45 ms.
//
// What the design does about it, and what it leaves for later. One block
// owns a tile of 64 rows for one (b, kv head): the G query heads of that
// kv head are folded into the rows (row r = query r / G, head r % G), so a
// K/V tile in shared memory serves all G heads. The block walks the key
// tiles in order, keeping the running max m, sum l and the output
// accumulator in f32 registers (online softmax), and skips every key tile
// that the causal / window test rules out for all its rows. Blocks are
// issued heaviest first (the last query rows see the most keys). The
// products run on the CUDA cores in f32 from shared memory (a 4x4 score
// micro-tile and a 4 x D/16 accumulator per thread); tensor cores
// (wgmma on bf16 tiles fed by TMA) are later work, and so is making the
// f32 path use anything but f32 FMAs (no TF32).
//
// Masking and precision follow the plain version: a key counts if
// ki < S (the true length: nothing is padded), qi >= ki when causal, and
// qi - ki < window when window > 0; a masked key gets the logit -1e30, a
// key past S gets probability 0. Scores are f32 dot products times
// 1/sqrt(D) of the true D; exp is the accurate expf; p is rounded to the
// input type before the P.V product (as the plain version's p.to(dtype));
// the output is acc / max(l, 1e-30) written in the input type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;         // a 16 x 16 grid of threads
constexpr int ROWS = 64;             // folded (query, head) rows per block
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

// key tile width: keeps shared memory at or under ~143 KB for D <= 256
template <int DMAX> struct Tile { static constexpr int BK = DMAX <= 64 ? 64 : 32; };

template <int DMAX>
constexpr size_t smem_bytes() {
  // q: ROWS x (DMAX+1), k: BK x (DMAX+1), v: BK x DMAX, p: ROWS x (BK+16)
  return sizeof(float) * (ROWS * (DMAX + 1) + Tile<DMAX>::BK * (DMAX + 1) +
                          Tile<DMAX>::BK * DMAX + ROWS * (Tile<DMAX>::BK + 16));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, int D, int causal, int window, float scale) {
  constexpr int BK = Tile<DMAX>::BK;
  constexpr int NJ = BK / 16;          // score columns per thread
  constexpr int NC = DMAX / 16;        // output columns per thread
  constexpr int QS = DMAX + 1;         // padded strides: no bank conflicts
  constexpr int PS = BK + 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + ROWS * QS;
  float* sv = sk + BK * QS;
  float* sp = sv + BK * DMAX;

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long nrows = (long long)S * G;
  // heaviest row blocks (the last queries) first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * ROWS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // the block's query tile, folded: row r -> query r / G, head kvh*G + r % G
  for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    const long long row = r0 + r;
    float x = 0.f;
    if (row < nrows && d < D) {
      const long long qi = row / G;
      const int h = kvh * G + (int)(row % G);
      x = to_f<T>(q[(((long long)b * S + qi) * H + h) * D + d]);
    }
    sq[r * QS + d] = x;
  }

  const long long last = (r0 + ROWS < nrows ? r0 + ROWS : nrows) - 1;
  const long long qlo = r0 / G, qhi = last / G;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  if (causal) kend = qhi + 1 < S ? qhi + 1 : S;

  long long qrow[4];
  bool live[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = r0 + ty + 16 * i;
    live[i] = row < nrows;
    qrow[i] = live[i] ? row / G : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * DMAX; i += THREADS) {
      const int c = i / DMAX, d = i % DMAX;
      const long long ki = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (ki < kend && d < D) {
        const long long off = (((long long)b * S + ki) * KV + kvh) * D + d;
        kx = to_f<T>(k[off]);
        vx = to_f<T>(v[off]);
      }
      sk[c * QS + d] = kx;
      sv[c * DMAX + d] = vx;
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const long long ki = k0 + tx + 16 * j;
        bool ok = ki < S;
        if (causal) ok = ok && qrow[i] >= ki;
        if (window > 0) ok = ok && qrow[i] - ki < window;
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const long long ki = k0 + tx + 16 * j;
        const float p = ki < S ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sp[(ty + 16 * i) * PS + tx + 16 * j] = to_f<T>(from_f<T>(p));
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = sv[c * DMAX + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const long long row = r0 + ty + 16 * i;
    const int h = kvh * G + (int)(row % G);
    T* o = out + (((long long)b * S + qrow[i]) * H + h) * D;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) o[d] = from_f<T>(acc[i][cc] * inv_l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)S * (H / KV);
  dim3 grid((unsigned)((nrows + ROWS - 1) / ROWS), (unsigned)(B * KV));
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, KV, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int D, int causal, int window, float scale,
             cudaStream_t st) {
  if (D <= 32) return launch<T, 32>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (D <= 128) return launch<T, 128>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  return launch<T, 256>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out share it). The caller checks
// shapes (D <= 256, H % KV == 0, B * KV <= 65535) and contiguity.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int S, int H, int KV, int D,
                                     int causal, int window, float scale,
                                     cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, H, KV, D, causal, window,
                           scale, stream);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, causal,
                                 window, scale, stream);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
