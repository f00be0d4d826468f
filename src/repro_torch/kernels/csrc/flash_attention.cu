// Blocked GQA flash attention (prefill), forward, for sm_90a (its backward:
// flash_attention_bwd.cu).
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
// Two routes, chosen by the caller from dtype and D (never by trying one):
//
// * Tensor cores (flash_fwd_wgmma_kernel): bf16 with D % 16 == 0, D <= 256.
//   One CTA owns 128 folded (query, head) rows of one (b, kv head) (row r
//   = query r / G, head kvh*G + r % G, so any G works and a K/V tile serves
//   all G heads) and runs three warp roles: two consumer warpgroups of 64
//   rows each and one producer warp. Q is loaded once into shared memory
//   in bf16, in the 128-byte-swizzled layout wgmma reads (plain 16-byte
//   loads: folded rows are no TMA box when G does not divide 64). The
//   producer streams K and V tiles (BK keys x D) by TMA, through a 4-D
//   tensor map over (B, S, KV, D) with 64-column boxes, into a ring of
//   2-3 stages guarded by a full/empty mbarrier pair per stage; rows past
//   S and columns past D arrive zero-filled. Each consumer computes
//   S = Q.K^T with wgmma (A and B from shared memory, K K-major), runs the
//   online softmax in the f32 accumulator registers (row max and sum by
//   quad shuffles), rounds P to bf16 in registers and issues O += P.V as
//   the register-A wgmma with V read MN-major from shared memory. O stays
//   in f32 registers until the end. The two warpgroups take turns on the
//   tensor cores (named barriers): one issues P_t.V_t and S_{t+1} together
//   while the other runs its softmax, so the exp work of one hides the
//   products of the other. Key tiles that the causal / window test rules
//   out for all 128 rows are never loaded; the per-element mask runs only
//   on the tiles that straddle a boundary; the heaviest row blocks are
//   issued first.
// * CUDA cores (flash_fwd_kernel): every other shape, and f32 (whose 2e-3
//   limit against the plain version forbids TF32). One block owns 64
//   folded rows; both products are f32 FMAs from shared memory (a 4x4
//   score micro-tile and a 4 x D/16 accumulator per thread).
//
// Masking and precision follow the plain version on both routes: a key
// counts if ki < S (the true length: nothing is padded), qi >= ki when
// causal, and qi - ki < window when window > 0; a masked key gets the
// logit -1e30 on the CUDA-core route and -inf on the tensor-core route
// (the same weights: every row sees its own key, so by its last tile a
// -1e30 logit's probability is exactly 0 too), a key past S probability
// 0. Scores are f32 dot products times 1/sqrt(D) of the true D; exp is
// the accurate expf; p is rounded to the input type before the P.V
// product (as the plain version's p.to(dtype)); the output is
// acc / max(l, 1e-30) written in the input type.
//
// Softmax statistics, for the backward (flash_attention_bwd.cu). Given a
// non-null lse (B, H, S) f32, both routes also write each row's
// log-sum-exp of its scaled logits, lse = m + log(max(l, 1e-30)), with m
// the row max of s * scale (the reference's m of layers.py:129, in the
// same units on both routes: the CUDA-core route keeps m of scores it has
// already scaled, the tensor-core route the raw max times the positive
// scale, which is the same float) and l the row's sum of exp(s * scale -
// m). The backward recomputes p = exp(s * scale - lse). A null lse skips
// the store: the serving path's work and bits are unchanged.
#include <cuda.h>            // CUtensorMap (the encoder comes via the runtime)
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
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int KV, int D,
                 int causal, int window, float scale) {
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
    // the 16 threads of the row hold the same m and l
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + qrow[i]] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int KV, int D, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)S * (H / KV);
  dim3 grid((unsigned)((nrows + ROWS - 1) / ROWS), (unsigned)(B * KV));
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, S, H, KV, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int H, int KV, int D, int causal,
             int window, float scale, cudaStream_t st) {
  if (D <= 32) return launch<T, 32>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, st);
  if (D <= 64) return launch<T, 64>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, st);
  if (D <= 128) return launch<T, 128>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, st);
  return launch<T, 256>(q, k, v, out, lse, B, S, H, KV, D, causal, window, scale, st);
}


// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D % 16 == 0, D <= 256.
// ---------------------------------------------------------------------------
constexpr int TC_ROWS = 128;         // folded rows per CTA: 2 warpgroups x 64
constexpr int TC_CONSUMERS = 256;    // the two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // + one producer warp
constexpr int PANEL_ROW = 128;       // bytes of one 64-column bf16 panel row
constexpr float NEG_INF = -__builtin_huge_valf();

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
               "\n}\n" :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of the given parity has completed; a wait that
// never ends (a fault in the pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one box of the 4-D tensor map (D, KV, S, B) into shared memory; the
// mbarrier counts its bytes when they land
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// named barriers 1, 2 (0 is __syncthreads): sync waits, arrive does not
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One wrapper per wgmma shape the kernel issues. The accumulator fragment
// of m64nN (per warp w of the warpgroup, lane l): d[4j + c] holds row
// 16w + l/4 + 8*(c/2), column 8j + 2*(l%4) + c%2.
// S (64 x 64) {+}= A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// S (64 x 128) {+}= A (64 x 16, smem) . B (128 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 192) += A (64 x 16, registers) . B (16 x 192, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 256) += A (64 x 16, registers) . B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <int BK> struct ScoreMma;
template <> struct ScoreMma<64> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n64(d, a, b, acc);
  }
};
template <> struct ScoreMma<128> {
  __device__ static void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    wgmma_ss_n128(d, a, b, acc);
  }
};
template <int DP> struct OutMma;
template <> struct OutMma<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t b) { wgmma_rs_n64(d, a, b); }
};
template <> struct OutMma<128> {
  __device__ static void run(float (&d)[64], const uint32_t (&a)[4],
                             uint64_t b) { wgmma_rs_n128(d, a, b); }
};
template <> struct OutMma<192> {
  __device__ static void run(float (&d)[96], const uint32_t (&a)[4],
                             uint64_t b) { wgmma_rs_n192(d, a, b); }
};
template <> struct OutMma<256> {
  __device__ static void run(float (&d)[128], const uint32_t (&a)[4],
                             uint64_t b) { wgmma_rs_n256(d, a, b); }
};

// S = Q . K^T of one key tile into sc (the first k16 step overwrites sc):
// Q's 64 rows of this warpgroup at q_base, the K tile at k_base, both
// K-major in 64-column panels
template <int DP, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t q_base,
                                             uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = desc_sw128(
        q_base + (kk / 4) * (TC_ROWS * PANEL_ROW) + (kk % 4) * 32, 16, 1024);
    const uint64_t db = desc_sw128(
        k_base + (kk / 4) * (BK * PANEL_ROW) + (kk % 4) * 32, 16, 1024);
    ScoreMma<BK>::run(sc, da, db, kk > 0);
  }
}

// O += P . V of one key tile: V (BK keys x DP) at v_base is read MN-major,
// 8-key groups 1024 bytes apart, 64-column panels BK * 128 bytes apart
template <int DP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    OutMma<DP>::run(o, pa[kk], desc_sw128(v_base + kk * 16 * PANEL_ROW,
                                          BK * PANEL_ROW, 1024));
}

// One tile's online softmax, in the score registers: mask (on a tile that
// straddles a boundary), row max and sum, the rescale of O, P in bf16.
template <int DP, int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], float (&o)[DP / 2], uint32_t (&pa)[BK / 16][4],
    float (&m)[2], float (&l)[2], long long k0, int S, int causal,
    int window, const long long (&qrow)[2], long long wq_lo,
    long long wq_hi, int col0, float scale) {
  // mask: a tile that straddles a boundary for some row of the
  // warpgroup (past S, the diagonal, the window's edge) is masked per
  // element: key offset u (0..BK-1) counts for row h if lo[h] <= u <=
  // hi[h]. A masked key gets -inf: its p is exactly 0, as the -1e30
  // logit's is once the row has a valid key, and every row has one (its
  // own) by its last tile; a row with none so far keeps l = 0, acc = 0.
  const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wq_lo) ||
                    (window > 0 && k0 <= wq_hi - window);
  if (edge) {
    int lo[2], hi[2];                // relative to this thread's column
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long long top = S - 1 - k0;
      if (causal && qrow[h] - k0 < top) top = qrow[h] - k0;
      long long bot = window > 0 ? qrow[h] - window + 1 - k0 : 0;
      top = top < -1 ? -1 : (top > BK ? BK : top);
      bot = bot < 0 ? 0 : (bot > BK ? BK : bot);
      hi[h] = (int)top - col0;
      lo[h] = (int)bot - col0;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = 8 * j + (c & 1), h = c >> 1;
        if (u < lo[h] || u > hi[h]) sc[4 * j + c] = NEG_INF;
      }
  }
  // online softmax; the row max of the raw scores times the (positive)
  // scale is the max of the scaled ones, and exp takes s * scale - m in
  // one fused multiply-add
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      mx[c >> 1] = fmaxf(mx[c >> 1], sc[4 * j + c]);
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale);
    corr[h] = expf(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = expf(fmaf(sc[4 * j + c], scale, -m[c >> 1]));
      l[c >> 1] += p;
      sc[4 * j + c] = p;
    }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
  // P in bf16: the score fragment of keys 16kk..16kk+15 is the A fragment
  // of the kk-th k16 step of P.V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      pa[kk][u] = pack_bf16(sc[8 * kk + 2 * u], sc[8 * kk + 2 * u + 1]);
}

// DP: D rounded up to a multiple of 64 (the panels of 64 bf16 columns, one
// 128-byte swizzle row each); BK: keys per tile; STAGES: K/V ring depth.
template <int DP, int BK, int STAGES>
struct TcShape {
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_BYTES = PANELS * TC_ROWS * PANEL_ROW;
  static constexpr int KV_PANEL = BK * PANEL_ROW;    // one panel of a tile
  static constexpr int TILE_BYTES = PANELS * KV_PANEL;
  // 1024 for aligning the base (the swizzle atom), Q, the K and V rings,
  // the full and empty barriers
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * TILE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

template <int DP, int BK, int STAGES>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int KV,
                       int D, int causal, int window, float scale) {
  using Sh = TcShape<DP, BK, STAGES>;
  constexpr int NS = BK / 2;           // score registers per thread
  constexpr int NO = DP / 2;           // output registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* sk = sq + Sh::Q_BYTES;
  uint8_t* sv = sk + STAGES * Sh::TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * Sh::TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long nrows = (long long)S * G;
  // heaviest row blocks (the last queries) first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const long long last = (r0 + TC_ROWS < nrows ? r0 + TC_ROWS : nrows) - 1;
  const long long qlo = r0 / G, qhi = last / G;
  long long kbeg = 0, kend = S;
  if (window > 0) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  if (causal) kend = qhi + 1 < S ? qhi + 1 : S;
  const int ntiles = (int)((kend - kbeg + BK - 1) / BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (wg < 2) {
    // this warpgroup's 64 query rows, folded, swizzled: 16-byte chunk j of
    // row rr sits at chunk (j % 8) ^ (rr % 8) of its panel row
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x % 128; i < 64 * CH; i += 128) {
      const int r = i / CH, j = i % CH;
      const int rr = wg * 64 + r;
      const long long row = r0 + rr;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows && j * 8 < D) {
        const long long qi = row / G;
        const int h = kvh * G + (int)(row % G);
        x = *reinterpret_cast<const uint4*>(
            q + (((long long)b * S + qi) * H + h) * D + j * 8);
      }
      *reinterpret_cast<uint4*>(sq + (j / 8) * (TC_ROWS * PANEL_ROW) +
                                rr * PANEL_ROW +
                                (((j % 8) ^ (rr & 7)) << 4)) = x;
    }
  }
  // the generic-proxy writes of Q must be visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the K/V ring full
    if (threadIdx.x == TC_CONSUMERS) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * Sh::TILE_BYTES);
        const int k0 = (int)(kbeg + (long long)t * BK);
#pragma unroll
        for (int p = 0; p < Sh::PANELS; ++p) {
          tma_load_4d(sk + s * Sh::TILE_BYTES + p * Sh::KV_PANEL, &tmap_k,
                      &full[s], 64 * p, kvh, k0, b);
          tma_load_4d(sv + s * Sh::TILE_BYTES + p * Sh::KV_PANEL, &tmap_v,
                      &full[s], 64 * p, kvh, k0, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the CTA
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rl = wg * 64 + warp * 16 + lane / 4;   // this thread's rows:
  long long row[2], qrow[2];                       // rl and rl + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + rl + 8 * h;
    qrow[h] = row[h] / G;
  }
  const long long wrow0 = r0 + wg * 64;
  const long long wlast = (wrow0 + 64 < nrows ? wrow0 + 64 : nrows) - 1;
  const long long wq_lo = wrow0 / G, wq_hi = (wlast > wrow0 ? wlast : wrow0) / G;
  const int col0 = 2 * (lane % 4);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // m: running max of the scaled scores; l: this thread's columns' sum
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float sc[NS];                        // S of the tile in hand, then its P
  uint32_t pa[BK / 16][4];             // P in bf16, the A operand of P.V
  const uint32_t q_base = smem_u32(sq) + wg * 64 * PANEL_ROW;

  // The two warpgroups take turns on the tensor cores: warpgroup w issues
  // its products after named barrier 1 + w and then opens 2 - w for the
  // other, so one warpgroup's softmax runs while the other's products do.
  // Each issues ntiles + 1 blocks of products: S_0; then (P_t.V_t,
  // S_{t+1}); then P_last.V_last. Warpgroup 1 opens the first turn and
  // skips the pass after its last block (nobody waits for it).
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  // (ntiles >= 1: every row sees at least its own key)
  if (wg == 1) named_bar_arrive(1, TC_CONSUMERS);
  mbar_wait(&full[0], 0);
  named_bar_sync(my_turn, TC_CONSUMERS);
  wgmma_fence();
  issue_scores<DP, BK>(sc, q_base, smem_u32(sk));
  wgmma_commit();
  named_bar_arrive(other_turn, TC_CONSUMERS);
  wgmma_wait_all();
  fence_regs(sc);
  // the products are issued outside any branch (a wgmma in a divergent
  // path is serialized), so the last tile is peeled off the loop
  for (int t = 0; t + 1 < ntiles; ++t) {
    softmax_tile<DP, BK>(sc, o, pa, m, l, kbeg + (long long)t * BK, S,
                         causal, window, qrow, wq_lo, wq_hi, col0, scale);
    mbar_wait(&full[(t + 1) % STAGES], ((t + 1) / STAGES) & 1);
    named_bar_sync(my_turn, TC_CONSUMERS);
    wgmma_fence();
    issue_pv<DP, BK>(o, pa, smem_u32(sv + (t % STAGES) * Sh::TILE_BYTES));
    issue_scores<DP, BK>(sc, q_base,
                         smem_u32(sk + ((t + 1) % STAGES) * Sh::TILE_BYTES));
    wgmma_commit();
    named_bar_arrive(other_turn, TC_CONSUMERS);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(sc);
    mbar_arrive(&empty[t % STAGES]);   // this thread is done with tile t
  }
  {
    const int t = ntiles - 1;
    softmax_tile<DP, BK>(sc, o, pa, m, l, kbeg + (long long)t * BK, S,
                         causal, window, qrow, wq_lo, wq_hi, col0, scale);
    named_bar_sync(my_turn, TC_CONSUMERS);
    wgmma_fence();
    issue_pv<DP, BK>(o, pa, smem_u32(sv + (t % STAGES) * Sh::TILE_BYTES));
    wgmma_commit();
    if (wg == 0) named_bar_arrive(other_turn, TC_CONSUMERS);
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[t % STAGES]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] >= nrows) continue;
    const int head = kvh * G + (int)(row[h] % G);
    __nv_bfloat16* dst = out + (((long long)b * S + qrow[h]) * H + head) * D;
    const float inv_l = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * h] * inv_l, o[4 * j + 2 * h + 1] * inv_l);
    }
    // the quad of the row holds the same m and, after the shuffles, l
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + head) * S + qrow[h]] =
          m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (nothing new to link)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODER = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_TENSOR_MAP = -2;   // it refused the tensor map

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (B, S, KV, D) bf16 as a 4-D tensor map; a box is 64 columns of one kv
// head for BK consecutive positions, 128-byte swizzled, zero-filled past
// the tensor's edges
int kv_tensor_map(CUtensorMap* map, const void* base, int B, int S, int KV,
                  int D, int BK) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)KV * D * 2,
                                 (cuuint64_t)S * KV * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int DP, int BK, int STAGES>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int H, int KV, int D, int causal,
              int window, float scale, cudaStream_t stream) {
  using Sh = TcShape<DP, BK, STAGES>;
  CUtensorMap mk, mv;
  int rc = kv_tensor_map(&mk, k, B, S, KV, D, BK);
  if (rc == 0) rc = kv_tensor_map(&mv, v, B, S, KV, D, BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP, BK, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long nrows = (long long)S * (H / KV);
  dim3 grid((unsigned)((nrows + TC_ROWS - 1) / TC_ROWS), (unsigned)(B * KV));
  flash_fwd_wgmma_kernel<DP, BK, STAGES><<<grid, TC_THREADS, Sh::SMEM,
                                           stream>>>(
      mk, mv, (const __nv_bfloat16*)q, (__nv_bfloat16*)out, lse, S, H, KV,
      D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and out share it). The CUDA-core route,
// for every shape; the caller checks shapes (D <= 256, H % KV == 0,
// B * KV <= 65535) and contiguity. lse: (B, H, S) f32 statistics, or null.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int dtype, int B, int S, int H, int KV,
                                     int D, int causal, int window,
                                     float scale, cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, (float*)lse, B, S, H, KV, D,
                           causal, window, scale, stream);
  return dispatch<__nv_bfloat16>(q, k, v, out, (float*)lse, B, S, H, KV, D,
                                 causal, window, scale, stream);
}

// The tensor-core route: bf16 only, D % 16 == 0, D <= 256, every pointer
// 16-byte aligned (the caller checks; repro_torch/kernels/flash_attention.py
// prefill_route picks the route).
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int B, int S, int H, int KV, int D,
                                        int causal, int window, float scale,
                                        cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (D % 16 != 0 || D <= 0 || D > 256) return (int)cudaErrorInvalidValue;
  float* st = (float*)lse;
  if (D <= 64)
    return launch_tc<64, 128, 3>(q, k, v, out, st, B, S, H, KV, D, causal,
                                 window, scale, stream);
  if (D <= 128)
    return launch_tc<128, 128, 2>(q, k, v, out, st, B, S, H, KV, D, causal,
                                  window, scale, stream);
  if (D <= 192)
    return launch_tc<192, 64, 2>(q, k, v, out, st, B, S, H, KV, D, causal,
                                 window, scale, stream);
  return launch_tc<256, 64, 2>(q, k, v, out, st, B, S, H, KV, D, causal,
                               window, scale, stream);
}

extern "C" const char* repro_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused the K/V tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
