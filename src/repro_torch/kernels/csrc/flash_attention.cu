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
#include "hopper.cuh"

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
  if (edge) mask_key_tile<BK>(sc, k0, S, causal, window, qrow, col0);
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
  if (wg < 2)                          // this warpgroup's 64 query rows
    load_folded_rows<DP>(sq, TC_ROWS * PANEL_ROW, q, wg, r0, nrows, b, kvh,
                         G, S, H, D);
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
