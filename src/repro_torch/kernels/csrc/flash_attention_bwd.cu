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
// Inputs, in the reference's layout: q, dO, O (B,S,H,D), k, v
// (B,Sk,KV,D), all f32 or all bf16; lse (B,H,S) f32, the forward's
// log-sum-exp of each row's scaled logits (flash_attention.cu). Outputs dq
// (B,S,H,D), dk, dv (B,Sk,KV,D) in the input type. Sk is S for
// self-attention; whisper's cross-attention has S decoder queries over Sk
// = 1500 encoder keys (non-causal, no window: the caller refuses a mask
// with Sk != S), and its gradient runs the same kernels with the key
// grids, tensor maps and key bounds over Sk. Three launches on either route, none with
// an atomic, so the same inputs give the same bits (the CUDA-core route's
// kernels are named here; the tensor-core route's 2 and 3 are below):
//   1. attn_bwd_dot_kernel (both routes): Dd = rowsum(dO * O) in f32,
//      (B,H,S), one warp a row, the lanes' partial sums folded by a fixed
//      shuffle tree;
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
// The masks are the forward's: a key counts if ki < Sk (the true length:
// nothing is padded), qi >= ki when causal, qi - ki < window when window
// > 0. As in the reference, p and ds are rounded to the input type before
// they enter the products (p to dV, ds to dK and dQ); every sum is f32,
// and f32 never goes through TF32 (f32 takes the CUDA-core FMAs).
//
// Two routes, chosen by the caller from the inputs (repro_torch/kernels/
// flash_attention.py bwd_route: dtype, head dim, group size, alignment),
// never by trying one and falling back:
//
// * CUDA cores (repro_flash_attention_bwd: attn_bwd_dkdv_kernel,
//   attn_bwd_dq_kernel): f32 (its 2e-3 limit against the plain version
//   rules TF32 out), and bf16 with D not a multiple of 16 or D > 128.
//   f32 FMAs from shared-memory tiles, a 4x4 register micro-tile per
//   thread.
// * Tensor cores (repro_flash_attention_bwd_tc: attn_bwd_dkdv_wgmma_kernel,
//   attn_bwd_dq_wgmma_kernel): bf16, D % 16 == 0, D <= 128, G <= 64,
//   16-byte aligned data. Both are warp-specialised: two consumer
//   warpgroups of 64 (keys or rows) each and one producer warpgroup that
//   keeps TMA loads in flight through a ring of full/empty mbarriers and
//   gives its registers to the consumers (setmaxnreg 40 / 232: at 24 the
//   producer's own loop spilled).
//   - dK/dV: one CTA per (batch, kv head, 128 keys). K and V arrive once
//     by TMA and stay resident. The producer streams tiles of Q and dO
//     rows through the ring: one 4-D box {64 columns, G heads, 64/G
//     queries, 1} of the (B, S, H, D) tensor gives the folded rows of
//     64/G whole queries in folded order (row = query * G + head); when G
//     does not divide 64 (qwen2's G = 7) the box takes floor(64/G)
//     queries and the tile's spare rows stay zero, so one code path
//     serves every G. It writes each row's lse and Dd beside the tile
//     (+inf and 0 for a spare row or a row past S: their p is exactly 0
//     with no mask). Each warpgroup, over the row tiles that can see its
//     64 keys in a fixed order, takes S^T = K.Q^T and dP^T = V.dO^T by
//     wgmma (both operands in shared memory), P^T = exp(S^T * scale -
//     lse) and dS^T = P^T (dP^T - Dd) scale in the accumulator registers,
//     rounds both to bf16 there (the reference's rounding points) and
//     issues dV += P^T.dO and dK += dS^T.Q as register-A wgmma, with dO
//     and Q read MN-major from the same swizzled tiles, then the next
//     tile's S^T and dP^T, in one turn of the two warpgroups' named-
//     barrier ping-pong (both walk all of the CTA's row tiles, masking
//     whole the few that one's keys cannot see). dK and dV stay in f32
//     registers and are written once.
//   - dQ: one CTA per 128 folded rows, the forward's shape: Q, dO (16-byte
//     loads into the swizzled layout), lse and Dd resident, the heaviest
//     row tiles first; K and V tiles stream by TMA. Per key tile S =
//     Q.K^T and dP = dO.V^T by wgmma, dS in registers (bf16), then dQ +=
//     dS.K by register-A wgmma with K read MN-major, then the next tile's
//     S and dP in the same turn; the two warpgroups take turns on the
//     tensor cores (the forward's named-barrier ping-pong), so one's exp
//     work runs while the other's products do. S and dP are thus
//     computed twice (once per kernel): the price of a dQ with no atomic
//     (an atomic sum changes its bits from run to run) and no partial-dQ
//     buffer per key tile (4.3 GB at the training shape below).
//   Key and row tiles that the causal or window test rules out for a
//   whole CTA are never loaded; the per-element mask (one interval of
//   rows or keys per accumulator row, computed once a tile) runs only on
//   tiles that straddle a boundary (a mask evaluated element by element
//   in 64-bit made dQ markedly slower). Keys
//   past Sk are masked in dQ (TMA zero-fills them, and a zero key still
//   has p = exp(-lse) != 0); in dK/dV they touch only their own rows,
//   which are never written (the stores stop at Sk). Without a mask
//   every key tile sees every row tile, so each dK/dV CTA walks all of
//   S's row tiles whatever Sk is. Every wgmma is issued outside any
//   branch.
//
// What bounds it on the H100. At the training shape (llama3.2-1b, B=4,
// S=4096, H=32, KV=8, D=64, causal) one product over the causal pairs is
// 2 B H D S(S+1)/2 = 1.375e11 FLOP. The least work is five products (S,
// dP, dV, dK, dQ): 0.695 ms at the tensor cores' bf16 rate (989
// TFLOP/s), above the bytes (q, k, v, out, dout, lse read once, the
// gradients written once). The tensor-core route computes seven (S and dP
// again for dQ): 0.973 ms. On the CUDA cores (67 TFLOP/s f32) the seven
// are at least 14.4 ms, which no CUDA-core design gets under; that route
// stays for f32 and the shapes above. What the tensor-core design does
// about the CUDA-core route's three costs: every product is a wgmma on
// bf16 tiles (not f32 FMAs); tiles arrive by TMA into a ring that the
// producer keeps full while the consumers compute (not scalar loads
// between __syncthreads); S and dP are still computed twice, as above.
#include "hopper.cuh"

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

// Load BK keys from k0 of k and v (kv head kvh of batch b); keys past Sk
// are zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_keys(const T* __restrict__ k,
                                          const T* __restrict__ v, float* sk,
                                          float* sv, long long k0, int b,
                                          int kvh, int Sk, int KV, int D) {
  using Tl = Tiles<DMAX>;
  for (int i = threadIdx.x; i < Tl::BK * DMAX; i += THREADS) {
    const int c = i / DMAX, d = i % DMAX;
    const long long ki = k0 + c;
    float kx = 0.f, vx = 0.f;
    if (ki < Sk && d < D) {
      const long long off = (((long long)b * Sk + ki) * KV + kvh) * D + d;
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
    float* sds, long long k0, int Sk, int D, int causal, int window,
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
      bool ok = qi >= 0 && ki < Sk;
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
                     T* __restrict__ dv, int S, int Sk, int H, int KV, int D,
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

  load_keys<T, DMAX>(k, v, sk, sv, k0, b, kvh, Sk, KV, D);

  // the queries that can see a key of this tile: from k0 when causal, up
  // to the tile's last key + window - 1 with a window (both only at Sk =
  // S), every query of S without a mask
  const long long klast = (k0 + Tl::BK < Sk ? k0 + Tl::BK : Sk) - 1;
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
    probs_and_ds<T, DMAX>(sq, sdo, sk, sv, slse, sdd, sqi, sp, sds, k0, Sk,
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
    if (ki >= Sk) continue;
    const long long base = (((long long)b * Sk + ki) * KV + kvh) * D;
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
                   int Sk, int H, int KV, int D, int causal, int window,
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
  long long kbeg = 0, kend = Sk;
  if (window > 0) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  if (causal) kend = qhi + 1 < Sk ? qhi + 1 : Sk;

  float adq[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.f;

  for (long long k0 = kbeg; k0 < kend; k0 += Tl::BK) {
    __syncthreads();                   // the previous keys are consumed
    load_keys<T, DMAX>(k, v, sk, sv, k0, b, kvh, Sk, KV, D);
    __syncthreads();
    probs_and_ds<T, DMAX>(sq, sdo, sk, sv, slse, sdd, sqi, nullptr, sds, k0,
                          Sk, D, causal, window, scale);
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
               void* dk, void* dv, int B, int S, int Sk, int H, int KV,
               int D, int causal, int window, float scale,
               cudaStream_t stream) {
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

  dim3 gkv((unsigned)((Sk + Tl::BK - 1) / Tl::BK), (unsigned)(B * KV));
  attn_bwd_dkdv_kernel<T, DMAX><<<gkv, THREADS, s_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
      (T*)dk, (T*)dv, S, Sk, H, KV, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long nrows = (long long)S * (H / KV);
  dim3 gq((unsigned)((nrows + Tl::BQ - 1) / Tl::BQ), (unsigned)(B * KV));
  attn_bwd_dq_kernel<T, DMAX><<<gq, THREADS, s_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd,
      (T*)dq, S, Sk, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 float* dd, void* dq, void* dk, void* dv, int B, int S,
                 int Sk, int H, int KV, int D, int causal, int window,
                 float scale, cudaStream_t st) {
  if (D <= 32)
    return launch_bwd<T, 32>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                             Sk, H, KV, D, causal, window, scale, st);
  if (D <= 64)
    return launch_bwd<T, 64>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                             Sk, H, KV, D, causal, window, scale, st);
  if (D <= 128)
    return launch_bwd<T, 128>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                              Sk, H, KV, D, causal, window, scale, st);
  return launch_bwd<T, 256>(q, k, v, out, dout, lse, dd, dq, dk, dv, B, S,
                            Sk, H, KV, D, causal, window, scale, st);
}


// ---------------------------------------------------------------------------
// The tensor-core route: bf16, D % 16 == 0, D <= 128, G <= 64.
// ---------------------------------------------------------------------------
constexpr int TC_KEYS = 128;         // dK/dV CTA: 2 warpgroups x 64 keys
constexpr int TC_ROWS = 128;         // dQ CTA: 2 warpgroups x 64 folded rows
constexpr int TC_TILE = 64;          // rows of a dK/dV CTA's Q/dO tile
constexpr int TC_CONSUMERS = 256;    // the two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // + the producer warpgroup
constexpr float POS_INF = __builtin_huge_valf();

// the producer warpgroup gives registers to the consumers (40 x 128 +
// 232 x 256 of the SM's 65,536)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// acc (64 x N) = A (64 x DP) . B (N x DP)^T, both K-major in shared memory
// in 64-column panels (A's panels a_panel bytes apart, B's b_panel); the
// first k16 step overwrites acc
template <int DP, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_base,
                                         uint32_t a_panel, uint32_t b_base,
                                         uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ScoreMma<N>::run(
        acc, desc_sw128(a_base + (kk / 4) * a_panel + (kk % 4) * 32, 16, 1024),
        desc_sw128(b_base + (kk / 4) * b_panel + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// acc (64 x DP) += A (64 x K, registers) . B (K x DP, shared memory,
// MN-major: K rows of 64-column panels b_panel bytes apart, 8-row groups
// 1024 bytes apart)
template <int DP, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[DP / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b_base, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    OutMma<DP>::run(acc, a[kk],
                    desc_sw128(b_base + kk * 16 * PANEL_ROW, b_panel, 1024));
}

// the accumulator fragment (f32, 64 x 16*NK) as NK bf16 A fragments of
// a register-A wgmma (k16 step kk holds columns 16kk..16kk+15)
template <int NK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NK][4],
                                       const float (&x)[NK * 8]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[kk][u] = pack_bf16(x[8 * kk + 2 * u], x[8 * kk + 2 * u + 1]);
}

// P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - Dd) scale of one row
// tile in the accumulator registers, then both in bf16 as the A fragments
// of dV += P^T.dO and dK += dS^T.Q. On a tile that straddles the diagonal
// or the window's edge (edge), a masked score is first set to -inf, so its
// p is exactly 0: key ki sees queries ki .. ki + window - 1, which are the
// tile rows (ki - tq0) G .. (ki + window - tq0) G - 1 (row r holds query
// tq0 + r / G), one interval of rows a key.
__device__ __forceinline__ void dkdv_probs(
    float (&st)[32], float (&dpt)[32], uint32_t (&pa)[4][4],
    uint32_t (&da)[4][4], const float* tl, const float* td, bool edge,
    int krow, int col0, int tq0, int G, int causal, int window,
    float scale) {
  if (edge) {
    int lo[2], hi[2];                  // rows [lo, hi), less this thread's col0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long ki = krow + 8 * h;
      long long a = causal ? (ki - tq0) * G : 0;
      long long e = window > 0 ? (ki + window - tq0) * G : TC_TILE;
      a = a < 0 ? 0 : (a > TC_TILE ? TC_TILE : a);
      e = e < 0 ? 0 : (e > TC_TILE ? TC_TILE : e);
      lo[h] = (int)a - col0;
      hi[h] = (int)e - col0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = 8 * j + (c & 1), h = c >> 1;
        if (u < lo[h] || u >= hi[h]) st[4 * j + c] = NEG_INF;
      }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // this thread's two columns of the group, in one 8-byte load each
    const float2 l2 = *reinterpret_cast<const float2*>(tl + 8 * j + col0);
    const float2 d2 = *reinterpret_cast<const float2*>(td + 8 * j + col0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float l = (c & 1) ? l2.y : l2.x, d = (c & 1) ? d2.y : d2.x;
      const float p = expf(fmaf(st[4 * j + c], scale, -l));
      dpt[4 * j + c] = p * (dpt[4 * j + c] - d) * scale;
      st[4 * j + c] = p;
    }
  }
  pack_a<4>(pa, st);
  pack_a<4>(da, dpt);
}

// DP: D rounded up to a multiple of 64 (64-column panels of 128 bytes a
// row); STAGES: depth of the Q/dO ring
template <int DP, int STAGES>
struct DkdvShape {
  static constexpr int PANELS = DP / 64;
  static constexpr int KV_PANEL = TC_KEYS * PANEL_ROW;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;       // K or V, resident
  static constexpr int ROW_PANEL = TC_TILE * PANEL_ROW;
  static constexpr int ROW_BYTES = PANELS * ROW_PANEL;     // a Q or dO tile
  // 1024 for aligning the base (the swizzle atom), K, V, the Q and dO
  // rings, each stage's lse and Dd, then the full and empty barriers and
  // K/V's
  static constexpr size_t SMEM =
      1024 + 2 * KV_BYTES + 2 * STAGES * ROW_BYTES +
      2 * STAGES * TC_TILE * sizeof(float) +
      (2 * STAGES + 1) * sizeof(uint64_t);
};

// dK, dV of 128 keys of one (batch, kv head): blockIdx.x the key tile
// (the heaviest, under a causal mask, first), blockIdx.y = b * KV + kvh
template <int DP, int STAGES>
__global__ void __launch_bounds__(TC_THREADS, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_do,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const float* __restrict__ lse,
                           const float* __restrict__ dd,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int Sk,
                           int H, int KV, int D, int causal, int window,
                           float scale) {
  using Sh = DkdvShape<DP, STAGES>;
  constexpr int NO = DP / 2;           // dK (or dV) registers per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = smem;
  uint8_t* sv = sk + Sh::KV_BYTES;
  uint8_t* sq = sv + Sh::KV_BYTES;
  uint8_t* sdo = sq + STAGES * Sh::ROW_BYTES;
  float* slse = reinterpret_cast<float*>(sdo + STAGES * Sh::ROW_BYTES);
  float* sdd = slse + STAGES * TC_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdd + STAGES * TC_TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int G = H / KV;
  const int QT = TC_TILE / G;          // whole queries a row tile
  const int R = QT * G;                // its rows; R..63 are spare (zero)
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int k0 = blockIdx.x * TC_KEYS;
  const int ntq = (S + QT - 1) / QT;
  const int wg = threadIdx.x / 128;

  // the row tiles that can see a key of the CTA: from the first query the
  // causal mask lets see k0 to the last the window lets see its last key
  // (both only at Sk = S); every row tile of S without a mask
  const int k_last = (k0 + TC_KEYS < Sk ? k0 + TC_KEYS : Sk) - 1;
  const int t_lo = causal ? k0 / QT : 0;
  int t_hi = ntq - 1;
  if (window > 0 && (long long)k_last + window - 1 < S - 1)
    t_hi = (int)(((long long)k_last + window - 1) / QT);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);         // the producer warp's lanes
      mbar_init(&empty[s], TC_CONSUMERS);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the spare rows of every Q/dO stage are zero for good (TMA writes rows
  // 0..R-1 only)
  for (int i = threadIdx.x; i < 2 * STAGES * Sh::PANELS * (TC_TILE - R) * 8;
       i += TC_THREADS) {
    const int chunk = i % ((TC_TILE - R) * 8), panel = i / ((TC_TILE - R) * 8);
    *reinterpret_cast<uint4*>(sq + panel * Sh::ROW_PANEL + R * PANEL_ROW +
                              chunk * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the generic-proxy zeros must be visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    if (threadIdx.x / 32 == 8) {
      // warp 8: K and V once, then the row tiles t_lo..t_hi in order
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * Sh::KV_BYTES);
#pragma unroll
        for (int p = 0; p < Sh::PANELS; ++p) {
          tma_load_4d(sk + p * Sh::KV_PANEL, &tmap_k, kv_full, 64 * p, kvh,
                      k0, b);
          tma_load_4d(sv + p * Sh::KV_PANEL, &tmap_v, kv_full, 64 * p, kvh,
                      k0, b);
        }
      }
      for (int t = t_lo, i = 0; t <= t_hi; ++t, ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        // each row's lse and Dd; +inf and 0 for a spare row or a row past
        // S, whose p is then exactly 0
        for (int r = lane; r < TC_TILE; r += 32) {
          const int qi = t * QT + r / G;
          float l = POS_INF, d = 0.f;
          if (r < R && qi < S) {
            const long long st =
                ((long long)b * H + kvh * G + r % G) * S + qi;
            l = lse[st];
            d = dd[st];
          }
          slse[s * TC_TILE + r] = l;
          sdd[s * TC_TILE + r] = d;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * Sh::PANELS * R * PANEL_ROW);
#pragma unroll
          for (int p = 0; p < Sh::PANELS; ++p) {
            tma_load_4d(sq + s * Sh::ROW_BYTES + p * Sh::ROW_PANEL, &tmap_q,
                        &full[s], 64 * p, kvh * G, t * QT, b);
            tma_load_4d(sdo + s * Sh::ROW_BYTES + p * Sh::ROW_PANEL,
                        &tmap_do, &full[s], 64 * p, kvh * G, t * QT, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    consumer_regs();
    // warpgroup wg owns keys kw0..kw0+63; this thread's accumulator rows
    // (keys) are 16 * warp + lane / 4 (+ 8), its columns (tile rows)
    // 8j + 2 * (lane % 4) (+ 1)
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int kw0 = k0 + 64 * wg;
    // Both warpgroups walk all of the CTA's row tiles t_lo..t_hi, so that
    // they can take turns on the tensor cores: a tile that the causal or
    // window test rules out for one warpgroup's 64 keys is masked whole
    // there (a few tiles at the CTA's two ends), and a warpgroup with no
    // key below Sk (the last CTA's second half) computes zero keys that
    // are never written. No product sits in a branch.
    const int krow = kw0 + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t k_base = smem_u32(sk) + wg * 64 * PANEL_ROW;
    const uint32_t v_base = smem_u32(sv) + wg * 64 * PANEL_ROW;
    auto q_at = [&](int s) { return smem_u32(sq + s * Sh::ROW_BYTES); };
    auto do_at = [&](int s) { return smem_u32(sdo + s * Sh::ROW_BYTES); };
    // a tile that straddles the diagonal or the window's edge for some
    // (row, key) of the warpgroup, or lies beyond them, is masked per
    // element
    auto edge_at = [&](int t) {
      const int tq0 = t * QT;
      const int tq1 = tq0 + QT - 1 < S - 1 ? tq0 + QT - 1 : S - 1;
      return (causal && tq0 < kw0 + 63) ||
             (window > 0 && tq1 - kw0 >= window);
    };

    float adk[NO], adv[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) adk[i] = adv[i] = 0.f;
    float st[32], dpt[32];             // S^T, dP^T of the tile, then P^T, dS^T
    uint32_t pa[4][4], da[4][4];       // P^T, dS^T in bf16: A operands

    // The two warpgroups take turns on the tensor cores, as in the dQ
    // kernel: warpgroup w issues after named barrier 1 + w and opens
    // 2 - w. Each takes n + 1 turns: S^T_0 and dP^T_0; then dV, dK of
    // tile t and S^T, dP^T of tile t + 1; then dV, dK of the last tile.
    // Within a turn the two groups of products are waited for one after
    // the other: with all four accumulators in flight at once ptxas ran
    // out of registers and serialized the products (C7512), and the
    // kernel was slower.
    const int n = t_hi - t_lo + 1;
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    mbar_wait(kv_full, 0);
    if (wg == 1) named_bar_arrive(1, TC_CONSUMERS);
    mbar_wait(&full[0], 0);
    named_bar_sync(my_turn, TC_CONSUMERS);
    wgmma_fence();
    issue_ss<DP, 64>(st, k_base, Sh::KV_PANEL, q_at(0), Sh::ROW_PANEL);
    issue_ss<DP, 64>(dpt, v_base, Sh::KV_PANEL, do_at(0), Sh::ROW_PANEL);
    wgmma_commit();
    named_bar_arrive(other_turn, TC_CONSUMERS);
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    for (int i = 0; i + 1 < n; ++i) {
      const int t = t_lo + i, s = i % STAGES, s1 = (i + 1) % STAGES;
      dkdv_probs(st, dpt, pa, da, slse + s * TC_TILE, sdd + s * TC_TILE,
                 edge_at(t), krow, col0, t * QT, G, causal, window, scale);
      mbar_wait(&full[s1], ((i + 1) / STAGES) & 1);
      named_bar_sync(my_turn, TC_CONSUMERS);
      wgmma_fence();
      issue_rs<DP, 64>(adv, pa, do_at(s), Sh::ROW_PANEL);
      issue_rs<DP, 64>(adk, da, q_at(s), Sh::ROW_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
      issue_ss<DP, 64>(st, k_base, Sh::KV_PANEL, q_at(s1), Sh::ROW_PANEL);
      issue_ss<DP, 64>(dpt, v_base, Sh::KV_PANEL, do_at(s1), Sh::ROW_PANEL);
      wgmma_commit();
      named_bar_arrive(other_turn, TC_CONSUMERS);
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);
      mbar_arrive(&empty[s]);
    }
    {
      const int i = n - 1, t = t_hi, s = i % STAGES;
      dkdv_probs(st, dpt, pa, da, slse + s * TC_TILE, sdd + s * TC_TILE,
                 edge_at(t), krow, col0, t * QT, G, causal, window, scale);
      named_bar_sync(my_turn, TC_CONSUMERS);
      wgmma_fence();
      issue_rs<DP, 64>(adv, pa, do_at(s), Sh::ROW_PANEL);
      issue_rs<DP, 64>(adk, da, q_at(s), Sh::ROW_PANEL);
      wgmma_commit();
      if (wg == 0) named_bar_arrive(other_turn, TC_CONSUMERS);
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ki = krow + 8 * h;
      if (ki >= Sk) continue;
      const long long base = (((long long)b * Sk + ki) * KV + kvh) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk + base + col) =
              __floats2bfloat162_rn(adk[4 * j + 2 * h], adk[4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + base + col) =
              __floats2bfloat162_rn(adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// DP as above; BK keys a K/V tile; STAGES: depth of the K/V ring
template <int DP, int BK, int STAGES>
struct DqShape {
  static constexpr int PANELS = DP / 64;
  static constexpr int ROW_PANEL = TC_ROWS * PANEL_ROW;
  static constexpr int ROW_BYTES = PANELS * ROW_PANEL;     // Q or dO, resident
  static constexpr int KV_PANEL = BK * PANEL_ROW;
  static constexpr int TILE_BYTES = PANELS * KV_PANEL;
  // 1024 for aligning the base, Q, dO, the K and V rings, the barriers
  static constexpr size_t SMEM = 1024 + 2 * ROW_BYTES +
                                 2 * STAGES * TILE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

// dQ of 128 folded rows of one (batch, kv head): blockIdx.x the row tile
// (the heaviest first), blockIdx.y = b * KV + kvh
template <int DP, int BK, int STAGES>
__global__ void __launch_bounds__(TC_THREADS, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         __nv_bfloat16* __restrict__ dq, int S, int Sk,
                         int H, int KV, int D, int causal, int window,
                         float scale) {
  using Sh = DqShape<DP, BK, STAGES>;
  constexpr int NO = DP / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* sdo = sq + Sh::ROW_BYTES;
  uint8_t* sk = sdo + Sh::ROW_BYTES;
  uint8_t* sv = sk + STAGES * Sh::TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * Sh::TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long nrows = (long long)S * G;
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * TC_ROWS;
  const long long last = (r0 + TC_ROWS < nrows ? r0 + TC_ROWS : nrows) - 1;
  const long long qlo = r0 / G, qhi = last / G;
  long long kbeg = 0, kend = Sk;
  if (window > 0) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  if (causal) kend = qhi + 1 < Sk ? qhi + 1 : Sk;
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
  if (wg < 2) {                        // this warpgroup's 64 rows
    load_folded_rows<DP>(sq, Sh::ROW_PANEL, q, wg, r0, nrows, b, kvh, G, S,
                         H, D);
    load_folded_rows<DP>(sdo, Sh::ROW_PANEL, dout, wg, r0, nrows, b, kvh, G,
                         S, H, D);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (wg == 2) {
    producer_regs();
    // one thread keeps the K/V ring full
    if (threadIdx.x == TC_CONSUMERS) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * Sh::TILE_BYTES);
        const int kt = (int)(kbeg + (long long)t * BK);
#pragma unroll
        for (int p = 0; p < Sh::PANELS; ++p) {
          tma_load_4d(sk + s * Sh::TILE_BYTES + p * Sh::KV_PANEL, &tmap_k,
                      &full[s], 64 * p, kvh, kt, b);
          tma_load_4d(sv + s * Sh::TILE_BYTES + p * Sh::KV_PANEL, &tmap_v,
                      &full[s], 64 * p, kvh, kt, b);
        }
      }
    }
  } else {
    consumer_regs();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int rl = wg * 64 + warp * 16 + lane / 4;   // this thread's rows:
    long long row[2], qrow[2];                       // rl and rl + 8
    float rlse[2], rdd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r0 + rl + 8 * h;
      qrow[h] = row[h] / G;
      rlse[h] = POS_INF;               // a row past the end: p = 0
      rdd[h] = 0.f;
      if (row[h] < nrows) {
        const long long st =
            ((long long)b * H + kvh * G + row[h] % G) * S + qrow[h];
        rlse[h] = lse[st];
        rdd[h] = dd[st];
      }
    }
    const long long wrow0 = r0 + wg * 64;
    const long long wlast = (wrow0 + 64 < nrows ? wrow0 + 64 : nrows) - 1;
    const long long wq_lo = wrow0 / G,
                    wq_hi = (wlast > wrow0 ? wlast : wrow0) / G;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(sq) + wg * 64 * PANEL_ROW;
    const uint32_t do_base = smem_u32(sdo) + wg * 64 * PANEL_ROW;

    float adq[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) adq[i] = 0.f;
    float sc[BK / 2], dp[BK / 2];      // S, dP of the tile, then P, dS
    uint32_t da[BK / 16][4];           // dS in bf16: the A operand of dS.K

    auto k_at = [&](int s) { return smem_u32(sk + s * Sh::TILE_BYTES); };
    auto v_at = [&](int s) { return smem_u32(sv + s * Sh::TILE_BYTES); };
    // P and dS of key tile t in the score registers, dS in bf16 as the A
    // operand of dQ += dS.K. On a tile that straddles Sk, the diagonal or
    // the window's edge for some row of the warpgroup (edge), a masked
    // score is first set to -inf (p exactly 0), as in the forward.
    auto probs = [&](int t) {
      const long long k0 = kbeg + (long long)t * BK;
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq_lo) ||
                        (window > 0 && k0 <= wq_hi - window);
      if (edge) mask_key_tile<BK>(sc, k0, Sk, causal, window, qrow, col0);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const float p = expf(fmaf(sc[4 * j + c], scale, -rlse[h]));
          dp[4 * j + c] = p * (dp[4 * j + c] - rdd[h]) * scale;
        }
      pack_a<BK / 16>(da, dp);
    };

    // The two warpgroups take turns on the tensor cores (named barriers 1
    // and 2, as the forward's): warpgroup w issues its products after
    // barrier 1 + w and then opens 2 - w, so one's exp work runs while the
    // other's products do. Each takes ntiles + 1 turns: S_0 and dP_0; then
    // dS_t.K_t, waited for, and S_{t+1}, dP_{t+1} (all three in flight
    // serialized the products at D = 128, C7512); then dS_last.K_last.
    // Warpgroup 1 opens the first turn and skips the pass after its last.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_bar_arrive(1, TC_CONSUMERS);
    mbar_wait(&full[0], 0);
    named_bar_sync(my_turn, TC_CONSUMERS);
    wgmma_fence();
    issue_ss<DP, BK>(sc, q_base, Sh::ROW_PANEL, k_at(0), Sh::KV_PANEL);
    issue_ss<DP, BK>(dp, do_base, Sh::ROW_PANEL, v_at(0), Sh::KV_PANEL);
    wgmma_commit();
    named_bar_arrive(other_turn, TC_CONSUMERS);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    for (int t = 0; t + 1 < ntiles; ++t) {
      const int s = t % STAGES, s1 = (t + 1) % STAGES;
      probs(t);
      mbar_wait(&full[s1], ((t + 1) / STAGES) & 1);
      named_bar_sync(my_turn, TC_CONSUMERS);
      wgmma_fence();
      issue_rs<DP, BK>(adq, da, k_at(s), Sh::KV_PANEL);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adq);
      wgmma_fence();
      issue_ss<DP, BK>(sc, q_base, Sh::ROW_PANEL, k_at(s1), Sh::KV_PANEL);
      issue_ss<DP, BK>(dp, do_base, Sh::ROW_PANEL, v_at(s1), Sh::KV_PANEL);
      wgmma_commit();
      named_bar_arrive(other_turn, TC_CONSUMERS);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&empty[s]);
    }
    {
      const int t = ntiles - 1, s = t % STAGES;
      probs(t);
      named_bar_sync(my_turn, TC_CONSUMERS);
      wgmma_fence();
      issue_rs<DP, BK>(adq, da, k_at(s), Sh::KV_PANEL);
      wgmma_commit();
      if (wg == 0) named_bar_arrive(other_turn, TC_CONSUMERS);
      wgmma_wait_all();
      fence_regs(adq);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= nrows) continue;
      const int head = kvh * G + (int)(row[h] % G);
      __nv_bfloat16* dst = dq + (((long long)b * S + qrow[h]) * H + head) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              adq[4 * j + 2 * h], adq[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int DP, int STAGES, int BK, int STAGES_Q>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  float* dd, void* dq, void* dk, void* dv, int B, int S,
                  int Sk, int H, int KV, int D, int causal, int window,
                  float scale, cudaStream_t stream) {
  using Kv = DkdvShape<DP, STAGES>;
  using Qs = DqShape<DP, BK, STAGES_Q>;
  using bf16 = __nv_bfloat16;
  const int G = H / KV;
  CUtensorMap mq, mdo, mk, mv, mkt, mvt;
  int rc = heads_tensor_map(&mq, q, B, S, H, D, G, TC_TILE / G);
  if (rc == 0) rc = heads_tensor_map(&mdo, dout, B, S, H, D, G, TC_TILE / G);
  if (rc == 0) rc = kv_tensor_map(&mk, k, B, Sk, KV, D, TC_KEYS);
  if (rc == 0) rc = kv_tensor_map(&mv, v, B, Sk, KV, D, TC_KEYS);
  if (rc == 0) rc = kv_tensor_map(&mkt, k, B, Sk, KV, D, BK);
  if (rc == 0) rc = kv_tensor_map(&mvt, v, B, Sk, KV, D, BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_wgmma_kernel<DP, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Kv::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<DP, BK, STAGES_Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Qs::SMEM);
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * S * H;
  attn_bwd_dot_kernel<bf16><<<(unsigned)((rows + THREADS / 32 - 1) /
                                         (THREADS / 32)),
                              THREADS, 0, stream>>>(
      (const bf16*)dout, (const bf16*)out, dd, rows, S, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 gkv((unsigned)((Sk + TC_KEYS - 1) / TC_KEYS), (unsigned)(B * KV));
  attn_bwd_dkdv_wgmma_kernel<DP, STAGES><<<gkv, TC_THREADS, Kv::SMEM,
                                           stream>>>(
      mq, mdo, mk, mv, lse, dd, (bf16*)dk, (bf16*)dv, S, Sk, H, KV, D,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long nrows = (long long)S * G;
  dim3 gq((unsigned)((nrows + TC_ROWS - 1) / TC_ROWS), (unsigned)(B * KV));
  attn_bwd_dq_wgmma_kernel<DP, BK, STAGES_Q><<<gq, TC_THREADS, Qs::SMEM,
                                               stream>>>(
      mkt, mvt, (const bf16*)q, (const bf16*)dout, lse, dd, (bf16*)dq, S,
      Sk, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, out, dout and the three gradients
// share it); lse and dd (B, H, S) f32, dd a scratch the first launch fills;
// k, v, dk, dv over Sk keys. The caller checks shapes (D <= 256, H % KV ==
// 0, B * KV <= 65535, Sk >= 1, Sk == S unless non-causal without a window)
// and contiguity. Returns the first launch error, 0 if none.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int Sk, int H, int KV, int D,
    int causal, int window, float scale, cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, out, dout, (const float*)lse,
                               (float*)dd, dq, dk, dv, B, S, Sk, H, KV, D,
                               causal, window, scale, stream);
  return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse,
                                     (float*)dd, dq, dk, dv, B, S, Sk, H, KV,
                                     D, causal, window, scale, stream);
}

// The tensor-core route: bf16 only, D % 16 == 0, D <= 128, H / KV <= 64,
// every pointer of q, k, v, out, dout 16-byte aligned (the caller checks;
// repro_torch/kernels/flash_attention.py bwd_route picks the route).
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dd, void* dq, void* dk,
    void* dv, int B, int S, int Sk, int H, int KV, int D, int causal,
    int window, float scale, cudaStream_t stream) {
  if (S == 0 || B == 0) return 0;
  if (D % 16 != 0 || D <= 0 || D > 128 || H / KV > TC_TILE || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const float* st = (const float*)lse;
  if (D <= 64)
    return launch_bwd_tc<64, 3, 64, 3>(q, k, v, out, dout, st, (float*)dd,
                                       dq, dk, dv, B, S, Sk, H, KV, D,
                                       causal, window, scale, stream);
  return launch_bwd_tc<128, 2, 64, 2>(q, k, v, out, dout, st, (float*)dd,
                                      dq, dk, dv, B, S, Sk, H, KV, D, causal,
                                      window, scale, stream);
}

extern "C" const char* repro_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled entry point";
  if (err == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a Q, dO, K or V tensor map";
  return cudaGetErrorString((cudaError_t)err);
}
