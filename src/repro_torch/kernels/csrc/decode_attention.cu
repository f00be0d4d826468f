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
// What the design does about it. S is split across blocks: a grid of
// (splits, B*KV), the split count planned on the host from the shapes and
// the SM count (repro_torch/kernels/decode_attention.py plan_splits), so
// that even B*KV = 8 fills the card. Each warp of a block streams its own
// slots, WS at a time, with cp.async.cg 16-byte copies of the cache in its
// own dtype into a private ring of NST stages in shared memory; while it
// works on one tile the next NST-1 are in flight, and no block-wide barrier
// runs inside the loop. A lane owns 8 of the D columns of one slot (LPS =
// DMAX/8 lanes per slot, 32/LPS slots per pass): it converts the cache to
// q's dtype and then to f32 on use, in registers; the score of (head,
// slot) is a dot product over its 8 columns finished by shuffles inside
// the slot's lane group, and the online softmax (running max, sum and the
// 8 output columns of every head) is kept per lane group in registers. At
// the end the lane groups and then the warps merge their (m, l, acc) in a
// fixed order; with one split the block writes the output, otherwise it
// writes (m, l, acc) to scratch and a second launch merges the splits of
// each (b, kv head) in split order. No float atomics anywhere: the same
// inputs give the same bits on every run. Every slot is read, valid or
// not, so the work (and the bound) does not depend on the data.
//
// Precision follows the plain version: a slot whose valid flag is false
// gets the logit -1e30 (all false: uniform weights over the S slots, as in
// the reference); a cache element is read as q's dtype (the reference's
// cache.astype(q.dtype): exact for a bf16 cache under f32 q, rounded to
// bf16 for an f32 cache under bf16 q); scores are f32 dot products times
// 1/sqrt(D); exp is the accurate expf; p is rounded to q's dtype before
// P.V; the output is acc / max(l, 1e-30) in q's dtype.
//
// With statistics (lse not null) the output is that same quotient in f32,
// normalised over the S slots given, and lse (B,H) f32 is m + log(l) of
// each (b, head), so that callers holding other slots of the same ring
// (a sequence split over ranks) merge their outputs by the log-sum-exp of
// the lse's. With one split the main kernel writes both, otherwise the
// combine kernel does; the order of every sum is the one above, so the
// statistics too are the same bits on every run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;                // warps per block
constexpr int THREADS = NW * 32;
constexpr int NPASS = 4;             // passes of 32/LPS slots per warp tile
constexpr int DL = 8;                // columns per lane
constexpr int MAX_G = 8;             // query heads per kv head
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

// DMAX: D rounded up to 64, 128 or 256
template <typename TC, int DMAX> struct Shape {
  static constexpr int LPS = DMAX / DL;            // lanes per slot
  static constexpr int SPP = 32 / LPS;             // slots per pass
  static constexpr int WS = NPASS * SPP;           // slots per warp tile
  static constexpr int T = NW * WS;                // slots per block tile
  static constexpr int NST = sizeof(TC) == 2 ? 3 : 2;   // ring stages
  static constexpr int CHUNK = 16 / sizeof(TC);    // elements per 16 bytes
  // one stage of one warp: K then V, WS rows of DMAX elements
  static constexpr int STAGE = 2 * WS * DMAX;
  static constexpr size_t SMEM = sizeof(TC) * (size_t)NW * NST * STAGE;
};

// the column of element e (0..7) of lane part p: a bf16 lane reads one
// 16-byte chunk (8 columns); an f32 lane reads chunks p and p + LPS, so
// that the 8 lanes of a quarter warp read 8 neighbouring chunks
template <typename TC, int DMAX>
__device__ __forceinline__ int col_of(int p, int e) {
  constexpr int LPS = DMAX / DL;
  if (sizeof(TC) == 2) return DL * p + e;
  return e < 4 ? 4 * p + e : 4 * (p + LPS) + e - 4;
}

template <typename TQ, typename TC, int DMAX>
__device__ __forceinline__ void load_cols(const TC* row, int p,
                                          float (&x)[DL]) {
  constexpr int LPS = DMAX / DL;
  if constexpr (sizeof(TC) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + DL * p);
    const TC* e = reinterpret_cast<const TC*>(&raw);
#pragma unroll
    for (int u = 0; u < DL; ++u) x[u] = as_q<TQ, TC>(e[u]);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * p);
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (p + LPS));
    x[0] = as_q<TQ, TC>(a.x); x[1] = as_q<TQ, TC>(a.y);
    x[2] = as_q<TQ, TC>(a.z); x[3] = as_q<TQ, TC>(a.w);
    x[4] = as_q<TQ, TC>(b.x); x[5] = as_q<TQ, TC>(b.y);
    x[6] = as_q<TQ, TC>(b.z); x[7] = as_q<TQ, TC>(b.w);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// one warp tile (slots s0 .. s0+WS-1, the first n_in of them in range)
// into a stage: every element of the stage is written, with zeros for the
// slots out of range and the columns past D
template <typename TC, int DMAX>
__device__ __forceinline__ void load_tile(TC* stage, const TC* kbase,
                                          const TC* vbase, long long s0,
                                          int n_in, int D,
                                          long long row_stride, bool vec,
                                          int lane) {
  using Sh = Shape<TC, DMAX>;
  TC* sk = stage;
  TC* sv = stage + Sh::WS * DMAX;
  if (vec) {                           // D * sizeof(TC) % 16 == 0
    constexpr int CPR = DMAX / Sh::CHUNK;          // chunks per row
    const int have = D / Sh::CHUNK;                // chunks with data
    for (int i = lane; i < Sh::WS * CPR; i += 32) {
      const int t = i / CPR, c = i % CPR;
      const bool in = t < n_in && c < have;
      const long long off = in ? (s0 + t) * row_stride + c * Sh::CHUNK : 0;
      cp_async16(sk + t * DMAX + c * Sh::CHUNK, kbase + off, in ? 16 : 0);
      cp_async16(sv + t * DMAX + c * Sh::CHUNK, vbase + off, in ? 16 : 0);
    }
  } else {                             // a ragged D: element by element
    for (int i = lane; i < Sh::WS * DMAX; i += 32) {
      const int t = i / DMAX, d = i % DMAX;
      TC xk = from_f<TC>(0.f), xv = from_f<TC>(0.f);
      if (t < n_in && d < D) {
        xk = kbase[(s0 + t) * row_stride + d];
        xv = vbase[(s0 + t) * row_stride + d];
      }
      sk[t * DMAX + d] = xk;
      sv[t * DMAX + d] = xv;
    }
  }
}

// the output of head row ``row`` (b * H + h), column d, from its merged
// (m, l, acc): in q's dtype, or in f32 with lse = m + log(l) (column 0
// writes it) where lse is not null
template <typename TQ>
__device__ __forceinline__ void write_out(void* out, float* lse,
                                          long long row, int D, int d,
                                          float m, float l, float a) {
  const float o = a / fmaxf(l, 1e-30f);
  if (lse == nullptr) {
    reinterpret_cast<TQ*>(out)[row * D + d] = from_f<TQ>(o);
    return;
  }
  reinterpret_cast<float*>(out)[row * D + d] = o;
  if (d == 0) lse[row] = m + logf(fmaxf(l, 1e-30f));
}

// grid (splits, B*KV). Split z covers slots [z*per, min(S, (z+1)*per)).
// With one split the block writes out (f32, with lse, where lse is not
// null); otherwise (m, l) per head to part_ml (B*KV, splits, G, 2) and
// acc to part_acc (B*KV, splits, G, D).
template <typename TQ, typename TC, int DMAX, int GMAX>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc,
                    const uint8_t* __restrict__ valid, void* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int S, int H, int KV,
                    int D, int per, float scale, int vec) {
  using Sh = Shape<TC, DMAX>;
  constexpr int LPS = Sh::LPS, SPP = Sh::SPP, WS = Sh::WS, NST = Sh::NST;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  TC* ring = reinterpret_cast<TC*>(smem_raw);

  const int G = H / KV;
  const int split = blockIdx.x, splits = gridDim.x;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LPS, part = lane % LPS;
  const long long sb = (long long)split * per;
  const long long se = sb + per < S ? sb + per : S;
  const int ntiles = (int)((se - sb + Sh::T - 1) / Sh::T);
  const uint8_t* vrow = valid + (long long)b * S;
  const long long row_stride = (long long)KV * D;
  const TC* kbase = kc + ((long long)b * S * KV + kvh) * D;
  const TC* vbase = vc + ((long long)b * S * KV + kvh) * D;
  TC* wring = ring + (size_t)warp * NST * Sh::STAGE;

  // this lane's 8 columns of q, for every head
  float qv[GMAX][DL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const int d = col_of<TC, DMAX>(part, e);
      qv[g][e] = g < G && d < D
          ? to_f<TQ>(q[((long long)b * H + kvh * G + g) * D + d]) : 0.f;
    }
  float m[GMAX], l[GMAX], acc[GMAX][DL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  // warp tile t of this warp: slots sb + t*T + warp*WS ...
  auto issue = [&](int t) {
    if (t < ntiles) {
      const long long s0 = sb + (long long)t * Sh::T + warp * WS;
      const long long left = se - s0;
      const int n_in = left <= 0 ? 0 : (left < WS ? (int)left : WS);
      load_tile<TC, DMAX>(wring + (t % NST) * Sh::STAGE, kbase, vbase, s0,
                          n_in, D, row_stride, vec, lane);
    }
    cp_async_commit();                 // an empty group keeps the count
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);

  for (int t = 0; t < ntiles; ++t) {
    issue(t + NST - 1);
    cp_async_wait<NST - 1>();          // tile t has landed (this lane's)
    __syncwarp();                      // ... and every lane's
    const TC* sk = wring + (t % NST) * Sh::STAGE;
    const TC* sv = sk + WS * DMAX;
    const long long s0 = sb + (long long)t * Sh::T + warp * WS;

    // scores of this lane group's NPASS slots, every head
    float sc[NPASS][GMAX];
    bool in[NPASS];
#pragma unroll
    for (int i = 0; i < NPASS; ++i) {
      const int r = i * SPP + grp;
      const long long pos = s0 + r;
      in[i] = pos < se;
      const bool ok = in[i] && vrow[pos] != 0;
      float kx[DL];
      load_cols<TQ, TC, DMAX>(sk + r * DMAX, part, kx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) a = fmaf(qv[g][e], kx[e], a);
#pragma unroll
        for (int o = LPS / 2; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        sc[i][g] = ok ? a * scale : NEG;
      }
    }
    // online softmax, per head, over the in-range slots
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < NPASS; ++i)
        if (in[i]) mx = fmaxf(mx, sc[i][g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int i = 0; i < NPASS; ++i) {
        const float p = in[i] ? expf(sc[i][g] - mx) : 0.f;
        l[g] += p;
        sc[i][g] = to_f<TQ>(from_f<TQ>(p));   // p in q's dtype for P.V
      }
    }
    // acc += p . v
#pragma unroll
    for (int i = 0; i < NPASS; ++i) {
      float vx[DL];
      load_cols<TQ, TC, DMAX>(sv + (i * SPP + grp) * DMAX, part, vx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int e = 0; e < DL; ++e)
          acc[g][e] = fmaf(sc[i][g], vx[e], acc[g][e]);
    }
    __syncwarp();                      // stage t % NST is free again
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (the same columns, other slots)
#pragma unroll
  for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float om = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], om);
      const float ca = expf(m[g] - mm), cb = expf(om - mm);
      l[g] = l[g] * ca + ol * cb;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * ca + oa * cb;
      }
      m[g] = mm;
    }
  }

  // merge the warps, in warp order, through shared memory (the ring is
  // free: every copy has landed and every warp is past its loop)
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem_raw);  // [NW][GMAX]
  float* wl = wm + NW * GMAX;                      // [NW][GMAX]
  float* wacc = wl + NW * GMAX;                    // [NW][GMAX][DMAX]
  if (grp == 0) {                      // lane group 0 holds the warp's merge
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (part == 0) {
        wm[warp * GMAX + g] = m[g];
        wl[warp * GMAX + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e)
        wacc[(warp * GMAX + g) * DMAX + col_of<TC, DMAX>(part, e)] =
            acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w * GMAX + g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w * GMAX + g] - mm);
      ls += wl[w * GMAX + g] * c;
      a += wacc[(w * GMAX + g) * DMAX + d] * c;
    }
    if (splits == 1) {
      const long long row = (long long)b * H + kvh * G + g;
      write_out<TQ>(out, lse, row, D, d, mm, ls, a);
    } else {
      const long long slot = (long long)bkv * splits + split;
      part_acc[(slot * G + g) * D + d] = a;
      if (d == 0) {
        part_ml[(slot * G + g) * 2] = mm;
        part_ml[(slot * G + g) * 2 + 1] = ls;
      }
    }
  }
}

// grid (B*KV): merge the splits of each (b, kv head), in split order
template <typename TQ>
__global__ void __launch_bounds__(256)
flash_decode_combine_kernel(const float* __restrict__ part_ml,
                            const float* __restrict__ part_acc,
                            void* __restrict__ out, float* __restrict__ lse,
                            int splits, int H, int KV, int D) {
  const int G = H / KV;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const long long first = (long long)bkv * splits;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mm = NEG;
    for (int z = 0; z < splits; ++z)
      mm = fmaxf(mm, part_ml[((first + z) * G + g) * 2]);
    float ls = 0.f, a = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float c = expf(part_ml[((first + z) * G + g) * 2] - mm);
      ls += part_ml[((first + z) * G + g) * 2 + 1] * c;
      a += part_acc[((first + z) * G + g) * D + d] * c;
    }
    write_out<TQ>(out, lse, (long long)b * H + kvh * G + g, D, d, mm, ls,
                  a);
  }
}

template <typename TQ, typename TC, int DMAX, int GMAX>
int launch(const void* q, const void* kc, const void* vc,
           const uint8_t* valid, void* out, float* lse, float* part_ml,
           float* part_acc,
           int B, int S, int H, int KV, int D, int splits, int per,
           float scale, cudaStream_t stream) {
  using Sh = Shape<TC, DMAX>;
  // the warps' merge reuses the ring
  static_assert(sizeof(float) * NW * GMAX * (DMAX + 2) <= Sh::SMEM,
                "the ring must hold the warps' merge");
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TC, DMAX, GMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vec = (D * (int)sizeof(TC)) % 16 == 0 &&
                  (uintptr_t)kc % 16 == 0 && (uintptr_t)vc % 16 == 0;
  dim3 grid((unsigned)splits, (unsigned)(B * KV));
  flash_decode_kernel<TQ, TC, DMAX, GMAX><<<grid, THREADS, Sh::SMEM,
                                            stream>>>(
      (const TQ*)q, (const TC*)kc, (const TC*)vc, valid, out, lse, part_ml,
      part_acc, S, H, KV, D, per, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  flash_decode_combine_kernel<TQ><<<B * KV, 256, 0, stream>>>(
      part_ml, part_acc, out, lse, splits, H, KV, D);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, int DMAX>
int by_group(const void* q, const void* kc, const void* vc,
             const uint8_t* valid, void* out, float* lse, float* ml,
             float* acc, int B,
             int S, int H, int KV, int D, int splits, int per, float scale,
             cudaStream_t st) {
  const int G = H / KV;
  if (G <= 2) return launch<TQ, TC, DMAX, 2>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
  if (G <= 4) return launch<TQ, TC, DMAX, 4>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
  return launch<TQ, TC, DMAX, 8>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
}

template <typename TQ, typename TC>
int dispatch(const void* q, const void* kc, const void* vc,
             const uint8_t* valid, void* out, float* lse, float* ml,
             float* acc, int B,
             int S, int H, int KV, int D, int splits, int per, float scale,
             cudaStream_t st) {
  if (D <= 64) return by_group<TQ, TC, 64>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
  if (D <= 128) return by_group<TQ, TC, 128>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
  return by_group<TQ, TC, 256>(q, kc, vc, valid, out, lse, ml, acc, B, S, H, KV, D, splits, per, scale, st);
}

}  // namespace

// q_dtype / cache_dtype: 0 = f32, 1 = bf16 (out has q's dtype, or f32
// with lse (B,H) f32 where lse is not null). valid is (B,S)
// bool, one byte a slot. splits and per (slots per split) come from the
// host plan (decode_attention.py plan_splits): per is a multiple of the
// block tile and (splits - 1) * per < S. part_ml / part_acc are scratch of
// B*KV*splits*G*2 and B*KV*splits*G*D floats (unused with one split). The
// caller checks shapes (D <= 256, H % KV == 0, H / KV <= 8) and
// contiguity.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, const void* valid,
                                  void* out, void* lse, void* part_ml,
                                  void* part_acc,
                                  int q_dtype, int cache_dtype, int B, int S,
                                  int H, int KV, int D, int splits, int per,
                                  float scale, cudaStream_t stream) {
  if (B == 0 || S == 0) return 0;
  if (H / KV > MAX_G || splits < 1) return (int)cudaErrorInvalidValue;
  const uint8_t* vm = (const uint8_t*)valid;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  float* st = (float*)lse;
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch<float, float>(q, kc, vc, vm, out, st, ml, acc, B, S, H, KV, D, splits, per, scale, stream);
  if (q_dtype == 0)
    return dispatch<float, __nv_bfloat16>(q, kc, vc, vm, out, st, ml, acc, B, S, H, KV, D, splits, per, scale, stream);
  if (cache_dtype == 0)
    return dispatch<__nv_bfloat16, float>(q, kc, vc, vm, out, st, ml, acc, B, S, H, KV, D, splits, per, scale, stream);
  return dispatch<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, vm, out, st, ml, acc, B, S, H, KV, D, splits, per, scale, stream);
}

// the block tile (slots) for head dim D: the split plan's unit
extern "C" int repro_flash_decode_tile(int D) {
  if (D <= 64) return Shape<__nv_bfloat16, 64>::T;
  if (D <= 128) return Shape<__nv_bfloat16, 128>::T;
  return Shape<__nv_bfloat16, 256>::T;
}

extern "C" int repro_flash_decode_max_g() { return MAX_G; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
