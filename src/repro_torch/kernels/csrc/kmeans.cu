// K-means kernels of the selection hot path (paper §3.1), for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/kmeans.py:
//   pairwise_dist_kernel           <- kmeans_pairwise_dist_kernel (:67)
//   lloyd_assign_kernel +
//   lloyd_sums_kernel  (one sweep) <- kmeans_lloyd_kernel         (:127)
// Plain versions: repro_torch/kernels/ref.py. Python side:
// repro_torch/kernels/kmeans.py (the row plan, the launch) and
// kernels/ops.py (checks, outputs, launch counts).
//
// What bounds them on the H100. At the main path's shapes (a client's
// N = 2500 PCA features of width D = P = 200; K = 10 centres in a
// farthest-point-init step, K = 100 label-masked slots in a Lloyd sweep)
// the work is 2*N*K*D flops over 2-3 MB: bytes bound a pairwise call at
// 0.6 us and f32 FMAs a sweep at 1.5 us, both below what one launch and
// one round trip to memory cost. So the aim is a device time near that
// floor: every SM busy from the start, no serial stage on the critical
// path. No tensor cores: f32 must track the plain version to 2e-3, which
// TF32 does not, and 3xTF32 would buy nothing under a flop bound that is
// already below one launch. Measured by tools/kmeans_device_time.py on an
// H100 80GB HBM3 at 700 W, at those shapes with two classes present: the
// pairwise kernel 5.2 us of device time, a Lloyd sweep 10.6 us (assign)
// + 10.2 us (sums), against 14.9 and 46.2 + 211.4 us for the first
// version of these kernels (more in PERF.md).
//
// One distance core serves both kernels (dist_core):
//   * A block owns `rows` rows of x, planned on the host (kmeans.py
//     plan_rows: the most rows that still give one full wave of blocks,
//     19 at N = 2500 -> 132 blocks on 132 SMs). It stages its rows and the
//     whole (K, D) centroid panel into dynamic shared memory once, with
//     bulk copies (cp.async.bulk, counted by an mbarrier) where rows are
//     16-byte aligned: one for the whole panel and one for the x tile
//     where their rows are contiguous in shared memory too (the main
//     path), else one a row (a bulk copy costs tens of ns to issue, so
//     fewer is faster); 4-byte cp.async (zero-filled to a whole float4)
//     otherwise. Centroid rows are padded only where the 8 lanes of a
//     quarter-warp, reading float4s of different centroids at neighbouring
//     columns, would otherwise not hit 32 different banks.
//   * Thread tiles: TR = 4 rows x TC = 4 centroids (centroids strided across
//     the panel, so neighbouring threads read neighbouring rows of it);
//     `split` threads (a power of two) share one tile, each taking every
//     split-th float4 of D, and are summed with xor shuffles in a fixed
//     order. ||x||^2 and ||c||^2 come from the same loads, taken by the
//     tiles of the first centroid group and the first row group.
//   * Where the panel does not fit the shared-memory budget the core loops
//     over centroid panels (and, for very wide D, over column chunks, the
//     dot products and norms carried across chunks in registers): the same
//     kernel, planned by the host; phase 2 of chip_smoke.py and
//     tests/test_torch_cuda.py hold both loops.
// pairwise_dist_kernel writes (N, K) from the core. lloyd_assign_kernel
// adds the additive mask (its tile comes beside the panel, by one bulk
// copy with a second mbarrier where it can, and is waited for only before
// the epilogue), turns each distance into
// one 64-bit key (order-preserving float bits, then the index, so that the
// lowest index wins ties as jnp.argmin does), takes each tile's minimum,
// then each row's over its tiles in shared memory (8 lanes a row, no
// atomics), and writes assign, mindist and member = assign if
// min(lmask) <= 0 else -1.
//
// Lloyd's sums. `_lloyd_iterate` exits on the bit-exact test new_c == c,
// so sums must be the same bits on every run: no float atomics. One block
// of 256 threads per (cluster, 64 columns) compacts the rows of its
// cluster in rounds of 4096 (a ballot per warp and step and a 128-entry
// prefix scan: N / 256 steps, not N) into an ascending list, then stages
// the listed rows 128 at a time into shared memory, every thread copying
// a 16-byte piece of a row so that the whole window is in flight at once
// (a thread's own loads in flight are few: one thread per column fetching
// its column's rows was bound by them), and each column's thread adds
// them in ascending order from 0. That is the sequential f32 sum in row
// order that the first version of this kernel computed, so the bits are
// the same for the same assign. It is launched as a programmatic
// dependent of the assign pass (PDL), which hides part of the launch gap
// between the two; it waits for the assign grid at its top.
//
// Every entry point returns a CUDA error code (cudaGetLastError after the
// launches, cudaLaunchKernelEx's, or cudaErrorInvalidValue for a plan the
// kernel cannot run); the wrapper raises on a non-zero value. Launches go
// on the caller's stream and do not sync. The pairwise entry takes N >= 1
// (the wrapper launches nothing at N = 0); at N = 0 the Lloyd entry runs
// only the sums pass, which writes zero sums and counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // threads of a distance block
constexpr int TR = 4;               // rows of a thread tile
constexpr int TC = 4;               // centroids of a thread tile
constexpr int MAX_ROWS = 32;        // rows of x a block holds at most
constexpr int MAX_SPLIT = 32;       // threads sharing a tile (one warp)
constexpr int SMEM_MAX = 232448;    // dynamic shared memory of one block
constexpr int SMEM_STATIC = 48 * 1024;
constexpr int SUM_THREADS = 256;    // threads of a sums block
constexpr int SUM_COLS = 64;        // columns of a sums block
constexpr int SUM_CHUNK = 4096;     // rows compacted per round
constexpr int SUM_WINDOW = 128;     // listed rows in shared memory at once

struct Plan {
  int rows, panel, width, stride, split, smem;
};

// byte offsets of the distance core's shared memory: two mbarriers, each
// row's 64-bit best key, each (row, centroid group)'s candidate key, the
// centroid panel (rows at `stride` floats), the x tile (rows at `width`
// floats), the mask tile, ||x||^2, ||c||^2 and each row's "may join a
// cluster" flag. kmeans.py smem_bytes is the same sum, and plan_ok
// refuses a launch whose smem is not this total.
struct Layout {
  long long best, cand, cs, xs, ms, x2, c2, flag, total;
  __host__ __device__ explicit Layout(const Plan& p) {
    best = 16;
    cand = best + 8LL * p.rows;
    // the panel starts on 16 bytes (bulk copies, float4 reads)
    cs = best + ((8LL * p.rows * (1 + (p.panel + TC - 1) / TC) + 15) & ~15LL);
    xs = cs + 4LL * p.panel * p.stride;
    ms = xs + 4LL * p.rows * p.width;
    x2 = ms + 4LL * p.rows * p.panel;
    c2 = x2 + 4LL * p.rows;
    flag = c2 + 4LL * p.panel;
    total = flag + 4LL * p.rows;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
               "\n}\n" :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of the given parity has completed; a wait that
// never ends (a fault in the copies) traps instead of hanging the card
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

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared;
// the mbarrier counts them when they land
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a float's bits as an unsigned key in the same order (-0 is made +0
// first, so that it ties with +0 as the comparison does), then the index:
// min over keys = the lowest (value, index)
__device__ __forceinline__ unsigned long long order_key(float v, int idx) {
  uint32_t u = __float_as_uint(v + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (uint32_t)idx;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The distance core (see the header). LLOYD = false: out[r, k] =
// ||x_r||^2 + ||c_k||^2 - 2 x_r.c_k. LLOYD = true: assign, mindist and
// member of each row under the additive mask.
template <bool LLOYD>
__device__ __forceinline__ void dist_core(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ lmask, float* __restrict__ out,
    int* __restrict__ assign, float* __restrict__ mindist,
    int* __restrict__ member, long long n, int k, int d, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(p);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned long long* best =
      reinterpret_cast<unsigned long long*>(smem + L.best);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(smem + L.cand);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* ms = reinterpret_cast<float*>(smem + L.ms);
  float* x2s = reinterpret_cast<float*>(smem + L.x2);
  float* c2s = reinterpret_cast<float*>(smem + L.c2);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * p.rows;
  const int nr = (int)(n - row0 < p.rows ? n - row0 : p.rows);
  const int chunks = (d + p.width - 1) / p.width;
  const int ncg = (p.panel + TC - 1) / TC;           // centroid groups
  const int sub = tid % p.split, grp = tid / p.split;
  const int rg = grp / ncg, cg = grp % ncg;
  const bool owner = grp < ((p.rows + TR - 1) / TR) * ncg && sub == 0;
  const bool bulk = d % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(c)) &
       15) == 0;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
  }
  if (LLOYD) {
    for (int i = tid; i < p.rows; i += THREADS) {
      best[i] = ~0ULL;
      flag[i] = 0;
    }
  }
  __syncthreads();
  uint32_t parity = 0;

  for (int k0 = 0; k0 < k; k0 += p.panel) {
    const int kc = k - k0 < p.panel ? k - k0 : p.panel;
    // the tile's dot products, and the squared norms of its rows (taken by
    // the tiles of the first centroid group, in the first panel) and of its
    // centroids (by the tiles of the first row group): from the same loads
    float acc[TR][TC], x2a[TR], c2a[TC];
    const bool xnorm = cg == 0 && k0 == 0, cnorm = rg == 0;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      x2a[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) c2a[j] = 0.f;
    // this thread's rows and centroids, clamped into the staged ones (the
    // clamped products are computed and never written)
    int xo[TR], co[TC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rg * TR + i;
      xo[i] = (r < nr ? r : nr - 1) * p.width;
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int cc = cg + j * ncg;
      co[j] = (cc < kc ? cc : kc - 1) * p.stride;
    }

    for (int ch = 0; ch < chunks; ++ch) {
      const int d0 = ch * p.width;
      const int w = d - d0 < p.width ? d - d0 : p.width;
      const int w4 = (w + 3) / 4;                     // float4s of a row
      const bool load_x = k0 == 0 || chunks > 1;
      __syncthreads();                // the last stage's reads are done
      // the mask tile, read only in the epilogue, has its own mbarrier
      const bool mask_bulk = LLOYD && ch == 0 && bulk && kc == k &&
          k % 4 == 0 && (reinterpret_cast<uintptr_t>(lmask) & 15) == 0;
      if (bulk) {
        if (warp == 0) {
          const int xr = load_x ? nr : 0;
          if (lane == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive_expect_tx(&bar[0], 4u * w * (kc + xr));
            // whole rows at their own stride: one copy for all of them
            if (chunks == 1 && p.stride == d)
              bulk_copy(cs, c + (long long)k0 * d, 4u * d * kc, &bar[0]);
            if (xr && chunks == 1 && p.width == d)
              bulk_copy(xs, x + row0 * d, 4u * d * xr, &bar[0]);
            if (mask_bulk) {
              mbar_arrive_expect_tx(&bar[1], 4u * k * nr);
              bulk_copy(ms, lmask + row0 * k, 4u * k * nr, &bar[1]);
            }
          }
          __syncwarp();                 // the byte counts come first
          if (chunks > 1 || p.stride != d) {          // a copy per row
            for (int i = lane; i < kc; i += 32)
              bulk_copy(cs + (long long)i * p.stride,
                        c + (long long)(k0 + i) * d + d0, 4u * w, &bar[0]);
          }
          if (xr && (chunks > 1 || p.width != d)) {
            for (int i = lane; i < xr; i += 32)
              bulk_copy(xs + (long long)i * p.width,
                        x + (row0 + i) * d + d0, 4u * w, &bar[0]);
          }
        }
      } else {
        const int wq = 4 * w4;        // zero-filled up to a whole float4
        for (int e = tid; e < kc * wq; e += THREADS) {
          const int i = e / wq, j = e % wq;
          cp_async4(cs + (long long)i * p.stride + j,
                    c + (long long)(k0 + i) * d + d0 + (j < w ? j : 0),
                    j < w ? 4 : 0);
        }
        if (load_x) {
          for (int e = tid; e < nr * wq; e += THREADS) {
            const int i = e / wq, j = e % wq;
            cp_async4(xs + (long long)i * p.width + j,
                      x + (row0 + i) * d + d0 + (j < w ? j : 0),
                      j < w ? 4 : 0);
          }
        }
      }
      if (LLOYD && ch == 0 && !mask_bulk) {
        for (int e = tid; e < nr * kc; e += THREADS) {
          const int i = e / kc, j = e % kc;
          cp_async4(ms + i * p.panel + j,
                    lmask + (row0 + i) * k + k0 + j, 4);
        }
      }
      if (bulk) {
        mbar_wait(&bar[0], parity);
      } else {                        // every thread's copies are visible
        cp_async_wait_all();
        __syncthreads();
      }

      // this thread's share of its tile's dot products over the chunk
      for (int q = sub; q < w4; q += p.split) {
        float4 a[TR], b[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          a[i] = reinterpret_cast<const float4*>(xs + xo[i])[q];
#pragma unroll
        for (int j = 0; j < TC; ++j)
          b[j] = reinterpret_cast<const float4*>(cs + co[j])[q];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
        if (xnorm) {
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            x2a[i] = fmaf(a[i].x, a[i].x, x2a[i]);
            x2a[i] = fmaf(a[i].y, a[i].y, x2a[i]);
            x2a[i] = fmaf(a[i].z, a[i].z, x2a[i]);
            x2a[i] = fmaf(a[i].w, a[i].w, x2a[i]);
          }
        }
        if (cnorm) {
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            c2a[j] = fmaf(b[j].x, b[j].x, c2a[j]);
            c2a[j] = fmaf(b[j].y, b[j].y, c2a[j]);
            c2a[j] = fmaf(b[j].z, b[j].z, c2a[j]);
            c2a[j] = fmaf(b[j].w, b[j].w, c2a[j]);
          }
        }
      }
      if (mask_bulk) mbar_wait(&bar[1], parity);   // before the epilogue
      parity ^= 1;
    }

    // the split threads of a tile are consecutive lanes: add their shares
    for (int off = p.split >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        x2a[i] += __shfl_xor_sync(0xffffffffu, x2a[i], off);
#pragma unroll
        for (int j = 0; j < TC; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j)
        c2a[j] += __shfl_xor_sync(0xffffffffu, c2a[j], off);
    }
    cp_async_wait_all();              // the mask tile
    if (owner) {
#pragma unroll
      for (int i = 0; i < TR; ++i)
        if (xnorm && rg * TR + i < nr) x2s[rg * TR + i] = x2a[i];
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (cnorm && cg + j * ncg < kc) c2s[cg + j * ncg] = c2a[j];
    }
    __syncthreads();                  // the norms are complete
    if (owner) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = rg * TR + i;
        if (r >= nr) continue;
        unsigned long long bk = ~0ULL;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int cc = cg + j * ncg;
          if (cc >= kc) continue;
          const float dist = (x2s[r] + c2s[cc]) - 2.f * acc[i][j];
          if (LLOYD) {
            const unsigned long long key =
                order_key(dist + ms[r * p.panel + cc], k0 + cc);
            bk = key < bk ? key : bk;
          } else {
            out[(row0 + r) * k + k0 + cc] = dist;
          }
        }
        if (LLOYD) cand[r * ncg + cg] = bk;
      }
    }
    if (LLOYD) {
      // 8 lanes a row: the minimum of its candidates, and whether any of
      // its mask values in the panel is <= 0, merged into the row's best
      __syncthreads();
      for (int v0 = 0; v0 < p.rows; v0 += THREADS / 8) {
        const int r = v0 + tid / 8;
        const bool ok = r < nr;
        unsigned long long bk = ~0ULL;
        int joins = 0;
        for (int q = tid % 8; ok && q < ncg; q += 8) {
          const unsigned long long key = cand[r * ncg + q];
          bk = key < bk ? key : bk;
        }
        for (int q = tid % 8; ok && q < kc; q += 8)
          joins |= ms[r * p.panel + q] <= 0.f;
#pragma unroll
        for (int off = 4; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, bk, off);
          bk = o < bk ? o : bk;
          joins |= __shfl_xor_sync(0xffffffffu, joins, off);
        }
        if (ok && tid % 8 == 0) {
          best[r] = bk < best[r] ? bk : best[r];
          flag[r] |= joins;
        }
      }
    }
  }

  if (LLOYD) {
    __syncthreads();
    for (int r = tid; r < nr; r += THREADS) {
      const unsigned long long key = best[r];
      const int idx = (int)(uint32_t)key;
      assign[row0 + r] = idx;
      mindist[row0 + r] = key_value(key);
      member[row0 + r] = flag[r] ? idx : -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
pairwise_dist_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ out, long long n, int k, int d,
                     const Plan p) {
  dist_core<false>(x, c, nullptr, out, nullptr, nullptr, nullptr, n, k, d,
                   p);
}

__global__ void __launch_bounds__(THREADS, 2)
lloyd_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ lmask, int* __restrict__ assign,
                    float* __restrict__ mindist, int* __restrict__ member,
                    long long n, int k, int d, const Plan p) {
  dist_core<true>(x, c, lmask, nullptr, assign, mindist, member, n, k, d, p);
}

// sums[cl, col] = the f32 sum, in ascending row order from 0, of x[r, col]
// over the rows r with member[r] == cl; counts[cl] = the number of them.
__global__ void __launch_bounds__(SUM_THREADS)
lloyd_sums_kernel(const float* __restrict__ x, const int* __restrict__ member,
                  float* __restrict__ sums, float* __restrict__ counts,
                  long long n, int k, int d) {
  constexpr int STEPS = SUM_CHUNK / SUM_THREADS;    // rows a thread scans
  constexpr int WARPS = SUM_THREADS / 32;
  constexpr int PER_LANE = STEPS * WARPS / 32;      // scan entries a lane
  static_assert(PER_LANE * 32 == STEPS * WARPS, "whole scan entries");
  __shared__ uint16_t list[SUM_CHUNK];  // this round's rows, ascending
  __shared__ int offs[STEPS * WARPS];   // (step, warp) -> first list slot
  __shared__ int total;
  __shared__ __align__(16) float window[SUM_WINDOW][SUM_COLS];
  const int cl = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.y * SUM_COLS;
  const int cols = d - col0 < SUM_COLS ? d - col0 : SUM_COLS;
  // every thread copies one piece of a listed row (16 bytes where the rows
  // allow it, else 4) and the next rows in steps: the block keeps a whole
  // window of rows in flight, not one thread's few
  const bool wide = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int pieces = wide ? SUM_COLS / 4 : SUM_COLS;   // of one row
  const int part = tid % pieces, first = tid / pieces;
  const int stride = SUM_THREADS / pieces;             // rows a pass
  const int c = wide ? 4 * part : part;                // its first column
  // launched as a programmatic dependent of the assign pass: wait until
  // its grid has finished and its member[] is visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float acc = 0.f;
  long long cnt = 0;
  for (long long n0 = 0; n0 < n; n0 += SUM_CHUNK) {
    // which of this round's rows join the cluster: all loads first, then
    // a ballot per warp and step (rows n0 + u*SUM_THREADS + tid, so
    // (step, warp) runs in row order)
    int mem[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long r = n0 + u * SUM_THREADS + tid;
      mem[u] = r < n ? member[r] : -1;
    }
    uint32_t ballot[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      ballot[u] = __ballot_sync(0xffffffffu, mem[u] == cl);
      if (lane == 0) offs[u * WARPS + warp] = __popc(ballot[u]);
    }
    __syncthreads();
    if (warp == 0) {                  // exclusive scan of the counts
      int v[PER_LANE], own = 0;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        v[e] = offs[lane * PER_LANE + e];
        own += v[e];
      }
      int s = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += t;
      }
      int run = s - own;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        offs[lane * PER_LANE + e] = run;
        run += v[e];
      }
      if (lane == 31) total = s;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      if ((ballot[u] >> lane) & 1u)
        list[offs[u * WARPS + warp] +
             __popc(ballot[u] & ((1u << lane) - 1u))] =
            (uint16_t)(u * SUM_THREADS + tid);
    }
    __syncthreads();
    const int m = total;
    // a window of listed rows at a time: the block's copies all in flight,
    // then the adds of each column in row order (zeros past the columns)
    for (int w0 = 0; w0 < m; w0 += SUM_WINDOW) {
      const int wn = m - w0 < SUM_WINDOW ? m - w0 : SUM_WINDOW;
      for (int i = first; i < wn; i += stride) {
        const float* row = x + (n0 + list[w0 + i]) * d + col0;
        if (wide)
          cp_async16(&window[i][c], row + (c < cols ? c : 0),
                     c < cols ? 16 : 0);
        else
          cp_async4(&window[i][c], row + (c < cols ? c : 0),
                    c < cols ? 4 : 0);
      }
      cp_async_wait_all();
      __syncthreads();
      if (tid < cols) {
        int i = 0;
        for (; i + 8 <= wn; i += 8) {   // eight reads, then the adds
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = window[i + u][tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc += v[u];
        }
        for (; i < wn; ++i) acc += window[i][tid];
      }
      __syncthreads();                // the window is reused
    }
    cnt += m;
  }
  if (col0 + tid < d && tid < SUM_COLS)
    sums[(long long)cl * d + col0 + tid] = acc;
  if (blockIdx.y == 0 && tid == 0) counts[cl] = (float)cnt;
}

// the plan can run: its tiles have their threads, its strides hold whole
// float4s, and its shared memory is the layout's and fits a block
bool plan_ok(const Plan& p, int k, int d) {
  if (p.rows < 1 || p.rows > MAX_ROWS || p.panel < 1 || p.panel > k ||
      p.split < 1 || p.split > MAX_SPLIT || (p.split & (p.split - 1)) ||
      p.width < 4 || p.width % 4 ||
      p.width > d + 3 || p.stride < p.width || p.stride % 4)
    return false;
  const long long tiles = (long long)((p.rows + TR - 1) / TR) *
                          ((p.panel + TC - 1) / TC);
  return tiles * p.split <= THREADS && p.smem <= SMEM_MAX &&
         Layout(p).total == p.smem;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= SMEM_STATIC) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" int repro_kmeans_pairwise_dist(const float* x, const float* c,
                                          float* out, long long n, int k,
                                          int d, int rows, int panel,
                                          int width, int stride, int split,
                                          int smem, cudaStream_t stream) {
  const Plan p{rows, panel, width, stride, split, smem};
  if (n < 1 || !plan_ok(p, k, d)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(pairwise_dist_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pairwise_dist_kernel<<<(unsigned)((n + rows - 1) / rows), THREADS, smem,
                         stream>>>(x, c, out, n, k, d, p);
  return (int)cudaGetLastError();
}

extern "C" int repro_kmeans_lloyd(const float* x, const float* c,
                                  const float* lmask, int* assign,
                                  float* mindist, int* member, float* sums,
                                  float* counts, long long n, int k, int d,
                                  int rows, int panel, int width, int stride,
                                  int split, int smem,
                                  cudaStream_t stream) {
  const Plan p{rows, panel, width, stride, split, smem};
  if (!plan_ok(p, k, d)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaError_t err = allow_smem(lloyd_assign_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    lloyd_assign_kernel<<<(unsigned)((n + rows - 1) / rows), THREADS, smem,
                          stream>>>(x, c, lmask, assign, mindist, member, n,
                                    k, d, p);
  }
  // the sums pass, launched so that it may start while the assign pass
  // ends (programmatic stream serialization; it waits at its top)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k, (unsigned)((d + SUM_COLS - 1) / SUM_COLS));
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n > 0 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lloyd_sums_kernel, x,
                                             (const int*)member, sums,
                                             counts, n, k, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
