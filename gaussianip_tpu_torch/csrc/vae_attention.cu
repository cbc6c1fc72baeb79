// K5: single-head softmax attention with a wide head, forward and backward,
// for Hopper (sm_90a): the VAE's mid-block attention (diffusion/vae.py:
// VAEAttention), one head of d = 512 channels over every latent pixel
// (N = 16,384 tokens in the SDXL encode at 1024^2, 4,096 at 512^2).
//
// Replaces no TPU kernel: gaussianip_tpu/diffusion/blocks.py:_attend leaves
// this attention to XLA. On the card SDPA sends a 512-wide head to its
// memory-efficient backend (flash and cuDNN take at most 256), whose
// generic sm80 kernels ran the SDXL encode's backward at 3.4% of the bf16
// peak.
//
//   q, k, v, o, dO  [B, N, d]  bf16 or float32, contiguous; d % 32 == 0,
//                              d <= 512
//   lse, delta      [B, N]     float32: the rows' logsumexp of S, and
//                              rowsum(dO * o)
//   p, ds           [N, ld]    one view's P and dS in q's dtype, ld = N
//                              rounded up to 8 (the columns past N are
//                              written as zeros or not at all)
//
// S = q k^T / sqrt(d), P = exp(S - lse), o = P v. Work: forward 4 B N^2 d,
// backward 10 B N^2 d operations, bound by the tensor cores at d = 512.
// Flash attention's shape does not fit this head: a 64 x 512 float32
// accumulator of o (or of dK, dV) is 128 KB, half an SM's registers. So the
// N x N work is kept apart from the 512-deep products:
//   forward   k5_scores<STATS>: S tile by tile, the online row max and sum
//             -> lse (float32); per view k5_scores<PROBS>: P = exp(S - lse)
//             as tiles in q's dtype; o = P v (the wrapper's torch.mm, f32
//             accumulation).
//   backward  k5_rowdot: delta = rowsum(dO * o) in float32; per view
//             k5_scores<GRADS>: S and dP = dO v^T, then P and
//             dS = P (dP - delta) / sqrt(d) as tiles; dV = P^T dO,
//             dQ = dS k, dK = dS^T q (the wrapper's torch.mm).
// S, dP, the row statistics, lse and delta stay float32; P and dS are
// rounded to q's dtype only as operands of the next product. The products
// in the kernels recompute S (2 N^2 d each), so the operations stay
// 4 + 2 (forward) and 10 (backward) N^2 d. Nothing N x N lives between the
// forward and the backward; the wrapper runs one view at a time through
// one p (and ds) buffer.
//
// bf16 (k5_scores_kernel): a 128 x 128 tile of S (and dP) per step of a
// persistent CTA, 384 threads. Warpgroup 2 produces: one thread keeps a
// ring of 5 stages in flight, each a 128 x 64 slice of the row operand (q
// or dO) and of the column operand (k or v), TMA boxes of a 3D map
// [B, N, d] with 128B swizzle; rows past N and channels past d come in as
// zeros. Warpgroups 0 and 1 consume, 64 rows each: wgmma m64n128k16 into
// float32 accumulators over the d / 64 slices (S, then dP into a second
// accumulator), then the epilogue in registers: STATS keeps a running max
// and sum per row (a row lies in 4 lanes); PROBS and GRADS round P (dS)
// into a padded staging tile in shared memory and store it 16 bytes a lane,
// masked at N. The producer runs ahead into the next tile while the
// consumers finish one. 199,760 B of shared memory: one CTA an SM. The
// K3 kernel's settled faults hold here too (csrc/conv3x3.cu; the shared
// helpers in csrc/hopper.cuh): mbarrier parities, scale-d 0 in place of a
// zero fill, 1024-B aligned stages, SBO 1024, +32 B per k16.
//
// float32 (k5_scores_f32_kernel): the same modes on the CUDA cores, 64 x 64
// tiles, slices of 32 channels through shared memory, 4 x 4 outputs a
// thread; no TF32. It exists for float32 VAEs (weight_parity's) and is not
// fast.
//
// No atomics: every output element is written by one thread, and the sums
// run in a fixed order, so a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

enum Mode { STATS = 0, PROBS = 1, GRADS = 2 };

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int SLICE = BM * BK * 2;  // one 128 x 64 bf16 box, 16 KB
constexpr int STAGE = 2 * SLICE;    // a row slice and a column slice
constexpr int STAGES = 5;
constexpr int ST_LD = BN + 8;  // staging row in elements, against conflicts
constexpr int STAGING = BM * ST_LD * 2;
constexpr int SMEM = STAGES * STAGE + STAGING + 2 * STAGES * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the consumers' place in the ring: stage, its pass's parity, and the stage
// whose wgmma group is still in flight (-1: none)
struct Ring {
  int s;
  uint32_t phase;
  int prev;
};

// one product of a tile into acc over the d / 64 slices in the ring: the
// warpgroup's 64 rows of the row slice against the 128 rows of the column
// slice; each stage is released once the next step's group is issued
__device__ __forceinline__ void consume(float (&acc)[64], Ring& ring,
                                        uint32_t base, uint32_t bars, int nk,
                                        int wg, int t128) {
  for (int kk = 0; kk < nk; ++kk) {
    mbar_wait(bars + 8 * ring.s, ring.phase);
    const uint32_t sa = base + ring.s * STAGE;
    const uint64_t da = sw128_desc(sa + wg * 64 * BK * 2);
    const uint64_t db = sw128_desc(sa + SLICE);
    fence_acc<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16)
      wgmma_m64n128(acc, da + 2 * k16, db + 2 * k16,  // +32 B per k16
                    kk > 0 || k16 > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's group has read its stage
    fence_acc<64>(acc);
    if (ring.prev >= 0 && t128 == 0)
      mbar_arrive(bars + 8 * (STAGES + ring.prev));
    ring.prev = ring.s;
    if (++ring.s == STAGES) {
      ring.s = 0;
      ring.phase ^= 1;
    }
  }
}

// a warpgroup's 64 x 128 tile, rounded (vals[2 c + h]: the pair at row
// row_w + 8 h, columns 8 c + col_l, +1), through its staging rows st to
// out[row0 + r][col0 + c], 16 bytes a lane, masked at n
__device__ __forceinline__ void store_tile(
    const __nv_bfloat162 (&vals)[BN / 4], __nv_bfloat16* st,
    __nv_bfloat16* __restrict__ out, long long row0, int col0, int row_w,
    int col_l, int t128, int wg, int n, long long ld) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(st + (row_w + 8 * h) * ST_LD +
                                         8 * c + col_l) = vals[2 * c + h];
  named_bar_sync(2 + wg, 128);
#pragma unroll
  for (int u = 0; u < 64 * (BN / 8) / 128; ++u) {
    const int idx = t128 + 128 * u, r = idx / (BN / 8),
              cv = (idx % (BN / 8)) * 8;
    const long long row = row0 + r;
    const int col = col0 + cv;
    if (row < n && col < n)
      *reinterpret_cast<uint4*>(out + row * ld + col) =
          *reinterpret_cast<const uint4*>(st + r * ST_LD + cv);
  }
  named_bar_sync(2 + wg, 128);  // the staging rows are free again
}

// The tiles of one CTA: STATS, row block blockIdx.x of view blockIdx.y
// against every column block; PROBS and GRADS, tiles blockIdx.x + u
// gridDim.x of the view's n_t x n_t, row-major, so that the CTAs in flight
// share a row block and sweep the columns together through L2.
struct Tiles {
  long long first, stride, total;
  int n_t;
  template <int MODE>
  __device__ __forceinline__ void init(int n) {
    n_t = (n + BM - 1) / BM;
    if (MODE == STATS) {
      first = 0, stride = 1, total = n_t;
    } else {
      first = blockIdx.x, stride = gridDim.x, total = (long long)n_t * n_t;
    }
  }
  template <int MODE>
  __device__ __forceinline__ void at(long long t, int& ti, int& tj) const {
    if (MODE == STATS) {
      ti = blockIdx.x, tj = (int)t;
    } else {
      ti = (int)(t / n_t), tj = (int)(t % n_t);
    }
  }
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    k5_scores_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_v,
                     float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ p_out,
                     __nv_bfloat16* __restrict__ ds_out, long long ld, int n,
                     int d, int view, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  __nv_bfloat16* staging =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const uint32_t bars = base + STAGES * STAGE + STAGING;
  const int b = MODE == STATS ? (int)blockIdx.y : view;
  const int nk = (d + BK - 1) / BK;
  Tiles tiles;
  tiles.init<MODE>(n);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);              // the producer's arrive
      mbar_init(bars + 8 * (STAGES + s), 2);   // one per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: S's slices (q, k), then for GRADS dP's (dO, v), per tile
    reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      int s = 0;
      uint32_t phase = 0;
      auto produce = [&](const CUtensorMap* rows, const CUtensorMap* cols,
                         int ti, int tj) {
        for (int kk = 0; kk < nk; ++kk) {
          mbar_wait(bars + 8 * (STAGES + s), phase ^ 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t sa = base + s * STAGE;
          mbar_expect_tx(full, STAGE);
          tma_load_3d(sa, rows, full, kk * BK, ti * BM, b);
          tma_load_3d(sa + SLICE, cols, full, kk * BK, tj * BN, b);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      };
      for (long long t = tiles.first; t < tiles.total; t += tiles.stride) {
        int ti, tj;
        tiles.at<MODE>(t, ti, tj);
        produce(&map_q, &map_k, ti, tj);
        if (MODE == GRADS) produce(&map_do, &map_v, ti, tj);
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows [64 wg, 64 wg + 64) of the tile
  reg_alloc<232>();
  const int t128 = threadIdx.x % 128, lane = t128 % 32;
  // accumulator layout of m64n128: register 4 c + 2 h + e holds row
  // 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e
  const int row_w = (t128 / 32) * 16 + lane / 4;  // in the warpgroup's 64
  const int col_l = 2 * (lane % 4);
  __nv_bfloat16* st = staging + wg * 64 * ST_LD;
  // no zero fill: the first k16 of a tile overwrites (scale-d 0), so that
  // no other instruction writes the accumulators
  float sacc[64];
  float dpacc[MODE == GRADS ? 64 : 1];
  Ring ring{0, 0, -1};
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.0f, 0.0f};

  int ti = 0, tj = 0;
  for (long long t = tiles.first; t < tiles.total; t += tiles.stride) {
    tiles.at<MODE>(t, ti, tj);
    consume(sacc, ring, base, bars, nk, wg, t128);
    if constexpr (MODE == GRADS) consume(dpacc, ring, base, bars, nk, wg, t128);
    wgmma_wait<0>();
    fence_acc<64>(sacc);
    if constexpr (MODE == GRADS) fence_acc<64>(dpacc);
    if (t128 == 0) mbar_arrive(bars + 8 * (STAGES + ring.prev));
    ring.prev = -1;

    const int col0 = tj * BN + col_l;
    if constexpr (MODE == STATS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * c + e < n) tmax = fmaxf(tmax, sacc[4 * c + 2 * h + e]);
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m_run[h], tmax * scale_log2);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * c + e < n)
              sum += exp2f(fmaf(sacc[4 * c + 2 * h + e], scale_log2, -m_new));
        l_run[h] = l_run[h] * exp2f(m_run[h] - m_new) + sum;
        m_run[h] = m_new;
      }
    } else {
      float lrow[2], drow[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = (long long)ti * BM + wg * 64 + row_w + 8 * h;
        lrow[h] = row < n ? lse[(long long)b * n + row] * LOG2E : 0.0f;
        if (MODE == GRADS && row < n) drow[h] = delta[(long long)b * n + row];
      }
      __nv_bfloat162 pv[BN / 4], dsv[MODE == GRADS ? BN / 4 : 1];
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pe[2], dse[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * c + 2 * h + e;
            pe[e] = col0 + 8 * c + e < n
                        ? exp2f(fmaf(sacc[i], scale_log2, -lrow[h]))
                        : 0.0f;
            if constexpr (MODE == GRADS)
              dse[e] = pe[e] * (dpacc[i] - drow[h]) * scale;
          }
          pv[2 * c + h] = __floats2bfloat162_rn(pe[0], pe[1]);
          if constexpr (MODE == GRADS)
            dsv[2 * c + h] = __floats2bfloat162_rn(dse[0], dse[1]);
        }
      const long long row0 = (long long)ti * BM + wg * 64;
      store_tile(pv, st, p_out, row0, tj * BN, row_w, col_l, t128, wg, n, ld);
      if constexpr (MODE == GRADS)
        store_tile(dsv, st, ds_out, row0, tj * BN, row_w, col_l, t128, wg, n,
                   ld);
    }
  }
  if constexpr (MODE == STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const long long row = (long long)blockIdx.x * BM + wg * 64 + row_w + 8 * h;
      if (lane % 4 == 0 && row < n)
        lse[(long long)b * n + row] = (m_run[h] + log2f(l)) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: 64 x 64 tiles of 256 threads, thread (ty, tx)
// holds rows 4 ty + r and columns tx + 16 c; a row's 16 threads are one
// half-warp. STATS: grid (n_t, B), a CTA sweeps its row block's columns;
// PROBS, GRADS: grid (n_t, n_t), one tile a CTA, of one view.

constexpr int FT = 64, FK = 32, FTHREADS = 256;

template <int MODE>
__global__ void __launch_bounds__(FTHREADS)
    k5_scores_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ dout,
                         const float* __restrict__ v, float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ p_out, float* __restrict__ ds_out,
                         long long ld, int n, int d, int view,
                         float scale_log2, float scale) {
  __shared__ float as[FK][FT + 1], bs[FK][FT + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = MODE == STATS ? (int)blockIdx.y : view;
  const int ti = MODE == STATS ? (int)blockIdx.x : (int)blockIdx.y;
  const int n_t = (n + FT - 1) / FT;
  const long long vb = (long long)b * n;

  // acc = rows(ti) x cols(tj)^T over d
  auto product = [&](const float* rows, const float* cols, int tj,
                     float (&acc)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += FK) {
      for (int idx = threadIdx.x; idx < FT * FK; idx += FTHREADS) {
        const int r = idx / FK, kk = idx % FK;
        const int gi = ti * FT + r, gj = tj * FT + r;
        as[kk][r] = gi < n ? rows[(vb + gi) * d + k0 + kk] : 0.0f;
        bs[kk][r] = gj < n ? cols[(vb + gj) * d + k0 + kk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = as[kk][4 * ty + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = bs[kk][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
      }
      __syncthreads();
    }
  };

  float sacc[4][4];
  if constexpr (MODE == STATS) {
    float m_run[4], l_run[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m_run[r] = -CUDART_INF_F, l_run[r] = 0.0f;
    for (int tj = 0; tj < n_t; ++tj) {
      product(q, k, tj, sacc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tj * FT + tx + 16 * c < n) tmax = fmaxf(tmax, sacc[r][c]);
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(m_run[r], tmax * scale_log2);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tj * FT + tx + 16 * c < n)
            sum += exp2f(fmaf(sacc[r][c], scale_log2, -m_new));
        l_run[r] = l_run[r] * exp2f(m_run[r] - m_new) + sum;
        m_run[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float l = l_run[r];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
      const int row = ti * FT + 4 * ty + r;
      if (tx == 0 && row < n) lse[vb + row] = (m_run[r] + log2f(l)) * LN2;
    }
    return;
  } else {
    const int tj = blockIdx.x;
    float dpacc[4][4];
    product(q, k, tj, sacc);
    if constexpr (MODE == GRADS) product(dout, v, tj, dpacc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ti * FT + 4 * ty + r;
      if (row >= n) continue;
      const float lr = lse[vb + row] * LOG2E;
      const float dr = MODE == GRADS ? delta[vb + row] : 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tj * FT + tx + 16 * c;
        if (col >= n) continue;
        const float p = exp2f(fmaf(sacc[r][c], scale_log2, -lr));
        p_out[row * ld + col] = p;
        if constexpr (MODE == GRADS)
          ds_out[row * ld + col] = p * (dpacc[r][c] - dr) * scale;
      }
    }
  }
}

// delta[row] = sum over d of dO[row] * o[row] in float32, a warp a row
template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void k5_rowdot_kernel(const T* __restrict__ dout,
                                 const T* __restrict__ o,
                                 float* __restrict__ delta, long long rows,
                                 int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32)
    sum = fmaf(to_f(dout[row * d + c]), to_f(o[row * d + c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// the 3D map [B, N, d] of a bf16 operand, 128 x 64 boxes, 128B swizzle;
// coordinates past N or d read zeros
CUresult encode_operand(EncodeTiled encode, CUtensorMap* map, const void* x,
                        int nb, int n, int d) {
  const cuuint64_t dim[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)nb};
  const cuuint64_t stride[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
                dim, stride, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int MODE>
int launch_bf16(EncodeTiled encode, const void* q, const void* k,
                const void* dout, const void* v, float* lse,
                const float* delta, void* p, void* ds, long long ld, int nb,
                int n, int d, int view, float scale_log2, float scale,
                cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        k5_scores_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  CUtensorMap mq, mk, mdo, mv;
  CUresult r = encode_operand(encode, &mq, q, nb, n, d);
  if (r == CUDA_SUCCESS) r = encode_operand(encode, &mk, k, nb, n, d);
  if (r == CUDA_SUCCESS && MODE == GRADS)
    r = encode_operand(encode, &mdo, dout, nb, n, d);
  if (r == CUDA_SUCCESS && MODE == GRADS)
    r = encode_operand(encode, &mv, v, nb, n, d);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  if (MODE != GRADS) mdo = mq, mv = mk;
  const long long n_t = (n + BM - 1) / BM;
  dim3 grid;
  if (MODE == STATS) {
    grid = dim3((unsigned)n_t, (unsigned)nb);
  } else {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const long long tiles = n_t * n_t;
    grid = dim3((unsigned)(tiles < sms ? tiles : sms));
  }
  k5_scores_kernel<MODE><<<grid, THREADS, SMEM, stream>>>(
      mq, mk, mdo, mv, lse, delta, static_cast<__nv_bfloat16*>(p),
      static_cast<__nv_bfloat16*>(ds), ld, n, d, view, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_f32(const void* q, const void* k, const void* dout, const void* v,
               float* lse, const float* delta, void* p, void* ds,
               long long ld, int nb, int n, int d, int view, float scale_log2,
               float scale, cudaStream_t stream) {
  const unsigned n_t = (unsigned)((n + FT - 1) / FT);
  const dim3 grid = MODE == STATS ? dim3(n_t, (unsigned)nb) : dim3(n_t, n_t);
  k5_scores_f32_kernel<MODE><<<grid, FTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(dout), static_cast<const float*>(v), lse,
      delta, static_cast<float*>(p), static_cast<float*>(ds), ld, n, d, view,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of k5_scores: mode 0 STATS (writes lse for every view), 1
// PROBS (p of `view`), 2 GRADS (p and ds of `view`). Returns 0, a
// cudaError, 10000 + the CUresult of a failed tensor-map encoding, or -1
// for arguments outside the kernel's contract.
extern "C" int k5_scores(void* encode_tiled, int mode, int bf16,
                         const void* q, const void* k, const void* dout,
                         const void* v, void* lse, const void* delta, void* p,
                         void* ds, long long ld, int nb, int n, int d,
                         int view, float scale_log2, float scale,
                         void* stream) {
  if (d < 32 || d > 512 || d % 32 || n < 1 || nb < 1 || nb > 65535 ||
      ld < n || ld % 8 || view < 0 || view >= nb || mode < 0 || mode > 2 ||
      (long long)(n + BM - 1) / BM > 65535)
    return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (bf16) {
    const auto enc = reinterpret_cast<EncodeTiled>(encode_tiled);
    switch (mode) {
      case STATS:
        return launch_bf16<STATS>(enc, q, k, dout, v, l, dl, p, ds, ld, nb, n,
                                  d, view, scale_log2, scale, st);
      case PROBS:
        return launch_bf16<PROBS>(enc, q, k, dout, v, l, dl, p, ds, ld, nb, n,
                                  d, view, scale_log2, scale, st);
      default:
        return launch_bf16<GRADS>(enc, q, k, dout, v, l, dl, p, ds, ld, nb, n,
                                  d, view, scale_log2, scale, st);
    }
  }
  switch (mode) {
    case STATS:
      return launch_f32<STATS>(q, k, dout, v, l, dl, p, ds, ld, nb, n, d,
                               view, scale_log2, scale, st);
    case PROBS:
      return launch_f32<PROBS>(q, k, dout, v, l, dl, p, ds, ld, nb, n, d,
                               view, scale_log2, scale, st);
    default:
      return launch_f32<GRADS>(q, k, dout, v, l, dl, p, ds, ld, nb, n, d,
                               view, scale_log2, scale, st);
  }
}

// delta = rowsum(dO * o) over `rows` rows of d, float32
extern "C" int k5_rowdot(int bf16, const void* dout, const void* o,
                         void* delta, long long rows, int d, void* stream) {
  if (rows < 1 || d < 1) return -1;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  const auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  if (bf16)
    k5_rowdot_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<const __nv_bfloat16*>(o), out, rows, d);
  else
    k5_rowdot_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(o), out,
        rows, d);
  return static_cast<int>(cudaGetLastError());
}
