// K3: stride-1 SAME 3x3 convolution for Hopper (sm_90a), bf16 in, f32
// accumulation, bf16 out.
//
// Replaces gaussianip_tpu/ops/conv_pallas.py:_kernel (pallas_call in
// _conv3x3_pallas), the fused 3x3 conv of every ResnetBlock and Upsample of
// the UNet / ControlNet denoise.
//
//   x  [B, H, W, Ci]  bf16 (a channels_last NCHW tensor's memory)
//   w  [9 * Ci, Co]   bf16, row k = (dy * 3 + dx) * Ci + ci (HWIO flattened)
//   b  [Co]           f32 or NULL, added to the f32 sum before rounding
//   y  [B, H, W, Co]  bf16
//
// An implicit GEMM: M = B*H*W output pixels, N = Co, K = 9*Ci. At the
// stage-1 shapes (batch 12, Ci, Co 320..2560) it is bound by operations on
// the tensor cores (~1,700 FLOP per byte moved, far above the H100's ~295).
// The design is the simple one: a 128x128 output tile per CTA of 8 warps,
// K-steps of 32 through a two-stage cp.async ring in shared memory, and
// nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators (each warp a
// 32x64 sub-tile, 2x4 fragments). The im2col is never materialised: each
// 16-byte vector of the A tile is 8 channels of one tap of one pixel,
// loaded straight from x, and SAME padding is a predicated zero-fill of
// that load (cp.async with src-size 0), so no padded copy of x exists.
// Ci and Co must be multiples of 8, so that a vector never straddles a tap
// or the edge of a row. wgmma, TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // padded rows (80 B) against bank conflicts
constexpr int B_LD = BN + 8;  // 272 B
constexpr int A_STAGE = BM * A_LD;  // bf16 elements per stage
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = 2 * (A_STAGE + B_STAGE) * 2;  // 37,888 B
constexpr int WARP_M = 32, WARP_N = 64;  // 4 x 2 warps
constexpr int FM = WARP_M / 16, FN = WARP_N / 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int nb, int h, int wd,
                   int ci, int co) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + 2 * A_STAGE;

  const long long m_total = (long long)nb * h * wd;
  const int k_total = 9 * ci;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // A tile: each thread loads rows (tid / 4) and (tid / 4 + 64), the same
  // 8-channel k-vector (tid % 4) of both; their pixels are fixed for the
  // whole K loop
  const int a_kv = tid & 3;
  const int a_row = tid >> 2;
  int a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + a_row + 64 * i;
    a_ok[i] = m < m_total;
    const long long mm = a_ok[i] ? m : 0;
    a_x[i] = (int)(mm % wd);
    const long long r = mm / wd;
    a_y[i] = (int)(r % h);
    a_b[i] = (int)(r / h);
  }
  // B tile: rows (tid / 16) and (tid / 16 + 16), column vector tid % 16
  const int b_k = tid >> 4;
  const int b_nv = tid & 15;
  const int b_n = n0 + b_nv * 8;
  const bool b_nok = b_n < co;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    const int kk = k0 + a_kv * 8;
    const bool k_ok = kk < k_total;
    const int tap = k_ok ? kk / ci : 0;
    const int c = kk - tap * ci;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* dst_a = sa + stage * A_STAGE + a_row * A_LD + a_kv * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_ok[i] && k_ok && yy >= 0 && yy < h && xx >= 0 &&
                      xx < wd;
      const __nv_bfloat16* src =
          ok ? x + ((((long long)a_b[i] * h + yy) * wd + xx) * ci + c) : x;
      cp_async16(dst_a + 64 * i * A_LD, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = b_k + 16 * i;
      const int kg = k0 + kr;
      const bool ok = b_nok && kg < k_total;
      const __nv_bfloat16* src = ok ? w + ((long long)kg * co + b_n) : w;
      cp_async16(sb + stage * B_STAGE + kr * B_LD + b_nv * 8, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nk = (k_total + BK - 1) / BK;

  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage kt has landed; kt + 1 may be in flight
    __syncthreads();
    const __nv_bfloat16* a = sa + (kt & 1) * A_STAGE;
    const __nv_bfloat16* b = sb + (kt & 1) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * WARP_M + i * 16) * A_LD + ks,
                               A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + ks * B_LD + wn * WARP_N + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16x16 f32 fragment at a time in its own
  // 1 KB of the (now idle) ring, adds the bias, rounds to bf16 and writes
  // 8 channels (16 bytes) per lane
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int lane = tid & 31;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * WARP_M + i * 16 + r;
      const int n = n0 + wn * WARP_N + j * 16 + c0;
      if (m < m_total && n < co) {
        __align__(16) __nv_bfloat16 out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = scratch[r * 16 + c0 + e];
          if (bias != nullptr) v += bias[n + e];
          out[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(y + m * co + n) =
            *reinterpret_cast<const uint4*>(out);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int conv3x3_fwd(const void* x, const void* w, const void* bias,
                           void* y, int nb, int h, int wd, int ci, int co,
                           void* stream) {
  const long long m_total = (long long)nb * h * wd;
  dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), nb, h, wd, ci, co);
  return static_cast<int>(cudaGetLastError());
}
