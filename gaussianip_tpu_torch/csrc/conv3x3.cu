// K3: stride-1 SAME 3x3 convolution for Hopper (sm_90a), bf16 in, f32
// accumulation, bf16 out.
//
// Replaces gaussianip_tpu/ops/conv_pallas.py:_kernel (pallas_call in
// _conv3x3_pallas), the fused 3x3 conv of every ResnetBlock and Upsample of
// the UNet / ControlNet denoise.
//
//   x  [B, H, W, Ci]  bf16 (a channels_last NCHW tensor's memory)
//   w  packed bf16, one layout per variant (ops/conv3x3_cuda.py:pack_weight)
//   b  [Co]           f32 or NULL, added to the f32 sum before rounding
//   y  [B, H, W, Co]  bf16
//
// An implicit GEMM: M = B*H*W output pixels, N = Co, K = 9*Ci. At the
// stage-1 shapes (batch 12, Ci, Co 320..2560) it is bound by operations on
// the tensor cores (~1,700 FLOP per byte moved, far above the H100's ~295).
// Two variants, chosen by ops/conv3x3_cuda.py:k3_variant and never standing
// in for each other:
//   - conv3x3_wgmma_kernel (below, "hopper"), for Ci a multiple of 64: every
//     SD1.5 conv of the guided step.
//   - conv3x3_kernel ("general"), for the other Ci, multiples of 8.
//
// The general variant, w [9 * Ci, Co] (HWIO flattened, row
// (dy * 3 + dx) * Ci + ci). The design is the simple one: a 128x128 output
// tile per CTA of 8 warps, K-steps of 32 through a two-stage cp.async ring
// in shared memory, and
// nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators (each warp a
// 32x64 sub-tile, 2x4 fragments). The im2col is never materialised: each
// 16-byte vector of the A tile is 8 channels of one tap of one pixel,
// loaded straight from x, and SAME padding is a predicated zero-fill of
// that load (cp.async with src-size 0), so no padded copy of x exists.
// Ci and Co must be multiples of 8, so that a vector never straddles a tap
// or the edge of a row.

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

// ---------------------------------------------------------------------------
// The Hopper variant: an implicit GEMM on wgmma fed by TMA.
//
//   w [Co, 9 * Ci] bf16 (OHWI flattened: column (dy * 3 + dx) * Ci + ci),
//   K-major, the wgmma B operand as it lies.
//
// One CTA computes a BM x BN tile of y (BM = 128 output pixels, BN = 128,
// 160 or 256 channels, chosen per shape by ops/conv3x3_cuda.py:k3_plan) over
// a range of K-steps. A K-step is one tap (dy, dx) and 64 channels: every
// Ci is a multiple of 64, so 64 bf16 = 128 B is exactly one 128B-swizzle
// row and a step never straddles a tap.
//   - A (activations): one TMA load per step of a tiled 4D box over
//     x [B, H, W, Ci]: 64 channels x (bw, bh, bb) pixels, whole output rows
//     where a row fits (2 x 64 at 64^2, 4 x 32, 8 x 16, 2 images x 8 x 8),
//     at the tile's origin shifted by (dx - 1, dy - 1). SAME padding costs
//     no code: TMA fills the coordinates that fall outside the tensor with
//     zeros. The box lands as 128-B rows in the order of the tile's pixels,
//     so it is the K-major 128B-swizzled A tile wgmma reads.
//   - B (weights): one TMA load per step of a 2D box, 64 x BN, of w.
//   - Warp specialisation, 384 threads: warpgroup 2 is the producer (one
//     thread keeps a ring of 4-6 stages of (A, B) in flight, mbarrier full /
//     empty pairs; setmaxnreg gives its registers away), warpgroups 0 and 1
//     consume: each runs wgmma.mma_async m64nBNk16 on its 64 rows of A
//     and all of B, f32 accumulators in registers, one wgmma group in flight
//     while the stage before it is released.
//   - Epilogue: bias added to the f32 sum, one round to bf16, staged in the
//     idle ring and stored 16 bytes per lane, masked at the ragged M and N
//     edges. With a K split (the 8^2 shapes, where M = 768 gives only 30-60
//     tiles) each split stores f32 partials and splitk_sum_kernel adds them,
//     adds the bias and rounds once.
// Settled faults to keep in mind:
//   - mbarrier parity: a consumer waits on full[s] with the parity of its
//     pass over the ring; the producer waits on empty[s] with the opposite
//     parity, so its first pass goes through. A wait that lasts seconds
//     traps instead of hanging the card.
//   - The accumulators are never zero-filled: ptxas serializes every wgmma
//     (warning C7515) when another instruction writes them. The first k16
//     of a tile uses scale-d 0 instead.
//   - wgmma descriptors for 128B swizzle: stage buffers are 1024-B aligned,
//     SBO = 1024 B (8 rows of 128 B), LBO unused, and a k16 sub-step inside
//     the 128-B row adds 32 B to the start address.
//   - Tensor maps: 16-B aligned base, strides multiples of 16 B, box
//     dimensions at most 256; encoded per call on the host (microseconds).
//     The encoder is libcuda's cuTensorMapEncodeTiled, passed in as an
//     address by the wrapper, so the library needs no -lcuda.

#include "hopper.cuh"

namespace hopper {

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      220 * 1024 / STAGE < 6 ? 220 * 1024 / STAGE : 6;
  // ring, then the full and empty barriers, plus room to align to 1024 B
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(BM * (BN + 8) * 2 <= STAGES * STAGE,
                "the epilogue's staging fits in the ring");
};

// d[0 .. N/2) = A (64 x 16, K-major, descriptor da) x B (16 x N, K-major,
// descriptor db) + (scale_d ? d : 0); one instruction per N, its operands
// written out
__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n160(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 256) {
    wgmma_m64n256(d, da, db, scale_d);
  } else if constexpr (BN == 160) {
    wgmma_m64n160(d, da, db, scale_d);
  } else {
    static_assert(BN == 128, "BN is 128, 160 or 256");
    wgmma_m64n128(d, da, db, scale_d);
  }
}

// the flat pixel index (b * H + y) * W + x of row r of the tile whose box
// starts at (x0, y0, b0), or -1 where the row lies outside the image
__device__ __forceinline__ long long tile_pixel(int r, int x0, int y0, int b0,
                                                int bw, int bh, int bb, int nb,
                                                int h, int wd) {
  const int xi = r % bw, yi = r / bw % bh, bi = r / (bw * bh);
  const int xx = x0 + xi, yy = y0 + yi, b = b0 + bi;
  if (bi >= bb || xx >= wd || yy >= h || b >= nb) return -1;
  return ((long long)b * h + yy) * wd + xx;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part, int nb, int h, int wd,
                         int ci, int co, int bw, int bh, int bb) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const uint32_t bars = base + T::STAGES * T::STAGE;

  // this CTA's N tile, M tile (one box of output pixels) and K-steps. N
  // tiles run fastest, so that the CTAs in flight share their A boxes in
  // L2 (x outgrows L2 at 32^2 with Ci = 1920: 47 MB)
  const int tiles_x = (wd + bw - 1) / bw, tiles_y = (h + bh - 1) / bh;
  const int x0 = (blockIdx.y % tiles_x) * bw;
  const int y0 = (blockIdx.y / tiles_x % tiles_y) * bh;
  const int b0 = (blockIdx.y / (tiles_x * tiles_y)) * bb;
  const int n0 = blockIdx.x * BN;
  const int cblocks = ci / BK;
  const int ksteps = 9 * cblocks;
  const int k_lo = (int)((long long)ksteps * blockIdx.z / gridDim.z);
  const int k_hi = (int)((long long)ksteps * (blockIdx.z + 1) / gridDim.z);
  const int n_it = k_hi - k_lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                 // the producer's arrive
      mbar_init(bars + 8 * (T::STAGES + s), 2);   // one per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      const uint32_t bytes = bw * bh * bb * BK * 2 + T::B_BYTES;
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_it; ++it) {
        mbar_wait(bars + 8 * (T::STAGES + s), phase ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t sa = base + s * T::STAGE;
        mbar_expect_tx(full, bytes);
        const int k = k_lo + it, tap = k / cblocks;
        tma_load_4d(sa, &map_x, full, (k - tap * cblocks) * BK,
                    x0 + tap % 3 - 1, y0 + tap / 3 - 1, b0);
        tma_load_2d(sa + A_BYTES, &map_w, full, k * BK, n0);
        if (++s == T::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of the tile
    reg_alloc<232>();
    // no zero fill: the first k16 of the first step overwrites d
    // (scale-d 0), so that no other instruction writes the accumulators
    // while wgmma groups are in flight
    float d[BN / 2];
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_it; ++it) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t sa = base + s * T::STAGE;
      const uint64_t da = sw128_desc(sa + wg * 64 * BK * 2);
      const uint64_t db = sw128_desc(sa + A_BYTES);
      fence_acc<BN / 2>(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_tile<BN>(d, da + 2 * kk, db + 2 * kk,  // +32 B per k16
                       it > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's group has read its stage
      fence_acc<BN / 2>(d);
      if (it > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(bars + 8 * (T::STAGES + prev));
      prev = s;
      if (++s == T::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(d);

    // accumulator layout of m64nN: register 4 i + 2 j + e holds row
    // 16 warp + lane / 4 + 8 j, column 8 i + 2 (lane % 4) + e
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r_base = wg * 64 + (t / 32) * 16 + lane / 4;
    const int c_base = 2 * (lane % 4);
    if (part != nullptr) {
      // one split of K: f32 partial sums, no bias
      float* p = part + (size_t)blockIdx.z * nb * h * wd * co;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long m =
            tile_pixel(r_base + 8 * j, x0, y0, b0, bw, bh, bb, nb, h, wd);
        if (m < 0) continue;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int n = n0 + 8 * i + c_base;
          if (n < co)
            *reinterpret_cast<float2*>(p + m * co + n) =
                make_float2(d[4 * i + 2 * j], d[4 * i + 2 * j + 1]);
        }
      }
      return;
    }
    named_bar_sync(1, 256);  // both consumer groups are done with the ring
    constexpr int LD = BN + 8;  // padded rows against bank conflicts
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + c_base;
      float b0v = 0.0f, b1v = 0.0f;
      if (bias != nullptr && n0 + c < co) {
        b0v = bias[n0 + c];
        b1v = bias[n0 + c + 1];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<__nv_bfloat162*>(st + (r_base + 8 * j) * LD + c) =
            __floats2bfloat162_rn(d[4 * i + 2 * j] + b0v,
                                  d[4 * i + 2 * j + 1] + b1v);
    }
    named_bar_sync(2 + wg, 128);
    constexpr int CH = BN / 8;  // 16-byte vectors per row
    for (int idx = t; idx < 64 * CH; idx += 128) {
      const int r = wg * 64 + idx / CH, c = (idx % CH) * 8;
      const long long m = tile_pixel(r, x0, y0, b0, bw, bh, bb, nb, h, wd);
      if (m >= 0 && n0 + c < co)
        *reinterpret_cast<uint4*>(y + m * co + n0 + c) =
            *reinterpret_cast<const uint4*>(st + r * LD + c);
    }
  }
}

// y = round(sum of the splits' partials + bias), 8 channels per thread
__global__ void splitk_sum_kernel(const float* __restrict__ part,
                                  const float* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ y,
                                  long long total, int co, int splits) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (e >= total) return;
  float acc[8] = {};
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part + s * total + e);
    const float4 u = p[0], v = p[1];
    acc[0] += u.x, acc[1] += u.y, acc[2] += u.z, acc[3] += u.w;
    acc[4] += v.x, acc[5] += v.y, acc[6] += v.z, acc[7] += v.w;
  }
  const int n = (int)(e % co);
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k] = __float2bfloat16(acc[k] + (bias != nullptr ? bias[n + k] : 0.0f));
  *reinterpret_cast<uint4*>(y + e) = *reinterpret_cast<const uint4*>(out);
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* bias,
           __nv_bfloat16* y, float* part, int nb, int h, int wd, int ci,
           int co, int bw, int bh, int bb, dim3 grid, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BN>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  conv3x3_wgmma_kernel<BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      mx, mw, bias, y, part, nb, h, wd, ci, co, bw, bh, bb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

// the dynamic shared memory of the instantiation for BN: its ring of
// stages, the barriers and the alignment slack
extern "C" int conv3x3_hopper_smem(int bn) {
  switch (bn) {
    case 256:
      return hopper::Tile<256>::SMEM;
    case 160:
      return hopper::Tile<160>::SMEM;
    case 128:
      return hopper::Tile<128>::SMEM;
    default:
      return -1;
  }
}

// Returns 0, a cudaError, 10000 + the CUresult of a failed tensor-map
// encoding, or -1 for arguments outside the kernel's contract.
extern "C" int conv3x3_hopper_fwd(void* encode_tiled, const void* x,
                                  const void* w, const void* bias, void* y,
                                  void* part, int nb, int h, int wd, int ci,
                                  int co, int bn, int bw, int bh, int bb,
                                  int splits, void* stream) {
  namespace hp = hopper;
  if (ci % hp::BK || co % 8 || bw * bh * bb > hp::BM || bw > 256 ||
      bh > 256 || bb > 256 || splits < 1 || splits > 9 * ci / hp::BK ||
      (splits > 1 && part == nullptr))
    return -1;
  const auto encode = reinterpret_cast<hp::EncodeTiled>(encode_tiled);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap mx, mw;
  const cuuint64_t x_dim[4] = {(cuuint64_t)ci, (cuuint64_t)wd, (cuuint64_t)h,
                               (cuuint64_t)nb};
  const cuuint64_t x_stride[3] = {(cuuint64_t)ci * 2, (cuuint64_t)wd * ci * 2,
                                  (cuuint64_t)h * wd * ci * 2};
  const cuuint32_t x_box[4] = {hp::BK, (cuuint32_t)bw, (cuuint32_t)bh,
                               (cuuint32_t)bb};
  CUresult r = encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(x), x_dim, x_stride, x_box, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  const cuuint64_t w_dim[2] = {(cuuint64_t)9 * ci, (cuuint64_t)co};
  const cuuint64_t w_stride[1] = {(cuuint64_t)9 * ci * 2};
  const cuuint32_t w_box[2] = {hp::BK, (cuuint32_t)bn};
  r = encode(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             w_dim, w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);

  const long long m_tiles = (long long)((wd + bw - 1) / bw) *
                            ((h + bh - 1) / bh) * ((nb + bb - 1) / bb);
  if (m_tiles > 65535) return -1;  // gridDim.y
  const dim3 grid((unsigned)((co + bn - 1) / bn), (unsigned)m_tiles,
                  (unsigned)splits);
  const auto st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  auto* out = static_cast<__nv_bfloat16*>(y);
  float* p = splits > 1 ? static_cast<float*>(part) : nullptr;
  int err;
  switch (bn) {
    case 256:
      err = hp::launch<256>(mx, mw, b, out, p, nb, h, wd, ci, co, bw, bh, bb,
                            grid, st);
      break;
    case 160:
      err = hp::launch<160>(mx, mw, b, out, p, nb, h, wd, ci, co, bw, bh, bb,
                            grid, st);
      break;
    case 128:
      err = hp::launch<128>(mx, mw, b, out, p, nb, h, wd, ci, co, bw, bh, bb,
                            grid, st);
      break;
    default:
      return -1;
  }
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)nb * h * wd * co;
  const unsigned blocks = (unsigned)((total / 8 + 255) / 256);
  hp::splitk_sum_kernel<<<blocks, 256, 0, st>>>(p, b, out, total, co, splits);
  return static_cast<int>(cudaGetLastError());
}
