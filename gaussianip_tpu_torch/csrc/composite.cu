// Tile compositor for differentiable Gaussian splatting on Hopper (sm_90a).
//
// K1 composite_fwd replaces gaussianip_tpu/render/composite_pallas.py
//    _fwd_kernel (_fwd_tile_stream / _chunk_alphas, pallas_call in _fwd_call).
// K2 composite_bwd replaces gaussianip_tpu/render/composite_pallas.py
//    _bwd_kernel (pallas_call in _bwd_call; VJP of composite_tiles) and, fused
//    into its epilogue, the per-instance -> per-gaussian reduction that the
//    JAX package leaves to autograd of the attribute gather (a scatter-add,
//    gaussianip_tpu/render/render.py).
//
// Layout (shared with the Python wrappers in render/composite_cuda.py):
//   data    [B, 16, E] f32: rows 0-5 power coefficients a0 ax ay axx axy ayy
//           of the tile-local pixel coords, rows 8-12 the features
//           r g b depth 1; other rows are not read.
//   starts, counts [B, NT] i32: unaligned depth-sorted segment per tile.
//   order   [B * NT] i32: segment (b * NT + t) taken by CTA i.
//   out     [B, NT, 8, 256] f32: rows 0-2 rgb, 3 alpha-weighted depth,
//           4 alpha, 5 last contributor, 6-7 zero. Row 5 is the index of the
//           last contributing instance RELATIVE TO THE SEGMENT START (-1 if
//           none); only K2 reads it.
//   gout    [B, NT, 8, 256] f32 (rows 0-4 are read).
//   packed  [B, N, 10] f32 per-gaussian attributes: mean2d 0-1, conic 2-4,
//           opacity 5, colour 6-8, depth 9. data's rows 0-5 of an instance
//           of gaussian g in tile t are gaussian_power_coeffs(mean2d - the
//           tile's origin, conic, opacity), rows 8-11 colour and depth.
//   gidx    [B, E] i64: the gaussian of each instance.
//   dpacked [B, N, 10] f32, zeroed by the wrapper: K2 adds the gradient of
//           every instance up to its tile's last contributor, through the
//           pack, with global atomics.
//
// Semantics (as the Pallas kernels and the CUDA rasterizer): alpha =
// min(exp(power), 0.99); alpha < 1/255 is skipped, decided on the power:
// power < ln(1/255) in float32, the power evaluated as
// (a0 + x (ax + x axx)) + y ((ay + x axy) + y ayy) with one rounding per
// operation (no FMA), so that the plain versions, which evaluate it so,
// make the same decision at every pixel; an instance whose
// inclusion would drop T below 1e-4 is dropped with everything behind it;
// the gradient of alpha is NOT gated at the 0.99 cap (dpower = dalpha*raw);
// K2 rebuilds T from T_stop = 1 - alpha_out.
//
// What bounds them on the H100: per (instance, pixel) pair K1 does 23 f32
// operations (an FMA counts 2) with one exp, K2 44 with one exp, a
// reciprocal and its share of the reduction of 10 gradient terms per
// instance over the tile (itemised in chip_smoke.py). The bytes are
// ~44 B per instance read and 8 KB of output per tile (K2: 32 B of gather
// and 40 B of atomics per instance besides), so both are bound by
// operations on live pairs. A one-pixel-per-thread design is bound instead
// by the shared-memory and shuffle pipe (one instruction per SM and
// cycle): 11 scalar broadcast loads per pair, and in K2 a 55-shuffle
// butterfly and 11 partial stores per instance and warp.
//
// What the design does about it:
// - Warps are independent: warp w of a tile's CTA owns 2 * PPT rows of it
//   (PPT pixels per thread, lane l at x = l % 16, rows l / 16 + 2 i), stages
//   its own batches of 32 instances (one per lane, coalesced loads from
//   the [B, 16, E] rows) in shared memory, and never waits for another warp.
//   PPT is K1_PPT = 2 for K1 and K2_PPT = 4 for K2: the fastest of 1, 2, 4
//   and 8 at the stage-1 shapes on an H100 (PERF.md).
// - Staging keeps only the instances whose alpha can reach 1/255 on the
//   warp's rows (reaches_rows, exact) and compacts them, so neither kernel
//   spends a pixel iteration on an instance that misses the warp.
// - CTAs take the tiles in the order the wrapper gives: the longest
//   segments first, so they do not run last.
// - Each staged instance is one 48 B record, read with 3 vector loads per
//   thread and reused for the thread's PPT pixels from registers. alpha is
//   one ex2.approx of the power times log2(e); 1 / (1 - alpha) is one
//   rcp.approx (both PTX, so the build flags, shared with conv3x3.cu, stay
//   as they are). K1 and K2 evaluate the power with the same code, so the
//   backward sees the forward's gates.
// - The power is u + y (v + y ayy) with u, v per thread and instance, since
//   a thread's pixels share x: 2 multiplies and 2 adds per pixel, each
//   rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction, which
//   the plain versions could not reproduce). K2 sums dpower, dpower y
//   and dpower y^2 over the thread's pixels and forms the six coefficient
//   terms (1, x, y, x^2, xy, y^2) once per instance.
// - K1 leaves the segment once no pixel of the warp is live (__all_sync
//   every 8 instances); K2 walks back only from the warp's last contributor.
// - K2 reduces the terms of 3 instances (3 x 10 = 30 of 32 slots) with a
//   transposed (reduce-scatter) butterfly: 31 shuffles, after which lane L
//   holds the warp's total of slot L = 10 * instance + term. The epilogue
//   applies the VJP of gaussian_power_coeffs (the instance's mean2d,
//   conic and opacity gathered from packed at staging) and adds the 30
//   terms with one warp-wide scalar atomicAdd into three 40 B rows of
//   dpacked, in place of a [B, 16, E] dgrad buffer and a scatter-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels per tile
constexpr int BATCH = 32;       // instances staged per warp and round
constexpr int NTERM = 10;       // gradient terms per instance, term q for
                                // column q of packed: the VJP of the 6
                                // coefficients gives mean2d, conic and
                                // opacity; then r g b depth (the constant
                                // feature 1 takes none)
constexpr int GROUP = 3;        // instances per transposed reduction
constexpr int K1_PPT = 2;       // pixels per thread of K1
constexpr int K2_PPT = 4;       // and of K2
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float LOG2E = 1.4426950408889634f;
// ln(1/255) in float32 (composite_cuda.py's LOG_ALPHA_MIN): the 1/255 gate
constexpr float LOG_ALPHA_MIN = -5.5412636f;

// One staged instance: the power coefficients, then the features.
struct __align__(16) Inst {
  float4 c;   // a0 ax ay axx
  float4 cf;  // axy ayy r g
  float4 f;   // b depth 1, the instance's index in its segment (int bits)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ Inst load_inst(const float* __restrict__ col,
                                          long long e) {
  Inst v;
  v.c = make_float4(col[0], col[e], col[2 * e], col[3 * e]);
  v.cf = make_float4(col[4 * e], col[5 * e], col[8 * e], col[9 * e]);
  v.f = make_float4(col[10 * e], col[11 * e], col[12 * e], 0.f);
  return v;
}

// Whether alpha can reach 1/255 on a row y in [ylo, yhi] (any x): the
// maximum over x of the power is a y^2 + b y + c; a 1-pixel margin covers
// f32 rounding. Conservative: degenerate coefficients are kept.
__device__ __forceinline__ bool reaches_rows(const Inst& q, float ylo,
                                             float yhi) {
  const float c3 = q.c.w;
  if (!(c3 < 0.f)) return true;
  const float k = 0.25f / c3;
  const float a = q.cf.y - q.cf.x * q.cf.x * k;
  if (!(a < 0.f)) return true;
  const float b = q.c.z - 2.0f * q.c.y * q.cf.x * k;
  const float c = q.c.x - q.c.y * q.c.y * k - LOG_ALPHA_MIN;
  const float disc = b * b - 4.0f * a * c;
  if (disc < 0.f) return false;
  const float yc = b / (-2.0f * a);
  const float h = sqrtf(disc) / (-2.0f * a) + 1.0f;
  return yc + h >= ylo && yc - h <= yhi;
}

// Stage the instances k0 .. k0 + n - 1 of the segment at `base` that can
// reach rows [ylo, yhi], in order, at the front of `dst` (each record's
// f.w holds its segment index). Returns the number staged; `slot` is this
// lane's record, -1 if its instance was culled or lies past n. The cull
// is exact: a culled instance has alpha < 1/255 at every pixel of the
// rows, so it changes no output.
__device__ __forceinline__ int stage_batch(Inst* dst, const float* base,
                                           long long e, int k0, int n,
                                           int lane, float ylo, float yhi,
                                           int& slot) {
  Inst v;
  bool keep = false;
  if (lane < n) {
    v = load_inst(base + k0 + lane, e);
    keep = reaches_rows(v, ylo, yhi);
  }
  const unsigned mask = __ballot_sync(FULL, keep);
  slot = -1;
  if (keep) {
    slot = __popc(mask & ((1u << lane) - 1u));
    v.f.w = __int_as_float(k0 + lane);
    dst[slot] = v;
  }
  return __popc(mask);
}

// The power (the log of the raw alpha) along the thread's column x:
// u + y (v + y ayy), one rounding per operation
struct Column {
  float u, v, w;
};

__device__ __forceinline__ Column column(const Inst& q, float x) {
  return {__fadd_rn(q.c.x, __fmul_rn(x, __fadd_rn(q.c.y, __fmul_rn(x, q.c.w)))),
          __fadd_rn(q.c.z, __fmul_rn(x, q.cf.x)), q.cf.y};
}

__device__ __forceinline__ float power(const Column& c, float y) {
  return __fadd_rn(c.u, __fmul_rn(y, __fadd_rn(c.v, __fmul_rn(y, c.w))));
}

// One step of the transposed reduction: a lane keeps the half of its H
// live slots that its bit H selects and adds that half from lane ^ H.
template <int H>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

// Warp sum of 32 slots, transposed: lane L returns the total of slot L.
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(32 * (8 / K1_PPT))
composite_fwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ order, float* __restrict__ out,
                     int nt, long long e) {
  constexpr int PPT = K1_PPT;
  constexpr int W = 8 / PPT;  // warps per tile
  const int lane = threadIdx.x & 31;
  const int ws = threadIdx.x >> 5;
  const int seg = order[blockIdx.x];
  const int b = seg / nt;
  const int start = starts[seg];
  const int count = counts[seg];
  const float* base = data + (long long)b * 16 * e + start;
  const int p0 = ws * 32 * PPT + lane;  // pixel i is p0 + 32 i
  const float x = (float)(lane & 15);
  float y[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) y[i] = (float)((p0 >> 4) + 2 * i);

  __shared__ Inst s_inst[W][BATCH];

  float T[PPT], acc[PPT][5];
  int last[PPT];
  bool done[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.f;
    last[i] = -1;
    done[i] = false;
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[i][c] = 0.f;
  }
  bool warp_done = false;
  const float ylo = (float)(ws * 2 * PPT), yhi = ylo + (2 * PPT - 1);
  for (int k0 = 0; k0 < count && !warp_done; k0 += BATCH) {
    __syncwarp();  // the previous batch is consumed
    int slot;
    const int n = stage_batch(s_inst[ws], base, e, k0,
                              min(BATCH, count - k0), lane, ylo, yhi, slot);
    __syncwarp();
    for (int j = 0; j < n; ++j) {
      const Inst q = s_inst[ws][j];
      const Column c = column(q, x);
      const float f[5] = {q.cf.z, q.cf.w, q.f.x, q.f.y, q.f.z};
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float pw = power(c, y[i]);
        const float alpha = fminf(ex2(pw * LOG2E), ALPHA_MAX);
        const float test_T = T[i] * (1.0f - alpha);
        if (!done[i] && pw >= LOG_ALPHA_MIN) {
          if (test_T < T_EPS) {
            done[i] = true;
          } else {
            const float w = alpha * T[i];
#pragma unroll
            for (int ch = 0; ch < 5; ++ch)
              acc[i][ch] = fmaf(f[ch], w, acc[i][ch]);
            T[i] = test_T;
            last[i] = __float_as_int(q.f.w);
          }
        }
      }
      if ((j & 7) == 7) {
        bool mine = true;
#pragma unroll
        for (int i = 0; i < PPT; ++i) mine = mine && done[i];
        if (__all_sync(FULL, mine)) {
          warp_done = true;
          break;
        }
      }
    }
  }
  float* o = out + (long long)seg * 8 * P;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = p0 + 32 * i;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) o[ch * P + p] = acc[i][ch];
    o[5 * P + p] = (float)last[i];
    o[6 * P + p] = 0.f;
    o[7 * P + p] = 0.f;
  }
}

__global__ void __launch_bounds__(32 * (8 / K2_PPT))
composite_bwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ starts,
                     const int* __restrict__ order,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     const float* __restrict__ packed,
                     const long long* __restrict__ gidx,
                     float* __restrict__ dpacked, int nt, int ntx, long long e,
                     long long n_gauss) {
  constexpr int PPT = K2_PPT;
  constexpr int W = 8 / PPT;
  const int lane = threadIdx.x & 31;
  const int ws = threadIdx.x >> 5;
  const int seg = order[blockIdx.x];
  const int b = seg / nt;
  const int t = seg - b * nt;
  const int start = starts[seg];
  const float* base = data + (long long)b * 16 * e + start;
  const long long* gbase = gidx + (long long)b * e + start;
  const float* pk = packed + (long long)b * n_gauss * NTERM;
  float* dpk = dpacked + (long long)b * n_gauss * NTERM;
  const float ox = (float)((t % ntx) * TILE);
  const float oy = (float)((t / ntx) * TILE);
  const int p0 = ws * 32 * PPT + lane;
  const float x = (float)(lane & 15);
  float y[PPT], y2[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    y[i] = (float)((p0 >> 4) + 2 * i);
    y2[i] = y[i] * y[i];
  }

  const float* o = out + (long long)seg * 8 * P;
  const float* g = gout + (long long)seg * 8 * P;
  float gr[PPT][5], T[PPT], r[PPT];
  int last[PPT];
  int my_last = -1;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = p0 + 32 * i;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) gr[i][ch] = g[ch * P + p];
    last[i] = (int)o[5 * P + p];
    // T after the last contributor; the early stop keeps it >= 1e-4, so the
    // walk back divides by (1 - alpha) >= 0.01 without underflow
    T[i] = fmaxf(1.0f - o[4 * P + p], 1e-12f);
    r[i] = 0.f;  // sum over later contributors of (feat . gout) * w
    my_last = max(my_last, last[i]);
  }
  const int max_last = __reduce_max_sync(FULL, my_last);
  if (max_last < 0) return;

  __shared__ Inst s_inst[W][BATCH];
  // per staged instance: mean2d - tile origin, conic, 1 / opacity (0 under
  // the 1e-12 clamp), the gaussian's index
  __shared__ float4 s_ep[W][BATCH][2];

  // the slot this lane totals in the transposed reduction
  const int slot_inst = min(lane / NTERM, GROUP - 1);
  const int slot_term = lane - slot_inst * NTERM;
  const bool slot_live = lane < GROUP * NTERM;

  const float ylo = (float)(ws * 2 * PPT), yhi = ylo + (2 * PPT - 1);
  for (int k0 = (max_last / BATCH) * BATCH; k0 >= 0; k0 -= BATCH) {
    __syncwarp();  // the previous batch is consumed
    int slot;
    const int n = stage_batch(s_inst[ws], base, e, k0,
                              min(BATCH, max_last + 1 - k0), lane, ylo, yhi,
                              slot);
    if (slot >= 0) {
      const long long gi = gbase[k0 + lane];
      // a packed row starts at 40 * gi bytes: 8-byte aligned
      const float2* row = reinterpret_cast<const float2*>(pk + gi * NTERM);
      const float2 m = row[0], ab = row[1], co = row[2];
      s_ep[ws][slot][0] = make_float4(m.x - ox, m.y - oy, ab.x, ab.y);
      s_ep[ws][slot][1] = make_float4(
          co.x, co.y >= 1e-12f ? 1.0f / co.y : 0.f,
          __int_as_float((int)gi), 0.f);
    }
    __syncwarp();
    for (int jg = n - 1; jg >= 0; jg -= GROUP) {
      float v[32];
      bool any = false;
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        const int j = jg - s;
        float s0 = 0.f, sy = 0.f, syy = 0.f;
        float fr[4] = {0.f, 0.f, 0.f, 0.f};
        if (j >= 0) {
          const Inst q = s_inst[ws][j];
          const Column c = column(q, x);
          const float f[5] = {q.cf.z, q.cf.w, q.f.x, q.f.y, q.f.z};
          const int k = __float_as_int(q.f.w);
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float pw = power(c, y[i]);
            const float raw = ex2(pw * LOG2E);
            const float alpha = fminf(raw, ALPHA_MAX);
            if (k <= last[i] && pw >= LOG_ALPHA_MIN) {
              const float rom = rcp(1.0f - alpha);
              const float t_ex = T[i] * rom;
              const float w = alpha * t_ex;
              float t1 = f[0] * gr[i][0];
#pragma unroll
              for (int ch = 1; ch < 5; ++ch) t1 = fmaf(f[ch], gr[i][ch], t1);
              // not gated at the cap
              const float dp = (t1 * t_ex - r[i] * rom) * raw;
              r[i] = fmaf(t1, w, r[i]);
              T[i] = t_ex;
              s0 += dp;
              sy = fmaf(dp, y[i], sy);
              syy = fmaf(dp, y2[i], syy);
#pragma unroll
              for (int ch = 0; ch < 4; ++ch)
                fr[ch] = fmaf(gr[i][ch], w, fr[ch]);
              any = true;
            }
          }
        }
        // d coeff = sum over pixels of dpower * (1, x, y, x^2, xy, y^2)
        v[s * NTERM + 0] = s0;
        v[s * NTERM + 1] = x * s0;
        v[s * NTERM + 2] = sy;
        v[s * NTERM + 3] = (x * x) * s0;
        v[s * NTERM + 4] = x * sy;
        v[s * NTERM + 5] = syy;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) v[s * NTERM + 6 + ch] = fr[ch];
      }
      v[30] = 0.f;
      v[31] = 0.f;
      if (!__any_sync(FULL, any)) continue;
      const float tot = reduce_scatter(v, lane);
      // coefficient gradients of this lane's instance
      float gc[6];
#pragma unroll
      for (int q = 0; q < 6; ++q)
        gc[q] = __shfl_sync(FULL, tot, slot_inst * NTERM + q);
      const int j = jg - slot_inst;
      if (slot_live && j >= 0) {
        const float4 e0 = s_ep[ws][j][0];
        const float4 e1 = s_ep[ws][j][1];
        const float mx = e0.x, my = e0.y, ca = e0.z, cb = e0.w, cc = e1.x;
        // VJP of preprocess.gaussian_power_coeffs
        float d = tot;  // terms 6-9: colour and depth
        if (slot_term == 0)
          d = gc[1] * ca + gc[2] * cb - gc[0] * (ca * mx + cb * my);
        else if (slot_term == 1)
          d = gc[1] * cb + gc[2] * cc - gc[0] * (cc * my + cb * mx);
        else if (slot_term == 2)
          d = -0.5f * gc[0] * mx * mx + gc[1] * mx - 0.5f * gc[3];
        else if (slot_term == 3)
          d = -gc[0] * mx * my + gc[1] * my + gc[2] * mx - gc[4];
        else if (slot_term == 4)
          d = -0.5f * gc[0] * my * my + gc[2] * my - 0.5f * gc[5];
        else if (slot_term == 5)
          d = gc[0] * e1.y;
        if (d != 0.f)
          atomicAdd(dpk + (long long)__float_as_int(e1.z) * NTERM + slot_term,
                    d);
      }
    }
  }
}

}  // namespace

extern "C" {

int composite_fwd(const float* data, const int* starts, const int* counts,
                  const int* order, float* out, int b, int nt, long long e,
                  cudaStream_t stream) {
  if (b <= 0 || nt <= 0) return 0;
  composite_fwd_kernel<<<b * nt, 32 * (8 / K1_PPT), 0, stream>>>(
      data, starts, counts, order, out, nt, e);
  return (int)cudaGetLastError();
}

int composite_bwd(const float* data, const int* starts, const int* order,
                  const float* out, const float* gout, const float* packed,
                  const long long* gidx, float* dpacked, int b, int nt,
                  int ntx, long long e, long long n_gauss,
                  cudaStream_t stream) {
  if (b <= 0 || nt <= 0) return 0;
  composite_bwd_kernel<<<b * nt, 32 * (8 / K2_PPT), 0, stream>>>(
      data, starts, order, out, gout, packed, gidx, dpacked, nt, ntx, e,
      n_gauss);
  return (int)cudaGetLastError();
}

}  // extern "C"
