// Tile compositor for differentiable Gaussian splatting on Hopper (sm_90a).
//
// K1 composite_fwd replaces gaussianip_tpu/render/composite_pallas.py
//    _fwd_kernel (_fwd_tile_stream / _chunk_alphas, pallas_call in _fwd_call).
// K2 composite_bwd replaces gaussianip_tpu/render/composite_pallas.py
//    _bwd_kernel (pallas_call in _bwd_call; VJP of composite_tiles).
//
// Layout (shared with the Python wrappers in render/composite_cuda.py):
//   data   [B, 16, E] f32: rows 0-5 power coefficients a0 ax ay axx axy ayy
//          of the tile-local pixel coords, rows 6-7 unused, rows 8-12 the
//          features r g b depth 1, rows 13-15 zero (not read).
//   starts, counts [B, NT] i32: unaligned depth-sorted segment per tile.
//   out    [B, NT, 8, 256] f32: rows 0-2 rgb, 3 alpha-weighted depth,
//          4 alpha, 5 last contributor, 6-7 zero. Row 5 is the index of the
//          last contributing instance RELATIVE TO THE SEGMENT START (-1 if
//          none); only K2 reads it.
//   gout   [B, NT, 8, 256] f32, dgrad [B, 16, E] f32 (pre-zeroed by the
//          wrapper; K2 writes rows 0-5 and 8-12 of instances up to the
//          tile's last contributor).
//
// Semantics (as the Pallas kernels and the CUDA rasterizer): alpha =
// min(exp(power), 0.99); alpha < 1/255 is skipped; an instance whose
// inclusion would drop T below 1e-4 is dropped with everything behind it;
// the gradient of alpha is NOT gated at the 0.99 cap (dpower = dalpha*raw).
//
// What bounds them on the H100: per (instance, pixel) pair K1 does ~20 f32
// operations and one exp, K2 ~40 operations, one exp and a divide plus the
// per-instance reduction over the tile's 256 pixels; the bytes are 44 B per
// instance read (64 B counted in the bound) and 8 KB of output per tile, so
// both are bound by operations on live pairs, not by bytes.
// What the design does about it: one CTA of 256 threads per (camera, tile),
// one thread per pixel, so each pair costs one thread-iteration with no
// padding to a matrix shape; each batch of instances is staged once in
// shared memory with coalesced loads (neighbouring threads read
// neighbouring instances of the [B, 16, E] layout) and then read as
// broadcasts; K1 leaves the segment as soon as no pixel of the tile is live
// (__syncthreads_count); K2 visits instances only up to the tile's last
// contributor, skips the reduction of an instance for a warp where no lane
// contributes, and reduces with warp shuffles then a shared-memory partial
// per warp. Every instance belongs to exactly one tile segment, so one CTA
// owns its dgrad columns: no atomics and no read-modify-write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels per tile == threads per CTA
constexpr int NWARP = P / 32;
constexpr int NCOEF = 6;
constexpr int NFEAT = 5;
constexpr int NGRAD = NCOEF + NFEAT;
constexpr int FWD_BATCH = 256;
constexpr int BWD_BATCH = 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(P)
composite_fwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, float* __restrict__ out,
                     int nt, long long e) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = threadIdx.x;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const long long seg = (long long)b * nt + t;
  const int start = starts[seg];
  const int count = counts[seg];
  const float* base = data + (long long)b * 16 * e + start;

  __shared__ float s_c[NCOEF][FWD_BATCH];
  __shared__ float s_f[NFEAT][FWD_BATCH];

  float T = 1.0f;
  float acc[NFEAT] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int last = -1;
  bool done = false;
  for (int k0 = 0; k0 < count; k0 += FWD_BATCH) {
    // barrier: the previous batch is consumed; leave once no pixel is live
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(FWD_BATCH, count - k0);
    if (p < n) {
#pragma unroll
      for (int r = 0; r < NCOEF; ++r) s_c[r][p] = base[r * e + k0 + p];
#pragma unroll
      for (int r = 0; r < NFEAT; ++r) s_f[r][p] = base[(8 + r) * e + k0 + p];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float power = s_c[0][j] + s_c[1][j] * x + s_c[2][j] * y +
                          s_c[3][j] * (x * x) + s_c[4][j] * (x * y) +
                          s_c[5][j] * (y * y);
      const float alpha = fminf(expf(power), ALPHA_MAX);
      if (alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < NFEAT; ++c) acc[c] += s_f[c][j] * w;
      T = test_T;
      last = k0 + j;
    }
  }
  float* o = out + seg * 8 * P + p;
#pragma unroll
  for (int c = 0; c < NFEAT; ++c) o[c * P] = acc[c];
  o[5 * P] = (float)last;
  o[6 * P] = 0.f;
  o[7 * P] = 0.f;
}

__global__ void __launch_bounds__(P)
composite_bwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ starts,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     float* __restrict__ dgrad, int nt, long long e) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const float fp[NCOEF] = {1.f, x, y, x * x, x * y, y * y};
  const long long seg = (long long)b * nt + t;
  const int start = starts[seg];
  const float* base = data + (long long)b * 16 * e + start;
  float* dbase = dgrad + (long long)b * 16 * e + start;
  const float* o = out + seg * 8 * P + p;
  const float* g = gout + seg * 8 * P + p;

  float gr[NFEAT];
#pragma unroll
  for (int c = 0; c < NFEAT; ++c) gr[c] = g[c * P];
  const int last = (int)o[5 * P];
  // T after the last contributor; the early stop keeps it >= 1e-4, so the
  // walk back divides by (1 - alpha) >= 0.01 without underflow
  float T = fmaxf(1.0f - o[4 * P], 1e-12f);
  float r = 0.f;  // sum over later contributors of (feat . gout) * w

  __shared__ int s_max_last;
  __shared__ float s_c[NCOEF][BWD_BATCH];
  __shared__ float s_f[NFEAT][BWD_BATCH];
  __shared__ float s_part[NWARP][BWD_BATCH][NGRAD];
  if (p == 0) s_max_last = -1;
  __syncthreads();
  atomicMax(&s_max_last, last);
  __syncthreads();
  const int max_last = s_max_last;
  if (max_last < 0) return;

  for (int k0 = (max_last / BWD_BATCH) * BWD_BATCH; k0 >= 0;
       k0 -= BWD_BATCH) {
    const int n = min(BWD_BATCH, max_last + 1 - k0);
    __syncthreads();  // the previous batch's staging and partials are read
    if (p < n) {
#pragma unroll
      for (int r2 = 0; r2 < NCOEF; ++r2) s_c[r2][p] = base[r2 * e + k0 + p];
#pragma unroll
      for (int r2 = 0; r2 < NFEAT; ++r2)
        s_f[r2][p] = base[(8 + r2) * e + k0 + p];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float v[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) v[q] = 0.f;
      bool contrib = false;
      if (k0 + j <= last) {
        const float power = s_c[0][j] + s_c[1][j] * x + s_c[2][j] * y +
                            s_c[3][j] * (x * x) + s_c[4][j] * (x * y) +
                            s_c[5][j] * (y * y);
        const float raw = expf(power);
        const float alpha = fminf(raw, ALPHA_MAX);
        if (alpha >= ALPHA_MIN) {
          contrib = true;
          const float om = 1.0f - alpha;
          const float t_ex = T / om;
          const float w = alpha * t_ex;
          float t1 = 0.f;
#pragma unroll
          for (int c = 0; c < NFEAT; ++c) t1 += s_f[c][j] * gr[c];
          const float dalpha = t1 * t_ex - r / om;
          const float dpower = dalpha * raw;  // not gated at the cap
          r += t1 * w;
          T = t_ex;
#pragma unroll
          for (int k = 0; k < NCOEF; ++k) v[k] = dpower * fp[k];
#pragma unroll
          for (int c = 0; c < NFEAT; ++c) v[NCOEF + c] = gr[c] * w;
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) s_part[warp][j][q] = v[q];
      }
    }
    __syncthreads();
    // sum the warp partials; neighbouring threads write neighbouring
    // instances of one dgrad row
    for (int idx = p; idx < n * NGRAD; idx += P) {
      const int q = idx / n;
      const int j = idx % n;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < NWARP; ++wi) s += s_part[wi][j][q];
      const int row = q < NCOEF ? q : 8 + (q - NCOEF);
      dbase[row * e + k0 + j] = s;
    }
  }
}

}  // namespace

extern "C" {

int composite_fwd(const float* data, const int* starts, const int* counts,
                  float* out, int b, int nt, long long e,
                  cudaStream_t stream) {
  if (b > 0 && nt > 0) {
    composite_fwd_kernel<<<dim3(nt, b), P, 0, stream>>>(data, starts, counts,
                                                       out, nt, e);
  }
  return (int)cudaGetLastError();
}

int composite_bwd(const float* data, const int* starts, const float* out,
                  const float* gout, float* dgrad, int b, int nt, long long e,
                  cudaStream_t stream) {
  if (b > 0 && nt > 0) {
    composite_bwd_kernel<<<dim3(nt, b), P, 0, stream>>>(
        data, starts, out, gout, dgrad, nt, e);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
