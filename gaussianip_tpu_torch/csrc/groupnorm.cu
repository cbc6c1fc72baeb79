// K4: GroupNorm with an optional SiLU fused in, forward and backward, for
// Hopper (sm_90a). Every GroupNorm of the VAE (diffusion/vae.py) runs it,
// through ops/groupnorm_cuda.py.
//
// It replaces no TPU kernel. The JAX package's FastGroupNorm
// (gaussianip_tpu/diffusion/norm.py) is a custom VJP that arranges the
// layout for XLA; written as eager PyTorch (diffusion/norm.py:group_norm,
// then F.silu) it is ~10 full-size passes forward, eight of them in
// float32 (~60 B an element), and autograd's backward walks ~25-35 more
// over float32 intermediates that it keeps.
//
//   x, y, dy, dx  [B, HW, C] in T = float or bf16 (NCHW tensors in
//                 channels_last memory)
//   w, bias       [C] f32
//   mean, rstd    [B, G] f32, G groups of C / G consecutive channels
//   part          [B, G, 2, NB] f32 partials of the NB blocks of an item
//   cpart         [B, NB, 2, C] f32 per-channel partials, or NULL
//
// Semantics, as the plain version: statistics in float32 over (pixels,
// channels of the group), var = E[x^2] - mean^2 clamped at 0, rstd =
// rsqrt(var + eps); a = ((x - mean) * rstd) * w + bias in float32 with one
// rounding per operation (no contraction, as the plain version's separate
// ops); y = T(a), and with the SiLU y = T(silu(T(a))) in float32. The
// backward keeps every term in float32 and rounds only dx to T:
//   g = dy * dsilu(T(a)) (or dy), dxhat = g * w,
//   dx = rstd * (dxhat - mean_G(dxhat) - xhat * mean_G(dxhat * xhat)),
//   dw = sum_{B,HW} g * xhat, dbias = sum_{B,HW} g.
//
// What bounds it on the H100: bytes. It does ~10 operations an element,
// against ~295 a byte at the ridge. A norm whose statistics span the
// whole image needs two passes unless the image stays on chip: the forward
// reads x twice and writes y (6 B an element in bf16), the backward reads
// x and dy twice and writes dx (10 B).
//
// What the design does about it:
// - Each pass streams [B, HW, C] once with 16-byte loads and stores. A
//   thread keeps one 16-byte column of channels for the whole pass, so its
//   channels' weight, bias and group statistics stay in registers.
// - The statistics passes keep per-channel float32 sums in registers,
//   reduce them over the block in shared memory and write one partial per
//   (block, group); the apply passes combine their batch item's partials,
//   a warp per group, in a fixed order. No atomics: reruns give the same
//   bits.
// - Nothing full-size is stored besides y and dx: the backward recomputes
//   xhat and the SiLU's input from x and the saved [B, G] mean and rstd.
// - The apply passes take the blocks in reverse order, so they first read
//   what the statistics pass read last, while it is still in L2.
// - The pixel split (ops/groupnorm_cuda.py:plan) gives every pass ~4
//   blocks an SM at every shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUPS = 512;

// 16 bytes of T as floats
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The thread's place in a block: a pixel row of `rows` a sweep, its 16-byte
// column `col` of the C / N columns, and the pixels [p0, p1) of block j.
struct Place {
  int rows, row, col, p0, p1;
  bool active;
};

template <int N>
__device__ __forceinline__ Place place(int c, int hw, int ppb, int j) {
  Place q;
  const int v = c / N;
  q.rows = THREADS / v;
  q.row = threadIdx.x / v;
  q.col = threadIdx.x % v;
  q.active = q.row < q.rows;
  q.p0 = j * ppb;
  q.p1 = min(hw, q.p0 + ppb);
  return q;
}

// xhat, as the plain version rounds it
__device__ __forceinline__ float normed(float x, float mu, float rs) {
  return __fmul_rn(__fsub_rn(x, mu), rs);
}

// the affine, as the plain version rounds it, then rounded to T where the
// plain version rounds it before its SiLU
template <typename T, bool SILU>
__device__ __forceinline__ float affine(float xh, float w, float b) {
  const float a = __fadd_rn(__fmul_rn(xh, w), b);
  return SILU ? Vec<T>::round(a) : a;
}

// dL/da from dL/dy at the SiLU's input a
template <bool SILU>
__device__ __forceinline__ float dact(float dy, float a) {
  if (!SILU) return dy;
  const float s = 1.f / (1.f + expf(-a));
  return dy * s * (1.f + a * (1.f - s));
}

// red[k][r * C + ch] (row r's sum of channel ch) -> red[k][ch], summed over
// the rows in order; a column is read and written by one thread alone
__device__ __forceinline__ void channel_sums(float* r0, float* r1, int rows,
                                             int c) {
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rows; ++r) {
      a += r0[r * c + ch];
      b += r1[r * c + ch];
    }
    r0[ch] = a;
    r1[ch] = b;
  }
}

// s0[gi], s1[gi] = the sums over the NB blocks of item b's partials
// part[b, gi, 0..1, :]: a warp per group, lanes in a fixed order, then a
// butterfly (every lane ends with the same bits)
__device__ __forceinline__ void combine(const float* __restrict__ part, int b,
                                        int g, int nb, float* s0, float* s1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int gi = warp; gi < g; gi += WARPS) {
    const float* p = part + (long long)(b * g + gi) * 2 * nb;
    float a = 0.f, q = 0.f;
    for (int k = lane; k < nb; k += 32) {
      a += p[k];
      q += p[nb + k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      s0[gi] = a;
      s1[gi] = q;
    }
  }
}

// Forward pass 1: per-(block, group) sum(x) and sum(x^2).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int hw,
                    int c, int g, int ppb) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][THREADS * N];
  const int j = blockIdx.x, nb = gridDim.x, b = blockIdx.y;
  const Place q = place<N>(c, hw, ppb, j);
  float s[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s2[i] = 0.f;
  if (q.active) {
    const T* xb = x + (long long)b * hw * c + q.col * N;
    int p = q.p0 + q.row;
    for (; p + 3 * q.rows < q.p1; p += 4 * q.rows) {
      uint4 u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = load16(xb + (long long)(p + k * q.rows) * c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[N];
        Vec<T>::unpack(u[k], v);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] += v[i];
          s2[i] = fmaf(v[i], v[i], s2[i]);
        }
      }
    }
    for (; p < q.p1; p += q.rows) {
      float v[N];
      Vec<T>::unpack(load16(xb + (long long)p * c), v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red[0][threadIdx.x * N + i] = s[i];
      red[1][threadIdx.x * N + i] = s2[i];
    }
  }
  __syncthreads();
  channel_sums(red[0], red[1], q.rows, c);
  __syncthreads();
  const int cpg = c / g;
  for (int gi = threadIdx.x; gi < g; gi += THREADS) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < cpg; ++k) {
      a += red[0][gi * cpg + k];
      a2 += red[1][gi * cpg + k];
    }
    float* o = part + (long long)(b * g + gi) * 2 * nb + j;
    o[0] = a;
    o[nb] = a2;
  }
}

// Forward pass 2: mean and rstd from the partials, then y.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ part,
                    const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ mean, float* __restrict__ rstd,
                    int hw, int c, int g, int ppb, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float st[2][MAX_GROUPS];
  const int nb = gridDim.x;
  const int j = nb - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  combine(part, b, g, nb, st[0], st[1]);
  __syncthreads();
  const int cpg = c / g;
  const float n = (float)hw * (float)cpg;
  for (int gi = threadIdx.x; gi < g; gi += THREADS) {
    const float mu = st[0][gi] / n;
    const float var = fmaxf(__fsub_rn(st[1][gi] / n, __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(var + eps);
    st[0][gi] = mu;
    st[1][gi] = rs;
    if (j == 0) {
      mean[b * g + gi] = mu;
      rstd[b * g + gi] = rs;
    }
  }
  __syncthreads();
  const Place q = place<N>(c, hw, ppb, j);
  if (!q.active) return;
  float mu[N], rs[N], wt[N], bs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ch = q.col * N + i, gi = ch / cpg;
    mu[i] = st[0][gi];
    rs[i] = st[1][gi];
    wt[i] = w[ch];
    bs[i] = bias[ch];
  }
  const long long base = (long long)b * hw * c + q.col * N;
  int p = q.p0 + q.row;
  for (; p + q.rows < q.p1; p += 2 * q.rows) {
    uint4 u[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      u[k] = load16(x + base + (long long)(p + k * q.rows) * c);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v[N];
      Vec<T>::unpack(u[k], v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float a =
            affine<T, SILU>(normed(v[i], mu[i], rs[i]), wt[i], bs[i]);
        v[i] = SILU ? a / (1.f + expf(-a)) : a;
      }
      *reinterpret_cast<uint4*>(y + base + (long long)(p + k * q.rows) * c) =
          Vec<T>::pack(v);
    }
  }
  for (; p < q.p1; p += q.rows) {
    float v[N];
    Vec<T>::unpack(load16(x + base + (long long)p * c), v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float a = affine<T, SILU>(normed(v[i], mu[i], rs[i]), wt[i], bs[i]);
      v[i] = SILU ? a / (1.f + expf(-a)) : a;
    }
    *reinterpret_cast<uint4*>(y + base + (long long)p * c) = Vec<T>::pack(v);
  }
}

// The thread's channels' mean, rstd, weight and bias.
template <int N>
__device__ __forceinline__ void channel_params(
    const Place& q, int b, int g, int cpg, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ w,
    const float* __restrict__ bias, float* mu, float* rs, float* wt,
    float* bs) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int ch = q.col * N + i, gi = b * g + ch / cpg;
    mu[i] = mean[gi];
    rs[i] = rstd[gi];
    wt[i] = w[ch];
    bs[i] = bias[ch];
  }
}

// Backward pass 1: per channel sum(g) and sum(g * xhat) over the block;
// per-(block, group) partials of sum(dxhat) and sum(dxhat * xhat), and,
// when cpart is not NULL, the per-channel sums for dw and dbias.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ part, float* __restrict__ cpart,
                        int hw, int c, int g, int ppb) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[2][THREADS * N];
  const int j = blockIdx.x, nb = gridDim.x, b = blockIdx.y;
  const int cpg = c / g;
  const Place q = place<N>(c, hw, ppb, j);
  if (q.active) {
    float mu[N], rs[N], wt[N], bs[N], sg[N], sgx[N];
    channel_params<N>(q, b, g, cpg, mean, rstd, w, bias, mu, rs, wt, bs);
#pragma unroll
    for (int i = 0; i < N; ++i) sg[i] = sgx[i] = 0.f;
    const long long base = (long long)b * hw * c + q.col * N;
    for (int p = q.p0 + q.row; p < q.p1; p += 2 * q.rows) {
      const bool two = p + q.rows < q.p1;
      uint4 ux[2], ud[2];
      ux[0] = load16(x + base + (long long)p * c);
      ud[0] = load16(dy + base + (long long)p * c);
      if (two) {
        ux[1] = load16(x + base + (long long)(p + q.rows) * c);
        ud[1] = load16(dy + base + (long long)(p + q.rows) * c);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        float xv[N], dv[N];
        Vec<T>::unpack(ux[k], xv);
        Vec<T>::unpack(ud[k], dv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xh = normed(xv[i], mu[i], rs[i]);
          const float gg = dact<SILU>(dv[i], affine<T, SILU>(xh, wt[i], bs[i]));
          sg[i] += gg;
          sgx[i] = fmaf(gg, xh, sgx[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red[0][threadIdx.x * N + i] = sg[i];
      red[1][threadIdx.x * N + i] = sgx[i];
    }
  }
  __syncthreads();
  channel_sums(red[0], red[1], q.rows, c);
  __syncthreads();
  for (int gi = threadIdx.x; gi < g; gi += THREADS) {
    float a = 0.f, a2 = 0.f;
    for (int k = 0; k < cpg; ++k) {
      const int ch = gi * cpg + k;
      a = fmaf(w[ch], red[0][ch], a);
      a2 = fmaf(w[ch], red[1][ch], a2);
    }
    float* o = part + (long long)(b * g + gi) * 2 * nb + j;
    o[0] = a;
    o[nb] = a2;
  }
  if (cpart != nullptr) {
    float* o = cpart + (long long)(b * nb + j) * 2 * c;
    for (int ch = threadIdx.x; ch < c; ch += THREADS) {
      o[ch] = red[0][ch];
      o[c + ch] = red[1][ch];
    }
  }
}

// Backward pass 2: the group means of dxhat and dxhat * xhat from the
// partials, then dx.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ part, T* __restrict__ dx,
                        int hw, int c, int g, int ppb) {
  constexpr int N = Vec<T>::N;
  __shared__ float st[2][MAX_GROUPS];
  const int nb = gridDim.x;
  const int j = nb - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  combine(part, b, g, nb, st[0], st[1]);
  __syncthreads();
  const int cpg = c / g;
  const Place q = place<N>(c, hw, ppb, j);
  if (!q.active) return;
  const float n = (float)hw * (float)cpg;
  float mu[N], rs[N], wt[N], bs[N], m1[N], m2[N];
  channel_params<N>(q, b, g, cpg, mean, rstd, w, bias, mu, rs, wt, bs);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int gi = (q.col * N + i) / cpg;
    m1[i] = st[0][gi] / n;
    m2[i] = st[1][gi] / n;
  }
  const long long base = (long long)b * hw * c + q.col * N;
  for (int p = q.p0 + q.row; p < q.p1; p += 2 * q.rows) {
    const bool two = p + q.rows < q.p1;
    uint4 ux[2], ud[2];
    ux[0] = load16(x + base + (long long)p * c);
    ud[0] = load16(dy + base + (long long)p * c);
    if (two) {
      ux[1] = load16(x + base + (long long)(p + q.rows) * c);
      ud[1] = load16(dy + base + (long long)(p + q.rows) * c);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 1 && !two) break;
      float xv[N], dv[N];
      Vec<T>::unpack(ux[k], xv);
      Vec<T>::unpack(ud[k], dv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = normed(xv[i], mu[i], rs[i]);
        const float gg = dact<SILU>(dv[i], affine<T, SILU>(xh, wt[i], bs[i]));
        xv[i] = rs[i] * (gg * wt[i] - m1[i] - xh * m2[i]);
      }
      *reinterpret_cast<uint4*>(dx + base + (long long)(p + k * q.rows) * c) =
          Vec<T>::pack(xv);
    }
  }
}

template <typename T>
int forward(int silu, const void* x, const float* w, const float* bias,
            void* y, float* part, float* mean, float* rstd, int b, int hw,
            int c, int g, int nb, int ppb, float eps, cudaStream_t s) {
  const dim3 grid(nb, b);
  gn_stats_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), part,
                                             hw, c, g, ppb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto apply = silu ? gn_apply_kernel<T, true> : gn_apply_kernel<T, false>;
  apply<<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), part, w, bias,
                                 static_cast<T*>(y), mean, rstd, hw, c, g,
                                 ppb, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(int silu, const void* x, const void* dy, const float* mean,
             const float* rstd, const float* w, const float* bias, void* dx,
             float* part, float* cpart, int b, int hw, int c, int g, int nb,
             int ppb, cudaStream_t s) {
  const dim3 grid(nb, b);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  auto stats = silu ? gn_bwd_stats_kernel<T, true>
                    : gn_bwd_stats_kernel<T, false>;
  stats<<<grid, THREADS, 0, s>>>(xt, dyt, mean, rstd, w, bias, part, cpart,
                                 hw, c, g, ppb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto apply = silu ? gn_bwd_apply_kernel<T, true>
                    : gn_bwd_apply_kernel<T, false>;
  apply<<<grid, THREADS, 0, s>>>(xt, dyt, mean, rstd, w, bias, part,
                                 static_cast<T*>(dx), hw, c, g, ppb);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int bf16, int b, int hw, int c, int g, int nb, int ppb) {
  const int n = bf16 ? 8 : 4;
  return b > 0 && b <= 65535 && hw > 0 && c > 0 && c % n == 0 &&
         c / n <= THREADS && g > 0 && g <= MAX_GROUPS && c % g == 0 &&
         nb > 0 && ppb > 0 && (long long)nb * ppb >= hw &&
         (long long)(nb - 1) * ppb < hw;
}

}  // namespace

extern "C" {

// Returns 0, a cudaError, or -1 for arguments outside the kernels' contract.
int groupnorm_fwd(int bf16, int silu, const void* x, const float* w,
                  const float* bias, void* y, float* part, float* mean,
                  float* rstd, int b, int hw, int c, int g, int nb, int ppb,
                  float eps, void* stream) {
  if (!valid(bf16, b, hw, c, g, nb, ppb)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? forward<__nv_bfloat16>(silu, x, w, bias, y, part, mean, rstd,
                                       b, hw, c, g, nb, ppb, eps, s)
              : forward<float>(silu, x, w, bias, y, part, mean, rstd, b, hw,
                               c, g, nb, ppb, eps, s);
}

int groupnorm_bwd(int bf16, int silu, const void* x, const void* dy,
                  const float* mean, const float* rstd, const float* w,
                  const float* bias, void* dx, float* part, float* cpart,
                  int b, int hw, int c, int g, int nb, int ppb,
                  void* stream) {
  if (!valid(bf16, b, hw, c, g, nb, ppb)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? backward<__nv_bfloat16>(silu, x, dy, mean, rstd, w, bias, dx,
                                        part, cpart, b, hw, c, g, nb, ppb, s)
              : backward<float>(silu, x, dy, mean, rstd, w, bias, dx, part,
                                cpart, b, hw, c, g, nb, ppb, s);
}

}  // extern "C"
