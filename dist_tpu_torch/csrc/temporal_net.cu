// Fused DiST TemporalNet block, forward:
//   out = qgelu(x + conv(1,3,3)(qgelu(conv(k,1,1)(LN(x)) + b1)) + b2)
// on channels-last x (B, T, H, W, C), LayerNorm eps 1e-5, fp32 inside,
// output in x's type.
//
// Replaces: dist_tpu/ops/temporal_net.py::_fwd_kernel (launched by
// _pallas_fwd, public fused_temporal_net). Boundary handling is that of
// _masks/_shift_spatial: zero frames outside [0, T) for the temporal taps
// (the LayerNorm output is zero there, not LN(0)), zero pixels outside the
// image for the 3x3 taps.
//
// What bounds it on the card: at the ladder's shape (8, 16, 14, 14, 96),
// k = 3, the block does 2 * N * C * F * (k + 9) = 5.5 GFLOP on N = 25,088
// positions and moves ~9.6 MB of bf16 in and out, so it is compute-bound:
// ~83 us at the 67 TFLOP/s fp32 CUDA-core peak that this kernel's fp32
// arithmetic uses.
//
// Design: the TPU kernel kept a whole batch row, (T*H*W, C) fp32 ~1.2 MB,
// in VMEM; an SM has 227 KB of shared memory. Here the block is two
// launches, each a tiled product over 64 positions x all output channels
// with the conv taps as an outer loop:
//   stage A: g = qgelu(sum_d LN(x[t + d - k/2]) @ w1[d] + b1)  -> fp32 scratch
//   stage B: out = qgelu(x + sum_(dy,dx) g[y+dy-1, x+dx-1] @ w2[dy,dx] + b2)
// For each tap the block gathers its 64 source rows (zero outside the clip
// or image) into shared memory and streams that tap's weight block
// (C x F or F x C fp32, <= 64 KB) in beside it. The 3x3 taps of stage B
// need g at neighbouring pixels, which another block computes; putting the
// fp32 g through a scratch buffer (the wrapper allocates it, N x F x 4 B =
// 9.6 MB, which stays in the 50 MB L2) costs ~6 us of traffic against the
// ~83 us compute bound and keeps each stage a plain product with its
// accumulators in registers. The LayerNorm of a source row is recomputed
// for each of the k temporal taps (96 values; negligible).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // positions per block
constexpr int NT = 256;  // threads: 16 (ty, rows ty + 16 i) x 16 (tx, cols tx + 16 j)
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float qgelu(float v) { return v / (1.f + expf(-1.702f * v)); }

__device__ __forceinline__ float qgelu_grad(float v) {
  const float s = 1.f / (1.f + expf(-1.702f * v));
  return s * (1.f + 1.702f * v * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Ws (K x 16 NJ, zero-padded columns) <- w[row0 .. row0 + K) of a (*, N) matrix
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int row0, int K, int N,
                                             int NP, float* Ws) {
  for (int idx = threadIdx.x; idx < K * NP; idx += NT) {
    const int r = idx / NP, c = idx % NP;
    Ws[idx] = c < N ? w[(size_t)(row0 + r) * N + c] : 0.f;
  }
}

// acc[i][j] += Xs[ty + 16 i, :K] . Ws[:K, tx + 16 j]; Xs rows are K + 1 apart
// so that the two rows a warp reads fall in different banks
template <int NJ>
__device__ __forceinline__ void tile_product(const float* Xs, const float* Ws, int K, int ty,
                                             int tx, float acc[4][NJ]) {
  const int ld = K + 1;
  constexpr int NP = 16 * NJ;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[4], w[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Xs[(ty + 16 * i) * ld + kk];
#pragma unroll
    for (int j = 0; j < NJ; ++j) w[j] = Ws[kk * NP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// stage A: g (N, F) fp32 = qgelu(temporal conv of LN(x) + b1); with hb != null
// (the backward) also the pre-activation hb
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
temporal_stage_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, const float* __restrict__ w1,
                      const float* __restrict__ b1, float* __restrict__ g, int N, int Tn, int HW,
                      int C, int F, int k, float* __restrict__ hb) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // BM x (C + 1)
  float* Ws = Xs + BM * (C + 1);                // C x NP
  __shared__ int valid[BM];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * BM;
  const int pad = k / 2;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int d = 0; d < k; ++d) {
    __syncthreads();
    if (threadIdx.x < BM) {
      const int p = p0 + threadIdx.x;
      int ok = p < N;
      if (ok) {
        const int t = (p / HW) % Tn;
        ok = t + d - pad >= 0 && t + d - pad < Tn;
      }
      valid[threadIdx.x] = ok;
    }
    __syncthreads();
    const long shift = (long)(d - pad) * HW;  // whole frames
    for (int idx = threadIdx.x; idx < BM * C; idx += NT) {
      const int r = idx / C, c = idx % C;
      Xs[r * (C + 1) + c] =
          valid[r] ? to_f(x[(size_t)((long)(p0 + r) + shift) * C + c]) : 0.f;
    }
    load_weights(w1, d * C, C, F, NP, Ws);
    __syncthreads();
    // LayerNorm of each valid row in place, one warp per row
    for (int r = warp; r < BM; r += NT / 32) {
      if (!valid[r]) continue;
      float* row = Xs + r * (C + 1);
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += row[c];
      const float mu = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xc = row[c] - mu;
        v += xc * xc;
      }
      const float rstd = rsqrtf(warp_sum(v) / C + kEps);
      for (int c = lane; c < C; c += 32) row[c] = (row[c] - mu) * rstd * ln_s[c] + ln_b[c];
    }
    __syncthreads();
    tile_product<NJ>(Xs, Ws, C, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int f = tx + 16 * j;
      if (f < F) {
        const float h = acc[i][j] + b1[f];
        g[(size_t)p * F + f] = qgelu(h);
        if (hb) hb[(size_t)p * F + f] = h;
      }
    }
  }
}

// stage B: out (N, C) = qgelu(x + 3x3 spatial conv of g + b2), in T; with
// dr != null (the backward) instead dr = qgelu'(that sum) * gout, fp32
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
spatial_stage_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     T* __restrict__ out, int N, int H, int W, int C, int F,
                     const T* __restrict__ gout, float* __restrict__ dr) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* Gs = reinterpret_cast<float*>(smem4);  // BM x (F + 1)
  float* Ws = Gs + BM * (F + 1);                // F x NP
  __shared__ int src[BM];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.x * BM;
  const int HW = H * W;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __syncthreads();
    if (threadIdx.x < BM) {
      const int p = p0 + threadIdx.x;
      int s = -1;
      if (p < N) {
        const int yx = p % HW, y = yx / W + dy, xx = yx % W + dx;
        if (y >= 0 && y < H && xx >= 0 && xx < W) s = p + dy * W + dx;
      }
      src[threadIdx.x] = s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * F; idx += NT) {
      const int r = idx / F, f = idx % F;
      const int s = src[r];
      Gs[r * (F + 1) + f] = s >= 0 ? g[(size_t)s * F + f] : 0.f;
    }
    load_weights(w2, tap * F, F, C, NP, Ws);
    __syncthreads();
    tile_product<NJ>(Gs, Ws, F, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) {
        const size_t o = (size_t)p * C + c;
        const float r = to_f(x[o]) + acc[i][j] + b2[c];
        if (dr)
          dr[o] = qgelu_grad(r) * to_f(gout[o]);
        else
          out[o] = from_f<T>(qgelu(r));
      }
    }
  }
}

template <typename T, int NJA, int NJB>
cudaError_t launch(const void* x, const float* ln_s, const float* ln_b, const float* w1,
                   const float* b1, const float* w2, const float* b2, float* g, void* out,
                   int N, int Tn, int H, int W, int C, int F, int k, cudaStream_t stream) {
  const size_t smem_a = sizeof(float) * ((size_t)BM * (C + 1) + (size_t)C * 16 * NJA);
  const size_t smem_b = sizeof(float) * ((size_t)BM * (F + 1) + (size_t)F * 16 * NJB);
  cudaError_t err = cudaFuncSetAttribute(temporal_stage_kernel<T, NJA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(spatial_stage_kernel<T, NJB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  const int blocks = (N + BM - 1) / BM;
  temporal_stage_kernel<T, NJA><<<blocks, NT, smem_a, stream>>>(
      static_cast<const T*>(x), ln_s, ln_b, w1, b1, g, N, Tn, H * W, C, F, k, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_stage_kernel<T, NJB><<<blocks, NT, smem_b, stream>>>(
      static_cast<const T*>(x), g, w2, b2, static_cast<T*>(out), N, H, W, C, F, nullptr,
      nullptr);
  return cudaGetLastError();
}

// NJ = ceil(channels / 16) groups of output columns per thread, in {2, 4, 6, 8}
template <typename T, int NJA>
cudaError_t dispatch_b(int njb, const void* x, const float* ln_s, const float* ln_b,
                       const float* w1, const float* b1, const float* w2, const float* b2,
                       float* g, void* out, int N, int Tn, int H, int W, int C, int F, int k,
                       cudaStream_t st) {
  switch (njb) {
    case 2: return launch<T, NJA, 2>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 4: return launch<T, NJA, 4>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 6: return launch<T, NJA, 6>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 8: return launch<T, NJA, 8>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const float* ln_s, const float* ln_b, const float* w1,
                     const float* b1, const float* w2, const float* b2, float* g, void* out,
                     int N, int Tn, int H, int W, int C, int F, int k, cudaStream_t st) {
  const int nja = ((F + 31) / 32) * 2, njb = ((C + 31) / 32) * 2;
  switch (nja) {
    case 2: return dispatch_b<T, 2>(njb, x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 4: return dispatch_b<T, 4>(njb, x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 6: return dispatch_b<T, 6>(njb, x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    case 8: return dispatch_b<T, 8>(njb, x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F, k, st);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// K3, the block's backward. Stages A and B above recompute the forward (hb, g
// and dr = qgelu'(r) * gout into fp32 scratch); the kernels below walk back.

constexpr int kBwdChunks = 32;  // fixed split of the positions for the weight grads

// stage C: dhb (N, F) = qgelu'(hb) * dg, dg = the 3x3 taps transposed: each
// tap reads dr at the opposite offset (zero where that pixel leaves the image)
template <int NJ>
__global__ void __launch_bounds__(NT)
spatial_dgrad_kernel(const float* __restrict__ dr, const float* __restrict__ hb,
                     const float* __restrict__ w2t, float* __restrict__ dhb, int N, int H,
                     int W, int C, int F) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* Ds = reinterpret_cast<float*>(smem4);  // BM x (C + 1)
  float* Ws = Ds + BM * (C + 1);                // C x NP
  __shared__ int src[BM];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int p0 = blockIdx.x * BM;
  const int HW = H * W;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;  // the forward read g[y + dy, x + dx]
    __syncthreads();
    if (threadIdx.x < BM) {
      const int q = p0 + threadIdx.x;
      int s = -1;
      if (q < N) {
        const int yx = q % HW, y = yx / W - dy, xx = yx % W - dx;
        if (y >= 0 && y < H && xx >= 0 && xx < W) s = q - dy * W - dx;
      }
      src[threadIdx.x] = s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * C; idx += NT) {
      const int r = idx / C, c = idx % C;
      const int s = src[r];
      Ds[r * (C + 1) + c] = s >= 0 ? dr[(size_t)s * C + c] : 0.f;
    }
    load_weights(w2t, tap * C, C, F, NP, Ws);  // w2t[tap * C + c][f] = w2[tap][f][c]
    __syncthreads();
    tile_product<NJ>(Ds, Ws, C, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = p0 + ty + 16 * i;
    if (q >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int f = tx + 16 * j;
      if (f < F) dhb[(size_t)q * F + f] = qgelu_grad(hb[(size_t)q * F + f]) * acc[i][j];
    }
  }
}

// stage D: dxl = the temporal taps transposed (dhb at the opposite frame
// shift; the zero frames outside [0, T) take no gradient), then the
// LayerNorm backward with LN recomputed, dx = dr + dx_ln in T, and this
// tile's column sums of dxl * z and dxl (the LayerNorm grads' partials)
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
temporal_dgrad_kernel(const T* __restrict__ x, const float* __restrict__ dhb,
                      const float* __restrict__ dr, const float* __restrict__ ln_s,
                      const float* __restrict__ w1t, T* __restrict__ dx,
                      float* __restrict__ plns, float* __restrict__ plnb, int N, int Tn,
                      int HW, int C, int F, int k) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // BM x (F + 1): gathered dhb
  float* Ws = Hs + BM * (F + 1);                // F x NP
  float* Ls = Ws + F * NP;                      // BM x (C + 1): dxl
  float* Zs = Ls + BM * (C + 1);                // BM x (C + 1): x, then z
  __shared__ int src[BM];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * BM;
  const int pad = k / 2;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int d = 0; d < k; ++d) {
    __syncthreads();
    if (threadIdx.x < BM) {
      const int q = p0 + threadIdx.x;
      int s = -1;
      if (q < N) {
        const int t = (q / HW) % Tn - (d - pad);  // the forward read frame t + d - pad
        if (t >= 0 && t < Tn) s = q - (d - pad) * HW;
      }
      src[threadIdx.x] = s;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * F; idx += NT) {
      const int r = idx / F, f = idx % F;
      const int s = src[r];
      Hs[r * (F + 1) + f] = s >= 0 ? dhb[(size_t)s * F + f] : 0.f;
    }
    load_weights(w1t, d * F, F, C, NP, Ws);  // w1t[d * F + f][c] = w1[d][c][f]
    __syncthreads();
    tile_product<NJ>(Hs, Ws, F, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) Ls[(ty + 16 * i) * (C + 1) + c] = acc[i][j];
    }
  for (int idx = threadIdx.x; idx < BM * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    Zs[r * (C + 1) + c] = p0 + r < N ? to_f(x[(size_t)(p0 + r) * C + c]) : 0.f;
  }
  __syncthreads();
  // LayerNorm backward, one warp per row
  for (int r = warp; r < BM; r += NT / 32) {
    const int p = p0 + r;
    if (p >= N) continue;
    float* z = Zs + r * (C + 1);
    const float* dxl = Ls + r * (C + 1);
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += z[c];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xc = z[c] - mu;
      v += xc * xc;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + kEps);
    float sdz = 0.f, sdzz = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float zc = (z[c] - mu) * rstd;
      z[c] = zc;
      const float dz = dxl[c] * ln_s[c];
      sdz += dz;
      sdzz += dz * zc;
    }
    const float mean_dz = warp_sum(sdz) / C, mean_dzz = warp_sum(sdzz) / C;
    for (int c = lane; c < C; c += 32) {
      const size_t o = (size_t)p * C + c;
      const float dz = dxl[c] * ln_s[c];
      dx[o] = from_f<T>(dr[o] + rstd * (dz - mean_dz - z[c] * mean_dzz));
    }
  }
  __syncthreads();
  // this tile's LayerNorm grad partials (rows past N hold zeros)
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < BM; ++r) {
      const float g = Ls[r * (C + 1) + c];
      s1 += g * Zs[r * (C + 1) + c];
      s2 += g;
    }
    plns[(size_t)blockIdx.x * C + c] = s1;
    plnb[(size_t)blockIdx.x * C + c] = s2;
  }
}

// Weight grads: block (tap, chunk) sums A_tap(p)^T B(p) over its chunk of
// positions into an (Ka x Kb) fp32 partial, walking 64-position tiles.
//   kTemporal: A = LN(x) at frame shift tap - k/2 (zero outside the clip),
//              B = dhb: dw1[tap] (C x F); tap-0 blocks also sum B: db1
//   else:      A = g at the 3x3 offset of tap (zero outside the image),
//              B = dr: dw2[tap] (F x C); tap-0 blocks also sum B: db2
// Each thread owns rows ty + 16 i and columns tx + 16 j of the partial.
template <typename T, int NJ, bool kTemporal>
__global__ void __launch_bounds__(NT)
weight_grad_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, const float* __restrict__ a_src,
                   const float* __restrict__ b_src, float* __restrict__ pw,
                   float* __restrict__ pb, int N, int Tn, int H, int W, int Ka, int Kb, int k,
                   int chunk_len) {
  constexpr int NP = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // BM x NP, zero past Ka
  float* Bs = As + BM * NP;                     // BM x NP, zero past Kb
  __shared__ int srcA[BM];
  __shared__ int rowB[BM];

  const int tap = blockIdx.x, ntaps = gridDim.x, chunk = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HW = H * W;
  const int p_begin = chunk * chunk_len;
  const int p_end = min(N, p_begin + chunk_len);

  float acc[NJ][NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += BM) {
    __syncthreads();
    if (threadIdx.x < BM) {
      const int p = p0 + threadIdx.x;
      int s = -1;
      if (p < p_end) {
        if (kTemporal) {
          const int shift = tap - k / 2;
          const int t = (p / HW) % Tn + shift;
          if (t >= 0 && t < Tn) s = p + shift * HW;
        } else {
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const int yx = p % HW, y = yx / W + dy, xx = yx % W + dx;
          if (y >= 0 && y < H && xx >= 0 && xx < W) s = p + dy * W + dx;
        }
      }
      srcA[threadIdx.x] = s;
      rowB[threadIdx.x] = p < p_end ? p : -1;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * NP; idx += NT) {
      const int r = idx / NP, a = idx % NP;
      const int s = srcA[r], q = rowB[r];
      float va = 0.f, vb = 0.f;
      if (s >= 0 && a < Ka)
        va = kTemporal ? to_f(x[(size_t)s * Ka + a]) : a_src[(size_t)s * Ka + a];
      if (q >= 0 && a < Kb) vb = b_src[(size_t)q * Kb + a];
      As[idx] = va;
      Bs[idx] = vb;
    }
    __syncthreads();
    if (kTemporal) {  // LayerNorm of each gathered row in place, one warp per row
      for (int r = warp; r < BM; r += NT / 32) {
        if (srcA[r] < 0) continue;
        float* row = As + r * NP;
        float s = 0.f;
        for (int c = lane; c < Ka; c += 32) s += row[c];
        const float mu = warp_sum(s) / Ka;
        float v = 0.f;
        for (int c = lane; c < Ka; c += 32) {
          const float xc = row[c] - mu;
          v += xc * xc;
        }
        const float rstd = rsqrtf(warp_sum(v) / Ka + kEps);
        for (int c = lane; c < Ka; c += 32) row[c] = (row[c] - mu) * rstd * ln_s[c] + ln_b[c];
      }
      __syncthreads();
    }
    if (tap == 0 && threadIdx.x < Kb)
      for (int r = 0; r < BM; ++r) bsum += Bs[r * NP + threadIdx.x];
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float a[NJ], b[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i) a[i] = As[r * NP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = Bs[r * NP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = pw + ((size_t)chunk * ntaps + tap) * Ka * Kb;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    const int a = ty + 16 * i;
    if (a >= Ka) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int b = tx + 16 * j;
      if (b < Kb) out[(size_t)a * Kb + b] = acc[i][j];
    }
  }
  if (tap == 0 && threadIdx.x < Kb) pb[(size_t)chunk * Kb + threadIdx.x] = bsum;
}

// out[m] = sum over r of in[r][m], r in a fixed order: lanes own columns, the
// 8 rows of the block stride over r, then one fixed-order sum of the 8
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int R, int M) {
  __shared__ float part[8][33];
  const int m = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (m < M)
    for (int r = threadIdx.y; r < R; r += 8) s += in[(size_t)r * M + m];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && m < M) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) t += part[i][threadIdx.x];
    out[m] = t;
  }
}

cudaError_t sum_rows(const float* in, float* out, int R, int M, cudaStream_t st) {
  sum_rows_kernel<<<(M + 31) / 32, dim3(32, 8), 0, st>>>(in, out, R, M);
  return cudaGetLastError();
}

// Scratch of one backward call, in floats, in this order (ops/temporal_net.py,
// bwd_scratch_floats, computes the same total)
struct BwdLayout {
  float *hb, *g, *dr, *dhb, *pw1, *pw2, *pdb1, *pdb2, *plns, *plnb;
  size_t total;
  BwdLayout(float* base, size_t N, size_t C, size_t F, size_t k, size_t tiles) {
    const size_t S = kBwdChunks;
    hb = base;
    g = hb + N * F;
    dr = g + N * F;
    dhb = dr + N * C;
    pw1 = dhb + N * F;
    pw2 = pw1 + S * k * C * F;
    pdb1 = pw2 + S * 9 * F * C;
    pdb2 = pdb1 + S * F;
    plns = pdb2 + S * C;
    plnb = plns + tiles * C;
    total = (size_t)(plnb + tiles * C - base);
  }
};

#define DTT_TRY(expr)                         \
  do {                                        \
    cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int NJ>
cudaError_t launch_bwd(const T* x, const T* gout, const float* ln_s, const float* ln_b,
                       const float* w1p, const float* w1t, const float* b1, const float* w2p,
                       const float* w2t, const float* b2, const BwdLayout& L, T* dx,
                       float* dlns, float* dlnb, float* dw1, float* db1, float* dw2,
                       float* db2, int N, int Tn, int H, int W, int C, int F, int k,
                       cudaStream_t st) {
  constexpr int NP = 16 * NJ;
  const int HW = H * W;
  const int tiles = (N + BM - 1) / BM;
  const int chunk_len = ((tiles + kBwdChunks - 1) / kBwdChunks) * BM;
  const size_t f4 = sizeof(float);
  const size_t smem_a = f4 * ((size_t)BM * (C + 1) + (size_t)C * NP);
  const size_t smem_b = f4 * ((size_t)BM * (F + 1) + (size_t)F * NP);
  const size_t smem_c = smem_a;
  const size_t smem_d = f4 * ((size_t)BM * (F + 1) + (size_t)F * NP + 2 * (size_t)BM * (C + 1));
  const size_t smem_w = f4 * 2 * (size_t)BM * NP;
  DTT_TRY(allow_smem(temporal_stage_kernel<T, NJ>, smem_a));
  DTT_TRY(allow_smem(spatial_stage_kernel<T, NJ>, smem_b));
  DTT_TRY(allow_smem(spatial_dgrad_kernel<NJ>, smem_c));
  DTT_TRY(allow_smem(temporal_dgrad_kernel<T, NJ>, smem_d));
  DTT_TRY(allow_smem(weight_grad_kernel<T, NJ, true>, smem_w));
  DTT_TRY(allow_smem(weight_grad_kernel<float, NJ, false>, smem_w));

  // A, B: the forward again, keeping hb, g and dr
  temporal_stage_kernel<T, NJ><<<tiles, NT, smem_a, st>>>(x, ln_s, ln_b, w1p, b1, L.g, N, Tn,
                                                          HW, C, F, k, L.hb);
  DTT_TRY(cudaGetLastError());
  spatial_stage_kernel<T, NJ><<<tiles, NT, smem_b, st>>>(x, L.g, w2p, b2, nullptr, N, H, W, C,
                                                         F, gout, L.dr);
  DTT_TRY(cudaGetLastError());
  // dw2, db2 partials
  weight_grad_kernel<float, NJ, false><<<dim3(9, kBwdChunks), NT, smem_w, st>>>(
      nullptr, nullptr, nullptr, L.g, L.dr, L.pw2, L.pdb2, N, Tn, H, W, F, C, k, chunk_len);
  DTT_TRY(cudaGetLastError());
  // C: dhb
  spatial_dgrad_kernel<NJ><<<tiles, NT, smem_c, st>>>(L.dr, L.hb, w2t, L.dhb, N, H, W, C, F);
  DTT_TRY(cudaGetLastError());
  // dw1, db1 partials
  weight_grad_kernel<T, NJ, true><<<dim3(k, kBwdChunks), NT, smem_w, st>>>(
      x, ln_s, ln_b, nullptr, L.dhb, L.pw1, L.pdb1, N, Tn, H, W, C, F, k, chunk_len);
  DTT_TRY(cudaGetLastError());
  // D: dx and the LayerNorm partials
  temporal_dgrad_kernel<T, NJ><<<tiles, NT, smem_d, st>>>(x, L.dhb, L.dr, ln_s, w1t, dx, L.plns,
                                                          L.plnb, N, Tn, HW, C, F, k);
  DTT_TRY(cudaGetLastError());
  // the partials, summed in a fixed order
  DTT_TRY(sum_rows(L.pw2, dw2, kBwdChunks, 9 * F * C, st));
  DTT_TRY(sum_rows(L.pdb2, db2, kBwdChunks, C, st));
  DTT_TRY(sum_rows(L.pw1, dw1, kBwdChunks, k * C * F, st));
  DTT_TRY(sum_rows(L.pdb1, db1, kBwdChunks, F, st));
  DTT_TRY(sum_rows(L.plns, dlns, tiles, C, st));
  return sum_rows(L.plnb, dlnb, tiles, C, st);
}

template <typename T>
cudaError_t dispatch_bwd(int nj, const void* x, const void* gout, const float* ln_s,
                         const float* ln_b, const float* w1p, const float* w1t, const float* b1,
                         const float* w2p, const float* w2t, const float* b2,
                         const BwdLayout& L, void* dx, float* dlns, float* dlnb, float* dw1,
                         float* db1, float* dw2, float* db2, int N, int Tn, int H, int W,
                         int C, int F, int k, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gout);
  T* dxt = static_cast<T*>(dx);
#define DTT_BWD(NJ)                                                                            \
  launch_bwd<T, NJ>(xt, gt, ln_s, ln_b, w1p, w1t, b1, w2p, w2t, b2, L, dxt, dlns, dlnb, dw1, \
                    db1, dw2, db2, N, Tn, H, W, C, F, k, st)
  switch (nj) {
    case 2: return DTT_BWD(2);
    case 4: return DTT_BWD(4);
    case 6: return DTT_BWD(6);
    case 8: return DTT_BWD(8);
    default: return cudaErrorInvalidValue;
  }
#undef DTT_BWD
}

}  // namespace

// x, out: (B, T, H, W, C) contiguous, fp32 (is_bf16 = 0) or bf16 (1).
// ln_s, ln_b (C); w1 (k*C, F) = the raw (k,1,1,C,F) kernel; b1 (F);
// w2 (9*F, C) = the raw (1,3,3,F,C) kernel; b2 (C): all fp32 contiguous.
// g: fp32 scratch of B*T*H*W*F elements. C, F <= 128. Two launches on
// `stream`; returns cudaGetLastError() after them.
extern "C" int dtt_temporal_net_fwd(const void* x, const float* ln_s, const float* ln_b,
                                    const float* w1, const float* b1, const float* w2,
                                    const float* b2, float* g, void* out, int B, int Tn, int H,
                                    int W, int C, int F, int k, int is_bf16, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C > 128 || F > 128 ||
      k <= 0)
    return cudaErrorInvalidValue;
  const long n = (long)B * Tn * H * W;
  if (n > 2147483647L / 128) return cudaErrorInvalidValue;
  const int N = (int)n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W,
                                           C, F, k, st)
                 : dispatch<float>(x, ln_s, ln_b, w1, b1, w2, b2, g, out, N, Tn, H, W, C, F,
                                   k, st);
}

// The block's gradient for the cotangent gout of its output (K3).
// x, gout, dx: (B, T, H, W, C) contiguous, fp32 (is_bf16 = 0) or bf16 (1).
// ln_s, ln_b, w1p (k*C, F), b1, w2p (9*F, C), b2 as for the forward; w1t
// (k*F, C) and w2t (9*C, F) the same taps transposed. scratch: fp32 of
// scratch_floats elements (BwdLayout). Outputs, fp32: dlns, dlnb (C); dw1
// (k*C, F); db1 (F); dw2 (9*F, C); db2 (C). A dozen launches on `stream`;
// returns the first error.
extern "C" int dtt_temporal_net_bwd(const void* x, const void* gout, const float* ln_s,
                                    const float* ln_b, const float* w1p, const float* w1t,
                                    const float* b1, const float* w2p, const float* w2t,
                                    const float* b2, float* scratch, void* dx, float* dlns,
                                    float* dlnb, float* dw1, float* db1, float* dw2, float* db2,
                                    int B, int Tn, int H, int W, int C, int F, int k,
                                    int is_bf16, int scratch_floats, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C > 128 || F > 128 ||
      k <= 0)
    return cudaErrorInvalidValue;
  const long n = (long)B * Tn * H * W;
  if (n > 2147483647L / 128) return cudaErrorInvalidValue;
  const int N = (int)n;
  const int tiles = (N + BM - 1) / BM;
  const BwdLayout L(scratch, N, C, F, k, tiles);
  if (L.total != (size_t)scratch_floats) return cudaErrorInvalidValue;
  const int nj = ((C > F ? C : F) + 31) / 32 * 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(nj, x, gout, ln_s, ln_b, w1p, w1t, b1, w2p, w2t,
                                               b2, L, dx, dlns, dlnb, dw1, db1, dw2, db2, N,
                                               Tn, H, W, C, F, k, st)
                 : dispatch_bwd<float>(nj, x, gout, ln_s, ln_b, w1p, w1t, b1, w2p, w2t, b2, L,
                                       dx, dlns, dlnb, dw1, db1, dw2, db2, N, Tn, H, W, C, F,
                                       k, st);
}

extern "C" const char* dtt_temporal_net_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
