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

// ---------------------------------------------------------------------------
// K3 for bf16 inputs (the train step's): the same function and the same
// stages on the tensor cores. fp32 inputs take the kernels above, untouched.
//
//   products  mma.sync.m16n8k16, bf16 operands and fp32 sums, the operands
//             from shared memory through ldmatrix: the gathered rows as A,
//             a tap's K x N weight block as B through ldmatrix.trans; in
//             the weight grads A^T B over a 128-position tile, both through
//             ldmatrix.trans. Channels are padded with zeros to P, the
//             next multiple of 32 (96 at the ladder's width).
//   operands  bf16 wherever a value only feeds a product: LN(x) (computed
//             in fp32 once, then rounded: xl), g = qgelu(hb), dr and dhb,
//             and the weights, packed per call as P x P tiles, tap-major:
//             w1, w1^T, w2, w2^T.
//   fp32      every elementwise step (the LayerNorm and its backward,
//             qgelu and qgelu', dx = dr + dx_ln) and every sum. hb, which
//             qgelu'(hb) reads, and dr, which dx reads, are kept in fp32
//             scratch beside the bf16 dr (they are not recomputed).
//   gathers   16-byte cp.async per 8 channels of a source row, zero-filled
//             (src-size 0) for rows outside the clip or image and for pad
//             channels; two buffers, the next tap's rows and weights in
//             flight while this tap's products run.
//   sums      the bias and LayerNorm grads as fp32 column sums of each
//             128-position tile; the weight grads in one launch of (k + 9)
//             taps x 32 chunks of positions (384 blocks at k = 3); the
//             partials summed in a fixed order, the weight grads' in one
//             launch and the tiles' in another; no atomics, so two
//             launches agree bit for bit.
// Launches: prepare (LN(x) and the weight tiles), A, B, C, the weight
// grads, D, and the two sums.
// What bounds it at (32, 16, 14, 14, 96), k = 3: 6 N C F (k + 9) = 66.6
// GFLOP on bf16 tensor cores, 0.067 ms, against ~58 MB of inputs and
// outputs (0.017 ms); what the design leaves is the scratch traffic, each
// bf16 operand gathered 3 or 9 times through the 50 MB L2.

namespace k3 {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;      // positions per block of a stage
constexpr int NW = 8;        // warps: 16 positions (or weight-grad rows) each
constexpr int NTH = 32 * NW;
constexpr int kChunks = 32;  // fixed split of the positions for the weight grads

enum Stage { kA = 0, kB = 1, kC = 2, kD = 3 };

// 16 bytes global -> shared without the registers; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, register i receives it in the mma layout
// (lane t: row t / 4, columns 2 (t % 4), + 1); .trans transposes each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory of a block at padded width P
template <int P>
struct Smem {
  static constexpr int LD = P + 8;  // bf16 row stride: ldmatrix's 8 rows in distinct banks
  static constexpr int ES = P + 4;  // fp32 row stride of the epilogue tile
  static constexpr size_t rows = sizeof(bf16) * BM * LD;             // 128 gathered rows
  static constexpr size_t stage = rows + sizeof(bf16) * P * LD;      // and one tap's weights
  static constexpr size_t epi = sizeof(float) * ((size_t)BM * ES + 2 * NW * P);
  static constexpr size_t bytes = 2 * stage > epi ? 2 * stage : epi;  // a stage kernel
  static constexpr size_t wgrad = 4 * rows;  // the weight grads: A and B tiles, two buffers
};

// the operands, scratch and outputs of one call
struct Args {
  const bf16 *x, *gout;
  const float *ln_s, *ln_b, *w1, *b1, *w2, *b2;  // w1 (k C, F), w2 (9 F, C), fp32
  bf16* wt;                  // (2 k + 18) P x P tiles: w1[d], w1[d]^T, w2[t], w2[t]^T
  bf16 *xl, *g, *drh, *dhb;  // (N, C), (N, F), (N, C), (N, F)
  float *hb, *dr;            // (N, F), (N, C)
  float* pw;     // weight-grad partials: per chunk, (k + 9) taps of C F
  float* ptile;  // per 128-position tile: db1 (F), db2, d ln_scale, d ln_bias (C each)
  bf16* dx;
  int N, T, H, W, C, F, k;
};

// Scratch of one call, in floats (a bf16 array takes half a float per
// element), in this order (ops/temporal_net.py, bwd_scratch_floats,
// computes the same total); every array starts on a 16-byte boundary
struct Layout {
  bf16 *wt, *xl, *g, *drh, *dhb;
  float *hb, *dr, *pw, *ptile;
  size_t total;
  Layout(float* base, size_t N, size_t C, size_t F, size_t k, size_t P, size_t tiles) {
    float* f = base;
    auto halves = [&f](size_t n) { bf16* p = reinterpret_cast<bf16*>(f); f += n / 2; return p; };
    auto floats = [&f](size_t n) { float* p = f; f += n; return p; };
    wt = halves((2 * k + 18) * P * P);
    xl = halves(N * C);
    g = halves(N * F);
    drh = halves(N * C);
    dhb = halves(N * F);
    hb = floats(N * F);
    dr = floats(N * C);
    pw = floats(kChunks * (k + 9) * C * F);
    ptile = floats(tiles * (F + 3 * C));
    total = (size_t)(f - base);
  }
};

// rows r of a 128-row tile from rows srow[r] of a (*, K) bf16 array (zeros
// where srow[r] < 0 and in the pad channels K .. P)
template <int P>
__device__ __forceinline__ void gather(bf16* dst, const bf16* __restrict__ src, int K,
                                       const int* srow) {
  constexpr int LD = P + 8, PC = P / 8;
  for (int c = threadIdx.x; c < BM * PC; c += NTH) {
    const int r = c / PC, ch = c % PC;
    const int s = srow[r];
    const bool ok = s >= 0 && ch * 8 < K;
    cp_async16(dst + r * LD + ch * 8, src + (ok ? (size_t)s * K + ch * 8 : 0), ok);
  }
}

// acc (16 x P) += the warp's 16 rows Rw (16 x P) times Ws (P x P, row-major)
template <int P>
__device__ __forceinline__ void rows_times_weights(const bf16* Rw, const bf16* Ws,
                                                   float (&acc)[P / 8][4]) {
  constexpr int LD = P + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, Rw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < P / 16; ++j) {
      // rows kk*16 + 0..7, 8..15 at columns 16 j + 0..7, then at + 8..15
      uint32_t b[4];
      ldsm_x4_trans(b, Ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 16 +
                           (lane >> 4) * 8);
      mma_16816(acc[2 * j], a, b[0], b[1]);
      mma_16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x P) += As[:, m0 .. m0 + 16)^T Bs over the tile's 128 positions
// (As, Bs: 128 x P, row-major)
template <int P>
__device__ __forceinline__ void a_t_b(const bf16* As, const bf16* Bs, int m0,
                                      float (&acc)[P / 8][4]) {
  constexpr int LD = P + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk) {
    // A^T's (m 0..7, k 0..7), (m 8..15, k 0..7), (m 0..7, k 8..15), (m 8..15, k 8..15)
    uint32_t a[4];
    ldsm_x4_trans(a, As + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + m0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < P / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + j * 16 +
                           (lane >> 4) * 8);
      mma_16816(acc[2 * j], a, b[0], b[1]);
      mma_16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// xl = LN(x) in bf16, one warp per position; the first (2 k + 18) P^2
// threads also pack the weight tiles
template <int P>
__global__ void __launch_bounds__(NTH) k3_prepare_kernel(const Args a) {
  const int k = a.k, C = a.C, F = a.F;
  const long i = (long)blockIdx.x * NTH + threadIdx.x;
  if (i < (long)(2 * k + 18) * P * P) {
    const int tile = (int)(i / (P * P)), r = (int)(i / P % P), c = (int)(i % P);
    float v = 0.f;
    if (tile < k) {  // w1[d]: C x F
      if (r < C && c < F) v = a.w1[((size_t)tile * C + r) * F + c];
    } else if (tile < 2 * k) {  // w1[d]^T: F x C
      if (r < F && c < C) v = a.w1[((size_t)(tile - k) * C + c) * F + r];
    } else if (tile < 2 * k + 9) {  // w2[t]: F x C
      if (r < F && c < C) v = a.w2[((size_t)(tile - 2 * k) * F + r) * C + c];
    } else {  // w2[t]^T: C x F
      if (r < C && c < F) v = a.w2[((size_t)(tile - 2 * k - 9) * F + c) * C + r];
    }
    a.wt[i] = __float2bfloat16_rn(v);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * NW + warp;
  if (p >= a.N) return;
  const bf16* xr = a.x + (size_t)p * C;
  float v[4], s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < C ? __bfloat162float(xr[c]) : 0.f;
    s += v[j];
  }
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = lane + 32 * j < C ? v[j] - mu : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + kEps);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = lane + 32 * j;
    if (c < C)
      a.xl[(size_t)p * C + c] = __float2bfloat16_rn((v[j] - mu) * rstd * a.ln_s[c] + a.ln_b[c]);
  }
}

// Stage S over the block's 128 positions: for each tap, the 128 source
// rows (gathered) times that tap's weight tile, summed in registers; then
//   kA: hb = acc + b1 (fp32), g = qgelu(hb) (bf16)
//   kB: dr = qgelu'(x + acc + b2) gout (fp32 and bf16); db2's tile partial
//   kC: dhb = qgelu'(hb) acc (bf16); db1's tile partial
//   kD: the LayerNorm backward with LN recomputed, dx = dr + dx_ln (bf16);
//       the tile partials of d ln_scale and d ln_bias
// The taps: kA the temporal ones (LN(x) at frame t + d - k/2), kB the 3x3
// ones (g at pixel (y + dy, x + dx)); kC and kD their transposes (dr at
// (y - dy, x - dx), dhb at frame t - d + k/2).
template <int P, int S>
__global__ void __launch_bounds__(NTH, 2) k3_stage_kernel(const Args a) {
  using L = Smem<P>;
  constexpr int LD = L::LD, ES = L::ES, PC = P / 8;
  constexpr bool kTemporal = S == kA || S == kD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int srow[2][BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * BM;
  const int HW = a.H * a.W, pad = a.k / 2;
  const int ntaps = kTemporal ? a.k : 9;
  // the gathered operand's width K and the output's width
  const int K = S == kA || S == kC ? a.C : a.F;
  const int Nout = S == kA || S == kC ? a.F : a.C;
  const bf16* src = S == kA ? a.xl : S == kB ? a.g : S == kC ? a.drh : a.dhb;
  const bf16* wt =
      a.wt + (size_t)(S == kA ? 0 : S == kD ? a.k : S == kB ? 2 * a.k : 2 * a.k + 9) * P * P;

  // the source row of tile row r for a tap, -1 for zeros
  auto source = [&](int tap, int r) {
    const int p = p0 + r;
    if (p >= a.N) return -1;
    if (kTemporal) {
      const int dt = S == kA ? tap - pad : pad - tap;
      const int t = (p / HW) % a.T + dt;
      return t >= 0 && t < a.T ? p + dt * HW : -1;
    }
    const int dy = S == kB ? tap / 3 - 1 : 1 - tap / 3;
    const int dx = S == kB ? tap % 3 - 1 : 1 - tap % 3;
    const int yx = p % HW, y = yx / a.W + dy, xx = yx % a.W + dx;
    return y >= 0 && y < a.H && xx >= 0 && xx < a.W ? p + dy * a.W + dx : -1;
  };
  auto buffer = [&](int b) { return reinterpret_cast<bf16*>(smem + b * L::stage); };
  auto issue = [&](int tap, int b) {
    bf16* Rs = buffer(b);
    gather<P>(Rs, src, K, srow[b]);
    const bf16* w = wt + (size_t)tap * P * P;
    bf16* Ws = Rs + BM * LD;
    for (int c = threadIdx.x; c < P * PC; c += NTH) {
      const int r = c / PC, ch = c % PC;
      cp_async16(Ws + r * LD + ch * 8, w + r * P + ch * 8, true);
    }
  };

  float acc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (threadIdx.x < BM) srow[0][threadIdx.x] = source(0, threadIdx.x);
  __syncthreads();
  issue(0, 0);
  cp_async_commit();
  for (int tap = 0; tap < ntaps; ++tap) {
    const int nb = (tap + 1) & 1;
    if (tap + 1 < ntaps && threadIdx.x < BM) srow[nb][threadIdx.x] = source(tap + 1, threadIdx.x);
    __syncthreads();  // srow[nb] written; every warp is done with buffer nb
    if (tap + 1 < ntaps) issue(tap + 1, nb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tap's rows and weights have landed
    const bf16* Rs = buffer(tap & 1);
    rows_times_weights<P>(Rs + warp * 16 * LD, Rs + BM * LD, acc);
  }
  __syncthreads();  // every warp is done with the buffers: the epilogue tile reuses them

  // the accumulators into an fp32 tile (row r, column c at Es[r ES + c])
  float* Es = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      float* e = Es + (warp * 16 + g) * ES + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(e) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(e + 8 * ES) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  const int nrows = min(BM, a.N - p0);

  if constexpr (S == kA) {
#pragma unroll 4
    for (int i = threadIdx.x; i < BM * P; i += NTH) {
      const int r = i / P, f = i % P;
      if (r < nrows && f < Nout) {
        const size_t o = (size_t)(p0 + r) * Nout + f;
        const float h = Es[r * ES + f] + a.b1[f];
        a.hb[o] = h;
        a.g[o] = __float2bfloat16_rn(qgelu(h));
      }
    }
  } else if constexpr (S == kB || S == kC) {
#pragma unroll 4
    for (int i = threadIdx.x; i < BM * P; i += NTH) {
      const int r = i / P, c = i % P;
      if (r < nrows && c < Nout) {
        const size_t o = (size_t)(p0 + r) * Nout + c;
        float d;
        if constexpr (S == kB) {
          d = qgelu_grad(__bfloat162float(a.x[o]) + Es[r * ES + c] + a.b2[c]) *
              __bfloat162float(a.gout[o]);
          a.dr[o] = d;
          a.drh[o] = __float2bfloat16_rn(d);
        } else {
          d = qgelu_grad(a.hb[o]) * Es[r * ES + c];
          a.dhb[o] = __float2bfloat16_rn(d);
        }
        Es[r * ES + c] = d;
      }
    }
    __syncthreads();
    // the tile's bias-grad partial: fp32 column sums, rows in order
    float* part = a.ptile + (size_t)blockIdx.x * (a.F + 3 * a.C) + (S == kB ? a.F : 0);
    for (int c = threadIdx.x; c < Nout; c += NTH) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += Es[r * ES + c];
      part[c] = s;
    }
  } else {  // kD: one warp per position
    constexpr int CJ = P / 32;
    const int C = a.C;
    float s1[CJ], s2[CJ];  // this warp's column sums of dxl z and dxl
#pragma unroll
    for (int j = 0; j < CJ; ++j) s1[j] = s2[j] = 0.f;
    for (int r = warp; r < nrows; r += NW) {
      const int p = p0 + r;
      const bf16* xr = a.x + (size_t)p * C;
      const float* dxl = Es + r * ES;
      float z[CJ], s = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        z[j] = c < C ? __bfloat162float(xr[c]) : 0.f;
        s += z[j];
      }
      const float mu = warp_sum(s) / C;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float d = lane + 32 * j < C ? z[j] - mu : 0.f;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / C + kEps);
      float sdz = 0.f, sdzz = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        if (c < C) {
          z[j] = (z[j] - mu) * rstd;
          const float dz = dxl[c] * a.ln_s[c];
          sdz += dz;
          sdzz += dz * z[j];
          s1[j] += dxl[c] * z[j];
          s2[j] += dxl[c];
        }
      }
      const float mean_dz = warp_sum(sdz) / C, mean_dzz = warp_sum(sdzz) / C;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        if (c < C) {
          const size_t o = (size_t)p * C + c;
          const float dz = dxl[c] * a.ln_s[c];
          a.dx[o] = __float2bfloat16_rn(a.dr[o] + rstd * (dz - mean_dz - z[j] * mean_dzz));
        }
      }
    }
    float* W1 = Es + BM * ES;
    float* W2 = W1 + NW * P;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      W1[warp * P + lane + 32 * j] = s1[j];
      W2[warp * P + lane + 32 * j] = s2[j];
    }
    __syncthreads();
    float* part = a.ptile + (size_t)blockIdx.x * (a.F + 3 * C) + a.F + C;
    for (int c = threadIdx.x; c < C; c += NTH) {
      float t1 = 0.f, t2 = 0.f;
      for (int w = 0; w < NW; ++w) {
        t1 += W1[w * P + c];
        t2 += W2[w * P + c];
      }
      part[c] = t1;
      part[C + c] = t2;
    }
  }
}

// Weight grads: block (tap, chunk) sums A_tap(p)^T B(p) over its chunk of
// positions, 128 at a time, into a (Ka x Kb) fp32 partial:
//   tap < k:  A = LN(x) at frame shift tap - k/2 (zero outside the clip),
//             B = dhb: dw1[tap] (C x F)
//   else:     A = g at the 3x3 offset of tap - k (zero outside the image),
//             B = dr: dw2[tap - k] (F x C)
// Warp w < P / 16 owns rows 16 w .. 16 w + 15 of the partial.
template <int P>
__global__ void __launch_bounds__(NTH, 2) k3_wgrad_kernel(const Args a, int chunk_len) {
  using L = Smem<P>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int srcA[2][BM], srcB[2][BM];
  const int tap = blockIdx.x, chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HW = a.H * a.W, pad = a.k / 2;
  const bool temporal = tap < a.k;
  const int Ka = temporal ? a.C : a.F, Kb = temporal ? a.F : a.C;
  const bf16* A = temporal ? a.xl : a.g;
  const bf16* B = temporal ? a.dhb : a.drh;
  const int p_begin = chunk * chunk_len, p_end = min(a.N, p_begin + chunk_len);
  const int ntiles = p_end > p_begin ? (p_end - p_begin + BM - 1) / BM : 0;

  // the source rows of tile i's positions (thread r < BM: row r)
  auto sources = [&](int i, int b) {
    const int r = threadIdx.x, p = p_begin + i * BM + r;
    int s = -1;
    if (p < p_end) {
      if (temporal) {
        const int dt = tap - pad, t = (p / HW) % a.T + dt;
        if (t >= 0 && t < a.T) s = p + dt * HW;
      } else {
        const int dy = (tap - a.k) / 3 - 1, dx = (tap - a.k) % 3 - 1;
        const int yx = p % HW, y = yx / a.W + dy, xx = yx % a.W + dx;
        if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) s = p + dy * a.W + dx;
      }
    }
    srcA[b][r] = s;
    srcB[b][r] = p < p_end ? p : -1;
  };
  auto tile_a = [&](int b) { return reinterpret_cast<bf16*>(smem + (size_t)b * 2 * L::rows); };
  auto issue = [&](int b) {
    gather<P>(tile_a(b), A, Ka, srcA[b]);
    gather<P>(tile_a(b) + BM * LD, B, Kb, srcB[b]);
  };

  float acc[P / 8][4];
#pragma unroll
  for (int j = 0; j < P / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  if (ntiles > 0) {
    if (threadIdx.x < BM) sources(0, 0);
    __syncthreads();
    issue(0);
    cp_async_commit();
    for (int i = 0; i < ntiles; ++i) {
      const int nb = (i + 1) & 1;
      if (i + 1 < ntiles && threadIdx.x < BM) sources(i + 1, nb);
      __syncthreads();  // sources written; every warp is done with buffer nb
      if (i + 1 < ntiles) issue(nb);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // tile i has landed
      if (warp < P / 16) a_t_b<P>(tile_a(i & 1), tile_a(i & 1) + BM * LD, warp * 16, acc);
    }
  }

  float* out = a.pw + ((size_t)chunk * (a.k + 9) + tap) * a.C * a.F;
  if (warp < P / 16) {
    const int g = lane >> 2, t4 = lane & 3, m = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int n = j * 8 + 2 * t4;
      if (n < Kb) {
        if (m < Ka) *reinterpret_cast<float2*>(out + (size_t)m * Kb + n) = make_float2(acc[j][0], acc[j][1]);
        if (m + 8 < Ka)
          *reinterpret_cast<float2*>(out + (size_t)(m + 8) * Kb + n) = make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// Fixed-order column sums of an (R, M) fp32 array into up to four
// outputs: column m < end[0] into out[0][m], then m - end[0] into out[1],
// and so on; M = end[3]. 32 columns a block, 32 lanes of rows striding
// over r, then the 32 lanes' partials in order.
struct Segments {
  float* out[4];
  int end[4];
};

__global__ void __launch_bounds__(1024) k3_sum_kernel(const float* __restrict__ in, int R,
                                                      Segments s) {
  __shared__ float part[32][33];
  const int M = s.end[3];
  const int m = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (m < M)
    for (int r = threadIdx.y; r < R; r += 32) acc += in[(size_t)r * M + m];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && m < M) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 32; ++i) t += part[i][threadIdx.x];
    int i = 0;
    while (m >= s.end[i]) ++i;
    s.out[i][m - (i ? s.end[i - 1] : 0)] = t;
  }
}

cudaError_t sum_columns(const float* in, int R, const Segments& s, cudaStream_t st) {
  k3_sum_kernel<<<(s.end[3] + 31) / 32, dim3(32, 32), 0, st>>>(in, R, s);
  return cudaGetLastError();
}

// the kernel's shared memory limit raised to its need, shared memory
// preferred over L1 so that two blocks fit on an SM
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  DTT_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int P>
cudaError_t prepare_all() {
  using L = Smem<P>;
  DTT_TRY(prepare(k3_stage_kernel<P, kA>, L::bytes));
  DTT_TRY(prepare(k3_stage_kernel<P, kB>, L::bytes));
  DTT_TRY(prepare(k3_stage_kernel<P, kC>, L::bytes));
  DTT_TRY(prepare(k3_stage_kernel<P, kD>, L::bytes));
  return prepare(k3_wgrad_kernel<P>, L::wgrad);
}

template <int P>
cudaError_t launch(const Args& a, float* dlns, float* dlnb, float* dw1, float* db1, float* dw2,
                   float* db2, cudaStream_t st) {
  using L = Smem<P>;
  DTT_TRY(prepare_all<P>());
  const int tiles = (a.N + BM - 1) / BM;
  const int chunk_len = ((tiles + kChunks - 1) / kChunks) * BM;
  const int ln_blocks = (a.N + NW - 1) / NW;
  const int pack_blocks = (int)(((long)(2 * a.k + 18) * P * P + NTH - 1) / NTH);
  const int prep_blocks = ln_blocks > pack_blocks ? ln_blocks : pack_blocks;
  k3_prepare_kernel<P><<<prep_blocks, NTH, 0, st>>>(a);
  DTT_TRY(cudaGetLastError());
  k3_stage_kernel<P, kA><<<tiles, NTH, L::bytes, st>>>(a);
  DTT_TRY(cudaGetLastError());
  k3_stage_kernel<P, kB><<<tiles, NTH, L::bytes, st>>>(a);
  DTT_TRY(cudaGetLastError());
  k3_stage_kernel<P, kC><<<tiles, NTH, L::bytes, st>>>(a);
  DTT_TRY(cudaGetLastError());
  k3_wgrad_kernel<P><<<dim3(a.k + 9, kChunks), NTH, L::wgrad, st>>>(a, chunk_len);
  DTT_TRY(cudaGetLastError());
  k3_stage_kernel<P, kD><<<tiles, NTH, L::bytes, st>>>(a);
  DTT_TRY(cudaGetLastError());
  const int cf = a.C * a.F, wend = (a.k + 9) * cf;
  DTT_TRY(sum_columns(a.pw, kChunks, {{dw1, dw2, nullptr, nullptr}, {a.k * cf, wend, wend, wend}},
                      st));
  return sum_columns(a.ptile, tiles,
                     {{db1, db2, dlns, dlnb}, {a.F, a.F + a.C, a.F + 2 * a.C, a.F + 3 * a.C}}, st);
}

// the padded width for C and F (both multiples of 8, <= 128)
int padded(int C, int F) { return ((C > F ? C : F) + 31) / 32 * 32; }

cudaError_t dispatch(const Args& a, float* dlns, float* dlnb, float* dw1, float* db1,
                     float* dw2, float* db2, cudaStream_t st) {
  switch (padded(a.C, a.F)) {
    case 32: return launch<32>(a, dlns, dlnb, dw1, db1, dw2, db2, st);
    case 64: return launch<64>(a, dlns, dlnb, dw1, db1, dw2, db2, st);
    case 96: return launch<96>(a, dlns, dlnb, dw1, db1, dw2, db2, st);
    case 128: return launch<128>(a, dlns, dlnb, dw1, db1, dw2, db2, st);
    default: return cudaErrorInvalidValue;
  }
}

// which: 0-3 the stage kernels A-D, 4 the weight grads
template <int P>
cudaError_t occupancy(int which, int* blocks, int* bytes) {
  using L = Smem<P>;
  const void* fns[5] = {reinterpret_cast<const void*>(k3_stage_kernel<P, kA>),
                        reinterpret_cast<const void*>(k3_stage_kernel<P, kB>),
                        reinterpret_cast<const void*>(k3_stage_kernel<P, kC>),
                        reinterpret_cast<const void*>(k3_stage_kernel<P, kD>),
                        reinterpret_cast<const void*>(k3_wgrad_kernel<P>)};
  *bytes = (int)(which == 4 ? L::wgrad : L::bytes);
  DTT_TRY(prepare_all<P>());
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fns[which], NTH, *bytes);
}

}  // namespace k3

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
// (k*F, C) and w2t (9*C, F) the same taps transposed, read by the fp32
// route only. The route follows the type: fp32 on the CUDA cores (scratch:
// BwdLayout), bf16 on the tensor cores (C and F multiples of 8, scratch
// 16-byte aligned: k3::Layout). scratch: fp32 of scratch_floats elements.
// Outputs, fp32: dlns, dlnb (C); dw1 (k*C, F); db1 (F); dw2 (9*F, C); db2
// (C). A dozen launches on `stream`; returns the first error.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {  // the tensor cores; rows move as 16-byte copies
    if (C % 8 || F % 8) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(scratch) % 16) return cudaErrorMisalignedAddress;
    const int tiles = (N + k3::BM - 1) / k3::BM;
    const k3::Layout S(scratch, N, C, F, k, k3::padded(C, F), tiles);
    if (S.total != (size_t)scratch_floats) return cudaErrorInvalidValue;
    const k3::Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gout),
                     ln_s, ln_b, w1p, b1, w2p, b2, S.wt, S.xl, S.g, S.drh, S.dhb, S.hb, S.dr,
                     S.pw, S.ptile, static_cast<__nv_bfloat16*>(dx), N, Tn, H, W, C, F, k};
    return k3::dispatch(a, dlns, dlnb, dw1, db1, dw2, db2, st);
  }
  const int tiles = (N + BM - 1) / BM;
  const BwdLayout L(scratch, N, C, F, k, tiles);
  if (L.total != (size_t)scratch_floats) return cudaErrorInvalidValue;
  const int nj = ((C > F ? C : F) + 31) / 32 * 2;
  return dispatch_bwd<float>(nj, x, gout, ln_s, ln_b, w1p, w1t, b1, w2p, w2t, b2, L, dx, dlns,
                             dlnb, dw1, db1, dw2, db2, N, Tn, H, W, C, F, k, st);
}

// K3's bf16 route at channels C, F: the blocks of one kernel resident on an
// SM (occupancy calculator) into *blocks and its dynamic shared memory per
// block into *bytes. which: 0-3 the stage kernels A-D, 4 the weight grads.
extern "C" int dtt_temporal_net_bwd_occupancy(int C, int F, int which, int* blocks, int* bytes) {
  if (C <= 0 || F <= 0 || C > 128 || F > 128 || which < 0 || which > 4)
    return cudaErrorInvalidValue;
  switch (k3::padded(C, F)) {
    case 32: return k3::occupancy<32>(which, blocks, bytes);
    case 64: return k3::occupancy<64>(which, blocks, bytes);
    case 96: return k3::occupancy<96>(which, blocks, bytes);
    default: return k3::occupancy<128>(which, blocks, bytes);
  }
}

extern "C" const char* dtt_temporal_net_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
