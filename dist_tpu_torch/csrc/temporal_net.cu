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

// stage A: g (N, F) fp32 = qgelu(temporal conv of LN(x) + b1)
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
temporal_stage_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, const float* __restrict__ w1,
                      const float* __restrict__ b1, float* __restrict__ g, int N, int Tn, int HW,
                      int C, int F, int k) {
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
      if (f < F) g[(size_t)p * F + f] = qgelu(acc[i][j] + b1[f]);
    }
  }
}

// stage B: out (N, C) = qgelu(x + 3x3 spatial conv of g + b2), in T
template <typename T, int NJ>
__global__ void __launch_bounds__(NT)
spatial_stage_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     T* __restrict__ out, int N, int H, int W, int C, int F) {
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
        const float r = to_f(x[(size_t)p * C + c]) + acc[i][j] + b2[c];
        out[(size_t)p * C + c] = from_f<T>(qgelu(r));
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
      static_cast<const T*>(x), ln_s, ln_b, w1, b1, g, N, Tn, H * W, C, F, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spatial_stage_kernel<T, NJB><<<blocks, NT, smem_b, stream>>>(
      static_cast<const T*>(x), g, w2, b2, static_cast<T*>(out), N, H, W, C, F);
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

extern "C" const char* dtt_temporal_net_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
