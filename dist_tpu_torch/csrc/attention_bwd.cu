// K1b (dtt_attention_qkv_bwd): the backward of the fused multi-head attention
// over the fused (B, L, 3D) qkv projection (K1, csrc/attention.cu).
//
// It replaces no Pallas kernel: the JAX package's fused_attention_qkv is a
// custom_vjp whose backward is the vjp of its reference math, recomputed from
// qkv (dist_tpu/ops/attention.py::_bwd, :124-131), which XLA compiles. The
// port trains a CLIP tower through K1, and a CUDA tensor goes to a kernel or
// raises, so the backward is a kernel of its own. For each batch row and head
// h, with s = hd^-1/2 and dO the cotangent of O:
//   S  = s Q_h K_h^T            fp32 (recomputed as K1 computes it)
//   P  = softmax(S)             fp32, causal mask optional
//   dV = round(P)^T dO          P rounded to the input type, as P V reads it
//   dP = round(dO V_h^T)        rounded to the input type, as the vjp of the
//                               plain version rounds it
//   dS = P o (dP - D),          D = rowsum(P o dP)
//   dQ = s dS K_h,   dK = s dS^T Q_h
// each written into its third of the (B, L, 3D) output in the input type.
// ops/attention.py::attention_qkv_bwd_plain spells out the same arithmetic.
//
// The bound. At the train shape (256, 197, 2304), 12 heads, bf16, the
// function reads qkv and dO and writes dqkv once, 542.2 MB, 0.162 ms at 3.35
// TB/s, against 5 products of 2 L^2 hd per (row, head), 0.077 ms at 989
// TFLOP/s: bytes-bound.
//
// Design: simple first, FlashAttention-2's split. No float atomics: each
// output element is written by one block, so two launches agree bit for bit.
//   pass A  one block per (row, head, 64-query tile): Q and dO tiles in
//           shared memory; keys and values stream in chunks of 64. A first
//           sweep folds each query row's max m, sum l and sum of
//           exp(S - m) dP (online rescaling, so D = that / l) over the chunks;
//           a second sweep recomputes S and dP, forms dS and accumulates
//           dQ = dS K. Writes dQ and each row's (m, l, D) to a scratch buffer.
//   pass B  one block per (row, head, 64-key tile): K and V tiles in shared
//           memory; queries, dO and their (m, l, D) stream in chunks of 64
//           (under the causal mask from the tile's first key on). Per chunk
//           it recomputes S^T and dP^T, forms P and dS, and accumulates
//           dV = P^T dO and dK = dS^T Q. Writes dK and dV.
// Four warps a block, each owning 16 rows of the tile. The products are
// warp-level: in bf16 nvcuda::wmma 16x16x16 (bf16 in, fp32 sums; dS is
// rounded to bf16 to enter the tensor cores), in fp32 the CUDA cores with a
// 4 x 8 register tile a lane. The softmax and dS go through shared memory,
// two lanes a row. Every product is recomputed once more than the minimum
// (S three times, dP twice): the design spends operations, which the
// function does not lack, to keep the blocks independent.
// Shared memory a block at hd 64: 90,880 bytes in bf16 (two blocks an SM),
// 139,520 in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BT = 64;       // rows of a block's own tile (queries in A, keys in B)
constexpr int BC = 64;       // rows of a streamed chunk
constexpr int NW = 4;        // warps a block, 16 tile rows each
constexpr int NT = 32 * NW;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to the input type and back
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

template <typename T, int HD>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LD = HD + (kBf16 ? 8 : 4);   // element row stride of the row tiles
  static constexpr int PS = BC + (kBf16 ? 8 : 4);   // element row stride of a warp's P, dS
  // fp32 row stride of a warp's S and dP tiles; in bf16 they also stage a
  // 16 x HD accumulator on its way out
  static constexpr int SW = (kBf16 && HD > BC ? HD : BC) + 4;
  static constexpr size_t tiles = sizeof(T) * (size_t)(2 * BT + 2 * BC) * LD;
  static constexpr size_t scores = sizeof(float) * (size_t)2 * NW * 16 * SW;
  static constexpr size_t probs = sizeof(T) * (size_t)2 * NW * 16 * PS;
  static constexpr size_t stats = sizeof(float) * 3 * BC;
  static constexpr size_t bytes = tiles + scores + probs + stats;
};

// ROWS rows of one head's slice (columns col .. col + HD of rows r0 ..) of a
// row-major matrix with row stride rs into dst (row stride LD), zero past L:
// 16-byte loads (the wrapper checks the alignment), all issued before the
// stores
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ base, size_t rs, int col, int r0,
                                          int L, T* dst) {
  constexpr int LD = Layout<T, HD>::LD, EPC = 16 / sizeof(T), CH = HD / EPC;
  constexpr int PER = ROWS * CH / NT;
  static_assert(ROWS * CH % NT == 0, "tile not a multiple of the block's loads");
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * EPC;
    v[i] = r0 + r < L ? *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * rs + col + d)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * EPC;
    *reinterpret_cast<uint4*>(dst + r * LD + d) = v[i];
  }
}

// ---------------------------------------------------------------------------
// warp-level products. mm_nt: C (16 x BC, fp32, stride SW) = A B^T with A
// the warp's 16 rows (stride LD) and B a BC-row tile (stride LD). Acc: a 16 x
// HD sum, acc += A B with A 16 x BC (stride PS) and B a BC-row tile.

template <typename T, int HD>
struct Ops;

template <int HD>
struct Ops<bf16, HD> {
  using Lay = Layout<bf16, HD>;
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  static __device__ __forceinline__ void mm_nt(const bf16* A, const bf16* B, float* C) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
    Frag c[BC / 16];
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16, Lay::LD);
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        wmma::load_matrix_sync(bt, B + j * 16 * Lay::LD + kk * 16, Lay::LD);
        wmma::mma_sync(c[j], a, bt, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BC / 16; ++j)
      wmma::store_matrix_sync(C + j * 16, c[j], Lay::SW, wmma::mem_row_major);
  }

  struct Acc {
    Frag f[HD / 16];

    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(f[j], 0.f);
    }

    __device__ __forceinline__ void mma(const bf16* A, const bf16* B) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wmma::load_matrix_sync(a, A + kk * 16, Lay::PS);
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          wmma::load_matrix_sync(b, B + kk * 16 * Lay::LD + j * 16, Lay::LD);
          wmma::mma_sync(f[j], a, b, f[j]);
        }
      }
    }

    // mul * the sum, rounded to bf16, into rows r0 .. r0 + 15 (those < L) of
    // columns col .. of out (row stride rs), through the warp's fp32 tile
    __device__ __forceinline__ void store(float* stage, bf16* __restrict__ out, size_t rs,
                                          int col, int r0, int L, float mul, int lane) {
      constexpr int CH = HD / 8;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
        wmma::store_matrix_sync(stage + j * 16, f[j], Lay::SW, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * CH / 32; ++i) {
        const int c = lane + 32 * i, r = c / CH, d = (c % CH) * 8;
        uint4 packed;
        bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(mul * stage[r * Lay::SW + d + u]);
        if (r0 + r < L)
          *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * rs + col + d) = packed;
      }
    }
  };
};

template <int HD>
struct Ops<float, HD> {
  using Lay = Layout<float, HD>;

  // lane: rows 4 (lane / 8) + i, columns lane % 8 + 8 j
  static __device__ __forceinline__ void mm_nt(const float* A, const float* B, float* C) {
    const int lane = threadIdx.x & 31, r0 = (lane >> 3) * 4, c0 = lane & 7;
    float c[4][BC / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) c[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[BC / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * Lay::LD + d);
#pragma unroll
      for (int j = 0; j < BC / 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(B + (c0 + 8 * j) * Lay::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BC / 8; ++j) {
          float s = c[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          c[i][j] = s;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) C[(r0 + i) * Lay::SW + c0 + 8 * j] = c[i][j];
  }

  struct Acc {
    float f[4][HD / 8];   // rows 4 (lane / 8) + i, columns lane % 8 + 8 j

    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) f[i][j] = 0.f;
    }

    __device__ __forceinline__ void mma(const float* A, const float* B) {
      const int lane = threadIdx.x & 31, r0 = (lane >> 3) * 4, c0 = lane & 7;
#pragma unroll 4
      for (int kk = 0; kk < BC; ++kk) {
        float a[4], b[HD / 8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * Lay::PS + kk];
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) b[j] = B[kk * Lay::LD + c0 + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) f[i][j] = fmaf(a[i], b[j], f[i][j]);
      }
    }

    __device__ __forceinline__ void store(float*, float* __restrict__ out, size_t rs, int col,
                                          int r0w, int L, float mul, int lane) {
      const int r0 = r0w + (lane >> 3) * 4, c0 = lane & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= L) continue;
        float* dst = out + (size_t)(r0 + i) * rs + col + c0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) dst[8 * j] = mul * f[i][j];
      }
    }
  };
};

// the per-row statistics of pass A, (3, B, H, L): m, l, D
__device__ __forceinline__ size_t stat_at(int which, int b, int h, int row, int B, int H, int L) {
  return (((size_t)which * B + b) * H + h) * L + row;
}

// ---------------------------------------------------------------------------
// pass A: dQ and each query row's (m, l, D); grid (ceil(L / BT), H, B)

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                        T* __restrict__ dqkv, float* __restrict__ stats, int B, int L, int D,
                        int causal, float scale) {
  using Lay = Layout<T, HD>;
  using O = Ops<T, HD>;
  constexpr int LD = Lay::LD, SW = Lay::SW, PS = Lay::PS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BT * LD;
  T* Ks = dOs + BT * LD;
  T* Vs = Ks + BC * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + Lay::tiles) + warp * 16 * SW;
  float* Dw = reinterpret_cast<float*>(smem + Lay::tiles) + (NW + warp) * 16 * SW;
  T* dSw = reinterpret_cast<T*>(smem + Lay::tiles + Lay::scores) + warp * 16 * PS;

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs;
  const T* obase = dout + (size_t)b * L * D;
  load_rows<T, HD, BT>(base, rs, h * HD, q0, L, Qs);
  load_rows<T, HD, BT>(obase, D, h * HD, q0, L, dOs);
  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;

  const int r_w = lane >> 1, par = lane & 1;
  const int row = q0 + warp * 16 + r_w;
  const int kend = causal ? min(L, q0 + BT) : L;

  // sweep 1: m, l and the rescaled sum of exp(S - m) dP
  float m = -INFINITY, l = 0.f, dn = 0.f;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();
    load_rows<T, HD, BC>(base, rs, D + h * HD, k0, L, Ks);
    load_rows<T, HD, BC>(base, rs, 2 * D + h * HD, k0, L, Vs);
    __syncthreads();
    O::mm_nt(Qw, Ks, Sw);
    O::mm_nt(dOw, Vs, Dw);
    __syncwarp();
    float tmax = -INFINITY;
    for (int c = par; c < BC; c += 2) {
      const int col = k0 + c;
      if (row < L && col < L && !(causal && col > row))
        tmax = fmaxf(tmax, Sw[r_w * SW + c] * scale);
    }
    const float mnew = fmaxf(m, fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1)));
    float se = 0.f, sd = 0.f;
    for (int c = par; c < BC; c += 2) {
      const int col = k0 + c;
      if (row < L && col < L && !(causal && col > row)) {
        const float e = expf(Sw[r_w * SW + c] * scale - mnew);
        se += e;
        sd += e * rnd<T>(Dw[r_w * SW + c]);
      }
    }
    se += __shfl_xor_sync(0xffffffffu, se, 1);
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    const float keep = m == -INFINITY ? 0.f : expf(m - mnew);
    l = l * keep + se;
    dn = dn * keep + sd;
    m = mnew;
    __syncwarp();
  }
  const float inv_l = 1.f / l, drow = dn / l;
  if (par == 0 && row < L) {
    stats[stat_at(0, b, h, row, B, H, L)] = m;
    stats[stat_at(1, b, h, row, B, H, L)] = l;
    stats[stat_at(2, b, h, row, B, H, L)] = drow;
  }

  // sweep 2: dS and dQ = dS K
  typename O::Acc dq;
  dq.zero();
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();
    load_rows<T, HD, BC>(base, rs, D + h * HD, k0, L, Ks);
    load_rows<T, HD, BC>(base, rs, 2 * D + h * HD, k0, L, Vs);
    __syncthreads();
    O::mm_nt(Qw, Ks, Sw);
    O::mm_nt(dOw, Vs, Dw);
    __syncwarp();
    for (int c = par; c < BC; c += 2) {
      const int col = k0 + c;
      float ds = 0.f;
      if (row < L && col < L && !(causal && col > row)) {
        const float p = expf(Sw[r_w * SW + c] * scale - m) * inv_l;
        ds = p * (rnd<T>(Dw[r_w * SW + c]) - drow);
      }
      dSw[r_w * PS + c] = from_f<T>(ds);
    }
    __syncwarp();
    dq.mma(dSw, Ks);
    __syncwarp();
  }
  dq.store(Sw, dqkv + (size_t)b * L * rs, rs, h * HD, q0 + warp * 16, L, scale, lane);
}

// ---------------------------------------------------------------------------
// pass B: dK and dV; grid (ceil(L / BT), H, B)

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float* __restrict__ stats, int B, int L,
                         int D, int causal, float scale) {
  using Lay = Layout<T, HD>;
  using O = Ops<T, HD>;
  constexpr int LD = Lay::LD, SW = Lay::SW, PS = Lay::PS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BT * LD;
  T* Qs = Vs + BT * LD;
  T* dOs = Qs + BC * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + Lay::tiles) + warp * 16 * SW;
  float* Dw = reinterpret_cast<float*>(smem + Lay::tiles) + (NW + warp) * 16 * SW;
  T* Pw = reinterpret_cast<T*>(smem + Lay::tiles + Lay::scores) + warp * 16 * PS;
  T* dSw = reinterpret_cast<T*>(smem + Lay::tiles + Lay::scores) + (NW + warp) * 16 * PS;
  float* ms = reinterpret_cast<float*>(smem + Lay::tiles + Lay::scores + Lay::probs);
  float* ils = ms + BC;
  float* ds_ = ils + BC;

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs;
  const T* obase = dout + (size_t)b * L * D;
  load_rows<T, HD, BT>(base, rs, D + h * HD, k0, L, Ks);
  load_rows<T, HD, BT>(base, rs, 2 * D + h * HD, k0, L, Vs);
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;

  const int r_w = lane >> 1, par = lane & 1;
  const int key = k0 + warp * 16 + r_w;
  typename O::Acc dk, dv;
  dk.zero();
  dv.zero();
  // under the causal mask no query before the tile's first key sees it
  for (int q0 = causal ? k0 : 0; q0 < L; q0 += BC) {
    __syncthreads();
    load_rows<T, HD, BC>(base, rs, h * HD, q0, L, Qs);
    load_rows<T, HD, BC>(obase, D, h * HD, q0, L, dOs);
    if (threadIdx.x < BC) {
      const int q = q0 + threadIdx.x;
      const bool in = q < L;
      ms[threadIdx.x] = in ? stats[stat_at(0, b, h, q, B, H, L)] : 0.f;
      ils[threadIdx.x] = in ? 1.f / stats[stat_at(1, b, h, q, B, H, L)] : 0.f;
      ds_[threadIdx.x] = in ? stats[stat_at(2, b, h, q, B, H, L)] : 0.f;
    }
    __syncthreads();
    O::mm_nt(Kw, Qs, Sw);    // S^T: keys x queries
    O::mm_nt(Vw, dOs, Dw);   // dP^T
    __syncwarp();
    for (int c = par; c < BC; c += 2) {
      const int q = q0 + c;
      float p = 0.f, ds = 0.f;
      if (key < L && q < L && !(causal && key > q)) {
        p = expf(Sw[r_w * SW + c] * scale - ms[c]) * ils[c];
        ds = p * (rnd<T>(Dw[r_w * SW + c]) - ds_[c]);
      }
      Pw[r_w * PS + c] = from_f<T>(p);
      dSw[r_w * PS + c] = from_f<T>(ds);
    }
    __syncwarp();
    dv.mma(Pw, dOs);
    dk.mma(dSw, Qs);
    __syncwarp();
  }
  T* out = dqkv + (size_t)b * L * rs;
  dk.store(Sw, out, rs, D + h * HD, k0 + warp * 16, L, scale, lane);
  dv.store(Sw, out, rs, 2 * D + h * HD, k0 + warp * 16, L, 1.f, lane);
}

// ---------------------------------------------------------------------------
// launches

struct Pair {
  const void* dq;
  const void* dkv;
  size_t smem;
};

template <typename T, int HD>
Pair pair_of() {
  return {reinterpret_cast<const void*>(attention_bwd_dq_kernel<T, HD>),
          reinterpret_cast<const void*>(attention_bwd_dkv_kernel<T, HD>),
          Layout<T, HD>::bytes};
}

template <typename T>
Pair pick_t(int hd) {
  switch (hd) {
    case 16: return pair_of<T, 16>();
    case 32: return pair_of<T, 32>();
    case 64: return pair_of<T, 64>();
    case 128: return pair_of<T, 128>();
    default: return {nullptr, nullptr, 0};
  }
}

Pair pick(int hd, int is_bf16) { return is_bf16 ? pick_t<bf16>(hd) : pick_t<float>(hd); }

cudaError_t prepare(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// K1b. qkv (B, L, 3D) and dqkv (B, L, 3D), dout (B, L, D), all contiguous,
// all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), 16-byte aligned; stats a
// float32 scratch of 3 B H L; hd = D / num_heads in {16, 32, 64, 128}.
// Launches pass A, then pass B, on `stream`; returns cudaGetLastError()
// after the launches.
extern "C" int dtt_attention_qkv_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int B, int L, int D, int num_heads, int causal, float scale,
                                     int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || D % num_heads != 0 || num_heads > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (misaligned(qkv) || misaligned(dout) || misaligned(dqkv) || misaligned(stats))
    return cudaErrorMisalignedAddress;  // the tiles move 16-byte vectors
  const Pair k = pick(D / num_heads, is_bf16);
  if (k.dq == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = prepare(k.dq, k.smem);
  if (err == cudaSuccess) err = prepare(k.dkv, k.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, num_heads, B);
  void* args[] = {&qkv, &dout, &dqkv, &stats, &B, &L, &D, &causal, &scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernel(k.dq, grid, dim3(NT), args, k.smem, s);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(k.dkv, grid, dim3(NT), args, k.smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// blocks of pass A (pass = 0) or pass B (pass = 1) resident on one SM, from
// the occupancy calculator; -1 for a head dim not taken or a CUDA error
extern "C" int dtt_attention_bwd_blocks_per_sm(int hd, int is_bf16, int pass) {
  const Pair k = pick(hd, is_bf16);
  const void* fn = pass ? k.dkv : k.dq;
  int blocks = 0;
  if (fn == nullptr || prepare(fn, k.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, k.smem) != cudaSuccess)
    return -1;
  return blocks;
}

// dynamic shared memory a block of either pass, in bytes (0 for a head dim
// not taken)
extern "C" int dtt_attention_bwd_smem_bytes(int hd, int is_bf16) {
  return static_cast<int>(pick(hd, is_bf16).smem);
}

extern "C" const char* dtt_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
