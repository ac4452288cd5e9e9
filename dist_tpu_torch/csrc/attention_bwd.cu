// K1b (dtt_attention_qkv_bwd): the backward of the fused multi-head attention
// over the fused (B, L, 3D) qkv projection (K1, csrc/attention.cu).
//
// What it replaces. No Pallas kernel: the JAX package's fused_attention_qkv
// is a custom_vjp whose backward is the vjp of its reference math,
// recomputed from qkv (dist_tpu/ops/attention.py::_bwd, :124-131), which XLA
// compiles. The port trains a CLIP tower through K1, and a CUDA tensor goes
// to a kernel or raises, so the backward is a kernel of its own. For each
// batch row and head h, with s = hd^-1/2 and dO the cotangent of O:
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
// function reads qkv and dO and writes dqkv once, 542.2 MB: 0.162 ms at
// 3.35 TB/s, against 5 products of 2 L^2 hd per (row, head), 0.077 ms at 989
// TFLOP/s. Bytes-bound.
//
// Two passes, FlashAttention-2's split, on every route: pass dq owns 64
// query rows (dQ and each row's statistics, into a (3, B, H, L) fp32
// scratch), pass dkv 64 keys (dK, dV), one block of 4 warps each, every
// warp 16 rows. Each output element has one writer and no float atomics are
// used, so two launches agree bit for bit. Routes, by the rule of
// whole_row.cuh (ops/attention.py::attention_bwd_route says the same):
//
// whole_row (bf16, hd 16, 32 or 64, L <= 272; instances at LP = 80, 208,
// 272 with CAUSAL a template parameter). Registers hold the scores, as in
// K1's whole-row route; S, P, dP and dS never touch shared memory.
//   pass dq   cp.async brings the Q and dO tiles and the row's whole K_h and
//             V_h (LP rows, zero past L; under the mask only the keys the
//             block reads) in two groups: Q and K, then dO and V, which land
//             while the scores run. A warp keeps its 16 x LP strip of S as
//             mma.sync C fragments (float s[LP/16][2][4] a lane), takes the
//             exact row max and sum in one pass over a quad (shfl_xor), the
//             scale and log2 e folded into ex2, and keeps P in fp32 in the
//             same registers. Sweep 1: dP = dO V^T tile by tile, rounded to
//             bf16, D += P dP (P's and dP's fragments share one layout, so
//             the product is lane-local), D reduced over the quad; up to LP
//             208 the rounded dP stays in registers as bf16 pairs (exact),
//             at LP 272 there is no room and sweep 2 computes it again
//             (there the sweeps visit the key tiles below L behind a
//             branch a tile, which keeps ptxas within 255 registers).
//             Sweep 2: dS = P (dP - D) packed into bf16 A fragments tile by
//             tile (each P tile dies as its dS is packed), then dQ += dS K
//             (K through ldmatrix.trans), dQ in float[hd/8][4]. Writes each
//             row's (m s log2 e, 1 / l, D) and dQ with 16-byte stores from
//             the registers (the lanes of a quad trade pairs until each
//             holds 8 columns).
//   pass dkv  Each warp reads the A fragments of its 16 keys' K and V
//             straight from global memory; cp.async brings the row's whole
//             Q_h and dO_h (under the mask from the block's first key on),
//             the rows' statistics beside them: one barrier. Each warp walks
//             the queries 16 at a time (under the mask from its first key):
//             S^T = K Q^T and dP^T = V dO^T as C fragments, P^T and dS^T
//             formed in registers from each column's statistics, packed
//             into bf16 A fragments, dV += round(P^T) dO and dK += dS^T Q
//             (dO and Q through ldmatrix.trans). No barrier in the loop.
//   Products of 2 L^2 hd a (row, head): 7 up to LP 208 (S twice, dP twice,
//   dQ, dK, dV), 8 at LP 272; the bound counts 5, the rest keeps the
//   blocks independent. Shared memory a block at hd 64: pass dq (128 + 2
//   LP)(hd + 8) bf16, 78,336 bytes at LP 208 and 96,768 at LP 272, two
//   blocks an SM (__launch_bounds__(128, 2)); pass dkv 2 LP (hd + 8) bf16
//   and 12 LP bytes of statistics, 62,400 at LP 208 (three blocks an SM,
//   registers capped to match, one query chunk a loop step) and 81,600 at
//   LP 272 (two, two chunks a step).
//   Why mma.sync and cp.async, not wgmma and TMA: the function is
//   bytes-bound, so the warp-level tensor-core rate is enough; wgmma's
//   64-row warpgroup tiles and shared-memory operands, and TMA's
//   mbarriers and producer warp, buy operations it does not lack.
//
// streaming (bf16 otherwise: L > 272 or hd 128; and on request where the
// rule says whole_row). The design K1b was first written in, kept for the
// lengths and head dims the registers cannot hold: keys (pass A) or
// queries (pass B) stream through shared memory in chunks of 64. Pass A's
// first sweep folds each row's max m, sum l and sum of exp(S - m) dP
// (online rescaling, so D = that / l), a second recomputes S and dP, forms
// dS and accumulates dQ = dS K; pass B recomputes S^T and dP^T per chunk,
// forms P and dS, and accumulates dV = P^T dO and dK = dS^T Q. The
// products are nvcuda::wmma 16x16x16 (bf16 in, fp32 sums; dS rounded to
// bf16); S and dS go through shared memory, two lanes a row. S is computed
// three times, dP twice. 90,880 bytes a block at hd 64.
//
// fp32 (fp32 inputs): the streaming design on the CUDA cores, a 4 x 8
// register tile a lane; 139,520 bytes a block at hd 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "whole_row.cuh"

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

// the per-row statistics pass dq leaves for pass dkv, (3, B, H, L): m, l,
// D on the streaming and fp32 routes; m s log2 e, 1 / l, D on whole_row
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
// whole_row: the row's keys (pass dq) or queries (pass dkv) resident, the
// scores and their gradients in registers

namespace wr {

constexpr float LOG2E = 1.4426950408889634f;

// shared memory of one block, bf16 rows with stride HD + 8 (ldmatrix's 8
// row addresses fall in distinct banks): pass dq holds its Q and dO tiles
// (64 rows) and the row's K_h and V_h (LP rows); pass dkv the row's Q_h and
// dO_h and their statistics (m s log2 e, 1 / l, D), LP floats each. Pass
// dkv reads its K and V fragments straight from global memory, so up to
// LP 208 three of its blocks fit on an SM (registers capped to match).
template <int HD, int LP>
struct Smem {
  static constexpr int LD = HD + 8;
  static constexpr size_t dq = sizeof(bf16) * (size_t)(2 * BT + 2 * LP) * LD;
  static constexpr size_t rows = sizeof(bf16) * (size_t)(2 * LP) * LD;
  static constexpr size_t dkv = rows + sizeof(float) * 3 * LP;
  static constexpr int dkv_blocks = LP <= 208 ? 3 : 2;
};

// rows [r0, r0 + n) of one head's columns (src: row 0 of them, row stride
// rs) into dst's rows 0 .. n - 1 (row stride HD + 8), zero-filled past L
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, size_t rs,
                                          int r0, int n, int L) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int c = threadIdx.x; c < n * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * LD + d, src + (size_t)(ok ? r0 + r : 0) * rs + d, ok);
  }
}

// the A fragments of the warp's 16 rows of a tile (row stride LD), as they are
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const bf16* rows, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// the A fragments of rows r0 .. r0 + 15 of one head's columns (src: row 0
// of them, row stride rs) straight from global memory, zero past L: lane t
// takes rows r0 + t/4 and + 8 at columns 16 kk + 2 (t % 4), + 1 and + 8
template <int HD>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[HD / 16][4],
                                              const bf16* __restrict__ src, size_t rs, int r0,
                                              int L, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, c0 = 2 * (lane & 3);
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(src + (size_t)(ra < L ? ra : 0) * rs + c0);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(src + (size_t)(rb < L ? rb : 0) * rs + c0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a[kk][0] = ra < L ? pa[8 * kk] : 0u;
    a[kk][1] = rb < L ? pb[8 * kk] : 0u;
    a[kk][2] = ra < L ? pa[8 * kk + 4] : 0u;
    a[kk][3] = rb < L ? pb[8 * kk + 4] : 0u;
  }
}

// c (16 x 16, fp32, two n8 tiles) = A B^T over HD: A the warp's fragments,
// B 16 rows of a tile (row stride LD) through ldmatrix as they are
template <int HD>
__device__ __forceinline__ void tile_nt(float (&c)[2][4], const uint32_t (&a)[HD / 16][4],
                                        const bf16* B, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // rows 0..7 at columns 0..7, 8..15, then rows 8..15 at the same
    uint32_t b[4];
    ldsm_x4(b, B + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_16816(c[0], a[kk], b[0], b[1]);
    mma_16816(c[1], a[kk], b[2], b[3]);
  }
}

// acc (16 x HD, fp32) += a (16 x 16, bf16 A fragments) B, B 16 rows of a
// row-major tile (row stride LD) through ldmatrix.trans
template <int HD>
__device__ __forceinline__ void tile_nn(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                        const bf16* B, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int dj = 0; dj < HD / 16; ++dj) {
    // rows 0..7, 8..15 at columns 16 dj + 0..7, then at + 8..15
    uint32_t b[4];
    ldsm_x4_trans(b, B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 + (lane >> 4) * 8);
    mma_16816(acc[2 * dj], a, b[0], b[1]);
    mma_16816(acc[2 * dj + 1], a, b[2], b[3]);
  }
}

// mul * acc (the warp's 16 x HD sum: lane t holds rows t/4 and t/4 + 8 at
// columns 8j + 2 (t % 4), + 1), rounded to bf16, into rows r0 .. r0 + 15
// (those < L) of out (row stride rs) with 16-byte stores from the
// registers: the four lanes of a quad trade their pairs (shfl_xor) until
// each holds whole chunks of 8 columns; chunk c = t % 4 + 4i is row t/4 +
// 8 (c / NJ), columns 8 (c % NJ) .. + 7. The selects keep every index
// static, so nothing goes to local memory.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4], float mul,
                                           bf16* __restrict__ out, size_t rs, int r0, int L,
                                           int lane) {
  constexpr int NJ = HD / 8, NC = 2 * NJ, PER = NC / 4;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t x[NC];   // this lane's pair of chunk c
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    x[j] = pack_bf16(mul * acc[j][0], mul * acc[j][1]);
    x[NJ + j] = pack_bf16(mul * acc[j][2], mul * acc[j][3]);
  }
  uint32_t y[PER][4];   // chunk t4 + 4i: lane q's pair in y[i][q]
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) y[i][q] = 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int peer = t4 ^ r;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      uint32_t send = x[4 * i];   // this lane's pair of the peer's chunk peer + 4i
#pragma unroll
      for (int q = 1; q < 4; ++q) send = peer == q ? x[q + 4 * i] : send;
      const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
      for (int q = 0; q < 4; ++q) y[i][q] = peer == q ? got : y[i][q];
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = t4 + 4 * i, row = r0 + g + 8 * (c / NJ);
    if (row < L)
      *reinterpret_cast<uint4*>(out + (size_t)row * rs + 8 * (c % NJ)) =
          make_uint4(y[i][0], y[i][1], y[i][2], y[i][3]);
  }
}

// x rounded to bf16 and back
__device__ __forceinline__ float rbf(float x) { return rnd<bf16>(x); }

// the low and high bf16 of a pair (pack_bf16's) as fp32, exactly
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// pass dq: dQ and each query row's (m s log2 e, 1 / l, D); grid (ceil(L /
// 64), H, B); `causal` is CAUSAL, fixed by the instance
template <int HD, int LP, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2)
attention_bwd_dq_wr_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           bf16* __restrict__ dqkv, float* __restrict__ stats, int B, int L,
                           int D, int causal, float scale) {
  constexpr int LD = HD + 8, NKT = LP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BT * LD;
  bf16* Ks = dOs + BT * LD;
  bf16* Vs = Ks + LP * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * rs + h * HD;
  const bf16* obase = dout + (size_t)b * L * D + h * HD;

  // the keys any row of the block reads, in whole tiles of 16; without the
  // mask all LP rows (zeros past L), so that every tile is computed
  const int nk = CAUSAL ? (min(L, q0 + BT) + 15) & ~15 : LP;
  copy_rows<HD>(Qs, base, rs, q0, BT, L);
  copy_rows<HD>(Ks, base + D, rs, 0, nk, L);
  cp_async_commit();
  copy_rows<HD>(dOs, obase, D, q0, BT, L);
  copy_rows<HD>(Vs, base + 2 * D, rs, 0, nk, L);
  cp_async_commit();
  cp_async_wait<1>();   // Q and K; dO and V may still be landing
  __syncthreads();

  const int q0w = q0 + warp * 16;
  const bool live = q0w < L;   // a warp whose rows all lie past L only waits
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0w + g, row1 = row0 + 8;
  // under the mask, the warp's keys end at its last row: later tiles skipped
  const int kend = CAUSAL ? min(L, q0w + 16) : LP;
  const float e = scale * LOG2E;

  // S, then P in place: s[t][n] is the n8 tile of keys 16t + 8n + 2 t4, + 1
  // of rows g (s[t][n][0..1]) and g + 8 (s[t][n][2..3])
  float s[NKT][2][4];
  float ms0 = 0.f, ms1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  if (live) {
    uint32_t qa[HD / 16][4];
    load_a<HD>(qa, Qs + warp * 16 * LD, lane);
#pragma unroll
    for (int t = 0; t < NKT; ++t) {
      if (!CAUSAL || t * 16 < kend) {
        tile_nt<HD>(s[t], qa, Ks + t * 16 * LD, lane);
      } else {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[t][n][i] = 0.f;
      }
    }
    // row max over the keys below lim (L, and the row's own index + 1
    // under the mask)
    const int lim0 = CAUSAL ? min(L, row0 + 1) : L;
    const int lim1 = CAUSAL ? min(L, row1 + 1) : L;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < NKT; ++t) {
      if (!CAUSAL || t * 16 < kend) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int c = t * 16 + n * 8 + 2 * t4;
          float* v = s[t][n];
          v[0] = c < lim0 ? v[0] : -INFINITY;
          v[1] = c + 1 < lim0 ? v[1] : -INFINITY;
          v[2] = c < lim1 ? v[2] : -INFINITY;
          v[3] = c + 1 < lim1 ? v[3] : -INFINITY;
          m0 = fmaxf(m0, fmaxf(v[0], v[1]));
          m1 = fmaxf(m1, fmaxf(v[2], v[3]));
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    // key 0 is every row's, so m0 and m1 are finite; exp(s (S - m)) as
    // 2^(S e - m e), e = s log2 e
    ms0 = m0 * e;
    ms1 = m1 * e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int t = 0; t < NKT; ++t) {
      if (!CAUSAL || t * 16 < kend) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* v = s[t][n];
          v[0] = fast_exp2(fmaf(v[0], e, -ms0));
          v[1] = fast_exp2(fmaf(v[1], e, -ms0));
          v[2] = fast_exp2(fmaf(v[2], e, -ms1));
          v[3] = fast_exp2(fmaf(v[3], e, -ms1));
          l0 += v[0] + v[1];
          l1 += v[2] + v[3];
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
#pragma unroll
    for (int t = 0; t < NKT; ++t) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[t][n][0] *= inv0;
        s[t][n][1] *= inv0;
        s[t][n][2] *= inv1;
        s[t][n][3] *= inv1;
      }
    }
  }

  cp_async_wait<0>();   // dO and V
  __syncthreads();
  if (!live) return;

  uint32_t oa[HD / 16][4];
  load_a<HD>(oa, dOs + warp * 16 * LD, lane);

  // sweep 1: dP = round(dO V^T) tile by tile and D = rowsum(P dP); the
  // masked and padded keys have P = 0. Up to LP 208 the rounded dP stays
  // in registers as bf16 pairs (exact: it is rounded to bf16 anyway) for
  // sweep 2; at LP 272 the strip and the kept dP would not fit beside
  // each other, so sweep 2 computes dP again.
  constexpr bool KEEP_DP = LP <= 208;
  uint32_t dpk[KEEP_DP ? NKT : 1][2][2];   // [t][n]: rows g, g + 8
  // the key tiles the sweeps and dQ visit: under the mask those before the
  // warp's last row; at LP 272 those below L, a branch a tile that keeps
  // ptxas from scheduling every tile's products at once (which spills
  // there); up to LP 208 every tile, without a branch
  constexpr bool BRANCH = CAUSAL || !KEEP_DP;
  const int vend = CAUSAL ? kend : L;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    if (!BRANCH || t * 16 < vend) {
      float dp[2][4];
      tile_nt<HD>(dp, oa, Vs + t * 16 * LD, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t r0 = pack_bf16(dp[n][0], dp[n][1]), r1 = pack_bf16(dp[n][2], dp[n][3]);
        if constexpr (KEEP_DP) {
          dpk[t][n][0] = r0;
          dpk[t][n][1] = r1;
        }
        d0 = fmaf(s[t][n][0], lo_bf16(r0), d0);
        d0 = fmaf(s[t][n][1], hi_bf16(r0), d0);
        d1 = fmaf(s[t][n][2], lo_bf16(r1), d1);
        d1 = fmaf(s[t][n][3], hi_bf16(r1), d1);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
  if (t4 == 0) {
    if (row0 < L) {
      stats[stat_at(0, b, h, row0, B, H, L)] = ms0;
      stats[stat_at(1, b, h, row0, B, H, L)] = inv0;
      stats[stat_at(2, b, h, row0, B, H, L)] = d0;
    }
    if (row1 < L) {
      stats[stat_at(0, b, h, row1, B, H, L)] = ms1;
      stats[stat_at(1, b, h, row1, B, H, L)] = inv1;
      stats[stat_at(2, b, h, row1, B, H, L)] = d1;
    }
  }

  // sweep 2: dS = P (dP - D), packed into the bf16 A fragments of dQ +=
  // dS K (k-step t: n8 tiles (t, 0), keys 0..7, and (t, 1), 8..15). Each
  // tile's P dies as its dS is packed, and the products run after, so the
  // fp32 strip and dQ's sums are not live together.
  uint32_t dsa[NKT][4];
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    if (!BRANCH || t * 16 < vend) {
      uint32_t r[2][2];
      if constexpr (KEEP_DP) {
#pragma unroll
        for (int n = 0; n < 2; ++n) r[n][0] = dpk[t][n][0], r[n][1] = dpk[t][n][1];
      } else {
        float dp[2][4];
        tile_nt<HD>(dp, oa, Vs + t * 16 * LD, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          r[n][0] = pack_bf16(dp[n][0], dp[n][1]), r[n][1] = pack_bf16(dp[n][2], dp[n][3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* p = s[t][n];
        dsa[t][2 * n] = pack_bf16(p[0] * (lo_bf16(r[n][0]) - d0), p[1] * (hi_bf16(r[n][0]) - d0));
        dsa[t][2 * n + 1] =
            pack_bf16(p[2] * (lo_bf16(r[n][1]) - d1), p[3] * (hi_bf16(r[n][1]) - d1));
      }
    }
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;
#pragma unroll
  for (int t = 0; t < NKT; ++t)
    if (!BRANCH || t * 16 < vend) tile_nn<HD>(dq, dsa[t], Ks + t * 16 * LD, lane);
  store_rows<HD>(dq, scale, dqkv + (size_t)b * L * rs + h * HD, rs, q0w, L, lane);
}

// pass dkv: dK and dV; grid (ceil(L / 64), H, B); `causal` is CAUSAL
template <int HD, int LP, bool CAUSAL>
__global__ void __launch_bounds__(NT, (Smem<HD, LP>::dkv_blocks))
attention_bwd_dkv_wr_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                            bf16* __restrict__ dqkv, const float* __restrict__ stats, int B,
                            int L, int D, int causal, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);    // query q in row q
  bf16* dOs = Qs + LP * LD;
  float* mss = reinterpret_cast<float*>(smem + Smem<HD, LP>::rows);
  float* ils = mss + LP;
  float* Ds = ils + LP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * rs + h * HD;
  const bf16* obase = dout + (size_t)b * L * D + h * HD;

  // the queries that see the block's keys (under the mask from its first
  // key on), in whole tiles of 16: zeros and 1 / l = 0 past L, so P = 0
  const int qs = CAUSAL ? k0 : 0, nq = (L + 15) & ~15;
  copy_rows<HD>(Qs + qs * LD, base, rs, qs, nq - qs, L);
  copy_rows<HD>(dOs + qs * LD, obase, D, qs, nq - qs, L);
  cp_async_commit();
  for (int q = qs + threadIdx.x; q < nq; q += NT) {
    const bool in = q < L;
    mss[q] = in ? stats[stat_at(0, b, h, q, B, H, L)] : 0.f;
    ils[q] = in ? stats[stat_at(1, b, h, q, B, H, L)] : 0.f;
    Ds[q] = in ? stats[stat_at(2, b, h, q, B, H, L)] : 0.f;
  }
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a_global<HD>(ka, base + D, rs, k0 + warp * 16, L, lane);
  load_a_global<HD>(va, base + 2 * D, rs, k0 + warp * 16, L, lane);
  cp_async_wait<0>();
  __syncthreads();

  const int k0w = k0 + warp * 16;
  if (k0w >= L) return;   // no key of this warp's: nothing to write
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0w + g, key1 = key0 + 8;
  const float e = scale * LOG2E;
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  // keys past L (rows of the warp's last tile) give rows of dK and dV that
  // are not stored; a row of an mma's A reaches only that row of its sum.
  // Two chunks a step where the registers allow two blocks an SM only.
#pragma unroll(Smem<HD, LP>::dkv_blocks == 3 ? 1 : 2)
  for (int c = CAUSAL ? k0w : 0; c < nq; c += 16) {
    float st[2][4], dpt[2][4];   // S^T, dP^T: keys g, g + 8; queries c + 8n + 2 t4, + 1
    tile_nt<HD>(st, ka, Qs + c * LD, lane);
    tile_nt<HD>(dpt, va, dOs + c * LD, lane);
    uint32_t pa[4], da[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int q = c + 8 * n + 2 * t4;
      const float2 m2 = *reinterpret_cast<const float2*>(mss + q);
      const float2 i2 = *reinterpret_cast<const float2*>(ils + q);
      const float2 D2 = *reinterpret_cast<const float2*>(Ds + q);
      float p[4];
      p[0] = fast_exp2(fmaf(st[n][0], e, -m2.x)) * i2.x;
      p[1] = fast_exp2(fmaf(st[n][1], e, -m2.y)) * i2.y;
      p[2] = fast_exp2(fmaf(st[n][2], e, -m2.x)) * i2.x;
      p[3] = fast_exp2(fmaf(st[n][3], e, -m2.y)) * i2.y;
      if (CAUSAL) {
        p[0] = key0 <= q ? p[0] : 0.f;
        p[1] = key0 <= q + 1 ? p[1] : 0.f;
        p[2] = key1 <= q ? p[2] : 0.f;
        p[3] = key1 <= q + 1 ? p[3] : 0.f;
      }
      pa[2 * n] = pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = pack_bf16(p[2], p[3]);
      da[2 * n] = pack_bf16(p[0] * (rbf(dpt[n][0]) - D2.x), p[1] * (rbf(dpt[n][1]) - D2.y));
      da[2 * n + 1] =
          pack_bf16(p[2] * (rbf(dpt[n][2]) - D2.x), p[3] * (rbf(dpt[n][3]) - D2.y));
    }
    tile_nn<HD>(dv, pa, dOs + c * LD, lane);
    tile_nn<HD>(dk, da, Qs + c * LD, lane);
  }
  bf16* out = dqkv + (size_t)b * L * rs + h * HD;
  store_rows<HD>(dk, scale, out + D, rs, k0w, L, lane);
  store_rows<HD>(dv, 1.f, out + 2 * D, rs, k0w, L, lane);
}

}  // namespace wr

// ---------------------------------------------------------------------------
// routes and launches

// the two passes of one route's instance and their shared memory
struct Pair {
  const void* dq;
  const void* dkv;
  size_t smem_dq;
  size_t smem_dkv;
};

template <typename T, int HD>
Pair streaming_pair() {
  return {reinterpret_cast<const void*>(attention_bwd_dq_kernel<T, HD>),
          reinterpret_cast<const void*>(attention_bwd_dkv_kernel<T, HD>), Layout<T, HD>::bytes,
          Layout<T, HD>::bytes};
}

// streaming (T = bf16) or fp32 (T = float)
template <typename T>
Pair streaming_of(int hd) {
  switch (hd) {
    case 16: return streaming_pair<T, 16>();
    case 32: return streaming_pair<T, 32>();
    case 64: return streaming_pair<T, 64>();
    case 128: return streaming_pair<T, 128>();
    default: return {nullptr, nullptr, 0, 0};
  }
}

template <int HD, int LP, bool CAUSAL>
Pair whole_row_pair() {
  return {reinterpret_cast<const void*>(wr::attention_bwd_dq_wr_kernel<HD, LP, CAUSAL>),
          reinterpret_cast<const void*>(wr::attention_bwd_dkv_wr_kernel<HD, LP, CAUSAL>),
          wr::Smem<HD, LP>::dq, wr::Smem<HD, LP>::dkv};
}

template <int HD, int LP>
Pair whole_row_lp(bool causal) {
  return causal ? whole_row_pair<HD, LP, true>() : whole_row_pair<HD, LP, false>();
}

template <int HD>
Pair whole_row_of(int L, bool causal) {
  switch (padded_len(L)) {
    case 80: return whole_row_lp<HD, 80>(causal);
    case 208: return whole_row_lp<HD, 208>(causal);
    default: return whole_row_lp<HD, 272>(causal);
  }
}

// the instance of an allowed route
Pair pick(int route, int L, int hd, bool causal) {
  if (route == kFp32) return streaming_of<float>(hd);
  if (route == kStreaming) return streaming_of<bf16>(hd);
  switch (hd) {
    case 16: return whole_row_of<16>(L, causal);
    case 32: return whole_row_of<32>(L, causal);
    case 64: return whole_row_of<64>(L, causal);
    default: return {nullptr, nullptr, 0, 0};
  }
}

// the kernel's shared memory limit raised to its need, shared memory
// preferred over L1 so that two blocks fit on an SM
cudaError_t prepare(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// the instance of a route at (L, hd, dtype), or nullptrs for a route the
// rule does not allow or a head dim not taken
Pair instance(int L, int hd, int is_bf16, int route, int causal) {
  if (L <= 0 || !route_allowed(route, L, hd, is_bf16)) return {nullptr, nullptr, 0, 0};
  return pick(route, L, hd, causal != 0);
}

}  // namespace

// K1b. qkv (B, L, 3D) and dqkv (B, L, 3D), dout (B, L, D), all contiguous,
// all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), 16-byte aligned; stats a
// float32 scratch of 3 B H L; hd = D / num_heads in {16, 32, 64, 128};
// route 0 whole_row, 1 streaming, 2 fp32, as attention_bwd_route names it
// (streaming also where it names whole_row; any other route is refused).
// passes: 1 pass dq, 2 pass dkv (which reads the statistics pass dq left in
// stats), 3 both, in that order, on `stream`. Returns cudaGetLastError()
// after the launches.
extern "C" int dtt_attention_qkv_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int B, int L, int D, int num_heads, int causal, float scale,
                                     int is_bf16, int route, int passes, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || D % num_heads != 0 || num_heads > 65535 ||
      B > 65535 || passes < 1 || passes > 3)
    return cudaErrorInvalidValue;
  if (misaligned(qkv) || misaligned(dout) || misaligned(dqkv) || misaligned(stats))
    return cudaErrorMisalignedAddress;  // the tiles move 16-byte vectors
  const Pair k = instance(L, D / num_heads, is_bf16, route, causal);
  if (k.dq == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = prepare(k.dq, k.smem_dq);
  if (err == cudaSuccess) err = prepare(k.dkv, k.smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BT - 1) / BT, num_heads, B);
  void* args[] = {&qkv, &dout, &dqkv, &stats, &B, &L, &D, &causal, &scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes & 1) {
    err = cudaLaunchKernel(k.dq, grid, dim3(NT), args, k.smem_dq, s);
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    err = cudaLaunchKernel(k.dkv, grid, dim3(NT), args, k.smem_dkv, s);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// blocks of pass dq (pass = 0) or pass dkv (pass = 1) resident on one SM on
// a route at (L, hd, dtype, causal), from the occupancy calculator; -1 for
// a route refused, a head dim not taken or a CUDA error
extern "C" int dtt_attention_bwd_blocks_per_sm(int L, int hd, int is_bf16, int route, int causal,
                                               int pass) {
  const Pair k = instance(L, hd, is_bf16, route, causal);
  const void* fn = pass ? k.dkv : k.dq;
  const size_t smem = pass ? k.smem_dkv : k.smem_dq;
  int blocks = 0;
  if (fn == nullptr || prepare(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// dynamic shared memory a block of pass dq (pass = 0) or dkv (pass = 1) on
// a route at (L, hd, dtype), in bytes (0 for a route refused or a head dim
// not taken)
extern "C" int dtt_attention_bwd_smem_bytes(int L, int hd, int is_bf16, int route, int pass) {
  const Pair k = instance(L, hd, is_bf16, route, 0);
  return static_cast<int>(pass ? k.smem_dkv : k.smem_dq);
}

extern "C" const char* dtt_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
