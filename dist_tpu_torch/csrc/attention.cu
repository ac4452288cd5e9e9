// Fused multi-head attention over the fused (B, L, 3D) qkv projection: two
// kernels that share their device code.
//
// K1 replaces dist_tpu/ops/attention.py::_attn_kernel (launched by
// _pallas_attention_qkv, public fused_attention_qkv). For each batch row
// and head h,
//   S = (Q_h * hd^-1/2) K_h^T        fp32
//   optional causal mask: col > row -> -inf
//   P = softmax(S)                   fp32, then rounded to the input type
//   O_h = P V_h                      fp32 accumulation, stored in the input type
// reading Q_h, K_h, V_h straight from columns h*hd, D + h*hd, 2D + h*hd of
// the fused rows and writing columns h*hd of the (B, L, D) output.
//
// K4 replaces tools/microbench.py::kernel_nb (via make_nb): the same
// function without the causal mask, nb batch rows per program.
//
// What bounds them on the card: at the CLIP shapes (L = 197 or 77, hd = 64)
// the function moves (3D + D) * L * B elements once and does 4 L^2 hd
// operations per (row, head); in bf16 at the tensor-core rate it is
// memory-bound (~23 us for the ViT-B/16 batch of 64 frames); in fp32 at
// the CUDA-core rate it is compute-bound (~114 us).
//
// K1's design: the TPU kernel ran one program per batch row with every
// head resident in VMEM. Here one block owns one (row, head, 64-query
// tile), so a ViT-B/16 launch has 64 * 12 * 4 = 3072 blocks for 132 SMs.
// Keys are streamed through shared memory in chunks of 64, so no length
// limit applies. Two passes over the keys keep the exact softmax of the
// reference: pass 1 finds each row's max and sum (online rescaling), pass
// 2 recomputes S, forms the normalised P, rounds it to the input type as
// the reference does, and accumulates P V. The key loop ends at the tile's
// last row under the causal mask.
//
// K4's design: one block owns the 64-query tile of one head for nb
// consecutive batch rows and loops over them, grid (ceil(L/64), heads,
// B/nb): 384 blocks at nb = 8 for the ViT-B/16 batch. In bf16 the block
// keeps a whole row's K_h and V_h resident in shared memory (L padded to a
// multiple of 64, zero past L), so each is read once per row rather than
// K twice; while it computes row r, the Q tile, K_h and V_h of row r + 1
// arrive in a second buffer by cp.async (two buffers: 192,512 bytes per
// block at hd = 64, L = 197, so one block per SM). The passes over the
// resident keys are K1's, chunk for chunk, so K4 and K1 give the same bits.
// In fp32 the block runs K1's streaming tile once per row (one buffer).
//
// bf16 (the served path): 4 warps, each owning 16 query rows, compute S
// and P V on the tensor cores with warp-level mma (nvcuda::wmma, bf16 in,
// fp32 accumulate); S goes through shared memory for the masked softmax,
// two lanes per row. Q is pre-scaled and rounded to bf16 on load, as the
// reference scales it in the input type (at hd = 64 the scale is 1/8 and
// the rounding is exact, which is kernel_nb's fp32 q * scale). fp32: 256
// threads on the CUDA cores, each owning a 4 x 4 tile of S and a
// 4 x (hd/16) tile of O, row max and sum reduced across the 16 lanes that
// share a row; Q is scaled in fp32 on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per chunk

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores

namespace simt {

constexpr int NT = 256;      // threads per block: 16 (ty) x 16 (tx)
constexpr int LP = BK + 16;  // row stride of the P tile (conflict-free writes)

// reduce over the 16 lanes that hold one row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * LP);
}

// rows [k0, k0 + BK) of one head's K or V into shared memory, zero past L
template <int HD>
__device__ __forceinline__ void load_chunk(const float* __restrict__ base, size_t row_stride,
                                           int col, int k0, int L, float* dst, int ld) {
  for (int idx = threadIdx.x; idx < BK * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int kr = k0 + r;
    dst[r * ld + d] = kr < L ? base[(size_t)kr * row_stride + col + d] : 0.f;
  }
}

// s[i][j] = Q[ty + 16 i] . K[tx + 16 j] over the chunk's keys
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, int ty, int tx,
                                       float s[4][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 q[4], k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(q[i].x, k[j].x, a);
        a = fmaf(q[i].y, k[j].y, a);
        a = fmaf(q[i].z, k[j].z, a);
        a = fmaf(q[i].w, k[j].w, a);
        s[i][j] = a;
      }
  }
}

// The block's 64-query tile (blockIdx.x) of head blockIdx.y in batch row b.
// Safe to call again for another row with the same shared memory: every
// shared buffer is written only after a barrier that follows its last read.
template <int HD>
__device__ __forceinline__ void tile(const float* __restrict__ qkv, float* __restrict__ out,
                                     int b, int L, int D, int causal, float scale,
                                     float* smem) {
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 16;
  float* Qs = smem;              // BQ x LD
  float* Ks = Qs + BQ * LD;      // BK x LD
  float* Vs = Ks + BK * LD;      // BK x HD
  float* Ps = Vs + BK * HD;      // BQ x LP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t row_stride = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * row_stride;

  for (int idx = threadIdx.x; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int qr = q0 + r;
    Qs[r * LD + d] = qr < L ? base[(size_t)qr * row_stride + h * HD + d] * scale : 0.f;
  }
  const int kend = causal ? min(L, q0 + BQ) : L;

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  // pass 1: each row's max and sum of exp
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_chunk<HD>(base, row_stride, D + h * HD, k0, L, Ks, LD);
    __syncthreads();
    float s[4][4];
    scores<HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= L || (causal && col > row)) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mnew);
      sum = row_sum(sum);
      const float keep = m[i] == -INFINITY ? 0.f : expf(m[i] - mnew);
      l[i] = l[i] * keep + sum;
      m[i] = mnew;
    }
  }

  // pass 2: P = softmax(S), O = P V
  float o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_chunk<HD>(base, row_stride, D + h * HD, k0, L, Ks, LD);
    load_chunk<HD>(base, row_stride, 2 * D + h * HD, k0, L, Vs, HD);
    __syncthreads();
    float s[4][4];
    scores<HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = 0.f;
        if (col < L && !(causal && col > row)) p = expf(s[i][j] - m[i]) / l[i];
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], v[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = Vs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= L) continue;
    float* dst = out + ((size_t)b * L + row) * D + h * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[tx + 16 * j] = o[i][j];
  }
}

// K1: batch row blockIdx.z
template <int HD>
__global__ void __launch_bounds__(NT)
attention_qkv_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int D,
                     int causal, float scale) {
  extern __shared__ float4 smem4[];
  tile<HD>(qkv, out, blockIdx.z, L, D, causal, scale, reinterpret_cast<float*>(smem4));
}

// K4: batch rows blockIdx.z * nb .. + nb - 1, one after the other
template <int HD>
__global__ void __launch_bounds__(NT)
attention_rows_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int D,
                      int nb, float scale) {
  extern __shared__ float4 smem4[];
  for (int i = 0; i < nb; ++i)
    tile<HD>(qkv, out, blockIdx.z * nb + i, L, D, 0, scale, reinterpret_cast<float*>(smem4));
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int L, int D, int causal, int nb,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();   // 2 buffers of 64 x (hd + 4), one of 64 x hd, P
  const bool rows = nb > 0;
  const void* fn = rows ? reinterpret_cast<const void*>(attention_rows_kernel<HD>)
                        : reinterpret_cast<const void*>(attention_qkv_kernel<HD>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float* x = static_cast<const float*>(qkv);
  float* y = static_cast<float*>(out);
  if (rows) {
    const dim3 grid((L + BQ - 1) / BQ, D / HD, B / nb);
    attention_rows_kernel<HD><<<grid, NT, smem, stream>>>(x, y, L, D, nb, scale);
  } else {
    const dim3 grid((L + BQ - 1) / BQ, D / HD, B);
    attention_qkv_kernel<HD><<<grid, NT, smem, stream>>>(x, y, L, D, causal, scale);
  }
  return cudaGetLastError();
}

// nb = 0: K1 (one row per block, `causal` honoured); nb >= 1: K4
cudaError_t dispatch(const void* qkv, void* out, int B, int L, int D, int hd, int causal,
                     int nb, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(qkv, out, B, L, D, causal, nb, scale, stream);
    case 32: return launch<32>(qkv, out, B, L, D, causal, nb, scale, stream);
    case 64: return launch<64>(qkv, out, B, L, D, causal, nb, scale, stream);
    case 128: return launch<128>(qkv, out, B, L, D, causal, nb, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

size_t dyn_smem(int hd) {
  switch (hd) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    default: return 0;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int NW = 4;            // warps per block, 16 query rows each
constexpr int NT = 32 * NW;
constexpr int PP = BK + 8;       // bf16 row stride of a warp's P tile

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;                      // bf16 row stride of Q, K, V
  static constexpr int OS = (HD > BK ? HD : BK) + 4;     // fp32 row stride of S / O
  static constexpr size_t q = sizeof(bf16) * BQ * LD;
  static constexpr size_t kv = sizeof(bf16) * BK * LD;
  static constexpr size_t s = sizeof(float) * NW * 16 * OS;
  static constexpr size_t p = sizeof(bf16) * NW * 16 * PP;
  static constexpr size_t bytes = q + 2 * kv + s + p;
};

// K4's shared memory: two buffers, each a Q tile and one row's whole K_h
// and V_h (lp = L rounded up to a multiple of BK rows), then S and P as K1
template <int HD>
struct RowsLayout {
  using K1 = Layout<HD>;
  static __host__ __device__ size_t kv(int lp) { return sizeof(bf16) * (size_t)lp * K1::LD; }
  static __host__ __device__ size_t buf(int lp) { return K1::q + 2 * kv(lp); }
  static __host__ __device__ size_t bytes(int lp) { return 2 * buf(lp) + K1::s + K1::p; }
};

__device__ __forceinline__ int padded_len(int L) { return (L + BK - 1) / BK * BK; }

// rows [k0, k0 + BK) of one head's K (and V, when Vs is given) into shared
// memory, zero past L: 16-byte loads (the wrapper checks the alignment), all
// of a thread's loads issued before its stores so they are in flight together
template <int HD>
__device__ __forceinline__ void load_kv(const bf16* __restrict__ base, size_t rs, int kcol,
                                        int vcol, int k0, int L, bf16* Ks, bf16* Vs) {
  constexpr int LD = Layout<HD>::LD, CH = HD / 8, PER = BK * CH / NT;
  uint4 kv[2][PER];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m == 1 && Vs == nullptr) break;
    const int col = m ? vcol : kcol;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * 8;
      kv[m][i] = k0 + r < L
          ? *reinterpret_cast<const uint4*>(base + (size_t)(k0 + r) * rs + col + d)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m == 1 && Vs == nullptr) break;
    bf16* dst = m ? Vs : Ks;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * 8;
      *reinterpret_cast<uint4*>(dst + r * LD + d) = kv[m][i];
    }
  }
}

// the warp's 16 x BK scores S = Qw K^T into Sw (fp32, row stride OS)
template <int HD>
__device__ __forceinline__ void warp_scores(const bf16* Qw, const bf16* Ks, float* Sw) {
  constexpr int LD = Layout<HD>::LD, OS = Layout<HD>::OS;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
  Acc acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(a, Qw + kk * 16, LD);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // K^T block (d = kk*16.., key = j*16..): element (d, key) at Ks[key * LD + d]
      wmma::load_matrix_sync(kt, Ks + j * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc[j], a, kt, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc[j], OS, wmma::mem_row_major);
}

// Softmax layout: lanes 2r and 2r + 1 share row r of the warp's tile
// (absolute query row `row`) and take alternate columns of the chunk.

// pass 1: fold the chunk of scores at key k0 into the row's max m and sum l
template <int OS>
__device__ __forceinline__ void row_stats(const float* Sw, int k0, int L, int causal, int row,
                                          int r_w, int par, float& m, float& l) {
  float tmax = -INFINITY;
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    if (col < L && !(causal && col > row)) tmax = fmaxf(tmax, Sw[r_w * OS + c]);
  }
  const float mnew = fmaxf(m, fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1)));
  float sum = 0.f;
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    if (col < L && !(causal && col > row)) sum += expf(Sw[r_w * OS + c] - mnew);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * (m == -INFINITY ? 0.f : expf(m - mnew)) + sum;
  m = mnew;
}

// pass 2: the chunk's normalised P, rounded to bf16, into the warp's Pw
template <int OS>
__device__ __forceinline__ void probs(const float* Sw, bf16* Pw, int k0, int L, int causal,
                                      int row, int r_w, int par, float m, float inv_l) {
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    float p = 0.f;
    if (col < L && !(causal && col > row)) p = expf(Sw[r_w * OS + c] - m) * inv_l;
    Pw[r_w * PP + c] = __float2bfloat16_rn(p);
  }
}

// O += P V over one chunk (Vs: its BK rows)
template <int HD>
__device__ __forceinline__ void pv(const bf16* Pw, const bf16* Vs, Acc (&o)[HD / 16]) {
  constexpr int LD = Layout<HD>::LD;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(pa, Pw + kk * 16, PP);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::load_matrix_sync(vb, Vs + kk * 16 * LD + j * 16, LD);
      wmma::mma_sync(o[j], pa, vb, o[j]);
    }
  }
}

// the warp's 16 x HD tile of O (query rows q0w..), through Sw, rounded to
// bf16 and stored with 16-byte writes into columns h*HD of batch row b
template <int HD>
__device__ __forceinline__ void store_o(Acc (&o)[HD / 16], float* Sw, bf16* __restrict__ out,
                                        int b, int q0w, int h, int L, int D, int lane) {
  constexpr int OS = Layout<HD>::OS, CH = HD / 8;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, o[j], OS, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i, r = c / CH, d = (c % CH) * 8;
    const int orow = q0w + r;
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(Sw[r * OS + d + u]);
    if (orow < L)
      *reinterpret_cast<uint4*>(out + ((size_t)b * L + orow) * D + h * HD + d) = packed;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
attention_qkv_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                        int causal, float scale) {
  using Lay = Layout<HD>;
  constexpr int LD = Lay::LD, OS = Lay::OS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::q + Lay::kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + Lay::q + 2 * Lay::kv) + warp * 16 * OS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + Lay::q + 2 * Lay::kv + Lay::s) + warp * 16 * PP;
  const bf16* Qw = Qs + warp * 16 * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * rs;

  {  // Q tile, scaled and rounded to bf16 (as the reference scales it)
    constexpr int CH = HD / 8, PER = BQ * CH / NT;
    uint4 raw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * 8;
      raw[i] = q0 + r < L
          ? *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * rs + h * HD + d)
          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * NT, r = c / CH, d = (c % CH) * 8;
      bf16* e = reinterpret_cast<bf16*>(&raw[i]);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(__bfloat162float(e[u]) * scale);
      *reinterpret_cast<uint4*>(Qs + r * LD + d) = raw[i];
    }
  }
  const int r_w = lane >> 1, par = lane & 1;
  const int row = q0 + warp * 16 + r_w;
  const int kend = causal ? min(L, q0 + BQ) : L;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_kv<HD>(base, rs, D + h * HD, 0, k0, L, Ks, nullptr);
    __syncthreads();
    warp_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    row_stats<OS>(Sw, k0, L, causal, row, r_w, par, m, l);
  }

  const float inv_l = 1.f / l;
  Acc o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.f);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_kv<HD>(base, rs, D + h * HD, 2 * D + h * HD, k0, L, Ks, Vs);
    __syncthreads();
    warp_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    probs<OS>(Sw, Pw, k0, L, causal, row, r_w, par, m, inv_l);
    __syncwarp();
    pv<HD>(Pw, Vs, o);
  }
  store_o<HD>(o, Sw, out, b, q0 + warp * 16, h, L, D, lane);
}

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

// start the copies of batch row `base`'s Q tile and its whole K_h and V_h
// (lp rows, zero past L) into one buffer, as one cp.async group
template <int HD>
__device__ __forceinline__ void prefetch_row(const bf16* __restrict__ base, size_t rs, int q0,
                                             int h, int D, int L, int lp, bf16* Qs, bf16* Ks,
                                             bf16* Vs) {
  constexpr int LD = Layout<HD>::LD, CH = HD / 8;
  for (int c = threadIdx.x; c < BQ * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = q0 + r < L;
    cp_async16(Qs + r * LD + d, base + (size_t)(ok ? q0 + r : 0) * rs + h * HD + d, ok);
  }
  for (int c = threadIdx.x; c < lp * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r < L;
    const bf16* k = base + (size_t)(ok ? r : 0) * rs + D + h * HD + d;
    cp_async16(Ks + r * LD + d, k, ok);
    cp_async16(Vs + r * LD + d, k + D, ok);
  }
  cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(NT)
attention_rows_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                         int nb, float scale) {
  using Lay = Layout<HD>;
  using Rows = RowsLayout<HD>;
  constexpr int LD = Lay::LD, OS = Lay::OS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lp = padded_len(L);
  const size_t buf = Rows::buf(lp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + 2 * buf) + warp * 16 * OS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + 2 * buf + Lay::s) + warp * 16 * PP;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b0 = blockIdx.z * nb;
  const size_t rs = 3 * (size_t)D;
  const int r_w = lane >> 1, par = lane & 1;
  // buffer i holds Q (BQ x LD), then K_h and V_h (lp x LD each)
  bf16* const buf0 = reinterpret_cast<bf16*>(smem);
  bf16* const buf1 = reinterpret_cast<bf16*>(smem + buf);

  prefetch_row<HD>(qkv + (size_t)b0 * L * rs, rs, q0, h, D, L, lp, buf0, buf0 + BQ * LD,
                   buf0 + BQ * LD + lp * LD);
  for (int r = 0; r < nb; ++r) {
    bf16* Qs = (r & 1) ? buf1 : buf0;
    const bf16* Ks = Qs + BQ * LD;
    const bf16* Vs = Ks + lp * LD;
    if (r + 1 < nb) {  // row r + 1 into the other buffer, then wait for row r only
      bf16* nq = (r & 1) ? buf0 : buf1;
      prefetch_row<HD>(qkv + (size_t)(b0 + r + 1) * L * rs, rs, q0, h, D, L, lp, nq,
                       nq + BQ * LD, nq + BQ * LD + lp * LD);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the warp's own Q rows, scaled and rounded to bf16 in place, as K1
    bf16* Qw = Qs + warp * 16 * LD;
    for (int i = lane; i < 16 * HD; i += 32) {
      bf16* e = Qw + (i / HD) * LD + i % HD;
      *e = __float2bfloat16_rn(__bfloat162float(*e) * scale);
    }
    __syncwarp();

    float m = -INFINITY, l = 0.f;
    for (int k0 = 0; k0 < L; k0 += BK) {
      warp_scores<HD>(Qw, Ks + k0 * LD, Sw);
      __syncwarp();
      row_stats<OS>(Sw, k0, L, 0, 0, r_w, par, m, l);
      __syncwarp();
    }
    const float inv_l = 1.f / l;
    Acc o[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.f);
    for (int k0 = 0; k0 < L; k0 += BK) {
      warp_scores<HD>(Qw, Ks + k0 * LD, Sw);
      __syncwarp();
      probs<OS>(Sw, Pw, k0, L, 0, 0, r_w, par, m, inv_l);
      __syncwarp();
      pv<HD>(Pw, Vs + k0 * LD, o);
    }
    store_o<HD>(o, Sw, out, b0 + r, q0 + warp * 16, h, L, D, lane);
    // every warp is done with this buffer before row r + 2's copies land in it
    __syncthreads();
  }
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int L, int D, int causal, float scale,
                   cudaStream_t stream) {
  // 64 x (hd + 8) Q, two 64 x (hd + 8) K/V chunks, 4 warps' S (fp32) and P
  const size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, B);
  attention_qkv_tc_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, D, causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_rows(const void* qkv, void* out, int B, int L, int D, int nb, float scale,
                        cudaStream_t stream) {
  // two buffers of (Q tile + whole-row K_h and V_h), S and P:
  // 192,512 bytes at hd = 64, L = 197 (lp = 256)
  const size_t smem = RowsLayout<HD>::bytes((L + BK - 1) / BK * BK);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attention_rows_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, B / nb);
  attention_rows_tc_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, D, nb, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* qkv, void* out, int B, int L, int D, int hd, int causal,
                     int nb, float scale, cudaStream_t stream) {
  switch (hd) {
#define DTT_CASE(H)                                                           \
  case H:                                                                     \
    return nb > 0 ? launch_rows<H>(qkv, out, B, L, D, nb, scale, stream)     \
                  : launch<H>(qkv, out, B, L, D, causal, scale, stream);
    DTT_CASE(16)
    DTT_CASE(32)
    DTT_CASE(64)
    DTT_CASE(128)
#undef DTT_CASE
    default: return cudaErrorInvalidValue;
  }
}

size_t rows_smem(int L, int hd) {
  const int lp = (L + BK - 1) / BK * BK;
  switch (hd) {
    case 16: return RowsLayout<16>::bytes(lp);
    case 32: return RowsLayout<32>::bytes(lp);
    case 64: return RowsLayout<64>::bytes(lp);
    case 128: return RowsLayout<128>::bytes(lp);
    default: return 0;
  }
}

}  // namespace tc

cudaError_t run(const void* qkv, void* out, int B, int L, int D, int num_heads, int causal,
                int nb, float scale, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || D % num_heads != 0 || num_heads > 65535 ||
      nb < 0 || (nb > 0 && B % nb != 0) || (nb > 0 ? B / nb : B) > 65535)
    return cudaErrorInvalidValue;
  const int hd = D / num_heads;
  if (is_bf16 && (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16))
    return cudaErrorMisalignedAddress;  // the bf16 path moves 16-byte vectors
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::dispatch(qkv, out, B, L, D, hd, causal, nb, scale, st)
                 : simt::dispatch(qkv, out, B, L, D, hd, causal, nb, scale, st);
}

}  // namespace

// K1. qkv (B, L, 3D) contiguous, out (B, L, D) contiguous, both fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1, both 16-byte aligned); hd =
// D / num_heads in {16, 32, 64, 128}. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int dtt_attention_qkv(const void* qkv, void* out, int B, int L, int D, int num_heads,
                                 int causal, float scale, int is_bf16, void* stream) {
  return run(qkv, out, B, L, D, num_heads, causal, 0, scale, is_bf16, stream);
}

// K4: K1's function without the causal mask, nb >= 1 batch rows per block;
// B % nb == 0. The bf16 path keeps whole rows in shared memory and returns
// cudaErrorInvalidValue where dtt_attention_rows_smem_bytes exceeds the
// card's per-block limit.
extern "C" int dtt_attention_qkv_rows(const void* qkv, void* out, int B, int L, int D,
                                      int num_heads, int nb, float scale, int is_bf16,
                                      void* stream) {
  if (nb < 1) return cudaErrorInvalidValue;
  return run(qkv, out, B, L, D, num_heads, 0, nb, scale, is_bf16, stream);
}

// K4's dynamic shared memory per block, in bytes (0 for a head dim it
// does not take)
extern "C" int dtt_attention_rows_smem_bytes(int L, int hd, int is_bf16) {
  if (L <= 0) return 0;
  return static_cast<int>(is_bf16 ? tc::rows_smem(L, hd) : simt::dyn_smem(hd));
}

extern "C" const char* dtt_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
