// Fused multi-head attention over the fused (B, L, 3D) qkv projection: two
// entry points that share their device code.
//
// K1 (dtt_attention_qkv) replaces dist_tpu/ops/attention.py::_attn_kernel
// (launched by _pallas_attention_qkv, public fused_attention_qkv). For each
// batch row and head h,
//   S = Q_h K_h^T * hd^-1/2     fp32; Q scaled in fp32, never rounded
//                               (as the TPU kernel scales it)
//   optional causal mask: col > row -> -inf
//   P = softmax(S)              fp32, normalised, then rounded to the input type
//   O_h = P V_h                 fp32 accumulation, stored in the input type
// reading Q_h, K_h, V_h straight from columns h*hd, D + h*hd, 2D + h*hd of
// the fused rows and writing columns h*hd of the (B, L, D) output.
//
// K4 (dtt_attention_qkv_rows) replaces tools/microbench.py::kernel_nb (via
// make_nb): the same function without the causal mask, one block looping
// over nb batch rows; grid (ceil(L/64), heads, B/nb). Every route runs K1's
// device routine once per row, so K4 gives K1's bits.
//
// The bound. At the CLIP shapes the function moves (3D + D) L B elements
// once and does 4 L^2 hd operations per (row, head). At the train shape
// (256, 197, 2304) in bf16 that is 0.0925 ms of bytes at 3.35 TB/s against
// 0.031 ms of operations at 989 TFLOP/s: bytes-bound. In fp32 on the CUDA
// cores it is operations-bound.
//
// Routes, one rule (attention_route in ops/attention.py says the same; a
// launch naming another route is refused):
//   whole_row  bf16, hd in {16, 32, 64}, L <= 272: the Hopper design below,
//              instantiated for padded lengths LP = 80, 208, 272 (the text
//              tower's 77, ViT-B/16's 197, ViT-L/14's 257);
//   streaming  every other bf16 case (L > 272, hd = 128): 64-key chunks in
//              two passes, nvcuda::wmma, no length limit;
//   fp32       fp32 on the CUDA cores (simt).
// The caller may ask for `streaming` where the rule says `whole_row` (to
// time the two side by side); nothing else.
//
// whole_row. One block of 4 warps owns 64 query rows of one head in one
// batch row, each warp 16 rows. The whole row fits: at L <= 272 a warp
// keeps its 16 x LP strip of scores in registers, so the softmax is exact
// in one pass, as the TPU kernel's whole (L, L) tile is, and P is
// normalised before it is rounded to bf16.
//   copies   cp.async, 16 bytes a thread, zero-filled past L: Q tile and
//            K_h as one group, V_h as a second; scores wait for the first
//            only, so V lands while they run. Without the causal mask all
//            LP rows of K and V are filled (zeros past L, so P = 0 never
//            meets uninitialised memory); under it, only the keys the
//            block reads, rounded up to 16 rows.
//   scores   mma.sync.m16n8k16 (bf16 in, fp32 sums), A = Q through
//            ldmatrix as it is; the scale multiplies the fp32 scores
//            inside the softmax's exponent factor (hd^-1/2 log2 e), so Q
//            is never rounded after scaling; B = K through ldmatrix;
//            float s[LP/8][4] per lane. Without the mask every key tile of
//            LP is computed and the loops have no branch (a branch per tile
//            keeps the compiler from scheduling the tiles' ldmatrix and mma
//            together; tools/attn_variants.py times the two); under it,
//            the tiles wholly past the warp's last row are skipped
//            (CAUSAL is a template parameter).
//   softmax  in registers: lane t holds rows t/4 and t/4 + 8; row max and
//            sum over the 4 lanes of a quad (shfl_xor 1, 2); ex2.approx
//            with log2 e folded into one fma (P is rounded to bf16
//            afterwards); P = p / sum rounded to bf16 and packed straight
//            into the k16 A fragments of P V (the FlashAttention-2
//            register layout): S and P never touch shared memory.
//   P V      mma.sync again, B = V through ldmatrix.trans from the
//            row-major tile; O in float o[hd/8][4]; rounded to bf16 in the
//            warp's own Q rows and stored with 16-byte writes.
// Why mma.sync and cp.async, and not wgmma and TMA: the function is
// bytes-bound here, so the warp-level tensor-core rate is enough to reach
// the bytes bound; wgmma needs shared-memory descriptors and 64-row
// warpgroup tiles, TMA and mbarriers a producer warp, and buy operations
// that this function does not lack.
// Per block at hd 64: shared memory (64 + 2 LP) (hd + 8) bf16, 69,120 bytes
// at LP 208 (three blocks per SM), 87,552 at LP 272 (two); registers are
// capped by __launch_bounds__ for three (LP <= 208) or two blocks per SM.
// K4 has no second buffer: the blocks resident on an SM overlap each
// other's copies.
//
// streaming (the lengths and head dims the registers cannot hold): one
// block per (row, head, 64-query tile); keys in chunks of 64
// through shared memory, pass 1 for each row's max and sum (online
// rescaling), pass 2 recomputes S and forms the normalised P, rounded, then
// P V; S (unscaled) goes through shared memory for the softmax, two lanes
// per row, which multiplies it by the scale in fp32.
//
// fp32: 256 threads on the CUDA cores, each owning a 4 x 4 tile of S and a
// 4 x (hd/16) tile of O, keys streamed as above; Q is scaled in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>


namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per chunk (streaming and fp32)

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

// ---- streaming: 64-key chunks, two passes

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

// pass 1: fold the chunk of scores at key k0, times `scale`, into the
// row's max m and sum l
template <int OS>
__device__ __forceinline__ void row_stats(const float* Sw, int k0, int L, int causal, int row,
                                          int r_w, int par, float scale, float& m, float& l) {
  float tmax = -INFINITY;
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    if (col < L && !(causal && col > row)) tmax = fmaxf(tmax, Sw[r_w * OS + c] * scale);
  }
  const float mnew = fmaxf(m, fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1)));
  float sum = 0.f;
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    if (col < L && !(causal && col > row)) sum += expf(Sw[r_w * OS + c] * scale - mnew);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  l = l * (m == -INFINITY ? 0.f : expf(m - mnew)) + sum;
  m = mnew;
}

// pass 2: the chunk's normalised P, rounded to bf16, into the warp's Pw
template <int OS>
__device__ __forceinline__ void probs(const float* Sw, bf16* Pw, int k0, int L, int causal,
                                      int row, int r_w, int par, float scale, float m,
                                      float inv_l) {
  for (int c = par; c < BK; c += 2) {
    const int col = k0 + c;
    float p = 0.f;
    if (col < L && !(causal && col > row)) p = expf(Sw[r_w * OS + c] * scale - m) * inv_l;
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

// The block's 64-query tile (blockIdx.x) of head blockIdx.y in batch row
// b. The caller puts a barrier between two calls on the same shared memory.
template <int HD>
__device__ __forceinline__ void stream_tile(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                            int b, int L, int D, int causal, float scale,
                                            unsigned char* smem) {
  using Lay = Layout<HD>;
  constexpr int LD = Lay::LD, OS = Lay::OS;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::q + Lay::kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + Lay::q + 2 * Lay::kv) + warp * 16 * OS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + Lay::q + 2 * Lay::kv + Lay::s) + warp * 16 * PP;
  const bf16* Qw = Qs + warp * 16 * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * rs;

  {  // Q tile as it is: the softmax scales the fp32 scores
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
    row_stats<OS>(Sw, k0, L, causal, row, r_w, par, scale, m, l);
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
    probs<OS>(Sw, Pw, k0, L, causal, row, r_w, par, scale, m, inv_l);
    __syncwarp();
    pv<HD>(Pw, Vs, o);
  }
  store_o<HD>(o, Sw, out, b, q0 + warp * 16, h, L, D, lane);
}

// K1, streaming route: batch row blockIdx.z
template <int HD>
__global__ void __launch_bounds__(NT)
attention_qkv_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                        int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  stream_tile<HD>(qkv, out, blockIdx.z, L, D, causal, scale, smem);
}

// K4, streaming route: batch rows blockIdx.z * nb .. + nb - 1
template <int HD>
__global__ void __launch_bounds__(NT)
attention_rows_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                         int nb, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = 0; i < nb; ++i) {
    if (i) __syncthreads();
    stream_tile<HD>(qkv, out, blockIdx.z * nb + i, L, D, 0, scale, smem);
  }
}

// ---- whole_row: the row's keys resident, scores and P in registers

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

// 2^x, the SFU's approximation (relative error ~2^-22, denormal results
// flushed to 0); P is rounded to bf16 afterwards
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory of one block: Q tile (BQ rows), K_h and V_h (LP rows each),
// bf16 with row stride HD + 8 (ldmatrix's 8 row addresses fall in distinct
// banks)
template <int HD, int LP>
struct WholeRow {
  static constexpr int LD = HD + 8;
  static constexpr size_t bytes = sizeof(bf16) * (size_t)(BQ + 2 * LP) * LD;
  static constexpr int min_blocks = LP <= 208 ? 3 : 2;   // per SM, for the register cap
};

// rows [r0, r0 + n) of one head's columns into shared memory (row stride
// LD), zero-filled past L. The thread index goes through an empty asm, so
// that each call computes its ~30 copy addresses afresh: hoisted out of
// K4's row loop they stayed live across the whole row and made its
// registers spill.
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, size_t rs,
                                          int r0, int n, int L) {
  constexpr int LD = HD + 8, CH = HD / 8;
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));
  for (int c = tid; c < n * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * LD + d, src + (size_t)(ok ? r0 + r : 0) * rs + d, ok);
  }
}

// The block's 64 query rows (blockIdx.x) of head blockIdx.y in batch row b,
// L <= LP. The caller puts a barrier between two calls on the same shared
// memory. Without the causal mask every key tile of LP is computed, its
// rows past L zero-filled and masked: the loops have no branch, so the
// compiler schedules the ldmatrix and mma of all tiles together. Under the
// mask the tiles past the warp's last row are skipped.
template <int HD, int LP, bool CAUSAL>
__device__ __forceinline__ void whole_row(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                          int b, int L, int D, float scale, unsigned char* smem) {
  constexpr int LD = WholeRow<HD, LP>::LD;
  constexpr int NKT = LP / 16;      // key tiles of 16: k-steps of P V
  constexpr int KS = HD / 16;       // k-steps of Q K^T
  constexpr int CH = HD / 8;        // 16-byte chunks of a row
  constexpr float LOG2E = 1.4426950408889634f;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + LP * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * L * rs + h * HD;

  // the keys any row of the block reads, in whole tiles of 16
  const int nk = CAUSAL ? (min(L, q0 + BQ) + 15) & ~15 : LP;
  copy_rows<HD>(Qs, base, rs, q0, BQ, L);
  copy_rows<HD>(Ks, base + D, rs, 0, nk, L);
  cp_async_commit();
  copy_rows<HD>(Vs, base + 2 * D, rs, 0, nk, L);
  cp_async_commit();
  cp_async_wait<1>();   // Q and K; V may still be landing
  __syncthreads();

  const int q0w = q0 + warp * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0w + g, row1 = row0 + 8;
  // under the mask, the warp's keys end at its last row: later tiles skipped
  const int kend = CAUSAL ? min(L, q0w + 16) : LP;

  // Q's A fragments as they are (the scale goes into the softmax's exponent)
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  // S: n8 tile j holds keys 8j + 2 t4, + 1 of rows g (s[j][0..1]) and g + 8
  float s[2 * NKT][4];
#pragma unroll
  for (int jt = 0; jt < NKT; ++jt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[2 * jt][i] = s[2 * jt + 1][i] = 0.f;
    if (!CAUSAL || jt * 16 < kend) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // keys 16 jt + 0..7 at d 0..7, 8..15, then keys + 8..15 at the same
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (jt * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * jt], qa[kk], kb[0], kb[1]);
        mma_16816(s[2 * jt + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }

  // softmax of rows row0 (s[.][0..1]) and row1 (s[.][2..3]); a row reads
  // keys below lim (L, and its own index + 1 under the causal mask)
  const int lim0 = CAUSAL ? min(L, row0 + 1) : L;
  const int lim1 = CAUSAL ? min(L, row1 + 1) : L;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    if (!CAUSAL || (j >> 1) * 16 < kend) {
      const int c = j * 8 + 2 * t4;
      s[j][0] = c < lim0 ? s[j][0] : -INFINITY;
      s[j][1] = c + 1 < lim0 ? s[j][1] : -INFINITY;
      s[j][2] = c < lim1 ? s[j][2] : -INFINITY;
      s[j][3] = c + 1 < lim1 ? s[j][3] : -INFINITY;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  // key 0 is every row's, so m0 and m1 are finite; exp(scale (s - m)) as
  // 2^(s e - m e), e = scale log2 e (at hd 64 the bits of scaling Q first)
  const float e = scale * LOG2E;
  const float ms0 = m0 * e, ms1 = m1 * e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NKT; ++j) {
    if (!CAUSAL || (j >> 1) * 16 < kend) {
      s[j][0] = fast_exp2(fmaf(s[j][0], e, -ms0));
      s[j][1] = fast_exp2(fmaf(s[j][1], e, -ms0));
      s[j][2] = fast_exp2(fmaf(s[j][2], e, -ms1));
      s[j][3] = fast_exp2(fmaf(s[j][3], e, -ms1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // P, normalised and rounded to bf16, as the A fragments of P V: k-step
  // t is n8 tiles 2t (columns 0..7) and 2t + 1 (8..15)
  uint32_t pa[NKT][4];
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    pa[t][0] = pack_bf16(s[2 * t][0] * inv0, s[2 * t][1] * inv0);
    pa[t][1] = pack_bf16(s[2 * t][2] * inv1, s[2 * t][3] * inv1);
    pa[t][2] = pack_bf16(s[2 * t + 1][0] * inv0, s[2 * t + 1][1] * inv0);
    pa[t][3] = pack_bf16(s[2 * t + 1][2] * inv1, s[2 * t + 1][3] * inv1);
  }

  cp_async_wait<0>();   // V
  __syncthreads();

  // O = P V: n8 tile j holds columns 8j + 2 t4, + 1 of rows g and g + 8
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
#pragma unroll
  for (int t = 0; t < NKT; ++t) {
    if (!CAUSAL || t * 16 < kend) {
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        // keys 16 t + 0..7, 8..15 at d 16 dj + 0..7, then at + 8..15
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                              (lane >> 4) * 8);
        mma_16816(o[2 * dj], pa[t], vb[0], vb[1]);
        mma_16816(o[2 * dj + 1], pa[t], vb[2], vb[3]);
      }
    }
  }

  // O rounded to bf16 through the warp's own Q rows, then 16-byte stores
  bf16* Ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(Ow + g * LD + j * 8 + 2 * t4) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * LD + j * 8 + 2 * t4) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i, r = c / CH, d = (c % CH) * 8;
    if (q0w + r < L)
      *reinterpret_cast<uint4*>(out + ((size_t)b * L + q0w + r) * D + h * HD + d) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + d);
  }
}

// K1, whole_row route: batch row blockIdx.z (`causal` is CAUSAL, fixed by
// the instance)
template <int HD, int LP, bool CAUSAL>
__global__ void __launch_bounds__(NT, (WholeRow<HD, LP>::min_blocks))
attention_qkv_wr_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                        int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  whole_row<HD, LP, CAUSAL>(qkv, out, blockIdx.z, L, D, scale, smem);
}

// K4, whole_row route: batch rows blockIdx.z * nb .. + nb - 1, one buffer
template <int HD, int LP>
__global__ void __launch_bounds__(NT, (WholeRow<HD, LP>::min_blocks))
attention_rows_wr_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int L, int D,
                         int nb, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = 0; i < nb; ++i) {
    if (i) __syncthreads();   // every warp is done with the last row's tiles
    whole_row<HD, LP, false>(qkv, out, blockIdx.z * nb + i, L, D, scale, smem);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// routes and launches

enum Route { kWholeRow = 0, kStreaming = 1, kFp32 = 2 };

constexpr int kMaxWholeRow = 272;

// the whole-row instance's padded length for L (L <= kMaxWholeRow)
int padded_len(int L) { return L <= 80 ? 80 : L <= 208 ? 208 : 272; }

// the rule: fp32 on the CUDA cores; bf16 whole-row where a warp's scores
// fit its registers, else streaming
int route_of(int L, int hd, int is_bf16) {
  if (!is_bf16) return kFp32;
  return (hd == 16 || hd == 32 || hd == 64) && L <= kMaxWholeRow ? kWholeRow : kStreaming;
}

// the rule's route, or streaming where the rule says whole_row
bool route_allowed(int route, int L, int hd, int is_bf16) {
  const int want = route_of(L, hd, is_bf16);
  return route == want || (route == kStreaming && want == kWholeRow);
}

// a kernel of either entry: (qkv, out, L, D, causal or nb, scale)
struct Kernel {
  const void* fn;
  size_t smem;
  int threads;
};

template <int HD, int LP>
Kernel whole_row_kernel(bool rows, bool causal) {
  const void* fn = rows     ? reinterpret_cast<const void*>(tc::attention_rows_wr_kernel<HD, LP>)
                   : causal ? reinterpret_cast<const void*>(tc::attention_qkv_wr_kernel<HD, LP, true>)
                            : reinterpret_cast<const void*>(tc::attention_qkv_wr_kernel<HD, LP, false>);
  return {fn, tc::WholeRow<HD, LP>::bytes, tc::NT};
}

template <int HD>
Kernel pick_hd(int route, int L, bool rows, bool causal) {
  if (route == kFp32)
    return {rows ? reinterpret_cast<const void*>(simt::attention_rows_kernel<HD>)
                 : reinterpret_cast<const void*>(simt::attention_qkv_kernel<HD>),
            simt::smem_bytes<HD>(), simt::NT};
  if (route == kStreaming)
    return {rows ? reinterpret_cast<const void*>(tc::attention_rows_tc_kernel<HD>)
                 : reinterpret_cast<const void*>(tc::attention_qkv_tc_kernel<HD>),
            tc::Layout<HD>::bytes, tc::NT};
  if constexpr (HD <= 64) {
    switch (padded_len(L)) {
      case 80: return whole_row_kernel<HD, 80>(rows, causal);
      case 208: return whole_row_kernel<HD, 208>(rows, causal);
      default: return whole_row_kernel<HD, 272>(rows, causal);
    }
  }
  return {nullptr, 0, 0};
}

// the kernel of an allowed route (K4, rows, takes no causal mask)
Kernel pick(int route, int L, int hd, bool rows, bool causal) {
  switch (hd) {
    case 16: return pick_hd<16>(route, L, rows, causal);
    case 32: return pick_hd<32>(route, L, rows, causal);
    case 64: return pick_hd<64>(route, L, rows, causal);
    case 128: return pick_hd<128>(route, L, rows, causal);
    default: return {nullptr, 0, 0};
  }
}

// the kernel's shared memory limit raised to its need, shared memory
// preferred over L1 so that several blocks fit on an SM
cudaError_t prepare(const Kernel& k) {
  cudaError_t err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(k.smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t run(const void* qkv, void* out, int B, int L, int D, int num_heads, int causal,
                int nb, float scale, int is_bf16, int route, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || D % num_heads != 0 || num_heads > 65535 ||
      nb < 0 || (nb > 0 && B % nb != 0) || (nb > 0 ? B / nb : B) > 65535)
    return cudaErrorInvalidValue;
  const int hd = D / num_heads;
  if (is_bf16 && (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16))
    return cudaErrorMisalignedAddress;  // the bf16 routes move 16-byte vectors
  if (!route_allowed(route, L, hd, is_bf16)) return cudaErrorInvalidValue;
  const Kernel k = pick(route, L, hd, nb > 0, causal != 0);
  if (k.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = prepare(k);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, num_heads, nb > 0 ? B / nb : B);
  int flag = nb > 0 ? nb : causal;
  void* args[] = {&qkv, &out, &L, &D, &flag, &scale};
  err = cudaLaunchKernel(k.fn, grid, dim3(k.threads), args, k.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K1. qkv (B, L, 3D) contiguous, out (B, L, D) contiguous, both fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1, both 16-byte aligned); hd =
// D / num_heads in {16, 32, 64, 128}; route 0 whole_row, 1 streaming,
// 2 fp32, as attention_route names it (streaming also where it names
// whole_row; any other route is refused). Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int dtt_attention_qkv(const void* qkv, void* out, int B, int L, int D, int num_heads,
                                 int causal, float scale, int is_bf16, int route, void* stream) {
  return run(qkv, out, B, L, D, num_heads, causal, 0, scale, is_bf16, route, stream);
}

// K4: K1's function without the causal mask, nb >= 1 batch rows per block;
// B % nb == 0; the route as for K1.
extern "C" int dtt_attention_qkv_rows(const void* qkv, void* out, int B, int L, int D,
                                      int num_heads, int nb, float scale, int is_bf16, int route,
                                      void* stream) {
  if (nb < 1) return cudaErrorInvalidValue;
  return run(qkv, out, B, L, D, num_heads, 0, nb, scale, is_bf16, route, stream);
}

// K4's dynamic shared memory per block on the rule's route, in bytes (0
// for a head dim it does not take)
extern "C" int dtt_attention_rows_smem_bytes(int L, int hd, int is_bf16) {
  if (L <= 0) return 0;
  return static_cast<int>(pick(route_of(L, hd, is_bf16), L, hd, true, false).smem);
}

// blocks of K1 (rows = 0, with or without the causal mask) or K4 (rows =
// 1) resident on one SM on the rule's route, from the occupancy
// calculator; -1 for a head dim not taken or a CUDA error
extern "C" int dtt_attention_blocks_per_sm(int L, int hd, int is_bf16, int rows, int causal) {
  if (L <= 0) return -1;
  const Kernel k = pick(route_of(L, hd, is_bf16), L, hd, rows != 0, causal != 0);
  int blocks = 0;
  if (k.fn == nullptr || prepare(k) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, k.threads, k.smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

extern "C" const char* dtt_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
