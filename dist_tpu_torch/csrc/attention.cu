// Fused multi-head attention over the fused (B, L, 3D) qkv projection.
//
// Replaces: dist_tpu/ops/attention.py::_attn_kernel (launched by
// _pallas_attention_qkv, public fused_attention_qkv). Same function: for
// each batch row and head h,
//   S = (Q_h * hd^-1/2) K_h^T        fp32
//   optional causal mask: col > row -> -inf
//   P = softmax(S)                   fp32, then rounded to the input type
//   O_h = P V_h                      fp32 accumulation, stored in the input type
// reading Q_h, K_h, V_h straight from columns h*hd, D + h*hd, 2D + h*hd of
// the fused rows and writing columns h*hd of the (B, L, D) output.
//
// What bounds it on the card: at the CLIP shapes (L = 197 or 77, hd = 64)
// the function moves (3D + D) * L * B elements once and does 4 L^2 hd
// operations per (row, head); in bf16 at the tensor-core rate it is
// memory-bound (~23 us for the ViT-B/16 batch of 64 frames); in fp32 at
// the CUDA-core rate it is compute-bound (~114 us).
//
// Design: the TPU kernel ran one program per batch row with every head
// resident in VMEM. Here one block owns one (row, head, 64-query tile), so
// a ViT-B/16 launch has 64 * 12 * 4 = 3072 blocks for 132 SMs. Keys are
// streamed through shared memory in chunks of 64, so no length limit
// applies. Two passes over the keys keep the exact softmax of the
// reference: pass 1 finds each row's max and sum (online rescaling), pass
// 2 recomputes S, forms the normalised P, rounds it to the input type as
// the reference does, and accumulates P V. The key loop ends at the tile's
// last row under the causal mask.
//
// bf16 (the served path): 4 warps, each owning 16 query rows, compute S
// and P V on the tensor cores with warp-level mma (nvcuda::wmma, bf16 in,
// fp32 accumulate); S goes through shared memory for the masked softmax,
// two lanes per row. Q is pre-scaled and rounded to bf16 on load, as the
// reference scales it in the input type. fp32: 256 threads on the CUDA
// cores, each owning a 4 x 4 tile of S and a 4 x (hd/16) tile of O, row
// max and sum reduced across the 16 lanes that share a row; Q is scaled in
// fp32 on load.

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

template <int HD>
__global__ void __launch_bounds__(NT)
attention_qkv_kernel(const float* __restrict__ qkv, float* __restrict__ out, int L, int D,
                     int causal, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NJ = HD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* Ks = Qs + BQ * LD;                     // BK x LD
  float* Vs = Ks + BK * LD;                     // BK x HD
  float* Ps = Vs + BK * HD;                     // BQ x LP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
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

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int L, int D, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, B);
  attention_qkv_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), L, D, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* qkv, void* out, int B, int L, int D, int hd, int causal,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(qkv, out, B, L, D, causal, scale, stream);
    case 32: return launch<32>(qkv, out, B, L, D, causal, scale, stream);
    case 64: return launch<64>(qkv, out, B, L, D, causal, scale, stream);
    case 128: return launch<128>(qkv, out, B, L, D, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

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
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
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
  // softmax layout: lanes 2r and 2r + 1 share row r of the warp's tile and
  // take alternate columns
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

  const float inv_l = 1.f / l;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_kv<HD>(base, rs, D + h * HD, 2 * D + h * HD, k0, L, Ks, Vs);
    __syncthreads();
    warp_scores<HD>(Qw, Ks, Sw);
    __syncwarp();
    for (int c = par; c < BK; c += 2) {
      const int col = k0 + c;
      float p = 0.f;
      if (col < L && !(causal && col > row)) p = expf(Sw[r_w * OS + c] - m) * inv_l;
      Pw[r_w * PP + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();
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

  __syncwarp();
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, o[j], OS, wmma::mem_row_major);
  __syncwarp();
  constexpr int CH = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i, r = c / CH, d = (c % CH) * 8;
    const int orow = q0 + warp * 16 + r;
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16_rn(Sw[r * OS + d + u]);
    if (orow < L)
      *reinterpret_cast<uint4*>(out + ((size_t)b * L + orow) * D + h * HD + d) = packed;
  }
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int L, int D, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attention_qkv_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, D / HD, B);
  attention_qkv_tc_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, D, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* qkv, void* out, int B, int L, int D, int hd, int causal,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(qkv, out, B, L, D, causal, scale, stream);
    case 32: return launch<32>(qkv, out, B, L, D, causal, scale, stream);
    case 64: return launch<64>(qkv, out, B, L, D, causal, scale, stream);
    case 128: return launch<128>(qkv, out, B, L, D, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// qkv (B, L, 3D) contiguous, out (B, L, D) contiguous, both fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1, both 16-byte aligned); hd =
// D / num_heads in {16, 32, 64, 128}. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int dtt_attention_qkv(const void* qkv, void* out, int B, int L, int D, int num_heads,
                                 int causal, float scale, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || num_heads <= 0 || D % num_heads != 0 || B > 65535 ||
      num_heads > 65535)
    return cudaErrorInvalidValue;
  const int hd = D / num_heads;
  if (is_bf16 && (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 16))
    return cudaErrorMisalignedAddress;  // the bf16 path moves 16-byte vectors
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? tc::dispatch(qkv, out, B, L, D, hd, causal, scale, st)
                 : simt::dispatch(qkv, out, B, L, D, hd, causal, scale, st);
}

extern "C" const char* dtt_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
