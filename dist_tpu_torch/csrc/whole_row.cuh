// What the attention kernels' whole-row routes share: K1 and K4
// (attention.cu) and K1b, K1's backward (attention_bwd.cu).
//
// The route rule, one for all three (ops/attention.py::attention_route and
// attention_bwd_route say the same): fp32 inputs take the CUDA cores; bf16
// takes whole_row where a warp's 16 rows of scores fit its registers (head
// dim 16, 32 or 64, L <= 272; instances padded to LP = 80, 208, 272: the
// text tower's 77, ViT-B/16's 197, ViT-L/14's 257), else streaming. A
// launch may ask for streaming where the rule says whole_row; nothing else.
//
// The warp-level primitives of sm_80 and later that the whole-row kernels
// are built from, each one PTX instruction: cp.async (16 bytes global ->
// shared, no registers), ldmatrix (8 x 8 bf16 matrices from shared memory
// into the mma fragment layout), mma.sync.m16n8k16 (bf16 in, fp32 sums),
// ex2.approx, and a pack of two fp32 values into a bf16 pair.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// numbered as ops/attention.py::ROUTES
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
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

}  // namespace
