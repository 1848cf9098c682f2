// Shared device helpers of the attention kernels: tile sizes, the tile codes,
// the bf16/fp16 mma.sync wrappers, cp.async, ldmatrix and the zero-filling
// tile loader (attention_int8.cu), the lse constants and the segment mask rule
// (all of them).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of row padding: keeps ldmatrix conflict-free
// per-(q tile, kv tile) visibility codes, as g2vlm_tpu's `_block_codes`
constexpr int kSkip = 0;     // no pair visible: the tile is not loaded
constexpr int kPartial = 1;  // evaluate the mask per element
constexpr int kFull = 2;     // every pair visible: no mask work

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float x, float y) {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0 -> the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Copies `rows` valid rows (of kBlockM/kBlockN) of a D-wide tile into shared
// memory; rows past `rows` are zero-filled so that 0-probability columns never
// multiply garbage (0 * NaN would poison the P.V product).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* smem, const T* gmem, long long row_stride, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + kPad;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < rows;
    cp_async16(smem + r * kLd + c, ok ? gmem + r * row_stride + c : gmem, ok);
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// lse of a row that sees no key, as g2vlm_tpu's NEG_INF; the backward reads
// any lse below kLseEmptyBelow as "empty" and gives the row P == 0
constexpr float kLseEmpty = -1e30f;
constexpr float kLseEmptyBelow = -1e29f;

// The segment rule of ops/masks.py on packed (doc, fn, noise, pos) metadata.
__device__ __forceinline__ bool seg_visible(const int4 q, const int4 k) {
  const bool same_doc = (q.x == k.x) & (q.x >= 0) & (k.x >= 0);
  const bool causal = k.w <= q.w;
  const bool full = (q.y == k.y) & (q.y >= 0);
  const bool hidden_noise = (k.z >= 0) & (q.z != k.z);
  return same_doc & (causal | full) & !hidden_noise;
}

}  // namespace
