// Shared device helpers of the attention kernels: the tile codes, cp.async
// groups, the lse constants and the segment mask rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// per-(q tile, kv tile) visibility codes, as g2vlm_tpu's `_block_codes`
constexpr int kSkip = 0;     // no pair visible: the tile is not loaded
constexpr int kPartial = 1;  // evaluate the mask per element
constexpr int kFull = 2;     // every pair visible: no mask work

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
