// Flash attention backward kernels for Hopper (sm_90a), bf16/fp16 in and out,
// fp32 accumulate.
//
// K5  g2_attention_bwd_dq / g2_attention_bwd_dkv with segment = 1 replace
//     g2vlm_tpu/ops/flash_attention.py `_flash_bwd_dq_kernel` (:385) and
//     `_flash_bwd_dkv_kernel` (:435), called through `_flash_bwd` (:845): the
//     backward of the packed segment-masked GQA attention K2/K3.
// K7  the same two entry points with segment = 0 replace
//     `_batched_bwd_dq_kernel` (:1164) and `_batched_bwd_dkv_kernel` (:1195),
//     called through `_batched_vjp_bwd` (:1325): the backward of the batched
//     bidirectional attention K1/K6.
//
// Both compute, from q, k, v, dO, the forward's lse and delta = rowsum(dO*O):
//     P  = exp(scale * Q K^T - lse)   (masked pairs 0)
//     dS = P * (dO V^T - delta)
//     dQ = scale * dS K,   dV = P^T dO,   dK = scale * dS^T Q
// The segment form is the batched form with one batch element, G = H / KVH
// query heads per KV head, the (doc, fn, noise, pos) mask rule and the
// forward's SKIP/PARTIAL/FULL tile codes, so one template serves both.
//
// What bounds them on the H100: tensor-core operations. The function needs
// five S x S x D products (S, dP, dQ, dK, dV); these two kernels do seven (the
// dq kernel recomputes S and dP), on q/k/v/dO traffic ~1000x smaller at the
// training pack of 12,800 rows. P and dS never reach device memory: they are
// recomputed per 64 x 64 tile from the saved lse and live in registers.
//
// The design, for the card (hopper_common.cuh has the building blocks):
// - Every product is a warpgroup `wgmma.mma_async` (m64, fp32 accumulators).
//   S = Q K^T and dP = dO V^T read both operands from shared memory; dQ += dS
//   K, dV += P^T dO and dK += dS^T Q take P or dS from registers (the RS form),
//   with K, dO and Q read MN-major from the same swizzled tiles. The dkv kernel
//   computes S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out of
//   the accumulators already as register A operands.
// - A block is two warpgroups, 256 threads, so that a thread may hold up to
//   255 registers (a warpgroup's dK + dV at D 128 are 128 of them). ptxas caps
//   a block of 288 or 384 threads at 168 registers a thread whatever
//   setmaxnreg asks, and the dkv kernel then spilled 700 bytes a thread: so no
//   producer warp. Instead every thread issues its share of the copies of the
//   tile two steps ahead of the one it multiplies, into a ring of four
//   shared-memory stages: 16-byte cp.async into the 128- or 64-byte
//   swizzle that wgmma reads, each stage completing on an mbarrier
//   (cp.async.mbarrier.arrive) and released on a second one once both
//   warpgroups' warps are done with it. cp.async and not TMA: the wrappers pass
//   frame-0 K/V with batch stride 0 and rows of 782 that end inside a tile,
//   which a per-thread copy zero-fills row by row. The walk over the tile
//   codes steps over SKIP tiles, so only live tiles enter the ring.
// - dq: one block per (batch, KV head, 64 query rows, pair of query heads of
//   the GQA group); each K/V stage feeds both heads, one consumer warpgroup
//   each (G odd, as K7's G = 1: one head, two query tiles). Q and dO stay in
//   shared memory, dQ in registers.
// - dkv: one block per (batch, KV head, 128 key rows, slice of the GQA group);
//   each consumer warpgroup owns 64 keys, keeps its K and V tiles in shared
//   memory and dK, dV in registers over the whole stream of (query tile, query
//   head) items, which both warpgroups share. Where the card would run the
//   blocks in too few waves (K5: 200 blocks on 132 SMs), the host cuts the
//   group into slices (`dkv_head_split` in ops/flash_attention.py); each slice
//   writes fp32 partial sums, and a second kernel adds them in slice order.
// - Element work (P, dS): one warp-uniform branch per tile on its code, then
//   branch-free selects and the hardware ex2. With a branch per element the
//   element work took longer than the products (K5 dq 8.0 ms, and 3.4 ms
//   with the element work left out, on the H100).
// Two kernels, one owner per output row, no atomics: two runs give bitwise
// equal results.
//
// Head dim 80 (the Qwen2-VL ViT's; 160-byte rows fit neither swizzle) is laid
// out as 96 columns in shared memory, as attention_segment.cu lays out its
// forward: the pad columns of every tile are zeroed once and never written
// again, so S = Q K^T and dP = dO V^T are unchanged; dQ, dK and dV run over 96
// columns (the pad ones come out 0) and are stored over 80.
//
// Ragged tails and empty rows: out-of-range rows of any tile are zero-filled;
// out-of-range or empty (lse == kLseEmpty) query rows read lse = +inf, so
// their P is exp2(-inf) = 0 and never NaN; keys >= n_kv are masked on PARTIAL
// tiles (tail tiles are never FULL); dK/dV rows in [n_kv, n_kv_store) are
// written as 0.

#include "attention_common.cuh"
#include "hopper_common.cuh"

#include <algorithm>

namespace {

constexpr int kWgThreads = 128;
constexpr int kConsumerWgs = 2;
constexpr int kBwdThreads = kConsumerWgs * kWgThreads;
constexpr int kTileRows = 64;  // rows of every operand tile, the tile of the codes
constexpr int kStages = 4;  // shared-memory stages of the ring
// copies run kAhead tiles ahead of the products, so that one warpgroup may
// trail the other by a tile before the ring holds either back (measured on
// the H100: 8 stages at D 64, or copies 3 tiles ahead, changed nothing)
constexpr int kAhead = kStages - 2;
constexpr int kReleaseWarps = kBwdThreads / 32;  // one release arrival per warp

// columns of a tile in shared memory: head dim 80 is zero-padded to 96
template <int D>
constexpr int kSmemCols = D == 80 ? 96 : D;

struct BwdArgs {
  const void* q;     // (B, n_q, H, D) through strides
  const void* k;     // (B, >= n_kv, KVH, D) through strides
  const void* v;
  const void* dout;  // (B, n_q, H, D) contiguous
  const float* lse;    // (B, H, n_q)
  const float* delta;  // (B, H, n_q)
  void* dq;  // (B, n_q, H, D) contiguous
  void* dk;  // (B, n_kv_store, KVH, D) contiguous
  void* dv;
  float* part;  // (n_split, 2, B, n_kv_store, KVH, D) fp32 partial dK, dV when n_split > 1
  const int4* q_meta;   // segment only
  const int4* kv_meta;
  const int8_t* codes;  // (ceil(n_q/64), ceil(n_kv/64))
  int n_q, n_kv, n_kv_store, h, kvh, n_split;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale, scale_log2;
};

// lse in log2 units for the backward: +inf for a row outside the tensor or a
// row that saw no key, so that P = exp2(s - lse) is 0
__device__ __forceinline__ float lse_log2(bool in_range, float lse) {
  return (in_range && lse > kLseEmptyBelow) ? lse * kLog2e : INFINITY;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool src_ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_ok ? 4 : 0)
               : "memory");
}

// the mbarriers of the ring: full[s] completes when stage s is loaded (every
// producer thread's cp.async landed and it arrived), empty[s] when every
// consumer thread is done with it
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kBwdThreads + 1);
      mbar_init(&empty[s], kReleaseWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

__device__ __forceinline__ void producer_commit(uint64_t* full) {
  mbar_arrive_cp_async(full);
  if (threadIdx.x == 0) mbar_arrive(full);  // after its write of the stage's info
}

__device__ __forceinline__ void advance(int& stage, int& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// zeroes the pad columns D .. kSmemCols<D> of `n_tiles` consecutive tiles from `tiles`, once: the
// copies never write them
template <int D>
__device__ __forceinline__ void zero_pad_columns(unsigned char* tiles, int n_tiles) {
  constexpr int kDs = kSmemCols<D>;
  if constexpr (kDs != D) {
    constexpr int kPadChunks = (kDs - D) / 8;
    for (int i = threadIdx.x; i < n_tiles * kTileRows * kPadChunks; i += kBwdThreads) {
      const int t = i / (kTileRows * kPadChunks);
      const int r = (i / kPadChunks) % kTileRows;
      const int c = D / 8 + i % kPadChunks;
      *reinterpret_cast<int4*>(tiles + t * kTileRows * kDs * 2 + swizzled_offset<kDs, kTileRows>(r, c)) =
          make_int4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
}

// stores the first D columns of a warpgroup's 64 x kSmemCols<D> accumulator times `mult` as rows of T (rows >=
// `rows` are not written)
template <typename T, int D>
__device__ __forceinline__ void store_acc(const float (&acc)[kSmemCols<D> / 2], float mult, T* dst_row0,
                                          long long row_stride, int rows, int tid) {
  const int qd = tid & 3;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = (tid >> 5) * 16 + ((tid & 31) >> 2) + row * 8;
    if (r < rows) {
      T* dst = dst_row0 + r * row_stride + qd * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack2<T>(acc[4 * j + 2 * row] * mult, acc[4 * j + 2 * row + 1] * mult);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kTile = kTileRows * kSmemCols<D> * 2;
  static constexpr int kQ = 0;                                 // [kConsumerWgs] resident Q tiles
  static constexpr int kDo = kQ + kConsumerWgs * kTile;        // [kConsumerWgs] resident dO tiles
  static constexpr int kK = kDo + kConsumerWgs * kTile;        // [kStages] streamed K tiles
  static constexpr int kV = kK + kStages * kTile;              // [kStages] streamed V tiles
  static constexpr int kMeta = kV + kStages * kTile;           // [kStages][64] int4 key metadata
  static constexpr int kBar = kMeta + kStages * kTileRows * 16;  // full[kStages], empty[kStages]
  static constexpr int kInfo = kBar + 2 * kStages * 8;  // [kStages] int4 (KV tile or -1 to end, code of each consumer)
  static constexpr int kBytes = kInfo + kStages * 16 + 1024;  // + alignment slack
};

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kBwdThreads, 1) bwd_dq_kernel(const BwdArgs a) {
  using L = DqSmem<D>;
  constexpr int kDs = kSmemCols<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  int4* s_info = reinterpret_cast<int4*>(smem + L::kInfo);
  const int4* s_meta = reinterpret_cast<const int4*>(smem + L::kMeta);

  const int group = a.h / a.kvh;
  const int hb = group % 2 == 0 ? 2 : 1;  // query heads per block, one per consumer warpgroup
  const int qb = kConsumerWgs / hb;       // query tiles per block
  const int n_hgroups = group / hb;
  const long long b = blockIdx.z;
  const int kv_h = blockIdx.y / n_hgroups;
  const int h_first = kv_h * group + (blockIdx.y % n_hgroups) * hb;
  const int qt_first = blockIdx.x * qb;
  const int n_q_tiles = cdiv(a.n_q, kTileRows);
  const int n_kv_tiles = cdiv(a.n_kv, kTileRows);
  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;

  zero_pad_columns<D>(smem + L::kQ, 2 * (kConsumerWgs + kStages));  // Q, dO, K, V: contiguous tiles
  init_ring(full, empty);

  // This warpgroup's query head and tile. Q and dO stay in shared memory.
  const int h = h_first + (hb == 2 ? wg : 0);
  const int qt = qt_first + (hb == 2 ? 0 : wg);
  const int q0 = qt * kTileRows;
  const int n_rows = qt < n_q_tiles ? min(kTileRows, a.n_q - q0) : 0;
  const long long o_ss = static_cast<long long>(a.h) * D;
  const uint32_t s_q = sb + L::kQ + wg * L::kTile;
  const uint32_t s_do = sb + L::kDo + wg * L::kTile;
  load_tile_swizzled<T, D, kTileRows, kDs>(
      s_q, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + static_cast<long long>(min(q0, a.n_q - 1)) * a.q_ss,
      a.q_ss, n_rows, tid, kWgThreads);
  load_tile_swizzled<T, D, kTileRows, kDs>(
      s_do, static_cast<const T*>(a.dout) + (b * a.n_q + min(q0, a.n_q - 1)) * o_ss + h * D, o_ss, n_rows, tid,
      kWgThreads);
  cp_async_commit();

  // The ring: every thread issues its share of each live K / V tile kAhead tiles ahead of the
  // products; tiles that are SKIP for both warpgroups never enter it.
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kv_h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kv_h * a.v_sh;
  int ld_t = 0, ld_stage = 0, ld_phase = 0, n_issued = 0;
  auto tile_code = [&](int w, int t) {
    const int qt_w = qt_first + (hb == 2 ? 0 : w);
    return qt_w >= n_q_tiles ? kSkip
           : kSeg            ? static_cast<int>(a.codes[static_cast<long long>(qt_w) * n_kv_tiles + t])
                             : ((t + 1) * kTileRows <= a.n_kv ? kFull : kPartial);
  };
  int nx0 = tile_code(0, 0), nx1 = tile_code(1, 0);  // codes of tile ld_t, loaded a call ahead
  auto issue_next = [&]() {
    while (ld_t < n_kv_tiles) {
      const int c0 = nx0, c1 = nx1;
      if (++ld_t < n_kv_tiles) {
        nx0 = tile_code(0, ld_t);
        nx1 = tile_code(1, ld_t);
      }
      if (c0 == kSkip && c1 == kSkip) continue;
      mbar_wait(&empty[ld_stage], ld_phase ^ 1);
      const int t = ld_t - 1;
      if (threadIdx.x == 0) s_info[ld_stage] = make_int4(t, c0, c1, 0);
      const int n0 = t * kTileRows;
      const int rows = min(kTileRows, a.n_kv - n0);
      load_tile_swizzled<T, D, kTileRows, kDs>(sb + L::kK + ld_stage * L::kTile, k + n0 * a.k_ss, a.k_ss, rows,
                                               threadIdx.x, kBwdThreads);
      load_tile_swizzled<T, D, kTileRows, kDs>(sb + L::kV + ld_stage * L::kTile, v + n0 * a.v_ss, a.v_ss, rows,
                                               threadIdx.x, kBwdThreads);
      if (kSeg && threadIdx.x < kTileRows) {
        const int r = threadIdx.x;
        cp_async16_u32(sb + L::kMeta + (ld_stage * kTileRows + r) * 16, a.kv_meta + (r < rows ? n0 + r : 0),
                       r < rows);
      }
      producer_commit(&full[ld_stage]);
      advance(ld_stage, ld_phase);
      ++n_issued;
      return;
    }
  };
  for (int i = 0; i < kAhead; ++i) issue_next();

  const int g = (tid & 31) >> 2;
  const int qd = tid & 3;
  const long long stat = (b * a.h + h) * a.n_q + q0;
  float row_lse2[2], row_delta[2];
  int4 rm[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = (tid >> 5) * 16 + g + row * 8;
    const bool in = r < n_rows;
    row_lse2[row] = lse_log2(in, in ? a.lse[stat + r] : 0.f);
    row_delta[row] = in ? a.delta[stat + r] : 0.f;
    rm[row] = kSeg && in ? a.q_meta[q0 + r] : make_int4(-2, -1, -1, 0);
  }
  float acc[kDs / 2];
#pragma unroll
  for (int i = 0; i < kDs / 2; ++i) acc[i] = 0.f;
  cp_async_wait<0>();  // this thread's Q / dO chunks (the ring's copies are in no group)
  fence_proxy_async();
  named_barrier(1 + wg, kWgThreads);  // the warpgroup's Q and dO tiles are in place

  const float scale_log2 = a.scale_log2;
  int stage = 0, phase = 0;
  for (int n_done = 0; n_done < n_issued; ++n_done) {
    issue_next();
    mbar_wait(&full[stage], phase);
    const int4 info = s_info[stage];
    const int code = wg == 0 ? info.y : info.z;
    if (code != kSkip) {
      fence_proxy_async();
      const uint32_t s_k = sb + L::kK + stage * L::kTile;
      const uint32_t s_v = sb + L::kV + stage * L::kTile;
      float s[32], dp[32];
      wgmma_fence();
      product_abt<T, kDs>(s, s_q, s_k);
      wgmma_commit();
      product_abt<T, kDs>(dp, s_do, s_v);
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP may still run under the exp2
      fence_regs(s);
      // P = 2^(scale log2(e) S - lse): one warp-uniform branch per tile, then branch-free
      // element work (a branch per element cost half the kernel's time)
      if (code == kFull) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], scale_log2, -row_lse2[(i >> 1) & 1]));
      } else {
        const int n0 = info.x * kTileRows;
        const int4* meta = s_meta + stage * kTileRows;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + qd * 2 + (i & 1);
          bool ok = n0 + col < a.n_kv;
          if (kSeg) ok &= seg_visible(rm[(i >> 1) & 1], meta[col]);
          const float pv = fast_exp2(fmaf(s[i], scale_log2, -row_lse2[(i >> 1) & 1]));
          s[i] = ok ? pv : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]);
      uint32_t ds[4][4];
      to_a_operands<T>(ds, dp);
      wgmma_fence();
      product_ab<T, kDs>(acc, ds, s_k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    release(&empty[stage]);
    advance(stage, phase);
  }
  if (n_rows > 0) {
    T* dq = static_cast<T*>(a.dq) + (b * a.n_q + q0) * o_ss + h * D;
    store_acc<T, D>(acc, a.scale, dq, o_ss, n_rows, tid);
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// dkv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kTile = kTileRows * kSmemCols<D> * 2;
  static constexpr int kK = 0;                                 // [kConsumerWgs] resident K tiles
  static constexpr int kV = kK + kConsumerWgs * kTile;         // [kConsumerWgs] resident V tiles
  static constexpr int kQ = kV + kConsumerWgs * kTile;         // [kStages] streamed Q tiles
  static constexpr int kDo = kQ + kStages * kTile;             // [kStages] streamed dO tiles
  static constexpr int kLse = kDo + kStages * kTile;           // [kStages][64] fp32
  static constexpr int kDelta = kLse + kStages * kTileRows * 4;  // [kStages][64] fp32
  static constexpr int kMeta = kDelta + kStages * kTileRows * 4;  // [kStages][64] int4 query metadata
  static constexpr int kBar = kMeta + kStages * kTileRows * 16;  // full[kStages], empty[kStages]
  static constexpr int kInfo = kBar + 2 * kStages * 8;  // [kStages] int4 (q tile or -1 to end, head, code of each consumer)
  static constexpr int kBytes = kInfo + kStages * 16 + 1024;
};

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kBwdThreads, 1) bwd_dkv_kernel(const BwdArgs a) {
  using L = DkvSmem<D>;
  constexpr int kDs = kSmemCols<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + kStages;
  int4* s_info = reinterpret_cast<int4*>(smem + L::kInfo);
  const float* s_lse = reinterpret_cast<const float*>(smem + L::kLse);
  const float* s_delta = reinterpret_cast<const float*>(smem + L::kDelta);
  const int4* s_meta = reinterpret_cast<const int4*>(smem + L::kMeta);

  const int group = a.h / a.kvh;
  const int per = group / a.n_split;  // query heads of this block's slice of the group
  const long long b = blockIdx.z;
  const int kv_h = blockIdx.y / a.n_split;
  const int split = blockIdx.y % a.n_split;
  const int kt_first = blockIdx.x * kConsumerWgs;  // the warpgroups' key tiles: columns of the codes
  const int n_q_tiles = cdiv(a.n_q, kTileRows);
  const int n_kv_tiles = cdiv(a.n_kv, kTileRows);
  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x % kWgThreads;
  const long long o_ss = static_cast<long long>(a.h) * D;

  zero_pad_columns<D>(smem + L::kK, 2 * (kConsumerWgs + kStages));  // K, V, Q, dO: contiguous tiles
  init_ring(full, empty);

  // This warpgroup's 64 keys: K and V stay in shared memory, dK and dV in registers.
  const int kt = kt_first + wg;
  const int k0 = kt * kTileRows;
  const int rows = max(0, min(kTileRows, a.n_kv - k0));
  const uint32_t s_k = sb + L::kK + wg * L::kTile;
  const uint32_t s_v = sb + L::kV + wg * L::kTile;
  const long long k_row = min(k0, a.n_kv - 1);
  load_tile_swizzled<T, D, kTileRows, kDs>(s_k, static_cast<const T*>(a.k) + b * a.k_sb + kv_h * a.k_sh + k_row * a.k_ss,
                                      a.k_ss, rows, tid, kWgThreads);
  load_tile_swizzled<T, D, kTileRows, kDs>(s_v, static_cast<const T*>(a.v) + b * a.v_sb + kv_h * a.v_sh + k_row * a.v_ss,
                                      a.v_ss, rows, tid, kWgThreads);
  cp_async_commit();

  // The ring: every thread issues its share of each (q tile, query head) item kAhead items
  // ahead of the products; q tiles that are SKIP for both warpgroups never enter it.
  int ld_qt = 0, ld_g = 0, ld_stage = 0, ld_phase = 0, n_issued = 0;
  auto tile_code = [&](int w, int qt) {
    const int kt_w = kt_first + w;
    return kt_w >= n_kv_tiles ? kSkip
           : kSeg             ? static_cast<int>(a.codes[static_cast<long long>(qt) * n_kv_tiles + kt_w])
                              : ((kt_w + 1) * kTileRows <= a.n_kv ? kFull : kPartial);
  };
  int c0 = tile_code(0, 0), c1 = tile_code(1, 0);  // codes of q tile ld_qt
  auto next_q_tile = [&]() {
    ld_g = 0;
    if (++ld_qt < n_q_tiles) {
      c0 = tile_code(0, ld_qt);
      c1 = tile_code(1, ld_qt);
    }
  };
  auto issue_next = [&]() {
    for (; ld_qt < n_q_tiles; next_q_tile()) {
      if (c0 == kSkip && c1 == kSkip) continue;
      const int h = kv_h * group + split * per + ld_g;
      mbar_wait(&empty[ld_stage], ld_phase ^ 1);
      if (threadIdx.x == 0) s_info[ld_stage] = make_int4(ld_qt, h, c0, c1);
      const int q0 = ld_qt * kTileRows;
      const int q_rows = min(kTileRows, a.n_q - q0);
      load_tile_swizzled<T, D, kTileRows, kDs>(
          sb + L::kQ + ld_stage * L::kTile,
          static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + static_cast<long long>(q0) * a.q_ss, a.q_ss, q_rows,
          threadIdx.x, kBwdThreads);
      load_tile_swizzled<T, D, kTileRows, kDs>(sb + L::kDo + ld_stage * L::kTile,
                                               static_cast<const T*>(a.dout) + (b * a.n_q + q0) * o_ss + h * D,
                                               o_ss, q_rows, threadIdx.x, kBwdThreads);
      if (threadIdx.x < kTileRows) {
        const int r = threadIdx.x;
        const long long stat = (b * a.h + h) * a.n_q + q0 + (r < q_rows ? r : 0);
        cp_async4(sb + L::kLse + (ld_stage * kTileRows + r) * 4, a.lse + stat, r < q_rows);
        cp_async4(sb + L::kDelta + (ld_stage * kTileRows + r) * 4, a.delta + stat, r < q_rows);
      } else if (kSeg && threadIdx.x < 2 * kTileRows) {
        const int r = threadIdx.x - kTileRows;
        cp_async16_u32(sb + L::kMeta + (ld_stage * kTileRows + r) * 16, a.q_meta + (r < q_rows ? q0 + r : 0),
                       r < q_rows);
      }
      producer_commit(&full[ld_stage]);
      advance(ld_stage, ld_phase);
      if (++ld_g == per) next_q_tile();
      ++n_issued;
      return;
    }
  };
  for (int i = 0; i < kAhead; ++i) issue_next();

  const int g = (tid & 31) >> 2;
  const int qd = tid & 3;
  const int key_row = (tid >> 5) * 16 + g;  // this thread's key rows: key_row and key_row + 8
  int4 rm[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = k0 + key_row + row * 8;
    rm[row] = kSeg && r < a.n_kv ? a.kv_meta[r] : make_int4(-1, -1, -1, -1);
  }
  float acc_dk[kDs / 2], acc_dv[kDs / 2];
#pragma unroll
  for (int i = 0; i < kDs / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  cp_async_wait<0>();  // this thread's K / V chunks (the ring's copies are in no group)
  fence_proxy_async();
  named_barrier(1 + wg, kWgThreads);  // the warpgroup's K and V tiles are in place

  const float scale_log2 = a.scale_log2;
  int stage = 0, phase = 0;
  for (int n_done = 0; n_done < n_issued; ++n_done) {
    issue_next();
    mbar_wait(&full[stage], phase);
    const int4 info = s_info[stage];
    const int code = wg == 0 ? info.z : info.w;
    const uint32_t s_q = sb + L::kQ + stage * L::kTile;
    const uint32_t s_do = sb + L::kDo + stage * L::kTile;
    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns the item's 64 query rows
    if (code != kSkip) {
      fence_proxy_async();
      wgmma_fence();
      product_abt<T, kDs>(st, s_k, s_q);
      wgmma_commit();
      product_abt<T, kDs>(dpt, s_v, s_do);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T may still run
      fence_regs(st);
      const int q0 = info.x * kTileRows;
      const float* lse = s_lse + stage * kTileRows;
      const float* delta = s_delta + stage * kTileRows;
      const int4* meta = s_meta + stage * kTileRows;
      if (code == kFull) {  // warp-uniform; the element work below has no branch
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + qd * 2 + (i & 1);
          st[i] = fast_exp2(fmaf(st[i], scale_log2, -lse_log2(q0 + col < a.n_q, lse[col])));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = (i >> 2) * 8 + qd * 2 + (i & 1);
          const float pv = fast_exp2(fmaf(st[i], scale_log2, -lse_log2(q0 + col < a.n_q, lse[col])));
          bool ok = k0 + key_row + ((i >> 1) & 1) * 8 < a.n_kv;
          if (kSeg) ok &= seg_visible(meta[col], rm[(i >> 1) & 1]);
          st[i] = ok ? pv : 0.f;
        }
      }
      wgmma_wait<0>();  // dP^T is in
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + qd * 2 + (i & 1);
        dpt[i] = st[i] * (dpt[i] - delta[col]);
      }
      uint32_t pt[4][4], dst[4][4];  // P^T and dS^T as register A operands
      to_a_operands<T>(pt, st);
      to_a_operands<T>(dst, dpt);
      wgmma_fence();
      product_ab<T, kDs>(acc_dv, pt, s_do);
      product_ab<T, kDs>(acc_dk, dst, s_q);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    release(&empty[stage]);
    advance(stage, phase);
  }

  const int rows_store = max(0, min(kTileRows, a.n_kv_store - k0));
  const long long kv_ss = static_cast<long long>(a.kvh) * D;
  const long long row0 = (b * a.n_kv_store + k0) * kv_ss + kv_h * D;
  if (a.n_split == 1) {
    store_acc<T, D>(acc_dk, a.scale, static_cast<T*>(a.dk) + row0, kv_ss, rows_store, tid);
    store_acc<T, D>(acc_dv, 1.f, static_cast<T*>(a.dv) + row0, kv_ss, rows_store, tid);
  } else {  // fp32 partial sums of this slice; dkv_reduce_kernel adds the slices in order
    const long long plane = static_cast<long long>(gridDim.z) * a.n_kv_store * kv_ss;
    float* pk = a.part + 2 * split * plane + row0;
    float* pv = pk + plane;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int r = key_row + row * 8;
      if (r < rows_store) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const long long off = r * kv_ss + j * 8 + qd * 2;
          *reinterpret_cast<float2*>(pk + off) = make_float2(acc_dk[4 * j + 2 * row], acc_dk[4 * j + 2 * row + 1]);
          *reinterpret_cast<float2*>(pv + off) = make_float2(acc_dv[4 * j + 2 * row], acc_dv[4 * j + 2 * row + 1]);
        }
      }
    }
  }
  cp_async_wait_all();
}

// dk = scale * (part[0] + part[1] + ...), dv likewise unscaled, slices added in
// order so that the result does not depend on the blocks' schedule
template <typename T>
__global__ void dkv_reduce_kernel(const float* part, T* dk, T* dv, long long n_pairs, int n_split, float scale) {
  const long long plane = 2 * n_pairs;  // floats of one (slice, dk or dv) plane
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_pairs;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float2 xk = reinterpret_cast<const float2*>(part + 2 * s * plane)[i];
      const float2 xv = reinterpret_cast<const float2*>(part + (2 * s + 1) * plane)[i];
      sk.x += xk.x;
      sk.y += xk.y;
      sv.x += xv.x;
      sv.y += xv.y;
    }
    reinterpret_cast<uint32_t*>(dk)[i] = pack2<T>(sk.x * scale, sk.y * scale);
    reinterpret_cast<uint32_t*>(dv)[i] = pack2<T>(sv.x, sv.y);
  }
}

template <typename T, int D, bool kSeg>
cudaError_t launch_bwd(const BwdArgs& a, int b, bool dkv, cudaStream_t stream) {
  const int group = a.h / a.kvh;
  if (dkv) {
    constexpr int smem = DkvSmem<D>::kBytes;
    if (a.n_split < 1 || group % a.n_split) return cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(bwd_dkv_kernel<T, D, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(cdiv(a.n_kv_store, kConsumerWgs * kTileRows), a.kvh * a.n_split, b);
    bwd_dkv_kernel<T, D, kSeg><<<grid, kBwdThreads, smem, stream>>>(a);
    if (a.n_split > 1) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const long long n_pairs = static_cast<long long>(b) * a.n_kv_store * a.kvh * D / 2;
      const int blocks = static_cast<int>(std::min((n_pairs + 255) / 256, 4096LL));
      dkv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                        n_pairs, a.n_split, a.scale);
    }
  } else {
    constexpr int smem = DqSmem<D>::kBytes;
    cudaError_t err =
        cudaFuncSetAttribute(bwd_dq_kernel<T, D, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int hb = group % 2 == 0 ? 2 : 1;
    dim3 grid(cdiv(cdiv(a.n_q, kTileRows), kConsumerWgs / hb), a.kvh * (group / hb), b);
    bwd_dq_kernel<T, D, kSeg><<<grid, kBwdThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, bool kSeg>
cudaError_t dispatch_bwd(const BwdArgs& a, int b, int d, bool dkv, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_bwd<T, 64, kSeg>(a, b, dkv, stream);
    // the Qwen2-VL ViT's head dim: the segment form only, for the ViT's training branch
    case 80: return kSeg ? launch_bwd<T, 80, true>(a, b, dkv, stream) : cudaErrorInvalidValue;
    case 96: return launch_bwd<T, 96, kSeg>(a, b, dkv, stream);
    case 128: return launch_bwd<T, 128, kSeg>(a, b, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run_bwd(
    bool dkv, int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, void* part, int n_split,
    const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int n_kv_store, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv,
            static_cast<float*>(part), static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
            static_cast<const int8_t*>(codes), n_q, n_kv, n_kv_store, h, kvh, n_split,
            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (segment) {
    err = dtype == 0 ? dispatch_bwd<__nv_bfloat16, true>(a, b, d, dkv, st)
                     : dispatch_bwd<__half, true>(a, b, d, dkv, st);
  } else {
    err = dtype == 0 ? dispatch_bwd<__nv_bfloat16, false>(a, b, d, dkv, st)
                     : dispatch_bwd<__half, false>(a, b, d, dkv, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. segment: 1 = K5 (metadata and codes given, b == 1),
// 0 = K7 (metadata and codes null, kvh == h). Strides are in elements; the
// head dim is contiguous. dout and dq are contiguous (B, n_q, H, D); dk and dv
// contiguous (B, n_kv_store, KVH, D); lse and delta contiguous fp32 (B, H, n_q).
// Keys >= n_kv are masked and their dk / dv rows written as 0. The dkv kernel
// cuts each GQA group into n_split slices of heads (n_split divides H / KVH);
// with n_split > 1, `part` is fp32 scratch of (n_split, 2, B, n_kv_store, KVH,
// D). Returns a cudaError_t.
extern "C" int g2_attention_bwd_dq(
    int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  return run_bwd(false, dtype, segment, q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, 1, q_meta, kv_meta,
                 codes, b, n_q, n_kv, n_kv, h, kvh, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                 stream);
}

extern "C" int g2_attention_bwd_dkv(
    int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, void* part, int n_split, const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int n_kv_store, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  return run_bwd(true, dtype, segment, q, k, v, dout, lse, delta, nullptr, dk, dv, part, n_split, q_meta, kv_meta,
                 codes, b, n_q, n_kv, n_kv_store, h, kvh, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 scale, stream);
}
