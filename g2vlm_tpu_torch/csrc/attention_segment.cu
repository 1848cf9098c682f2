// The segment-masked GQA attention forward for Hopper (sm_90a), bf16/fp16 in
// and out, fp32 accumulate.
//
// K2  g2_segment_attention (lse null) replaces g2vlm_tpu/ops/flash_attention.py
//     `_flash_kernel` (:168, called through `_fwd_pallas` :715, pallas_call
//     :817): packed GQA attention, q (Sq, H, D) against k, v (Skv, KVH, D),
//     masked per token pair by int32 (doc, fn, noise, pos) metadata with the
//     rule of ops/masks.py `make_segment_mask`, and per 64 x 64 tile by the
//     SKIP / PARTIAL / FULL codes of `block_codes`.
// K3  the same entry point with an lse pointer replaces `_flash_kernel_lse`
//     (:239): the same out (one template, one flag), plus lse = m + ln(l) in
//     natural units, fp32 (H, Sq); kLseEmpty for a row that sees no key. The
//     training forward saves it for K5 (attention_bwd.cu).
// K4  g2_segment_attention_pipe replaces `_flash_kernel_pipe` (:270, the pipe
//     branch of `_fwd_pallas`, pallas_call :777): K2's and K3's function in the
//     two-stage schedule, S of tile t + 1 on the tensor cores while tile t's
//     softmax and P V run. It is the same template with kPipe set.
// K8  g2_segment_attention_int8 replaces `_flash_kernel_int8` (:494, launched
//     by `_flash_int8` :582, pallas_call :658): K2's function with S = Q K^T an
//     int8 x int8 -> int32 product on per-token scales, the quantized serving
//     mode's prefill attention. The same template with kInt8 set, serial. The
//     quantiser is plain tensor code outside the kernel (ops/flash_attention.py
//     `quantize_qk`, as the JAX package keeps it outside its kernel): q8
//     (Sq, H, DP) and k8 (Skv, KVH, DP) int8 with DP = D rounded up to 32 and
//     zeros past D, qs (H, Sq) fp32 folded with scale log2(e), ks (KVH, Skv)
//     fp32. S in log2 units is float(s32) * qs[row] * ks[col], row scale first,
//     as the plain version; from there on it is K2. The TPU kernel
//     exponentiates without a shift and clamps at 2^100; this one keeps K2's
//     exact running maximum (the same function wherever the clamp is not hit,
//     and finite beyond it, which the un-normed ViT logits need).
// MLA g2_mla_attention, the port's own (the JAX package has no such layer):
//     K2's function, schedule and plan where q and k are wider than v, the
//     prefill form of the "mla_moe" decoder's latent attention (Kimi-VL-A3B,
//     16:16 heads, QK head dim 192 = 128 nope + 64 rope columns, V head dim
//     128), as the kernel `mla_fwd_kernel`: the warp-specialised schedule of
//     K2 at head dim 128 below, its Q and K tiles 192 columns wide (three TMA
//     boxes a K tile, twelve k-steps of S) and its V tiles and O 128, with
//     four stages in the ring instead of five.
//
// What bounds it on the H100: tensor-core operations (K8: QK^T at the int8
// rate, twice the bf16 one, and half the operand bytes). K2 at the 32-view recon
// prefill (25,088 rows, 12:2 heads of 128) is 3.8 TFLOP over the visible pairs
// (3.9 ms at 989 TFLOP/s) on 0.15 GB of q/k/v/o; at the chat prefill (48,384
// rows) 9.1 TFLOP. Beside the products:
// - the mask rule: ~10 integer operations a pair on every PARTIAL tile, and at
//   the sorted chat prefill every walked tile is PARTIAL (2,341 M pairs);
// - the exponentials, one a pair on the special-function units;
// - the K/V copies from L2: every block reads all live K/V tiles of its KV head.
//
// Two schedules of one template (hopper_common.cuh has the building blocks).
//
// K2 and K3 at head dim 128 (the decoder's: the recon and chat prefills, the
// training pack) run the warp-specialised schedule, `segment_fwd_ws`:
// - What bounds it: the products, and beside them the softmax. Per 64-key
//   tile a warpgroup's S and P V take ~512 cycles of the tensor cores at
//   their peak, its softmax (32 exponentials, the row maxima and sums, the
//   packing of P) about as long again, and S = Q K^T with both operands in
//   shared memory reads 128 bytes a cycle at that peak, all that shared
//   memory gives. The L2 does not bound it: a build whose blocks all read the
//   same 8 K/V tiles measured no faster (PERF.md).
// - A block is three warpgroups: a producer (warpgroup 2) and two consumers
//   (0 and 1) of 64 query rows each. At an even GQA group G (the decoder's
//   12:2) the consumers hold two query heads of one KV head on the same rows
//   and share every stage, its codes and its mask; at G odd they hold two
//   consecutive query tiles of one head. `segment_fwd_grid` reckons the grid
//   from the two warpgroups that g2_segment_attention_warpgroups reports.
// - The producer: one thread fills a ring of 5 K/V stages of 64 keys by TMA
//   (k and v as tensor maps whose 64 x 64 boxes land as the column blocks of
//   a swizzled tile; rows past Skv arrive as zeros), and its four warps build
//   the PARTIAL masks of each stage from the metadata, as the lockstep fill
//   does. Tiles that are SKIP for both consumers never enter the ring.
// - The consumers issue only wgmma: S of tile t + 1 and P V of tile t
//   together (K4's order, so K2's arithmetic: the outputs are bitwise the
//   lockstep schedule's), then tile t + 1's softmax under them. They take
//   turns on the tensor cores on two named barriers (4 + wg), so that one
//   warpgroup's softmax runs under the other's products. A warp whose rows'
//   running maxima all stood still on a tile skips the rescale of O (a
//   multiplication by 1).
// - Key tiles of 64: the softmax keeps K2's running maximum per 64 keys, so
//   K2, K3 and K4 stay bitwise equal; a 128-key tile would round P
//   elsewhere.
// - Registers (ptxas, PERF.md): a block of 384 threads is compiled to 168
//   registers a thread whatever setmaxnreg asks, as attention_bwd.cu found
//   for its kernels. The consumers' state (O 64, S 32, P 16 and the
//   statistics) fits in 143 with no spill, so no setmaxnreg is used; Q as a
//   register operand of S (32 more) spills and serialises the wgmma, whatever
//   the block's size.
//
// K4, K8 and every head dim below 128 run the lockstep schedule,
// `segment_fwd_lockstep`: there the products are smaller against the fill
// and the softmax (D 64 / 80 / 96), K8's int8 S takes another ring, and K4 is
// by its definition the two-stage schedule that K2 is compared against.
// - GQA heads share K/V stages, as the TPU kernel packs a group into one step.
//   A block is kWgs = 3 consumer warpgroups of 64 query rows each. Where the
//   group G is a multiple of 3, the warpgroups hold 3 query heads of one KV
//   head on the same 64 token rows: they share every K/V stage, its tile code
//   and its mask. Otherwise (the ViT's 16:16, G = 1) they hold 3 consecutive
//   query tiles of one head, as K1's blocks do, and each reads its own code.
//   `block_plan` decodes a block's share of the grid. One block per item: a
//   block walks up to 756 tiles at the main path's shapes, so a persistent
//   grid would save little (PERF.md).
// - Products on wgmma: S = Q K^T with both operands K-major in swizzled shared
//   memory; O += P V with P packed to T in registers as the A operand and V
//   read MN-major from the same stage. Head dim 80 (160-byte rows fit neither
//   swizzle) is zero-padded to 96 in shared memory: the pad columns of Q and K
//   are zeroed once and never written again, so they add nothing to S, and
//   the pad columns of O are not stored.
// - K8's S is an s8 wgmma (m64n64k32, DP / 32 k-steps) on int8 Q and K tiles
//   of 64 rows of 128 bytes, laid out as a 64-column bf16 tile (128-byte
//   swizzle): an int8 k-step is 32 bytes of a row, as a bf16 one. DP 96 (the
//   ViT's 80, which the quantiser pads) writes 96 bytes of each row and reads
//   3 k-steps, so the last 32 bytes are never read; DP 64 reads 2. A stage
//   holds the int8 K tile (8 KB), the T V tile and the tile's 64 key scales
//   (4-byte cp.async, zero past Skv); Q sits as int8, 8 KB a warpgroup. The
//   s32 accumulator has the fp32 one's ownership, so the scales apply in
//   registers before K2's softmax (with the scale already in qs).
// - A ring of kStages K/V stages, filled by 16-byte cp.async completing on an
//   mbarrier, kAhead tiles ahead of the products, by every thread of the
//   block. A stage is released on a second mbarrier once every warp is done
//   with it. SKIP tiles (SKIP for every warpgroup) never enter the ring: the
//   fill steps over them. The ragged tail (a pack of 333 rows) is
//   zero-filled per thread.
// - The mask of a PARTIAL tile is built once per block and stage, not once
//   per head: the fill evaluates the rule for the rows of each PARTIAL query
//   tile of the block against the tile's 64 keys, one pair a lane, and packs
//   it with two warp ballots a row into 64 bits next to the stage, on the
//   stage's mbarrier. A consumer reads four words a tile and selects with one
//   AND per element. The key metadata comes from device memory (L2) at fill
//   time, so the stage holds the bits and not the metadata.
// - Serial (K2 / K3, K8): S, softmax, P V on each tile; the fill of a later
//   stage runs under S. Pipelined (K4, kPipe): tile t + 1's S and tile t's
//   P V are issued together, and tile t + 1's exponentials run while they are
//   in flight. With three warpgroups a block (one an SM: 186 KB of shared
//   memory at D 128) the serial form holds 156-168 registers, the pipelined
//   one spills at 168 (PERF.md). K8 runs the serial form (131 KB at D 128).
//   A warpgroup whose own code is SKIP on a stage that another warpgroup needs
//   first finishes its pending P V, so that it never holds a stage while the
//   ring laps it.
//
// Both schedules: softmax in registers in exp2 units: scale log2(e) folded
// into one FFMA per element (for a positive scale), the hardware ex2
// (fast_exp2), K2's exact running maximum, one warp-uniform branch per tile
// (FULL or PARTIAL) and branch-free selects inside. A row with nothing
// visible yet shifts by 0; a row that sees no key is written as 0 (lse
// kLseEmpty). No atomics: every output row has one owner, two launches are
// bitwise equal.

#include <cuda.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kRows = 64;  // rows of every tile: a warpgroup's query rows, a stage's keys

// The lockstep schedules' block and ring, the same at every head dim.
constexpr int kWgs = 3;  // consumer warpgroups
constexpr int kSegThreads = kWgs * 128;
constexpr int kSegWarps = kSegThreads / 32;

// The warp-specialised schedule (K2 and K3 at head dim 128): two consumer warpgroups and a producer one.
constexpr int kWsWgs = 2;  // the stage's info holds a code for each
constexpr int kWsProducerWarps = 4;
constexpr int kWsThreads = kWsWgs * 128 + kWsProducerWarps * 32;
constexpr int kBarProducer = 1 + kWsWgs;  // named barriers: 1 + wg the Q tiles, then the producer's, then the turns
constexpr int kBarTurn = kBarProducer + 1;

template <int D, bool kPipe, bool kInt8>
constexpr bool kWarpSpecialised = D == 128 && !kPipe && !kInt8;

template <int D, bool kInt8>
struct SegSmem {
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 2;  // copies run kAhead tiles ahead: a warpgroup holds at most two stages
  static constexpr int kDs = D == 80 ? 96 : D;  // columns of a T tile in shared memory
  static constexpr int kDp = (D + 31) / 32 * 32;  // bytes of a q8 / k8 row (K8)
  static constexpr int kTile = kRows * kDs * 2;  // a T tile
  static constexpr int kQkTile = kInt8 ? kRows * 128 : kTile;    // a Q or K tile: int8 rows of 128 bytes (K8)
  static constexpr int kQ = 0;                                    // [kWgs] Q tiles
  static constexpr int kK = kQ + kWgs * kQkTile;                  // [kStages] K tiles
  static constexpr int kV = kK + kStages * kQkTile;               // [kStages] V tiles
  static constexpr int kMaskStage = kWgs * kRows * 8;             // [query tile][row][2] uint32 of a stage
  static constexpr int kMask = kV + kStages * kTile;              // [kStages] masks
  static constexpr int kKs = kMask + kStages * kMaskStage;        // [kStages][64] fp32 key scales (K8)
  static constexpr int kQMeta = kKs + (kInt8 ? kStages * kRows * 4 : 0);  // [kWgs * 64] int4 query metadata
  static constexpr int kInfo = kQMeta + kWgs * kRows * 16;        // [kStages] int4 (kv tile, code per query tile)
  static constexpr int kBar = kInfo + kStages * 16;               // full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;    // + alignment slack
  static_assert(kBytes <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

// The warp-specialised schedule's shared memory at QK head dim DQK and V head dim DV (128 and 128:
// K2 / K3; 192 and 128: the MLA forward): its stages are filled by TMA, whose 64 x 64 boxes land as
// the column blocks of a swizzled T tile. Five stages at 128 / 128; at 192 / 128 four fit the 227 KB.
template <int DQK, int DV>
struct WsSmem {
  static constexpr int kStages = DQK == 128 ? 5 : 4;
  static constexpr int kQkTile = kRows * DQK * 2;             // a 64 x DQK T tile (Q, K)
  static constexpr int kVTile = kRows * DV * 2;               // a 64 x DV T tile (V)
  static constexpr int kQ = 0;                                // [kWsWgs] Q tiles
  static constexpr int kK = kQ + kWsWgs * kQkTile;            // [kStages] K tiles
  static constexpr int kV = kK + kStages * kQkTile;           // [kStages] V tiles
  static constexpr int kMaskStage = kWsWgs * kRows * 8;       // [query tile][row][2] uint32 of a stage
  static constexpr int kMask = kV + kStages * kVTile;         // [kStages] masks
  static constexpr int kQMeta = kMask + kStages * kMaskStage;  // [kWsWgs * 64] int4 query metadata
  static constexpr int kInfo = kQMeta + kWsWgs * kRows * 16;  // [kStages] int4 (kv tile, code per query tile)
  static constexpr int kBar = kInfo + kStages * 16;           // full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct SegmentArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // contiguous (Sq, H, D)
  const int4* q_meta;
  const int4* kv_meta;
  const int8_t* codes;  // (ceil(Sq / 64), ceil(Skv / 64))
  int sq, skv, h, kvh;
  long long q_ss, q_sh;
  long long k_ss, k_sh;
  long long v_ss, v_sh;
  float scale_log2;  // K8: 1 (the scale is in qs)
  float* lse;  // contiguous (H, Sq), or null
  const float* qs = nullptr;  // K8: (H, Sq) query scales, folded with scale log2(e)
  const float* ks = nullptr;  // K8: (KVH, Skv) key scales
  CUtensorMap k_map{}, v_map{};  // the warp-specialised schedule: k and v as 64-row boxes of 64 columns
};

// A block's share of the launch, as `segment_fwd_grid` reckons the grid: hb
// query heads times qb query tiles, hb * qb = wgs (the consumer warpgroups).
// Warpgroup w holds head head0 + w % hb and query tile qt0 + w / hb.
struct BlockPlan {
  int hb, qb, kv_h, head0, qt0;
};

__device__ __forceinline__ BlockPlan block_plan(const SegmentArgs& a, int wgs) {
  const int group = a.h / a.kvh;
  BlockPlan p;
  p.hb = group % wgs == 0 ? wgs : 1;
  p.qb = wgs / p.hb;
  const int n_hg = group / p.hb;
  const int n_qtb = cdiv(cdiv(a.sq, kRows), p.qb);
  int x = blockIdx.x;
  const int qtb = x % n_qtb;
  x /= n_qtb;
  const int hg = x % n_hg;
  p.kv_h = x / n_hg;
  p.head0 = p.kv_h * group + hg * p.hb;
  p.qt0 = qtb * p.qb;
  return p;
}

// Copies `rows` valid rows (of 64) of a D-wide row-major global tile into a
// kDs-column swizzled tile; rows past `rows` are zero-filled, columns past D
// are not written. With T = int8_t (K8) a row is D bytes and the tile has the
// layout of a 64-column bf16 one (rows of 128 bytes).
template <typename T, int D, int kDs>
__device__ __forceinline__ void load_rows(uint32_t tile, const T* src, long long row_stride, int rows, int tid,
                                          int nthreads) {
  constexpr int kPerChunk = 16 / sizeof(T);
  constexpr int kChunks = D / kPerChunk;
  constexpr int kCols = sizeof(T) == 1 ? 64 : kDs;  // the bf16 tile whose layout this one has
  for (int i = tid; i < kRows * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = r < rows;
    cp_async16_u32(tile + swizzled_offset<kCols, kRows>(r, c), ok ? src + r * row_stride + c * kPerChunk : src, ok);
  }
}

// x[64 x 64] = A B^T of two int8 tiles (load_rows<int8_t, DP, ..>), s32, over DP / 32 k-steps
template <int DP>
__device__ __forceinline__ void product_abt_s8(int32_t (&x)[32], uint32_t tile_a, uint32_t tile_b) {
#pragma unroll
  for (int kk = 0; kk < DP / 32; ++kk) {
    wgmma_s8_ss(x, desc_k_major<64, 64>(tile_a, kk), desc_k_major<64, 64>(tile_b, kk), kk > 0);
  }
}

// S in log2 units from the s32 product: float(s) * qs[row] * ks[col], the row scale first (K8)
__device__ __forceinline__ void dequantise(float (&s)[32], const int32_t (&x)[32], const float (&qs)[2],
                                           const float* ks) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 kc = *reinterpret_cast<const float2*>(ks + 8 * j + 2 * qd);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * j + e] = __int2float_rn(x[4 * j + e]) * qs[e >> 1] * (e & 1 ? kc.y : kc.x);
  }
}

// One tile's online softmax in exp2 units, as attention_batched.cu's, with the
// mask of a PARTIAL tile as bits: wq[row][half] holds this thread's row's 32
// visibility bits of keys 32 half .. 32 half + 31, shifted right by 2 (tid % 4),
// so that element i (row (i >> 1) & 1, key 8 (i >> 2) + 2 (tid % 4) + (i & 1))
// is bit 8 ((i >> 2) & 3) + (i & 1) of word i >> 4.
template <bool kMask, bool kPos>
__device__ __forceinline__ void softmax_tile(float (&s)[32], const uint32_t (&wq)[2][2], float c, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!kPos) s[i] *= c;
    if (kMask) s[i] = wq[(i >> 1) & 1][i >> 4] & (1u << (8 * ((i >> 2) & 3) + (i & 1))) ? s[i] : -INFINITY;
  }
  float m_use[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float mx = row_reduce<true>(s, row);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[row], kPos ? mx * c : mx);  // c > 0: the maximum commutes with it
    // a row with nothing visible yet shifts by 0, so 2^-inf stays 0, never NaN
    m_use[row] = m_new == -INFINITY ? 0.f : m_new;
    alpha[row] = fast_exp2(m_run[row] - m_use[row]);
    m_run[row] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float m = m_use[(i >> 1) & 1];
    s[i] = fast_exp2(kPos ? fmaf(s[i], c, -m) : s[i] - m);
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) l_run[row] = l_run[row] * alpha[row] + row_reduce<false>(s, row);
}

// softmax_tile on a tile of the given code: one warp-uniform branch on the code
// and on the sign of c, which is one for the whole launch
__device__ __forceinline__ void softmax_step(float (&s)[32], int code, const uint32_t* mask_rows, float c,
                                             float (&m_run)[2], float (&l_run)[2], float (&alpha)[2]) {
  if (code == kPartial) {
    const int tid = threadIdx.x % 128;
    const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
    const int sh = 2 * (tid & 3);
    uint32_t wq[2][2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const uint2 w = *reinterpret_cast<const uint2*>(mask_rows + 2 * (r0 + 8 * row));
      wq[row][0] = w.x >> sh;
      wq[row][1] = w.y >> sh;
    }
    if (c > 0.f) {
      softmax_tile<true, true>(s, wq, c, m_run, l_run, alpha);
    } else {
      softmax_tile<true, false>(s, wq, c, m_run, l_run, alpha);
    }
  } else {
    const uint32_t none[2][2] = {};
    if (c > 0.f) {
      softmax_tile<false, true>(s, none, c, m_run, l_run, alpha);
    } else {
      softmax_tile<false, false>(s, none, c, m_run, l_run, alpha);
    }
  }
}

// A warpgroup's 64 output rows (and their lse) from its accumulator: O / l, 0 for a row that sees no key
template <typename T, int D, int kDs, bool kLse>
__device__ __forceinline__ void store_rows(const SegmentArgs& a, const float (&acc)[kDs / 2], const float (&m_run)[2],
                                           const float (&l_run)[2], int h, int q0, int n_rows) {
  if (n_rows <= 0) return;
  const int tid = threadIdx.x % 128;
  const int g = (tid & 31) >> 2;
  const int qd = tid & 3;
  const long long o_ss = static_cast<long long>(a.h) * D;
  T* o = static_cast<T*>(a.o) + static_cast<long long>(q0) * o_ss + h * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float l = l_run[row];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key is written as 0
    const int rr = (tid >> 5) * 16 + g + row * 8;
    if (rr < n_rows) {
      if (kLse && qd == 0) {
        a.lse[static_cast<long long>(h) * a.sq + q0 + rr] = l > 0.f ? m_run[row] * kLn2 + logf(l) : kLseEmpty;
      }
      T* dst = o + rr * o_ss + qd * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack2<T>(acc[4 * j + 2 * row] * inv, acc[4 * j + 2 * row + 1] * inv);
      }
    }
  }
}

// The lockstep schedules: three consumer warpgroups that also fill the ring
template <typename T, int D, bool kLse, bool kPipe, bool kInt8>
__device__ __forceinline__ void segment_fwd_lockstep(const SegmentArgs& a) {
  using L = SegSmem<D, kInt8>;
  using QK = std::conditional_t<kInt8, int8_t, T>;  // the type of q and k
  constexpr int kDs = L::kDs;
  constexpr int kDqk = kInt8 ? L::kDp : D;  // elements of a q / k row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L::kMask);
  int4* s_qmeta = reinterpret_cast<int4*>(smem + L::kQMeta);
  int4* s_info = reinterpret_cast<int4*>(smem + L::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;

  const BlockPlan bp = block_plan(a, kWgs);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int n_q_tiles = cdiv(a.sq, kRows);
  const int n_kv_tiles = cdiv(a.skv, kRows);
  const int qtl = wg / bp.hb;  // this warpgroup's query tile among the block's
  const int h = bp.head0 + wg % bp.hb;
  const int q0 = (bp.qt0 + qtl) * kRows;
  const int n_rows = max(0, min(kRows, a.sq - q0));

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], kSegThreads + kSegWarps);  // a cp.async arrival per thread, a plain one per warp
      mbar_init(&empty[st], kSegWarps);                // one release per warp
    }
    mbar_init_fence();
  }
  // the query metadata of the block's rows; rows past Sq never match anything (doc -2, as the TPU wrapper pads)
  for (int r = threadIdx.x; r < bp.qb * kRows; r += kSegThreads) {
    const int row = bp.qt0 * kRows + r;
    s_qmeta[r] = row < a.sq ? a.q_meta[row] : make_int4(-2, -1, -1, 0);
  }
  if constexpr (kDs != D) {  // zero the pad columns of every T tile once: the copies never write them
    constexpr int kPadChunks = (kDs - D) / 8;
    // Q, K and V tiles are contiguous; K8's int8 Q and K arrive padded and read only DP / 32 k-steps
    constexpr int kTiles = kInt8 ? L::kStages : kWgs + 2 * L::kStages;
    constexpr int kFirst = kInt8 ? L::kV : L::kQ;
    for (int i = threadIdx.x; i < kTiles * kRows * kPadChunks; i += kSegThreads) {
      const int t = i / (kRows * kPadChunks);
      const int r = (i / kPadChunks) % kRows;
      const int c = D / 8 + i % kPadChunks;
      *reinterpret_cast<int4*>(smem + kFirst + t * L::kTile + swizzled_offset<kDs, kRows>(r, c)) =
          make_int4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  // this warpgroup's Q tile
  const uint32_t s_q = sb + L::kQ + wg * L::kQkTile;
  load_rows<QK, kDqk, kDs>(s_q, static_cast<const QK*>(a.q) + h * a.q_sh +
                                    static_cast<long long>(n_rows > 0 ? q0 : 0) * a.q_ss,
                           a.q_ss, n_rows, tid, 128);
  cp_async_commit();

  // The ring: every thread issues its share of each live K / V tile kAhead tiles ahead of the
  // products, and of the mask of a PARTIAL one; tiles that are SKIP for every query tile of the
  // block never enter it.
  const QK* kp = static_cast<const QK*>(a.k) + bp.kv_h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + bp.kv_h * a.v_sh;
  const float* ksp = kInt8 ? a.ks + static_cast<long long>(bp.kv_h) * a.skv : nullptr;
  auto tile_code = [&](int j, int t) {  // code of the block's query tile j against kv tile t
    const int qt = bp.qt0 + j;
    return j < bp.qb && qt < n_q_tiles ? static_cast<int>(a.codes[static_cast<long long>(qt) * n_kv_tiles + t])
                                       : kSkip;
  };
  int ld_t = 0, ld_stage = 0, ld_phase = 0, n_issued = 0;
  auto issue_next = [&]() {
    while (ld_t < n_kv_tiles) {
      const int t = ld_t++;
      const int c0 = tile_code(0, t), c1 = tile_code(1, t), c2 = tile_code(2, t);
      if (c0 == kSkip && c1 == kSkip && c2 == kSkip) continue;
      mbar_wait(&empty[ld_stage], ld_phase ^ 1);
      const int n0 = t * kRows;
      const int rows = min(kRows, a.skv - n0);
      load_rows<QK, kDqk, kDs>(sb + L::kK + ld_stage * L::kQkTile, kp + n0 * a.k_ss, a.k_ss, rows, threadIdx.x,
                               kSegThreads);
      load_rows<T, D, kDs>(sb + L::kV + ld_stage * L::kTile, vp + n0 * a.v_ss, a.v_ss, rows, threadIdx.x,
                           kSegThreads);
      if constexpr (kInt8) {  // the tile's key scales; keys past Skv read as 0
        if (threadIdx.x < kRows) {
          const bool ok = static_cast<int>(threadIdx.x) < rows;
          cp_async4_u32(sb + L::kKs + (ld_stage * kRows + threadIdx.x) * 4, ok ? ksp + n0 + threadIdx.x : ksp, ok);
        }
      }
      mbar_arrive_cp_async(&full[ld_stage]);
      if (c0 == kPartial || c1 == kPartial || c2 == kPartial) {
        // the mask of each PARTIAL query tile j: bit c of word (j, r, h) is pair (query row j * 64 + r,
        // key n0 + 32 h + c) visible; a lane evaluates one key of a word, the warp's ballot packs it
        int4 km0 = make_int4(-1, -1, -1, -1), km1 = km0;
        if (lane < rows) km0 = a.kv_meta[n0 + lane];
        if (lane + 32 < rows) km1 = a.kv_meta[n0 + 32 + lane];
        uint2* mask = reinterpret_cast<uint2*>(s_mask + ld_stage * (L::kMaskStage / 4));
        for (int j = 0; j < bp.qb; ++j) {
          if ((j == 0 ? c0 : j == 1 ? c1 : c2) != kPartial) continue;
#pragma unroll 2
          for (int r = j * kRows + warp; r < (j + 1) * kRows; r += kSegWarps) {
            const int4 qm = s_qmeta[r];
            const uint32_t lo = __ballot_sync(0xffffffffu, seg_visible(qm, km0));
            const uint32_t hi = __ballot_sync(0xffffffffu, seg_visible(qm, km1));
            if (lane == 0) mask[r] = make_uint2(lo, hi);
          }
        }
      }
      if (threadIdx.x == 0) s_info[ld_stage] = make_int4(t, c0, c1, c2);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[ld_stage]);  // after the warp's writes of the mask and the info
      next_stage<L::kStages>(ld_stage, ld_phase);
      ++n_issued;
      return;
    }
  };
  for (int i = 0; i < L::kAhead; ++i) issue_next();

  cp_async_wait<0>();  // this thread's Q chunks (the ring's copies are in no group)
  fence_proxy_async();
  named_barrier(1 + wg, 128);  // the warpgroup's Q tile is in place

  const float scale_log2 = a.scale_log2;
  float acc[kDs / 2];
#pragma unroll
  for (int i = 0; i < kDs / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums, added over the quad at the end
  float alpha[2];
  float s[32];
  int32_t si[kInt8 ? 32 : 1];  // K8's s32 S
  float qs[2] = {0.f, 0.f};    // K8's scales of this thread's two query rows
  uint32_t p[4][4];
  if constexpr (kInt8) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int rr = (tid >> 5) * 16 + ((tid & 31) >> 2) + row * 8;
      if (rr < n_rows) qs[row] = a.qs[static_cast<long long>(h) * a.sq + q0 + rr];
    }
  }
  // S = Q K^T of a stage, issued (not committed); then, once it has arrived, in float registers
  auto issue_s = [&](int st) {
    if constexpr (kInt8) {
      product_abt_s8<L::kDp>(si, s_q, sb + L::kK + st * L::kQkTile);
    } else {
      product_abt<T, kDs>(s, s_q, sb + L::kK + st * L::kQkTile);
    }
  };
  auto s_arrived = [&](int st) {
    if constexpr (kInt8) {
      fence_regs(si);
      dequantise(s, si, qs, reinterpret_cast<const float*>(smem + L::kKs) + st * kRows);
    } else {
      fence_regs(s);
    }
  };
  auto my_code = [&](int st) {
    const int4 info = s_info[st];
    return n_rows == 0 ? kSkip : qtl == 0 ? info.y : qtl == 1 ? info.z : info.w;
  };
  auto mask_rows = [&](int st) { return s_mask + st * (L::kMaskStage / 4) + qtl * kRows * 2; };

  int stage = 0, phase = 0;
  if (!kPipe) {
    for (int n_done = 0; n_done < n_issued; ++n_done) {
      mbar_wait(&full[stage], phase);
      const int code = my_code(stage);
      if (code == kSkip) {
        issue_next();
      } else {
        fence_proxy_async();
        wgmma_fence();
        issue_s(stage);
        wgmma_commit();
        issue_next();  // the fill of a later stage runs under the product
        wgmma_wait<0>();
        s_arrived(stage);
        softmax_step(s, code, mask_rows(stage), scale_log2, m_run, l_run, alpha);
        rescale<kDs>(acc, alpha);
        to_a_operands<T>(p, s);
        wgmma_fence();
        product_ab<T, kDs>(acc, p, sb + L::kV + stage * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      release(&empty[stage]);
      next_stage<L::kStages>(stage, phase);
    }
  } else {
    int st_p = -1;  // the stage whose P V is pending, with its P in p
    auto flush = [&]() {
      wgmma_fence();
      product_ab<T, kDs>(acc, p, sb + L::kV + st_p * L::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(&empty[st_p]);
      st_p = -1;
    };
    for (int n_done = 0; n_done < n_issued; ++n_done) {
      mbar_wait(&full[stage], phase);
      const int st = stage;
      next_stage<L::kStages>(stage, phase);
      const int code = my_code(st);
      if (code == kSkip) {  // another warpgroup's tile: finish the pending P V, pass the stage on
        issue_next();
        if (st_p >= 0) flush();
        release(&empty[st]);
        continue;
      }
      fence_proxy_async();
      if (st_p < 0) {
        wgmma_fence();
        issue_s(st);
        wgmma_commit();
        issue_next();
        wgmma_wait<0>();
        s_arrived(st);
        softmax_step(s, code, mask_rows(st), scale_log2, m_run, l_run, alpha);
        rescale<kDs>(acc, alpha);
        to_a_operands<T>(p, s);
        st_p = st;
        continue;
      }
      // each wgmma pipeline is straight-line code: ptxas serialises wgmma issued under a branch
      wgmma_fence();
      issue_s(st);  // S of this tile
      wgmma_commit();
      product_ab<T, kDs>(acc, p, sb + L::kV + st_p * L::kTile);  // O += P V of the pending one
      wgmma_commit();
      issue_next();
      wgmma_wait<1>();  // S is in; P V runs on under its exponentials
      s_arrived(st);
      softmax_step(s, code, mask_rows(st), scale_log2, m_run, l_run, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);  // P stays live until its product is done
      release(&empty[st_p]);
      rescale<kDs>(acc, alpha);
      to_a_operands<T>(p, s);  // only now: registers of an operand in flight must not be written
      st_p = st;
    }
    if (st_p >= 0) flush();
  }

  store_rows<T, D, kDs, kLse>(a, acc, m_run, l_run, h, q0, n_rows);
  cp_async_wait_all();
}

// The warp-specialised schedule of K2 and K3 at head dim 128 (DQK = DV = 128), and of the MLA forward
// (DQK 192, DV 128: q and k carry 64 rope columns past the 128 of v). Warpgroups 0 and 1 are consumers: each
// holds 64 query rows (two heads of a GQA group on the same rows, or two query tiles of one head), its
// own S, P and O, and issues only wgmma. Warpgroup 2 is the producer: one thread fills the ring by TMA,
// the four warps build the PARTIAL masks. The consumers take turns on the tensor cores (named barriers
// 4 and 5): each issues S of its next tile with P V of its last one and passes the turn, so that one
// warpgroup's softmax runs under the other's products.
template <typename T, bool kLse, int DQK, int DV>
__device__ __forceinline__ void segment_fwd_ws(const SegmentArgs& a) {
  using L = WsSmem<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L::kMask);
  int4* s_qmeta = reinterpret_cast<int4*>(smem + L::kQMeta);
  int4* s_info = reinterpret_cast<int4*>(smem + L::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;

  const BlockPlan bp = block_plan(a, kWsWgs);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform to the compiler too
  const int lane = threadIdx.x & 31;
  const int n_q_tiles = cdiv(a.sq, kRows);
  const int n_kv_tiles = cdiv(a.skv, kRows);
  auto tile_code = [&](int j, int t) {  // code of the block's query tile j against kv tile t
    const int qt = bp.qt0 + j;
    return j < bp.qb && qt < n_q_tiles ? static_cast<int>(a.codes[static_cast<long long>(qt) * n_kv_tiles + t])
                                       : kSkip;
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], kWsProducerWarps + 1);  // the TMA's bytes with one arrival, and one per producer warp
      mbar_init(&empty[st], kWsWgs * 4);           // one release per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWsWgs) {
    // The producer: each live K / V tile by TMA into the next free stage, and the mask of a PARTIAL one;
    // tiles that are SKIP for both query tiles of the block never enter the ring.
    const int ptid = threadIdx.x - kWsWgs * 128;
    const int pwarp = ptid / 32;
    // the query metadata of the block's rows; rows past Sq never match anything (doc -2, as the TPU wrapper pads)
    for (int r = ptid; r < bp.qb * kRows; r += kWsProducerWarps * 32) {
      const int row = bp.qt0 * kRows + r;
      s_qmeta[r] = row < a.sq ? a.q_meta[row] : make_int4(-2, -1, -1, 0);
    }
    named_barrier(kBarProducer, kWsProducerWarps * 32);
    int st = 0, ph = 0;
    for (int t = 0; t < n_kv_tiles; ++t) {
      int c[kWsWgs];  // each consumer's code
      bool live = false, partial = false;
#pragma unroll
      for (int j = 0; j < kWsWgs; ++j) {
        c[j] = tile_code(j, t);
        live |= c[j] != kSkip;
        partial |= c[j] == kPartial;
      }
      if (!live) continue;
      mbar_wait_sleep(&empty[st], ph ^ 1);
      const int n0 = t * kRows;
      if (ptid == 0) {  // rows past Skv arrive as zeros
        mbar_arrive_expect_tx(&full[st], L::kQkTile + L::kVTile);
#pragma unroll
        for (int cb = 0; cb < (DQK > DV ? DQK : DV) / 64; ++cb) {
          if (cb < DQK / 64) {
            tma_load_3d(sb + L::kK + st * L::kQkTile + cb * kRows * 128, &a.k_map, &full[st], 64 * cb, bp.kv_h, n0);
          }
          if (cb < DV / 64) {
            tma_load_3d(sb + L::kV + st * L::kVTile + cb * kRows * 128, &a.v_map, &full[st], 64 * cb, bp.kv_h, n0);
          }
        }
        s_info[st] = make_int4(t, c[0], c[1], 0);
      }
      if (partial) {
        // the mask of each PARTIAL query tile j: bit c of word (j, r, h) is pair (query row j * 64 + r,
        // key n0 + 32 h + c) visible; a lane evaluates one key of a word, the warp's ballot packs it
        const int rows = min(kRows, a.skv - n0);
        int4 km0 = make_int4(-1, -1, -1, -1), km1 = km0;
        if (lane < rows) km0 = a.kv_meta[n0 + lane];
        if (lane + 32 < rows) km1 = a.kv_meta[n0 + 32 + lane];
        uint2* mask = reinterpret_cast<uint2*>(s_mask + st * (L::kMaskStage / 4));
        for (int j = 0; j < bp.qb; ++j) {
          if (c[j] != kPartial) continue;
#pragma unroll 2
          for (int r = j * kRows + pwarp; r < (j + 1) * kRows; r += kWsProducerWarps) {
            const int4 qm = s_qmeta[r];
            const uint32_t lo = __ballot_sync(0xffffffffu, seg_visible(qm, km0));
            const uint32_t hi = __ballot_sync(0xffffffffu, seg_visible(qm, km1));
            if (lane == 0) mask[r] = make_uint2(lo, hi);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);  // after the warp's writes of the mask and the info
      next_stage<L::kStages>(st, ph);
    }
    return;
  }

  // a consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int qtl = wg / bp.hb;  // this warpgroup's query tile among the block's
  const int h = bp.head0 + wg % bp.hb;
  const int q0 = (bp.qt0 + qtl) * kRows;
  const int n_rows = max(0, min(kRows, a.sq - q0));
  const uint32_t s_q = sb + L::kQ + wg * L::kQkTile;
  const T* q_rows = static_cast<const T*>(a.q) + h * a.q_sh + static_cast<long long>(n_rows > 0 ? q0 : 0) * a.q_ss;
  load_rows<T, DQK, DQK>(s_q, q_rows, a.q_ss, n_rows, tid, 128);
  cp_async_commit();
  int n_live = 0;  // the tiles the producer puts in the ring
  for (int t0 = 0; t0 < n_kv_tiles; t0 += 32) {
    const int t = t0 + lane;
    bool live = false;
#pragma unroll
    for (int j = 0; j < kWsWgs; ++j) live |= t < n_kv_tiles && tile_code(j, t) != kSkip;
    n_live += __popc(__ballot_sync(0xffffffffu, live));
  }
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + wg, 128);  // the warpgroup's Q tile is in place

  // the turns on the tensor cores: warpgroup 0 takes the first
  if (wg == 1) named_barrier_arrive(kBarTurn, 256);
  auto take_turn = [&]() { named_barrier(kBarTurn + wg, 256); };
  auto pass_turn = [&]() { named_barrier_arrive(kBarTurn + 1 - wg, 256); };

  const float scale_log2 = a.scale_log2;
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial sums, added over the quad at the end
  float alpha[2];
  float s[32];
  uint32_t p[4][4];
  auto issue_s = [&](int st) { product_abt<T, DQK>(s, s_q, sb + L::kK + st * L::kQkTile); };
  auto rescale_acc = [&]() {  // a warp whose rows' maxima all stood still multiplies by 1: it skips that
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale<DV>(acc, alpha);
  };
  auto my_code = [&](int st) {
    const int4 info = s_info[st];
    return n_rows == 0 ? kSkip : qtl == 0 ? info.y : info.z;
  };
  auto mask_rows = [&](int st) { return s_mask + st * (L::kMaskStage / 4) + qtl * kRows * 2; };

  // K4's order of work, so K2's arithmetic: S of tile t + 1 and P V of tile t issued together, tile
  // t + 1's softmax under them
  int stage = 0, phase = 0;
  int st_p = -1;  // the stage whose P V is pending, with its P in p
  auto flush = [&]() {
    wgmma_fence();
    product_ab<T, DV>(acc, p, sb + L::kV + st_p * L::kVTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&empty[st_p]);
    st_p = -1;
  };
  for (int n_done = 0; n_done < n_live; ++n_done) {
    mbar_wait_sleep(&full[stage], phase);
    const int st = stage;
    next_stage<L::kStages>(stage, phase);
    const int code = my_code(st);
    take_turn();
    if (code == kSkip) {  // the other warpgroup's tile: finish the pending P V, pass the stage on
      pass_turn();
      if (st_p >= 0) flush();
      release(&empty[st]);
      continue;
    }
    if (st_p < 0) {
      wgmma_fence();
      issue_s(st);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_step(s, code, mask_rows(st), scale_log2, m_run, l_run, alpha);
      rescale_acc();
      to_a_operands<T>(p, s);
      st_p = st;
      continue;
    }
    // each wgmma pipeline is straight-line code: ptxas serialises wgmma issued under a branch
    wgmma_fence();
    issue_s(st);  // S of this tile
    wgmma_commit();
    product_ab<T, DV>(acc, p, sb + L::kV + st_p * L::kVTile);  // O += P V of the pending one
    wgmma_commit();
    pass_turn();
    wgmma_wait<1>();  // S is in; P V runs on under its exponentials, and the other warpgroup's products
    fence_regs(s);
    softmax_step(s, code, mask_rows(st), scale_log2, m_run, l_run, alpha);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);  // P stays live until its product is done
    release(&empty[st_p]);
    rescale_acc();
    to_a_operands<T>(p, s);  // only now: registers of an operand in flight must not be written
    st_p = st;
  }
  if (st_p >= 0) flush();
  if (wg == 0) take_turn();  // warpgroup 1's last pass: the turns' arrivals balance

  store_rows<T, DV, DV, kLse>(a, acc, m_run, l_run, h, q0, n_rows);
}

template <typename T, int D, bool kLse, bool kPipe, bool kInt8>
__global__ void __launch_bounds__(kWarpSpecialised<D, kPipe, kInt8> ? kWsThreads : kSegThreads, 1)
    segment_fwd_kernel(const __grid_constant__ SegmentArgs a) {
  if constexpr (kWarpSpecialised<D, kPipe, kInt8>) {
    segment_fwd_ws<T, kLse, 128, 128>(a);
  } else {
    segment_fwd_lockstep<T, D, kLse, kPipe, kInt8>(a);
  }
}

// The MLA forward: K2's warp-specialised schedule and plan at QK head dim DQK and V head dim DV, without
// lse. A kernel of its own name, so that a trace tells it from K2's launches.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kWsThreads, 1) mla_fwd_kernel(const __grid_constant__ SegmentArgs a) {
  segment_fwd_ws<T, false, DQK, DV>(a);
}

template <typename T>
cudaError_t launch_mla(const SegmentArgs& a, int n_blocks, cudaStream_t stream) {
  constexpr int smem = WsSmem<192, 128>::kBytes;
  auto kernel = mla_fwd_kernel<T, 192, 128>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kWsThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLse, bool kPipe, bool kInt8 = false>
cudaError_t launch_as(const SegmentArgs& a, int n_blocks, cudaStream_t stream) {
  constexpr bool kWs = kWarpSpecialised<D, kPipe, kInt8>;
  constexpr int smem = kWs ? WsSmem<128, 128>::kBytes : SegSmem<D, kInt8>::kBytes;
  auto kernel = segment_fwd_kernel<T, D, kLse, kPipe, kInt8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kWs ? kWsThreads : kSegThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a (rows, heads, cols) view (strides in elements, the head dim contiguous) whose box is
// 64 rows of one head by 64 columns, 128-byte swizzled: a column block of a T tile. Rows past the end
// arrive as zeros.
bool tile_map(CUtensorMap* map, int dtype, const void* base, int rows, int heads, long long row_stride,
              long long head_stride, int cols = 128) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || rows < 1) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(head_stride) * 2, static_cast<cuuint64_t>(row_stride) * 2};
  const cuuint32_t box[3] = {64, 1, kRows};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, bool kPipe>
cudaError_t launch(const SegmentArgs& a, int n_blocks, cudaStream_t stream) {
  return a.lse ? launch_as<T, D, true, kPipe>(a, n_blocks, stream)
               : launch_as<T, D, false, kPipe>(a, n_blocks, stream);
}

template <typename T, bool kPipe>
cudaError_t dispatch(const SegmentArgs& a, int d, int n_blocks, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, kPipe>(a, n_blocks, stream);
    case 80: return launch<T, 80, kPipe>(a, n_blocks, stream);  // the Qwen2-VL ViT's head dim
    case 96: return launch<T, 96, kPipe>(a, n_blocks, stream);
    case 128: return launch<T, 128, kPipe>(a, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K8: serial, no lse
template <typename T>
cudaError_t dispatch_int8(const SegmentArgs& a, int d, int n_blocks, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_as<T, 64, false, false, true>(a, n_blocks, stream);
    case 80: return launch_as<T, 80, false, false, true>(a, n_blocks, stream);
    case 96: return launch_as<T, 96, false, false, true>(a, n_blocks, stream);
    case 128: return launch_as<T, 128, false, false, true>(a, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kPipe>
int entry(int dtype, const SegmentArgs& a, int d, int n_blocks, void* stream) {
  if (a.h % a.kvh != 0 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch<__nv_bfloat16, kPipe>(a, d, n_blocks, st)
                                     : dispatch<__half, kPipe>(a, d, n_blocks, st));
}

}  // namespace

// q (Sq, H, D), k/v (Skv, KVH, D); q_meta (Sq, 4) and kv_meta (Skv, 4) int32
// (doc, fn, noise, pos); codes (ceil(Sq/64), ceil(Skv/64)) int8 tile codes.
// The output is a contiguous (Sq, H, D) tensor; lse is a contiguous fp32
// (H, Sq) tensor or null. dtype: 0 = bf16, 1 = fp16. Strides are in elements;
// the head dim is contiguous. n_blocks is the grid that `segment_fwd_grid`
// reckons for g2_segment_attention_warpgroups(d, 0, 0) warpgroups a block. At
// head dim 128 k and v are read by TMA: their base and strides must be
// multiples of 16 bytes. Returns a cudaError_t.
extern "C" int g2_segment_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    float scale, void* stream, int n_blocks) {
  SegmentArgs a{q, k, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
                static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh,
                scale * kLog2e, static_cast<float*>(lse)};
  if (d == 128 &&
      !(tile_map(&a.k_map, dtype, k, skv, kvh, k_ss, k_sh) && tile_map(&a.v_map, dtype, v, skv, kvh, v_ss, v_sh))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return entry<false>(dtype, a, d, n_blocks, stream);
}

// K4: the same arguments, the pipelined schedule; n_blocks for
// g2_segment_attention_warpgroups(d, 1, 0) warpgroups a block.
extern "C" int g2_segment_attention_pipe(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    float scale, void* stream, int n_blocks) {
  SegmentArgs a{q, k, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
                static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh,
                scale * kLog2e, static_cast<float*>(lse)};
  return entry<true>(dtype, a, d, n_blocks, stream);
}

// K8. dtype (of v and the output): 0 = bf16, 1 = fp16. q8 (Sq, H, DP) and k8
// (Skv, KVH, DP) int8 with DP = d rounded up to 32 and zero channels past d;
// qs (H, Sq) and ks (KVH, Skv) contiguous fp32, qs folded with the softmax
// scale times log2(e); v (Skv, KVH, d). Strides are in elements (bytes for
// q8 / k8); the head dim is contiguous and rows are 16-byte aligned. The
// metadata and tile codes are K2's, n_blocks the grid for
// g2_segment_attention_warpgroups(d, 0, 1) warpgroups a block. The output is
// a contiguous (Sq, H, d) tensor. Returns a cudaError_t.
extern "C" int g2_segment_attention_int8(
    int dtype, const void* q8, const void* k8, const void* v, void* o,
    const void* qs, const void* ks,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d, int dp,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    void* stream, int n_blocks) {
  if (h % kvh != 0 || n_blocks < 1 || dp != (d + 31) / 32 * 32) return static_cast<int>(cudaErrorInvalidValue);
  SegmentArgs a{q8, k8, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
                static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh,
                1.f, nullptr, static_cast<const float*>(qs), static_cast<const float*>(ks)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch_int8<__nv_bfloat16>(a, d, n_blocks, st)
                                     : dispatch_int8<__half>(a, d, n_blocks, st));
}

// The MLA forward (Kimi-VL's latent attention in its prefill form): q (Sq, H, dqk), k (Skv, KVH, dqk),
// v (Skv, KVH, dv) with dqk 192 and dv 128 only; metadata, tile codes, strides and n_blocks as
// g2_segment_attention's at head dim 128 (K2's warp-specialised block), and k and v read by TMA: their
// base and strides multiples of 16 bytes. The output is a contiguous (Sq, H, dv) tensor. Returns a
// cudaError_t.
extern "C" int g2_mla_attention(
    int dtype, const void* q, const void* k, const void* v, void* o,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int dqk, int dv,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    float scale, void* stream, int n_blocks) {
  if (dqk != 192 || dv != 128 || h % kvh != 0 || n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  SegmentArgs a{q, k, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
                static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh,
                scale * kLog2e, nullptr};
  if (!(tile_map(&a.k_map, dtype, k, skv, kvh, k_ss, k_sh, dqk) && tile_map(&a.v_map, dtype, v, skv, kvh, v_ss, v_sh, dv))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_mla<__nv_bfloat16>(a, n_blocks, st) : launch_mla<__half>(a, n_blocks, st));
}

// The consumer warpgroups of a block of an entry (pipelined: K4, int8: K8, neither: K2 / K3) at head dim d.
extern "C" int g2_segment_attention_warpgroups(int d, int pipelined, int int8) {
  return d == 128 && !pipelined && !int8 ? kWsWgs : kWgs;
}
