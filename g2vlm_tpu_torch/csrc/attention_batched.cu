// The batched attention forward for Hopper (sm_90a), bf16/fp16 in and out,
// fp32 accumulate.
//
// K1  g2_batched_attention (lse null) replaces g2vlm_tpu/ops/flash_attention.py
//     `_batched_flash_kernel` (:1058, with `_rows_update` :1041), called through
//     `_batched_fwd` (:1256, pallas_call :1295): bidirectional attention inside
//     each batch element, q (B,S,H,D) against k,v (B,M,H,D), keys >= valid_kv
//     masked. The DINOv2 encoder and the Pi3 decoders (self attention, and cross
//     attention to frame 0, whose K/V arrive with batch stride 0) call it.
// K6  the same entry point with an lse pointer replaces `_batched_flash_kernel_lse`
//     (:1127), the training forward: the same out (one template, one flag), plus
//     lse = m + ln(l) in natural units, fp32 (B,H,S); kLseEmpty for a row that
//     sees no key. K7 (attention_bwd.cu) reads it.
//
// What bounds it on the H100. At the main-path shapes, tensor-core operations:
// K1 at a DINOv2-L batch (32, 782, 16, 64) is 4 B H S M D = 80.2 GFLOP (0.081
// ms at 989 TFLOP/s) on 205 MB of q/k/v/o (0.061 ms at 3.35 TB/s); at the Pi3
// shape (32, 777, 16, 96) 118.7 GFLOP (0.120 ms). Close behind them:
// - the exponentials: B H S M = 313 M ex2 at (32, 782, 16, 64), at 16 a clock
//   per SM on the special-function units ~0.08 ms, as long as the products at
//   head dim 64;
// - shared memory: S = Q K^T as m64n64k16 with both operands in shared memory
//   reads 4 KB per 32-clock product, the 128 bytes a clock an SM has, and the
//   K/V copies write into the same banks;
// - L2 reads: a block reads all K/V of its (b, h), 200 KB at D 64, for the
//   query rows it holds: 128 FLOP a byte at 128 rows (at 64 rows a block, 64
//   FLOP a byte: ~15 TB/s of L2 at the tensor-core peak).
//
// The design (hopper_common.cuh has the building blocks):
// - Products on wgmma: S = Q K^T with both operands K-major in shared memory;
//   O += P V with P packed to T in registers as the A operand and V read
//   MN-major from the same swizzled stage. Each consumer warpgroup owns 64 query
//   rows, and a block of FwdConfig<D>::kWgs warpgroups (2 at D 64 and 128, 3 at D
//   96) holds 64 kWgs rows of one (b, h): every K/V stage feeds all of them. A
//   warpgroup whose rows lie past S (the last block of a 782-row view: 13 tiles
//   of 64 in 7 blocks of 2) passes its stages on without products.
// - A ring of K/V stages, filled by 16-byte cp.async that completes on an
//   mbarrier (cp.async.mbarrier.arrive), issued stages - 2 tiles ahead of the
//   products by every thread; each stage is released on a second mbarrier once
//   every warp is done with it. cp.async and not TMA: frame-0 K/V come with
//   batch stride 0 and q/k/v as strided views of the qkv projection, and a
//   per-thread copy zero-fills the rows past M. Q takes the same road: each
//   warpgroup keeps two Q slots and loads the Q of its item after next as soon
//   as it is done with an item, completing on the slot's own mbarrier.
// - Softmax in registers in exp2 units: scale log2(e) folded into one FFMA per
//   element (for a positive scale), the hardware ex2 (fast_exp2), row maxima
//   and sums as trees. Only the last K/V tile of a view is partial: one
//   warp-uniform branch per tile, branch-free selects inside it. A row that
//   has seen nothing yet shifts by 0, never NaN; a row that sees no key is
//   written as 0.
// - At D 96 (FwdConfig::kOverlap) the softmax runs under the tensor cores: tile
//   t + 1's S product and tile t's P V product are issued together, and tile
//   t + 1's exponentials run while they are in flight. At D 64 a warpgroup
//   runs its products and softmax in series, and the overlap comes from two
//   blocks of two warpgroups on each SM instead (the overlapped form needs ~170
//   registers, so one block an SM, and measured 37% slower there).
// - A persistent grid: the host launches as many blocks as fit on the card
//   (`batched_fwd_grid` in ops/flash_attention.py) and each walks the items (b,
//   h, query block) blockIdx.x, blockIdx.x + gridDim.x, ... in order, with the
//   ring running on across items, so that the next item's first tiles load
//   while this one's epilogue stores. Neighbouring blocks hold neighbouring
//   query blocks of one (b, h), so K/V come from device memory about once and
//   from L2 after.
// - No atomics: every output row has one owner, and two launches give bitwise
//   equal out and lse.
// What still holds it (probe builds that left the softmax, the products or the
// copies out, timed on the H100; PERF.md): the products with their
// waits, the copies and the softmax take about as long together as their
// times apart added up; they overlap little.

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

// Per head dim, the consumer warpgroups of a block (64 query rows each) and whether the softmax runs
// under the products: what measured fastest on the H100 among 2 and 3 warpgroups, serial and
// overlapped (PERF.md).
template <int D>
struct FwdConfig {
  static constexpr int kWgs = D == 96 ? 3 : 2;
  static constexpr bool kOverlap = D == 96;
  static constexpr int kThreads = kWgs * 128;
};
constexpr int kRows = 64;  // rows of every tile: a warpgroup's query rows, a stage's keys

template <int D>
struct FwdSmem : FwdConfig<D> {
  using FwdConfig<D>::kWgs;
  static constexpr int kTile = kRows * D * 2;
  static constexpr int kQ = 0;  // [2 slots][kWgs] Q tiles
  static constexpr int kK = kQ + 2 * kWgs * kTile;
  static constexpr int kStages = 4;  // K/V stages of the ring
  // copies run kAhead tiles ahead of the products, so that one warpgroup may
  // trail another by kStages - kAhead - 1 tiles before the ring holds either back
  static constexpr int kAhead = kStages - 2;
  static constexpr int kV = kK + kStages * kTile;    // [kStages] K tiles from kK, V tiles from kV
  static constexpr int kBar = kV + kStages * kTile;  // full[kStages], empty[kStages], q_full[2][kWgs]
  static constexpr int kBytes = kBar + (2 * kStages + 2 * kWgs) * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // contiguous (B, S, H, D)
  float* lse;   // contiguous (B, H, S), or null
  int b, s, m, h;  // m: the keys that count (valid_kv)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale_log2;
};

// One tile's online softmax in exp2 units. s holds this thread's 32 logits of the
// warpgroup's 64 x 64 S tile (element i: row (i >> 1) & 1 of the thread's two,
// column 8 (i >> 2) + 2 (tid % 4) + (i & 1)); columns >= n_cols are keys past M
// (kMask: the last, partial tile). c is scale log2(e): with kPos (c > 0) the row
// maximum is taken on the raw logits and c folded into one FFMA per element;
// otherwise the logits are multiplied first. On return s holds P, m_run / l_run
// are updated and alpha is what the output rows must be multiplied by.
template <bool kMask, bool kPos>
__device__ __forceinline__ void softmax_tile(float (&s)[32], int n_cols, float c, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!kPos) s[i] *= c;
    if (kMask) s[i] = (i >> 2) * 8 + qd * 2 + (i & 1) < n_cols ? s[i] : -INFINITY;
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

// softmax_tile on a tile of n_cols keys: warp-uniform branches, since only the
// last tile of a view is partial and c has one sign for the whole launch
__device__ __forceinline__ void softmax_step(float (&s)[32], int n_cols, float c, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  if (n_cols < kRows) {
    if (c > 0.f) {
      softmax_tile<true, true>(s, n_cols, c, m_run, l_run, alpha);
    } else {
      softmax_tile<true, false>(s, n_cols, c, m_run, l_run, alpha);
    }
  } else if (c > 0.f) {
    softmax_tile<false, true>(s, n_cols, c, m_run, l_run, alpha);
  } else {
    softmax_tile<false, false>(s, n_cols, c, m_run, l_run, alpha);
  }
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(FwdConfig<D>::kThreads, 1)
    batched_fwd_kernel(const FwdArgs a) {
  using L = FwdSmem<D>;
  constexpr int kWgs = L::kWgs;
  constexpr int kThreads = L::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t sb = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;  // [slot * kWgs + wg]

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_q_tiles = cdiv(a.s, kRows);
  const int n_qb = cdiv(n_q_tiles, kWgs);  // query blocks per (b, h)
  const int n_items = a.b * a.h * n_qb;
  const int n_kv_tiles = cdiv(a.m, kRows);
  const int last_cols = a.m - (n_kv_tiles - 1) * kRows;  // keys of the last tile

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&full[st], kThreads);  // one cp.async arrival per thread
      mbar_init(&empty[st], kThreads / 32);  // one release per warp
    }
    for (int i = 0; i < 2 * kWgs; ++i) mbar_init(&q_full[i], 128);  // the warpgroup's threads
    mbar_init_fence();
  }
  __syncthreads();

  // this warpgroup's rows of an item: (q, first row, rows in range)
  struct Rows {
    const T* q;
    long long b, h;
    int q0, n;
  };
  auto rows_of = [&](int item) {
    const int qb = item % n_qb;
    const int bh = item / n_qb;
    Rows r;
    r.b = bh / a.h;
    r.h = bh % a.h;
    r.q0 = (qb * kWgs + wg) * kRows;
    r.n = max(0, min(kRows, a.s - r.q0));
    r.q = static_cast<const T*>(a.q) + r.b * a.q_sb + r.h * a.q_sh +
          static_cast<long long>(r.n > 0 ? r.q0 : 0) * a.q_ss;
    return r;
  };
  // the warpgroup's Q tile of its iter-th item into slot iter & 1 (an item past the end loads nothing)
  auto load_q = [&](int iter) {
    const int item = blockIdx.x + iter * gridDim.x;
    if (item >= n_items) return;
    const Rows r = rows_of(item);
    const int slot = (iter & 1) * kWgs + wg;
    load_tile_swizzled<T, D, kRows>(sb + L::kQ + slot * L::kTile, r.q, a.q_ss, r.n, tid, 128);
    mbar_arrive_cp_async(&q_full[slot]);
  };
  load_q(0);
  load_q(1);

  // The ring: every thread issues its share of each K / V tile of the block's walk over its items,
  // L::kAhead tiles ahead of the products.
  int ld_iter = 0, ld_t = 0, ld_stage = 0, ld_phase = 0;
  auto issue_next = [&]() {
    const int item = blockIdx.x + ld_iter * gridDim.x;
    if (item >= n_items) return;
    const long long bh = item / n_qb;
    const long long b = bh / a.h, h = bh % a.h;
    const int n0 = ld_t * kRows;
    const int rows = min(kRows, a.m - n0);
    mbar_wait(&empty[ld_stage], ld_phase ^ 1);
    const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + n0 * a.k_ss;
    const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + n0 * a.v_ss;
    load_tile_swizzled<T, D, kRows>(sb + L::kK + ld_stage * L::kTile, k, a.k_ss, rows, threadIdx.x, kThreads);
    load_tile_swizzled<T, D, kRows>(sb + L::kV + ld_stage * L::kTile, v, a.v_ss, rows, threadIdx.x, kThreads);
    mbar_arrive_cp_async(&full[ld_stage]);
    next_stage<L::kStages>(ld_stage, ld_phase);
    if (++ld_t == n_kv_tiles) {
      ld_t = 0;
      ++ld_iter;
    }
  };
  for (int i = 0; i < L::kAhead; ++i) issue_next();

  int stage = 0, phase = 0;
  auto acquire = [&]() {  // the next K / V stage, landed
    issue_next();
    mbar_wait(&full[stage], phase);
    const int st = stage;
    next_stage<L::kStages>(stage, phase);
    return st;
  };

  const float scale_log2 = a.scale_log2;
  const int g = (tid & 31) >> 2;
  const int qd = tid & 3;
  const long long o_ss = static_cast<long long>(a.h) * D;
  for (int iter = 0;; ++iter) {
    const int item = blockIdx.x + iter * gridDim.x;
    if (item >= n_items) break;
    const Rows r = rows_of(item);
    const int slot = (iter & 1) * kWgs + wg;
    const uint32_t s_q = sb + L::kQ + slot * L::kTile;
    mbar_wait(&q_full[slot], (iter >> 1) & 1);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's partial sums, added over the quad at the end
    float alpha[2];
    float s[32];
    uint32_t p[4][4];

    if (r.n == 0) {  // no rows of this warpgroup in the item: pass its stages on
      for (int t = 0; t < n_kv_tiles; ++t) release(&empty[acquire()]);
    } else if (L::kOverlap) {
      // each wgmma pipeline below is straight-line code: ptxas serialises wgmma issued under a branch
      int st = acquire();
      fence_proxy_async();
      wgmma_fence();
      product_abt<T, D>(s, s_q, sb + L::kK + st * L::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_step(s, n_kv_tiles == 1 ? last_cols : kRows, scale_log2, m_run, l_run, alpha);
      to_a_operands<T>(p, s);
      for (int t = 0; t + 1 < n_kv_tiles; ++t) {
        const int st_next = acquire();
        fence_proxy_async();
        wgmma_fence();
        product_abt<T, D>(s, s_q, sb + L::kK + st_next * L::kTile);  // S of tile t + 1
        wgmma_commit();
        product_ab<T, D>(acc, p, sb + L::kV + st * L::kTile);  // O += P V of tile t
        wgmma_commit();
        wgmma_wait<1>();  // S of tile t + 1 is in; P V runs on under its exponentials
        fence_regs(s);
        softmax_step(s, t + 2 == n_kv_tiles ? last_cols : kRows, scale_log2, m_run, l_run, alpha);
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);  // P stays live until its product is done
        release(&empty[st]);
        rescale<D>(acc, alpha);
        to_a_operands<T>(p, s);  // only now: registers of an operand in flight must not be written
        st = st_next;
      }
      wgmma_fence();
      product_ab<T, D>(acc, p, sb + L::kV + st * L::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(&empty[st]);
    } else {
      for (int t = 0; t < n_kv_tiles; ++t) {
        const int st = acquire();
        fence_proxy_async();
        wgmma_fence();
        product_abt<T, D>(s, s_q, sb + L::kK + st * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax_step(s, t + 1 == n_kv_tiles ? last_cols : kRows, scale_log2, m_run, l_run, alpha);
        rescale<D>(acc, alpha);
        to_a_operands<T>(p, s);
        wgmma_fence();
        product_ab<T, D>(acc, p, sb + L::kV + st * L::kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release(&empty[st]);
      }
    }
    // the slot is free once the warpgroup's products are done: load the item after next into it
    named_barrier(1 + wg, 128);
    load_q(iter + 2);

    if (r.n > 0) {
      T* o = static_cast<T*>(a.o) + (r.b * a.s + r.q0) * o_ss + r.h * D;
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        float l = l_run[row];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key is written as 0
        const int rr = (tid >> 5) * 16 + g + row * 8;
        if (rr < r.n) {
          if (kLse && qd == 0) {
            a.lse[(r.b * a.h + r.h) * a.s + r.q0 + rr] = l > 0.f ? m_run[row] * kLn2 + logf(l) : kLseEmpty;
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
  }
  cp_async_wait_all();
}

template <typename T, int D, bool kLse>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(batched_fwd_kernel<T, D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              FwdSmem<D>::kBytes);
}

template <typename T, int D, bool kLse>
cudaError_t launch_as(const FwdArgs& a, int n_blocks, cudaStream_t stream) {
  cudaError_t err = set_smem<T, D, kLse>();
  if (err != cudaSuccess) return err;
  batched_fwd_kernel<T, D, kLse><<<n_blocks, FwdConfig<D>::kThreads, FwdSmem<D>::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool kLse>
int blocks_per_sm_as() {
  if (set_smem<T, D, kLse>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, batched_fwd_kernel<T, D, kLse>, FwdConfig<D>::kThreads,
                                                    FwdSmem<D>::kBytes) != cudaSuccess) {
    return -1;
  }
  return n;
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, int n_blocks, cudaStream_t stream) {
  return a.lse ? launch_as<T, D, true>(a, n_blocks, stream) : launch_as<T, D, false>(a, n_blocks, stream);
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a, int d, int n_blocks, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, n_blocks, stream);
    case 96: return launch<T, 96>(a, n_blocks, stream);
    case 128: return launch<T, 128>(a, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool kLse>
int blocks_per_sm(int d) {
  switch (d) {
    case 64: return blocks_per_sm_as<T, 64, kLse>();
    case 96: return blocks_per_sm_as<T, 96, kLse>();
    case 128: return blocks_per_sm_as<T, 128, kLse>();
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp16. Strides are in elements; the head dim is contiguous.
// The output is a contiguous (B, S, H, D) tensor; lse is a contiguous fp32
// (B, H, S) tensor or null. Keys >= m_valid are masked. n_blocks is the grid:
// each block walks the items (b, h, block of 64 FwdConfig<d>::kWgs query rows)
// blockIdx.x, blockIdx.x + n_blocks, ... Returns a cudaError_t.
extern "C" int g2_batched_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    int b, int s, int m_valid, int h, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream, int n_blocks) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, o, static_cast<float*>(lse), b, s, m_valid, h, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
            v_sb, v_ss, v_sh, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<__nv_bfloat16>(a, d, n_blocks, st) : dispatch<__half>(a, d, n_blocks, st);
  return static_cast<int>(err);
}

// Blocks of the kernel for (dtype, d, lse or not) that fit on one SM at once
// (-1 on an error), and the query rows of one block.
extern "C" int g2_batched_attention_blocks_per_sm(int dtype, int d, int with_lse) {
  if (dtype == 0) return with_lse ? blocks_per_sm<__nv_bfloat16, true>(d) : blocks_per_sm<__nv_bfloat16, false>(d);
  return with_lse ? blocks_per_sm<__half, true>(d) : blocks_per_sm<__half, false>(d);
}

extern "C" int g2_batched_attention_rows_per_block(int d) {
  switch (d) {
    case 64: return FwdConfig<64>::kWgs * kRows;
    case 96: return FwdConfig<96>::kWgs * kRows;
    case 128: return FwdConfig<128>::kWgs * kRows;
    default: return -1;
  }
}
