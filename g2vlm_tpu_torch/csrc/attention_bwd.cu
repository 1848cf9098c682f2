// Flash attention backward kernels for Hopper (sm_90a), bf16/fp16 in and out,
// fp32 accumulate.
//
// K5  g2_attention_bwd_dq / g2_attention_bwd_dkv with segment = 1 replace
//     g2vlm_tpu/ops/flash_attention.py `_flash_bwd_dq_kernel`,
//     `_flash_bwd_dkv_kernel` and `_recompute_p` (called through `_flash_bwd`):
//     the backward of the packed segment-masked GQA attention K2/K3.
// K7  the same two entry points with segment = 0 replace
//     `_batched_bwd_dq_kernel`, `_batched_bwd_dkv_kernel` and `_batched_p`
//     (called through `_batched_vjp_bwd`): the backward of the batched
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
// What bounds them on the H100: tensor-core FLOPs (the dq kernel does three
// S x S x D products, the dkv kernel four, on q/k/v/dO traffic that is ~1000x
// smaller at the training pack of 12,800 rows). The design keeps P and dS out
// of device memory: they are recomputed per 64 x 64 tile from the saved lse
// and live only in registers.
//
// Two kernels, one per output, so every output row has one owner and no
// atomics are needed (results are deterministic):
//   dq:  one block of 4 warps per (batch, q head, 64 query rows) walks the KV
//        tiles of its row of codes; each warp owns 16 query rows.
//   dkv: one block per (batch, KV head, 64 key rows) walks the q tiles of its
//        column of codes and, inside each, the G query heads of the group, so
//        the GQA sum happens in the accumulators; each warp owns 16 key rows
//        and computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, which
//        makes P^T and dS^T the register A operands of the dV and dK products.
// All operand tiles sit in shared memory (cp.async, one stage) and are read
// with ldmatrix per k-step, so the registers hold only accumulators: at D = 128
// a tile is walked in two passes of 32 columns to keep dK + dV + P + dS under
// the 255-register limit.
//
// Ragged tails and empty rows: out-of-range rows of any tile are zero-filled;
// out-of-range or empty (lse == kLseEmpty) query rows read lse = +inf, so
// their P is exp2(-inf) = 0 and never NaN; keys >= n_kv are masked on PARTIAL
// tiles (tail tiles are never FULL); dK/dV rows in [n_kv, n_kv_store) are
// written as 0.

#include "attention_common.cuh"

namespace {

// columns of a 64-wide tile handled per pass
template <int D>
struct BwdCols {
  static constexpr int value = D > 96 ? 32 : 64;
};

// acc[16 x NC] += A[16 x D] B[NC x D]^T. sA: the warp's first row, sB: the
// first row of the column tile; both row-major with the padded leading dim.
template <typename T, int D, int NC>
__device__ __forceinline__ void mma_abt(float (&acc)[NC / 8][4], const T* sA, const T* sB, int lane) {
  constexpr int kLd = D + kPad;
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ac = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8;
  const int bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + ar * kLd + kk * 16 + ac);
#pragma unroll
    for (int nb = 0; nb < NC / 16; ++nb) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (nb * 16 + br) * kLd + kk * 16 + bc);
      Mma<T>::run(acc[2 * nb], a, b[0], b[1]);
      Mma<T>::run(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += P[16 x NC] B[NC x D], P given as fp32 accumulator fragments
// (rounded to T here), B row-major in shared memory.
template <typename T, int D, int NC>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const float (&p)[NC / 8][4], const T* sB, int lane) {
  constexpr int kLd = D + kPad;
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = (lane >> 4) * 8;
#pragma unroll
  for (int kb = 0; kb < NC / 16; ++kb) {
    uint32_t a[4];
    a[0] = Mma<T>::pack(p[2 * kb][0], p[2 * kb][1]);
    a[1] = Mma<T>::pack(p[2 * kb][2], p[2 * kb][3]);
    a[2] = Mma<T>::pack(p[2 * kb + 1][0], p[2 * kb + 1][1]);
    a[3] = Mma<T>::pack(p[2 * kb + 1][2], p[2 * kb + 1][3]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kb * 16 + r) * kLd + dn * 16 + c);
      Mma<T>::run(acc[2 * dn], a, b[0], b[1]);
      Mma<T>::run(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// The segment rule between this thread's two rows (metadata in registers) and
// the columns of the current tile (metadata in shared memory). In the dq
// kernel rows are queries and columns keys; in the dkv kernel the reverse.
template <bool kRowsAreQ>
struct TileRule {
  int4 rm[2];
  const int4* s_meta;
  __device__ __forceinline__ bool visible(int row, int col) const {
    return kRowsAreQ ? seg_visible(rm[row], s_meta[col]) : seg_visible(s_meta[col], rm[row]);
  }
};

// One pass over NC columns of a tile for this warp's 16 rows: leaves P in `p`
// and dS in `ds`. S = R_s C_s^T and dP = R_d C_d^T (dq kernel: R = Q, dO rows
// and C = K, V columns; dkv kernel: R = K, V rows and C = Q, dO columns).
// lse (in log2 units) and delta belong to the query side: per row from
// registers when kRowsAreQ, per column from shared memory otherwise.
template <typename T, int D, int NC, bool kSeg, bool kRowsAreQ>
__device__ __forceinline__ void p_and_ds(
    float (&p)[NC / 8][4], float (&ds)[NC / 8][4],
    const T* sR_s, const T* sC_s, const T* sR_d, const T* sC_d,
    const float (&row_lse2)[2], const float (&row_delta)[2],
    const float* s_lse2, const float* s_delta,
    const TileRule<kRowsAreQ>& rule, int col0, bool masked, int kv_first, int n_kv,
    float scale_log2, int lane) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
  }
  mma_abt<T, D, NC>(p, sR_s, sC_s, lane);
  mma_abt<T, D, NC>(ds, sR_d, sC_d, lane);
  const int tig = lane & 3;
  const int grp = lane >> 2;
  // element e of n8 tile j is row grp + (e >> 1) * 8, column j*8 + tig*2 + (e & 1)
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = e >> 1;
      const int col = j * 8 + tig * 2 + (e & 1);
      const float l2 = kRowsAreQ ? row_lse2[rl] : s_lse2[col0 + col];
      const float dl = kRowsAreQ ? row_delta[rl] : s_delta[col0 + col];
      bool ok = true;
      if (masked) {
        const int kv_idx = kRowsAreQ ? kv_first + col : kv_first + grp + rl * 8;
        ok = kv_idx < n_kv;
        if (kSeg) ok = ok && rule.visible(rl, col0 + col);
      }
      const float pv = ok ? exp2f(p[j][e] * scale_log2 - l2) : 0.f;
      p[j][e] = pv;
      ds[j][e] = pv * (ds[j][e] - dl);
    }
  }
}

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
  const int4* q_meta;   // segment only
  const int4* kv_meta;
  const int8_t* codes;  // (ceil(n_q/64), ceil(n_kv/64))
  int n_q, n_kv, n_kv_store, h, kvh;
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

template <typename T, int D>
__device__ __forceinline__ void store_rows(
    const float (&acc)[D / 8][4], float mult, T* dst_row0, long long row_stride, int rows, int warp, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = warp * 16 + (lane >> 2) + row * 8;
    if (r < rows) {
      T* dst = dst_row0 + r * row_stride + tig * 2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dst + i * 8) =
            Mma<T>::pack(acc[i][2 * row] * mult, acc[i][2 * row + 1] * mult);
      }
    }
  }
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  constexpr int NC = BwdCols<D>::value;
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_do = s_q + kBlockM * kLd;
  T* s_k = s_do + kBlockM * kLd;
  T* s_v = s_k + kBlockN * kLd;
  int4* s_meta = reinterpret_cast<int4*>(s_v + kBlockN * kLd);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kBlockM;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long kv_h = h / (a.h / a.kvh);
  const int n_q = min(kBlockM, a.n_q - q0);
  const long long o_ss = static_cast<long long>(a.h) * D;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss;
  const T* dout = static_cast<const T*>(a.dout) + (b * a.n_q + q0) * o_ss + h * D;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kv_h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kv_h * a.v_sh;

  load_tile<T, D, kBlockM>(s_q, q, a.q_ss, n_q);
  load_tile<T, D, kBlockM>(s_do, dout, o_ss, n_q);
  cp_async_commit();

  const long long stat = (b * a.h + h) * a.n_q + q0;
  float row_lse2[2], row_delta[2];
  TileRule<true> rule;
  rule.s_meta = s_meta;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = warp * 16 + (lane >> 2) + row * 8;
    const bool in = r < n_q;
    row_lse2[row] = lse_log2(in, in ? a.lse[stat + r] : 0.f);
    row_delta[row] = in ? a.delta[stat + r] : 0.f;
    if (kSeg) rule.rm[row] = in ? a.q_meta[q0 + r] : make_int4(-2, -1, -1, 0);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = (a.n_kv + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    const int code = kSeg ? a.codes[static_cast<long long>(blockIdx.x) * n_tiles + t]
                          : (n0 + kBlockN <= a.n_kv ? kFull : kPartial);
    if (code == kSkip) continue;
    const int rows = min(kBlockN, a.n_kv - n0);
    __syncthreads();  // the previous tile's readers are done with s_k / s_v / s_meta
    load_tile<T, D, kBlockN>(s_k, k + n0 * a.k_ss, a.k_ss, rows);
    load_tile<T, D, kBlockN>(s_v, v + n0 * a.v_ss, a.v_ss, rows);
    cp_async_commit();
    if (kSeg && threadIdx.x < kBlockN) {
      const int j = n0 + threadIdx.x;
      s_meta[threadIdx.x] = j < a.n_kv ? a.kv_meta[j] : make_int4(-1, -1, -1, -1);
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < kBlockN; c0 += NC) {
      float p[NC / 8][4], ds[NC / 8][4];
      p_and_ds<T, D, NC, kSeg, true>(
          p, ds, s_q + warp * 16 * kLd, s_k + c0 * kLd, s_do + warp * 16 * kLd, s_v + c0 * kLd,
          row_lse2, row_delta, nullptr, nullptr, rule, c0, code != kFull, n0 + c0, a.n_kv,
          a.scale_log2, lane);
      mma_ab<T, D, NC>(acc, ds, s_k + c0 * kLd, lane);
    }
  }
  cp_async_wait<0>();  // a row of SKIP tiles never waited for its Q / dO loads

  T* dq = static_cast<T*>(a.dq) + (b * a.n_q + q0) * o_ss + h * D;
  store_rows<T, D>(acc, a.scale, dq, o_ss, n_q, warp, lane);
}

template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  constexpr int NC = BwdCols<D>::value;
  T* s_k = reinterpret_cast<T*>(smem_raw);
  T* s_v = s_k + kBlockN * kLd;
  T* s_q = s_v + kBlockN * kLd;
  T* s_do = s_q + kBlockM * kLd;
  float* s_lse2 = reinterpret_cast<float*>(s_do + kBlockM * kLd);
  float* s_delta = s_lse2 + kBlockM;
  int4* s_meta = reinterpret_cast<int4*>(s_delta + kBlockM);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv0 = blockIdx.x * kBlockN;
  const long long kv_h = blockIdx.y;
  const long long b = blockIdx.z;
  const int group = a.h / a.kvh;
  const int rows_valid = max(0, min(kBlockN, a.n_kv - kv0));
  const long long o_ss = static_cast<long long>(a.h) * D;

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc_dk[i][0] = acc_dk[i][1] = acc_dk[i][2] = acc_dk[i][3] = 0.f;
    acc_dv[i][0] = acc_dv[i][1] = acc_dv[i][2] = acc_dv[i][3] = 0.f;
  }

  if (rows_valid > 0) {  // uniform across the block
    const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kv_h * a.k_sh + kv0 * a.k_ss;
    const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kv_h * a.v_sh + kv0 * a.v_ss;
    load_tile<T, D, kBlockN>(s_k, k, a.k_ss, rows_valid);
    load_tile<T, D, kBlockN>(s_v, v, a.v_ss, rows_valid);
    cp_async_commit();

    TileRule<false> rule;
    rule.s_meta = s_meta;
    if (kSeg) {
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int r = kv0 + warp * 16 + (lane >> 2) + row * 8;
        rule.rm[row] = r < a.n_kv ? a.kv_meta[r] : make_int4(-1, -1, -1, -1);
      }
    }
    const float unused[2] = {0.f, 0.f};

    const int n_q_tiles = (a.n_q + kBlockM - 1) / kBlockM;
    const int n_kv_tiles = (a.n_kv + kBlockN - 1) / kBlockN;
    for (int qt = 0; qt < n_q_tiles; ++qt) {
      const int code = kSeg ? a.codes[static_cast<long long>(qt) * n_kv_tiles + blockIdx.x]
                            : (kv0 + kBlockN <= a.n_kv ? kFull : kPartial);
      if (code == kSkip) continue;
      const int q0 = qt * kBlockM;
      const int n_q = min(kBlockM, a.n_q - q0);
      for (int g = 0; g < group; ++g) {
        const long long h = kv_h * group + g;
        const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + q0 * a.q_ss;
        const T* dout = static_cast<const T*>(a.dout) + (b * a.n_q + q0) * o_ss + h * D;
        __syncthreads();  // the previous pass's readers are done with s_q / s_do / stats
        load_tile<T, D, kBlockM>(s_q, q, a.q_ss, n_q);
        load_tile<T, D, kBlockM>(s_do, dout, o_ss, n_q);
        cp_async_commit();
        if (threadIdx.x < kBlockM) {
          const int r = threadIdx.x;
          const bool in = r < n_q;
          const long long stat = (b * a.h + h) * a.n_q + q0 + r;
          s_lse2[r] = lse_log2(in, in ? a.lse[stat] : 0.f);
          s_delta[r] = in ? a.delta[stat] : 0.f;
          if (kSeg) s_meta[r] = in ? a.q_meta[q0 + r] : make_int4(-2, -1, -1, 0);
        }
        cp_async_wait<0>();
        __syncthreads();

#pragma unroll
        for (int c0 = 0; c0 < kBlockM; c0 += NC) {
          float p[NC / 8][4], ds[NC / 8][4];
          p_and_ds<T, D, NC, kSeg, false>(
              p, ds, s_k + warp * 16 * kLd, s_q + c0 * kLd, s_v + warp * 16 * kLd, s_do + c0 * kLd,
              unused, unused, s_lse2, s_delta, rule, c0, code != kFull, kv0 + warp * 16, a.n_kv,
              a.scale_log2, lane);
          mma_ab<T, D, NC>(acc_dv, p, s_do + c0 * kLd, lane);
          mma_ab<T, D, NC>(acc_dk, ds, s_q + c0 * kLd, lane);
        }
      }
    }
    cp_async_wait<0>();  // a column of SKIP tiles never waited for its K / V loads
  }

  const int rows_store = max(0, min(kBlockN, a.n_kv_store - kv0));
  const long long kv_ss = static_cast<long long>(a.kvh) * D;
  T* dk = static_cast<T*>(a.dk) + (b * a.n_kv_store + kv0) * kv_ss + kv_h * D;
  T* dv = static_cast<T*>(a.dv) + (b * a.n_kv_store + kv0) * kv_ss + kv_h * D;
  store_rows<T, D>(acc_dk, a.scale, dk, kv_ss, rows_store, warp, lane);
  store_rows<T, D>(acc_dv, 1.f, dv, kv_ss, rows_store, warp, lane);
}

template <int D>
constexpr int bwd_smem_bytes() {
  // four operand tiles, the per-column lse and delta of the dkv kernel, one tile of metadata
  return 4 * kBlockM * (D + kPad) * 2 + 2 * kBlockM * 4 + kBlockM * 16;
}

template <typename T, int D, bool kSeg>
cudaError_t launch_bwd(const BwdArgs& a, int b, bool dkv, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D>();
  if (dkv) {
    cudaError_t err =
        cudaFuncSetAttribute(bwd_dkv_kernel<T, D, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.n_kv_store + kBlockN - 1) / kBlockN, a.kvh, b);
    bwd_dkv_kernel<T, D, kSeg><<<grid, kThreads, smem, stream>>>(a);
  } else {
    cudaError_t err =
        cudaFuncSetAttribute(bwd_dq_kernel<T, D, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.n_q + kBlockM - 1) / kBlockM, a.h, b);
    bwd_dq_kernel<T, D, kSeg><<<grid, kThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, bool kSeg>
cudaError_t dispatch_bwd(const BwdArgs& a, int b, int d, bool dkv, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_bwd<T, 64, kSeg>(a, b, dkv, stream);
    case 96: return launch_bwd<T, 96, kSeg>(a, b, dkv, stream);
    case 128: return launch_bwd<T, 128, kSeg>(a, b, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run_bwd(
    bool dkv, int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int n_kv_store, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk, dv,
            static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
            static_cast<const int8_t*>(codes), n_q, n_kv, n_kv_store, h, kvh,
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
// Keys >= n_kv are masked and their dk / dv rows written as 0. Returns a
// cudaError_t.
extern "C" int g2_attention_bwd_dq(
    int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dq, const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  return run_bwd(false, dtype, segment, q, k, v, dout, lse, delta, dq, nullptr, nullptr, q_meta, kv_meta, codes,
                 b, n_q, n_kv, n_kv, h, kvh, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, stream);
}

extern "C" int g2_attention_bwd_dkv(
    int dtype, int segment,
    const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, const void* q_meta, const void* kv_meta, const void* codes,
    int b, int n_q, int n_kv, int n_kv_store, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  return run_bwd(true, dtype, segment, q, k, v, dout, lse, delta, nullptr, dk, dv, q_meta, kv_meta, codes,
                 b, n_q, n_kv, n_kv_store, h, kvh, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                 stream);
}
