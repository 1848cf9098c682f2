// The segment attention forward kernels for Hopper (sm_90a), bf16/fp16 in, fp32
// accumulate. (The batched forward K1 / K6 is in attention_batched.cu, the
// backward kernels in attention_bwd.cu.)
//
// K2  g2_segment_attention  replaces g2vlm_tpu/ops/flash_attention.py
//     `_flash_kernel` (via `_fwd_pallas` / `flash_segment_attention`): packed
//     GQA attention, q (Sq,H,D) against k,v (Skv,KVH,D), masked per token pair
//     by int32 (doc, fn, noise, pos) metadata with the rule of
//     g2vlm_tpu/ops/masks.py `make_segment_mask`.
// K3  the same entry point with a non-null `lse` pointer replaces
//     `_flash_kernel_lse`: the same forward plus one fp32 store per row of
//     lse = m + ln(l) in natural units (the kernel works in exp2 units and
//     converts once), kLseEmpty for a row that sees no key. The training
//     forward saves it for the backward. A template flag keeps the store out
//     of the no-grad instantiations.
//
// What bounds it on the H100: at the main-path shapes it is tensor-core
// bound. K2 at the 32-view prefill (25,088 tokens, 12 heads, D=128) is
// 4*S^2*D*H = 3.9 TFLOP per layer against ~0.2 GB of q/k/v/o traffic, far
// right of the ~295 FLOP/byte ridge. The design keeps the S x S logits out of
// device memory entirely (an fp32 online softmax in registers), feeds the
// tensor cores with bf16 mma.sync m16n8k16 from ldmatrix'd shared-memory
// tiles, and folds the softmax scale and log2(e) into one multiply before
// exp2.
//
// Tiling: one block of 4 warps per (head, 64 query rows); each warp
// owns 16 query rows, holds its Q fragments in registers, and streams 64-row
// K/V tiles through shared memory with cp.async (K and V in separate groups so
// that QK^T starts while V lands). It reads a per-(q tile, kv tile) code:
// SKIP tiles are not loaded, FULL tiles skip the per-element mask rule (at the
// recon prefill nearly every tile is FULL). The ragged tails of q and kv (a
// pack of 333 rows) are masked in the kernel: out-of-range K/V rows are zero-filled
// and their logits set to -inf, out-of-range q rows are never stored. A row
// that sees no key (padding, doc < 0) keeps l == 0 and is written as 0.
// Offsets are 64-bit throughout.

#include "attention_common.cuh"

namespace {

// K2 mask: the segment rule of ops/masks.py on (doc, fn, noise, pos).
struct SegmentRule {
  int4 qm[2];           // metadata of this thread's two query rows
  const int4* kv_meta;  // (Skv,) packed kv metadata in device memory
  int4* s_meta;         // (kBlockN,) shared-memory copy of the current kv tile
  int n_kv;
  const int8_t* codes;  // (n_q_tiles, n_kv_tiles) tile codes, or null: all partial
  int n_kv_tiles;
  int q_tile;

  __device__ __forceinline__ int tile_code(int t, int /*n0*/) const {
    return codes ? codes[static_cast<long long>(q_tile) * n_kv_tiles + t] : kPartial;
  }

  __device__ __forceinline__ void load_kv_meta(int n0) {
    if (threadIdx.x < kBlockN) {
      const int j = n0 + threadIdx.x;
      s_meta[threadIdx.x] = j < n_kv ? kv_meta[j] : make_int4(-1, -1, -1, -1);
    }
  }
  __device__ __forceinline__ bool visible(int row, int col_local) const {
    return seg_visible(qm[row], s_meta[col_local]);
  }
};

// One block computes 64 query rows of one (batch, head) against all keys.
// With kLse it also stores the rows' log-sum-exp at lse[0 .. n_q).
template <typename T, int D, bool kLse, typename Mask>
__device__ __forceinline__ void flash_block(
    const T* __restrict__ q, long long q_rs, int n_q,
    const T* __restrict__ k, long long k_rs,
    const T* __restrict__ v, long long v_rs, int n_kv,
    T* __restrict__ o, long long o_rs, float* __restrict__ lse, float scale_log2, Mask& mask, T* smem) {
  constexpr int kLd = D + kPad;
  constexpr int kKSteps = D / 16;       // mma k-steps over the head dim
  constexpr int kDTiles = D / 8;        // n8 tiles of the output
  constexpr int kNTiles = kBlockN / 8;  // n8 tiles of the logits
  T* s_q = smem;
  T* s_k = s_q + kBlockM * kLd;
  T* s_v = s_k + kBlockN * kLd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;

  load_tile<T, D, kBlockM>(s_q, q, q_rs, n_q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t q_frag[kKSteps][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(q_frag[kk], s_q + r * kLd + kk * 16 + c);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end

  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    const int code = mask.tile_code(t, n0);  // uniform across the block
    if (code == kSkip) continue;
    const int rows = min(kBlockN, n_kv - n0);
    __syncthreads();  // the previous tile's readers are done with s_k / s_v
    load_tile<T, D, kBlockN>(s_k, k + n0 * k_rs, k_rs, rows);
    cp_async_commit();
    load_tile<T, D, kBlockN>(s_v, v + n0 * v_rs, v_rs, rows);
    cp_async_commit();
    mask.load_kv_meta(n0);
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const int r = (lane & 7) + (lane >> 4) * 8;
      const int c = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int nb = 0; nb < kBlockN / 16; ++nb) {
          uint32_t b[4];
          ldmatrix_x4(b, s_k + (nb * 16 + r) * kLd + kk * 16 + c);
          Mma<T>::run(s[2 * nb], q_frag[kk], b[0], b[1]);
          Mma<T>::run(s[2 * nb + 1], q_frag[kk], b[2], b[3]);
        }
      }
    }

    // scale into log2 units and, on partial tiles, mask; element e of tile j
    // is row (e >> 1), column j*8 + tig*2 + (e & 1)
    if (code == kFull) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + tig * 2 + (e & 1);
          const bool ok = (n0 + col < n_kv) && mask.visible(e >> 1, col);
          s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        }
      }
    }

#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * row], s[j][2 * row + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[row], mx);
      // a row with nothing visible yet shifts by 0, so exp2(-inf) stays 0, never NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[row] - m_use);
      m_run[row] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const float p0 = exp2f(s[j][2 * row] - m_use);
        const float p1 = exp2f(s[j][2 * row + 1] - m_use);
        s[j][2 * row] = p0;
        s[j][2 * row + 1] = p1;
        sum += p0 + p1;
      }
      l_run[row] = l_run[row] * alpha + sum;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        acc[i][2 * row] *= alpha;
        acc[i][2 * row + 1] *= alpha;
      }
    }

    cp_async_wait<0>();
    __syncthreads();

    // O += P V: the logits' accumulator fragments are the A operand directly
    {
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < kBlockN / 16; ++kb) {
        uint32_t a[4];
        a[0] = Mma<T>::pack(s[2 * kb][0], s[2 * kb][1]);
        a[1] = Mma<T>::pack(s[2 * kb][2], s[2 * kb][3]);
        a[2] = Mma<T>::pack(s[2 * kb + 1][0], s[2 * kb + 1][1]);
        a[3] = Mma<T>::pack(s[2 * kb + 1][2], s[2 * kb + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, s_v + (kb * 16 + r) * kLd + dn * 16 + c);
          Mma<T>::run(acc[2 * dn], a, b[0], b[1]);
          Mma<T>::run(acc[2 * dn + 1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float l = l_run[row];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // empty rows are written as 0
    const int r = warp * 16 + (lane >> 2) + row * 8;
    if (r < n_q) {
      if (kLse && tig == 0) lse[r] = l > 0.f ? m_run[row] * kLn2 + logf(l) : kLseEmpty;
      T* dst = o + r * o_rs + tig * 2;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<uint32_t*>(dst + i * 8) =
            Mma<T>::pack(acc[i][2 * row] * inv, acc[i][2 * row + 1] * inv);
      }
    }
  }
}

struct SegmentArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int4* q_meta;
  const int4* kv_meta;
  const int8_t* codes;
  int sq, skv, h, kvh;
  long long q_ss, q_sh;
  long long k_ss, k_sh;
  long long v_ss, v_sh;
  float scale_log2;
  float* lse;  // (H, Sq) or null; last, so that the other fields keep their offsets
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads) segment_kernel(SegmentArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  const int q0 = blockIdx.x * kBlockM;
  const long long h = blockIdx.y;
  const long long kv_h = h / (a.h / a.kvh);  // GQA: q head h reads KV head h // G
  T* smem = reinterpret_cast<T*>(smem_raw);

  SegmentRule mask;
  mask.kv_meta = a.kv_meta;
  mask.n_kv = a.skv;
  mask.codes = a.codes;
  mask.n_kv_tiles = (a.skv + kBlockN - 1) / kBlockN;
  mask.q_tile = blockIdx.x;
  mask.s_meta = reinterpret_cast<int4*>(smem + (kBlockM + 2 * kBlockN) * kLd);
  const int lane = threadIdx.x & 31;
  for (int row = 0; row < 2; ++row) {
    const int r = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + row * 8;
    // rows past Sq never match anything (doc -2, as the TPU wrapper pads them)
    mask.qm[row] = r < a.sq ? a.q_meta[r] : make_int4(-2, -1, -1, 0);
  }

  const T* q = static_cast<const T*>(a.q) + h * a.q_sh + q0 * a.q_ss;
  const T* k = static_cast<const T*>(a.k) + kv_h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + kv_h * a.v_sh;
  const long long o_ss = static_cast<long long>(a.h) * D;
  T* o = static_cast<T*>(a.o) + q0 * o_ss + h * D;
  float* lse = kLse ? a.lse + h * a.sq + q0 : nullptr;
  flash_block<T, D, kLse>(q, a.q_ss, min(kBlockM, a.sq - q0), k, a.k_ss, v, a.v_ss, a.skv, o, o_ss,
                          lse, a.scale_log2, mask, smem);
}

template <int D>
constexpr int smem_bytes(bool with_meta) {
  return (kBlockM + 2 * kBlockN) * (D + kPad) * 2 + (with_meta ? kBlockN * 16 : 0);
}

template <typename T, int D, bool kLse>
cudaError_t launch_segment_as(const SegmentArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>(true);
  cudaError_t err =
      cudaFuncSetAttribute(segment_kernel<T, D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h);
  segment_kernel<T, D, kLse><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_segment(const SegmentArgs& a, cudaStream_t stream) {
  return a.lse ? launch_segment_as<T, D, true>(a, stream) : launch_segment_as<T, D, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_segment(const SegmentArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_segment<T, 64>(a, stream);
    // the Qwen2-VL ViT's head dim: 5 k-steps of 16, 10 n-tiles of 8, rows of 160 bytes. Forward
    // only: the lse forward at this width comes with the ViT's training branch
    case 80: return a.lse ? cudaErrorInvalidValue : launch_segment_as<T, 80, false>(a, stream);
    case 96: return launch_segment<T, 96>(a, stream);
    case 128: return launch_segment<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (Sq, H, D), k/v (Skv, KVH, D); q_meta (Sq, 4) and kv_meta (Skv, 4) int32
// (doc, fn, noise, pos); codes (ceil(Sq/64), ceil(Skv/64)) int8 tile codes or
// null. The output is a contiguous (Sq, H, D) tensor; lse is a contiguous
// fp32 (H, Sq) tensor or null.
extern "C" int g2_segment_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    float scale, void* stream) {
  SegmentArgs a{q, k, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
                static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale * kLog2e,
                static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_segment<__nv_bfloat16>(a, d, st)
                               : dispatch_segment<__half>(a, d, st);
  return static_cast<int>(err);
}
