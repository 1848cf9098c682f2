// K8  g2_segment_attention_int8: segment-masked GQA attention whose QK^T is an
// int8 x int8 -> int32 tensor-core product, for Hopper (sm_90a).
//
// Replaces g2vlm_tpu/ops/flash_attention.py `_flash_kernel_int8` (launched by
// `_flash_int8`): the quantized serving mode's prefill attention. The
// quantiser is plain tensor code outside the kernel (ops/flash_attention.py
// `quantize_qk`, as the JAX package keeps it outside its kernel); the kernel
// takes q8 (Sq, H, DP) and k8 (Skv, KVH, DP) int8 with per-token fp32 scales
// qs (H, Sq), already folded with softmax scale * log2(e), and ks (KVH, Skv),
// v (Skv, KVH, D) in bf16/fp16 and the int32 (doc, fn, noise, pos) metadata
// and tile codes of K2, and writes out (Sq, H, D) in v's type. No lse, no
// gradient.
//
// Head dim padding: one s8 mma step covers k = 32 head-dim channels, so the
// quantiser writes q8/k8 with the head dim zero-padded to DP, the next
// multiple of 32 (80 -> 96 for the Qwen2-VL ViT; 64, 96, 128 unchanged). The
// zero channels add nothing to the integer product; V and the output keep
// their D columns. int8 rows of DP bytes keep cp.async's 16-byte alignment.
//
// What bounds it on the H100: tensor-core operations, as K2 (at the chat
// prefill, 48,384 rows x 12 heads of 128, ~7 TFLOP equivalents on ~0.3 GB).
// QK^T runs on the s8 path (mma.sync m16n8k32, twice the bf16 rate per
// instruction and half the shared-memory bytes per operand), P.V stays the
// bf16 m16n8k16 product of K2. The int32 accumulator fragment has the
// ownership of K2's fp32 one (thread (g, tig): rows g and g + 8, columns
// tig*2 and tig*2 + 1 of each n8 tile), so dequantisation -- one multiply by
// the row's qs, one by the column's ks, in that order as the TPU kernel --
// happens in registers right before the softmax, and the rest is K2: tile
// codes (SKIP tiles not loaded, FULL tiles unmasked), the segment rule on
// PARTIAL tiles, zero-filled ragged K/V tails masked by the key bound, rows
// that see no key written as 0. At the byte level the A and B fragments of
// the s8 m16n8k32 product are laid out as those of the bf16 m16n8k16 one
// (four consecutive int8 where that has two bf16), so `ldmatrix` loads them
// from row-major int8 tiles with the same lane addressing, one k-step being
// 32 bytes of a row.
//
// Softmax form: the TPU kernel exponentiates without a shift and clamps at
// 2^100; this kernel keeps K2's exact running maximum instead (the same
// function wherever the clamp is not hit, and finite beyond it, which the
// un-normed ViT logits need).
//
// Padded keys arrive with k8 = 0 and a tiny scale; the mask removes them, not
// the scale.

#include "attention_common.cuh"

namespace {

constexpr int kPadB = 16;  // bytes of row padding of the int8 tiles: keeps ldmatrix conflict-free

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies `rows` valid rows of DP bytes into shared memory rows of DP + kPadB
// bytes; rows past `rows` are zero-filled.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_s8(int8_t* smem, const int8_t* gmem, long long row_stride, int rows) {
  constexpr int kChunks = DP / 16;
  constexpr int kLdB = DP + kPadB;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const bool ok = r < rows;
    cp_async16(smem + r * kLdB + c, ok ? gmem + r * row_stride + c : gmem, ok);
  }
}

struct Int8Args {
  const int8_t* q8;
  const int8_t* k8;
  const void* v;
  void* o;
  const float* qs;  // (H, Sq)
  const float* ks;  // (KVH, Skv)
  const int4* q_meta;
  const int4* kv_meta;
  const int8_t* codes;  // (n_q_tiles, n_kv_tiles) or null: all partial
  int sq, skv, h, kvh;
  long long q_ss, q_sh;  // bytes == int8 elements
  long long k_ss, k_sh;
  long long v_ss, v_sh;  // elements of T
};

template <typename T, int D, int DP>
__global__ void __launch_bounds__(kThreads) int8_segment_kernel(Int8Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;        // V rows, elements of T
  constexpr int kLdB = DP + kPadB;     // q8 / k8 rows, bytes
  constexpr int kKSteps = DP / 32;     // s8 mma k-steps over the padded head dim
  constexpr int kDTiles = D / 8;       // n8 tiles of the output
  constexpr int kNTiles = kBlockN / 8; // n8 tiles of the logits
  T* s_v = reinterpret_cast<T*>(smem_raw);
  int8_t* s_q8 = reinterpret_cast<int8_t*>(s_v + kBlockN * kLd);
  int8_t* s_k8 = s_q8 + kBlockM * kLdB;
  int4* s_meta = reinterpret_cast<int4*>(s_k8 + kBlockN * kLdB);
  float* s_ks = reinterpret_cast<float*>(s_meta + kBlockN);

  const int q0 = blockIdx.x * kBlockM;
  const long long h = blockIdx.y;
  const long long kv_h = h / (a.h / a.kvh);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int n_q = min(kBlockM, a.sq - q0);
  const int n_kv = a.skv;
  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;
  const int8_t* codes = a.codes ? a.codes + static_cast<long long>(blockIdx.x) * n_tiles : nullptr;

  const int8_t* q8 = a.q8 + h * a.q_sh + q0 * a.q_ss;
  const int8_t* k8 = a.k8 + kv_h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + kv_h * a.v_sh;
  const float* ks = a.ks + kv_h * a.skv;

  int4 qm[2];
  float qs[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = q0 + warp * 16 + (lane >> 2) + row * 8;
    // rows past Sq never match anything (doc -2, as the TPU wrapper pads them)
    qm[row] = r < a.sq ? a.q_meta[r] : make_int4(-2, -1, -1, 0);
    qs[row] = r < a.sq ? a.qs[h * a.sq + r] : 0.f;
  }

  load_tile_s8<DP, kBlockM>(s_q8, q8, a.q_ss, n_q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t q_frag[kKSteps][4];
  {
    const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = (lane >> 4) * 16;  // bytes
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) ldmatrix_x4(q_frag[kk], s_q8 + r * kLdB + kk * 32 + c);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int code = codes ? codes[t] : kPartial;  // uniform across the block
    if (code == kSkip) continue;
    const int n0 = t * kBlockN;
    const int rows = min(kBlockN, n_kv - n0);
    __syncthreads();  // the previous tile's readers are done with s_k8 / s_v / s_meta / s_ks
    load_tile_s8<DP, kBlockN>(s_k8, k8 + n0 * a.k_ss, a.k_ss, rows);
    cp_async_commit();
    load_tile<T, D, kBlockN>(s_v, v + n0 * a.v_ss, a.v_ss, rows);
    cp_async_commit();
    if (threadIdx.x < kBlockN) {
      const int j = n0 + threadIdx.x;
      s_meta[threadIdx.x] = j < n_kv ? a.kv_meta[j] : make_int4(-1, -1, -1, -1);
      s_ks[threadIdx.x] = j < n_kv ? ks[j] : 0.f;
    }
    cp_async_wait<1>();  // k8 has landed; V may still be in flight
    __syncthreads();

    int s32[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) s32[j][0] = s32[j][1] = s32[j][2] = s32[j][3] = 0;
    {
      const int r = (lane & 7) + (lane >> 4) * 8;
      const int c = ((lane >> 3) & 1) * 16;  // bytes
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int nb = 0; nb < kBlockN / 16; ++nb) {
          uint32_t b[4];
          ldmatrix_x4(b, s_k8 + (nb * 16 + r) * kLdB + kk * 32 + c);
          mma_s8(s32[2 * nb], q_frag[kk], b[0], b[1]);
          mma_s8(s32[2 * nb + 1], q_frag[kk], b[2], b[3]);
        }
      }
    }

    // dequantise into log2 units (row scale, then column scale) and, on
    // partial tiles, mask; element e of tile j is row (e >> 1), column
    // j*8 + tig*2 + (e & 1)
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const float2 ksc = *reinterpret_cast<const float2*>(s_ks + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = __int2float_rn(s32[j][e]) * qs[e >> 1] * ((e & 1) ? ksc.y : ksc.x);
        if (code == kFull) {
          s[j][e] = val;
        } else {
          const int col = j * 8 + tig * 2 + (e & 1);
          const bool ok = (n0 + col < n_kv) && seg_visible(qm[e >> 1], s_meta[col]);
          s[j][e] = ok ? val : -INFINITY;
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

    // O += P V with P rounded to T: the bf16/fp16 product of K2
    {
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < kBlockN / 16; ++kb) {
        uint32_t p[4];
        p[0] = Mma<T>::pack(s[2 * kb][0], s[2 * kb][1]);
        p[1] = Mma<T>::pack(s[2 * kb][2], s[2 * kb][3]);
        p[2] = Mma<T>::pack(s[2 * kb + 1][0], s[2 * kb + 1][1]);
        p[3] = Mma<T>::pack(s[2 * kb + 1][2], s[2 * kb + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, s_v + (kb * 16 + r) * kLd + dn * 16 + c);
          Mma<T>::run(acc[2 * dn], p, b[0], b[1]);
          Mma<T>::run(acc[2 * dn + 1], p, b[2], b[3]);
        }
      }
    }
  }

  const long long o_ss = static_cast<long long>(a.h) * D;
  T* o = static_cast<T*>(a.o) + q0 * o_ss + h * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float l = l_run[row];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // empty rows are written as 0
    const int r = warp * 16 + (lane >> 2) + row * 8;
    if (r < n_q) {
      T* dst = o + r * o_ss + tig * 2;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<uint32_t*>(dst + i * 8) =
            Mma<T>::pack(acc[i][2 * row] * inv, acc[i][2 * row + 1] * inv);
      }
    }
  }
}

template <typename T, int D, int DP>
cudaError_t launch_int8(const Int8Args& a, cudaStream_t stream) {
  constexpr int smem = kBlockN * (D + kPad) * 2 + (kBlockM + kBlockN) * (DP + kPadB) + kBlockN * (16 + 4);
  cudaError_t err =
      cudaFuncSetAttribute(int8_segment_kernel<T, D, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h);
  int8_segment_kernel<T, D, DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_int8(const Int8Args& a, int d, int dp, cudaStream_t stream) {
  if (dp != (d + 31) / 32 * 32) return cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch_int8<T, 64, 64>(a, stream);
    case 80: return launch_int8<T, 80, 96>(a, stream);
    case 96: return launch_int8<T, 96, 96>(a, stream);
    case 128: return launch_int8<T, 128, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of v and the output): 0 = bf16, 1 = fp16. q8 (Sq, H, DP) and k8
// (Skv, KVH, DP) int8 with DP = d rounded up to 32 and zero channels past d;
// qs (H, Sq) and ks (KVH, Skv) contiguous fp32; v (Skv, KVH, D). Strides are
// in elements; the head dim is contiguous. The output is a contiguous
// (Sq, H, D) tensor. Returns a cudaError_t.
extern "C" int g2_segment_attention_int8(
    int dtype, const void* q8, const void* k8, const void* v, void* o,
    const void* qs, const void* ks,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d, int dp,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    void* stream) {
  Int8Args a{static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8), v, o,
             static_cast<const float*>(qs), static_cast<const float*>(ks),
             static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
             static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_int8<__nv_bfloat16>(a, d, dp, st)
                               : dispatch_int8<__half>(a, d, dp, st);
  return static_cast<int>(err);
}
