// K4  g2_segment_attention_pipe: the two-stage software-pipelined forward of
// the segment-masked GQA attention, for Hopper (sm_90a), bf16/fp16 in, fp32
// accumulate.
//
// Replaces g2vlm_tpu/ops/flash_attention.py `_flash_kernel_pipe` (launched by
// the pipe branch of `_fwd_pallas`): the same function as K2 (`_flash_kernel`)
// and, with a non-null `lse`, as K3 (`_flash_kernel_lse`), scheduled in two
// stages. The TPU kernel runs n_kv + 1 grid steps; step j stages tile j's
// masked scores and V in a ping-pong scratch and flushes tile j-1's exp2 /
// row-sum / P.V from the other slot, so that the matrix unit works on tile j
// while the vector unit works on tile j-1.
//
// The schedule on this card, per block of 4 warps and 64 query rows of one
// head: a loop of (live tiles + 1) iterations. Iteration i
//   1. waits for the copies issued in iteration i-1 and synchronises once;
//   2. issues cp.async copies of V of tile i into V stage i%2 and of K (and
//      the kv metadata) of tile i+1 into K stage (i+1)%2: K is consumed one
//      iteration before V of the same tile, so two stages of each suffice and
//      the copies are in flight during all of the iteration's arithmetic;
//   3. FILL: the QK^T mma.sync products of tile i into a fresh score fragment,
//      scaled into log2 units and, on PARTIAL tiles, masked right away (masked
//      scores become -inf, so the flush does no mask work);
//   4. FLUSH: running max, exp2, row sum, rescale and the P.V products of tile
//      i-1, whose scores waited in a second register fragment. The mma.sync
//      of step 3 do not depend on step 4, so the tensor pipe and the exp2
//      unit overlap within a warp as well as across warps.
// SKIP tiles are dead: they are stepped over when the next live tile is
// looked up, cost no copy and no iteration. The first flush and the last
// fill are empty. K2 pays three block synchronisations per tile and starts
// each tile's copies only after the previous tile's arithmetic; here it is
// one synchronisation, and the copies overlap the arithmetic.
//
// Registers are the scarce resource: two live score fragments (2 x 32
// floats) beside the output accumulator (64 floats at D = 128). The Q
// fragments are therefore not held in registers as in K2 but re-read from
// shared memory with ldmatrix at every k-step (one extra ldmatrix per four
// of K's).
//
// Softmax form: the TPU kernel is shiftless because its running max would
// make flushes order-dependent. Here the flushes run in tile order inside one
// thread's loop, so the exact running max of K2 is kept and every flush does
// K2's arithmetic on K2's values: the result equals K2's to rounding (the
// compiler may contract a multiply and a subtract differently in the two
// kernels), and stays finite on logits of any size.
//
// What bounds it on the H100: tensor-core operations, as K2.

#include "attention_common.cuh"

namespace {

struct PipeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int4* q_meta;
  const int4* kv_meta;
  const int8_t* codes;  // (n_q_tiles, n_kv_tiles) tile codes, or null: all partial
  int sq, skv, h, kvh;
  long long q_ss, q_sh;
  long long k_ss, k_sh;
  long long v_ss, v_sh;
  float scale_log2;
  float* lse;  // (H, Sq) or null
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads) pipe_kernel(PipeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kBlockN / 8;
  constexpr int kStage = kBlockN * kLd;  // elements of one K or V stage
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_k = s_q + kBlockM * kLd;  // two stages
  T* s_v = s_k + 2 * kStage;     // two stages
  int4* s_meta = reinterpret_cast<int4*>(s_v + 2 * kStage);  // two stages of kBlockN

  const int q0 = blockIdx.x * kBlockM;
  const long long h = blockIdx.y;
  const long long kv_h = h / (a.h / a.kvh);  // GQA: q head h reads KV head h // G
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int n_q = min(kBlockM, a.sq - q0);
  const int n_kv = a.skv;
  const int n_tiles = (n_kv + kBlockN - 1) / kBlockN;
  const int8_t* codes = a.codes ? a.codes + static_cast<long long>(blockIdx.x) * n_tiles : nullptr;

  const T* q = static_cast<const T*>(a.q) + h * a.q_sh + q0 * a.q_ss;
  const T* k = static_cast<const T*>(a.k) + kv_h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + kv_h * a.v_sh;

  int4 qm[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = q0 + warp * 16 + (lane >> 2) + row * 8;
    // rows past Sq never match anything (doc -2, as the TPU wrapper pads them)
    qm[row] = r < a.sq ? a.q_meta[r] : make_int4(-2, -1, -1, 0);
  }

  // the next tile at or after t that is not SKIP (uniform across the block)
  auto next_live = [&](int t) {
    while (t < n_tiles && codes && codes[t] == kSkip) ++t;
    return t;
  };
  auto load_k = [&](int t, int stage) {
    const int n0 = t * kBlockN;
    load_tile<T, D, kBlockN>(s_k + stage * kStage, k + n0 * a.k_ss, a.k_ss, min(kBlockN, n_kv - n0));
    if (threadIdx.x < kBlockN) {
      const int j = n0 + threadIdx.x;
      s_meta[stage * kBlockN + threadIdx.x] = j < n_kv ? a.kv_meta[j] : make_int4(-1, -1, -1, -1);
    }
  };
  auto load_v = [&](int t, int stage) {
    const int n0 = t * kBlockN;
    load_tile<T, D, kBlockN>(s_v + stage * kStage, v + n0 * a.v_ss, a.v_ss, min(kBlockN, n_kv - n0));
  };

  int t_cur = next_live(0);
  load_tile<T, D, kBlockM>(s_q, q, a.q_ss, n_q);
  if (t_cur < n_tiles) load_k(t_cur, 0);
  cp_async_commit();

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end
  float s_pend[kNTiles][4];     // the staged scores of the previous live tile
  bool pending = false;

  for (int it = 0;; ++it) {
    const int st = it & 1;
    const bool live = t_cur < n_tiles;
    cp_async_wait<0>();
    __syncthreads();  // this iteration's K and the pending tile's V have landed; last iteration's readers are done
    int t_next = n_tiles;
    if (live) {
      t_next = next_live(t_cur + 1);
      load_v(t_cur, st);
      if (t_next < n_tiles) load_k(t_next, st ^ 1);
    }
    cp_async_commit();

    // ---- fill: scores of tile t_cur, scaled and masked at stage time ----
    float s_new[kNTiles][4];
    if (live) {
      const int n0 = t_cur * kBlockN;
      const int code = codes ? codes[t_cur] : kPartial;
      const T* sk = s_k + st * kStage;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) s_new[j][0] = s_new[j][1] = s_new[j][2] = s_new[j][3] = 0.f;
      {
        const int qr = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int qc = (lane >> 4) * 8;
        const int r = (lane & 7) + (lane >> 4) * 8;
        const int c = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t qf[4];
          ldmatrix_x4(qf, s_q + qr * kLd + kk * 16 + qc);
#pragma unroll
          for (int nb = 0; nb < kBlockN / 16; ++nb) {
            uint32_t b[4];
            ldmatrix_x4(b, sk + (nb * 16 + r) * kLd + kk * 16 + c);
            Mma<T>::run(s_new[2 * nb], qf, b[0], b[1]);
            Mma<T>::run(s_new[2 * nb + 1], qf, b[2], b[3]);
          }
        }
      }
      if (code == kFull) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s_new[j][e] *= a.scale_log2;
        }
      } else {
        const int4* sm = s_meta + st * kBlockN;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + tig * 2 + (e & 1);
            const bool ok = (n0 + col < n_kv) && seg_visible(qm[e >> 1], sm[col]);
            s_new[j][e] = ok ? s_new[j][e] * a.scale_log2 : -INFINITY;
          }
        }
      }
    }

    // ---- flush: softmax update and P.V of the pending tile, in tile order ----
    if (pending) {
      const T* sv = s_v + (st ^ 1) * kStage;
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) mx = fmaxf(mx, fmaxf(s_pend[j][2 * row], s_pend[j][2 * row + 1]));
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
          const float p0 = exp2f(s_pend[j][2 * row] - m_use);
          const float p1 = exp2f(s_pend[j][2 * row + 1] - m_use);
          s_pend[j][2 * row] = p0;
          s_pend[j][2 * row + 1] = p1;
          sum += p0 + p1;
        }
        l_run[row] = l_run[row] * alpha + sum;
#pragma unroll
        for (int i = 0; i < kDTiles; ++i) {
          acc[i][2 * row] *= alpha;
          acc[i][2 * row + 1] *= alpha;
        }
      }
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < kBlockN / 16; ++kb) {
        uint32_t p[4];
        p[0] = Mma<T>::pack(s_pend[2 * kb][0], s_pend[2 * kb][1]);
        p[1] = Mma<T>::pack(s_pend[2 * kb][2], s_pend[2 * kb][3]);
        p[2] = Mma<T>::pack(s_pend[2 * kb + 1][0], s_pend[2 * kb + 1][1]);
        p[3] = Mma<T>::pack(s_pend[2 * kb + 1][2], s_pend[2 * kb + 1][3]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sv + (kb * 16 + r) * kLd + dn * 16 + c);
          Mma<T>::run(acc[2 * dn], p, b[0], b[1]);
          Mma<T>::run(acc[2 * dn + 1], p, b[2], b[3]);
        }
      }
    }

    if (!live) break;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_pend[j][e] = s_new[j][e];
    }
    pending = true;
    t_cur = t_next;
  }

  const long long o_ss = static_cast<long long>(a.h) * D;
  T* o = static_cast<T*>(a.o) + q0 * o_ss + h * D;
  float* lse = kLse ? a.lse + h * a.sq + q0 : nullptr;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    float l = l_run[row];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // empty rows are written as 0
    const int r = warp * 16 + (lane >> 2) + row * 8;
    if (r < n_q) {
      if (kLse && tig == 0) lse[r] = l > 0.f ? m_run[row] * kLn2 + logf(l) : kLseEmpty;
      T* dst = o + r * o_ss + tig * 2;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<uint32_t*>(dst + i * 8) =
            Mma<T>::pack(acc[i][2 * row] * inv, acc[i][2 * row + 1] * inv);
      }
    }
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch_pipe_as(const PipeArgs& a, cudaStream_t stream) {
  constexpr int smem = (kBlockM + 4 * kBlockN) * (D + kPad) * 2 + 2 * kBlockN * 16;
  cudaError_t err =
      cudaFuncSetAttribute(pipe_kernel<T, D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h);
  pipe_kernel<T, D, kLse><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_pipe(const PipeArgs& a, cudaStream_t stream) {
  return a.lse ? launch_pipe_as<T, D, true>(a, stream) : launch_pipe_as<T, D, false>(a, stream);
}

template <typename T>
cudaError_t dispatch_pipe(const PipeArgs& a, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_pipe<T, 64>(a, stream);
    // the Qwen2-VL ViT's head dim, forward only (no lse), as K2's
    case 80: return a.lse ? cudaErrorInvalidValue : launch_pipe_as<T, 80, false>(a, stream);
    case 96: return launch_pipe<T, 96>(a, stream);
    case 128: return launch_pipe<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of g2_segment_attention (attention.cu): q (Sq, H, D), k/v
// (Skv, KVH, D); q_meta (Sq, 4) and kv_meta (Skv, 4) int32 (doc, fn, noise,
// pos); codes (ceil(Sq/64), ceil(Skv/64)) int8 tile codes or null. The output
// is a contiguous (Sq, H, D) tensor; lse is a contiguous fp32 (H, Sq) tensor
// or null. dtype: 0 = bf16, 1 = fp16. Returns a cudaError_t.
extern "C" int g2_segment_attention_pipe(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_meta, const void* kv_meta, const void* codes,
    int sq, int skv, int h, int kvh, int d,
    long long q_ss, long long q_sh,
    long long k_ss, long long k_sh,
    long long v_ss, long long v_sh,
    float scale, void* stream) {
  PipeArgs a{q, k, v, o, static_cast<const int4*>(q_meta), static_cast<const int4*>(kv_meta),
             static_cast<const int8_t*>(codes), sq, skv, h, kvh, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale * kLog2e,
             static_cast<float*>(lse)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_pipe<__nv_bfloat16>(a, d, st)
                               : dispatch_pipe<__half>(a, d, st);
  return static_cast<int>(err);
}
