// The fused kernels of the MoT decode step for Hopper (sm_90a): one token per
// sequence against a bf16 / fp16 KV cache, fp32 inside.
//
// decode_attn_kernel (g2_decode_attention): a layer's attention chain between
//     the q/k/v and the o products. The fresh rows' q/k RMSNorm (when the
//     model has qk_norm), the rotate-half RoPE of the step's angles, the
//     scores of the GQA group's queries against the cache rows below `length`
//     and against the token's own row (the "self" term), the softmax and P.V,
//     all in fp32 as decoding.py's chain computes them; the output in the
//     compute dtype for o_proj; and the store of the roped k row and the v row
//     at row `length` of the layer's cache.
// add_rms_norm_kernel (g2_add_rms_norm): the residual add x + delta, rounded
//     as the dtype's add rounds, and the RMSNorm of that sum with its double
//     rounding (y to the dtype, then times the weight in fp32, then to the
//     dtype): each layer's input and post-attention norm and the final norm.
//
// Neither replaces a TPU kernel: the JAX package runs this step as XLA ops
// (g2vlm_tpu/inference/decoding.py has no pallas_call). They exist because the
// step, captured in a CUDA graph, was ~88 small kernels a layer between its
// seven products: fp32 casts of the whole cache, elementwise chains, and the
// gaps between them.
//
// What bounds them on the H100: bytes and latency. decode_attn_kernel reads
// 2 KVH length D 2 bytes of cache (7.3 MB at 7,100 rows of 2 KV heads of 128:
// 2.2 us at 3.35 TB/s); add_rms_norm_kernel a few KB. A layer's share of the
// step is microseconds, so the launch, the prologue and the tail count as much
// as the bandwidth.
//
// The design of decode_attn_kernel: split rows with a last-block merge.
// - One block of 256 threads per (split of the cache rows, KV head, sequence).
//   The host sizes the splits from the capacity (`decode_split` in
//   ops/decode_fused.py) so that the grid fills the card at the lengths the
//   capacity is made for; a block whose rows all lie at or beyond `length`,
//   read on the device, exits at once, so a fixed capacity costs nothing and
//   the grid is fixed when a CUDA graph captures the step.
// - Every global read that does not depend on `length` is issued with it, in
//   one round trip. A block streams its rows in chunks of 128 through a
//   two-stage ring of 16-byte cp.async copies (the next chunk's issued before
//   the current one's work); the first chunk's copies fly under the prologue,
//   where a warp a head norms and ropes the G queries and the k row with warp
//   shuffles alone.
// - Scores: four threads to a pair of rows (r, r + 64), a quarter of the
//   pieces each, so that one broadcast load of a query serves both rows; the K
//   rows sit in shared memory swizzled by the row (piece c of row r at c ^ (r
//   & 15)), and the quarters start at pieces chosen so that a quarter warp's
//   16-byte loads fall in distinct banks. P.V: a pair of columns and a quarter
//   of the rows a thread. The softmax is online across the chunks: the maxima
//   through one barrier a chunk (the reduction scratch used in turns), each
//   thread's share of the sum l and the accumulators in registers, summed once
//   at the end.
// - Each block writes its split's (acc, m, l) to fp32 scratch and takes an
//   atomic ticket (acquire-release, after a barrier: the CUTLASS semaphore's
//   pattern). The block that draws the last one merges the splits, a warp a
//   query for the weights and 16-byte loads of the records in predicated
//   batches, with the token's own row (the chain's self term); it writes the
//   output, stores the row (after every read of its head's cache rows: no
//   hazard, even where a full cache clamps the row into the visible range),
//   and resets the ticket to 0, so the next launch on the same scratch, or the
//   next replay, starts clean.
// Measured on the H100 at chat-short's lengths (PERF.md): the cache rows take
// about a third of a launch; the rest is the chain of barriers of one chunk's
// scores, softmax and P.V, the ticket and the merge, each a few hundred
// nanoseconds to microseconds of latency on a few warps an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                         // head dim
constexpr int kChunk = 128;                     // cache rows of a chunk
constexpr int kThreads = 256;                   // four to two rows (scores), a quarter of the rows to two columns (P.V)
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                         // 2-byte values in a 16-byte piece
constexpr int kPieces = kD / kVec;              // 16-byte pieces of a row
constexpr int kMaxG = 8;                        // query heads of a GQA group
constexpr int kStageBytes = 2 * kChunk * kD * 2;  // a chunk's K and V: 64 KB
constexpr int kMaxSplits = kStageBytes / (2 * kMaxG * 4);  // the merge keeps (m, l) of each split in a stage
constexpr int kMergeBatch = 16;                 // split records the merge loads at once
constexpr int kNormThreads = 256;
constexpr int kNormPieces = 4;                  // 16-byte pieces a thread: hidden sizes up to 8,192

// floats of a split's record: the G accumulators of kD columns, then (m, l) of each query, padded to
// 16 bytes for the merge's vector loads
template <int G>
constexpr int kRecord = (G * (kD + 2) + 3) / 4 * 4;

template <typename T>
struct Cvt;
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half t(float x) { return __float2half_rn(x); }
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::f(Cvt<T>::t(x));
}

// a norm weight of dtype code 0 bf16, 1 fp16, 2 fp32
__device__ __forceinline__ float weight_at(const void* w, int w_dtype, int i) {
  if (w_dtype == 2) return static_cast<const float*>(w)[i];
  if (w_dtype == 1) return __half2float(static_cast<const __half*>(w)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
}

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[kVec]) {
  const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = Cvt<T>::f(p[e]);
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&in)[kVec]) {
  uint4 raw;
  T* p = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) p[e] = Cvt<T>::t(in[e]);
  return raw;
}

// G consecutive floats of shared memory, in pairs where G is even (`p` 8-byte aligned then)
template <int G>
__device__ __forceinline__ void load_row(const float* p, float (&out)[G]) {
  if constexpr (G % 2 == 0) {
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + g);
      out[g] = v.x, out[g + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) out[g] = p[g];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// an atomic add that releases what this thread has seen (through a barrier: its block's writes) and
// acquires what the earlier adders released, at device scope
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum of one value a thread, for every thread (W warps), in a fixed order: a launch
// repeats its result
template <int W>
__device__ __forceinline__ float block_sum(float v, float (&red)[W]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < W; ++w) r += red[w];
  return r;
}

struct AttnArgs {
  const void* q;  // (B, H, D), batch stride q_sb
  const void* k;  // (B, KVH, D), batch stride k_sb
  const void* v;
  const void* q_w;  // (D,) q_norm weight, null without qk_norm
  const void* k_w;
  int w_dtype;
  float eps;
  const float* cos;  // (B, D)
  const float* sin;
  void* k_cache;  // the layer's (B, KVH, C, D): strides c_sb, c_sh, D, 1
  void* v_cache;
  const long long* length;  // (B,)
  void* out;                // (B, H D)
  float* part;              // (B, KVH, n_split) records of kRecord<G> floats: acc (G, D), then (m, l) of each query
  int* ticket;              // (B, KVH), 0 between launches
  int kvh, cap, n_split, chunks_per_split;
  long long q_sb, k_sb, v_sb, c_sb, c_sh;
  float scale;
};

// The block's maximum of each of N values, for every thread: one barrier, `red` used in turns
template <int N>
__device__ __forceinline__ void block_max(float (&v)[N], float (*red)[kWarps][kMaxG + 1], int& turn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_max(v[n]);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[turn][warp][n] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float r = red[turn][0][n];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[turn][w][n]);
    v[n] = r;
  }
  turn ^= 1;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(16) float qs[G + 1][kD];     // the G normed, roped queries, then the k row
  __shared__ __align__(16) float ps[kChunk][G];     // a chunk's probabilities
  __shared__ __align__(16) float upper[3][G][kD];   // P.V of row quarters 1-3, added to quarter 0's at the end
  __shared__ float red[2][kWarps][kMaxG + 1];       // reductions, in turns
  __shared__ float stat[3][G];                      // the merge: each query's maximum, sum and self weight
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int col = t & (kD - 1), half = t >> 7;  // the row store: a column
  const int cp = t & (kD / 2 - 1), quarter = t >> 6;  // P.V: columns 2 cp and 2 cp + 1, a quarter of the rows
  const int rp = t >> 2, part = t & 3;          // the scores: rows rp and rp + 64, a quarter of their pieces
  const int hd0 = warp;                         // the prologue: warp w the head w, lane l its columns 4l..4l+3

  // every global read that does not depend on `length`, issued with it: one round trip
  const long long len = a.length[b];
  const bool norm = a.q_w != nullptr;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + static_cast<long long>(h) * G * kD;  // 8-byte aligned rows
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * kD;
  uint2 raw0 = make_uint2(0, 0);
  if (hd0 <= G) raw0 = *reinterpret_cast<const uint2*>((hd0 < G ? qp + hd0 * kD : kp) + 4 * lane);
  const float4 cs = *reinterpret_cast<const float4*>(a.cos + b * kD + 4 * lane);
  const float4 sn = *reinterpret_cast<const float4*>(a.sin + b * kD + 4 * lane);
  const T v_self_raw = static_cast<const T*>(a.v)[b * a.v_sb + h * kD + col];

  const int n = static_cast<int>(len < a.cap ? len : a.cap);  // the visible rows
  const int span = kChunk * a.chunks_per_split;
  const int n_act = n > 0 ? (n + span - 1) / span : 1;  // splits that take part; split 0 always does
  if (split >= n_act) return;
  const int row0 = split * span;
  const int rows = n > row0 ? min(n, row0 + span) - row0 : 0;
  const int n_chunks = (rows + kChunk - 1) / kChunk;
  const T* kc = static_cast<const T*>(a.k_cache) + b * a.c_sb + h * a.c_sh;
  const T* vc = static_cast<const T*>(a.v_cache) + b * a.c_sb + h * a.c_sh;

  auto issue = [&](int j) {  // chunk j's K (swizzled by the row) and V, one cp.async group
    T* ks = reinterpret_cast<T*>(ring + (j & 1) * kStageBytes);
    T* vs = ks + kChunk * kD;
    const int r0 = row0 + j * kChunk, nr = min(kChunk, row0 + rows - r0);
#pragma unroll
    for (int i = t; i < kChunk * kPieces; i += kThreads) {
      const int r = i / kPieces, c = i % kPieces;
      if (r < nr) {
        cp_async16(ks + r * kD + (c ^ (r & 15)) * kVec, kc + static_cast<long long>(r0 + r) * kD + c * kVec);
        cp_async16(vs + r * kD + c * kVec, vc + static_cast<long long>(r0 + r) * kD + c * kVec);
      }
    }
    cp_async_commit();
  };
  if (n_chunks > 0) issue(0);

  // ---- prologue: the queries and the k row normed and roped as the chain does, a warp a head
  for (int hd = hd0; hd <= G; hd += kWarps) {
    const T* src = hd < G ? qp + hd * kD : kp;
    const uint2 raw = hd == hd0 ? raw0 : *reinterpret_cast<const uint2*>(src + 4 * lane);
    const T* xr = reinterpret_cast<const T*>(&raw);
    float x[4] = {Cvt<T>::f(xr[0]), Cvt<T>::f(xr[1]), Cvt<T>::f(xr[2]), Cvt<T>::f(xr[3])};
    if (norm) {  // rms_norm(x.float(), w): x * rsqrt(mean(x^2) + eps), then times w, all fp32
      const float ss = warp_sum(x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
      const float r = __frsqrt_rn(__fadd_rn(ss / kD, a.eps));
      const void* w = hd < G ? a.q_w : a.k_w;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = __fmul_rn(__fmul_rn(x[e], r), weight_at(w, a.w_dtype, 4 * lane + e));
    }
    const float c4[4] = {cs.x, cs.y, cs.z, cs.w}, s4[4] = {sn.x, sn.y, sn.z, sn.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // x c + rotate_half(x) s, two products and a sum (no FMA); lane ^ 16 holds col ^ 64
      const float other = __shfl_xor_sync(0xffffffffu, x[e], 16);
      const float v = __fadd_rn(__fmul_rn(x[e], c4[e]), __fmul_rn(lane < 16 ? -other : other, s4[e]));
      y[e] = norm ? v : round_to<T>(v);  // without the norm apply_mrope returns the projection's dtype
    }
    *reinterpret_cast<float4*>(&qs[hd][4 * lane]) = make_float4(y[0], y[1], y[2], y[3]);
  }

  // ---- the split's rows, chunk by chunk, online softmax; each thread's share of the sum l apart
  int turn = 0;
  float m_run[G], l_part[G], acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) m_run[g] = -INFINITY, l_part[g] = 0.f, acc[g][0] = acc[g][1] = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    const bool more = j + 1 < n_chunks;
    if (more) issue(j + 1);
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();  // chunk j has landed
    __syncthreads();  // (first chunk: also the prologue's queries)
    const T* ks = reinterpret_cast<const T*>(ring + (j & 1) * kStageBytes);
    const T* vs = ks + kChunk * kD;
    const int nr = min(kChunk, rows - j * kChunk);
    float s[2][G];  // rows rp and rp + 64
#pragma unroll
    for (int g = 0; g < G; ++g) s[0][g] = s[1][g] = 0.f;
    if (rp < nr) {
      // part p reads pieces 4p..4p+3, parts 2 and 3 from the third one on: with the rows' swizzle a
      // quarter warp's 8 loads fall in distinct banks; each query load serves both rows
      const uint4* k0 = reinterpret_cast<const uint4*>(ks + rp * kD);
      const uint4* k1 = reinterpret_cast<const uint4*>(ks + (rp + kChunk / 2) * kD);
      const bool second = rp + kChunk / 2 < nr;
#pragma unroll
      for (int i = 0; i < kPieces / 4; ++i) {
        const int c = 4 * part + ((i + (part & 2)) & 3);
        float kf0[kVec], kf1[kVec];
        unpack8<T>(k0[c ^ (rp & 15)], kf0);
        if (second) unpack8<T>(k1[c ^ ((rp + kChunk / 2) & 15)], kf1);
        else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kf1[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 q0 = *reinterpret_cast<const float4*>(&qs[g][c * kVec]);
          const float4 q1 = *reinterpret_cast<const float4*>(&qs[g][c * kVec + 4]);
          const float qv[kVec] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[0][g] = fmaf(qv[e], kf0[e], s[0][g]), s[1][g] = fmaf(qv[e], kf1[e], s[1][g]);
        }
      }
    }
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {  // the four quarters of each row: a tree of commutative sums, one result on all four
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], 1);
        s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], 2);
        s[r][g] = rp + r * (kChunk / 2) < nr ? s[r][g] * a.scale : -INFINITY;
      }
      mx[g] = fmaxf(s[0][g], s[1][g]);
    }
    block_max<G>(mx, red, turn);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m_run[g], mx[g]);  // finite: the chunk has a row
      const float alpha = expf(m_run[g] - m_new);
      const float p0 = expf(s[0][g] - m_new), p1 = expf(s[1][g] - m_new);
      if (part == 0) ps[rp][g] = p0, ps[rp + kChunk / 2][g] = p1;
      l_part[g] = l_part[g] * alpha + (part == 0 ? p0 + p1 : 0.f);  // each row once
      acc[g][0] *= alpha, acc[g][1] *= alpha;
      m_run[g] = m_new;
    }
    __syncthreads();  // ps
    const int r1 = min(nr, (quarter + 1) * (kChunk / 4));
#pragma unroll 8
    for (int r = quarter * (kChunk / 4); r < r1; ++r) {
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(vs + r * kD + 2 * cp);
      const T* v2 = reinterpret_cast<const T*>(&raw);
      const float va = Cvt<T>::f(v2[0]), vb = Cvt<T>::f(v2[1]);
      float pr[G];
      load_row<G>(&ps[r][0], pr);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][0] = fmaf(pr[g], va, acc[g][0]), acc[g][1] = fmaf(pr[g], vb, acc[g][1]);
    }
    if (more) __syncthreads();  // the stage and ps are free for the chunk after next
  }
  if (n_chunks == 0) __syncthreads();  // the prologue's queries

  // ---- the split's record, then the ticket
#pragma unroll
  for (int g = 0; g < G; ++g) l_part[g] = warp_sum(l_part[g]);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[turn][warp][g] = l_part[g];
  }
  if (quarter > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) *reinterpret_cast<float2*>(&upper[quarter - 1][g][2 * cp]) = make_float2(acc[g][0], acc[g][1]);
  }
  __syncthreads();
  const int rec = kRecord<G>;
  float* mine = a.part + (static_cast<long long>(b * a.kvh + h) * a.n_split + split) * rec;
  if (quarter == 0) {  // the quarters summed in their order
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float2 v = make_float2(acc[g][0], acc[g][1]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float2 u = *reinterpret_cast<const float2*>(&upper[k][g][2 * cp]);
        v.x += u.x, v.y += u.y;
      }
      *reinterpret_cast<float2*>(mine + g * kD + 2 * cp) = v;
    }
  }
  if (t < G) {
    float l = red[turn][0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) l += red[turn][w][t];
    float m = m_run[0];
#pragma unroll
    for (int g = 1; g < G; ++g) m = g == t ? m_run[g] : m;
    *reinterpret_cast<float2*>(mine + G * kD + 2 * t) = make_float2(m, l);
  }
  __syncthreads();  // the barrier, then one thread's release: the record is out before the ticket (cumulative)
  if (t == 0) last = atomic_add_acq_rel(a.ticket + b * a.kvh + h, 1) == n_act - 1;
  __syncthreads();  // the last block's acquire, passed on to its threads
  if (!last) return;

  // ---- the last block: merge the splits and the self term, write the output, store the row
  const float* parts = a.part + static_cast<long long>(b * a.kvh + h) * a.n_split * rec;
  float* wts = reinterpret_cast<float*>(ring);  // (n_act, G) each split's maximum, then its weight exp(m - M)
  float* sums = wts + n_act * G;                // (n_act, G) each split's sum
  if (warp < G) {  // warp g: query g's self score, its maximum over the splits, their weights, its sum
    const int g = warp;
    const float4 qg = *reinterpret_cast<const float4*>(&qs[g][4 * lane]);
    const float4 kr = *reinterpret_cast<const float4*>(&qs[G][4 * lane]);
    const float sf = warp_sum(qg.x * kr.x + qg.y * kr.y + qg.z * kr.z + qg.w * kr.w) * a.scale;
    float mm = sf;
#pragma unroll 2
    for (int i = lane; i < n_act; i += 32) {
      const float2 st = __ldcg(reinterpret_cast<const float2*>(parts + static_cast<long long>(i) * rec + G * kD) + g);
      wts[i * G + g] = st.x;
      sums[i * G + g] = st.y;
      mm = fmaxf(mm, st.x);
    }
    mm = warp_max(mm);
    float l = 0.f;
    for (int i = lane; i < n_act; i += 32) {
      const float w = expf(wts[i * G + g] - mm);
      wts[i * G + g] = w;
      l += sums[i * G + g] * w;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float p_self = expf(sf - mm);
      stat[0][g] = mm, stat[1][g] = l + p_self, stat[2][g] = p_self;
    }
  }
  __syncthreads();
  if (t < G * kD / 4) {  // 4 columns of one query a thread, 16-byte loads of the records
    const int g = t / (kD / 4), c0 = 4 * (t % (kD / 4));
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < n_act; i0 += kMergeBatch) {  // a batch's loads in flight together (predicated, no
      float4 ai[kMergeBatch];                           // rolled remainder: one L2 round trip a batch)
      float w[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int i = i0 + u;
        ai[u] = i < n_act ? __ldcg(reinterpret_cast<const float4*>(parts + static_cast<long long>(i) * rec + g * kD + c0))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        w[u] = i < n_act ? wts[i * G + g] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)  // in the splits' order; a padded split adds exact zeros
        o.x = fmaf(ai[u].x, w[u], o.x), o.y = fmaf(ai[u].y, w[u], o.y), o.z = fmaf(ai[u].z, w[u], o.z),
        o.w = fmaf(ai[u].w, w[u], o.w);
    }
    const T* vr = static_cast<const T*>(a.v) + b * a.v_sb + h * kD + c0;
    const float p_self = stat[2][g], l = fmaxf(stat[1][g], 1e-30f);
    const float oo[4] = {o.x, o.y, o.z, o.w};
    T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * a.kvh * G * kD +
             (static_cast<long long>(h) * G + g) * kD + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = Cvt<T>::t((oo[e] + p_self * Cvt<T>::f(vr[e])) / l);
  }
  if (half == 0) {
    const long long pos = len < a.cap ? len : a.cap - 1;
    static_cast<T*>(a.k_cache)[b * a.c_sb + h * a.c_sh + pos * kD + col] = Cvt<T>::t(qs[G][col]);
    static_cast<T*>(a.v_cache)[b * a.c_sb + h * a.c_sh + pos * kD + col] = v_self_raw;
  }
  if (t == 0) a.ticket[b * a.kvh + h] = 0;
}

template <typename T, int G>
cudaError_t launch_attn(const AttnArgs& a, int batch, cudaStream_t stream) {
  const int stages = a.chunks_per_split > 1 ? 2 : 1;
  const int smem = stages * kStageBytes;
  auto kernel = decode_attn_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_split, a.kvh, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attn(const AttnArgs& a, int g, int batch, cudaStream_t stream) {
  switch (g) {  // the groups of the configs that decode on it (GROUPS in ops/decode_fused.py)
    case 6: return launch_attn<T, 6>(a, batch, stream);  // 12:2 heads
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads) add_rms_norm_kernel(
    const T* x, const T* delta, const void* w, int w_dtype, T* x_out, T* y, int n, float eps,
    long long x_sb, long long d_sb, long long xo_sb, long long y_sb) {
  __shared__ float red[kNormThreads / 32];
  const int b = blockIdx.x, t = threadIdx.x, pieces = n / kVec;
  float v[kNormPieces][kVec];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kNormPieces; ++k) {
    const int c = t + k * kNormThreads;
    if (c >= pieces) break;
    unpack8<T>(*reinterpret_cast<const uint4*>(x + b * x_sb + c * kVec), v[k]);
    if (delta != nullptr) {  // x + delta in fp32, rounded once to the dtype, as the dtype's add rounds
      float d[kVec];
      unpack8<T>(*reinterpret_cast<const uint4*>(delta + b * d_sb + c * kVec), d);
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[k][e] = round_to<T>(v[k][e] + d[e]);
      *reinterpret_cast<uint4*>(x_out + b * xo_sb + c * kVec) = pack8<T>(v[k]);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(v[k][e], v[k][e], ss);
  }
  const float r = __frsqrt_rn(__fadd_rn(block_sum(ss, red) / n, eps));
#pragma unroll
  for (int k = 0; k < kNormPieces; ++k) {
    const int c = t + k * kNormThreads;
    if (c >= pieces) break;
    float o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = __fmul_rn(weight_at(w, w_dtype, c * kVec + e), round_to<T>(__fmul_rn(v[k][e], r)));
    *reinterpret_cast<uint4*>(y + b * y_sb + c * kVec) = pack8<T>(o);
  }
}

}  // namespace

// Both entries return the launch's cudaError_t (0: launched).
extern "C" int g2_decode_attention(
    int dtype, int g, const void* q, const void* k, const void* v, const void* q_w, const void* k_w, int w_dtype,
    float eps, const float* cos, const float* sin, void* k_cache, void* v_cache, const long long* length,
    void* out, float* part, int* ticket, int batch, int kvh, int cap, int n_split, int chunks_per_split,
    long long q_sb, long long k_sb, long long v_sb, long long c_sb, long long c_sh, float scale, void* stream) {
  if (batch < 1 || kvh < 1 || cap < 1 || n_split < 1 || n_split > kMaxSplits || chunks_per_split < 1 ||
      static_cast<long long>(n_split) * chunks_per_split * kChunk < cap || (q_w == nullptr) != (k_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{q, k, v, q_w, k_w, w_dtype, eps, cos, sin, k_cache, v_cache, length, out, part, ticket,
             kvh, cap, n_split, chunks_per_split, q_sb, k_sb, v_sb, c_sb, c_sh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_attn<__nv_bfloat16>(a, g, batch, st) : dispatch_attn<__half>(a, g, batch, st);
  return static_cast<int>(err);
}

extern "C" int g2_add_rms_norm(
    int dtype, const void* x, const void* delta, const void* w, int w_dtype, void* x_out, void* y, int batch,
    int n, float eps, long long x_sb, long long d_sb, long long xo_sb, long long y_sb, void* stream) {
  if (batch < 1 || n < kVec || n % kVec || n > kNormThreads * kNormPieces * kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    add_rms_norm_kernel<__nv_bfloat16><<<batch, kNormThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta), w, w_dtype,
        static_cast<__nv_bfloat16*>(x_out), static_cast<__nv_bfloat16*>(y), n, eps, x_sb, d_sb, xo_sb, y_sb);
  } else {
    add_rms_norm_kernel<__half><<<batch, kNormThreads, 0, st>>>(
        static_cast<const __half*>(x), static_cast<const __half*>(delta), w, w_dtype, static_cast<__half*>(x_out),
        static_cast<__half*>(y), n, eps, x_sb, d_sb, xo_sb, y_sb);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's constants the wrapper sizes its launches and scratch by: rows of a chunk, the most
// query heads of a group, the most splits.
extern "C" int g2_decode_constants(int which) {
  switch (which) {
    case 0: return kChunk;
    case 1: return kMaxG;
    case 2: return kMaxSplits;
    case 3: return kD;
    default: return -1;
  }
}
