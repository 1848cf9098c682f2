// PIL's fixed-point resampler for the chat path's images on the device, fused
// with the normalisations, the casts and the ViT's patch-row layout.
//
// resample_pass_kernel (g2_resample_pass): one separable pass of Pillow's
//     8-bit resize (Resample.c, ImagingResampleHorizontal_8bpc /
//     ImagingResampleVertical_8bpc) over a batch of (N, H, W, 3) uint8 frames
//     of one shape, along W or H: each output column (row) sums the input
//     columns (rows) xmin .. xmin + n - 1 times int32 taps, from 1 << 21, and
//     clips `>> 22` to 0..255 (clip8). The taps are Pillow's, rounded to 22
//     fractional bits on the host (ops/resample.py `coeffs`), so the sums are
//     the same integers in any order.
// resample_views_kernel (g2_resample_views): the vertical pass fused with the
//     views' epilogue: x / 255, (x - mean) / std per channel in fp32, the
//     cast, stored as (N, 3, H, W): the DINOv2 views of chat.
// resample_rows_kernel (g2_resample_patch_rows): the vertical pass fused with
//     the ViT's epilogue: the same fp32 normalisation (CLIP's mean / std), the
//     cast, and each pixel stored into its merge-grouped patch row of
//     (P, 3 T p p) at its column, once for each of the T temporal copies
//     (data/vit_preprocess.tile_patches' layout); the launch also zeroes the
//     `pad` elements of `out` after its frames' rows (pack_views' padding).
//
// None replaces a TPU kernel: the JAX package preprocesses on the host with
// PIL. They exist because that host work, with the cast and the copy of its
// fp32 rows, was the largest block of a chat request while the card idled.
//
// What bounds them on the H100: bytes and launch latency. Four 480x640 frames
// are 3.7 MB in; the views and the ViT rows 32 MB out in bf16, ~12 us at
// 3.35 TB/s; a pass reads its input a few times over (the taps overlap) from
// L1 / L2. The design: one thread a pixel and its three channels; the table
// row (xmin, n, taps) is shared by the threads of an output row (vertical
// passes, where a block spans one or two rows) or read through L1
// (horizontal). The division and the normalisation are IEEE fp32 operations
// as numpy does them (this source is built without fast math), and the casts
// round to nearest even as torch's do, so every output is bitwise the host
// path's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrecisionBits = 22;  // Resample.c PRECISION_BITS: 32 - 8 - 2

__device__ __forceinline__ uint8_t clip8(int ss) {
  // Resample.c clip8: the sum >> 22, clipped to 0..255
  if (ss >= (1 << kPrecisionBits << 8)) return 255;
  if (ss <= 0) return 0;
  return static_cast<uint8_t>(ss >> kPrecisionBits);
}

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half cast_out<__half>(float v) { return __float2half_rn(v); }

struct Norm {
  float mean[3];
  float std[3];
};

// The three channels of output pixel `o` of a pass along an axis whose input
// pixels lie `step` bytes apart, from `src` (the first input pixel of its
// line). `tab` is the pass's table of `stride` int32 a row: xmin, n, taps.
__device__ __forceinline__ void pass3(const uint8_t* __restrict__ src, long long step,
                                      const int* __restrict__ tab, int stride, int o, int out[3]) {
  const int* row = tab + static_cast<long long>(o) * stride;
  const int xmin = __ldg(row), n = __ldg(row + 1);
  int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
  const uint8_t* p = src + xmin * step;
  for (int k = 0; k < n; ++k, p += step) {
    const int w = __ldg(row + 2 + k);
    s0 += static_cast<int>(p[0]) * w;
    s1 += static_cast<int>(p[1]) * w;
    s2 += static_cast<int>(p[2]) * w;
  }
  out[0] = clip8(s0);
  out[1] = clip8(s1);
  out[2] = clip8(s2);
}

// axis 2: (N, H, W, 3) -> (N, H, out_len, 3); axis 1: -> (N, out_len, W, 3)
__global__ void __launch_bounds__(kThreads) resample_pass_kernel(
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, const int* __restrict__ tab, int axis, int n_frames,
    int h, int w, int out_len, int stride) {
  const int oh = axis == 1 ? out_len : h, ow = axis == 1 ? w : out_len;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_frames) * oh * ow) return;
  const int x = static_cast<int>(idx % ow);
  const long long fy = idx / ow;  // frame * oh + y
  const int y = static_cast<int>(fy % oh);
  const long long f = fy / oh;
  int px[3];
  if (axis == 1) {
    pass3(in + (f * h * w + x) * 3, static_cast<long long>(w) * 3, tab, stride, y, px);
  } else {
    pass3(in + (f * h + y) * w * 3, 3, tab, stride, x, px);
  }
  uint8_t* o = out + idx * 3;
  o[0] = static_cast<uint8_t>(px[0]);
  o[1] = static_cast<uint8_t>(px[1]);
  o[2] = static_cast<uint8_t>(px[2]);
}

// numpy's float32 arithmetic of the host path: u / 255.0f, then (x - mean) / std
__device__ __forceinline__ float normalise(int u, float mean, float std) {
  const float x = __fdiv_rn(static_cast<float>(u), 255.0f);
  return __fdiv_rn(__fsub_rn(x, mean), std);
}

// (N, H, W, 3) -> (N, 3, out_h, W) in T
template <typename T>
__global__ void __launch_bounds__(kThreads) resample_views_kernel(
    const uint8_t* __restrict__ in, T* __restrict__ out, const int* __restrict__ tab, int n_frames, int h, int w,
    int out_h, int stride, Norm nm) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_frames) * out_h * w) return;
  const int x = static_cast<int>(idx % w);
  const long long fy = idx / w;
  const int y = static_cast<int>(fy % out_h);
  const long long f = fy / out_h;
  int px[3];
  pass3(in + (f * h * w + x) * 3, static_cast<long long>(w) * 3, tab, stride, y, px);
  const long long plane = static_cast<long long>(out_h) * w;
  T* o = out + f * 3 * plane + static_cast<long long>(y) * w + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c * plane] = cast_out<T>(normalise(px[c], nm.mean[c], nm.std[c]));
}

// (N, H, W, 3) -> the frames' merge-grouped patch rows of (P, 3 T p p) in T; then `pad` zeros
template <typename T>
__global__ void __launch_bounds__(kThreads) resample_rows_kernel(
    const uint8_t* __restrict__ in, T* __restrict__ out, const int* __restrict__ tab, int n_frames, int h, int w,
    int out_h, int stride, Norm nm, int patch, int merge, int temporal, long long pad) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long pixels = static_cast<long long>(n_frames) * out_h * w;
  const int row_len = 3 * temporal * patch * patch;
  if (idx >= pixels) {
    if (idx - pixels < pad) out[(pixels / (patch * patch)) * row_len + (idx - pixels)] = cast_out<T>(0.0f);
    return;
  }
  const int x = static_cast<int>(idx % w);
  const long long fy = idx / w;
  const int y = static_cast<int>(fy % out_h);
  const long long f = fy / out_h;
  int px[3];
  pass3(in + (f * h * w + x) * 3, static_cast<long long>(w) * 3, tab, stride, y, px);
  // tile_patches: row (bh, bw, mh, mw) of the frame, column ((c T + t) p + ph) p + pw
  const int gy = y / patch, ph = y % patch, gx = x / patch, pw = x % patch;
  const int gw = w / patch;
  const long long row = f * (static_cast<long long>(out_h / patch) * gw) +
                        ((static_cast<long long>(gy / merge) * (gw / merge) + gx / merge) * merge + gy % merge) * merge +
                        gx % merge;
  T* o = out + row * row_len + ph * patch + pw;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T v = cast_out<T>(normalise(px[c], nm.mean[c], nm.std[c]));
    for (int t = 0; t < temporal; ++t) o[(c * temporal + t) * patch * patch] = v;
  }
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int g2_resample_pass(int axis, const void* in, void* out, const int* tab, int n, int h, int w, int out_len,
                                int stride, void* stream) {
  if ((axis != 1 && axis != 2) || n < 1 || h < 1 || w < 1 || out_len < 1 || stride < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * (axis == 1 ? static_cast<long long>(out_len) * w
                                                                 : static_cast<long long>(h) * out_len);
  resample_pass_kernel<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), tab, axis, n, h, w, out_len, stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g2_resample_views(int dtype, const void* in, void* out, const int* tab, int n, int h, int w, int out_h,
                                 int stride, float m0, float m1, float m2, float s0, float s1, float s2,
                                 void* stream) {
  if (n < 1 || h < 1 || w < 1 || out_h < 1 || stride < 3 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Norm nm{{m0, m1, m2}, {s0, s1, s2}};
  const unsigned grid = blocks(static_cast<long long>(n) * out_h * w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (dtype == 0) {
    resample_views_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        src, static_cast<__nv_bfloat16*>(out), tab, n, h, w, out_h, stride, nm);
  } else if (dtype == 1) {
    resample_views_kernel<__half><<<grid, kThreads, 0, st>>>(src, static_cast<__half*>(out), tab, n, h, w, out_h,
                                                             stride, nm);
  } else {
    resample_views_kernel<float><<<grid, kThreads, 0, st>>>(src, static_cast<float*>(out), tab, n, h, w, out_h,
                                                            stride, nm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int g2_resample_patch_rows(int dtype, const void* in, void* out, const int* tab, int n, int h, int w,
                                      int out_h, int stride, float m0, float m1, float m2, float s0, float s1,
                                      float s2, int patch, int merge, int temporal, long long pad, void* stream) {
  if (n < 1 || h < 1 || w < 1 || out_h < 1 || stride < 3 || dtype < 0 || dtype > 2 || patch < 1 || merge < 1 ||
      temporal < 1 || pad < 0 || out_h % (patch * merge) || w % (patch * merge))
    return static_cast<int>(cudaErrorInvalidValue);
  const Norm nm{{m0, m1, m2}, {s0, s1, s2}};
  const unsigned grid = blocks(static_cast<long long>(n) * out_h * w + pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  if (dtype == 0) {
    resample_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        src, static_cast<__nv_bfloat16*>(out), tab, n, h, w, out_h, stride, nm, patch, merge, temporal, pad);
  } else if (dtype == 1) {
    resample_rows_kernel<__half><<<grid, kThreads, 0, st>>>(src, static_cast<__half*>(out), tab, n, h, w, out_h,
                                                            stride, nm, patch, merge, temporal, pad);
  } else {
    resample_rows_kernel<float><<<grid, kThreads, 0, st>>>(src, static_cast<float*>(out), tab, n, h, w, out_h,
                                                           stride, nm, patch, merge, temporal, pad);
  }
  return static_cast<int>(cudaGetLastError());
}
