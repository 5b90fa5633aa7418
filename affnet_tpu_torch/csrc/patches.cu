// Kernel B4: bilinear patch sampler on the row-padded pyramid buffer.
//
// Replaces affnet_tpu/ops/pallas_patches.py:_sampler_kernel (entries
// extract_patches_window_matmul and extract_patches_bucketed).  Plain
// version: affnet_tpu_torch/ops/patches.py
// extract_patches_from_flat_pyramid.
//
// Patch i samples flat level level[i] (rows [row_off, row_off + h), columns
// [0, w) of the buffer) with torch grid_sample semantics: sample position
// p = min(h, w) * A @ (gx, gy) + (w * tx, h * ty), then u = p - 0.5
// (align_corners=False) or u = p * (size - 1) / size (True); bilinear with
// out-of-level corners contributing zero.  The plain version's float
// operations in its order, separately rounded, so the two agree bit for bit.
//
// Design: a direct gather, one block per patch, one thread per output
// sample.  The TPU kernel's static windows, tent-weight matmuls and exact
// fallback are a TPU layout choice; with no static window nothing can
// overflow, so the caller's n_overflow is always 0.
//
// bf16 mode (B4-bf16, the extractor's fast mode): the TPU kernel with
// mxu_dtype=bf16 (pallas_patches.py:214-247) rounds each window value and
// each column tent weight to bf16 and accumulates their products in f32,
// then weights the row sums by the f32 row tents.  Here: the four corner
// values and the column weights (1 - fx, fx) are rounded to bf16 (round to
// nearest even, by the intrinsics), each row's two products (exact in f32)
// are summed in f32, and the rows are weighted by the f32 (1 - fy, fy) and
// summed.  Plain version: extract_patches_from_flat_pyramid(...,
// bf16=True), the same operations in the same order.
//
// Bound on the H100: bytes.  2000 32x32 patches write 8.2 MB and read at
// most four corners per sample from L2-resident windows; a few us at
// 3.35 TB/s.  Speed is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPs = 64;
constexpr int kThreads = 256;

struct BaseGrid {
  float lin[kMaxPs];
};

// The buffer value at level pixel (xc, yc), read clamped into the level,
// and whether (xc, yc) lies inside it.
__device__ __forceinline__ float fetch(const float* __restrict__ buf,
                                       int pitch, long long row_off,
                                       long long xc, long long yc, int h,
                                       int w, float* inb) {
  *inb = (xc >= 0 && xc <= w - 1 && yc >= 0 && yc <= h - 1) ? 1.0f : 0.0f;
  const long long xcc = min(max(xc, 0LL), static_cast<long long>(w - 1));
  const long long ycc = min(max(yc, 0LL), static_cast<long long>(h - 1));
  return __ldg(buf + (row_off + ycc) * pitch + xcc);
}

__device__ __forceinline__ float corner(const float* __restrict__ buf,
                                        int pitch, long long row_off,
                                        long long xc, long long yc, int h,
                                        int w, float wgt) {
  float inb;
  const float v = fetch(buf, pitch, row_off, xc, yc, h, w, &inb);
  return __fmul_rn(__fmul_rn(v, wgt), inb);
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 mode: the masked corner value rounded to bf16.
__device__ __forceinline__ float corner_bf16(const float* __restrict__ buf,
                                             int pitch, long long row_off,
                                             long long xc, long long yc,
                                             int h, int w) {
  float inb;
  const float v = fetch(buf, pitch, row_off, xc, yc, h, w, &inb);
  return __fmul_rn(to_bf16(v), inb);
}

template <bool kBf16>
__global__ void sample_patches(const float* __restrict__ buf, int pitch,
                               const float* __restrict__ lafs,
                               const int* __restrict__ level,
                               const int* __restrict__ row_offsets,
                               const int* __restrict__ heights,
                               const int* __restrict__ widths, int n_levels,
                               BaseGrid grid, float* __restrict__ out,
                               int ps, int align_corners) {
  const int p = blockIdx.x;
  const int l = min(max(level[p], 0), n_levels - 1);
  const int h = heights[l], w = widths[l];
  const long long row_off = row_offsets[l];
  const float hf = static_cast<float>(h), wf = static_cast<float>(w);
  const float m = fminf(hf, wf);
  const float* a = lafs + static_cast<size_t>(p) * 6;
  const float a00 = a[0], a01 = a[1], tx = a[2];
  const float a10 = a[3], a11 = a[4], ty = a[5];
  for (int s = threadIdx.x; s < ps * ps; s += blockDim.x) {
    const float gx = grid.lin[s % ps];
    const float gy = grid.lin[s / ps];
    const float xs = __fadd_rn(
        __fmul_rn(m, __fadd_rn(__fmul_rn(a00, gx), __fmul_rn(a01, gy))),
        __fmul_rn(wf, tx));
    const float ys = __fadd_rn(
        __fmul_rn(m, __fadd_rn(__fmul_rn(a10, gx), __fmul_rn(a11, gy))),
        __fmul_rn(hf, ty));
    float u, v;
    if (align_corners) {
      u = __fdiv_rn(__fmul_rn(xs, __fsub_rn(wf, 1.0f)), wf);
      v = __fdiv_rn(__fmul_rn(ys, __fsub_rn(hf, 1.0f)), hf);
    } else {
      u = __fsub_rn(xs, 0.5f);
      v = __fsub_rn(ys, 0.5f);
    }
    const float x0 = floorf(u), y0 = floorf(v);
    const float fx = __fsub_rn(u, x0), fy = __fsub_rn(v, y0);
    const float gx1 = __fsub_rn(1.0f, fx), gy1 = __fsub_rn(1.0f, fy);
    // Saturating conversions keep non-finite or huge coordinates in range;
    // the in-bounds test then zeroes them.
    const long long x0i = __float2ll_rz(x0), y0i = __float2ll_rz(y0);
    float acc;
    if (kBf16) {
      const float cx0 = to_bf16(gx1), cx1 = to_bf16(fx);
      const float row0 = __fadd_rn(
          __fmul_rn(corner_bf16(buf, pitch, row_off, x0i, y0i, h, w), cx0),
          __fmul_rn(corner_bf16(buf, pitch, row_off, x0i + 1, y0i, h, w),
                    cx1));
      const float row1 = __fadd_rn(
          __fmul_rn(corner_bf16(buf, pitch, row_off, x0i, y0i + 1, h, w),
                    cx0),
          __fmul_rn(corner_bf16(buf, pitch, row_off, x0i + 1, y0i + 1, h,
                                w), cx1));
      acc = __fadd_rn(__fmul_rn(gy1, row0), __fmul_rn(fy, row1));
    } else {
      acc = corner(buf, pitch, row_off, x0i, y0i, h, w, __fmul_rn(gx1, gy1));
      acc = __fadd_rn(acc, corner(buf, pitch, row_off, x0i + 1, y0i, h, w,
                                  __fmul_rn(fx, gy1)));
      acc = __fadd_rn(acc, corner(buf, pitch, row_off, x0i, y0i + 1, h, w,
                                  __fmul_rn(gx1, fy)));
      acc = __fadd_rn(acc, corner(buf, pitch, row_off, x0i + 1, y0i + 1, h,
                                  w, __fmul_rn(fx, fy)));
    }
    out[static_cast<size_t>(p) * ps * ps + s] = acc;
  }
}

}  // namespace

// buf: float32 (buf_rows, pitch); lafs: float32 (n, 2, 3); level: int32
// (n,); row_offsets/heights/widths: int32 (n_levels,); lin_host: host array
// of ps base-grid coordinates, copied into the kernel parameters; out:
// float32 (n, ps, ps); bf16: nonzero selects bf16 mode.  All device arrays
// contiguous.
extern "C" int launch_sample_patches(const float* buf, int buf_rows,
                                     int pitch, const float* lafs,
                                     const int* level, const int* row_offsets,
                                     const int* heights, const int* widths,
                                     int n_levels, const float* lin_host,
                                     float* out, int n, int ps,
                                     int align_corners, int bf16,
                                     void* stream) {
  if (buf_rows <= 0 || pitch <= 0 || n <= 0 || n_levels <= 0 || ps < 2 ||
      ps > kMaxPs)
    return static_cast<int>(cudaErrorInvalidValue);
  BaseGrid grid;
  for (int i = 0; i < ps; ++i) grid.lin[i] = lin_host[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    sample_patches<true><<<n, kThreads, 0, st>>>(
        buf, pitch, lafs, level, row_offsets, heights, widths, n_levels,
        grid, out, ps, align_corners);
  else
    sample_patches<false><<<n, kThreads, 0, st>>>(
        buf, pitch, lafs, level, row_offsets, heights, widths, n_levels,
        grid, out, ps, align_corners);
  return static_cast<int>(cudaGetLastError());
}
