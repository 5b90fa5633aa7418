// Kernel B5 backward: the vector-Jacobian product of the bilinear patch
// sampler (csrc/patches.cu) with respect to the LAFs and the buffer.
//
// Replaces the backward of affnet_tpu/ops/pallas_patches.py:
// _batched_sample_diff, _batched_sample_bwd (:702), which is the VJP of the
// XLA flat gather (ops/patches.py extract_patches_from_flat_pyramid), not a
// Pallas kernel.  The forward of B5 is B4's kernel on per-sample tables.
// Plain version: autograd of affnet_tpu_torch/ops/patches.py
// extract_patches_from_flat_pyramid.
//
// For each output sample with upstream gradient g, sample position (u, v),
// fractions (fx, fy) and masked corner values I00, I10, I01, I11 (zero when
// the corner lies outside the level):
//   d out / du = (1 - fy)(I10 - I00) + fy (I11 - I01)
//   d out / dv = (1 - fx)(I01 - I00) + fx (I11 - I10)
// (floor has a zero derivative), chained through
//   u = s_u (m (a00 gx + a01 gy) + w tx) [- 0.5],  v likewise with h,
// where s_u = 1, or (w - 1) / w with align_corners.  The six LAF partials
// are reduced over the patch's PS^2 samples in a fixed order (per-thread
// strided sums, then a fixed shuffle and warp tree), so the LAF cotangent is
// the same from run to run.  The buffer cotangent scatters g * weight into
// the four in-level corners with atomicAdd (order not reproducible);
// samples at non-finite positions, or beyond 1e9 px, scatter nothing.
//
// Design: one block per patch, one thread per sample in a strided loop; the
// sample coordinates are computed with the forward's separately rounded
// operations so floor() picks the forward's corners.
//
// Bound on the H100: bytes.  The training rewarp reads 2048 x 32 x 32
// upstream gradients (8 MB) and the touched corners of a 33 MB image stack,
// and writes 24 bytes per patch: a few us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPs = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct BaseGrid {
  float lin[kMaxPs];
};

__device__ __forceinline__ bool in_level(long long xc, long long yc, int h,
                                         int w) {
  return xc >= 0 && xc <= w - 1 && yc >= 0 && yc <= h - 1;
}

__global__ void sample_patches_bwd(const float* __restrict__ buf, int pitch,
                                   const float* __restrict__ lafs,
                                   const int* __restrict__ level,
                                   const int* __restrict__ row_offsets,
                                   const int* __restrict__ heights,
                                   const int* __restrict__ widths,
                                   int n_levels, BaseGrid grid,
                                   const float* __restrict__ g,
                                   float* __restrict__ grad_buf,
                                   float* __restrict__ grad_lafs, int ps,
                                   int align_corners) {
  const int p = blockIdx.x;
  const int l = min(max(level[p], 0), n_levels - 1);
  const int h = heights[l], w = widths[l];
  const long long row_off = row_offsets[l];
  const float hf = static_cast<float>(h), wf = static_cast<float>(w);
  const float m = fminf(hf, wf);
  const float* a = lafs + static_cast<size_t>(p) * 6;
  const float a00 = a[0], a01 = a[1], tx = a[2];
  const float a10 = a[3], a11 = a[4], ty = a[5];
  const float* gp = g + static_cast<size_t>(p) * ps * ps;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = threadIdx.x; s < ps * ps; s += blockDim.x) {
    const float gx = grid.lin[s % ps];
    const float gy = grid.lin[s / ps];
    // The forward's coordinate arithmetic (csrc/patches.cu), op for op.
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
    // Positions beyond 1e9 px (and NaN) touch no level: they are skipped
    // before the integer conversion, so no index can overflow.
    const bool near = fabsf(u) < 1e9f && fabsf(v) < 1e9f;
    const long long x0i = near ? __float2ll_rz(x0) : 0;
    const long long y0i = near ? __float2ll_rz(y0) : 0;
    const float gs = gp[s];
    const long long cx[4] = {x0i, x0i + 1, x0i, x0i + 1};
    const long long cy[4] = {y0i, y0i, y0i + 1, y0i + 1};
    const float wgt[4] = {gx1 * gy1, fx * gy1, gx1 * fy, fx * fy};
    float val[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      val[c] = 0.0f;
      if (near && in_level(cx[c], cy[c], h, w)) {
        const long long off = (row_off + cy[c]) * pitch + cx[c];
        val[c] = __ldg(buf + off);
        if (grad_buf != nullptr) atomicAdd(grad_buf + off, gs * wgt[c]);
      }
    }
    if (grad_lafs != nullptr) {
      const float du = gy1 * (val[1] - val[0]) + fy * (val[3] - val[2]);
      const float dv = gx1 * (val[2] - val[0]) + fx * (val[3] - val[1]);
      const float gu = gs * du, gv = gs * dv;
      acc[0] += gu * gx;
      acc[1] += gu * gy;
      acc[2] += gu;
      acc[3] += gv * gx;
      acc[4] += gv * gy;
      acc[5] += gv;
    }
  }
  if (grad_lafs == nullptr) return;
  __shared__ float part[kWarps][6];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float x = acc[k];
    for (int off = 16; off > 0; off /= 2)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float tot = 0.0f;
    for (int i = 0; i < kWarps; ++i) tot += part[i][k];
    const bool is_u = k < 3;
    const float su = align_corners ? (is_u ? (wf - 1.0f) / wf
                                           : (hf - 1.0f) / hf)
                                   : 1.0f;
    const float scale = (k % 3 == 2) ? (is_u ? wf : hf) : m;
    grad_lafs[static_cast<size_t>(p) * 6 + k] = su * scale * tot;
  }
}

}  // namespace

// buf: float32 (buf_rows, pitch); lafs: float32 (n, 2, 3); level: int32
// (n,); row_offsets/heights/widths: int32 (n_levels,); lin_host: host array
// of ps base-grid coordinates; g: float32 (n, ps, ps) upstream gradient;
// grad_buf: float32 (buf_rows, pitch), zeroed by the caller, or null to
// skip the buffer cotangent; grad_lafs: float32 (n, 2, 3), or null to skip
// the LAF cotangent.  All device arrays contiguous.
extern "C" int launch_sample_patches_bwd(
    const float* buf, int buf_rows, int pitch, const float* lafs,
    const int* level, const int* row_offsets, const int* heights,
    const int* widths, int n_levels, const float* lin_host, const float* g,
    float* grad_buf, float* grad_lafs, int n, int ps, int align_corners,
    void* stream) {
  if (buf_rows <= 0 || pitch <= 0 || n <= 0 || n_levels <= 0 || ps < 2 ||
      ps > kMaxPs || (grad_buf == nullptr && grad_lafs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BaseGrid grid;
  for (int i = 0; i < ps; ++i) grid.lin[i] = lin_host[i];
  sample_patches_bwd<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, pitch, lafs, level, row_offsets, heights, widths, n_levels, grid,
      g, grad_buf, grad_lafs, ps, align_corners);
  return static_cast<int>(cudaGetLastError());
}
