// Kernel B4: bilinear patch sampler on the row-padded pyramid buffer.
//
// Replaces affnet_tpu/ops/pallas_patches.py:_sampler_kernel (entries
// extract_patches_window_matmul and extract_patches_bucketed).  Plain
// version: affnet_tpu_torch/ops/patches.py
// extract_patches_from_flat_pyramid.  The same kernel is B4-bf16 (bf16
// mode), B5's forward (per-sample tables) and B6's forward (the shape
// optimizer's pyramid table and moving level index).
//
// Patch i samples flat level level[i] (rows [row_off, row_off + h), columns
// [0, w) of the buffer) with torch grid_sample semantics: sample position
// p = min(h, w) * A @ (gx, gy) + (w * tx, h * ty), then u = p - 0.5
// (align_corners=False) or u = p * (w - 1) / w (True); bilinear with
// out-of-level corners contributing zero.  The plain version's float
// operations in its order, each separately rounded (__fmul_rn, __fadd_rn:
// no contraction into FMA), so the two agree bit for bit.  A non-finite
// LAF gives NaN samples in both, and reads only in-level addresses here.
//
// Bound on the H100: bytes in principle (the output, 4 bytes a sample, and
// the touched corners), but a direct gather spends some 45 to 70
// instructions on every sample, so the issue rate is what limits it: the
// design cuts instructions per sample.
//   - Persistent blocks: the grid is sized from the SM count and the
//     occupancy; block b samples patches b, b + G, b + 2G, ...  Each block
//     loads the parameters of up to kChunk of its patches at once, one
//     thread each (the dependent loads level -> level tables -> LAF in
//     parallel), into shared memory, with the per-patch products
//     (min(h, w), w * tx, h * ty) formed there once.
//   - The patch size is a template parameter for 32 and 64: thread t owns
//     column t % PS of the PS * PS / 256 consecutive rows from
//     (t / PS) * PS * PS / 256, so a warp covers 32 consecutive samples of
//     one patch row (coalesced stores; its corner loads fall on few cache
//     lines) and a run a compact 32 x 4 block of the patch.  Its base-grid values sit in
//     registers for the whole kernel, and the column products a00 * gx and
//     a10 * gx are formed once per patch.  Any other size takes a generic
//     instance that walks the samples t, t + 256, ... with the base grid in
//     shared memory, sized from PS.
//   - Runs of kRun samples: a thread computes the coordinates of its run,
//     then issues all the run's corner loads before it uses any of them.
//   - A run whose every sample in the warp has all four corners inside its
//     level (the common case) reads them unclamped from one row pointer;
//     any other run takes the exact masked path: clamped reads, and the
//     in-level masks folded into the weights, which leaves every product
//     and sum the plain version forms bit for bit (see slow_sample).
//   - 32-bit index arithmetic: the launch refuses a buffer of 2^31 elements
//     or more.
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

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;       // samples a thread computes together
constexpr int kChunk = 64;    // patch parameters a block stages at once
constexpr unsigned kFull = 0xffffffffu;

// One patch's sampling parameters, as the plain version forms them.
struct alignas(16) Patch {
  float a00, a01, a10, a11;   // the LAF's 2x2 part
  float m, wtx, hty;          // min(h, w), w * tx, h * ty
  float wf, hf, wm1, hm1;     // w, h, w - 1, h - 1
  int w, h, base;             // level width, height, first element
  unsigned wl, hl;            // max(w - 1, 0), max(h - 1, 0)
  float* out;                 // the patch's first output sample
};

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ Patch load_patch(
    const float* __restrict__ lafs, const int* __restrict__ level,
    const int* __restrict__ row_offsets, const int* __restrict__ heights,
    const int* __restrict__ widths, int n_levels, int pitch, int p,
    float* __restrict__ out, int ps) {
  const int l = min(max(__ldg(level + p), 0), n_levels - 1);
  const float* a = lafs + static_cast<size_t>(p) * 6;
  Patch P;
  P.w = __ldg(widths + l);
  P.h = __ldg(heights + l);
  P.base = __ldg(row_offsets + l) * pitch;
  P.wl = max(P.w - 1, 0);
  P.hl = max(P.h - 1, 0);
  P.a00 = __ldg(a);
  P.a01 = __ldg(a + 1);
  P.a10 = __ldg(a + 3);
  P.a11 = __ldg(a + 4);
  P.wf = static_cast<float>(P.w);
  P.hf = static_cast<float>(P.h);
  P.wm1 = __fsub_rn(P.wf, 1.0f);
  P.hm1 = __fsub_rn(P.hf, 1.0f);
  P.m = fminf(P.hf, P.wf);
  P.wtx = __fmul_rn(P.wf, __ldg(a + 2));
  P.hty = __fmul_rn(P.hf, __ldg(a + 5));
  P.out = out + static_cast<size_t>(p) * ps * ps;
  return P;
}

// Exact masked corners of one sample: clamped reads, and each corner
// weight multiplied by its in-level masks.  The plain version forms
// (v * wgt) * inb with inb = mx * my in {0, 1} and wgt >= +0 (or NaN);
// v * ((wx * mx) * (wy * my)) is the same float for every finite v, the
// zero's sign included, and NaN where the plain one is NaN.
template <bool kBf16>
__device__ __forceinline__ float slow_sample(const Patch& P,
                                             const float* __restrict__ buf,
                                             int pitch, int x0, int y0,
                                             float fx, float fy) {
  // x0 + 1 saturates as the plain version's int64 coordinate clamps.
  const int x1 = x0 + (x0 != INT_MAX), y1 = y0 + (y0 != INT_MAX);
  const float mx0 = static_cast<unsigned>(x0) < static_cast<unsigned>(P.w)
                        ? 1.0f : 0.0f;
  const float mx1 = static_cast<unsigned>(x1) < static_cast<unsigned>(P.w)
                        ? 1.0f : 0.0f;
  const float my0 = static_cast<unsigned>(y0) < static_cast<unsigned>(P.h)
                        ? 1.0f : 0.0f;
  const float my1 = static_cast<unsigned>(y1) < static_cast<unsigned>(P.h)
                        ? 1.0f : 0.0f;
  const int xc0 = max(min(x0, P.w - 1), 0), xc1 = max(min(x1, P.w - 1), 0);
  const float* r0 = buf + (P.base + max(min(y0, P.h - 1), 0) * pitch);
  const float* r1 = buf + (P.base + max(min(y1, P.h - 1), 0) * pitch);
  const float v00 = __ldg(r0 + xc0), v10 = __ldg(r0 + xc1);
  const float v01 = __ldg(r1 + xc0), v11 = __ldg(r1 + xc1);
  const float gx1 = __fsub_rn(1.0f, fx), gy1 = __fsub_rn(1.0f, fy);
  if constexpr (kBf16) {
    const float cx0 = __fmul_rn(to_bf16(gx1), mx0);
    const float cx1 = __fmul_rn(to_bf16(fx), mx1);
    const float row0 =
        __fadd_rn(__fmul_rn(to_bf16(v00), __fmul_rn(cx0, my0)),
                  __fmul_rn(to_bf16(v10), __fmul_rn(cx1, my0)));
    const float row1 =
        __fadd_rn(__fmul_rn(to_bf16(v01), __fmul_rn(cx0, my1)),
                  __fmul_rn(to_bf16(v11), __fmul_rn(cx1, my1)));
    return __fadd_rn(__fmul_rn(gy1, row0), __fmul_rn(fy, row1));
  }
  const float wx0 = __fmul_rn(gx1, mx0), wx1 = __fmul_rn(fx, mx1);
  const float wy0 = __fmul_rn(gy1, my0), wy1 = __fmul_rn(fy, my1);
  float acc = __fmul_rn(v00, __fmul_rn(wx0, wy0));
  acc = __fadd_rn(acc, __fmul_rn(v10, __fmul_rn(wx1, wy0)));
  acc = __fadd_rn(acc, __fmul_rn(v01, __fmul_rn(wx0, wy1)));
  return __fadd_rn(acc, __fmul_rn(v11, __fmul_rn(wx1, wy1)));
}

// One run of kRun samples of patch P: xa/xb are a00 * gx and a10 * gx of
// each sample's column, ya/yb a01 * gy and a11 * gy of its row, off its
// offset in the patch; samples with valid false are computed (at a real
// sample position) but not stored.
template <bool kBf16, bool kAlign>
__device__ __forceinline__ void sample_run(
    const Patch& P, const float* __restrict__ buf, int pitch,
    const float (&xa)[kRun], const float (&xb)[kRun],
    const float (&ya)[kRun], const float (&yb)[kRun],
    const int (&off)[kRun], const bool (&valid)[kRun]) {
  float fx[kRun], fy[kRun];
  int x0[kRun], y0[kRun];
  bool inside = true;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const float xs =
        __fadd_rn(__fmul_rn(P.m, __fadd_rn(xa[k], ya[k])), P.wtx);
    const float ys =
        __fadd_rn(__fmul_rn(P.m, __fadd_rn(xb[k], yb[k])), P.hty);
    float u, v;
    if constexpr (kAlign) {
      u = __fdiv_rn(__fmul_rn(xs, P.wm1), P.wf);
      v = __fdiv_rn(__fmul_rn(ys, P.hm1), P.hf);
    } else {
      u = __fsub_rn(xs, 0.5f);
      v = __fsub_rn(ys, 0.5f);
    }
    const float xf = floorf(u), yf = floorf(v);
    fx[k] = __fsub_rn(u, xf);
    fy[k] = __fsub_rn(v, yf);
    // Saturating conversions (NaN -> 0): every address below stays in the
    // level; a NaN sample still comes out NaN through its weights.
    x0[k] = __float2int_rz(xf);
    y0[k] = __float2int_rz(yf);
    inside = inside && static_cast<unsigned>(x0[k]) < P.wl &&
             static_cast<unsigned>(y0[k]) < P.hl;
  }
  if (__all_sync(kFull, inside)) {
    float c[kRun][4];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float* q = buf + (P.base + y0[k] * pitch + x0[k]);
      c[k][0] = __ldg(q);
      c[k][1] = __ldg(q + 1);
      c[k][2] = __ldg(q + pitch);
      c[k][3] = __ldg(q + pitch + 1);
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float gx1 = __fsub_rn(1.0f, fx[k]), gy1 = __fsub_rn(1.0f, fy[k]);
      float acc;
      if constexpr (kBf16) {
        const float cx0 = to_bf16(gx1), cx1 = to_bf16(fx[k]);
        const float row0 = __fadd_rn(__fmul_rn(to_bf16(c[k][0]), cx0),
                                     __fmul_rn(to_bf16(c[k][1]), cx1));
        const float row1 = __fadd_rn(__fmul_rn(to_bf16(c[k][2]), cx0),
                                     __fmul_rn(to_bf16(c[k][3]), cx1));
        acc = __fadd_rn(__fmul_rn(gy1, row0), __fmul_rn(fy[k], row1));
      } else {
        acc = __fmul_rn(c[k][0], __fmul_rn(gx1, gy1));
        acc = __fadd_rn(acc, __fmul_rn(c[k][1], __fmul_rn(fx[k], gy1)));
        acc = __fadd_rn(acc, __fmul_rn(c[k][2], __fmul_rn(gx1, fy[k])));
        acc = __fadd_rn(acc, __fmul_rn(c[k][3], __fmul_rn(fx[k], fy[k])));
      }
      if (valid[k]) P.out[off[k]] = acc;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float acc =
          slow_sample<kBf16>(P, buf, pitch, x0[k], y0[k], fx[k], fy[k]);
      if (valid[k]) P.out[off[k]] = acc;
    }
  }
}

// kPs = 32 or 64 (a divisor of kThreads no smaller than a warp), or 0 for
// the generic instance (any ps >= 2, base grid in dynamic shared memory).
template <int kPs, bool kBf16, bool kAlign>
__global__ void __launch_bounds__(kThreads, 4)
    sample_patches(const float* __restrict__ buf, int pitch,
                   const float* __restrict__ lafs,
                   const int* __restrict__ level,
                   const int* __restrict__ row_offsets,
                   const int* __restrict__ heights,
                   const int* __restrict__ widths, int n_levels,
                   const float* __restrict__ lin, float* __restrict__ out,
                   int n, int ps) {
  __shared__ Patch prm[kChunk];
  extern __shared__ float lin_s[];
  const int t = threadIdx.x;
  const int G = gridDim.x;
  const int mine = (n - static_cast<int>(blockIdx.x) + G - 1) / G;

  // The thread's fixed samples: templated sizes keep their base-grid
  // values in registers, the generic one walks s = t + kThreads * j.
  constexpr int kPer = kPs > 0 ? kPs * kPs / kThreads : 1;
  float gx = 0.0f, gy[kPer];
  int r0 = 0, c0 = 0, dr = 0, dc = 0, n_runs = 0;
  if constexpr (kPs > 0) {
    c0 = t % kPs;
    r0 = t / kPs;
    gx = __ldg(lin + c0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) gy[k] = __ldg(lin + r0 * kPer + k);
  } else {
    for (int i = t; i < ps; i += kThreads) lin_s[i] = __ldg(lin + i);
    c0 = t % ps;
    r0 = t / ps;
    dc = kThreads % ps;
    dr = kThreads / ps;
    const int per = (ps * ps + kThreads - 1) / kThreads;
    n_runs = (per + kRun - 1) / kRun;
  }

  for (int i0 = 0; i0 < mine; i0 += kChunk) {
    const int cnt = min(kChunk, mine - i0);
    __syncthreads();   // the previous chunk's parameters are read
    if (t < cnt)
      prm[t] = load_patch(lafs, level, row_offsets, heights, widths,
                          n_levels, pitch, blockIdx.x + (i0 + t) * G, out,
                          ps);
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const Patch P = prm[i];
      if constexpr (kPs > 0) {
        const float xa = __fmul_rn(P.a00, gx), xb = __fmul_rn(P.a10, gx);
#pragma unroll
        for (int q = 0; q < kPer / kRun; ++q) {
          float xav[kRun], xbv[kRun], ya[kRun], yb[kRun];
          int off[kRun];
          bool valid[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            const int kk = q * kRun + k;
            xav[k] = xa;
            xbv[k] = xb;
            ya[k] = __fmul_rn(P.a01, gy[kk]);
            yb[k] = __fmul_rn(P.a11, gy[kk]);
            off[k] = (r0 * kPer + kk) * kPs + c0;
            valid[k] = true;
          }
          sample_run<kBf16, kAlign>(P, buf, pitch, xav, xbv, ya, yb, off,
                                    valid);
        }
      } else {
        int r = r0, c = c0;
        for (int q = 0; q < n_runs; ++q) {
          float xav[kRun], xbv[kRun], ya[kRun], yb[kRun];
          int off[kRun];
          bool valid[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            valid[k] = r < ps;
            const float gxs = lin_s[c];
            const float gys = lin_s[valid[k] ? r : ps - 1];
            xav[k] = __fmul_rn(P.a00, gxs);
            xbv[k] = __fmul_rn(P.a10, gxs);
            ya[k] = __fmul_rn(P.a01, gys);
            yb[k] = __fmul_rn(P.a11, gys);
            off[k] = r * ps + c;
            c += dc;
            r += dr;
            if (c >= ps) {
              c -= ps;
              ++r;
            }
          }
          sample_run<kBf16, kAlign>(P, buf, pitch, xav, xbv, ya, yb, off,
                                    valid);
        }
      }
    }
  }
}

using Kernel = void (*)(const float*, int, const float*, const int*,
                        const int*, const int*, const int*, int,
                        const float*, float*, int, int);

template <int kPs>
Kernel pick(bool bf16, bool align) {
  if (bf16)
    return align ? sample_patches<kPs, true, true>
                 : sample_patches<kPs, true, false>;
  return align ? sample_patches<kPs, false, true>
               : sample_patches<kPs, false, false>;
}

}  // namespace

// buf: float32 (buf_rows, pitch) with buf_rows * pitch < 2^31; lafs:
// float32 (n, 2, 3); level: int32 (n,); row_offsets/heights/widths: int32
// (n_levels,); lin: float32 (ps,) base-grid coordinates on the device;
// out: float32 (n, ps, ps); bf16: nonzero selects bf16 mode.  All device
// arrays contiguous.
extern "C" int launch_sample_patches(const float* buf, int buf_rows,
                                     int pitch, const float* lafs,
                                     const int* level, const int* row_offsets,
                                     const int* heights, const int* widths,
                                     int n_levels, const float* lin,
                                     float* out, int n, int ps,
                                     int align_corners, int bf16,
                                     void* stream) {
  if (buf_rows <= 0 || pitch <= 0 || n <= 0 || n_levels <= 0 || ps < 2 ||
      static_cast<long long>(buf_rows) * pitch >= (1LL << 31) ||
      static_cast<long long>(ps) * ps >= (1LL << 31) ||
      ps > 48 * 1024 / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kern = ps == 32   ? pick<32>(bf16, align_corners)
                      : ps == 64 ? pick<64>(bf16, align_corners)
                                 : pick<0>(bf16, align_corners);
  const size_t smem = (ps == 32 || ps == 64) ? 0 : ps * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(max(per_sm, 1)) * sms;
  const int grid = static_cast<int>(resident < n ? resident : n);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      buf, pitch, lafs, level, row_offsets, heights, widths, n_levels, lin,
      out, n, ps);
  return static_cast<int>(cudaGetLastError());
}
