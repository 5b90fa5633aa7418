// Kernels B5 and B6 backward: the vector-Jacobian product of the bilinear
// patch sampler (csrc/patches.cu) with respect to the LAFs and the buffer.
//
// Replaces the backward of affnet_tpu/ops/pallas_patches.py:
// _batched_sample_diff, _batched_sample_bwd (:702; B5, the training
// rewarp), and of make_pyramid_sampler_diff (:757; B6, shape
// optimization), both the VJP of the XLA flat gather (ops/patches.py
// extract_patches_from_flat_pyramid), not Pallas kernels.  Plain versions:
// autograd of affnet_tpu_torch/ops/patches.py
// extract_patches_from_flat_pyramid; the LAF cotangent in this kernel's
// own order and rounding: ops/patches.py laf_cotangent_replay.
//
// For each output sample with upstream gradient g, sample position (u, v),
// fractions (fx, fy) and masked corner values I00, I10, I01, I11 (zero when
// the corner lies outside the level, or the position is not finite or lies
// beyond 1e9 px):
//   d out / du = (1 - fy)(I10 - I00) + fy (I11 - I01)
//   d out / dv = (1 - fx)(I01 - I00) + fx (I11 - I10)
// (floor has a zero derivative), chained through
//   u = s_u (m (a00 gx + a01 gy) + w tx) [- 0.5],  v likewise with h,
// where s_u = 1, or (w - 1) / w with align_corners.  The sample coordinates
// are the forward's separately rounded operations, so floor() picks the
// forward's corners.  Every operation of the LAF cotangent is separately
// rounded (__fmul_rn, __fadd_rn: no contraction into FMA), in a fixed
// order, so it is the same from run to run and laf_cotangent_replay
// reproduces it bit for bit:
//   - a thread sums its samples' g du, g du gy, g dv, g dv gy in sample
//     order (the templated sizes: its column's rows, top to bottom; their
//     gx is the thread's, so it multiplies the two sums once, at the end;
//     the generic size: s = t, t + 256, ..., with g du gx and g dv gx
//     summed too);
//   - each warp reduces its lanes' six partials with the tree of a
//     shuffle-down reduction (offsets 16, 8, 4, 2, 1; warp_sums);
//   - the patch's eight warp sums are added in warp order, and the sum is
//     scaled by (s_u m), (s_u w), (s_v m) or (s_v h).
// The buffer cotangent scatters g * weight into the four in-level corners
// with atomicAdd (order not reproducible); samples at non-finite positions,
// or beyond 1e9 px, scatter nothing.  It has instances of its own: the
// LAF-only route (the training rewarp and shape optimization ask for
// nothing else) carries no atomics, and its caller zeroes no buffer.
//
// Bound on the H100: bytes in principle (the upstream gradient, 4 bytes a
// sample, the touched corners and 24 bytes a patch), but like the forward
// a direct gather spends tens of instructions on every sample and a patch
// ends in a reduction, so the issue rate and the latency of each patch's
// dependent loads limit it.  The design is the forward's:
//   - Persistent blocks: the grid is sized from the SM count and the
//     occupancy; block b takes patches b, b + G, b + 2G, ...  It loads the
//     parameters of up to kChunk of its patches at once, one thread each
//     (the dependent loads level -> level tables -> LAF in parallel), into
//     shared memory, and writes their warp sums there too; the cotangents
//     of a chunk are finished together after one barrier, so no patch waits
//     on a barrier of its own.
//   - The patch size is a template parameter for 32 and 64: thread t owns
//     column t % PS of the PS * PS / 256 consecutive rows from
//     (t / PS) * PS * PS / 256 (PS / 8 rows at PS 32), so there is no % or
//     / per sample; its base-grid values sit in registers and its column's
//     products a00 * gx and a10 * gx are formed once per patch.  Any other
//     size takes a generic instance that walks the samples t, t + 256, ...
//     with the base grid in shared memory.
//   - Runs of kRun samples: a thread computes the coordinates of its run,
//     then issues the run's upstream gradients and all 16 corner loads
//     before it uses any of them.
//   - A run whose every sample in the warp has all four corners inside its
//     level reads them unclamped from one row pointer; any other run takes
//     the masked path (clamped reads, out-of-level corners selected to 0).
//   - 32-bit index arithmetic: the launch refuses a buffer of 2^31 elements
//     or more.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;       // samples a thread computes together
constexpr int kChunk = 64;    // patches a block stages at once
constexpr int kParts = 6;     // LAF partials of a patch
constexpr unsigned kFull = 0xffffffffu;

// One patch's sampling parameters, as the forward forms them.
struct alignas(16) Patch {
  float a00, a01, a10, a11;   // the LAF's 2x2 part
  float m, wtx, hty;          // min(h, w), w * tx, h * ty
  float wf, hf, wm1, hm1;     // w, h, w - 1, h - 1
  int w, h, base;             // level width, height, first element
  unsigned wl, hl;            // max(w - 1, 0), max(h - 1, 0)
  int p;                      // the patch's index
};

__device__ __forceinline__ Patch load_patch(
    const float* __restrict__ lafs, const int* __restrict__ level,
    const int* __restrict__ row_offsets, const int* __restrict__ heights,
    const int* __restrict__ widths, int n_levels, int pitch, int p) {
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
  P.p = p;
  return P;
}

// The LAF partials a thread carries: g du, g du gy, g dv, g dv gy and, in
// the generic instance, g du gx and g dv gx.
struct Acc {
  float u = 0.0f, uy = 0.0f, v = 0.0f, vy = 0.0f, ux = 0.0f, vx = 0.0f;
};

// One run of kRun samples of patch P: xa/xb are a00 * gx and a10 * gx of
// each sample's column, ya/yb a01 * gy and a11 * gy of its row, gxs/gys
// its base-grid values, off its offset in the patch; samples with valid
// false contribute nothing.
template <bool kAlign, bool kLaf, bool kBuf, bool kGx>
__device__ __forceinline__ void grad_run(
    const Patch& P, const float* __restrict__ buf, int pitch,
    const float* __restrict__ gp, float* __restrict__ grad_buf,
    const float (&xa)[kRun], const float (&xb)[kRun],
    const float (&ya)[kRun], const float (&yb)[kRun],
    const float (&gxs)[kRun], const float (&gys)[kRun],
    const int (&off)[kRun], const bool (&valid)[kRun], Acc& acc) {
  float fx[kRun], fy[kRun], gs[kRun];
  int x0[kRun], y0[kRun];
  bool near[kRun];
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
    // Positions beyond 1e9 px (and NaN) touch no level: they read and
    // scatter nothing, and their integer corners are never formed.
    near[k] = valid[k] && fabsf(u) < 1e9f && fabsf(v) < 1e9f;
    x0[k] = near[k] ? __float2int_rz(xf) : 0;
    y0[k] = near[k] ? __float2int_rz(yf) : 0;
    gs[k] = valid[k] ? __ldg(gp + off[k]) : 0.0f;
    inside = inside && near[k] &&
             static_cast<unsigned>(x0[k]) < P.wl &&
             static_cast<unsigned>(y0[k]) < P.hl;
  }
  // Each corner's element offset (clamped into the level on the masked
  // path), its value (0 outside the level) and whether it is in the level.
  int idx[kRun][4];
  float c[kRun][4];
  bool in[kRun][4];
  if (__all_sync(kFull, inside)) {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int q = P.base + y0[k] * pitch + x0[k];
      idx[k][0] = q;
      idx[k][1] = q + 1;
      idx[k][2] = q + pitch;
      idx[k][3] = q + pitch + 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[k][j] = __ldg(buf + idx[k][j]);
        in[k][j] = true;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int x1 = x0[k] + 1, y1 = y0[k] + 1;
      const bool mx0 = static_cast<unsigned>(x0[k]) <
                       static_cast<unsigned>(P.w);
      const bool mx1 = static_cast<unsigned>(x1) < static_cast<unsigned>(P.w);
      const bool my0 = static_cast<unsigned>(y0[k]) <
                       static_cast<unsigned>(P.h);
      const bool my1 = static_cast<unsigned>(y1) < static_cast<unsigned>(P.h);
      const int xc0 = max(min(x0[k], P.w - 1), 0);
      const int xc1 = max(min(x1, P.w - 1), 0);
      const int q0 = P.base + max(min(y0[k], P.h - 1), 0) * pitch;
      const int q1 = P.base + max(min(y1, P.h - 1), 0) * pitch;
      idx[k][0] = q0 + xc0;
      idx[k][1] = q0 + xc1;
      idx[k][2] = q1 + xc0;
      idx[k][3] = q1 + xc1;
      in[k][0] = near[k] && mx0 && my0;
      in[k][1] = near[k] && mx1 && my0;
      in[k][2] = near[k] && mx0 && my1;
      in[k][3] = near[k] && mx1 && my1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float val = __ldg(buf + idx[k][j]);
        c[k][j] = in[k][j] ? val : 0.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const float gx1 = __fsub_rn(1.0f, fx[k]), gy1 = __fsub_rn(1.0f, fy[k]);
    if constexpr (kLaf) {
      const float du =
          __fadd_rn(__fmul_rn(gy1, __fsub_rn(c[k][1], c[k][0])),
                    __fmul_rn(fy[k], __fsub_rn(c[k][3], c[k][2])));
      const float dv =
          __fadd_rn(__fmul_rn(gx1, __fsub_rn(c[k][2], c[k][0])),
                    __fmul_rn(fx[k], __fsub_rn(c[k][3], c[k][1])));
      // The generic instance's samples past PS * PS add nothing.
      if (valid[k]) {
        const float gu = __fmul_rn(gs[k], du), gv = __fmul_rn(gs[k], dv);
        acc.u = __fadd_rn(acc.u, gu);
        acc.uy = __fadd_rn(acc.uy, __fmul_rn(gu, gys[k]));
        acc.v = __fadd_rn(acc.v, gv);
        acc.vy = __fadd_rn(acc.vy, __fmul_rn(gv, gys[k]));
        if constexpr (kGx) {
          acc.ux = __fadd_rn(acc.ux, __fmul_rn(gu, gxs[k]));
          acc.vx = __fadd_rn(acc.vx, __fmul_rn(gv, gxs[k]));
        }
      }
    }
    if constexpr (kBuf) {
      const float w4[4] = {__fmul_rn(gx1, gy1), __fmul_rn(fx[k], gy1),
                           __fmul_rn(gx1, fy[k]), __fmul_rn(fx[k], fy[k])};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (in[k][j])
          atomicAdd(grad_buf + idx[k][j], __fmul_rn(gs[k], w4[j]));
    }
  }
}

// The warp's tree sums of the lanes' kSlots values: at each level the
// value at lane position i is added to the one at i + off (off = 16, 8,
// 4, 2, 1), the tree of a shuffle-down reduction into lane 0, for every
// slot.  The first three levels halve the slots a lane carries (a lane
// keeps the half its lane bit selects and adds its partner's copy of it),
// so the tree costs 4 + 2 + 1 + 1 + 1 shuffles for all eight slots, not 5
// per slot.  Slot s ends in lane 16 (s / 4) + 8 (s / 2 % 2) + 4 (s % 2),
// which is what this returns for the lane that holds it.
constexpr int kSlots = 8;

__device__ __forceinline__ float warp_sums(const float (&x)[kSlots],
                                           int lane) {
  float v4[4], v2[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi16 ? x[j] : x[4 + j];
    const float keep = hi16 ? x[4 + j] : x[j];
    v4[j] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 16));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi8 ? v4[j] : v4[2 + j];
    const float keep = hi8 ? v4[2 + j] : v4[j];
    v2[j] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 8));
  }
  float v = __fadd_rn(hi4 ? v2[1] : v2[0],
                      __shfl_xor_sync(kFull, hi4 ? v2[0] : v2[1], 4));
  v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
  return __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
}

// kPs = 32 or 64 (a divisor of kThreads no smaller than a warp), or 0 for
// the generic instance (any ps >= 2, base grid in dynamic shared memory).
// kLaf: the LAF cotangent; kBuf: the buffer cotangent.
template <int kPs, bool kAlign, bool kLaf, bool kBuf>
__global__ void __launch_bounds__(kThreads, 4)
    sample_patches_bwd(const float* __restrict__ buf, int pitch,
                       const float* __restrict__ lafs,
                       const int* __restrict__ level,
                       const int* __restrict__ row_offsets,
                       const int* __restrict__ heights,
                       const int* __restrict__ widths, int n_levels,
                       const float* __restrict__ lin,
                       const float* __restrict__ g,
                       float* __restrict__ grad_buf,
                       float* __restrict__ grad_lafs, int n, int ps) {
  __shared__ Patch prm[kChunk];
  __shared__ float part[kLaf ? kChunk : 1][kWarps][kParts];
  extern __shared__ float lin_s[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int G = gridDim.x;
  const int mine = (n - static_cast<int>(blockIdx.x) + G - 1) / G;
  constexpr bool kGx = kPs == 0;

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
    __syncthreads();   // the previous chunk's parameters and sums are read
    if (t < cnt)
      prm[t] = load_patch(lafs, level, row_offsets, heights, widths,
                          n_levels, pitch, blockIdx.x + (i0 + t) * G);
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const Patch P = prm[i];
      const float* gp = g + static_cast<size_t>(P.p) * ps * ps;
      Acc acc;
      if constexpr (kPs > 0) {
        const float xa = __fmul_rn(P.a00, gx), xb = __fmul_rn(P.a10, gx);
#pragma unroll
        for (int q = 0; q < kPer / kRun; ++q) {
          float xav[kRun], xbv[kRun], ya[kRun], yb[kRun], gxs[kRun],
              gys[kRun];
          int off[kRun];
          bool valid[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            const int kk = q * kRun + k;
            xav[k] = xa;
            xbv[k] = xb;
            ya[k] = __fmul_rn(P.a01, gy[kk]);
            yb[k] = __fmul_rn(P.a11, gy[kk]);
            gxs[k] = gx;
            gys[k] = gy[kk];
            off[k] = (r0 * kPer + kk) * kPs + c0;
            valid[k] = true;
          }
          grad_run<kAlign, kLaf, kBuf, kGx>(P, buf, pitch, gp, grad_buf,
                                            xav, xbv, ya, yb, gxs, gys, off,
                                            valid, acc);
        }
      } else {
        int r = r0, c = c0;
        for (int q = 0; q < n_runs; ++q) {
          float xav[kRun], xbv[kRun], ya[kRun], yb[kRun], gxs[kRun],
              gys[kRun];
          int off[kRun];
          bool valid[kRun];
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            valid[k] = r < ps;
            gxs[k] = lin_s[c];
            gys[k] = lin_s[valid[k] ? r : ps - 1];
            xav[k] = __fmul_rn(P.a00, gxs[k]);
            xbv[k] = __fmul_rn(P.a10, gxs[k]);
            ya[k] = __fmul_rn(P.a01, gys[k]);
            yb[k] = __fmul_rn(P.a11, gys[k]);
            off[k] = r * ps + c;
            c += dc;
            r += dr;
            if (c >= ps) {
              c -= ps;
              ++r;
            }
          }
          grad_run<kAlign, kLaf, kBuf, kGx>(P, buf, pitch, gp, grad_buf,
                                            xav, xbv, ya, yb, gxs, gys, off,
                                            valid, acc);
        }
      }
      if constexpr (kLaf) {
        float x[kSlots] = {};
        if constexpr (kGx) {
          x[0] = acc.ux;
          x[3] = acc.vx;
        } else {
          x[0] = __fmul_rn(gx, acc.u);
          x[3] = __fmul_rn(gx, acc.v);
        }
        x[1] = acc.uy;
        x[2] = acc.u;
        x[4] = acc.vy;
        x[5] = acc.v;
        const float sum = warp_sums(x, lane);
        const int slot = (lane >> 4 & 1) * 4 + (lane >> 3 & 1) * 2 +
                         (lane >> 2 & 1);
        if ((lane & 3) == 0 && slot < kParts) part[i][warp][slot] = sum;
      }
    }
    if constexpr (kLaf) {
      __syncthreads();
      for (int e = t; e < cnt * kParts; e += kThreads) {
        const int i = e / kParts, k = e % kParts;
        const Patch& P = prm[i];
        float tot = part[i][0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tot = __fadd_rn(tot, part[i][w][k]);
        const bool is_u = k < 3;
        const float s = kAlign ? (is_u ? __fdiv_rn(P.wm1, P.wf)
                                       : __fdiv_rn(P.hm1, P.hf))
                               : 1.0f;
        const float scale = (k % 3 == 2) ? (is_u ? P.wf : P.hf) : P.m;
        grad_lafs[static_cast<size_t>(P.p) * 6 + k] =
            __fmul_rn(__fmul_rn(s, scale), tot);
      }
    }
  }
}

using Kernel = void (*)(const float*, int, const float*, const int*,
                        const int*, const int*, const int*, int,
                        const float*, const float*, float*, float*, int,
                        int);

template <int kPs, bool kAlign>
Kernel pick_route(bool need_laf, bool need_buf) {
  if (need_laf && need_buf) return sample_patches_bwd<kPs, kAlign, true, true>;
  if (need_laf) return sample_patches_bwd<kPs, kAlign, true, false>;
  return sample_patches_bwd<kPs, kAlign, false, true>;
}

template <int kPs>
Kernel pick(bool align, bool need_laf, bool need_buf) {
  return align ? pick_route<kPs, true>(need_laf, need_buf)
               : pick_route<kPs, false>(need_laf, need_buf);
}

}  // namespace

// buf: float32 (buf_rows, pitch) with buf_rows * pitch < 2^31; lafs:
// float32 (n, 2, 3); level: int32 (n,); row_offsets/heights/widths: int32
// (n_levels,); lin: float32 (ps,) base-grid coordinates on the device; g:
// float32 (n, ps, ps) upstream gradient; grad_buf: float32 (buf_rows,
// pitch), zeroed by the caller, or null to skip the buffer cotangent;
// grad_lafs: float32 (n, 2, 3), or null to skip the LAF cotangent.  All
// device arrays contiguous.
extern "C" int launch_sample_patches_bwd(
    const float* buf, int buf_rows, int pitch, const float* lafs,
    const int* level, const int* row_offsets, const int* heights,
    const int* widths, int n_levels, const float* lin, const float* g,
    float* grad_buf, float* grad_lafs, int n, int ps, int align_corners,
    void* stream) {
  if (buf_rows <= 0 || pitch <= 0 || n <= 0 || n_levels <= 0 || ps < 2 ||
      static_cast<long long>(buf_rows) * pitch >= (1LL << 31) ||
      static_cast<long long>(ps) * ps >= (1LL << 31) ||
      ps > 48 * 1024 / 4 || (grad_buf == nullptr && grad_lafs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool need_laf = grad_lafs != nullptr;
  const bool need_buf = grad_buf != nullptr;
  const Kernel kern =
      ps == 32   ? pick<32>(align_corners, need_laf, need_buf)
      : ps == 64 ? pick<64>(align_corners, need_laf, need_buf)
                 : pick<0>(align_corners, need_laf, need_buf);
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
      g, grad_buf, grad_lafs, n, ps);
  return static_cast<int>(cudaGetLastError());
}
