// Kernel B1: separable Gaussian blur of one pyramid level, replicate edges,
// written straight into its rows of the row-padded level buffer.
//
// Replaces affnet_tpu/ops/pallas_blur.py:_blur_kernel (entry
// gaussian_blur_pallas).  Plain version: affnet_tpu_torch/ops/cuda_blur.py
// blur_level_plain (blur_plain, then the same writes).
//
// One launch per level.  A block owns a 64x32 output tile.  It stages the
// input rows and columns of the tile plus the tap radius in shared memory
// (cp.async: 16-byte copies where the rows are aligned and the tile lies
// inside the image, clamped 4-byte copies elsewhere: replicate edges for
// any radius), runs the horizontal pass into a second shared tile and the
// vertical pass from it, and writes the tile once: nothing goes to device
// memory in between.  For 1 to 31 taps the tap count is a template
// argument: the taps sit in the kernel's parameters (constant-bank
// operands), a thread computes 4 adjacent columns of the horizontal pass
// from one register window (128-bit shared loads) and 8 adjacent rows of
// the vertical pass from another, with all sums interleaved, so a level
// costs few instructions per pixel and a small level's block has short
// dependency chains.  Other tap counts take a generic kernel that reads
// the taps from device memory and walks a radius above kMaxHalo in chunks
// of rows and columns, in increasing order, so every output still sums its
// taps in order and shared memory does not grow with the tap count.  Taps
// are accumulated in order with separately rounded multiplies and adds
// (__fmul_rn/__fadd_rn: no contraction into FMA), the plain version's
// float operations, so the two agree bit for bit.
//
// The launch also does the pyramid's copies: the output goes to a row
// pitch (the buffer's width); columns [w, pad_to) of the output rows, and
// of the input rows when asked, are zeroed (the buffer's padding); and
// with `down` set, the stride-2 point samples of the output (the next
// octave's first level) are written there.
//
// Bound on the H100: bytes.  A 1080x1920 level reads 8.3 MB and writes 8.3
// MB: about 5 us at 3.35 TB/s; the 29 levels of a 1080p image move about
// 104 MB (31 us).

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kTileW;   // 4
constexpr int kRowsPerThread = kTileH / kRowGroups;   // 8
constexpr int kMaxHalo = 32;   // radius staged in one chunk

struct BlurArgs {
  const float* in;
  int in_pitch;
  float* out;
  int out_pitch;
  float* down;       // or null
  int down_pitch;
  float* in_pad;     // == in to zero the input's padding, or null
  int h, w, pad_to;
  const float* taps;   // device, n floats
  int n;
  int ch, cw;          // chunk rows and columns (shared tiles)
  bool vec;            // in and in_pitch allow 16-byte row copies
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Output pixel (y, x): the level, and its stride-2 sample when asked.
__device__ __forceinline__ void store(const BlurArgs& a, int y, int x,
                                      float v) {
  a.out[static_cast<size_t>(y) * a.out_pitch + x] = v;
  if (a.down != nullptr && !(y & 1) && !(x & 1))
    a.down[static_cast<size_t>(y >> 1) * a.down_pitch + (x >> 1)] = v;
}

// The buffer's padding: columns [w, pad_to) of the tile's rows.
__device__ __forceinline__ void zero_padding(const BlurArgs& a, int x0,
                                             int y0) {
  const int x = x0 + static_cast<int>(threadIdx.x) % kTileW;
  if (x < a.w || x >= a.pad_to) return;
  for (int ry = threadIdx.x / kTileW; ry < min(kTileH, a.h - y0);
       ry += kRowGroups) {
    const size_t y = static_cast<size_t>(y0 + ry);
    a.out[y * a.out_pitch + x] = 0.0f;
    if (a.in_pad != nullptr) a.in_pad[y * a.in_pitch + x] = 0.0f;
  }
}

template <int N>
struct FixedTaps {
  float t[N];
};

// N taps known at compile time (radius R <= 15).  Staged columns start R4
// (R rounded up to 4) left of the tile, so 16-byte copies stay aligned.
template <int N>
__global__ void __launch_bounds__(kThreads)
    blur_fixed(BlurArgs a, FixedTaps<N> taps) {
  constexpr int R = N / 2;
  constexpr int R4 = (R + 3) / 4 * 4;
  constexpr int SW = kTileW + 2 * R4;
  constexpr int SH = kTileH + 2 * R;
  constexpr int HV = (R4 - R + N + 3 + 3) / 4;   // float4s a window needs
  // 4 spare columns: the last window's float4s reach past SW (unused).
  __shared__ __align__(16) float sin[SH][SW + 4];
  __shared__ __align__(16) float hacc[SH][kTileW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  if (x0 < a.w) {     // uniform over the block
    if (a.vec && x0 >= R4 && x0 + kTileW + R4 <= a.w) {
      for (int e = tid; e < SH * (SW / 4); e += kThreads) {
        const int i = e / (SW / 4), j = e - i * (SW / 4);
        const int yy = min(max(y0 - R + i, 0), a.h - 1);
        cp_async16(&sin[i][4 * j],
                   a.in + static_cast<size_t>(yy) * a.in_pitch + x0 - R4 +
                       4 * j);
      }
    } else {
      for (int e = tid; e < SH * SW; e += kThreads) {
        const int i = e / SW, j = e - i * SW;
        const int yy = min(max(y0 - R + i, 0), a.h - 1);
        const int xx = min(max(x0 - R4 + j, 0), a.w - 1);
        cp_async4(&sin[i][j],
                  a.in + static_cast<size_t>(yy) * a.in_pitch + xx);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // Horizontal: 4 adjacent columns a thread, from one window.
    for (int e = tid; e < SH * (kTileW / 4); e += kThreads) {
      const int i = e / (kTileW / 4), c0 = 4 * (e - i * (kTileW / 4));
      float v[4 * HV];
#pragma unroll
      for (int m = 0; m < HV; ++m)
        *reinterpret_cast<float4*>(&v[4 * m]) =
            *reinterpret_cast<const float4*>(&sin[i][c0 + 4 * m]);
      float acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = __fmul_rn(taps.t[0], v[R4 - R + q]);
#pragma unroll
      for (int k = 1; k < N; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(taps.t[k], v[R4 - R + q + k]));
      *reinterpret_cast<float4*>(&hacc[i][c0]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    // Vertical: 8 adjacent rows of one column a thread.
    const int xx = tid % kTileW, r0 = (tid / kTileW) * kRowsPerThread;
    float v[kRowsPerThread + N - 1];
#pragma unroll
    for (int m = 0; m < kRowsPerThread + N - 1; ++m) v[m] = hacc[r0 + m][xx];
    float acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      acc[q] = __fmul_rn(taps.t[0], v[q]);
#pragma unroll
    for (int k = 1; k < N; ++k)
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(taps.t[k], v[q + k]));
    const int x = x0 + xx;
    if (x < a.w) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        if (y0 + r0 + q < a.h) store(a, y0 + r0 + q, x, acc[q]);
    }
  }
  zero_padding(a, x0, y0);
}

// Any odd tap count, taps in device memory.
__global__ void __launch_bounds__(kThreads) blur_any(BlurArgs a) {
  extern __shared__ float smem[];
  float* sin = smem;                   // ch x cw input chunk
  float* hacc = smem + a.ch * a.cw;    // ch x kTileW horizontal sums
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;
  const int xx = tid % kTileW;
  const int g = tid / kTileW;
  const int tx_lim = min(kTileW, a.w - x0);
  const int ty_lim = min(kTileH, a.h - y0);

  if (tx_lim > 0) {     // uniform over the block
    const int r = a.n / 2;
    float acc[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.0f;
    // Virtual rows v in [y0 - r, y0 + ty_lim + r) and columns u in
    // [x0 - r, x0 + tx_lim + r); each holds the clamped pixel.
    for (int vc = y0 - r; vc < y0 + ty_lim + r; vc += a.ch) {
      const int nrows = min(a.ch, y0 + ty_lim + r - vc);
      for (int uc = x0 - r; uc < x0 + tx_lim + r; uc += a.cw) {
        const int ncols = min(a.cw, x0 + tx_lim + r - uc);
        __syncthreads();     // the previous chunk's readers are done
        for (int e = tid; e < nrows * a.cw; e += kThreads) {
          const int rr = e / a.cw, cc = e - rr * a.cw;
          if (cc >= ncols) continue;
          const int yy = min(max(vc + rr, 0), a.h - 1);
          const int xc = min(max(uc + cc, 0), a.w - 1);
          cp_async4(sin + e, a.in + static_cast<size_t>(yy) * a.in_pitch + xc);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        // Horizontal pass: the taps of column x whose input column lies in
        // this chunk, in order, continuing the sum of earlier chunks.
        for (int e = tid; e < nrows * kTileW; e += kThreads) {
          const int rr = e / kTileW, c = e - rr * kTileW;
          if (c >= tx_lim) continue;
          const int base = x0 + c - r - uc;    // input column of tap 0
          int i = max(0, -base);
          const int i_end = min(a.n, ncols - base);
          if (i >= i_end) continue;
          const float* s = sin + rr * a.cw + base;
          float v;
          if (i == 0) {
            v = __fmul_rn(__ldg(a.taps), s[0]);
            i = 1;
          } else {
            v = hacc[e];
          }
          for (; i < i_end; ++i)
            v = __fadd_rn(v, __fmul_rn(__ldg(a.taps + i), s[i]));
          hacc[e] = v;
        }
      }
      __syncthreads();
      // Vertical pass over this chunk's rows, taps in order.
      if (xx < tx_lim) {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const int ry = g + kRowGroups * k;
          if (ry >= ty_lim) continue;
          const int base = y0 + ry - r - vc;   // chunk row of tap 0
          int i = max(0, -base);
          const int i_end = min(a.n, nrows - base);
          if (i >= i_end) continue;
          const float* col = hacc + base * kTileW + xx;
          if (i == 0) {
            acc[k] = __fmul_rn(__ldg(a.taps), col[0]);
            i = 1;
          }
          for (; i < i_end; ++i)
            acc[k] = __fadd_rn(acc[k],
                               __fmul_rn(__ldg(a.taps + i), col[i * kTileW]));
        }
      }
    }
    if (xx < tx_lim) {
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int ry = g + kRowGroups * k;
        if (ry < ty_lim) store(a, y0 + ry, x0 + xx, acc[k]);
      }
    }
  }
  zero_padding(a, x0, y0);
}

template <int N>
cudaError_t launch_fixed(const BlurArgs& a, const float* taps_host,
                         dim3 grid, cudaStream_t s) {
  FixedTaps<N> t;
  for (int i = 0; i < N; ++i) t.t[i] = taps_host[i];
  blur_fixed<N><<<grid, kThreads, 0, s>>>(a, t);
  return cudaGetLastError();
}

}  // namespace

// in: float32 (h, w) rows in_pitch apart; out: (h, w) rows out_pitch apart,
// columns [w, pad_to) zeroed (pad_to <= out_pitch; and of in's rows when
// in_pad == in, pad_to <= in_pitch); down: null, or ((h + 1) / 2,
// (w + 1) / 2) rows down_pitch apart, receiving out[::2, ::2]; taps_dev /
// taps_host: the n_taps taps (odd count) in device and in host memory.
extern "C" int launch_blur(const float* in, int in_pitch, float* out,
                           int out_pitch, float* down, int down_pitch,
                           float* in_pad, int h, int w, int pad_to,
                           const float* taps_dev, const float* taps_host,
                           int n_taps, void* stream) {
  if (h <= 0 || w <= 0 || n_taps < 1 || n_taps % 2 == 0 || pad_to < w ||
      in_pitch < w || out_pitch < pad_to ||
      (in_pad != nullptr && in_pitch < pad_to))
    return static_cast<int>(cudaErrorInvalidValue);
  BlurArgs a;
  a.in = in;
  a.in_pitch = in_pitch;
  a.out = out;
  a.out_pitch = out_pitch;
  a.down = down;
  a.down_pitch = down_pitch;
  a.in_pad = in_pad;
  a.h = h;
  a.w = w;
  a.pad_to = pad_to;
  a.taps = taps_dev;
  a.n = n_taps;
  a.vec = in_pitch % 4 == 0 && reinterpret_cast<size_t>(in) % 16 == 0;
  const dim3 grid((pad_to + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_taps) {
    case 1: err = launch_fixed<1>(a, taps_host, grid, s); break;
    case 3: err = launch_fixed<3>(a, taps_host, grid, s); break;
    case 5: err = launch_fixed<5>(a, taps_host, grid, s); break;
    case 7: err = launch_fixed<7>(a, taps_host, grid, s); break;
    case 9: err = launch_fixed<9>(a, taps_host, grid, s); break;
    case 11: err = launch_fixed<11>(a, taps_host, grid, s); break;
    case 13: err = launch_fixed<13>(a, taps_host, grid, s); break;
    case 15: err = launch_fixed<15>(a, taps_host, grid, s); break;
    case 17: err = launch_fixed<17>(a, taps_host, grid, s); break;
    case 19: err = launch_fixed<19>(a, taps_host, grid, s); break;
    case 21: err = launch_fixed<21>(a, taps_host, grid, s); break;
    case 23: err = launch_fixed<23>(a, taps_host, grid, s); break;
    case 25: err = launch_fixed<25>(a, taps_host, grid, s); break;
    case 27: err = launch_fixed<27>(a, taps_host, grid, s); break;
    case 29: err = launch_fixed<29>(a, taps_host, grid, s); break;
    case 31: err = launch_fixed<31>(a, taps_host, grid, s); break;
    default: {
      const int halo = min(n_taps / 2, kMaxHalo);
      a.ch = kTileH + 2 * halo;
      a.cw = kTileW + 2 * halo;
      const size_t smem =
          static_cast<size_t>(a.ch) * (a.cw + kTileW) * sizeof(float);
      if (smem > 48 * 1024) {   // a radius above 20: opt in to more
        err = cudaFuncSetAttribute(
            blur_any, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      blur_any<<<grid, kThreads, smem, s>>>(a);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}
