// Kernel B7: stride-1 k x k convolution on the flat (C_pad, N*H*W) layout,
// with the bias and the activation fused.
//
// Replaces affnet_tpu/ops/pallas_conv.py:_conv_kernel (entry conv_flat).
// Plain version: affnet_tpu_torch/ops/conv_flat.py conv_flat_plain.
//
// Contract (the TPU kernel's): x is (C_pad, N*H*W), channels in rows, every
// pixel of every H x W patch in columns; out is (O, N*H*W) at the input's
// full extent.  Tap (r, s) of output pixel (y, x) reads input pixel
// (y + r - pad, x + s - pad) of the same patch, or zero outside it (the
// TPU kernel's edge masks).  Eval BatchNorm is folded into the weights by
// the caller; bias and activation (0 none, 1 relu, 2 tanh, 3 elu) are
// applied in float32.  The caller crops VALID convolutions and subsamples
// stride-2 ones.
//
// Design: a direct convolution, no im2col in device memory.  A block owns
// a tile of up to 1024 output pixels (whole rows of the N*H row space, so
// several small patches share a tile) and OB output channels; each of its
// 256 threads owns up to 4 pixels and keeps their OB sums in registers.
// The input channels go through shared memory 8 at a time: the tile's rows
// with a (kh - 1)-row and (kw - 1)-column halo (columns outside the patch
// are stored as zeros; rows are masked per pixel by the patch's own row
// index, since the rows around a tile edge belong to a neighbouring
// patch), and the weights of those 8 channels for the block's OB outputs.
// The TPU kernel's rolled lane axis, tap groups and VMEM blocks are a
// TPU layout choice and have no counterpart here.
//
// Precision: float32 products summed in float32 (fused multiply-adds, in
// the order channel, tap row, tap column).  bf16 mode (B7-bf16): x and out
// are bf16, the weights are bf16 values held in float32 (rounded by the
// wrapper), so every product is exact and the sums are float32, as in the
// TPU kernel with compute_dtype=bf16; the result is rounded to bf16 once.
//
// Bound on the H100: operations.  AffNetFast's six layers over 3000 32x32
// patches are 106 GFLOP at full extent (1.6 ms at the float32 peak of
// 67 TFLOP/s) against 1.5 GB read and written (0.45 ms at 3.35 TB/s).
// This kernel uses the CUDA cores only; a wgmma/TMA version is later work.
//
// Limits: C_pad a multiple of 8, O a multiple of 8, kh <= 32, W <= 1024,
// and the shared tile (8 x (rows + kh - 1) x (W + kw - 1) floats plus
// 8 x kh x kw x OB weights) within 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                       // pixels per thread
constexpr int kTilePixels = kThreads * kPix;  // pixels per block
constexpr int kChunk = 8;                     // input channels per stage
constexpr int kMaxKh = 32;                    // row-mask bits
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) return tanhf(y);
  if (act == 3) return y > 0.0f ? y : expm1f(y);
  return y;
}

// Floats of the x tile, rounded up so the weights after it are 16-byte
// aligned for float4 reads.
__host__ __device__ __forceinline__ int x_tile_floats(int tile_rows, int kh,
                                                      int wd, int kw) {
  return (kChunk * (tile_rows + kh - 1) * (wd + kw - 1) + 3) & ~3;
}

// x: (c_pad, g_rows * wd); w: (c_pad, kh * kw, o_total) float32; bias:
// (o_total,); out: (o_total, g_rows * wd).  g_rows = N * h rows of width
// wd.  Block (bx, by): rows [bx * tile_rows, ...) and outputs
// [by * OB, by * OB + OB).
template <typename T, int OB>
__global__ void __launch_bounds__(kThreads)
conv_flat_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int c_pad, int o_total, int g_rows, int h, int wd, int kh,
                 int kw, int pad, int act, int tile_rows) {
  extern __shared__ float smem[];
  const int sr = tile_rows + kh - 1;
  const int sc = wd + kw - 1;
  const int taps = kh * kw;
  float* xs = smem;                                   // [kChunk][sr][sc]
  float* ws = smem + x_tile_floats(tile_rows, kh, wd, kw);
                                                      // [kChunk][taps][OB]
  const int r0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, g_rows - r0);
  const int npix = rows * wd;
  const int o0 = blockIdx.y * OB;
  const long long plane = static_cast<long long>(g_rows) * wd;

  // Each pixel's tile row and column, and which tap rows stay inside its
  // patch.
  int ty[kPix], tx[kPix];
  unsigned rmask[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int pix = threadIdx.x + j * kThreads;
    ty[j] = 0;
    tx[j] = 0;
    rmask[j] = 0u;
    if (pix < npix) {
      ty[j] = pix / wd;
      tx[j] = pix - ty[j] * wd;
      const int y = (r0 + ty[j]) % h;
      for (int r = 0; r < kh; ++r) {
        const int yy = y + r - pad;
        if (yy >= 0 && yy < h) rmask[j] |= 1u << r;
      }
    }
  }

  float acc[kPix][OB];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int o = 0; o < OB; ++o) acc[j][o] = 0.0f;

  const int tile_n = kChunk * sr * sc;
  const int w_n = kChunk * taps * OB;
  for (int c0 = 0; c0 < c_pad; c0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile_n; i += kThreads) {
      const int c = i / (sr * sc);
      const int rem = i - c * sr * sc;
      const int rr = rem / sc;
      const int col = rem - rr * sc - pad;
      const int gr = r0 - pad + rr;
      float v = 0.0f;
      if (gr >= 0 && gr < g_rows && col >= 0 && col < wd)
        v = load_x(x + (c0 + c) * plane + static_cast<long long>(gr) * wd +
                   col);
      xs[i] = v;
    }
    for (int i = threadIdx.x; i < w_n; i += kThreads) {
      const int o = i % OB;
      const int ct = i / OB;                          // c * taps + t
      ws[i] = w[static_cast<long long>(c0 * taps + ct) * o_total + o0 + o];
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const float* xc = xs + c * sr * sc;
      for (int r = 0; r < kh; ++r) {
        for (int s = 0; s < kw; ++s) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((c * kh + r) * kw + s) * OB);
          float wv[OB];
#pragma unroll
          for (int q = 0; q < OB / 4; ++q) {
            const float4 t4 = wp[q];
            wv[4 * q] = t4.x;
            wv[4 * q + 1] = t4.y;
            wv[4 * q + 2] = t4.z;
            wv[4 * q + 3] = t4.w;
          }
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            float xv = xc[(ty[j] + r) * sc + tx[j] + s];
            xv = ((rmask[j] >> r) & 1u) ? xv : 0.0f;
#pragma unroll
            for (int o = 0; o < OB; ++o) acc[j][o] = fmaf(wv[o], xv, acc[j][o]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int pix = threadIdx.x + j * kThreads;
    if (pix >= npix) continue;
    const long long col = static_cast<long long>(r0) * wd + pix;
#pragma unroll
    for (int o = 0; o < OB; ++o) {
      const float y = activate(acc[j][o] + bias[o0 + o], act);
      store_y(out + (o0 + o) * plane + col, y);
    }
  }
}

template <typename T, int OB>
int launch(const void* x, const float* w, const float* bias, void* out,
           int c_pad, int o, int g_rows, int h, int wd, int kh, int kw,
           int pad, int act, cudaStream_t st) {
  const int tile_rows = kTilePixels / wd;
  const size_t smem =
      sizeof(float) * (x_tile_floats(tile_rows, kh, wd, kw) +
                       static_cast<size_t>(kChunk) * kh * kw * OB);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_flat_kernel<T, OB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g_rows + tile_rows - 1) / tile_rows, o / OB);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), c_pad, o,
      g_rows, h, wd, kh, kw, pad, act, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (c_pad, g_rows * wd) float32 or bf16; w (c_pad, kh * kw, o) float32;
// bias (o,) float32; out like x with o rows.  Returns cudaGetLastError().
extern "C" int launch_conv_flat(const void* x, const float* w,
                                const float* bias, void* out, int c_pad,
                                int o, int g_rows, int h, int wd, int kh,
                                int kw, int pad, int act, int bf16,
                                void* stream) {
  if (c_pad <= 0 || c_pad % kChunk || o <= 0 || o % 8 || g_rows <= 0 ||
      h <= 0 || wd <= 0 || wd > kTilePixels || g_rows % h || kh <= 0 ||
      kh > kMaxKh || kw <= 0 || pad < 0 || pad >= kh || pad >= kw ||
      act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ob16 = o % 16 == 0;
  if (bf16)
    return ob16 ? launch<__nv_bfloat16, 16>(x, w, bias, out, c_pad, o,
                                            g_rows, h, wd, kh, kw, pad, act,
                                            st)
                : launch<__nv_bfloat16, 8>(x, w, bias, out, c_pad, o,
                                           g_rows, h, wd, kh, kw, pad, act,
                                           st);
  return ob16 ? launch<float, 16>(x, w, bias, out, c_pad, o, g_rows, h, wd,
                                  kh, kw, pad, act, st)
              : launch<float, 8>(x, w, bias, out, c_pad, o, g_rows, h, wd,
                                 kh, kw, pad, act, st);
}
