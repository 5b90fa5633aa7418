// Kernel B7: one k x k convolution layer of the flat eval stack, on the
// flat layout, with the bias and the activation fused.  B7-bf16 is its
// bf16 mode, on the tensor cores.
//
// Replaces affnet_tpu/ops/pallas_conv.py:_conv_kernel (entry conv_flat)
// together with the caller-side crop and subsample of JAX's flat stack
// (affnet_tpu/models/cnn.py _onehot_first, _downsample2_onehot).  Plain
// version: affnet_tpu_torch/ops/conv_flat.py conv_layer_plain.
//
// Contract (the layer's own work): x is (C, N*H*W) with the layer's real C,
// channels in rows, every pixel of every H x W patch in columns; out is
// (O, N*Ho*Wo) with Ho = (H + 2*pad - k)/stride + 1 (Wo likewise).  Output
// pixel (i, j) reads input pixel (i*stride + r - pad, j*stride + s - pad) of
// the same patch, or zero outside it.  Eval BatchNorm is folded into the
// weights by the caller; bias and activation (0 none, 1 relu, 2 tanh, 3 elu)
// are applied in float32.  Only the kept outputs are computed and written.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): float32 is bound by
// operations at every 3x3 layer with C >= 16 (67 TFLOP/s outside the tensor
// cores; 9*C*O FMAs per output pixel against (C + O) * 4 bytes) and by
// bytes at the 1-channel aff1 (its 16 outputs a pixel); bf16 is bound by
// bytes at every layer (989 TFLOP/s on the tensor cores against 3.35
// TB/s).  Both are persistent: one block per slot the card can hold, each
// walking patch groups blockIdx.x, + gridDim.x, ...
//
// float32 (B7): a register-tiled direct convolution on the CUDA cores, with
// float32 FMAs (no TF32, as the TPU kernel's Precision.HIGHEST).  A block
// owns a group of whole patches (pb of them) and ob outputs (ob = O unless
// the tile would exceed 512 threads).  Each thread owns 8 consecutive output
// pixels of one output row and 8 outputs: 64 sums in registers.  The input
// goes through shared memory in chunks of channels, double-buffered across
// chunks and groups: cp.async copies the next stage (16-, 8- or 4-byte
// pieces) while the FMAs of this one run.  A stage holds every patch's
// rows with a zero halo (pad rows above and below, a 4-column margin on
// the left so the copies stay 16-byte aligned, zeros on the right), so
// zero padding costs nothing in the inner loop.  Per (channel, tap row) a
// thread reads one window of its input row as float4s into registers
// (13-28 floats; the stride is in the addressing) and each tap's 8 weights
// as two float4s, then does 8 x 8 FMAs per tap.  Outputs are written as
// float4s where the row allows.
//
// bf16 (B7-bf16): the same block tiling (groups of whole patches, ob
// outputs) as an implicit GEMM on mma.sync.m16n8k16 (bf16 operands,
// float32 sums): M = output pixels, N = outputs, K = taps x channels.  The
// block stages every channel of a group into shared memory, transposed to
// pixel-major rows of Cp = C rounded up to 16 channels plus 8 (48, 80,
// 144 ... bytes a pixel: an odd number of 16-byte units, so the eight rows
// of an ldmatrix hit distinct banks at stride 1), with a zero halo.
// cp.async copies the next group's input as it lies in device memory
// into a copy buffer while the tensor cores work on this one (cp.async
// cannot transpose; the block transposes from the buffer; loads into
// registers instead were not overlapped with the products).  The im2col
// slice of 16 pixels by 16 channels of one tap is then one ldmatrix.x4 of
// 16 pixel rows at that tap's offset; no im2col is written.  A 1-channel
// layer (aff1, TFeat's 7x7) instead pads K = taps to a multiple of 16 with
// zeros and gathers each lane's A fragment from the staged tile through a
// tap table.  The weights, (taps, ob, Cp) bf16 (or (ob, K)), are staged
// once per block and read with ldmatrix.  Each warp takes two m-tiles at a
// time (one at 64 outputs), which share the B fragments, and passes its
// outputs through a small tile in shared memory to write rows of up to 16
// bytes a lane.
//
// Precision: float32 mode sums float32 products with FMAs in the order
// channel, tap row, tap column.  bf16 mode: the products of bf16 values
// are exact; the tensor core sums each k16 step's 16 products into the
// float32 accumulator with its own alignment and rounding, not as a chain
// of float32 adds.  Measured on the H100 at the flagship's shapes
// (chip_smoke.py phase 10, outputs before the activation against the
// float64 sum of the same bf16 products rounded to bf16): B7-bf16 differs
// from that in 0.002%-0.03% of the outputs, a float32 chain (the plain
// version) in 0.004%-0.009%, both at values near cancellation; the
// tolerance of one bf16 ulp of the value plus 1e-5 of the largest
// magnitude covers both.  The result is rounded to bf16 once, after bias
// and activation.
//
// Limits: C >= 1, O a multiple of 8, kh = kw in {3, 7} with pad 0 or
// (k - 1) / 2, stride 1 or 2; float32: Ho * ceil(Wo / 8) <= 512 and one
// channel of a patch within the 110 KB shared-memory budget per stage;
// bf16: one patch's staged channels plus 8 outputs' weights within 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;
constexpr int kBudget = 110 * 1024;   // per block, so two blocks share an SM
constexpr int kMaxThreads = 512;
constexpr int kPx = 8;                // output pixels per thread (float32)
constexpr int kMaxChunk = 8;          // input channels per stage (float32)
constexpr int kMargin = 4;            // left margin columns (float32)
constexpr int kWarps = 8;             // warps per block (bf16)
constexpr int kRawElems = 16384;      // input elements a group stages (bf16)

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) return tanhf(y);
  if (act == 3) return y > 0.0f ? y : expm1f(y);
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// float32: register-tiled direct convolution (B7)
// ---------------------------------------------------------------------------

struct F32Plan {
  int pb, ob, seg, hs, ws, cc, vec, threads;
  size_t smem;
};

// float4s of a thread's input window: input columns x0*S - P + [0, span)
// with span = 7*S + K, read from the aligned smem column x0*S (the margin
// is kMargin columns).
template <int K, int S, int P>
struct Window {
  static constexpr int kFloats = kMargin - P + (kPx - 1) * S + K;
  static constexpr int kVec = (kFloats + 3) / 4;
};

template <int K, int S, int P>
__global__ void __launch_bounds__(kMaxThreads)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                const float* __restrict__ bias, float* __restrict__ out,
                int c, int o_total, int n, int h, int wd, int ho, int wo,
                int act, F32Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int taps = K * K;
  const int n_groups = (n + pl.pb - 1) / pl.pb;
  const int my_groups =
      (n_groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int o0 = blockIdx.y * pl.ob;
  const int plane = pl.hs * pl.ws;
  const int xstage = pl.cc * pl.pb * plane;
  const int wstage = pl.cc * taps * pl.ob;
  float* xs = smem;
  float* ws = smem + 2 * xstage;
  const long long nhw = static_cast<long long>(n) * h * wd;
  const long long howo = static_cast<long long>(ho) * wo;

  for (int i = tid; i < 2 * xstage; i += pl.threads) xs[i] = 0.0f;
  __syncthreads();

  // This thread's tile: output group og (8 outputs), patch p of each of
  // the block's patch groups, output row i, columns sg*8 .. sg*8+7.
  const int per_og = pl.pb * ho * pl.seg;
  const int og = tid / per_og;
  const int rem = tid - og * per_og;
  const int p = rem / (ho * pl.seg);
  const int i = (rem / pl.seg) % ho;
  const int sg = rem % pl.seg;

  // Stage s of this block: chunk s % nq of its patch group s / nq, into
  // buffer s & 1.
  const int nq = (c + pl.cc - 1) / pl.cc;
  const int vec_el = pl.vec / 4;
  const int row_vecs = wd / vec_el;
  auto stage = [&](int s) {
    const int n0 = (blockIdx.x + (s / nq) * gridDim.x) * pl.pb;
    const int npb = min(pl.pb, n - n0);
    const int c0 = (s % nq) * pl.cc;
    const int ncs = min(pl.cc, c - c0);
    float* xb = xs + (s & 1) * xstage;
    const int total = ncs * npb * h * row_vecs;
    for (int e = tid; e < total; e += pl.threads) {
      const int v = e % row_vecs;
      const int row = e / row_vecs;            // (cl, p, y)
      const int y = row % h;
      const int cp = row / h;                  // cl * npb + p
      const int pp = cp % npb;
      const int cl = cp / npb;
      const float* src = x + (c0 + cl) * nhw +
                         static_cast<long long>(n0 + pp) * h * wd +
                         static_cast<long long>(y) * wd + v * vec_el;
      float* dst = xb + ((cl * pl.pb + pp) * pl.hs + y + P) * pl.ws +
                   kMargin + v * vec_el;
      cp_async(dst, src, pl.vec);
    }
    float* wb = ws + (s & 1) * wstage;
    const int ob4 = pl.ob / 4;
    const int wtotal = ncs * taps * ob4;
    for (int e = tid; e < wtotal; e += pl.threads) {
      const int v = e % ob4;
      const int ct = e / ob4;                  // cl * taps + t
      cp_async(wb + ct * pl.ob + 4 * v,
               wgt + (static_cast<long long>(c0) * taps + ct) * o_total +
                   o0 + 4 * v,
               16);
    }
    cp_commit();
  };

  float acc[kPx][8];
#pragma unroll
  for (int a = 0; a < kPx; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;

  const int total_stages = my_groups * nq;
  stage(0);
  for (int s = 0; s < total_stages; ++s) {
    if (s + 1 < total_stages)
      stage(s + 1);
    else
      cp_commit();
    cp_wait_one();
    __syncthreads();
    const int n0 = (blockIdx.x + (s / nq) * gridDim.x) * pl.pb;
    const bool active = p < min(pl.pb, n - n0);
    const int q = s % nq;
    if (active) {
      const int ncs = min(pl.cc, c - q * pl.cc);
      const float* xb = xs + (s & 1) * xstage;
      const float* wb = ws + (s & 1) * wstage + og * 8;
      for (int cl = 0; cl < ncs; ++cl) {
        const float* xrow = xb + ((cl * pl.pb + p) * pl.hs + i * S) * pl.ws +
                            sg * kPx * S;
        // Unrolled, the 7 rows of a 7x7 kernel cost more in registers
        // than they gain (TFeat's layer 18% slower on the H100).
#pragma unroll(K == 7 ? 1 : K)
        for (int r = 0; r < K; ++r) {
          float win[Window<K, S, P>::kVec * 4];
          const float4* src =
              reinterpret_cast<const float4*>(xrow + r * pl.ws);
#pragma unroll
          for (int v = 0; v < Window<K, S, P>::kVec; ++v) {
            const float4 t4 = src[v];
            win[4 * v] = t4.x;
            win[4 * v + 1] = t4.y;
            win[4 * v + 2] = t4.z;
            win[4 * v + 3] = t4.w;
          }
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const float4* wp = reinterpret_cast<const float4*>(
                wb + ((cl * K + r) * K + t) * pl.ob);
            const float4 wa = wp[0], wz = wp[1];
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wz.x, wz.y, wz.z, wz.w};
#pragma unroll
            for (int a = 0; a < kPx; ++a) {
              const float xv = win[kMargin - P + a * S + t];
#pragma unroll
              for (int b = 0; b < 8; ++b)
                acc[a][b] = fmaf(wv[b], xv, acc[a][b]);
            }
          }
        }
      }
    }
    if (q == nq - 1) {
      // The group's last chunk: write its outputs (from registers; the
      // next stage's copy is already in flight) and start new sums.
      if (active) {
        const int j0 = sg * kPx;
        const long long col =
            (n0 + p) * howo + static_cast<long long>(i) * wo + j0;
        const bool vec4 = j0 + kPx <= wo && wo % 4 == 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int oc = o0 + og * 8 + b;
          const float bv = bias[oc];
          float y[kPx];
#pragma unroll
          for (int a = 0; a < kPx; ++a) y[a] = activate(acc[a][b] + bv, act);
          float* dst = out + oc * static_cast<long long>(n) * howo + col;
          if (vec4) {
            reinterpret_cast<float4*>(dst)[0] =
                make_float4(y[0], y[1], y[2], y[3]);
            reinterpret_cast<float4*>(dst)[1] =
                make_float4(y[4], y[5], y[6], y[7]);
          } else {
#pragma unroll
            for (int a = 0; a < kPx; ++a)
              if (j0 + a < wo) dst[a] = y[a];
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kPx; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    }
    __syncthreads();
  }
}

// The number of blocks of ``threads`` threads with ``smem`` bytes that fit
// on the card at once, into *blocks: the persistent grids' size.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            int* blocks) {
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *blocks = max(1, per_sm) * sms;
  return err;
}

template <int K, int S, int P>
int launch_f32(const float* x, const float* w, const float* bias, float* out,
               int c, int o, int n, int h, int wd, int ho, int wo, int act,
               cudaStream_t st) {
  F32Plan pl;
  pl.seg = (wo + kPx - 1) / kPx;
  pl.ob = o;
  while (ho * pl.seg * (pl.ob / 8) > kMaxThreads && pl.ob % 16 == 0)
    pl.ob /= 2;
  const int per_patch = ho * pl.seg * (pl.ob / 8);
  if (per_patch > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  pl.pb = max(1, min(n, 256 / per_patch));
  pl.vec = (wd % 4 == 0) ? 16 : (wd % 2 == 0) ? 8 : 4;
  pl.hs = h + 2 * P;
  const int need = (pl.seg - 1) * kPx * S + 4 * Window<K, S, P>::kVec;
  pl.ws = (max(kMargin + wd + P, need) + 3) & ~3;
  if (pl.ws % 8 == 0) pl.ws += 4;             // rows on alternate banks
  auto smem_for = [&](int pb, int cc) {
    return sizeof(float) * 2 *
           (static_cast<size_t>(cc) * pb * pl.hs * pl.ws +
            static_cast<size_t>(cc) * K * K * pl.ob);
  };
  pl.cc = min(c, kMaxChunk);
  while (pl.cc > 1 && smem_for(pl.pb, pl.cc) > kBudget) --pl.cc;
  while (pl.pb > 1 && smem_for(pl.pb, pl.cc) > kBudget) --pl.pb;
  pl.smem = smem_for(pl.pb, pl.cc);
  if (pl.smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  pl.threads = pl.pb * per_patch;
  auto kernel = conv_f32_kernel<K, S, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = resident_blocks(reinterpret_cast<const void*>(kernel), pl.threads,
                        pl.smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + pl.pb - 1) / pl.pb;
  const int ny = o / pl.ob;
  const dim3 grid(min(groups, max(1, resident / ny)), ny);
  kernel<<<grid, pl.threads, pl.smem, st>>>(x, w, bias, out, c, o, n, h, wd,
                                            ho, wo, act, pl);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores (B7-bf16)
// ---------------------------------------------------------------------------

struct Bf16Plan {
  int pb, ob, hs, ws, cp, kr, taps_eff, ksteps, vec8, ve, raw_stride;
  int x_bytes, w_bytes, tab_bytes, e_bytes;
  size_t smem;
};

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned addr, unsigned& r0,
                                            unsigned& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack2(unsigned short lo,
                                          unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// NT = ob / 8 n-tiles of 8 outputs; K the kernel size (unused by GATHER,
// the 1-channel form: K = taps padded to 16, fragments gathered through
// the tap table); MT m-tiles a warp at a time.  Persistent: block x walks
// patch groups x, x + gridDim.x, ...
template <int NT, int K, bool GATHER>
__global__ void __launch_bounds__(kWarps * 32, 2)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wgt,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int c, int o_total, int n,
                 int h, int wd, int ho, int wo, int k, int stride, int pad,
                 int act, Bf16Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* xt = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* wsm =
      reinterpret_cast<unsigned short*>(smem_raw + pl.x_bytes);
  int* tab = reinterpret_cast<int*>(smem_raw + pl.x_bytes + pl.w_bytes);
  const unsigned short* xg = reinterpret_cast<const unsigned short*>(x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthr = kWarps * 32;
  const int o0 = blockIdx.y * pl.ob;
  const int hw = h * wd;
  const long long nhw = static_cast<long long>(n) * hw;
  constexpr int MT = NT == 8 ? 1 : 2;
  const int taps = k * k;
  const int n_groups = (n + pl.pb - 1) / pl.pb;

  // Zero the input tile once (its halo stays zero; every group overwrites
  // the interior); GATHER a (pb, hs, ws) bf16 tile, else (pb, hs, ws, kr)
  // with the channels of a pixel contiguous.  Stage the weights, rows
  // (tap, output) of kr bf16 (cp or K channels, 8 pad), and the tap table.
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = tid; i < pl.x_bytes / 16; i += nthr)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    const int row16 = (pl.kr - 8) / 8;           // 16-byte pieces of a row
    const int rows = pl.taps_eff * pl.ob;
    for (int e = tid; e < rows * row16; e += nthr) {
      const int v = e % row16;
      const int row = e / row16;
      const int t = row / pl.ob;
      const int oc = row - t * pl.ob;
      const uint4 d = __ldg(reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned short*>(wgt) +
          (static_cast<long long>(t) * o_total + o0 + oc) * (pl.kr - 8) +
          v * 8));
      *reinterpret_cast<uint4*>(wsm + row * pl.kr + v * 8) = d;
    }
    if (GATHER) {
      for (int e = tid; e < pl.ksteps * 16; e += nthr) {
        const int r = e / k;
        tab[e] = e < taps ? r * pl.ws + (e - r * k) : -1;
      }
    }
  }

  // The input of group gi, as it lies in device memory (channel rows of
  // the group's pixels, raw_stride apart), copied with cp.async while the
  // tensor cores work on the previous group (pl.vec8: 16-byte pieces).
  unsigned short* raw = reinterpret_cast<unsigned short*>(
      smem_raw + pl.x_bytes + pl.w_bytes + pl.tab_bytes + pl.e_bytes);
  auto load_group = [&](int gi) {
    const int n0 = gi * pl.pb;
    const int nv = min(pl.pb, n - n0) * hw / 8;
    for (int e = tid; e < c * nv; e += nthr) {
      const int ch = e % c;
      const int v = e / c;
      cp_async(raw + ch * pl.raw_stride + v * 8,
               xg + ch * nhw + static_cast<long long>(n0) * hw + v * 8, 16);
    }
    cp_commit();
  };
  auto put = [&](int u, int ch, unsigned short val) {
    const int pp = u / hw;
    const int rr = u - pp * hw;
    const int yy = rr / wd;
    const int xx = rr - yy * wd;
    const int pix = (pp * pl.hs + yy + pad) * pl.ws + xx + pad;
    xt[GATHER ? pix : pix * pl.kr + ch] = val;
  };
  auto store_group = [&](int gi) {
    const int n0 = gi * pl.pb;
    const int npb = min(pl.pb, n - n0);
    if (pl.vec8) {
      const int nv = npb * hw / 8;
      for (int e = tid; e < c * nv; e += nthr) {
        const int ch = e % c;
        const int v = e / c;
        const uint4 d = *reinterpret_cast<const uint4*>(
            raw + ch * pl.raw_stride + v * 8);
        const unsigned words[4] = {d.x, d.y, d.z, d.w};
        if (wd % 8 == 0) {
          // The 8 pixels lie on one row of one patch.
          const int u = v * 8;
          const int pp = u / hw;
          const int rr = u - pp * hw;
          const int yy = rr / wd;
          const int pix = (pp * pl.hs + yy + pad) * pl.ws + rr - yy * wd +
                          pad;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const unsigned short val = static_cast<unsigned short>(
                (q & 1) ? words[q >> 1] >> 16 : words[q >> 1] & 0xffffu);
            xt[GATHER ? pix + q : (pix + q) * pl.kr + ch] = val;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            put(v * 8 + 2 * q, ch,
                static_cast<unsigned short>(words[q] & 0xffffu));
            put(v * 8 + 2 * q + 1, ch,
                static_cast<unsigned short>(words[q] >> 16));
          }
        }
      }
    } else {
      for (int e = tid; e < c * npb * hw; e += nthr) {
        const int ch = e % c;
        const int u = e / c;
        put(u, ch, xg[ch * nhw + static_cast<long long>(n0) * hw + u]);
      }
    }
  };

  const int howo = ho * wo;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const unsigned xt_addr = smem_addr(xt);
  const unsigned w_addr = smem_addr(wsm);
  const long long out_plane = static_cast<long long>(n) * howo;
  const bool even = (g & 1) == 0;
  // This warp's output tile: NT*8 rows of MT*16 pixels, rows 16-byte
  // aligned and 8 pixels apart in banks.
  constexpr int erow = MT * 16 + 8;
  unsigned short* etile = reinterpret_cast<unsigned short*>(
                              smem_raw + pl.x_bytes + pl.w_bytes +
                              pl.tab_bytes) +
                          warp * NT * 8 * erow;

  int gi = blockIdx.x;
  if (pl.vec8) load_group(gi);
  for (; gi < n_groups; gi += gridDim.x) {
    const int n0 = gi * pl.pb;
    const int npix = min(pl.pb, n - n0) * howo;
    const int mtiles = (npix + 15) / 16;
    const long long col0 = static_cast<long long>(n0) * howo;
    cp_wait_all();
    __syncthreads();          // this group's copy has landed, the previous
                              // group's products are done
    store_group(gi);
    __syncthreads();          // the tile is staged, the copy buffer free
    if (pl.vec8 && gi + static_cast<int>(gridDim.x) < n_groups)
      load_group(gi + gridDim.x);

    // The tile's pixel of output pixel u (top-left tap), or of pixel 0
    // when u lies past the group's outputs.
    auto base_of = [&](int u) {
      if (u >= npix) u = 0;
      const int pp = u / howo;
      const int rr = u - pp * howo;
      const int ii = rr / wo;
      const int jj = rr - ii * wo;
      return (pp * pl.hs + ii * stride) * pl.ws + jj * stride;
    };

    // Each warp takes MT m-tiles at a time; they share the B fragments.
    for (int mt0 = warp * MT; mt0 < mtiles; mt0 += kWarps * MT) {
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int a = 0; a < NT; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[m][a][b] = 0.0f;

      // B fragments of k16 step ``col`` (in elements) of weight rows
      // ``row0`` .. into the products of every m-tile.
      auto products = [&](const unsigned (&af)[MT][4], int row0, int col) {
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          if (NT == 1) {
            unsigned b0, b1;
            const int row = row0 + (lane & 7);
            ldmatrix_x2(w_addr + 2 * (row * pl.kr + col +
                                      ((lane >> 3) & 1) * 8),
                        b0, b1);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              mma_bf16(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3],
                       b0, b1);
          } else {
            unsigned b0, b1, b2, b3;
            const int row =
                row0 + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(w_addr + 2 * (row * pl.kr + col +
                                      ((lane >> 3) & 1) * 8),
                        b0, b1, b2, b3);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(acc[m][nt], af[m][0], af[m][1], af[m][2], af[m][3],
                       b0, b1);
              mma_bf16(acc[m][nt + 1], af[m][0], af[m][1], af[m][2],
                       af[m][3], b2, b3);
            }
          }
        }
      };

      if (GATHER) {
        int b_lo[MT], b_hi[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          b_lo[m] = base_of((mt0 + m) * 16 + g);
          b_hi[m] = base_of((mt0 + m) * 16 + g + 8);
        }
        for (int ks = 0; ks < pl.ksteps; ++ks) {
          const int* tk = tab + ks * 16 + 2 * qd;
          const int t0 = tk[0], t1 = tk[1], t8 = tk[8], t9 = tk[9];
          auto at = [&](int base, int t) -> unsigned short {
            return t < 0 ? static_cast<unsigned short>(0) : xt[base + t];
          };
          unsigned af[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            af[m][0] = pack2(at(b_lo[m], t0), at(b_lo[m], t1));
            af[m][1] = pack2(at(b_hi[m], t0), at(b_hi[m], t1));
            af[m][2] = pack2(at(b_lo[m], t8), at(b_lo[m], t9));
            af[m][3] = pack2(at(b_hi[m], t8), at(b_hi[m], t9));
          }
          products(af, 0, ks * 16);
        }
      } else {
        unsigned arow[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          arow[m] = xt_addr + 2 * (base_of((mt0 + m) * 16 + (lane & 15)) *
                                       pl.kr +
                                   (lane >> 4) * 8);
#pragma unroll 1
        for (int r = 0; r < K; ++r) {
#pragma unroll
          for (int s = 0; s < K; ++s) {
            const unsigned tap_off = 2 * (r * pl.ws + s) * pl.kr;
            for (int ks = 0; ks < pl.ksteps; ++ks) {
              unsigned af[MT][4];
#pragma unroll
              for (int m = 0; m < MT; ++m)
                ldmatrix_x4(arow[m] + tap_off + 32 * ks, af[m][0], af[m][1],
                            af[m][2], af[m][3]);
              products(af, (r * K + s) * pl.ob, ks * 16);
            }
          }
        }
      }

      // Epilogue: lane (g, qd) holds pixels g and g + 8 of an m-tile for
      // outputs 2qd and 2qd + 1 of each n-tile; neighbouring lanes (g ^ 1)
      // swap halves so each holds two neighbouring pixels of one output,
      // stored to the warp's tile (NT*8 outputs x MT*16 pixels), which the
      // warp then writes out in rows of up to 16 bytes a lane.
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int oc = nt * 8 + 2 * qd;
          const float b0 = bias[o0 + oc], b1 = bias[o0 + oc + 1];
          unsigned short hv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            hv[a] = __bfloat16_as_ushort(__float2bfloat16_rn(
                activate(acc[m][nt][a] + ((a & 1) ? b1 : b0), act)));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const unsigned short mine0 = hv[2 * half];      // output oc
            const unsigned short mine1 = hv[2 * half + 1];  // output oc + 1
            // Even g keeps output oc and takes the odd lane's oc; odd g
            // keeps oc + 1 and takes the even lane's oc + 1.
            const unsigned short got = static_cast<unsigned short>(
                __shfl_xor_sync(0xffffffffu,
                                static_cast<unsigned>(even ? mine1 : mine0),
                                4));
            const int px = m * 16 + 8 * half + (g & ~1);
            *reinterpret_cast<unsigned*>(
                etile + (even ? oc : oc + 1) * erow + px) =
                even ? pack2(mine0, got) : pack2(got, mine1);
          }
        }
      }
      __syncwarp();
      const int per_row = MT * 16 / pl.ve;
      for (int e = lane; e < NT * 8 * per_row; e += 32) {
        const int row = e / per_row;
        const int j = (e - row * per_row) * pl.ve;
        const int u = mt0 * 16 + j;
        const unsigned short* src = etile + row * erow + j;
        unsigned short* dst = reinterpret_cast<unsigned short*>(out) +
                              (o0 + row) * out_plane + col0 + u;
        if (u + pl.ve <= npix) {
          if (pl.ve == 8)
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          else if (pl.ve == 4)
            *reinterpret_cast<uint2*>(dst) =
                *reinterpret_cast<const uint2*>(src);
          else if (pl.ve == 2)
            *reinterpret_cast<unsigned*>(dst) =
                *reinterpret_cast<const unsigned*>(src);
          else
            *dst = *src;
        } else {
          for (int q = 0; q < pl.ve && u + q < npix; ++q) dst[q] = src[q];
        }
      }
      __syncwarp();
    }
  }
}

template <int NT, int K, bool GATHER>
int launch_bf16_nt(const void* x, const void* w, const float* bias,
                   void* out, int c, int o, int n, int h, int wd, int ho,
                   int wo, int k, int stride, int pad, int act,
                   const Bf16Plan& pl, cudaStream_t st) {
  auto kernel = conv_bf16_kernel<NT, K, GATHER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = resident_blocks(reinterpret_cast<const void*>(kernel), kWarps * 32,
                        pl.smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + pl.pb - 1) / pl.pb;
  const int ny = o / pl.ob;
  const dim3 grid(min(groups, max(1, resident / ny)), ny);
  kernel<<<grid, kWarps * 32, pl.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), c, o, n, h, wd, ho, wo, k, stride,
      pad, act, pl);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool GATHER>
int launch_bf16_k(const void* x, const void* w, const float* bias, void* out,
                  int c, int o, int n, int h, int wd, int ho, int wo, int k,
                  int stride, int pad, int act, const Bf16Plan& pl,
                  cudaStream_t st) {
  if constexpr (GATHER)
    return launch_bf16_nt<NT, 0, true>(x, w, bias, out, c, o, n, h, wd, ho,
                                       wo, k, stride, pad, act, pl, st);
  if (k == 3)
    return launch_bf16_nt<NT, 3, false>(x, w, bias, out, c, o, n, h, wd, ho,
                                        wo, k, stride, pad, act, pl, st);
  return launch_bf16_nt<NT, 7, false>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, pl, st);
}

template <bool GATHER>
int launch_bf16(const void* x, const void* w, const float* bias, void* out,
                int c, int o, int n, int h, int wd, int ho, int wo, int k,
                int stride, int pad, int act, cudaStream_t st) {
  Bf16Plan pl;
  const int taps = k * k;
  pl.hs = h + 2 * pad;
  pl.ws = wd + 2 * pad;
  pl.cp = GATHER ? 1 : (c + 15) / 16 * 16;
  pl.kr = (GATHER ? (taps + 15) / 16 * 16 : pl.cp) + 8;
  pl.taps_eff = GATHER ? 1 : taps;
  pl.ksteps = GATHER ? (taps + 15) / 16 : pl.cp / 16;
  const int pix_bytes = GATHER ? 2 : 2 * pl.kr;
  const int patch_bytes = pl.hs * pl.ws * pix_bytes;
  pl.tab_bytes = GATHER ? 4 * pl.ksteps * 16 : 0;
  auto w_bytes = [&](int ob) { return pl.taps_eff * ob * pl.kr * 2; };
  pl.ob = 8;
  for (int cand = 64; cand > 8; cand /= 2)
    if (o % cand == 0 && w_bytes(cand) <= kBudget / 2) {
      pl.ob = cand;
      break;
    }
  pl.w_bytes = w_bytes(pl.ob);
  const int howo = ho * wo;
  // The copy buffer holds a group's input, at most kRawElems elements;
  // without 16-byte rows (H*W not a multiple of 8) the group is staged
  // from device memory directly.
  pl.vec8 = (h * wd) % 8 == 0 && c * h * wd <= kRawElems;
  pl.pb = max(1, min(n, (kWarps * 4 * 16 + howo - 1) / howo));
  if (pl.vec8) pl.pb = max(1, min(pl.pb, kRawElems / (c * h * wd)));
  // The warps' output tiles: ob rows of MT*16 + 8 bf16 each.
  pl.e_bytes = kWarps * pl.ob * ((pl.ob == 64 ? 1 : 2) * 16 + 8) * 2;
  // Channel rows of the copy buffer 16 bytes longer than the group's
  // pixels, so the lanes of a 16-byte read hit distinct banks.
  auto raw_bytes = [&](int pb) {
    return pl.vec8 ? c * (pb * h * wd + 8) * 2 : 0;
  };
  while (pl.pb > 1 && pl.pb * patch_bytes + pl.w_bytes + pl.tab_bytes +
                            pl.e_bytes + raw_bytes(pl.pb) > kBudget)
    --pl.pb;
  pl.raw_stride = pl.pb * h * wd + 8;
  pl.x_bytes = (pl.pb * patch_bytes + 15) & ~15;
  pl.ve = howo % 8 == 0 ? 8 : howo % 4 == 0 ? 4 : howo % 2 == 0 ? 2 : 1;
  pl.smem = static_cast<size_t>(pl.x_bytes) + pl.w_bytes + pl.tab_bytes +
            pl.e_bytes + raw_bytes(pl.pb);
  if (pl.smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl.ob) {
    case 64:
      return launch_bf16_k<8, GATHER>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, pl, st);
    case 32:
      return launch_bf16_k<4, GATHER>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, pl, st);
    case 16:
      return launch_bf16_k<2, GATHER>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, pl, st);
    default:
      return launch_bf16_k<1, GATHER>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, pl, st);
  }
}

template <int K, int S>
int launch_f32_pad(const float* x, const float* w, const float* bias,
                   float* out, int c, int o, int n, int h, int wd, int ho,
                   int wo, int pad, int act, cudaStream_t st) {
  if (pad == 0)
    return launch_f32<K, S, 0>(x, w, bias, out, c, o, n, h, wd, ho, wo, act,
                               st);
  return launch_f32<K, S, (K - 1) / 2>(x, w, bias, out, c, o, n, h, wd, ho,
                                       wo, act, st);
}

}  // namespace

// x (c, n * h * wd) float32 or bf16; w packed by the wrapper: float32
// (c, k * k, o); bf16 (k * k, o, Cp) with Cp = c rounded up to 16, or for
// c == 1 (o, K) with K = k * k rounded up to 16; bias (o,) float32; out
// (o, n * ho * wo) like x.  Returns cudaGetLastError().
extern "C" int launch_conv_flat(const void* x, const void* w,
                                const float* bias, void* out, int c, int o,
                                int n, int h, int wd, int k, int stride,
                                int pad, int act, int bf16, void* stream) {
  if (c <= 0 || o <= 0 || o % 8 || n <= 0 || h <= 0 || wd <= 0 ||
      (k != 3 && k != 7) || (pad != 0 && 2 * pad != k - 1) ||
      (stride != 1 && stride != 2) || k > h + 2 * pad ||
      k > wd + 2 * pad || act < 0 || act > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h + 2 * pad - k) / stride + 1;
  const int wo = (wd + 2 * pad - k) / stride + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return c == 1 ? launch_bf16<true>(x, w, bias, out, c, o, n, h, wd, ho,
                                      wo, k, stride, pad, act, st)
                  : launch_bf16<false>(x, w, bias, out, c, o, n, h, wd, ho,
                                       wo, k, stride, pad, act, st);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (k == 3)
    return stride == 1 ? launch_f32_pad<3, 1>(xf, wf, bias, of, c, o, n, h,
                                              wd, ho, wo, pad, act, st)
                       : launch_f32_pad<3, 2>(xf, wf, bias, of, c, o, n, h,
                                              wd, ho, wo, pad, act, st);
  return stride == 1 ? launch_f32_pad<7, 1>(xf, wf, bias, of, c, o, n, h, wd,
                                            ho, wo, pad, act, st)
                     : launch_f32_pad<7, 2>(xf, wf, bias, of, c, o, n, h, wd,
                                            ho, wo, pad, act, st);
}
