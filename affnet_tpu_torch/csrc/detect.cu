// Kernel B2: the detection stage of one image, split over three kernels so
// that no full map is written unless something reads it.
//
// Replaces affnet_tpu/ops/pallas_detect.py:_detect_octave_kernel (entry
// detect_octave_fused) together with its caller's border mask and octave
// dedup map (affnet_tpu/detector.py:183-195).  Plain versions:
// affnet_tpu_torch/ops/cuda_detect.py stencil_plain, dedup_plain,
// refine_plain.
//
// 1. detect_stencil, one launch per octave.  Responses r_l = max(|gxx * gyy
//    - gxy^2| * sigma_l^4 - th, 0) with replicate (clamped) neighbours; for
//    each center level the 3x3x3 NMS (cur where cur - max(cube) + 1e-5 > 0,
//    out-of-image neighbours take no part), times the border mask (width
//    `border`), written straight into the level's slice of the detector's
//    flat response vector.  A block owns a 32x32 tile: it stages each level
//    with a 2-pixel halo in shared memory (cp.async, 16-byte copies inside
//    the image, in a ring of three: two levels load while one is computed),
//    computes a thread's 4 rows of a column from a register window of 6
//    level rows, and keeps a rolling window of three response tiles with a
//    1-pixel halo, so shared memory does not grow with the level count.  In the same pass it counts
//    what the octave dedup needs: for center k and each set K of earlier
//    centers, the pixels whose response is > 0 and that no center of K
//    claims (response >= 1).  Counts saturate at 2: 2^(L-2) - 1 counters an
//    octave, summed in shared memory and added to device memory once a
//    block.
// 2. detect_dedup, one launch per image.  Each octave's keep flags follow
//    from its counters (a level with <= 1 unclaimed survivor is dropped);
//    then each pixel runs update_octave_map's float sequence over the
//    centers (masked = nmsed * (1 - map) * keep; map = floor(map + masked)
//    > 0) and writes back the entries it changes.
// 3. detect_refine, one launch per image, on the kept indices only: the
//    soft-argmax (sigma, y, x) over the zero-padded 3x3x3 response cube
//    with the reference's biased [-0.5, 0.5, 1.5] grid, normalized by
//    (min(h, w), h, w) through their float32 reciprocals, recomputed from
//    the 5x5 neighbourhood of the three levels in the level buffer: nine
//    threads a point, one per row of its cube, then one sums in order.
// Every float operation is the plain chain's, in its order and separately
// rounded (__fadd_rn/__fmul_rn/__fdiv_rn), so responses, survivor sets and
// (sigma, y, x) agree bit for bit.  The counters assume finite responses
// (a response of inf or NaN would take the torch chain's map elsewhere).
//
// Bound on the H100: bytes.  Octave 0 at 1080x1920 reads 5 levels (41.5
// MB) and writes 3 response planes (24.9 MB): about 20 us at 3.35 TB/s,
// about 27 us for the 7 octaves; the dedup reads the 33 MB response vector.
// The old kernel wrote 12 full maps an octave (41.5 + 99.5 MB, 42 us).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kTileW * kThreadsY;
constexpr int kRowsPerThread = kTileH / kThreadsY;   // 4 contiguous rows
constexpr int kLvW = kTileW + 8;      // 4 columns each side: 16-byte copies
constexpr int kLvH = kTileH + 4;
constexpr int kRsW = kTileW + 2;
constexpr int kRsH = kTileH + 2;
constexpr int kMaxCenters = 20;        // 2^20 - 1 counters an octave
constexpr int kSmemCounters = 4095;    // reduced in shared memory up to 12 centers
constexpr int kMaxOctaves = 32;

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

// max(|det-Hessian| * s4 - th, 0) from the 3x3 neighbourhood v (replicate
// edges already applied), in the plain version's order.
__device__ __forceinline__ float hessian_response(const float (&v)[3][3],
                                                  float s4, float th) {
  const float two_c = __fmul_rn(2.0f, v[1][1]);
  const float gxx = __fadd_rn(__fsub_rn(v[1][0], two_c), v[1][2]);
  const float gyy = __fadd_rn(__fsub_rn(v[0][1], two_c), v[2][1]);
  const float gx0 = __fmul_rn(0.5f, __fsub_rn(v[0][0], v[0][2]));
  const float gx2 = __fmul_rn(0.5f, __fsub_rn(v[2][0], v[2][2]));
  const float gxy = __fmul_rn(0.5f, __fsub_rn(gx0, gx2));
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  return fmaxf(__fsub_rn(__fmul_rn(fabsf(det), s4), th), 0.0f);
}

// *g = min(*g + v, 2), atomically.
__device__ __forceinline__ void add_saturating(int* g, int v) {
  int old = *reinterpret_cast<volatile int*>(g);
  while (old < 2) {
    const int prev = atomicCAS(g, old, min(old + v, 2));
    if (prev == old) break;
    old = prev;
  }
}

struct StencilArgs {
  const float* levels;   // level l at levels + l * level_stride
  int level_stride, pitch, h, w, n_levels;
  float sigma4[kMaxCenters + 2];
  float th;
  int border;
  float* resp;       // (n_levels - 2, h, w), contiguous
  int* counters;     // 2^(n_levels - 2) - 1, zeroed by the caller
  bool vec;          // levels, level_stride and pitch allow 16-byte copies
};

__global__ void __launch_bounds__(kThreads, 5)
    detect_stencil(StencilArgs a) {
  __shared__ __align__(16) float lv[3][kLvH][kLvW];
  __shared__ float rs[3][kRsH][kRsW];
  extern __shared__ int s_cnt[];
  const int n_centers = a.n_levels - 2;
  const int n_cnt = (1 << n_centers) - 1;
  const bool in_smem = n_cnt <= kSmemCounters;
  int* cnt = in_smem ? s_cnt : a.counters;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  if (in_smem)
    for (int i = tid; i < n_cnt; i += kThreads) s_cnt[i] = 0;

  // Level l's rows y0 - 2 .. y0 + 33 and columns x0 - 4 .. x0 + 35
  // (clamped) into ring slot l % 3; 16-byte copies inside the image.
  const bool vec = a.vec && x0 >= 4 && x0 + kTileW + 4 <= a.w;
  auto stage = [&](int l) {
    const float* lev = a.levels + static_cast<size_t>(l) * a.level_stride;
    float(*dst)[kLvW] = lv[l % 3];
    if (vec) {
      for (int e = tid; e < kLvH * (kLvW / 4); e += kThreads) {
        const int i = e / (kLvW / 4), j = e - i * (kLvW / 4);
        const int yy = min(max(y0 - 2 + i, 0), a.h - 1);
        cp_async16(&dst[i][4 * j],
                   lev + static_cast<size_t>(yy) * a.pitch + x0 - 4 + 4 * j);
      }
    } else {
      for (int e = tid; e < kLvH * kLvW; e += kThreads) {
        const int i = e / kLvW, j = e - i * kLvW;
        const int yy = min(max(y0 - 2 + i, 0), a.h - 1);
        const int xx = min(max(x0 - 4 + j, 0), a.w - 1);
        cp_async4(&dst[i][j], lev + static_cast<size_t>(yy) * a.pitch + xx);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // The response at tile position (i, j) (image y0 - 1 + i, x0 - 1 + j)
  // from its level's slot: the 3x3 around level tile (i + 1, j + 3).
  auto halo_response = [&](int l, int i, int j) {
    const int yy = y0 - 1 + i, xx = x0 - 1 + j;
    if (yy < 0 || yy >= a.h || xx < 0 || xx >= a.w) return -CUDART_INF_F;
    float v[3][3];
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) v[di][dj] = lv[l % 3][i + di][j + 2 + dj];
    return hessian_response(v, a.sigma4[l], a.th);
  };

  stage(0);
  stage(1);
  const int x = x0 + tx;
  const int ry0 = ty * kRowsPerThread;      // first output row in the tile
  unsigned claims[kRowsPerThread];          // bit k: center k's response >= 1
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) claims[q] = 0u;

  for (int l = 0; l < a.n_levels; ++l) {
    if (l + 2 < a.n_levels) {
      stage(l + 2);
      asm volatile("cp.async.wait_group 2;\n" ::);
    } else if (l + 1 < a.n_levels) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    // Level l's responses over the tile and its 1-pixel halo; -inf outside
    // the image, where NMS takes no neighbour.  The tile's own 4 rows of a
    // column a thread, from a register window of 6 level rows; the halo
    // ring (132 positions) one a thread.
    {
      const float(*src)[kLvW] = lv[l % 3];
      const float s4 = a.sigma4[l];
      float w[kRowsPerThread + 2][3];
#pragma unroll
      for (int m = 0; m < kRowsPerThread + 2; ++m)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) w[m][dj] = src[ry0 + 1 + m][tx + 3 + dj];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        float v[3][3];
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) v[di][dj] = w[q + di][dj];
        const bool inside = y0 + ry0 + q < a.h && x < a.w;
        rs[l % 3][ry0 + q + 1][tx + 1] =
            inside ? hessian_response(v, s4, a.th) : -CUDART_INF_F;
      }
      if (tid < 2 * kRsW + 2 * kTileH) {
        int i, j;
        if (tid < 2 * kRsW) {
          i = tid < kRsW ? 0 : kRsH - 1;
          j = tid % kRsW;
        } else {
          i = 1 + (tid - 2 * kRsW) / 2;
          j = (tid & 1) ? kRsW - 1 : 0;
        }
        rs[l % 3][i][j] = halo_response(l, i, j);
      }
    }
    __syncthreads();
    if (l < 2) continue;

    // Center level l - 1 (center index k): 3x3 max of the three levels'
    // max, a row of three at a time for this thread's column.
    const int k = l - 2;
    const float(*lo)[kRsW] = rs[(l - 2) % 3];
    const float(*cur)[kRsW] = rs[(l - 1) % 3];
    const float(*hi)[kRsW] = rs[l % 3];
    float hm[kRowsPerThread + 2];
#pragma unroll
    for (int q = 0; q < kRowsPerThread + 2; ++q) {
      const int i = ry0 + q;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        m = fmaxf(m, fmaxf(fmaxf(lo[i][tx + dj], cur[i][tx + dj]),
                           hi[i][tx + dj]));
      hm[q] = m;
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int y = y0 + ry0 + q;
      if (y >= a.h || x >= a.w) continue;
      const float mp = fmaxf(fmaxf(hm[q], hm[q + 1]), hm[q + 2]);
      const float c = cur[ry0 + q + 1][tx + 1];
      float nm = __fadd_rn(__fsub_rn(c, mp), 1e-5f) > 0.0f ? c : 0.0f;
      if (y < a.border || y >= a.h - a.border || x < a.border ||
          x >= a.w - a.border)
        nm = 0.0f;
      a.resp[(static_cast<size_t>(k) * a.h + y) * a.w + x] = nm;
      if (nm > 0.0f) {
        // Every set K of earlier centers that claims none of this pixel.
        const unsigned free = ~claims[q] & ((1u << k) - 1u);
        int* base = cnt + (1 << k) - 1;
        for (unsigned K = free;; K = (K - 1u) & free) {
          if (in_smem)
            atomicAdd(base + K, 1);
          else
            add_saturating(base + K, 1);
          if (K == 0u) break;
        }
      }
      if (nm >= 1.0f) claims[q] |= 1u << k;
    }
  }
  if (in_smem) {
    __syncthreads();
    for (int i = tid; i < n_cnt; i += kThreads)
      if (s_cnt[i] > 0) add_saturating(a.counters + i, s_cnt[i]);
  }
}

struct DedupArgs {
  long long px0[kMaxOctaves + 1];   // first pixel of each octave
  long long resp0[kMaxOctaves];     // its first entry in the response vector
  int n_oct, n_centers, n_cnt;
  float* resp;
  const int* counters;              // n_oct x n_cnt
};

__global__ void detect_dedup(DedupArgs a) {
  const long long total = a.px0[a.n_oct];
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < total; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    int o = 0;
    while (a.px0[o + 1] <= p) ++o;
    const long long hw = a.px0[o + 1] - a.px0[o];
    const int* cnt = a.counters + static_cast<size_t>(o) * a.n_cnt;
    float* rp = a.resp + a.resp0[o] + (p - a.px0[o]);
    unsigned kept = 0u;
    float map = 0.0f;
    for (int k = 0; k < a.n_centers; ++k, rp += hw) {
      const bool keep = __ldg(cnt + (1 << k) - 1 + kept) >= 2;
      if (keep) kept |= 1u << k;
      const float nm = *rp;
      float masked = __fmul_rn(nm, __fsub_rn(1.0f, map));
      masked = __fmul_rn(masked, keep ? 1.0f : 0.0f);
      if (__float_as_uint(masked) != __float_as_uint(nm)) *rp = masked;
      map = floorf(__fadd_rn(map, masked)) > 0.0f ? 1.0f : 0.0f;
    }
  }
}

struct RefineArgs {
  const float* buf;
  int pitch;
  const long long* idx;       // (n,) indices into the response vector
  int n;
  const long long* det_off;   // (n_det,) first entry of each center level
  const long long* ext_level;  // (n_det,) flat index of its level below
  int n_det;
  const int* row_off;         // per flat level
  const int* heights;
  const int* widths;
  const float* sigma;
  const float* sigma4;
  float th;
  float* out;                 // (n, 3): sigma, y, x normalized
};

constexpr int kRefinePoints = 32;     // points a block
constexpr int kRefineThreads = 9 * kRefinePoints;

// Nine threads a point, one per (level k, row dy) of its 3x3x3 cube: each
// computes that row's three responses (zero outside the image) from a 3x5
// window of its level and the row's terms of the soft-argmax (rsum and the
// x numerator's term); one thread then sums them in the plain order.
__global__ void __launch_bounds__(kRefineThreads)
    detect_refine(RefineArgs a) {
  __shared__ float rsum_s[kRefinePoints][9], sx_s[kRefinePoints][9];
  __shared__ int lf_s[kRefinePoints], y_s[kRefinePoints], x_s[kRefinePoints];
  const int pt = threadIdx.x / 9, part = threadIdx.x % 9;
  const int t = blockIdx.x * kRefinePoints + pt;
  const int k = part / 3, dy = part % 3;
  if (t < a.n) {
    const long long idx = a.idx[t];
    int lo = 0, hi = a.n_det - 1;       // the last det_off <= idx
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (a.det_off[mid] <= idx) lo = mid; else hi = mid - 1;
    }
    const int lf = static_cast<int>(a.ext_level[lo]);
    const int h = a.heights[lf], w = a.widths[lf];
    const long long pix = idx - a.det_off[lo];
    const int y = static_cast<int>(pix / w);
    const int x = static_cast<int>(pix - static_cast<long long>(y) * w);
    if (part == 0) {
      lf_s[pt] = lf;
      y_s[pt] = y;
      x_s[pt] = x;
    }
    const float* lev =
        a.buf + static_cast<size_t>(a.row_off[lf + k]) * a.pitch;
    const int yy = y + dy - 1;
    float win[3][5];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int ry = min(max(yy + i - 1, 0), h - 1);
        const int rx = min(max(x + j - 2, 0), w - 1);
        win[i][j] = __ldg(lev + static_cast<size_t>(ry) * a.pitch + rx);
      }
    float c[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = x + dx - 1;
      float v[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[i][j] = win[i][dx + j];
      c[dx] = yy >= 0 && yy < h && xx >= 0 && xx < w
                  ? hessian_response(v, a.sigma4[lf + k], a.th)
                  : 0.0f;
    }
    rsum_s[pt][part] = __fadd_rn(__fadd_rn(c[0], c[1]), c[2]);
    sx_s[pt][part] = __fadd_rn(__fadd_rn(__fmul_rn(-0.5f, c[0]),
                                         __fmul_rn(0.5f, c[1])),
                               __fmul_rn(1.5f, c[2]));
  }
  __syncthreads();
  if (t >= a.n || part != 0) return;
  const int lf = lf_s[pt], y = y_s[pt], x = x_s[pt];
  const int h = a.heights[lf], w = a.widths[lf];
  float den = 0.0f, num_z = 0.0f, num_y = 0.0f, num_x = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    float s = 0.0f, sy = 0.0f, sx = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float rsum = rsum_s[pt][3 * kk + d];
      s = __fadd_rn(s, rsum);
      sy = __fadd_rn(sy, __fmul_rn(static_cast<float>(d) - 0.5f, rsum));
      sx = __fadd_rn(sx, sx_s[pt][3 * kk + d]);
    }
    den = __fadd_rn(den, s);
    num_z = __fadd_rn(num_z, __fmul_rn(a.sigma[lf + kk], s));
    num_y = __fadd_rn(num_y, sy);
    num_x = __fadd_rn(num_x, sx);
  }
  den = __fadd_rn(den, 1e-8f);
  const float sc = __fdiv_rn(num_z, den);
  const float yv = __fadd_rn(__fdiv_rn(num_y, den), static_cast<float>(y));
  const float xv = __fadd_rn(__fdiv_rn(num_x, den), static_cast<float>(x));
  // Normalized by multiplying with float32 reciprocals, as the plain chain.
  a.out[3 * t] = __fmul_rn(sc, __fdiv_rn(1.0f, static_cast<float>(min(h, w))));
  a.out[3 * t + 1] = __fmul_rn(yv, __fdiv_rn(1.0f, static_cast<float>(h)));
  a.out[3 * t + 2] = __fmul_rn(xv, __fdiv_rn(1.0f, static_cast<float>(w)));
}

}  // namespace

// levels: n_levels float32 (h, w) planes level_stride elements apart, rows
// pitch apart; sigma4_host: host array of n_levels floats
// (float32(sigma_l^4)); resp: float32 (n_levels - 2, h, w) contiguous;
// counters: int32 (2^(n_levels - 2) - 1), zeroed.
extern "C" int launch_detect_stencil(const float* levels, int level_stride,
                                     int pitch, int h, int w, int n_levels,
                                     const float* sigma4_host, float th,
                                     int border, float* resp, int* counters,
                                     void* stream) {
  if (h <= 0 || w <= 0 || n_levels < 3 || n_levels > kMaxCenters + 2 ||
      pitch < w || level_stride < h * pitch)
    return static_cast<int>(cudaErrorInvalidValue);
  StencilArgs a;
  a.levels = levels;
  a.level_stride = level_stride;
  a.pitch = pitch;
  a.h = h;
  a.w = w;
  a.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) a.sigma4[l] = sigma4_host[l];
  a.th = th;
  a.border = border;
  a.resp = resp;
  a.counters = counters;
  a.vec = pitch % 4 == 0 && level_stride % 4 == 0 &&
          reinterpret_cast<size_t>(levels) % 16 == 0;
  const int n_cnt = (1 << (n_levels - 2)) - 1;
  const size_t smem = n_cnt <= kSmemCounters ? n_cnt * sizeof(int) : 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  detect_stencil<<<grid, dim3(kTileW, kThreadsY), smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// resp: the flat response vector; counters: int32 (n_oct, 2^n_centers - 1);
// resp_off_host / hw_host: host arrays of n_oct int64 (each octave's first
// entry in resp, and its h * w).
extern "C" int launch_detect_dedup(float* resp, const int* counters,
                                   const long long* resp_off_host,
                                   const long long* hw_host, int n_oct,
                                   int n_centers, void* stream) {
  if (n_oct < 1 || n_oct > kMaxOctaves || n_centers < 1 ||
      n_centers > kMaxCenters)
    return static_cast<int>(cudaErrorInvalidValue);
  DedupArgs a;
  a.px0[0] = 0;
  for (int o = 0; o < n_oct; ++o) {
    a.px0[o + 1] = a.px0[o] + hw_host[o];
    a.resp0[o] = resp_off_host[o];
  }
  a.n_oct = n_oct;
  a.n_centers = n_centers;
  a.n_cnt = (1 << n_centers) - 1;
  a.resp = resp;
  a.counters = counters;
  const long long blocks = (a.px0[n_oct] + 255) / 256;
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  detect_dedup<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// idx: int64 (n,); det_off, ext_level: int64 (n_det,); row_off, heights,
// widths: int32 per flat level; sigma, sigma4: float32 per flat level; out:
// float32 (n, 3).
extern "C" int launch_detect_refine(const float* buf, int pitch,
                                    const long long* idx, int n,
                                    const long long* det_off,
                                    const long long* ext_level, int n_det,
                                    const int* row_off, const int* heights,
                                    const int* widths, const float* sigma,
                                    const float* sigma4, float th, float* out,
                                    void* stream) {
  if (n <= 0 || n_det <= 0) return static_cast<int>(cudaErrorInvalidValue);
  RefineArgs a;
  a.buf = buf;
  a.pitch = pitch;
  a.idx = idx;
  a.n = n;
  a.det_off = det_off;
  a.ext_level = ext_level;
  a.n_det = n_det;
  a.row_off = row_off;
  a.heights = heights;
  a.widths = widths;
  a.sigma = sigma;
  a.sigma4 = sigma4;
  a.th = th;
  a.out = out;
  detect_refine<<<(n + kRefinePoints - 1) / kRefinePoints, kRefineThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
