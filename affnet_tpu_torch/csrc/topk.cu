// Kernel B3: per-row top-m, stage 1 of the exact two-stage global top-k.
//
// Replaces affnet_tpu/ops/pallas_topk.py:_row_topm_kernel (entry
// row_topm_pallas).  Plain version: affnet_tpu_torch/ops/cuda_topk.py
// row_topm_flat_plain (row_topm_plain on the vector padded with -1).
//
// The flat contract: the n values are read as rows of 1024, and the
// entries at or after n read as -1.0, as the padded copy held them, so the
// caller makes no copy.  For each row the plain version runs m rounds of
// (row max, the lowest column holding it, mask that column to -1), then
// takes the row max of what is left.  The kernel only compares and moves
// values, so its outputs are the plain version's (inputs free of NaN).
//
// Bound on the H100: bytes.  The 1080p response vector is 8.2M float32
// (33.6 MB read once; 1.1 MB written): about 10 us at 3.35 TB/s.  m serial
// rounds of a 32-step compare chain and a shuffle butterfly cost some 3k
// dependent instructions a row; the design selects in a fixed number of
// passes instead:
//   - One warp per row, lane k holding columns k, k + 32, ..., k + 992 in
//     registers (coalesced loads).
//   - Entries are ordered by (value desc, column asc), under which they
//     are all distinct.  Each lane finds its largest entry; each lane's
//     largest is ranked against the other 31 by shuffles, and the
//     (m+1)-th of them, Q, is a threshold: the m+1 lane maxima at or above
//     it are entries, so the row's first m+1 entries are all at or above Q.
//   - The entries at or above Q (the candidates) are compacted into shared
//     memory by a warp prefix sum of per-lane counts; each
//     candidate's rank among them is its rank in the row.  Ranks below m
//     are the outputs, rank m is the leftover.
//   - That is the plain version's answer when the (m+1)-th entry is above
//     -1 (so the masked -1 entries never return).  A row where it is not
//     (at most m entries above -1), or with more candidates than fit, or
//     m = 32, runs the m rounds themselves (rounds()), exact for any input.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 1024;
constexpr int kPerLane = kRow / 32;
constexpr int kMaxM = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kCap = 64;      // candidates a warp ranks in shared memory
constexpr unsigned kFull = 0xffffffffu;

// Whether entry (av, ac) comes before (bv, bc): value desc, column asc.
__device__ __forceinline__ bool before(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

__device__ __forceinline__ void warp_argmax(float& v, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oc = __shfl_xor_sync(kFull, c, off);
    if (before(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

// The plain version's m rounds on the row held in v (consumed).
__device__ __forceinline__ void rounds(float (&v)[kPerLane], int lane,
                                       int row, int m,
                                       float* __restrict__ vals,
                                       int* __restrict__ cols,
                                       float* __restrict__ leftover) {
  for (int k = 0; k < m; ++k) {
    float best = v[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < kPerLane; ++j)
      if (v[j] > best) {
        best = v[j];
        bj = j;
      }
    int bc = lane + 32 * bj;
    warp_argmax(best, bc);
    if (lane == 0) {
      vals[static_cast<size_t>(row) * m + k] = best;
      cols[static_cast<size_t>(row) * m + k] = bc;
    }
    if ((bc & 31) == lane) {
      const int jj = bc >> 5;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (j == jj) v[j] = -1.0f;
    }
  }
  float rest = v[0];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) rest = fmaxf(rest, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    rest = fmaxf(rest, __shfl_xor_sync(kFull, rest, off));
  if (lane == 0) leftover[row] = rest;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    row_topm(const float* __restrict__ x, int n, float* __restrict__ vals,
             int* __restrict__ cols, float* __restrict__ leftover, int rows,
             int m) {
  __shared__ float2 cand[kWarpsPerBlock][kCap];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + wid;
  if (row >= rows) return;  // whole warps leave together
  const int base = row * kRow;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = base + lane + 32 * j;
    v[j] = i < n ? __ldg(x + i) : -1.0f;
  }

  if (m < 32) {
    // The lane's first entry (the lowest column among equal values).
    float mv = v[0];
    int mj = 0;
#pragma unroll
    for (int j = 1; j < kPerLane; ++j)
      if (v[j] > mv) {
        mv = v[j];
        mj = j;
      }
    const int mc = lane + 32 * mj;
    int rank = 0;
#pragma unroll
    for (int i = 1; i < 32; ++i)
      rank += before(__shfl_xor_sync(kFull, mv, i),
                     __shfl_xor_sync(kFull, mc, i), mv, mc);
    const int src = __ffs(__ballot_sync(kFull, rank == m)) - 1;
    const float qv = __shfl_sync(kFull, mv, src);
    const int qc = __shfl_sync(kFull, mc, src);
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (!before(qv, qc, v[j], lane + 32 * j)) mask |= 1u << j;
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total <= kCap) {
      int pos = incl - cnt;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (mask >> j & 1u)
          cand[wid][pos++] =
              make_float2(v[j], __int_as_float(lane + 32 * j));
      __syncwarp();
      float a[2];
      int ac[2], r[2] = {0, 0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 e = cand[wid][min(lane + 32 * h, total - 1)];
        a[h] = e.x;
        ac[h] = __float_as_int(e.y);
      }
      for (int i = 0; i < total; ++i) {
        const float2 e = cand[wid][i];
        const int ec = __float_as_int(e.y);
#pragma unroll
        for (int h = 0; h < 2; ++h) r[h] += before(e.x, ec, a[h], ac[h]);
      }
      bool mine[2], last = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[h] = lane + 32 * h < total;
        last = last || (mine[h] && r[h] == m && a[h] > -1.0f);
      }
      if (__any_sync(kFull, last)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!mine[h] || r[h] > m) continue;
          if (r[h] == m) {
            leftover[row] = a[h];
          } else {
            vals[static_cast<size_t>(row) * m + r[h]] = a[h];
            cols[static_cast<size_t>(row) * m + r[h]] = ac[h];
          }
        }
        return;
      }
    }
  }
  rounds(v, lane, row, m, vals, cols, leftover);
}

}  // namespace

// x: float32 (n,) contiguous, read as rows of 1024 (entries at or after n
// read as -1); vals: float32 (rows, m); cols: int32 (rows, m); leftover:
// float32 (rows,); rows = ceil(n / 1024).
extern "C" int launch_row_topm(const float* x, int n, float* vals, int* cols,
                               float* leftover, int rows, int m,
                               void* stream) {
  if (n <= 0 || n > INT_MAX - kRow || rows != (n + kRow - 1) / kRow ||
      m < 1 || m > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_topm<<<blocks, 32 * kWarpsPerBlock, 0,
             static_cast<cudaStream_t>(stream)>>>(x, n, vals, cols, leftover,
                                                  rows, m);
  return static_cast<int>(cudaGetLastError());
}
