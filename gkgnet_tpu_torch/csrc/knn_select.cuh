// Helpers of the kernels of knn_mr.cu and knn_topk.cu: the one-warp-per-row
// kernels' block (l2norm_rows, row_sq), the type conversions, the warp sum,
// and select_nan_columns, which gives a row whose distances run out of
// numbers its NaN columns in column order. The fp32 scan
// (knn_scan_f32.cuh) and the bf16 one (knn_scan.cuh) call it: its test for
// NaN does not depend on the order of the sum.
//
// Order: ascending (distance, column), the lower column first among equal
// distances. NaN distances come after every number, +inf included, in
// column order: the scans' lists never take a NaN (every comparison with
// it is false), and a row with fewer numbers than it needs runs out of
// them in the merge; select_nan_columns then walks its columns in order
// for the NaN ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace knn_select {
// Internal linkage, as each including file's own helpers would have.
namespace {

constexpr int kWarps = 8;          // rows per block (one warp each)
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The merge found the lists empty at rank r < k*d: the row has r numbers
// among its distances. Ranks r..k*d-1 are its NaN distances in column
// order; find them by computing each column's distance anew, 32 columns at
// a time, exactly as the scan did (the same fp32 products in the same
// order), and keep ranks 0, d, 2d, ... as the merge does.
template <typename T>
__device__ void select_nan_columns(int r, int kd, int dilation,
                                   const float* xw, float xq,
                                   const T* __restrict__ yn_b,
                                   const float* __restrict__ ysq_b,
                                   const float* brow, int m, int d, int lane,
                                   int* sel_w) {
  for (int j0 = 0; j0 < m && r < kd; j0 += 32) {
    const int j = j0 + lane;
    bool is_nan = false;
    if (j < m) {
      float acc = 0.f;
      for (int e = 0; e < d; ++e) {
        acc = fmaf(xw[e], to_f32(yn_b[(long long)j * d + e]), acc);
      }
      float dist = xq - 2.f * acc + ysq_b[j];
      if (brow != nullptr) dist += brow[j];
      is_nan = dist != dist;
    }
    unsigned mask = __ballot_sync(kFull, is_nan);  // warp-uniform
    for (; mask != 0 && r < kd; ++r) {
      const int bit = __ffs(mask) - 1;
      mask &= mask - 1;
      if (lane == 0 && r % dilation == 0) sel_w[r / dilation] = j0 + bit;
    }
  }
}

}  // namespace
}  // namespace knn_select
