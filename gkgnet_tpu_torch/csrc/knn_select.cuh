// The k-nearest-neighbour selection helpers of the CUDA-core (fp32)
// kernels of knn_mr.cu and knn_topk.cu: each lane keeps a sorted register
// list of its best (distance, column) pairs (insert), the lanes' lists are
// merged by a warp lexicographic min (lex_less), and a row whose distances
// run out of numbers gets its NaN columns in column order
// (select_nan_columns, which the bf16 tensor-core kernels of knn_scan.cuh
// call too: its test for NaN does not depend on the order of the sum).
//
// Order: ascending (distance, column), the lower column first among equal
// distances. NaN distances come after every number, +inf included, in
// column order: the register lists never take a NaN (every comparison with
// it is false), and a row with fewer numbers than it needs runs out of
// them in the merge; select_nan_columns then walks its columns in order
// for the NaN ones.
//
// The two fp32 kernels' target scans and merges compute the same fp32
// distances in the same order (x_sq - 2 * <x, y> + y_sq (+ bias), products
// summed by fmaf over the channels from a transposed fp32 tile, staged
// whole or, for rows too wide for it, kChunk channels at a time), so
// knn_topk(xn, yn, k*d)[..., ::d] is bitwise knn_mr's idx on the same
// normalized fp32 rows; the bf16 kernels hold the same contract through
// knn_scan.cuh's one scan. chip_smoke.py checks both at every knn_mr shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace knn_select {
// Internal linkage, as each including file's own helpers would have.
namespace {

constexpr int kWarps = 8;          // query rows per block (one warp each)
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;          // target rows per shared-memory tile
constexpr int kTileP = kTile + 1;  // padded stride: conflict-free transpose
constexpr int kChunk = 128;        // channels per staged chunk of the
                                   // chunked scans (rows too wide for a
                                   // whole transposed tile)
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

// Lexicographic (distance, column) order: the lower column wins a tie.
// False whenever a distance is NaN.
__device__ __forceinline__ bool lex_less(float d1, int c1, float d2, int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

// Insert (dv, cv) into the lane's sorted list, dropping its last entry.
// Fully unrolled over constant indices, so the list stays in registers.
template <int KDM>
__device__ __forceinline__ void insert(float (&ld)[KDM], int (&lc)[KDM],
                                       float dv, int cv) {
  if (!lex_less(dv, cv, ld[KDM - 1], lc[KDM - 1])) return;
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    if (lex_less(dv, cv, ld[p], lc[p])) {
      const float td = ld[p];
      const int tc = lc[p];
      ld[p] = dv;
      lc[p] = cv;
      dv = td;
      cv = tc;
    }
  }
}

// The register-list length a k*d takes: the template instantiations.
inline int kdm_bucket(int kd) {
  return kd <= 8 ? 8 : kd <= 16 ? 16 : kd <= 32 ? 32 : kd <= 64 ? 64 : 0;
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
