// Fused dynamic-graph front half for Hopper (sm_90a): L2-normalize rows,
// squared distances (+ optional bias), top-(k*d) with the lowest column
// first among equal distances, keep every d-th, gather the raw target rows
// and write max_j(y_j - x) -- in one pass over the targets per query row.
//
// Replaces the TPU kernel gkgnet_tpu/ops/pallas/knn_mr.py::knn_mr_fused
// (_fused_forward :864 -> _run_pallas :646, pallas_call at :832; bodies
// _kernel_one_group :144 and _kernel_foldv_one_group :285). The function
// is ported, not the blocks: the TPU's (T, M) VMEM distance scratch, its
// argmin/foldv selectors and its one-hot MXU gather answer TPU limits. Here
// each query row keeps its candidates in registers and the gather is a
// direct indexed load.
//
// What bounds it on this card. At the main path's largest call (stage 1,
// BG=16, N=20736, M=1296, D=40, bf16) the bytes it must move are ~174 MB,
// most of it the 107 MB fp32 bias (0.05 ms at 3.35 TB/s), and the distance
// products are 34 GFLOP (0.035 ms on bf16 tensor cores). This first design
// computes the products on the fp32 CUDA cores from shared memory, so it is
// bound by shared-memory loads and fp32 issue, far above either bound.
// What the design does about the bytes: the grid's fastest axis is the
// batch-group axis, so the blocks that read the same bias rows for
// different groups run together and the bias is served from L2; each block
// reads the target set once for its kWarps query rows.
//
// Design (one warp per query row, kWarps rows per block):
//   1. l2norm_rows: one warp per row of x and of y: fp32 norm of the raw
//      row, divide by max(norm, 1e-12), round to the input type (the
//      contract of gkgnet_tpu/ops/knn.py l2_normalize), then the fp32 sum
//      of squares of the rounded row. Written to scratch the caller owns.
//   2. knn_mr_kernel: the block walks the targets in tiles of kTile rows,
//      staged transposed in shared memory as fp32. Each lane computes the
//      distances of its 2 columns of the tile,
//      x_sq - 2 * dot + y_sq (+ bias), and keeps a sorted register list of
//      its best KDM >= k*d (dist, col) pairs. Then k*d rounds of a warp
//      lexicographic min over the lanes' list heads give the global order;
//      rounds 0, d, 2d, ... are kept. Last, the lanes gather the raw target
//      rows of the kept columns and write max_j(y_j - x) in fp32, rounded
//      once to the input type.
//   The selection helpers (the register lists, their lexicographic order,
//   select_nan_columns) are knn_select.cuh's, shared with knn_topk.cu,
//   whose scan and merge repeat this kernel's arithmetic, so that
//   knn_topk(xn, yn, k*d)[..., ::d] is bitwise this kernel's idx. The scan
//   and merge stay written out here: moved into shared functions they
//   compiled to other code (122 and 178 registers for lists of 32 and 64,
//   not 115 and 171) and a 1 % slower stage-1 call on an H100 80GB HBM3.
//
// NaN distances (a NaN query row, a NaN target row, a NaN bias entry) come
// after every number, +inf included, and among themselves in column order:
// the order of the plain version's torch.sort. The register lists never
// take a NaN (every comparison with it is false), so a row keeps its exact
// order over its numbers at no cost on the hot path. Only a row with fewer
// than k*d numbers runs out of them in the merge: its lists show the empty
// slot, and select_nan_columns then walks the columns in order for the
// NaN ones. (Ordering NaN inside the comparison instead cost 6 % to 45 %
// of the kernel's time at stage 1, by variant, on an H100 80GB HBM3.)
//
// Launch discipline: both kernels run on the caller's stream, allocate
// nothing and do not synchronize; knn_mr_forward returns
// cudaGetLastError() after the launches.

#include "knn_select.cuh"

namespace {

using knn_select::from_f32;
using knn_select::insert;
using knn_select::kdm_bucket;
using knn_select::kFull;
using knn_select::kThreads;
using knn_select::kTile;
using knn_select::kTileP;
using knn_select::kWarps;
using knn_select::lex_less;
using knn_select::select_nan_columns;
using knn_select::to_f32;
using knn_select::warp_sum;

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2norm_rows(const T* __restrict__ x, T* __restrict__ xn,
            float* __restrict__ xsq, long long rows_x,
            const T* __restrict__ y, T* __restrict__ yn,
            float* __restrict__ ysq, long long rows_y, int d) {
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* src;
  T* dst;
  float* sq;
  if (row < rows_x) {
    src = x + row * d;
    dst = xn + row * d;
    sq = xsq + row;
  } else if (row < rows_x + rows_y) {
    const long long r = row - rows_x;
    src = y + r * d;
    dst = yn + r * d;
    sq = ysq + r;
  } else {
    return;  // whole warp: this kernel has no block-wide barrier
  }
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(src[c]);
    ss = fmaf(v, v, ss);
  }
  const float denom = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
  float s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const T r = from_f32<T>(to_f32(src[c]) / denom);
    dst[c] = r;
    const float f = to_f32(r);
    s2 = fmaf(f, f, s2);
  }
  s2 = warp_sum(s2);
  if (lane == 0) *sq = s2;
}

// bias_mode: 0 none, 1 shared (N, M), 2 batched (BG, N, M); fp32.
template <typename T, int KDM>
__global__ void __launch_bounds__(kThreads)
knn_mr_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ xn, const T* __restrict__ yn,
              const float* __restrict__ xsq, const float* __restrict__ ysq,
              const float* __restrict__ bias, int bias_mode,
              int* __restrict__ idx, T* __restrict__ mr,
              int n, int m, int d, int k, int dilation) {
  extern __shared__ float smem[];
  float* ys = smem;                       // [d][kTileP] target tile, fp32
  float* xs = ys + d * kTileP;            // [kWarps][d] normalized queries
  float* ysq_s = xs + kWarps * d;         // [kTile]
  int* sel = reinterpret_cast<int*>(ysq_s + kTile);  // [kWarps][KDM]

  const int bg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  const bool active = row < n;  // warp-uniform
  const long long qrow = (long long)bg * n + (active ? row : 0);
  const T* yn_b = yn + (long long)bg * m * d;
  const float* ysq_b = ysq + (long long)bg * m;

  float* xw = xs + warp * d;
  for (int c = lane; c < d; c += 32) xw[c] = to_f32(xn[qrow * d + c]);
  const float xq = xsq[qrow];
  const float* brow = nullptr;
  if (bias_mode != 0 && active) {
    const long long brow_idx = (bias_mode == 2 ? (long long)bg * n : 0) + row;
    brow = bias + brow_idx * m;
  }

  float ld[KDM];
  int lc[KDM];
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    ld[p] = INFINITY;
    lc[p] = INT_MAX;
  }

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int tw = min(kTile, m - j0);
    __syncthreads();  // the previous tile (and xw on the first pass) done
    const T* src = yn_b + (long long)j0 * d;
    for (int t = threadIdx.x; t < tw * d; t += kThreads) {
      const int jj = t / d;
      const int e = t - jj * d;
      ys[e * kTileP + jj] = to_f32(src[t]);
    }
    for (int t = threadIdx.x; t < tw; t += kThreads) ysq_s[t] = ysq_b[j0 + t];
    __syncthreads();
    if (active) {
      const int c0 = lane;
      const int c1 = lane + 32;
      float acc0 = 0.f;
      float acc1 = 0.f;
#pragma unroll 4
      for (int e = 0; e < d; ++e) {
        const float xv = xw[e];
        acc0 = fmaf(xv, ys[e * kTileP + c0], acc0);
        acc1 = fmaf(xv, ys[e * kTileP + c1], acc1);
      }
      // columns at or past tw read stale shared memory and are dropped here
      if (c0 < tw) {
        float dist = xq - 2.f * acc0 + ysq_s[c0];
        if (brow != nullptr) dist += brow[j0 + c0];
        insert<KDM>(ld, lc, dist, j0 + c0);
      }
      if (c1 < tw) {
        float dist = xq - 2.f * acc1 + ysq_s[c1];
        if (brow != nullptr) dist += brow[j0 + c1];
        insert<KDM>(ld, lc, dist, j0 + c1);
      }
    }
  }
  if (!active) return;  // no block-wide barrier follows

  // Warp merge: k*d rounds of a lexicographic min over the list heads.
  const int kd = k * dilation;
  int* sel_w = sel + warp * KDM;
  for (int r = 0; r < kd; ++r) {
    float bd = ld[0];
    int bc = lc[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, o);
      const int oc = __shfl_xor_sync(kFull, bc, o);
      if (lex_less(od, oc, bd, bc)) {
        bd = od;
        bc = oc;
      }
    }
    if (bc == INT_MAX) {  // warp-uniform: every list is empty
      select_nan_columns<T>(r, kd, dilation, xw, xq, yn_b, ysq_b, brow, m,
                            d, lane, sel_w);
      break;
    }
    if (lc[0] == bc) {  // the owning lane pops its head
#pragma unroll
      for (int p = 0; p < KDM - 1; ++p) {
        ld[p] = ld[p + 1];
        lc[p] = lc[p + 1];
      }
      ld[KDM - 1] = INFINITY;
      lc[KDM - 1] = INT_MAX;
    }
    if (lane == 0 && r % dilation == 0) sel_w[r / dilation] = bc;
  }
  __syncwarp();

  // Gather the raw target rows and take max(y_j - x) in fp32.
  const T* x_row = x + qrow * d;
  const T* y_b = y + (long long)bg * m * d;
  for (int c = lane; c < d; c += 32) {
    const float xv = to_f32(x_row[c]);
    float best = -INFINITY;
    for (int s = 0; s < k; ++s) {
      const float v = to_f32(y_b[(long long)sel_w[s] * d + c]) - xv;
      best = (v > best || v != v) ? v : best;  // NaN propagates, as amax
    }
    mr[qrow * d + c] = from_f32<T>(best);
  }
  for (int s = lane; s < k; s += 32) idx[qrow * k + s] = sel_w[s];
}

size_t main_smem_bytes(int d, int kdm) {
  return sizeof(float) * ((size_t)d * kTileP + (size_t)kWarps * d + kTile) +
         sizeof(int) * (size_t)kWarps * kdm;
}

template <typename T, int KDM>
cudaError_t launch_main(const void* x, const void* y, const void* xn,
                        const void* yn, const void* xsq, const void* ysq,
                        const void* bias, int bias_mode, void* idx, void* mr,
                        int bg, int n, int m, int d, int k, int dilation,
                        cudaStream_t stream) {
  const size_t smem = main_smem_bytes(d, KDM);
  if (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_mr_kernel<T, KDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bg, (n + kWarps - 1) / kWarps);
  knn_mr_kernel<T, KDM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(xn), static_cast<const T*>(yn),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
      static_cast<T*>(mr), n, m, d, k, dilation);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* x, const void* y, const void* bias,
                    void* xn, void* yn, void* xsq, void* ysq, void* idx,
                    void* mr, int bg, int n, int m, int d, int k,
                    int dilation, int bias_mode, int y_is_x,
                    cudaStream_t stream) {
  const long long rows_x = (long long)bg * n;
  const long long rows_y = y_is_x ? 0 : (long long)bg * m;
  const long long blocks = (rows_x + rows_y + kWarps - 1) / kWarps;
  l2norm_rows<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xn),
      static_cast<float*>(xsq), rows_x, static_cast<const T*>(y),
      static_cast<T*>(yn), static_cast<float*>(ysq), rows_y, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* ynp = y_is_x ? xn : yn;
  const void* ysqp = y_is_x ? xsq : ysq;
  switch (kdm_bucket(k * dilation)) {
    case 8:
      return launch_main<T, 8>(x, y, xn, ynp, xsq, ysqp, bias, bias_mode,
                               idx, mr, bg, n, m, d, k, dilation, stream);
    case 16:
      return launch_main<T, 16>(x, y, xn, ynp, xsq, ysqp, bias, bias_mode,
                                idx, mr, bg, n, m, d, k, dilation, stream);
    case 32:
      return launch_main<T, 32>(x, y, xn, ynp, xsq, ysqp, bias, bias_mode,
                                idx, mr, bg, n, m, d, k, dilation, stream);
    case 64:
      return launch_main<T, 64>(x, y, xn, ynp, xsq, ysqp, bias, bias_mode,
                                idx, mr, bg, n, m, d, k, dilation, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (bg, n, d), y (bg, m, d) raw rows of one type (is_bf16: bfloat16, else
// float32), contiguous; bias fp32 per bias_mode; xn/xsq (bg, n, d)/(bg, n)
// and yn/ysq (bg, m, d)/(bg, m) scratch (unused for y when y_is_x);
// outputs idx (bg, n, k) int32 and mr (bg, n, d) of the input type.
// Requires 1 <= k * dilation <= min(m, 64). Returns a cudaError_t code.
int knn_mr_forward(const void* x, const void* y, const void* bias, void* xn,
                   void* yn, void* xsq, void* ysq, void* idx, void* mr,
                   int bg, int n, int m, int d, int k, int dilation,
                   int bias_mode, int is_bf16, int y_is_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg,
                                  n, m, d, k, dilation, bias_mode, y_is_x, s);
  return forward<float>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg, n, m, d,
                        k, dilation, bias_mode, y_is_x, s);
}

// Dynamic shared memory of one main-kernel block at row width d and k*d
// (0 when k*d exceeds 64).
long long knn_mr_smem_bytes(int d, int kd) {
  const int kdm = kdm_bucket(kd);
  return kdm ? (long long)main_smem_bytes(d, kdm) : 0;
}

const char* knn_mr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
