// Fused squared-distance + top-k for Hopper (sm_90a): for every query row
// of x the k target rows of y with the smallest x_sq - 2 <x, y> + y_sq
// (+ bias), in ascending (distance, column) order, the lowest column first
// among equal distances, and optionally those distances.
//
// Replaces the TPU kernel gkgnet_tpu/ops/pallas/knn_topk.py::knn_topk
// (pallas_call at :211 with a bias, :223 without; bodies _knn_kernel_* and
// _topk_from_dist :60). The function is ported, not the blocks: the TPU
// kernel holds a (T, M) fp32 distance block in VMEM and takes k rounds of a
// masked argmin over it. Here each query row keeps its candidates in
// registers, so no distance is ever stored.
//
// The rows arrive L2-normalized (knn_graph does it); x_sq and y_sq are the
// fp32 sums of squares of the rows as given. NaN distances come after every
// number, +inf included, in column order, as in the plain version's
// torch.sort (not the TPU kernel's, whose masked argmin loses a row that
// holds a NaN).
//
// Two kernels compute it, one per input type.
//
// bf16 (the Graphers' type): knn_topk_tc_kernel, on knn_scan.cuh's
// tensor-core scan and row-threshold selection, the same scan and
// selection knn_mr.cu's bf16 kernel runs; the header says what bounds it on
// this card (at the slice's largest call, a stage-1 Grapher at batch 8
// without channel groups, BG=8, N=20736, M=1296, D=80, k=9: ~142 MB, most
// of it the 107 MB fp32 bias, 0.04 ms at 3.35 TB/s, and 34 GFLOP, 0.035 ms
// on bf16 tensor cores) and what the design does about it. Each row's
// merge writes its k nearest in order, with their distances, straight to
// idx and vals. Shared memory per block (knn_scan::layout): at D = 640 and
// k = 27, 2 warps' query rows and two 64-row tiles, 216 KB; 1 warp for
// wider rows, and past about 780 bf16 channels the header's D-chunked
// scan, whose staging does not grow with D.
//
// fp32: knn_topk_kernel, the CUDA-core design (one warp per query row,
// kWarps rows per block), as the TPU kernel keeps fp32 at full precision:
//   1. row_sq (both types): one warp per row of x and of y, the fp32 sum of
//      squares in lane-strided fmaf order and a butterfly sum: the
//      arithmetic of knn_mr.cu's l2norm_rows on its rounded rows, so on
//      knn_mr's own normalized rows both kernels see bitwise the same x_sq
//      and y_sq.
//   2. knn_topk_kernel: scan_targets walks the targets in tiles of kTile
//      rows, staged transposed in shared memory as fp32; each lane computes
//      the distances of its 2 columns of the tile and keeps a sorted
//      register list of its best KDM >= k pairs; merge_lists takes k rounds
//      of a warp lexicographic min over the lanes' list heads and writes
//      the row's k nearest in order, with their distances, straight to idx
//      and vals. Both repeat knn_mr.cu's fp32 scan and merge line for line,
//      with dilation 1 (knn_mr.cu says why they are not shared functions).
//      For lists of 8 and 16 the rare NaN tail is a real call (nan_tail,
//      not inlined): on an H100 80GB HBM3 that took the stage-1 Grapher
//      call from 6.95 to 6.51 ms and label 1 from 1.99 to 1.42 ms, while for
//      lists of 32 it made the stage-3 calls 2.8 -> 4.2 ms, so there the
//      tail stays inlined.
//   Shared-memory loads and fp32 issue bound it (one load per fmaf). The
//   target tile is d * 65 fp32 values: at D = 640 a block takes 187 KB of
//   dynamic shared memory (opted in above 48 KB; 227 KB is the card's
//   limit, so D <= 795). Wider rows take scan_targets_chunked, which
//   stages kChunk = 128 channels of the tile at a time (33 KB) beside the
//   warps' whole query rows (32 bytes a channel), so D <= ~6,100. This
//   design computed the bf16 calls too until the tensor-core kernel took
//   them; its fp32 instantiations compile to the code they had then.
//
// Launch discipline: both kernels run on the caller's stream, allocate
// nothing and do not synchronize; knn_topk_forward returns
// cudaGetLastError() after the launches.

#include <type_traits>

#include "knn_scan.cuh"
#include "knn_select.cuh"

namespace {

using knn_select::insert;
using knn_select::kChunk;
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
row_sq(const T* __restrict__ x, float* __restrict__ xsq, long long rows_x,
       const T* __restrict__ y, float* __restrict__ ysq, long long rows_y,
       int d) {
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* src;
  float* sq;
  if (row < rows_x) {
    src = x + row * d;
    sq = xsq + row;
  } else if (row < rows_x + rows_y) {
    const long long r = row - rows_x;
    src = y + r * d;
    sq = ysq + r;
  } else {
    return;  // whole warp: this kernel has no block-wide barrier
  }
  float s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float f = to_f32(src[c]);
    s2 = fmaf(f, f, s2);
  }
  s2 = warp_sum(s2);
  if (lane == 0) *sq = s2;
}

// The block walks the targets of its batch-group in tiles of kTile rows,
// staged transposed in shared memory as fp32; each active warp keeps its
// row's best KDM (distance, column) pairs, per lane, in ld/lc (ascending).
// Every thread of the block calls it: it holds the block's barriers. The
// arithmetic is knn_mr_kernel's scan, line for line.
template <typename T, int KDM>
__device__ __forceinline__ void scan_targets(
    const float* xw, float xq, const T* __restrict__ y_b,
    const float* __restrict__ ysq_b, const float* brow, int m, int d,
    bool active, float* ys, float* ysq_s, int lane, float (&ld)[KDM],
    int (&lc)[KDM]) {
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    ld[p] = INFINITY;
    lc[p] = INT_MAX;
  }
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int tw = min(kTile, m - j0);
    __syncthreads();  // the previous tile (and xw on the first pass) done
    const T* src = y_b + (long long)j0 * d;
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
}

// scan_targets for rows too wide for a whole transposed tile: the tile
// is staged kChunk channels at a time and each lane's two sums carry over
// the chunks, the same fmaf steps in the same order (knn_mr_kernel's
// chunked scan, line for line), so every distance is bitwise
// scan_targets'.
template <typename T, int KDM>
__device__ __forceinline__ void scan_targets_chunked(
    const float* xw, float xq, const T* __restrict__ y_b,
    const float* __restrict__ ysq_b, const float* brow, int m, int d,
    bool active, float* ys, float* ysq_s, int lane, float (&ld)[KDM],
    int (&lc)[KDM]) {
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    ld[p] = INFINITY;
    lc[p] = INT_MAX;
  }
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int tw = min(kTile, m - j0);
    float acc0 = 0.f;
    float acc1 = 0.f;
    for (int e0 = 0; e0 < d; e0 += kChunk) {
      const int w = min(kChunk, d - e0);
      __syncthreads();  // the previous chunk (and xw on the first pass)
      const T* src = y_b + (long long)j0 * d + e0;
      for (int t = threadIdx.x; t < tw * w; t += kThreads) {
        const int jj = t / w;
        const int e = t - jj * w;
        ys[e * kTileP + jj] = to_f32(src[(long long)jj * d + e]);
      }
      if (e0 == 0) {
        for (int t = threadIdx.x; t < tw; t += kThreads) {
          ysq_s[t] = ysq_b[j0 + t];
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int e = 0; e < w; ++e) {
          const float xv = xw[e0 + e];
          acc0 = fmaf(xv, ys[e * kTileP + lane], acc0);
          acc1 = fmaf(xv, ys[e * kTileP + lane + 32], acc1);
        }
      }
    }
    if (active) {  // columns at or past tw are dropped here
      const int c0 = lane;
      const int c1 = lane + 32;
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
}

// The ranks r..k-1 of a row whose distances ran out of numbers: its NaN
// columns in column order, with NaN values.
template <typename T>
__device__ __forceinline__ void nan_tail(int r, int k, const float* xw,
                                         float xq, const T* __restrict__ y_b,
                                         const float* __restrict__ ysq_b,
                                         const float* brow, int m, int d,
                                         int lane, int* idx_w,
                                         float* val_w) {
  select_nan_columns<T>(r, k, 1, xw, xq, y_b, ysq_b, brow, m, d, lane, idx_w);
  if (val_w != nullptr) {
    for (int s = r + lane; s < k; s += 32) val_w[s] = NAN;
  }
}

template <typename T>
__device__ __noinline__ void nan_tail_call(int r, int k, const float* xw,
                                           float xq, const T* y_b,
                                           const float* ysq_b,
                                           const float* brow, int m, int d,
                                           int lane, int* idx_w,
                                           float* val_w) {
  nan_tail<T>(r, k, xw, xq, y_b, ysq_b, brow, m, d, lane, idx_w, val_w);
}

// Warp merge: k rounds of a lexicographic min over the lanes' list heads
// give the row's k nearest in order; lane 0 writes them to idx_w and,
// unless val_w is nullptr, their distances to val_w (NaN for the ranks of
// NaN distances, which nan_tail finds). The arithmetic is
// knn_mr_kernel's merge, line for line, with dilation 1.
template <typename T, int KDM>
__device__ __forceinline__ void merge_lists(
    float (&ld)[KDM], int (&lc)[KDM], int k, const float* xw, float xq,
    const T* __restrict__ y_b, const float* __restrict__ ysq_b,
    const float* brow, int m, int d, int lane, int* idx_w, float* val_w) {
  for (int r = 0; r < k; ++r) {
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
      if constexpr (KDM <= 16) {
        nan_tail_call<T>(r, k, xw, xq, y_b, ysq_b, brow, m, d, lane, idx_w,
                         val_w);
      } else {
        nan_tail<T>(r, k, xw, xq, y_b, ysq_b, brow, m, d, lane, idx_w,
                    val_w);
      }
      return;
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
    if (lane == 0) {
      idx_w[r] = bc;
      if (val_w != nullptr) val_w[r] = bd;
    }
  }
}

// bias_mode: 0 none, 1 shared (N, M), 2 batched (BG, N, M); fp32.
// vals: nullptr, or (BG, N, k) fp32 for the selected distances.
// kChunked: scan_targets_chunked, for rows too wide for a whole tile.
template <typename T, int KDM, bool kChunked = false>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                const float* __restrict__ bias, int bias_mode,
                int* __restrict__ idx, float* __restrict__ vals, int n, int m,
                int d, int k) {
  extern __shared__ float smem[];
  float* ys = smem;                       // [d][kTileP] target tile, fp32
                                          // (chunked: [kChunk][kTileP])
  float* xs = ys + (kChunked ? kChunk : d) * kTileP;  // [kWarps][d] queries
  float* ysq_s = xs + kWarps * d;         // [kTile]

  const int bg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * kWarps + warp;
  const bool active = row < n;  // warp-uniform
  const long long qrow = (long long)bg * n + (active ? row : 0);
  const T* y_b = y + (long long)bg * m * d;
  const float* ysq_b = ysq + (long long)bg * m;

  float* xw = xs + warp * d;
  for (int c = lane; c < d; c += 32) xw[c] = to_f32(x[qrow * d + c]);
  const float xq = xsq[qrow];
  const float* brow = nullptr;
  if (bias_mode != 0 && active) {
    const long long brow_idx = (bias_mode == 2 ? (long long)bg * n : 0) + row;
    brow = bias + brow_idx * m;
  }

  float ld[KDM];
  int lc[KDM];
  if constexpr (kChunked) {
    scan_targets_chunked<T, KDM>(xw, xq, y_b, ysq_b, brow, m, d, active, ys,
                                 ysq_s, lane, ld, lc);
  } else {
    scan_targets<T, KDM>(xw, xq, y_b, ysq_b, brow, m, d, active, ys, ysq_s,
                         lane, ld, lc);
  }
  if (!active) return;  // no block-wide barrier follows
  merge_lists<T, KDM>(ld, lc, k, xw, xq, y_b, ysq_b, brow, m, d, lane,
                      idx + qrow * k,
                      vals != nullptr ? vals + qrow * k : nullptr);
}

size_t main_smem_bytes(int d, bool chunked = false) {
  return sizeof(float) *
         ((size_t)(chunked ? kChunk : d) * kTileP + (size_t)kWarps * d +
          kTile);
}

// Whether the CUDA-core kernel takes the chunked scan: only where the
// whole tile does not fit (or when forced), as knn_mr.cu decides it.
bool main_chunked(int d, bool force_chunked) {
  int dev = 0, optin = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return force_chunked || main_smem_bytes(d) > (size_t)optin;
}

template <typename T, int KDM, bool kChunked = false>
cudaError_t launch_main_as(const void* x, const void* y, const void* xsq,
                           const void* ysq, const void* bias, int bias_mode,
                           void* idx, void* vals, int bg, int n, int m,
                           int d, int k, cudaStream_t stream) {
  const size_t smem = main_smem_bytes(d, kChunked);
  if (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_kernel<T, KDM, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bg, (n + kWarps - 1) / kWarps);
  knn_topk_kernel<T, KDM, kChunked><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
      static_cast<float*>(vals), n, m, d, k);
  return cudaGetLastError();
}

template <typename T, int KDM>
cudaError_t launch_main(const void* x, const void* y, const void* xsq,
                        const void* ysq, const void* bias, int bias_mode,
                        void* idx, void* vals, int bg, int n, int m, int d,
                        int k, cudaStream_t stream, bool force_chunked) {
  if (main_chunked(d, force_chunked)) {
    return launch_main_as<T, KDM, true>(x, y, xsq, ysq, bias, bias_mode, idx,
                                        vals, bg, n, m, d, k, stream);
  }
  return launch_main_as<T, KDM>(x, y, xsq, ysq, bias, bias_mode, idx, vals,
                                bg, n, m, d, k, stream);
}

// The bf16 kernel on knn_scan.cuh's tensor-core scan and row-threshold
// selection (16 query rows per warp, 1-4 warps per block): each row's
// merge writes its k nearest in order, with their distances, straight to
// idx and vals. The arguments are knn_topk_kernel's. kChunked: the
// header's chunked scan, for rows too wide for its whole-row layout.
template <int KDM, bool kChunked = false>
__global__ void __launch_bounds__(knn_scan::kMaxWarps * 32)
knn_topk_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ xsq,
                   const float* __restrict__ ysq,
                   const float* __restrict__ bias, int bias_mode,
                   int* __restrict__ idx, float* __restrict__ vals, int n,
                   int m, int d, int k) {
  using knn_scan::kRows;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int warps = blockDim.x >> 5;
  const knn_scan::Layout lay = knn_scan::layout_for<kChunked>(d, KDM, warps);
  const int bg = blockIdx.x;
  const int row0 = blockIdx.y * warps * kRows;
  const int wrow0 = row0 + (threadIdx.x >> 5) * kRows;
  knn_scan::Rows rows{x + (long long)bg * n * d, xsq + (long long)bg * n,
                      y + (long long)bg * m * d, ysq + (long long)bg * m,
                      bias_mode == 0 ? nullptr
                                     : bias + (bias_mode == 2
                                                   ? (long long)bg * n * m
                                                   : 0LL),
                      n, m, d};
  unsigned lk[KDM];
  int lc[KDM];
  float dsum_a = 0.f, dsum_b = 0.f;  // unused: no distance sums here
  if constexpr (kChunked) {
    knn_scan::scan_chunked<KDM, true, false>(rows, row0, k, smem_tc, lay,
                                             lk, lc, dsum_a, dsum_b);
  } else {
    knn_scan::scan<KDM, true, false>(rows, row0, k, smem_tc, lay, lk,
                                     lc, dsum_a, dsum_b);
  }
  if (wrow0 >= n) return;  // whole warp: no block-wide barrier follows
  const long long first = ((long long)bg * n + wrow0) * k;
  knn_scan::merge_rows<KDM, kChunked>(rows, row0, k, 1, smem_tc, lay, lk, lc,
                                      idx + first, k,
                                      vals != nullptr ? vals + first
                                                      : nullptr);
}

template <int KDM, bool kChunked = false>
cudaError_t launch_tc_as(const knn_scan::Config& cfg, const void* x,
                         const void* y, const void* xsq, const void* ysq,
                         const void* bias, int bias_mode, void* idx,
                         void* vals, int bg, int n, int m, int d, int k,
                         cudaStream_t stream) {
  if (cfg.smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_tc_kernel<KDM, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = cfg.warps * knn_scan::kRows;
  const dim3 grid(bg, (n + rows - 1) / rows);
  knn_topk_tc_kernel<KDM, kChunked>
      <<<grid, cfg.warps * 32, cfg.smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(y),
          static_cast<const float*>(xsq), static_cast<const float*>(ysq),
          static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
          static_cast<float*>(vals), n, m, d, k);
  return cudaGetLastError();
}

template <int KDM>
cudaError_t launch_tc(const void* x, const void* y, const void* xsq,
                      const void* ysq, const void* bias, int bias_mode,
                      void* idx, void* vals, int bg, int n, int m, int d,
                      int k, cudaStream_t stream, bool force_chunked) {
  const knn_scan::Config cfg = knn_scan::config(d, KDM, force_chunked);
  if (cfg.smem == 0) return cudaErrorInvalidValue;
  if (cfg.chunked) {
    return launch_tc_as<KDM, true>(cfg, x, y, xsq, ysq, bias, bias_mode, idx,
                                   vals, bg, n, m, d, k, stream);
  }
  return launch_tc_as<KDM>(cfg, x, y, xsq, ysq, bias, bias_mode, idx, vals,
                           bg, n, m, d, k, stream);
}

template <typename T>
cudaError_t forward(const void* x, const void* y, const void* bias,
                    void* xsq, void* ysq, void* idx, void* vals, int bg,
                    int n, int m, int d, int k, int bias_mode, int y_is_x,
                    cudaStream_t stream, bool force_chunked) {
  const long long rows_x = (long long)bg * n;
  const long long rows_y = y_is_x ? 0 : (long long)bg * m;
  const long long blocks = (rows_x + rows_y + kWarps - 1) / kWarps;
  row_sq<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(xsq), rows_x,
      static_cast<const T*>(y), static_cast<float*>(ysq), rows_y, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* ysqp = y_is_x ? xsq : ysq;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // the tensor-core scan
    switch (knn_scan::list_slots(k)) {
      case 8:
        return launch_tc<8>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                            n, m, d, k, stream, force_chunked);
      case 12:
        return launch_tc<12>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                             n, m, d, k, stream, force_chunked);
      case 16:
        return launch_tc<16>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                             n, m, d, k, stream, force_chunked);
      case 24:
        return launch_tc<24>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                             n, m, d, k, stream, force_chunked);
      case 32:
        return launch_tc<32>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                             n, m, d, k, stream, force_chunked);
      case 64:
        return launch_tc<64>(x, y, xsq, ysqp, bias, bias_mode, idx, vals, bg,
                             n, m, d, k, stream, force_chunked);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (kdm_bucket(k)) {
      case 8:
        return launch_main<T, 8>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                                 bg, n, m, d, k, stream, force_chunked);
      case 16:
        return launch_main<T, 16>(x, y, xsq, ysqp, bias, bias_mode, idx,
                                  vals, bg, n, m, d, k, stream, force_chunked);
      case 32:
        return launch_main<T, 32>(x, y, xsq, ysqp, bias, bias_mode, idx,
                                  vals, bg, n, m, d, k, stream, force_chunked);
      case 64:
        return launch_main<T, 64>(x, y, xsq, ysqp, bias, bias_mode, idx,
                                  vals, bg, n, m, d, k, stream, force_chunked);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

extern "C" {

// x (bg, n, d), y (bg, m, d) rows of one type (is_bf16: bfloat16, else
// float32), contiguous (y may be x: y_is_x); bias fp32 per bias_mode;
// xsq (bg, n) and ysq (bg, m) fp32 scratch (ysq unused when y_is_x);
// outputs idx (bg, n, k) int32 and, unless vals is null, vals (bg, n, k)
// fp32. Requires 1 <= k <= min(m, 64). force_chunked: take the chunked
// scan at any width (its results are bitwise the unchunked kernel's);
// without it the chunked scan runs only where the whole-row layout does
// not fit. Returns a cudaError_t code.
int knn_topk_forward(const void* x, const void* y, const void* bias,
                     void* xsq, void* ysq, void* idx, void* vals, int bg,
                     int n, int m, int d, int k, int bias_mode, int is_bf16,
                     int y_is_x, int force_chunked, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16>(x, y, bias, xsq, ysq, idx, vals, bg, n, m,
                                  d, k, bias_mode, y_is_x, s,
                                  force_chunked != 0);
  return forward<float>(x, y, bias, xsq, ysq, idx, vals, bg, n, m, d, k,
                        bias_mode, y_is_x, s, force_chunked != 0);
}

// Dynamic shared memory of one main-kernel block at row width d and k
// neighbours, in bf16 (is_bf16) or fp32, with the layout the kernel takes
// (force_chunked: as knn_topk_forward's): negative where that layout is
// the chunked one, 0 when k exceeds 64 or no block shape fits.
long long knn_topk_smem_bytes(int d, int k, int is_bf16, int force_chunked) {
  if (is_bf16) {
    const int len = knn_scan::list_slots(k);
    if (!len) return 0;
    const knn_scan::Config cfg = knn_scan::config(d, len, force_chunked != 0);
    return cfg.chunked ? -(long long)cfg.smem : cfg.smem;
  }
  if (!kdm_bucket(k)) return 0;
  const bool chunked = main_chunked(d, force_chunked != 0);
  const long long smem = (long long)main_smem_bytes(d, chunked);
  return chunked ? -smem : smem;
}

const char* knn_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
