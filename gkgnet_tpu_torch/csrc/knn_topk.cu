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
// registers, so no distance block is ever stored in device memory.
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
// fp32: knn_topk_kernel, as the TPU kernel keeps fp32 at full precision:
//   1. row_sq (both types): one warp per row of x and of y, the fp32 sum of
//      squares in lane-strided fmaf order and a butterfly sum: the
//      arithmetic of knn_mr.cu's l2norm_rows on its rounded rows, so on
//      knn_mr's own normalized rows both kernels see bitwise the same x_sq
//      and y_sq.
//   2. knn_topk_kernel: knn_scan_f32.cuh's scan (register-blocked fmaf fed
//      by cp.async, one layout for every D) and row-threshold selection,
//      the same scan and selection knn_mr.cu's fp32 kernel runs; the
//      header says what bounds it on this card and what the design does
//      about it. Each row's merge writes its k nearest in order, with their
//      distances, straight to idx and vals. Its distances and values are
//      bitwise those of the design it replaced (one warp per query row,
//      sorted per-lane register lists, a whole-row and a D-chunked
//      layout).

// Launch discipline: both kernels run on the caller's stream, allocate
// nothing and do not synchronize; knn_topk_forward returns
// cudaGetLastError() after the launches.

#include <type_traits>

#include "knn_scan.cuh"
#include "knn_scan_f32.cuh"
#include "knn_select.cuh"

namespace {

using knn_select::kThreads;
using knn_select::kWarps;
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

// bias_mode: 0 none, 1 shared (N, M), 2 batched (BG, N, M); fp32.
// vals: nullptr, or (BG, N, k) fp32 for the selected distances.
// block_rows: the block's query rows (knn_f32::config), its column groups
// blockDim.x / (4 * block_rows). knn_scan_f32.cuh's scan, then its merge
// writes each row's k nearest in order, with their distances, straight to
// idx and vals: the scan and the selection knn_mr.cu's fp32 kernel runs.
template <int KDM>
__global__ void __launch_bounds__(knn_f32::kMaxThreads, KDM <= 16 ? 2 : 1)
knn_topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                const float* __restrict__ bias, int bias_mode,
                int* __restrict__ idx, float* __restrict__ vals, int n, int m,
                int d, int k, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  const int rows = block_rows;
  const int cgroups = blockDim.x / (4 * rows);
  const knn_f32::Layout lay = knn_f32::layout(rows, cgroups, KDM);
  const int bg = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  const knn_f32::Rows r{
      x + (long long)bg * n * d, xsq + (long long)bg * n,
      y + (long long)bg * m * d, ysq + (long long)bg * m,
      bias_mode == 0
          ? nullptr
          : bias + (bias_mode == 2 ? (long long)bg * n * m : 0LL),
      n, m, d};
  unsigned lk[KDM];
  int lc[KDM];
  knn_f32::scan<KDM, true, false>(r, row0, k, rows, cgroups, smem_f32, lay,
                                  lk, lc);
  const long long first = ((long long)bg * n + row0) * k;
  knn_f32::merge<KDM>(r, row0, k, 1, rows, cgroups, smem_f32, lay, lk, lc,
                      idx + first, k,
                      vals != nullptr ? vals + first : nullptr);
}

// The fp32 kernel at knn_f32::config's launch shape (force_rows /
// force_groups: a test's choice).
template <int KDM>
cudaError_t launch_main(const void* x, const void* y, const void* xsq,
                        const void* ysq, const void* bias, int bias_mode,
                        void* idx, void* vals, int bg, int n, int m, int d,
                        int k, cudaStream_t stream, int force_rows,
                        int force_groups) {
  const knn_f32::Config cfg =
      knn_f32::config(bg, n, m, KDM, true, force_rows, force_groups);
  if (cfg.smem == 0) return cudaErrorInvalidValue;
  if (cfg.smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_kernel<KDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        cfg.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bg, (n + cfg.rows - 1) / cfg.rows);
  knn_topk_kernel<KDM><<<grid, 4 * cfg.rows * cfg.groups, cfg.smem,
                         stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
      static_cast<float*>(vals), n, m, d, k, cfg.rows);
  return cudaGetLastError();
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
                    cudaStream_t stream, bool force_chunked, int force_rows,
                    int force_groups) {
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
    switch (knn_f32::list_slots(k)) {
      case 8:
        return launch_main<8>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                              bg, n, m, d, k, stream, force_rows,
                              force_groups);
      case 16:
        return launch_main<16>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                               bg, n, m, d, k, stream, force_rows,
                               force_groups);
      case 32:
        return launch_main<32>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                               bg, n, m, d, k, stream, force_rows,
                               force_groups);
      case 48:
        return launch_main<48>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                               bg, n, m, d, k, stream, force_rows,
                               force_groups);
      case 64:
        return launch_main<64>(x, y, xsq, ysqp, bias, bias_mode, idx, vals,
                               bg, n, m, d, k, stream, force_rows,
                               force_groups);
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
// fp32. Requires 1 <= k <= min(m, 64). force_chunked (bf16): take the
// chunked scan at any width (its results are bitwise the unchunked
// kernel's); without it the chunked scan runs only where the whole-row
// layout does not fit. block_rows / block_groups (fp32, nonzero): launch
// blocks of that many query rows / column groups instead of
// knn_f32::config's (the results are bitwise the same). Returns a
// cudaError_t code.
int knn_topk_forward(const void* x, const void* y, const void* bias,
                     void* xsq, void* ysq, void* idx, void* vals, int bg,
                     int n, int m, int d, int k, int bias_mode, int is_bf16,
                     int y_is_x, int force_chunked, int block_rows,
                     int block_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16>(x, y, bias, xsq, ysq, idx, vals, bg, n, m,
                                  d, k, bias_mode, y_is_x, s,
                                  force_chunked != 0, 0, 0);
  return forward<float>(x, y, bias, xsq, ysq, idx, vals, bg, n, m, d, k,
                        bias_mode, y_is_x, s, false, block_rows,
                        block_groups);
}

// Dynamic shared memory of one main-kernel block at row width d and k
// neighbours, in bf16 (is_bf16) or fp32, with the layout the kernel takes
// (force_chunked, block_rows, block_groups: as knn_topk_forward's; bg and
// n the call's batch-groups and query rows, which the fp32 block depends
// on, and m its targets): negative where that layout is the bf16 chunked
// one, 0 when k exceeds 64 or no block shape fits. For fp32, shape
// (unless null) receives the block's query rows and column groups.
long long knn_topk_smem_bytes(int d, int k, int is_bf16, int force_chunked,
                              int bg, int n, int m, int block_rows,
                              int block_groups, int* shape) {
  if (is_bf16) {
    const int len = knn_scan::list_slots(k);
    if (!len) return 0;
    const knn_scan::Config cfg = knn_scan::config(d, len, force_chunked != 0);
    return cfg.chunked ? -(long long)cfg.smem : cfg.smem;
  }
  const knn_f32::Config cfg = knn_f32::config(
      bg, n, m, knn_f32::list_slots(k), true, block_rows, block_groups);
  if (shape != nullptr) {
    shape[0] = cfg.rows;
    shape[1] = cfg.groups;
  }
  return cfg.smem;
}

const char* knn_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
