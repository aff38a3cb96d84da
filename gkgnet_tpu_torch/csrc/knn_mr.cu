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
// direct indexed load. Like the TPU kernel, which multiplies bf16 rows on
// its matrix unit in one pass with fp32 accumulation (knn_mr.py:164-180)
// and fp32 rows at Precision.HIGHEST, the bf16 kernel takes its products
// from the tensor cores and the fp32 one from the CUDA cores.
//
// knn_mr_forward_grouped replaces the fold-aware TPU kernel
// knn_mr.py::knn_mr_fused_grouped (:1167; the same pallas_call with
// groups > 1, whose static per-group loop over full-channel blocks answers
// Mosaic's block-shape rule). Here a group is a pointer offset and a row
// stride: the kGrouped instantiation normalizes each group's D channels of
// the unfolded (B, N, g*D) rows into the same folded scratch, runs the
// same scan and merge on it, and gathers and writes the unfolded rows, so
// its idx and mr are bitwise those of fold -> knn_mr_forward -> unfold and
// the (B, N, C) <-> (B*g, N, C/g) copies around the call never exist. The
// flag is a template parameter of both kernels, so the folded
// instantiations compile to the code they had without it.
//
// Two kernels compute it, one per input type.
//
// bf16 (the model's type): knn_mr_tc_kernel, on knn_scan.cuh's tensor-core
// scan and row-threshold selection, which its header describes: what bounds
// it on this card (instruction issue and latency, far above the 0.23 ms per
// forward that bytes and tensor-core operations allow) and what the design
// does about it. After the scan each warp merges its 16 rows' lists into
// their kept columns; then its lanes gather the raw target rows of those
// columns, 8 channels (one 16-byte load) per lane, the warp's (row, chunk)
// items spread over its lanes, and write max_j(y_j - x) in fp32, rounded
// once to bf16 (max_relative8; max_relative_pair where rows are not whole
// 16-byte chunks).
//
// fp32: knn_mr_kernel, on knn_scan_f32.cuh's CUDA-core scan and
// row-threshold selection, as the TPU kernel keeps fp32 at
// Precision.HIGHEST (TF32 would break the 1e-4 fp64 ordering oracle):
//   1. l2norm_rows (both types): one warp per row of x and of y: fp32 norm
//      of the raw row, divide by max(norm, 1e-12), round to the input type
//      (the contract of gkgnet_tpu/ops/knn.py l2_normalize), then the fp32
//      sum of squares of the rounded row. Written to scratch the caller
//      owns. knn_l2norm launches it alone.
//   2. knn_mr_kernel: the header's scan (register-blocked fmaf, each
//      distance one fmaf chain over the channels in order, x_sq - 2 * dot
//      + y_sq (+ bias); query rows and target tiles staged 32 channels at a
//      time by cp.async in a ring of stages, one layout for every D) and
//      its merge (the block's rows' kept columns, ranks 0, d, 2d, ...).
//      Then the block's warps take its rows in turn: the lanes gather the
//      raw target rows of the kept columns, 4 channels (one 16-byte load) a
//      lane where rows are 16-byte aligned (max_relative4), and write
//      max_j(y_j - x) in fp32. The header says what bounds it on this card and how the host
//      picks the block (query rows and column groups) by shape; the
//      result does not depend on that choice. knn_topk.cu's fp32 kernel
//      takes its distances and its selection from the same header, so
//      knn_topk(xn, yn, k*d)[..., ::d] is bitwise this kernel's idx. Its
//      distances are bitwise those of the design it replaced (one warp per
//      query row, two columns per lane, sorted 64-slot lists per lane, a
//      whole-row and a D-chunked layout), so are idx, mr and the phases'
//      checksums (time_kernels.py's digests).
//
// NaN distances (a NaN query row, a NaN target row, a NaN bias entry) come
// after every number, +inf included, and among themselves in column order:
// the order of the plain version's torch.sort. In both kernels the
// register lists never take a NaN (every comparison with it is false), so
// a row keeps its exact order over its numbers at no cost on the hot path.
// Only a row with fewer than k*d numbers runs out of them in the merge: its
// lists show the empty slot, and knn_select::select_nan_columns then walks
// the columns in order for the NaN ones. (Ordering NaN inside the
// comparison instead cost 6 % to 45 % of the earlier CUDA-core kernel's
// time at stage 1, by variant, on an H100 80GB HBM3.)
//
// knn_phase runs the phase-isolated pieces of this same kernel for the tool
// gkgnet_tpu_torch/tools/exp_kernel_phases.py, which replaces the TPU tool
// tools/exp_kernel_phases.py::make (:108; bodies k_dist :57, k_sel :63).
// The phase is a template parameter of both kernels (kPhase; the forward
// is kForward), so the split times the scan, the merge and the gather the
// model runs, not a copy of them; the tool's bf16 geometry times
// knn_mr_tc_kernel. Each phase writes one fp32 checksum per
// query row, (BG, N, 1), as the TPU kernels define it:
//   dist  the row sum of the fp32 distances x_sq - 2 <x, y> + y_sq from the
//         rounded normalized rows (the contract of _dist :37-54);
//   sel   distances, then the k merge rounds, no gather:
//         sum_D(acc) + sum(idx) with acc left at its initial value. That
//         value is -inf, as on the TPU, so the checksum is -inf whatever the
//         indices; it is a kernel argument (acc_init) from the host, so
//         that the compiler cannot prove -inf + sum(idx) == -inf and
//         delete the selection;
//   gfix  distances, then the gathers of the fixed columns 7 + j, no
//         selection: sum_D max_j(y[7 + j] - x) + sum_j (7 + j). The row sum
//         of the distances is added times dist_weight (0 from the host), so
//         that the scan stays alive as the TPU's scratch store keeps it;
//   selg  the whole forward: sum_D max_j(y[idx_j] - x) + sum(idx), the max
//         in fp32 before any rounding to the input type.
// The phases run without bias and dilation (the tool's geometry has
// neither), folded, with lists of 8, 12 (bf16) or 16, and the fp32 ones
// with one column group (the dist and gfix sums' order).
//
// Launch discipline: the kernels run on the caller's stream, allocate
// nothing and do not synchronize; knn_mr_forward, knn_mr_forward_grouped
// and knn_phase return cudaGetLastError() after the launches.

#include <type_traits>

#include "knn_scan.cuh"
#include "knn_scan_f32.cuh"
#include "knn_select.cuh"

namespace {

using knn_select::from_f32;
using knn_select::kFull;
using knn_select::kThreads;
using knn_select::kWarps;
using knn_select::to_f32;
using knn_select::warp_sum;

// The raw row that folded row r = (bg, i) of a grouped call reads: the
// unfolded (B, R, g*D) rows are rows of D in (b, i, gi) order, and
// bg = b * g + gi.
__device__ __forceinline__ long long grouped_row(long long r, int rows,
                                                 int groups) {
  const long long bg = r / rows;
  const long long i = r - bg * rows;
  const long long b = bg / groups;
  return (b * rows + i) * groups + (bg - b * groups);
}

// One warp per row of x and of y: fp32 norm of the raw row, divide by
// max(norm, 1e-12), round to the input type (the contract of
// gkgnet_tpu/ops/knn.py l2_normalize), then the fp32 sum of squares of the
// rounded row. Written to scratch the caller owns, folded (BG, N, D) and
// (BG, M, D). kGrouped: x and y are unfolded (B, N, g*D) and (B, M, g*D),
// and each group's D channels are normalized on their own.
template <typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
l2norm_rows(const T* __restrict__ x, T* __restrict__ xn,
            float* __restrict__ xsq, long long rows_x,
            const T* __restrict__ y, T* __restrict__ yn,
            float* __restrict__ ysq, long long rows_y, int d, int n, int m,
            int groups) {
  const long long row =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* src;
  T* dst;
  float* sq;
  if (row < rows_x) {
    src = x + (kGrouped ? grouped_row(row, n, groups) : row) * d;
    dst = xn + row * d;
    sq = xsq + row;
  } else if (row < rows_x + rows_y) {
    const long long r = row - rows_x;
    src = y + (kGrouped ? grouped_row(r, m, groups) : r) * d;
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

// kPhase: the forward (idx and mr), or one of the phase tool's pieces,
// which write one checksum per query row to out (see the top of the file).
constexpr int kForward = 0;
constexpr int kDist = 1;
constexpr int kSel = 2;
constexpr int kGfix = 3;
constexpr int kSelg = 4;
constexpr int kFixedColumn = 7;  // gfix gathers columns 7, 8, ..., 6 + k

// The fp32 forward's max-relative row: for each channel c of the query row
// x_row, max_j over the kept columns sel_w[0..k) of y[sel_w[j]][c] - x[c]
// in fp32, combined in the order of sel_w with NaN propagating (the
// scalar epilogue's arithmetic, so the same bits), written to mr_row; 4
// channels (one 16-byte load) per lane, each kept column's loads issued 8
// at a time before their first use. Rows of d % 4 == 0 channels, 16-byte
// aligned.
__device__ __forceinline__ void max_relative4(
    const float* __restrict__ y_b, int ystride, const int* sel_w, int k,
    const float* __restrict__ x_row, float* __restrict__ mr_row, int d,
    int lane) {
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 xv = *reinterpret_cast<const float4*>(x_row + c);
    float4 best = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    for (int s0 = 0; s0 < k; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < k) {
          v[u] = *reinterpret_cast<const float4*>(
              y_b + (long long)sel_w[s0 + u] * ystride + c);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < k) {  // NaN propagates, as amax
          float w = v[u].x - xv.x;
          best.x = (w > best.x || w != w) ? w : best.x;
          w = v[u].y - xv.y;
          best.y = (w > best.y || w != w) ? w : best.y;
          w = v[u].z - xv.z;
          best.z = (w > best.z || w != w) ? w : best.z;
          w = v[u].w - xv.w;
          best.w = (w > best.w || w != w) ? w : best.w;
        }
      }
    }
    *reinterpret_cast<float4*>(mr_row + c) = best;
  }
}

// bias_mode: 0 none, 1 shared (N, M), 2 batched (BG, N, M); fp32.
// kGrouped: x, y and mr are unfolded (B, N, g*D) / (B, M, g*D) and idx is
// (B, N, g, k); xn/yn and their squares are the folded scratch all the
// same, so only the epilogue's reads of the raw rows and its writes move.
// The phases' arguments (acc_init, dist_weight, out) come after the
// forward's; block_rows is the block's query rows (knn_f32::config), its
// column groups blockDim.x / (4 * block_rows). After knn_scan_f32.cuh's
// scan and merge (the block's rows' kept columns in its shared sel rows),
// the block's warps take its rows in turn: the lanes gather the raw target
// rows of the kept columns and write max_j(y_j - x) (max_relative4 where
// the forward's rows are 16-byte aligned), or, lane-strided over the
// channels as the phases' sums need, the phase's checksum.
template <int KDM, bool kGrouped, int kPhase>
__global__ void __launch_bounds__(knn_f32::kMaxThreads, KDM <= 16 ? 2 : 1)
knn_mr_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ xn, const float* __restrict__ yn,
              const float* __restrict__ xsq, const float* __restrict__ ysq,
              const float* __restrict__ bias, int bias_mode,
              int* __restrict__ idx, float* __restrict__ mr,
              int n, int m, int d, int k, int dilation, int groups,
              float acc_init, float dist_weight, float* __restrict__ out,
              int block_rows) {
  static_assert(kPhase == kForward || !kGrouped, "phases run folded");
  constexpr bool kSelect =
      kPhase == kForward || kPhase == kSel || kPhase == kSelg;
  constexpr bool kGather =
      kPhase == kForward || kPhase == kGfix || kPhase == kSelg;
  constexpr bool kSumDist = kPhase == kDist || kPhase == kGfix;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  const int rows = block_rows;
  const int cgroups = blockDim.x / (4 * rows);
  const knn_f32::Layout lay = knn_f32::layout(rows, cgroups, KDM);
  const int bg = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const knn_f32::Rows r{
      xn + (long long)bg * n * d, xsq + (long long)bg * n,
      yn + (long long)bg * m * d, ysq + (long long)bg * m,
      bias_mode == 0
          ? nullptr
          : bias + (bias_mode == 2 ? (long long)bg * n * m : 0LL),
      n, m, d};
  unsigned lk[KDM];
  int lc[KDM];
  knn_f32::scan<KDM, kSelect, kSumDist>(r, row0, k * dilation, rows,
                                        cgroups, smem_f32, lay, lk, lc);
  int* sel = reinterpret_cast<int*>(smem_f32 + lay.sel);
  const float* dsum = reinterpret_cast<const float*>(smem_f32 + lay.dsum);
  if constexpr (kSelect) {
    knn_f32::merge<KDM>(r, row0, k * dilation, dilation, rows, cgroups,
                        smem_f32, lay, lk, lc, sel, KDM, nullptr);
  } else {
    for (int i = threadIdx.x; i < rows * k; i += blockDim.x) {
      sel[(i / k) * KDM + i % k] = kFixedColumn + i % k;
    }
    __syncthreads();  // sel and the distance sums written
  }

  // Gather the raw target rows and take max(y_j - x) in fp32; a grouped
  // call's targets are rows of g*D too.
  const float* y_b = y + (long long)bg * m * d;
  int ystride = d;
  if constexpr (kGrouped) {
    const int b = bg / groups;
    const int gi = bg - b * groups;
    y_b = y + (long long)b * m * groups * d + (long long)gi * d;
    ystride = groups * d;
  }
  // the forward's rows in whole, 16-byte aligned 4-channel chunks
  const bool vec4 = (d & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y_b) |
                      reinterpret_cast<uintptr_t>(mr)) & 15) == 0;
  for (int rr = warp; rr < rows && row0 + rr < n; rr += blockDim.x >> 5) {
    const int row = row0 + rr;
    const long long qrow = (long long)bg * n + row;
    // the output row of x and mr (of d) and of idx (of k): a grouped
    // call's group gi of batch b writes channels [gi*D, (gi+1)*D) of rows
    // of g*D
    long long orow = qrow;
    if constexpr (kGrouped) {
      const int b = bg / groups;
      orow = ((long long)b * n + row) * groups + (bg - b * groups);
    }
    if constexpr (kPhase == kDist) {
      if (lane == 0) out[qrow] = dsum[rr];
      continue;
    }
    const int* sel_w = sel + rr * KDM;
    const float* x_row = x + orow * d;
    float part = 0.f;  // the phases: this lane's channels of sum_D(acc)
    if constexpr (kPhase == kForward) {
      if (vec4) {
        max_relative4(y_b, ystride, sel_w, k, x_row, mr + orow * d, d, lane);
        for (int s = lane; s < k; s += 32) idx[orow * k + s] = sel_w[s];
        continue;
      }
    }
    if constexpr (kGather) {
      for (int c = lane; c < d; c += 32) {
        const float xv = x_row[c];
        float best = -INFINITY;
        for (int s = 0; s < k; ++s) {
          const float v = y_b[(long long)sel_w[s] * ystride + c] - xv;
          best = (v > best || v != v) ? v : best;  // NaN propagates, as amax
        }
        if constexpr (kPhase == kForward) {
          mr[orow * d + c] = best;
        } else {
          part += best;
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) part += acc_init;
    }
    if constexpr (kPhase == kForward) {
      for (int s = lane; s < k; s += 32) idx[orow * k + s] = sel_w[s];
    } else {
      int isum = 0;
      for (int s = 0; s < k; ++s) isum += sel_w[s];
      float res = warp_sum(part) + (float)isum;
      if constexpr (kSumDist) res += dsum[rr] * dist_weight;
      if (lane == 0) out[qrow] = res;
    }
  }
}

// The fp32 kernel at knn_f32::config's launch shape (force_rows /
// force_groups: a test's choice; the forward alone takes column groups).
template <int KDM, bool kGrouped, int kPhase = kForward>
cudaError_t launch_main(const void* x, const void* y, const void* xn,
                        const void* yn, const void* xsq, const void* ysq,
                        const void* bias, int bias_mode, void* idx, void* mr,
                        int bg, int n, int m, int d, int k, int dilation,
                        int groups, cudaStream_t stream,
                        float acc_init = 0.f, float dist_weight = 0.f,
                        void* out = nullptr, int force_rows = 0,
                        int force_groups = 0) {
  const knn_f32::Config cfg = knn_f32::config(
      bg, n, m, KDM, kPhase == kForward, force_rows, force_groups);
  if (cfg.smem == 0) return cudaErrorInvalidValue;
  if (cfg.smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_mr_kernel<KDM, kGrouped, kPhase>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bg, (n + cfg.rows - 1) / cfg.rows);
  knn_mr_kernel<KDM, kGrouped, kPhase>
      <<<grid, 4 * cfg.rows * cfg.groups, cfg.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(xn), static_cast<const float*>(yn),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
      static_cast<float*>(mr), n, m, d, k, dilation, groups, acc_init,
      dist_weight, static_cast<float*>(out), cfg.rows);
  return cudaGetLastError();
}

// The max-relative value of one channel c of a query row: max_j over the
// kept columns sel_w[0..k) of y[sel_w[j]][c] - xv in fp32, combined in the
// order of sel_w with NaN propagating (knn_mr_kernel's arithmetic), for two
// channels at a time (c1 < 0: none). The loads are issued 16 at a time
// before their first use, so a warp has up to 32 in flight.
__device__ __forceinline__ void max_relative_pair(
    const __nv_bfloat16* __restrict__ y_b, int ystride, const int* sel_w,
    int k, int c0, int c1, float x0, float x1, float& b0, float& b1) {
  b0 = -INFINITY;
  b1 = -INFINITY;
  for (int s0 = 0; s0 < k; s0 += 16) {
    float v0[16], v1[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (s0 + u < k) {
        const long long off = (long long)sel_w[s0 + u] * ystride;
        v0[u] = to_f32(y_b[off + c0]);
        v1[u] = c1 >= 0 ? to_f32(y_b[off + c1]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (s0 + u < k) {
        const float w0 = v0[u] - x0;
        b0 = (w0 > b0 || w0 != w0) ? w0 : b0;  // NaN propagates, as amax
        const float w1 = v1[u] - x1;
        b1 = (w1 > b1 || w1 != w1) ? w1 : b1;
      }
    }
  }
}

// 8 bf16 values from 16 bytes, in fp32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The same maxima for the 8 channels c0..c0+7 (c0 a multiple of 8, rows
// of a multiple of 8 channels: 16-byte aligned), x8 the query's 8 raw
// values: each kept column's 8 values one 16-byte load, issued 8 columns
// at a time before their first use.
__device__ __forceinline__ void max_relative8(
    const __nv_bfloat16* __restrict__ y_b, int ystride, const int* sel_w,
    int k, int c0, const __nv_bfloat16* __restrict__ x8, float (&best)[8]) {
  float xv[8];
  unpack8(*reinterpret_cast<const uint4*>(x8), xv);
#pragma unroll
  for (int c = 0; c < 8; ++c) best[c] = -INFINITY;
  for (int s0 = 0; s0 < k; s0 += 8) {
    uint4 raw[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < k) {
        raw[u] = *reinterpret_cast<const uint4*>(
            y_b + (long long)sel_w[s0 + u] * ystride + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < k) {
        float v[8];
        unpack8(raw[u], v);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float w = v[c] - xv[c];
          best[c] = (w > best[c] || w != w) ? w : best[c];  // as amax
        }
      }
    }
  }
}

// 8 fp32 values rounded to bf16 (as from_f32), stored as 16 bytes.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __halves2bfloat162(__float2bfloat16_rn(v[2 * i]),
                              __float2bfloat16_rn(v[2 * i + 1]));
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// The bf16 forward and its phases on knn_scan.cuh's tensor-core scan and
// row-threshold selection: 16 query rows per warp, 1-4 warps per block
// (knn_scan::config). After the scan and the merge (each warp's rows' kept
// columns in its shared sel rows), the epilogue does knn_mr_kernel's work
// for the warp's rows: the lanes gather the raw target rows of the kept
// columns (max_relative8, max_relative_pair) and write max_j(y_j - x) (or
// the phase's checksum). The arguments are knn_mr_kernel's. kChunked (the
// folded forward only): knn_scan.cuh's chunked scan, for rows too wide for
// its whole-row layout; the epilogue reads no staged row, so it is the
// same.
template <int KDM, bool kGrouped, int kPhase, bool kChunked = false>
__global__ void __launch_bounds__(knn_scan::kMaxWarps * 32)
knn_mr_tc_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ y,
                 const __nv_bfloat16* __restrict__ xn,
                 const __nv_bfloat16* __restrict__ yn,
                 const float* __restrict__ xsq, const float* __restrict__ ysq,
                 const float* __restrict__ bias, int bias_mode,
                 int* __restrict__ idx, __nv_bfloat16* __restrict__ mr, int n,
                 int m, int d, int k, int dilation, int groups,
                 float acc_init, float dist_weight, float* __restrict__ out) {
  using knn_scan::kRows;
  static_assert(kPhase == kForward || !kGrouped, "phases run folded");
  static_assert(!kChunked || (kPhase == kForward && !kGrouped),
                "the chunked scan runs the folded forward");
  constexpr bool kSelect =
      kPhase == kForward || kPhase == kSel || kPhase == kSelg;
  constexpr bool kGather =
      kPhase == kForward || kPhase == kGfix || kPhase == kSelg;
  constexpr bool kSumDist = kPhase == kDist || kPhase == kGfix;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int warps = blockDim.x >> 5;
  const knn_scan::Layout lay = knn_scan::layout_for<kChunked>(d, KDM, warps);
  const int bg = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * warps * kRows;
  const int wrow0 = row0 + warp * kRows;
  knn_scan::Rows rows{xn + (long long)bg * n * d, xsq + (long long)bg * n,
                      yn + (long long)bg * m * d, ysq + (long long)bg * m,
                      bias_mode == 0 ? nullptr
                                     : bias + (bias_mode == 2
                                                   ? (long long)bg * n * m
                                                   : 0LL),
                      n, m, d};
  const int kd = k * dilation;
  unsigned lk[KDM];
  int lc[KDM];
  float dsum_a = 0.f, dsum_b = 0.f;  // dist, gfix: this lane's distances
  if constexpr (kChunked) {
    knn_scan::scan_chunked<KDM, kSelect, kSumDist>(
        rows, row0, kd, smem_tc, lay, lk, lc, dsum_a, dsum_b);
  } else {
    knn_scan::scan<KDM, kSelect, kSumDist>(rows, row0, kd, smem_tc,
                                           lay, lk, lc, dsum_a, dsum_b);
  }
  if (wrow0 >= n) return;  // whole warp: no block-wide barrier follows

  if constexpr (kSumDist) {  // the quad's sums: the rows' totals
    dsum_a += __shfl_xor_sync(kFull, dsum_a, 1);
    dsum_a += __shfl_xor_sync(kFull, dsum_a, 2);
    dsum_b += __shfl_xor_sync(kFull, dsum_b, 1);
    dsum_b += __shfl_xor_sync(kFull, dsum_b, 2);
  }
  if constexpr (kPhase == kDist) {
    const int g = lane >> 2;
    if ((lane & 3) == 0) {
      if (wrow0 + g < n) out[(long long)bg * n + wrow0 + g] = dsum_a;
      if (wrow0 + g + 8 < n) out[(long long)bg * n + wrow0 + g + 8] = dsum_b;
    }
    return;
  }

  int* sel = reinterpret_cast<int*>(smem_tc + lay.sel) + warp * kRows * KDM;
  if constexpr (kSelect) {
    knn_scan::merge_rows<KDM, kChunked>(rows, row0, kd, dilation, smem_tc,
                                        lay, lk, lc, sel, KDM, nullptr);
  } else {
    for (int i = lane; i < kRows * k; i += 32) {
      sel[(i / k) * KDM + i % k] = kFixedColumn + i % k;
    }
    __syncwarp();
  }

  // knn_mr_kernel's epilogue for the warp's rows: gather the raw target
  // rows of the kept columns and take max(y_j - x) in fp32; a grouped
  // call's targets and outputs are rows of g*D.
  const __nv_bfloat16* y_b = y + (long long)bg * m * d;
  int ystride = d;
  int b = bg;
  int gi = 0;
  if constexpr (kGrouped) {
    b = bg / groups;
    gi = bg - b * groups;
    y_b = y + (long long)b * m * groups * d + (long long)gi * d;
    ystride = groups * d;
  }
  auto out_row = [&](int row) {  // the output row of x and mr (of d)
    if constexpr (kGrouped) {
      return ((long long)b * n + row) * groups + gi;
    } else {
      return (long long)bg * n + row;
    }
  };
  const int nrows = min(kRows, n - wrow0);
  // the phases: each (row, 8-channel chunk)'s sum of maxima (or each row's
  // lanes' sums where rows are not 8-channel aligned), then the rows'
  float* psum = reinterpret_cast<float*>(
      smem_tc + lay.y + warp * knn_scan::merge_bytes(d, KDM));
  const int chunks = d >> 3;
  const bool vec =  // rows of whole, 16-byte aligned 8-channel chunks
      (d & 7) == 0 && ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y_b) |
                        reinterpret_cast<uintptr_t>(mr)) & 15) == 0;
  if constexpr (kGather) {
    if (vec) {
      // 8 channels per lane: one 16-byte load per kept column, the warp's
      // (row, chunk) items spread over its lanes
      for (int it = lane; it < nrows * chunks; it += 32) {
        const int rr = it / chunks;
        const int ch = it - rr * chunks;
        const long long orow = out_row(wrow0 + rr);
        float best[8];
        max_relative8(y_b, ystride, sel + rr * KDM, k, ch * 8,
                      x + orow * d + ch * 8, best);
        if constexpr (kPhase == kForward) {
          store8(mr + orow * d + ch * 8, best);
        } else {
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) sum += best[c];
          psum[rr * chunks + ch] = sum;
        }
      }
    } else {
      for (int rr = 0; rr < nrows; ++rr) {
        const long long orow = out_row(wrow0 + rr);
        float part = 0.f;  // the phases: this lane's channels' maxima
        for (int c0 = lane; c0 < d; c0 += 64) {
          const int c1 = c0 + 32 < d ? c0 + 32 : -1;
          const float x0 = to_f32(x[orow * d + c0]);
          const float x1 = c1 >= 0 ? to_f32(x[orow * d + c1]) : 0.f;
          float b0, b1;
          max_relative_pair(y_b, ystride, sel + rr * KDM, k, c0, c1, x0, x1,
                            b0, b1);
          if constexpr (kPhase == kForward) {
            mr[orow * d + c0] = from_f32<__nv_bfloat16>(b0);
            if (c1 >= 0) mr[orow * d + c1] = from_f32<__nv_bfloat16>(b1);
          } else {
            part += b0;
            if (c1 >= 0) part += b1;
          }
        }
        if constexpr (kPhase != kForward) psum[rr * 32 + lane] = part;
      }
    }
  }
  if constexpr (kPhase == kForward) {
    for (int it = lane; it < nrows * k; it += 32) {
      const int rr = it / k;
      const int s = it - rr * k;
      idx[out_row(wrow0 + rr) * k + s] = sel[rr * KDM + s];
    }
  } else {
    __syncwarp();  // the items' sums written
    const int parts = vec ? chunks : 32;
    for (int rr = 0; rr < nrows; ++rr) {
      float part = 0.f;  // sum_D(acc): this lane's parts of it
      for (int c = lane; c < (kGather ? parts : d); c += 32) {
        part += kGather ? psum[rr * parts + c] : acc_init;
      }
      int isum = 0;
      for (int s = 0; s < k; ++s) isum += sel[rr * KDM + s];
      float res = warp_sum(part) + (float)isum;
      if constexpr (kSumDist) {
        const float dr =
            __shfl_sync(kFull, rr < 8 ? dsum_a : dsum_b, 4 * (rr & 7));
        res += dr * dist_weight;
      }
      if (lane == 0) out[(long long)bg * n + wrow0 + rr] = res;
    }
  }
}

template <int KDM, bool kGrouped, int kPhase, bool kChunked = false>
cudaError_t launch_tc_as(const knn_scan::Config& cfg, const void* x,
                         const void* y, const void* xn, const void* yn,
                         const void* xsq, const void* ysq, const void* bias,
                         int bias_mode, void* idx, void* mr, int bg, int n,
                         int m, int d, int k, int dilation, int groups,
                         cudaStream_t stream, float acc_init,
                         float dist_weight, void* out) {
  if (cfg.smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_mr_tc_kernel<KDM, kGrouped, kPhase, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = cfg.warps * knn_scan::kRows;
  const dim3 grid(bg, (n + rows - 1) / rows);
  knn_mr_tc_kernel<KDM, kGrouped, kPhase, kChunked>
      <<<grid, cfg.warps * 32, cfg.smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(y),
          static_cast<const __nv_bfloat16*>(xn),
          static_cast<const __nv_bfloat16*>(yn),
          static_cast<const float*>(xsq), static_cast<const float*>(ysq),
          static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
          static_cast<__nv_bfloat16*>(mr), n, m, d, k, dilation, groups,
          acc_init, dist_weight, static_cast<float*>(out));
  return cudaGetLastError();
}

// The launch shape of knn_scan::config, and the chunked instantiation
// where it takes the chunked layout (the folded forward only: the grouped
// kernel and the phases fail there).
template <int KDM, bool kGrouped, int kPhase = kForward>
cudaError_t launch_tc(const void* x, const void* y, const void* xn,
                      const void* yn, const void* xsq, const void* ysq,
                      const void* bias, int bias_mode, void* idx, void* mr,
                      int bg, int n, int m, int d, int k, int dilation,
                      int groups, cudaStream_t stream, float acc_init = 0.f,
                      float dist_weight = 0.f, void* out = nullptr,
                      bool force_chunked = false) {
  const knn_scan::Config cfg = knn_scan::config(d, KDM, force_chunked);
  if (cfg.smem == 0) return cudaErrorInvalidValue;
  if (cfg.chunked) {
    if constexpr (kPhase == kForward && !kGrouped) {
      return launch_tc_as<KDM, false, kForward, true>(
          cfg, x, y, xn, yn, xsq, ysq, bias, bias_mode, idx, mr, bg, n, m,
          d, k, dilation, groups, stream, acc_init, dist_weight, out);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return launch_tc_as<KDM, kGrouped, kPhase>(
      cfg, x, y, xn, yn, xsq, ysq, bias, bias_mode, idx, mr, bg, n, m, d, k,
      dilation, groups, stream, acc_init, dist_weight, out);
}

// f(std::integral_constant<int, L>{}) for the list length L that T's
// kernel takes for k*d = kd, no longer than kMaxList: knn_scan's for
// bf16, knn_f32's for fp32. cudaErrorInvalidValue where none does.
template <typename T, int kMaxList, typename F>
cudaError_t with_lists(int kd, F f) {
  using std::integral_constant;
  const int len = std::is_same_v<T, __nv_bfloat16> ? knn_scan::list_slots(kd)
                                                   : knn_f32::list_slots(kd);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (len == 12) return f(integral_constant<int, 12>{});
    if constexpr (kMaxList >= 24) {
      if (len == 24) return f(integral_constant<int, 24>{});
    }
  }
  if (len == 8) return f(integral_constant<int, 8>{});
  if (len == 16) return f(integral_constant<int, 16>{});
  if constexpr (kMaxList >= 64) {
    if (len == 32) return f(integral_constant<int, 32>{});
    if constexpr (!std::is_same_v<T, __nv_bfloat16>) {
      if (len == 48) return f(integral_constant<int, 48>{});
    }
    if (len == 64) return f(integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

// bg is the folded batch B * groups; d the channels of one group. The bf16
// calls run knn_mr_tc_kernel, the fp32 ones knn_mr_kernel.
template <typename T, bool kGrouped>
cudaError_t forward(const void* x, const void* y, const void* bias,
                    void* xn, void* yn, void* xsq, void* ysq, void* idx,
                    void* mr, int bg, int n, int m, int d, int k,
                    int dilation, int bias_mode, int y_is_x, int groups,
                    cudaStream_t stream, bool force_chunked = false,
                    int force_rows = 0, int force_groups = 0) {
  const long long rows_x = (long long)bg * n;
  const long long rows_y = y_is_x ? 0 : (long long)bg * m;
  const long long blocks = (rows_x + rows_y + kWarps - 1) / kWarps;
  l2norm_rows<T, kGrouped><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xn),
      static_cast<float*>(xsq), rows_x, static_cast<const T*>(y),
      static_cast<T*>(yn), static_cast<float*>(ysq), rows_y, d, n, m,
      groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* ynp = y_is_x ? xn : yn;
  const void* ysqp = y_is_x ? xsq : ysq;
  return with_lists<T, 64>(k * dilation, [&](auto len) {
    constexpr int L = decltype(len)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return launch_tc<L, kGrouped>(x, y, xn, ynp, xsq, ysqp, bias,
                                    bias_mode, idx, mr, bg, n, m, d, k,
                                    dilation, groups, stream, 0.f, 0.f,
                                    nullptr, force_chunked);
    } else {
      return launch_main<L, kGrouped>(x, y, xn, ynp, xsq, ysqp, bias,
                                      bias_mode, idx, mr, bg, n, m, d, k,
                                      dilation, groups, stream, 0.f, 0.f,
                                      nullptr, force_rows, force_groups);
    }
  });
}

// The forward's first kernel alone on rows of x (the edge-partitioned
// builds normalize the rows they pass to knn_topk with it).
template <typename T>
cudaError_t normalize(const void* x, void* xn, void* xsq, long long rows,
                      int d, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  l2norm_rows<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xn),
      static_cast<float*>(xsq), rows, nullptr, nullptr, nullptr, 0, d, 0, 0,
      1);
  return cudaGetLastError();
}

template <typename T, int KDM, int kPhase>
cudaError_t launch_phase(const void* x, const void* y, const void* xn,
                         const void* yn, const void* xsq, const void* ysq,
                         void* out, int bg, int n, int m, int d, int k,
                         cudaStream_t stream) {
  const float acc_init = -INFINITY;  // acc's initial value, as on the TPU
  const float dist_weight = 0.f;     // gfix: keeps the scan, adds nothing
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_tc<KDM, false, kPhase>(
        x, y, xn, yn, xsq, ysq, nullptr, 0, nullptr, nullptr, bg, n, m, d, k,
        1, 1, stream, acc_init, dist_weight, out);
  } else {
    return launch_main<KDM, false, kPhase>(
        x, y, xn, yn, xsq, ysq, nullptr, 0, nullptr, nullptr, bg, n, m, d, k,
        1, 1, stream, acc_init, dist_weight, out);
  }
}

template <typename T>
cudaError_t run_phase(int phase, const void* x, const void* y, void* xn,
                      void* yn, void* xsq, void* ysq, void* out, int bg,
                      int n, int m, int d, int k, cudaStream_t stream) {
  const long long rows_x = (long long)bg * n;
  const long long rows_y = (long long)bg * m;
  const long long blocks = (rows_x + rows_y + kWarps - 1) / kWarps;
  l2norm_rows<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xn),
      static_cast<float*>(xsq), rows_x, static_cast<const T*>(y),
      static_cast<T*>(yn), static_cast<float*>(ysq), rows_y, d, n, m, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return with_lists<T, 16>(k, [&](auto len) {
    constexpr int L = decltype(len)::value;
    switch (phase) {
      case kDist:
        return launch_phase<T, L, kDist>(x, y, xn, yn, xsq, ysq, out, bg, n,
                                         m, d, k, stream);
      case kSel:
        return launch_phase<T, L, kSel>(x, y, xn, yn, xsq, ysq, out, bg, n,
                                        m, d, k, stream);
      case kGfix:
        return launch_phase<T, L, kGfix>(x, y, xn, yn, xsq, ysq, out, bg, n,
                                         m, d, k, stream);
      case kSelg:
        return launch_phase<T, L, kSelg>(x, y, xn, yn, xsq, ysq, out, bg, n,
                                         m, d, k, stream);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

}  // namespace

extern "C" {

// x (bg, n, d), y (bg, m, d) raw rows of one type (is_bf16: bfloat16, else
// float32), contiguous; bias fp32 per bias_mode; xn/xsq (bg, n, d)/(bg, n)
// and yn/ysq (bg, m, d)/(bg, m) scratch (unused for y when y_is_x);
// outputs idx (bg, n, k) int32 and mr (bg, n, d) of the input type.
// Requires 1 <= k * dilation <= min(m, 64). force_chunked (bf16): take
// the chunked scan at any width (its results are bitwise the unchunked
// kernel's); without it the chunked scan runs only where the whole-row
// layout does not fit. block_rows / block_groups (fp32, nonzero): launch
// blocks of that many query rows / column groups instead of
// knn_f32::config's (the results are bitwise the same). Returns a
// cudaError_t code.
int knn_mr_forward(const void* x, const void* y, const void* bias, void* xn,
                   void* yn, void* xsq, void* ysq, void* idx, void* mr,
                   int bg, int n, int m, int d, int k, int dilation,
                   int bias_mode, int is_bf16, int y_is_x, int force_chunked,
                   int block_rows, int block_groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16, false>(x, y, bias, xn, yn, xsq, ysq, idx,
                                         mr, bg, n, m, d, k, dilation,
                                         bias_mode, y_is_x, 1, s,
                                         force_chunked != 0);
  return forward<float, false>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg, n,
                               m, d, k, dilation, bias_mode, y_is_x, 1, s,
                               false, block_rows, block_groups);
}

// The fold-aware forward: x (b, n, groups*d), y (b, m, groups*d) unfolded,
// contiguous; group gi is channels [gi*d, (gi+1)*d) of every row. bias
// none (bias_mode 0) or shared (n, m) (bias_mode 1). xn/xsq and yn/ysq are
// folded scratch, (b*groups, n, d)/(b*groups, n) and (b*groups, m, d)/
// (b*groups, m); outputs idx (b, n, groups, k) int32 and mr
// (b, n, groups*d) of the input type: bitwise the folded forward's on the
// folded rows, unfolded. block_rows / block_groups: as knn_mr_forward's.
// Returns a cudaError_t code.
int knn_mr_forward_grouped(const void* x, const void* y, const void* bias,
                           void* xn, void* yn, void* xsq, void* ysq,
                           void* idx, void* mr, int b, int groups, int n,
                           int m, int d, int k, int dilation, int bias_mode,
                           int is_bf16, int y_is_x, int block_rows,
                           int block_groups, void* stream) {
  if (bias_mode == 2 || groups < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bg = b * groups;
  if (is_bf16)
    return forward<__nv_bfloat16, true>(x, y, bias, xn, yn, xsq, ysq, idx,
                                        mr, bg, n, m, d, k, dilation,
                                        bias_mode, y_is_x, groups, s);
  return forward<float, true>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg, n,
                              m, d, k, dilation, bias_mode, y_is_x, groups,
                              s, false, block_rows, block_groups);
}

// x (rows, d) raw rows of one type (is_bf16: bfloat16, else float32),
// contiguous; xn (rows, d) the rows L2-normalized exactly as the forward
// normalizes them before its distances (l2norm_rows), xsq (rows) fp32
// scratch. Returns a cudaError_t code.
int knn_l2norm(const void* x, void* xn, void* xsq, long long rows, int d,
               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return normalize<__nv_bfloat16>(x, xn, xsq, rows, d, s);
  return normalize<float>(x, xn, xsq, rows, d, s);
}

// The phase tool's pieces of the forward. phase: 0 dist, 1 sel, 2 gfix,
// 3 selg. x (bg, n, d), y (bg, m, d) raw rows of one type (is_bf16:
// bfloat16, else float32), contiguous; xn/xsq (bg, n, d)/(bg, n) and
// yn/ysq (bg, m, d)/(bg, m) scratch; out (bg, n) fp32 checksums. Requires
// 1 <= k <= min(m, 16), and m >= 7 + k for gfix. Returns a cudaError_t
// code.
int knn_phase(int phase, const void* x, const void* y, void* xn, void* yn,
              void* xsq, void* ysq, void* out, int bg, int n, int m, int d,
              int k, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phase + 1 == kGfix && m < kFixedColumn + k)
    return cudaErrorInvalidValue;
  if (is_bf16)
    return run_phase<__nv_bfloat16>(phase + 1, x, y, xn, yn, xsq, ysq, out,
                                    bg, n, m, d, k, s);
  return run_phase<float>(phase + 1, x, y, xn, yn, xsq, ysq, out, bg, n, m,
                          d, k, s);
}

// Dynamic shared memory of one folded forward block at row width d and
// k*d = kd, in bf16 (is_bf16) or fp32, with the layout the forward takes
// (force_chunked, block_rows, block_groups: as knn_mr_forward's; bg and n
// the call's batch-groups and query rows, which the fp32 block depends
// on, and m its targets): negative where that layout is the bf16 chunked
// one, 0 when k*d exceeds 64 or no block shape fits. For fp32, shape
// (unless null) receives the block's query rows and column groups.
long long knn_mr_smem_bytes(int d, int kd, int is_bf16, int force_chunked,
                            int bg, int n, int m, int block_rows,
                            int block_groups, int* shape) {
  if (is_bf16) {
    const int len = knn_scan::list_slots(kd);
    if (!len) return 0;
    const knn_scan::Config cfg = knn_scan::config(d, len, force_chunked != 0);
    return cfg.chunked ? -(long long)cfg.smem : cfg.smem;
  }
  const knn_f32::Config cfg =
      knn_f32::config(bg, n, m, knn_f32::list_slots(kd), true, block_rows,
                      block_groups);
  if (shape != nullptr) {
    shape[0] = cfg.rows;
    shape[1] = cfg.groups;
  }
  return cfg.smem;
}

const char* knn_mr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
