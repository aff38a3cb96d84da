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
// instantiations compile to the code they had without it; knn_mr_kernel's
// grouped one writes its scan's loop with the loads ahead of the products
// (see there).
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
// fp32: knn_mr_kernel, the CUDA-core design, as the TPU kernel keeps fp32
// at Precision.HIGHEST (TF32 would break the 1e-4 fp64 ordering oracle):
// one warp per query row, kWarps rows per block.
//   1. l2norm_rows (both types): one warp per row of x and of y: fp32 norm
//      of the raw row, divide by max(norm, 1e-12), round to the input type
//      (the contract of gkgnet_tpu/ops/knn.py l2_normalize), then the fp32
//      sum of squares of the rounded row. Written to scratch the caller
//      owns.
//   2. knn_mr_kernel: the block walks the targets in tiles of kTile rows,
//      staged transposed in shared memory as fp32. Each lane computes the
//      distances of its 2 columns of the tile,
//      x_sq - 2 * dot + y_sq (+ bias), and keeps a sorted register list of
//      its best KDM >= k*d (dist, col) pairs. Then k*d rounds of a warp
//      lexicographic min over the lanes' list heads give the global order;
//      rounds 0, d, 2d, ... are kept. Last, the lanes gather the raw target
//      rows of the kept columns and write max_j(y_j - x) in fp32, rounded
//      once to the input type.
//   Its bound: shared-memory loads and fp32 issue (one load per fmaf), far
//   above the bytes' and the fp32 operations' bounds. The transposed tile
//   is 260 bytes a channel, so past D = 795 (arch b without channel
//   groups: D = 1024) the folded forward stages it kChunk = 128 channels
//   at a time (kChunked), the same sums in the same order. The blocks that read
//   the same bias rows for different groups run together (the grid's
//   fastest axis is the batch-group axis), so the bias comes from L2.
//   The selection helpers (the register lists, their lexicographic order,
//   select_nan_columns) are knn_select.cuh's, shared with knn_topk.cu,
//   whose fp32 scan and merge repeat this kernel's arithmetic, so that
//   knn_topk(xn, yn, k*d)[..., ::d] is bitwise this kernel's idx. The scan
//   and merge stay written out here: moved into shared functions they
//   compiled to other code (122 and 178 registers for lists of 32 and 64,
//   not 115 and 171) and a 1 % slower stage-1 call on an H100 80GB HBM3.
//   This design computed the bf16 calls too until the tensor-core kernel
//   took them; its fp32 instantiations compile to the code they had then.
//
// NaN distances (a NaN query row, a NaN target row, a NaN bias entry) come
// after every number, +inf included, and among themselves in column order:
// the order of the plain version's torch.sort. In both kernels the
// register lists never take a NaN (every comparison with it is false), so
// a row keeps its exact order over its numbers at no cost on the hot path.
// Only a row with fewer than k*d numbers runs out of them in the merge: its
// lists show the empty slot, and select_nan_columns then walks the columns
// in order for the NaN ones. (Ordering NaN inside the comparison instead
// cost 6 % to 45 % of the CUDA-core kernel's time at stage 1, by variant,
// on an H100 80GB HBM3.)
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
// neither), folded, with lists of 8, 12 (bf16) or 16.
//
// Launch discipline: the kernels run on the caller's stream, allocate
// nothing and do not synchronize; knn_mr_forward, knn_mr_forward_grouped
// and knn_phase return cudaGetLastError() after the launches.

#include <type_traits>

#include "knn_scan.cuh"
#include "knn_select.cuh"

namespace {

using knn_select::from_f32;
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

// bias_mode: 0 none, 1 shared (N, M), 2 batched (BG, N, M); fp32.
// kGrouped: x, y and mr are unfolded (B, N, g*D) / (B, M, g*D) and idx is
// (B, N, g, k); xn/yn and their squares are the folded scratch all the
// same, so only the epilogue's reads of the raw rows and its writes move.
// The phases' arguments (acc_init, dist_weight, out) come last, so the
// forward's parameters keep their offsets. kChunked (the folded forward
// only): the target tile is staged kChunk channels at a time, for rows
// whose whole transposed tile does not fit in shared memory; the products
// are the same fmaf steps in the same order, so every distance is bitwise
// the unchunked kernel's.
template <typename T, int KDM, bool kGrouped, int kPhase,
          bool kChunked = false>
__global__ void __launch_bounds__(kThreads)
knn_mr_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const T* __restrict__ xn, const T* __restrict__ yn,
              const float* __restrict__ xsq, const float* __restrict__ ysq,
              const float* __restrict__ bias, int bias_mode,
              int* __restrict__ idx, T* __restrict__ mr,
              int n, int m, int d, int k, int dilation, int groups,
              float acc_init, float dist_weight, float* __restrict__ out) {
  static_assert(kPhase == kForward || !kGrouped, "phases run folded");
  static_assert(!kChunked || (kPhase == kForward && !kGrouped),
                "the chunked scan runs the folded forward");
  constexpr bool kSelect =
      kPhase == kForward || kPhase == kSel || kPhase == kSelg;
  constexpr bool kGather =
      kPhase == kForward || kPhase == kGfix || kPhase == kSelg;
  constexpr bool kSumDist = kPhase == kDist || kPhase == kGfix;
  extern __shared__ float smem[];
  float* ys = smem;                       // [d][kTileP] target tile, fp32
                                          // (chunked: [kChunk][kTileP])
  float* xs = ys + (kChunked ? kChunk : d) * kTileP;  // [kWarps][d] queries
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
  // the output row of x and mr (of d) and of idx (of k): a grouped call's
  // group gi of batch b writes channels [gi*D, (gi+1)*D) of rows of g*D
  long long orow = qrow;
  if constexpr (kGrouped) {
    const int b = bg / groups;
    orow = ((long long)b * n + row) * groups + (bg - b * groups);
  }

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
  float dsum = 0.f;  // dist, gfix: this lane's distances, in column order

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int tw = min(kTile, m - j0);
    if constexpr (kChunked) {
      float acc0 = 0.f;
      float acc1 = 0.f;
      for (int e0 = 0; e0 < d; e0 += kChunk) {
        const int w = min(kChunk, d - e0);
        __syncthreads();  // the previous chunk (and xw on the first pass)
        const T* src = yn_b + (long long)j0 * d + e0;
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
      if (active) {  // as below: columns at or past tw are dropped
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
      continue;
    }
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
      if constexpr (kGrouped) {
        // The same sums in the same order, with each step's shared-memory
        // loads written ahead of its products. Written as the loop below,
        // this instantiation compiled to a schedule that interleaves them
        // and took longer than fold + folded kernel + unfold together at
        // the main path's shapes (stage 3: 2.74 against 2.22 ms); written
        // so, it takes 1-16 % less than the folded kernel alone
        // (chip_smoke.py phase 7; H100 80GB HBM3, 700 W).
        int e = 0;
        for (; e + 4 <= d; e += 4) {
          float xv[4], a[4], b[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            xv[u] = xw[e + u];
            a[u] = ys[(e + u) * kTileP + c0];
            b[u] = ys[(e + u) * kTileP + c1];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc0 = fmaf(xv[u], a[u], acc0);
            acc1 = fmaf(xv[u], b[u], acc1);
          }
        }
        for (; e < d; ++e) {
          const float xv = xw[e];
          acc0 = fmaf(xv, ys[e * kTileP + c0], acc0);
          acc1 = fmaf(xv, ys[e * kTileP + c1], acc1);
        }
      } else {
#pragma unroll 4
        for (int e = 0; e < d; ++e) {
          const float xv = xw[e];
          acc0 = fmaf(xv, ys[e * kTileP + c0], acc0);
          acc1 = fmaf(xv, ys[e * kTileP + c1], acc1);
        }
      }
      // columns at or past tw read stale shared memory and are dropped here
      if (c0 < tw) {
        float dist = xq - 2.f * acc0 + ysq_s[c0];
        if (brow != nullptr) dist += brow[j0 + c0];
        if constexpr (kSumDist) dsum += dist;
        if constexpr (kSelect) insert<KDM>(ld, lc, dist, j0 + c0);
      }
      if (c1 < tw) {
        float dist = xq - 2.f * acc1 + ysq_s[c1];
        if (brow != nullptr) dist += brow[j0 + c1];
        if constexpr (kSumDist) dsum += dist;
        if constexpr (kSelect) insert<KDM>(ld, lc, dist, j0 + c1);
      }
    }
  }
  if (!active) return;  // no block-wide barrier follows

  if constexpr (kPhase == kDist) {
    dsum = warp_sum(dsum);
    if (lane == 0) out[qrow] = dsum;
    return;
  }

  int* sel_w = sel + warp * KDM;
  if constexpr (kSelect) {
    // Warp merge: k*d rounds of a lexicographic min over the list heads.
    const int kd = k * dilation;
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
  } else {
    for (int s = lane; s < k; s += 32) sel_w[s] = kFixedColumn + s;
  }
  __syncwarp();

  // Gather the raw target rows and take max(y_j - x) in fp32; a grouped
  // call's targets are rows of g*D too.
  const T* y_b = y + (long long)bg * m * d;
  int ystride = d;
  if constexpr (kGrouped) {
    const int b = bg / groups;
    const int gi = bg - b * groups;
    y_b = y + (long long)b * m * groups * d + (long long)gi * d;
    ystride = groups * d;
  }
  const T* x_row = x + orow * d;
  float part = 0.f;  // the phases: this lane's channels of sum_D(acc)
  if constexpr (kGather) {
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f32(x_row[c]);
      float best = -INFINITY;
      for (int s = 0; s < k; ++s) {
        const float v = to_f32(y_b[(long long)sel_w[s] * ystride + c]) - xv;
        best = (v > best || v != v) ? v : best;  // NaN propagates, as amax
      }
      if constexpr (kPhase == kForward) {
        mr[orow * d + c] = from_f32<T>(best);
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
    if constexpr (kSumDist) res += warp_sum(dsum) * dist_weight;
    if (lane == 0) out[qrow] = res;
  }
}

// The CUDA-core kernel's dynamic shared memory: the transposed target tile
// (chunked: kChunk of its channels), the warps' query rows, y_sq and the
// selected columns.
size_t main_smem_bytes(int d, int kdm, bool chunked = false) {
  return sizeof(float) * ((size_t)(chunked ? kChunk : d) * kTileP +
                          (size_t)kWarps * d + kTile) +
         sizeof(int) * (size_t)kWarps * kdm;
}

// Whether the CUDA-core kernel takes the chunked scan: only where the
// whole tile does not fit (or when forced), so that every width that fits
// keeps its kernel.
bool main_chunked(int d, int kdm, bool force_chunked) {
  int dev = 0, optin = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return force_chunked || main_smem_bytes(d, kdm) > (size_t)optin;
}

template <typename T, int KDM, bool kGrouped, int kPhase = kForward,
          bool kChunked = false>
cudaError_t launch_main(const void* x, const void* y, const void* xn,
                        const void* yn, const void* xsq, const void* ysq,
                        const void* bias, int bias_mode, void* idx, void* mr,
                        int bg, int n, int m, int d, int k, int dilation,
                        int groups, cudaStream_t stream,
                        float acc_init = 0.f, float dist_weight = 0.f,
                        void* out = nullptr) {
  const size_t smem = main_smem_bytes(d, KDM, kChunked);
  if (smem > 48 * 1024) {  // above the default dynamic limit: opt in
    cudaError_t err = cudaFuncSetAttribute(
        knn_mr_kernel<T, KDM, kGrouped, kPhase, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bg, (n + kWarps - 1) / kWarps);
  knn_mr_kernel<T, KDM, kGrouped, kPhase, kChunked>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(xn), static_cast<const T*>(yn),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<const float*>(bias), bias_mode, static_cast<int*>(idx),
      static_cast<T*>(mr), n, m, d, k, dilation, groups, acc_init,
      dist_weight, static_cast<float*>(out));
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
// bf16, knn_select's for fp32. cudaErrorInvalidValue where none does.
template <typename T, int kMaxList, typename F>
cudaError_t with_lists(int kd, F f) {
  using std::integral_constant;
  const int len = std::is_same_v<T, __nv_bfloat16> ? knn_scan::list_slots(kd)
                                                   : kdm_bucket(kd);
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
                    cudaStream_t stream, bool force_chunked = false) {
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
    } else if (main_chunked(d, L, force_chunked)) {
      if constexpr (kGrouped) {
        return cudaErrorInvalidValue;  // the grouped kernel is not chunked
      } else {
        return launch_main<T, L, false, kForward, true>(
            x, y, xn, ynp, xsq, ysqp, bias, bias_mode, idx, mr, bg, n, m, d,
            k, dilation, groups, stream);
      }
    } else {
      return launch_main<T, L, kGrouped>(x, y, xn, ynp, xsq, ysqp, bias,
                                         bias_mode, idx, mr, bg, n, m, d, k,
                                         dilation, groups, stream);
    }
  });
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
    return launch_main<T, KDM, false, kPhase>(
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
// Requires 1 <= k * dilation <= min(m, 64). force_chunked: take the
// chunked scan at any width (its results are bitwise the unchunked
// kernel's); without it the chunked scan runs only where the whole-row
// layout does not fit. Returns a cudaError_t code.
int knn_mr_forward(const void* x, const void* y, const void* bias, void* xn,
                   void* yn, void* xsq, void* ysq, void* idx, void* mr,
                   int bg, int n, int m, int d, int k, int dilation,
                   int bias_mode, int is_bf16, int y_is_x, int force_chunked,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16, false>(x, y, bias, xn, yn, xsq, ysq, idx,
                                         mr, bg, n, m, d, k, dilation,
                                         bias_mode, y_is_x, 1, s,
                                         force_chunked != 0);
  return forward<float, false>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg, n,
                               m, d, k, dilation, bias_mode, y_is_x, 1, s,
                               force_chunked != 0);
}

// The fold-aware forward: x (b, n, groups*d), y (b, m, groups*d) unfolded,
// contiguous; group gi is channels [gi*d, (gi+1)*d) of every row. bias
// none (bias_mode 0) or shared (n, m) (bias_mode 1). xn/xsq and yn/ysq are
// folded scratch, (b*groups, n, d)/(b*groups, n) and (b*groups, m, d)/
// (b*groups, m); outputs idx (b, n, groups, k) int32 and mr
// (b, n, groups*d) of the input type: bitwise the folded forward's on the
// folded rows, unfolded. Returns a cudaError_t code.
int knn_mr_forward_grouped(const void* x, const void* y, const void* bias,
                           void* xn, void* yn, void* xsq, void* ysq,
                           void* idx, void* mr, int b, int groups, int n,
                           int m, int d, int k, int dilation, int bias_mode,
                           int is_bf16, int y_is_x, void* stream) {
  if (bias_mode == 2 || groups < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bg = b * groups;
  if (is_bf16)
    return forward<__nv_bfloat16, true>(x, y, bias, xn, yn, xsq, ysq, idx,
                                        mr, bg, n, m, d, k, dilation,
                                        bias_mode, y_is_x, groups, s);
  return forward<float, true>(x, y, bias, xn, yn, xsq, ysq, idx, mr, bg, n,
                              m, d, k, dilation, bias_mode, y_is_x, groups,
                              s);
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
// (force_chunked: as knn_mr_forward's): negative where that layout is the
// chunked one, 0 when k*d exceeds 64 or no block shape fits.
long long knn_mr_smem_bytes(int d, int kd, int is_bf16, int force_chunked) {
  if (is_bf16) {
    const int len = knn_scan::list_slots(kd);
    if (!len) return 0;
    const knn_scan::Config cfg = knn_scan::config(d, len, force_chunked != 0);
    return cfg.chunked ? -(long long)cfg.smem : cfg.smem;
  }
  const int kdm = kdm_bucket(kd);
  if (!kdm) return 0;
  const bool chunked = main_chunked(d, kdm, force_chunked != 0);
  const long long smem = (long long)main_smem_bytes(d, kdm, chunked);
  return chunked ? -smem : smem;
}

const char* knn_mr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
