// The bf16 target scan and selection shared by knn_mr.cu and knn_topk.cu,
// written for Hopper's tensor cores (sm_90a): for each query row, the
// k*d targets with the smallest fp32 distance x_sq - 2 <x, y> + y_sq
// (+ bias), in ascending (distance, column) order, the lower column first
// among equal distances, NaN distances after every number in column order.
//
// What bounds it on this card. At the main path's largest call (stage 1,
// BG=16, N=20736, M=1296, D=40) the distance products are 34 GFLOP (41 with
// D padded to 48): 0.04 ms at the bf16 tensor-core peak. The bytes are
// ~174 MB (0.05 ms), most of them the fp32 bias, which the 16 groups read
// again through L2 (1.7 GB). The selection compares 430 M candidates and
// keeps 9 per row. The CUDA-core scan this replaces (per-lane lists fed
// by fmaf from a transposed fp32 tile, which the fp32 kernels kept until
// knn_scan_f32.cuh) ran at 6.5 TFLOP/s and spent 40 % of its time inserting
// into lists whose tails rejected little. Here the scan, the selection
// and the gather each take about a third of the time, all far above the
// bound (PERF.md): the kernel is bound by instruction issue and latency,
// with 16 warps per SM.
//
// What the design does about that:
//   1. Products on the tensor cores. A block holds 16 query rows per warp
//      (4 warps where shared memory allows: config) and walks the targets
//      in tiles of kBN = 64 rows, staged in shared memory as bf16 by
//      cp.async, double-buffered, channels zero-padded to a multiple of 16, rows an odd number of
//      16-byte units apart so that ldmatrix has no bank conflicts. Each
//      warp computes its 16 x 64 tile with mma.sync.m16n8k16 (bf16 in,
//      fp32 accumulate; mma_bf16 below): each product is exact in fp32, as
//      on the TPU's matrix unit, and each distance takes the same mma steps
//      in the same order (the depth in chunks of 16, from zero) in every
//      kernel that includes this file.
//   2. The epilogue in registers: dist = x_sq - 2 * acc + y_sq (+ bias),
//      the bias read by the accumulator fragment's column pairs; the grid's
//      fastest axis is the batch-group axis, so the groups that share a
//      bias row run together and read it from L2.
//   3. A threshold for the whole row. Each row is owned by two lanes of the
//      quad that holds it in the mma layout, each with an ascending
//      register list of its best k*d (key, col) pairs among its half of
//      the columns (the key: the distance's bits in the numbers' order).
//      The list has KDM >= k*d slots; the first KDM - k*d are dead (key 0,
//      which nothing passes), so the last slot is the k*d-th best and
//      dropping it is exact. The row's threshold is the lower of its two
//      owners' last entries, at least the row's k*d-th best so far. The
//      quad compares each new distance against it (at or below: a loose
//      test is safe, the list decides), writes the tile to the warp's
//      shared scratch, and each owner inserts only the columns that passed
//      (16 bits per lane and row, gathered in column order), so a row pays
//      an insertion for about k*d*(1 + ln(M / 64)) of its M candidates.
//      Candidates arrive in column order, so an insertion compares keys
//      only. The top k*d of a total order does not depend on which lane
//      saw what, so the result is deterministic, with no atomics.
//   4. At the end each row's two lists are merged by one lane (a two-way
//      merge of k*d steps in (key, col) order), ranks 0, d, 2d, ... kept.
//      NaN never passes the threshold, so it never enters a list; a row
//      with fewer than k*d numbers runs out of them in the merge and takes
//      its NaN columns in column order from knn_select::select_nan_columns,
//      whose test for NaN does not depend on the order of the sum.
// A warp's rows are its own from the first tile to the last: its lists,
// its scratch and its merges need only the warp; the block's barriers are
// the tile loads', and one after the last tile frees the tile buffers for
// the merge.
//
// Wide rows (the chunked instantiation, kChunked). The layout above
// stages whole rows, 2 bytes a channel for each of up to 64 query rows and
// 2 x 64 target rows, so it stops fitting near D = 780 (arch b without
// channel groups has D = 1024). The chunked scan stages both the query
// rows and the target tiles kDC = 128 channels at a time, in a ring of two
// (target chunk, query chunk) buffers fed by cp.async: the pipeline's
// stages are the (tile, chunk) pairs in order, and each warp's mma
// accumulators carry a tile's products from one chunk to the next. The
// mma steps are the same, in the same order (the depth in chunks of 16,
// from zero), so a distance is bitwise the unchunked scan's, and so are
// idx, mr and knn_topk's values. Its staging does not grow with D; the
// merge region, which reuses it, holds 8 bytes a channel per warp (a NaN
// row's fp32 copy) and outgrows it past D ~2,200 at 4 warps, so the bf16
// kernels take D up to ~28,000 at 1 warp. It runs only where the
// unchunked layout does not fit (config), so every call that fitted keeps
// its kernel. scan_chunked shares no code with scan: a helper or lambda
// shared by both changes the instructions nvcc emits for scan, and the
// unchunked kernels are held to their SASS (tools/compare_sass.py).
//
// knn_topk(xn, yn, k*d)[..., ::d] is bitwise knn_mr's idx on the same
// normalized rows: both kernels take their distances and their selection
// from this file; chip_smoke.py checks it at every knn_mr shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "knn_select.cuh"

namespace knn_scan {
// Internal linkage, as each including file's own helpers would have.
namespace {

using bf16 = __nv_bfloat16;
using knn_select::kFull;

constexpr int kRows = 16;        // query rows per warp: one m16 tile
constexpr int kMaxWarps = 4;     // warps per block at most
constexpr int kBN = 64;          // target rows per shared-memory tile
constexpr int kSub = kBN / 8;    // n8 column blocks of a tile
constexpr int kDistStride = 72;  // fp32 words per row of a warp's distance
                                 // tile: conflict-free float2 stores
constexpr unsigned kEmpty = 0xffffffffu;  // key of an empty list slot
constexpr unsigned kDead = 0u;            // key of a slot past k*d
constexpr int kDC = 128;         // channels per stage of the chunked scan

// The list length a k*d takes (the template instantiations); 0 above 64.
inline int list_slots(int kd) {
  return kd <= 8    ? 8
         : kd <= 12 ? 12
         : kd <= 16 ? 16
         : kd <= 24 ? 24
         : kd <= 32 ? 32
         : kd <= 64 ? 64
                    : 0;
}

// Channels padded to the mma depth, and the shared-memory row stride in
// bf16 elements: 8 more, an odd number of 16-byte units per row.
__host__ __device__ inline int padded_depth(int d) {
  return (d + 15) / 16 * 16;
}
__host__ __device__ inline int row_stride(int d) {
  return padded_depth(d) + 8;
}

// A warp's share of the tile region once the scan is done: its lanes'
// lists for the merge (slot-major, 8 bytes a pair), then one fp32 query
// row for a NaN tail, then (knn_mr's phases) 16 rows of fp32 sums of
// 8 channels each.
__host__ __device__ inline int merge_bytes(int d, int kdm) {
  const int b = 32 * kdm * 8 > d * 8 ? 32 * kdm * 8 : d * 8;
  return (b + 15) / 16 * 16;
}

// Byte offsets into a block's dynamic shared memory.
struct Layout {
  int q;        // [warps * 16][row_stride] bf16 query rows
  int y;        // [2][kBN][row_stride] bf16 target tiles; after the
                // scan, [warps] merge_bytes
  int ysq;      // [2][kBN] fp32 y_sq of the tiles
  int dist;     // [warps][16][kDistStride] fp32 distance tiles
  int sel;      // [warps][16][kdm] int32 selected columns (knn_mr)
  int total;
};

__host__ __device__ inline Layout layout(int d, int kdm, int warps) {
  const int tiles = 2 * kBN * row_stride(d) * 2;
  const int merge = warps * merge_bytes(d, kdm);
  Layout l;
  l.q = 0;
  l.y = l.q + warps * kRows * row_stride(d) * 2;
  l.ysq = l.y + (tiles > merge ? tiles : merge);
  l.dist = l.ysq + 2 * kBN * 4;
  l.sel = l.dist + warps * kRows * kDistStride * 4;
  l.total = l.sel + warps * kRows * kdm * 4;
  return l;
}

// The chunked scan's layout: the same regions, but the target tiles and
// the query rows are staged kDC channels at a time, both in two buffers:
// y [2][kBN][row_stride(kDC)], then q [2][warps * 16][row_stride(kDC)];
// after the scan the merge region starts at y, as in layout.
__host__ __device__ inline Layout layout_chunked(int d, int kdm, int warps) {
  const int s = row_stride(kDC);
  const int staged = 2 * (kBN + warps * kRows) * s * 2;
  const int merge = warps * merge_bytes(d, kdm);
  Layout l;
  l.y = 0;
  l.q = l.y + 2 * kBN * s * 2;
  l.ysq = l.y + (staged > merge ? staged : merge);
  l.dist = l.ysq + 2 * kBN * 4;
  l.sel = l.dist + warps * kRows * kDistStride * 4;
  l.total = l.sel + warps * kRows * kdm * 4;
  return l;
}

template <bool kChunked>
__host__ __device__ inline Layout layout_for(int d, int kdm, int warps) {
  if constexpr (kChunked) {
    return layout_chunked(d, kdm, warps);
  } else {
    return layout(d, kdm, warps);
  }
}

// The launch shape: 4 warps per block where they fit in shared memory,
// else 2, else 1. A call has N / 16 warps per batch-group whatever the
// block, so fewer warps per block add no parallelism at small N: they only
// stage each tile more often (PERF.md has the measurements). Where no
// shape of the unchunked layout fits (bf16 rows of more than about 780
// channels), or with force_chunked, the chunked layout, whose size does
// not depend on D but for the merge's rows (4 warps at D = 1024 and
// k*d = 45: 104,960 bytes). smem is 0 when nothing fits.
struct Config {
  int warps;
  int smem;
  bool chunked;
};

inline Config config(int d, int kdm, bool force_chunked = false) {
  int dev = 0, optin = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int c = force_chunked ? 1 : 0; c < 2; ++c) {
    for (int warps = kMaxWarps; warps >= 1; warps >>= 1) {
      const int smem = c == 1 ? layout_chunked(d, kdm, warps).total
                                 : layout(d, kdm, warps).total;
      if (smem <= optin) return {warps, smem, c == 1};
    }
  }
  return {1, 0, false};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major): bf16 products,
// exact in fp32, summed into the fp32 accumulators by the tensor core.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A distance as an unsigned key in the order of the numbers: -inf lowest,
// +inf highest (kEmpty above it). -0 is taken as +0, as a comparison of the
// floats takes it. Never given a NaN: the filter lets none through.
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Insert (key, col) into a lane's ascending list, dropping its last entry,
// for a col above every col in the list: it goes after the entries of equal
// key, which keep their order. The entries from its place on move down one
// slot whatever their keys (comparing them as they move would let an entry
// pass others of equal key). Fully unrolled over constant indices, from
// the last slot up, so the list stays in registers.
template <int KDM>
__device__ __forceinline__ void insert_key(unsigned (&lk)[KDM],
                                           int (&lc)[KDM], unsigned key,
                                           int col) {
  if (!(key < lk[KDM - 1])) return;
#pragma unroll
  for (int p = KDM - 1; p > 0; --p) {
    if (key < lk[p]) {
      const bool here = !(key < lk[p - 1]);
      lk[p] = here ? key : lk[p - 1];
      lc[p] = here ? col : lc[p - 1];
    }
  }
  if (key < lk[0]) {
    lk[0] = key;
    lc[0] = col;
  }
}

// One block's share of a call: its batch-group's rows and their squares.
struct Rows {
  const bf16* xn;     // n x d normalized query rows
  const float* xsq;   // n
  const bf16* yn;     // m x d normalized target rows
  const float* ysq;   // m
  const float* bias;  // query row r's bias at bias + r * m, or nullptr
  int n, m, d;
};

// Copy `rows` rows of d channels from src (row stride d) to shared memory
// (row stride s): 16-byte cp.async where every row is 16-byte aligned,
// else element by element.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int d, int s) {
  if ((d & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = d >> 3;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int rr = i / chunks;
      const int cc = i - rr * chunks;
      cp_async16(dst + rr * s + cc * 8, src + (long long)rr * d + cc * 8);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      const int rr = i / d;
      const int e = i - rr * d;
      dst[rr * s + e] = src[(long long)rr * d + e];
    }
  }
}

// The chunked scan's copy: channels [c0, c0 + w) of `rows` rows of d
// channels from src to shared memory (row stride s), as stage_rows copies
// whole rows.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src,
                                            int rows, int d, int c0, int w,
                                            int s) {
  if ((d & 7) == 0 && (w & 7) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = w >> 3;
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int rr = i / chunks;
      const int cc = i - rr * chunks;
      cp_async16(dst + rr * s + cc * 8,
                 src + (long long)rr * d + c0 + cc * 8);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int rr = i / w;
      const int e = i - rr * w;
      dst[rr * s + e] = src[(long long)rr * d + c0 + e];
    }
  }
}

// Zero channels [d, padded_depth) of `rows` rows of stride s.
__device__ __forceinline__ void zero_padding(bf16* dst, int rows, int d,
                                             int s) {
  const int pad = padded_depth(d) - d;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int rr = i / pad;
    dst[rr * s + d + (i - rr * pad)] = __float2bfloat16_rn(0.f);
  }
}

// The distance of a query row to a target column, from the products' sum;
// the bias, where there is one, is added after.
__device__ __forceinline__ float distance(float xq, float dot, float ysq) {
  return xq - 2.f * dot + ysq;
}

// The rows a lane holds in the mma layout (warp-local: g and g + 8), and
// the row and half it owns for the selection: lanes 4g + 0 and 4g + 1 own
// row g, lanes 4g + 2 and 4g + 3 own row g + 8, each the columns that the
// lanes 4g + 2h and 4g + 2h + 1 of its quad hold (h = lane & 1): columns
// 8s + 4h + q of a tile, q < 4.
__device__ __forceinline__ int owned_row(int lane) {
  return (lane >> 2) + 8 * ((lane >> 1) & 1);
}

// The block's scan. Every thread of the block calls it: it holds the
// block's barriers, the last one after the last tile, so that the tile
// region is free for merge_rows. On return, with kSelect, each lane holds
// in lk/lc (ascending keys, the first KDM - kd slots dead) its best kd
// (distance, column) pairs of its owned row's half; with kSumDist,
// dsum_a/dsum_b hold the sums of the lane's distances of its rows g and
// g + 8 (over its columns only).
template <int KDM, bool kSelect, bool kSumDist>
__device__ __forceinline__ void scan(const Rows& r, int row0, int kd,
                                     unsigned char* smem,
                                     const Layout& lay, unsigned (&lk)[KDM],
                                     int (&lc)[KDM], float& dsum_a,
                                     float& dsum_b) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = lane & 1;
  const int s = row_stride(r.d);
  const int nk = padded_depth(r.d) >> 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* y_s = reinterpret_cast<bf16*>(smem + lay.y);
  float* ysq_s = reinterpret_cast<float*>(smem + lay.ysq);
  float* dist_w = reinterpret_cast<float*>(smem + lay.dist) +
                  warp * kRows * kDistStride;

  // The query rows, and zeros where the mma reads past the data: the
  // padding channels, and the query rows past n.
  const int rows_q = min(warps * kRows, r.n - row0);
  stage_rows(q_s, r.xn + (long long)row0 * r.d, rows_q, r.d, s);
  zero_padding(q_s, rows_q, r.d, s);
  for (int i = threadIdx.x; i < (warps * kRows - rows_q) * s;
       i += blockDim.x) {
    q_s[rows_q * s + i] = __float2bfloat16_rn(0.f);
  }
  zero_padding(y_s, 2 * kBN, r.d, s);

  const int tiles = (r.m + kBN - 1) / kBN;
  auto load_tile = [&](int tile, int slot) {
    const int j0 = tile * kBN;
    const int tw = min(kBN, r.m - j0);
    stage_rows(y_s + slot * kBN * s, r.yn + (long long)j0 * r.d, tw, r.d, s);
    float* dst = ysq_s + slot * kBN;
    for (int i = threadIdx.x; i < tw; i += blockDim.x) {
      cp_async4(dst + i, r.ysq + j0 + i);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const bool active = row0 + warp * kRows < r.n;  // warp-uniform
  const int ra = min(row0 + warp * kRows + g, r.n - 1);  // clamped rows:
  const int rb = min(row0 + warp * kRows + g + 8, r.n - 1);  // safe reads
  const float xq_a = r.xsq[ra];
  const float xq_b = r.xsq[rb];
  const float* brow_a = r.bias != nullptr ? r.bias + (long long)ra * r.m
                                          : nullptr;
  const float* brow_b = r.bias != nullptr ? r.bias + (long long)rb * r.m
                                          : nullptr;
  const bool pairs =  // bias column pairs 8-byte aligned
      (r.m & 1) == 0 && (reinterpret_cast<uintptr_t>(r.bias) & 7) == 0;

#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    const bool dead = p < KDM - kd;
    lk[p] = dead ? kDead : kEmpty;
    lc[p] = dead ? INT_MIN : INT_MAX;
  }
  // the thresholds of rows g and g + 8: a distance passes at or below
  float td_a = INFINITY, td_b = INFINITY;
  const float* drow = dist_w + owned_row(lane) * kDistStride;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait_all();
    __syncthreads();  // the tile landed; the other buffer is free
    const int slot = tile & 1;
    if (tile + 1 < tiles) {
      load_tile(tile + 1, slot ^ 1);
      cp_async_commit();
    }
    if (active) {
      const int j0 = tile * kBN;
      const int tw = min(kBN, r.m - j0);
      const bf16* yt = y_s + slot * kBN * s;
      const float* yq = ysq_s + slot * kBN;
      float acc[kSub][4];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
      const bf16* qa = q_s + (warp * kRows + (lane & 15)) * s +
                       ((lane >> 4) << 3);
      const bf16* yb = yt + ((lane & 7) + ((lane >> 4) << 3)) * s +
                       (((lane >> 3) & 1) << 3);
      for (int ks = 0; ks < nk; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, qa + ks * 16);
#pragma unroll
        for (int sp = 0; sp < kSub / 2; ++sp) {
          unsigned b[4];
          ldmatrix_x4(b, yb + sp * 16 * s + ks * 16);
          mma_bf16(acc[2 * sp], a, b[0], b[1]);
          mma_bf16(acc[2 * sp + 1], a, b[2], b[3]);
        }
      }

      // pass bits: column 8 sub + 2t + c of row g at bit 4 sub + c, of row
      // g + 8 two bits above
      unsigned pass = 0u;
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        const int cl = sub * 8 + 2 * t;  // tile-local column of c0; c1 next
        const float2 yq2 = *reinterpret_cast<const float2*>(yq + cl);
        float da0 = distance(xq_a, acc[sub][0], yq2.x);
        float da1 = distance(xq_a, acc[sub][1], yq2.y);
        float db0 = distance(xq_b, acc[sub][2], yq2.x);
        float db1 = distance(xq_b, acc[sub][3], yq2.y);
        const bool v0 = cl < tw;
        const bool v1 = cl + 1 < tw;
        if (brow_a != nullptr) {  // warp-uniform
          const int j = j0 + cl;
          float ba0 = 0.f, ba1 = 0.f, bb0 = 0.f, bb1 = 0.f;
          if (pairs) {
            if (v0) {
              const float2 pa = *reinterpret_cast<const float2*>(brow_a + j);
              const float2 pb = *reinterpret_cast<const float2*>(brow_b + j);
              ba0 = pa.x;
              ba1 = pa.y;
              bb0 = pb.x;
              bb1 = pb.y;
            }
          } else {
            if (v0) {
              ba0 = brow_a[j];
              bb0 = brow_b[j];
            }
            if (v1) {
              ba1 = brow_a[j + 1];
              bb1 = brow_b[j + 1];
            }
          }
          da0 += ba0;
          da1 += ba1;
          db0 += bb0;
          db1 += bb1;
        }
        if constexpr (kSumDist) {
          if (v0) {
            dsum_a += da0;
            dsum_b += db0;
          }
          if (v1) {
            dsum_a += da1;
            dsum_b += db1;
          }
        }
        if constexpr (kSelect) {
          pass |= (unsigned)(da0 <= td_a) << (4 * sub);
          pass |= (unsigned)(da1 <= td_a) << (4 * sub + 1);
          pass |= (unsigned)(db0 <= td_b) << (4 * sub + 2);
          pass |= (unsigned)(db1 <= td_b) << (4 * sub + 3);
          *reinterpret_cast<float2*>(dist_w + g * kDistStride + cl) =
              make_float2(da0, da1);
          *reinterpret_cast<float2*>(dist_w + (g + 8) * kDistStride + cl) =
              make_float2(db0, db1);
        }
      }

      if constexpr (kSelect) {
        if (tw < kBN) {  // the last tile: drop the columns past m
          unsigned valid = 0u;
#pragma unroll
          for (int sub = 0; sub < kSub; ++sub) {
            const int cl = sub * 8 + 2 * t;
            valid |= (cl < tw ? 5u : 0u) << (4 * sub);
            valid |= (cl + 1 < tw ? 10u : 0u) << (4 * sub);
          }
          pass &= valid;
        }
        __syncwarp();  // the warp's distance tile written
        // The owner's candidates, in column order: bit 4 sub + q for
        // column 8 sub + 4h + q, from its two source lanes' bits of its row.
        const unsigned w0 = __shfl_sync(kFull, pass, 4 * g + 2 * h);
        const unsigned w1 = __shfl_sync(kFull, pass, 4 * g + 2 * h + 1);
        const int sh = (t >> 1) * 2;
        unsigned cand = ((w0 >> sh) & 0x33333333u) |
                        (((w1 >> sh) & 0x33333333u) << 2);
        while (cand != 0u) {
          const int bit = __ffs(cand) - 1;
          cand &= cand - 1u;
          const int cl = (bit >> 2) * 8 + 4 * h + (bit & 3);
          insert_key<KDM>(lk, lc, key_of(drow[cl]), j0 + cl);
        }
        // the row's threshold: the lower of its two owners' last entries
        unsigned tk = lk[KDM - 1];
        tk = min(tk, __shfl_xor_sync(kFull, tk, 1));
        const float td = tk == kEmpty ? INFINITY : from_key(tk);
        td_a = __shfl_sync(kFull, td, 4 * g);
        td_b = __shfl_sync(kFull, td, 4 * g + 2);
      }
    }
  }
  __syncthreads();  // every warp done with the tiles: the region is free
}

// scan's work on one tile once a warp's products are in acc: the
// distances (acc holds <x, y> of rows g and g + 8 with the tile's columns
// 8 sub + 2t and 8 sub + 2t + 1), the distance sums, and the selection into
// the lanes' lists, with the rows' thresholds td_a / td_b: scan's tile
// loop, line for line, for scan_chunked (scan keeps its own copy, see the
// top of the file).
template <int KDM, bool kSelect, bool kSumDist>
__device__ __forceinline__ void take_tile(
    const float (&acc)[kSub][4], const float* yq, int j0, int tw,
    float xq_a, float xq_b, const float* brow_a, const float* brow_b,
    bool pairs, float* dist_w, const float* drow, unsigned (&lk)[KDM],
    int (&lc)[KDM], float& td_a, float& td_b, float& dsum_a,
    float& dsum_b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = lane & 1;
  // pass bits: column 8 sub + 2t + c of row g at bit 4 sub + c, of row
  // g + 8 two bits above
  unsigned pass = 0u;
#pragma unroll
  for (int sub = 0; sub < kSub; ++sub) {
    const int cl = sub * 8 + 2 * t;  // tile-local column of c0; c1 next
    const float2 yq2 = *reinterpret_cast<const float2*>(yq + cl);
    float da0 = distance(xq_a, acc[sub][0], yq2.x);
    float da1 = distance(xq_a, acc[sub][1], yq2.y);
    float db0 = distance(xq_b, acc[sub][2], yq2.x);
    float db1 = distance(xq_b, acc[sub][3], yq2.y);
    const bool v0 = cl < tw;
    const bool v1 = cl + 1 < tw;
    if (brow_a != nullptr) {  // warp-uniform
      const int j = j0 + cl;
      float ba0 = 0.f, ba1 = 0.f, bb0 = 0.f, bb1 = 0.f;
      if (pairs) {
        if (v0) {
          const float2 pa = *reinterpret_cast<const float2*>(brow_a + j);
          const float2 pb = *reinterpret_cast<const float2*>(brow_b + j);
          ba0 = pa.x;
          ba1 = pa.y;
          bb0 = pb.x;
          bb1 = pb.y;
        }
      } else {
        if (v0) {
          ba0 = brow_a[j];
          bb0 = brow_b[j];
        }
        if (v1) {
          ba1 = brow_a[j + 1];
          bb1 = brow_b[j + 1];
        }
      }
      da0 += ba0;
      da1 += ba1;
      db0 += bb0;
      db1 += bb1;
    }
    if constexpr (kSumDist) {
      if (v0) {
        dsum_a += da0;
        dsum_b += db0;
      }
      if (v1) {
        dsum_a += da1;
        dsum_b += db1;
      }
    }
    if constexpr (kSelect) {
      pass |= (unsigned)(da0 <= td_a) << (4 * sub);
      pass |= (unsigned)(da1 <= td_a) << (4 * sub + 1);
      pass |= (unsigned)(db0 <= td_b) << (4 * sub + 2);
      pass |= (unsigned)(db1 <= td_b) << (4 * sub + 3);
      *reinterpret_cast<float2*>(dist_w + g * kDistStride + cl) =
          make_float2(da0, da1);
      *reinterpret_cast<float2*>(dist_w + (g + 8) * kDistStride + cl) =
          make_float2(db0, db1);
    }
  }

  if constexpr (kSelect) {
    if (tw < kBN) {  // the last tile: drop the columns past m
      unsigned valid = 0u;
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        const int cl = sub * 8 + 2 * t;
        valid |= (cl < tw ? 5u : 0u) << (4 * sub);
        valid |= (cl + 1 < tw ? 10u : 0u) << (4 * sub);
      }
      pass &= valid;
    }
    __syncwarp();  // the warp's distance tile written
    // The owner's candidates, in column order: bit 4 sub + q for
    // column 8 sub + 4h + q, from its two source lanes' bits of its row.
    const unsigned w0 = __shfl_sync(kFull, pass, 4 * g + 2 * h);
    const unsigned w1 = __shfl_sync(kFull, pass, 4 * g + 2 * h + 1);
    const int sh = (t >> 1) * 2;
    unsigned cand = ((w0 >> sh) & 0x33333333u) |
                    (((w1 >> sh) & 0x33333333u) << 2);
    while (cand != 0u) {
      const int bit = __ffs(cand) - 1;
      cand &= cand - 1u;
      const int cl = (bit >> 2) * 8 + 4 * h + (bit & 3);
      insert_key<KDM>(lk, lc, key_of(drow[cl]), j0 + cl);
    }
    // the row's threshold: the lower of its two owners' last entries
    unsigned tk = lk[KDM - 1];
    tk = min(tk, __shfl_xor_sync(kFull, tk, 1));
    const float td = tk == kEmpty ? INFINITY : from_key(tk);
    td_a = __shfl_sync(kFull, td, 4 * g);
    td_b = __shfl_sync(kFull, td, 4 * g + 2);
  }
}

// scan for rows too wide for its layout (layout_chunked; see the top of
// the file): the same contract, the same barriers (the last one after the
// last tile frees the staging for merge_rows), and each tile's products
// accumulated over its kDC-channel chunks before take_tile.
template <int KDM, bool kSelect, bool kSumDist>
__device__ __forceinline__ void scan_chunked(const Rows& r, int row0, int kd,
                                             unsigned char* smem,
                                             const Layout& lay,
                                             unsigned (&lk)[KDM],
                                             int (&lc)[KDM], float& dsum_a,
                                             float& dsum_b) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int s = row_stride(kDC);
  bf16* q_s = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* y_s = reinterpret_cast<bf16*>(smem + lay.y);
  float* ysq_s = reinterpret_cast<float*>(smem + lay.ysq);
  float* dist_w = reinterpret_cast<float*>(smem + lay.dist) +
                  warp * kRows * kDistStride;

  // zeros in the query rows past n, in both buffers (the chunks fill the
  // rows_q rows)
  const int rows_q = min(warps * kRows, r.n - row0);
  const int q_buf = warps * kRows * s;  // one query buffer
  const int pad = (warps * kRows - rows_q) * s;
  for (int i = threadIdx.x; i < 2 * pad; i += blockDim.x) {
    const int b = i / pad;
    q_s[b * q_buf + rows_q * s + i - b * pad] = __float2bfloat16_rn(0.f);
  }

  // stage st is chunk st % nch of tile st / nch; the tile's y_sq lands
  // with its last chunk, in that stage's slot
  const int tiles = (r.m + kBN - 1) / kBN;
  const int nch = (r.d + kDC - 1) / kDC;
  auto load_stage = [&](int st, int slot) {
    const int tile = st / nch;
    const int c0 = (st - tile * nch) * kDC;
    const int w = min(kDC, r.d - c0);
    const int j0 = tile * kBN;
    const int tw = min(kBN, r.m - j0);
    bf16* qd = q_s + slot * q_buf;
    bf16* yd = y_s + slot * kBN * s;
    stage_chunk(qd, r.xn + (long long)row0 * r.d, rows_q, r.d, c0, w, s);
    stage_chunk(yd, r.yn + (long long)j0 * r.d, tw, r.d, c0, w, s);
    zero_padding(qd, rows_q, w, s);  // channels [w, padded_depth(w))
    zero_padding(yd, tw, w, s);
    if (c0 + w == r.d) {
      float* dst = ysq_s + slot * kBN;
      for (int i = threadIdx.x; i < tw; i += blockDim.x) {
        cp_async4(dst + i, r.ysq + j0 + i);
      }
    }
  };
  load_stage(0, 0);
  cp_async_commit();

  const bool active = row0 + warp * kRows < r.n;  // warp-uniform
  const int ra = min(row0 + warp * kRows + g, r.n - 1);  // clamped rows:
  const int rb = min(row0 + warp * kRows + g + 8, r.n - 1);  // safe reads
  const float xq_a = r.xsq[ra];
  const float xq_b = r.xsq[rb];
  const float* brow_a = r.bias != nullptr ? r.bias + (long long)ra * r.m
                                          : nullptr;
  const float* brow_b = r.bias != nullptr ? r.bias + (long long)rb * r.m
                                          : nullptr;
  const bool pairs =  // bias column pairs 8-byte aligned
      (r.m & 1) == 0 && (reinterpret_cast<uintptr_t>(r.bias) & 7) == 0;

#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    const bool dead = p < KDM - kd;
    lk[p] = dead ? kDead : kEmpty;
    lc[p] = dead ? INT_MIN : INT_MAX;
  }
  // the thresholds of rows g and g + 8: a distance passes at or below
  float td_a = INFINITY, td_b = INFINITY;
  const float* drow = dist_w + owned_row(lane) * kDistStride;

  int st = 0;  // the pipeline's stage
  for (int tile = 0; tile < tiles; ++tile) {
    float acc[kSub][4];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    int slot = 0;
    for (int ch = 0; ch < nch; ++ch, ++st) {
      cp_async_wait_all();
      __syncthreads();  // the stage landed; the other buffers are free
      slot = st & 1;
      if (st + 1 < tiles * nch) {
        load_stage(st + 1, slot ^ 1);
        cp_async_commit();
      }
      if (active) {
        const bf16* qa = q_s + slot * q_buf +
                         (warp * kRows + (lane & 15)) * s +
                         ((lane >> 4) << 3);
        const bf16* yb = y_s + slot * kBN * s +
                         ((lane & 7) + ((lane >> 4) << 3)) * s +
                         (((lane >> 3) & 1) << 3);
        const int nks = padded_depth(min(kDC, r.d - ch * kDC)) >> 4;
        for (int ks = 0; ks < nks; ++ks) {
          unsigned a[4];
          ldmatrix_x4(a, qa + ks * 16);
#pragma unroll
          for (int sp = 0; sp < kSub / 2; ++sp) {
            unsigned bb[4];
            ldmatrix_x4(bb, yb + sp * 16 * s + ks * 16);
            mma_bf16(acc[2 * sp], a, bb[0], bb[1]);
            mma_bf16(acc[2 * sp + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    if (active) {
      const int j0 = tile * kBN;
      take_tile<KDM, kSelect, kSumDist>(
          acc, ysq_s + slot * kBN, j0, min(kBN, r.m - j0), xq_a, xq_b,
          brow_a, brow_b, pairs, dist_w, drow, lk, lc, td_a, td_b, dsum_a,
          dsum_b);
    }
  }
  __syncthreads();  // every warp done with the stages: the region is free
}

// Lexicographic (key, column) order, for merging two lanes' lists.
__device__ __forceinline__ bool key_less(unsigned k1, int c1, unsigned k2,
                                         int c2) {
  return k1 < k2 || (k1 == k2 && c1 < c2);
}

// After scan<KDM, true, ...>: merge each row's two lists and write its
// ranks 0, d, 2d, ... (dilation d) as rank / d into sel_w (row stride
// sel_stride, warp-local rows) and, unless vals_w is nullptr, every rank's
// distance into vals_w (same stride); rows at or past n are skipped. A row
// with fewer than kd numbers takes its NaN columns in column order
// (select_nan_columns), with NaN distances. The warp calls it whole.
// kChunked: after scan_chunked, which staged no whole query row.
template <int KDM, bool kChunked = false>
__device__ __forceinline__ void merge_rows(const Rows& r, int row0, int kd,
                                           int dilation, unsigned char* smem,
                                           const Layout& lay,
                                           const unsigned (&lk)[KDM],
                                           const int (&lc)[KDM], int* sel_w,
                                           int sel_stride, float* vals_w) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = row_stride(r.d);
  unsigned char* mine = smem + lay.y + warp * merge_bytes(r.d, KDM);
  const bf16* q_s = reinterpret_cast<const bf16*>(smem + lay.q);
  const int wrow0 = row0 + warp * kRows;  // the warp's first query row

  uint2* lists = reinterpret_cast<uint2*>(mine);
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    if (p >= KDM - kd) {
      lists[(p - (KDM - kd)) * 32 + lane] = make_uint2(lk[p], lc[p]);
    }
  }
  __syncwarp();

  const int orow = owned_row(lane);
  int nan_from = kd;  // the rank at which the row's numbers ran out
  if ((lane & 1) == 0 && wrow0 + orow < r.n) {
    int* sel_row = sel_w + orow * sel_stride;
    float* val_row = vals_w != nullptr ? vals_w + orow * sel_stride : nullptr;
    int i = 0, j = 0;  // i + j = rank < kd: neither list is read past kd
    for (int rank = 0; rank < kd; ++rank) {
      const uint2 a = lists[i * 32 + lane];
      const uint2 b = lists[j * 32 + lane + 1];
      const bool take_b = key_less(b.x, (int)b.y, a.x, (int)a.y);
      const unsigned kv = take_b ? b.x : a.x;
      const int cv = (int)(take_b ? b.y : a.y);
      if (cv == INT_MAX) {  // both lists empty
        nan_from = rank;
        break;
      }
      if (rank % dilation == 0) sel_row[rank / dilation] = cv;
      if (val_row != nullptr) val_row[rank] = from_key(kv);
      i += !take_b;
      j += take_b;
    }
  }
  unsigned need = __ballot_sync(kFull, nan_from < kd);
  float* xw = reinterpret_cast<float*>(mine);
  while (need != 0u) {  // warp-uniform
    const int src = __ffs(need) - 1;
    need &= need - 1u;
    const int rank = __shfl_sync(kFull, nan_from, src);
    const int row = owned_row(src);
    const int qr = wrow0 + row;
    __syncwarp();  // the lists (or the previous row's query) read
    if constexpr (kChunked) {
      for (int e = lane; e < r.d; e += 32) {
        xw[e] = __bfloat162float(r.xn[(long long)qr * r.d + e]);
      }
    } else {
      for (int e = lane; e < r.d; e += 32) {
        xw[e] = __bfloat162float(q_s[(warp * kRows + row) * s + e]);
      }
    }
    __syncwarp();
    knn_select::select_nan_columns<bf16>(
        rank, kd, dilation, xw, r.xsq[qr], r.yn, r.ysq,
        r.bias != nullptr ? r.bias + (long long)qr * r.m : nullptr, r.m, r.d,
        lane, sel_w + row * sel_stride);
    if (vals_w != nullptr) {
      for (int v = rank + lane; v < kd; v += 32) {
        vals_w[row * sel_stride + v] = NAN;
      }
    }
  }
  __syncwarp();
}

}  // namespace
}  // namespace knn_scan
