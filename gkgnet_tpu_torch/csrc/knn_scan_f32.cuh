// The fp32 target scan and selection shared by knn_mr.cu and knn_topk.cu
// (knn_mr_kernel, its grouped and phase instantiations, and
// knn_topk_kernel), written for Hopper's CUDA cores (sm_90a): for each query
// row, the k*d targets with the smallest fp32 distance
// x_sq - 2 <x, y> + y_sq (+ bias), in ascending (distance, column) order,
// the lower column first among equal distances, NaN distances after every
// number in column order.
//
// Every distance is bitwise the one the CUDA-core kernels of PRs 5-14
// computed: its dot product is one fmaf chain over the channels 0..D-1 in
// order, from 0.f, and the epilogue is x_sq - 2.f * dot + y_sq with the bias
// added after. No TF32 and no tensor-core split: either changes the bits,
// and TF32 breaks the 1e-4 fp64 ordering oracle. So idx, mr, knn_topk's
// values and the phase tool's checksums are those kernels' too.
//
// What bounds it on this card. Arch b's ungrouped stage 4 (BG 8,
// N = M = 324, D = 1024) is 1.72 GFLOP: 0.026 ms at the 67 TFLOP/s FFMA
// peak; its bytes (the rows and the bias, ~21 MB) 0.006 ms. The design it
// replaces ran the products at 1-4 TFLOP/s: one query row per warp, two
// target columns per lane, three shared-memory loads per two fmaf, the tile
// staged by plain loads between two barriers, and each lane inserting every
// candidate into a sorted 64-slot register list. This one is bound by
// shared-memory bandwidth: a 4 x 4 micro-tile takes 8 LDS.128 (32
// wavefronts of 128 bytes a warp) per 64 fmaf (16 issue cycles of the SM's
// four schedulers), so at most half the FFMA peak; and at the small calls
// by the grid (that call fills 88 of the 132 SMs with its best block). It
// runs that call at 9 TFLOP/s (PERF.md; H100 80GB HBM3, 700 W).
//
// What the design does about it:
//   1. Register-blocked FFMA. A block holds `rows` query rows (8-64) and
//      `groups` column groups (1, 2 or 4; 4 * rows * groups <= 256
//      threads); it walks the targets in wide tiles of 64 * groups columns,
//      column group g taking columns [64 g, 64 g + 64) of each. A thread of
//      group g owns a 4 x 4 micro-tile: query rows 4 ty + i and columns
//      tx + 16 j (ty = its index in the group / 16, tx = that % 16). Per
//      4 channels it loads its 4 query rows and its 4 target rows as float4
//      (8 LDS.128: the query loads are broadcasts, the target rows of a
//      quarter-warp 36 floats apart, so in distinct 16-byte bank groups) and
//      issues 64 fmaf, channel by channel, so each accumulator takes its
//      products in channel order.
//   2. Staging by cp.async, one layout for every D. Each pipeline stage is
//      one (wide tile, 32-channel chunk) pair: the block's query rows and
//      the tile's target rows, channels [32 c, 32 c + 32), rows 36 floats
//      apart, in a ring of kStages stages (16-byte copies where rows are
//      16-byte aligned, else 4-byte ones). The accumulators carry a tile's
//      products from one chunk to the next. A last chunk that is not a
//      multiple of 4 channels is padded with zeros, whose fmaf(0, 0, acc)
//      leaves every distance's bits as they are (pad_note below). The
//      staging does not grow with D, so every D takes this one layout.
//   3. A threshold for each row (knn_scan.cuh's steps 3-4 with other
//      owners). After a tile's last chunk each thread writes its 16
//      distances to its group's shared scratch. Four lanes of the group own
//      a row, each the 16 columns 16 q .. 16 q + 15 of every tile, with an
//      ascending register list of its best k*d (key, col) pairs (KDM >= k*d
//      slots, the first KDM - k*d dead, so the last slot is its k*d-th best;
//      the key is the distance's bits in the numbers' order). The row's
//      threshold is the lowest of its four owners' last keys; an owner
//      inserts only the columns at or below it, in column order, so a row
//      pays an insertion for about k*d (1 + ln(M / 64)) of its candidates.
//      Lists of 8, 16, 32, 48 or 64 slots (list_slots): 48 for arch b's
//      k*d = 45 keeps that instantiation at 242 registers, without spills.
//   4. At the end each row's 4 * groups lists are merged by one lane
//      (k*d steps in (key, col) order; knn_mr keeps ranks 0, d, 2d, ...).
//      NaN never passes a threshold; a row with fewer than k*d numbers runs
//      out of them in the merge and takes its NaN columns in column order
//      from knn_select::select_nan_columns. The top k*d of a total order
//      does not depend on which lane saw what: deterministic, no atomics.
//   5. A grid that fills the card (config): the block's rows and column
//      groups chosen by shape on the host, from an estimate of the busiest
//      SM's work, so that calls with few query rows (arch b's D = 1024
//      calls, 2,592 rows; the label calls, 80 a batch-group) split the
//      targets over column groups, and calls with many keep 64 rows a
//      block. The grid's fastest axis is the batch-group axis, so the
//      groups that share a bias row read it from L2. The result does not
//      depend on the block (tests and chip_smoke.py force other choices
//      and compare bits).
// The phase tool's dist and gfix checksums sum a row's distances as the
// old kernel's lanes did (lane L: columns L and L + 32 of each 64-column
// tile, in tile order, then a butterfly over the 32 lanes): a half-warp of
// one column group holds exactly those columns (tx and tx + 16), so with
// one column group the sums are taken in that order (sum_rows).
//
// pad_note: acc starts at +0 and each step rounds x*y + acc once; a zero
// sum of a nonzero product and acc rounds to +0, so acc is -0 only after
// a product that underflows to -0 from +0. Then fmaf(0, 0, -0) is +0, but
// x_sq - 2 * acc is the same for both zeros (x_sq >= +0), so every
// distance keeps its bits.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "knn_scan.cuh"
#include "knn_select.cuh"

namespace knn_f32 {
// Internal linkage, as each including file's own helpers would have.
namespace {

using knn_scan::cp_async16;
using knn_scan::cp_async4;
using knn_scan::cp_async_commit;
using knn_scan::from_key;
using knn_scan::insert_key;
using knn_scan::kDead;
using knn_scan::kEmpty;
using knn_scan::key_less;
using knn_scan::key_of;
using knn_select::kFull;

constexpr int kTn = 64;            // target columns per tile of a group
constexpr int kCh = 32;            // channels per pipeline stage
constexpr int kStride = kCh + 4;   // floats per staged row: 4 banks apart
constexpr int kStages = 3;         // the cp.async ring
constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 4;
constexpr int kDistStride = 68;    // floats per row of a distance tile
constexpr int kMaxHeads = 4 * kMaxGroups;  // lists merged per row
// config's weight of a staged row (per channel) against one product: the
// fit of time_kernels.py --blocks on an H100 80GB HBM3 (label 1's (8, 4)
// block against its (16, 4): 1.58x)
constexpr int kStageCost = 24;

// The list length a k*d takes (the template instantiations); 0 above 64.
// 48 for arch b's k*d = 45: 32 registers a thread fewer than 64.
inline int list_slots(int kd) {
  return kd <= 8    ? 8
         : kd <= 16 ? 16
         : kd <= 32 ? 32
         : kd <= 48 ? 48
         : kd <= 64 ? 64
                    : 0;
}

// One block's share of a call: its batch-group's rows and their squares.
struct Rows {
  const float* xn;    // n x d normalized query rows
  const float* xsq;   // n
  const float* yn;    // m x d normalized target rows
  const float* ysq;   // m
  const float* bias;  // query row r's bias at bias + r * m, or nullptr
  int n, m, d;
};

// Byte offsets into a block's dynamic shared memory.
struct Layout {
  int ring;   // [kStages][rows + 64 groups][kStride] fp32 query and
              // target chunks; after the scan, the merge's lists:
              // [warps][KDM][32] (key, col) pairs
  int ysq;    // [kStages][64 groups] fp32 y_sq of the tiles
  int dist;   // [groups][rows][kDistStride] fp32 distance tiles
  int dsum;   // [rows] fp32 distance sums (the phases)
  int sel;    // [rows][kdm] int32 selected columns (knn_mr)
  int total;
};

__host__ __device__ inline Layout layout(int rows, int groups, int kdm) {
  const int ring = kStages * (rows + kTn * groups) * kStride * 4;
  const int lists = rows * groups / 8 * 32 * kdm * 8;  // warps x 32 lanes
  Layout l;
  l.ring = 0;
  l.ysq = ring > lists ? ring : lists;
  l.dist = l.ysq + kStages * kTn * groups * 4;
  l.dsum = l.dist + groups * rows * kDistStride * 4;
  l.sel = l.dsum + rows * 4;
  l.total = l.sel + rows * kdm * 4;
  return l;
}

// The launch shape: `rows` query rows and `groups` column groups per block
// of 4 * rows * groups threads, and its dynamic shared memory (0 when the
// shape is not one the kernels take or does not fit).
struct Config {
  int rows;
  int groups;
  int smem;
};

// The block for bg batch-groups of n query rows and m targets at list
// length kdm. The phases (with_groups false) keep one column group, for
// their sums' order, and 64 query rows a block, halved while the grid has
// fewer blocks than the card has SMs, down to 8. The forward takes the
// 256-thread block (64, 1), (32, 2) or (16, 4) whose estimate is lowest:
// for the SM that runs the most blocks (waves x blocks resident per SM: one
// where a list of more than 16 slots takes more than 128 registers a
// thread, else two), its wide tiles x (the tile's products, rows x columns,
// + kStageCost x the rows it stages). So small calls split the targets
// over column groups and large ones keep the most rows per staged tile:
// arch b's D = 1024 stage 4 takes (32, 2), its label call and s@576's
// label 1 (16, 4), s@576's stage 1 (64, 1) (time_kernels.py --blocks, H100
// 80GB HBM3, 700 W: within 25 % of the fastest block at every shape it
// times).
// force_rows / force_groups (nonzero) replace either choice.
inline Config config(int bg, int n, int m, int kdm, bool with_groups,
                     int force_rows = 0, int force_groups = 0) {
  int dev = 0, sms = 132, optin = 232448;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int rows = 64, groups = 1;
  if (!with_groups) {
    while (rows > 8 && (long long)bg * ((n + rows - 1) / rows) < sms) {
      rows /= 2;
    }
  } else {
    const long long resident = kdm <= 16 ? 2 : 1;  // blocks per SM
    long long best = -1;
    for (int g = 1; g <= kMaxGroups; g *= 2) {
      const int r = 64 / g;
      const long long blocks = (long long)bg * ((n + r - 1) / r);
      const long long waves = (blocks + resident * sms - 1) /
                              (resident * sms);
      const long long wide = (long long)kTn * g;
      const long long cost = waves * resident * ((m + wide - 1) / wide) *
                             (r * wide + kStageCost * (r + wide));
      if (best < 0 || cost < best) {
        best = cost;
        rows = r;
        groups = g;
      }
    }
  }
  if (force_rows) rows = force_rows;
  if (force_groups) groups = force_groups;
  const bool ok = (rows == 8 || rows == 16 || rows == 32 || rows == 64) &&
                  (groups == 1 || groups == 2 || groups == 4) &&
                  4 * rows * groups <= kMaxThreads &&
                  (with_groups || groups == 1) && kdm > 0;
  const int smem = ok ? layout(rows, groups, kdm).total : 0;
  return {rows, groups, smem <= optin ? smem : 0};
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy channels [0, w) of `rows` rows (row stride d, from src) into shared
// memory (row stride kStride), and zeros into channels [w, w rounded up to
// 4). 16-byte cp.async where every row is 16-byte aligned, else 4-byte.
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int rows, int d, int w,
                                            bool vec) {
  if (vec && w == kCh) {  // a whole chunk: 8 16-byte copies a row
    for (int i = threadIdx.x; i < rows * (kCh / 4); i += blockDim.x) {
      const int rr = i >> 3;
      const int c4 = (i & 7) << 2;
      cp_async16(dst + rr * kStride + c4, src + (long long)rr * d + c4);
    }
    return;
  }
  if (vec) {  // d and w are multiples of 4
    const int q4 = w >> 2;
    for (int i = threadIdx.x; i < rows * q4; i += blockDim.x) {
      const int rr = i / q4;
      const int cc = i - rr * q4;
      cp_async16(dst + rr * kStride + 4 * cc, src + (long long)rr * d + 4 * cc);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int rr = i / w;
    const int e = i - rr * w;
    cp_async4(dst + rr * kStride + e, src + (long long)rr * d + e);
  }
  const int pad = ((w + 3) & ~3) - w;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x) {
    const int rr = i / pad;
    dst[rr * kStride + w + (i - rr * pad)] = 0.f;
  }
}

// 4 channels of a thread's 4 x 4 micro-tile: acc[i][j] += x_i[e..e+3] .
// y_j[e..e+3], one fmaf per channel in channel order. xs: the thread's
// first query row at channel e (its rows kStride apart); ys: its first
// target row (its rows 16 kStride apart).
__device__ __forceinline__ void quad(float (&acc)[4][4], const float* xs,
                                     const float* ys) {
  float4 a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = *reinterpret_cast<const float4*>(xs + i * kStride);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = *reinterpret_cast<const float4*>(ys + 16 * j * kStride);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
  }
}

// The block's scan. Every thread of the block calls it: it holds the
// block's barriers, the last one after the last stage, so that the ring is
// free for merge. On return, with kSelect, each lane holds in lk/lc
// (ascending keys, the first KDM - kd slots dead) its best kd (distance,
// column) pairs of its owned row's columns 16 q .. 16 q + 15 of each of its
// group's tiles; with kSumDist (one column group), the distance sum of each
// query row, in the old lanes' order, is in the dsum region.
template <int KDM, bool kSelect, bool kSumDist>
__device__ __forceinline__ void scan(const Rows& r, int row0, int kd,
                                     int rows, int groups,
                                     unsigned char* smem, const Layout& lay,
                                     unsigned (&lk)[KDM], int (&lc)[KDM]) {
  const int gthreads = 4 * rows;  // threads per column group
  const int g = threadIdx.x / gthreads;
  const int t = threadIdx.x - g * gthreads;
  const int ty = t >> 4;
  const int tx = t & 15;
  const int wide = kTn * groups;  // target columns per wide tile
  const int stage_floats = (rows + wide) * kStride;
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  float* ysq_s = reinterpret_cast<float*>(smem + lay.ysq);
  float* dist_g = reinterpret_cast<float*>(smem + lay.dist) +
                  g * rows * kDistStride;

  const int rows_q = min(rows, r.n - row0);
  const int tiles = (r.m + wide - 1) / wide;
  const int nch = (r.d + kCh - 1) / kCh;
  const int total = tiles * nch;
  const bool vec = (r.d & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(r.xn) |
                     reinterpret_cast<uintptr_t>(r.yn)) & 15) == 0;
  // stage st is chunk st % nch of wide tile st / nch; the tile's y_sq
  // lands with its last chunk, in that stage's slot
  auto load_stage = [&](int st) {
    const int slot = st % kStages;
    const int tile = st / nch;
    const int c0 = (st - tile * nch) * kCh;
    const int w = min(kCh, r.d - c0);
    const int j0 = tile * wide;
    const int tw = min(wide, r.m - j0);
    float* xd = ring + slot * stage_floats;
    stage_chunk(xd, r.xn + (long long)row0 * r.d + c0, rows_q, r.d, w, vec);
    stage_chunk(xd + rows * kStride, r.yn + (long long)j0 * r.d + c0, tw,
                r.d, w, vec);
    if (c0 + w == r.d) {
      float* dst = ysq_s + slot * wide;
      for (int i = threadIdx.x; i < tw; i += blockDim.x) {
        cp_async4(dst + i, r.ysq + j0 + i);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  // the thread's query rows (clamped past n: safe reads, results dropped)
  float xq[4];
  const float* brow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = min(row0 + 4 * ty + i, r.n - 1);
    xq[i] = r.xsq[gr];
    brow[i] = r.bias != nullptr ? r.bias + (long long)gr * r.m : nullptr;
  }
  // the owned row (4 lanes each, q its quarter of the group's 64 columns)
  const int orow = 4 * ty + (tx >> 2);
  const int q = tx & 3;
  const bool owner = row0 + orow < r.n;
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    const bool dead = p < KDM - kd;
    lk[p] = dead ? kDead : kEmpty;
    lc[p] = dead ? INT_MIN : INT_MAX;
  }
  float td = INFINITY;  // the owned row's threshold: passes at or below
  float sa[4] = {0.f, 0.f, 0.f, 0.f};  // the old lanes tx and tx + 16
  float sb[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][4];

  const int xoff = 4 * ty * kStride;
  const int yoff = (rows + kTn * g + tx) * kStride;
  int tile = 0, ch = 0;
  for (int st = 0; st < total; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed; the slot of st - 1 is free
    if (st + kStages - 1 < total) load_stage(st + kStages - 1);
    cp_async_commit();
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
    }
    const int slot = st % kStages;
    const float* stg = ring + slot * stage_floats;
    const int w = min(kCh, r.d - ch * kCh);
    if (w == kCh) {
#pragma unroll
      for (int e = 0; e < kCh; e += 4) quad(acc, stg + xoff + e, stg + yoff + e);
    } else {
      for (int e = 0; e < w; e += 4) quad(acc, stg + xoff + e, stg + yoff + e);
    }
    if (++ch == nch) {  // the tile's products are whole
      const int j0 = tile * wide + kTn * g;  // the group's first column
      const int tw = r.m - j0;               // its columns below tw are real
      const float* yq = ysq_s + slot * wide + kTn * g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          float dist = xq[i] - 2.f * acc[i][j] + yq[col];
          if (brow[i] != nullptr && col < tw) dist += brow[i][j0 + col];
          if constexpr (kSumDist) {
            if (col < tw) {
              if (j & 1) {
                sb[i] += dist;
              } else {
                sa[i] += dist;
              }
            }
          }
          if constexpr (kSelect) {
            dist_g[(4 * ty + i) * kDistStride + col] = dist;
          }
        }
      }
      if constexpr (kSelect) {
        __syncwarp();  // the warp's rows' distances written
        if (owner) {
          const float* drow = dist_g + orow * kDistStride + 16 * q;
          unsigned pass = 0u;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 v = reinterpret_cast<const float4*>(drow)[u];
            pass |= (unsigned)(v.x <= td) << (4 * u);
            pass |= (unsigned)(v.y <= td) << (4 * u + 1);
            pass |= (unsigned)(v.z <= td) << (4 * u + 2);
            pass |= (unsigned)(v.w <= td) << (4 * u + 3);
          }
          const int lim = tw - 16 * q;  // the owned columns past m
          if (lim < 16) pass &= lim <= 0 ? 0u : (1u << lim) - 1u;
          while (pass != 0u) {  // in column order
            const int b = __ffs(pass) - 1;
            pass &= pass - 1u;
            insert_key<KDM>(lk, lc, key_of(drow[b]), j0 + 16 * q + b);
          }
        }
        // the row's threshold: the lowest of its four owners' last keys
        unsigned tk = lk[KDM - 1];
        tk = min(tk, __shfl_xor_sync(kFull, tk, 1));
        tk = min(tk, __shfl_xor_sync(kFull, tk, 2));
        td = tk == kEmpty ? INFINITY : from_key(tk);
      }
      ch = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
  if constexpr (kSumDist) {  // the old lanes' butterfly, lane 0's value
    float* dsum = reinterpret_cast<float*>(smem + lay.dsum);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = sa[i] + sb[i];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (tx == 0) dsum[4 * ty + i] = v;
    }
  }
  __syncthreads();  // every thread done with the ring: it is free
}

// After scan<KDM, true, ...>: merge each row's 4 * groups lists and write
// its ranks 0, d, 2d, ... (dilation d) as rank / d into sel (row stride
// sel_stride, block-local rows) and, unless vals is nullptr, every rank's
// distance into vals (same stride); rows at or past n are skipped. A row
// with fewer than kd numbers takes its NaN columns in column order
// (select_nan_columns), with NaN distances. Every thread of the block calls
// it: it holds barriers, the last one after the rows' columns are written.
template <int KDM>
__device__ __forceinline__ void merge(const Rows& r, int row0, int kd,
                                      int dilation, int rows, int groups,
                                      unsigned char* smem,
                                      const Layout& lay,
                                      const unsigned (&lk)[KDM],
                                      const int (&lc)[KDM], int* sel,
                                      int sel_stride, float* vals) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint2* lists = reinterpret_cast<uint2*>(smem + lay.ring);
#pragma unroll
  for (int p = 0; p < KDM; ++p) {
    if (p >= KDM - kd) {
      lists[(warp * KDM + p - (KDM - kd)) * 32 + lane] =
          make_uint2(lk[p], lc[p]);
    }
  }
  __syncthreads();  // every group's lists written

  const int gwarps = rows / 8;  // warps per column group
  const int orow = 8 * warp + 4 * (lane >> 4) + ((lane & 15) >> 2);
  int nan_from = kd;  // the rank at which the row's numbers ran out
  if (warp < gwarps && (lane & 3) == 0 && row0 + orow < r.n) {
    // head u: the list of owner lane + (u & 3) of column group u / 4
    const int heads = 4 * groups;
    unsigned hk[kMaxHeads];
    int hc[kMaxHeads], hi[kMaxHeads];
#pragma unroll
    for (int u = 0; u < kMaxHeads; ++u) {
      hi[u] = 0;
      if (u < heads) {
        const uint2 e = lists[((u / 4 * gwarps + warp) * KDM) * 32 + lane +
                              (u & 3)];
        hk[u] = e.x;
        hc[u] = (int)e.y;
      } else {
        hk[u] = kEmpty;
        hc[u] = INT_MAX;
      }
    }
    int* sel_row = sel + orow * sel_stride;
    float* val_row = vals != nullptr ? vals + orow * sel_stride : nullptr;
    for (int rank = 0; rank < kd; ++rank) {
      unsigned bk = hk[0];
      int bc = hc[0], bu = 0;
#pragma unroll
      for (int u = 1; u < kMaxHeads; ++u) {
        if (key_less(hk[u], hc[u], bk, bc)) {
          bk = hk[u];
          bc = hc[u];
          bu = u;
        }
      }
      if (bc == INT_MAX) {  // every list empty
        nan_from = rank;
        break;
      }
      if (rank % dilation == 0) sel_row[rank / dilation] = bc;
      if (val_row != nullptr) val_row[rank] = from_key(bk);
#pragma unroll
      for (int u = 0; u < kMaxHeads; ++u) {
        if (u == bu) {  // the taken list moves on
          if (++hi[u] < kd) {
            const uint2 e = lists[((u / 4 * gwarps + warp) * KDM + hi[u]) *
                                      32 + lane + (u & 3)];
            hk[u] = e.x;
            hc[u] = (int)e.y;
          } else {
            hk[u] = kEmpty;
            hc[u] = INT_MAX;
          }
        }
      }
    }
  }
  if (warp < gwarps) {  // column group 0's warps: their rows' NaN tails
    unsigned need = __ballot_sync(kFull, nan_from < kd);
    while (need != 0u) {  // warp-uniform
      const int src = __ffs(need) - 1;
      need &= need - 1u;
      const int rank = __shfl_sync(kFull, nan_from, src);
      const int row = 8 * warp + 4 * (src >> 4) + ((src & 15) >> 2);
      const long long qr = row0 + row;
      knn_select::select_nan_columns<float>(
          rank, kd, dilation, r.xn + qr * r.d, r.xsq[qr], r.yn, r.ysq,
          r.bias != nullptr ? r.bias + qr * r.m : nullptr, r.m, r.d, lane,
          sel + row * sel_stride);
      if (vals != nullptr) {
        for (int v = rank + lane; v < kd; v += 32) {
          vals[row * sel_stride + v] = NAN;
        }
      }
    }
  }
  __syncthreads();  // the rows' columns written
}

}  // namespace
}  // namespace knn_f32
