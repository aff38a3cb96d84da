// Backward of the fused kNN graph + max-relative aggregate for Hopper
// (sm_90a): from the forward's saved idx, the gradient of
// mr = max_j(y[idx_j] - x) with respect to x and y.
//
// Replaces the TPU kernel gkgnet_tpu/ops/pallas/knn_mr.py::_bwd_pallas
// (pallas_call at :1071; bodies _bwd_kernel :894 and _bwd_kernel_batched
// :979). The function is ported, not the blocks: the TPU kernel turned the
// scatter-add into one-hot matmuls on the MXU and carried gy across its
// sequential grid in VMEM. Here blocks run in no order, so the scatter
// becomes a gather over an inverse edge list that these kernels build.
//
// The contract (the TPU kernel's, for both of its bodies):
//   rel_j = y[idx_j] - x, rounded to the input type;
//   mr = max_j rel_j (NaN if any rel_j is NaN), cnt = #{j : rel_j == mr};
//   g_j = (rel_j == mr ? g / cnt : 0), in fp32, rounded to the input type;
//   gy[m] = sum over the edges (n, j) with idx[n, j] == m of g_j, in fp32
//           from 0.0 in ascending edge id (bg*N + n)*k + j, no FMA,
//           rounded once to the input type;
//   gx = -g exactly.
//
// Two instantiations of one code path: the folded one on (BG, N, D) rows,
// and the group-strided one on unfolded (B, N, g*D) rows with idx
// (B, N, g, k), for the grouped route. Every kernel works in the folded
// coordinates (bg = b*g + gi, row bg*N + n, edge id (bg*N + n)*k + j) and
// maps them to the unfolded storage row (b*N + n)*g + gi only where it
// reads x, g, idx, y or writes gx, gy, so both give bitwise the same sums.
//
// What bounds it on this card. At the main path's largest call (stage 1,
// BG=16, N=20736, M=1296, D=40, k=9, bf16) the bytes it must move are x, g
// (26.5 MB each), y (1.7 MB), idx (11.9 MB), gx (26.5 MB) and gy (1.7 MB):
// ~95 MB, 0.028 ms at 3.35 TB/s; the arithmetic is a few operations per
// edge and channel. What the design below adds to that is a gather per
// edge from L2 in each of steps 3 and 4: the edge's target row of y (80
// bytes at stage 1) and its query row's split and tie masks (80 + 80
// bytes), 239 MB and 478 MB over stage 1's 2.99 M edges. Those gathers,
// and the instructions that address them, bound steps 3 and 4; step 4 also
// adds each target's edges in one fixed order, so a hub target (many
// incoming edges) is a long serial tail.
//
// Design, four kernels on the caller's stream (the first design wrote a
// (BG, N, k, D) per-edge buffer, 239 MB at stage 1, read it back in
// target order from all over that buffer, and took its inverse edge list
// from a library sort; none of that is left):
//   1. rank_edges: a counting sort of the edges by target, stable by
//      construction. One warp per unit of 512-4096 consecutive edges of
//      one bg (smaller units where a call has few edges, so that the card
//      has enough warps) copies the unit's targets to shared memory and
//      walks them in edge order, 32 a round: __match_any_sync groups a
//      round's lanes by target, and counts per target (shared memory, or
//      the unit's global row where M counts do not fit) carry the ranks
//      from round to round. It writes each edge's rank among the unit's
//      edges to its target and the unit's count of each target (one row of
//      M per unit). Integer work only, no atomics.
//   2. target_offsets: per bg, each target's first position in the inverse
//      list (an exclusive scan over the targets, from bg*N*k, since every
//      edge of bg targets a row of bg) and, in place of the units' counts,
//      where each unit's edges to that target start.
//   3. row_split: one thread per 16-byte chunk of a query row (8 channels
//      in bf16, 4 in fp32; a block is a few whole rows, so no thread
//      divides an index): one branchless sweep over the k gathered target
//      rows keeps the max and the tie set of each channel as a k-bit mask;
//      it writes gx = -g, the rounded split g / cnt (BG, N, D) in the input
//      type, the chunk's tie masks (one 16-bit word per channel for k <=
//      16, else 64-bit), and each edge at its place in the inverse list
//      (its unit's start for the target plus its rank) as row << kbits | j.
//      At stage 1 that is 26.5 MB of split and 26.5 MB of masks in place of
//      the 239 MB buffer, written in order, and one scattered 4-byte store
//      per edge.
//   4. target_sum: one thread per 16-byte chunk of a target: it walks the
//      target's edges in list order (ascending edge id), the next batch's
//      list entries loading while the current batch's split chunks and tie
//      masks do, adds the split where the edge's tie bit is set, in fp32 in
//      that order, and writes gy rounded once.
// Threads never cooperate in steps 3 and 4, so a thread takes one chunk
// and no lane idles; a row or target with many chunks spreads over as many
// threads. The adds skip the non-tie edges instead of adding +0.0: the sum
// starts at +0.0 and an fp32 sum in round-to-nearest is never -0.0 then,
// so adding +0.0 (or -0.0) changes nothing and gy is bitwise the sum over
// every g_j. Tried on the card and dropped: one tie byte per edge and
// chunk (step 4 then gathers 85 bytes per edge at stage 1, not 160), whose
// transposition of the tie sets cost step 3 more than it saved step 4; 8
// or 16 edges in flight in step 4 (fewer warps fit, and it was slower than
// 4 at every main-path shape); smaller ranking units (step 2 then reads
// more counts than step 1 saves).
//
// The same file holds the backward of the plain neighbour gather
// (gather_backward; gkgnet_tpu_torch/ops/aggregate.py gather_nodes, whose
// JAX counterpart gkgnet_tpu/ops/aggregate.py:27 gets its VJP from XLA and
// had no Pallas kernel). x_j = y[idx_j] has the gradient gy[t] = the sum of
// the incoming rows g[e] over the edges e with idx[e] == t. PyTorch's own
// gather backward on the card is a scatter-add with float atomics, whose
// order, and so whose rounding, changes from run to run; here gy[t] is the
// fp32 sum from 0.0 in ascending edge id (bg*N + n)*k + j, no FMA, rounded
// once to the input type: steps 1 and 2 as above, then
//   5. place_edges: one thread per edge writes its id at its place in the
//      inverse list (its unit's start for the target plus its rank);
//   6. target_sum's kEdgeRows instantiation: step 4 with the edge's own row
//      of g in place of its query row's split, and no tie masks.
// Its bytes: g (E x D) read once, idx (E ints) and gy (BG x M x D) written
// once; the edges' rows are gathered by target, each once.
//
// Launch discipline: every kernel runs on the caller's stream, allocates
// nothing (the caller passes one workspace of knn_mr_bwd_workspace_bytes)
// and does not synchronize; the entry point returns cudaGetLastError()
// after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kUnitLogMax = 12;  // at most 4096 edges per ranking unit
constexpr int kUnitLogMin = 9;
constexpr int kUnitsWanted = 4 * 132;  // enough warps for the card's SMs
constexpr int kSmemBytes = 48 * 1024;  // rank_edges' counts and targets
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;  // threads wanted per block of steps 3 and 4
constexpr int kMaxChunks = 256;  // most 16-byte chunks in a row (blockDim.x)

// channels in a 16-byte chunk
template <typename T>
constexpr int kChan = 16 / (int)sizeof(T);

// 32-bit words of a chunk's tie masks: one W per channel
template <typename T, typename W>
constexpr int kMaskWords = kChan<T> * (int)sizeof(W) / 4;

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

// bf16 bits <-> fp32, exact one way, round to nearest even the other; on
// registers only (no address taken, so nothing goes to the stack).
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// A 16-byte chunk's raw bits <-> its kChan<T> values in fp32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* v) {
  if constexpr (sizeof(T) == 2) {
    v[0] = bf16_lo(r.x); v[1] = bf16_hi(r.x);
    v[2] = bf16_lo(r.y); v[3] = bf16_hi(r.y);
    v[4] = bf16_lo(r.z); v[5] = bf16_hi(r.z);
    v[6] = bf16_lo(r.w); v[7] = bf16_hi(r.w);
  } else {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  if constexpr (sizeof(T) == 2) {
    return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                      bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
}

// One chunk from p into fp32; `valid` of its channels exist (the rest read
// as 0). kVec: p is 16-byte aligned and valid is the whole chunk.
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                           int valid, float* v) {
  if constexpr (kVec) {
    unpack<T>(*reinterpret_cast<const uint4*>(p), v);
  } else {
#pragma unroll
    for (int i = 0; i < kChan<T>; ++i) {
      v[i] = i < valid ? to_f32(p[i]) : 0.f;
    }
  }
}

// One chunk of fp32 values rounded to T at p; `valid` of them are written.
template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, int valid,
                                            const float* v) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = pack<T>(v);
  } else {
#pragma unroll
    for (int i = 0; i < kChan<T>; ++i) {
      if (i < valid) p[i] = from_f32<T>(v[i]);
    }
  }
}

// A chunk's tie masks, kMaskWords 32-bit words (8 or more bytes, aligned
// to their size in the workspace).
template <int kWords>
__device__ __forceinline__ void store_words(unsigned* __restrict__ p,
                                            const unsigned* w) {
  if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kWords; q += 4) {
      *reinterpret_cast<uint4*>(p + q) =
          make_uint4(w[q], w[q + 1], w[q + 2], w[q + 3]);
    }
  }
}

template <int kWords>
__device__ __forceinline__ void load_words(const unsigned* __restrict__ p,
                                           unsigned* w) {
  if constexpr (kWords == 2) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < kWords; q += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(p + q);
      w[q] = a.x; w[q + 1] = a.y; w[q + 2] = a.z; w[q + 3] = a.w;
    }
  }
}

// The storage row of folded row (bg, r) for rows of `per_bg` per group:
// bg*per_bg + r folded; (b*per_bg + r)*groups + gi unfolded (bg = b*g + gi).
template <bool kGrouped>
__device__ __forceinline__ long long storage_row(long long bg, long long r,
                                                 long long per_bg,
                                                 int groups) {
  if constexpr (kGrouped) {
    return ((bg / groups) * per_bg + r) * groups + bg % groups;
  } else {
    return bg * per_bg + r;
  }
}

// Exclusive sum of v over the block: warp shuffles, then one level over
// the warps' totals in `warp_part` (>= 64 entries). Returns the sum over
// the lower threads and sets `total` to the block's sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_part,
                                                   int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int inc = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, s);
    if (lane >= s) inc += o;
  }
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_part[lane] : 0;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w += o;
    }
    warp_part[32 + lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_part[32 + warp - 1];
  total = warp_part[32 + nwarps - 1];
  __syncthreads();  // warp_part is reused by the next call
  return before + inc - v;
}

// 1. One warp per unit of 2**unit_log consecutive edges of one bg (unit
// blockIdx.x of bg blockIdx.y), in edge order n*k + j: rank[e] = the
// number of earlier edges of the unit with e's target, and
// hist[(bg*units_per_bg + unit)*m + t] = the unit's edges to t. The warp
// first copies the unit's targets to shared memory, then takes 32 edges a
// round, in order: the lanes with a lane's target (__match_any_sync) give
// its rank, their count so far plus those below it, and the last of them
// adds their number to the count. The counts live in shared memory
// (kSmemBins) or, where m of them do not fit beside the targets, in the
// unit's hist row itself.
template <bool kGrouped, bool kSmemBins>
__global__ void __launch_bounds__(32)
rank_edges(const int* __restrict__ idx, int* __restrict__ rank,
           int* __restrict__ hist, int n, int m, int k, int groups,
           int units_per_bg, int unit_log) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const long long bg = blockIdx.y;
  const int edges_bg = n * k;
  const int e0 = blockIdx.x << unit_log;
  const int count = min(1 << unit_log, edges_bg - e0);
  int* targets = smem;
  int* h = hist + (bg * units_per_bg + blockIdx.x) * (long long)m;
  volatile int* bins = kSmemBins ? smem + (1 << unit_log) : h;
  for (int p0 = 0; p0 < count; p0 += 8 * 32) {  // 8 loads in flight a lane
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int el = e0 + p0 + u * 32 + lane;
      const int r = el / k;
      v[u] = p0 + u * 32 + lane < count
                 ? idx[storage_row<kGrouped>(bg, r, n, groups) * k
                       + (el - r * k)]
                 : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (p0 + u * 32 + lane < count) targets[p0 + u * 32 + lane] = v[u];
    }
  }
  for (int t = lane; t < m; t += 32) bins[t] = 0;
  __syncwarp();
  // no global store inside the walk: each round's barrier would wait for
  // it; a lane's rank replaces its consumed target in shared memory
  const unsigned below = (1u << lane) - 1u;
  int t_next = lane < count ? targets[lane] : m;  // m: no edge
  for (int p0 = 0; p0 < count; p0 += 32) {
    const int p = p0 + lane;
    const int t = t_next;
    t_next = p + 32 < count ? targets[p + 32] : m;
    const unsigned same = __match_any_sync(0xffffffffu, t);
    const int before = t < m ? bins[t] : 0;
    __syncwarp();
    if (t < m) {
      targets[p] = before + __popc(same & below);
      if (31 - __clz(same) == lane) bins[t] = before + __popc(same);
    }
    __syncwarp();
  }
  int* rank_u = rank + bg * edges_bg + e0;
  for (int p = lane; p < count; p += 32) rank_u[p] = targets[p];
  if constexpr (kSmemBins) {
    for (int t = lane; t < m; t += 32) h[t] = bins[t];
  }
}

// 2. One block per bg: first[bg*m + t] = bg*n*k + the exclusive sum of the
// bg's counts over targets < t; hist becomes, per unit, where its edges
// to t start in the inverse list. first[BG*m] = BG*n*k.
__global__ void __launch_bounds__(kScanThreads)
target_offsets(int* __restrict__ hist, int* __restrict__ first, int m,
               int units_per_bg, int edges_bg, int bgs) {
  __shared__ int warp_part[64];
  const int bg = blockIdx.x;
  int carry = bg * edges_bg;
  for (int t0 = 0; t0 < m; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    int* h = hist + (long long)bg * units_per_bg * m + t;
    int tot = 0;
    if (t < m) {
      for (int u = 0; u < units_per_bg; ++u) tot += h[(long long)u * m];
    }
    int block_total;
    const int exc = block_exclusive_sum(tot, warp_part, block_total);
    if (t < m) {
      int run = carry + exc;
      first[(long long)bg * m + t] = run;
      for (int u = 0; u < units_per_bg; ++u) {
        const int c = h[(long long)u * m];
        h[(long long)u * m] = run;
        run += c;
      }
    }
    carry += block_total;
  }
  if (bg == 0 && threadIdx.x == 0) {
    first[(long long)bgs * m] = bgs * edges_bg;
  }
}

// 3. Thread (c, ry) of block (bx, gi, b) on chunk c of query row r =
// bx*blockDim.y + ry of group bg = b*groups + gi: gx = -g, split = g / cnt
// in T (rows padded to whole chunks), the chunk's tie masks (bit j of
// channel i's W: edge j ties), and the row's edges j = c, c + nch, ... at
// their places in the inverse list as row << kbits | j. W is uint16_t for
// k <= 16, else uint64_t.
template <typename T, bool kGrouped, bool kVec, typename W>
__global__ void __launch_bounds__(kMaxChunks)
row_split(const T* __restrict__ x, const T* __restrict__ y,
          const int* __restrict__ idx, const T* __restrict__ g,
          const int* __restrict__ rank, const int* __restrict__ base,
          T* __restrict__ gx, T* __restrict__ split,
          unsigned* __restrict__ order, unsigned* __restrict__ mask, int n,
          int m, int d, int k, int groups, int units_per_bg, int unit_log,
          int kbits) {
  constexpr int C = kChan<T>;
  constexpr int kWords = kMaskWords<T, W>;
  using Bits = std::conditional_t<sizeof(W) == 8, unsigned long long,
                                  unsigned>;
  const int nch = blockDim.x;
  const int c = threadIdx.x;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n) return;  // no barrier below
  const int gi = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = b * groups + gi;
  const long long row = (long long)bg * n + r;  // folded
  const long long s =
      kGrouped ? ((long long)b * n + r) * groups + gi : row;  // storage
  const int* idx_r = idx + s * k;
  for (int j = c; j < k; j += nch) {
    const int at = base[((long long)bg * units_per_bg
                         + ((r * k + j) >> unit_log)) * m + idx_r[j]]
                   + rank[row * k + j];
    order[at] = ((unsigned)row << kbits) | (unsigned)j;
  }
  const int ch = c * C;
  const int valid = min(C, d - ch);
  // target t's chunk: y_c + t*y_step (storage row (b*m + t)*groups + gi
  // unfolded, bg*m + t folded)
  const T* y_c = y + (kGrouped ? (long long)b * m * groups + gi
                               : (long long)bg * m) * d + ch;
  const long long y_step = (long long)(kGrouped ? groups : 1) * d;
  float xv[C], mr[C];
  Bits bits[C];
  load_chunk<T, kVec>(x + s * d + ch, valid, xv);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    mr[i] = -INFINITY;
    bits[i] = 0;
  }
  // the max and its tie set in one sweep; a NaN rel makes mr NaN, and
  // then no rel equals it
#pragma unroll 3
  for (int j = 0; j < k; ++j) {
    float yv[C];
    load_chunk<T, kVec>(y_c + idx_r[j] * y_step, valid, yv);
    const Bits bit = (Bits)1 << j;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float rel = to_f32(from_f32<T>(yv[i] - xv[i]));
      const bool up = rel > mr[i];
      bits[i] = up ? bit : (rel == mr[i] ? bits[i] | bit : bits[i]);
      asm("max.NaN.f32 %0, %0, %1;" : "+f"(mr[i]) : "f"(rel));
    }
  }
  float gv[C], sp[C];
  unsigned words[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) words[q] = 0u;
  load_chunk<T, kVec>(g + s * d + ch, valid, gv);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (mr[i] != mr[i]) bits[i] = 0;
    sp[i] = gv[i] / (float)__popcll((unsigned long long)bits[i]);
    if constexpr (sizeof(W) == 2) {
      words[i >> 1] |= (unsigned)bits[i] << (16 * (i & 1));
    } else {
      words[2 * i] = (unsigned)bits[i];
      words[2 * i + 1] = (unsigned)((unsigned long long)bits[i] >> 32);
    }
    gv[i] = -gv[i];
  }
  store_chunk<T, kVec>(gx + s * d + ch, valid, gv);
  const long long rc = row * nch + c;
  *reinterpret_cast<uint4*>(split + rc * C) = pack<T>(sp);
  store_words<kWords>(mask + rc * kWords, words);
}

// 4. Thread (c, ty) of block (bx, gi, b) on chunk c of target t =
// bx*blockDim.y + ty of group bg = b*groups + gi: gy = the fp32 sum, in
// list order, of the split of each incoming edge's row where the edge's
// tie bit is set. kInFlight edges' split chunks and tie masks load at
// once, while the next batch's list entries load. kEdgeRows (the gather's
// backward, folded only): the list holds edge ids, `split` is g with one
// row of d channels per edge, and every edge's row is added.
template <typename T, bool kGrouped, bool kVec, typename W, int kInFlight,
          bool kEdgeRows = false>
__global__ void __launch_bounds__(kMaxChunks)
target_sum(const T* __restrict__ split, const unsigned* __restrict__ order,
           const unsigned* __restrict__ mask, const int* __restrict__ first,
           T* __restrict__ gy, int m, int d, int groups, int kbits) {
  constexpr int C = kChan<T>;
  constexpr int kWords = kMaskWords<T, W>;
  const int nch = blockDim.x;
  const int c = threadIdx.x;
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= m) return;
  const int gi = blockIdx.y;
  const int b = blockIdx.z;
  const long long ft = (long long)(b * groups + gi) * m + t;  // folded
  const long long st =
      kGrouped ? ((long long)b * m + t) * groups + gi : ft;  // storage
  const int begin = first[ft];
  const int end = first[ft + 1];
  const unsigned jmask = (1u << kbits) - 1u;
  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  unsigned next[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    next[u] = begin + u < end ? order[begin + u] : 0u;
  }
  if constexpr (kEdgeRows) {
    const int ch = c * C;
    const int valid = min(C, d - ch);
    for (int p0 = begin; p0 < end; p0 += kInFlight) {
      float sv[kInFlight][C];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (p0 + u < end) {
          load_chunk<T, kVec>(split + (long long)next[u] * d + ch, valid,
                              sv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int p = p0 + kInFlight + u;
        next[u] = p < end ? order[p] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (p0 + u >= end) continue;
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] = __fadd_rn(acc[i], sv[u][i]);
      }
    }
  } else {
    for (int p0 = begin; p0 < end; p0 += kInFlight) {
      uint4 sr[kInFlight];
      unsigned mw[kInFlight][kWords];
      unsigned jj[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (p0 + u < end) {
          const long long rc = (long long)(next[u] >> kbits) * nch + c;
          sr[u] = *reinterpret_cast<const uint4*>(split + rc * C);
          load_words<kWords>(mask + rc * kWords, mw[u]);
          jj[u] = next[u] & jmask;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int p = p0 + kInFlight + u;
        next[u] = p < end ? order[p] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (p0 + u >= end) continue;
        float sv[C];
        unpack<T>(sr[u], sv);
        if constexpr (sizeof(W) == 2) {
          const unsigned b0 = 1u << jj[u];
          const unsigned b1 = b0 << 16;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            if (mw[u][i >> 1] & ((i & 1) ? b1 : b0)) {
              acc[i] = __fadd_rn(acc[i], sv[i]);
            }
          }
        } else {
          const int hi = jj[u] >> 5;
          const unsigned bj = 1u << (jj[u] & 31u);
#pragma unroll
          for (int i = 0; i < C; ++i) {
            if ((hi ? mw[u][2 * i + 1] : mw[u][2 * i]) & bj) {
              acc[i] = __fadd_rn(acc[i], sv[i]);
            }
          }
        }
      }
    }
  }
  const int ch = c * C;
  store_chunk<T, kVec>(gy + st * d + ch, min(C, d - ch), acc);
}

// 5. (the gather's backward) One thread per edge e of the whole call: its
// id at its place in the inverse list, its unit's start for its target
// (hist, after step 2) plus its rank among the unit's edges to it.
__global__ void __launch_bounds__(kThreads)
place_edges(const int* __restrict__ idx, const int* __restrict__ rank,
            const int* __restrict__ base, unsigned* __restrict__ order,
            long long edges, int edges_bg, int m, int units_per_bg,
            int unit_log) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= edges) return;
  const long long bg = e / edges_bg;
  const int el = (int)(e - bg * edges_bg);
  order[base[(bg * units_per_bg + (el >> unit_log)) * m + idx[e]]
        + rank[e]] = (unsigned)e;
}

struct Workspace {
  int* rank;
  int* hist;
  int* first;
  unsigned* order;
  unsigned* mask;
  void* split;
  long long bytes;
};

long long align256(long long v) { return (v + 255) / 256 * 256; }

// log2 of the edges per ranking unit: the largest in [kUnitLogMin,
// kUnitLogMax] that still gives kUnitsWanted units, else the smallest.
int unit_log_for(long long bgs, long long n, long long k) {
  int lg = kUnitLogMax;
  while (lg > kUnitLogMin
         && bgs * ((n * k + (1ll << lg) - 1) >> lg) < kUnitsWanted) {
    --lg;
  }
  return lg;
}

long long units_for(long long n, long long k, int unit_log) {
  return (n * k + (1ll << unit_log) - 1) >> unit_log;
}

// bits of j in an inverse-list entry row << kbits | j
int bits_for(int k) {
  int b = 0;
  while ((1 << b) < k) ++b;
  return b;
}

// The workspace's parts; with_split false (the gather's backward): the
// ranks, counts, offsets and inverse list only.
Workspace carve(void* work, long long bgs, long long n, long long m,
                long long d, long long k, long long elem,
                bool with_split = true) {
  const long long edges = bgs * n * k;
  const long long chan = 16 / elem;
  const long long nch = (d + chan - 1) / chan;
  const long long units = units_for(n, k, unit_log_for(bgs, n, k));
  const long long w_bytes = k <= 16 ? 2 : 8;
  char* p = static_cast<char*>(work);
  long long off = 0;
  Workspace w{};
  auto take = [&](long long bytes) {
    char* at = p == nullptr ? nullptr : p + off;
    off += align256(bytes);
    return at;
  };
  w.rank = reinterpret_cast<int*>(take(edges * 4));
  w.hist = reinterpret_cast<int*>(take(bgs * units * m * 4));
  w.first = reinterpret_cast<int*>(take((bgs * m + 1) * 4));
  w.order = reinterpret_cast<unsigned*>(take(edges * 4));
  if (with_split) {
    w.mask = reinterpret_cast<unsigned*>(
        take(bgs * n * nch * chan * w_bytes));
    w.split = take(bgs * n * nch * 16);
  }
  w.bytes = off;
  return w;
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, bool kGrouped, bool kVec, typename W>
int launch_rows(const void* x, const void* y, const void* idx, const void* g,
                void* gx, void* gy, const Workspace& w, int b, int groups,
                int n, int m, int d, int k, int units_per_bg, int unit_log,
                cudaStream_t s) {
  const int nch = (d + kChan<T> - 1) / kChan<T>;
  const int per_block = kThreads / nch > 1 ? kThreads / nch : 1;
  const dim3 block(nch, per_block);
  const int kbits = bits_for(k);
  T* st = static_cast<T*>(w.split);
  if (n > 0) {
    const dim3 grid((n + per_block - 1) / per_block, groups, b);
    row_split<T, kGrouped, kVec, W><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const int*>(idx), static_cast<const T*>(g), w.rank,
        w.hist, static_cast<T*>(gx), st, w.order, w.mask, n, m, d, k, groups,
        units_per_bg, unit_log, kbits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + per_block - 1) / per_block, groups, b);
  // 4 edges in flight (8 ran slower on the card at every main-path
  // shape); 2 for the wide masks of k > 16
  constexpr int kInFlight = sizeof(W) == 8 ? 2 : 4;
  target_sum<T, kGrouped, kVec, W, kInFlight><<<grid, block, 0, s>>>(
      st, w.order, w.mask, w.first, static_cast<T*>(gy), m, d, groups,
      kbits);
  return cudaGetLastError();
}

template <typename T, bool kGrouped, bool kVec>
int launch_masks(const void* x, const void* y, const void* idx,
                 const void* g, void* gx, void* gy, const Workspace& w, int b,
                 int groups, int n, int m, int d, int k, int units_per_bg,
                 int unit_log, cudaStream_t s) {
  return k <= 16
             ? launch_rows<T, kGrouped, kVec, uint16_t>(
                   x, y, idx, g, gx, gy, w, b, groups, n, m, d, k,
                   units_per_bg, unit_log, s)
             : launch_rows<T, kGrouped, kVec, uint64_t>(
                   x, y, idx, g, gx, gy, w, b, groups, n, m, d, k,
                   units_per_bg, unit_log, s);
}

// Steps 1 and 2: each edge's rank among its unit's edges to its target,
// each target's first place in the inverse list and each unit's start.
template <bool kGrouped>
int launch_ranking(const void* idx, const Workspace& w, long long bgs,
                   int groups, int n, int m, int k, int units_per_bg,
                   int unit_log, cudaStream_t s) {
  if (units_per_bg > 0) {
    const dim3 grid(units_per_bg, (unsigned)bgs);
    const long long smem = ((1ll << unit_log) + m) * (long long)sizeof(int);
    const int* it = static_cast<const int*>(idx);
    if (smem <= kSmemBytes) {
      rank_edges<kGrouped, true><<<grid, 32, smem, s>>>(
          it, w.rank, w.hist, n, m, k, groups, units_per_bg, unit_log);
    } else {
      rank_edges<kGrouped, false>
          <<<grid, 32, (1 << unit_log) * sizeof(int), s>>>(
          it, w.rank, w.hist, n, m, k, groups, units_per_bg, unit_log);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  target_offsets<<<(unsigned)bgs, kScanThreads, 0, s>>>(
      w.hist, w.first, m, units_per_bg, n * k, (int)bgs);
  return cudaGetLastError();
}

template <typename T, bool kGrouped>
int launch_all(const void* x, const void* y, const void* idx, const void* g,
               void* gx, void* gy, void* work, int b, int groups, int n,
               int m, int d, int k, cudaStream_t s) {
  const long long bgs = (long long)b * groups;
  const Workspace w = carve(work, bgs, n, m, d, k, sizeof(T));
  const int unit_log = unit_log_for(bgs, n, k);
  const int units_per_bg = (int)units_for(n, k, unit_log);
  const int err = launch_ranking<kGrouped>(idx, w, bgs, groups, n, m, k,
                                           units_per_bg, unit_log, s);
  if (err != cudaSuccess) return err;
  const bool vec = d % kChan<T> == 0 && aligned(x, 16) && aligned(y, 16)
                   && aligned(g, 16) && aligned(gx, 16) && aligned(gy, 16);
  return vec ? launch_masks<T, kGrouped, true>(x, y, idx, g, gx, gy, w, b,
                                               groups, n, m, d, k,
                                               units_per_bg, unit_log, s)
             : launch_masks<T, kGrouped, false>(x, y, idx, g, gx, gy, w, b,
                                                groups, n, m, d, k,
                                                units_per_bg, unit_log, s);
}

template <typename T>
int launch_typed(const void* x, const void* y, const void* idx, const void* g,
                 void* gx, void* gy, void* work, int b, int groups, int n,
                 int m, int d, int k, cudaStream_t s) {
  if ((d + kChan<T> - 1) / kChan<T> > kMaxChunks || b > 65535
      || groups > 65535
      || (((long long)b * groups * n) << bits_for(k)) >= (1ll << 32)) {
    return cudaErrorInvalidValue;
  }
  return groups > 1
             ? launch_all<T, true>(x, y, idx, g, gx, gy, work, b, groups, n,
                                   m, d, k, s)
             : launch_all<T, false>(x, y, idx, g, gx, gy, work, b, 1, n, m,
                                    d, k, s);
}

// The gather's backward on checked sizes: steps 1, 2, 5 and 6.
template <typename T>
int launch_gather(const void* g, const void* idx, void* gy, void* work,
                  int b, int n, int m, int d, int k, cudaStream_t s) {
  constexpr int C = kChan<T>;
  const int nch = (d + C - 1) / C;
  const long long edges = (long long)b * n * k;
  if (nch > kMaxChunks || b > 65535 || edges >= (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  const Workspace w = carve(work, b, n, m, d, k, sizeof(T), false);
  const int unit_log = unit_log_for(b, n, k);
  const int units_per_bg = (int)units_for(n, k, unit_log);
  int err = launch_ranking<false>(idx, w, b, 1, n, m, k, units_per_bg,
                                  unit_log, s);
  if (err != cudaSuccess) return err;
  if (edges > 0) {
    place_edges<<<(unsigned)((edges + kThreads - 1) / kThreads), kThreads, 0,
                  s>>>(static_cast<const int*>(idx), w.rank, w.hist, w.order,
                       edges, n * k, m, units_per_bg, unit_log);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int per_block = kThreads / nch > 1 ? kThreads / nch : 1;
  const dim3 block(nch, per_block);
  const dim3 grid((m + per_block - 1) / per_block, 1, b);
  const T* gt = static_cast<const T*>(g);
  T* gyt = static_cast<T*>(gy);
  if (d % C == 0 && aligned(g, 16) && aligned(gy, 16)) {
    target_sum<T, false, true, uint16_t, 4, true><<<grid, block, 0, s>>>(
        gt, w.order, nullptr, w.first, gyt, m, d, 1, 0);
  } else {
    target_sum<T, false, false, uint16_t, 4, true><<<grid, block, 0, s>>>(
        gt, w.order, nullptr, w.first, gyt, m, d, 1, 0);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace knn_mr_backward needs for these sizes.
long long knn_mr_bwd_workspace_bytes(int b, int groups, int n, int m, int d,
                                     int k, int is_bf16) {
  return carve(nullptr, (long long)b * groups, n, m, d, k, is_bf16 ? 2 : 4)
      .bytes;
}

// groups == 1: x (b, n, d), y (b, m, d), g (b, n, d), idx (b, n, k);
// groups > 1: x (b, n, groups*d), y (b, m, groups*d), g like x,
// idx (b, n, groups, k), group gi on channels [gi*d, (gi+1)*d). One type
// for x, y, g (is_bf16: bfloat16, else float32), idx int32 with every
// entry in [0, m), all contiguous; b*groups*n*k < 2**31, k <= 64, at most
// 256 16-byte chunks in d channels, b and groups <= 65535 and
// b*groups*n << ceil(log2 k) < 2**32 (else cudaErrorInvalidValue). Writes gx like x and gy like y; work holds
// knn_mr_bwd_workspace_bytes. Returns a cudaError_t code.
int knn_mr_backward(const void* x, const void* y, const void* idx,
                    const void* g, void* gx, void* gy, void* work, int b,
                    int groups, int n, int m, int d, int k, int is_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)b * groups * m == 0 || d == 0) return cudaSuccess;
  if (is_bf16) {
    return launch_typed<__nv_bfloat16>(x, y, idx, g, gx, gy, work, b, groups,
                                       n, m, d, k, s);
  }
  return launch_typed<float>(x, y, idx, g, gx, gy, work, b, groups, n, m, d,
                             k, s);
}

// Bytes of the workspace gather_backward needs for these sizes.
long long gather_bwd_workspace_bytes(int b, int n, int m, int d, int k,
                                     int is_bf16) {
  return carve(nullptr, b, n, m, d, k, is_bf16 ? 2 : 4, false).bytes;
}

// The backward of x_j = y[idx_j]: g (b, n, k, d) the gradient of the
// gathered rows, idx (b, n, k) int32 with every entry in [0, m), gy
// (b, m, d) written: gy[t] = the fp32 sum of g's rows over the edges to t,
// from 0.0 in ascending edge id, rounded once. One type for g and gy
// (is_bf16: bfloat16, else float32), all contiguous; b <= 65535,
// b*n*k < 2**31 and at most 256 16-byte chunks in d channels (else
// cudaErrorInvalidValue). work holds gather_bwd_workspace_bytes. Returns a
// cudaError_t code.
int gather_backward(const void* g, const void* idx, void* gy, void* work,
                    int b, int n, int m, int d, int k, int is_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)b * m == 0 || d == 0) return cudaSuccess;
  if (is_bf16) {
    return launch_gather<__nv_bfloat16>(g, idx, gy, work, b, n, m, d, k, s);
  }
  return launch_gather<float>(g, idx, gy, work, b, n, m, d, k, s);
}

const char* knn_mr_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
