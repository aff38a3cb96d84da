// Backward of the fused kNN graph + max-relative aggregate for Hopper
// (sm_90a): from the forward's saved idx, the gradient of
// mr = max_j(y[idx_j] - x) with respect to x and y.
//
// Replaces the TPU kernel gkgnet_tpu/ops/pallas/knn_mr.py::_bwd_pallas
// (pallas_call at :1071; bodies _bwd_kernel :894 and _bwd_kernel_batched
// :979). The function is ported, not the blocks: the TPU kernel turned the
// scatter-add into one-hot matmuls on the MXU and carried gy across its
// sequential grid in VMEM. Here blocks run in no order, so the scatter
// becomes a gather over an inverted edge list.
//
// The contract (the TPU kernel's, for both of its bodies):
//   rel_j = y[idx_j] - x, rounded to the input type;
//   mr = max_j rel_j (NaN if any rel_j is NaN), cnt = #{j : rel_j == mr};
//   g_j = (rel_j == mr ? g / cnt : 0), in fp32, rounded to the input type;
//   gy[m] = sum over the edges (n, j) with idx[n, j] == m of g_j, in fp32,
//           rounded once to the input type;
//   gx = -g exactly.
//
// Design, two passes:
//   A. edge_grads: one warp per query row, lanes over channels. Per channel
//      it recomputes the k rels, their max and tie count, and writes the k
//      per-edge gradients g_j to a (BG, N, k, D) buffer in the input type
//      (g_j is already rounded to it, so nothing is lost), and gx = -g.
//   B. gather_targets: one warp per target row, lanes over channels. It
//      sums the g_j of the row's incoming edges in fp32 in a fixed order:
//      the caller passes the edges sorted by (target, query row, slot) and
//      each target's first position in that order. No atomics, so gy is
//      bitwise the same on every run.
//
// What bounds it on this card. At the main path's largest call (stage 1,
// BG=16, N=20736, M=1296, D=40, k=9, bf16) the bytes it must move are the
// inputs x, g (26.5 MB each), y (1.7 MB), idx (11.9 MB) and the outputs gx
// (26.5 MB) and gy (1.7 MB): ~95 MB, 0.028 ms at 3.35 TB/s; the arithmetic
// is a few operations per edge and channel. So it is bound by bytes. This
// first design moves more: the per-edge buffer is written once and read
// once (239 MB each way at stage 1 in bf16), and pass B reads its edges
// in target order, one D-wide row each, from all over the buffer.
//
// Launch discipline: both kernels run on the caller's stream, allocate
// nothing and do not synchronize; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;  // rows per block (one warp each)
constexpr int kThreads = kWarps * 32;

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

// y[t] - x rounded to the input type, returned as fp32 (exact).
template <typename T>
__device__ __forceinline__ float rel_in(T yv, float xv) {
  return to_f32(from_f32<T>(to_f32(yv) - xv));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_grads(const T* __restrict__ x, const T* __restrict__ y,
           const int* __restrict__ idx, const T* __restrict__ g,
           T* __restrict__ gx, T* __restrict__ ge, long long rows, int n,
           int m, int d, int k) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp: no block-wide barrier here
  const int lane = threadIdx.x & 31;
  const long long bg = row / n;
  const T* y_b = y + bg * m * d;
  const int* idx_r = idx + row * k;
  T* ge_r = ge + row * k * d;
  for (int c = lane; c < d; c += 32) {
    const float xv = to_f32(x[row * d + c]);
    const float gv = to_f32(g[row * d + c]);
    // max and tie count in one sweep; a NaN rel makes mr NaN, and then no
    // rel equals it (jnp.maximum propagates NaN, == is false for it)
    float mr = -INFINITY;
    int cnt = 0;
    bool nan = false;
    for (int j = 0; j < k; ++j) {
      const float r = rel_in(y_b[(long long)idx_r[j] * d + c], xv);
      if (r != r) {
        nan = true;
      } else if (r > mr) {
        mr = r;
        cnt = 1;
      } else if (r == mr) {
        ++cnt;
      }
    }
    if (nan) cnt = 0;
    const float split = gv / (float)cnt;
    for (int j = 0; j < k; ++j) {
      const float r = rel_in(y_b[(long long)idx_r[j] * d + c], xv);
      ge_r[(long long)j * d + c] = from_f32<T>(!nan && r == mr ? split : 0.f);
    }
    gx[row * d + c] = from_f32<T>(-gv);
  }
}

// order: the flat edge ids (bg*N + n)*k + j sorted by target bg*M + idx,
// then by edge id; first: (BG*M + 1) positions into order, target t's
// edges are order[first[t] .. first[t+1]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_targets(const T* __restrict__ ge, const long long* __restrict__ order,
               const long long* __restrict__ first, T* __restrict__ gy,
               long long targets, int d) {
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= targets) return;
  const int lane = threadIdx.x & 31;
  const long long begin = first[t];
  const long long end = first[t + 1];
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (long long p = begin; p < end; ++p) {
      acc += to_f32(ge[order[p] * d + c]);
    }
    gy[t * d + c] = from_f32<T>(acc);
  }
}

unsigned blocks_for(long long rows) {
  return (unsigned)((rows + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// x (bg, n, d), y (bg, m, d), g (bg, n, d) of one type (is_bf16: bfloat16,
// else float32), idx (bg, n, k) int32 with every entry in [0, m), all
// contiguous. Writes gx (bg, n, d) and the per-edge gradients ge
// (bg, n, k, d), both of the input type. Returns a cudaError_t code.
int knn_mr_edge_grads(const void* x, const void* y, const void* idx,
                      const void* g, void* gx, void* ge, int bg, int n,
                      int m, int d, int k, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bg * n;
  if (rows == 0) return cudaSuccess;
  if (is_bf16) {
    using T = __nv_bfloat16;
    edge_grads<T><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const int*>(idx), static_cast<const T*>(g),
        static_cast<T*>(gx), static_cast<T*>(ge), rows, n, m, d, k);
  } else {
    edge_grads<float><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const int*>(idx), static_cast<const float*>(g),
        static_cast<float*>(gx), static_cast<float*>(ge), rows, n, m, d, k);
  }
  return cudaGetLastError();
}

// ge (bg*n*k, d) from knn_mr_edge_grads; order (bg*n*k) and first
// (targets + 1) int64 as described at gather_targets; writes gy
// (targets, d) of the input type, targets = bg * m.
int knn_mr_gather_targets(const void* ge, const void* order,
                          const void* first, void* gy, long long targets,
                          int d, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (targets == 0) return cudaSuccess;
  const long long* o = static_cast<const long long*>(order);
  const long long* f = static_cast<const long long*>(first);
  if (is_bf16) {
    using T = __nv_bfloat16;
    gather_targets<T><<<blocks_for(targets), kThreads, 0, s>>>(
        static_cast<const T*>(ge), o, f, static_cast<T*>(gy), targets, d);
  } else {
    gather_targets<float><<<blocks_for(targets), kThreads, 0, s>>>(
        static_cast<const float*>(ge), o, f, static_cast<float*>(gy),
        targets, d);
  }
  return cudaGetLastError();
}

const char* knn_mr_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
