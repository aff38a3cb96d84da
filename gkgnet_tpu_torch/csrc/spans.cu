// Span markers: one empty one-thread kernel per boundary of each of the
// port's device spans (utils/profiling.py span()), launched on the current
// stream while it captures a CUDA graph. They become nodes of the graph,
// so every replay runs them in stream order and a profile's device
// timeline shows where each span begins and ends, with no host code in the
// replay. The kernels are extern "C" so that a trace names them as
// written here: gkgnet_span_begin_<name> and gkgnet_span_end_<name>.
//
// GKGNET_SPANS is the one list of the spans; the kernels, the names and the
// launch table are generated from it.

#include <cuda_runtime.h>

#define GKGNET_SPANS(X)                                                      \
  X(forward) X(loss) X(backward) X(optimizer) X(ema) X(loss_scale)            \
  X(stem) X(stage1) X(stage2) X(stage3) X(stage4)                             \
  X(label1) X(label2) X(label3) X(label4) X(head)

#define GKGNET_SPAN_KERNELS(name)                                            \
  extern "C" __global__ void gkgnet_span_begin_##name() {}                    \
  extern "C" __global__ void gkgnet_span_end_##name() {}
GKGNET_SPANS(GKGNET_SPAN_KERNELS)

namespace {

typedef void (*Marker)();

#define GKGNET_SPAN_NAME(name) #name,
const char* const kNames[] = {GKGNET_SPANS(GKGNET_SPAN_NAME)};

#define GKGNET_SPAN_PAIR(name)                                               \
  {gkgnet_span_begin_##name, gkgnet_span_end_##name},
const Marker kMarkers[][2] = {GKGNET_SPANS(GKGNET_SPAN_PAIR)};

constexpr int kCount = sizeof(kNames) / sizeof(kNames[0]);

}  // namespace

extern "C" int gkgnet_span_count() { return kCount; }

extern "C" const char* gkgnet_span_name(int i) {
  return i >= 0 && i < kCount ? kNames[i] : "";
}

// Loads every marker kernel on the current device (a stream that captures
// may not load a module, and lazy loading would load each at its first
// launch).
extern "C" int gkgnet_span_load() {
  cudaFuncAttributes attr;
  for (int i = 0; i < kCount; ++i) {
    for (int end = 0; end < 2; ++end) {
      cudaError_t err = cudaFuncGetAttributes(
          &attr, reinterpret_cast<const void*>(kMarkers[i][end]));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// Launches span i's begin (end = 0) or end (end = 1) marker, <<<1, 1>>>
// with no shared memory, on stream.
extern "C" int gkgnet_span_mark(int i, int end, void* stream) {
  if (i < 0 || i >= kCount || end < 0 || end > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* none[1] = {nullptr};
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kMarkers[i][end]), dim3(1), dim3(1), none,
      0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

extern "C" const char* gkgnet_span_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
