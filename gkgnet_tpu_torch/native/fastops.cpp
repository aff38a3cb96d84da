// Host-side image ops of the data loader (counterpart:
// gkgnet_tpu/native/fastops.cpp, the same arithmetic).
//
// A plain C interface over caller-owned buffers, bound with ctypes
// (gkgnet_tpu_torch/native/__init__.py); ctypes releases the interpreter
// lock for the call, so the loader's threads run these in parallel. The
// Python side checks every dtype, shape and contiguity before it passes a
// pointer. Built with -ffp-contract=off: each result is bitwise the numpy
// plain version beside the binding (same float32 operations in the same
// order, no fused multiply-add).
//
//   fo_normalize_u8    uint8 (n_pix, 3) -> float32 (x - mean) * (1 / std)
//   fo_collate_normalize  the same over a batch of equal-size images
//   fo_mix_chain       CropMixup's blend recursion over uint8 views
//   fo_color_jitter    brightness / contrast / saturation chain

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct NormJob {
  const uint8_t* src;
  float* dst;
  int64_t n_pix;  // number of 3-channel pixels
  float mean[3];
  float inv_std[3];
};

void run_norm(const NormJob& job, int64_t begin, int64_t end) {
  const uint8_t* s = job.src + begin * 3;
  float* d = job.dst + begin * 3;
  const float m0 = job.mean[0], m1 = job.mean[1], m2 = job.mean[2];
  const float i0 = job.inv_std[0], i1 = job.inv_std[1], i2 = job.inv_std[2];
  for (int64_t p = begin; p < end; ++p) {
    d[0] = (static_cast<float>(s[0]) - m0) * i0;
    d[1] = (static_cast<float>(s[1]) - m1) * i1;
    d[2] = (static_cast<float>(s[2]) - m2) * i2;
    s += 3;
    d += 3;
  }
}

void run_norm_parallel(const NormJob& job, int max_threads) {
  const int64_t kMinPerThread = 1 << 16;
  int n_threads = static_cast<int>(
      std::min<int64_t>(max_threads, job.n_pix / kMinPerThread + 1));
  if (n_threads <= 1) {
    run_norm(job, 0, job.n_pix);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (job.n_pix + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = std::min<int64_t>(b + chunk, job.n_pix);
    if (b >= e) break;
    threads.emplace_back(run_norm, std::cref(job), b, e);
  }
  for (auto& th : threads) th.join();
}

NormJob make_job(const uint8_t* src, float* dst, int64_t n_pix,
                 const float* mean, const float* stdv) {
  NormJob job;
  job.src = src;
  job.dst = dst;
  job.n_pix = n_pix;
  for (int i = 0; i < 3; ++i) {
    job.mean[i] = mean[i];
    job.inv_std[i] = 1.0f / stdv[i];
  }
  return job;
}

inline float clip255(float x) {
  return x < 0.0f ? 0.0f : (x > 255.0f ? 255.0f : x);
}

// L = (299 R + 587 G + 114 B) / 1000 (ITU-R 601, PIL "L")
inline float luma(const float* p) {
  return (299.0f * p[0] + 587.0f * p[1] + 114.0f * p[2]) * 1e-3f;
}

}  // namespace

extern "C" {

void fo_normalize_u8(const uint8_t* src, int64_t n_pix, const float* mean,
                     const float* stdv, float* out) {
  run_norm_parallel(make_job(src, out, n_pix, mean, stdv),
                    static_cast<int>(std::thread::hardware_concurrency()));
}

// srcs: batch pointers to uint8 (n_pix, 3) images; out: float32
// (batch, n_pix, 3).
void fo_collate_normalize(const uint8_t* const* srcs, int64_t batch,
                          int64_t n_pix, const float* mean, const float* stdv,
                          float* out) {
  std::vector<NormJob> jobs;
  for (int64_t b = 0; b < batch; ++b)
    jobs.push_back(make_job(srcs[b], out + b * n_pix * 3, n_pix, mean, stdv));
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int per_sample_threads = std::max(1, hw / std::max<int>(1, (int)batch));
  std::vector<std::thread> workers;
  for (int64_t b = 0; b < batch; ++b)
    workers.emplace_back([&jobs, b, per_sample_threads] {
      run_norm_parallel(jobs[b], per_sample_threads);
    });
  for (auto& w : workers) w.join();
}

// buf = float(views[0]); for each pass i (view = views[i + 1]):
//   side 0: buf = lam*buf + (1-lam)*view
//   side 1: buf = lam*buf + (1-lam)*view[..., perm]
//   side 2: buf = lam*buf[..., perm] + (1-lam)*view
// out = uint8(clip(buf, 0, 255)) (a truncating cast, numpy's astype).
// views: n_views pointers to uint8 buffers of len bytes (len % 3 == 0);
// lams, sides: n_views - 1 entries; perms: 3 per pass.
void fo_mix_chain(const uint8_t* const* views, int64_t n_views, int64_t len,
                  const float* lams, const int32_t* sides,
                  const int32_t* perms, uint8_t* out) {
  const int64_t n_pix = len / 3;
  std::vector<float> buf(static_cast<size_t>(len));
  for (int64_t j = 0; j < len; ++j) buf[j] = static_cast<float>(views[0][j]);
  for (int64_t i = 0; i + 1 < n_views; ++i) {
    const uint8_t* v = views[i + 1];
    const float lam = lams[i], inv = 1.0f - lams[i];
    const int p0 = perms[3 * i], p1 = perms[3 * i + 1], p2 = perms[3 * i + 2];
    float* b = buf.data();
    if (sides[i] == 0) {
      for (int64_t j = 0; j < len; ++j)
        b[j] = lam * b[j] + inv * static_cast<float>(v[j]);
    } else if (sides[i] == 1) {
      for (int64_t p = 0; p < n_pix; ++p, b += 3, v += 3) {
        b[0] = lam * b[0] + inv * static_cast<float>(v[p0]);
        b[1] = lam * b[1] + inv * static_cast<float>(v[p1]);
        b[2] = lam * b[2] + inv * static_cast<float>(v[p2]);
      }
    } else {
      for (int64_t p = 0; p < n_pix; ++p, b += 3, v += 3) {
        const float b0 = b[p0], b1 = b[p1], b2 = b[p2];
        b[0] = lam * b0 + inv * static_cast<float>(v[0]);
        b[1] = lam * b1 + inv * static_cast<float>(v[1]);
        b[2] = lam * b2 + inv * static_cast<float>(v[2]);
      }
    }
  }
  for (int64_t j = 0; j < len; ++j)
    out[j] = static_cast<uint8_t>(clip255(buf[j]));
}

// kinds[i]: 0 brightness (v *= f), 1 contrast (v = f*v + (1-f)*mean(L),
// L of the current state, summed in double in pixel order), 2 saturation
// (v = f*v + (1-f)*L(pixel)). Values clip to [0, 255] after every op; the
// final store rounds to nearest (+0.5, truncate).
void fo_color_jitter(const uint8_t* img, int64_t len, const int32_t* kinds,
                     const float* factors, int64_t n_ops, uint8_t* out) {
  const int64_t n_pix = len / 3;
  std::vector<float> buf(static_cast<size_t>(len));
  for (int64_t j = 0; j < len; ++j) buf[j] = static_cast<float>(img[j]);
  for (int64_t i = 0; i < n_ops; ++i) {
    const float f = factors[i], inv = 1.0f - factors[i];
    float* b = buf.data();
    if (kinds[i] == 0) {
      for (int64_t j = 0; j < len; ++j) b[j] = clip255(b[j] * f);
    } else if (kinds[i] == 1) {
      double sum = 0.0;
      for (int64_t q = 0; q < n_pix; ++q) sum += luma(b + 3 * q);
      const float add = inv * static_cast<float>(sum / n_pix);
      for (int64_t j = 0; j < len; ++j) b[j] = clip255(f * b[j] + add);
    } else {
      for (int64_t q = 0; q < n_pix; ++q, b += 3) {
        const float add = inv * luma(b);
        b[0] = clip255(f * b[0] + add);
        b[1] = clip255(f * b[1] + add);
        b[2] = clip255(f * b[2] + add);
      }
    }
  }
  for (int64_t j = 0; j < len; ++j)
    out[j] = static_cast<uint8_t>(clip255(buf[j]) + 0.5f);
}

}  // extern "C"
