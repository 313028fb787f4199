// apex_tpu_torch native host runtime: host-side data-plane ops.
//
// The PyTorch port's own copy of the JAX package's host C++
// (csrc/runtime.cpp at the repository root): apex_C flatten/unflatten
// (bucket coalescing for gradient exchange and checkpoint assembly), the
// byte work of the examples' data_prefetcher (uint8 -> float normalize,
// NHWC -> NCHW) and a bulk float32 -> bfloat16 cast, multi-threaded, over a
// plain C ABI loaded with ctypes (apex_tpu_torch/runtime/__init__.py).
//
// Built with: g++ -O3 -shared -fPIC -pthread -std=c++17 runtime.cpp
// (apex_tpu_torch/_build.py, at first use, into build/apex_tpu_torch/).
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over a small thread pool.  Spawn cost is
// irrelevant against the multi-MB memcpy/convert bodies this serves.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int t = threads;
  if (t <= 0) t = static_cast<int>(std::thread::hardware_concurrency());
  if (t > n) t = static_cast<int>(n);
  if (t <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int w = 0; w < t; ++w) {
    pool.emplace_back([&] {
      for (int64_t i; (i = next.fetch_add(1)) < n;) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Coalesce n buffers (nbytes[i] each) into dst, end to end.  The apex_C
// `flatten` semantic (csrc/flatten_unflatten.cpp:5-8) minus torch: offsets
// are the running byte sums, computed identically by the Python binding.
void apex_flatten(const void** srcs, const int64_t* nbytes, int64_t n,
                  void* dst, int threads) {
  std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; ++i) off[i + 1] = off[i] + nbytes[i];
  auto* out = static_cast<uint8_t*>(dst);
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(out + off[i], srcs[i], static_cast<size_t>(nbytes[i]));
  });
}

// Scatter flat back into n buffers — apex_C `unflatten`
// (csrc/flatten_unflatten.cpp:10-13).
void apex_unflatten(const void* flat, void** dsts, const int64_t* nbytes,
                    int64_t n, int threads) {
  std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; ++i) off[i + 1] = off[i] + nbytes[i];
  auto* in = static_cast<const uint8_t*>(flat);
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(dsts[i], in + off[i], static_cast<size_t>(nbytes[i]));
  });
}

// Fused uint8 NHWC → float32 NCHW with per-channel (x/255 - mean)/std —
// exactly the arithmetic the reference prefetcher runs per batch on its side
// stream (main_amp.py:287-301: sub_(mean).div_(std) after a 255-scale
// normalize folded into mean/std there; we take mean/std in [0,1] units).
void apex_normalize_u8_nhwc_to_f32_nchw(const uint8_t* src, float* dst,
                                        int64_t n, int64_t h, int64_t w,
                                        int64_t c, const float* mean,
                                        const float* stdv, int threads) {
  const int64_t hw = h * w;
  std::vector<float> scale(static_cast<size_t>(c)), bias(
      static_cast<size_t>(c));
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stdv[ch]);
    bias[ch] = -mean[ch] / stdv[ch];
  }
  parallel_for(n * c, threads, [&](int64_t job) {
    const int64_t img = job / c, ch = job % c;
    const uint8_t* s = src + img * hw * c + ch;
    float* d = dst + img * c * hw + ch * hw;
    const float sc = scale[ch], bi = bias[ch];
    for (int64_t i = 0; i < hw; ++i) d[i] = s[i * c] * sc + bi;
  });
}

// Layout-preserving variant for channels-last models (nn.to_channels_last):
// uint8 NHWC → float32 NHWC, same per-channel normalize, no transpose — the
// channel sweep stays the inner (contiguous) loop on both sides.
void apex_normalize_u8_nhwc_to_f32_nhwc(const uint8_t* src, float* dst,
                                        int64_t n, int64_t h, int64_t w,
                                        int64_t c, const float* mean,
                                        const float* stdv, int threads) {
  std::vector<float> scale(static_cast<size_t>(c)), bias(
      static_cast<size_t>(c));
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stdv[ch]);
    bias[ch] = -mean[ch] / stdv[ch];
  }
  // split n*h ways (rows are layout-contiguous; channels are
  // interleaved) so small batches still fan out across cores — the
  // NCHW sibling's n*c granularity, adapted to this layout
  parallel_for(n * h, threads, [&](int64_t job) {
    const int64_t off = job * w * c;
    const uint8_t* s = src + off;
    float* d = dst + off;
    for (int64_t i = 0; i < w; ++i) {
      for (int64_t ch = 0; ch < c; ++ch) {
        d[i * c + ch] = s[i * c + ch] * scale[ch] + bias[ch];
      }
    }
  });
}

// float32 → bfloat16 (round-to-nearest-even) bulk cast: host-side half of
// feeding bf16 batches without paying an on-device cast + extra transfer.
void apex_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                      int threads) {
  constexpr int64_t kChunk = 1 << 16;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  parallel_for(chunks, threads, [&](int64_t cidx) {
    const int64_t lo = cidx * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t x;
      std::memcpy(&x, src + i, 4);
      const uint32_t rounding = 0x7FFF + ((x >> 16) & 1);
      if ((x & 0x7F800000) == 0x7F800000 && (x & 0x007FFFFF)) {
        dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040);  // quiet NaN
      } else {
        dst[i] = static_cast<uint16_t>((x + rounding) >> 16);
      }
    }
  });
}

int apex_runtime_abi_version() { return 1; }

}  // extern "C"
