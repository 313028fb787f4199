// LayerNorm forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/kernels/layer_norm.py::ln_forward (Pallas kernel
// _fwd_kernel): y = (x - mean) * rstd [* w + b] over the last dim, with the
// two-pass fp32 statistics of the JAX kernel (mean first, then the mean of
// the squared deviations; not Welford, not E[x^2] - E[x]^2) and
// rstd = 1 / sqrt(var + eps).  y is in x's dtype; mean and rstd are fp32,
// one per row.
//
// Bound on the H100: bytes.  At the GPT-2-small shapes (4096 x 768 in
// prefill, 8 x 768 per decode step) the kernel does ~8 operations per
// element it reads and writes once, far below the card's ~20 fp32
// operations per byte, so the least time is (read x + write y) over
// 3.35 TB/s; the 8-row decode shape is bound by launch latency.
//
// Design: the row stays in registers, so x is read from memory once and
// both passes run out of registers.  A row of n <= 1024 belongs to one warp
// (four rows per 128-thread block); a longer row to a 256- or 1024-thread
// block, whose warps combine their partial sums through shared memory.
// Each thread holds VPT elements at a stride of the row's thread count, so
// neighbouring threads read neighbouring addresses.  Up to n = 16384.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// Sum over the TPR threads of one row: shuffles inside each warp, then, for a
// row spread over several warps, one partial per warp through shared memory.
template <int WPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (WPR > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // the previous reduction's reads of red are done
    if (lane == 0) red[warp] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) s += red[i];
  }
  return s;
}

template <int TPR>
struct Shape {
  static constexpr int RPC = TPR >= 128 ? 1 : 128 / TPR;  // rows per block
  static constexpr int WPR = TPR / 32;                     // warps per row
};

template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int rows, int n, float eps) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR;
  __shared__ float red[RPC][WPR];
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  // a block of several warps holds one row (RPC == 1), so a block either
  // returns whole or not at all and the __syncthreads in row_sum are safe
  if (row >= rows) return;
  const T* xr = x + row * n;

  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    v[i] = c < n ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = row_sum<WPR>(s, red[threadIdx.y]) / n;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    if (c < n) {
      const float dv = v[i] - mu;
      q += dv * dv;
    }
  }
  const float var = row_sum<WPR>(q, red[threadIdx.y]) / n;
  const float rs = 1.f / sqrtf(var + eps);

  T* yr = y + row * n;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    if (c < n) {
      float o = (v[i] - mu) * rs;
      if (w != nullptr) o = o * w[c] + b[c];
      yr[c] = from_f<T>(o);
    }
  }
  if (tid == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

template <typename T, int VPT, int TPR>
cudaError_t launch(const void* x, const float* w, const float* b, void* y, float* mean,
                   float* rstd, int rows, int n, float eps, cudaStream_t st) {
  constexpr int RPC = Shape<TPR>::RPC;
  const dim3 block(TPR, RPC);
  const dim3 grid((rows + RPC - 1) / RPC);
  ln_fwd_kernel<T, VPT, TPR><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), mean, rstd, rows, n, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* w, const float* b, void* y, float* mean,
                     float* rstd, int rows, int n, float eps, cudaStream_t st) {
  if (n <= 128) return launch<T, 4, 32>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 256) return launch<T, 8, 32>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 512) return launch<T, 16, 32>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 768) return launch<T, 24, 32>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 1024) return launch<T, 32, 32>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 2048) return launch<T, 8, 256>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 4096) return launch<T, 16, 256>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 8192) return launch<T, 32, 256>(x, w, b, y, mean, rstd, rows, n, eps, st);
  if (n <= 16384) return launch<T, 16, 1024>(x, w, b, y, mean, rstd, rows, n, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, n) contiguous in dtype (0 float32, 1 bfloat16, 2 float16);
// w, b (n,) float32, both null for the non-affine form; y like x;
// mean, rstd (rows,) float32.  Returns the cudaError_t of the launch.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
                           void* rstd, int rows, int n, float eps, int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || (wf == nullptr) != (bf == nullptr)) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dispatch<float>(x, wf, bf, y, mf, rf, rows, n, eps, st);
    case 1: return dispatch<__nv_bfloat16>(x, wf, bf, y, mf, rf, rows, n, eps, st);
    case 2: return dispatch<__half>(x, wf, bf, y, mf, rf, rows, n, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
