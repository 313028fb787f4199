// Helpers shared by the kernel sources: the dtype codes of the C entry
// points and the conversions between those types and fp32.  Each source
// compiles into a library of its own, so these live in an anonymous
// namespace, one copy per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// dtype codes of every C entry point: 0 float32, 1 bfloat16, 2 float16
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2;

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

// element i of an array whose dtype is known only at run time
__device__ __forceinline__ float load_as_f(const void* p, long long i, int dtype) {
  switch (dtype) {
    case DT_BF16: return to_f(static_cast<const __nv_bfloat16*>(p)[i]);
    case DT_F16: return to_f(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// element i of an array whose dtype is known only at run time := v,
// rounded once to nearest even (as torch's .to(dtype))
__device__ __forceinline__ void store_from_f(void* p, long long i, float v, int dtype) {
  switch (dtype) {
    case DT_BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v); break;
    case DT_F16: static_cast<__half*>(p)[i] = __float2half(v); break;
    default: static_cast<float*>(p)[i] = v;
  }
}

}  // namespace

extern "C" const char* apex_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
