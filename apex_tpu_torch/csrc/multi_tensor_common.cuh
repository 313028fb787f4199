// What the multi-tensor optimizer kernels (multi_tensor_adam.cu,
// multi_tensor_sgd.cu) share: four values of a dtype as fp32 in one vector
// access, the dtype dispatch of their C entry points and the walk over a
// list's chunk map.
//
// A launch takes a list of up to MT_MAX_TENSORS tensors.  Each tensor is
// cut into chunks of `chunk` elements (at most MT_MAX_CHUNK), and a device
// table maps each chunk to its (tensor, element offset); the wrapper
// (kernels/multi_tensor.py) picks the chunk per list so that a short list
// still gives every SM several chunks.  One block takes a chunk, and a
// thread loads MT_UNROLL vectors of every array before it computes.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MT_THREADS = 256;       // threads per block
constexpr int MT_MAX_CHUNK = 65536;   // elements per chunk, the most a launch takes
constexpr int MT_MAX_TENSORS = 256;   // tensors per launch
// vectors of each array a thread loads before it computes: 1, as 2 and 4
// measured no faster in fp32 and slower with half parameters (PERF.md)
constexpr int MT_UNROLL = 1;

// four consecutive elements of T as fp32, loaded from and stored to an
// address aligned to ALIGN (16 bytes in fp32, 8 in a half dtype); a store
// rounds to nearest, as from_f<T> does; load_ro reads through the
// read-only data path
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static constexpr uintptr_t ALIGN = 16;
  __device__ static void unpack(const float4 t, float o[4]) {
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
  __device__ static void load(const float* a, float o[4]) {
    unpack(*reinterpret_cast<const float4*>(a), o);
  }
  __device__ static void load_ro(const float* a, float o[4]) {
    unpack(__ldg(reinterpret_cast<const float4*>(a)), o);
  }
  __device__ static void store(float* a, const float o[4]) {
    *reinterpret_cast<float4*>(a) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  static constexpr uintptr_t ALIGN = 8;
  __device__ static void unpack(const uint2 u, float o[4]) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
  }
  __device__ static void load(const __nv_bfloat16* a, float o[4]) {
    unpack(*reinterpret_cast<const uint2*>(a), o);
  }
  __device__ static void load_ro(const __nv_bfloat16* a, float o[4]) {
    unpack(__ldg(reinterpret_cast<const uint2*>(a)), o);
  }
  __device__ static void store(__nv_bfloat16* a, const float o[4]) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 y = __floats2bfloat162_rn(o[2], o[3]);
    *reinterpret_cast<uint2*>(a) = make_uint2(*reinterpret_cast<const unsigned*>(&x),
                                              *reinterpret_cast<const unsigned*>(&y));
  }
};
template <> struct Vec4<__half> {
  static constexpr uintptr_t ALIGN = 8;
  __device__ static void unpack(const uint2 u, float o[4]) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 y = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
  }
  __device__ static void load(const __half* a, float o[4]) {
    unpack(*reinterpret_cast<const uint2*>(a), o);
  }
  __device__ static void load_ro(const __half* a, float o[4]) {
    unpack(__ldg(reinterpret_cast<const uint2*>(a)), o);
  }
  __device__ static void store(__half* a, const float o[4]) {
    const __half2 x = __floats2half2_rn(o[0], o[1]);
    const __half2 y = __floats2half2_rn(o[2], o[3]);
    *reinterpret_cast<uint2*>(a) = make_uint2(*reinterpret_cast<const unsigned*>(&x),
                                              *reinterpret_cast<const unsigned*>(&y));
  }
};

template <typename T> __device__ __forceinline__ bool vec_aligned(const T* a) {
  return reinterpret_cast<uintptr_t>(a) % Vec4<T>::ALIGN == 0;
}

// f(tensor, element offset, elements) for each chunk of the table's chunk
// map that falls to this block: chunk c to block c % gridDim.x.  The C
// entry points launch one block a chunk, which the SMs take up as their
// blocks finish (fewer blocks, as many as are resident at once, each
// walking the chunks at this stride, measured slower: PERF.md).  The table
// (int64) holds three address rows [3 * nt], the sizes [nt], then per
// chunk (tensor index, element offset) [2 * nc].
template <typename F>
__device__ __forceinline__ void for_each_chunk(const long long* __restrict__ table, int nt,
                                               int nc, int chunk, F&& f) {
  const long long* sizes = table + 3 * nt;
  const long long* chunks = table + 4 * nt;
  for (int c = blockIdx.x; c < nc; c += gridDim.x) {
    const int t = (int)chunks[2 * c];
    const long long off = chunks[2 * c + 1];
    f(t, off, (int)min((long long)chunk, sizes[t] - off));
  }
}

template <typename T> struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the type T of a dtype code
template <typename F> cudaError_t with_dtype(int code, F&& f) {
  switch (code) {
    case DT_F32: return f(Tag<float>{});
    case DT_BF16: return f(Tag<__nv_bfloat16>{});
    case DT_F16: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
