// Adam / AdamW over a list of tensors in one launch, for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/kernels/multi_tensor.py::fused_adam (Pallas kernel
// _adam_kernel): per element, in fp32 and in this order,
//   g += wd * p                      (mode 0, L2, with weight decay)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * g * g
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)
//   u += wd * p                      (mode 1, decoupled, with weight decay)
//   p  = p - lr * u
// with lr, wd, b1, 1 - b1, b2, 1 - b2, eps and the bias corrections bc1,
// bc2 read as nine fp32 values from device memory, so a train step whose
// step count lives on the card makes no host round trip.  Every operation
// is an IEEE round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn): nvcc would otherwise contract a * b + c into one FMA, and the
// plain PyTorch version, one operation per elementwise kernel, rounds after
// each, so the two agree bit for bit.  Like the reference it never writes
// the overflow flag; unlike the Pallas kernel, which returns new arrays for
// its caller to select from, it updates p, m and v in place, so it reads
// the flag itself and leaves every tensor untouched when the flag is set.
//
// Bound on the H100: bytes.  Each element reads g, p, m and v and writes p,
// m and v: 26-28 bytes with fp32 p, m and v, 14 with all four in fp16, for
// ~15 operations.  At GPT-2 small (124.4 M parameters in 124 tensors) that
// is 3.2-3.5 GB, ~1 ms at 3.35 TB/s, or 1.74 GB, ~0.52 ms, in fp16.
//
// Design: the reference CUDA design (multi_tensor_apply.cuh), not the
// Pallas copy of every tensor into one packed panel, which would move the
// bytes twice more.  Each tensor is cut into chunks of 65536 elements and
// one 256-thread block takes a chunk.  A device table holds each tensor's
// p, m and v addresses, its size and the chunk -> (tensor, offset) map; the
// caller builds it once per list and keeps it, since the in-place updates
// keep those addresses.  The gradients are new tensors every step, so
// their addresses travel in the launch's parameters instead (up to 256
// tensors a launch).  g is fp32, bf16 or fp16; so are p, m and v, each
// list of one dtype.  Every value is read as fp32, updated in fp32 and
// written back rounded to nearest in its own dtype, as the JAX function
// casts its fp32 results back (so O3's half parameters and moments run
// here too).  The kernel is a template on the four dtypes, one instance
// for each combination: a thread takes four consecutive elements with one
// vector load and store per array (16 bytes in fp32, 8 in a half dtype)
// where every address of the chunk allows it, and the rest one by one.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CHUNK = 65536;   // elements per chunk (one block's work)
constexpr int NT = 256;        // threads per block
constexpr int MAXT = 256;      // tensors per launch
enum { LR, WD, B1, OMB1, B2, OMB2, EPS, BC1, BC2 };

struct GradList {
  const void* g[MAXT];
};

struct Scalars {
  float lr, wd, b1, omb1, b2, omb2, eps, bc1, bc2;
};

__device__ __forceinline__ void adam_elem(float g, float& p, float& m, float& v,
                                          const Scalars& s, bool l2, bool decoupled) {
  if (l2) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (decoupled) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

// four consecutive elements of T as fp32, loaded from and stored to an
// address aligned to ALIGN; a store rounds to nearest, as from_f<T> does
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static constexpr uintptr_t ALIGN = 16;
  __device__ static void load(const float* a, float o[4]) {
    const float4 t = *reinterpret_cast<const float4*>(a);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
  __device__ static void store(float* a, const float o[4]) {
    *reinterpret_cast<float4*>(a) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  static constexpr uintptr_t ALIGN = 8;
  __device__ static void load(const __nv_bfloat16* a, float o[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(a);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
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
  __device__ static void load(const __half* a, float o[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(a);
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 y = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
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

// table (int64): p, m, v addresses [3 * nt], sizes [nt], then per chunk
// (tensor index, element offset) [2 * nc]
template <typename G, typename P, typename M, typename V>
__global__ void __launch_bounds__(NT)
adam_kernel(GradList gl, const long long* __restrict__ table, int nt, int nc,
            const float* __restrict__ scal, const int* __restrict__ flag, int use_wd,
            int decoupled) {
  if (flag != nullptr && *flag != 0) return;  // a skipped step: nothing changes
  const Scalars s{scal[LR], scal[WD], scal[B1], scal[OMB1], scal[B2],
                  scal[OMB2], scal[EPS], scal[BC1], scal[BC2]};
  const bool l2 = use_wd && !decoupled, dec = use_wd && decoupled;
  const long long* sizes = table + 3 * nt;
  const long long* chunks = table + 4 * nt;
  for (int c = blockIdx.x; c < nc; c += gridDim.x) {
    const int t = (int)chunks[2 * c];
    const long long off = chunks[2 * c + 1];
    const int n = (int)min((long long)CHUNK, sizes[t] - off);
    const G* g = static_cast<const G*>(gl.g[t]) + off;
    P* p = reinterpret_cast<P*>(table[t]) + off;
    M* m = reinterpret_cast<M*>(table[nt + t]) + off;
    V* v = reinterpret_cast<V*>(table[2 * nt + t]) + off;
    int tail = 0;
    if (vec_aligned(g) && vec_aligned(p) && vec_aligned(m) && vec_aligned(v)) {
      const int n4 = n / 4;
      for (int i = threadIdx.x; i < n4; i += NT) {
        float gv[4], pv[4], mv[4], vv[4];
        Vec4<G>::load(g + 4 * i, gv);
        Vec4<P>::load(p + 4 * i, pv);
        Vec4<M>::load(m + 4 * i, mv);
        Vec4<V>::load(v + 4 * i, vv);
#pragma unroll
        for (int e = 0; e < 4; ++e) adam_elem(gv[e], pv[e], mv[e], vv[e], s, l2, dec);
        Vec4<P>::store(p + 4 * i, pv);
        Vec4<M>::store(m + 4 * i, mv);
        Vec4<V>::store(v + 4 * i, vv);
      }
      tail = n4 * 4;
    }
    for (int i = tail + threadIdx.x; i < n; i += NT) {
      float pv = to_f(p[i]), mv = to_f(m[i]), vv = to_f(v[i]);
      adam_elem(to_f(g[i]), pv, mv, vv, s, l2, dec);
      p[i] = from_f<P>(pv);
      m[i] = from_f<M>(mv);
      v[i] = from_f<V>(vv);
    }
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

// The most tensors one apex_adam call takes.
extern "C" int apex_adam_max_tensors() { return MAXT; }

// The chunk size in elements that the table's chunk map uses.
extern "C" int apex_adam_chunk() { return CHUNK; }

// grads: host array of nt device addresses of the gradients, all of gdtype
// (0 float32, 1 bfloat16, 2 float16); table: the device table above for p,
// m and v (nc chunks), of pdtype, mdtype and vdtype; scal: 9 fp32 device
// values (lr, wd, b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2); flag: device
// int32, or null; nothing changes when it is non-zero.  decoupled: 1 for
// AdamW, 0 for L2; use_wd: 0 leaves weight decay out.  Returns the
// cudaError_t of the launch.
extern "C" int apex_adam(const void* const* grads, const void* table, int nt, int nc,
                         const void* scal, const void* flag, int gdtype, int use_wd,
                         int decoupled, int pdtype, int mdtype, int vdtype, void* stream) {
  if (nt <= 0 || nt > MAXT || nc <= 0 || grads == nullptr || table == nullptr ||
      scal == nullptr)
    return cudaErrorInvalidValue;
  GradList gl;
  for (int i = 0; i < nt; ++i) gl.g[i] = grads[i];
  for (int i = nt; i < MAXT; ++i) gl.g[i] = nullptr;
  const long long* tb = static_cast<const long long*>(table);
  const float* sc = static_cast<const float*>(scal);
  const int* fl = static_cast<const int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(gdtype, [&](auto tg) {
    return with_dtype(pdtype, [&](auto tp) {
      return with_dtype(mdtype, [&](auto tm) {
        return with_dtype(vdtype, [&](auto tv) {
          adam_kernel<typename decltype(tg)::type, typename decltype(tp)::type,
                      typename decltype(tm)::type, typename decltype(tv)::type>
              <<<nc, NT, 0, st>>>(gl, tb, nt, nc, sc, fl, use_wd, decoupled);
          return cudaGetLastError();
        });
      });
    });
  });
}
