// Momentum SGD over a list of tensors in one launch, for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/kernels/multi_tensor.py::fused_sgd (Pallas kernel
// _sgd_kernel): per element, in fp32 and in this order,
//   gf  = g * scale
//   gf += wd * p                     (weight decay before momentum)
//   m   = momentum * m + (1 - dampening) * gf     (m = gf on the first run)
//   u   = gf + momentum * m (nesterov) or m       (u = gf with momentum 0)
//   u  += wd * p                     (weight decay after momentum)
//   p   = p - lr * u
// over [grads, params, momenta] (depth 3), or with a fourth list, a half
// model copy of the params written from the new fp32 p in the same pass
// (depth 4, amp O2's masters and model).  lr, wd and scale are read as fp32
// values from device memory, so a scheduled lr (lr x schedule(step) on the
// card) never reaches the host; momentum and 1 - dampening (computed on the
// host in double, as the JAX kernel's Python floats are) share that vector.
// Every operation is an IEEE round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn): nvcc would otherwise contract a * b + c into one
// FMA, and the plain PyTorch version, one operation per elementwise kernel,
// rounds after each, so the two agree bit for bit.  With momentum 0 the
// momenta are neither read nor written.  The update never writes the noop
// flag; it reads it and leaves p, m and the model copy untouched when it is
// set (the JAX function selects the old values after the kernel instead;
// the result is the same).
//
// Bound on the H100: bytes.  Each element reads g, p and m and writes p and
// m (and the model copy): 18 bytes with a bf16 g and fp32 p and m, 22 with
// an fp32 g and an fp16 model copy, for ~8 operations.  At ResNet-50 (25.56 M
// parameters in 161 tensors) that is 460-562 MB, 0.14-0.17 ms at 3.35 TB/s.
//
// Design: the reference CUDA design (multi_tensor_apply.cuh), as in
// multi_tensor_adam.cu, not the Pallas copy of every tensor into one packed
// panel.  Each tensor is cut into chunks of 65536 elements and one
// 256-thread block takes a chunk.  A device table holds each tensor's p, m
// and model-copy addresses, its size and the chunk -> (tensor, offset) map;
// the caller builds it once per list and keeps it, since the in-place
// updates keep those addresses.  The gradients are new tensors every step,
// so their addresses travel in the launch's parameters, each with its own
// dtype code: one launch takes a list whose gradients mix dtypes (under
// keep_batchnorm_fp32 ResNet's conv and fc gradients are bf16 and its
// BatchNorm gradients fp32) without a widening pass.  A chunk lies in one
// tensor, so the switch on the gradient's dtype is uniform over a block.
// The kernel is a template on the params' dtype (fp32, bf16, fp16) and the
// model copy's (none, bf16, fp16): 9 instances, each with three gradient
// paths.  A thread takes four consecutive elements with one vector load and
// store per array where every address of the chunk allows it, and the rest
// one by one.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int CHUNK = 65536;   // elements per chunk (one block's work)
constexpr int NT = 256;        // threads per block
constexpr int MAXT = 256;      // tensors per launch
enum { LR, WD, SCALE, MOM, OMD };

struct GradList {
  const void* g[MAXT];
  unsigned char dt[MAXT];      // dtype code of each gradient
};

struct Scalars {
  float lr, wd, scale, mom, omd;
};

struct Mode {
  bool wd_before, wd_after, has_mom, first_run, nesterov;
};

__device__ __forceinline__ void sgd_elem(float g, float& p, float& m, const Scalars& s,
                                         const Mode& md) {
  float gf = __fmul_rn(g, s.scale);
  if (md.wd_before) gf = __fadd_rn(gf, __fmul_rn(s.wd, p));
  float u = gf;
  if (md.has_mom) {
    m = md.first_run ? gf : __fadd_rn(__fmul_rn(s.mom, m), __fmul_rn(s.omd, gf));
    u = md.nesterov ? __fadd_rn(gf, __fmul_rn(s.mom, m)) : m;
  }
  if (md.wd_after) u = __fadd_rn(u, __fmul_rn(s.wd, p));
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

// the model copy's type, or NoCopy at depth 3
struct NoCopy {};

// one chunk of n elements: g of type G, p of type P, m fp32 (untouched
// without momentum), c the model copy of type C
template <typename G, typename P, typename C>
__device__ __forceinline__ void sgd_chunk(const G* __restrict__ g, P* __restrict__ p,
                                          float* __restrict__ m, C* __restrict__ c, int n,
                                          const Scalars& s, const Mode& md) {
  constexpr bool COPY = !std::is_same<C, NoCopy>::value;
  bool aligned = vec_aligned(g) && vec_aligned(p) && (!md.has_mom || vec_aligned(m));
  if constexpr (COPY) aligned = aligned && vec_aligned(c);
  int tail = 0;
  if (aligned) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += NT) {
      float gv[4], pv[4], mv[4] = {0.f, 0.f, 0.f, 0.f};
      Vec4<G>::load(g + 4 * i, gv);
      Vec4<P>::load(p + 4 * i, pv);
      if (md.has_mom && !md.first_run) Vec4<float>::load(m + 4 * i, mv);
#pragma unroll
      for (int e = 0; e < 4; ++e) sgd_elem(gv[e], pv[e], mv[e], s, md);
      Vec4<P>::store(p + 4 * i, pv);
      if (md.has_mom) Vec4<float>::store(m + 4 * i, mv);
      if constexpr (COPY) Vec4<C>::store(c + 4 * i, pv);
    }
    tail = n4 * 4;
  }
  for (int i = tail + threadIdx.x; i < n; i += NT) {
    float pv = to_f(p[i]), mv = (md.has_mom && !md.first_run) ? m[i] : 0.f;
    sgd_elem(to_f(g[i]), pv, mv, s, md);
    p[i] = from_f<P>(pv);
    if (md.has_mom) m[i] = mv;
    if constexpr (COPY) c[i] = from_f<C>(pv);
  }
}

// table (int64): p, m, model-copy addresses [3 * nt], sizes [nt], then per
// chunk (tensor index, element offset) [2 * nc]
template <typename P, typename C>
__global__ void __launch_bounds__(NT)
sgd_kernel(GradList gl, const long long* __restrict__ table, int nt, int nc,
           const float* __restrict__ scal, const int* __restrict__ flag, Mode md) {
  if (flag != nullptr && *flag != 0) return;  // a skipped step: nothing changes
  const Scalars s{scal[LR], scal[WD], scal[SCALE], scal[MOM], scal[OMD]};
  const long long* sizes = table + 3 * nt;
  const long long* chunks = table + 4 * nt;
  for (int ch = blockIdx.x; ch < nc; ch += gridDim.x) {
    const int t = (int)chunks[2 * ch];
    const long long off = chunks[2 * ch + 1];
    const int n = (int)min((long long)CHUNK, sizes[t] - off);
    P* p = reinterpret_cast<P*>(table[t]) + off;
    float* m = reinterpret_cast<float*>(table[nt + t]) + off;
    C* c = reinterpret_cast<C*>(table[2 * nt + t]) + off;
    switch (gl.dt[t]) {
      case DT_BF16:
        sgd_chunk(static_cast<const __nv_bfloat16*>(gl.g[t]) + off, p, m, c, n, s, md);
        break;
      case DT_F16:
        sgd_chunk(static_cast<const __half*>(gl.g[t]) + off, p, m, c, n, s, md);
        break;
      default:
        sgd_chunk(static_cast<const float*>(gl.g[t]) + off, p, m, c, n, s, md);
        break;
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

// f(Tag<C>{}) for the model copy's dtype code, -1 for none
template <typename F> cudaError_t with_copy_dtype(int code, F&& f) {
  switch (code) {
    case -1: return f(Tag<NoCopy>{});
    case DT_BF16: return f(Tag<__nv_bfloat16>{});
    case DT_F16: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The most tensors one apex_sgd call takes.
extern "C" int apex_sgd_max_tensors() { return MAXT; }

// The chunk size in elements that the table's chunk map uses.
extern "C" int apex_sgd_chunk() { return CHUNK; }

// grads: host array of nt device addresses of the gradients; gdtypes: host
// array of their nt dtype codes (0 float32, 1 bfloat16, 2 float16); table:
// the device table above (nc chunks) for p of pdtype, fp32 m and a model
// copy of cdtype (1 or 2; -1 at depth 3, its addresses then unused); scal: 5
// fp32 device values (lr, wd, scale, momentum, 1 - dampening); flag: device
// int32, or null; nothing changes when it is non-zero.  use_wd: 0 leaves
// weight decay out, else it enters after momentum when wd_after is 1 and
// before it otherwise; has_mom: 0 for momentum 0 (m untouched); first_run:
// m = gf; nesterov: u = gf + momentum * m.  Returns the cudaError_t of the
// launch.
extern "C" int apex_sgd(const void* const* grads, const unsigned char* gdtypes,
                        const void* table, int nt, int nc, const void* scal, const void* flag,
                        int pdtype, int cdtype, int use_wd, int wd_after, int has_mom,
                        int first_run, int nesterov, void* stream) {
  if (nt <= 0 || nt > MAXT || nc <= 0 || grads == nullptr || gdtypes == nullptr ||
      table == nullptr || scal == nullptr)
    return cudaErrorInvalidValue;
  GradList gl;
  for (int i = 0; i < nt; ++i) {
    if (gdtypes[i] > DT_F16) return cudaErrorInvalidValue;
    gl.g[i] = grads[i];
    gl.dt[i] = gdtypes[i];
  }
  for (int i = nt; i < MAXT; ++i) {
    gl.g[i] = nullptr;
    gl.dt[i] = 0;
  }
  const Mode md{use_wd != 0 && wd_after == 0, use_wd != 0 && wd_after != 0, has_mom != 0,
                first_run != 0, nesterov != 0};
  const long long* tb = static_cast<const long long*>(table);
  const float* sc = static_cast<const float*>(scal);
  const int* fl = static_cast<const int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(pdtype, [&](auto tp) {
    return with_copy_dtype(cdtype, [&](auto tc) {
      sgd_kernel<typename decltype(tp)::type, typename decltype(tc)::type>
          <<<nc, NT, 0, st>>>(gl, tb, nt, nc, sc, fl, md);
      return cudaGetLastError();
    });
  });
}
