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
// Bound on the H100: bytes.  Each element reads g (2 or 4 bytes), p, m and
// v and writes p, m and v: 26-28 bytes for ~15 operations.  At GPT-2 small
// (124.4 M parameters in 124 tensors) that is 3.2-3.5 GB, ~1 ms at
// 3.35 TB/s.
//
// Design: the reference CUDA design (multi_tensor_apply.cuh), not the
// Pallas copy of every tensor into one packed panel, which would move the
// bytes twice more.  Each tensor is cut into chunks of 65536 elements and
// one 256-thread block takes a chunk.  A device table holds each tensor's
// p, m and v addresses, its size and the chunk -> (tensor, offset) map; the
// caller builds it once per list and keeps it, since the in-place updates
// keep those addresses.  The gradients are new tensors every step, so
// their addresses travel in the launch's parameters instead (up to 256
// tensors a launch).  Loads and stores are 16-byte vectors where every
// address of the chunk allows it, scalar otherwise.  p, m and v are fp32;
// g is fp32, bf16 or fp16.

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

// four consecutive gradients as fp32, from an address aligned to ALIGN
template <typename G> struct Grad4;
template <> struct Grad4<float> {
  static constexpr uintptr_t ALIGN = 16;
  __device__ static void load(const float* g, float o[4]) {
    const float4 t = *reinterpret_cast<const float4*>(g);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
};
template <> struct Grad4<__nv_bfloat16> {
  static constexpr uintptr_t ALIGN = 8;
  __device__ static void load(const __nv_bfloat16* g, float o[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(g);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};
template <> struct Grad4<__half> {
  static constexpr uintptr_t ALIGN = 8;
  __device__ static void load(const __half* g, float o[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(g);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

// table (int64): p, m, v addresses [3 * nt], sizes [nt], then per chunk
// (tensor index, element offset) [2 * nc]
template <typename G>
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
    float* p = reinterpret_cast<float*>(table[t]) + off;
    float* m = reinterpret_cast<float*>(table[nt + t]) + off;
    float* v = reinterpret_cast<float*>(table[2 * nt + t]) + off;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
          reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
        reinterpret_cast<uintptr_t>(g) % Grad4<G>::ALIGN == 0;
    int tail = 0;
    if (vec) {
      const int n4 = n / 4;
      for (int i = threadIdx.x; i < n4; i += NT) {
        float gv[4];
        Grad4<G>::load(g + 4 * i, gv);
        float4 pv = reinterpret_cast<float4*>(p)[i];
        float4 mv = reinterpret_cast<float4*>(m)[i];
        float4 vv = reinterpret_cast<float4*>(v)[i];
        adam_elem(gv[0], pv.x, mv.x, vv.x, s, l2, dec);
        adam_elem(gv[1], pv.y, mv.y, vv.y, s, l2, dec);
        adam_elem(gv[2], pv.z, mv.z, vv.z, s, l2, dec);
        adam_elem(gv[3], pv.w, mv.w, vv.w, s, l2, dec);
        reinterpret_cast<float4*>(p)[i] = pv;
        reinterpret_cast<float4*>(m)[i] = mv;
        reinterpret_cast<float4*>(v)[i] = vv;
      }
      tail = n4 * 4;
    }
    for (int i = tail + threadIdx.x; i < n; i += NT) {
      float pv = p[i], mv = m[i], vv = v[i];
      adam_elem(to_f(g[i]), pv, mv, vv, s, l2, dec);
      p[i] = pv;
      m[i] = mv;
      v[i] = vv;
    }
  }
}

template <typename G>
cudaError_t launch(const GradList& gl, const long long* table, int nt, int nc, const float* scal,
                   const int* flag, int use_wd, int decoupled, cudaStream_t st) {
  adam_kernel<G><<<nc, NT, 0, st>>>(gl, table, nt, nc, scal, flag, use_wd, decoupled);
  return cudaGetLastError();
}

}  // namespace

// The most tensors one apex_adam call takes.
extern "C" int apex_adam_max_tensors() { return MAXT; }

// The chunk size in elements that the table's chunk map uses.
extern "C" int apex_adam_chunk() { return CHUNK; }

// grads: host array of nt device addresses of the gradients, all of gdtype
// (0 float32, 1 bfloat16, 2 float16); table: the device table above for
// fp32 p, m and v (nc chunks); scal: 9 fp32 device values (lr, wd, b1,
// 1 - b1, b2, 1 - b2, eps, bc1, bc2); flag: device int32, or null; nothing
// changes when it is non-zero.  decoupled: 1 for AdamW, 0 for L2;
// use_wd: 0 leaves weight decay out.  Returns the cudaError_t of the launch.
extern "C" int apex_adam(const void* const* grads, const void* table, int nt, int nc,
                         const void* scal, const void* flag, int gdtype, int use_wd,
                         int decoupled, void* stream) {
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
  switch (gdtype) {
    case DT_F32: return launch<float>(gl, tb, nt, nc, sc, fl, use_wd, decoupled, st);
    case DT_BF16: return launch<__nv_bfloat16>(gl, tb, nt, nc, sc, fl, use_wd, decoupled, st);
    case DT_F16: return launch<__half>(gl, tb, nt, nc, sc, fl, use_wd, decoupled, st);
    default: return cudaErrorInvalidValue;
  }
}
