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
// panel, with the geometry of multi_tensor_common.cuh: chunks of a size the
// wrapper picks per list and card (2048 elements at ResNet-18's and
// ResNet-50's fp32 lists), one 256-thread block a chunk.  A device table holds
// each tensor's p, m and model-copy addresses, its size and the chunk ->
// (tensor, offset) map; the caller builds it once per list and chunk and
// keeps it, since the in-place updates keep those addresses.  The
// gradients are new tensors every step, so their addresses travel in the
// launch's parameters, each with its own dtype code: one launch takes a
// list whose gradients mix dtypes (under keep_batchnorm_fp32 ResNet's conv
// and fc gradients are bf16 and its BatchNorm gradients fp32) without a
// widening pass.  A chunk lies in one tensor, so the switch on the
// gradient's dtype is uniform over a block.  The kernel is a template on
// the params' dtype (fp32, bf16, fp16) and the model copy's (none, bf16,
// fp16): 9 instances, each with three gradient paths.  Where every address
// of a chunk allows it, a thread loads four consecutive elements of each
// array with one vector access (g through the read-only path), all in
// flight before it computes and stores them; the rest, and misaligned
// chunks, go one element at a time.  The update is elementwise, so no
// chunking changes a bit of it.

#include <type_traits>

#include "multi_tensor_common.cuh"

namespace {

enum { LR, WD, SCALE, MOM, OMD };

struct GradList {
  const void* g[MT_MAX_TENSORS];
  unsigned char dt[MT_MAX_TENSORS];   // dtype code of each gradient
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

// the model copy's type, or NoCopy at depth 3
struct NoCopy {};

// one chunk of n elements: g of type G, p of type P, m fp32 (untouched
// without momentum), c the model copy of type C
template <typename G, typename P, typename C>
__device__ __forceinline__ void sgd_chunk(const G* __restrict__ g, P* __restrict__ p,
                                          float* __restrict__ m, C* __restrict__ c, int n,
                                          const Scalars& s, const Mode& md) {
  constexpr bool COPY = !std::is_same<C, NoCopy>::value;
  const bool read_m = md.has_mom && !md.first_run;
  bool aligned = vec_aligned(g) && vec_aligned(p) && (!md.has_mom || vec_aligned(m));
  if constexpr (COPY) aligned = aligned && vec_aligned(c);
  int tail = 0;
  if (aligned) {
    const int n4 = n / 4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += MT_UNROLL * MT_THREADS) {
      float gv[MT_UNROLL][4], pv[MT_UNROLL][4], mv[MT_UNROLL][4];
#pragma unroll
      for (int u = 0; u < MT_UNROLL; ++u) {
        const int i = i0 + u * MT_THREADS;
        if (i < n4) {
          Vec4<G>::load_ro(g + 4 * i, gv[u]);
          Vec4<P>::load(p + 4 * i, pv[u]);
          if (read_m) {
            Vec4<float>::load(m + 4 * i, mv[u]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) mv[u][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MT_UNROLL; ++u) {
        const int i = i0 + u * MT_THREADS;
        if (i < n4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sgd_elem(gv[u][e], pv[u][e], mv[u][e], s, md);
          Vec4<P>::store(p + 4 * i, pv[u]);
          if (md.has_mom) Vec4<float>::store(m + 4 * i, mv[u]);
          if constexpr (COPY) Vec4<C>::store(c + 4 * i, pv[u]);
        }
      }
    }
    tail = n4 * 4;
  }
  for (int i = tail + threadIdx.x; i < n; i += MT_THREADS) {
    float pv = to_f(p[i]), mv = read_m ? m[i] : 0.f;
    sgd_elem(to_f(g[i]), pv, mv, s, md);
    p[i] = from_f<P>(pv);
    if (md.has_mom) m[i] = mv;
    if constexpr (COPY) c[i] = from_f<C>(pv);
  }
}

// table (int64): p, m, model-copy addresses [3 * nt], sizes [nt], then per
// chunk (tensor index, element offset) [2 * nc]
template <typename P, typename C>
__global__ void __launch_bounds__(MT_THREADS)
sgd_kernel(GradList gl, const long long* __restrict__ table, int nt, int nc, int chunk,
           const float* __restrict__ scal, const int* __restrict__ flag, Mode md) {
  if (flag != nullptr && *flag != 0) return;  // a skipped step: nothing changes
  const Scalars s{scal[LR], scal[WD], scal[SCALE], scal[MOM], scal[OMD]};
  for_each_chunk(table, nt, nc, chunk, [&](int t, long long off, int n) {
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
  });
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
extern "C" int apex_sgd_max_tensors() { return MT_MAX_TENSORS; }

// The largest chunk, in elements, that one apex_sgd call takes.
extern "C" int apex_sgd_chunk() { return MT_MAX_CHUNK; }

// grads: host array of nt device addresses of the gradients; gdtypes: host
// array of their nt dtype codes (0 float32, 1 bfloat16, 2 float16); table:
// the device table above (nc chunks of `chunk` elements, 1 <= chunk <=
// apex_sgd_chunk()) for p of pdtype, fp32 m and a model copy of cdtype (1
// or 2; -1 at depth 3, its addresses then unused); scal: 5 fp32 device
// values (lr, wd, scale, momentum, 1 - dampening); flag: device int32, or
// null; nothing changes when it is non-zero.  use_wd: 0 leaves weight
// decay out, else it enters after momentum when wd_after is 1 and before it
// otherwise; has_mom: 0 for momentum 0 (m untouched); first_run: m = gf;
// nesterov: u = gf + momentum * m.  Returns the cudaError_t of the launch.
extern "C" int apex_sgd(const void* const* grads, const unsigned char* gdtypes,
                        const void* table, int nt, int nc, int chunk, const void* scal,
                        const void* flag, int pdtype, int cdtype, int use_wd, int wd_after,
                        int has_mom, int first_run, int nesterov, void* stream) {
  if (nt <= 0 || nt > MT_MAX_TENSORS || nc <= 0 || chunk <= 0 || chunk > MT_MAX_CHUNK ||
      grads == nullptr || gdtypes == nullptr || table == nullptr || scal == nullptr)
    return cudaErrorInvalidValue;
  GradList gl;
  for (int i = 0; i < nt; ++i) {
    if (gdtypes[i] > DT_F16) return cudaErrorInvalidValue;
    gl.g[i] = grads[i];
    gl.dt[i] = gdtypes[i];
  }
  for (int i = nt; i < MT_MAX_TENSORS; ++i) {
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
      const auto kernel = sgd_kernel<typename decltype(tp)::type, typename decltype(tc)::type>;
      kernel<<<nc, MT_THREADS, 0, st>>>(gl, tb, nt, nc, chunk, sc, fl, md);
      return cudaGetLastError();
    });
  });
}
