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
// bytes twice more, with its geometry redrawn for the H100
// (multi_tensor_common.cuh).  Each tensor is cut into chunks of a size the
// wrapper picks per list and card, at most 64 KB of reads and writes (2048
// elements in fp32, 4096 in fp16) and less for a short list (DCGAN's
// discriminator, 0.66 M values in 12 tensors, takes 1024: 655 chunks for
// the 132 SMs, where the reference's 65536 gave 20), and one 256-thread
// block takes a chunk: the SMs take new blocks as theirs finish, so the
// last wave is short.  A
// device table holds each tensor's p, m and v addresses, its size and the
// chunk -> (tensor, offset) map; the caller builds it once per list and
// chunk and keeps it, since the in-place updates keep those addresses.
// The gradients are new tensors every step, so their addresses travel in
// the launch's parameters instead (up to 256 tensors a launch).  g is
// fp32, bf16 or fp16; so are p, m and v, each list of one dtype.  Every
// value is read as fp32, updated in fp32 and written back rounded to
// nearest in its own dtype, as the JAX function casts its fp32 results
// back (so O3's half parameters and moments run here too).  The kernel is
// a template on the four dtypes, one instance for each combination (81).
// Where every address of a chunk allows it, a thread loads four
// consecutive elements of each array with one vector access (16 bytes in
// fp32, 8 in a half dtype; g through the read-only path), all four loads
// in flight before it computes (the arrays are __restrict__), then stores;
// the rest of the chunk, and a chunk whose addresses are misaligned, go
// one element at a time.  (Two or four vectors of each array a thread
// measured no faster in fp32 and up to 14% slower with half p, m and v,
// whose arithmetic then needs more of the registers that set the blocks an
// SM holds: PERF.md.)  The update is elementwise, so no chunking changes a
// bit of it.

#include "multi_tensor_common.cuh"

namespace {

enum { LR, WD, B1, OMB1, B2, OMB2, EPS, BC1, BC2 };

struct GradList {
  const void* g[MT_MAX_TENSORS];
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

// one chunk of n elements
template <typename G, typename P, typename M, typename V>
__device__ __forceinline__ void adam_chunk(const G* __restrict__ g, P* __restrict__ p,
                                           M* __restrict__ m, V* __restrict__ v, int n,
                                           const Scalars& s, bool l2, bool dec) {
  int tail = 0;
  if (vec_aligned(g) && vec_aligned(p) && vec_aligned(m) && vec_aligned(v)) {
    const int n4 = n / 4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += MT_UNROLL * MT_THREADS) {
      float gv[MT_UNROLL][4], pv[MT_UNROLL][4], mv[MT_UNROLL][4], vv[MT_UNROLL][4];
#pragma unroll
      for (int u = 0; u < MT_UNROLL; ++u) {
        const int i = i0 + u * MT_THREADS;
        if (i < n4) {
          Vec4<G>::load_ro(g + 4 * i, gv[u]);
          Vec4<P>::load(p + 4 * i, pv[u]);
          Vec4<M>::load(m + 4 * i, mv[u]);
          Vec4<V>::load(v + 4 * i, vv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < MT_UNROLL; ++u) {
        const int i = i0 + u * MT_THREADS;
        if (i < n4) {
#pragma unroll
          for (int e = 0; e < 4; ++e) adam_elem(gv[u][e], pv[u][e], mv[u][e], vv[u][e], s, l2, dec);
          Vec4<P>::store(p + 4 * i, pv[u]);
          Vec4<M>::store(m + 4 * i, mv[u]);
          Vec4<V>::store(v + 4 * i, vv[u]);
        }
      }
    }
    tail = n4 * 4;
  }
  for (int i = tail + threadIdx.x; i < n; i += MT_THREADS) {
    float pv = to_f(p[i]), mv = to_f(m[i]), vv = to_f(v[i]);
    adam_elem(to_f(g[i]), pv, mv, vv, s, l2, dec);
    p[i] = from_f<P>(pv);
    m[i] = from_f<M>(mv);
    v[i] = from_f<V>(vv);
  }
}

// table (int64): p, m, v addresses [3 * nt], sizes [nt], then per chunk
// (tensor index, element offset) [2 * nc]
template <typename G, typename P, typename M, typename V>
__global__ void __launch_bounds__(MT_THREADS)
adam_kernel(GradList gl, const long long* __restrict__ table, int nt, int nc, int chunk,
            const float* __restrict__ scal, const int* __restrict__ flag, int use_wd,
            int decoupled) {
  if (flag != nullptr && *flag != 0) return;  // a skipped step: nothing changes
  const Scalars s{scal[LR], scal[WD], scal[B1], scal[OMB1], scal[B2],
                  scal[OMB2], scal[EPS], scal[BC1], scal[BC2]};
  const bool l2 = use_wd && !decoupled, dec = use_wd && decoupled;
  for_each_chunk(table, nt, nc, chunk, [&](int t, long long off, int n) {
    adam_chunk(static_cast<const G*>(gl.g[t]) + off, reinterpret_cast<P*>(table[t]) + off,
               reinterpret_cast<M*>(table[nt + t]) + off,
               reinterpret_cast<V*>(table[2 * nt + t]) + off, n, s, l2, dec);
  });
}

}  // namespace

// The most tensors one apex_adam call takes.
extern "C" int apex_adam_max_tensors() { return MT_MAX_TENSORS; }

// The largest chunk, in elements, that one apex_adam call takes.
extern "C" int apex_adam_chunk() { return MT_MAX_CHUNK; }

// grads: host array of nt device addresses of the gradients, all of gdtype
// (0 float32, 1 bfloat16, 2 float16); table: the device table above for p,
// m and v (nc chunks of `chunk` elements, 1 <= chunk <= apex_adam_chunk()),
// of pdtype, mdtype and vdtype; scal: 9 fp32 device values (lr, wd, b1,
// 1 - b1, b2, 1 - b2, eps, bc1, bc2); flag: device int32, or null; nothing
// changes when it is non-zero.  decoupled: 1 for AdamW, 0 for L2; use_wd: 0
// leaves weight decay out.  Returns the cudaError_t of the launch.
extern "C" int apex_adam(const void* const* grads, const void* table, int nt, int nc,
                         int chunk, const void* scal, const void* flag, int gdtype, int use_wd,
                         int decoupled, int pdtype, int mdtype, int vdtype, void* stream) {
  if (nt <= 0 || nt > MT_MAX_TENSORS || nc <= 0 || chunk <= 0 || chunk > MT_MAX_CHUNK ||
      grads == nullptr || table == nullptr || scal == nullptr)
    return cudaErrorInvalidValue;
  GradList gl;
  for (int i = 0; i < nt; ++i) gl.g[i] = grads[i];
  for (int i = nt; i < MT_MAX_TENSORS; ++i) gl.g[i] = nullptr;
  const long long* tb = static_cast<const long long*>(table);
  const float* sc = static_cast<const float*>(scal);
  const int* fl = static_cast<const int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(gdtype, [&](auto tg) {
    return with_dtype(pdtype, [&](auto tp) {
      return with_dtype(mdtype, [&](auto tm) {
        return with_dtype(vdtype, [&](auto tv) {
          const auto kernel =
              adam_kernel<typename decltype(tg)::type, typename decltype(tp)::type,
                          typename decltype(tm)::type, typename decltype(tv)::type>;
          kernel<<<nc, MT_THREADS, 0, st>>>(gl, tb, nt, nc, chunk, sc, fl, use_wd, decoupled);
          return cudaGetLastError();
        });
      });
    });
  });
}
