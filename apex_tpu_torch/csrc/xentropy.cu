// Label-smoothed softmax cross-entropy, forward and backward, for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/kernels/xentropy.py::xent_forward (Pallas kernel
// _fwd_kernel): per row of logits x (C columns) and label y,
//   lse  = log(sum_j exp(x_j))
//   loss = lse - (1 - s) * x[y] - s * (sum of live x_j) / max(n_live, 1)
// with live columns those above MASKED_LOGIT_THR (-1e29, the -1e30
// masked-vocabulary convention), loss 0 on rows whose label is padding_idx,
// and x[y] taken as 0 for a label outside 0..C-1 (the kernel arm's
// semantics); losses and lse are fp32.  The live count is written as a
// third output for the backward.  And
// apex_tpu/kernels/xentropy.py::xent_backward (Pallas kernel _bwd_kernel):
//   dx_j = gm * (exp(x_j - lse) - smooth_j) - ((1 - s) * gm) * [j == y]
// with smooth_j = s / n_live on live columns and 0 elsewhere, gm the row's
// incoming gradient (0 on padding rows, zeroed by the caller), written in
// x's dtype.  Every operation of the backward is an IEEE round-to-nearest
// intrinsic in that order, so it rounds as the plain PyTorch version does,
// and the two differ only where their exp differ.
//
// Bound on the H100: bytes.  The forward reads each logit once (2 bytes in
// bf16) for ~4 operations, the backward reads and writes it once for ~6: at
// the GPT-2 bench shape (16368 x 50257 bf16, 1.65 GB) that is ~0.49 ms and
// ~0.98 ms at 3.35 TB/s.
//
// Design: one 256-thread block a row.  The TPU kernel sweeps column blocks
// on a sequential grid with running max/sum scratch; here the whole row
// belongs to one block, each thread keeps a running (max, sum-exp) pair
// over its columns (rescaled once per 16-byte vector, not per element), and
// the block combines the pairs by warp shuffles and shared memory.  With an
// odd C a bf16 row starts at any 2-byte offset, so each row is cut into a
// scalar head up to the first 16-byte boundary, a body of 16-byte vector
// loads and a scalar tail.  The target logit is one load by thread 0 (the
// row was just read, so it comes from L2).  The smoothing sum and live
// count are compiled in only when s > 0.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;               // threads per block, one row a block
constexpr int NW = NT / 32;
constexpr float MASK_THR = -1e29f;    // kernels/dispatch.py MASKED_LOGIT_THR

// a running (max, sum of exp(x - max)) pair; an empty pair has s == 0
struct MaxSum {
  float m, s;
};

__device__ __forceinline__ MaxSum combine(MaxSum a, MaxSum b) {
  if (a.s == 0.f) return b;
  if (b.s == 0.f) return a;
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * __expf(a.m - m) + b.s * __expf(b.m - m)};
}

// the 16-byte vector of each dtype and its conversion to fp32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float o[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
  __device__ static void store(float* p, const float o[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float o[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float o[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float o[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__half* p, const float o[8]) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(o[2 * i], o[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// elements before the first 16-byte boundary of p (at most n)
template <typename T>
__device__ __forceinline__ int head_of(const T* p, int n) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(p) & 15);
  return min(n, mis == 0 ? 0 : (16 - mis) / (int)sizeof(T));
}

// one thread's running state over its columns
template <bool SMOOTH>
struct RowAcc {
  MaxSum ms{-INFINITY, 0.f};
  float live_sum = 0.f, live_n = 0.f;

  __device__ __forceinline__ void add(const float* v, int k) {
    float m = v[0];
#pragma unroll
    for (int i = 1; i < k; ++i) m = fmaxf(m, v[i]);
    // a vector of -inf (a masked fp16 column rounds -1e30 to -inf) adds
    // nothing; -inf - -inf would be nan
    if (m != -INFINITY) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < k; ++i) s += __expf(v[i] - m);
      ms = combine(ms, MaxSum{m, s});
    }
    if (SMOOTH) {
#pragma unroll
      for (int i = 0; i < k; ++i)
        if (v[i] > MASK_THR) {
          live_sum += v[i];
          live_n += 1.f;
        }
    }
  }
};

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(NT)
xent_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out,
                float* __restrict__ live_out, int rows, int c, float smoothing,
                float one_minus_s, long long padding_idx) {
  constexpr int V = Vec<T>::N;
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (long long)row * c;
  RowAcc<SMOOTH> acc;
  const int head = head_of(xr, c);
  const int nvec = (c - head) / V;
  const int tail = head + nvec * V;
  if (tid < head) {
    const float v = to_f(xr[tid]);
    acc.add(&v, 1);
  }
  const T* body = xr + head;
#pragma unroll 2
  for (int i = tid; i < nvec; i += NT) {
    float v[V];
    Vec<T>::load(body + (long long)i * V, v);
    acc.add(v, V);
  }
  for (int i = tail + tid; i < c; i += NT) {
    const float v = to_f(xr[i]);
    acc.add(&v, 1);
  }

  // block combine: warps by shuffles, then the warps' results in shared memory
  MaxSum ms = acc.ms;
  float ls = acc.live_sum, ln = acc.live_n;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const MaxSum other{__shfl_xor_sync(0xffffffffu, ms.m, o),
                       __shfl_xor_sync(0xffffffffu, ms.s, o)};
    ms = combine(ms, other);
    if (SMOOTH) {
      ls += __shfl_xor_sync(0xffffffffu, ls, o);
      ln += __shfl_xor_sync(0xffffffffu, ln, o);
    }
  }
  __shared__ float red[4][NW];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[0][warp] = ms.m;
    red[1][warp] = ms.s;
    red[2][warp] = ls;
    red[3][warp] = ln;
  }
  __syncthreads();
  if (tid != 0) return;
  ms = MaxSum{red[0][0], red[1][0]};
  ls = red[2][0];
  ln = red[3][0];
  for (int w = 1; w < NW; ++w) {
    ms = combine(ms, MaxSum{red[0][w], red[1][w]});
    ls += red[2][w];
    ln += red[3][w];
  }
  const float lse = ms.m + logf(ms.s);
  const long long y = labels[row];
  const float t = (y >= 0 && y < c) ? to_f(xr[y]) : 0.f;
  float l = lse - one_minus_s * t;
  if (SMOOTH) l -= smoothing * ls / fmaxf(ln, 1.f);
  loss[row] = (y == padding_idx) ? 0.f : l;
  lse_out[row] = lse;
  live_out[row] = SMOOTH ? ln : (float)c;
}

template <typename T, bool SMOOTH>
__device__ __forceinline__ float dx_elem(float x, int j, long long y, float lse, float gm,
                                         float smooth, float c1gm) {
  const float p = expf(__fsub_rn(x, lse));
  const float sm = (SMOOTH && x > MASK_THR) ? smooth : 0.f;
  const float d = __fmul_rn(gm, __fsub_rn(p, sm));
  return j == y ? __fsub_rn(d, c1gm) : d;
}

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(NT)
xent_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                const float* __restrict__ lse_in, const float* __restrict__ gmask,
                const float* __restrict__ live, T* __restrict__ dx, int rows, int c,
                float smoothing, float one_minus_s) {
  constexpr int V = Vec<T>::N;
  const int row = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)row * c;
  const T* xr = x + base;
  T* dr = dx + base;
  const long long y = labels[row];
  const float lse = lse_in[row], gm = gmask[row];
  const float smooth = SMOOTH ? __fdiv_rn(smoothing, live[row]) : 0.f;
  const float c1gm = __fmul_rn(one_minus_s, gm);
  const bool same = ((reinterpret_cast<uintptr_t>(xr) ^ reinterpret_cast<uintptr_t>(dr)) & 15) == 0;
  const int head = same ? head_of(xr, c) : c;
  const int nvec = (c - head) / V;
  const int tail = head + nvec * V;
  for (int j = tid; j < head; j += NT)
    dr[j] = from_f<T>(dx_elem<T, SMOOTH>(to_f(xr[j]), j, y, lse, gm, smooth, c1gm));
#pragma unroll 2
  for (int i = tid; i < nvec; i += NT) {
    float v[V];
    const int j0 = head + i * V;
    Vec<T>::load(xr + j0, v);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = dx_elem<T, SMOOTH>(v[k], j0 + k, y, lse, gm, smooth, c1gm);
    Vec<T>::store(dr + j0, v);
  }
  for (int j = tail + tid; j < c; j += NT)
    dr[j] = from_f<T>(dx_elem<T, SMOOTH>(to_f(xr[j]), j, y, lse, gm, smooth, c1gm));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* labels, void* loss, void* lse, void* live,
                       int rows, int c, float s, float oms, long long pad, bool smooth,
                       cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const long long* lp = static_cast<const long long*>(labels);
  float *l = static_cast<float*>(loss), *e = static_cast<float*>(lse),
        *n = static_cast<float*>(live);
  if (smooth)
    xent_fwd_kernel<T, true><<<rows, NT, 0, st>>>(xp, lp, l, e, n, rows, c, s, oms, pad);
  else
    xent_fwd_kernel<T, false><<<rows, NT, 0, st>>>(xp, lp, l, e, n, rows, c, s, oms, pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* labels, const void* lse, const void* gm,
                       const void* live, void* dx, int rows, int c, float s, float oms,
                       bool smooth, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const long long* lp = static_cast<const long long*>(labels);
  const float *e = static_cast<const float*>(lse), *g = static_cast<const float*>(gm),
              *n = static_cast<const float*>(live);
  T* d = static_cast<T*>(dx);
  if (smooth)
    xent_bwd_kernel<T, true><<<rows, NT, 0, st>>>(xp, lp, e, g, n, d, rows, c, s, oms);
  else
    xent_bwd_kernel<T, false><<<rows, NT, 0, st>>>(xp, lp, e, g, n, d, rows, c, s, oms);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, c) contiguous logits of dtype (0 float32, 1 bfloat16, 2
// float16); labels: rows int64; loss, lse, live: rows fp32 outputs (live is
// the live-column count, c when smoothing is 0).  one_minus_s is 1 - s
// rounded to fp32 from double on the host.  Returns the cudaError_t of the
// launch.
extern "C" int apex_xent_fwd(const void* x, const void* labels, void* loss, void* lse,
                             void* live, int rows, int c, float smoothing, float one_minus_s,
                             long long padding_idx, int dtype, void* stream) {
  if (rows <= 0 || c <= 0 || x == nullptr || labels == nullptr || loss == nullptr ||
      lse == nullptr || live == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sm = smoothing != 0.f;
  switch (dtype) {
    case DT_F32:
      return launch_fwd<float>(x, labels, loss, lse, live, rows, c, smoothing, one_minus_s,
                               padding_idx, sm, st);
    case DT_BF16:
      return launch_fwd<__nv_bfloat16>(x, labels, loss, lse, live, rows, c, smoothing,
                                       one_minus_s, padding_idx, sm, st);
    case DT_F16:
      return launch_fwd<__half>(x, labels, loss, lse, live, rows, c, smoothing, one_minus_s,
                                padding_idx, sm, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, dx: (rows, c) contiguous, of dtype; labels: rows int64; lse, gmask,
// live: rows fp32 (gmask zero on padding rows; live read only when
// smoothing is not 0).  Returns the cudaError_t of the launch.
extern "C" int apex_xent_bwd(const void* x, const void* labels, const void* lse,
                             const void* gmask, const void* live, void* dx, int rows, int c,
                             float smoothing, float one_minus_s, int dtype, void* stream) {
  const bool sm = smoothing != 0.f;
  if (rows <= 0 || c <= 0 || x == nullptr || labels == nullptr || lse == nullptr ||
      gmask == nullptr || dx == nullptr || (sm && live == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_bwd<float>(x, labels, lse, gmask, live, dx, rows, c, smoothing, one_minus_s,
                               sm, st);
    case DT_BF16:
      return launch_bwd<__nv_bfloat16>(x, labels, lse, gmask, live, dx, rows, c, smoothing,
                                       one_minus_s, sm, st);
    case DT_F16:
      return launch_bwd<__half>(x, labels, lse, gmask, live, dx, rows, c, smoothing,
                                one_minus_s, sm, st);
    default: return cudaErrorInvalidValue;
  }
}
