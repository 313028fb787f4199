// LayerNorm forward and backward for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: apex_tpu/kernels/layer_norm.py::ln_forward (Pallas kernel
// _fwd_kernel): y = (x - mean) * rstd [* w + b] over the last dim, with the
// two-pass fp32 statistics of the JAX kernel (mean first, then the mean of
// the squared deviations; not Welford, not E[x^2] - E[x]^2) and
// rstd = 1 / sqrt(var + eps).  y is in x's dtype; mean and rstd are fp32,
// one per row.  And apex_tpu/kernels/layer_norm.py::ln_backward (Pallas
// kernel _bwd_kernel): from the saved mean and rstd, xhat = (x - mean) *
// rstd, gh = g * w, c1 = mean(gh), c2 = mean(gh * xhat) and
// dx = (gh - c1 - xhat * c2) * rstd in x's dtype; dgamma = sum(g * xhat)
// and dbeta = sum(g) over all rows, in fp32.
//
// Bound on the H100: bytes.  At the GPT-2-small shapes (4096 x 768 in
// prefill, 8 x 768 per decode step, 16384 x 768 in training) both kernels
// do ~10 operations per element they read and write once, far below the
// card's ~20 fp32 operations per byte, so the least time is the bytes of x
// and y (forward) or g, x and dx (backward) over 3.35 TB/s; the 8-row
// decode shape is bound by launch latency.
//
// Design: the row stays in registers, so x (and g) are read from memory
// once and both passes run out of registers.  A row of n <= 1024 belongs to
// one warp (four rows per 128-thread block); a longer row to a 256- or
// 1024-thread block, whose warps combine their partial sums through shared
// memory.  Each thread holds VPT elements at a stride of the row's thread
// count, so neighbouring threads read neighbouring addresses.  Up to
// n = 16384.  The TPU kernel sums dgamma/dbeta across its sequential grid
// in one output block; CUDA blocks run in no order, so the backward runs a
// fixed grid of a few blocks per SM, each walking rows at a grid stride and
// keeping its threads' column sums in registers, and writes one fp32 row of
// partial sums per block into a workspace; a second kernel sums the
// workspace by column in a fixed order.  Deterministic, no float atomics.

#include "norm_common.cuh"

namespace {

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
#define APEX_LN_FWD(VPT, TPR) launch<T, VPT, TPR>(x, w, b, y, mean, rstd, rows, n, eps, st)
  APEX_NORM_BY_ROW(n, APEX_LN_FWD);
#undef APEX_LN_FWD
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC)
ln_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const void* __restrict__ w, int wdtype, T* __restrict__ dx,
              float* __restrict__ part_w, float* __restrict__ part_b, int rows, int n) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR;
  __shared__ float red[RPC][WPR];
  const int tid = threadIdx.x;

  float wv[VPT], aw[VPT], ab[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    wv[i] = (w != nullptr && c < n) ? load_as_f(w, c, wdtype) : 1.f;
    aw[i] = 0.f;
    ab[i] = 0.f;
  }

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  for (long long row = (long long)blockIdx.x * RPC + threadIdx.y; row < rows; row += stride) {
    const T* gr = g + row * n;
    const T* xr = x + row * n;
    const float mu = mean[row], rs = rstd[row];
    float gv[VPT], xh[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      gv[i] = 0.f;
      xh[i] = 0.f;
      if (c < n) {
        gv[i] = to_f(gr[c]);
        xh[i] = (to_f(xr[c]) - mu) * rs;
      }
      const float gh = gv[i] * wv[i];
      s1 += gh;
      s2 += gh * xh[i];
    }
    const float c1 = row_sum<WPR>(s1, red[threadIdx.y]) / n;
    const float c2 = row_sum<WPR>(s2, red[threadIdx.y]) / n;
    T* dxr = dx + row * n;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      if (c < n) dxr[c] = from_f<T>((gv[i] * wv[i] - c1 - xh[i] * c2) * rs);
      aw[i] += gv[i] * xh[i];
      ab[i] += gv[i];
    }
  }
  if (part_w == nullptr) return;  // the plain (non-affine) form

  float* pw = part_w + (long long)blockIdx.x * n;
  float* pb = part_b + (long long)blockIdx.x * n;
  if constexpr (RPC == 1) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      if (c < n) {
        pw[c] = aw[i];
        pb[c] = ab[i];
      }
    }
  } else {
    // the RPC warps of the block (one row stream each) add their column
    // sums in a fixed order
    __shared__ float cw[RPC][VPT * TPR], cb[RPC][VPT * TPR];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      cw[threadIdx.y][tid + i * TPR] = aw[i];
      cb[threadIdx.y][tid + i * TPR] = ab[i];
    }
    __syncthreads();
    for (int c = threadIdx.y * TPR + tid; c < n; c += RPC * TPR) {
      float sw = 0.f, sb = 0.f;
#pragma unroll
      for (int r = 0; r < RPC; ++r) {
        sw += cw[r][c];
        sb += cb[r][c];
      }
      pw[c] = sw;
      pb[c] = sb;
    }
  }
}

// dw[c] = sum over p of part_w[p, c] (blockIdx.y == 0), db likewise
// (blockIdx.y == 1): 32 columns a block, 32 threads down each column, then
// a fixed-order sum of the 32 through shared memory
__global__ void __launch_bounds__(1024)
ln_bwd_cols_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                   float* __restrict__ dw, float* __restrict__ db, int parts, int n) {
  __shared__ float red[32][33];
  const float* src = blockIdx.y == 0 ? part_w : part_b;
  float* dst = blockIdx.y == 0 ? dw : db;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += 32) s += src[(long long)p * n + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) t += red[i][threadIdx.x];
    dst[c] = t;
  }
}

template <typename T, int VPT, int TPR>
cudaError_t launch_bwd(const void* g, const void* x, const float* mean, const float* rstd,
                       const void* w, int wdtype, void* dx, float* pw, float* pb, int parts,
                       int rows, int n, cudaStream_t st) {
  const dim3 block(TPR, Shape<TPR>::RPC);
  ln_bwd_kernel<T, VPT, TPR><<<parts, block, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, rstd, w, wdtype,
      static_cast<T*>(dx), pw, pb, rows, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* g, const void* x, const float* mean, const float* rstd,
                         const void* w, int wdtype, void* dx, float* pw, float* pb, int parts,
                         int rows, int n, cudaStream_t st) {
#define APEX_LN_BWD(VPT, TPR) \
  launch_bwd<T, VPT, TPR>(g, x, mean, rstd, w, wdtype, dx, pw, pb, parts, rows, n, st)
  APEX_NORM_BY_ROW(n, APEX_LN_BWD);
#undef APEX_LN_BWD
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

// The number of blocks (and rows of partial sums) apex_ln_bwd runs for a
// (rows, n) input on the current device (norm_bwd_parts).  The caller
// allocates the (parts, n) fp32 workspaces from it.
extern "C" int apex_ln_bwd_parts(int rows, int n) { return norm_bwd_parts(rows, n); }

// g, x, dx (rows, n) contiguous in dtype; mean, rstd (rows,) float32; w (n,)
// in wdtype, or null for the plain form, whose part_w and part_b are null
// too; part_w, part_b (parts, n) float32 with parts from apex_ln_bwd_parts.
// Returns the cudaError_t of the launch.
extern "C" int apex_ln_bwd(const void* g, const void* x, const void* mean, const void* rstd,
                           const void* w, int wdtype, void* dx, void* part_w, void* part_b,
                           int parts, int rows, int n, int dtype, void* stream) {
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || parts <= 0 || (w == nullptr) != (pw == nullptr) ||
      (pw == nullptr) != (pb == nullptr) || wdtype < 0 || wdtype > 2)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch_bwd<float>(g, x, mf, rf, w, wdtype, dx, pw, pb, parts, rows, n, st);
    case DT_BF16: return dispatch_bwd<__nv_bfloat16>(g, x, mf, rf, w, wdtype, dx, pw, pb, parts, rows, n, st);
    case DT_F16: return dispatch_bwd<__half>(g, x, mf, rf, w, wdtype, dx, pw, pb, parts, rows, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// dw, db (n,) float32 = the column sums of part_w, part_b (parts, n).
// Returns the cudaError_t of the launch.
extern "C" int apex_ln_bwd_cols(const void* part_w, const void* part_b, void* dw, void* db,
                                int parts, int n, void* stream) {
  if (parts <= 0 || n <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + 31) / 32, 2), block(32, 32);
  ln_bwd_cols_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db), parts, n);
  return cudaGetLastError();
}
