// RMSNorm forward and backward for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: apex_tpu/kernels/rms_norm.py::rms_forward (Pallas kernel
// _fwd_kernel): y = x * rstd [* w] over the last dim, with
// rstd = rsqrt(mean(x^2) + eps) in fp32 (the forward's mean a product with
// 1 / n and its rsqrt the instruction's, as in layer_norm.cu); y is in x's
// dtype, rstd fp32, one per row.  And apex_tpu/kernels/rms_norm.py::rms_backward (Pallas
// kernel _bwd_kernel): from the saved rstd, xhat = x * rstd, gh = g * w,
// c2 = mean(gh * xhat) and dx = (gh - xhat * c2) * rstd in x's dtype;
// dw = sum(g * xhat) over all rows, in fp32.
//
// Bound on the H100: bytes.  At the Llama shapes (16384 x 768 in training,
// 4096 x 768 in prefill, 8 x 768 per decode step) both kernels do under ten
// operations per element they read and write once, far below the card's
// ~20 fp32 operations per byte, so the least time is the bytes of x and y
// (forward) or g, x and dx (backward) over 3.35 TB/s; the 8-row decode
// shape is bound by launch latency.
// The forward at the training shape moves 50 MB, which the 50 MB L2
// cannot hold between calls; at 4096 x 768 fp32 its 25 MB can stay there,
// so a warm call may beat the HBM bound.  What bounds it in practice is
// bytes in flight: enough 16-byte loads issued ahead of their use.
//
// Design: layer_norm.cu's, without the mean, on the row layout of
// norm_common.cuh.  The row stays in registers, so x (and g) are read from
// memory once.  A row of n <= 1024 belongs to one warp (four rows per
// 128-thread block); a longer row to a 256- or 1024-thread block whose warps
// combine their partial sums through shared memory.  Up to n = 16384.  The
// forward has layer_norm.cu's two routes: vec (16-byte chunks of x and y,
// row streams walking rows at a grid stride with the next row in flight,
// the weight read once per block in its own dtype, staged in shared
// memory as fp32 planes or, where each stream takes one row, held in
// registers) for n a multiple of 16 bytes' worth of x's dtype and 16-byte
// aligned x, y and w; scalar (one element per access) for the rest.  The
// TPU kernel sums dw in place across its sequential grid; CUDA blocks run
// in no order, so the backward runs a fixed grid of blocks, each walking
// rows at a grid stride and keeping its threads' column sums in registers,
// and writes one fp32 row of partial sums per block into a workspace; a
// second kernel sums the workspace by column in a fixed order and rounds
// dw once to the dtype asked for.  Deterministic, no float atomics.  The
// backward has layer_norm.cu's two routes, on the same rules: vec (16-byte
// chunks of g, x and dx, row streams over the resident blocks with the
// next row in flight, w staged once a block, the column sums added over a
// block's streams through shared memory) and scalar.

#include "norm_common.cuh"

namespace {

// the scalar route's row: one element per access, w (of its own type W;
// null for the plain form) read after rstd, which is the vec kernel's
template <typename T, int VPT, int TPR, typename W>
__device__ __forceinline__ void rms_fwd_row(const T* __restrict__ xr, const W* __restrict__ w,
                                            T* __restrict__ yr, float* __restrict__ rstd_out,
                                            long long row, int n, float inv_n, float eps,
                                            float* red) {
  const int tid = threadIdx.x;
  float v[VPT];
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    v[i] = c < n ? to_f(xr[c]) : 0.f;
    q += v[i] * v[i];
  }
  const float rs = rsqrtf(row_sum<Shape<TPR>::WPR>(q, red) * inv_n + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    if (c < n) {
      float o = v[i] * rs;
      if (w != nullptr) o = o * to_f(w[c]);
      yr[c] = from_f<T>(o);
    }
  }
  if (tid == 0) rstd_out[row] = rs;
}

// the scalar route: any n and alignment; the weight's dtype switched on
// once, around the whole row
template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC)
rms_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w, int wdt,
               T* __restrict__ y, float* __restrict__ rstd_out, int rows, int n,
               float inv_n, float eps) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR;
  __shared__ float red[RPC][WPR];
  const long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  // a block of several warps holds one row (RPC == 1), so a block either
  // returns whole or not at all and the __syncthreads in row_sum are safe
  if (row >= rows) return;
  APEX_PARAM_SWITCH(wdt, W,
      rms_fwd_row<T, VPT, TPR>(x + row * n, static_cast<const W*>(w), y + row * n, rstd_out,
                               row, n, inv_n, eps, red[threadIdx.y]));
}

// the vec route: 16-byte chunks, chunk tid + i * TPR of a row to each
// thread; each row stream walks rows at a grid stride with the next row's
// chunks in flight while it reduces the current one; the chunks stay
// packed and are converted to fp32 in each pass.  w, as fp32, is held as
// PARAMS says (see launch).  rstd as layer_norm.cu's vec kernel: a
// product with inv_n = 1 / n and the rsqrt instruction
template <typename T, int CPT, int TPR, int PARAMS>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC, 1)
rms_fwd_vec_kernel(const T* __restrict__ x, const void* __restrict__ w, int wdt,
                   T* __restrict__ y, float* __restrict__ rstd_out, int rows, int n,
                   float inv_n, float eps) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR, L = chunk_len<T>();
  constexpr int RC = PARAMS == PARAMS_REGS ? CPT : 1, SLOTS = CPT * TPR;
  __shared__ float red[RPC][WPR];
  extern __shared__ float4 staged[];  // w's L / 4 planes
  const int tid = threadIdx.x;
  const int chunks = n / L;

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  uint4 cur[CPT];
  float wr[RC][L];
  if (row < rows) load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + row * n), chunks, cur);
  if constexpr (PARAMS == PARAMS_SHARED) {
    APEX_PARAM_SWITCH(wdt, P,
        stage_param<L, SLOTS, TPR * RPC>(static_cast<const P*>(w), chunks, staged));
    __syncthreads();
  } else if constexpr (PARAMS == PARAMS_REGS) {
    APEX_PARAM_SWITCH(wdt, P, load_param_row<L, CPT, TPR>(static_cast<const P*>(w), chunks, wr));
  }
  for (; row < rows; row += stride) {
    uint4 nxt[CPT];
    if (row + stride < rows)
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + (row + stride) * n), chunks, nxt);

    float q = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (tid + i * TPR < chunks) {
        float v[L];
        unpack_chunk<T>(cur[i], v);
#pragma unroll
        for (int j = 0; j < L; ++j) q += v[j] * v[j];
      }
    }
    const float rs = rsqrtf(row_sum<WPR>(q, red[threadIdx.y]) * inv_n + eps);

    uint4* yr = reinterpret_cast<uint4*>(y + row * n);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * TPR;
      if (c < chunks) {
        float o[L], wv[L];
        unpack_chunk<T>(cur[i], o);
        if constexpr (PARAMS == PARAMS_SHARED) {
          load_staged<L, SLOTS>(staged, c, wv);
        } else if constexpr (PARAMS == PARAMS_REGS) {
#pragma unroll
          for (int j = 0; j < L; ++j) wv[j] = wr[i][j];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) {
          o[j] = o[j] * rs;
          if constexpr (PARAMS != PARAMS_NONE) o[j] = o[j] * wv[j];
        }
        yr[c] = pack_chunk<T>(o);
      }
    }
    if (tid == 0) rstd_out[row] = rs;
#pragma unroll
    for (int i = 0; i < CPT; ++i) cur[i] = nxt[i];
  }
}

struct FwdArgs {
  const void* x;
  const void* w;
  int wdt;
  void* y;
  float* rstd;
  int rows, n;
  float eps;
  int route;
  cudaStream_t st;
};

template <typename T, int VPT, int TPR>
cudaError_t launch(const FwdArgs& a) {
  constexpr int RPC = Shape<TPR>::RPC;
  const dim3 block(TPR, RPC);
  if (a.route == NORM_SCALAR) {
    rms_fwd_kernel<T, VPT, TPR><<<(a.rows + RPC - 1) / RPC, block, 0, a.st>>>(
        static_cast<const T*>(a.x), a.w, a.wdt, static_cast<T*>(a.y), a.rstd, a.rows, a.n,
        1.f / a.n, a.eps);
    return cudaGetLastError();
  }
  constexpr int CPT = chunks_per_thread<T>(VPT), L = chunk_len<T>();
  constexpr int SMEM_MAX = CPT * L * TPR * int(sizeof(float));
  static const int per_sm = vec_blocks_per_sm(rms_fwd_vec_kernel<T, CPT, TPR, PARAMS_SHARED>,
                                              TPR * RPC, SMEM_MAX);
  int grid = 0;
  const cudaError_t e = norm_vec_grid(a.rows, RPC, per_sm, &grid);
  if (e != cudaSuccess) return e;
  auto kernel = rms_fwd_vec_kernel<T, CPT, TPR, PARAMS_NONE>;
  int smem = 0;
  if (a.w != nullptr) {
    kernel = rms_fwd_vec_kernel<T, CPT, TPR, PARAMS_SHARED>;
    smem = SMEM_MAX;
    // w in registers where each row stream takes one row, not in a
    // 1024-thread block (layer_norm.cu's launch)
    if constexpr (TPR < 1024) {
      if ((long long)grid * RPC >= a.rows) {
        kernel = rms_fwd_vec_kernel<T, CPT, TPR, PARAMS_REGS>;
        smem = 0;
      }
    }
  }
  kernel<<<grid, block, smem, a.st>>>(static_cast<const T*>(a.x), a.w, a.wdt,
                                      static_cast<T*>(a.y), a.rstd, a.rows, a.n, 1.f / a.n,
                                      a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a) {
  if (a.route != NORM_SCALAR &&
      (a.n % chunk_len<T>() != 0 || !aligned16(a.x) || !aligned16(a.y) ||
       (a.w != nullptr && !aligned16(a.w))))
    return cudaErrorInvalidValue;
#define APEX_RMS_FWD(VPT, TPR) launch<T, VPT, TPR>(a)
  APEX_NORM_BY_ROW(a.n, APEX_RMS_FWD);
#undef APEX_RMS_FWD
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC)
rms_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
               const float* __restrict__ rstd, const void* __restrict__ w, int wdtype,
               T* __restrict__ dx, float* __restrict__ part_w, int rows, int n) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR;
  __shared__ float red[RPC][WPR];
  const int tid = threadIdx.x;

  // a 1024-thread block (n > 8192) has 64 registers a thread, which hold
  // the column sums but not w, g and xhat beside them: there the dx pass
  // reads g and x again (from L1) and w is read where it is used
  constexpr bool HOLD = TPR < 1024;
  constexpr int HV = HOLD ? VPT : 1;
  auto weight = [&](int c) { return (w != nullptr && c < n) ? load_as_f(w, c, wdtype) : 1.f; };
  float wv[HV], aw[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if constexpr (HOLD) wv[i] = weight(tid + i * TPR);
    aw[i] = 0.f;
  }

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  for (long long row = (long long)blockIdx.x * RPC + threadIdx.y; row < rows; row += stride) {
    const T* gr = g + row * n;
    const T* xr = x + row * n;
    const float rs = rstd[row];
    float gv[HV], xh[HV];
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      float gi = 0.f, xi = 0.f, wi;
      if (c < n) {
        gi = to_f(gr[c]);
        xi = to_f(xr[c]) * rs;
      }
      if constexpr (HOLD) {
        gv[i] = gi, xh[i] = xi, wi = wv[i];
      } else {
        wi = weight(c);
      }
      s2 += gi * wi * xi;
    }
    const float c2 = row_sum<WPR>(s2, red[threadIdx.y]) / n;
    T* dxr = dx + row * n;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      float gi = 0.f, xi = 0.f, wi;
      if constexpr (HOLD) {
        gi = gv[i], xi = xh[i], wi = wv[i];
      } else {
        if (c < n) {
          gi = to_f(gr[c]);
          xi = to_f(xr[c]) * rs;
        }
        wi = weight(c);
      }
      if (c < n) dxr[c] = from_f<T>((gi * wi - xi * c2) * rs);
      aw[i] += gi * xi;
    }
  }
  if (part_w == nullptr) return;  // the plain (non-affine) form

  float* pw = part_w + (long long)blockIdx.x * n;
  if constexpr (RPC == 1) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      if (c < n) pw[c] = aw[i];
    }
  } else {
    // the RPC warps of the block (one row stream each) add their column
    // sums in a fixed order
    __shared__ float cw[RPC][VPT * TPR];
#pragma unroll
    for (int i = 0; i < VPT; ++i) cw[threadIdx.y][tid + i * TPR] = aw[i];
    __syncthreads();
    for (int c = threadIdx.y * TPR + tid; c < n; c += RPC * TPR) {
      float sw = 0.f;
#pragma unroll
      for (int r = 0; r < RPC; ++r) sw += cw[r][c];
      pw[c] = sw;
    }
  }
}

// the vec route's backward: layer_norm.cu's ln_bwd_vec_kernel without the
// mean: 16-byte chunks of g, x and dx, row streams at a grid stride with the
// next row's chunks and rstd in flight, w (AFFINE) staged once a block as
// fp32 planes from its own dtype, c2 a product with inv_n = 1 / n, and the
// columns' fp32 sums of g * xhat kept in registers and written as one row
// of partials a block (write_col_partials)
template <typename T, int CPT, int TPR, bool AFFINE>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC, 1)
rms_bwd_vec_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ rstd, const void* __restrict__ w, int wdt,
                   T* __restrict__ dx, float* __restrict__ part_w, int rows, int n,
                   float inv_n) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR, L = chunk_len<T>();
  constexpr int SLOTS = CPT * TPR, AC = AFFINE ? CPT : 1;
  __shared__ float red[RPC][WPR];
  extern __shared__ float4 smem[];  // w's L / 4 planes, then the column sums
  const int tid = threadIdx.x;
  const int chunks = n / L;
  // the column sums may be scheduled now (ln_bwd_vec_kernel's note)
  asm volatile("griddepcontrol.launch_dependents;");

  // a 1024-thread block (n > 8192) holds the column sums but not the row
  // beside them in its 64 registers a thread: ln_bwd_vec_kernel's HOLD
  constexpr bool HOLD = TPR < 1024;
  constexpr int HC = HOLD ? CPT : 1;

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  uint4 cg[HC], cx[HC];
  float rs = 0.f;
  if (row < rows) {
    if constexpr (HOLD) {
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(g + row * n), chunks, cg);
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + row * n), chunks, cx);
    }
    rs = rstd[row];
  }
  float aw[AC][L];
#pragma unroll
  for (int i = 0; i < AC; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) aw[i][j] = 0.f;
  }
  if constexpr (AFFINE) {
    APEX_PARAM_SWITCH(wdt, P,
        stage_param<L, SLOTS, TPR * RPC>(static_cast<const P*>(w), chunks, smem));
    __syncthreads();
  }
  for (; row < rows; row += stride) {
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * n);
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
    uint4 ng[HC], nx[HC];
    float nrs = 0.f;
    const long long next = row + stride;
    if (next < rows) {
      if constexpr (HOLD) {
        load_row<CPT, TPR>(reinterpret_cast<const uint4*>(g + next * n), chunks, ng);
        load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + next * n), chunks, nx);
      }
      nrs = rstd[next];
    }

    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * TPR;
      if (c < chunks) {
        float gv[L], xv[L], wv[L];
        if constexpr (HOLD) {
          unpack_chunk<T>(cg[i], gv);
          unpack_chunk<T>(cx[i], xv);
        } else {
          unpack_chunk<T>(__ldg(gr + c), gv);
          unpack_chunk<T>(__ldg(xr + c), xv);
        }
        if constexpr (AFFINE) load_staged<L, SLOTS>(smem, c, wv);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float xh = xv[j] * rs;
          float gh = gv[j];
          if constexpr (AFFINE) {
            gh *= wv[j];
            aw[i][j] += gv[j] * xh;
          }
          s2 += gh * xh;
        }
      }
    }
    const float c2 = row_sum<WPR>(s2, red[threadIdx.y]) * inv_n;

    uint4* dr = reinterpret_cast<uint4*>(dx + row * n);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * TPR;
      if (c < chunks) {
        float gv[L], xv[L], wv[L], o[L];
        if constexpr (HOLD) {
          unpack_chunk<T>(cg[i], gv);
          unpack_chunk<T>(cx[i], xv);
        } else {
          unpack_chunk<T>(__ldg(gr + c), gv);
          unpack_chunk<T>(__ldg(xr + c), xv);
        }
        if constexpr (AFFINE) load_staged<L, SLOTS>(smem, c, wv);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float xh = xv[j] * rs;
          float gh = gv[j];
          if constexpr (AFFINE) gh *= wv[j];
          o[j] = (gh - xh * c2) * rs;
        }
        dr[c] = pack_chunk<T>(o);
      }
    }
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) cg[i] = ng[i], cx[i] = nx[i];
    }
    rs = nrs;
  }
  if constexpr (AFFINE) {
    __syncthreads();  // every stream is done with the staged w
    write_col_partials<L, CPT, TPR, RPC>(aw, smem, part_w + (long long)blockIdx.x * n, chunks);
  }
}

// dw: the column sums of part_w, rounded once to odt (sum_columns)
__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
rms_bwd_cols_kernel(const float* __restrict__ part_w, void* __restrict__ dw, int parts, int n,
                    int odt) {
  sum_columns(part_w, dw, parts, n, odt);
}

struct BwdArgs {
  const void* g;
  const void* x;
  const float* rstd;
  const void* w;
  int wdt;
  void* dx;
  float* pw;
  int parts, rows, n, route;
  cudaStream_t st;
};

// The backward's grid, which is also the number of rows of partial column
// sums (layer_norm.cu's bwd_grid): scalar, norm_bwd_parts; vec, as many
// blocks as are resident at once (of the affine kernel), no more than the
// rows need; 0 if the runtime refuses.
template <typename T, int VPT, int TPR>
int bwd_grid(int rows, int n, int route) {
  if (route == NORM_SCALAR) return norm_bwd_parts(rows, n);
  constexpr int RPC = Shape<TPR>::RPC, CPT = chunks_per_thread<T>(VPT);
  static const int per_sm = vec_blocks_per_sm(rms_bwd_vec_kernel<T, CPT, TPR, true>, TPR * RPC,
                                              norm_bwd_vec_smem<T, CPT, TPR>());
  int grid = 0;
  return norm_vec_grid(rows, RPC, per_sm, &grid) == cudaSuccess ? grid : 0;
}

template <typename T, int VPT, int TPR>
cudaError_t launch_bwd(const BwdArgs& a) {
  constexpr int RPC = Shape<TPR>::RPC, CPT = chunks_per_thread<T>(VPT);
  const int grid = bwd_grid<T, VPT, TPR>(a.rows, a.n, a.route);
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  if (a.parts != grid) return cudaErrorInvalidValue;  // the workspace's rows
  const dim3 block(TPR, RPC);
  const T* g = static_cast<const T*>(a.g);
  const T* x = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(a.dx);
  if (a.route == NORM_SCALAR) {
    rms_bwd_kernel<T, VPT, TPR><<<grid, block, 0, a.st>>>(g, x, a.rstd, a.w, a.wdt, dx, a.pw,
                                                          a.rows, a.n);
  } else if (a.w != nullptr) {
    rms_bwd_vec_kernel<T, CPT, TPR, true>
        <<<grid, block, norm_bwd_vec_smem<T, CPT, TPR>(), a.st>>>(
            g, x, a.rstd, a.w, a.wdt, dx, a.pw, a.rows, a.n, 1.f / a.n);
  } else {
    rms_bwd_vec_kernel<T, CPT, TPR, false><<<grid, block, 0, a.st>>>(
        g, x, a.rstd, nullptr, 0, dx, nullptr, a.rows, a.n, 1.f / a.n);
  }
  return cudaGetLastError();
}

// whether the vec route takes these arguments (n a multiple of the chunk,
// 16-byte aligned rows, weight and workspace)
template <typename T>
bool vec_takes(const BwdArgs& a) {
  return a.n % chunk_len<T>() == 0 && aligned16(a.g) && aligned16(a.x) && aligned16(a.dx) &&
         (a.w == nullptr || (aligned16(a.w) && aligned16(a.pw)));
}

template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& a) {
  if (a.route != NORM_SCALAR && !vec_takes<T>(a)) return cudaErrorInvalidValue;
#define APEX_RMS_BWD(VPT, TPR) launch_bwd<T, VPT, TPR>(a)
  APEX_NORM_BY_ROW(a.n, APEX_RMS_BWD);
#undef APEX_RMS_BWD
}

template <typename T>
int dispatch_parts(int rows, int n, int route) {
  if (n > 16384) return 0;
#define APEX_RMS_PARTS(VPT, TPR) bwd_grid<T, VPT, TPR>(rows, n, route)
  APEX_NORM_BY_ROW(n, APEX_RMS_PARTS);
#undef APEX_RMS_PARTS
}

}  // namespace

// x (rows, n) contiguous in dtype (0 float32, 1 bfloat16, 2 float16);
// w (n,) in wdtype (codes as dtype's, independent of x's), or null for
// the non-affine form; y like x; rstd (rows,) float32.  route as
// apex_ln_fwd's (layer_norm.cu): NORM_SCALAR (0) or NORM_VEC (1); vec
// takes n a multiple of 16 / sizeof(x's dtype) and 16-byte aligned x, y
// and w.  Returns the cudaError_t of the launch.
extern "C" int apex_rms_fwd(const void* x, const void* w, int wdtype, void* y, void* rstd,
                            int rows, int n, float eps, int dtype, int route, void* stream) {
  const FwdArgs a{x, w, wdtype, y, static_cast<float*>(rstd), rows, n, eps, route,
                  static_cast<cudaStream_t>(stream)};
  if (rows <= 0 || n <= 0 || wdtype < DT_F32 || wdtype > DT_F16 ||
      (route != NORM_SCALAR && route != NORM_VEC))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch<float>(a);
    case DT_BF16: return dispatch<__nv_bfloat16>(a);
    case DT_F16: return dispatch<__half>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The number of blocks (and rows of partial sums) apex_rms_bwd runs for a
// (rows, n) input in dtype on route on the current device (bwd_grid), 0
// for arguments no launch takes.  The caller allocates the (parts, n) fp32
// workspace from it.
extern "C" int apex_rms_bwd_parts(int rows, int n, int dtype, int route) {
  if (rows <= 0 || n <= 0 || (route != NORM_SCALAR && route != NORM_VEC)) return 0;
  switch (dtype) {
    case DT_F32: return dispatch_parts<float>(rows, n, route);
    case DT_BF16: return dispatch_parts<__nv_bfloat16>(rows, n, route);
    case DT_F16: return dispatch_parts<__half>(rows, n, route);
    default: return 0;
  }
}

// g, x, dx (rows, n) contiguous in dtype; rstd (rows,) float32; w (n,) in
// wdtype, or null for the plain form, whose part_w is null too; part_w
// (parts, n) float32 with parts from apex_rms_bwd_parts for the same rows,
// n, dtype and route.  route as apex_ln_bwd's: vec takes n a multiple of
// 16 / sizeof(dtype) and 16-byte aligned g, x, dx, w and part_w.  Returns
// the cudaError_t of the launch.
extern "C" int apex_rms_bwd(const void* g, const void* x, const void* rstd, const void* w,
                            int wdtype, void* dx, void* part_w, int parts, int rows, int n,
                            int dtype, int route, void* stream) {
  const BwdArgs a{g, x, static_cast<const float*>(rstd), w, wdtype, dx,
                  static_cast<float*>(part_w), parts, rows, n, route,
                  static_cast<cudaStream_t>(stream)};
  if (rows <= 0 || n <= 0 || parts <= 0 || (w == nullptr) != (a.pw == nullptr) ||
      wdtype < DT_F32 || wdtype > DT_F16 || (route != NORM_SCALAR && route != NORM_VEC))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch_bwd<float>(a);
    case DT_BF16: return dispatch_bwd<__nv_bfloat16>(a);
    case DT_F16: return dispatch_bwd<__half>(a);
    default: return cudaErrorInvalidValue;
  }
}

// dw (n,) in odtype (codes as dtype's) = the column sums of part_w (parts,
// n), summed in fp32 and rounded once.  Returns the cudaError_t of the
// launch.
extern "C" int apex_rms_bwd_cols(const void* part_w, void* dw, int parts, int n, int odtype,
                                 void* stream) {
  if (parts <= 0 || n <= 0 || odtype < DT_F32 || odtype > DT_F16) return cudaErrorInvalidValue;
  const dim3 grid((n + SUM_COLS - 1) / SUM_COLS), block(SUM_COLS, SUM_ROWS);
  return launch_dependent(rms_bwd_cols_kernel, grid, block, static_cast<cudaStream_t>(stream),
                          static_cast<const float*>(part_w), dw, parts, n, odtype);
}
