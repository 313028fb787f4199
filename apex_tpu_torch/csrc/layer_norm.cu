// LayerNorm forward and backward for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: apex_tpu/kernels/layer_norm.py::ln_forward (Pallas kernel
// _fwd_kernel): y = (x - mean) * rstd [* w + b] over the last dim, with the
// two-pass fp32 statistics of the JAX kernel (mean first, then the mean of
// the squared deviations; not Welford, not E[x^2] - E[x]^2) and
// rstd = rsqrt(var + eps).  y is in x's dtype; mean and rstd are fp32,
// one per row.  The forward takes each mean as a product with 1 / n and
// rstd from the rsqrt instruction (within 2 units in the last place of
// 1 / sqrt), as the JAX kernel's lax.rsqrt: IEEE division and square root
// compile to out-of-line slow paths, around which ptxas saved live
// registers to the stack.  And apex_tpu/kernels/layer_norm.py::ln_backward
// (Pallas kernel _bwd_kernel): from the saved mean and rstd, xhat =
// (x - mean) * rstd, gh = g * w, c1 = mean(gh), c2 = mean(gh * xhat) and
// dx = (gh - c1 - xhat * c2) * rstd in x's dtype; dgamma = sum(g * xhat)
// and dbeta = sum(g) over all rows, in fp32.
//
// Bound on the H100: bytes.  At the GPT-2-small shapes (4096 x 768 in
// prefill, 8 x 768 per decode step, 16384 x 768 in training) both kernels
// do ~10 operations per element they read and write once, far below the
// card's ~20 fp32 operations per byte, so the least time is the bytes of x
// and y (forward) or g, x and dx (backward) over 3.35 TB/s; the 8-row
// decode shape is bound by launch latency.
// The forward at the training shape moves 50 MB, which the 50 MB L2
// cannot hold between calls; at 4096 x 768 fp32 its 25 MB can stay there,
// so a warm call may beat the HBM bound.  What bounds it in practice is
// bytes in flight: enough 16-byte loads issued ahead of their use.
//
// Design: the row stays in registers, so x (and g) are read from memory
// once and both passes run out of registers.  A row of n <= 1024 belongs to
// one warp (four rows per 128-thread block); a longer row to a 256- or
// 1024-thread block, whose warps combine their partial sums through shared
// memory.  Up to n = 16384.  The forward has two routes, which the caller
// picks (kernels/layer_norm.py::norm_route):
// - vec, for n a multiple of 16 bytes' worth of x's dtype and 16-byte
//   aligned x, y, w and b: each thread holds 16-byte chunks of its row at a
//   stride of the row's thread count (a 768-wide bf16 row is 96 chunks, 3 a
//   lane), so a warp instruction moves 512 contiguous bytes, and y is
//   written the same way.  The chunks stay packed in registers and are
//   converted to fp32 in each pass.  Row streams walk rows at a grid stride
//   over as many blocks as are resident at once, each loading its next
//   row's chunks before it reduces the current one, so a row's worth of
//   bytes stays in flight per warp.  w and b are read 16 bytes at a time
//   in their own dtypes, once per block: into shared memory as fp32 where
//   the streams walk several rows (in registers they cost the occupancy
//   that keeps bytes in flight), laid out in planes of float4 so that a
//   warp's reads are conflict-free; into registers where each stream takes
//   one row (decode: the shared-memory round trip lengthened the launch),
//   except in 1024-thread blocks, whose 64 registers a thread cannot hold
//   them beside the row.  y goes to L2 by default (the next GEMM reads
//   it).  Its launch bound names one block an SM: without it ptxas spilled
//   a few bytes of some instances to reach the next occupancy step.
// - scalar, for the rest: a block per four rows (or per row), each thread
//   holding VPT elements at a stride of the row's thread count, one 2- or
//   4-byte access each, the parameters read after the statistics in their
//   dtypes (switched on once, around the row).
// Both reduce with warp shuffles; lane 0 writes the row's statistics.
// The TPU kernel sums dgamma/dbeta across its sequential grid in one
// output block; CUDA blocks run in no order, so the backward runs a fixed
// grid of blocks, each walking rows at a grid stride and keeping its
// threads' column sums in registers, and writes one fp32 row of partial
// sums per block into a workspace; a second kernel sums the workspace by
// column in a fixed order and rounds each sum once to the dtype asked for
// (the weight's, for the autograd Function).  Deterministic, no float
// atomics: the grid, and so the order of every sum, depends only on the
// shape, dtype, route and card.  The backward has the forward's two routes:
// - vec: 16-byte chunks of g, x and dx in the forward's row layout, row
//   streams over as many blocks as are resident at once, each loading its
//   next row's chunks and statistics before it reduces the current row, so
//   about two rows of g and x are in flight a warp; w staged once a block
//   as fp32 planes from its own dtype; c1 and c2 products with 1 / n; at
//   the end the block's row streams add their column sums in a fixed order
//   through shared memory.  In 1024-thread blocks (n > 8192) the 64
//   registers a thread hold the column sums but not the row, so there the
//   row is read again for dx (from L1) and not loaded ahead.
// - scalar, for the rest: one element per access, two blocks an SM, w
//   held in registers, the statistics' means IEEE divisions by n; the same
//   1024-thread exception, where w is read at each use.

#include "norm_common.cuh"

namespace {

// the scalar route's row: one element per access, w and b (each of its
// own type W, B; both null for the plain form) read after the statistics,
// which are the vec kernel's (inv_n = 1 / n, the rsqrt instruction)
template <typename T, int VPT, int TPR, typename W, typename B>
__device__ __forceinline__ void ln_fwd_row(const T* __restrict__ xr, const W* __restrict__ w,
                                           const B* __restrict__ b, T* __restrict__ yr,
                                           float* __restrict__ mean_out,
                                           float* __restrict__ rstd_out, long long row, int n,
                                           float inv_n, float eps, float* red) {
  constexpr int WPR = Shape<TPR>::WPR;
  const int tid = threadIdx.x;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    v[i] = c < n ? to_f(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = row_sum<WPR>(s, red) * inv_n;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    if (c < n) {
      const float dv = v[i] - mu;
      q += dv * dv;
    }
  }
  const float rs = rsqrtf(row_sum<WPR>(q, red) * inv_n + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * TPR;
    if (c < n) {
      float o = (v[i] - mu) * rs;
      if (w != nullptr) o = o * to_f(w[c]) + to_f(b[c]);
      yr[c] = from_f<T>(o);
    }
  }
  if (tid == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

// the scalar route: any n and alignment; the parameters' dtypes switched
// on once, around the whole row
template <typename T, int VPT, int TPR>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC)
ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w, int wdt,
              const void* __restrict__ b, int bdt, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int rows, int n, float inv_n, float eps) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR;
  __shared__ float red[RPC][WPR];
  const long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  // a block of several warps holds one row (RPC == 1), so a block either
  // returns whole or not at all and the __syncthreads in row_sum are safe
  if (row >= rows) return;
  APEX_PARAM_SWITCH(wdt, W, APEX_PARAM_SWITCH(bdt, B,
      ln_fwd_row<T, VPT, TPR>(x + row * n, static_cast<const W*>(w),
                              static_cast<const B*>(b), y + row * n, mean_out, rstd_out,
                              row, n, inv_n, eps, red[threadIdx.y])));
}

// the vec route: 16-byte chunks, chunk tid + i * TPR of a row to each
// thread; each row stream walks rows at a grid stride with the next row's
// chunks in flight while it reduces the current one; the chunks stay
// packed and are converted to fp32 in each pass (fewer registers).  w and
// b, as fp32, are held as PARAMS says (see launch).  The means are products with
// inv_n = 1 / n and rstd the rsqrt instruction's (as the JAX kernel's
// lax.rsqrt, within 2 units in the last place of 1 / sqrt): no IEEE
// division or square root, whose out-of-line slow paths make ptxas save
// live registers to the stack
template <typename T, int CPT, int TPR, int PARAMS>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC, 1)
ln_fwd_vec_kernel(const T* __restrict__ x, const void* __restrict__ w, int wdt,
                  const void* __restrict__ b, int bdt, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int n, float inv_n, float eps) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR, L = chunk_len<T>();
  constexpr int RC = PARAMS == PARAMS_REGS ? CPT : 1, SLOTS = CPT * TPR;
  __shared__ float red[RPC][WPR];
  extern __shared__ float4 staged[];  // w's L / 4 planes, then b's
  const float4* ws = staged;
  const float4* bs = staged + L / 4 * SLOTS;
  const int tid = threadIdx.x;
  const int chunks = n / L;

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  uint4 cur[CPT];
  float wr[RC][L], br[RC][L];
  if (row < rows) load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + row * n), chunks, cur);
  if constexpr (PARAMS == PARAMS_SHARED) {
    APEX_PARAM_SWITCH(wdt, P,
        stage_param<L, SLOTS, TPR * RPC>(static_cast<const P*>(w), chunks, staged));
    APEX_PARAM_SWITCH(bdt, P,
        stage_param<L, SLOTS, TPR * RPC>(static_cast<const P*>(b), chunks,
                                         staged + L / 4 * SLOTS));
    __syncthreads();
  } else if constexpr (PARAMS == PARAMS_REGS) {
    APEX_PARAM_SWITCH(wdt, P, load_param_row<L, CPT, TPR>(static_cast<const P*>(w), chunks, wr));
    APEX_PARAM_SWITCH(bdt, P, load_param_row<L, CPT, TPR>(static_cast<const P*>(b), chunks, br));
  }
  for (; row < rows; row += stride) {
    uint4 nxt[CPT];
    if (row + stride < rows)
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + (row + stride) * n), chunks, nxt);

    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (tid + i * TPR < chunks) {
        float v[L];
        unpack_chunk<T>(cur[i], v);
#pragma unroll
        for (int j = 0; j < L; ++j) s += v[j];
      }
    }
    const float mu = row_sum<WPR>(s, red[threadIdx.y]) * inv_n;

    float q = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (tid + i * TPR < chunks) {
        float v[L];
        unpack_chunk<T>(cur[i], v);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float dv = v[j] - mu;
          q += dv * dv;
        }
      }
    }
    const float rs = rsqrtf(row_sum<WPR>(q, red[threadIdx.y]) * inv_n + eps);

    uint4* yr = reinterpret_cast<uint4*>(y + row * n);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * TPR;
      if (c < chunks) {
        float o[L], wv[L], bv[L];
        unpack_chunk<T>(cur[i], o);
        if constexpr (PARAMS == PARAMS_SHARED) {
          load_staged<L, SLOTS>(ws, c, wv);
          load_staged<L, SLOTS>(bs, c, bv);
        } else if constexpr (PARAMS == PARAMS_REGS) {
#pragma unroll
          for (int j = 0; j < L; ++j) wv[j] = wr[i][j], bv[j] = br[i][j];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) {
          o[j] = (o[j] - mu) * rs;
          if constexpr (PARAMS != PARAMS_NONE) o[j] = o[j] * wv[j] + bv[j];
        }
        yr[c] = pack_chunk<T>(o);
      }
    }
    if (tid == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rs;
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) cur[i] = nxt[i];
  }
}

struct FwdArgs {
  const void* x;
  const void* w;
  int wdt;
  const void* b;
  int bdt;
  void* y;
  float* mean;
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
    ln_fwd_kernel<T, VPT, TPR><<<(a.rows + RPC - 1) / RPC, block, 0, a.st>>>(
        static_cast<const T*>(a.x), a.w, a.wdt, a.b, a.bdt, static_cast<T*>(a.y), a.mean,
        a.rstd, a.rows, a.n, 1.f / a.n, a.eps);
    return cudaGetLastError();
  }
  constexpr int CPT = chunks_per_thread<T>(VPT), L = chunk_len<T>();
  constexpr int SMEM_MAX = 2 * CPT * L * TPR * int(sizeof(float));
  static const int per_sm = vec_blocks_per_sm(ln_fwd_vec_kernel<T, CPT, TPR, PARAMS_SHARED>,
                                              TPR * RPC, SMEM_MAX);
  int grid = 0;
  const cudaError_t e = norm_vec_grid(a.rows, RPC, per_sm, &grid);
  if (e != cudaSuccess) return e;
  auto kernel = ln_fwd_vec_kernel<T, CPT, TPR, PARAMS_NONE>;
  int smem = 0;
  if (a.w != nullptr) {
    kernel = ln_fwd_vec_kernel<T, CPT, TPR, PARAMS_SHARED>;
    smem = SMEM_MAX;
    // w and b in registers where each row stream takes one row (fewer
    // rows than the resident blocks hold: decode, small batches), which
    // saves the shared-memory round trip; not in a 1024-thread block,
    // whose 64 registers a thread cannot hold them beside the row
    if constexpr (TPR < 1024) {
      if ((long long)grid * RPC >= a.rows) {
        kernel = ln_fwd_vec_kernel<T, CPT, TPR, PARAMS_REGS>;
        smem = 0;
      }
    }
  }
  kernel<<<grid, block, smem, a.st>>>(static_cast<const T*>(a.x), a.w, a.wdt, a.b, a.bdt,
                                      static_cast<T*>(a.y), a.mean, a.rstd, a.rows, a.n,
                                      1.f / a.n, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a) {
  if (a.route != NORM_SCALAR &&
      (a.n % chunk_len<T>() != 0 || !aligned16(a.x) || !aligned16(a.y) ||
       (a.w != nullptr && (!aligned16(a.w) || !aligned16(a.b)))))
    return cudaErrorInvalidValue;
#define APEX_LN_FWD(VPT, TPR) launch<T, VPT, TPR>(a)
  APEX_NORM_BY_ROW(a.n, APEX_LN_FWD);
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

  // a 1024-thread block (n > 8192) has 64 registers a thread, too few for
  // w, g, xhat and the column sums: there the dx pass reads g and x again
  // (from L1), w is read where it is used and the column sums sit in
  // shared memory (each thread's own: sw[i * TPR + tid], sb likewise, so
  // no synchronisation)
  constexpr bool HOLD = TPR < 1024;
  constexpr int HV = HOLD ? VPT : 1;
  // unrolled only where registers hold the row: rolled, the compiler can
  // neither keep the first pass's loads for the second nor hoist them all
  constexpr int UNROLL = HOLD ? VPT : 1;
  extern __shared__ float sums[];
  float* sw = sums;
  float* sb = sums + VPT * TPR;
  auto weight = [&](int c) { return (w != nullptr && c < n) ? load_as_f(w, c, wdtype) : 1.f; };
  float wv[HV], aw[HV], ab[HV];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if constexpr (HOLD) {
      wv[i] = weight(tid + i * TPR);
      aw[i] = ab[i] = 0.f;
    } else {
      sw[i * TPR + tid] = sb[i * TPR + tid] = 0.f;
    }
  }

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  for (long long row = (long long)blockIdx.x * RPC + threadIdx.y; row < rows; row += stride) {
    const T* gr = g + row * n;
    const T* xr = x + row * n;
    const float mu = mean[row], rs = rstd[row];
    float gv[HV], xh[HV];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll(UNROLL)
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      float gi = 0.f, xi = 0.f, wi;
      if (c < n) {
        gi = to_f(gr[c]);
        xi = (to_f(xr[c]) - mu) * rs;
      }
      if constexpr (HOLD) {
        gv[i] = gi, xh[i] = xi, wi = wv[i];
      } else {
        wi = weight(c);
      }
      const float gh = gi * wi;
      s1 += gh;
      s2 += gh * xi;
    }
    const float c1 = row_sum<WPR>(s1, red[threadIdx.y]) / n;
    const float c2 = row_sum<WPR>(s2, red[threadIdx.y]) / n;
    T* dxr = dx + row * n;
#pragma unroll(UNROLL)
    for (int i = 0; i < VPT; ++i) {
      const int c = tid + i * TPR;
      float gi = 0.f, xi = 0.f, wi;
      if constexpr (HOLD) {
        gi = gv[i], xi = xh[i], wi = wv[i];
      } else {
        if (c < n) {
          gi = to_f(gr[c]);
          xi = (to_f(xr[c]) - mu) * rs;
        }
        wi = weight(c);
      }
      if (c < n) dxr[c] = from_f<T>((gi * wi - c1 - xi * c2) * rs);
      if constexpr (HOLD) {
        aw[i] += gi * xi;
        ab[i] += gi;
      } else {
        sw[i * TPR + tid] += gi * xi;
        sb[i * TPR + tid] += gi;
      }
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
        if constexpr (HOLD) {
          pw[c] = aw[i], pb[c] = ab[i];
        } else {
          pw[c] = sw[i * TPR + tid], pb[c] = sb[i * TPR + tid];
        }
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

// the vec route's backward: layer_norm.cu's forward layout (16-byte
// chunks of g, x and dx, chunk tid + i * TPR of a row to each thread), row
// streams walking rows at a grid stride with the next row's chunks and
// statistics in flight while the current row is reduced, the chunks kept
// packed and converted to fp32 in each pass.  w (AFFINE) is read once a
// block in its own dtype and staged as fp32 planes (stage_param).  c1 and
// c2 are products with inv_n = 1 / n (no IEEE division).  Each thread keeps
// its columns' fp32 sums of g * xhat and g in registers over its rows; at
// the end the block's streams add theirs in a fixed order and write one
// row of partials (write_col_partials).
template <typename T, int CPT, int TPR, bool AFFINE>
__global__ void __launch_bounds__(TPR * Shape<TPR>::RPC, 1)
ln_bwd_vec_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const void* __restrict__ w, int wdt, T* __restrict__ dx,
                  float* __restrict__ part_w, float* __restrict__ part_b, int rows, int n,
                  float inv_n) {
  constexpr int RPC = Shape<TPR>::RPC, WPR = Shape<TPR>::WPR, L = chunk_len<T>();
  constexpr int SLOTS = CPT * TPR, AC = AFFINE ? CPT : 1;
  __shared__ float red[RPC][WPR];
  extern __shared__ float4 smem[];  // w's L / 4 planes, then the column sums
  const int tid = threadIdx.x;
  const int chunks = n / L;
  // the column sums, launched as this grid's programmatic dependent, may be
  // scheduled now: they wait for the whole grid before they read
  asm volatile("griddepcontrol.launch_dependents;");

  // a 1024-thread block (n > 8192) has 64 registers a thread, which hold
  // the column sums but not the row beside them: there each pass reads its
  // chunks from memory (the dx pass from L1) and nothing of the next row is
  // loaded ahead (the block's 32 warps keep bytes in flight)
  constexpr bool HOLD = TPR < 1024;
  constexpr int HC = HOLD ? CPT : 1;
  // unrolled only where registers hold the row: rolled, the compiler can
  // neither keep the first pass's loads for the second nor hoist them all
  constexpr int UNROLL = HOLD ? CPT : 1;

  // with RPC == 1 every thread of the block walks the same rows, so the
  // __syncthreads in row_sum are reached by all of them
  const long long stride = (long long)gridDim.x * RPC;
  long long row = (long long)blockIdx.x * RPC + threadIdx.y;
  uint4 cg[HC], cx[HC];
  float mu = 0.f, rs = 0.f;
  if (row < rows) {
    if constexpr (HOLD) {
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(g + row * n), chunks, cg);
      load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + row * n), chunks, cx);
    }
    mu = mean[row], rs = rstd[row];
  }
  // the column sums: in registers, or, in a 1024-thread block, in shared
  // memory after the staged w (each thread's own, value j of its chunk i at
  // (i * L + j) * TPR + tid: no synchronisation, no bank conflicts), as its
  // 64 registers a thread cannot hold them beside the loads
  constexpr int AR = HOLD ? AC : 1;
  float* sw = reinterpret_cast<float*>(smem + L / 4 * SLOTS);
  float* sb = sw + CPT * L * TPR;
  float aw[AR][L], ab[AR][L];
#pragma unroll
  for (int i = 0; i < AC; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if constexpr (HOLD) {
        aw[i][j] = ab[i][j] = 0.f;
      } else if constexpr (AFFINE) {
        sw[(i * L + j) * TPR + tid] = sb[(i * L + j) * TPR + tid] = 0.f;
      }
    }
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
    float nmu = 0.f, nrs = 0.f;
    const long long next = row + stride;
    if (next < rows) {
      if constexpr (HOLD) {
        load_row<CPT, TPR>(reinterpret_cast<const uint4*>(g + next * n), chunks, ng);
        load_row<CPT, TPR>(reinterpret_cast<const uint4*>(x + next * n), chunks, nx);
      }
      nmu = mean[next], nrs = rstd[next];
    }

    float s1 = 0.f, s2 = 0.f;
#pragma unroll(UNROLL)
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
          const float xh = (xv[j] - mu) * rs;
          float gh = gv[j];
          if constexpr (AFFINE) gh *= wv[j];
          s1 += gh;
          s2 += gh * xh;
          if constexpr (AFFINE && HOLD) {
            aw[i][j] += gv[j] * xh;
            ab[i][j] += gv[j];
          } else if constexpr (AFFINE) {
            sw[(i * L + j) * TPR + tid] += gv[j] * xh;
            sb[(i * L + j) * TPR + tid] += gv[j];
          }
        }
      }
    }
    const float c1 = row_sum<WPR>(s1, red[threadIdx.y]) * inv_n;
    const float c2 = row_sum<WPR>(s2, red[threadIdx.y]) * inv_n;

    uint4* dr = reinterpret_cast<uint4*>(dx + row * n);
#pragma unroll(UNROLL)
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
          const float xh = (xv[j] - mu) * rs;
          float gh = gv[j];
          if constexpr (AFFINE) gh *= wv[j];
          o[j] = (gh - c1 - xh * c2) * rs;
        }
        dr[c] = pack_chunk<T>(o);
      }
    }
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) cg[i] = ng[i], cx[i] = nx[i];
    }
    mu = nmu, rs = nrs;
  }
  if constexpr (AFFINE) {
    __syncthreads();  // every stream is done with the staged w
    const long long off = (long long)blockIdx.x * n;
    if constexpr (HOLD) {
      write_col_partials<L, CPT, TPR, RPC>(aw, smem, part_w + off, chunks);
      write_col_partials<L, CPT, TPR, RPC>(ab, smem, part_b + off, chunks);
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* src = k == 0 ? sw : sb;
        float t[CPT][L];
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
#pragma unroll
          for (int j = 0; j < L; ++j) t[i][j] = src[(i * L + j) * TPR + tid];
        }
        write_col_partials<L, CPT, TPR, RPC>(t, smem, (k == 0 ? part_w : part_b) + off, chunks);
      }
    }
  }
}

// dgamma (blockIdx.y == 0) and dbeta (1): the column sums of part_w and
// part_b, rounded once to odt (sum_columns)
__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
ln_bwd_cols_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                   void* __restrict__ dw, void* __restrict__ db, int parts, int n, int odt) {
  sum_columns(blockIdx.y == 0 ? part_w : part_b, blockIdx.y == 0 ? dw : db, parts, n, odt);
}

// the vec backward's dynamic shared memory: norm_bwd_vec_smem's, and in a
// 1024-thread block as much again for each of the two column sums
template <typename T, int CPT, int TPR>
constexpr int bwd_vec_smem() {
  return (TPR < 1024 ? 1 : 3) * norm_bwd_vec_smem<T, CPT, TPR>();
}

struct BwdArgs {
  const void* g;
  const void* x;
  const float* mean;
  const float* rstd;
  const void* w;
  int wdt;
  void* dx;
  float* pw;
  float* pb;
  int parts, rows, n, route;
  cudaStream_t st;
};

// The backward's grid, which is also the number of rows of partial column
// sums, for a (rows, n) input of T on `route` on the current device (0 if
// the runtime refuses): scalar, norm_bwd_parts; vec, as many blocks as are
// resident at once (of the affine kernel), and no more than the rows need.
template <typename T, int VPT, int TPR>
int bwd_grid(int rows, int n, int route) {
  if (route == NORM_SCALAR) return norm_bwd_parts(rows, n);
  constexpr int RPC = Shape<TPR>::RPC, CPT = chunks_per_thread<T>(VPT);
  static const int per_sm = vec_blocks_per_sm(ln_bwd_vec_kernel<T, CPT, TPR, true>, TPR * RPC,
                                              bwd_vec_smem<T, CPT, TPR>());
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
    // the column sums of a 1024-thread block, in shared memory
    constexpr int SMEM = TPR < 1024 ? 0 : 2 * VPT * TPR * int(sizeof(float));
    static const cudaError_t set =
        SMEM > 48 * 1024 ? cudaFuncSetAttribute(ln_bwd_kernel<T, VPT, TPR>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)
                         : cudaSuccess;
    if (set != cudaSuccess) return set;
    ln_bwd_kernel<T, VPT, TPR><<<grid, block, SMEM, a.st>>>(g, x, a.mean, a.rstd, a.w, a.wdt,
                                                            dx, a.pw, a.pb, a.rows, a.n);
  } else if (a.w != nullptr) {
    ln_bwd_vec_kernel<T, CPT, TPR, true><<<grid, block, bwd_vec_smem<T, CPT, TPR>(), a.st>>>(
        g, x, a.mean, a.rstd, a.w, a.wdt, dx, a.pw, a.pb, a.rows, a.n, 1.f / a.n);
  } else {
    ln_bwd_vec_kernel<T, CPT, TPR, false><<<grid, block, 0, a.st>>>(
        g, x, a.mean, a.rstd, nullptr, 0, dx, nullptr, nullptr, a.rows, a.n, 1.f / a.n);
  }
  return cudaGetLastError();
}

// whether the vec route takes these arguments (n a multiple of the chunk,
// 16-byte aligned rows, weight and workspaces)
template <typename T>
bool vec_takes(const BwdArgs& a) {
  return a.n % chunk_len<T>() == 0 && aligned16(a.g) && aligned16(a.x) && aligned16(a.dx) &&
         (a.w == nullptr || (aligned16(a.w) && aligned16(a.pw) && aligned16(a.pb)));
}

template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& a) {
  if (a.route != NORM_SCALAR && !vec_takes<T>(a)) return cudaErrorInvalidValue;
#define APEX_LN_BWD(VPT, TPR) launch_bwd<T, VPT, TPR>(a)
  APEX_NORM_BY_ROW(a.n, APEX_LN_BWD);
#undef APEX_LN_BWD
}

template <typename T>
int dispatch_parts(int rows, int n, int route) {
  if (n > 16384) return 0;
#define APEX_LN_PARTS(VPT, TPR) bwd_grid<T, VPT, TPR>(rows, n, route)
  APEX_NORM_BY_ROW(n, APEX_LN_PARTS);
#undef APEX_LN_PARTS
}

}  // namespace

// x (rows, n) contiguous in dtype (0 float32, 1 bfloat16, 2 float16);
// w, b (n,) in wdtype and bdtype (codes as dtype's, each independent of
// x's), both null for the non-affine form; y like x; mean, rstd (rows,)
// float32.  route: NORM_SCALAR (0) or NORM_VEC (1); vec takes n a
// multiple of 16 / sizeof(x's dtype) and 16-byte aligned x, y, w and b.
// Returns the cudaError_t of the launch.
extern "C" int apex_ln_fwd(const void* x, const void* w, int wdtype, const void* b, int bdtype,
                           void* y, void* mean, void* rstd, int rows, int n, float eps,
                           int dtype, int route, void* stream) {
  const FwdArgs a{x, w, wdtype, b, bdtype, y, static_cast<float*>(mean),
                  static_cast<float*>(rstd), rows, n, eps, route,
                  static_cast<cudaStream_t>(stream)};
  if (rows <= 0 || n <= 0 || (w == nullptr) != (b == nullptr) || wdtype < DT_F32 ||
      wdtype > DT_F16 || bdtype < DT_F32 || bdtype > DT_F16 ||
      (route != NORM_SCALAR && route != NORM_VEC))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch<float>(a);
    case DT_BF16: return dispatch<__nv_bfloat16>(a);
    case DT_F16: return dispatch<__half>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The number of blocks (and rows of partial sums) apex_ln_bwd runs for a
// (rows, n) input in dtype on route on the current device (bwd_grid), 0
// for arguments no launch takes.  The caller allocates the (parts, n) fp32
// workspaces from it.
extern "C" int apex_ln_bwd_parts(int rows, int n, int dtype, int route) {
  if (rows <= 0 || n <= 0 || (route != NORM_SCALAR && route != NORM_VEC)) return 0;
  switch (dtype) {
    case DT_F32: return dispatch_parts<float>(rows, n, route);
    case DT_BF16: return dispatch_parts<__nv_bfloat16>(rows, n, route);
    case DT_F16: return dispatch_parts<__half>(rows, n, route);
    default: return 0;
  }
}

// g, x, dx (rows, n) contiguous in dtype; mean, rstd (rows,) float32; w (n,)
// in wdtype, or null for the plain form, whose part_w and part_b are null
// too; part_w, part_b (parts, n) float32 with parts from apex_ln_bwd_parts
// for the same rows, n, dtype and route.  route: NORM_SCALAR (0) or
// NORM_VEC (1); vec takes n a multiple of 16 / sizeof(dtype) and 16-byte
// aligned g, x, dx, w, part_w and part_b.  Returns the cudaError_t of the
// launch.
extern "C" int apex_ln_bwd(const void* g, const void* x, const void* mean, const void* rstd,
                           const void* w, int wdtype, void* dx, void* part_w, void* part_b,
                           int parts, int rows, int n, int dtype, int route, void* stream) {
  const BwdArgs a{g, x, static_cast<const float*>(mean), static_cast<const float*>(rstd),
                  w, wdtype, dx, static_cast<float*>(part_w), static_cast<float*>(part_b),
                  parts, rows, n, route, static_cast<cudaStream_t>(stream)};
  if (rows <= 0 || n <= 0 || parts <= 0 || (w == nullptr) != (a.pw == nullptr) ||
      (a.pw == nullptr) != (a.pb == nullptr) || wdtype < DT_F32 || wdtype > DT_F16 ||
      (route != NORM_SCALAR && route != NORM_VEC))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch_bwd<float>(a);
    case DT_BF16: return dispatch_bwd<__nv_bfloat16>(a);
    case DT_F16: return dispatch_bwd<__half>(a);
    default: return cudaErrorInvalidValue;
  }
}

// dw, db (n,) in odtype (codes as dtype's) = the column sums of part_w,
// part_b (parts, n), each summed in fp32 and rounded once.  Returns the
// cudaError_t of the launch.
extern "C" int apex_ln_bwd_cols(const void* part_w, const void* part_b, void* dw, void* db,
                                int parts, int n, int odtype, void* stream) {
  if (parts <= 0 || n <= 0 || odtype < DT_F32 || odtype > DT_F16) return cudaErrorInvalidValue;
  const dim3 grid((n + SUM_COLS - 1) / SUM_COLS, 2), block(SUM_COLS, SUM_ROWS);
  return launch_dependent(ln_bwd_cols_kernel, grid, block, static_cast<cudaStream_t>(stream),
                          static_cast<const float*>(part_w), static_cast<const float*>(part_b),
                          dw, db, parts, n, odtype);
}
