// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/kernels/attention.py::flash_attention_bwd (Pallas
// kernels _dq_kernel and _dkv_kernel).  From the forward's q, k, v, its
// per-row logsumexp lse and the incoming gradient dO, and with
// delta = rowsum(dO * out) computed by the caller, the probabilities are
// recomputed tile by tile as p = exp(s - lse), with s the forward's exact
// score (flash_common.cuh: scale after q.k^T, bias, causal / band mask at
// -1e30, keys past Sk left out), then dp = dO.v^T and ds = p * (dp - delta);
// dq = scale * ds.k, dk = scale * ds^T.q and dv = p^T.dO, each in its
// input's dtype.  All math in fp32.  Two kernels, as the reference splits
// it: dq over a sweep of the keys, dk/dv over a sweep of the queries, so
// neither needs atomics.  With dropout, both regenerate the forward's hash
// mask (flash_common.cuh) for their own tiles, as the Pallas kernels replay
// it: dp = (dO.v^T) * mult, ds = p * (dp - delta) with delta taken over the
// dropped output, and dv = (p * mult)^T.dO.
//
// Bound on the H100: operations.  At the GPT-2-small training shape
// (BH = 192, S = 1024, D = 64, causal) the five products take 10 * D
// operations per unmasked (row, key) pair, 64.5 GFLOP, against ~126 MB of
// q, k, v, out, dO and dq, dk, dv (bf16); with the math in fp32 on the CUDA
// cores (67 TFLOP/s) that is ~1 ms of arithmetic against ~0.04 ms of
// memory traffic.
//
// Design: 256-thread blocks in parallel, so each TPU grid dimension that
// was sequential becomes a loop inside one block.  dq: one block per
// (batch*head, 64-row query tile) keeps the Q and dO tiles in shared memory
// and loops over the 64-key K/V tiles that hold an unmasked entry; each
// thread owns a 4 x 4 patch of the score tile (s and dp accumulate in one
// pass over D), writes its ds to a shared tile, and accumulates a
// 4 x (D/16) patch of dq.  dk/dv: one block per (batch*head, 64-key tile)
// keeps K and V and loops over the query tiles that can see them, with the
// roles swapped (the thread's patch is keys by queries; p and ds go to two
// shared tiles; lse and delta of the tile to two shared vectors).  Tiles
// are staged as fp32 at a row stride of D + 1 (one column read by 16 rows
// hits 16 banks); 86 KB (dq) and 108 KB (dk/dv) of shared memory at
// D = 64, so two blocks fit on an SM.  Tiles with no unmasked entry are
// never loaded; query tiles in dq, like the forward, run longest first.
// The products are CUDA-core FMAs: this is the "simt" route, which takes
// fp32 and head dims other than 64; flash_attention_tc.cu is the
// tensor-core route for the rest.

#include "flash_common.cuh"

namespace {

constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int SS = BK + 16;   // shared score-tile row stride in floats

__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  // Q, dO, K, V tiles at row stride d + 1, the ds tile at SS
  return sizeof(float) * (size_t)(2 * BQ * (d + 1) + 2 * BK * (d + 1) + BQ * SS);
}

__host__ __device__ constexpr size_t dkv_smem_bytes(int d) {
  // K, V, Q, dO tiles at row stride d + 1, the p and ds tiles at SS, the
  // query tile's lse and delta
  return sizeof(float) * (size_t)(2 * BK * (d + 1) + 2 * BQ * (d + 1) + 2 * BK * SS + 2 * BQ);
}

// rows [r0, r0 + 64) of a (rows, d) matrix of T into a shared fp32 tile at
// row stride ld, zeros past the last row
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int rows, int d,
                                          int ld) {
  for (int idx = threadIdx.x; idx < 64 * d; idx += NT) {
    const int r = idx / d, c = idx - r * d;
    dst[r * ld + c] = r0 + r < rows ? to_f(src[(long long)(r0 + r) * d + c]) : 0.f;
  }
}

// NE = dq columns per thread: head dim d <= 16 * NE
template <typename T, int NE>
__global__ void __launch_bounds__(NT, NE <= 4 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, long long bias_bstride,
                    long long bias_qstride, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int sq, int sk, int d, float scale, int causal,
                    int window, const int* __restrict__ seed_vec, uint32_t drop_thresh,
                    float drop_scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;
  float* Os = Qs + BQ * ld;
  float* Ks = Os + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ss = Vs + BK * ld;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long qoff = (long long)bh * sq * d, koff = (long long)bh * sk * d;
  const float* bb = bias == nullptr ? nullptr : bias + bh * bias_bstride;
  const Dropout drop(seed_vec, bh, drop_thresh, drop_scale);

  load_tile(Qs, q + qoff, q0, sq, d, ld);
  load_tile(Os, dout + qoff, q0, sq, d, ld);
  float lr[4], dl[4];
  const float* brow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = q0 + ty + 16 * r;
    const bool in = gi < sq;
    lr[r] = in ? lse[(long long)bh * sq + gi] : 0.f;
    dl[r] = in ? delta[(long long)bh * sq + gi] : 0.f;
    brow[r] = (bb != nullptr && in) ? bb + gi * bias_qstride : nullptr;
  }

  float acc[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;

  int kbeg, kend;
  key_range(q0, BQ, sk, causal, window, &kbeg, &kend);
  const int jt0 = kbeg / BK, jt1 = (kend + BK - 1) / BK;
  for (int jt = jt0; jt < jt1; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the Q/dO tiles are in place; the last tile's reads are done
    load_tile(Ks, k + koff, k0, sk, d, ld);
    load_tile(Vs, v + koff, k0, sk, d, ld);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = Qs[(ty + 16 * r) * ld + dd];
        ov[r] = Os[(ty + 16 * r) * ld + dd];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * ld + dd];
        vv[c] = Vs[(tx + 16 * c) * ld + dd];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gj = k0 + tx + 16 * c;
        const float x = score(s[r][c], scale, brow[r], gi, gj, sk, causal, window);
        const float p = gi < sq ? expf(x - lr[r]) : 0.f;
        const float dpv = drop.on ? dp[r][c] * drop.mult(gi, gj) : dp[r][c];
        Ss[(ty + 16 * r) * SS + tx + 16 * c] = p * (dpv - dl[r]);
      }
    }
    __syncthreads();

    const int jn = min(BK, sk - k0);
    for (int j = 0; j < jn; ++j) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = Ss[(ty + 16 * r) * SS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = tx + 16 * e;
        const float kv = c < d ? Ks[j * ld + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][e] = fmaf(ds[r], kv, acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = q0 + ty + 16 * r;
    if (gi >= sq) continue;
    T* row = dq + qoff + (long long)gi * d;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = tx + 16 * e;
      if (c < d) row[c] = from_f<T>(acc[r][e] * scale);
    }
  }
}

// NE = dk/dv columns per thread: head dim d <= 16 * NE
template <typename T, int NE>
__global__ void __launch_bounds__(NT, NE <= 4 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     long long bias_bstride, long long bias_qstride,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int d, float scale, int causal, int window,
                     const int* __restrict__ seed_vec, uint32_t drop_thresh,
                     float drop_scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* Os = Qs + BQ * ld;
  float* Ps = Os + BQ * ld;
  float* Ds = Ps + BK * SS;
  float* Ls = Ds + BK * SS;
  float* Dls = Ls + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most queries
  const long long qoff = (long long)bh * sq * d, koff = (long long)bh * sk * d;
  const float* bb = bias == nullptr ? nullptr : bias + bh * bias_bstride;
  const Dropout drop(seed_vec, bh, drop_thresh, drop_scale);

  load_tile(Ks, k + koff, k0, sk, d, ld);
  load_tile(Vs, v + koff, k0, sk, d, ld);

  float ak[4][NE], av[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NE; ++e) ak[r][e] = av[r][e] = 0.f;

  int qbeg, qend;
  query_range(k0, BK, sq, sk, causal, window, &qbeg, &qend);
  const int it0 = qbeg / BQ, it1 = (qend + BQ - 1) / BQ;
  for (int it = it0; it < it1; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // the K/V tiles are in place; the last tile's reads are done
    load_tile(Qs, q + qoff, q0, sq, d, ld);
    load_tile(Os, dout + qoff, q0, sq, d, ld);
    if (tid < BQ) {
      const bool in = q0 + tid < sq;
      Ls[tid] = in ? lse[(long long)bh * sq + q0 + tid] : 0.f;
      Dls[tid] = in ? delta[(long long)bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // the patch is keys (rows ty + 16 r) by queries (columns tx + 16 c)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = Ks[(ty + 16 * r) * ld + dd];
        vv[r] = Vs[(ty + 16 * r) * ld + dd];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = Qs[(tx + 16 * c) * ld + dd];
        ov[c] = Os[(tx + 16 * c) * ld + dd];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
          dp[r][c] = fmaf(vv[r], ov[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = tx + 16 * c, gi = q0 + i;
      const float* brow = (bb != nullptr && gi < sq) ? bb + gi * bias_qstride : nullptr;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gj = k0 + ty + 16 * r;
        const float x = score(s[r][c], scale, brow, gi, gj, sk, causal, window);
        const float p = gi < sq ? expf(x - Ls[i]) : 0.f;
        const float mult = drop.on ? drop.mult(gi, gj) : 1.f;
        Ps[(ty + 16 * r) * SS + i] = p * mult;
        Ds[(ty + 16 * r) * SS + i] = p * (dp[r][c] * mult - Dls[i]);
      }
    }
    __syncthreads();

    const int in = min(BQ, sq - q0);
    for (int i = 0; i < in; ++i) {
      float pv[4], ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = Ps[(ty + 16 * r) * SS + i];
        ds[r] = Ds[(ty + 16 * r) * SS + i];
      }
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = tx + 16 * e;
        const float ov = c < d ? Os[i * ld + c] : 0.f;
        const float qv = c < d ? Qs[i * ld + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          av[r][e] = fmaf(pv[r], ov, av[r][e]);
          ak[r][e] = fmaf(ds[r], qv, ak[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gj = k0 + ty + 16 * r;
    if (gj >= sk) continue;
    T* krow = dk + koff + (long long)gj * d;
    T* vrow = dv + koff + (long long)gj * d;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = tx + 16 * e;
      if (c < d) {
        krow[c] = from_f<T>(ak[r][e] * scale);
        vrow[c] = from_f<T>(av[r][e]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float* bias;
  long long bstride, qstride;
  const void* dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, sq, sk, d;
  float scale;
  int causal, window;
  const int* seed_vec;
  uint32_t thresh;
  float drop_scale;
  cudaStream_t st;
};

template <typename T, int NE>
cudaError_t launch_dq(const Args& a) {
  // allow the largest tile set of this instantiation once (above 48 KB only
  // dynamic shared memory may be used, after this opt-in)
  static cudaError_t opt_in = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem_bytes(16 * NE));
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, NE><<<grid, NT, dq_smem_bytes(a.d), a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.bias, a.bstride, a.qstride, static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.sq, a.sk, a.d, a.scale, a.causal, a.window, a.seed_vec,
      a.thresh, a.drop_scale);
  return cudaGetLastError();
}

template <typename T, int NE>
cudaError_t launch_dkv(const Args& a) {
  static cudaError_t opt_in = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dkv_smem_bytes(16 * NE));
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(a.bh, (a.sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, NE><<<grid, NT, dkv_smem_bytes(a.d), a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.bias, a.bstride, a.qstride, static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.d, a.scale, a.causal,
      a.window, a.seed_vec, a.thresh, a.drop_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool dkv) {
  if (a.d <= 16) return dkv ? launch_dkv<T, 1>(a) : launch_dq<T, 1>(a);
  if (a.d <= 32) return dkv ? launch_dkv<T, 2>(a) : launch_dq<T, 2>(a);
  if (a.d <= 64) return dkv ? launch_dkv<T, 4>(a) : launch_dq<T, 4>(a);
  if (a.d <= 128) return dkv ? launch_dkv<T, 8>(a) : launch_dq<T, 8>(a);
  return cudaErrorInvalidValue;
}

cudaError_t run(const Args& a, int dtype, bool dkv) {
  // grid.y counts query (dq) or key (dk/dv) tiles and may not pass 65535
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.d <= 0 || a.sq > 65535 * BQ ||
      a.sk > 65535 * BK)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch<float>(a, dkv);
    case DT_BF16: return dispatch<__nv_bfloat16>(a, dkv);
    case DT_F16: return dispatch<__half>(a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (bh, sq, d) and k, v (bh, sk, d), contiguous, in dtype
// (0 float32, 1 bfloat16, 2 float16); bias fp32 or null, element (b, i, j)
// at b * bias_bstride + i * bias_qstride + j (a stride of 0 broadcasts);
// lse and delta (bh, sq) fp32.  window <= 0 means no band; the band applies
// only with causal.  seed_vec, drop_thresh and drop_scale as for
// apex_flash_fwd (null: no dropout).  Returns the cudaError_t of the launch.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                 long long bias_bstride, long long bias_qstride,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int bh, int sq, int sk, int d, float scale,
                                 int causal, int window, const void* seed_vec,
                                 unsigned int drop_thresh, float drop_scale, int dtype,
                                 void* stream) {
  const Args a{q, k, v, static_cast<const float*>(bias), bias_bstride, bias_qstride, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
               nullptr, nullptr, bh, sq, sk, d, scale, causal, window,
               static_cast<const int*>(seed_vec), drop_thresh, drop_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, false);
}

// As apex_flash_bwd_dq, writing dk and dv (bh, sk, d) in dtype.
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* bias, long long bias_bstride,
                                  long long bias_qstride, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int bh, int sq,
                                  int sk, int d, float scale, int causal, int window,
                                  const void* seed_vec, unsigned int drop_thresh,
                                  float drop_scale, int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(bias), bias_bstride, bias_qstride, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr,
               dk, dv, bh, sq, sk, d, scale, causal, window,
               static_cast<const int*>(seed_vec), drop_thresh, drop_scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, true);
}
