// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: apex_tpu/kernels/attention.py::flash_attention_fwd (Pallas
// kernel _fwd_kernel): blockwise online-softmax attention with fp32 scores,
// softmax and accumulation, returning out (in q's dtype) and the per-row
// logsumexp (fp32).  Same masking conventions: the scale multiplies q.k^T,
// an additive fp32 bias broadcasts as (BH|1, Sq|1, Sk), causal masking is
// top-left aligned (row >= col), the Mistral band keeps col > row - window,
// and masked scores are the finite -1e30, so a row whose keys are all masked
// averages v uniformly.  Keys past Sk (the ragged last tile) are left out of
// the softmax altogether, as in the plain reference.  The masking code is
// flash_common.cuh, shared with the backward kernels.  With dropout (a
// seed vector is given), each probability is multiplied by the hash mask's
// 1 / (1 - p) or 0 before it meets V, and only there: the running sum and
// the logsumexp keep the undropped probabilities, as the Pallas kernel's do.
//
// Bound on the H100: operations.  At GPT-2-small prefill (BH = 96, S = 512,
// D = 64, causal) the two products do 4 * D operations per unmasked
// (row, key) pair, 3.2 GFLOP, against 50 MB of q, k, v and out; with the
// math in fp32 on the CUDA cores (67 TFLOP/s) that is ~48 us of arithmetic
// against ~15 us of memory traffic.
//
// Design: one 256-thread block per (batch*head, 64-row query tile); blocks run
// in parallel, so the TPU's sequential k grid becomes a loop inside the block.
// The Q tile and each 64-key K/V tile are staged in shared memory as fp32
// (dynamic shared memory: 70 KB at D = 64, 119 KB at D = 128).  Each thread
// owns a 4 x 4 patch of the score tile and a 4 x (D/16) patch of the output
// accumulator, so the running max and sum of a row live in the 16 lanes of
// one half-warp and are combined with shuffles.  K tiles entirely above the
// diagonal, or entirely below the band, are never loaded.  Query tiles are
// issued from the last (the longest under causal masking) to the first.
// The products run as CUDA-core FMAs: this is the "simt" route, which
// takes fp32 and head dims other than 64; flash_attention_tc.cu is the
// tensor-core route for the rest.  The dropout hash costs ~12 integer
// operations per (row, key) pair against the 2 * D FMAs of the two
// products.

#include "flash_common.cuh"

namespace {

constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int SS = BK + 16;   // score-tile row stride in floats (no bank conflicts)

__host__ __device__ constexpr size_t smem_bytes(int d) {
  // Q and K tiles at a row stride of d + 1 (16 rows read in one column hit
  // 16 banks), the V tile at d, the score tile at SS
  return sizeof(float) * (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * SS);
}

// NE = output columns per thread: head dim d <= 16 * NE
template <typename T, int NE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, long long bias_bstride,
                 long long bias_qstride, T* __restrict__ out, float* __restrict__ lse,
                 int sq, int sk, int d, float scale, int causal, int window,
                 const int* __restrict__ seed_vec, uint32_t drop_thresh, float drop_scale) {
  extern __shared__ float smem[];
  const int qk_stride = d + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * qk_stride;
  float* Vs = Ks + BK * qk_stride;
  float* Ss = Vs + BK * d;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + (long long)bh * sq * d;
  const T* kb = k + (long long)bh * sk * d;
  const T* vb = v + (long long)bh * sk * d;
  const float* bb = bias == nullptr ? nullptr : bias + bh * bias_bstride;
  const Dropout drop(seed_vec, bh, drop_thresh, drop_scale);

  for (int idx = tid; idx < BQ * d; idx += NT) {
    const int r = idx / d, c = idx - r * d;
    Qs[r * qk_stride + c] = q0 + r < sq ? to_f(qb[(long long)(q0 + r) * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[r][e] = 0.f;
  }

  // the key tiles that hold an unmasked entry for some row of this tile
  int kbeg, kend;
  key_range(q0, BQ, sk, causal, window, &kbeg, &kend);
  const int jt0 = kbeg / BK, jt1 = (kend + BK - 1) / BK;

  for (int jt = jt0; jt < jt1; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the Q tile is in place; the last tile's reads are done
    for (int idx = tid; idx < BK * d; idx += NT) {
      const int r = idx / d, c = idx - r * d;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < sk) {
        const long long off = (long long)(k0 + r) * d + c;
        kv = to_f(kb[off]);
        vv = to_f(vb[off]);
      }
      Ks[r * qk_stride + c] = kv;
      Vs[r * d + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * qk_stride + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * qk_stride + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = q0 + ty + 16 * r;
      const float* brow = (bb != nullptr && gi < sq) ? bb + gi * bias_qstride : nullptr;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = score(s[r][c], scale, brow, gi, k0 + tx + 16 * c, sk, causal, window);
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ss[(ty + 16 * r) * SS + tx + 16 * c] = drop.on ? p * drop.mult(gi, k0 + tx + 16 * c) : p;
        ps += p;
      }
      l[r] = l[r] * alpha + half_warp_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

    const int jn = min(BK, sk - k0);
    for (int j = 0; j < jn; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ss[(ty + 16 * r) * SS + j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = tx + 16 * e;
        const float vv = c < d ? Vs[j * d + c] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][e] = fmaf(pv[r], vv, acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = q0 + ty + 16 * r;
    if (gi >= sq) continue;
    // l >= 1 whenever a tile was visited; l == 0 only for a row that no
    // tile reaches (a band that ends before the keys do)
    const float sl = l[r] == 0.f ? 1.f : l[r];
    T* orow = out + ((long long)bh * sq + gi) * d;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = tx + 16 * e;
      if (c < d) orow[c] = from_f<T>(acc[r][e] / sl);
    }
    if (tx == 0) lse[(long long)bh * sq + gi] = m[r] + logf(sl);
  }
}

template <typename T, int NE>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   long long bias_bstride, long long bias_qstride, void* out, float* lse,
                   int bh, int sq, int sk, int d, float scale, int causal, int window,
                   const int* seed_vec, uint32_t thresh, float drop_scale, cudaStream_t st) {
  // allow the largest tile set of this instantiation once (above 48 KB only
  // dynamic shared memory may be used, after this opt-in)
  static cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(16 * NE));
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, NE><<<grid, NT, smem_bytes(d), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      bias_bstride, bias_qstride, static_cast<T*>(out), lse, sq, sk, d, scale, causal,
      window, seed_vec, thresh, drop_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias,
                     long long bs, long long qs, void* out, float* lse, int bh, int sq,
                     int sk, int d, float scale, int causal, int window, const int* seed_vec,
                     uint32_t thresh, float drop_scale, cudaStream_t st) {
#define APEX_FLASH_FWD(NE)                                                                  \
  launch<T, NE>(q, k, v, bias, bs, qs, out, lse, bh, sq, sk, d, scale, causal, window,     \
                seed_vec, thresh, drop_scale, st)
  if (d <= 16) return APEX_FLASH_FWD(1);
  if (d <= 32) return APEX_FLASH_FWD(2);
  if (d <= 64) return APEX_FLASH_FWD(4);
  if (d <= 128) return APEX_FLASH_FWD(8);
#undef APEX_FLASH_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), contiguous, in dtype (0 float32,
// 1 bfloat16, 2 float16); bias fp32 or null, element (b, i, j) at
// b * bias_bstride + i * bias_qstride + j (a stride of 0 broadcasts);
// out like q; lse (bh, sq) fp32.  window <= 0 means no band; the band
// applies only with causal.  seed_vec: null for no dropout, else a device
// int32 vector [seed, row_off, col_off]; drop_thresh and drop_scale are the
// keep threshold min(int((1 - p) * 2^32), 2^32 - 1) and 1 / (1 - p) in
// float32.  Returns the cudaError_t of the launch.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                              long long bias_bstride, long long bias_qstride, void* out,
                              void* lse, int bh, int sq, int sk, int d, float scale,
                              int causal, int window, const void* seed_vec,
                              unsigned int drop_thresh, float drop_scale, int dtype,
                              void* stream) {
  const float* bf = static_cast<const float*>(bias);
  float* lf = static_cast<float*>(lse);
  const int* sv = static_cast<const int*>(seed_vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // grid.y counts query tiles and may not pass 65535
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || sq > 65535 * BQ) return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return dispatch<float>(q, k, v, bf, bias_bstride, bias_qstride, out, lf, bh, sq, sk, d, scale, causal, window, sv, drop_thresh, drop_scale, st);
    case DT_BF16: return dispatch<__nv_bfloat16>(q, k, v, bf, bias_bstride, bias_qstride, out, lf, bh, sq, sk, d, scale, causal, window, sv, drop_thresh, drop_scale, st);
    case DT_F16: return dispatch<__half>(q, k, v, bf, bias_bstride, bias_qstride, out, lf, bh, sq, sk, d, scale, causal, window, sv, drop_thresh, drop_scale, st);
    default: return cudaErrorInvalidValue;
  }
}
