// Fused LM head + cross-entropy, forward and backward, for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/kernels/lm_head_xent.py::_fwd_impl (Pallas kernel
// _fwd_kernel): per row i of x (N, E) the logits s_ij = x_i . w_j over the
// table w (V, E) are computed block by block and consumed at once by an
// online max / sum-exp and the target logit, so the (N, V) logits never
// reach device memory; out come loss_i = lse_i - s_{i,label_i} and lse_i in
// fp32.  A label outside [0, V) matches no column: its target term is 0.
// And apex_tpu/kernels/lm_head_xent.py::_bwd (Pallas kernels _dx_kernel and
// _demb_kernel): the logits are recomputed block by block,
// dl_ij = gm_i * (exp(s_ij - lse_i) - [j == label_i]), and
// dx = dl . w (N, E) in x's dtype and dw = dl^T . x (V, E) in w's dtype.
// Every product is fp32 over the inputs widened to fp32, as in the TPU
// kernels.
//
// Bound on the H100: operations.  The forward is 2NVE multiply-adds' worth
// of operations and each backward kernel 4NVE (the recomputed logits and
// the product), against inputs of (N + V) E elements: thousands of
// operations a byte.  This first version runs its products as fp32 FMAs on
// the CUDA cores (67 TFLOP/s at best), not on the tensor cores (989 TFLOP/s
// bf16), so it stays far from that bound; wgmma tiles are later work.
//
// Design.  One 256-thread block owns 32 rows of one operand (the "own"
// side) and streams the other operand 64 rows at a time; a tile of 32 x 64
// logits is a loop over E in chunks of 32, both chunks staged in shared
// memory as fp32 (transposed, padded against bank conflicts), each thread
// computing 2 x 4 logits in registers.
// - Forward: own = 32 token rows, stream = the vocabulary.  Each row's 64
//   logits of a tile lie in 16 threads of one half-warp, which reduce the
//   tile's max and sum-exp by shuffles and fold them into the row's running
//   (max, sum-exp) pair; columns >= V are skipped (the TPU kernel's -1e30).
// - dx: own = 32 token rows, stream = the vocabulary; each tile's dl goes to
//   shared memory and is multiplied at once into a (32, E) fp32 accumulator
//   that lives in shared memory for the whole vocabulary loop.  The TPU
//   kernel keeps a (256, E) accumulator in VMEM; 32 rows keep it within an
//   SM's 227 KB: 96 KB at E = 768.  E above 1024 is split into slices of
//   at most 1024 columns (grid.y), each slice recomputing the logits: at
//   E = 2048 / 4096 the logits GEMM runs 2 / 4 times instead of once.
// - dw: the swapped grid.  Own = 32 vocabulary rows, stream = the tokens; a
//   block loops over all token rows, so each dw row has one writer, no
//   atomics are needed and the summation order is fixed.
// Token rows >= N and vocabulary rows >= V contribute nothing (the TPU
// kernels' gm = 0 / lse = 1e30 padding and p = 0 pad columns).

#include "common.cuh"

namespace {

constexpr int OWN = 32;     // rows of the own side per block
constexpr int STR = 64;     // rows of the streamed side per tile
constexpr int BK = 32;      // E chunk of the logits product
constexpr int EC = 128;     // E chunk of the dl product
constexpr int ET_MAX = 1024;  // widest E slice a backward block accumulates
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

// The 32 x 64 tile of logits s[r][c] = sum_k own[o0 + r][k] * str[s0 + c][k]
// into acc[a][b] = s[2 * ty + a][tx + 16 * b] (ty = tid / 16, tx = tid % 16).
// as_ is BK x (OWN + 1) floats and bs is BK x (STR + 1); rows outside
// [0, n_own) / [0, n_str) and k >= e read as 0.
template <typename T>
__device__ __forceinline__ void logits_tile(const T* __restrict__ own, long long o0, int n_own,
                                            const T* __restrict__ str, long long s0, int n_str,
                                            int e, float (&acc)[2][4], float* as_, float* bs) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < e; k0 += BK) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int i = 0; i < OWN * BK / THREADS; ++i) {
      const int idx = tid + i * THREADS, r = idx / BK, k = idx % BK;
      const long long row = o0 + r;
      as_[k * (OWN + 1) + r] =
          (row < n_own && k0 + k < e) ? to_f(own[row * e + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < STR * BK / THREADS; ++i) {
      const int idx = tid + i * THREADS, c = idx / BK, k = idx % BK;
      const long long row = s0 + c;
      bs[k * (STR + 1) + c] =
          (row < n_str && k0 + k < e) ? to_f(str[row * e + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float a0 = as_[k * (OWN + 1) + 2 * ty], a1 = as_[k * (OWN + 1) + 2 * ty + 1];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float v = bs[k * (STR + 1) + tx + 16 * b];
        acc[0][b] = fmaf(a0, v, acc[0][b]);
        acc[1][b] = fmaf(a1, v, acc[1][b]);
      }
    }
  }
}

// reductions over the 16 threads (one half-warp) that hold one logits row
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lmx_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ lab,
               float* __restrict__ loss, float* __restrict__ lse_out, int n, int v, int e) {
  __shared__ float as_[BK * (OWN + 1)], bs[BK * (STR + 1)];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long row0 = (long long)blockIdx.x * OWN;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  int lb[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const long long r = row0 + 2 * ty + a;
    lb[a] = r < n ? lab[r] : -1;
  }
  for (int j0 = 0; j0 < v; j0 += STR) {
    float s[2][4];
    logits_tile(x, row0, n, w, j0, v, e, s, as_, bs);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float mx = NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = j0 + tx + 16 * b;
        if (c < v) {
          mx = fmaxf(mx, s[a][b]);
          if (c == lb[a]) t[a] += s[a][b];
        }
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      float se = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (j0 + tx + 16 * b < v) se += expf(s[a][b] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + half_sum(se);
      m[a] = m_new;
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float tt = half_sum(t[a]);  // one thread of the 16 holds it
    const long long r = row0 + 2 * ty + a;
    if (tx == 0 && r < n) {
      const float lse = m[a] + logf(l[a]);
      lse_out[r] = lse;
      loss[r] = lse - tt;
    }
  }
}

// dx (DW false: own = tokens, stream = vocabulary) or dw (DW true: own =
// vocabulary, stream = tokens) for the E slice [blockIdx.y * et, + et).
// Dynamic shared memory: acc 32 x (et + 8), dl 32 x 65, and a staging area
// shared by the logits chunks and the dl product's chunk of the streamed
// operand (64 x EC).
template <typename T, bool DW>
__device__ __forceinline__ void lmx_bwd_body(const T* __restrict__ x, const T* __restrict__ w,
                                             const int* __restrict__ lab,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ gm, T* __restrict__ out,
                                             int n, int v, int e, int et) {
  extern __shared__ float smem[];
  const int ld = et + 8;  // 2 * ld = 16 mod 32: a warp's two rows hit other banks
  float* acc = smem;
  float* dl = acc + OWN * ld;
  float* stage = dl + OWN * (STR + 1);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* own = DW ? w : x;
  const T* str = DW ? x : w;
  const int n_own = DW ? v : n, n_str = DW ? n : v;
  const long long o0 = (long long)blockIdx.x * OWN;
  const int e0 = blockIdx.y * et;
  const int ew = min(et, e - e0);

  for (int i = tid; i < OWN * ld; i += THREADS) acc[i] = 0.f;

  for (long long s0 = 0; s0 < n_str; s0 += STR) {
    float s[2][4];
    logits_tile(own, o0, n_own, str, s0, n_str, e, s, stage, stage + BK * (OWN + 1));
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = 2 * ty + a, c = tx + 16 * b;
        const long long tok = DW ? s0 + c : o0 + r, voc = DW ? o0 + r : s0 + c;
        float d = 0.f;
        if (tok < n && voc < v) {
          const float p = expf(s[a][b] - lse[tok]);
          d = gm[tok] * (p - (voc == lab[tok] ? 1.f : 0.f));
        }
        dl[r * (STR + 1) + c] = d;
      }
    // acc[r][:] += sum_c dl[r][c] * str[s0 + c][e0 + :], EC columns at a time
    for (int c0 = 0; c0 < ew; c0 += EC) {
      __syncthreads();  // dl is written; the staging area is free
#pragma unroll 4
      for (int i = 0; i < STR * EC / THREADS; ++i) {
        const int idx = tid + i * THREADS, c = idx / EC, k = idx % EC;
        const long long row = s0 + c;
        stage[c * EC + k] =
            (row < n_str && c0 + k < ew) ? to_f(str[row * e + e0 + c0 + k]) : 0.f;
      }
      __syncthreads();
      float u[2][EC / 16];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < EC / 16; ++q) {
          const int col = c0 + tx + 16 * q;
          u[a][q] = col < ew ? acc[(2 * ty + a) * ld + col] : 0.f;
        }
#pragma unroll 4
      for (int c = 0; c < STR; ++c) {
        const float d0 = dl[(2 * ty) * (STR + 1) + c], d1 = dl[(2 * ty + 1) * (STR + 1) + c];
#pragma unroll
        for (int q = 0; q < EC / 16; ++q) {
          const float sv = stage[c * EC + tx + 16 * q];
          u[0][q] = fmaf(d0, sv, u[0][q]);
          u[1][q] = fmaf(d1, sv, u[1][q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < EC / 16; ++q) {
          const int col = c0 + tx + 16 * q;
          if (col < ew) acc[(2 * ty + a) * ld + col] = u[a][q];
        }
    }
    __syncthreads();  // the dl product's reads of dl and stage are done
  }
  for (int i = tid; i < OWN * ew; i += THREADS) {
    const int r = i / ew, k = i % ew;
    const long long row = o0 + r;
    if (row < n_own) out[row * e + e0 + k] = from_f<T>(acc[r * ld + k]);
  }
}

// the two backward kernels, under names of their own for the profiler
template <typename T>
__global__ void __launch_bounds__(THREADS)
lmx_dx_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ lab,
              const float* __restrict__ lse, const float* __restrict__ gm, T* __restrict__ dx,
              int n, int v, int e, int et) {
  lmx_bwd_body<T, false>(x, w, lab, lse, gm, dx, n, v, e, et);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lmx_dw_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ lab,
              const float* __restrict__ lse, const float* __restrict__ gm, T* __restrict__ dw,
              int n, int v, int e, int et) {
  lmx_bwd_body<T, true>(x, w, lab, lse, gm, dw, n, v, e, et);
}

// the widths of the backward's E slices: as few slices as ET_MAX allows,
// each a multiple of 16 columns
int slice_width(int e) {
  const int slices = (e + ET_MAX - 1) / ET_MAX;
  const int et = (e + slices - 1) / slices;
  return (et + 15) / 16 * 16;
}

size_t bwd_smem_bytes(int et) {
  const int stage = BK * (OWN + 1) + BK * (STR + 1) > STR * EC
                        ? BK * (OWN + 1) + BK * (STR + 1) : STR * EC;
  return sizeof(float) * ((size_t)OWN * (et + 8) + OWN * (STR + 1) + stage);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int* lab, float* loss, float* lse,
                       int n, int v, int e, cudaStream_t st) {
  lmx_fwd_kernel<T><<<(n + OWN - 1) / OWN, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), lab, loss, lse, n, v, e);
  return cudaGetLastError();
}

template <typename T, bool DW>
cudaError_t launch_bwd(const void* x, const void* w, const int* lab, const float* lse,
                       const float* gm, void* out, int n, int v, int e, cudaStream_t st) {
  const int et = slice_width(e);
  const size_t smem = bwd_smem_bytes(et);
  auto kernel = DW ? lmx_dw_kernel<T> : lmx_dx_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((DW ? v : n) + OWN - 1) / OWN, (e + et - 1) / et);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(w), lab,
                                      lse, gm, static_cast<T*>(out), n, v, e, et);
  return cudaGetLastError();
}

template <bool DW>
cudaError_t dispatch_bwd(const void* x, const void* w, const int* lab, const float* lse,
                         const float* gm, void* out, int n, int v, int e, int dtype,
                         cudaStream_t st) {
  switch (dtype) {
    case DT_F32: return launch_bwd<float, DW>(x, w, lab, lse, gm, out, n, v, e, st);
    case DT_BF16: return launch_bwd<__nv_bfloat16, DW>(x, w, lab, lse, gm, out, n, v, e, st);
    case DT_F16: return launch_bwd<__half, DW>(x, w, lab, lse, gm, out, n, v, e, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, e) and w (v, e) contiguous, both in dtype (0 float32, 1 bfloat16,
// 2 float16); lab (n,) int32; loss, lse (n,) float32.  Returns the
// cudaError_t of the launch.
extern "C" int apex_lmx_fwd(const void* x, const void* w, const void* lab, void* loss,
                            void* lse, int n, int v, int e, int dtype, void* stream) {
  const int* lb = static_cast<const int*>(lab);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32: return launch_fwd<float>(x, w, lb, lo, ls, n, v, e, st);
    case DT_BF16: return launch_fwd<__nv_bfloat16>(x, w, lb, lo, ls, n, v, e, st);
    case DT_F16: return launch_fwd<__half>(x, w, lb, lo, ls, n, v, e, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's two launches.  x, w, lab, lse as above (lse from the
// forward); gm (n,) float32, the loss's incoming gradient per row; dx (n, e)
// and dw (v, e) in dtype.  Each returns the cudaError_t of its launch.
extern "C" int apex_lmx_bwd_dx(const void* x, const void* w, const void* lab, const void* lse,
                               const void* gm, void* dx, int n, int v, int e, int dtype,
                               void* stream) {
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  return dispatch_bwd<false>(x, w, static_cast<const int*>(lab),
                             static_cast<const float*>(lse), static_cast<const float*>(gm),
                             dx, n, v, e, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int apex_lmx_bwd_dw(const void* x, const void* w, const void* lab, const void* lse,
                               const void* gm, void* dw, int n, int v, int e, int dtype,
                               void* stream) {
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  return dispatch_bwd<true>(x, w, static_cast<const int*>(lab),
                            static_cast<const float*>(lse), static_cast<const float*>(gm),
                            dw, n, v, e, dtype, static_cast<cudaStream_t>(stream));
}
