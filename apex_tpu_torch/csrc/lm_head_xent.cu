// Fused LM head + cross-entropy, forward and backward, for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces: apex_tpu/kernels/lm_head_xent.py::_fwd_impl :183 (Pallas kernel
// _fwd_kernel :61, pallas_call :192): per row i of x (N, E) the logits
// s_ij = x_i . w_j over the table w (V, E) are computed block by block and
// consumed at once by an online max / sum-exp and the target logit, so the
// (N, V) logits never reach device memory; out come loss_i = lse_i -
// s_{i,label_i} and lse_i in fp32.  A label outside [0, V) matches no
// column: its target term is 0.  And lm_head_xent.py::_bwd :214 (_dx_kernel
// :96, pallas_call :230; _demb_kernel :121, pallas_call :244): the logits
// are recomputed block by block, dl_ij = gm_i * (exp(s_ij - lse_i) -
// [j == label_i]), and dx = dl . w (N, E) in x's dtype and dw = dl^T . x
// (V, E) in w's dtype, one launch each.  Token rows >= N and vocabulary rows
// >= V contribute nothing.  Scratch is bounded by the tiles, never by N x V.
//
// Bound on the H100: operations.  The forward is 2NVE operations, each
// backward launch 4NVE (its logits and its product); the backward's least
// work is 6NVE, the logits once and both products.  At the Llama loss's
// (N, V, E) = (16368, 32000, 768) at the bf16 tensor-core rate (989
// TFLOP/s): 0.81 ms forward, 1.63 ms a backward launch, 2.44 ms the whole
// backward, against inputs of (N + V) E elements: thousands of operations a
// byte.
//
// Two routes, chosen by the caller before the launch (the `route` argument
// of each entry point; a route that cannot take the arguments returns
// cudaErrorInvalidValue, nothing falls back).
//
// The tensor-core route ("tc"): bf16, E a multiple of 8 and at most 768,
// 16-byte-aligned bases.  Every product is a bf16 x bf16 -> fp32
// wgmma.mma_async: a product of two bf16 values is exact in fp32, so the
// logits are the TPU kernels' (fp32 over the widened inputs) up to the order
// of the sums.
// - A CTA owns BM = 128 rows of one operand (tokens for the forward and dx,
//   vocabulary rows for dw) and keeps them in shared memory for its whole
//   life: 128 x 768 bf16 = 192 KB, TMA-copied once in 12 chunks of 64
//   columns.  It streams the other operand in tiles of BN = 64 rows, each a
//   sequence of 64-column chunks (8 KB), through a ring of 4 stages with
//   full/empty mbarriers.  Every tile is 128-byte swizzled by TMA, so the
//   same stage serves as a K-major B (the logits, trans-b 0) and as an
//   MN-major B (the dl product, trans-b 1).  Shared memory at E = 768:
//   230,472 bytes a block (dw 232,008, with its token vectors) of the
//   232,448 allowed, 1024 of them for alignment; one CTA an SM.
// - 384 threads: one producer warpgroup (one thread issues every TMA;
//   setmaxnreg 40) and two consumer warpgroups of 64 own rows each
//   (setmaxnreg 232; ptxas gives the kernel 168 registers a thread at
//   launch, no spills).  A consumer's logits tile is a 64 x 64 fp32
//   accumulator (32 registers a thread), 4 wgmma m64n64k16 a chunk, one
//   wgmma group in flight behind the one being issued.
// - Forward: the epilogue of each tile is the online softmax in registers:
//   the 4 threads of a quad share a row of the accumulator layout and
//   reduce its max by shuffles; the sum-exp and the target logit stay per
//   thread until the end; columns >= V are masked.  Grid: N / 128 CTAs (128
//   at the Llama shape, one wave of 132 SMs).
// - dx and dw: a CTA also owns an E slice of 256 columns of its output rows
//   (grid.y = E / 256) and accumulates it in registers for the whole stream:
//   4 x 32 fp32 a thread.  Each tile's logits are recomputed over the full
//   E, turned into dl in registers, rounded to bf16 and reused as the A
//   operand of the second product (the accumulator-to-A-fragment layout of
//   FlashAttention-3), against the stream tile's 4 chunks of the slice,
//   which the ring brings once more (12 + 4 chunks a tile).  Recompute
//   factor E / 256 = 3: each backward launch does 8NVE operations (6NVE of
//   logits, 2NVE of product) instead of 4NVE.  dw is the swapped grid: own
//   vocabulary rows, stream the tokens, whose lse, gm and labels the
//   consumers stage in shared memory once a tile.  One writer for every
//   output element, a fixed summation order, no atomics: two launches on
//   the same inputs give the same bits.
// Two variants were built, held equal to these kernels on the card, and
// measured slower there, so they are not kept: a cluster of E / 256 CTAs
// that splits the logits' K instead of recomputing it (each CTA's fp32
// partial logits, 32 KB a tile, summed through distributed shared memory:
// the exchange cost more than the recompute it saves), and issuing the
// next tile's wgmmas before a tile's epilogue (with 4 stages beside the
// 192 KB own tile, the ring drains while the epilogue runs).
// dl is computed in fp32 and rounded to bf16 only as the A operand: its
// relative rounding of 2^-9 bounds the error of dx and dw near 4e-3 of their
// largest entry.
//
// The SIMT route ("simt"): everything else (fp32, where tensor cores would
// compute TF32, a different function; fp16, where dl of order 1e-9 lies
// below fp16's range and would flush to 0; bf16 with E > 768, E % 8 != 0 or
// unaligned bases).  One 256-thread block owns 32 rows of one operand and
// streams the other 64 rows at a time; a tile of 32 x 64 logits is a loop
// over E in chunks of 32, both chunks staged in shared memory as fp32, each
// thread computing 2 x 4 logits with CUDA-core FMAs (67 TFLOP/s at best).
// - Forward: each row's 64 logits of a tile lie in 16 threads of one
//   half-warp, which reduce the tile's max and sum-exp by shuffles.
// - dx: each tile's dl goes to shared memory and is multiplied at once into
//   a (32, E) fp32 accumulator in shared memory (96 KB at E = 768); E above
//   1024 is split into slices of at most 1024 columns (grid.y), each slice
//   recomputing the logits.
// - dw: the swapped grid, one writer per dw row, no atomics.
// Token rows >= N and vocabulary rows >= V contribute nothing (the TPU
// kernels' gm = 0 / lse = 1e30 padding and p = 0 pad columns).

#include <stdint.h>

#include "hopper_common.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16): TMA, mbarriers and wgmma, written in PTX
// (the primitives are hopper_common.cuh's).
namespace tc {

constexpr int BM = 128;      // own rows a CTA: two consumer warpgroups of 64
constexpr int BN = 64;       // streamed rows a tile
constexpr int BK = 64;       // E chunk: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 4;    // ring of streamed chunks
constexpr int E_MAX = 768;   // the own tile stays resident: 128 x 768 bf16
constexpr int SLICE = 256;   // E columns of a backward CTA's accumulator
constexpr int THREADS = 384; // producer warpgroup + 2 consumer warpgroups
constexpr int OWN_CHUNK = BM * BK * 2;  // bytes: 16 KB
constexpr int STR_CHUNK = BN * BK * 2;  // bytes: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

enum Kind { FWD = 0, DX = 1, DW = 2 };

using namespace hop;

// Shared memory, from a 1024-byte-aligned base: the own tile (kc chunks of
// BM x BK), the ring (STAGES chunks of BN x BK), for dw the stream tile's
// lse * log2(e), gm and labels (two buffers of 3 x BN words), then the
// barriers: own_full, full[STAGES], empty[STAGES].
__host__ __device__ constexpr int vec_words(int kind) { return kind == DW ? 2 * 3 * BN : 0; }
__host__ __device__ constexpr int smem_bytes(int kind, int kc) {
  return 1024 + kc * OWN_CHUNK + STAGES * STR_CHUNK + 4 * vec_words(kind) + 8 * (1 + 2 * STAGES);
}

// The accumulator layout of wgmma m64nNk16 (fp32): in warp w of the
// warpgroup, lane l holds d[j] at row 16 w + l / 4 + 8 ((j / 2) % 2) and
// column 8 (j / 4) + 2 (l % 4) + j % 2.
template <int KIND>
__device__ __forceinline__ void lmx_tc_body(const CUtensorMap& own_map,
                                            const CUtensorMap& str_map,
                                            const int* __restrict__ lab,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ gm,
                                            float* __restrict__ loss_out,
                                            float* __restrict__ lse_out,
                                            __nv_bfloat16* __restrict__ out, int n, int v,
                                            int e) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int kc = (e + BK - 1) / BK;
  const uint32_t own_s = base;
  const uint32_t ring_s = own_s + kc * OWN_CHUNK;
  float* vec = reinterpret_cast<float*>(smem_raw + (ring_s + STAGES * STR_CHUNK - raw));
  const uint32_t own_full = ring_s + STAGES * STR_CHUNK + 4 * vec_words(KIND);
  const uint32_t full0 = own_full + 8, empty0 = full0 + 8 * STAGES;

  const int own_rows = KIND == DW ? v : n, str_rows = KIND == DW ? n : v;
  const int own0 = blockIdx.x * BM;
  const int e0 = blockIdx.y * SLICE;
  const int nq = KIND == FWD ? 0 : (min(SLICE, e - e0) + BK - 1) / BK;  // dl chunks a tile
  const int tiles = (str_rows + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: the own tile once, then every streamed chunk in the
    // order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      mbar_expect_tx(own_full, kc * OWN_CHUNK);
      for (int c = 0; c < kc; ++c) tma_load(own_s + c * OWN_CHUNK, &own_map, own_full, c * BK, own0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        const int s0 = t * BN;
        for (int c = 0; c < kc + nq; ++c) {
          const int col = c < kc ? c * BK : e0 + (c - kc) * BK;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, STR_CHUNK);
          tma_load(ring_s + stage * STR_CHUNK, &str_map, full0 + 8 * stage, col, s0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = tid - 128;              // consumer thread, 0..255
    const int cw = ct >> 7;                // consumer warpgroup
    const int lane = ct & 31;
    const int r0 = cw * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);  // own-tile row; + 8
    const int cq = 2 * (lane & 3);         // column within each group of 8
    const uint32_t a_off = cw * 64 * 128;  // this warpgroup's rows in an own chunk

    // per own row (h = 0, 1: rows r0, r0 + 8)
    int lb[2] = {-1, -1};
    float l2[2] = {0.f, 0.f}, g[2] = {0.f, 0.f};
    if constexpr (KIND != DW) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = own0 + r0 + 8 * h;
        if (row < n) {
          lb[h] = lab[row];
          if constexpr (KIND == DX) {
            l2[h] = lse[row] * LOG2E;
            g[h] = gm[row];
          }
        }
      }
    }
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};  // forward
    float acc[4][32];  // dx / dw: the E slice
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
    uint32_t a[4][4];  // dl as bf16 A fragments, 4 k-steps of 16 streamed rows
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;

    int stage = 0, pend = -1;
    uint32_t phase = 0;
    auto take = [&]() -> uint32_t {
      mbar_wait(full0 + 8 * stage, phase);
      return ring_s + stage * STR_CHUNK;
    };
    // after a chunk's wgmmas: keep that group in flight, release the stage
    // of the one before it
    auto next = [&]() {
      wg_commit();
      wg_wait<1>();
      if (pend >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pend);
      pend = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto drain = [&]() {
      wg_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * pend);
      pend = -1;
    };

    mbar_wait(own_full, 0);
    for (int t = 0; t < tiles; ++t) {
      const int j0 = t * BN;
      float my_l2 = 0.f, my_g = 0.f;
      int my_lb = -1;
      if (KIND == DW && ct < BN && j0 + ct < n) {
        my_l2 = lse[j0 + ct] * LOG2E;
        my_g = gm[j0 + ct];
        my_lb = lab[j0 + ct];
      }
      // the logits tile: own rows x streamed rows [j0, j0 + BN), over E
      fence_regs(s);
      for (int c = 0; c < kc; ++c) {
        const uint32_t b = take();
        wg_fence();
        const uint64_t da = desc(own_s + c * OWN_CHUNK + a_off), db = desc(b);
#pragma unroll
        for (int k = 0; k < 4; ++k) mma_ss<__nv_bfloat16>(s, da + 2 * k, db + 2 * k, c > 0 || k > 0);
        next();
      }
      drain();
      fence_regs(s);

      if constexpr (KIND == FWD) {
        float mx[2] = {-1e30f, -1e30f};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int h = (j >> 1) & 1, col = j0 + 8 * (j >> 2) + cq + (j & 1);
          if (col < v) {
            if (col == lb[h]) tg[h] += s[j];
          } else {
            s[j] = -1e30f;
          }
          mx[h] = fmaxf(mx[h], s[j]);
        }
        float mb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(m[h], mx[h]);
          l[h] *= ex2((m[h] - m_new) * LOG2E);
          m[h] = m_new;
          mb[h] = m_new * LOG2E;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int h = (j >> 1) & 1;
          l[h] += ex2(fmaf(s[j], LOG2E, -mb[h]));
        }
      } else {
        if constexpr (KIND == DW) {
          float* buf = vec + (t & 1) * 3 * BN;
          if (ct < BN) {
            buf[ct] = my_l2;
            buf[BN + ct] = my_g;
            reinterpret_cast<int*>(buf)[2 * BN + ct] = my_lb;
          }
          asm volatile("bar.sync 1, 256;" ::: "memory");
        }
        const float* buf = vec + (t & 1) * 3 * BN;
        // dl = gm (exp(s - lse) - onehot), fp32, then bf16 A fragments
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 8 * k + 2 * i, h = i & 1;
            const int cl = 8 * (2 * k + (i >> 1)) + cq;  // tile column of s[j]
            float d[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float p, gg;
              bool hit;
              if constexpr (KIND == DX) {
                const int col = j0 + cl + u;
                p = ex2(fmaf(s[j + u], LOG2E, -l2[h]));
                gg = col < v ? g[h] : 0.f;
                hit = col == lb[h];
              } else {
                p = ex2(fmaf(s[j + u], LOG2E, -buf[cl + u]));
                gg = buf[BN + cl + u];
                hit = own0 + r0 + 8 * h == reinterpret_cast<const int*>(buf)[2 * BN + cl + u];
              }
              d[u] = gg * (p - (hit ? 1.f : 0.f));
            }
            a[k][i] = pack2<__nv_bfloat16>(d[0], d[1]);
          }
        // acc[q] += dl . (streamed rows x E columns [e0 + 64 q, + 64))
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < nq) {
            const uint32_t b = take();
            wg_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) mma_rs<__nv_bfloat16>(acc[q], a[k], desc(b + k * 2048));
            next();
          }
        }
        drain();
        fence_regs(a);
      }
    }

    if constexpr (KIND == FWD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lh = l[h], th = tg[h];
        lh += __shfl_xor_sync(0xffffffffu, lh, 1);
        lh += __shfl_xor_sync(0xffffffffu, lh, 2);
        th += __shfl_xor_sync(0xffffffffu, th, 1);
        th += __shfl_xor_sync(0xffffffffu, th, 2);
        const int row = own0 + r0 + 8 * h;
        if ((lane & 3) == 0 && row < n) {
          const float ls = m[h] + logf(lh);
          lse_out[row] = ls;
          loss_out[row] = ls - th;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_regs(acc[q]);
        if (q < nq) {
#pragma unroll
          for (int j = 0; j < 32; j += 2) {
            const long long row = own0 + r0 + 8 * ((j >> 1) & 1);
            const int col = e0 + 64 * q + 8 * (j >> 2) + cq;
            if (row < own_rows && col < e)
              *reinterpret_cast<uint32_t*>(out + row * e + col) = pack2<__nv_bfloat16>(acc[q][j], acc[q][j + 1]);
          }
        }
      }
    }
  }
}

// the three kernels, under names of their own for the profiler
__global__ void __launch_bounds__(THREADS, 1)
lmx_fwd_tc(__grid_constant__ const CUtensorMap own_map, __grid_constant__ const CUtensorMap str_map,
           const int* __restrict__ lab, float* __restrict__ loss, float* __restrict__ lse,
           int n, int v, int e) {
  lmx_tc_body<FWD>(own_map, str_map, lab, nullptr, nullptr, loss, lse, nullptr, n, v, e);
}

__global__ void __launch_bounds__(THREADS, 1)
lmx_dx_tc(__grid_constant__ const CUtensorMap own_map, __grid_constant__ const CUtensorMap str_map,
          const int* __restrict__ lab, const float* __restrict__ lse,
          const float* __restrict__ gm, __nv_bfloat16* __restrict__ dx, int n, int v, int e) {
  lmx_tc_body<DX>(own_map, str_map, lab, lse, gm, nullptr, nullptr, dx, n, v, e);
}

__global__ void __launch_bounds__(THREADS, 1)
lmx_dw_tc(__grid_constant__ const CUtensorMap own_map, __grid_constant__ const CUtensorMap str_map,
          const int* __restrict__ lab, const float* __restrict__ lse,
          const float* __restrict__ gm, __nv_bfloat16* __restrict__ dw, int n, int v, int e) {
  lmx_tc_body<DW>(own_map, str_map, lab, lse, gm, nullptr, nullptr, dw, n, v, e);
}

// rows x e bf16, row-major, cut into boxes of BK columns x box_rows rows,
// 128-byte swizzled; elements outside the tensor read as 0
cudaError_t make_map(CUtensorMap* map, const void* p, int rows, int e, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(e), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(e) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// what the route takes: bf16, E % 8 == 0 (16-byte rows), E <= E_MAX (the
// resident own tile), 16-byte-aligned bases
bool takes(const void* x, const void* w, int e, int dtype) {
  return dtype == DT_BF16 && e % 8 == 0 && e <= E_MAX &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

template <int KIND>
cudaError_t launch(const void* x, const void* w, const int* lab, const float* lse,
                   const float* gm, float* loss, float* lse_out, void* out, int n, int v, int e,
                   cudaStream_t st) {
  const int own_rows = KIND == DW ? v : n, str_rows = KIND == DW ? n : v;
  CUtensorMap own_map, str_map;
  cudaError_t err = make_map(&own_map, KIND == DW ? w : x, own_rows, e, BM);
  if (err != cudaSuccess) return err;
  err = make_map(&str_map, KIND == DW ? x : w, str_rows, e, BN);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(KIND, (e + BK - 1) / BK);
  const dim3 grid((own_rows + BM - 1) / BM, KIND == FWD ? 1 : (e + SLICE - 1) / SLICE);
  if constexpr (KIND == FWD) {
    err = cudaFuncSetAttribute(lmx_fwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    lmx_fwd_tc<<<grid, THREADS, smem, st>>>(own_map, str_map, lab, loss, lse_out, n, v, e);
  } else {
    auto kernel = KIND == DX ? lmx_dx_tc : lmx_dw_tc;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, st>>>(own_map, str_map, lab, lse, gm,
                                        static_cast<__nv_bfloat16*>(out), n, v, e);
  }
  return cudaGetLastError();
}

}  // namespace tc

// Routes of the entry points: 0 the SIMT kernels (any dtype and shape), 1 the
// tensor-core kernels (tc::takes).  A route that cannot take the arguments
// returns cudaErrorInvalidValue.
constexpr int ROUTE_SIMT = 0, ROUTE_TC = 1;

}  // namespace

// x (n, e) and w (v, e) contiguous, both in dtype (0 float32, 1 bfloat16,
// 2 float16); lab (n,) int32; loss, lse (n,) float32.  Returns the
// cudaError_t of the launch.
extern "C" int apex_lmx_fwd(const void* x, const void* w, const void* lab, void* loss,
                            void* lse, int n, int v, int e, int dtype, int route,
                            void* stream) {
  const int* lb = static_cast<const int*>(lab);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  if (route == ROUTE_TC) {
    if (!tc::takes(x, w, e, dtype)) return cudaErrorInvalidValue;
    return tc::launch<tc::FWD>(x, w, lb, nullptr, nullptr, lo, ls, nullptr, n, v, e, st);
  }
  if (route != ROUTE_SIMT) return cudaErrorInvalidValue;
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
                               int route, void* stream) {
  const int* lb = static_cast<const int*>(lab);
  const float* ls = static_cast<const float*>(lse);
  const float* g = static_cast<const float*>(gm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  if (route == ROUTE_TC) {
    if (!tc::takes(x, w, e, dtype)) return cudaErrorInvalidValue;
    return tc::launch<tc::DX>(x, w, lb, ls, g, nullptr, nullptr, dx, n, v, e, st);
  }
  if (route != ROUTE_SIMT) return cudaErrorInvalidValue;
  return dispatch_bwd<false>(x, w, lb, ls, g, dx, n, v, e, dtype, st);
}

extern "C" int apex_lmx_bwd_dw(const void* x, const void* w, const void* lab, const void* lse,
                               const void* gm, void* dw, int n, int v, int e, int dtype,
                               int route, void* stream) {
  const int* lb = static_cast<const int*>(lab);
  const float* ls = static_cast<const float*>(lse);
  const float* g = static_cast<const float*>(gm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || v <= 0 || e <= 0) return cudaErrorInvalidValue;
  if (route == ROUTE_TC) {
    if (!tc::takes(x, w, e, dtype)) return cudaErrorInvalidValue;
    return tc::launch<tc::DW>(x, w, lb, ls, g, nullptr, nullptr, dw, n, v, e, st);
  }
  if (route != ROUTE_SIMT) return cudaErrorInvalidValue;
  return dispatch_bwd<true>(x, w, lb, ls, g, dw, n, v, e, dtype, st);
}

// Bytes of dynamic shared memory a tensor-core launch takes: kind 0 the
// forward, 1 dx, 2 dw.
extern "C" int apex_lmx_tc_smem(int kind, int e) {
  return tc::smem_bytes(kind, (e + tc::BK - 1) / tc::BK);
}
