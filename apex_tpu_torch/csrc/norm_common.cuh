// The row layout shared by the LayerNorm and RMSNorm kernels
// (layer_norm.cu, rms_norm.cu): a row of n <= 1024 belongs to one warp,
// four rows to a 128-thread block; a longer row to a 256- or 1024-thread
// block.  The scalar route's threads hold VPT values at a stride of the
// row's TPR threads; the vec route's hold 16-byte chunks at a stride of TPR
// chunks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

// route codes of the entry points (apex_{ln,rms}_{fwd,bwd,bwd_parts}):
// scalar, one element per access, any n and alignment; vec, 16-byte
// accesses, for n a multiple of 16 bytes' worth of x's dtype and 16-byte
// aligned rows (x, y; g, dx) and parameters
constexpr int NORM_SCALAR = 0, NORM_VEC = 1;

// where a vec kernel holds the affine parameters (a template argument, so
// that no kernel tests for them at run time): none (the plain form), in
// shared memory as fp32 (staged once a block), or in registers
constexpr int PARAMS_NONE = 0, PARAMS_SHARED = 1, PARAMS_REGS = 2;

// Sum over the TPR threads of one row: shuffles inside each warp, then, for a
// row spread over several warps, one partial per warp through shared memory.
template <int WPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (WPR > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // the previous reduction's reads of red are done
    if (lane == 0) red[warp] = s;
    __syncthreads();
    s = 0.f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) s += red[i];
  }
  return s;
}

template <int TPR>
struct Shape {
  static constexpr int RPC = TPR >= 128 ? 1 : 128 / TPR;  // rows per block
  static constexpr int WPR = TPR / 32;                     // warps per row
};

// The (VPT, TPR) of a row of n values, as the statements that end a
// dispatch function: return LAUNCH(VPT, TPR), a macro naming one launch, or
// cudaErrorInvalidValue for n > 16384.
#define APEX_NORM_BY_ROW(n, LAUNCH)         \
  if ((n) <= 128) return LAUNCH(4, 32);     \
  if ((n) <= 256) return LAUNCH(8, 32);     \
  if ((n) <= 512) return LAUNCH(16, 32);    \
  if ((n) <= 768) return LAUNCH(24, 32);    \
  if ((n) <= 1024) return LAUNCH(32, 32);   \
  if ((n) <= 2048) return LAUNCH(8, 256);   \
  if ((n) <= 4096) return LAUNCH(16, 256);  \
  if ((n) <= 8192) return LAUNCH(32, 256);  \
  if ((n) <= 16384) return LAUNCH(16, 1024); \
  return cudaErrorInvalidValue

// The number of blocks (and rows of partial column sums) the scalar
// route's backward kernel runs for a (rows, n) input on the current device:
// two per SM, so that all are resident at once, and no more than the rows
// need.
inline int norm_bwd_parts(int rows, int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int rpc = n <= 1024 ? 4 : 1;
  const int need = (rows + rpc - 1) / rpc;
  return need < 2 * sms ? (need > 0 ? need : 1) : 2 * sms;
}

// ---------------------------------------------------------------------------
// the vec route: 16-byte chunks of a row
// ---------------------------------------------------------------------------

// values of T in one 16-byte chunk
template <typename T>
__host__ __device__ constexpr int chunk_len() { return 16 / int(sizeof(T)); }

// chunks a thread holds for the scalar route's (VPT, TPR): VPT values, at
// least one chunk
template <typename T>
__host__ __device__ constexpr int chunks_per_thread(int vpt) {
  return vpt * int(sizeof(T)) / 16 > 0 ? vpt * int(sizeof(T)) / 16 : 1;
}

template <typename T> __device__ __forceinline__ T from_bits(unsigned short b);
template <> __device__ __forceinline__ __nv_bfloat16 from_bits(unsigned short b) {
  return __ushort_as_bfloat16(b);
}
template <> __device__ __forceinline__ __half from_bits(unsigned short b) {
  return __ushort_as_half(b);
}
__device__ __forceinline__ unsigned to_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned to_bits(__half v) { return __half_as_ushort(v); }

// fp32 values of W 32-bit words of T, lowest address first
template <typename T, int W>
__device__ __forceinline__ void unpack(const unsigned* w, float* f) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (sizeof(T) == 4) {
      f[j] = __uint_as_float(w[j]);
    } else {
      f[2 * j] = to_f(from_bits<T>(static_cast<unsigned short>(w[j] & 0xffffu)));
      f[2 * j + 1] = to_f(from_bits<T>(static_cast<unsigned short>(w[j] >> 16)));
    }
  }
}

template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  unpack<T, 4>(w, f);
}

// one 16-byte chunk of T from chunk_len<T>() fp32 values, each rounded once
template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4)
      w[j] = __float_as_uint(f[j]);
    else
      w[j] = to_bits(from_f<T>(f[2 * j])) | (to_bits(from_f<T>(f[2 * j + 1])) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The statements `...` with P the type of dtype's code (a parameter
// vector's): the dtype is switched on once, outside the loops that read
// the vector, so their loads issue together.  The statements call
// __forceinline__ functions (a pragma cannot stand in a macro argument).
#define APEX_PARAM_SWITCH(dtype, P, ...)                            \
  switch (dtype) {                                                  \
    case DT_BF16: { using P = __nv_bfloat16; __VA_ARGS__; } break;  \
    case DT_F16: { using P = __half; __VA_ARGS__; } break;          \
    default: { using P = float; __VA_ARGS__; }                      \
  }

// the L values of a parameter vector of P from element i0 (a multiple of
// L, the base 16-byte aligned), as fp32: L = 4 or 8, so the chunk is 8 to
// 32 bytes, read in 8- or 16-byte loads
template <int L, typename P>
__device__ __forceinline__ void load_param_chunk(const P* p, int i0, float* f) {
  if constexpr (sizeof(P) == 4) {
    const uint4* q = reinterpret_cast<const uint4*>(p + i0);
#pragma unroll
    for (int j = 0; j < L / 4; ++j) unpack_chunk<float>(__ldg(q + j), f + 4 * j);
  } else if constexpr (L == 8) {
    unpack_chunk<P>(__ldg(reinterpret_cast<const uint4*>(p + i0)), f);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + i0));
    const unsigned w[2] = {u.x, u.y};
    unpack<P, 2>(w, f);
  }
}

// a thread's CPT chunks of a parameter vector q (chunk tid + i * TPR,
// those past `chunks` left untouched), as fp32
template <int L, int CPT, int TPR, typename P>
__device__ __forceinline__ void load_param_row(const P* q, int chunks, float (&f)[CPT][L]) {
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * TPR;
    if (c < chunks) load_param_chunk<L>(q, c * L, f[i]);
  }
}

// a thread's CPT chunks of one row: chunk tid + i * TPR, those past the
// row's `chunks` left untouched
template <int CPT, int TPR>
__device__ __forceinline__ void load_row(const uint4* __restrict__ xr, int chunks,
                                         uint4 (&u)[CPT]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * TPR;
    if (c < chunks) u[i] = __ldg(xr + c);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The vec route's grid for a (rows, n) input: as many blocks as are
// resident at once on the current device (`per_sm` of them an SM), and no
// more than the rows need.  Each row stream (a warp, or a block for
// n > 1024) walks rows at a grid stride.
inline cudaError_t norm_vec_grid(int rows, int rpc, int per_sm, int* grid) {
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int need = (rows + rpc - 1) / rpc;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int blocks = per_sm * sms;
  *grid = need < blocks ? need : blocks;
  return cudaSuccess;
}

// The vec route's copy of an affine parameter vector q, staged by the
// whole block (THREADS threads) before it walks its rows: read 16 bytes at
// a time in its own dtype, kept as fp32 in shared memory in L / 4 planes
// of float4, plane j holding values 4j..4j+3 of each chunk (chunk c at
// float4 j * SLOTS + c, SLOTS the most chunks of the row layout), so that
// a warp's reads of one plane are conflict-free and every offset from a
// thread's first chunk is a constant.
template <int L, int SLOTS, int THREADS, typename P>
__device__ __forceinline__ void stage_param(const P* q, int chunks, float4* s) {
#pragma unroll 1  // one or two passes (a 16384-wide row)
  for (int c = threadIdx.y * blockDim.x + threadIdx.x; c < chunks; c += THREADS) {
    float f[L];
    load_param_chunk<L>(q, c * L, f);
#pragma unroll
    for (int j = 0; j < L / 4; ++j)
      s[j * SLOTS + c] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
  }
}

// chunk c of a staged parameter vector (stage_param), as L fp32 values
template <int L, int SLOTS>
__device__ __forceinline__ void load_staged(const float4* s, int c, float* f) {
#pragma unroll
  for (int j = 0; j < L / 4; ++j) {
    const float4 q = s[j * SLOTS + c];
    f[4 * j] = q.x, f[4 * j + 1] = q.y, f[4 * j + 2] = q.z, f[4 * j + 3] = q.w;
  }
}

// The vec backward's dynamic shared memory: the weight's staged planes
// (stage_param) while the row streams walk their rows, then the RPC
// streams' column sums of one accumulator (write_col_partials), the larger.
template <typename T, int CPT, int TPR>
constexpr int norm_bwd_vec_smem() {
  return Shape<TPR>::RPC * CPT * TPR * chunk_len<T>() * int(sizeof(float));
}

// One row of a vec backward block's partial column sums: each row stream
// (threadIdx.y) holds the fp32 sums a[i][j] of columns (tid + i * TPR) * L
// + j over its rows; the block's RPC streams add theirs in a fixed order
// (stream 0 first) and write them to `part` (n fp32 values, 16-byte
// aligned) in 16-byte stores.  `buf` is the block's norm_bwd_vec_smem
// bytes, free on entry (the caller synchronises first) and on exit; the
// streams' sums go through it as float4 planes (stage_param's layout), so
// the writes and the sums' reads are conflict-free.
template <int L, int CPT, int TPR, int RPC>
__device__ __forceinline__ void write_col_partials(const float (&a)[CPT][L], float4* buf,
                                                   float* __restrict__ part, int chunks) {
  constexpr int SLOTS = CPT * TPR, Q = L / 4 * SLOTS;  // float4s a stream
  const int tid = threadIdx.x;
  float4* out = reinterpret_cast<float4*>(part);
  if constexpr (RPC == 1) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * TPR;
      if (c < chunks) {
#pragma unroll
        for (int j = 0; j < L / 4; ++j)
          out[c * (L / 4) + j] =
              make_float4(a[i][4 * j], a[i][4 * j + 1], a[i][4 * j + 2], a[i][4 * j + 3]);
      }
    }
  } else {
    float4* mine = buf + threadIdx.y * Q;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
#pragma unroll
      for (int j = 0; j < L / 4; ++j)
        mine[j * SLOTS + tid + i * TPR] =
            make_float4(a[i][4 * j], a[i][4 * j + 1], a[i][4 * j + 2], a[i][4 * j + 3]);
    }
    __syncthreads();
    for (int q = threadIdx.y * TPR + tid; q < Q; q += RPC * TPR) {
      const int c = q % SLOTS, j = q / SLOTS;
      if (c < chunks) {
        float4 s = buf[q];
#pragma unroll
        for (int r = 1; r < RPC; ++r) {
          const float4 t = buf[r * Q + q];
          s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
        }
        out[c * (L / 4) + j] = s;
      }
    }
    __syncthreads();
  }
}

// The backwards' column sums: dst[c] = the sum over p of src[p, c] for a
// (parts, n) fp32 workspace, rounded once to odt.  SUM_COLS columns a
// block, SUM_ROWS threads down each column (a warp reads two 64-byte row
// segments), then a fixed-order tree over the SUM_ROWS partial sums through
// shared memory: deterministic, and twice the blocks and half the chain of
// dependent loads a thread that 32 columns of 32 threads give.
constexpr int SUM_COLS = 16, SUM_ROWS = 64;

__device__ __forceinline__ void sum_columns(const float* __restrict__ src, void* __restrict__ dst,
                                            int parts, int n, int odt) {
  __shared__ float red[SUM_ROWS][SUM_COLS + 1];
  // launched as the row kernel's programmatic dependent (launch_dependent):
  // wait until that grid is complete and its partials are visible (a no-op
  // for an ordinary launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int c = blockIdx.x * SUM_COLS + threadIdx.x;
  float s = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += SUM_ROWS) s += src[(long long)p * n + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int h = SUM_ROWS / 2; h > 0; h >>= 1) {
    if (threadIdx.y < h) red[threadIdx.y][threadIdx.x] += red[threadIdx.y + h][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < n) store_from_f(dst, c, red[0][threadIdx.x], odt);
}

// Launch a column-sum kernel as a programmatic dependent of the kernel
// before it on the stream (Hopper's programmatic dependent launch): its
// blocks may be scheduled while the row kernel's last blocks run, and wait
// in sum_columns until that grid is complete.  No state is left behind.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t st,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The resident blocks an SM holds of a vec kernel at `threads` a block and
// `smem` bytes of dynamic shared memory (the most its widest row stages),
// after allowing it that much; 0 if the runtime refuses.
template <typename K>
inline int vec_blocks_per_sm(K kernel, int threads, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace
