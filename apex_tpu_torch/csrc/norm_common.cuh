// The row layout shared by the LayerNorm and RMSNorm kernels
// (layer_norm.cu, rms_norm.cu): a row of n <= 1024 belongs to one warp,
// four rows to a 128-thread block; a longer row to a 256- or 1024-thread
// block.  Each thread holds VPT values at a stride of the row's TPR
// threads.
#pragma once

#include "common.cuh"

namespace {

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

// The number of blocks (and rows of partial column sums) a backward kernel
// runs for a (rows, n) input on the current device: two per SM, so that
// all are resident at once, and no more than the rows need.
inline int norm_bwd_parts(int rows, int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int rpc = n <= 1024 ? 4 : 1;
  const int need = (rows + rpc - 1) / rpc;
  return need < 2 * sms ? (need > 0 ? need : 1) : 2 * sms;
}

}  // namespace
