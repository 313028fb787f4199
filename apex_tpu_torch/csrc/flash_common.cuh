// The masking convention of the flash-attention kernels, in one place: the
// forward (flash_attention.cu) and both backward kernels
// (flash_attention_bwd.cu) compute every score through score() and pick
// their tiles through key_range() / query_range(), so the three cannot
// drift apart.  The convention is apex_tpu/kernels/attention.py's
// (_mask_block, _block_has_unmasked): the scale multiplies q.k^T, an
// additive fp32 bias comes next, the causal mask is top-left aligned
// (row >= col) and the Mistral band keeps col > row - window, masked
// scores are the finite -1e30; keys past Sk are left out altogether (-inf).
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool masked_out(int gi, int gj, int causal, int window) {
  return causal && (gj > gi || (window > 0 && gj <= gi - window));
}

// the score of query row gi against key gj from their dot product; brow is
// the bias row of gi (null without a bias)
__device__ __forceinline__ float score(float dot, float scale, const float* brow, int gi,
                                       int gj, int sk, int causal, int window) {
  if (gj >= sk) return -INFINITY;  // past the keys: no weight, even in a fully masked row
  float x = dot * scale;
  if (brow != nullptr) x += brow[gj];
  return masked_out(gi, gj, causal, window) ? NEG : x;
}

// the keys [*kbeg, *kend) that hold an unmasked entry for some row of the
// query tile starting at q0
__device__ __forceinline__ void key_range(int q0, int sk, int causal, int window, int* kbeg,
                                          int* kend) {
  *kbeg = 0;
  *kend = sk;
  if (causal) {
    *kend = min(sk, q0 + BQ);
    if (window > 0) *kbeg = max(0, q0 - window + 1);
  }
}

// the query rows [*qbeg, *qend) that hold an unmasked entry for some key of
// the key tile starting at k0
__device__ __forceinline__ void query_range(int k0, int sq, int sk, int causal, int window,
                                            int* qbeg, int* qend) {
  *qbeg = 0;
  *qend = sq;
  if (causal) {
    *qbeg = min(sq, k0);
    if (window > 0) *qend = min(sq, min(sk, k0 + BK) - 1 + window);
  }
}

// max / sum over the 16 lanes of a half-warp (the 16 threads of one row)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
