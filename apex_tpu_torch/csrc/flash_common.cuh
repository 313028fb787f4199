// The masking convention of the flash-attention kernels, in one place: the
// forward (flash_attention.cu) and both backward kernels
// (flash_attention_bwd.cu), and the tensor-core route's three
// (flash_attention_tc.cu), compute every score through score() and pick
// their tiles through key_range() / query_range() at their own tile heights,
// so the routes cannot drift apart.  The convention is apex_tpu/kernels/attention.py's
// (_mask_block, _block_has_unmasked): the scale multiplies q.k^T, an
// additive fp32 bias comes next, the causal mask is top-left aligned
// (row >= col) and the Mistral band keeps col > row - window, masked
// scores are the finite -1e30; keys past Sk are left out altogether (-inf).
//
// The attention dropout of the three kernels is here too: the counter-based
// hash of apex_tpu/kernels/attention.py (_hash_keep_u32, _mult_from_hash),
// a function of (seed, batch*head, global row, global column) alone, so the
// forward and both backward kernels regenerate the same mask whatever their
// tiling, and it equals the plain version's bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

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
// query tile [q0, q0 + bq)
__device__ __forceinline__ void key_range(int q0, int bq, int sk, int causal, int window,
                                          int* kbeg, int* kend) {
  *kbeg = 0;
  *kend = sk;
  if (causal) {
    *kend = min(sk, q0 + bq);
    if (window > 0) *kbeg = max(0, q0 - window + 1);
  }
}

// the query rows [*qbeg, *qend) that hold an unmasked entry for some key of
// the key tile [k0, k0 + bk)
__device__ __forceinline__ void query_range(int k0, int bk, int sq, int sk, int causal,
                                            int window, int* qbeg, int* qend) {
  *qbeg = 0;
  *qend = sq;
  if (causal) {
    *qbeg = min(sq, k0);
    if (window > 0) *qend = min(sq, min(sk, k0 + bk) - 1 + window);
  }
}

// whether the tile of query rows [q0, q0 + bq) and keys [k0, k0 + bk) holds
// an entry that score() masks or leaves out, or a row past Sq: false means
// every score of the tile is the scaled product plus the bias
__device__ __forceinline__ bool tile_masked(int q0, int bq, int k0, int bk, int sq, int sk,
                                            int causal, int window) {
  if (q0 + bq > sq || k0 + bk > sk) return true;
  return causal && (k0 + bk - 1 > q0 || (window > 0 && k0 <= q0 + bq - 1 - window));
}

// the murmur3-style finaliser of (row, col, batch*head, seed), in wrapping
// uint32 arithmetic
__device__ __forceinline__ uint32_t dropout_hash(uint32_t row, uint32_t col, uint32_t bh,
                                                 uint32_t seed) {
  uint32_t h = row * 0x9E3779B9u + col * 0x85EBCA6Bu + seed * 0xC2B2AE35u + bh * 0x27D4EB2Fu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// one block's view of the dropout: off when the seed vector is null, else
// the seed and the global offsets of row 0 and column 0 read from the
// device vector [seed, row_off, col_off], the block's batch*head index, and
// the keep threshold and 1 / (1 - p), both computed on the host exactly as
// the JAX package computes them
struct Dropout {
  bool on;
  uint32_t seed, row_off, col_off, bh, thresh;
  float scale;

  __device__ __forceinline__ Dropout(const int* seed_vec, int bh_, uint32_t thresh_,
                                     float scale_)
      : on(seed_vec != nullptr), seed(0), row_off(0), col_off(0),
        bh(static_cast<uint32_t>(bh_)), thresh(thresh_), scale(scale_) {
    if (on) {
      seed = static_cast<uint32_t>(seed_vec[0]);
      row_off = static_cast<uint32_t>(seed_vec[1]);
      col_off = static_cast<uint32_t>(seed_vec[2]);
    }
  }

  // the inverted-dropout multiplier of query row gi, key gj: 1 / (1 - p)
  // where the hash falls below the threshold, else 0
  __device__ __forceinline__ float mult(int gi, int gj) const {
    const uint32_t h = dropout_hash(row_off + static_cast<uint32_t>(gi),
                                    col_off + static_cast<uint32_t>(gj), bh, seed);
    return h < thresh ? scale : 0.f;
  }
};

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
