// Flash attention, forward and backward, on Hopper's tensor cores (sm_90a),
// with a plain C interface: the "tc" route of the flash kernels.
//
// Replaces: apex_tpu/kernels/attention.py::flash_attention_fwd :352 (Pallas
// kernel _fwd_kernel :175, pallas_call :396) and flash_attention_bwd :420
// (_dq_kernel :237, pallas_call :466; _dkv_kernel :283, pallas_call :490),
// for bf16 and fp16 inputs with head dim 64 and 16-byte-aligned bases.  The
// wrapper (kernels/attention.py::flash_route) sends everything else to the
// CUDA-core kernels of flash_attention.cu and flash_attention_bwd.cu (the
// "simt" route); nothing falls back from one route to the other.
//
// The function is the simt route's, with the masking of flash_common.cuh
// (score(): the scale after q.k^T, the fp32 bias, the causal mask and the
// Mistral band at -1e30, keys past Sk at -inf; key_range() / query_range()
// pick the tiles; Dropout::mult() is the hash mask, a function of (seed,
// batch*head, row, column) alone, so this route's mask equals the plain one
// entry for entry whatever the tiling).  What the route rounds:
// - q.k^T and dO.v^T are products of two 16-bit values, exact in fp32, summed
//   in fp32 by the tensor cores: the plain version's scores up to the order
//   of the sums;
// - forward: p = exp(s - m) of the running row max m is summed in fp32 into
//   l (and lse = m + log l, of the undropped p); p * mult is rounded to the
//   input dtype only as the A operand of p.v;
// - backward: p = exp(s - lse) in fp32; dv += round(p * mult)^T . dO;
//   ds = p (dp * mult - delta) in fp32, rounded to the input dtype as the
//   operand of dq = ds . k and dk = ds^T . q; the scale is applied in fp32 at
//   the end.  FlashAttention-2/3 and cuDNN round the same operands; the JAX
//   kernels keep them in fp32.
// The exponentials are ex2.approx of (x - m) log2(e), the difference taken
// first: at a fully masked row x = m = -1e30 and the difference is 0, as in
// the plain version (an FMA of x log2(e) - m log2(e) would keep the rounding
// of m log2(e), ~1e23).
//
// Bound on the H100: operations.  At the GPT-2-small training shape (BH =
// 192, S = 1024, D = 64, causal) the forward is 4 D operations per unmasked
// pair, 25.8 GFLOP, 0.026 ms at the bf16 rate, against 101 MB of q, k, v,
// out and lse (0.030 ms): both bounds are near.  The backward's least work is
// 10 D per pair (s, dp, dv, dq, dk: 64.5 GFLOP, 0.065 ms); these two kernels
// do 14 D (90 GFLOP), because both recompute s and dp: dq 6 D (s, dp,
// ds.k), dk/dv 8 D (s^T, dp^T, p^T.dO, ds^T.q).
//
// Design: three warpgroups a CTA (384 threads, one CTA an SM).  Warpgroup 0
// is the producer (setmaxnreg 40): one thread issues every TMA load.  The
// other two are consumers (setmaxnreg 232) of 64 own rows each, so a CTA
// owns BM = 128 rows: queries for the forward and dq, keys for dk/dv.
// - Tensor maps: q, k, v and dO are 3-D maps (D, S, BH), boxes of 64 x 64 x
//   1, 128-byte swizzle (64 16-bit values are one swizzle row); rows past S
//   read as zeros inside their own head.  The own rows' boxes stay resident
//   (the forward's Q, 16 KB; dq's Q and dO, dk/dv's K and V, 32 KB); the
//   other side streams through a ring of STAGES stages, one 64-row tile of
//   two operands (16 KB) a stage, with full/empty mbarriers.  dk/dv's
//   stages also carry the tile's lse and delta, which the producer warp
//   writes to shared memory with plain loads and announces with its own
//   arrivals on the stage's full barrier.
// - Products, wgmma m64n64k16 (fp32 accumulators, 32 registers a thread):
//   s = Q.K^T, dp = dO.V^T (dq), s^T = K.Q^T, dp^T = V.dO^T (dk/dv), both
//   operands K-major in shared memory; then p (forward), ds (dq), p^T and
//   ds^T (dk/dv) are packed in registers as the A operand of the next
//   product (FlashAttention-3's register reuse) against the stage's other
//   tile as MN-major B (trans-b): O += P.V, dQ += dS.K, dV += P^T.dO,
//   dK += dS^T.Q.
// - Softmax in registers: each thread holds two rows of the 64 x 64 tile, 16
//   columns each; a row's max and sum are reduced over the 4 threads of a
//   quad.  Mask, bias and dropout are applied per accumulator element at the
//   (row, column) the fragment layout gives it.
// - Order: stream tiles with no unmasked entry for the CTA are never
//   loaded; a warpgroup skips the tiles it has none in (it still takes and
//   releases the stage).  Query tiles of the forward and dq are issued
//   longest first.  The backward is two kernels, dq over the keys and dk/dv
//   over the queries, with one writer for every output element and no
//   atomics: two launches on the same inputs give the same bits.
// Each consumer issues a tile's products and waits for them (no ping-pong of
// softmax and products between warpgroups, no persistent CTAs): simple and
// right first.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {
namespace ftc {

using namespace hop;

constexpr int HD = 64;          // the head dim the route takes
constexpr int BM = 128;         // own rows a CTA: two consumer warpgroups of 64
constexpr int BN = 64;          // streamed rows a tile
constexpr int STAGES = 4;       // ring of streamed tiles
constexpr int THREADS = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = BN * HD * 2;  // bytes of one 64 x 64 box of 16-bit values
constexpr float LOG2E = 1.4426950408889634f;

enum Kind { FWD = 0, DQ = 1, DKV = 2 };

struct Params {
  const float* bias;
  long long bstride, qstride;
  const float* lse;    // dq, dk/dv: the forward's
  const float* delta;  // dq, dk/dv: rowsum(dO * out)
  float* lse_out;      // forward
  void* out0;          // forward: out; dq: dq; dk/dv: dk
  void* out1;          // dk/dv: dv
  int sq, sk;
  float scale;
  int causal, window;
  const int* seed_vec;
  uint32_t thresh;
  float drop_scale;
};

// Shared memory from a 1024-byte-aligned base: the own boxes (the forward's
// Q as 2 boxes; dq's Q then dO, dk/dv's K then V, 4 boxes), the ring (STAGES
// x 2 boxes), for dk/dv the ring's lse and delta (STAGES x 2 x BN floats),
// then the barriers: own_full, full[STAGES], empty[STAGES].
__host__ __device__ constexpr int own_ops(int kind) { return kind == FWD ? 1 : 2; }
__host__ __device__ constexpr int vec_bytes(int kind) {
  return kind == DKV ? STAGES * 2 * BN * 4 : 0;
}
__host__ __device__ constexpr int smem_bytes(int kind) {
  return 1024 + own_ops(kind) * 2 * BOX + STAGES * 2 * BOX + vec_bytes(kind) +
         8 * (1 + 2 * STAGES);
}

// The accumulator layout (hopper_common.cuh): thread (warp w, lane l) of a
// warpgroup holds element j of a 64 x 64 tile at row 16 w + l / 4 +
// 8 ((j / 2) % 2) and column 8 (j / 4) + 2 (l % 4) + j % 2.

// The scores of a thread's 32 elements from their dot products, element j at
// row r + 8 ((j / 2) % 2) and column c + 8 (j / 4) + j % 2 of the product:
// query rows and key columns, or (TRANS, dk/dv) key rows and query columns.
// MASKED: through score(), with the bias only for rows before Sq; else (a
// tile that tile_masked() clears) the scaled product plus the bias, which
// is what score() gives there.
template <bool MASKED, bool TRANS>
__device__ __forceinline__ void tile_scores(float (&s)[32], const Params& p, const float* bb,
                                            int r, int c) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int row = r + 8 * ((j >> 1) & 1), col = c + 8 * (j >> 2) + (j & 1);
    const int gi = TRANS ? col : row, gj = TRANS ? row : col;
    const float* brow = bb == nullptr ? nullptr : bb + gi * p.qstride;
    if (MASKED)
      s[j] = score(s[j], p.scale, gi < p.sq ? brow : nullptr, gi, gj, p.sk, p.causal, p.window);
    else
      s[j] = brow == nullptr ? s[j] * p.scale : s[j] * p.scale + brow[gj];
  }
}

template <int KIND, typename T>
__device__ __forceinline__ void flash_tc_body(const CUtensorMap& own_a, const CUtensorMap& own_b,
                                              const CUtensorMap& str_a,
                                              const CUtensorMap& str_b, const Params& p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t own_s = base;
  const uint32_t ring_s = own_s + own_ops(KIND) * 2 * BOX;
  const uint32_t vec_s = ring_s + STAGES * 2 * BOX;
  const float* vec = reinterpret_cast<const float*>(smem_raw + (vec_s - raw));
  const uint32_t own_full = vec_s + vec_bytes(KIND);
  const uint32_t full0 = own_full + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x;
  // queries for the forward and dq, longest first; keys for dk/dv, the
  // first (which see the most queries) first
  const int own0 = (KIND == DKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y) * BM;
  int beg, end;  // the streamed rows that hold an unmasked entry for the CTA
  if (KIND == DKV)
    query_range(own0, BM, p.sq, p.sk, p.causal, p.window, &beg, &end);
  else
    key_range(own0, BM, p.sk, p.causal, p.window, &beg, &end);
  const int t0 = beg / BN, t1 = (end + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, KIND == DKV ? 32 : 1);  // dk/dv: every lane of warp 0
      mbar_init(empty0 + 8 * s, 8);                    // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: the own boxes once, then the streamed tiles in the order
    // the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int lane = tid;
    if (tid == 0) {
      mbar_expect_tx(own_full, own_ops(KIND) * 2 * BOX);
      for (int o = 0; o < own_ops(KIND); ++o)
        for (int b = 0; b < 2; ++b)
          tma_load_3d(own_s + (2 * o + b) * BOX, o == 0 ? &own_a : &own_b, own_full, 0,
                      own0 + b * BN, bh);
    }
    if (tid == 0 || (KIND == DKV && tid < 32)) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        const int s0 = t * BN;
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if constexpr (KIND == DKV) {
          float* v = reinterpret_cast<float*>(smem_raw + (vec_s - raw)) + stage * 2 * BN;
          // lse, +inf past Sq (p = 0 there), and delta
          for (int i = lane; i < BN; i += 32) {
            const bool in = s0 + i < p.sq;
            const long long at = (long long)bh * p.sq + s0 + i;
            v[i] = in ? p.lse[at] : INFINITY;
            v[BN + i] = in ? p.delta[at] : 0.f;
          }
        }
        if (lane == 0) {
          mbar_expect_tx(full, 2 * BOX);
          tma_load_3d(ring_s + stage * 2 * BOX, &str_a, full, 0, s0, bh);
          tma_load_3d(ring_s + stage * 2 * BOX + BOX, &str_b, full, 0, s0, bh);
        } else {
          mbar_arrive(full);  // releases this lane's lse and delta
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = tid - 128;  // consumer thread, 0..255
    const int cw = ct >> 7;    // consumer warpgroup
    const int lane = ct & 31;
    const int rw = ((ct >> 5) & 3) * 16 + (lane >> 2);  // own row in the warpgroup's 64; + 8
    const int cq = 2 * (lane & 3);                      // column within each group of 8
    const uint32_t a_box = own_s + cw * BOX;            // own operand a, this warpgroup's rows
    const uint32_t b_box = own_s + (2 + cw) * BOX;      // own operand b (dq: dO; dk/dv: V)
    const int row0 = own0 + cw * 64;
    int wbeg, wend;  // this warpgroup's streamed rows
    if (KIND == DKV)
      query_range(row0, 64, p.sq, p.sk, p.causal, p.window, &wbeg, &wend);
    else
      key_range(row0, 64, p.sk, p.causal, p.window, &wbeg, &wend);
    const int w0 = wbeg / BN, w1 = (wend + BN - 1) / BN;
    const Dropout drop(p.seed_vec, bh, p.thresh, p.drop_scale);
    const float* bb = p.bias == nullptr ? nullptr : p.bias + bh * p.bstride;

    // per own row (h = 0, 1: rows row0 + rw and row0 + rw + 8): the forward's
    // running max and sum; dq's lse (+inf past Sq: p = 0) and delta
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float lr[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
    if constexpr (KIND == DQ) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = row0 + rw + 8 * h;
        if (gi < p.sq) {
          lr[h] = p.lse[(long long)bh * p.sq + gi];
          dl[h] = p.delta[(long long)bh * p.sq + gi];
        }
      }
    }
    // element j's row and column: r + 8 ((j / 2) % 2), c + 8 (j / 4) + j % 2
    const int r = row0 + rw, c = cq;

    float acc0[32], acc1[32];  // forward: O; dq: dQ; dk/dv: dV and dK
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = 0.f;
    if constexpr (KIND == DKV) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc1[i] = 0.f;
    }
    float s[32], dp[32];
    uint32_t a0[4][4], a1[4][4];

    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(own_full, 0);
    for (int t = t0; t < t1; ++t) {
      const int s0 = t * BN;
      mbar_wait(full0 + 8 * stage, phase);
      if (t >= w0 && t < w1) {
        const uint32_t sa = ring_s + stage * 2 * BOX, sb = sa + BOX;
        // s (forward, dq: Q.K^T; dk/dv: K.Q^T) and dp (dq: dO.V^T; dk/dv:
        // V.dO^T) over the head dim, both operands K-major
        fence_regs(s);
        if constexpr (KIND != FWD) fence_regs(dp);
        wg_fence();
        const uint64_t da = desc(a_box), db = desc(sa);
#pragma unroll
        for (int k = 0; k < 4; ++k) mma_ss<T>(s, da + 2 * k, db + 2 * k, k > 0);
        if constexpr (KIND != FWD) {
          const uint64_t dc = desc(b_box), dd = desc(sb);
#pragma unroll
          for (int k = 0; k < 4; ++k) mma_ss<T>(dp, dc + 2 * k, dd + 2 * k, k > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        if constexpr (KIND != FWD) fence_regs(dp);

        // the scores (forward, dq: rows are queries; dk/dv: rows are keys)
        const bool masked = KIND == DKV
                                ? tile_masked(s0, BN, row0, 64, p.sq, p.sk, p.causal, p.window)
                                : tile_masked(row0, 64, s0, BN, p.sq, p.sk, p.causal, p.window);
        if (masked)
          tile_scores<true, KIND == DKV>(s, p, bb, r, s0 + c);
        else
          tile_scores<false, KIND == DKV>(s, p, bb, r, s0 + c);

        if constexpr (KIND == FWD) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
          float alpha[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            const float m_new = fmaxf(m[h], mx[h]);
            alpha[h] = ex2((m[h] - m_new) * LOG2E);
            l[h] *= alpha[h];
            m[h] = m_new;
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int h = (j >> 1) & 1;
            s[j] = ex2((s[j] - m[h]) * LOG2E);
            l[h] += s[j];
            acc0[j] *= alpha[h];
          }
          if (drop.on) {
#pragma unroll
            for (int j = 0; j < 32; ++j)
              s[j] *= drop.mult(r + 8 * ((j >> 1) & 1), s0 + c + 8 * (j >> 2) + (j & 1));
          }
          to_a_frags<T>(s, a0);
          // O += P.V (V is the MN-major B: keys x D)
          fence_regs(acc0);
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) mma_rs<T>(acc0, a0[k], desc(sb + k * 2048));
        } else if constexpr (KIND == DQ) {
          if (drop.on) {
#pragma unroll
            for (int j = 0; j < 32; ++j)
              dp[j] *= drop.mult(r + 8 * ((j >> 1) & 1), s0 + c + 8 * (j >> 2) + (j & 1));
          }
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int h = (j >> 1) & 1;
            s[j] = ex2((s[j] - lr[h]) * LOG2E) * (dp[j] - dl[h]);
          }
          to_a_frags<T>(s, a0);
          // dQ += dS.K (K is the MN-major B: keys x D)
          fence_regs(acc0);
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) mma_rs<T>(acc0, a0[k], desc(sa + k * 2048));
        } else {
          const float* vl = vec + stage * 2 * BN + c;  // the tile's lse, then its delta
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int cj = 8 * (j >> 2) + (j & 1);
            const float pr = ex2((s[j] - vl[cj]) * LOG2E);
            if (drop.on) {
              const float mult = drop.mult(s0 + c + cj, r + 8 * ((j >> 1) & 1));
              s[j] = pr * mult;
              dp[j] = pr * (dp[j] * mult - vl[BN + cj]);
            } else {
              s[j] = pr;
              dp[j] = pr * (dp[j] - vl[BN + cj]);
            }
          }
          to_a_frags<T>(s, a0);
          to_a_frags<T>(dp, a1);
          // dV += P^T.dO and dK += dS^T.Q (dO and Q are MN-major B: queries x D)
          fence_regs(acc0);
          fence_regs(acc1);
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) mma_rs<T>(acc0, a0[k], desc(sb + k * 2048));
#pragma unroll
          for (int k = 0; k < 4; ++k) mma_rs<T>(acc1, a1[k], desc(sa + k * 2048));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(acc0);
        fence_regs(a0);
        if constexpr (KIND == DKV) {
          fence_regs(acc1);
          fence_regs(a1);
        }
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the epilogue: two 16-bit values (4 bytes) a store
    if constexpr (KIND == FWD) {
      T* out = static_cast<T*>(p.out0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        // l >= 1 whenever a tile was visited; l == 0 only for a row that no
        // tile reaches (a band that ends before the keys do)
        const float sl = l[h] == 0.f ? 1.f : l[h];
        if (r + 8 * h >= p.sq) continue;
        const long long at = (long long)bh * p.sq + r + 8 * h;
        if ((lane & 3) == 0) p.lse_out[at] = m[h] + logf(sl);
        const float inv = 1.f / sl;
#pragma unroll
        for (int j = 2 * h; j < 32; j += 4)
          *reinterpret_cast<uint32_t*>(out + at * HD + 8 * (j >> 2) + cq) =
              pack2<T>(acc0[j] * inv, acc0[j + 1] * inv);
      }
    } else {
      const int rows = KIND == DKV ? p.sk : p.sq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= rows) continue;
        const long long at = ((long long)bh * rows + r + 8 * h) * HD;
        T* o0 = static_cast<T*>(p.out0) + at;  // dq or dk
#pragma unroll
        for (int j = 2 * h; j < 32; j += 4) {
          const int col = 8 * (j >> 2) + cq;
          if constexpr (KIND == DQ) {
            *reinterpret_cast<uint32_t*>(o0 + col) = pack2<T>(acc0[j] * p.scale, acc0[j + 1] * p.scale);
          } else {
            *reinterpret_cast<uint32_t*>(o0 + col) = pack2<T>(acc1[j] * p.scale, acc1[j + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out1) + at + col) =
                pack2<T>(acc0[j], acc0[j + 1]);
          }
        }
      }
    }
  }
}

// the three kernels, under names of their own for the profiler
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc(__grid_constant__ const CUtensorMap q_map, __grid_constant__ const CUtensorMap k_map,
             __grid_constant__ const CUtensorMap v_map, const Params p) {
  flash_tc_body<FWD, T>(q_map, q_map, k_map, v_map, p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc(__grid_constant__ const CUtensorMap q_map,
                __grid_constant__ const CUtensorMap do_map,
                __grid_constant__ const CUtensorMap k_map,
                __grid_constant__ const CUtensorMap v_map, const Params p) {
  flash_tc_body<DQ, T>(q_map, do_map, k_map, v_map, p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc(__grid_constant__ const CUtensorMap k_map,
                 __grid_constant__ const CUtensorMap v_map,
                 __grid_constant__ const CUtensorMap q_map,
                 __grid_constant__ const CUtensorMap do_map, const Params p) {
  flash_tc_body<DKV, T>(k_map, v_map, q_map, do_map, p);
}

// (bh, rows, HD) of dtype, contiguous, as a 3-D map (HD, rows, bh) cut into
// boxes of HD x BN x 1, 128-byte swizzled; rows past `rows` read as 0
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int bh, int dtype) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {HD * 2, static_cast<cuuint64_t>(rows) * HD * 2};
  const cuuint32_t box[3] = {HD, BN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, dtype == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v, *dout;
  Params p;
  int bh, d, dtype;
  cudaStream_t st;
};

// what the route takes: bf16 or fp16, head dim 64, 16-byte-aligned bases
// (TMA's rule), grids within limits
bool takes(const Args& a) {
  if ((a.dtype != DT_BF16 && a.dtype != DT_F16) || a.d != HD) return false;
  if (a.bh <= 0 || a.p.sq <= 0 || a.p.sk <= 0) return false;
  if ((a.p.sq + BM - 1) / BM > 65535 || (a.p.sk + BM - 1) / BM > 65535) return false;
  for (const void* ptr : {a.q, a.k, a.v, a.dout})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  return true;
}

template <int KIND, typename T, typename Kernel>
cudaError_t start(Kernel kernel, const CUtensorMap (&maps)[4], int own_rows, const Args& a) {
  const int smem = smem_bytes(KIND);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (own_rows + BM - 1) / BM);
  if constexpr (KIND == FWD)
    kernel<<<grid, THREADS, smem, a.st>>>(maps[0], maps[1], maps[2], a.p);
  else
    kernel<<<grid, THREADS, smem, a.st>>>(maps[0], maps[1], maps[2], maps[3], a.p);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t launch(const Args& a) {
  // own operands first, then the streamed ones, in the kernel's order
  CUtensorMap maps[4];
  const void* ptrs[4];
  int rows[4];
  if (KIND == FWD) {
    ptrs[0] = a.q; ptrs[1] = a.k; ptrs[2] = a.v; ptrs[3] = a.v;
    rows[0] = a.p.sq; rows[1] = rows[2] = rows[3] = a.p.sk;
  } else if (KIND == DQ) {
    ptrs[0] = a.q; ptrs[1] = a.dout; ptrs[2] = a.k; ptrs[3] = a.v;
    rows[0] = rows[1] = a.p.sq; rows[2] = rows[3] = a.p.sk;
  } else {
    ptrs[0] = a.k; ptrs[1] = a.v; ptrs[2] = a.q; ptrs[3] = a.dout;
    rows[0] = rows[1] = a.p.sk; rows[2] = rows[3] = a.p.sq;
  }
  for (int i = 0; i < (KIND == FWD ? 3 : 4); ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], rows[i], a.bh, a.dtype);
    if (err != cudaSuccess) return err;
  }
  if constexpr (KIND == FWD) return start<FWD, T>(flash_fwd_tc<T>, maps, a.p.sq, a);
  if constexpr (KIND == DQ) return start<DQ, T>(flash_bwd_dq_tc<T>, maps, a.p.sq, a);
  return start<DKV, T>(flash_bwd_dkv_tc<T>, maps, a.p.sk, a);
}

template <int KIND>
cudaError_t run(const Args& a) {
  if (!takes(a)) return cudaErrorInvalidValue;
  return a.dtype == DT_F16 ? launch<KIND, __half>(a) : launch<KIND, __nv_bfloat16>(a);
}

}  // namespace ftc
}  // namespace

// The entry points take the simt route's arguments (flash_attention.cu,
// flash_attention_bwd.cu) and return cudaErrorInvalidValue for what the
// route does not take: dtype other than 1 (bfloat16) or 2 (float16), d != 64,
// a base address not 16-byte aligned.
extern "C" int apex_flash_tc_fwd(const void* q, const void* k, const void* v, const void* bias,
                                 long long bias_bstride, long long bias_qstride, void* out,
                                 void* lse, int bh, int sq, int sk, int d, float scale,
                                 int causal, int window, const void* seed_vec,
                                 unsigned int drop_thresh, float drop_scale, int dtype,
                                 void* stream) {
  const ftc::Params p{static_cast<const float*>(bias), bias_bstride, bias_qstride, nullptr,
                      nullptr, static_cast<float*>(lse), out, nullptr, sq, sk, scale, causal,
                      window, static_cast<const int*>(seed_vec), drop_thresh, drop_scale};
  const ftc::Args a{q, k, v, q, p, bh, d, dtype, static_cast<cudaStream_t>(stream)};
  return ftc::run<ftc::FWD>(a);
}

extern "C" int apex_flash_tc_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* bias, long long bias_bstride,
                                    long long bias_qstride, const void* dout, const void* lse,
                                    const void* delta, void* dq, int bh, int sq, int sk, int d,
                                    float scale, int causal, int window, const void* seed_vec,
                                    unsigned int drop_thresh, float drop_scale, int dtype,
                                    void* stream) {
  const ftc::Params p{static_cast<const float*>(bias), bias_bstride, bias_qstride,
                      static_cast<const float*>(lse), static_cast<const float*>(delta),
                      nullptr, dq, nullptr, sq, sk, scale, causal, window,
                      static_cast<const int*>(seed_vec), drop_thresh, drop_scale};
  const ftc::Args a{q, k, v, dout, p, bh, d, dtype, static_cast<cudaStream_t>(stream)};
  return ftc::run<ftc::DQ>(a);
}

extern "C" int apex_flash_tc_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* bias, long long bias_bstride,
                                     long long bias_qstride, const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv, int bh, int sq,
                                     int sk, int d, float scale, int causal, int window,
                                     const void* seed_vec, unsigned int drop_thresh,
                                     float drop_scale, int dtype, void* stream) {
  const ftc::Params p{static_cast<const float*>(bias), bias_bstride, bias_qstride,
                      static_cast<const float*>(lse), static_cast<const float*>(delta),
                      nullptr, dk, dv, sq, sk, scale, causal, window,
                      static_cast<const int*>(seed_vec), drop_thresh, drop_scale};
  const ftc::Args a{q, k, v, dout, p, bh, d, dtype, static_cast<cudaStream_t>(stream)};
  return ftc::run<ftc::DKV>(a);
}

// Bytes of dynamic shared memory a launch takes: kind 0 the forward, 1 dq,
// 2 dk/dv.
extern "C" int apex_flash_tc_smem(int kind) { return ftc::smem_bytes(kind); }
