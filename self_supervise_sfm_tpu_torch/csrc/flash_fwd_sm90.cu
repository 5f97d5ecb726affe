// Flash-attention forward (K1, and K1m under a RelocMask) and fused [context |
// own frame] attention (K2, and K2p against one layer of the kv2 scene cache
// read in place) on one attention body written for Hopper (sm_90a): TMA loads
// into a ring of shared-memory stages, wgmma products, warp specialisation.
// bf16 in, fp32 softmax state, head dim 64 or 128 (a template parameter;
// each kernel is built at both, the head dim 128 ones under names with
// "_d128").
//
// Replaces the Pallas TPU kernels
//   K1:  self_supervise_sfm_tpu/ops/flash_attention.py  _flash_fwd / _kernel
//   K1m: the same with mask=RelocMask
//   K2:  self_supervise_sfm_tpu/ops/flash_attention.py  frame_ctx_kernel /
//        _frame_ctx_kernel
//   K2p: self_supervise_sfm_tpu/ops/flash_attention.py
//        frame_ctx_packed_kernel / _frame_ctx_kv2_kernel
// and computes what they compute: an online softmax in the log2 domain, fp32
// running max / denominator / accumulator, p rounded to bf16 before the PV
// product, the keys of a ragged last tile masked by select with their V rows
// zero, the l == 0 guard at finalize, out in bf16 and (K1) the natural-log
// lse in fp32. Three roundings differ from the plain versions, each by at
// most one fp32 rounding of an intermediate: the logit scale is folded into
// the FFMA of the exp2 argument (s * c - m, not round(s * c) - m), exp2 is
// ex2.approx.ftz (p below 2^-126 becomes 0), and out is O * (1 / l). K2 folds
// the context tiles of scene b = bf / F and then the frame's own tiles into
// ONE online softmax (tile boundaries restart at key 0 of each source): no
// mask, no lse merge. K2p is K2 with another context tensor map, over the
// (depth, B, H, Nc, 2 * 64) cache: rows of 256 bytes, the k half at the base
// and the v half 128 bytes further, the layer picked by a coordinate; nothing
// of the cache is sliced or copied, and the two agree bit for bit on equal
// values. K1m is K2's walk over other tensor maps: under RelocMask(n_ctx, P,
// F) keys are [n_ctx context | F frames of P] and a q row of frame f sees
// the context and frame f's keys, so a slice is one frame of one head (bh *
// F + f), its context tiles are boxes of the first n_ctx rows of k's slice
// bh and its own tiles boxes of frame f, each from its segment's key 0. The
// mask lives only in the maps: a box clips at its segment's end, so no tile
// holds a key its rows may not see; there is no per-element predicate and no
// dead tile, and on equal values K1m is bit-equal to K2 / K2p. At reloc layer
// 0, (16, 2748) x (16, 3358), that is 352 work tiles of 5 context and 11 own
// key tiles; at 5 queries, (16, 6870) x (16, 8395), 880 of 12 + 11.
//
// Bound on an H100: operations. 4 * Nq * Nk * d FLOPs over the q/k/v/o bytes
// is 690-3450 FLOP/byte at the main-path sizes, above the card's ~295
// FLOP/byte ridge, so the floor is the bf16 tensor-core rate. At head dim 64
// three floors lie close together: the products, the exp2 of every logit on
// the MUFU unit (16 a clock an SM: as long as the products) and the issue of
// the softmax's ~8 instructions a logit. The design overlaps them; it does
// not remove any. At head dim 128 with half the heads (the same width) a
// site has half the logits and the same products: the exp2 and the softmax
// fall to half the products' time.
//
// Design. A persistent grid of one block an SM walks over (slice, 128-row q
// tile) work tiles. A block is three warpgroups:
// - the producer (one thread issues; its warpgroup gives up registers with
//   setmaxnreg) loads a work tile's Q once (TMA boxes of 128 x 64, 16 KB
//   each) and streams 128-key K and V tiles through a ring of shared-memory
//   stages (3 at either head dim) with a full and an empty mbarrier each,
//   running ahead into the next work tile while the consumers finish the
//   last one. Tensor maps are 3-D (d, N, slices) or 4-D: K2's context (d,
//   Nc, B * H, layers), K1m's context (d, n_ctx, 1, BH) and own keys (d, P, F,
//   BH) at a slice stride of n_ctx + F * P rows, so a box never crosses into
//   the next head or frame; TMA fills rows past a segment's end with zeros
//   and counts the whole box's bytes.
// - Rows and atoms: a 64-channel bf16 row is exactly 128 bytes, one row of
//   the 128-byte swizzle, so a box is 64 channels wide. At head dim 128 a
//   token's row is two such atoms: each tile (Q, K, V) is loaded as two
//   boxes, channels 0-63 and 64-127, stored atom by atom (atom a of a tile
//   at a * rows * 128 bytes, each 1024-byte aligned).
// - two consumer warpgroups own 64 q rows each. S = Q K^T is wgmma
//   m64n128k16 with both operands read from shared memory through
//   descriptors in the 128-byte swizzle the TMA box writes: d / 16 k steps,
//   4 of 32 bytes along the swizzled rows of an atom, then the next atom.
//   P, rounded to bf16 in registers, is the A operand of O += P V, wgmma
//   m64nDk16 (n = 64 or 128) with B = V in its natural row-major layout read
//   through the transposed-B bit (at n = 128 the descriptor's leading byte
//   offset steps from V's first atom to its second): no V is transposed
//   anywhere.
//   At head dim 64, within a warpgroup, tile i's S product is issued
//   together with tile i - 1's PV product, and tile i's softmax runs while
//   PV i - 1 is in flight.
//   Between the warpgroups, named barriers make them take turns to issue
//   their products (ping-pong), so that one's softmax runs while the other's
//   products hold the tensor cores.
// - Head dim 128: Q takes 32 KB and each stage of K and V 64 KB, so 3 stages
//   are 229,376 bytes, with the barriers and the 1 KB of alignment 230,464
//   of the 232,448 a block may have (4 stages do not fit). O at m64n128 is
//   64 fp32 registers a thread, as S is; the consumers' 240 registers hold
//   both, but not with the previous tile's P beside them, so a warpgroup
//   runs S, softmax and PV of a tile in turn (OVERLAP below).
// Every output row is computed by one warpgroup in one fixed order of key
// tiles, whatever the grid, the batch or the pointers: no split over keys and
// no atomics.

#include <stddef.h>

#include "sm90_common.cuh"

namespace {

using namespace sfm_sm90;

constexpr int BM = 128;                // q rows a work tile, 64 a consumer warpgroup
constexpr int BN = 128;                // keys a K / V tile
constexpr int STAGES = 3;              // K / V ring depth (on an H100, 2 ran slower and 4 no faster)
constexpr int STAGES_D128 = 3;         // at head dim 128 the most that fit (on an H100, 2 ran level, within 1 %)
constexpr int NTHREADS = 384;          // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;      // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 240;     // and of the consumers
constexpr int ATOM_ROW = 128;          // bytes of a row of one swizzle atom: 64 bf16 channels
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

template <int S>
struct Barriers {
  uint64_t full[S];    // a stage's K and V have landed (TMA bytes)
  uint64_t empty[S];   // the 8 consumer warps are done reading a stage
  uint64_t q_full;     // the work tile's Q has landed
  uint64_t q_empty;    // the 8 consumer warps are done reading Q
};

// The body's shared memory at head dim D (64 or 128): Q, then the ring's K
// tiles, then its V tiles (each 1024-byte aligned: the 128-byte swizzle
// repeats every 8 rows; a tile is D / 64 atoms of its rows), then the
// barriers; 1 KB of slack to align the dynamic shared memory by hand
template <int D>
struct Smem {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int ATOMS = D / 64;            // 128-byte swizzle atoms a row
  static constexpr int RING = D == 64 ? STAGES : STAGES_D128;  // K / V stages
  static constexpr int Q_ATOM = BM * ATOM_ROW;    // 16 KB: one atom of the Q tile
  static constexpr int KV_ATOM = BN * ATOM_ROW;   // 16 KB: one atom of a K or a V tile
  static constexpr int Q_BYTES = BM * D * 2;      // 16 / 32 KB
  static constexpr int KV_BYTES = BN * D * 2;     // 16 / 32 KB a K or a V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + RING * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + RING * KV_BYTES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + static_cast<int>(sizeof(Barriers<RING>));
};
static_assert(Smem<64>::SMEM_BYTES == 115776, "the head-dim-64 body's shared memory");
static_assert(Smem<128>::SMEM_BYTES <= 232448, "more shared memory than a block can have");

struct Params {
  bf16* o;
  float* lse;      // K1, K1m
  int nq;          // q rows of a slice
  int nk;          // own keys of a slice
  int nc;          // context keys of a scene (K2, K2p) or of a head (K1m)
  int heads;       // (K2, K2p) slice = bf * heads + h
  int frames;      // frames a scene: b = bf / frames; (K1m) slice = bh * frames + f
  int layer;       // coordinate of the context map's 4th dim
  int q_tiles;     // ceil(nq / BM)
  int tiles;       // q_tiles * slices
  float scale_log2;
};

// -- the online softmax on wgmma's accumulator layout --------------------------

// exp2 on the MUFU unit, outputs below 2^-126 flushed to zero (p that small
// is below every bf16 / fp32 sum it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Running max (log2 domain) and denominator of this thread's rows g and g + 8.
struct RowState {
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
};

// Fold one tile of logits into the row state: s[4j + e] holds the raw logit
// of key k0 + 8j + 2t + (e & 1) of row g (e < 2) or g + 8. Keys at or past
// nvalid are forced to NEG_INF by select; the running max moves to the log2
// domain (round(max s * c) is the max of round(s * c): the scale is
// positive); p = exp2(s * c - m_new) with the scale folded into one FFMA is
// left in fp32 in s, and l sums those, unrounded. Returns the rescale factors
// of the two rows' accumulators.
__device__ __forceinline__ float2 softmax_tile(float (&s)[BN / 2], RowState& rs, int k0,
                                               int nvalid, int t, float scale_log2) {
  if (k0 + BN > nvalid) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= nvalid) s[4 * j + e] = NEG_INF;
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float n0 = fmaxf(rs.m[0], mx0 * scale_log2), n1 = fmaxf(rs.m[1], mx1 * scale_log2);
  const float2 alpha = make_float2(exp2_ftz(rs.m[0] - n0), exp2_ftz(rs.m[1] - n1));
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    s[4 * j] = exp2_ftz(fmaf(s[4 * j], scale_log2, -n0));
    s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -n0));
    s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -n1));
    s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -n1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  rs.m[0] = n0;
  rs.m[1] = n1;
  rs.l[0] = rs.l[0] * alpha.x + sum0;
  rs.l[1] = rs.l[1] * alpha.y + sum1;
  return alpha;
}

// O *= alpha, row g by alpha.x and row g + 8 by alpha.y
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float2 alpha) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha.x;
    o[4 * j + 1] *= alpha.x;
    o[4 * j + 2] *= alpha.y;
    o[4 * j + 3] *= alpha.y;
  }
}

// P in bf16 as wgmma's A fragments: the accumulator layout of two
// neighbouring 8-key groups is the A layout of one 16-key step
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// -- the attention body -------------------------------------------------------

// The keys of work tile `tile` stream as [context tiles (CTX) | own tiles];
// the slice of a work tile is its (batch * head), for K2 (bf * H + h), for
// K1m (RELOC, with CTX) its (batch * head * frames + frame). D: the head dim.
template <int D, bool CTX, bool RELOC = false>
__device__ __forceinline__ void attention(const CUtensorMap* mq, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const CUtensorMap* mck,
                                          const CUtensorMap* mcv, const Params& p) {
  typedef Smem<D> L;
  constexpr int STAGES = L::RING, ATOMS = L::ATOMS, Q_BYTES = L::Q_BYTES;
  constexpr int KV_BYTES = L::KV_BYTES, K_OFF = L::K_OFF, V_OFF = L::V_OFF;
  typedef Barriers<STAGES> Bars;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t full0 = bars + static_cast<uint32_t>(offsetof(Bars, full));
  const uint32_t empty0 = bars + static_cast<uint32_t>(offsetof(Bars, empty));
  const uint32_t q_full = bars + static_cast<uint32_t>(offsetof(Bars, q_full));
  const uint32_t q_empty = bars + static_cast<uint32_t>(offsetof(Bars, q_empty));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ctx_tiles = CTX ? cdiv(p.nc, BN) : 0;
  const int kv_tiles = ctx_tiles + cdiv(p.nk, BN);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // == producer: one thread issues every copy ==
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int slice = tile / p.q_tiles;
        const int q0 = (tile % p.q_tiles) * BM;
        // the context map's coordinates 2 and 3: K2 (scene * H + h, layer),
        // K1m (0, bh); K1m's own keys are frame slice % F of slice bh
        int c2 = 0, c3 = p.layer;
        if (RELOC) c3 = slice / p.frames;
        else if (CTX) c2 = (slice / p.heads / p.frames) * p.heads + slice % p.heads;
        mbar_wait(q_empty, q_phase ^ 1);  // the previous tile's Q is consumed
        mbar_expect_tx(q_full, Q_BYTES);
        // one box a swizzle atom of the row: channels 64 a to 64 a + 63
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load_3d(base + a * L::Q_ATOM, mq, q_full, 64 * a, q0, slice);
        q_phase ^= 1;
        for (int i = 0; i < kv_tiles; ++i) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          // a ragged box still counts all of its bytes
          mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a) {
            const uint32_t sk = base + K_OFF + stage * KV_BYTES + a * L::KV_ATOM;
            const uint32_t sv = base + V_OFF + stage * KV_BYTES + a * L::KV_ATOM;
            const int ch = 64 * a;
            if (CTX && i < ctx_tiles) {
              tma_load_4d(sk, mck, full, ch, i * BN, c2, c3);
              tma_load_4d(sv, mcv, full, ch, i * BN, c2, c3);
            } else if (RELOC) {
              tma_load_4d(sk, mk, full, ch, (i - ctx_tiles) * BN, slice % p.frames, c3);
              tma_load_4d(sv, mv, full, ch, (i - ctx_tiles) * BN, slice % p.frames, c3);
            } else {
              tma_load_3d(sk, mk, full, ch, (i - ctx_tiles) * BN, slice);
              tma_load_3d(sv, mv, full, ch, (i - ctx_tiles) * BN, slice);
            }
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // == consumers: warpgroup cw owns q rows [64 cw, 64 cw + 64) of a tile ==
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // the warpgroup's 64 rows of each atom of Q
    const uint64_t desc_q = sw128_desc(base + cw * (BM / 2) * ATOM_ROW, 1);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    // S = Q K^T of the tile in `st`: d / 16 k-steps of 16 channels, 32 bytes
    // along the swizzled rows of an atom, 4 an atom, then the next atom (a
    // 16 KB step in Q and in K); committed as one wgmma group
    auto issue_s = [&](float (&s)[BN / 2], int st) {
      const uint64_t desc_k = sw128_desc(base + K_OFF + st * KV_BYTES, 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128(s, desc_add(desc_q, (kk / 4) * (L::Q_ATOM >> 4) + 2 * (kk % 4)),
                         desc_add(desc_k, (kk / 4) * (L::KV_ATOM >> 4) + 2 * (kk % 4)), kk);
      wgmma_commit();
    };
    // O += P V of the tile in `st`: 8 k-steps of 16 keys, 16 rows (2048
    // bytes) of each atom of V; at d = 128 one m64n128 product covers both
    // atoms, its leading byte offset the 16 KB from the first to the second;
    // one wgmma group
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4], int st) {
      if constexpr (D == 64) {
        const uint64_t desc_v = sw128_desc(base + V_OFF + st * KV_BYTES, 1024 >> 4);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_m64n64(o, pa[kk], desc_add(desc_v, 128 * kk));
      } else {
        const uint64_t desc_v = sw128_desc(base + V_OFF + st * KV_BYTES, L::KV_ATOM >> 4);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_m64n128(o, pa[kk], desc_add(desc_v, 128 * kk));
      }
      wgmma_commit();
    };
    auto wait_full = [&]() {
      mbar_wait(full0 + 8 * stage, phase);
      __syncwarp();  // the .aligned wgmma instructions need the warp converged
    };
    auto advance = [&]() {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // Ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2), so that one warpgroup's softmax
    // runs while the other's products occupy the tensor cores. Warpgroup 0
    // has the first turn; the very last turn passes nothing on.
    auto turn_begin = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
    };
    auto turn_end = [&](bool last) {
      if (!last) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
    };
    if (cw == 0 && kv_tiles > 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    // At head dim 64 a warpgroup overlaps its own softmax with its products
    // (S of tile i issued with PV of tile i - 1). At 128 that needs O, S and
    // P live at once, 160 registers of accumulators and fragments, and with
    // the rest past the consumers' 240 (ptxas spilled 144 bytes and
    // serialised the wgmma): a warpgroup runs S, softmax and PV of a tile in
    // turn, two turns a tile, and the ping-pong overlaps one warpgroup's
    // softmax with the other's products.
    constexpr bool OVERLAP = D == 64;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int slice = tile / p.q_tiles;
      const int q0 = (tile % p.q_tiles) * BM;
      const bool last_tile = tile + static_cast<int>(gridDim.x) >= p.tiles;
      float o[D / 2];  // 64 x d fp32 accumulator: d / 8 column groups of 8, 4 a thread
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      RowState rs;
      mbar_wait(q_full, q_phase);
      __syncwarp();
      q_phase ^= 1;
      if (kv_tiles == 0) {
        if (lane == 0) mbar_arrive(q_empty);
      } else if constexpr (!OVERLAP) {
        // O = O * alpha_i + P_i V_i, tile by tile, the same products in the
        // same order as the overlapped walk
        float s[BN / 2];
        uint32_t pa[BN / 16][4];
        for (int i = 0; i < kv_tiles; ++i) {
          const bool own = i >= ctx_tiles;
          wait_full();
          turn_begin();
          wgmma_fence();
          issue_s(s, stage);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(s);
          if (i == kv_tiles - 1 && lane == 0) mbar_arrive(q_empty);
          const float2 alpha = softmax_tile(s, rs, (own ? i - ctx_tiles : i) * BN,
                                            own ? p.nk : p.nc, t, p.scale_log2);
          rescale<D>(o, alpha);
          pack_p(s, pa);
          turn_begin();
          fence_regs(o);
          wgmma_fence();
          issue_pv(o, pa, stage);
          turn_end(last_tile && cw == 1 && i == kv_tiles - 1);
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(empty0 + 8 * stage);
          advance();
        }
      } else {
        // Tile i's S product is issued together with tile i - 1's PV product,
        // after O has been rescaled by tile i - 1's alpha: O = O * alpha_{i-1}
        // + P_{i-1} V_{i-1}, the order of a tile-by-tile online softmax. The
        // softmax of tile i runs while PV i - 1 is in flight; P i stays fp32
        // in the S registers until PV i - 1 has landed and frees the bf16 A
        // fragments.
        float s[BN / 2];
        uint32_t pa[BN / 16][4];
        wait_full();
        turn_begin();
        wgmma_fence();
        issue_s(s, stage);
        turn_end(false);
        wgmma_wait<0>();
        fence_regs(s);
        if (kv_tiles == 1 && lane == 0) mbar_arrive(q_empty);
        float2 alpha = softmax_tile(s, rs, 0, ctx_tiles > 0 ? p.nc : p.nk, t, p.scale_log2);
        pack_p(s, pa);
        int prev = stage;
        advance();
        for (int i = 1; i < kv_tiles; ++i) {
          const bool own = i >= ctx_tiles;
          wait_full();
          turn_begin();
          wgmma_fence();
          issue_s(s, stage);
          rescale<D>(o, alpha);
          fence_regs(o);
          wgmma_fence();
          issue_pv(o, pa, prev);
          turn_end(false);
          wgmma_wait<1>();  // S of tile i has landed; PV of i - 1 may not have
          fence_regs(s);
          if (i == kv_tiles - 1 && lane == 0) mbar_arrive(q_empty);
          alpha = softmax_tile(s, rs, (own ? i - ctx_tiles : i) * BN, own ? p.nk : p.nc, t,
                               p.scale_log2);
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
          pack_p(s, pa);
          prev = stage;
          advance();
        }
        turn_begin();
        rescale<D>(o, alpha);
        fence_regs(o);
        wgmma_fence();
        issue_pv(o, pa, prev);
        turn_end(last_tile && cw == 1);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }

      // out = O * (1 / l) (l == 0 guarded), bf16; lse = m / log2(e) + log(l)
      const float d0 = rs.l[0] == 0.f ? 1.f : rs.l[0];
      const float d1 = rs.l[1] == 0.f ? 1.f : rs.l[1];
      const float i0 = 1.f / d0, i1 = 1.f / d1;
      const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
      bf16* ob = p.o + static_cast<size_t>(slice) * p.nq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + t * 2;
        if (r0 < p.nq)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
              pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        if (r1 < p.nq)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + c) =
              pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
      if ((!CTX || RELOC) && t == 0) {
        float* lb = p.lse + static_cast<size_t>(slice) * p.nq;
        if (r0 < p.nq) lb[r0] = rs.m[0] * (1.0f / LOG2E) + logf(d0);
        if (r1 < p.nq) lb[r1] = rs.m[1] * (1.0f / LOG2E) + logf(d1);
      }
    }
  }
}

// The four kernels at head dim D, under the names NAME (K1), NAME2 (K2),
// NAME2P (K2p) and NAME1M (K1m)
#define SFM_ATTENTION_KERNELS(D, K1, K2, K2P, K1M)                                           \
  /* K1: slices (batch * head), keys of the slice only */                                   \
  __global__ void __launch_bounds__(NTHREADS, 1)                                            \
      K1(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,    \
         const __grid_constant__ CUtensorMap mv, const Params p) {                          \
    attention<D, false>(&mq, &mk, &mv, nullptr, nullptr, p);                                \
  }                                                                                         \
  /* K2: slices (bf * H + h); the context of scene bf / F, then the frame's keys */         \
  __global__ void __launch_bounds__(NTHREADS, 1)                                            \
      K2(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,    \
         const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mck,   \
         const __grid_constant__ CUtensorMap mcv, const Params p) {                         \
    attention<D, true>(&mq, &mk, &mv, &mck, &mcv, p);                                       \
  }                                                                                         \
  /* K2p: K2's body; its context maps run over the kv2 cache (its own name, so */           \
  /* that a profile tells the serving path's launches apart) */                             \
  __global__ void __launch_bounds__(NTHREADS, 1)                                            \
      K2P(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,   \
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mck,  \
          const __grid_constant__ CUtensorMap mcv, const Params p) {                        \
    attention<D, true>(&mq, &mk, &mv, &mck, &mcv, p);                                       \
  }                                                                                         \
  /* K1m: slices (bh * F + f); the context rows of k's slice bh, then frame f's */          \
  /* keys, through segment maps (its own name, so that a profile tells it apart) */         \
  __global__ void __launch_bounds__(NTHREADS, 1)                                            \
      K1M(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,   \
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mck,  \
          const __grid_constant__ CUtensorMap mcv, const Params p) {                        \
    attention<D, true, true>(&mq, &mk, &mv, &mck, &mcv, p);                                 \
  }
SFM_ATTENTION_KERNELS(64, flash_fwd_kernel, frame_ctx_fwd_kernel, frame_ctx_kv2_fwd_kernel,
                      flash_fwd_reloc_sm90_kernel)
SFM_ATTENTION_KERNELS(128, flash_fwd_d128_kernel, frame_ctx_fwd_d128_kernel,
                      frame_ctx_kv2_fwd_d128_kernel, flash_fwd_reloc_d128_sm90_kernel)
#undef SFM_ATTENTION_KERNELS

typedef void (*Kernel3)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const Params);
typedef void (*Kernel5)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap, const Params);

// the kernels of head dim D: K1, K2, K2p, K1m
template <int D>
struct Kernels;
template <>
struct Kernels<64> {
  static constexpr Kernel3 k1 = flash_fwd_kernel;
  static constexpr Kernel5 k2 = frame_ctx_fwd_kernel, k2p = frame_ctx_kv2_fwd_kernel,
                           k1m = flash_fwd_reloc_sm90_kernel;
};
template <>
struct Kernels<128> {
  static constexpr Kernel3 k1 = flash_fwd_d128_kernel;
  static constexpr Kernel5 k2 = frame_ctx_fwd_d128_kernel, k2p = frame_ctx_kv2_fwd_d128_kernel,
                           k1m = flash_fwd_reloc_d128_sm90_kernel;
};

constexpr int KERNELS = 8;  // K1, K2, K2p, K1m at head dims 64 and 128

// -- host side: tensor maps and launches ---------------------------------------

// (slices, n, D) contiguous
template <int D>
bool encode_rows(CUtensorMap* map, const void* ptr, int n, int slices) {
  return encode_rows64(map, ptr, 3, static_cast<uint64_t>(n), D * 2,
                       static_cast<uint64_t>(slices), 1, 0, BN, D);
}

Params make_params(void* o, void* lse, int slices, int nq, int nk, int nc, int heads,
                   int frames, int layer, float scale_log2) {
  Params p;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.nq = nq;
  p.nk = nk;
  p.nc = nc;
  p.heads = heads;
  p.frames = frames;
  p.layer = layer;
  p.q_tiles = (nq + BM - 1) / BM;
  p.tiles = p.q_tiles * slices;
  p.scale_log2 = scale_log2;
  return p;
}

// Grid of a launch: one block an SM (the registers allow no second), at most
// one a work tile; 0 if there is nothing to launch. The first launch of each
// kernel checks its registers and sets its dynamic shared memory limit.
int grid_of(const void* kernel, int smem_bytes, const Params& p, int* grid) {
  static const void* ready[KERNELS] = {};
  *grid = 0;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int slot = 0;
  while (slot < KERNELS && ready[slot] != nullptr && ready[slot] != kernel) ++slot;
  if (slot == KERNELS || ready[slot] != kernel) {
    // setmaxnreg moves registers between the warpgroups of a block: the
    // consumers' increase waits until the block's allocation at launch holds
    // it, so a kernel compiled to fewer registers would never get past it
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * NTHREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 2 * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (slot < KERNELS) ready[slot] = kernel;
  }
  *grid = p.tiles < sms ? p.tiles : sms;
  return 0;
}

template <int D>
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int nq,
              int nk, float scale_log2, void* stream) {
  CUtensorMap mq, mk, mv;
  if (!encode_rows<D>(&mq, q, nq, bh) || !encode_rows<D>(&mk, k, nk, bh) ||
      !encode_rows<D>(&mv, v, nk, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(o, lse, bh, nq, nk, 0, 1, 1, 0, scale_log2);
  constexpr int SMEM_BYTES = Smem<D>::SMEM_BYTES;
  const Kernel3 kernel = Kernels<D>::k1;
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(kernel), SMEM_BYTES, p, &grid);
  if (err != 0 || grid == 0) return err;
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int frame_ctx_fwd(const void* q, const void* k, const void* v, const void* ck, const void* cv,
                  void* o, int bf, int heads, int frames, int np_, int nc, float scale_log2,
                  void* stream) {
  if (heads <= 0 || frames <= 0 || bf % frames) return static_cast<int>(cudaErrorInvalidValue);
  const int bh = bf / frames * heads;
  CUtensorMap mq, mk, mv, mck, mcv;
  if (!encode_rows<D>(&mq, q, np_, bf * heads) || !encode_rows<D>(&mk, k, np_, bf * heads) ||
      !encode_rows<D>(&mv, v, np_, bf * heads) ||
      !encode_rows64(&mck, nc > 0 ? ck : q, 4, nc, D * 2, bh, 1, 0, BN, D) ||
      !encode_rows64(&mcv, nc > 0 ? cv : q, 4, nc, D * 2, bh, 1, 0, BN, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(o, nullptr, bf * heads, np_, np_, nc, heads, frames, 0, scale_log2);
  constexpr int SMEM_BYTES = Smem<D>::SMEM_BYTES;
  const Kernel5 kernel = Kernels<D>::k2;
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(kernel), SMEM_BYTES, p, &grid);
  if (err != 0 || grid == 0) return err;
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mck,
                                                                            mcv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int frame_ctx_kv2_fwd(const void* q, const void* k, const void* v, const void* ckv, void* o,
                      int bf, int heads, int frames, int np_, int nc, int layer,
                      long long layer_stride, float scale_log2, void* stream) {
  if (layer < 0 || layer_stride < 0 || heads <= 0 || frames <= 0 || bf % frames)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = bf / frames * heads;
  const uint64_t layer_bytes = static_cast<uint64_t>(layer_stride) * 2;
  // an empty context is never loaded, but its map needs a valid address
  const bf16* ckv_k = static_cast<const bf16*>(nc > 0 ? ckv : q);
  CUtensorMap mq, mk, mv, mck, mcv;
  if (!encode_rows<D>(&mq, q, np_, bf * heads) || !encode_rows<D>(&mk, k, np_, bf * heads) ||
      !encode_rows<D>(&mv, v, np_, bf * heads) ||
      !encode_rows64(&mck, ckv_k, 4, nc, 4 * D, bh, layer + 1, layer_bytes, BN, D) ||
      !encode_rows64(&mcv, ckv_k + D, 4, nc, 4 * D, bh, layer + 1, layer_bytes, BN, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p =
      make_params(o, nullptr, bf * heads, np_, np_, nc, heads, frames, layer, scale_log2);
  constexpr int SMEM_BYTES = Smem<D>::SMEM_BYTES;
  const Kernel5 kernel = Kernels<D>::k2p;
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(kernel), SMEM_BYTES, p, &grid);
  if (err != 0 || grid == 0) return err;
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mck,
                                                                            mcv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int flash_fwd_reloc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int nq, int nk, int n_ctx, int frame_size, int num_frames, float scale_log2,
                    void* stream) {
  if (frame_size <= 0 || num_frames <= 0 || n_ctx < 0 || nq != num_frames * frame_size ||
      nk != n_ctx + nq)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t slice_bytes = static_cast<uint64_t>(nk) * D * 2;
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const size_t own = static_cast<size_t>(n_ctx) * D;  // rows of 2 D bytes: 16-byte aligned
  CUtensorMap mq, mk, mv, mck, mcv;
  if (!encode_rows<D>(&mq, q, frame_size, bh * num_frames) ||
      !encode_rows64(&mk, kb + own, 4, frame_size, D * 2, num_frames, bh, slice_bytes, BN, D) ||
      !encode_rows64(&mv, vb + own, 4, frame_size, D * 2, num_frames, bh, slice_bytes, BN, D) ||
      !encode_rows64(&mck, kb, 4, n_ctx, D * 2, 1, bh, slice_bytes, BN, D) ||
      !encode_rows64(&mcv, vb, 4, n_ctx, D * 2, 1, bh, slice_bytes, BN, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(o, lse, bh * num_frames, frame_size, frame_size, n_ctx, 1,
                               num_frames, 0, scale_log2);
  constexpr int SMEM_BYTES = Smem<D>::SMEM_BYTES;
  const Kernel5 kernel = Kernels<D>::k1m;
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(kernel), SMEM_BYTES, p, &grid);
  if (err != 0 || grid == 0) return err;
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, mck,
                                                                            mcv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sfm_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int nq, int nk, float scale_log2,
                                  void* stream) {
  return flash_fwd<64>(q, k, v, o, lse, bh, nq, nk, scale_log2, stream);
}

// ck / cv: (B, H, Nc, 64) contiguous, B = bf / frames
extern "C" int sfm_frame_ctx_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* ck, const void* cv, void* o, int bf,
                                      int heads, int frames, int np_, int nc,
                                      float scale_log2, void* stream) {
  return frame_ctx_fwd<64>(q, k, v, ck, cv, o, bf, heads, frames, np_, nc, scale_log2, stream);
}

// ckv is the base of the whole stacked cache (depth, B, H, Nc, 2 * 64);
// layer_stride is the number of elements between two layers (B * H * Nc *
// 128), in 64 bits. The context maps run over (64, Nc, B * H, layer + 1) at
// row stride 256 bytes: the k half at ckv, the v half at ckv + 64.
extern "C" int sfm_frame_ctx_kv2_fwd_bf16(const void* q, const void* k, const void* v,
                                          const void* ckv, void* o, int bf, int heads,
                                          int frames, int np_, int nc, int layer,
                                          long long layer_stride, float scale_log2,
                                          void* stream) {
  return frame_ctx_kv2_fwd<64>(q, k, v, ckv, o, bf, heads, frames, np_, nc, layer, layer_stride,
                               scale_log2, stream);
}

// q / o: (BH, F * P, 64), lse (BH, F * P); k / v: (BH, n_ctx + F * P, 64),
// keys [context | frames]. The q map reads each frame as a slice of its own
// (BH * F slices of P rows); the context map runs over the first n_ctx rows
// of each of k's BH slices, the own map over the F frames of P rows that
// follow them. An empty context is never loaded; its map gets one row of k.
extern "C" int sfm_flash_fwd_reloc_sm90(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bh, int nq, int nk, int n_ctx,
                                        int frame_size, int num_frames, float scale_log2,
                                        void* stream) {
  return flash_fwd_reloc<64>(q, k, v, o, lse, bh, nq, nk, n_ctx, frame_size, num_frames,
                             scale_log2, stream);
}

// The same four at head dim 128, with the head-dim-64 entries' arguments:
// q / k / v / o rows of 128 channels, the kv2 cache (depth, B, H, Nc, 2 * 128)
// with the v half at ckv + 128 and its layer stride B * H * Nc * 256 elements
extern "C" int sfm_flash_fwd_d128_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int nq, int nk, float scale_log2,
                                       void* stream) {
  return flash_fwd<128>(q, k, v, o, lse, bh, nq, nk, scale_log2, stream);
}

extern "C" int sfm_frame_ctx_fwd_d128_bf16(const void* q, const void* k, const void* v,
                                           const void* ck, const void* cv, void* o, int bf,
                                           int heads, int frames, int np_, int nc,
                                           float scale_log2, void* stream) {
  return frame_ctx_fwd<128>(q, k, v, ck, cv, o, bf, heads, frames, np_, nc, scale_log2, stream);
}

extern "C" int sfm_frame_ctx_kv2_fwd_d128_bf16(const void* q, const void* k, const void* v,
                                               const void* ckv, void* o, int bf, int heads,
                                               int frames, int np_, int nc, int layer,
                                               long long layer_stride, float scale_log2,
                                               void* stream) {
  return frame_ctx_kv2_fwd<128>(q, k, v, ckv, o, bf, heads, frames, np_, nc, layer,
                                layer_stride, scale_log2, stream);
}

extern "C" int sfm_flash_fwd_reloc_d128_sm90(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int bh, int nq, int nk,
                                             int n_ctx, int frame_size, int num_frames,
                                             float scale_log2, void* stream) {
  return flash_fwd_reloc<128>(q, k, v, o, lse, bh, nq, nk, n_ctx, frame_size, num_frames,
                              scale_log2, stream);
}

// What the body was built with and what the compiler gave each kernel (0 K1,
// 1 K2, 2 K2p, 3 K1m; 4-7 the same at head dim 128): registers a thread at
// launch, local (spill) bytes a thread, dynamic shared memory a block, ring
// stages, q rows and keys a tile, the setmaxnreg counts of the producer and
// the consumer warpgroups.
extern "C" int sfm_attention_sm90_info(int which, int* out) {
  if (which < 0 || which >= KERNELS) return static_cast<int>(cudaErrorInvalidValue);
  const void* fns[KERNELS] = {
      reinterpret_cast<const void*>(Kernels<64>::k1), reinterpret_cast<const void*>(Kernels<64>::k2),
      reinterpret_cast<const void*>(Kernels<64>::k2p), reinterpret_cast<const void*>(Kernels<64>::k1m),
      reinterpret_cast<const void*>(Kernels<128>::k1), reinterpret_cast<const void*>(Kernels<128>::k2),
      reinterpret_cast<const void*>(Kernels<128>::k2p),
      reinterpret_cast<const void*>(Kernels<128>::k1m)};
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool d128 = which >= 4;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = d128 ? Smem<128>::SMEM_BYTES : Smem<64>::SMEM_BYTES;
  out[3] = d128 ? Smem<128>::RING : Smem<64>::RING;
  out[4] = BM;
  out[5] = BN;
  out[6] = PRODUCER_REGS;
  out[7] = CONSUMER_REGS;
  return 0;
}
