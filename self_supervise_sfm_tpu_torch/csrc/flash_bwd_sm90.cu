// Flash-attention backward (B9: the dq kernel and the dk/dv kernel, each
// without a mask and under a RelocMask) on an attention body written for
// Hopper (sm_90a): TMA loads into a ring of shared-memory stages, wgmma
// products, warp specialisation. bf16 in, fp32 lse / delta and
// accumulators, head dim 64.
//
// Replaces the Pallas TPU kernels
//   dq:   self_supervise_sfm_tpu/ops/flash_attention.py  _flash_bwd / _dq_kernel
//   dk/dv: self_supervise_sfm_tpu/ops/flash_attention.py  _flash_bwd / _dkv_kernel
// (mask=None and mask=RelocMask) and computes what they compute: p =
// exp2(s * scale * log2(e) - lse * log2(e)) recomputed from the saved
// natural-log lse, ds = p * (do v^T - delta) * scale with delta = rowsum(do
// * o) - dlse (computed in PyTorch beforehand), p and ds rounded to bf16
// before their products, fp32 sums, the results rounded to bf16; p selected
// to 0 for a key past the work tile's end (both kernels) and a q row past
// the end of the rows it streams (dk/dv), as the TPU kernels select past N
// and where the mask forbids. Two roundings differ from the plain version,
// each by at most one fp32 rounding of an intermediate: the logit scale is
// folded into the FFMA of the exp2 argument (s * c - lse2, not round(s * c)
// - lse2) and exp2 is ex2.approx.ftz (p below 2^-126 becomes 0), as in
// flash_fwd_sm90.cu.
//
// Bound on an H100: operations. The dq kernel does 3 and the dk/dv kernel 4
// products of 2 Nq Nk 64 FLOPs (both recompute S and dP; under a mask, over
// the allowed pairs); over their bytes that is far above the card's ~295
// FLOP/byte ridge at the train step's sizes, so the floor is the bf16
// tensor-core rate. As in the forward, the exp2 of every logit (MUFU) and
// the ~10 instructions a logit of the p / ds step lie close to the
// products' time at head dim 64; the design overlaps them.
//
// Design, both kernels. A persistent grid of one block an SM walks over
// work tiles. A block is three warpgroups: a producer (its first warp
// stays; setmaxnreg gives its registers up) and two consumer warpgroups
// that own 64 rows of a work tile each. Tensor maps are 3-D (64, N, B H),
// so a box never crosses into the next head and may start at any row; TMA
// fills rows past N with zeros and counts the whole box's bytes. Every
// product reads its shared operands through descriptors in the 128-byte
// swizzle the TMA box writes (a 64-channel bf16 row is exactly 128 bytes),
// and nothing is transposed in shared memory: a product that needs a tile
// transposed reads it MN-major through wgmma's transposed-B bit (as the
// forward's PV reads V). Within a warpgroup, tile i's S / dP products are
// issued together with tile i - 1's accumulating products, and tile i's p
// / ds step runs while those are in flight; between the warpgroups, named
// barriers make them take turns to issue (ping-pong), so one's p / ds step
// runs while the other's products hold the tensor cores. Every output row
// has one owner and one fixed order of tiles: no atomics, the gradients
// are the same from run to run.
//
// dk/dv kernel: a work tile is (slice, 128 keys), 64 keys a consumer
//   warpgroup. Its K and V tiles are loaded once into one of two K / V slots
//   and from there (ldmatrix, once) into registers as the A fragments of
//   S^T and dP^T, so the slot is free for the next work tile at once and the
//   two products read only Q / dO from shared memory; the producer
//   streams the work tile's Q and dO tiles of KV_BQ rows through a ring of
//   KV_STAGES stages, q innermost, each stage with the tile's lse and delta,
//   which the producer warp's 32 lanes copy with 4-byte cp.async (an (B H,
//   Nq) fp32 row is Nq * 4 bytes, no multiple of the 16 a tensor map's
//   strides need; rows past the streamed rows' end zero-filled), each
//   lane's copies arriving on the stage's full barrier beside the TMA
//   bytes, so that the producer never waits for a load. Per q tile, four
//   products, M = keys:
//     S^T  = K Q^T and dP^T = V dO^T   (K / V registers, Q / dO K-major),
//     dV  += P^T dO and dK += dS^T Q   (P^T / dS^T bf16 in registers, dO / Q
//                                       MN-major through the transposed-B bit).
//   Work tiles at the train step's sites (132 SMs): ViT / split own 352
//   (2.67 rounds), frame 704 (5.33), global 352 (2.67), split context 160
//   (1.21, the last key tile 98 of 128 keys). On an H100 80GB HBM3
//   (tools/ablate_attention.py, 20 launches back to back), against this
//   design: 128-row q tiles take 1.7-1.8x as long (S^T / dP^T of 64 x 128
//   and the rest need ~256 registers: ptxas spills and serialises wgmma),
//   K / V read through shared-memory descriptors 11-15% longer, lse / delta
//   by plain loads 8-34% longer, a 2-stage ring 33-61% longer.
// dq kernel: a work tile is (slice, 128 q rows), 64 a consumer warpgroup:
//   the forward's shape. Q and dO are loaded once; K and V stream through a
//   ring of DQ_STAGES stages of DQ_BK keys. Per key tile:
//     S = Q K^T and dP = dO V^T        (shared x shared, both K-major),
//     dQ += dS K                       (dS bf16 in registers, K MN-major).
//   lse * log2(e) and delta are two per-row values a thread holds in
//   registers (plain loads). 352 / 704 / 352 / 352 / 352 work tiles at the
//   five sites above.
//
// The RelocMask forms (flash_bwd_{dq,dkv}_reloc_sm90_kernel) are the same
// bodies with MASKED set. The keys are [n_ctx context | F frames of P], and
// a q row of frame f sees the context and frame f's keys. The mask is block
// structured, so it is expressed by where the work tiles start and end, not
// by a predicate per element: a tile starts at a segment boundary (a TMA
// box may start at any row), and the selects against a work tile's ends,
// which the unmasked forms make against N, are the only masking. No dead
// tile is loaded and no element is tested against the mask.
//   dk/dv: a work tile is up to 128 keys of one segment: of the context
//   (it streams all Nq q rows) or of frame f (from n_ctx + f P, clipped at
//   the frame's end; it streams only q rows [f P, (f + 1) P), with their lse
//   / delta). A context tile streams F times as many q tiles as a frame
//   tile, so the walk takes the context tiles first (longest first), and
//   its odd rounds run backwards, so that the blocks that took a context
//   tile in round 0 take the last tiles of round 1.
//   dq: a work tile is up to 128 q rows of one frame (from f P, clipped at
//   the frame's end). It streams the context's key tiles, then its frame's,
//   each with its own end: the TPU kernels' order, context first.
//   The stores compare against the work tile's end, not N: a tile's tail
//   rows belong to a neighbour's work tile.
//   At the train step's reloc layer 0, (16, 2748, 3358) under
//   RelocMask(610, 1374, 2): 27 dk/dv work tiles a slice (5 context of 43
//   q tiles, 2 x 11 frame of 22) and 22 dq work tiles (of 5 + 11 key
//   tiles). The busiest block streams 88 q tiles of dk/dv against 84.7 on
//   average (109 in a plain round-robin walk, 130 with the frame tiles
//   first and odd rounds backwards).

#include <stddef.h>

#include "sm90_common.cuh"

namespace {

using namespace sfm_sm90;

constexpr int D = 64;               // head dim: one 128-byte row a token
constexpr int ROW_BYTES = D * 2;
constexpr int NTHREADS = 384;       // producer + two consumer warpgroups
constexpr bool PINGPONG = true;     // the two consumer warpgroups take turns to issue
// the masked walks: odd rounds of the grid backwards, and dk/dv's context
// tiles (the longest) before the frames'
constexpr bool SNAKE = true;
constexpr bool CTX_FIRST = true;
constexpr float LOG2E = 1.4426950408889634f;

// dk/dv kernel
constexpr int KV_BM = 128;     // keys a work tile, 64 a consumer warpgroup
constexpr int KV_BQ = 64;      // q rows a streamed Q / dO tile
constexpr int KV_STAGES = 3;   // Q / dO ring depth
// the warpgroup's 64 keys of K and V as wgmma A fragments in registers
// (ldmatrix once a work tile): S^T and dP^T read only Q / dO from shared
// memory, and the K / V slot is free for the next work tile at once
constexpr bool KV_IN_REGS = true;
static_assert(!KV_IN_REGS || KV_BQ == 64, "K / V in registers: m64n64 products");
// setmaxnreg of the producer warpgroup and of the consumers: the producer
// warp's loop spills at 24 (ptxas, sm_90a); the consumers hold S^T, dP^T,
// P^T, dS^T, dK and dV (160 registers) within 232
constexpr int KV_PRODUCER_REGS = 40;
constexpr int KV_CONSUMER_REGS = 232;
constexpr int KV_TILE_BYTES = KV_BM * ROW_BYTES;  // a K or a V tile, 16 KB
constexpr int KV_Q_BYTES = KV_BQ * ROW_BYTES;     // a Q or a dO tile
constexpr int KV_ROWV_BYTES = 2 * KV_BQ * 4;      // lse, then delta
constexpr int KV_K_OFF = 0;                       // two K slots
constexpr int KV_V_OFF = 2 * KV_TILE_BYTES;       // two V slots
constexpr int KV_Q_OFF = 4 * KV_TILE_BYTES;
constexpr int KV_DO_OFF = KV_Q_OFF + KV_STAGES * KV_Q_BYTES;
constexpr int KV_ROWV_OFF = KV_DO_OFF + KV_STAGES * KV_Q_BYTES;
constexpr int KV_BAR_OFF = KV_ROWV_OFF + KV_STAGES * KV_ROWV_BYTES;

struct DkvBarriers {
  uint64_t full[KV_STAGES];   // a stage's Q, dO (TMA bytes) and lse / delta (32 lanes)
  uint64_t empty[KV_STAGES];  // the 8 consumer warps are done with a stage
  uint64_t kv_full[2];        // a work tile's K and V have landed
  uint64_t kv_empty[2];       // the 8 consumer warps are done with a K / V slot
};
// 1 KB of slack to align the dynamic shared memory by hand
constexpr int KV_SMEM_BYTES = 1024 + KV_BAR_OFF + static_cast<int>(sizeof(DkvBarriers));

// dq kernel
constexpr int DQ_BM = 128;     // q rows a work tile, 64 a consumer warpgroup
constexpr int DQ_BK = 128;     // keys a streamed K / V tile
constexpr int DQ_STAGES = 3;   // K / V ring depth
constexpr int DQ_PRODUCER_REGS = 24;   // one thread issues the copies
constexpr int DQ_CONSUMER_REGS = 240;  // S, dP, dS and dQ: 192 registers
constexpr int DQ_Q_BYTES = DQ_BM * ROW_BYTES;   // Q or dO of a work tile, 16 KB
constexpr int DQ_KV_BYTES = DQ_BK * ROW_BYTES;  // a K or a V tile
constexpr int DQ_Q_OFF = 0;
constexpr int DQ_DO_OFF = DQ_Q_BYTES;
constexpr int DQ_K_OFF = 2 * DQ_Q_BYTES;
constexpr int DQ_V_OFF = DQ_K_OFF + DQ_STAGES * DQ_KV_BYTES;
constexpr int DQ_BAR_OFF = DQ_V_OFF + DQ_STAGES * DQ_KV_BYTES;

struct DqBarriers {
  uint64_t full[DQ_STAGES];   // a stage's K and V have landed
  uint64_t empty[DQ_STAGES];  // the 8 consumer warps are done with a stage
  uint64_t q_full;            // the work tile's Q and dO have landed
  uint64_t q_empty;           // the 8 consumer warps are done with Q and dO
};
constexpr int DQ_SMEM_BYTES = 1024 + DQ_BAR_OFF + static_cast<int>(sizeof(DqBarriers));

typedef __nv_bfloat16 bf16;

struct Params {
  const float* lse;    // (B H, nq), natural log
  const float* delta;  // (B H, nq): rowsum(do * o) - dlse
  bf16* out0;          // dq, or dk
  bf16* out1;          // dv
  int nq;
  int nk;
  int slices;          // B H
  // keys [n_ctx context | frames x frame own keys]; a q row of frame f sees
  // the context and frame f's keys. Without a mask: n_ctx = nk and one
  // frame of nq rows, no own keys.
  int n_ctx;
  int frame;
  int frames;
  int tiles;           // work tiles in all
  float scale_log2;    // scale * log2(e)
  float scale;         // head_dim ** -0.5
};

// A work tile: its slice; the rows it owns, [r0, r_end) (keys for dk/dv, q
// rows for dq; its boxes read 128 rows from r0, and the rows at or past
// r_end, which belong to another work tile or lie past N, get p = 0 and are
// not stored); and dk/dv's streamed q rows [s0, s_end), or dq's own-frame
// keys [s0, s_end), streamed after the context's (none without a mask).
struct Work {
  int slice;
  int r0, r_end;
  int s0, s_end;
};

// The k-th work tile of this block: round k of the grid, backwards on odd
// rounds of a masked walk (SNAKE)
template <bool MASKED>
__device__ __forceinline__ int tile_at(int k) {
  const int g = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  return k * g + ((MASKED && SNAKE && (k & 1)) ? g - 1 - b : b);
}

// dk/dv work tile t: the slices' context tiles (each streams all nq q rows)
// first, then each slice's frames, 128 keys from the frame's first key,
// clipped at its last (each streams its frame's q rows)
template <bool MASKED>
__device__ __forceinline__ Work dkv_work(const Params& p, int t) {
  const int ctx_tiles = cdiv(p.n_ctx, KV_BM);
  const int ctx = p.slices * ctx_tiles;
  if (MASKED && !CTX_FIRST) t = (t + ctx) % p.tiles;
  if (!MASKED || t < ctx) {
    const int k0 = (t % ctx_tiles) * KV_BM;
    return {t / ctx_tiles, k0, min(k0 + KV_BM, p.n_ctx), 0, p.nq};
  }
  t -= ctx;
  const int per_frame = cdiv(p.frame, KV_BM), per_slice = p.frames * per_frame;
  const int r = t % per_slice, f0 = (r / per_frame) * p.frame;
  const int k0 = p.n_ctx + f0 + (r % per_frame) * KV_BM;
  return {t / per_slice, k0, min(k0 + KV_BM, p.n_ctx + f0 + p.frame), f0, f0 + p.frame};
}

// dq work tile t: each slice's frames in order, 128 q rows from the frame's
// first row, clipped at its last; masked, the frame's own keys
template <bool MASKED>
__device__ __forceinline__ Work dq_work(const Params& p, int t) {
  const int per_frame = cdiv(p.frame, DQ_BM), per_slice = p.frames * per_frame;
  const int r = t % per_slice, f0 = (r / per_frame) * p.frame;
  const int q0 = f0 + (r % per_frame) * DQ_BM;
  const int own = MASKED ? p.n_ctx + f0 : 0;
  return {t / per_slice, q0, min(q0 + DQ_BM, f0 + p.frame), own, MASKED ? own + p.frame : 0};
}

// Key tile i of a dq work tile: the context's DQ_BK-key tiles, then the own
// frame's; keys at or past *end are selected to 0
__device__ __forceinline__ int dq_key_tile(const Params& p, const Work& w, int i, int* end) {
  const int ctx = cdiv(p.n_ctx, DQ_BK);
  const int k0 = i < ctx ? i * DQ_BK : w.s0 + (i - ctx) * DQ_BK;
  *end = min(k0 + DQ_BK, i < ctx ? p.n_ctx : w.s_end);
  return k0;
}

// exp2 on the MUFU unit, outputs below 2^-126 flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x N) (+)= A (64 x 16) B (16 x N), both from shared memory, N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_m64n64(d, da, db, scale_d);
  else
    wgmma_ss_m64n128(d, da, db, scale_d);
}

// d (64 x N) (+)= A (64 x 16) B (16 x N), B K-major from shared memory, A
// from registers (A_REGS, N = 64) or from shared memory
template <int N, bool A_REGS>
__device__ __forceinline__ void wgmma_a(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (A_REGS)
    wgmma_rs_m64n64<0>(d, a, db, scale_d);
  else
    wgmma_ss<N>(d, da, db, scale_d);
}

// An fp32 accumulator tile of N columns in bf16 as wgmma's A fragments: the
// accumulator layout of two neighbouring 8-column groups is the A layout of
// one 16-deep k step
template <int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The consumers' turns (ping-pong, where ON): the two warpgroups take turns
// to issue their products (named barriers 1 and 2); warpgroup 0 has the
// first turn, and the very last turn passes nothing on.
template <bool ON>
__device__ __forceinline__ void turn_first(int cw) {
  if (ON && cw == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}
template <bool ON>
__device__ __forceinline__ void turn_begin(int cw) {
  if (ON) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
template <bool ON>
__device__ __forceinline__ void turn_end(int cw, bool last) {
  if (ON && !last) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// -- dk/dv --------------------------------------------------------------------

template <bool MASKED>
__device__ __forceinline__ void dkv_body(const CUtensorMap& mq, const CUtensorMap& mk,
                                         const CUtensorMap& mv, const CUtensorMap& mdo,
                                         const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t bars = base + KV_BAR_OFF;
  const uint32_t full0 = bars + static_cast<uint32_t>(offsetof(DkvBarriers, full));
  const uint32_t empty0 = bars + static_cast<uint32_t>(offsetof(DkvBarriers, empty));
  const uint32_t kv_full0 = bars + static_cast<uint32_t>(offsetof(DkvBarriers, kv_full));
  const uint32_t kv_empty0 = bars + static_cast<uint32_t>(offsetof(DkvBarriers, kv_empty));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 33);  // the TMA bytes' arrival and the producer warp's 32
      mbar_init(empty0 + 8 * s, 8);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(kv_full0 + 8 * s, 1);
      mbar_init(kv_empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // == producer: warp 0; lane 0 issues the TMA copies, the 32 lanes lse / delta ==
    setmaxnreg_dec<KV_PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int stage = 0, kslot = 0;
      uint32_t phase = 0, kphase = 0;
      for (int k = 0, tile; (tile = tile_at<MASKED>(k)) < p.tiles; ++k) {
        const Work w = dkv_work<MASKED>(p, tile);
        if (lane == 0) {
          const uint32_t kv_full = kv_full0 + 8 * kslot;
          mbar_wait(kv_empty0 + 8 * kslot, kphase ^ 1);
          mbar_expect_tx(kv_full, 2 * KV_TILE_BYTES);
          tma_load_3d(base + KV_K_OFF + kslot * KV_TILE_BYTES, &mk, kv_full, 0, w.r0, w.slice);
          tma_load_3d(base + KV_V_OFF + kslot * KV_TILE_BYTES, &mv, kv_full, 0, w.r0, w.slice);
        }
        if (++kslot == 2) {
          kslot = 0;
          kphase ^= 1;
        }
        const float* lse = p.lse + static_cast<size_t>(w.slice) * p.nq;
        const float* delta = p.delta + static_cast<size_t>(w.slice) * p.nq;
        for (int q0 = w.s0; q0 < w.s_end; q0 += KV_BQ) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t rowv = base + KV_ROWV_OFF + stage * KV_ROWV_BYTES;
          // rows past the streamed rows' end: 0, as the TPU kernel's q-side
          // loads past nq (p is selected to 0 there); a zero-filled copy
          // names row 0's address
          for (int r = lane; r < KV_BQ; r += 32) {
            const bool ok = q0 + r < w.s_end;
            const int row = ok ? q0 + r : 0;
            cp_async_4(rowv + 4 * r, lse + row, ok ? 4 : 0);
            cp_async_4(rowv + 4 * (KV_BQ + r), delta + row, ok ? 4 : 0);
          }
          if (lane == 0) {
            // a ragged box still counts all of its bytes
            mbar_expect_tx(full, 2 * KV_Q_BYTES);
            tma_load_3d(base + KV_Q_OFF + stage * KV_Q_BYTES, &mq, full, 0, q0, w.slice);
            tma_load_3d(base + KV_DO_OFF + stage * KV_Q_BYTES, &mdo, full, 0, q0, w.slice);
          }
          cp_async_arrive(full);  // once this lane's lse / delta have landed
          if (++stage == KV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // == consumers: warpgroup cw owns keys [64 cw, 64 cw + 64) of a work tile ==
    setmaxnreg_inc<KV_CONSUMER_REGS>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    int stage = 0, kslot = 0;
    uint32_t phase = 0, kphase = 0;
    auto wait_full = [&]() {
      mbar_wait(full0 + 8 * stage, phase);
      __syncwarp();  // the .aligned wgmma instructions need the warp converged
    };
    auto advance = [&]() {
      if (++stage == KV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    turn_first<PINGPONG>(cw);
    for (int k = 0, tile; (tile = tile_at<MASKED>(k)) < p.tiles; ++k) {
      const Work w = dkv_work<MASKED>(p, tile);
      const bool last_tile = tile_at<MASKED>(k + 1) >= p.tiles;
      const int steps = cdiv(w.s_end - w.s0, KV_BQ);
      const int key0 = w.r0 + cw * 64 + warp * 16 + g;  // this thread's keys key0, key0 + 8
      const bool kok0 = key0 < w.r_end, kok1 = key0 + 8 < w.r_end;
      const bool edge_k = w.r0 + KV_BM > w.r_end;
      const uint64_t desc_k = sw128_desc(base + KV_K_OFF + kslot * KV_TILE_BYTES + cw * 8192, 1);
      const uint64_t desc_v = sw128_desc(base + KV_V_OFF + kslot * KV_TILE_BYTES + cw * 8192, 1);
      float dk[D / 2], dv[D / 2];  // 64 keys x 64 channels each, fp32
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full0 + 8 * kslot, kphase);
      __syncwarp();
      // K and V of this warp's 16 keys as A fragments, 4 k steps of 16
      // channels: row R at 16-byte chunk c lies at chunk c ^ (R % 8) of the
      // 128-byte swizzle
      uint32_t kf[D / 16][4], vf[D / 16][4];
      if constexpr (KV_IN_REGS) {
        const int row = cw * 64 + warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = row * ROW_BYTES + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4);
          ldmatrix_x4(kf[kk], base + KV_K_OFF + kslot * KV_TILE_BYTES + off);
          ldmatrix_x4(vf[kk], base + KV_V_OFF + kslot * KV_TILE_BYTES + off);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty0 + 8 * kslot);
      }

      // S^T = K Q^T and dP^T = V dO^T of the tile in `st`: 4 k steps of 16
      // channels each (32 bytes along the swizzled rows of Q / dO), one
      // wgmma group; K / V from registers or from their slot
      auto issue_sdp = [&](float (&s)[KV_BQ / 2], float (&dp)[KV_BQ / 2], int st) {
        const uint64_t dq_ = sw128_desc(base + KV_Q_OFF + st * KV_Q_BYTES, 1);
        const uint64_t ddo = sw128_desc(base + KV_DO_OFF + st * KV_Q_BYTES, 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_a<KV_BQ, KV_IN_REGS>(s, kf[kk], desc_add(desc_k, 2 * kk), desc_add(dq_, 2 * kk),
                                     kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_a<KV_BQ, KV_IN_REGS>(dp, vf[kk], desc_add(desc_v, 2 * kk),
                                     desc_add(ddo, 2 * kk), kk);
        wgmma_commit();
      };
      // dV += P^T dO and dK += dS^T Q of the tile in `st`: KV_BQ / 16 k steps
      // of 16 q rows (2048 bytes) of dO / Q each, read MN-major; one group
      auto issue_dkv = [&](const uint32_t (&pa)[KV_BQ / 16][4],
                           const uint32_t (&da)[KV_BQ / 16][4], int st) {
        const uint64_t dq_ = sw128_desc(base + KV_Q_OFF + st * KV_Q_BYTES, 1024 >> 4);
        const uint64_t ddo = sw128_desc(base + KV_DO_OFF + st * KV_Q_BYTES, 1024 >> 4);
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk) wgmma_rs_m64n64(dv, pa[kk], desc_add(ddo, 128 * kk));
#pragma unroll
        for (int kk = 0; kk < KV_BQ / 16; ++kk) wgmma_rs_m64n64(dk, da[kk], desc_add(dq_, 128 * kk));
        wgmma_commit();
      };
      // P^T into s and dS^T into dp, fp32: s[4j + e] is key key0 + 8 (e >> 1)
      // against q row q0 + 8j + 2t + (e & 1); the stage's lse / delta of
      // those rows from shared memory, lse2 = lse * log2(e) rounded once
      auto p_ds = [&](float (&s)[KV_BQ / 2], float (&dp)[KV_BQ / 2], int st, int q0) {
        const float* rowv =
            reinterpret_cast<const float*>(gbase + KV_ROWV_OFF + st * KV_ROWV_BYTES);
        const bool edge = edge_k || q0 + KV_BQ > w.s_end;
#pragma unroll
        for (int j = 0; j < KV_BQ / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 ls = *reinterpret_cast<const float2*>(rowv + c);
          const float2 l2 = make_float2(ls.x * LOG2E, ls.y * LOG2E);
          const float2 dl = *reinterpret_cast<const float2*>(rowv + KV_BQ + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = exp2_ftz(fmaf(s[4 * j + e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const bool ok = ((e >> 1) ? kok1 : kok0) && q0 + c + (e & 1) < w.s_end;
              pe = ok ? pe : 0.f;
            }
            s[4 * j + e] = pe;
            dp[4 * j + e] = pe * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * p.scale;
          }
        }
      };

      float s[KV_BQ / 2], dp[KV_BQ / 2];
      uint32_t pa[KV_BQ / 16][4], da[KV_BQ / 16][4];
      wait_full();
      turn_begin<PINGPONG>(cw);
      wgmma_fence();
      issue_sdp(s, dp, stage);
      turn_end<PINGPONG>(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      p_ds(s, dp, stage, w.s0);
      pack_a<KV_BQ>(s, pa);
      pack_a<KV_BQ>(dp, da);
      int prev = stage;
      advance();
      for (int i = 1; i < steps; ++i) {
        wait_full();
        turn_begin<PINGPONG>(cw);
        wgmma_fence();
        issue_sdp(s, dp, stage);
        issue_dkv(pa, da, prev);
        turn_end<PINGPONG>(cw, false);
        wgmma_wait<1>();  // S^T / dP^T of tile i have landed; dK / dV of i - 1 may not have
        fence_regs(s);
        fence_regs(dp);
        p_ds(s, dp, stage, w.s0 + i * KV_BQ);
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        pack_a<KV_BQ>(s, pa);
        pack_a<KV_BQ>(dp, da);
        prev = stage;
        advance();
      }
      turn_begin<PINGPONG>(cw);
      wgmma_fence();
      issue_dkv(pa, da, prev);
      turn_end<PINGPONG>(cw, last_tile && cw == 1);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) {
        mbar_arrive(empty0 + 8 * prev);
        if (!KV_IN_REGS) mbar_arrive(kv_empty0 + 8 * kslot);
      }
      if (++kslot == 2) {
        kslot = 0;
        kphase ^= 1;
      }

      // dk, dv in bf16; keys past the work tile's end are never stored
      bf16* dkb = p.out0 + static_cast<size_t>(w.slice) * p.nk * D;
      bf16* dvb = p.out1 + static_cast<size_t>(w.slice) * p.nk * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + t * 2;
        if (kok0) {
          *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(key0) * D + c) =
              pack_bf16(dk[4 * j], dk[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(key0) * D + c) =
              pack_bf16(dv[4 * j], dv[4 * j + 1]);
        }
        if (kok1) {
          *reinterpret_cast<uint32_t*>(dkb + static_cast<size_t>(key0 + 8) * D + c) =
              pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
          *reinterpret_cast<uint32_t*>(dvb + static_cast<size_t>(key0 + 8) * D + c) =
              pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo, const Params p) {
  dkv_body<false>(mq, mk, mv, mdo, p);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_reloc_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mdo, const Params p) {
  dkv_body<true>(mq, mk, mv, mdo, p);
}

// -- dq -----------------------------------------------------------------------

template <bool MASKED>
__device__ __forceinline__ void dq_body(const CUtensorMap& mq, const CUtensorMap& mk,
                                        const CUtensorMap& mv, const CUtensorMap& mdo,
                                        const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + DQ_BAR_OFF;
  const uint32_t full0 = bars + static_cast<uint32_t>(offsetof(DqBarriers, full));
  const uint32_t empty0 = bars + static_cast<uint32_t>(offsetof(DqBarriers, empty));
  const uint32_t q_full = bars + static_cast<uint32_t>(offsetof(DqBarriers, q_full));
  const uint32_t q_empty = bars + static_cast<uint32_t>(offsetof(DqBarriers, q_empty));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // == producer: one thread issues every copy ==
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int k = 0, tile; (tile = tile_at<MASKED>(k)) < p.tiles; ++k) {
        const Work w = dq_work<MASKED>(p, tile);
        const int steps = cdiv(p.n_ctx, DQ_BK) + cdiv(w.s_end - w.s0, DQ_BK);
        mbar_wait(q_empty, q_phase ^ 1);  // the previous tile's Q and dO are consumed
        mbar_expect_tx(q_full, 2 * DQ_Q_BYTES);
        tma_load_3d(base + DQ_Q_OFF, &mq, q_full, 0, w.r0, w.slice);
        tma_load_3d(base + DQ_DO_OFF, &mdo, q_full, 0, w.r0, w.slice);
        q_phase ^= 1;
        for (int i = 0; i < steps; ++i) {
          int k_end;
          const int k0 = dq_key_tile(p, w, i, &k_end);
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, 2 * DQ_KV_BYTES);
          tma_load_3d(base + DQ_K_OFF + stage * DQ_KV_BYTES, &mk, full, 0, k0, w.slice);
          tma_load_3d(base + DQ_V_OFF + stage * DQ_KV_BYTES, &mv, full, 0, k0, w.slice);
          if (++stage == DQ_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // == consumers: warpgroup cw owns q rows [64 cw, 64 cw + 64) of a work tile ==
    setmaxnreg_inc<DQ_CONSUMER_REGS>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint64_t desc_q = sw128_desc(base + DQ_Q_OFF + cw * (DQ_Q_BYTES / 2), 1);
    const uint64_t desc_do = sw128_desc(base + DQ_DO_OFF + cw * (DQ_Q_BYTES / 2), 1);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    auto wait_full = [&]() {
      mbar_wait(full0 + 8 * stage, phase);
      __syncwarp();
    };
    auto advance = [&]() {
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // S = Q K^T and dP = dO V^T of the tile in `st`: one wgmma group
    auto issue_sdp = [&](float (&s)[DQ_BK / 2], float (&dp)[DQ_BK / 2], int st) {
      const uint64_t dk_ = sw128_desc(base + DQ_K_OFF + st * DQ_KV_BYTES, 1);
      const uint64_t dv_ = sw128_desc(base + DQ_V_OFF + st * DQ_KV_BYTES, 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<DQ_BK>(s, desc_add(desc_q, 2 * kk), desc_add(dk_, 2 * kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<DQ_BK>(dp, desc_add(desc_do, 2 * kk), desc_add(dv_, 2 * kk), kk);
      wgmma_commit();
    };
    // dQ += dS K of the tile in `st`: DQ_BK / 16 k steps of 16 keys, K read
    // MN-major; one group
    auto issue_dq = [&](float (&dq)[D / 2], const uint32_t (&da)[DQ_BK / 16][4], int st) {
      const uint64_t dk_ = sw128_desc(base + DQ_K_OFF + st * DQ_KV_BYTES, 1024 >> 4);
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) wgmma_rs_m64n64(dq, da[kk], desc_add(dk_, 128 * kk));
      wgmma_commit();
    };
    turn_first<PINGPONG>(cw);
    for (int k = 0, tile; (tile = tile_at<MASKED>(k)) < p.tiles; ++k) {
      const Work w = dq_work<MASKED>(p, tile);
      const bool last_tile = tile_at<MASKED>(k + 1) >= p.tiles;
      const int steps = cdiv(p.n_ctx, DQ_BK) + cdiv(w.s_end - w.s0, DQ_BK);
      const int r0 = w.r0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
      // this thread's two rows: lse * log2(e) and delta, 0 past nq (rows
      // past the work tile's end are computed, never stored)
      const float* lse = p.lse + static_cast<size_t>(w.slice) * p.nq;
      const float* delta = p.delta + static_cast<size_t>(w.slice) * p.nq;
      const float lse0 = r0 < p.nq ? lse[r0] * LOG2E : 0.f;
      const float lse1 = r1 < p.nq ? lse[r1] * LOG2E : 0.f;
      const float dl0 = r0 < p.nq ? delta[r0] : 0.f;
      const float dl1 = r1 < p.nq ? delta[r1] : 0.f;
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      // dS into dp, fp32: s[4j + e] is row r0 + 8 (e >> 1) against key k0 +
      // 8j + 2t + (e & 1); keys at or past the key tile's end are selected to 0
      auto p_ds = [&](const float (&s)[DQ_BK / 2], float (&dp)[DQ_BK / 2], int i) {
        int k_end;
        const int k0 = dq_key_tile(p, w, i, &k_end);
        const bool edge = k0 + DQ_BK > k_end;
#pragma unroll
        for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = exp2_ftz(fmaf(s[4 * j + e], p.scale_log2, -((e >> 1) ? lse1 : lse0)));
            if (edge) pe = k0 + 8 * j + 2 * t + (e & 1) < k_end ? pe : 0.f;
            dp[4 * j + e] = pe * (dp[4 * j + e] - ((e >> 1) ? dl1 : dl0)) * p.scale;
          }
      };
      mbar_wait(q_full, q_phase);
      __syncwarp();
      q_phase ^= 1;

      float s[DQ_BK / 2], dp[DQ_BK / 2];
      uint32_t da[DQ_BK / 16][4];
      wait_full();
      turn_begin<PINGPONG>(cw);
      wgmma_fence();
      issue_sdp(s, dp, stage);
      turn_end<PINGPONG>(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (steps == 1 && lane == 0) mbar_arrive(q_empty);
      p_ds(s, dp, 0);
      pack_a<DQ_BK>(dp, da);
      int prev = stage;
      advance();
      for (int i = 1; i < steps; ++i) {
        wait_full();
        turn_begin<PINGPONG>(cw);
        wgmma_fence();
        issue_sdp(s, dp, stage);
        issue_dq(dq, da, prev);
        turn_end<PINGPONG>(cw, false);
        wgmma_wait<1>();  // S / dP of tile i have landed; dQ of i - 1 may not have
        fence_regs(s);
        fence_regs(dp);
        if (i == steps - 1 && lane == 0) mbar_arrive(q_empty);
        p_ds(s, dp, i);
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        pack_a<DQ_BK>(dp, da);
        prev = stage;
        advance();
      }
      turn_begin<PINGPONG>(cw);
      wgmma_fence();
      issue_dq(dq, da, prev);
      turn_end<PINGPONG>(cw, last_tile && cw == 1);
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // dq in bf16; rows past the work tile's end are never stored
      bf16* ob = p.out0 + static_cast<size_t>(w.slice) * p.nq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + t * 2;
        if (r0 < w.r_end)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
              pack_bf16(dq[4 * j], dq[4 * j + 1]);
        if (r1 < w.r_end)
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + c) =
              pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo, const Params p) {
  dq_body<false>(mq, mk, mv, mdo, p);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_reloc_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo, const Params p) {
  dq_body<true>(mq, mk, mv, mdo, p);
}

// -- host side: tensor maps and launches ---------------------------------------

// (slices, n, 64) contiguous, boxes of box_rows rows
bool encode_rows(CUtensorMap* map, const void* ptr, int n, int slices, int box_rows) {
  return encode_rows64(map, ptr, 3, static_cast<uint64_t>(n), ROW_BYTES,
                       static_cast<uint64_t>(slices), 1, 0, static_cast<uint32_t>(box_rows));
}

// The first launch of each kernel checks its registers and sets its dynamic
// shared memory limit; the grid is one block an SM (the registers allow no
// second), at most one a work tile.
int prepare(const void* kernel, int smem_bytes, int producer_regs, int consumer_regs,
            bool* ready, int tiles, int* grid) {
  *grid = 0;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!*ready) {
    // setmaxnreg moves registers between the warpgroups of a block: the
    // consumers' increase waits until the block's allocation at launch holds it
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * NTHREADS < producer_regs * 128 + consumer_regs * 2 * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *ready = true;
  }
  *grid = tiles < sms ? tiles : sms;
  return 0;
}

Params make_params(const void* lse, const void* delta, void* out0, void* out1, int bh, int nq,
                   int nk, int n_ctx, int frame, int tiles, float scale_log2, float scale) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  p.nq = nq;
  p.nk = nk;
  p.slices = bh;
  p.n_ctx = n_ctx;
  p.frame = frame;
  p.frames = nq / frame;
  p.tiles = tiles;
  p.scale_log2 = scale_log2;
  p.scale = scale;
  return p;
}

// Without a mask the context is all nk keys and the q rows one frame; with
// one, nk == n_ctx + nq and the q rows are frames of frame_size.
bool args_ok(bool masked, int bh, int nq, int nk, int n_ctx, int frame) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return false;
  return !masked || (frame > 0 && n_ctx >= 0 && nq % frame == 0 && nk == n_ctx + nq);
}

template <bool MASKED>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int bh, int nq, int nk, int n_ctx, int frame,
              float scale_log2, float scale, void* stream) {
  if (!MASKED) {
    n_ctx = nk;
    frame = nq;
  }
  if (!args_ok(MASKED, bh, nq, nk, n_ctx, frame)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_rows(&mq, q, nq, bh, DQ_BM) || !encode_rows(&mdo, dout, nq, bh, DQ_BM) ||
      !encode_rows(&mk, k, nk, bh, DQ_BK) || !encode_rows(&mv, v, nk, bh, DQ_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = bh * (nq / frame) * cdiv(frame, DQ_BM);
  const Params p =
      make_params(lse, delta, dq, nullptr, bh, nq, nk, n_ctx, frame, tiles, scale_log2, scale);
  const void* kernel = MASKED ? reinterpret_cast<const void*>(flash_bwd_dq_reloc_sm90_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel);
  static bool ready = false;
  int grid;
  const int err = prepare(kernel, DQ_SMEM_BYTES, DQ_PRODUCER_REGS, DQ_CONSUMER_REGS, &ready,
                          p.tiles, &grid);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MASKED)
    flash_bwd_dq_reloc_sm90_kernel<<<grid, NTHREADS, DQ_SMEM_BYTES, st>>>(mq, mk, mv, mdo, p);
  else
    flash_bwd_dq_sm90_kernel<<<grid, NTHREADS, DQ_SMEM_BYTES, st>>>(mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool MASKED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int nq, int nk, int n_ctx,
               int frame, float scale_log2, float scale, void* stream) {
  if (!MASKED) {
    n_ctx = nk;
    frame = nq;
  }
  if (!args_ok(MASKED, bh, nq, nk, n_ctx, frame)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_rows(&mq, q, nq, bh, KV_BQ) || !encode_rows(&mdo, dout, nq, bh, KV_BQ) ||
      !encode_rows(&mk, k, nk, bh, KV_BM) || !encode_rows(&mv, v, nk, bh, KV_BM))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = bh * (cdiv(n_ctx, KV_BM) + (MASKED ? nq / frame * cdiv(frame, KV_BM) : 0));
  const Params p =
      make_params(lse, delta, dk, dv, bh, nq, nk, n_ctx, frame, tiles, scale_log2, scale);
  const void* kernel = MASKED ? reinterpret_cast<const void*>(flash_bwd_dkv_reloc_sm90_kernel)
                              : reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel);
  static bool ready = false;
  int grid;
  const int err = prepare(kernel, KV_SMEM_BYTES, KV_PRODUCER_REGS, KV_CONSUMER_REGS, &ready,
                          p.tiles, &grid);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (MASKED)
    flash_bwd_dkv_reloc_sm90_kernel<<<grid, NTHREADS, KV_SMEM_BYTES, st>>>(mq, mk, mv, mdo, p);
  else
    flash_bwd_dkv_sm90_kernel<<<grid, NTHREADS, KV_SMEM_BYTES, st>>>(mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q / do: (bh, nq, 64), k / v: (bh, nk, 64) bf16; lse / delta (bh, nq)
// fp32; dq (bh, nq, 64) bf16. nq, nk >= 1.
extern "C" int sfm_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int bh, int nq, int nk, float scale_log2,
                                     float scale, void* stream) {
  return launch_dq<false>(q, k, v, dout, lse, delta, dq, bh, nq, nk, 0, 0, scale_log2, scale,
                          stream);
}

// As above; dk / dv (bh, nk, 64) bf16.
extern "C" int sfm_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int nq, int nk,
                                      float scale_log2, float scale, void* stream) {
  return launch_dkv<false>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, 0, 0, scale_log2,
                           scale, stream);
}

// The same under a RelocMask: nk == n_ctx + nq, the q rows frames of
// frame_size.
extern "C" int sfm_flash_bwd_dq_reloc_sm90(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int bh, int nq, int nk,
                                           int n_ctx, int frame_size, float scale_log2,
                                           float scale, void* stream) {
  return launch_dq<true>(q, k, v, dout, lse, delta, dq, bh, nq, nk, n_ctx, frame_size,
                         scale_log2, scale, stream);
}

extern "C" int sfm_flash_bwd_dkv_reloc_sm90(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int bh,
                                            int nq, int nk, int n_ctx, int frame_size,
                                            float scale_log2, float scale, void* stream) {
  return launch_dkv<true>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, n_ctx, frame_size,
                          scale_log2, scale, stream);
}

// What each kernel was built with and what the compiler gave it (0 dq, 1
// dk/dv, 2 and 3 their RelocMask forms): registers a thread at launch,
// local (spill) bytes a thread, dynamic shared memory a block, ring stages,
// rows a work tile, rows a streamed tile, and the setmaxnreg counts of the
// producer and the consumers.
extern "C" int sfm_flash_bwd_sm90_info(int which, int* out) {
  if (which < 0 || which > 3) return static_cast<int>(cudaErrorInvalidValue);
  const void* const kernels[4] = {reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel),
                                  reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel),
                                  reinterpret_cast<const void*>(flash_bwd_dq_reloc_sm90_kernel),
                                  reinterpret_cast<const void*>(flash_bwd_dkv_reloc_sm90_kernel)};
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernels[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool dq = which % 2 == 0;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = dq ? DQ_SMEM_BYTES : KV_SMEM_BYTES;
  out[3] = dq ? DQ_STAGES : KV_STAGES;
  out[4] = dq ? DQ_BM : KV_BM;
  out[5] = dq ? DQ_BK : KV_BQ;
  out[6] = dq ? DQ_PRODUCER_REGS : KV_PRODUCER_REGS;
  out[7] = dq ? DQ_CONSUMER_REGS : KV_CONSUMER_REGS;
  return 0;
}
