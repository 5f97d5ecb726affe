// Flash-attention forward (K1) and fused [context | own frame] attention (K2,
// and K2p against one layer of the kv2 scene cache read in place) on one
// attention body written for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, wgmma products, warp specialisation. bf16 in, fp32
// softmax state, head dim 64.
//
// Replaces the Pallas TPU kernels
//   K1:  self_supervise_sfm_tpu/ops/flash_attention.py  _flash_fwd / _kernel
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
// values.
//
// Bound on an H100: operations. 4 * Nq * Nk * 64 FLOPs over the q/k/v/o bytes
// is 690-3450 FLOP/byte at the main-path sizes, above the card's ~295
// FLOP/byte ridge, so the floor is the bf16 tensor-core rate. At head dim 64
// three floors lie close together: the products, the exp2 of every logit on
// the MUFU unit (16 a clock an SM: as long as the products) and the issue of
// the softmax's ~8 instructions a logit. The design overlaps them; it does
// not remove any.
//
// Design. A persistent grid of one block an SM walks over (slice, 128-row q
// tile) work tiles. A block is three warpgroups:
// - the producer (one thread issues; its warpgroup gives up registers with
//   setmaxnreg) loads a work tile's Q once (a TMA box of 128 x 64, 16 KB) and
//   streams 128-key K and V tiles through a ring of 3 shared-memory stages
//   with a full and an empty mbarrier each, running ahead into the next work
//   tile while the consumers finish the last one. Tensor maps are 3-D (64, N,
//   slices) or, for K2's context, 4-D (64, Nc, B * H, layers), so a box never
//   crosses into the next head; TMA fills rows past N with zeros and counts
//   the whole box's bytes.
// - two consumer warpgroups own 64 q rows each. S = Q K^T is wgmma
//   m64n128k16 with both operands read from shared memory through
//   descriptors in the 128-byte swizzle the TMA box writes (a 64-channel bf16
//   row is exactly 128 bytes). P, rounded to bf16 in registers, is the A
//   operand of O += P V, wgmma m64n64k16 with B = V in its natural row-major
//   layout read through the transposed-B bit: no V is transposed anywhere.
//   Within a warpgroup, tile i's S product is issued together with tile i -
//   1's PV product, and tile i's softmax runs while PV i - 1 is in flight.
//   Between the warpgroups, named barriers make them take turns to issue
//   their products (ping-pong), so that one's softmax runs while the other's
//   products hold the tensor cores.
// Every output row is computed by one warpgroup in one fixed order of key
// tiles, whatever the grid, the batch or the pointers: no split over keys and
// no atomics.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                  // head dim: one 128-byte row a token
constexpr int BM = 128;                // q rows a work tile, 64 a consumer warpgroup
constexpr int BN = 128;                // keys a K / V tile
constexpr int STAGES = 3;              // K / V ring depth (on an H100, 2 ran slower and 4 no faster)
constexpr int NTHREADS = 384;          // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;      // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 240;     // and of the consumers
constexpr int Q_BYTES = BM * D * 2;    // 16 KB
constexpr int KV_BYTES = BN * D * 2;   // 16 KB a K or a V tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct Barriers {
  uint64_t full[STAGES];   // a stage's K and V have landed (TMA bytes)
  uint64_t empty[STAGES];  // the 8 consumer warps are done reading a stage
  uint64_t q_full;         // the work tile's Q has landed
  uint64_t q_empty;        // the 8 consumer warps are done reading Q
};

// Q, then STAGES K tiles, then STAGES V tiles (each 1024-byte aligned: the
// 128-byte swizzle repeats every 8 rows), then the barriers; 1 KB of slack
// to align the dynamic shared memory by hand
constexpr int K_OFF = Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
constexpr int SMEM_BYTES = 1024 + BAR_OFF + static_cast<int>(sizeof(Barriers));

struct Params {
  bf16* o;
  float* lse;      // K1 only
  int nq;          // q rows of a slice
  int nk;          // own keys of a slice
  int nc;          // context keys of a scene (K2, K2p)
  int heads;       // (K2, K2p) slice = bf * heads + h
  int frames;      // frames a scene: b = bf / frames
  int layer;       // coordinate of the context map's 4th dim
  int q_tiles;     // ceil(nq / BM)
  int tiles;       // q_tiles * slices
  float scale_log2;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the phase of parity `parity` (the phase before
// the first counts as complete, so parity 1 passes on a fresh barrier). A
// wait that lasts seconds can only be a fault (a lost arrival or transaction
// count): it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 0xFFFFu) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 4000000000ull)
        __trap();
    }
  }
}

// -- TMA ----------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a 1024-byte aligned tile of 128-byte rows
// in the 128-byte swizzle: start address, leading and stride byte offsets
// (16-byte units), layout type 1 (SWIZZLE_128B) in bits 62-63. The stride
// byte offset (bits 32-45) is the 1024 bytes between groups of 8 rows. A
// K-major operand (Q, K) keeps its 16-channel k step inside one swizzled row,
// so its leading offset is unused (1). For the MN-major V the leading offset
// is the step between 64-column atoms, unused at 64 columns; it is set to the
// same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo16) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// the descriptor `steps` 16-byte units further on: the start address field
// is the low 14 bits and a tile never crosses 256 KB, so the add never
// carries into the high word
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t steps) {
  return (desc & 0xFFFFFFFF00000000ull) | static_cast<uint32_t>(static_cast<uint32_t>(desc) + steps);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the fence / wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, fp32) (+)= A (64 x 16, shared) * B (128 x 16, shared), both
// K-major in the 128-byte swizzle; scale_d == 0 ignores d's old value
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: rows of 16 keys, 128-byte swizzle, read through the transpose bit)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

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
// the slice of a work tile is its (batch * head), for K2 (bf * H + h).
template <bool CTX>
__device__ __forceinline__ void attention(const CUtensorMap* mq, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const CUtensorMap* mck,
                                          const CUtensorMap* mcv, const Params& p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + BAR_OFF;
  const uint32_t full0 = bars + static_cast<uint32_t>(offsetof(Barriers, full));
  const uint32_t empty0 = bars + static_cast<uint32_t>(offsetof(Barriers, empty));
  const uint32_t q_full = bars + static_cast<uint32_t>(offsetof(Barriers, q_full));
  const uint32_t q_empty = bars + static_cast<uint32_t>(offsetof(Barriers, q_empty));
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
        int ctx_slice = 0;
        if (CTX) ctx_slice = (slice / p.heads / p.frames) * p.heads + slice % p.heads;
        mbar_wait(q_empty, q_phase ^ 1);  // the previous tile's Q is consumed
        mbar_expect_tx(q_full, Q_BYTES);
        tma_load_3d(base, mq, q_full, 0, q0, slice);
        q_phase ^= 1;
        for (int i = 0; i < kv_tiles; ++i) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          // a ragged box still counts all of its bytes
          mbar_expect_tx(full, 2 * KV_BYTES);
          const uint32_t sk = base + K_OFF + stage * KV_BYTES;
          const uint32_t sv = base + V_OFF + stage * KV_BYTES;
          if (CTX && i < ctx_tiles) {
            tma_load_4d(sk, mck, full, 0, i * BN, ctx_slice, p.layer);
            tma_load_4d(sv, mcv, full, 0, i * BN, ctx_slice, p.layer);
          } else {
            tma_load_3d(sk, mk, full, 0, (i - ctx_tiles) * BN, slice);
            tma_load_3d(sv, mv, full, 0, (i - ctx_tiles) * BN, slice);
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
    const uint64_t desc_q = sw128_desc(base + cw * (Q_BYTES / 2), 1);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    // S = Q K^T of the tile in `st`: 4 k-steps of 16 channels, 32 bytes
    // along the swizzled row; committed as one wgmma group
    auto issue_s = [&](float (&s)[BN / 2], int st) {
      const uint64_t desc_k = sw128_desc(base + K_OFF + st * KV_BYTES, 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128(s, desc_add(desc_q, 2 * kk), desc_add(desc_k, 2 * kk), kk);
      wgmma_commit();
    };
    // O += P V of the tile in `st`: 8 k-steps of 16 keys, 16 rows (2048
    // bytes) of V each; one wgmma group
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4], int st) {
      const uint64_t desc_v = sw128_desc(base + V_OFF + st * KV_BYTES, 1024 >> 4);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_m64n64(o, pa[kk], desc_add(desc_v, 128 * kk));
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
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int slice = tile / p.q_tiles;
      const int q0 = (tile % p.q_tiles) * BM;
      const bool last_tile = tile + static_cast<int>(gridDim.x) >= p.tiles;
      float o[D / 2];  // 64 x 64 fp32 accumulator: 8 column groups of 8, 4 a thread
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      RowState rs;
      mbar_wait(q_full, q_phase);
      __syncwarp();
      q_phase ^= 1;
      if (kv_tiles == 0) {
        if (lane == 0) mbar_arrive(q_empty);
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
          rescale(o, alpha);
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
        rescale(o, alpha);
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
      if (!CTX && t == 0) {
        float* lb = p.lse + static_cast<size_t>(slice) * p.nq;
        if (r0 < p.nq) lb[r0] = rs.m[0] * (1.0f / LOG2E) + logf(d0);
        if (r1 < p.nq) lb[r1] = rs.m[1] * (1.0f / LOG2E) + logf(d1);
      }
    }
  }
}

// K1: slices (batch * head), keys of the slice only
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const Params p) {
  attention<false>(&mq, &mk, &mv, nullptr, nullptr, p);
}

// K2: slices (bf * H + h); the context of scene bf / F, then the frame's keys
__global__ void __launch_bounds__(NTHREADS, 1)
frame_ctx_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mck,
                     const __grid_constant__ CUtensorMap mcv, const Params p) {
  attention<true>(&mq, &mk, &mv, &mck, &mcv, p);
}

// K2p: K2's body; its context maps run over the kv2 cache (its own name, so
// that a profile tells the serving path's launches apart)
__global__ void __launch_bounds__(NTHREADS, 1)
frame_ctx_kv2_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mck,
                         const __grid_constant__ CUtensorMap mcv, const Params p) {
  attention<true>(&mq, &mk, &mv, &mck, &mcv, p);
}

// -- host side: tensor maps and launches ---------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A map over rows of 64 bf16 (128 bytes, the swizzle span) at a row stride of
// row_bytes: dims (64, n, slices[, layers]), box (64, 128[, 1], 1). Rows past
// n read as zeros. An empty source gets one row (never loaded) at an address
// the caller takes from another tensor.
bool encode(CUtensorMap* map, const void* ptr, int rank, uint64_t n, uint64_t row_bytes,
            uint64_t slices, uint64_t layers, uint64_t layer_bytes) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  if (n == 0) n = 1;
  // the layer stride is at least one layer (it is 0 for an empty kv2 context)
  if (layer_bytes < slices * n * row_bytes) layer_bytes = slices * n * row_bytes;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), n, slices, layers};
  const cuuint64_t strides[3] = {row_bytes, n * row_bytes, layer_bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(BN), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// (slices, n, 64) contiguous
bool encode_rows(CUtensorMap* map, const void* ptr, int n, int slices) {
  return encode(map, ptr, 3, static_cast<uint64_t>(n), D * 2, static_cast<uint64_t>(slices), 1, 0);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
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
int grid_of(const void* kernel, const Params& p, int* grid) {
  static const void* ready[3] = {nullptr, nullptr, nullptr};
  *grid = 0;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  int slot = 0;
  while (slot < 3 && ready[slot] != nullptr && ready[slot] != kernel) ++slot;
  if (slot == 3 || ready[slot] != kernel) {
    // setmaxnreg moves registers between the warpgroups of a block: the
    // consumers' increase waits until the block's allocation at launch holds
    // it, so a kernel compiled to fewer registers would never get past it
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * NTHREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 2 * 128)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (slot < 3) ready[slot] = kernel;
  }
  *grid = p.tiles < sms ? p.tiles : sms;
  return 0;
}

}  // namespace

extern "C" int sfm_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int nq, int nk, float scale_log2,
                                  void* stream) {
  CUtensorMap mq, mk, mv;
  if (!encode_rows(&mq, q, nq, bh) || !encode_rows(&mk, k, nk, bh) ||
      !encode_rows(&mv, v, nk, bh))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(o, lse, bh, nq, nk, 0, 1, 1, 0, scale_log2);
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(flash_fwd_kernel), p, &grid);
  if (err != 0 || grid == 0) return err;
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// ck / cv: (B, H, Nc, 64) contiguous, B = bf / frames
extern "C" int sfm_frame_ctx_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* ck, const void* cv, void* o, int bf,
                                      int heads, int frames, int np_, int nc,
                                      float scale_log2, void* stream) {
  if (heads <= 0 || frames <= 0 || bf % frames) return static_cast<int>(cudaErrorInvalidValue);
  const int bh = bf / frames * heads;
  CUtensorMap mq, mk, mv, mck, mcv;
  if (!encode_rows(&mq, q, np_, bf * heads) || !encode_rows(&mk, k, np_, bf * heads) ||
      !encode_rows(&mv, v, np_, bf * heads) ||
      !encode(&mck, nc > 0 ? ck : q, 4, nc, D * 2, bh, 1, 0) ||
      !encode(&mcv, nc > 0 ? cv : q, 4, nc, D * 2, bh, 1, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(o, nullptr, bf * heads, np_, np_, nc, heads, frames, 0, scale_log2);
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(frame_ctx_fwd_kernel), p, &grid);
  if (err != 0 || grid == 0) return err;
  frame_ctx_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mck, mcv, p);
  return static_cast<int>(cudaGetLastError());
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
  if (layer < 0 || layer_stride < 0 || heads <= 0 || frames <= 0 || bf % frames)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = bf / frames * heads;
  const uint64_t layer_bytes = static_cast<uint64_t>(layer_stride) * 2;
  // an empty context is never loaded, but its map needs a valid address
  const bf16* ckv_k = static_cast<const bf16*>(nc > 0 ? ckv : q);
  CUtensorMap mq, mk, mv, mck, mcv;
  if (!encode_rows(&mq, q, np_, bf * heads) || !encode_rows(&mk, k, np_, bf * heads) ||
      !encode_rows(&mv, v, np_, bf * heads) ||
      !encode(&mck, ckv_k, 4, nc, 4 * D, bh, layer + 1, layer_bytes) ||
      !encode(&mcv, ckv_k + D, 4, nc, 4 * D, bh, layer + 1, layer_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p =
      make_params(o, nullptr, bf * heads, np_, np_, nc, heads, frames, layer, scale_log2);
  int grid;
  const int err = grid_of(reinterpret_cast<const void*>(frame_ctx_kv2_fwd_kernel), p, &grid);
  if (err != 0 || grid == 0) return err;
  frame_ctx_kv2_fwd_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mck, mcv, p);
  return static_cast<int>(cudaGetLastError());
}

// What the body was built with and what the compiler gave each kernel (0 K1,
// 1 K2, 2 K2p): registers a thread at launch, local (spill) bytes a thread,
// dynamic shared memory a block, ring stages, q rows and keys a tile, and the
// setmaxnreg counts of the producer and the consumer warpgroups.
extern "C" int sfm_attention_sm90_info(int which, int* out) {
  cudaFuncAttributes attr;
  const void* fn = which == 0   ? reinterpret_cast<const void*>(flash_fwd_kernel)
                   : which == 1 ? reinterpret_cast<const void*>(frame_ctx_fwd_kernel)
                                : reinterpret_cast<const void*>(frame_ctx_kv2_fwd_kernel);
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = SMEM_BYTES;
  out[3] = STAGES;
  out[4] = BM;
  out[5] = BN;
  out[6] = PRODUCER_REGS;
  out[7] = CONSUMER_REGS;
  return 0;
}
