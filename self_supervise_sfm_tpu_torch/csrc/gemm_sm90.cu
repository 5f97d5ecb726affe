// The five fused kernels of a transformer block on one GEMM body written for
// Hopper (sm_90a): TMA loads into a ring of shared-memory stages, wgmma
// products, warp specialisation, a persistent grid. bf16 activations and
// weights, fp32 norm / bias / layer-scale / RoPE parameters.
//
// Replaces the Pallas TPU kernels of self_supervise_sfm_tpu/ops/fused_qkv.py
//   ln_qkv_rope_sm90_kernel    fused_qkv_kernel       / _kernel        (+ ln_rows_kernel)
//   ln_qkv_sm90_kernel         fused_qkv_plain_kernel / _kernel_plain  (+ ln_rows_kernel)
//   proj_residual_sm90_kernel  fused_proj_kernel      / _proj_kernel
//   mlp_up_sm90_kernel         fused_mlp_kernel / _mlp_up_kernel       (+ ln_rows_kernel)
//   mlp_down_sm90_kernel       fused_mlp_kernel / _mlp_down_kernel
// and computes what they compute, with their rounding points. The three
// layer-normed kernels: hn = LN(x) with fp32 statistics (centred variance),
// rounded to bf16; acc = hn @ W in fp32, rounded to bf16; + b in bf16. Then
// LN+QKV+RoPE: per head of q and k a layer norm over its d values in fp32,
// rounded to bf16, and 2D RoPE in bf16 (bf16 cos / sin, each product
// rounded); LN+QKV: nothing more; both write q, k, v as (B, H, N, d). The
// three kernels with a head dim are built at d = 64 and at d = 128 (names
// with "_d128").
// MLP-up: the exact (erff) GELU in fp32, rounded to bf16. MLP-down: acc = h
// @ W2 in fp32, rounded to bf16; + b2, x gamma and + x, each in bf16. The
// out-projection: the same product and epilogue on the merged heads of the
// attention output o (B, H, N, d) @ W_proj (C, C). x and h are flat (M, C)
// and (M, 4C) rows; the weights stay in their (K, Nout) row-major layout,
// read MN-major.
//
// Bound on an H100: operations. 2 M C Nout FLOPs over x, W and the result
// is 330-780 FLOP a byte at the main path's sizes (M = 6870 or 13740 rows, C
// = 1024, Nout = C, 3C or 4C), above the card's ~295 ridge, so the floor is
// the bf16 tensor-core rate: LN+QKV(+RoPE) 43 / 86 GFLOP a call, 0.044 /
// 0.087 ms, the MLP pair 58 / 115 GFLOP, 0.058 / 0.117 ms, the
// out-projection 14 / 29 GFLOP, 0.015 / 0.029 ms at 989 TFLOP/s.
//
// Design:
// - Products: wgmma m64n128k16 with both operands read from shared memory.
//   A (hn, h or o) is K-major in the 128-byte swizzle: a 64-channel bf16 row is
//   one swizzle row, the 16-channel k step a 32-byte start-address step. B =
//   W in its natural (K, Nout) layout is read through the transposed-B bit:
//   a stage holds two 64-column atoms (64 k rows of 128 bytes each, 8 KB),
//   so the descriptor's stride byte offset is the 1024 bytes between groups
//   of 8 k rows and its leading byte offset the 8 KB between the atoms.
// - Copies: one producer thread issues TMA loads (a 64 x BM box of A, two 64
//   x 64 boxes of B) into a ring of STAGES stages with a full and an empty
//   mbarrier each; no consumer thread spends an instruction on a copy. The
//   producer's warpgroup gives up its registers (setmaxnreg) to the two
//   consumer warpgroups. Rows past M arrive as zeros and are never stored.
// - Epilogue: a persistent grid of one block a multiprocessor walks the
//   output tiles. With PINGPONG the two consumer warpgroups own alternate
//   128 x 128 tiles and take turns to issue their main loops (named
//   barriers), so one's epilogue (the GELU's erff, or bias / gamma /
//   residual) runs while the other's products hold the tensor cores.
//   Without it both share one 256 x 128 tile (B read from L2 half as often,
//   the epilogue exposed); tools/ablate_gemm_sm90.py times the two.
// - Merged heads (the out-projection): A is read through a 3-D map over o
//   as (d, N, B H), box (64, BM, 1): at d = 64 a K slice of 64 is one head,
//   so slice kt of the row tile at row n0 of frame b is the box at (0, n0,
//   b H + kt); at d = 128 a head is two K slices, and slice kt is the box at
//   (64 (kt % 2), n0, b H + kt / 2). Either lands as the same swizzled BM x
//   64 image as a 2-D box of flat rows. No merge copy exists. The tile walk goes frame by frame (the
//   Pallas grid (B, cdiv(N, bn))): B ceil(N / BM) row tiles, none crossing a
//   frame, so no box starts at a negative row or reads the next frame's;
//   rows past N come in as zeros (a box clips at the end of its own slice)
//   and are never stored. The flat kernels walk their M rows as one frame.
// - Layer norm: a pre-pass kernel of this source (ln_rows_kernel, one warp
//   a row) writes hn once, as the JAX kernel's bf16 cast before the dot; the
//   GEMM's A is then a plain TMA load, and no column tile repeats the norm.
// - q / k / v: at d = 64 a 128-column tile is two heads, and the 3 Hl 64 /
//   128 tiles split evenly into q, k and v (Hl, the heads the call computes,
//   even), so a tile lies in one part; at d = 128 a tile is one head, and
//   any Hl splits evenly. Hl is all H heads of C = d H, or one rank's head
//   shard under tensor parallelism: W is then (C, 3 Hl d), the columns [q_l
//   | k_l | v_l] of the rank's heads, and K stays C.
//   On the accumulator layout a thread holds d / 4 values of one head in
//   each of its rows (j in [NT hh, NT hh + NT), NT = d / 8), so the qk-norm
//   is a sum over them and a quad shuffle, and RoPE's partner column (a
//   quarter of the head away, +-16 or +-32) is j +- NT / 4 in the same
//   thread. A row's (b, n) is divmod(row, N); q, k and v go to (B, H, N,
//   d), where a head's rows are contiguous. Stores: from the accumulators, bf16
//   pairs. Staging each 128 x 64 head block in shared memory for one TMA
//   store ran 1.4-1.9x slower on an H100, in an ablation at head dim 64.
// - Tile order: row by row (GROUP_M = 1). Raster groups of 8 row tiles,
//   walked column by column so that a group's rows of A stay in the 50 MB
//   L2, measured no faster on an H100 for the MLP pair (ablate_gemm_sm90):
//   the ~132 tiles in flight hold 4-17 row tiles of A and the 8 MB weight in
//   L2 either way. (LN+QKV ran 8-11% faster grouped, LN+QKV+RoPE 1-2%, in
//   one run; one order serves all four kernels until a per-kernel choice is
//   measured over several runs.)
// - Rounds: 128 x 128 tiles are 1728 / 3456 (up, ViT / frame) and 432 / 864
//   (down) a call, 13.1 / 26.2 and 3.3 / 6.5 rounds of 132 multiprocessors;
//   the last round of MLP-down at ViT is the fullest left (36 of 132).
//   LN+QKV(+RoPE): 1296 / 2592 tiles (ViT, reloc, global / frame), 9.8 / 19.6
//   rounds. The out-projection, 11 row tiles a frame of 1374 in place of
//   10.73 (2.5% more products): 440 / 880 / 432 tiles (ViT and reloc /
//   frame / global), 3.33 / 6.67 / 3.27 rounds; at K = 1024 a tile has 16
//   K slices, so its residual epilogue is four times MLP-down's share.
// Every output element is one warpgroup's fp32 sum over the K slices in
// order, whatever the grid, the row count or the tile: no split over K and
// no atomics, so a row's result does not depend on the rows beside it.

#include <stddef.h>

#include "sm90_common.cuh"

namespace {

using namespace sfm_sm90;

typedef __nv_bfloat16 bf16;

constexpr bool PINGPONG = true;        // alternate 128 x 128 tiles; false: one 256 x 128 tile
constexpr int STAGES = 5;              // ring depth (on an H100, 3 ran slower, 6 no faster)
constexpr int GROUP_M = 1;             // row tiles a raster group (1: row by row)
constexpr int BK = 64;                 // K slice: one 128-byte swizzle row of A
constexpr int WG_M = 128;              // rows of a consumer warpgroup's tile part
constexpr int BN = 128;                // columns of a tile: two 64-column atoms of B
constexpr int BM = PINGPONG ? WG_M : 2 * WG_M;  // rows of a tile
constexpr int NTHREADS = 384;          // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;      // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 240;     // and of the consumers
constexpr int A_BYTES = BM * BK * 2;   // 16 KB (32 KB for 256 rows)
constexpr int B_ATOM_BYTES = BK * 64 * 2;  // 8 KB: 64 k rows of 64 columns
constexpr int B_BYTES = 2 * B_ATOM_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int HD = 64;                 // head dim: a tile of BN columns is two heads
constexpr int HD128 = 128;             // the other head dim built: a tile is one head
// stages (1024-byte aligned: the swizzle repeats every 8 rows), then a full
// and an empty barrier a stage; 1 KB of slack to align by hand
constexpr int SMEM_BYTES = 1024 + BAR_OFF + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");
// the warps that read a stage and arrive on its empty barrier
constexpr int EMPTY_ARRIVALS = PINGPONG ? 4 : 8;

enum { E_GELU = 0, E_RESID = 1, E_F32 = 2, E_QKV_ROPE = 3, E_QKV = 4, E_PROJ = 5 };

__host__ __device__ constexpr bool is_qkv(int ep) { return ep == E_QKV_ROPE || ep == E_QKV; }

struct Params {
  const float* bias;   // (nout)
  const float* gamma;  // (nout) layer-scale (E_RESID)
  const bf16* resid;   // (M, nout) residual (E_RESID)
  void* out;           // (M, nout): bf16, fp32 for E_F32
  // E_QKV_ROPE / E_QKV: q, k, v (B, H, N, d); qk-norm and RoPE (E_QKV_ROPE)
  bf16* q;
  bf16* k;
  bf16* v;
  const float* qn_w;   // (d) q / k layer norm over a head
  const float* qn_b;
  const float* kn_w;
  const float* kn_b;
  const float* cos;    // (ntok, d)
  const float* sin;
  float eps;
  int batch, ntok, heads;
  int M, K, nout;
  int m_tiles, n_tiles, tiles, k_tiles;
  // the walk's frames: rows and row tiles of each (E_PROJ: B frames of N
  // rows; the other kernels: one frame of M rows)
  int frame_rows, frame_tiles;
};

// round an fp32 value to bf16 and back: the value a bf16 tensor would hold
__device__ __forceinline__ float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// tile t -> (row tile, column tile): groups of GROUP_M row tiles, walked
// column by column, the row tiles of a group inside each column
__device__ __forceinline__ void tile_coords(const Params& p, int t, int& mb, int& nb) {
  const int per_group = GROUP_M * p.n_tiles;
  const int first = (t / per_group) * GROUP_M;
  const int rows = min(p.m_tiles - first, GROUP_M);
  const int r = t % per_group;
  mb = first + r % rows;
  nb = r / rows;
}

// The epilogue of one 128 x 128 part, rows from m0 (those before m_end, the
// end of its frame, are stored), columns from n0, on the wgmma accumulator
// layout: acc[h][4j + e] is row h * 64 + 16 warp + g (+ 8 for e >= 2),
// column 8j + 2t + (e & 1). E_RESID and E_PROJ: the residual epilogue.
template <int EP>
__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[2][64], int m0, int m_end,
                                         int n0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + h * 64 + warp * 16 + hr * 8 + g;
      if (row >= m_end) continue;
      const size_t base = static_cast<size_t>(row) * p.nout + n0 + 2 * t;
      if (EP == E_F32) {
        float* o = static_cast<float*>(p.out) + base;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(acc[h][4 * j + 2 * hr], acc[h][4 * j + 2 * hr + 1]);
        continue;
      }
      bf16* o = static_cast<bf16*>(p.out) + base;
      const float* bias = p.bias + n0 + 2 * t;
      if (EP == E_GELU) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          const float h0 = rb(rb(acc[h][4 * j + 2 * hr]) + rb(b.x));
          const float h1 = rb(rb(acc[h][4 * j + 2 * hr + 1]) + rb(b.y));
          const float g0 = 0.5f * h0 * (1.0f + erff(h0 * 0.70710678118654752f));
          const float g1 = 0.5f * h1 * (1.0f + erff(h1 * 0.70710678118654752f));
          *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(g0, g1);
        }
      } else {
        // every load of the row before its first store: the stores may alias
        // the loads as far as the compiler knows, and would serialise them
        const bf16* x = p.resid + base;
        uint32_t res[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) res[j] = *reinterpret_cast<const uint32_t*>(x + 8 * j);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
          const float2 gm = __ldg(reinterpret_cast<const float2*>(p.gamma + n0 + 2 * t + 8 * j));
          const float v0 = rb(rb(acc[h][4 * j + 2 * hr]) + rb(b.x));
          const float v1 = rb(rb(acc[h][4 * j + 2 * hr + 1]) + rb(b.y));
          const float2 xr = unpack_bf16(res[j]);
          *reinterpret_cast<uint32_t*>(o + 8 * j) =
              pack_bf16(xr.x + rb(v0 * rb(gm.x)), xr.y + rb(v1 * rb(gm.y)));
        }
      }
    }
  }
}

// The epilogue of LN+QKV(+RoPE) on one 128 x 128 part (rows from m0, columns
// from n0: HPT heads of q, k or v, two at head dim 64, one at 128).
// acc[h][4j + e] is row h * 64 + 16 warp + g (+ 8 for e >= 2), column 8j +
// 2t + (e & 1), so head hh of the part is j in [NT hh, NT hh + NT), NT = HD
// / 8: HD / 4 values of a row a thread, HD a quad. The values of a row go
// through v[hh][nt][e] = column 8 (NT hh + nt) + 2t + e. A row's loads come
// first and serve every head of the part: the cos / sin of its token (from
// L2: the tables exceed what shared memory leaves of L1), kept as bf16
// pairs, then the bias; the heads' qk-norms then run side by side.
template <int EP, int HD>
__device__ __forceinline__ void epilogue_qkv(const Params& p, float (&acc)[2][64], int m0, int n0) {
  constexpr int HPT = BN / HD;  // heads a part
  constexpr int NT = HD / 8;    // 8-column groups of a head
  constexpr int QT = NT / 4;    // of a quarter of a head: RoPE's partner is QT groups away
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.heads * HD;
  const int part = n0 / C;  // 0 q, 1 k, 2 v
  const int head0 = (n0 - part * C) / HD;
  const bool normed = EP == E_QKV_ROPE && part < 2;
  const float* nw = part == 0 ? p.qn_w : p.kn_w;
  const float* nb = part == 0 ? p.qn_b : p.kn_b;
  bf16* out = part == 0 ? p.q : part == 1 ? p.k : p.v;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + h * 64 + warp * 16 + hr * 8 + g;
      const bool valid = row < p.M;
      const int b = valid ? row / p.ntok : 0;
      const int n = valid ? row - b * p.ntok : 0;
      // rb(cos), rb(sin) of the row's columns 8 nt + 2t (+ 1) as bf16 pairs:
      // at head dim 64 loaded first; at 128 a pair at a time where RoPE
      // takes it (16 pairs a table held through the qk-norm spilled)
      uint32_t cs[NT], sn[NT];
      auto tables = [&](int nt) {
        const size_t c = static_cast<size_t>(n) * HD + 8 * nt + 2 * t;
        const float2 c2 = __ldg(reinterpret_cast<const float2*>(p.cos + c));
        const float2 s2 = __ldg(reinterpret_cast<const float2*>(p.sin + c));
        cs[nt] = pack_bf16(c2.x, c2.y);
        sn[nt] = pack_bf16(s2.x, s2.y);
      };
      if (normed && HD == 64) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) tables(nt);
      }
      // accumulator -> bf16, + bias in bf16
      float v[HPT][NT][2];
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = NT * hh + nt;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * j + 2 * t));
          v[hh][nt][0] = rb(rb(acc[h][4 * j + 2 * hr]) + rb(bias.x));
          v[hh][nt][1] = rb(rb(acc[h][4 * j + 2 * hr + 1]) + rb(bias.y));
        }
      }
      if (normed) {
        // layer norm over each head's HD values of this row, fp32
        float s[HPT], rs[HPT];
#pragma unroll
        for (int hh = 0; hh < HPT; ++hh) {
          s[hh] = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) s[hh] += v[hh][nt][0] + v[hh][nt][1];
        }
#pragma unroll
        for (int hh = 0; hh < HPT; ++hh) {
          const float mu = quad_sum(s[hh]) * (1.0f / HD);
          float q = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            v[hh][nt][0] -= mu;
            v[hh][nt][1] -= mu;
            q += v[hh][nt][0] * v[hh][nt][0] + v[hh][nt][1] * v[hh][nt][1];
          }
          s[hh] = q;
        }
#pragma unroll
        for (int hh = 0; hh < HPT; ++hh) rs[hh] = rsqrtf(quad_sum(s[hh]) * (1.0f / HD) + p.eps);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = 8 * nt + 2 * t;  // column in the head
          const float2 w2 = __ldg(reinterpret_cast<const float2*>(nw + c));
          const float2 b2 = __ldg(reinterpret_cast<const float2*>(nb + c));
#pragma unroll
          for (int hh = 0; hh < HPT; ++hh) {
            v[hh][nt][0] = rb(__fadd_rn(__fmul_rn(__fmul_rn(v[hh][nt][0], rs[hh]), w2.x), b2.x));
            v[hh][nt][1] = rb(__fadd_rn(__fmul_rn(__fmul_rn(v[hh][nt][1], rs[hh]), w2.y), b2.y));
          }
        }
        // 2D RoPE in bf16: t * cos + rot * sin, rot = (-t2, t1, -t4, t3)
        // over quarters of HD / 4 columns: a value of quarter 1 (or 3) and
        // its partner QT groups on, in quarter 2 (or 4), turn as a pair, in
        // place
#pragma unroll
        for (int hh = 0; hh < HPT; ++hh) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt & QT) continue;  // the pair's second
            const int pn = nt + QT;
            if (HD == 128) {
              tables(nt);
              tables(pn);
            }
            const float2 c1 = unpack_bf16(cs[nt]), s1 = unpack_bf16(sn[nt]);
            const float2 c2 = unpack_bf16(cs[pn]), s2 = unpack_bf16(sn[pn]);
            const float a0 = v[hh][nt][0], a1 = v[hh][nt][1];
            const float b0 = v[hh][pn][0], b1 = v[hh][pn][1];
            v[hh][nt][0] = rb(__fmul_rn(a0, c1.x)) + rb(__fmul_rn(-b0, s1.x));
            v[hh][nt][1] = rb(__fmul_rn(a1, c1.y)) + rb(__fmul_rn(-b1, s1.y));
            v[hh][pn][0] = rb(__fmul_rn(b0, c2.x)) + rb(__fmul_rn(a0, s2.x));
            v[hh][pn][1] = rb(__fmul_rn(b1, c2.y)) + rb(__fmul_rn(a1, s2.y));
          }
        }
      }
      if (!valid) continue;
#pragma unroll
      for (int hh = 0; hh < HPT; ++hh) {
        bf16* dst = out + ((static_cast<size_t>(b) * p.heads + head0 + hh) * p.ntok + n) * HD + 2 * t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<uint32_t*>(dst + 8 * nt) = pack_bf16(v[hh][nt][0], v[hh][nt][1]);
      }
    }
  }
}

// (E_PROJ: A is o (B, H, N, HD) through a 3-D map as (HD, N, B H))
// out = epilogue(A @ W): A (M, K) through map ma, W (K, nout) through mb; HD
// the head dim of the kernels that have one
template <int EP, int HD>
__device__ __forceinline__ void gemm(const CUtensorMap* ma, const CUtensorMap* mb, const Params& p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + BAR_OFF;
  const uint32_t empty0 = full0 + 8 * STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // == producer: one thread issues every copy, tile after tile ==
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        int mt, nt;
        tile_coords(p, tile, mt, nt);
        // frame f, its row r0; a box never starts outside the frame
        const int f = mt / p.frame_tiles, r0 = (mt - f * p.frame_tiles) * BM, n0 = nt * BN;
        for (int kt = 0; kt < p.k_tiles; ++kt) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          // a ragged box still counts all of its bytes
          mbar_expect_tx(full, STAGE_BYTES);
          const uint32_t sa = base + stage * STAGE_BYTES;
          if constexpr (EP == E_PROJ && HD == 64)
            tma_load_3d(sa, ma, full, 0, r0, f * p.heads + kt);  // head kt of frame f
          else if constexpr (EP == E_PROJ)  // channels 64 (kt % 2) of head kt / 2 of frame f
            tma_load_3d(sa, ma, full, BK * (kt % (HD / BK)), r0, f * p.heads + kt / (HD / BK));
          else
            tma_load_2d(sa, ma, full, kt * BK, f * p.frame_rows + r0);
          tma_load_2d(sa + A_BYTES, mb, full, n0, kt * BK);
          tma_load_2d(sa + A_BYTES + B_ATOM_BYTES, mb, full, n0 + 64, kt * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // == consumers: warpgroup cw multiplies 128 rows x 128 columns a tile ==
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    // the block's tiles are numbered i = 0, 1, ...; with PINGPONG warpgroup
    // cw takes those with i % 2 == cw, else both take every tile
    const int step = PINGPONG ? 2 : 1;
    const uint32_t a_part = PINGPONG ? 0u : static_cast<uint32_t>(cw * WG_M * BK * 2);
    // Ping-pong turns (named barriers 1 and 2): a warpgroup issues its main
    // loop only in its turn and passes the turn on when its last products
    // are issued; warpgroup 0 has the first turn, the block's last tile
    // passes nothing on. The turns also keep the ring's parity waits sound:
    // a warpgroup skips the other's k_tiles ring positions, and only once
    // the other has waited on all of them is every stage it waits on at most
    // one phase ahead of its barrier (without the turns, a wait two phases
    // ahead passes on the parity of an old phase; the watchdog traps).
    if (PINGPONG && cw == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    for (int i = PINGPONG ? cw : 0;; i += step) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= p.tiles) break;
      int mt, nt;
      tile_coords(p, tile, mt, nt);
      const int it0 = i * p.k_tiles;  // the ring position of the tile's first slice
      int stage = it0 % STAGES;
      uint32_t phase = (it0 / STAGES) & 1;
      float acc[2][64];
      if (PINGPONG) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
      int prev = 0;
      for (int kt = 0; kt < p.k_tiles; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        __syncwarp();  // the .aligned wgmma instructions need the warp converged
        const uint32_t sa = base + stage * STAGE_BYTES + a_part;
        const uint64_t da0 = sw128_desc(sa, 1), da1 = sw128_desc(sa + 64 * 128, 1);
        const uint64_t db = sw128_desc(base + stage * STAGE_BYTES + A_BYTES, B_ATOM_BYTES >> 4);
        wgmma_fence();
        // 4 k steps of 16: +32 bytes along A's swizzled rows, +16 rows (2048
        // bytes) down B's atoms
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const int accumulate = kt > 0 || kk > 0;
          wgmma_ss_m64n128<1>(acc[0], desc_add(da0, 2 * kk), desc_add(db, 128 * kk), accumulate);
          wgmma_ss_m64n128<1>(acc[1], desc_add(da1, 2 * kk), desc_add(db, 128 * kk), accumulate);
        }
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the previous slice's products are done: free its stage
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (PINGPONG && tile + static_cast<int>(gridDim.x) < p.tiles)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      // the part's first flat row and its frame's end
      const int f = mt / p.frame_tiles, m_end = (f + 1) * p.frame_rows;
      const int m0 = f * p.frame_rows + (mt - f * p.frame_tiles) * BM +
                     static_cast<int>(a_part / (BK * 2));
      const int n0 = nt * BN;
      if constexpr (is_qkv(EP))
        epilogue_qkv<EP, HD>(p, acc, m0, n0);
      else
        epilogue<EP>(p, acc, m0, m_end, n0);
    }
  }
}

// The kernels of the body: A and W maps, the parameters; the head dim D of
// those with one
#define SFM_GEMM_KERNEL_HD(name, EP, D)                                                     \
  __global__ void __launch_bounds__(NTHREADS, 1)                                            \
      name(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb, \
           const Params p) {                                                                \
    gemm<EP, D>(&ma, &mb, p);                                                               \
  }
#define SFM_GEMM_KERNEL(name, EP) SFM_GEMM_KERNEL_HD(name, EP, HD)
SFM_GEMM_KERNEL(mlp_up_sm90_kernel, E_GELU)
SFM_GEMM_KERNEL(mlp_down_sm90_kernel, E_RESID)
SFM_GEMM_KERNEL(gemm_probe_sm90_kernel, E_F32)  // the bare product in fp32: the operand layouts
SFM_GEMM_KERNEL(ln_qkv_rope_sm90_kernel, E_QKV_ROPE)
SFM_GEMM_KERNEL(ln_qkv_sm90_kernel, E_QKV)
SFM_GEMM_KERNEL(proj_residual_sm90_kernel, E_PROJ)
SFM_GEMM_KERNEL_HD(ln_qkv_rope_d128_sm90_kernel, E_QKV_ROPE, HD128)
SFM_GEMM_KERNEL_HD(ln_qkv_d128_sm90_kernel, E_QKV, HD128)
SFM_GEMM_KERNEL_HD(proj_residual_d128_sm90_kernel, E_PROJ, HD128)
#undef SFM_GEMM_KERNEL
#undef SFM_GEMM_KERNEL_HD

typedef void (*GemmKernel)(const CUtensorMap, const CUtensorMap, const Params);

template <int EP, int HD>
GemmKernel kernel_of() {
  if (HD == HD128)
    return EP == E_QKV_ROPE ? ln_qkv_rope_d128_sm90_kernel
           : EP == E_QKV    ? ln_qkv_d128_sm90_kernel
                            : proj_residual_d128_sm90_kernel;
  return EP == E_GELU       ? mlp_up_sm90_kernel
         : EP == E_RESID    ? mlp_down_sm90_kernel
         : EP == E_QKV_ROPE ? ln_qkv_rope_sm90_kernel
         : EP == E_QKV      ? ln_qkv_sm90_kernel
         : EP == E_PROJ     ? proj_residual_sm90_kernel
                            : gemm_probe_sm90_kernel;
}

// -- the layer-norm pre-pass ---------------------------------------------------

constexpr int LN_ROWS = 8;  // rows (warps) a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// hn = ((x - mu) * rstd) * scale + bias in fp32, rounded to bf16; one warp a
// row, 8 channels (16 bytes) a lane a step of 256, K a multiple of 8 (the
// lanes past K sit out the last step). Mean and
// centred variance as the plain version's, explicit roundings (no fused
// multiply-add) in the normalisation.
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, bf16* __restrict__ y, int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * K;
  bf16* yr = y + static_cast<size_t>(row) * K;
  float s = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const float2 a = unpack_bf16(u.x), bb = unpack_bf16(u.y);
    const float2 cq = unpack_bf16(u.z), d = unpack_bf16(u.w);
    s += ((a.x + a.y) + (bb.x + bb.y)) + ((cq.x + cq.y) + (d.x + d.y));
  }
  const float mu = warp_sum(s) / static_cast<float>(K);
  float q = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const uint32_t in[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = unpack_bf16(in[j]);
      const float d0 = v.x - mu, d1 = v.y - mu;
      q += d0 * d0 + d1 * d1;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / static_cast<float>(K) + eps);
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const uint32_t in[4] = {u.x, u.y, u.z, u.w};
    const float4 wa = *reinterpret_cast<const float4*>(w + c);
    const float4 wb = *reinterpret_cast<const float4*>(w + c + 4);
    const float4 ba = *reinterpret_cast<const float4*>(b + c);
    const float4 bc = *reinterpret_cast<const float4*>(b + c + 4);
    const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float b8[8] = {ba.x, ba.y, ba.z, ba.w, bc.x, bc.y, bc.z, bc.w};
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = unpack_bf16(in[j]);
      const float y0 =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mu), rs), w8[2 * j]), b8[2 * j]);
      const float y1 =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.y, mu), rs), w8[2 * j + 1]), b8[2 * j + 1]);
      out[j] = pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint4*>(yr + c) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// -- host side ------------------------------------------------------------------

// A 2-D map over a row-major (outer, inner) bf16 matrix, box (64, box_outer)
// in the 128-byte swizzle; rows past `outer` read as zeros
bool encode_2d(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The first launch of each kernel checks its registers (setmaxnreg moves
// registers between the warpgroups: the consumers' increase waits until the
// block's allocation at launch holds it, so a kernel compiled to fewer
// registers would never get past it) and sets its dynamic shared memory;
// one flag a kernel of the body, so no later launch repeats either.
template <int EP, int HD>
int prepare() {
  static bool ready = false;
  if (ready) return 0;
  const void* kernel = reinterpret_cast<const void*>(kernel_of<EP, HD>());
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * NTHREADS < PRODUCER_REGS * 128 + CONSUMER_REGS * 2 * 128)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready = true;
  return 0;
}

// out = epilogue(a (M, K) @ w (K, nout)); K a multiple of 64, nout of 128;
// E_PROJ: a is o (batch, heads, ntok, HD), K = HD heads, M = batch ntok.
// Grid: one block a multiprocessor, at most one a tile.
template <int EP, int HD>
int launch_gemm(const void* a, const void* w, Params p, void* stream) {
  if (p.M < 0 || p.K <= 0 || p.K % BK || p.nout <= 0 || p.nout % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0) return 0;
  const int frames = EP == E_PROJ ? p.batch : 1;
  CUtensorMap ma, mb;
  const bool a_ok =
      EP == E_PROJ ? encode_rows64(&ma, a, 3, p.ntok, HD * 2, p.batch * p.heads, 1, 0, BM, HD)
                   : encode_2d(&ma, a, p.K, p.M, BM);
  if (!a_ok || !encode_2d(&mb, w, p.nout, p.K, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  p.frame_rows = p.M / frames;
  p.frame_tiles = (p.frame_rows + BM - 1) / BM;
  p.m_tiles = frames * p.frame_tiles;
  p.n_tiles = p.nout / BN;
  p.tiles = p.m_tiles * p.n_tiles;
  p.k_tiles = p.K / BK;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (const int err = prepare<EP, HD>()) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  const GemmKernel kernel = kernel_of<EP, HD>();
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_ln(const void* x, const void* ln_w, const void* ln_b, void* hn, int rows, int dim,
              float eps, void* stream) {
  if (rows < 0 || dim <= 0 || dim % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  ln_rows_kernel<<<(rows + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(hn), rows, dim, eps);
  return static_cast<int>(cudaGetLastError());
}

// x (B N, C) -> q, k, v (B, Hl, N, HD): the pre-pass into the (B N, C) bf16
// scratch hn, then hn @ W (C, 3 Hl HD) + b and the epilogue EP; C a multiple
// of 64 (the K slices), at HD = 64 Hl even (a 128-column tile never
// straddles q | k or k | v; at HD = 128 a tile is one head); Hl = C / HD is
// the whole width
template <int EP, int HD>
int launch_qkv(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* b,
               Params p, void* hn, int batch, int ntok, int dim, int heads, float eps,
               void* stream) {
  if (batch < 0 || ntok < 0 || heads <= 0 || heads % (BN / HD) || dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * ntok;
  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;
  p.bias = static_cast<const float*>(b);
  p.eps = eps;
  p.batch = batch;
  p.ntok = ntok;
  p.heads = heads;
  p.M = rows;
  p.K = dim;
  p.nout = 3 * heads * HD;
  return launch_gemm<EP, HD>(hn, w, p, stream);
}

// o (B, H, N, HD), x (B N, C) -> y = x + gamma * (merge_heads(o) @ Wp (C, C)
// + bp) (B N, C), C = HD heads, a multiple of 128
template <int HD>
int launch_proj(const void* o, const void* x, const void* wp, const void* bp,
                const void* gamma, void* y, int batch, int ntok, int heads, void* stream) {
  if (batch < 0 || ntok < 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.bias = static_cast<const float*>(bp);
  p.gamma = static_cast<const float*>(gamma);
  p.resid = static_cast<const bf16*>(x);
  p.out = y;
  p.batch = batch;
  p.ntok = ntok;
  p.heads = heads;
  p.M = batch * ntok;
  p.K = heads * HD;
  p.nout = heads * HD;
  return launch_gemm<E_PROJ, HD>(o, wp, p, stream);
}

// the parameters of LN+QKV+RoPE
Params rope_params(const void* qn_w, const void* qn_b, const void* kn_w, const void* kn_b,
                   const void* cos, const void* sin, void* q, void* k, void* v) {
  Params p = {};
  p.qn_w = static_cast<const float*>(qn_w);
  p.qn_b = static_cast<const float*>(qn_b);
  p.kn_w = static_cast<const float*>(kn_w);
  p.kn_b = static_cast<const float*>(kn_b);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  return p;
}

Params qkv_params(void* q, void* k, void* v) {
  Params p = {};
  p.q = static_cast<bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  return p;
}

}  // namespace

// x (B, N, C) -> q, k, v (B, Hl, N, 64): LN, @ W (C, 3 Hl 64) + b, qk-norm,
// RoPE; hn is a (B N, C) bf16 scratch buffer that the pre-pass writes and the
// product reads
extern "C" int sfm_ln_qkv_rope_sm90(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w, const void* b, const void* qn_w,
                                    const void* qn_b, const void* kn_w, const void* kn_b,
                                    const void* cos, const void* sin, void* q, void* k, void* v,
                                    void* hn, int batch, int ntok, int dim, int heads,
                                    float eps, void* stream) {
  const Params p = rope_params(qn_w, qn_b, kn_w, kn_b, cos, sin, q, k, v);
  return launch_qkv<E_QKV_ROPE, HD>(x, ln_w, ln_b, w, b, p, hn, batch, ntok, dim, heads, eps,
                                    stream);
}

// the same without qk-norm and RoPE (the ViT blocks)
extern "C" int sfm_ln_qkv_sm90(const void* x, const void* ln_w, const void* ln_b, const void* w,
                               const void* b, void* q, void* k, void* v, void* hn, int batch,
                               int ntok, int dim, int heads, float eps, void* stream) {
  return launch_qkv<E_QKV, HD>(x, ln_w, ln_b, w, b, qkv_params(q, k, v), hn, batch, ntok, dim,
                               heads, eps, stream);
}

// x (M, C) -> hn = LN(x) (M, C) bf16: the pre-pass alone
extern "C" int sfm_ln_rows_bf16(const void* x, const void* ln_w, const void* ln_b, void* hn,
                                int rows, int dim, float eps, void* stream) {
  return launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream);
}

// x (M, C) -> h = gelu(LN(x) @ W1 (C, Ch) + b1) (M, Ch); hn is an (M, C) bf16
// scratch buffer that the pre-pass writes and the product reads
extern "C" int sfm_mlp_up_sm90(const void* x, const void* ln_w, const void* ln_b,
                               const void* w1, const void* b1, void* h, void* hn, int rows,
                               int dim, int hidden, float eps, void* stream) {
  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;
  Params p = {};
  p.bias = static_cast<const float*>(b1);
  p.out = h;
  p.M = rows;
  p.K = dim;
  p.nout = hidden;
  return launch_gemm<E_GELU, HD>(hn, w1, p, stream);
}

// h (M, Ch), x (M, C) -> y = x + gamma * (h @ W2 (Ch, C) + b2) (M, C)
extern "C" int sfm_mlp_down_sm90(const void* h, const void* x, const void* w2, const void* b2,
                                 const void* gamma, void* y, int rows, int hidden, int dim,
                                 void* stream) {
  Params p = {};
  p.bias = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.resid = static_cast<const bf16*>(x);
  p.out = y;
  p.M = rows;
  p.K = hidden;
  p.nout = dim;
  return launch_gemm<E_RESID, HD>(h, w2, p, stream);
}

// o (B, H, N, 64), x (B N, C) -> y = x + gamma * (merge_heads(o) @ Wp (C, C)
// + bp) (B N, C), C = 64 heads, a multiple of 128
extern "C" int sfm_proj_residual_sm90(const void* o, const void* x, const void* wp,
                                      const void* bp, const void* gamma, void* y, int batch,
                                      int ntok, int heads, void* stream) {
  return launch_proj<HD>(o, x, wp, bp, gamma, y, batch, ntok, heads, stream);
}

// LN+QKV+RoPE, LN+QKV and the out-projection at head dim 128, with the
// head-dim-64 entries' arguments: W (C, 3 Hl 128), q / k / v and o (B, H, N,
// 128), the qk-norm parameters (128), cos / sin (N, 128); any Hl
extern "C" int sfm_ln_qkv_rope_d128_sm90(const void* x, const void* ln_w, const void* ln_b,
                                         const void* w, const void* b, const void* qn_w,
                                         const void* qn_b, const void* kn_w, const void* kn_b,
                                         const void* cos, const void* sin, void* q, void* k,
                                         void* v, void* hn, int batch, int ntok, int dim,
                                         int heads, float eps, void* stream) {
  const Params p = rope_params(qn_w, qn_b, kn_w, kn_b, cos, sin, q, k, v);
  return launch_qkv<E_QKV_ROPE, HD128>(x, ln_w, ln_b, w, b, p, hn, batch, ntok, dim, heads, eps,
                                       stream);
}

extern "C" int sfm_ln_qkv_d128_sm90(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w, const void* b, void* q, void* k, void* v,
                                    void* hn, int batch, int ntok, int dim, int heads, float eps,
                                    void* stream) {
  return launch_qkv<E_QKV, HD128>(x, ln_w, ln_b, w, b, qkv_params(q, k, v), hn, batch, ntok,
                                  dim, heads, eps, stream);
}

extern "C" int sfm_proj_residual_d128_sm90(const void* o, const void* x, const void* wp,
                                           const void* bp, const void* gamma, void* y, int batch,
                                           int ntok, int heads, void* stream) {
  return launch_proj<HD128>(o, x, wp, bp, gamma, y, batch, ntok, heads, stream);
}

// a (M, K) bf16 @ w (K, nout) bf16 -> out (M, nout) fp32, the accumulators
// as they are
extern "C" int sfm_gemm_sm90_probe(const void* a, const void* w, void* out, int rows, int k,
                                   int nout, void* stream) {
  Params p = {};
  p.out = out;
  p.M = rows;
  p.K = k;
  p.nout = nout;
  return launch_gemm<E_F32, HD>(a, w, p, stream);
}

// What the body was built with and what the compiler gave each kernel (0
// MLP-up, 1 MLP-down, 2 the probe, 3 the layer-norm pre-pass, 4 LN+QKV+RoPE,
// 5 LN+QKV, 6 the out-projection; 7-9 the last three at head dim 128):
// registers a thread at launch, local
// (spill) bytes a thread, dynamic shared memory a block, ring stages, rows
// and columns a tile, setmaxnreg of the producer and the consumers,
// ping-pong (1) or cooperative (0), row tiles a raster group.
extern "C" int sfm_gemm_sm90_info(int which, int* out) {
  cudaFuncAttributes attr;
  const void* fn = which == 0   ? reinterpret_cast<const void*>(mlp_up_sm90_kernel)
                   : which == 1 ? reinterpret_cast<const void*>(mlp_down_sm90_kernel)
                   : which == 2 ? reinterpret_cast<const void*>(gemm_probe_sm90_kernel)
                   : which == 3 ? reinterpret_cast<const void*>(ln_rows_kernel)
                   : which == 4 ? reinterpret_cast<const void*>(ln_qkv_rope_sm90_kernel)
                   : which == 5 ? reinterpret_cast<const void*>(ln_qkv_sm90_kernel)
                   : which == 6 ? reinterpret_cast<const void*>(proj_residual_sm90_kernel)
                   : which == 7 ? reinterpret_cast<const void*>(ln_qkv_rope_d128_sm90_kernel)
                   : which == 8 ? reinterpret_cast<const void*>(ln_qkv_d128_sm90_kernel)
                                : reinterpret_cast<const void*>(proj_residual_d128_sm90_kernel);
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = which == 3 ? 0 : SMEM_BYTES;
  out[3] = STAGES;
  out[4] = BM;
  out[5] = BN;
  out[6] = PRODUCER_REGS;
  out[7] = CONSUMER_REGS;
  out[8] = PINGPONG ? 1 : 0;
  out[9] = GROUP_M;
  return 0;
}
