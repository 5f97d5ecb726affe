// fp32 forms of the flash-attention backward (B9: the dq kernel and the dk/dv
// kernel, each without a mask and under a RelocMask), one body on the CUDA
// cores. fp32 q / k / v / do / lse / delta in, fp32 gradients out, head dim 64
// or 128 (a template parameter of the one body; the head dim 128 kernels
// carry "d128" in their names).
//
// Replaces the fp32 forms of the Pallas TPU kernels (dtype-generic there: the
// bf16 forms are flash_bwd_sm90.cu's)
//   dq:    self_supervise_sfm_tpu/ops/flash_attention.py  _flash_bwd / _dq_kernel
//   dk/dv: self_supervise_sfm_tpu/ops/flash_attention.py  _flash_bwd / _dkv_kernel
// (mask=None and mask=RelocMask) and computes what they compute for fp32
// inputs: p = exp2(s * scale * log2(e) - lse * log2(e)) recomputed from the
// saved natural-log lse, dp = do v^T, ds = p * (dp - delta) * scale with delta
// = rowsum(do * o) - dlse (computed in PyTorch beforehand), dq = ds k, dk =
// ds^T q, dv = p^T do. p and ds stay fp32 (the kernels' astype calls are
// no-ops at fp32), every sum is fp32 and the results are written in fp32. p
// is selected to 0 for a key past the end of the keys a tile streams (both
// kernels) and, in dk/dv, for a q row past the end of the rows it streams,
// whose q / do / lse / delta loads are zero-filled: a garbage row would carry
// NaN into the sums (the TPU kernel's note). As in flash_fwd_f32.cu the scale
// is folded into the FFMA of the exp2 argument (s * c - lse2, one rounding)
// and exp2 is ex2.approx.ftz (p below 2^-126 becomes 0).
//
// Bound on an H100 SXM: operations. The dq kernel does 3 and the dk/dv
// kernel 4 products of 2 Nq Nk D FLOPs (both recompute S and dP; under a
// mask, over the allowed pairs), 340-1700 FLOP a byte at the train step's
// sizes against the fp32 ridge of 67e12 / 3.35e12 = 20. At 67 TFLOP/s: the
// ViT / split-own site (32, 1374, 1374) 0.35 ms dq and 0.46 ms dk/dv, the
// frame site (64, 1374, 1374) and the global site (16, 2748, 2748) 0.69 /
// 0.92 ms, the split-context site (32, 1374 q rows, 610 keys) 0.15 / 0.21 ms;
// at head dim 128 the same sites in 8 heads, the same operations and bounds.
//
// Design (first version: right and simple, modelled on flash_fwd_f32.cu; a
// 3xTF32 tensor-core body is later work). 256 threads a block owning 64
// rows, thread (tr, tc) = (tid / 16, tid % 16) owning rows 4 tr .. 4 tr + 3
// of the block's own rows: of S / dP the streamed rows tc + 16 j (j < rows of
// a streamed tile / 16), of the accumulating products the channels 64 g + 4
// tc .. 64 g + 4 tc + 3 (g < D / 64). Shared-memory rows are padded to D + 4
// floats (68 or 132, 4 banks apart), so that the 16 rows a warp reads at
// once with float4 loads fall on distinct banks; the streamed tiles pass
// through two stages of 16-byte cp.async copies (the next tile's copies in
// flight while the current one computes; rows past a source's end
// zero-filled by a copy of 0 source bytes). P and dS go through shared
// memory in rows that the warp owning them writes and reads, ordered by a
// __syncwarp.
//   dq kernel: a block owns 64 q rows. Q, dO, and the rows' lse and delta
//   (plain loads into registers: an (B H, Nq) fp32 row is Nq * 4 bytes, so a
//   tile's 256 bytes need not be 16-byte aligned) are loaded once; K and V
//   stream in 64-key tiles. Per key tile S = Q K^T and dP = dO V^T (16 + 16
//   accumulators), dS to shared memory, then dQ += dS K (16 accumulators at
//   D = 64, 32 at 128). Shared memory: Q + dO + 2 x (K + V) + dS = 121,856
//   bytes at D = 64, 220,160 at 128; one block an SM.
//   dk/dv kernel: a block owns 64 keys. K and V are loaded once; Q, dO, lse
//   and delta stream in 64-row tiles (lse / delta by 4-byte cp.async, for the
//   alignment above). Per q tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
//   to shared memory, then dV += P^T dO and dK += dS^T Q (32 accumulators at
//   D = 64, 64 at 128). Shared memory: K + V + 2 x (Q + dO) + P^T + dS^T + 2
//   x (lse + delta) = 140,288 bytes at D = 64, one block an SM. At 128 two
//   stages of 64-row tiles would take 238,592 bytes, over the 232,448 a block
//   may have: the tiles stream through one stage (170,496 bytes; the next
//   tile's copies start after the products of this one). 32-row tiles
//   through two stages (KV_BQ_D128 = 32, KV_STAGES_D128 = 2: 154,112 bytes)
//   keep a copy in flight but halve S^T a step and double the tile loop's
//   barriers; tools/ablate_attention.py's "f32" part times both, and the one
//   stage ran 7-9 % faster on an H100.
// Every output row has one owner (one block) and one fixed order of tiles: no
// split over the other axis, no atomics, and a repeat is bit-equal.
//
// The RelocMask forms (flash_bwd_{dq,dkv}_reloc_f32_kernel) are the same
// bodies with MASKED set. The keys are [n_ctx context | F frames of P], and a
// q row of frame f sees the context and frame f's keys. The mask is block
// structured, so it is expressed by where the tiles start and end, not by a
// test per element, as in flash_bwd_sm90.cu:
//   dq: a block's 64 q rows lie within one frame (its tiles restart at f P).
//   It streams the context's key tiles, then its own frame's, each source from
//   its own key 0 and with its own end.
//   dk/dv: a block's 64 keys lie within one segment. A context block streams
//   all Nq q rows; a frame-f block only rows [f P, (f + 1) P).
//   Loads and stores compare against the tile's own end, not N: a tile's tail
//   rows belong to another tile, and nothing outside the allowed pairs is
//   loaded. Without a mask a launch has the context = all Nk keys and one
//   frame of Nq rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows a block owns: q rows (dq) or keys (dk/dv)
constexpr int BN = 64;          // rows a streamed tile at head dim 64: keys (dq) or q rows (dk/dv)
constexpr int DQ_BK_D128 = 64;  // keys a K / V tile of dq at head dim 128
constexpr int KV_BQ_D128 = 64;  // q rows a Q / dO tile of dk/dv at head dim 128
constexpr int KV_STAGES_D128 = 1;  // stages of those tiles (1 or 2)
constexpr int NTHREADS = 256;   // 16 row groups of 4 rows x 16 lanes
constexpr float LOG2E = 1.4426950408889634f;

// The tiling at head dim D (64 or 128): rows of D + 4 floats (4 banks
// apart); dq streams KN-key K / V tiles through two stages, dk/dv QN-row Q /
// dO tiles (and their lse / delta) through KV_STAGES; P, dS and their
// transposes in rows of (streamed rows + 4) floats.
template <int D>
struct Tiling {
  static constexpr int LD = D + 4;
  static constexpr int KN = D == 64 ? BN : DQ_BK_D128;
  static constexpr int QN = D == 64 ? BN : KV_BQ_D128;
  static constexpr int KV_STAGES = D == 64 ? 2 : KV_STAGES_D128;
  // Q, dO, K x 2, V x 2, dS
  static constexpr int DQ_SMEM_BYTES = (2 * BM * LD + 4 * KN * LD + BM * (KN + 4)) * 4;
  // K, V, (Q, dO) x stages, P^T, dS^T, (lse, delta) x stages
  static constexpr int DKV_SMEM_BYTES =
      (2 * BM * LD + 2 * KV_STAGES * QN * LD + 2 * BM * (QN + 4) + KV_STAGES * 2 * QN) * 4;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // (B H, nq), natural log
  const float* delta;  // (B H, nq): rowsum(do * o) - dlse
  float* out0;         // dq, or dk
  float* out1;         // dv
  int nq;
  int nk;
  // keys [n_ctx context | frames x frame own keys]; a q row of frame f sees
  // the context and frame f's keys. Without a mask: n_ctx = nk and one frame
  // of nq rows.
  int n_ctx;
  int frame;
  int frames;
  float scale_log2;  // scale * log2(e)
  float scale;       // head_dim ** -0.5
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 (or 4) bytes from device memory into shared memory; with src_bytes 0
// nothing is read and the bytes are zero
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a slice's (N, D) rows into a padded tile: ROWS
// rows x D / 4 chunks of 16 bytes; rows at or past `end` zero
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int end) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 4;
    const bool ok = r0 + r < end;
    const float* s = ok ? src + static_cast<long long>(r0 + r) * D + col : src;
    cp_async16(dst + r * Tiling<D>::LD + col, s, ok ? 16 : 0);
  }
}

// the 4 x JN register tile of a product over D channels: rows 4 tr + i of A
// against rows tc + 16 j of B, both padded tiles; 4 channels a step, the
// channel loop unrolled 8 steps at a time (fully unrolled, ptxas hoisted the
// loads of later steps until one kernel spilled at 255 registers, and the
// head dim 128 kernels took ~40 s to compile)
template <int D, int JN>
__device__ __forceinline__ void rows_dot(float (&s)[4][JN], const float* a_tile,
                                         const float* b_tile, int tr, int tc) {
  constexpr int LD = Tiling<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; dd += 4) {
    float4 a[4], b[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_tile + (4 * tr + i) * LD + dd);
#pragma unroll
    for (int j = 0; j < JN; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_tile + (tc + 16 * j) * LD + dd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc (rows 4 tr + i, channels 64 g + 4 tc .. 64 g + 4 tc + 3) += A B over
// the tile's ROWS streamed rows: A the warp's own rows of a padded (64 x
// ROWS) tile, B a padded (ROWS rows x D channels) tile; 4 rows of B a step,
// in order
template <int D, int ROWS>
__device__ __forceinline__ void acc_product(float (&acc)[4][D / 16], const float* a_tile,
                                            const float* b_tile, int tr, int tc) {
  constexpr int LD = Tiling<D>::LD, LDA = ROWS + 4;
#pragma unroll
  for (int kk = 0; kk < ROWS; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_tile + (4 * tr + i) * LDA + kk);
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      float4 b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(b_tile + (kk + c) * LD + 64 * g + 4 * tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
        float* ag = acc[i] + 4 * g;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ag[0] = fmaf(ai[c], b[c].x, ag[0]);
          ag[1] = fmaf(ai[c], b[c].y, ag[1]);
          ag[2] = fmaf(ai[c], b[c].z, ag[2]);
          ag[3] = fmaf(ai[c], b[c].w, ag[3]);
        }
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][D / 16],
                                           long long row0, int r0, int end, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * tr + i;
    if (r >= end) continue;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float* ag = acc[i] + 4 * g;
      *reinterpret_cast<float4*>(out + (row0 + r) * D + 64 * g + 4 * tc) =
          make_float4(ag[0], ag[1], ag[2], ag[3]);
    }
  }
}

// -- dq -----------------------------------------------------------------------

// Block (x, slice): the x-th 64-row tile of the slice's frames, 64 q rows from
// the frame's first row, clipped at its last; it streams the context's key
// tiles, then (MASKED) its frame's own
template <int D, bool MASKED>
__device__ __forceinline__ void dq_body(const Params& p) {
  using T = Tiling<D>;
  constexpr int LD = T::LD, KN = T::KN, LDS = KN + 4, JN = KN / 16;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sdo = smem + BM * LD;
  float* sk = sdo + BM * LD;  // two stages
  float* sv = sk + 2 * KN * LD;  // two stages
  float* sds = sv + 2 * KN * LD;

  const int slice = blockIdx.y;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int per_frame = cdiv(p.frame, BM);
  const int f0 = static_cast<int>(blockIdx.x) / per_frame * p.frame;
  const int q0 = f0 + static_cast<int>(blockIdx.x) % per_frame * BM;
  const int q_end = min(q0 + BM, f0 + p.frame);
  const long long qrow = static_cast<long long>(slice) * p.nq;
  const float* qs = p.q + qrow * D;
  const float* dos = p.dout + qrow * D;
  const float* ks = p.k + static_cast<long long>(slice) * p.nk * D;
  const float* vs = p.v + static_cast<long long>(slice) * p.nk * D;
  const int ctx_tiles = cdiv(p.n_ctx, KN);
  const int own0 = p.n_ctx + f0;
  const int tiles = ctx_tiles + (MASKED ? cdiv(p.frame, KN) : 0);

  // key tile t: its first key and the end of its source
  auto key_tile = [&](int t, int* end) {
    if (t < ctx_tiles) {
      *end = p.n_ctx;
      return t * KN;
    }
    *end = own0 + p.frame;
    return own0 + (t - ctx_tiles) * KN;
  };
  auto load_kv = [&](int t, int st) {
    int end;
    const int k0 = key_tile(t, &end);
    load_tile<D, KN>(sk + st * KN * LD, ks, k0, end);
    load_tile<D, KN>(sv + st * KN * LD, vs, k0, end);
    cp_async_commit();
  };

  // Q and dO ride in the first K / V tile's copy group
  load_tile<D, BM>(sq, qs, q0, q_end);
  load_tile<D, BM>(sdo, dos, q0, q_end);
  if (tiles > 0) load_kv(0, 0);
  else cp_async_commit();

  float lse2[4], dl[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * tr + i;
    const bool ok = r < q_end;
    lse2[i] = (ok ? p.lse[qrow + r] : 0.f) * LOG2E;
    dl[i] = ok ? p.delta[qrow + r] : 0.f;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      load_kv(t + 1, st ^ 1);  // that stage was released by the last tile's barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + st * KN * LD;
    const float* vt = sv + st * KN * LD;

    // S = Q K^T and dP = dO V^T: rows 4 tr + i, keys tc + 16 j
    float s[4][JN], dp[4][JN];
    rows_dot<D, JN>(s, sq, kt, tr, tc);
    rows_dot<D, JN>(dp, sdo, vt, tr, tc);

    // dS = P (dP - delta) scale, p selected to 0 past the source's end; to
    // shared memory, the rows of this warp's two row groups
    int end;
    const int k0 = key_tile(t, &end);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float pe = exp2_ftz(fmaf(s[i][j], p.scale_log2, -lse2[i]));
        pe = k0 + tc + 16 * j < end ? pe : 0.f;
        sds[(4 * tr + i) * LDS + tc + 16 * j] = pe * (dp[i][j] - dl[i]) * p.scale;
      }
    __syncwarp();

    // dQ += dS K
    acc_product<D, KN>(acc, sds, kt, tr, tc);
    // every warp is done with this stage and with its dS rows
    __syncthreads();
  }
  cp_async_wait<0>();  // with no key tile, Q's and dO's copies are still in flight
  store_rows<D>(p.out0, acc, qrow, q0, q_end, tr, tc);
}

// -- dk/dv --------------------------------------------------------------------

// Block (x, slice): the x-th 64-key tile of the slice, the context's first
// (each streams all nq q rows), then (MASKED) each frame's, 64 keys from the
// frame's first key, clipped at its last (each streams its frame's q rows)
template <int D, bool MASKED>
__device__ __forceinline__ void dkv_body(const Params& p) {
  using T = Tiling<D>;
  constexpr int LD = T::LD, QN = T::QN, LDP = QN + 4, JN = QN / 16, STAGES = T::KV_STAGES;
  static_assert(STAGES == 1 || STAGES == 2, "dk/dv streams through one or two stages");
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = smem + BM * LD;
  float* sq = sv + BM * LD;              // STAGES stages
  float* sdo = sq + STAGES * QN * LD;    // STAGES stages
  float* spt = sdo + STAGES * QN * LD;
  float* sdst = spt + BM * LDP;
  float* srow = sdst + BM * LDP;  // STAGES stages of [lse QN | delta QN]

  const int slice = blockIdx.y;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int ctx_tiles = cdiv(p.n_ctx, BM);
  int k0, k_end, s0, s_end;
  if (!MASKED || static_cast<int>(blockIdx.x) < ctx_tiles) {
    k0 = blockIdx.x * BM;
    k_end = min(k0 + BM, p.n_ctx);
    s0 = 0;
    s_end = p.nq;
  } else {
    const int t = blockIdx.x - ctx_tiles, per_frame = cdiv(p.frame, BM);
    s0 = t / per_frame * p.frame;
    s_end = s0 + p.frame;
    k0 = p.n_ctx + s0 + t % per_frame * BM;
    k_end = min(k0 + BM, p.n_ctx + s_end);
  }
  const long long qrow = static_cast<long long>(slice) * p.nq;
  const long long krow = static_cast<long long>(slice) * p.nk;
  const float* qs = p.q + qrow * D;
  const float* dos = p.dout + qrow * D;
  const int tiles = cdiv(s_end - s0, QN);

  auto load_q = [&](int t, int st) {
    const int r0 = s0 + t * QN;
    load_tile<D, QN>(sq + st * QN * LD, qs, r0, s_end);
    load_tile<D, QN>(sdo + st * QN * LD, dos, r0, s_end);
    if (threadIdx.x < 2 * QN) {  // lse, then delta: 4 bytes a row, zero past s_end
      const int r = r0 + (threadIdx.x & (QN - 1));
      const bool ok = r < s_end;
      const float* src = threadIdx.x < QN ? p.lse : p.delta;
      cp_async4(srow + st * 2 * QN + threadIdx.x, ok ? src + qrow + r : src, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  // K and V ride in the first q tile's copy group
  load_tile<D, BM>(sk, p.k + krow * D, k0, k_end);
  load_tile<D, BM>(sv, p.v + krow * D, k0, k_end);
  if (tiles > 0) load_q(0, 0);
  else cp_async_commit();

  bool kok[4];
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kok[i] = k0 + 4 * tr + i < k_end;
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int st = STAGES == 2 ? t & 1 : 0;
    if (STAGES == 2 && t + 1 < tiles) {
      load_q(t + 1, st ^ 1);  // that stage was released by the last tile's barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = sq + st * QN * LD;
    const float* dot = sdo + st * QN * LD;
    const float* rowv = srow + st * 2 * QN;

    // S^T = K Q^T and dP^T = V dO^T: keys 4 tr + i, q rows tc + 16 j
    float s[4][JN], dp[4][JN];
    rows_dot<D, JN>(s, sk, qt, tr, tc);
    rows_dot<D, JN>(dp, sv, dot, tr, tc);

    // P^T and dS^T = P^T (dP^T - delta) scale, p selected to 0 past the keys'
    // and the q rows' ends; to shared memory, the rows of this warp's two
    // row groups
    const int q0 = s0 + t * QN;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int c = tc + 16 * j;
      const bool qok = q0 + c < s_end;
      const float l2 = rowv[c] * LOG2E, dl = rowv[QN + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pe = exp2_ftz(fmaf(s[i][j], p.scale_log2, -l2));
        pe = kok[i] && qok ? pe : 0.f;
        spt[(4 * tr + i) * LDP + c] = pe;
        sdst[(4 * tr + i) * LDP + c] = pe * (dp[i][j] - dl) * p.scale;
      }
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q
    acc_product<D, QN>(dv, spt, dot, tr, tc);
    acc_product<D, QN>(dk, sdst, qt, tr, tc);
    // every warp is done with this stage and with its P^T / dS^T rows
    __syncthreads();
    if (STAGES == 1 && t + 1 < tiles) load_q(t + 1, 0);
  }
  cp_async_wait<0>();  // with no q tile, K's and V's copies are still in flight
  store_rows<D>(p.out0, dk, krow, k0, k_end, tr, tc);
  store_rows<D>(p.out1, dv, krow, k0, k_end, tr, tc);
}

#define SFM_BWD_KERNELS(HD, SUFFIX)                                                             \
  __global__ void __launch_bounds__(NTHREADS, 1) flash_bwd_dq_##SUFFIX##kernel(const Params p) { \
    dq_body<HD, false>(p);                                                                      \
  }                                                                                             \
  __global__ void __launch_bounds__(NTHREADS, 1)                                                \
      flash_bwd_dkv_##SUFFIX##kernel(const Params p) {                                         \
    dkv_body<HD, false>(p);                                                                     \
  }                                                                                             \
  __global__ void __launch_bounds__(NTHREADS, 1)                                                \
      flash_bwd_dq_reloc_##SUFFIX##kernel(const Params p) {                                    \
    dq_body<HD, true>(p);                                                                       \
  }                                                                                             \
  __global__ void __launch_bounds__(NTHREADS, 1)                                                \
      flash_bwd_dkv_reloc_##SUFFIX##kernel(const Params p) {                                   \
    dkv_body<HD, true>(p);                                                                      \
  }

SFM_BWD_KERNELS(64, f32_)
SFM_BWD_KERNELS(128, d128_f32_)
#undef SFM_BWD_KERNELS

constexpr int KERNELS = 8;  // dq, dk/dv, and their RelocMask forms; at 64, then at 128

const void* kernel_of(int which) {
  static const void* const table[KERNELS] = {
      reinterpret_cast<const void*>(flash_bwd_dq_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dkv_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dq_reloc_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dkv_reloc_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dq_d128_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dkv_d128_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dq_reloc_d128_f32_kernel),
      reinterpret_cast<const void*>(flash_bwd_dkv_reloc_d128_f32_kernel)};
  return table[which];
}

template <int D>
int smem_of(int form) {
  return form % 2 == 0 ? Tiling<D>::DQ_SMEM_BYTES : Tiling<D>::DKV_SMEM_BYTES;
}

int smem_of_kernel(int which) { return which < 4 ? smem_of<64>(which) : smem_of<128>(which); }

// -- host side ----------------------------------------------------------------

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// Launch kernel `form` (0 dq, 1 dk/dv, 2 and 3 their RelocMask forms) at head
// dim D over (tiles of a slice, slices); a kernel's first launch sets its
// dynamic shared memory limit (above the 48 KB default).
template <int D>
int launch(int form, const Params& p, int tiles, int slices, void* stream) {
  static bool ready[4] = {};
  const int which = form + (D == 128 ? 4 : 0);
  if (slices <= 0 || tiles <= 0) return 0;
  if (slices > 65535 || !aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) ||
      !aligned16(p.dout) || !aligned16(p.out0) || (p.out1 && !aligned16(p.out1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_of<D>(form);
  if (!ready[form]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[form] = true;
  }
  Params arg = p;
  void* args[] = {&arg};
  const cudaError_t err = cudaLaunchKernel(kernel_of(which), dim3(tiles, slices),
                                           dim3(NTHREADS), args, smem,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Params of a launch; without a mask (n_ctx < 0) the context is every key and
// the q rows one frame. Returns false on shapes that do not agree.
bool make_params(Params* p, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* out0, void* out1, int nq, int nk,
                 int n_ctx, int frame_size, float scale_log2, float scale) {
  const bool masked = n_ctx >= 0;
  if (nq < 0 || nk < 0) return false;
  if (masked && (frame_size <= 0 || nq % frame_size || nk != n_ctx + nq)) return false;
  *p = Params{};
  p->q = static_cast<const float*>(q);
  p->k = static_cast<const float*>(k);
  p->v = static_cast<const float*>(v);
  p->dout = static_cast<const float*>(dout);
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->out0 = static_cast<float*>(out0);
  p->out1 = static_cast<float*>(out1);
  p->nq = nq;
  p->nk = nk;
  p->n_ctx = masked ? n_ctx : nk;
  p->frame = masked ? frame_size : nq;
  p->frames = masked ? nq / frame_size : 1;
  p->scale_log2 = scale_log2;
  p->scale = scale;
  return true;
}

template <int D>
int launch_dq(bool masked, const Params& p, int bh, void* stream) {
  if (p.nq == 0 || p.nk == 0) return 0;
  return launch<D>(masked ? 2 : 0, p, p.frames * cdiv(p.frame, BM), bh, stream);
}

template <int D>
int launch_dkv(bool masked, const Params& p, int bh, void* stream) {
  if (p.nq == 0 || p.nk == 0) return 0;
  const int own = masked ? p.frames * cdiv(p.frame, BM) : 0;
  return launch<D>(masked ? 3 : 1, p, cdiv(p.n_ctx, BM) + own, bh, stream);
}

// The entries at head dim D; n_ctx < 0: no mask
template <int D>
int dq_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int nq, int nk, int n_ctx, int frame_size,
             float scale_log2, float scale, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, dout, lse, delta, dq, nullptr, nq, nk, n_ctx, frame_size,
                   scale_log2, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<D>(n_ctx >= 0, p, bh, stream);
}

template <int D>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int nq, int nk, int n_ctx,
              int frame_size, float scale_log2, float scale, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, dout, lse, delta, dk, dv, nq, nk, n_ctx, frame_size,
                   scale_log2, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv<D>(n_ctx >= 0, p, bh, stream);
}

}  // namespace

// q / dout: (bh, nq, 64), k / v: (bh, nk, 64), lse / delta: (bh, nq); dq
// (bh, nq, 64); fp32, contiguous. The arguments of sfm_flash_bwd_dq_sm90.
extern "C" int sfm_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int bh, int nq, int nk, float scale_log2,
                                    float scale, void* stream) {
  return dq_entry<64>(q, k, v, dout, lse, delta, dq, bh, nq, nk, -1, 0, scale_log2, scale,
                      stream);
}

// As above; dk / dv (bh, nk, 64) fp32.
extern "C" int sfm_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int nq, int nk,
                                     float scale_log2, float scale, void* stream) {
  return dkv_entry<64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, -1, 0, scale_log2, scale,
                       stream);
}

// The same under a RelocMask: nk == n_ctx + nq, the q rows frames of
// frame_size.
extern "C" int sfm_flash_bwd_dq_reloc_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int bh, int nq, int nk, int n_ctx,
                                          int frame_size, float scale_log2, float scale,
                                          void* stream) {
  if (n_ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dq_entry<64>(q, k, v, dout, lse, delta, dq, bh, nq, nk, n_ctx, frame_size,
                      scale_log2, scale, stream);
}

extern "C" int sfm_flash_bwd_dkv_reloc_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int nq, int nk, int n_ctx, int frame_size,
                                           float scale_log2, float scale, void* stream) {
  if (n_ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dkv_entry<64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, n_ctx, frame_size,
                       scale_log2, scale, stream);
}

// The four at head dim 128: (bh, n, 128) rows, the same arguments.
extern "C" int sfm_flash_bwd_dq_d128_f32(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, int bh, int nq, int nk, float scale_log2,
                                         float scale, void* stream) {
  return dq_entry<128>(q, k, v, dout, lse, delta, dq, bh, nq, nk, -1, 0, scale_log2, scale,
                       stream);
}

extern "C" int sfm_flash_bwd_dkv_d128_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int bh, int nq, int nk,
                                          float scale_log2, float scale, void* stream) {
  return dkv_entry<128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, -1, 0, scale_log2,
                        scale, stream);
}

extern "C" int sfm_flash_bwd_dq_reloc_d128_f32(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dq, int bh, int nq,
                                               int nk, int n_ctx, int frame_size,
                                               float scale_log2, float scale, void* stream) {
  if (n_ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dq_entry<128>(q, k, v, dout, lse, delta, dq, bh, nq, nk, n_ctx, frame_size,
                       scale_log2, scale, stream);
}

extern "C" int sfm_flash_bwd_dkv_reloc_d128_f32(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dk, void* dv, int bh,
                                                int nq, int nk, int n_ctx, int frame_size,
                                                float scale_log2, float scale, void* stream) {
  if (n_ctx < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dkv_entry<128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, n_ctx, frame_size,
                        scale_log2, scale, stream);
}

// What the body was built with and what the compiler gave each kernel (0 dq,
// 1 dk/dv, 2 and 3 their RelocMask forms; 4-7 the same at head dim 128):
// registers a thread, local (spill) bytes a thread, dynamic shared memory a
// block, rows a block owns, rows a streamed tile, threads a block, the blocks
// an SM holds at once, and the stages of the streamed tiles.
extern "C" int sfm_flash_bwd_f32_info(int which, int* out) {
  if (which < 0 || which >= KERNELS) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_of(which);
  const int smem = smem_of_kernel(which);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NTHREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool dq = which % 2 == 0, d128 = which >= 4;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = smem;
  out[3] = BM;
  out[4] = dq ? (d128 ? Tiling<128>::KN : Tiling<64>::KN) : (d128 ? Tiling<128>::QN : Tiling<64>::QN);
  out[5] = NTHREADS;
  out[6] = blocks;
  out[7] = dq ? 2 : (d128 ? Tiling<128>::KV_STAGES : Tiling<64>::KV_STAGES);
  return 0;
}
