// Flash-attention forward under a RelocMask (K1m) and backward (B9: the dq
// and dk/dv kernels, each with its RelocMask variant), for Hopper (sm_90a),
// bf16 in, fp32 softmax state, head dim 64.
//
// Replaces the Pallas TPU kernels
//   K1m: self_supervise_sfm_tpu/ops/flash_attention.py  _flash_fwd / _kernel
//        with mask=RelocMask
//   B9:  self_supervise_sfm_tpu/ops/flash_attention.py  _flash_bwd's two
//        pallas_calls, _dq_kernel and _dkv_kernel
// The unmasked forward (K1) and the [context | own frame] attention (K2, and
// K2p on the kv2 cache) moved to flash_fwd_sm90.cu, one body redesigned for
// Hopper (TMA ring, wgmma, warp specialisation). K1m and B9 keep the simple
// first body below; their redesigns are queued.
//
// K1m computes what _kernel computes under the mask: an online softmax in the
// log2 domain (exp2f), fp32 running max / denominator / accumulator, p cast to
// bf16 before the PV product, ragged last key tile masked by select with its
// V rows zeroed, the l == 0 guard at finalize, out in bf16 and the
// natural-log lse in fp32. It evaluates the RelocMask per element (key <
// n_ctx, or key inside the row's own frame) and skips key tiles in which no
// row of the block sees a key.
//
// Bound on an H100: operations. The 4*Nq*Nk*d FLOPs of QK^T and PV over the
// q/k/v/o bytes give 690-3450 FLOP/byte at the main-path sizes, above the
// card's ~295 FLOP/byte ridge, so the floor is the bf16 tensor-core rate.
// Design (the simple first version): one block of 4 warps per (batch*head,
// 64-row q tile); each warp owns 16 q rows and keeps its Q fragments, the
// 16x64 fp32 accumulator and the row state in registers. The block streams
// 64-key tiles of K (row-major) and V (transposed) through padded shared
// memory, and every warp runs mma.sync m16n8k16 bf16 products on them; the S
// accumulator is reused in registers as the A operand of PV (no shared-memory
// round trip for P). No cp.async/TMA pipelining and no wgmma, so it reaches
// only a fraction of the tensor-core rate.
//
// B9, the backward (replaces _flash_bwd's two pallas_calls, _dq_kernel and
// _dkv_kernel, with or without a RelocMask): both kernels recompute
// p = exp2(s * scale * log2(e) - lse * log2(e)) from the saved natural-log
// lse (0 where masked or out of bounds) and ds = p * (do v^T - delta) *
// scale, with delta = rowsum(do * o) - dlse computed in PyTorch beforehand.
// dq kernel: one block of 4 warps per (batch*head, 64-row q tile); each
//   warp keeps its Q and dO fragments, lse and delta of its 16 rows and the
//   16x64 fp32 dq accumulator in registers and streams 64-key tiles of K
//   (row-major and transposed) and V through shared memory (k innermost).
// dk/dv kernel: one block of 4 warps per (batch*head, 64-row key tile);
//   each warp keeps the K and V fragments of its 16 keys and the two 16x64
//   fp32 accumulators in registers, computes the transposed tiles S^T and
//   dP^T, and streams 64-row q tiles of Q and dO (row-major and transposed)
//   with their lse, delta and frame index through shared memory (q
//   innermost).
// Every output row has one owner and a fixed summation order: no atomics,
// so the gradients are the same from run to run. ds and p are rounded to
// bf16 before their products, as the TPU kernels do. Guards as on the TPU:
// ragged tiles are consumed unpadded; out-of-bounds K/V rows load as zeros
// in the dq kernel, out-of-bounds q-side rows (q, do, lse, delta) as zeros
// in the dk/dv kernel, and p is zero-selected on key and q validity; a
// RelocMask block skips tiles no pair of its rows and keys can see.
// Bound on an H100: operations. The dq kernel does 3 and the dk/dv kernel 4
// products of 2*Nq*Nk*d FLOPs (both recompute S and dP), 3.5x the forward.
// Same simple design as K1m: mma.sync m16n8k16, one tile in flight,
// transposed tiles stored element by element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // q rows per block, 16 per warp
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr int LDS = D + 8;     // padded shared row stride (bf16): conflict-free fragment loads
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct TileSmem {
  bf16 k[BK][LDS];   // K tile, row = key
  bf16 vt[D][LDS];   // V tile transposed, row = head-dim channel
};

struct RowState {
  float acc[D / 8][4];  // 16 x 64 fp32 accumulator in mma C layout
  float m[2];           // running max (log2 domain) of rows g and g + 8
  float l[2];           // running denominator
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q fragments (A operand, 4 k-steps of 16 channels) of this warp's 16 rows.
// Rows past nq load as zeros; their outputs are never stored.
__device__ __forceinline__ void load_q(const bf16* __restrict__ q, int row0,
                                       int nq, uint32_t (&qf)[D / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + t * 2;
    qf[ks][0] = r0 < nq ? *reinterpret_cast<const uint32_t*>(q + (size_t)r0 * D + c) : 0u;
    qf[ks][1] = r1 < nq ? *reinterpret_cast<const uint32_t*>(q + (size_t)r1 * D + c) : 0u;
    qf[ks][2] = r0 < nq ? *reinterpret_cast<const uint32_t*>(q + (size_t)r0 * D + c + 8) : 0u;
    qf[ks][3] = r1 < nq ? *reinterpret_cast<const uint32_t*>(q + (size_t)r1 * D + c + 8) : 0u;
  }
}

// Stage keys [k0, k0 + BK) of one (batch*head) slice into shared memory;
// keys at or past nvalid are zero-filled (the TPU kernel's v zeroing).
__device__ __forceinline__ void load_kv_tile(const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, int k0,
                                             int nvalid, TileSmem& sm) {
  for (int c = threadIdx.x; c < BK * D / 8; c += NTHREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + row < nvalid) {
      kk = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + row) * D + col);
      vv = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + row) * D + col);
    }
    *reinterpret_cast<uint4*>(&sm.k[row][col]) = kk;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.vt[col + i][row] = ve[i];
  }
}

// The RelocMask as one thread sees it: keys below n_ctx are the context, and
// the thread's rows g / g + 8 also see their own frame's keys [lo, hi).
struct RowMask {
  int n_ctx;
  int lo[2];
  int hi[2];
};

// Fold one staged key tile into the warp's online softmax (the TPU
// kernel's _compute / _online_step body) under the RelocMask's allow
// predicate and the key-validity select.
__device__ __forceinline__ void attend_tile(RowState& st,
                                            const uint32_t (&qf)[D / 16][4],
                                            const TileSmem& sm, int k0,
                                            int nvalid, float scale_log2,
                                            const RowMask& mk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[BK / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* kp = &sm.k[nt * 8 + g][ks * 16 + t * 2];
      mma_16816(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }
  // log2-scaled logits; keys past nvalid forced by select
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + t * 2 + (e & 1);
      const int r = e >> 1;
      const bool ok = key < nvalid && (key < mk.n_ctx || (key >= mk.lo[r] && key < mk.hi[r]));
      s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_INF;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float m0 = fmaxf(st.m[0], mx0), m1 = fmaxf(st.m[1], mx1);
  const float alpha0 = exp2f(st.m[0] - m0), alpha1 = exp2f(st.m[1] - m1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - m0);
    s[nt][1] = exp2f(s[nt][1] - m0);
    s[nt][2] = exp2f(s[nt][2] - m1);
    s[nt][3] = exp2f(s[nt][3] - m1);
    sum0 += s[nt][0] + s[nt][1];
    sum1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  st.m[0] = m0;
  st.m[1] = m1;
  st.l[0] = st.l[0] * alpha0 + sum0;
  st.l[1] = st.l[1] * alpha1 + sum1;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    st.acc[dn][0] *= alpha0;
    st.acc[dn][1] *= alpha0;
    st.acc[dn][2] *= alpha1;
    st.acc[dn][3] *= alpha1;
  }
  // P (bf16, from the S accumulator registers) @ V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const bf16* vp = &sm.vt[dn * 8 + g][kk * 16 + t * 2];
      mma_16816(st.acc[dn], a, *reinterpret_cast<const uint32_t*>(vp),
                *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }
}

__device__ __forceinline__ void init_state(RowState& st) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    st.acc[dn][0] = st.acc[dn][1] = st.acc[dn][2] = st.acc[dn][3] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
}

// out = acc / l (l == 0 guarded), bf16; lse = m / log2(e) + log(l) if asked.
__device__ __forceinline__ void finalize(const RowState& st, bf16* __restrict__ o,
                                         float* __restrict__ lse, int row0,
                                         int nq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float l0 = st.l[0] == 0.f ? 1.f : st.l[0];
  const float l1 = st.l[1] == 0.f ? 1.f : st.l[1];
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + t * 2;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + c) =
          pack_bf16(st.acc[dn][0] / l0, st.acc[dn][1] / l0);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + c) =
          pack_bf16(st.acc[dn][2] / l1, st.acc[dn][3] / l1);
  }
  if (lse != nullptr && t == 0) {
    if (r0 < nq) lse[r0] = st.m[0] * (1.0f / LOG2E) + logf(l0);
    if (r1 < nq) lse[r1] = st.m[1] * (1.0f / LOG2E) + logf(l1);
  }
}

// K1m: K1 under a RelocMask. Keys are [n_ctx context | frames of frame_size];
// row r (frame r / frame_size) sees the context and its own frame. A key tile
// in which no row of this block's 64 sees a key is skipped by the whole block
// (the TPU kernel's block_visible). The block's first visible tile can leave
// a row with every entry masked (m stays NEG_INF and p = exp2(0) = 1, as on
// the TPU); the row's first real key then rescales that by exp2(-1e30) = 0.
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_reloc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int nq, int nk, int n_ctx,
                       int frame_size, float scale_log2) {
  __shared__ __align__(16) TileSmem sm;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, nq);
  const int row0 = q0 + (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t qf[D / 16][4];
  load_q(q + bh * nq * D, row0, nq, qf);
  RowState st;
  init_state(st);
  RowMask mk;
  mk.n_ctx = n_ctx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mk.lo[r] = n_ctx + ((row0 + g + 8 * r) / frame_size) * frame_size;
    mk.hi[r] = mk.lo[r] + frame_size;
  }
  // the frames this block's rows belong to, as a key range
  const int own_lo = n_ctx + (q0 / frame_size) * frame_size;
  const int own_hi = n_ctx + ((q1 - 1) / frame_size + 1) * frame_size;
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    const int k1 = min(k0 + BK, nk);
    const bool visible = k0 < n_ctx || (k0 < own_hi && k1 > own_lo);
    if (!visible) continue;  // uniform over the block
    __syncthreads();
    load_kv_tile(kb, vb, k0, nk, sm);
    __syncthreads();
    attend_tile(st, qf, sm, k0, nk, scale_log2, mk);
  }
  finalize(st, o + bh * nq * D, lse + bh * nq, row0, nq);
}

// -- B9: flash backward -------------------------------------------------------

// dq kernel tiles: K row-major (B of S = Q K^T), V row-major (B of
// dP = dO V^T), K transposed (B of dQ = dS K).
struct DqSmem {
  bf16 k[BK][LDS];
  bf16 v[BK][LDS];
  bf16 kt[D][LDS];
};

// dk/dv kernel tiles: Q and dO row-major (B of S^T = K Q^T, dP^T = V dO^T),
// transposed (B of dK += dS^T Q, dV += P^T dO), and the per-row lse (log2
// domain), delta and frame index of the q tile.
struct DkvSmem {
  bf16 q[BQ][LDS];
  bf16 dout[BQ][LDS];
  bf16 qt[D][LDS];
  bf16 dot[D][LDS];
  float lse2[BQ];
  float delta[BQ];
  int frame[BQ];
};

// Stage rows [r0, r0 + 64) of a and b (row stride D): row-major and
// transposed. Rows at or past nvalid are zero-filled.
__device__ __forceinline__ void load_pair_tile(const bf16* __restrict__ a,
                                               const bf16* __restrict__ b,
                                               int r0, int nvalid,
                                               bf16 (*a_rm)[LDS], bf16 (*b_rm)[LDS],
                                               bf16 (*a_t)[LDS], bf16 (*b_t)[LDS]) {
  for (int c = threadIdx.x; c < BK * D / 8; c += NTHREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 aa = make_uint4(0u, 0u, 0u, 0u), bb = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < nvalid) {
      aa = *reinterpret_cast<const uint4*>(a + (size_t)(r0 + row) * D + col);
      bb = *reinterpret_cast<const uint4*>(b + (size_t)(r0 + row) * D + col);
    }
    *reinterpret_cast<uint4*>(&a_rm[row][col]) = aa;
    if (b_rm != nullptr) *reinterpret_cast<uint4*>(&b_rm[row][col]) = bb;
    const bf16* ae = reinterpret_cast<const bf16*>(&aa);
    const bf16* be = reinterpret_cast<const bf16*>(&bb);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (a_t != nullptr) a_t[col + i][row] = ae[i];
      if (b_t != nullptr) b_t[col + i][row] = be[i];
    }
  }
}

// C fragments of two neighbouring n-tiles (16 keys or 16 q rows) as the A
// operand of the next product, rounded to bf16.
__device__ __forceinline__ void c_to_a(const float (&lo)[4], const float (&hi)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// grid (ceil(nq / BQ), BH). MASKED: keys are [n_ctx context | frames of
// frame_size]; row r sees the context and its own frame.
template <bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int nq, int nk, int n_ctx,
                    int frame_size, float scale_log2, float scale) {
  __shared__ __align__(16) DqSmem sm;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q1 = min(q0 + BQ, nq);
  const int row0 = q0 + (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_q(q + bh * nq * D, row0, nq, qf);
  load_q(dout + bh * nq * D, row0, nq, dof);
  float lse2[2], dl[2];
  RowMask mk;
  mk.n_ctx = n_ctx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse2[r] = row < nq ? lse[bh * nq + row] * LOG2E : 0.f;
    dl[r] = row < nq ? delta[bh * nq + row] : 0.f;
    if constexpr (MASKED) {
      mk.lo[r] = n_ctx + (row / frame_size) * frame_size;
      mk.hi[r] = mk.lo[r] + frame_size;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  int own_lo = 0, own_hi = 0;
  if constexpr (MASKED) {
    own_lo = n_ctx + (q0 / frame_size) * frame_size;
    own_hi = n_ctx + ((q1 - 1) / frame_size + 1) * frame_size;
  }
  const bf16* kb = k + bh * nk * D;
  const bf16* vb = v + bh * nk * D;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    if constexpr (MASKED) {
      const int k1 = min(k0 + BK, nk);
      if (!(k0 < n_ctx || (k0 < own_hi && k1 > own_lo))) continue;  // uniform
    }
    __syncthreads();
    load_pair_tile(kb, vb, k0, nk, sm.k, sm.v, sm.kt, nullptr);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* kp = &sm.k[nt * 8 + g][ks * 16 + t * 2];
        mma_16816(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
        const bf16* vp = &sm.v[nt * 8 + g][ks * 16 + t * 2];
        mma_16816(dp[nt], dof[ks], *reinterpret_cast<const uint32_t*>(vp),
                  *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
    // ds (in place of s): p recomputed in the log2 domain, 0 where masked
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        bool ok = key < nk;
        if constexpr (MASKED) ok = ok && (key < mk.n_ctx || (key >= mk.lo[r] && key < mk.hi[r]));
        const float p = ok ? exp2f(__fmul_rn(s[nt][e], scale_log2) - lse2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[r]) * scale;
      }
    }
    // dq += ds (bf16) @ K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* kp = &sm.kt[dn * 8 + g][kk * 16 + t * 2];
        mma_16816(acc[dn], a, *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
  }
  bf16* o = dq + bh * nq * D;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + t * 2;
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + c) = pack_bf16(acc[dn][0], acc[dn][1]);
    if (r1 < nq)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + c) = pack_bf16(acc[dn][2], acc[dn][3]);
  }
}

// grid (ceil(nk / BK), BH). Each warp owns 16 keys; its tiles are transposed
// (rows = keys, columns = q rows of the staged tile).
template <bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int nq, int nk,
                     int n_ctx, int frame_size, float scale_log2, float scale) {
  __shared__ __align__(16) DkvSmem sm;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int k1 = min(k0 + BK, nk);
  const int krow0 = k0 + (threadIdx.x >> 5) * 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_q(k + bh * nk * D, krow0, nk, kf);
  load_q(v + bh * nk * D, krow0, nk, vf);
  // this thread's keys krow0 + g and krow0 + g + 8: validity, and (masked)
  // context membership or frame index
  int kframe[2];
  bool kok[2], kctx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow0 + g + 8 * r;
    kok[r] = key < nk;
    kctx[r] = key < n_ctx;
    kframe[r] = (MASKED && key >= n_ctx) ? (key - n_ctx) / frame_size : -1;
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }
  const bf16* qb = q + bh * nq * D;
  const bf16* db = dout + bh * nq * D;
  for (int q0 = 0; q0 < nq; q0 += BQ) {
    if constexpr (MASKED) {
      const int q1 = min(q0 + BQ, nq);
      const int own_lo = n_ctx + (q0 / frame_size) * frame_size;
      const int own_hi = n_ctx + ((q1 - 1) / frame_size + 1) * frame_size;
      if (!(k0 < n_ctx || (k0 < own_hi && k1 > own_lo))) continue;  // uniform
    }
    __syncthreads();
    load_pair_tile(qb, db, q0, nq, sm.q, sm.dout, sm.qt, sm.dot);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const int row = q0 + i;
      const bool ok = row < nq;
      sm.lse2[i] = ok ? lse[bh * nq + row] * LOG2E : 0.f;
      sm.delta[i] = ok ? delta[bh * nq + row] : 0.f;
      // -1 marks a row past nq; frames are >= 0
      sm.frame[i] = ok ? (MASKED ? row / frame_size : 0) : -1;
    }
    __syncthreads();
    float s[BQ / 8][4], dp[BQ / 8][4];  // S^T and dP^T: 16 keys x 64 q rows
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* qp = &sm.q[nt * 8 + g][ks * 16 + t * 2];
        mma_16816(s[nt], kf[ks], *reinterpret_cast<const uint32_t*>(qp),
                  *reinterpret_cast<const uint32_t*>(qp + 8));
        const bf16* dp_ = &sm.dout[nt * 8 + g][ks * 16 + t * 2];
        mma_16816(dp[nt], vf[ks], *reinterpret_cast<const uint32_t*>(dp_),
                  *reinterpret_cast<const uint32_t*>(dp_ + 8));
      }
    }
    // p^T (in place of s) and ds^T (in place of dp)
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        const int fr = sm.frame[col];
        bool ok = kok[r] && fr >= 0;
        if constexpr (MASKED) ok = ok && (kctx[r] || kframe[r] == fr);
        const float p = ok ? exp2f(__fmul_rn(s[nt][e], scale_log2) - sm.lse2[col]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sm.delta[col]) * scale;
      }
    }
    // dv += p^T (bf16) @ dO, dk += ds^T (bf16) @ Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      c_to_a(s[2 * kk], s[2 * kk + 1], ap);
      c_to_a(dp[2 * kk], dp[2 * kk + 1], ads);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* op = &sm.dot[dn * 8 + g][kk * 16 + t * 2];
        mma_16816(dva[dn], ap, *reinterpret_cast<const uint32_t*>(op),
                  *reinterpret_cast<const uint32_t*>(op + 8));
        const bf16* qp = &sm.qt[dn * 8 + g][kk * 16 + t * 2];
        mma_16816(dka[dn], ads, *reinterpret_cast<const uint32_t*>(qp),
                  *reinterpret_cast<const uint32_t*>(qp + 8));
      }
    }
  }
  bf16* dko = dk + bh * nk * D;
  bf16* dvo = dv + bh * nk * D;
  const int r0 = krow0 + g, r1 = krow0 + g + 8;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + t * 2;
    if (r0 < nk) {
      *reinterpret_cast<uint32_t*>(dko + (size_t)r0 * D + c) = pack_bf16(dka[dn][0], dka[dn][1]);
      *reinterpret_cast<uint32_t*>(dvo + (size_t)r0 * D + c) = pack_bf16(dva[dn][0], dva[dn][1]);
    }
    if (r1 < nk) {
      *reinterpret_cast<uint32_t*>(dko + (size_t)r1 * D + c) = pack_bf16(dka[dn][2], dka[dn][3]);
      *reinterpret_cast<uint32_t*>(dvo + (size_t)r1 * D + c) = pack_bf16(dva[dn][2], dva[dn][3]);
    }
  }
}

}  // namespace

extern "C" int sfm_flash_fwd_reloc_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int nq, int nk, int n_ctx,
                                        int frame_size, int num_frames,
                                        float scale_log2, void* stream) {
  if (frame_size <= 0 || n_ctx < 0 || nq != num_frames * frame_size ||
      nk != n_ctx + nq)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_fwd_reloc_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, n_ctx, frame_size, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// B9. masked != 0 selects the RelocMask variant (nk == n_ctx + nq, the q
// rows frames of frame_size). delta = rowsum(do * o) - dlse, fp32 (bh, nq).
static bool bwd_args_ok(int nq, int nk, int n_ctx, int frame_size, int masked) {
  return !masked || (frame_size > 0 && n_ctx >= 0 && nq % frame_size == 0 &&
                     nk == n_ctx + nq);
}

template <bool MASKED>
static void launch_bwd_dq(dim3 grid, cudaStream_t st, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* delta, void* dq, int nq, int nk, int n_ctx,
                          int frame_size, float scale_log2, float scale) {
  flash_bwd_dq_kernel<MASKED><<<grid, NTHREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), nq, nk, n_ctx, frame_size, scale_log2, scale);
}

template <bool MASKED>
static void launch_bwd_dkv(dim3 grid, cudaStream_t st, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int nq, int nk,
                           int n_ctx, int frame_size, float scale_log2, float scale) {
  flash_bwd_dkv_kernel<MASKED><<<grid, NTHREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk, n_ctx, frame_size,
      scale_log2, scale);
}

extern "C" int sfm_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int bh, int nq,
                                     int nk, int n_ctx, int frame_size, int masked,
                                     float scale_log2, float scale, void* stream) {
  if (!bwd_args_ok(nq, nk, n_ctx, frame_size, masked))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nq + BQ - 1) / BQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked)
    launch_bwd_dq<true>(grid, st, q, k, v, dout, lse, delta, dq, nq, nk, n_ctx,
                        frame_size, scale_log2, scale);
  else
    launch_bwd_dq<false>(grid, st, q, k, v, dout, lse, delta, dq, nq, nk, n_ctx,
                         frame_size, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sfm_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv, int bh,
                                      int nq, int nk, int n_ctx, int frame_size,
                                      int masked, float scale_log2, float scale,
                                      void* stream) {
  if (!bwd_args_ok(nq, nk, n_ctx, frame_size, masked))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nk + BK - 1) / BK, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (masked)
    launch_bwd_dkv<true>(grid, st, q, k, v, dout, lse, delta, dk, dv, nq, nk, n_ctx,
                         frame_size, scale_log2, scale);
  else
    launch_bwd_dkv<false>(grid, st, q, k, v, dout, lse, delta, dk, dv, nq, nk, n_ctx,
                          frame_size, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
