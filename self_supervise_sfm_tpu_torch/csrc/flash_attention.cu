// Flash-attention forward (K1, and K1m with a RelocMask), fused
// [context | own frame] attention (K2) and the same against one layer of the
// kv2 scene cache read in place (K2p), for Hopper (sm_90a), bf16 in, fp32
// softmax state, head dim 64.
//
// Replaces the Pallas TPU kernels
//   K1:  self_supervise_sfm_tpu/ops/flash_attention.py  _flash_fwd / _kernel
//   K1m: the same call with mask=RelocMask
//   K2:  self_supervise_sfm_tpu/ops/flash_attention.py  frame_ctx_kernel /
//        _frame_ctx_kernel
//   K2p: self_supervise_sfm_tpu/ops/flash_attention.py
//        frame_ctx_packed_kernel / _frame_ctx_kv2_kernel
// and computes what they compute: an online softmax in the log2 domain
// (exp2f), fp32 running max / denominator / accumulator, p cast to bf16
// before the PV product, ragged last key tile masked by select with its V
// rows zeroed, the l == 0 guard at finalize, out in bf16 and (K1) the
// natural-log lse in fp32. K2 folds the shared context tiles of scene
// b = bf / F and then the frame's own tiles into ONE online softmax: no mask,
// no lse merge.
// K2p is K2 with the context taken from layer `layer` of the depth-stacked
// cache (depth, B, H, Nc, 2*64): each 256-byte row holds [k | v], so the
// kernel reads the k half at offset 0 and the v half at offset 64 with a row
// stride of 128, straight from the cache's buffer. The TPU kernel pads q to
// 128 lanes and interleaves the frame's own K/V to the same layout; here the
// own k and v stay separate tensors. Nothing of the cache is sliced or
// copied, and every offset into it is 64-bit.
// K1m evaluates the RelocMask per element (key < n_ctx, or key inside the
// row's own frame) and skips key tiles in which no row of the block sees a
// key.
//
// Bound on an H100: operations. The 4*Nq*Nk*d FLOPs of QK^T and PV over the
// q/k/v/o bytes give 690-3450 FLOP/byte at the main-path sizes (Nq = Nk =
// 1374 to 6870), above the card's ~295 FLOP/byte ridge, so the floor is the
// bf16 tensor-core rate.
// Design: one block of 4 warps per (batch*head, 64-row q tile); each warp
// owns 16 q rows and keeps its Q fragments, the 16x64 fp32 accumulator and
// the row state in registers. The block streams 64-key tiles of K (row-major)
// and V (transposed) through padded shared memory, and every warp runs
// mma.sync m16n8k16 bf16 products on them; the S accumulator is reused in
// registers as the A operand of PV (no shared-memory round trip for P).
// This is the simple first version: no cp.async/TMA pipelining and no
// wgmma, so it reaches only a fraction of the tensor-core rate.

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
// keys at or past nvalid are zero-filled (the TPU kernel's v zeroing). LD is
// the row stride of k and v in elements: D for separate tensors, 2 * D for
// the [k | v] rows of the kv2 cache.
template <int LD>
__device__ __forceinline__ void load_kv_tile(const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, int k0,
                                             int nvalid, TileSmem& sm) {
  for (int c = threadIdx.x; c < BK * D / 8; c += NTHREADS) {
    const int row = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + row < nvalid) {
      kk = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + row) * LD + col);
      vv = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + row) * LD + col);
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
// kernel's _compute / _online_step body). MASKED adds the RelocMask's allow
// predicate to the key-validity select.
template <bool MASKED>
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
      bool ok = key < nvalid;
      if constexpr (MASKED) {
        const int r = e >> 1;
        ok = ok && (key < mk.n_ctx || (key >= mk.lo[r] && key < mk.hi[r]));
      }
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

// Stream all tiles of one key source through the online softmax.
template <int LD>
__device__ __forceinline__ void attend_source(RowState& st,
                                              const uint32_t (&qf)[D / 16][4],
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              int nk, float scale_log2,
                                              TileSmem& sm) {
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_kv_tile<LD>(k, v, k0, nk, sm);
    __syncthreads();
    attend_tile<false>(st, qf, sm, k0, nk, scale_log2, RowMask{});
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

// K1: grid (ceil(nq / BQ), BH)
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, float scale_log2) {
  __shared__ __align__(16) TileSmem sm;
  const size_t bh = blockIdx.y;
  const int row0 = blockIdx.x * BQ + (threadIdx.x >> 5) * 16;
  uint32_t qf[D / 16][4];
  load_q(q + bh * nq * D, row0, nq, qf);
  RowState st;
  init_state(st);
  attend_source<D>(st, qf, k + bh * nk * D, v + bh * nk * D, nk, scale_log2, sm);
  finalize(st, o + bh * nq * D, lse + bh * nq, row0, nq);
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
    load_kv_tile<D>(kb, vb, k0, nk, sm);
    __syncthreads();
    attend_tile<true>(st, qf, sm, k0, nk, scale_log2, mk);
  }
  finalize(st, o + bh * nq * D, lse + bh * nq, row0, nq);
}

// K2: grid (ceil(np / BQ), BF * H). Rows of frame bf attend the context of
// scene bf / F, then the frame's own keys, in one online softmax.
__global__ void __launch_bounds__(NTHREADS)
frame_ctx_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ ck,
                     const bf16* __restrict__ cv, bf16* __restrict__ o,
                     int heads, int frames, int np_, int nc, float scale_log2) {
  __shared__ __align__(16) TileSmem sm;
  const size_t bfh = blockIdx.y;  // (bf * H + h)
  const size_t h = bfh % heads;
  const size_t b = (bfh / heads) / frames;
  const int row0 = blockIdx.x * BQ + (threadIdx.x >> 5) * 16;
  uint32_t qf[D / 16][4];
  load_q(q + bfh * np_ * D, row0, np_, qf);
  RowState st;
  init_state(st);
  const size_t ctx = (b * heads + h) * nc * D;
  attend_source<D>(st, qf, ck + ctx, cv + ctx, nc, scale_log2, sm);
  attend_source<D>(st, qf, k + bfh * np_ * D, v + bfh * np_ * D, np_, scale_log2, sm);
  finalize(st, o + bfh * np_ * D, nullptr, row0, np_);
}

// K2p: K2 against the kv2 cache in place. ckv_layer points at layer `layer`
// of the (depth, B, H, Nc, 2 * D) cache; the context of scene b, head h is
// its Nc rows of [k | v] starting at (b * H + h) * Nc * 2 * D. Same tile
// order and arithmetic as K2, so the two agree bit for bit on equal values.
__global__ void __launch_bounds__(NTHREADS)
frame_ctx_kv2_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ ckv_layer,
                         bf16* __restrict__ o, int heads, int frames, int np_,
                         int nc, float scale_log2) {
  __shared__ __align__(16) TileSmem sm;
  const size_t bfh = blockIdx.y;  // (bf * H + h)
  const size_t h = bfh % heads;
  const size_t b = (bfh / heads) / frames;
  const int row0 = blockIdx.x * BQ + (threadIdx.x >> 5) * 16;
  uint32_t qf[D / 16][4];
  load_q(q + bfh * np_ * D, row0, np_, qf);
  RowState st;
  init_state(st);
  const bf16* ctx = ckv_layer + (b * heads + h) * nc * (2 * D);
  attend_source<2 * D>(st, qf, ctx, ctx + D, nc, scale_log2, sm);
  attend_source<D>(st, qf, k + bfh * np_ * D, v + bfh * np_ * D, np_, scale_log2, sm);
  finalize(st, o + bfh * np_ * D, nullptr, row0, np_);
}

}  // namespace

extern "C" int sfm_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int nq, int nk,
                                  float scale_log2, void* stream) {
  dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sfm_frame_ctx_fwd_bf16(const void* q, const void* k,
                                      const void* v, const void* ck,
                                      const void* cv, void* o, int bf,
                                      int heads, int frames, int np_, int nc,
                                      float scale_log2, void* stream) {
  dim3 grid((np_ + BQ - 1) / BQ, bf * heads);
  frame_ctx_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(cv), static_cast<bf16*>(o), heads, frames, np_,
      nc, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

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

// ckv is the base of the whole stacked cache; layer_stride is the number of
// elements between two layers (B * H * Nc * 2 * D), in 64 bits.
extern "C" int sfm_frame_ctx_kv2_fwd_bf16(const void* q, const void* k,
                                          const void* v, const void* ckv,
                                          void* o, int bf, int heads,
                                          int frames, int np_, int nc,
                                          int layer, long long layer_stride,
                                          float scale_log2, void* stream) {
  if (layer < 0 || layer_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* ckv_layer = static_cast<const bf16*>(ckv) +
                          static_cast<size_t>(layer) * static_cast<size_t>(layer_stride);
  dim3 grid((np_ + BQ - 1) / BQ, bf * heads);
  frame_ctx_kv2_fwd_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ckv_layer, static_cast<bf16*>(o), heads,
      frames, np_, nc, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
