// Three fused transformer-block kernels for Hopper (sm_90a), bf16
// activations and weights, fp32 norm / bias / layer-scale parameters. (The
// MLP pair, fused_mlp_kernel's _mlp_up_kernel and _mlp_down_kernel, moved to
// the wgmma / TMA body of gemm_sm90.cu; these three are queued to follow.)
//
// They replace the Pallas TPU kernels of self_supervise_sfm_tpu/ops/fused_qkv.py
//   fused_ln_qkv_rope_kernel    fused_qkv_kernel        / _kernel
//   fused_ln_qkv_kernel         fused_qkv_plain_kernel  / _kernel_plain
//   fused_proj_residual_kernel  fused_proj_kernel       / _proj_kernel
// and compute what those compute, with the same rounding points: layer-norm
// statistics in fp32 (centred variance), the normalised rows rounded to bf16
// before the product, the fp32 accumulator rounded to bf16 before the bias
// is added in bf16, every later bf16 operation rounded again (qk-norm in
// fp32 then bf16, RoPE with bf16 cos / sin, layer-scale, residual).
//
// Bound on an H100: operations, at every site of the main path. Rows M =
// B * N are 6870 (ViT, global, reloc) or 13740 (frame) and C = 1024:
//   LN + QKV (+ qk-norm + RoPE)  2 M C 3C   43 / 86 GFLOP over 62 / 118 MB
//   out-proj + residual          2 M C C    14 / 29 GFLOP over 44 /  86 MB
// i.e. 330-690 FLOP a byte against the card's ridge of ~295, so the floor is
// the bf16 tensor-core rate; the fusion's part is that nothing but x, W and
// the result crosses device memory.
//
// Design. The Pallas kernels hold a whole weight in VMEM and walk token
// blocks in order; here a block owns a 128 x 256 output tile of the flat
// (B * N, Nout) product (gemm_core.cuh) and differs per kernel only in
//   the A loader: (i) layer-normed rows: a small pre-pass kernel of this
//     source (one warp a row, two passes, centred form) writes mean and rstd
//     of every row to a scratch (M, 2) fp32 buffer, and the loader applies
//     (x - mu) * rstd * scale + bias to each slice in shared memory, one
//     slice ahead of the product. Statistics in a prologue of each block
//     would make the 12 column-tile blocks of the same rows read the
//     rows again from L2. (ii) merged heads: read straight from the
//     (B, H, N, 64) attention output, a K slice of 64 is one head, no
//     transpose exists.
//   the epilogue, on the mma accumulator layout: a warp's 64 columns are one
//     head, so the qk layer norm is a sum over a thread's 16 values and a
//     quad shuffle, and RoPE's partner column j +- 16 sits in the same
//     thread two n-tiles away. q, k, v go straight to (B, H, N, 64).
// Ragged edge: tiles run over the flat rows (1374 and 6870 are no multiple
// of 128); each row's (b, n) is computed for the head-split store and the
// cos / sin lookup, rows past M load as zeros and are never stored.
// Still simple: mma.sync, no wgmma, no TMA, no clusters, bf16x2 stores from
// the accumulator layout, and a grid of whole tiles (216 or 432 blocks on
// 132 multiprocessors for the out-projection's 1024 output columns).

#include "gemm_core.cuh"

namespace {

using namespace sfm_gemm;

constexpr int HD = 64;  // head dim

struct Params {
  const bf16* a;      // x (M, K) | attention out (B, H, N, 64)
  const bf16* w;      // (K, nout)
  const float* bias;  // (nout)
  const float* ln_w;  // layer norm over K (LN loader)
  const float* ln_b;
  const float* stats;  // (M, 2) mean, rstd of the rows of a (LN loader)
  const float* qn_w;  // qk-norm over the head dim (RoPE epilogue)
  const float* qn_b;
  const float* kn_w;
  const float* kn_b;
  const float* cos;   // (ntok, 64)
  const float* sin;
  const float* gamma;  // layer-scale (residual epilogue)
  const bf16* resid;   // (M, nout)
  bf16* out0;          // q | y
  bf16* out1;          // k
  bf16* out2;          // v
  float eps;
  int M, K, nout, ntok, heads;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ uint4 ld128(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// -- A loaders ----------------------------------------------------------------
// A slice is BM rows of BK / 8 chunks of 8 contiguous k values (16 bytes).
// Thread tid copies chunk cc of rows row_l, row_l + A_ROW_STEP, ...; rows past
// the matrix are zero-filled.

constexpr int A_ROW_CHUNKS = BK / 8;
constexpr int A_ROW_STEP = NTHREADS / A_ROW_CHUNKS;
constexpr int A_CHUNKS = BM / A_ROW_STEP;  // chunks a thread
static_assert(NTHREADS % A_ROW_CHUNKS == 0 && BM % A_ROW_STEP == 0, "A loader mapping");
static_assert(HD % BK == 0, "a K slice must lie inside one head");

struct FlatLoader {
  const bf16* src[A_CHUNKS];
  bool ok[A_CHUNKS];
  int row_l, cc;

  __device__ __forceinline__ void init(const Params& p, int m0) {
    row_l = threadIdx.x / A_ROW_CHUNKS;
    cc = (threadIdx.x % A_ROW_CHUNKS) * 8;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = m0 + row_l + A_ROW_STEP * i;
      ok[i] = row < p.M;
      src[i] = p.a + (size_t)(ok[i] ? row : 0) * p.K + cc;
    }
  }
  __device__ __forceinline__ void copy(int kt, bf16* sa) const {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      cp_async16(sa + (row_l + A_ROW_STEP * i) * LDA + cc, src[i] + kt * BK,
                 ok[i] ? 16 : 0);
  }
  __device__ __forceinline__ void transform(int, bf16*) const {}
};

// rows of the head-merged (B, N, H * 64) matrix, read from (B, H, N, 64)
struct HeadsLoader : FlatLoader {
  size_t head_stride;

  __device__ __forceinline__ void init(const Params& p, int m0) {
    row_l = threadIdx.x / A_ROW_CHUNKS;
    cc = (threadIdx.x % A_ROW_CHUNKS) * 8;
    head_stride = (size_t)p.ntok * HD;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = m0 + row_l + A_ROW_STEP * i;
      ok[i] = row < p.M;
      const int b = ok[i] ? row / p.ntok : 0;
      const int n = ok[i] ? row - b * p.ntok : 0;
      src[i] = p.a + ((size_t)b * p.heads * p.ntok + n) * HD;
    }
  }
  __device__ __forceinline__ void copy(int kt, bf16* sa) const {
    const int k = kt * BK + cc;
    const size_t off = (size_t)(k / HD) * head_stride + (k % HD);
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      cp_async16(sa + (row_l + A_ROW_STEP * i) * LDA + cc, src[i] + off, ok[i] ? 16 : 0);
  }
};

// layer-normed rows: the raw slice lands in shared memory and the thread that
// copied a chunk rewrites it as ((x - mu) * rstd) * scale + bias, computed in
// fp32 and rounded to bf16. s_lw / s_lb hold the norm's scale and bias.
struct LnLoader : FlatLoader {
  const float* s_lw;
  const float* s_lb;
  float mu[A_CHUNKS], rs[A_CHUNKS];

  __device__ __forceinline__ void init(const Params& p, int m0, const float* lw,
                                       const float* lb) {
    FlatLoader::init(p, m0);
    s_lw = lw + cc;
    s_lb = lb + cc;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const float2 st = ok[i] ? *reinterpret_cast<const float2*>(
                                    p.stats + 2 * (size_t)(m0 + row_l + A_ROW_STEP * i))
                              : make_float2(0.f, 0.f);
      mu[i] = st.x;
      rs[i] = st.y;
    }
  }
  __device__ __forceinline__ void transform(int kt, bf16* sa) const {
    const float4* w4 = reinterpret_cast<const float4*>(s_lw + kt * BK);
    const float4* b4 = reinterpret_cast<const float4*>(s_lb + kt * BK);
    const float4 wa = w4[0], wb = w4[1], ba = b4[0], bb = b4[1];
    const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const float b8[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      uint4* chunk = reinterpret_cast<uint4*>(sa + (row_l + A_ROW_STEP * i) * LDA + cc);
      const uint4 r = *chunk;
      const uint32_t in[4] = {r.x, r.y, r.z, r.w};
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = unpack_bf16(in[j]);
        // explicit roundings: no fused multiply-add, as the plain version
        const float y0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(x.x, mu[i]), rs[i]), w8[2 * j]), b8[2 * j]);
        const float y1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(x.y, mu[i]), rs[i]), w8[2 * j + 1]),
            b8[2 * j + 1]);
        out[j] = ok[i] ? pack_bf16(y0, y1) : 0u;
      }
      *chunk = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
};

// mean and rstd over K of every row, one warp a row, centred variance
constexpr int STATS_ROWS = 8;  // rows (warps) a block

__global__ void __launch_bounds__(STATS_ROWS * 32)
ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int M, int K,
                float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * STATS_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = ld128(xr + c);
    const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
    const float2 cq = unpack_bf16(u.z), d = unpack_bf16(u.w);
    s += ((a.x + a.y) + (b.x + b.y)) + ((cq.x + cq.y) + (d.x + d.y));
  }
  const float mu = warp_sum(s) / (float)K;
  float q = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = ld128(xr + c);
    const uint32_t in[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = unpack_bf16(in[j]);
      const float d0 = v.x - mu, d1 = v.y - mu;
      q += d0 * d0 + d1 * d1;
    }
  }
  const float rs = rsqrtf(warp_sum(q) / (float)K + eps);
  if (lane == 0) *reinterpret_cast<float2*>(stats + 2 * (size_t)row) = make_float2(mu, rs);
}

// -- epilogues ----------------------------------------------------------------

enum { E_QKV_ROPE = 0, E_QKV = 1, E_RESID = 2 };

template <int EP>
__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[MT][NT][4],
                                         int m0, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int cb = n0 + wn * WN;  // first of this warp's 64 columns
  if (cb >= p.nout) return;

  // q / k / v part and head of this warp's columns (head-split epilogues)
  const int C = p.heads * HD;
  const int part = (EP == E_QKV_ROPE || EP == E_QKV) ? cb / C : 0;
  const int head = (cb - part * C) >> 6;
  const bool normed = EP == E_QKV_ROPE && part < 2;
  const float* nw = part == 0 ? p.qn_w : p.kn_w;
  const float* nb = part == 0 ? p.qn_b : p.kn_b;

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + mt * 16 + half * 8 + g;
      const bool valid = row < p.M;
      // accumulator -> bf16, + bias in bf16
      float v[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 bias =
            *reinterpret_cast<const float2*>(p.bias + cb + nt * 8 + 2 * t);
        v[nt][0] = rb(rb(acc[mt][nt][half * 2]) + rb(bias.x));
        v[nt][1] = rb(rb(acc[mt][nt][half * 2 + 1]) + rb(bias.y));
      }

      if (EP == E_RESID) {
        if (!valid) continue;
        const size_t base = (size_t)row * p.nout + cb;
        // every load of the row before its first store: the stores may alias
        // the loads as far as the compiler knows, and would serialise them
        uint32_t res[NT];
        float2 gm[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = nt * 8 + 2 * t;
          res[nt] = *reinterpret_cast<const uint32_t*>(p.resid + base + j);
          gm[nt] = *reinterpret_cast<const float2*>(p.gamma + cb + j);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 x = unpack_bf16(res[nt]);
          const float y0 = rb(v[nt][0] * rb(gm[nt].x)), y1 = rb(v[nt][1] * rb(gm[nt].y));
          *reinterpret_cast<uint32_t*>(p.out0 + base + nt * 8 + 2 * t) =
              pack_bf16(x.x + y0, x.y + y1);
        }
      } else {
        const int b = valid ? row / p.ntok : 0;
        const int n = valid ? row - b * p.ntok : 0;
        if (normed) {
          // layer norm over the head's 64 values of this row, fp32
          float s = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) s += v[nt][0] + v[nt][1];
          const float mu = quad_sum(s) * (1.0f / HD);
          float q = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            v[nt][0] -= mu;
            v[nt][1] -= mu;
            q += v[nt][0] * v[nt][0] + v[nt][1] * v[nt][1];
          }
          const float rs = rsqrtf(quad_sum(q) * (1.0f / HD) + p.eps);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int j = nt * 8 + 2 * t;
            const float2 w2 = *reinterpret_cast<const float2*>(nw + j);
            const float2 b2 = *reinterpret_cast<const float2*>(nb + j);
            v[nt][0] = rb(__fadd_rn(__fmul_rn(__fmul_rn(v[nt][0], rs), w2.x), b2.x));
            v[nt][1] = rb(__fadd_rn(__fmul_rn(__fmul_rn(v[nt][1], rs), w2.y), b2.y));
          }
          // 2D RoPE in bf16: t * cos + rot * sin, rot = (-t2, t1, -t4, t3)
          // over quarters of 16 columns = two n-tiles
          float o[8][2];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int j = nt * 8 + 2 * t;
            float2 c2 = make_float2(0.f, 0.f), s2 = make_float2(0.f, 0.f);
            if (valid) {
              c2 = *reinterpret_cast<const float2*>(p.cos + (size_t)n * HD + j);
              s2 = *reinterpret_cast<const float2*>(p.sin + (size_t)n * HD + j);
            }
            const bool lower = (nt & 2) == 0;  // quarters 1 and 3
            const int pn = lower ? nt + 2 : nt - 2;
            const float r0 = lower ? -v[pn][0] : v[pn][0];
            const float r1 = lower ? -v[pn][1] : v[pn][1];
            o[nt][0] = rb(__fmul_rn(v[nt][0], rb(c2.x))) + rb(__fmul_rn(r0, rb(s2.x)));
            o[nt][1] = rb(__fmul_rn(v[nt][1], rb(c2.y))) + rb(__fmul_rn(r1, rb(s2.y)));
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            v[nt][0] = o[nt][0];
            v[nt][1] = o[nt][1];
          }
        }
        if (!valid) continue;
        bf16* dst = (part == 0 ? p.out0 : part == 1 ? p.out1 : p.out2) +
                    (((size_t)b * p.heads + head) * p.ntok + n) * HD;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<uint32_t*>(dst + nt * 8 + 2 * t) =
              pack_bf16(v[nt][0], v[nt][1]);
      }
    }
  }
}

// -- kernels ------------------------------------------------------------------

enum { A_LN = 0, A_HEADS = 1 };

template <int AL, int EP>
__device__ __forceinline__ void run(const Params& p) {
  // STAGES A stages, STAGES B stages, then (LN loader) the norm's scale and bias
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + STAGES * A_STAGE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[MT][NT][4];
  if (AL == A_LN) {
    float* s_lw = reinterpret_cast<float*>(smem + TILE_BYTES);
    float* s_lb = s_lw + p.K;
    for (int i = threadIdx.x; i < p.K; i += NTHREADS) {
      s_lw[i] = p.ln_w[i];
      s_lb[i] = p.ln_b[i];
    }
    __syncthreads();
    LnLoader al;
    al.init(p, m0, s_lw, s_lb);
    mainloop(al, p.w, p.K, p.nout, n0, sa, sb, acc);
  } else {
    HeadsLoader al;
    al.init(p, m0);
    mainloop(al, p.w, p.K, p.nout, n0, sa, sb, acc);
  }
  epilogue<EP>(p, acc, m0, n0);
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) fused_ln_qkv_rope_kernel(const Params p) {
  run<A_LN, E_QKV_ROPE>(p);
}
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) fused_ln_qkv_kernel(const Params p) {
  run<A_LN, E_QKV>(p);
}
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) fused_proj_residual_kernel(const Params p) {
  run<A_HEADS, E_RESID>(p);
}

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can have

// Launch one of the three kernels with its dynamic shared memory (above the
// 48 KB a kernel gets without asking, so the limit is raised first).
template <class Kernel>
int launch(Kernel kernel, const Params& p, bool layer_normed, void* stream) {
  const int bytes = TILE_BYTES + (layer_normed ? 2 * p.K * (int)sizeof(float) : 0);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.nout + BN - 1) / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the statistics pre-pass of the layer-normed kernels, on the same stream
int launch_stats(const Params& p, float* stats, void* stream) {
  ln_stats_kernel<<<(p.M + STATS_ROWS - 1) / STATS_ROWS, STATS_ROWS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(p.a, stats, p.M, p.K, p.eps);
  return static_cast<int>(cudaGetLastError());
}

const bf16* cb16(const void* p) { return static_cast<const bf16*>(p); }
const float* cf32(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// The layer-normed entries take a scratch buffer stats (M, 2) fp32 and launch
// the statistics pre-pass before the product.
//
// x (B, N, C) -> q, k, v (B, H, N, 64): LN, @W (C, 3C) + b, qk-norm, RoPE
extern "C" int sfm_fused_ln_qkv_rope(const void* x, const void* ln_w, const void* ln_b,
                                     const void* w, const void* b, const void* qn_w,
                                     const void* qn_b, const void* kn_w,
                                     const void* kn_b, const void* cos, const void* sin,
                                     void* q, void* k, void* v, void* stats, int batch,
                                     int ntok, int heads, float eps, void* stream) {
  Params p = {};
  p.a = cb16(x); p.w = cb16(w); p.bias = cf32(b);
  p.ln_w = cf32(ln_w); p.ln_b = cf32(ln_b);
  p.qn_w = cf32(qn_w); p.qn_b = cf32(qn_b); p.kn_w = cf32(kn_w); p.kn_b = cf32(kn_b);
  p.cos = cf32(cos); p.sin = cf32(sin);
  p.out0 = static_cast<bf16*>(q); p.out1 = static_cast<bf16*>(k);
  p.out2 = static_cast<bf16*>(v);
  p.eps = eps; p.M = batch * ntok; p.K = heads * HD; p.nout = 3 * heads * HD;
  p.ntok = ntok; p.heads = heads;
  p.stats = static_cast<const float*>(stats);
  if (const int rc = launch_stats(p, static_cast<float*>(stats), stream)) return rc;
  return launch(fused_ln_qkv_rope_kernel, p, true, stream);
}

// the same without qk-norm and RoPE
extern "C" int sfm_fused_ln_qkv(const void* x, const void* ln_w, const void* ln_b,
                                const void* w, const void* b, void* q, void* k, void* v,
                                void* stats, int batch, int ntok, int heads, float eps,
                                void* stream) {
  Params p = {};
  p.a = cb16(x); p.w = cb16(w); p.bias = cf32(b);
  p.ln_w = cf32(ln_w); p.ln_b = cf32(ln_b);
  p.out0 = static_cast<bf16*>(q); p.out1 = static_cast<bf16*>(k);
  p.out2 = static_cast<bf16*>(v);
  p.eps = eps; p.M = batch * ntok; p.K = heads * HD; p.nout = 3 * heads * HD;
  p.ntok = ntok; p.heads = heads;
  p.stats = static_cast<const float*>(stats);
  if (const int rc = launch_stats(p, static_cast<float*>(stats), stream)) return rc;
  return launch(fused_ln_qkv_kernel, p, true, stream);
}

// o (B, H, N, 64), x (B, N, C) -> y = x + gamma * (merge(o) @ W (C, C) + b)
extern "C" int sfm_fused_proj_residual(const void* o, const void* x, const void* w,
                                       const void* b, const void* gamma, void* y,
                                       int batch, int ntok, int heads, void* stream) {
  Params p = {};
  p.a = cb16(o); p.w = cb16(w); p.bias = cf32(b); p.gamma = cf32(gamma);
  p.resid = cb16(x); p.out0 = static_cast<bf16*>(y);
  p.M = batch * ntok; p.K = heads * HD; p.nout = heads * HD;
  p.ntok = ntok; p.heads = heads;
  return launch(fused_proj_residual_kernel, p, false, stream);
}
