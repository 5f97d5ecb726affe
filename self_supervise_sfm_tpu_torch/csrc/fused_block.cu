// The fused out-projection of a transformer block for Hopper (sm_90a), bf16
// activations and weights, fp32 bias / layer-scale parameters. (The MLP pair
// and the two LN+QKV kernels moved to the wgmma / TMA body of gemm_sm90.cu;
// this one is queued to follow: it needs a merged-heads A operand there.)
//
// It replaces the Pallas TPU kernel of self_supervise_sfm_tpu/ops/fused_qkv.py
//   fused_proj_residual_kernel  fused_proj_kernel / _proj_kernel
// and computes what it computes, with the same rounding points: the fp32
// accumulator rounded to bf16 before the bias is added in bf16, then the
// layer-scale and the residual, each rounded to bf16.
//
// Bound on an H100: operations at every site of the main path. Rows M = B *
// N are 6870 (ViT, global) or 13740 (frame) and C = 1024: 2 M C C = 14 / 29
// GFLOP over 44 / 86 MB, i.e. 330 FLOP a byte against the card's ridge of
// ~295, so the floor is the bf16 tensor-core rate; the fusion's part is that
// nothing but the attention output, x, W and the result crosses device memory.
//
// Design. The Pallas kernel holds the whole weight in VMEM and walks token
// blocks in order; here a block owns a 128 x 256 output tile of the flat
// (B * N, C) product (gemm_core.cuh) with
//   the A loader of merged heads: rows read straight from the (B, H, N, 64)
//     attention output, a K slice of 64 is one head, no transpose exists;
//   the epilogue on the mma accumulator layout: bias, layer-scale and
//     residual, bf16x2 stores.
// Ragged edge: tiles run over the flat rows (1374 and 6870 are no multiple
// of 128); each row's (b, n) is computed for the head-merge load, rows past M
// load as zeros and are never stored.
// Still simple: mma.sync, no wgmma, no TMA, no clusters, and a grid of whole
// tiles (216 or 432 blocks on 132 multiprocessors for the 1024 output
// columns).

#include "gemm_core.cuh"

namespace {

using namespace sfm_gemm;

constexpr int HD = 64;  // head dim

struct Params {
  const bf16* a;       // attention out (B, H, N, 64)
  const bf16* w;       // (K, nout)
  const float* bias;   // (nout)
  const float* gamma;  // layer-scale
  const bf16* resid;   // (M, nout)
  bf16* out;           // y (M, nout)
  int M, K, nout, ntok, heads;
};

// -- the A loader -------------------------------------------------------------
// A slice is BM rows of BK / 8 chunks of 8 contiguous k values (16 bytes).
// Thread tid copies chunk cc of rows row_l, row_l + A_ROW_STEP, ...; rows past
// the matrix are zero-filled.

constexpr int A_ROW_CHUNKS = BK / 8;
constexpr int A_ROW_STEP = NTHREADS / A_ROW_CHUNKS;
constexpr int A_CHUNKS = BM / A_ROW_STEP;  // chunks a thread
static_assert(NTHREADS % A_ROW_CHUNKS == 0 && BM % A_ROW_STEP == 0, "A loader mapping");
static_assert(HD % BK == 0, "a K slice must lie inside one head");

// rows of the head-merged (B, N, H * 64) matrix, read from (B, H, N, 64)
struct HeadsLoader {
  const bf16* src[A_CHUNKS];
  bool ok[A_CHUNKS];
  int row_l, cc;
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

// -- the epilogue: y = x + rb(rb(rb(acc) + rb(b)) * rb(gamma)) ----------------

__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[MT][NT][4], int m0,
                                         int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int cb = n0 + wn * WN;  // first of this warp's 64 columns
  if (cb >= p.nout) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + mt * 16 + half * 8 + g;
      if (row >= p.M) continue;
      // accumulator -> bf16, + bias in bf16
      float v[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(p.bias + cb + nt * 8 + 2 * t);
        v[nt][0] = rb(rb(acc[mt][nt][half * 2]) + rb(bias.x));
        v[nt][1] = rb(rb(acc[mt][nt][half * 2 + 1]) + rb(bias.y));
      }
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
        *reinterpret_cast<uint32_t*>(p.out + base + nt * 8 + 2 * t) =
            pack_bf16(x.x + y0, x.y + y1);
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) fused_proj_residual_kernel(const Params p) {
  // STAGES A stages, then STAGES B stages
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + STAGES * A_STAGE;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[MT][NT][4];
  HeadsLoader al;
  al.init(p, m0);
  mainloop(al, p.w, p.K, p.nout, n0, sa, sb, acc);
  epilogue(p, acc, m0, n0);
}

}  // namespace

// o (B, H, N, 64), x (B, N, C) -> y = x + gamma * (merge(o) @ W (C, C) + b).
// The kernel's dynamic shared memory is above the 48 KB a kernel gets
// without asking, so the limit is raised first.
extern "C" int sfm_fused_proj_residual(const void* o, const void* x, const void* w,
                                       const void* b, const void* gamma, void* y,
                                       int batch, int ntok, int heads, void* stream) {
  Params p = {};
  p.a = static_cast<const bf16*>(o);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(b);
  p.gamma = static_cast<const float*>(gamma);
  p.resid = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(y);
  p.M = batch * ntok;
  p.K = heads * HD;
  p.nout = heads * HD;
  p.ntok = ntok;
  p.heads = heads;
  const cudaError_t rc = cudaFuncSetAttribute(
      fused_proj_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.nout + BN - 1) / BN, (p.M + BM - 1) / BM);
  fused_proj_residual_kernel<<<grid, NTHREADS, TILE_BYTES, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
