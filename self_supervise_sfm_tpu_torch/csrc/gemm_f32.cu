// fp32 forms of the five fused kernels of a transformer block (LN+QKV+RoPE,
// LN+QKV, the out-projection, MLP-up, MLP-down), one GEMM body on the CUDA
// cores. fp32 activations, weights, norm / bias / layer-scale / RoPE
// parameters and outputs.
//
// Replaces the fp32 forms of the Pallas TPU kernels of
// self_supervise_sfm_tpu/ops/fused_qkv.py (dtype-generic there: the bf16
// forms are gemm_sm90.cu's)
//   ln_qkv_rope_f32_kernel    fused_qkv_kernel       / _kernel        (+ ln_rows_f32_kernel)
//   ln_qkv_f32_kernel         fused_qkv_plain_kernel / _kernel_plain  (+ ln_rows_f32_kernel)
//   proj_residual_f32_kernel  fused_proj_kernel      / _proj_kernel
//   mlp_up_f32_kernel         fused_mlp_kernel / _mlp_up_kernel       (+ ln_rows_f32_kernel)
//   mlp_down_f32_kernel       fused_mlp_kernel / _mlp_down_kernel
// and, at head dim 128, the first three as ln_qkv_rope_d128_f32_kernel,
// ln_qkv_d128_f32_kernel and proj_residual_d128_f32_kernel (the head dim a
// template parameter of the body, as in gemm_sm90.cu),
// and computes what they compute for fp32 inputs, where every cast of theirs
// to the weight's or the output's dtype does nothing. The layer-normed
// kernels: hn = ((x - mu) * rstd) * w + b with fp32 statistics (centred
// variance); acc = hn @ W in fp32; + bias. Then LN+QKV+RoPE: per head of q
// and k a layer norm over its d values (d = 64 or 128), and 2D RoPE, t *
// cos + rot * sin with rot = (-t2, t1, -t4, t3) over quarters of the head;
// LN+QKV: nothing more; both write q, k, v as (B, H, N, d). MLP-up: the exact GELU, 0.5 h
// (1 + erff(h / sqrt 2)) (erff, as gemm_sm90.cu and the plain version's
// torch.erf; the Pallas kernel's Abramowitz & Stegun 7.1.26 rational erf
// differs from it by less than 1.5e-7). MLP-down and the out-projection: y
// = x + (acc + b) * gamma. The out-projection's A is the attention output o
// (B, H, N, d) read in place as the merged heads (B N, H d): a K step of 16
// lies inside one head at either head dim. Every elementwise step after the product is one
// fp32 operation with one rounding (__fadd_rn / __fmul_rn: nvcc would
// otherwise contract a multiply and an add into one FFMA), in the plain
// version's order.
//
// Arithmetic: FFMA on the CUDA cores, not 3xTF32, for the reason
// flash_fwd_f32.cu gives: a TF32 product keeps about three decimal digits,
// far over the fp32 tolerance, and 3xTF32 needs split operands laid out for
// the tensor cores; FFMA is exact fp32 products, one rounding a
// multiply-add, summed over K in order. Its ceiling is the card's 67
// TFLOP/s of fp32. A tensor-core design is later work.
//
// Bound on an H100 SXM: operations. 2 M C Nout FLOPs over x, W and the
// result is 300-900 FLOP a byte at the main path's sizes (M = 6870 or 13740
// rows, C = 1024, Nout = C, 3C or 4C), far above the fp32 ridge of 67e12 /
// 3.35e12 = 20 FLOP a byte. At 67 TFLOP/s: LN+QKV(+RoPE) 0.645 / 1.290 ms
// (6870 / 13740 rows), the out-projection 0.215 / 0.430 ms, MLP-up and
// MLP-down 0.860 / 1.720 ms each. The head dim 128 kernels do the same
// operations on the same operands as their head dim 64 forms at C = 1024
// (only the epilogue's mapping of columns to heads differs), so these bounds
// hold for them too.
//
// Design (first version: right and simple):
// - A block of 256 threads owns a 128 x 128 output tile (grid: column tiles
//   x row tiles, the column tiles of one row tile adjacent, so that its rows
//   of A are read from L2 by the blocks after the first). Thread (ty, tx) =
//   (tid / 16, tid % 16) owns rows 8 ty .. 8 ty + 7 and columns 4 tx .. 4 tx
//   + 3 and 64 + 4 tx .. 64 + 4 tx + 3: an 8 x 8 register tile.
// - K steps of BK = 16 stream through STAGES cp.async stages (16-byte copies,
//   the next tiles' copies in flight while one computes; one __syncthreads
//   a step). A is held as its rows of 16 floats (64 bytes), W as its 16 rows
//   of 128 columns. An A fragment read is a float4 of four k values of one
//   row, the same address for the 16 threads of a row group (a broadcast); a
//   W fragment read is a float4 of four columns, 8 consecutive float4 a
//   quarter-warp. Neither needs padding to avoid bank conflicts, nor do the
//   copies (8 threads of a quarter-warp write 128 consecutive bytes). Per 4
//   k values a thread reads 8 A and 8 W float4 for 256 FFMA.
// - Registers: 64 accumulators, 32 A and 8 W values live, within the 128 a
//   thread that two blocks an SM leave (125-128 used, no spill, CUDA 12.8
//   for sm_90a). The copies' offsets are 32-bit element
//   counts for that reason: with 64-bit ones three kernels spilled 8-16
//   bytes; the host refuses operands of 2^31 elements or more.
// - Rows past M arrive as zeros (a copy of 0 source bytes) and are never
//   stored: 13740 and 6870 rows are not multiples of 128. A row's (b, n) is
//   divmod(row, N), so a tile may cross a frame boundary; the out-projection
//   gathers its rows of o from their frames one by one.
// - Layer norm: a pre-pass (ln_rows_f32_kernel, one warp a row) writes hn
//   once to an (M, C) fp32 scratch, as the bf16 body's pre-pass does; the
//   product's A is then a plain copy for all five kernels, and no column
//   tile repeats the statistics. The other way, per-row statistics and the
//   normalisation applied to each stage, saves the scratch's write and read
//   (2 x 56 MB at the frame site, ~0.03 ms at 3.35 TB/s against a 1.29 ms
//   bound) at the price of a second A loader; the pre-pass keeps one.
// - LN+QKV(+RoPE) at head dim 64: a 128-column tile is two heads of one of
//   q, k and v (the 3 Hl 64 columns for the Hl heads the call computes, Hl
//   even: all heads, or one rank's head shard under tensor parallelism, W
//   (C, 3 Hl 64)). A head's 64 values of a row lie in the 16 threads of the
//   row group, 4 each, in the same half-warp: the qk-norm's sums are a
//   thread's 4 values, ((v0 + v1) + v2) + v3, then xor shuffles over lanes
//   1, 2, 4, 8 (every lane ends with the same sum); RoPE's partner column
//   (+-16) is 4 threads away, lane ^ 4. Stores are float4, a row's 64 values
//   of a head 256 contiguous bytes.
// - LN+QKV(+RoPE) at head dim 128: a 128-column tile is one head, so a tile
//   lies in one of q, k and v at any Hl (W (C, 3 Hl 128)). A head's 128
//   values of a row lie in the 16 threads of the row group, 8 each: columns
//   4 tx .. 4 tx + 3 (j = 0) and 64 + 4 tx .. 64 + 4 tx + 3 (j = 1). The
//   epilogue takes a row's j = 0 and j = 1 values together (rows outer):
//   the qk-norm's sums are a thread's ((v0 + v1) + v2) + v3 at j = 0 plus
//   the same at j = 1, then the butterfly over lanes 1, 2, 4, 8; RoPE's
//   quarters are 32 columns, so the partner column (+-32) lies at the same j
//   8 threads away, lane ^ 8. Stores are two float4 a thread, a row's 128
//   values of a head 512 contiguous bytes.
// Every output element is one thread's fp32 FFMA chain over K in order,
// whatever the grid or the row count: no split over K, no atomics, and a
// repeat is bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows a tile
constexpr int BN = 128;          // columns a tile: two heads of 64 for LN+QKV(+RoPE)
constexpr int BK = 16;           // K step: one stage
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int NTHREADS = 256;    // 16 row groups x 16 threads
constexpr int TM = 8;            // rows a thread
constexpr int MIN_BLOCKS = 2;    // blocks an SM: at most 128 registers a thread
constexpr int HD = 64;           // head dim: a tile of BN columns is two heads
constexpr int HD128 = 128;       // the other head dim built: a tile is one head
constexpr int A_TILE = BM * BK;  // floats of A in a stage (rows of 16)
constexpr int B_TILE = BK * BN;  // floats of W in a stage
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 4;
constexpr int LN_ROWS = 8;       // rows (warps) a block of the pre-pass

enum { E_QKV_ROPE = 0, E_QKV = 1, E_PROJ = 2, E_GELU = 3, E_RESID = 4 };

struct Params {
  const float* a;      // (M, K) rows; E_PROJ: o (batch, heads, ntok, d)
  const float* w;      // (K, nout)
  const float* bias;   // (nout)
  const float* gamma;  // (nout) layer scale (E_PROJ, E_RESID)
  const float* resid;  // (M, nout) residual (E_PROJ, E_RESID)
  float* out;          // (M, nout) (E_PROJ, E_GELU, E_RESID)
  float* q;            // (batch, heads, ntok, d) (E_QKV_ROPE, E_QKV)
  float* k;
  float* v;
  const float* qn_w;   // (d) q / k layer norm over a head (E_QKV_ROPE)
  const float* qn_b;
  const float* kn_w;
  const float* kn_b;
  const float* cos;    // (ntok, d)
  const float* sin;
  float eps;
  int M, K, nout;
  int ntok, heads;     // E_QKV*: the outputs' N and Hl; E_PROJ: o's N and H
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16 bytes from device memory into shared memory; with src_bytes 0 nothing
// is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
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

// the sum over the 16 lanes of a half-warp, on every lane of it
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float get(const float4& f, int e) {
  return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
}

// The epilogue of LN+QKV(+RoPE) at head dim 64 on row `row` of the tile's
// values, head j of the tile (4 values of this thread: columns 4 tx .. 4 tx
// + 3 of it).
template <int EP>
__device__ __forceinline__ void store_qkv(const Params& p, float (&val)[4], int row, int n0,
                                          int j, int tx) {
  const int C = p.heads * HD;
  const int part = n0 / C;  // 0 q, 1 k, 2 v: a tile lies in one part (Hl even)
  const int head = (n0 - part * C) / HD + j;
  const bool valid = row < p.M;
  const int b = valid ? row / p.ntok : 0;
  const int n = valid ? row - b * p.ntok : 0;
  const int c = 4 * tx;  // column in the head
  if (EP == E_QKV_ROPE && part < 2) {
    // layer norm over the head's 64 values of this row: 16 lanes x 4
    const float* nw = part == 0 ? p.qn_w : p.kn_w;
    const float* nb = part == 0 ? p.qn_b : p.kn_b;
    const float mu =
        half_warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(val[0], val[1]), val[2]), val[3])) /
        static_cast<float>(HD);
    float xc[4], sq[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xc[e] = __fsub_rn(val[e], mu);
      sq[e] = __fmul_rn(xc[e], xc[e]);
    }
    const float var =
        half_warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]), sq[3])) /
        static_cast<float>(HD);
    const float rs = rsqrtf(__fadd_rn(var, p.eps));
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(nw + c));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(nb + c));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      val[e] = __fadd_rn(__fmul_rn(__fmul_rn(xc[e], rs), get(w4, e)), get(b4, e));
    // 2D RoPE: t * cos + rot * sin, rot = (-t2, t1, -t4, t3) over quarters
    // of 16 columns, i.e. 4 threads apart; quarters 1 and 3 (tx / 4 even)
    // take their partner negated
    const bool lower = ((tx >> 2) & 1) == 0;
    const int tc = n * HD + c;
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(p.cos + tc));
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.sin + tc));
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float partner = __shfl_xor_sync(0xffffffffu, val[e], 4);
      const float rot = lower ? -partner : partner;
      o[e] = __fadd_rn(__fmul_rn(val[e], get(c4, e)), __fmul_rn(rot, get(s4, e)));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) val[e] = o[e];
  }
  if (!valid) return;
  float* out = part == 0 ? p.q : part == 1 ? p.k : p.v;
  float* dst = out + ((b * p.heads + head) * p.ntok + n) * HD + c;
  *reinterpret_cast<float4*>(dst) = make_float4(val[0], val[1], val[2], val[3]);
}

// ((v0 + v1) + v2) + v3 of the 4 values at v[e0 ..]
__device__ __forceinline__ float sum4(const float (&v)[8], int e0) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[e0], v[e0 + 1]), v[e0 + 2]), v[e0 + 3]);
}

// The epilogue of LN+QKV(+RoPE) at head dim 128 on row `row`: the tile is
// one head, this thread's 8 values of it columns 4 tx .. 4 tx + 3 (val[0 ..
// 3], j = 0) and 64 + 4 tx .. 64 + 4 tx + 3 (val[4 .. 7], j = 1).
template <int EP>
__device__ __forceinline__ void store_qkv_d128(const Params& p, float (&val)[8], int row,
                                               int n0, int tx) {
  const int C = p.heads * HD128;
  const int part = n0 / C;  // 0 q, 1 k, 2 v: a tile is one head of one part
  const int head = (n0 - part * C) / HD128;
  const bool valid = row < p.M;
  const int b = valid ? row / p.ntok : 0;
  const int n = valid ? row - b * p.ntok : 0;
  const int c = 4 * tx;  // column in the head at j = 0; 64 + c at j = 1
  if (EP == E_QKV_ROPE && part < 2) {
    // layer norm over the head's 128 values of this row: 16 lanes x 8, a
    // lane's j = 0 sum plus its j = 1 sum, then the half-warp's butterfly
    const float* nw = part == 0 ? p.qn_w : p.kn_w;
    const float* nb = part == 0 ? p.qn_b : p.kn_b;
    const float mu =
        half_warp_sum(__fadd_rn(sum4(val, 0), sum4(val, 4))) / static_cast<float>(HD128);
    float xc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) xc[e] = __fsub_rn(val[e], mu);
    float sq[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sq[e] = __fmul_rn(xc[e], xc[e]);
    const float var =
        half_warp_sum(__fadd_rn(sum4(sq, 0), sum4(sq, 4))) / static_cast<float>(HD128);
    const float rs = rsqrtf(__fadd_rn(var, p.eps));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(nw + 64 * j + c));
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(nb + 64 * j + c));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        val[4 * j + e] =
            __fadd_rn(__fmul_rn(__fmul_rn(xc[4 * j + e], rs), get(w4, e)), get(b4, e));
    }
    // 2D RoPE: t * cos + rot * sin, rot = (-t2, t1, -t4, t3) over quarters
    // of 32 columns: the partner is at the same j, 8 threads apart; quarters
    // 1 and 3 (tx / 8 even) take their partner negated
    const bool lower = ((tx >> 3) & 1) == 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int tc = n * HD128 + 64 * j + c;
      const float4 c4 = __ldg(reinterpret_cast<const float4*>(p.cos + tc));
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.sin + tc));
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float partner = __shfl_xor_sync(0xffffffffu, val[4 * j + e], 8);
        const float rot = lower ? -partner : partner;
        o[e] = __fadd_rn(__fmul_rn(val[4 * j + e], get(c4, e)), __fmul_rn(rot, get(s4, e)));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) val[4 * j + e] = o[e];
    }
  }
  if (!valid) return;
  float* out = part == 0 ? p.q : part == 1 ? p.k : p.v;
  float* dst = out + ((b * p.heads + head) * p.ntok + n) * HD128 + c;
  *reinterpret_cast<float4*>(dst) = make_float4(val[0], val[1], val[2], val[3]);
  *reinterpret_cast<float4*>(dst + 64) = make_float4(val[4], val[5], val[6], val[7]);
}

// out = epilogue(A @ W) on the block's tile (column tile blockIdx.x, row
// tile blockIdx.y); HD the head dim of E_QKV_ROPE, E_QKV and E_PROJ
template <int EP, int HD>
__device__ __forceinline__ void gemm(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                    // STAGES tiles of A
  float* sb = smem + STAGES * A_TILE;  // STAGES tiles of W
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // this thread's copies: A rows tid / 4 and tid / 4 + 64, 4 floats at
  // column 4 (tid % 4) of the K step; W rows tid / 32 and tid / 32 + 8, 4
  // floats at column 4 (tid % 32) of the tile
  // (element offsets in 32 bits: the host refuses operands of 2^31 elements
  // or more; -1 marks a row past M)
  const int ach = (tid & 3) * 4;
  int a_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + (tid >> 2) + 64 * i;
    if (row >= p.M) {
      a_off[i] = -1;
    } else if (EP == E_PROJ) {
      // merged row (b, n): o[b, h, n, :] holds its columns h HD .. h HD + HD - 1
      const int b = row / p.ntok, n = row - b * p.ntok;
      a_off[i] = (b * p.heads * p.ntok + n) * HD + ach;
    } else {
      a_off[i] = row * p.K + ach;
    }
  }
  const int bch = (tid & 31) * 4, br = tid >> 5;
  const int w_off = br * p.nout + n0 + bch;
  const int k_tiles = p.K / BK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    // E_PROJ: a K step lies in head k0 / HD, at its column k0 % HD
    const int ka = EP == E_PROJ ? (k0 / HD) * p.ntok * HD + k0 % HD : k0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(sa + st * A_TILE + ((tid >> 2) + 64 * i) * BK + ach,
                 a_off[i] >= 0 ? p.a + (a_off[i] + ka) : p.a, a_off[i] >= 0 ? 16 : 0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(sb + st * B_TILE + (br + 8 * i) * BN + bch,
                 p.w + (w_off + (k0 + 8 * i) * p.nout), 16);
  };

  // the first STAGES - 1 steps in flight; a group is committed for every
  // step, empty past the last, so that the wait below counts steps
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }

  const int ty = tid >> 4, tx = tid & 15;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step kt have landed
    __syncthreads();              // everyone's; and everyone is done with step kt - 1
    {
      const int nk = kt + STAGES - 1;  // into the stage step kt - 1 used
      if (nk < k_tiles) load(nk, nk % STAGES);
      cp_async_commit();
    }
    const float* at = sa + (kt % STAGES) * A_TILE + ty * TM * BK;
    const float* bt = sb + (kt % STAGES) * B_TILE + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(at + i * BK + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bt + (k4 + kk) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(bt + (k4 + kk) * BN + 64);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = get(a[i], kk);
          acc[i][0] = fmaf(x, b0.x, acc[i][0]);
          acc[i][1] = fmaf(x, b0.y, acc[i][1]);
          acc[i][2] = fmaf(x, b0.z, acc[i][2]);
          acc[i][3] = fmaf(x, b0.w, acc[i][3]);
          acc[i][4] = fmaf(x, b1.x, acc[i][4]);
          acc[i][5] = fmaf(x, b1.y, acc[i][5]);
          acc[i][6] = fmaf(x, b1.z, acc[i][6]);
          acc[i][7] = fmaf(x, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the last step

  if constexpr (HD == HD128 && (EP == E_QKV_ROPE || EP == E_QKV)) {
    // -- epilogue at head dim 128: rows 8 ty + i, a row's 8 values of the
    // tile's one head together (columns 4 tx + e and 64 + 4 tx + e)
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.bias + n0 + 4 * tx));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.bias + n0 + 64 + 4 * tx));
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float val[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        val[e] = __fadd_rn(acc[i][e], get(b0, e));
        val[4 + e] = __fadd_rn(acc[i][4 + e], get(b1, e));
      }
      store_qkv_d128<EP>(p, val, m0 + ty * TM + i, n0, tx);
    }
  } else {
    // -- epilogue: rows 8 ty + i, columns 4 tx + e (j = 0) and 64 + 4 tx + e (j = 1)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 64 * j + 4 * tx;
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.bias + col));
      float4 g4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (EP == E_PROJ || EP == E_RESID) g4 = __ldg(reinterpret_cast<const float4*>(p.gamma + col));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty * TM + i;
        float val[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) val[e] = __fadd_rn(acc[i][4 * j + e], get(b4, e));
        if (EP == E_QKV_ROPE || EP == E_QKV) {
          store_qkv<EP>(p, val, row, n0, j, tx);
          continue;
        }
        if (row >= p.M) continue;
        const int at_out = row * p.nout + col;
        if (EP == E_GELU) {
          // 0.5 h (1 + erf(h 2^-1/2)), in the plain version's order
#pragma unroll
          for (int e = 0; e < 4; ++e)
            val[e] = __fmul_rn(__fmul_rn(0.5f, val[e]),
                               __fadd_rn(1.0f, erff(__fmul_rn(val[e], 0.70710678118654752f))));
        } else {
          // y = x + (acc + b) * gamma
          const float4 x4 = *reinterpret_cast<const float4*>(p.resid + at_out);
#pragma unroll
          for (int e = 0; e < 4; ++e) val[e] = __fadd_rn(get(x4, e), __fmul_rn(val[e], get(g4, e)));
        }
        *reinterpret_cast<float4*>(p.out + at_out) = make_float4(val[0], val[1], val[2], val[3]);
      }
    }
  }
}

// the kernels of the body; the head dim D of those with one
#define SFM_GEMM_F32_KERNEL_HD(name, EP, D)                                      \
  __global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS) name(const Params p) { \
    gemm<EP, D>(p);                                                              \
  }
#define SFM_GEMM_F32_KERNEL(name, EP) SFM_GEMM_F32_KERNEL_HD(name, EP, HD)
SFM_GEMM_F32_KERNEL(ln_qkv_rope_f32_kernel, E_QKV_ROPE)
SFM_GEMM_F32_KERNEL(ln_qkv_f32_kernel, E_QKV)
SFM_GEMM_F32_KERNEL(proj_residual_f32_kernel, E_PROJ)
SFM_GEMM_F32_KERNEL(mlp_up_f32_kernel, E_GELU)
SFM_GEMM_F32_KERNEL(mlp_down_f32_kernel, E_RESID)
SFM_GEMM_F32_KERNEL_HD(ln_qkv_rope_d128_f32_kernel, E_QKV_ROPE, HD128)
SFM_GEMM_F32_KERNEL_HD(ln_qkv_d128_f32_kernel, E_QKV, HD128)
SFM_GEMM_F32_KERNEL_HD(proj_residual_d128_f32_kernel, E_PROJ, HD128)
#undef SFM_GEMM_F32_KERNEL
#undef SFM_GEMM_F32_KERNEL_HD

// -- the layer-norm pre-pass ---------------------------------------------------

// hn = ((x - mu) * rstd) * w + b in fp32; one warp a row, 4 channels (16
// bytes) a lane a step of 128, K a multiple of 4 (the lanes past K sit out
// the last step; rows stay 16-byte aligned). Mean and centred variance as
// the plain version's; explicit roundings (no fused multiply-add) in the
// normalisation.
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_rows_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y, int M, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + static_cast<size_t>(row) * K;
  float* yr = y + static_cast<size_t>(row) * K;
  float s = 0.f;
  for (int c = lane * 4; c < K; c += 128) {
    const float4 u = *reinterpret_cast<const float4*>(xr + c);
    s += (u.x + u.y) + (u.z + u.w);
  }
  const float mu = warp_sum(s) / static_cast<float>(K);
  float q = 0.f;
  for (int c = lane * 4; c < K; c += 128) {
    const float4 u = *reinterpret_cast<const float4*>(xr + c);
    const float d0 = u.x - mu, d1 = u.y - mu, d2 = u.z - mu, d3 = u.w - mu;
    q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rs = rsqrtf(warp_sum(q) / static_cast<float>(K) + eps);
  for (int c = lane * 4; c < K; c += 128) {
    const float4 u = *reinterpret_cast<const float4*>(xr + c);
    const float4 w4 = *reinterpret_cast<const float4*>(w + c);
    const float4 b4 = *reinterpret_cast<const float4*>(b + c);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(get(u, e), mu), rs), get(w4, e)),
                       get(b4, e));
    *reinterpret_cast<float4*>(yr + c) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// -- host side ------------------------------------------------------------------

// the five GEMM kernels (0-4, by EP), the pre-pass (5), the head dim 128
// forms of the first three (D128 + EP)
constexpr int LN_KERNEL = 5;
constexpr int D128 = 6;
constexpr int KERNELS = 9;

typedef void (*GemmKernel)(const Params);

GemmKernel gemm_kernel(int which) {
  switch (which) {
    case E_QKV_ROPE: return ln_qkv_rope_f32_kernel;
    case E_QKV: return ln_qkv_f32_kernel;
    case E_PROJ: return proj_residual_f32_kernel;
    case E_GELU: return mlp_up_f32_kernel;
    case E_RESID: return mlp_down_f32_kernel;
    case D128 + E_QKV_ROPE: return ln_qkv_rope_d128_f32_kernel;
    case D128 + E_QKV: return ln_qkv_d128_f32_kernel;
    case D128 + E_PROJ: return proj_residual_d128_f32_kernel;
    default: return nullptr;
  }
}

const void* kernel_of(int which) {
  return which == LN_KERNEL ? reinterpret_cast<const void*>(ln_rows_f32_kernel)
                            : reinterpret_cast<const void*>(gemm_kernel(which));
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// out = epilogue(A (M, K) @ W (K, nout)); K a multiple of 16, nout of 128;
// HD the head dim of E_QKV_ROPE, E_QKV and E_PROJ. Grid: column tiles x row
// tiles. The first launch of a kernel sets its dynamic shared memory limit.
template <int EP, int HD>
int launch_gemm(const Params& p, void* stream) {
  constexpr int which = (HD == HD128 ? D128 : 0) + EP;
  static bool ready = false;
  if (p.M < 0 || p.K <= 0 || p.K % BK || p.nout <= 0 || p.nout % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0) return 0;
  // the kernel's 32-bit element offsets: A (E_PROJ: o, the same count), W
  // and the outputs under 2^31 elements
  const long long big = 1LL << 31;
  if (static_cast<long long>(p.M) * p.K >= big || static_cast<long long>(p.K) * p.nout >= big ||
      static_cast<long long>(p.M) * p.nout >= big)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cdiv(p.M, BM) > 65535 || !aligned16(p.a) || !aligned16(p.w) || !aligned16(p.bias))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid(p.nout / BN, cdiv(p.M, BM));
  const GemmKernel kernel = gemm_kernel(which);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_ln(const void* x, const void* ln_w, const void* ln_b, void* hn, int rows, int dim,
              float eps, void* stream) {
  if (rows < 0 || dim <= 0 || dim % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (!aligned16(x) || !aligned16(ln_w) || !aligned16(ln_b) || !aligned16(hn))
    return static_cast<int>(cudaErrorInvalidValue);
  ln_rows_f32_kernel<<<cdiv(rows, LN_ROWS), LN_ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<float*>(hn), rows, dim, eps);
  return static_cast<int>(cudaGetLastError());
}

// x (B N, C) -> q, k, v (B, Hl, N, HD): the pre-pass into the (B N, C) fp32
// scratch hn, then hn @ W (C, 3 Hl HD) + b and the epilogue EP; at HD = 64
// Hl even (a 128-column tile never straddles q | k or k | v; at HD = 128 a
// tile is one head); Hl = C / HD is the whole width
template <int EP, int HD>
int launch_qkv(const void* x, const void* ln_w, const void* ln_b, const void* w, const void* b,
               Params p, void* hn, int batch, int ntok, int dim, int heads, float eps,
               void* stream) {
  if (batch < 0 || ntok < 0 || heads <= 0 || heads % (BN / HD) || dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * ntok;
  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;
  p.a = static_cast<const float*>(hn);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(b);
  p.eps = eps;
  p.ntok = ntok;
  p.heads = heads;
  p.M = rows;
  p.K = dim;
  p.nout = 3 * heads * HD;
  return launch_gemm<EP, HD>(p, stream);
}

// the parameters of LN+QKV+RoPE (its norm and RoPE operands 16-byte aligned)
// and of both LN+QKV forms: their outputs
bool rope_params(Params& p, const void* qn_w, const void* qn_b, const void* kn_w,
                 const void* kn_b, const void* cos, const void* sin) {
  if (!aligned16(qn_w) || !aligned16(qn_b) || !aligned16(kn_w) || !aligned16(kn_b) ||
      !aligned16(cos) || !aligned16(sin))
    return false;
  p.qn_w = static_cast<const float*>(qn_w);
  p.qn_b = static_cast<const float*>(qn_b);
  p.kn_w = static_cast<const float*>(kn_w);
  p.kn_b = static_cast<const float*>(kn_b);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  return true;
}

Params qkv_params(void* q, void* k, void* v) {
  Params p = {};
  p.q = static_cast<float*>(q);
  p.k = static_cast<float*>(k);
  p.v = static_cast<float*>(v);
  return p;
}

// o (B, H, N, HD), x (B N, C) -> y = x + gamma * (merge_heads(o) @ Wp (C, C)
// + bp) (B N, C), C = HD heads, a multiple of 128
template <int HD>
int launch_proj(const void* o, const void* x, const void* wp, const void* bp,
                const void* gamma, void* y, int batch, int ntok, int heads, void* stream) {
  if (batch < 0 || ntok < 0 || heads <= 0 || !aligned16(x) || !aligned16(gamma) ||
      !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.a = static_cast<const float*>(o);
  p.w = static_cast<const float*>(wp);
  p.bias = static_cast<const float*>(bp);
  p.gamma = static_cast<const float*>(gamma);
  p.resid = static_cast<const float*>(x);
  p.out = static_cast<float*>(y);
  p.ntok = ntok;
  p.heads = heads;
  p.M = batch * ntok;
  p.K = heads * HD;
  p.nout = heads * HD;
  return launch_gemm<E_PROJ, HD>(p, stream);
}

}  // namespace

// x (B, N, C) -> q, k, v (B, Hl, N, 64): LN, @ W (C, 3 Hl 64) + b, qk-norm,
// RoPE; hn is a (B N, C) fp32 scratch buffer that the pre-pass writes and the
// product reads. The arguments of sfm_ln_qkv_rope_sm90.
extern "C" int sfm_ln_qkv_rope_f32(const void* x, const void* ln_w, const void* ln_b,
                                   const void* w, const void* b, const void* qn_w,
                                   const void* qn_b, const void* kn_w, const void* kn_b,
                                   const void* cos, const void* sin, void* q, void* k, void* v,
                                   void* hn, int batch, int ntok, int dim, int heads, float eps,
                                   void* stream) {
  Params p = qkv_params(q, k, v);
  if (!rope_params(p, qn_w, qn_b, kn_w, kn_b, cos, sin))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qkv<E_QKV_ROPE, HD>(x, ln_w, ln_b, w, b, p, hn, batch, ntok, dim, heads, eps,
                                    stream);
}

// the same without qk-norm and RoPE (the ViT blocks)
extern "C" int sfm_ln_qkv_f32(const void* x, const void* ln_w, const void* ln_b, const void* w,
                              const void* b, void* q, void* k, void* v, void* hn, int batch,
                              int ntok, int dim, int heads, float eps, void* stream) {
  return launch_qkv<E_QKV, HD>(x, ln_w, ln_b, w, b, qkv_params(q, k, v), hn, batch, ntok, dim,
                               heads, eps, stream);
}

// o (B, H, N, 64), x (B N, C) -> y = x + gamma * (merge_heads(o) @ Wp (C, C)
// + bp) (B N, C), C = 64 heads, a multiple of 128
extern "C" int sfm_proj_residual_f32(const void* o, const void* x, const void* wp,
                                     const void* bp, const void* gamma, void* y, int batch,
                                     int ntok, int heads, void* stream) {
  return launch_proj<HD>(o, x, wp, bp, gamma, y, batch, ntok, heads, stream);
}

// LN+QKV+RoPE, LN+QKV and the out-projection at head dim 128: q, k, v and o
// (B, H, N, 128), W (C, 3 Hl 128), any Hl; the head dim 64 entries' arguments
extern "C" int sfm_ln_qkv_rope_d128_f32(const void* x, const void* ln_w, const void* ln_b,
                                        const void* w, const void* b, const void* qn_w,
                                        const void* qn_b, const void* kn_w, const void* kn_b,
                                        const void* cos, const void* sin, void* q, void* k,
                                        void* v, void* hn, int batch, int ntok, int dim,
                                        int heads, float eps, void* stream) {
  Params p = qkv_params(q, k, v);
  if (!rope_params(p, qn_w, qn_b, kn_w, kn_b, cos, sin))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qkv<E_QKV_ROPE, HD128>(x, ln_w, ln_b, w, b, p, hn, batch, ntok, dim, heads,
                                       eps, stream);
}

extern "C" int sfm_ln_qkv_d128_f32(const void* x, const void* ln_w, const void* ln_b,
                                   const void* w, const void* b, void* q, void* k, void* v,
                                   void* hn, int batch, int ntok, int dim, int heads, float eps,
                                   void* stream) {
  return launch_qkv<E_QKV, HD128>(x, ln_w, ln_b, w, b, qkv_params(q, k, v), hn, batch, ntok,
                                  dim, heads, eps, stream);
}

extern "C" int sfm_proj_residual_d128_f32(const void* o, const void* x, const void* wp,
                                          const void* bp, const void* gamma, void* y, int batch,
                                          int ntok, int heads, void* stream) {
  return launch_proj<HD128>(o, x, wp, bp, gamma, y, batch, ntok, heads, stream);
}

// x (M, C) -> h = gelu(LN(x) @ W1 (C, Ch) + b1) (M, Ch); hn is an (M, C)
// fp32 scratch buffer that the pre-pass writes and the product reads
extern "C" int sfm_mlp_up_f32(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                              const void* b1, void* h, void* hn, int rows, int dim, int hidden,
                              float eps, void* stream) {
  if (!aligned16(h)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream)) return err;
  Params p = {};
  p.a = static_cast<const float*>(hn);
  p.w = static_cast<const float*>(w1);
  p.bias = static_cast<const float*>(b1);
  p.out = static_cast<float*>(h);
  p.M = rows;
  p.K = dim;
  p.nout = hidden;
  return launch_gemm<E_GELU, HD>(p, stream);
}

// h (M, Ch), x (M, C) -> y = x + gamma * (h @ W2 (Ch, C) + b2) (M, C)
extern "C" int sfm_mlp_down_f32(const void* h, const void* x, const void* w2, const void* b2,
                                const void* gamma, void* y, int rows, int hidden, int dim,
                                void* stream) {
  if (!aligned16(x) || !aligned16(gamma) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.a = static_cast<const float*>(h);
  p.w = static_cast<const float*>(w2);
  p.bias = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.resid = static_cast<const float*>(x);
  p.out = static_cast<float*>(y);
  p.M = rows;
  p.K = hidden;
  p.nout = dim;
  return launch_gemm<E_RESID, HD>(p, stream);
}

// x (M, C) -> hn = LN(x) (M, C) fp32: the pre-pass alone
extern "C" int sfm_ln_rows_f32(const void* x, const void* ln_w, const void* ln_b, void* hn,
                               int rows, int dim, float eps, void* stream) {
  return launch_ln(x, ln_w, ln_b, hn, rows, dim, eps, stream);
}

// What the body was built with and what the compiler gave each kernel (0
// LN+QKV+RoPE, 1 LN+QKV, 2 the out-projection, 3 MLP-up, 4 MLP-down, 5 the
// layer-norm pre-pass; 6-8 the first three at head dim 128): registers a
// thread, local (spill) bytes a thread,
// dynamic shared memory a block, rows and columns a tile, the K step, ring
// stages, threads a block, and the blocks an SM holds at once.
extern "C" int sfm_gemm_f32_info(int which, int* out) {
  if (which < 0 || which >= KERNELS) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_of(which);
  const bool gemm = which != LN_KERNEL;
  const int smem = gemm ? SMEM_BYTES : 0;
  const int threads = gemm ? NTHREADS : LN_ROWS * 32;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (gemm) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = smem;
  out[3] = gemm ? BM : LN_ROWS;
  out[4] = gemm ? BN : 0;
  out[5] = gemm ? BK : 0;
  out[6] = gemm ? STAGES : 0;
  out[7] = threads;
  out[8] = blocks;
  out[9] = 0;
  return 0;
}
