// fp32 forms of the attention forward: K1 (flash forward, out and lse), K1m
// (K1 under a RelocMask), K2 (fused [context | own frame] attention) and K2p
// (K2 against one layer of the kv2 scene cache, read in place), one body on
// the CUDA cores. fp32 in, fp32 out, head dim 64.
//
// Replaces the fp32 forms of the Pallas TPU kernels (dtype-generic there:
// the bf16 forms are flash_fwd_sm90.cu's)
//   K1:  self_supervise_sfm_tpu/ops/flash_attention.py  _flash_fwd / _kernel
//   K1m: the same with mask=RelocMask
//   K2:  self_supervise_sfm_tpu/ops/flash_attention.py  frame_ctx_kernel /
//        _frame_ctx_kernel
//   K2p: self_supervise_sfm_tpu/ops/flash_attention.py
//        frame_ctx_packed_kernel / _frame_ctx_kv2_kernel
// and computes what they compute for fp32 inputs: logits in fp32, a running
// max in the log2 domain, p = exp2(s * c - m) with c = d^-1/2 * log2(e), p
// kept in fp32 for the PV product (the kernels' p.astype(v.dtype) is a no-op
// at fp32), l and O in fp32, out = O / l (l == 0 guarded) and, for K1, the
// natural-log lse = m / log2(e) + log(l). The keys of a ragged last tile are
// forced to NEG_INF by select and their V rows are zero. K2 and K2p fold
// the context tiles of the frame's scene, then the frame's own tiles, into
// one online softmax (tile boundaries restart at key 0 of each source), as
// the bf16 body does; K2p reads the (depth, B, H, Nc, 2 * 64) cache through
// its layer offset and a row stride of 128 floats (k half at the row's
// base, v half 64 floats further) and never writes it. K1m is K2's walk over
// one key tensor laid out [n_ctx context | F frames of P] (the RelocMask: a q
// row of frame f sees the context and frame f's keys): a slice is one frame
// of one (batch, head), its q rows are the frame's P rows, its context the
// first n_ctx keys and its own keys the frame's P, so the mask is expressed
// by where the tiles start and end and nothing outside the allowed pairs is
// loaded; it writes the lse as K1 does, and its out is bit-equal to K2's on
// the unfolded tensors.
//
// Arithmetic: FFMA on the CUDA cores, not 3xTF32. A single TF32 product
// keeps about three decimal digits, some 50x over the fp32 tolerance;
// 3xTF32 (hi * hi + hi * lo + lo * hi, TF32 products on the tensor cores)
// would recover ~fp32 accuracy at 495 / 3 = 165 TFLOP/s but needs the
// operands split and the fragments laid out for the tensor cores. FFMA is
// exact fp32 products with one rounding a multiply-add, in the order of a
// dot product, and keeps the first fp32 body simple; its ceiling is the
// card's 67 TFLOP/s of fp32. As in the bf16 body, the scale is folded into
// the FFMA of the exp2 argument and exp2 is ex2.approx.ftz (about 2 ulps; p
// below 2^-126 becomes 0).
//
// Bound on an H100 SXM: operations. 4 * Nq * Nk * 64 FLOPs (K1m: over the
// allowed pairs) over the q / k / v / o bytes is 340-1700 FLOP/byte at the main-path sizes, far above the
// fp32 ridge of 67e12 / 3.35e12 = 20 FLOP/byte. At 67 TFLOP/s: the ViT site
// (80, 1374) 0.58 ms, the frame site (160, 1374) 1.15 ms, the global site
// (16, 6870) 2.89 ms, K2 / K2p at the reloc site (80 slices of 1374 rows
// against 1525 + 1374 keys) 1.22 ms, K2p against a 20-anchor cache (6100 +
// 1374 keys) 3.14 ms, K1m at the 5-query mask (16 x 5 frames of 1374 rows
// against 1525 + 1374 keys) 1.22 ms.
//
// Design (first version: right and simple; wgmma TF32 with TMA, or warp
// specialisation, is later work). A block of 256 threads owns 64 q rows of
// one slice (grid: q tiles x slices) and streams 64-key K and V tiles
// through two shared-memory stages with 16-byte cp.async loads (the next
// tile's copies in flight while the current tile computes; rows past a
// source's end zero-filled by a copy of 0 source bytes). Thread (tr, tc) =
// (tid / 16, tid % 16) owns q rows 4 tr .. 4 tr + 3: of S = Q K^T the keys tc
// + 16 j (j < 4), of O the channels 4 tc .. 4 tc + 3. Each 4-channel step of
// S is 8 shared-memory float4 loads and 64 FFMA; rows are padded to 68
// floats so that the 16 keys a warp reads at once fall on distinct banks.
// The row max and sum reduce over the 16 lanes of a row group with xor
// shuffles (the same value on every lane). P goes through shared memory:
// its rows are written and read by the warp that owns them, so a __syncwarp
// orders them. Shared memory: q 17 KB + two stages of K and V 68 KB + P 17
// KB = 104,448 bytes, two blocks an SM. Every output row is computed by one
// block in one fixed order of key tiles: no split over keys, no atomics, and
// a repeat is bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BM = 64;         // q rows a block
constexpr int BN = 64;         // keys a K / V tile
constexpr int NTHREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int LD = D + 4;      // floats a row of a shared-memory tile (272 bytes)
constexpr int TILE = BM * LD;  // floats of one tile (q, K, V or P)
constexpr int SMEM_BYTES = 6 * TILE * 4;  // q, K x 2, V x 2, P
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* ck;     // context K rows (K2: (B, H, Nc, 64); K2p: the layer's [k | v] rows;
                       // K1m: the key tensor's first n_ctx rows)
  const float* cv;     // context V rows
  float* o;
  float* lse;          // K1, K1m (null: not written)
  int nq;              // q rows of a slice
  int nk;              // own keys of a slice
  // a slice's own keys: k + k_off + (slice / kf) * k_slice + (slice % kf) *
  // nk * 64 (K1, K2, K2p: one frame a key slice; K1m: the F frames of a
  // (batch, head) after its context)
  int kf;
  long long k_off;
  long long k_slice;
  int nc;              // context keys of a scene (K2, K2p)
  int heads;           // slice = bf * heads + h
  int frames;          // scene = bf / frames
  int c_row;           // floats between two context rows: 64 (K2), 128 (K2p)
  long long c_slice;   // floats between two (scene, head) slices of the context
  float scale_log2;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// rows [r0, r0 + 64) of a source of n rows, `stride` floats apart, into a
// padded tile: 64 rows x 16 chunks of 16 bytes, 4 a thread; rows past n zero
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int n,
                                          int stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c >> 4, col = (c & 15) * 4;
    const bool ok = r0 + r < n;
    const float* s = ok ? src + static_cast<long long>(r0 + r) * stride + col : src;
    cp_async16(dst + r * LD + col, s, ok ? 16 : 0);
  }
}

// -- the attention body -------------------------------------------------------

// The keys of slice blockIdx.y stream as [context tiles (CTX) | own tiles].
template <bool CTX>
__device__ __forceinline__ void attention(const Params& p) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = smem + TILE;      // two stages
  float* sv = smem + 3 * TILE;  // two stages
  float* sp = smem + 5 * TILE;

  const int slice = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const float* qs = p.q + static_cast<long long>(slice) * p.nq * D;
  const long long own_off = p.k_off + static_cast<long long>(slice / p.kf) * p.k_slice +
                           static_cast<long long>(slice % p.kf) * p.nk * D;
  const float* ks = p.k + own_off;
  const float* vs = p.v + own_off;
  const float* cks = nullptr;
  const float* cvs = nullptr;
  if (CTX) {
    const long long c = static_cast<long long>(slice / p.heads / p.frames) * p.heads +
                        slice % p.heads;
    cks = p.ck + c * p.c_slice;
    cvs = p.cv + c * p.c_slice;
  }
  const int ctx_tiles = CTX ? cdiv(p.nc, BN) : 0;
  const int tiles = ctx_tiles + cdiv(p.nk, BN);

  auto load_kv = [&](int t, int st) {
    if (CTX && t < ctx_tiles) {
      load_tile(sk + st * TILE, cks, t * BN, p.nc, p.c_row);
      load_tile(sv + st * TILE, cvs, t * BN, p.nc, p.c_row);
    } else {
      load_tile(sk + st * TILE, ks, (t - ctx_tiles) * BN, p.nk, D);
      load_tile(sv + st * TILE, vs, (t - ctx_tiles) * BN, p.nk, D);
    }
    cp_async_commit();
  };

  // q rides in the first K / V tile's copy group
  load_tile(sq, qs, q0, p.nq, D);
  if (tiles > 0) load_kv(0, 0);
  else cp_async_commit();

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
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
    const float* kt = sk + st * TILE;
    const float* vt = sv + st * TILE;

    // S = Q K^T: rows 4 tr + i, keys tc + 16 j; 4 channels a step
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; dd += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (4 * tr + i) * LD + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(kt + (tc + 16 * j) * LD + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // the online softmax of the tile's keys, row by row
    const bool own = t >= ctx_tiles;
    const int k0 = (own ? t - ctx_tiles : t) * BN;
    const int nvalid = own ? p.nk : p.nc;
    if (k0 + BN > nvalid) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + tc + 16 * j >= nvalid) s[i][j] = NEG_INF;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx * p.scale_log2);
      const float alpha = exp2_ftz(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2_ftz(fmaf(s[i][j], p.scale_log2, -mn));
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = mn;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= alpha;
    }

    // P (fp32) to shared memory: the rows of this warp's two row groups
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(4 * tr + i) * LD + tc + 16 * j] = s[i][j];
    __syncwarp();

    // O += P V: rows 4 tr + i, channels 4 tc .. 4 tc + 3; 4 keys a step
#pragma unroll
    for (int kk = 0; kk < BN; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sp + (4 * tr + i) * LD + kk);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(vt + (kk + c) * LD + 4 * tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][0] = fmaf(a[i].x, b[0].x, o[i][0]);
        o[i][1] = fmaf(a[i].x, b[0].y, o[i][1]);
        o[i][2] = fmaf(a[i].x, b[0].z, o[i][2]);
        o[i][3] = fmaf(a[i].x, b[0].w, o[i][3]);
        o[i][0] = fmaf(a[i].y, b[1].x, o[i][0]);
        o[i][1] = fmaf(a[i].y, b[1].y, o[i][1]);
        o[i][2] = fmaf(a[i].y, b[1].z, o[i][2]);
        o[i][3] = fmaf(a[i].y, b[1].w, o[i][3]);
        o[i][0] = fmaf(a[i].z, b[2].x, o[i][0]);
        o[i][1] = fmaf(a[i].z, b[2].y, o[i][1]);
        o[i][2] = fmaf(a[i].z, b[2].z, o[i][2]);
        o[i][3] = fmaf(a[i].z, b[2].w, o[i][3]);
        o[i][0] = fmaf(a[i].w, b[3].x, o[i][0]);
        o[i][1] = fmaf(a[i].w, b[3].y, o[i][1]);
        o[i][2] = fmaf(a[i].w, b[3].z, o[i][2]);
        o[i][3] = fmaf(a[i].w, b[3].w, o[i][3]);
      }
    }
    // every warp is done with this stage and with its P rows
    __syncthreads();
  }
  cp_async_wait<0>();  // with no key tile, q's copies are still in flight

  // out = O / l (l == 0 guarded); lse = m / log2(e) + log(l)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * tr + i;
    if (r >= p.nq) continue;
    const float d = l[i] == 0.f ? 1.f : l[i];
    const long long row = static_cast<long long>(slice) * p.nq + r;
    *reinterpret_cast<float4*>(p.o + row * D + 4 * tc) =
        make_float4(o[i][0] / d, o[i][1] / d, o[i][2] / d, o[i][3] / d);
    if (p.lse && tc == 0) p.lse[row] = m[i] * (1.0f / LOG2E) + logf(d);
  }
}

// K1: slices (batch * head), keys of the slice only
__global__ void __launch_bounds__(NTHREADS, 2) flash_fwd_f32_kernel(const Params p) {
  attention<false>(p);
}

// K2: slices (bf * H + h); the context of scene bf / F, then the frame's keys
__global__ void __launch_bounds__(NTHREADS, 2) frame_ctx_fwd_f32_kernel(const Params p) {
  attention<true>(p);
}

// K2p: K2's body over the kv2 cache's rows (its own name, so that a profile
// tells the serving path's launches apart)
__global__ void __launch_bounds__(NTHREADS, 2) frame_ctx_kv2_fwd_f32_kernel(const Params p) {
  attention<true>(p);
}

// K1m: K2's body over one key tensor [context | frames]; slices (bh * F + f)
__global__ void __launch_bounds__(NTHREADS, 2) flash_fwd_reloc_f32_kernel(const Params p) {
  attention<true>(p);
}

constexpr int KERNELS = 4;  // K1, K2, K2p, K1m

const void* kernel_of(int which) {
  return which == 0   ? reinterpret_cast<const void*>(flash_fwd_f32_kernel)
         : which == 1 ? reinterpret_cast<const void*>(frame_ctx_fwd_f32_kernel)
         : which == 2 ? reinterpret_cast<const void*>(frame_ctx_kv2_fwd_f32_kernel)
                      : reinterpret_cast<const void*>(flash_fwd_reloc_f32_kernel);
}

// -- host side ----------------------------------------------------------------

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// Launch kernel `which` over (q tiles, slices); its first launch sets its
// dynamic shared memory limit (above the 48 KB default).
int launch(int which, const Params& p, int slices, void* stream) {
  static bool ready[KERNELS] = {};
  if (slices <= 0 || p.nq <= 0) return 0;
  if (slices > 65535 || !aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) ||
      !aligned16(p.o) || (p.nc > 0 && (!aligned16(p.ck) || !aligned16(p.cv))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ready[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[which] = true;
  }
  const dim3 grid(cdiv(p.nq, BM), slices);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) flash_fwd_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(p);
  else if (which == 1) frame_ctx_fwd_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(p);
  else if (which == 2) frame_ctx_kv2_fwd_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(p);
  else flash_fwd_reloc_f32_kernel<<<grid, NTHREADS, SMEM_BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v, void* o, void* lse, int nq,
                   int nk, float scale_log2) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.nq = nq;
  p.nk = nk;
  p.kf = 1;
  p.k_slice = static_cast<long long>(nk) * D;
  p.heads = 1;
  p.frames = 1;
  p.scale_log2 = scale_log2;
  return p;
}

}  // namespace

// q / o: (BH, Nq, 64), k / v: (BH, Nk, 64), lse (BH, Nq); fp32, contiguous
extern "C" int sfm_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int nq, int nk, float scale_log2,
                                 void* stream) {
  if (nq < 0 || nk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, o, lse, nq, nk, scale_log2);
  return launch(0, p, bh, stream);
}

// q / k / v / o: (B * F, H, P, 64); ck / cv: (B, H, Nc, 64), B = bf / frames
extern "C" int sfm_frame_ctx_fwd_f32(const void* q, const void* k, const void* v,
                                     const void* ck, const void* cv, void* o, int bf,
                                     int heads, int frames, int np_, int nc, float scale_log2,
                                     void* stream) {
  if (heads <= 0 || frames <= 0 || bf % frames || np_ < 0 || nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, o, nullptr, np_, np_, scale_log2);
  p.ck = static_cast<const float*>(ck);
  p.cv = static_cast<const float*>(cv);
  p.nc = nc;
  p.heads = heads;
  p.frames = frames;
  p.c_row = D;
  p.c_slice = static_cast<long long>(nc) * D;
  return launch(1, p, bf * heads, stream);
}

// ckv is the base of the whole stacked cache (depth, B, H, Nc, 2 * 64);
// layer_stride is the number of elements between two layers (B * H * Nc *
// 128). The context rows of layer `layer` are 128 floats apart: the k half
// at the row's base, the v half 64 floats further.
extern "C" int sfm_frame_ctx_kv2_fwd_f32(const void* q, const void* k, const void* v,
                                         const void* ckv, void* o, int bf, int heads,
                                         int frames, int np_, int nc, int layer,
                                         long long layer_stride, float scale_log2,
                                         void* stream) {
  if (layer < 0 || layer_stride < 0 || heads <= 0 || frames <= 0 || bf % frames || np_ < 0 ||
      nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* base = static_cast<const float*>(ckv) + static_cast<long long>(layer) * layer_stride;
  Params p = make_params(q, k, v, o, nullptr, np_, np_, scale_log2);
  p.ck = base;
  p.cv = base + D;
  p.nc = nc;
  p.heads = heads;
  p.frames = frames;
  p.c_row = 2 * D;
  p.c_slice = static_cast<long long>(nc) * 2 * D;
  return launch(2, p, bf * heads, stream);
}

// q / o: (bh, F * P, 64), k / v: (bh, n_ctx + F * P, 64), keys [context |
// frames], lse (bh, F * P); fp32, contiguous. The arguments of
// sfm_flash_fwd_reloc_sm90: nq = num_frames * frame_size, nk = n_ctx + nq.
extern "C" int sfm_flash_fwd_reloc_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int nq, int nk, int n_ctx,
                                       int frame_size, int num_frames, float scale_log2,
                                       void* stream) {
  if (frame_size <= 0 || num_frames <= 0 || n_ctx < 0 || nq != num_frames * frame_size ||
      nk != n_ctx + nq)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, o, lse, frame_size, frame_size, scale_log2);
  p.ck = static_cast<const float*>(k);
  p.cv = static_cast<const float*>(v);
  p.nc = n_ctx;
  p.frames = num_frames;  // heads 1: the context of slice s is that of (batch, head) s / F
  p.c_row = D;
  p.c_slice = static_cast<long long>(nk) * D;
  p.kf = num_frames;
  p.k_off = static_cast<long long>(n_ctx) * D;
  p.k_slice = static_cast<long long>(nk) * D;
  return launch(3, p, bh * num_frames, stream);
}

// What the body was built with and what the compiler gave each kernel (0 K1,
// 1 K2, 2 K2p, 3 K1m): registers a thread, local (spill) bytes a thread, dynamic
// shared memory a block, q rows a block, keys a tile, threads a block, and
// the blocks an SM holds at once.
extern "C" int sfm_flash_fwd_f32_info(int which, int* out) {
  if (which < 0 || which >= KERNELS) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_of(which);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NTHREADS, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = SMEM_BYTES;
  out[3] = BM;
  out[4] = BN;
  out[5] = NTHREADS;
  out[6] = blocks;
  out[7] = 0;
  return 0;
}
