// fp32 forms of the attention forward: K1 (flash forward, out and lse), K1m
// (K1 under a RelocMask), K2 (fused [context | own frame] attention) and K2p
// (K2 against one layer of the kv2 scene cache, read in place), one body on
// the CUDA cores. fp32 in, fp32 out, head dim 64 or 128 (a template
// parameter of the one body; the head dim 128 kernels carry "d128" in their
// names).
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
// the bf16 body does; K2p reads the (depth, B, H, Nc, 2 D) cache through its
// layer offset and a row stride of 2 D floats (k half at the row's base, v
// half D floats further) and never writes it. K1m is K2's walk over
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
// Bound on an H100 SXM: operations. 4 * Nq * Nk * D FLOPs (K1m: over the
// allowed pairs) over the q / k / v / o bytes is 340-1700 FLOP/byte at the
// main-path sizes, far above the fp32 ridge of 67e12 / 3.35e12 = 20 FLOP/byte.
// At 67 TFLOP/s: the ViT site (80, 1374) 0.58 ms, the frame site (160, 1374)
// 1.15 ms, the global site (16, 6870) 2.89 ms, K2 / K2p at the reloc site (80
// slices of 1374 rows against 1525 + 1374 keys) 1.22 ms, K2p against a
// 20-anchor cache (6100 + 1374 keys) 3.14 ms, K1m at the 5-query mask (16 x 5
// frames of 1374 rows against 1525 + 1374 keys) 1.22 ms; at head dim 128 the
// same sites in 8 heads do the same operations, so the same bounds.
//
// Design (first version: right and simple; wgmma TF32 with TMA, or warp
// specialisation, is later work). A block of 256 threads owns 64 q rows of
// one slice (grid: q tiles x slices) and streams KN-key K and V tiles (KN =
// 64) through two shared-memory stages with 16-byte cp.async loads (the next
// tile's copies in flight while the current tile computes; rows past a
// source's end zero-filled by a copy of 0 source bytes). Thread (tr, tc) =
// (tid / 16, tid % 16) owns q rows 4 tr .. 4 tr + 3: of S = Q K^T the keys tc
// + 16 j (j < KN / 16), of O the channels 64 g + 4 tc .. 64 g + 4 tc + 3 (g
// < D / 64: 16 accumulators at D = 64, 32 at 128). Each 4-channel step of S
// is 8 shared-memory float4 loads and 64 FFMA; rows are padded to D + 4
// floats (68 or 132, 4 banks apart) so that the 16 keys a warp reads at once
// fall on distinct banks. The row max and sum reduce over the 16 lanes of a
// row group with xor shuffles (the same value on every lane). P goes through
// shared memory in rows of KN + 4 floats: its rows are written and read by
// the warp that owns them, so a __syncwarp orders them. Shared memory at D =
// 64: q 17 KB + two stages of K and V 68 KB + P 17 KB = 104,448 bytes, two
// blocks an SM (128 registers a thread); at D = 128: q 33 KB + two stages of
// K and V 132 KB + P 17 KB = 186,368 bytes, one block an SM (255 registers
// allowed). 32-key tiles at 128 (BN_D128 = 32: 110,592 bytes) would hold two
// blocks an SM at 128 registers; tools/ablate_attention.py's "f32" part
// times both. Every output row is computed by one block in one fixed order
// of key tiles: no split over keys, no atomics, and a repeat is bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // q rows a block
constexpr int BN = 64;         // keys a K / V tile at head dim 64
constexpr int BN_D128 = 64;    // keys a K / V tile at head dim 128
constexpr int NTHREADS = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int SMEM_LIMIT = 233472;  // shared memory of an SM (1 KB of it reserved a block)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tiling at head dim D (64 or 128): rows of D + 4 floats (4 banks
// apart), KN keys a K / V tile, P rows of KN + 4 floats; q, two stages of K
// and V, and P in shared memory; the blocks an SM holds at once.
template <int D>
struct Tiling {
  static constexpr int LD = D + 4;
  static constexpr int KN = D == 64 ? BN : BN_D128;
  static constexpr int LDP = KN + 4;
  static constexpr int SMEM_BYTES = (BM * LD + 4 * KN * LD + BM * LDP) * 4;
  static constexpr int MIN_BLOCKS = 2 * (SMEM_BYTES + 1024) <= SMEM_LIMIT ? 2 : 1;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* ck;     // context K rows (K2: (B, H, Nc, D); K2p: the layer's [k | v] rows;
                       // K1m: the key tensor's first n_ctx rows)
  const float* cv;     // context V rows
  float* o;
  float* lse;          // K1, K1m (null: not written)
  int nq;              // q rows of a slice
  int nk;              // own keys of a slice
  // a slice's own keys: k + k_off + (slice / kf) * k_slice + (slice % kf) *
  // nk * D (K1, K2, K2p: one frame a key slice; K1m: the F frames of a
  // (batch, head) after its context)
  int kf;
  long long k_off;
  long long k_slice;
  int nc;              // context keys of a scene (K2, K2p)
  int heads;           // slice = bf * heads + h
  int frames;          // scene = bf / frames
  int c_row;           // floats between two context rows: D (K2), 2 D (K2p)
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

// rows [r0, r0 + ROWS) of a source of n rows, `stride` floats apart, into a
// padded tile: ROWS rows x D / 4 chunks of 16 bytes; rows past n zero
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int n,
                                          int stride) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
    const int c = threadIdx.x + i * NTHREADS;
    const int r = c / CHUNKS, col = (c % CHUNKS) * 4;
    const bool ok = r0 + r < n;
    const float* s = ok ? src + static_cast<long long>(r0 + r) * stride + col : src;
    cp_async16(dst + r * Tiling<D>::LD + col, s, ok ? 16 : 0);
  }
}

// -- the attention body -------------------------------------------------------

// The keys of slice blockIdx.y stream as [context tiles (CTX) | own tiles].
template <int D, bool CTX>
__device__ __forceinline__ void attention(const Params& p) {
  using T = Tiling<D>;
  constexpr int LD = T::LD, KN = T::KN, LDP = T::LDP;
  constexpr int JN = KN / 16;  // keys of S a lane: tc + 16 j
  constexpr int G = D / 64;    // channel groups of O a lane: 64 g + 4 tc .. 64 g + 4 tc + 3
  constexpr int KV = KN * LD;  // floats of a K or V stage
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = smem + BM * LD;  // two stages
  float* sv = sk + 2 * KV;     // two stages
  float* sp = sv + 2 * KV;

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
  const int ctx_tiles = CTX ? cdiv(p.nc, KN) : 0;
  const int tiles = ctx_tiles + cdiv(p.nk, KN);

  auto load_kv = [&](int t, int st) {
    if (CTX && t < ctx_tiles) {
      load_tile<D, KN>(sk + st * KV, cks, t * KN, p.nc, p.c_row);
      load_tile<D, KN>(sv + st * KV, cvs, t * KN, p.nc, p.c_row);
    } else {
      load_tile<D, KN>(sk + st * KV, ks, (t - ctx_tiles) * KN, p.nk, D);
      load_tile<D, KN>(sv + st * KV, vs, (t - ctx_tiles) * KN, p.nk, D);
    }
    cp_async_commit();
  };

  // q rides in the first K / V tile's copy group
  load_tile<D, BM>(sq, qs, q0, p.nq, D);
  if (tiles > 0) load_kv(0, 0);
  else cp_async_commit();

  float o[4][4 * G], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * G; ++e) o[i][e] = 0.f;
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
    const float* kt = sk + st * KV;
    const float* vt = sv + st * KV;

    // S = Q K^T: rows 4 tr + i, keys tc + 16 j; 4 channels a step
    float s[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; dd += 4) {
      float4 a[4], b[JN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (4 * tr + i) * LD + dd);
#pragma unroll
      for (int j = 0; j < JN; ++j)
        b[j] = *reinterpret_cast<const float4*>(kt + (tc + 16 * j) * LD + dd);
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

    // the online softmax of the tile's keys, row by row
    const bool own = t >= ctx_tiles;
    const int k0 = (own ? t - ctx_tiles : t) * KN;
    const int nvalid = own ? p.nk : p.nc;
    if (k0 + KN > nvalid) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j)
          if (k0 + tc + 16 * j >= nvalid) s[i][j] = NEG_INF;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < JN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx * p.scale_log2);
      const float alpha = exp2_ftz(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[i][j] = exp2_ftz(fmaf(s[i][j], p.scale_log2, -mn));
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = mn;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 4 * G; ++e) o[i][e] *= alpha;
    }

    // P (fp32) to shared memory: the rows of this warp's two row groups
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) sp[(4 * tr + i) * LDP + tc + 16 * j] = s[i][j];
    __syncwarp();

    // O += P V: rows 4 tr + i, channels 64 g + 4 tc .. 64 g + 4 tc + 3; 4
    // keys a step, in order
#pragma unroll
    for (int kk = 0; kk < KN; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(sp + (4 * tr + i) * LDP + kk);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[c] = *reinterpret_cast<const float4*>(vt + (kk + c) * LD + 64 * g + 4 * tc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
          float* oi = o[i] + 4 * g;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            oi[0] = fmaf(ai[c], b[c].x, oi[0]);
            oi[1] = fmaf(ai[c], b[c].y, oi[1]);
            oi[2] = fmaf(ai[c], b[c].z, oi[2]);
            oi[3] = fmaf(ai[c], b[c].w, oi[3]);
          }
        }
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
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* og = o[i] + 4 * g;
      *reinterpret_cast<float4*>(p.o + row * D + 64 * g + 4 * tc) =
          make_float4(og[0] / d, og[1] / d, og[2] / d, og[3] / d);
    }
    if (p.lse && tc == 0) p.lse[row] = m[i] * (1.0f / LOG2E) + logf(d);
  }
}

#define SFM_FWD_KERNELS(HD, SUFFIX)                                                             \
  /* K1: slices (batch * head), keys of the slice only */                                      \
  __global__ void __launch_bounds__(NTHREADS, Tiling<HD>::MIN_BLOCKS)                           \
      flash_fwd_##SUFFIX##kernel(const Params p) {                                             \
    attention<HD, false>(p);                                                                    \
  }                                                                                             \
  /* K2: slices (bf * H + h); the context of scene bf / F, then the frame's keys */            \
  __global__ void __launch_bounds__(NTHREADS, Tiling<HD>::MIN_BLOCKS)                           \
      frame_ctx_fwd_##SUFFIX##kernel(const Params p) {                                         \
    attention<HD, true>(p);                                                                     \
  }                                                                                             \
  /* K2p: K2's body over the kv2 cache's rows (its own name, so that a profile */              \
  /* tells the serving path's launches apart) */                                               \
  __global__ void __launch_bounds__(NTHREADS, Tiling<HD>::MIN_BLOCKS)                           \
      frame_ctx_kv2_fwd_##SUFFIX##kernel(const Params p) {                                     \
    attention<HD, true>(p);                                                                     \
  }                                                                                             \
  /* K1m: K2's body over one key tensor [context | frames]; slices (bh * F + f) */             \
  __global__ void __launch_bounds__(NTHREADS, Tiling<HD>::MIN_BLOCKS)                           \
      flash_fwd_reloc_##SUFFIX##kernel(const Params p) {                                       \
    attention<HD, true>(p);                                                                     \
  }

SFM_FWD_KERNELS(64, f32_)
SFM_FWD_KERNELS(128, d128_f32_)
#undef SFM_FWD_KERNELS

constexpr int KERNELS = 8;  // K1, K2, K2p, K1m at head dim 64, then at 128

const void* kernel_of(int which) {
  static const void* const table[KERNELS] = {
      reinterpret_cast<const void*>(flash_fwd_f32_kernel),
      reinterpret_cast<const void*>(frame_ctx_fwd_f32_kernel),
      reinterpret_cast<const void*>(frame_ctx_kv2_fwd_f32_kernel),
      reinterpret_cast<const void*>(flash_fwd_reloc_f32_kernel),
      reinterpret_cast<const void*>(flash_fwd_d128_f32_kernel),
      reinterpret_cast<const void*>(frame_ctx_fwd_d128_f32_kernel),
      reinterpret_cast<const void*>(frame_ctx_kv2_fwd_d128_f32_kernel),
      reinterpret_cast<const void*>(flash_fwd_reloc_d128_f32_kernel)};
  return table[which];
}

int smem_of(int which) {
  return which < 4 ? Tiling<64>::SMEM_BYTES : Tiling<128>::SMEM_BYTES;
}

// -- host side ----------------------------------------------------------------

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// Launch kernel `form` (0 K1, 1 K2, 2 K2p, 3 K1m) at head dim D over (q
// tiles, slices); a kernel's first launch sets its dynamic shared memory
// limit (above the 48 KB default).
template <int D>
int launch(int form, const Params& p, int slices, void* stream) {
  static bool ready[4] = {};
  const int which = form + (D == 128 ? 4 : 0);
  if (slices <= 0 || p.nq <= 0) return 0;
  if (slices > 65535 || !aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) ||
      !aligned16(p.o) || (p.nc > 0 && (!aligned16(p.ck) || !aligned16(p.cv))))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tiling<D>::SMEM_BYTES;
  if (!ready[form]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of(which), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[form] = true;
  }
  Params arg = p;
  void* args[] = {&arg};
  const cudaError_t err =
      cudaLaunchKernel(kernel_of(which), dim3(cdiv(p.nq, BM), slices), dim3(NTHREADS), args,
                       smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
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

template <int D>
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int nq,
              int nk, float scale_log2, void* stream) {
  if (nq < 0 || nk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params<D>(q, k, v, o, lse, nq, nk, scale_log2);
  return launch<D>(0, p, bh, stream);
}

template <int D>
int frame_ctx_fwd(const void* q, const void* k, const void* v, const void* ck, const void* cv,
                  void* o, int bf, int heads, int frames, int np_, int nc, float scale_log2,
                  void* stream) {
  if (heads <= 0 || frames <= 0 || bf % frames || np_ < 0 || nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params<D>(q, k, v, o, nullptr, np_, np_, scale_log2);
  p.ck = static_cast<const float*>(ck);
  p.cv = static_cast<const float*>(cv);
  p.nc = nc;
  p.heads = heads;
  p.frames = frames;
  p.c_row = D;
  p.c_slice = static_cast<long long>(nc) * D;
  return launch<D>(1, p, bf * heads, stream);
}

template <int D>
int frame_ctx_kv2_fwd(const void* q, const void* k, const void* v, const void* ckv, void* o,
                      int bf, int heads, int frames, int np_, int nc, int layer,
                      long long layer_stride, float scale_log2, void* stream) {
  if (layer < 0 || layer_stride < 0 || heads <= 0 || frames <= 0 || bf % frames || np_ < 0 ||
      nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* base = static_cast<const float*>(ckv) + static_cast<long long>(layer) * layer_stride;
  Params p = make_params<D>(q, k, v, o, nullptr, np_, np_, scale_log2);
  p.ck = base;
  p.cv = base + D;
  p.nc = nc;
  p.heads = heads;
  p.frames = frames;
  p.c_row = 2 * D;
  p.c_slice = static_cast<long long>(nc) * 2 * D;
  return launch<D>(2, p, bf * heads, stream);
}

template <int D>
int flash_fwd_reloc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                    int nq, int nk, int n_ctx, int frame_size, int num_frames, float scale_log2,
                    void* stream) {
  if (frame_size <= 0 || num_frames <= 0 || n_ctx < 0 || nq != num_frames * frame_size ||
      nk != n_ctx + nq)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params<D>(q, k, v, o, lse, frame_size, frame_size, scale_log2);
  p.ck = static_cast<const float*>(k);
  p.cv = static_cast<const float*>(v);
  p.nc = n_ctx;
  p.frames = num_frames;  // heads 1: the context of slice s is that of (batch, head) s / F
  p.c_row = D;
  p.c_slice = static_cast<long long>(nk) * D;
  p.kf = num_frames;
  p.k_off = static_cast<long long>(n_ctx) * D;
  p.k_slice = static_cast<long long>(nk) * D;
  return launch<D>(3, p, bh * num_frames, stream);
}

}  // namespace

// q / o: (BH, Nq, 64), k / v: (BH, Nk, 64), lse (BH, Nq); fp32, contiguous
extern "C" int sfm_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int bh, int nq, int nk, float scale_log2,
                                 void* stream) {
  return flash_fwd<64>(q, k, v, o, lse, bh, nq, nk, scale_log2, stream);
}

// q / k / v / o: (B * F, H, P, 64); ck / cv: (B, H, Nc, 64), B = bf / frames
extern "C" int sfm_frame_ctx_fwd_f32(const void* q, const void* k, const void* v,
                                     const void* ck, const void* cv, void* o, int bf,
                                     int heads, int frames, int np_, int nc, float scale_log2,
                                     void* stream) {
  return frame_ctx_fwd<64>(q, k, v, ck, cv, o, bf, heads, frames, np_, nc, scale_log2, stream);
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
  return frame_ctx_kv2_fwd<64>(q, k, v, ckv, o, bf, heads, frames, np_, nc, layer,
                               layer_stride, scale_log2, stream);
}

// q / o: (bh, F * P, 64), k / v: (bh, n_ctx + F * P, 64), keys [context |
// frames], lse (bh, F * P); fp32, contiguous. The arguments of
// sfm_flash_fwd_reloc_sm90: nq = num_frames * frame_size, nk = n_ctx + nq.
extern "C" int sfm_flash_fwd_reloc_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int nq, int nk, int n_ctx,
                                       int frame_size, int num_frames, float scale_log2,
                                       void* stream) {
  return flash_fwd_reloc<64>(q, k, v, o, lse, bh, nq, nk, n_ctx, frame_size, num_frames,
                             scale_log2, stream);
}

// The same four at head dim 128: rows of 128 floats (the kv2 cache's rows of
// 256, the v half 128 floats after the k half).
extern "C" int sfm_flash_fwd_d128_f32(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int bh, int nq, int nk, float scale_log2,
                                      void* stream) {
  return flash_fwd<128>(q, k, v, o, lse, bh, nq, nk, scale_log2, stream);
}

extern "C" int sfm_frame_ctx_fwd_d128_f32(const void* q, const void* k, const void* v,
                                          const void* ck, const void* cv, void* o, int bf,
                                          int heads, int frames, int np_, int nc,
                                          float scale_log2, void* stream) {
  return frame_ctx_fwd<128>(q, k, v, ck, cv, o, bf, heads, frames, np_, nc, scale_log2, stream);
}

extern "C" int sfm_frame_ctx_kv2_fwd_d128_f32(const void* q, const void* k, const void* v,
                                              const void* ckv, void* o, int bf, int heads,
                                              int frames, int np_, int nc, int layer,
                                              long long layer_stride, float scale_log2,
                                              void* stream) {
  return frame_ctx_kv2_fwd<128>(q, k, v, ckv, o, bf, heads, frames, np_, nc, layer,
                                layer_stride, scale_log2, stream);
}

extern "C" int sfm_flash_fwd_reloc_d128_f32(const void* q, const void* k, const void* v,
                                            void* o, void* lse, int bh, int nq, int nk,
                                            int n_ctx, int frame_size, int num_frames,
                                            float scale_log2, void* stream) {
  return flash_fwd_reloc<128>(q, k, v, o, lse, bh, nq, nk, n_ctx, frame_size, num_frames,
                              scale_log2, stream);
}

// What the body was built with and what the compiler gave each kernel (0 K1,
// 1 K2, 2 K2p, 3 K1m; 4-7 the same at head dim 128): registers a thread, local
// (spill) bytes a thread, dynamic shared memory a block, q rows a block, keys
// a tile, threads a block, the blocks an SM holds at once, and the head dim.
extern "C" int sfm_flash_fwd_f32_info(int which, int* out) {
  if (which < 0 || which >= KERNELS) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_of(which);
  const int smem = smem_of(which);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NTHREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = smem;
  out[3] = BM;
  out[4] = which < 4 ? Tiling<64>::KN : Tiling<128>::KN;
  out[5] = NTHREADS;
  out[6] = blocks;
  out[7] = which < 4 ? 64 : 128;
  return 0;
}
