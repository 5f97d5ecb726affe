// The mma.sync bf16 GEMM body of the fused out-projection (fused_block.cu)
// for Hopper (sm_90a).
//
// One block of 8 warps owns a 128 x 256 output tile and loops over K in
// slices of 64; nothing carries over between blocks. Each warp owns 64 rows
// x 64 columns (one attention head wide, so a per-head reduction stays
// inside a quad of lanes) as 4 x 8 mma.sync m16n8k16 tiles with fp32
// accumulators: 128 accumulator registers a thread, one block a
// multiprocessor.
//
// Both operands reach padded shared memory by cp.async through a ring of
// four stages (row strides of 144 and 528 bytes keep every ldmatrix phase on
// distinct banks): up to three slices are in flight while one is multiplied.
// A is read back with ldmatrix, B (the weight, (K, Nout) row-major) with
// ldmatrix.trans into the mma "col" layout; the fragments of k-step kk + 1
// are requested before the products of k-step kk are started.
// The A loader is a template parameter: copy(kt, stage) starts the copies of
// the thread's own 16-byte chunks of slice kt (fused_block.cu's reads merged
// heads).
//
// What limits it (tools/ablate_fused_gemm.py on an H100 80GB HBM3, 13740
// rows; flat A, K 4096, 1024 columns, 115 GFLOP): the whole kernel takes
// 0.453 ms; its products alone 0.244 ms (472 TFLOP/s: mma.sync, and 216
// blocks on 132 multiprocessors), with the ldmatrix reads 0.271 ms; its
// cp.async copies alone 0.280 ms (1.36 GB from L2, B read again by every row
// tile); the epilogue 0.04 ms. Copies and products overlap only in part:
// both go through shared memory and the same instruction slots. Past this
// lie TMA, wgmma and a persistent grid whose epilogue overlaps the next tile
// (gemm_sm90.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sfm_gemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // block rows
constexpr int BN = 256;        // block columns
constexpr int BK = 64;         // K slice
constexpr int STAGES = 4;      // cp.async ring
constexpr int WM = 64;         // warp rows
constexpr int WN = 64;         // warp columns
constexpr int WARPS_M = BM / WM;  // warps along M, then along N
constexpr int WARPS_N = BN / WN;
constexpr int NTHREADS = 32 * WARPS_M * WARPS_N;
constexpr int MIN_BLOCKS = 1;  // blocks a multiprocessor the registers allow
constexpr int MT = WM / 16;    // mma tiles a warp, along M
constexpr int NT = WN / 8;     // and along N
constexpr int LDA = BK + 8;    // padded shared row strides (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int A_STAGE = BM * LDA;  // elements a stage
constexpr int B_STAGE = BK * LDB;
constexpr int TILE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

// round an fp32 value to bf16 and back: the value a bf16 tensor would hold
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16-byte asynchronous copy global -> shared; nbytes == 0 zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int nbytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(a), "l"(gmem), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc = A[m0 : m0 + BM, :] @ W[:, n0 : n0 + BN]. K is a multiple of BK and
// nout a multiple of 8; columns at or past nout are zero-filled. sa and sb are
// the STAGES A and B stages in shared memory.
template <class ALoader>
__device__ __forceinline__ void mainloop(ALoader& al, const bf16* __restrict__ w,
                                         int K, int nout, int n0, bf16* sa, bf16* sb,
                                         float (&acc)[MT][NT][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int KT = K / BK;

  // slice kt of both operands into stage kt % STAGES; one group a slice,
  // committed even when empty so that the group count stays in step
  auto copy_slice = [&](int kt) {
    if (kt < KT) {
      const int slot = kt % STAGES;
      al.copy(kt, sa + slot * A_STAGE);
      bf16* dst = sb + slot * B_STAGE;
#pragma unroll
      for (int i = 0; i < BK * BN / 8 / NTHREADS; ++i) {
        const int c = tid + i * NTHREADS;
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool ok = n0 + col < nout;
        const bf16* src = w + (size_t)(kt * BK + row) * nout + n0 + col;
        cp_async16(dst + row * LDB + col, ok ? src : w, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) copy_slice(s);

  // ldmatrix lane addressing: lanes 8i..8i+7 give the rows of matrix i
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    // own chunks of slices <= kt + 1 have landed; after the barrier every
    // thread's chunks of slice kt have, and stage (kt - 1) % STAGES is free:
    // all warps are done multiplying slice kt - 1
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    copy_slice(kt + STAGES - 1);

    const bf16* ta = sa + (kt % STAGES) * A_STAGE + (wm * WM + lrow) * LDA + lcol;
    const bf16* tb = sb + (kt % STAGES) * B_STAGE + lrow * LDB + wn * WN + lcol;
    // fragments are double buffered in registers: those of k-step kk + 1 are
    // requested before the products of k-step kk are started
    uint32_t af[2][MT][4], bq[2][NT / 2][4];
    auto load_frags = [&](int kk, int buf) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[buf][mt], ta + mt * 16 * LDA + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_trans(bq[buf][np], tb + kk * 16 * LDB + np * 16);
    };
    load_frags(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk + 1 < BK / 16) load_frags(kk + 1, (kk + 1) & 1);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][2 * np], af[kk & 1][mt], bq[kk & 1][np][0], bq[kk & 1][np][1]);
          mma_16816(acc[mt][2 * np + 1], af[kk & 1][mt], bq[kk & 1][np][2],
                    bq[kk & 1][np][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace sfm_gemm
