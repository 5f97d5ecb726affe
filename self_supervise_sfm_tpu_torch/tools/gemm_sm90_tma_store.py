"""The TMA-store variant of ``csrc/gemm_sm90.cu``, as textual patches for
``tools/ablate_gemm_sm90.py`` (variants "TMA stores (q, k, v)" and "TMA
stores, 4 stages").

LN+QKV(+RoPE) stage each warpgroup's two 128 x 64 head blocks in shared
memory (the 128-byte swizzle: 16-byte chunk nt of row r at chunk nt ^ (r &
7)) and write each with one TMA store through a 3-D map over (64, N, B H) of
q, k or v; a head's rows are contiguous in (B, H, N, 64). A part whose rows
cross a frame boundary stores from the accumulators, as the shipped body
does everywhere: a TMA store at a negative row (the next frame's box at row
n0 - N) faults on an H100 with an illegal instruction, where a TMA load
would read zeros. Shared memory: the ring, the barriers, then 2 x 2 x 16 KB
of staging, 1024-byte aligned (231,424 bytes at 5 stages of 232,448).
Every kernel of the body then takes the three store maps as parameters.
"""

from __future__ import annotations

HELPERS = r"""
// -- the TMA-store variant ------------------------------------------------------

// a warpgroup's two 128 x 64 head blocks after the barriers, 1024-byte aligned
constexpr int OUT_HEAD_BYTES = WG_M * HD * 2;
constexpr int OUT_OFF = (BAR_OFF + 2 * STAGES * 8 + 1023) / 1024 * 1024;
constexpr int SMEM_QKV_BYTES = 1024 + OUT_OFF + 2 * 2 * OUT_HEAD_BYTES;
static_assert(SMEM_QKV_BYTES <= 232448, "more shared memory than a block can have");

// the TMA store maps of q, k and v: (64, ntok, B H) each
struct QkvMaps {
  CUtensorMap q, k, v;
};

// a TMA store of a box of shared memory to a 3-D map; coordinates past the
// map's end are not written. Completion by bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until this thread's store groups are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's writes to shared memory visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier of the 128 threads of consumer warpgroup cw
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");
}

"""

STORE_QKV = r"""// The TMA stores of a warpgroup's staged part, issued by one thread: each
// head block through the map of its part (q, k or v) at row m0 - N b of
// frame b, the frame of all its rows (rows at N and after are not written).
__device__ __forceinline__ void store_qkv(const Params& p, const CUtensorMap* const (&mo)[3],
                                          int m0, int n0, uint32_t out_smem) {
  const int C = p.heads * HD;
  const int part = n0 / C;
  const int head0 = (n0 - part * C) / HD;
  const CUtensorMap* map = part == 0 ? mo[0] : part == 1 ? mo[1] : mo[2];
  const int b = m0 / p.ntok;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    tma_store_3d(map, out_smem + hh * OUT_HEAD_BYTES, 0, m0 - b * p.ntok,
                 b * p.heads + head0 + hh);
  bulk_commit();
}

"""

ENCODE_HEADS = r"""// A 3-D map over q, k or v (B, H, N, 64) bf16 as (64, N, B H), box (64,
// WG_M, 1) in the 128-byte swizzle: a TMA store of a head block
bool encode_heads(CUtensorMap* map, void* ptr, int ntok, int bh) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(ntok), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {HD * 2, static_cast<cuuint64_t>(ntok) * HD * 2};
  const cuuint32_t box[3] = {HD, WG_M, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int smem_bytes(int ep) { return is_qkv(ep) ? SMEM_QKV_BYTES : SMEM_BYTES; }

"""

# (old, new): each old text must occur exactly once in the shipped source
PATCHES = [
    ("// round an fp32 value to bf16 and back",
     HELPERS.lstrip("\n") + "// round an fp32 value to bf16 and back"),
    ("__device__ __forceinline__ void epilogue_qkv(const Params& p, float (&acc)[2][64], int m0, "
     "int n0) {",
     "__device__ __forceinline__ void epilogue_qkv(const Params& p, float (&acc)[2][64], int m0, "
     "int n0,\n                                             bool staged, uint8_t* out_stage) {"),
    ("      const int row = m0 + h * 64 + warp * 16 + hr * 8 + g;\n"
     "      const bool valid = row < p.M;\n",
     "      const int r = h * 64 + warp * 16 + hr * 8 + g;  // row of the part\n"
     "      const int row = m0 + r;\n"
     "      const bool valid = row < p.M;\n"),
    ("      if (!valid) continue;\n"
     "#pragma unroll\n"
     "      for (int hh = 0; hh < 2; ++hh) {\n"
     "        bf16* dst = out + ((static_cast<size_t>(b) * p.heads + head0 + hh) * p.ntok + n) "
     "* HD + 2 * t;\n"
     "#pragma unroll\n"
     "        for (int nt = 0; nt < 8; ++nt)\n"
     "          *reinterpret_cast<uint32_t*>(dst + 8 * nt) = pack_bf16(v[hh][nt][0], "
     "v[hh][nt][1]);\n"
     "      }\n",
     "#pragma unroll\n"
     "      for (int hh = 0; hh < 2; ++hh) {\n"
     "        if (staged) {\n"
     "          uint8_t* dst = out_stage + hh * OUT_HEAD_BYTES + r * 128 + 4 * t;\n"
     "#pragma unroll\n"
     "          for (int nt = 0; nt < 8; ++nt)\n"
     "            *reinterpret_cast<uint32_t*>(dst + ((nt ^ (r & 7)) << 4)) =\n"
     "                pack_bf16(v[hh][nt][0], v[hh][nt][1]);\n"
     "        } else if (valid) {\n"
     "          bf16* dst = out + ((static_cast<size_t>(b) * p.heads + head0 + hh) * p.ntok + n) "
     "* HD + 2 * t;\n"
     "#pragma unroll\n"
     "          for (int nt = 0; nt < 8; ++nt)\n"
     "            *reinterpret_cast<uint32_t*>(dst + 8 * nt) = pack_bf16(v[hh][nt][0], "
     "v[hh][nt][1]);\n"
     "        }\n"
     "      }\n"),
    ("// out = epilogue(A @ W): A (M, K) through map ma, W (K, nout) through mb\n"
     "template <int EP>\n"
     "__device__ __forceinline__ void gemm(const CUtensorMap* ma, const CUtensorMap* mb, "
     "const Params& p) {",
     STORE_QKV
     + "// out = epilogue(A @ W): A (M, K) through map ma, W (K, nout) through mb;\n"
     "// LN+QKV(+RoPE) store q, k, v through the maps mo\n"
     "template <int EP>\n"
     "__device__ __forceinline__ void gemm(const CUtensorMap* ma, const CUtensorMap* mb,\n"
     "                                     const CUtensorMap* const (&mo)[3], const Params& p) {"),
    ("    const int lane = threadIdx.x & 31;\n    // the block's tiles",
     "    const int lane = threadIdx.x & 31;\n"
     "    // the warpgroup's staging block, as an address and a pointer\n"
     "    const uint32_t out_smem = base + OUT_OFF + cw * 2 * OUT_HEAD_BYTES;\n"
     "    uint8_t* const out_stage = smem_raw + (out_smem - smem_u32(smem_raw));\n"
     "    // the block's tiles"),
    ("      if constexpr (is_qkv(EP))\n"
     "        epilogue_qkv<EP>(p, acc, m0, n0);\n"
     "      else\n"
     "        epilogue<EP>(p, acc, m0, m_end, n0);\n"
     "    }\n"
     "  }\n"
     "}\n",
     "      if constexpr (is_qkv(EP)) {\n"
     "        // staged: the part's rows (those before M) lie in one frame\n"
     "        const bool staged = m0 / p.ntok == (min(m0 + WG_M, p.M) - 1) / p.ntok;\n"
     "        if (staged) {\n"
     "          // the staging block is free once the previous tile's stores read it\n"
     "          if (threadIdx.x % 128 == 0) bulk_wait_read<0>();\n"
     "          warpgroup_sync(cw);\n"
     "        }\n"
     "        epilogue_qkv<EP>(p, acc, m0, n0, staged, out_stage);\n"
     "        if (staged) {\n"
     "          fence_proxy_async();\n"
     "          warpgroup_sync(cw);\n"
     "          if (threadIdx.x % 128 == 0) store_qkv(p, mo, m0, n0, out_smem);\n"
     "        }\n"
     "      } else {\n"
     "        epilogue<EP>(p, acc, m0, m_end, n0);\n"
     "      }\n"
     "    }\n"
     "    if (is_qkv(EP) && threadIdx.x % 128 == 0) bulk_wait_all();\n"
     "  }\n"
     "}\n"),
    ("           const Params p) {                                                                \\\n"
     "    gemm<EP>(&ma, &mb, p);",
     "           const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk, \\\n"
     "           const __grid_constant__ CUtensorMap mv, const Params p) {                 \\\n"
     "    const CUtensorMap* const mo[3] = {&mq, &mk, &mv};                                \\\n"
     "    gemm<EP>(&ma, &mb, mo, p);"),
    ("typedef void (*GemmKernel)(const CUtensorMap, const CUtensorMap, const Params);",
     "typedef void (*GemmKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,\n"
     "                           const CUtensorMap, const CUtensorMap, const Params);"),
    ("// The first launch of each kernel checks",
     ENCODE_HEADS + "// The first launch of each kernel checks"),
    ("cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);",
     "cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                             smem_bytes(EP));"),
    ("int launch_gemm(const void* a, const void* w, Params p, void* stream) {",
     "int launch_gemm(const void* a, const void* w, Params p, void* stream,\n"
     "                const QkvMaps& mo = QkvMaps{}) {"),
    ("  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(ma, mb, p);",
     "  kernel<<<grid, NTHREADS, smem_bytes(EP), static_cast<cudaStream_t>(stream)>>>(\n"
     "      ma, mb, mo.q, mo.k, mo.v, p);"),
    ("  return launch_gemm<EP>(hn, w, p, stream);",
     "  QkvMaps mo = {};\n"
     "  if (rows > 0 && (!encode_heads(&mo.q, p.q, ntok, batch * heads) ||\n"
     "                   !encode_heads(&mo.k, p.k, ntok, batch * heads) ||\n"
     "                   !encode_heads(&mo.v, p.v, ntok, batch * heads)))\n"
     "    return static_cast<int>(cudaErrorInvalidValue);\n"
     "  return launch_gemm<EP>(hn, w, p, stream, mo);"),
    ("  out[2] = which == 3 ? 0 : SMEM_BYTES;",
     "  out[2] = which == 3 ? 0 : which == 4 || which == 5 ? SMEM_QKV_BYTES : SMEM_BYTES;"),
]
