// Align-corners bilinear upsample (K3) for Hopper (sm_90a):
// (N, H, W, C) fp32 -> (N, H2, W2, C) in fp32 or bf16, with an optional fp32
// (H2, W2, C) addend shared across N fused into the store.
//
// Replaces the two Pallas TPU kernels of
// self_supervise_sfm_tpu/ops/resize.py: _resize_w / _w_kernel (the W pass as
// a (W2, W) x (W, C) interp matmul per row) and _resize_h / _h_kernel (the
// 2-tap H lerp with the fused addend and the output cast). On the card the
// W matmul becomes the 2-tap gather it stands for, so one pass reads the
// input once (its taps hit L1/L2) and writes the output once; the sums differ
// from the interp-matrix matmul only by fp32 rounding.
// Taps: lo = min(floor(j * (n - 1) / (n2 - 1)), n - 2), frac computed in
// fp32 as in _h_kernel; y = xw(lo) * (1 - fh) + xw(lo + 1) * fh (+ add).
//
// Bound on an H100: bytes (a handful of FLOPs per 2-14 bytes moved): the
// input, the addend and the output once each. At the DPT head's final
// upsample, 5 x (296, 296, 128) -> (518, 518, 128) bf16 with the (518, 518,
// 128) addend, that is 224 + 137 + 343 MB, 0.21 ms at 3.35 TB/s.
//
// Design. The addend (137 MB) exceeds the 50 MB L2, so a thread mapping
// with the image outermost reads it from device memory once an image. Here
// a thread owns one output pixel (j, i) and 8 channels (4 where C is no
// multiple of 8) of the images of one chunk, [n0, n0 + img_chunk): it loads
// its addend values once into registers and then, image by image, makes the
// four tap loads, the two W lerps and the H lerp, adds and stores. The grid
// is (pixels x channel groups / THREADS, chunks). The host picks the chunk
// (ops/resize.py:image_chunk) so that the grid holds a few waves of the
// card's SMs: at the DPT site (4.3 M threads) the chunk is every image, one
// pass as before; at the fine tracker's many small images, (5120, 16, 16,
// 32) -> 31 x 31, a pixel grid of 16 blocks is cut into 256 chunks of 20
// images, so every SM holds work. Neighbouring threads take neighbouring
// channels, and consecutive blocks walk along i within an output row j, so
// that blocks in flight share their input rows in L1 and L2. Taps load
// through the read-only path; the output (written once, read by nobody
// here) is stored with the streaming hint so that it does not evict the
// input from L2. taps(), the lerp order and its one fused multiply-add are
// those of the image-outermost kernel this replaced, so every output is
// bit-equal to that kernel's (held on an H100, fp32 and bf16 stores), and
// to this kernel's at any chunk; against the plain version (no fused
// multiply-add) the fp32 sums differ by an ulp where the fma rounds once
// instead of twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // a block: 16 pixels of a row at C = 128

__device__ __forceinline__ void taps(int j, int n, int n2, int& lo, float& f) {
  lo = min((j * (n - 1)) / (n2 - 1), n - 2);
  f = (float)(j * (n - 1)) / (float)(n2 - 1) - (float)lo;
}

// a (1 - f) + b f with the second product fused: fma(b, f, a g), as the
// compiler had contracted the same expression written plainly in the
// image-outermost kernel; written out so that no other contraction is chosen
__device__ __forceinline__ float lerp(float a, float b, float f, float g) {
  return __fmaf_rn(b, f, __fmul_rn(a, g));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = 1.f - f;
  return make_float4(lerp(a.x, b.x, f, g), lerp(a.y, b.y, f, g), lerp(a.z, b.z, f, g),
                     lerp(a.w, b.w, f, g));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// V float4 groups a thread (V = 2: 8 channels, V = 1: 4)
template <int V, bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
resize_bilinear_ac_kernel(const float* __restrict__ x, const float* __restrict__ add,
                          void* __restrict__ out, int n_img, int img_chunk, int H, int W,
                          int C, int H2, int W2) {
  const int groups = C / (4 * V);
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)H2 * W2 * groups) return;
  const int c = (int)(idx % groups) * 4 * V;
  const int pix = (int)(idx / groups);
  const int i = pix % W2, j = pix / W2;

  int lh, lw;
  float fh, fw;
  taps(j, H, H2, lh, fh);
  taps(i, W, W2, lw, fw);
  const size_t o_pix = ((size_t)j * W2 + i) * C + c;
  // the addend, once for every image
  float4 p[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    p[v] = add != nullptr ? __ldg(reinterpret_cast<const float4*>(add + o_pix) + v)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t in_img = (size_t)H * W * C, out_img = (size_t)H2 * W2 * C;
  const size_t row = (size_t)W * C;
  // this block's chunk of images: [n0, n0 + count)
  const int n0 = (int)blockIdx.y * img_chunk;
  const int count = min(img_chunk, n_img - n0);
  const float* base = x + (size_t)n0 * in_img + ((size_t)lh * W + lw) * C + c;
  size_t o = (size_t)n0 * out_img + o_pix;
  for (int k = 0; k < count; ++k, base += in_img, o += out_img) {
    const float4* t00 = reinterpret_cast<const float4*>(base);
    const float4* t01 = reinterpret_cast<const float4*>(base + C);
    const float4* t10 = reinterpret_cast<const float4*>(base + row);
    const float4* t11 = reinterpret_cast<const float4*>(base + row + C);
    float4 y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      y[v] = lerp4(lerp4(__ldg(t00 + v), __ldg(t01 + v), fw),
                   lerp4(__ldg(t10 + v), __ldg(t11 + v), fw), fh);
      if (add != nullptr)
        y[v] = make_float4(y[v].x + p[v].x, y[v].y + p[v].y, y[v].z + p[v].z, y[v].w + p[v].w);
    }
    if constexpr (OUT_BF16) {
      bf16* dst = static_cast<bf16*>(out) + o;
      if constexpr (V == 2) {
        __stcs(reinterpret_cast<uint4*>(dst),
               make_uint4(pack2(y[0].x, y[0].y), pack2(y[0].z, y[0].w), pack2(y[1].x, y[1].y),
                          pack2(y[1].z, y[1].w)));
      } else {
        __stcs(reinterpret_cast<uint2*>(dst),
               make_uint2(pack2(y[0].x, y[0].y), pack2(y[0].z, y[0].w)));
      }
    } else {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
#pragma unroll
      for (int v = 0; v < V; ++v) __stcs(dst + v, y[v]);
    }
  }
}

template <int V>
void launch(const float* x, const float* add, void* out, bool out_bf16, int n_img,
            int img_chunk, int H, int W, int C, int H2, int W2, cudaStream_t s) {
  const long long threads = (long long)H2 * W2 * (C / (4 * V));
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS),
                  (unsigned)((n_img + img_chunk - 1) / img_chunk));
  if (out_bf16)
    resize_bilinear_ac_kernel<V, true><<<grid, THREADS, 0, s>>>(x, add, out, n_img, img_chunk,
                                                                H, W, C, H2, W2);
  else
    resize_bilinear_ac_kernel<V, false><<<grid, THREADS, 0, s>>>(x, add, out, n_img, img_chunk,
                                                                 H, W, C, H2, W2);
}

}  // namespace

// img_chunk: images a block walks (1 .. n_img); the grid's y extent,
// ceil(n_img / img_chunk), must stay within 65535
extern "C" int sfm_resize_bilinear_ac(const void* x, const void* add, void* out,
                                      int out_bf16, int n_img, int img_chunk, int H, int W,
                                      int C, int H2, int W2, void* stream) {
  if (C <= 0 || C % 4 || img_chunk <= 0 || (n_img + img_chunk - 1) / img_chunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(add);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0)
    launch<2>(xf, af, out, out_bf16 != 0, n_img, img_chunk, H, W, C, H2, W2, s);
  else
    launch<1>(xf, af, out, out_bf16 != 0, n_img, img_chunk, H, W, C, H2, W2, s);
  return static_cast<int>(cudaGetLastError());
}
