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
// Bound on an H100: bytes (a handful of FLOPs per 2-14 bytes moved). One
// thread writes 4 channels: 4 float4 tap loads, one float4 addend load, one
// 8- or 16-byte store, neighbouring threads on neighbouring channels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void taps(int j, int n, int n2, int& lo, float& f) {
  lo = min((j * (n - 1)) / (n2 - 1), n - 2);
  f = (float)(j * (n - 1)) / (float)(n2 - 1) - (float)lo;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = 1.f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f, a.z * g + b.z * f,
                     a.w * g + b.w * f);
}

template <bool OUT_BF16>
__global__ void resize_bilinear_ac_kernel(const float* __restrict__ x,
                                          const float* __restrict__ add,
                                          void* __restrict__ out, int n_img,
                                          int H, int W, int C, int H2, int W2) {
  const int C4 = C / 4;
  const long long total = (long long)n_img * H2 * W2 * C4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C4) * 4;
  long long rest = idx / C4;
  const int i = (int)(rest % W2);
  rest /= W2;
  const int j = (int)(rest % H2);
  const int n = (int)(rest / H2);

  int lh, lw;
  float fh, fw;
  taps(j, H, H2, lh, fh);
  taps(i, W, W2, lw, fw);
  const float* base = x + (((size_t)n * H + lh) * W + lw) * C + c;
  const size_t row = (size_t)W * C;
  const float4 a00 = *reinterpret_cast<const float4*>(base);
  const float4 a01 = *reinterpret_cast<const float4*>(base + C);
  const float4 a10 = *reinterpret_cast<const float4*>(base + row);
  const float4 a11 = *reinterpret_cast<const float4*>(base + row + C);
  float4 y = lerp4(lerp4(a00, a01, fw), lerp4(a10, a11, fw), fh);
  if (add != nullptr) {
    const float4 p =
        *reinterpret_cast<const float4*>(add + ((size_t)j * W2 + i) * C + c);
    y = make_float4(y.x + p.x, y.y + p.y, y.z + p.z, y.w + p.w);
  }
  const size_t o = (((size_t)n * H2 + j) * W2 + i) * C + c;
  if (OUT_BF16) {
    __nv_bfloat162 lo2 = __floats2bfloat162_rn(y.x, y.y);
    __nv_bfloat162 hi2 = __floats2bfloat162_rn(y.z, y.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo2);
    packed.y = *reinterpret_cast<uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) = packed;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = y;
  }
}

}  // namespace

extern "C" int sfm_resize_bilinear_ac(const void* x, const void* add, void* out,
                                      int out_bf16, int n_img, int H, int W,
                                      int C, int H2, int W2, void* stream) {
  const long long total = (long long)n_img * H2 * W2 * (C / 4);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(add);
  if (out_bf16)
    resize_bilinear_ac_kernel<true><<<blocks, threads, 0, s>>>(xf, af, out, n_img,
                                                               H, W, C, H2, W2);
  else
    resize_bilinear_ac_kernel<false><<<blocks, threads, 0, s>>>(xf, af, out, n_img,
                                                                H, W, C, H2, W2);
  return static_cast<int>(cudaGetLastError());
}
