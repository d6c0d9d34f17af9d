// Fused bilinear H-upsample + channel argmax: stage 2 of
// rtseg_tpu_torch/ops/fused_head.py::resize_argmax.
//
// Replaces the TPU kernel rtseg_tpu/ops/fused_head.py::_head_kernel (the
// pl.pallas_call in resize_argmax). The TPU kernel does the H-interpolation
// as a dense [TH, h] x [h, C*TW] product on the matrix unit. Here each output
// row has exactly two non-zero taps in that operator (lo, hi and their
// float32 weights, computed on the host from the same _interp_matrix), so a
// pixel costs 2*C fused multiply-adds instead of h*C: the dense form would be
// bound by the CUDA cores, the two-tap form is bound by memory.
//
// Bound on this card: bytes. The kernel reads the W-interpolated logits
// z[B, h, C, W] (bf16 or f32) and writes int32 predictions [B, H, W]; it
// never materializes the [B, H, W, C] full-resolution logits.
//
// Design: threads run along W, so every load of z[b, row, c, x..x+255] and
// the int32 store coalesce. Each thread computes ROWS consecutive output
// rows at its column: at an 8x upsample those rows share one or two input
// rows, so the repeated loads hit L1 instead of going back to L2/HBM. The
// argmax is a running strict '>' over c in increasing order, so the lowest
// class index wins an exact tie, like torch.argmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_argmax_kernel(const T* __restrict__ z, const int* __restrict__ lo,
                   const int* __restrict__ hi, const float* __restrict__ wlo,
                   const float* __restrict__ whi, int* __restrict__ out,
                   int h, int C, int H, int W) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.z;
  if (x >= W) return;
  const size_t plane = (size_t)C * W;            // one input row, all classes
  const T* zb = z + (size_t)b * h * plane + x;
  int* ob = out + (size_t)b * H * W + x;
  const int y_end = min(H, (int)(blockIdx.y + 1) * kRows);
  for (int y = blockIdx.y * kRows; y < y_end; ++y) {
    const float a0 = __ldg(wlo + y);
    const float a1 = __ldg(whi + y);
    const T* p0 = zb + (size_t)__ldg(lo + y) * plane;
    const T* p1 = zb + (size_t)__ldg(hi + y) * plane;
    float best = a0 * to_f32(p0[0]) + a1 * to_f32(p1[0]);
    int idx = 0;
    for (int c = 1; c < C; ++c) {
      const size_t off = (size_t)c * W;
      const float v = a0 * to_f32(p0[off]) + a1 * to_f32(p1[off]);
      if (v > best) {
        best = v;
        idx = c;
      }
    }
    ob[(size_t)y * W] = idx;
  }
}

}  // namespace

// z: [B, h, C, W] contiguous, bf16 (is_bf16 != 0) or f32. lo/hi: int32 [H],
// wlo/whi: float32 [H]. out: int32 [B, H, W]. Returns cudaGetLastError().
extern "C" int rtseg_head_argmax(const void* z, const void* lo, const void* hi,
                                 const void* wlo, const void* whi, void* out,
                                 int B, int h, int C, int H, int W,
                                 int is_bf16, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, (H + kRows - 1) / kRows, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    head_argmax_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const int*>(lo),
        static_cast<const int*>(hi), static_cast<const float*>(wlo),
        static_cast<const float*>(whi), static_cast<int*>(out), h, C, H, W);
  } else {
    head_argmax_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const int*>(lo),
        static_cast<const int*>(hi), static_cast<const float*>(wlo),
        static_cast<const float*>(whi), static_cast<int*>(out), h, C, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
