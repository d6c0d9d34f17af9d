// Evaluation confusion matrix: rtseg_tpu_torch/ops/pallas_metrics.py::
// confusion_matrix_pallas.
//
// Replaces the TPU kernel rtseg_tpu/ops/pallas_metrics.py::_cm_kernel (the
// pl.pallas_call in confusion_matrix_pallas), which builds one-hots of
// 8x8192-pixel blocks on chip and counts them with matrix-unit products.
// On this card the natural form is a histogram: each block keeps a C x C
// int32 histogram in shared memory, a grid-stride loop feeds it with
// shared-memory atomics, and the block merges it into the int32 output with
// one global atomicAdd per non-zero cell. Integer atomics make the counts
// exact and independent of the launch order.
//
// Bound on this card: bytes (two int32 maps read once). What stands in the
// way is contention: neighbouring pixels mostly share (label, prediction),
// so the lanes of a warp would hit one shared-memory word in turn. Each warp
// therefore groups its lanes by key with __match_any_sync, and one lane per
// group adds the group's size.
//
// Valid pixels: label != ignore_index, 0 <= label < C and 0 <= pred < C,
// as in the TPU kernel (ignored pixels carry label -1 there, and rows or
// columns past C are sliced away).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
confusion_kernel(const int* __restrict__ labels, const int* __restrict__ preds,
                 int64_t n, int C, int ignore_index, int* __restrict__ out) {
  extern __shared__ int hist[];
  const int cells = C * C;
  for (int i = threadIdx.x; i < cells; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // the loop bound depends only on the block, so every lane of a warp runs
  // the same number of iterations and reaches __match_any_sync together
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int key = -1;
    if (i < n) {
      const int t = __ldg(labels + i);
      const int p = __ldg(preds + i);
      if (t != ignore_index && t >= 0 && t < C && p >= 0 && p < C)
        key = t * C + p;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[key], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int v = hist[i];
    if (v) atomicAdd(out + i, v);
  }
}

}  // namespace

// labels, preds: int32 [n] contiguous. out: int32 [C, C], zeroed by the
// caller. blocks: grid size chosen by the caller. Returns cudaGetLastError().
extern "C" int rtseg_confusion_matrix(const void* labels, const void* preds,
                                      int64_t n, int C, int ignore_index,
                                      void* out, int blocks, void* stream) {
  const size_t smem = (size_t)C * C * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        confusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  confusion_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const int*>(preds), n, C,
      ignore_index, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
