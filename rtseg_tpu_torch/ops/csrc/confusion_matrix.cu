// Evaluation confusion matrix (K2): rtseg_tpu_torch/ops/pallas_metrics.py::
// confusion_matrix_pallas.
//
// Replaces the TPU kernel rtseg_tpu/ops/pallas_metrics.py::_cm_kernel (the
// pl.pallas_call in confusion_matrix_pallas), which builds one-hots of
// 8x8192-pixel blocks on chip and counts them with matrix-unit products.
// On this card the natural form is a histogram of key = label * C + pred.
//
// Bound on this card: bytes. Two int32 maps are read once (8 bytes a pixel)
// and a pixel costs a handful of integer instructions. A kernel that takes
// one pixel a thread and groups each warp's keys with __match_any_sync
// before one shared atomic a group keeps few bytes in flight and pays the
// match on every 32 pixels, most of all where the keys differ: on an H100
// it ran at 2.7 times this one's time on uniform random maps and 1.15
// times on street-like ones. This design streams both maps whatever the
// data and keeps equal keys off the shared-memory atomics:
// - A persistent grid (two blocks of 512 threads an SM; one where a C x C
//   histogram does not fit twice) walks contiguous chunks of both maps. A
//   thread issues all eight of an iteration's 128-bit loads (16 pixels of
//   each map) before it counts any of them, and the first ones before the
//   histogram is zeroed, so up to 128 KB an SM are in flight. A head that
//   is not 16-byte aligned and a tail shorter than a vector take scalar
//   loads; maps whose offsets differ modulo 16 bytes take scalar loads
//   throughout.
// - A thread keeps the run of equal keys it is in as (key, count) in
//   registers, across iterations, and adds it to shared memory only when
//   the key changes: a long run costs no atomic until it ends. At the end
//   of the block's chunk each warp adds its open runs one distinct key at a
//   time (__reduce_add_sync), so a warp that holds one key adds once.
// - One histogram a block in shared memory: with runs counted in
//   registers the warps of a block seldom add to one word at once, and on
//   an H100 a copy a warp (16 at C=19) measured within 0.5% of one copy a
//   block on every input family, so the block's warps share one.
// - Each block adds the non-zero cells of its histogram to the int32
//   output with global atomics: at most C*C a block (361 at C=19, under
//   100,000 for the grid, spread over 361 addresses), so a merge across a
//   thread-block cluster through distributed shared memory has nothing
//   measurable to save. Integer atomics make the counts exact and
//   independent of the launch order.
// What bounds it then: the bytes. It reaches 84-89% of the HBM bound at
// [16,1024,2048] on every input family chip_smoke.py draws and on the
// models' predictions; the uniform random maps, where most valid pixels
// end a run, pay most in atomics.
// The host plan (grid, chunk, head and tail) is
// ops/pallas_metrics.py::k2_plan.
//
// Valid pixels: label != ignore_index, 0 <= label < C and 0 <= pred < C,
// as in the TPU kernel (ignored pixels carry label -1 there, and rows or
// columns past C are sliced away).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;               // ops/pallas_metrics.py _THREADS
constexpr int kVecs = 4;                    // vectors a map a thread loads
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec>
__device__ __forceinline__ int4 load4(const int* __restrict__ base,
                                      int64_t v) {
  if (kVec) return __ldg(reinterpret_cast<const int4*>(base) + v);
  const int* q = base + 4 * v;
  return make_int4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
}

// one iteration's vectors of this thread: warp w of the block owns vectors
// [v + 32*kVecs*w, v + 32*kVecs*(w+1)), lane l the vectors l, l+32, ...
// of them, so each load of a warp reads 512 contiguous bytes
template <bool kVec>
__device__ __forceinline__ void load_iteration(
    const int* __restrict__ labels, const int* __restrict__ preds,
    int64_t first, int64_t end, int4 (&t)[kVecs], int4 (&p)[kVecs]) {
#pragma unroll
  for (int g = 0; g < kVecs; ++g) {
    const int64_t v = first + 32 * g;
    if (v < end) {
      t[g] = load4<kVec>(labels, v);
      p[g] = load4<kVec>(preds, v);
    } else {
      t[g] = make_int4(-1, -1, -1, -1);     // -1 is never a valid label
      p[g] = make_int4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ int pixel_key(int t, int p, int C, int ignore) {
  const bool ok = t != ignore && static_cast<unsigned>(t) <
                  static_cast<unsigned>(C) && static_cast<unsigned>(p) <
                  static_cast<unsigned>(C);
  return ok ? t * C + p : -1;
}

// extend this thread's run, or add it to the block's histogram and start
// a new one (key -1: invalid pixels, never added)
__device__ __forceinline__ void count(int key, int* hist, int& run_key,
                                      unsigned& run_count) {
  if (key != run_key) {
    if (run_key >= 0) atomicAdd(hist + run_key, (int)run_count);
    run_key = key;
    run_count = 0;
  }
  ++run_count;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
confusion_kernel(const int* __restrict__ labels,
                 const int* __restrict__ preds, int head, int64_t nvec,
                 int tail, int64_t chunk, int C, int ignore_index,
                 int* __restrict__ out) {
  extern __shared__ int hist[];   // C x C, cell label * C + pred
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* body_t = labels + head;          // 16-byte aligned when kVec
  const int* body_p = preds + head;
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < nvec ? begin + chunk : nvec;
  const int64_t mine_first = 32 * kVecs * warp + lane;
  const int64_t step = (int64_t)kThreads * kVecs;

  int4 t[kVecs], p[kVecs];
  int64_t v = begin;
  if (v < end)
    load_iteration<kVec>(body_t, body_p, v + mine_first, end, t, p);
  for (int i = threadIdx.x; i < C * C; i += kThreads) hist[i] = 0;
  __syncthreads();

  // the head and the tail, at most 3 pixels each: block 0's first lanes
  if (blockIdx.x == 0 && threadIdx.x < head + tail) {
    const int64_t i = threadIdx.x < head
                          ? threadIdx.x
                          : head + 4 * nvec + (threadIdx.x - head);
    const int key = pixel_key(__ldg(labels + i), __ldg(preds + i), C,
                              ignore_index);
    if (key >= 0) atomicAdd(hist + key, 1);
  }

  int run_key = -1;
  unsigned run_count = 0;
  // the trip count depends on the block only, so the warps stay whole
  for (; v < end; v += step) {
#pragma unroll
    for (int g = 0; g < kVecs; ++g) {
      const int4 a = t[g], b = p[g];
      count(pixel_key(a.x, b.x, C, ignore_index), hist, run_key, run_count);
      count(pixel_key(a.y, b.y, C, ignore_index), hist, run_key, run_count);
      count(pixel_key(a.z, b.z, C, ignore_index), hist, run_key, run_count);
      count(pixel_key(a.w, b.w, C, ignore_index), hist, run_key, run_count);
    }
    if (v + step < end)
      load_iteration<kVec>(body_t, body_p, v + step + mine_first, end, t, p);
  }

  // the warp's open runs, one distinct key a round: one round when the
  // whole warp holds one key
  unsigned todo = __ballot_sync(kFull, run_key >= 0);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const int key = __shfl_sync(kFull, run_key, leader);
    const unsigned total =
        __reduce_add_sync(kFull, run_key == key ? run_count : 0u);
    if (lane == leader) atomicAdd(hist + key, (int)total);
    todo &= ~__ballot_sync(kFull, run_key == key);
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C * C; c += kThreads)
    if (hist[c]) atomicAdd(out + c, hist[c]);
}

}  // namespace

// The launch plan of ops/pallas_metrics.py::k2_plan (K2Args there).
struct K2Args {
  int64_t nvec;     // 16-byte vectors in the body
  int64_t chunk;    // vectors a block walks
  int head;         // scalar pixels before the body
  int tail;         // scalar pixels after it
  int vec;          // 128-bit loads (the maps share their offset mod 16 B)
  int blocks;
  int smem;         // bytes of dynamic shared memory a block
};

// labels, preds: int32, n = head + 4 * nvec + tail contiguous elements.
// out: int32 [C, C], zeroed here on the stream before the kernel. Returns
// the first CUDA error, or cudaGetLastError() after the launch.
extern "C" int rtseg_confusion_matrix(const void* labels, const void* preds,
                                      void* out, int C, int ignore_index,
                                      const K2Args* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * C * C, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  void (*kernel)(const int*, const int*, int, int64_t, int, int64_t, int,
                 int, int*) =
      a->vec ? confusion_kernel<true> : confusion_kernel<false>;
  // the shared memory opted into so far, by instance and device
  static int opted[2][64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* done = dev < 64 ? &opted[a->vec != 0][dev] : nullptr;
  if (a->smem > 48 * 1024 && (!done || *done < a->smem)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (done) *done = a->smem;
  }
  kernel<<<a->blocks, kThreads, a->smem, s>>>(
      static_cast<const int*>(labels), static_cast<const int*>(preds),
      a->head, a->nvec, a->tail, a->chunk, C, ignore_index,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
