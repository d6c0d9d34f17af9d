// Fused bilinear upsample + channel argmax, in one kernel:
// rtseg_tpu_torch/ops/fused_head.py::resize_argmax on CUDA tensors.
//
// Replaces the TPU kernel rtseg_tpu/ops/fused_head.py::_head_kernel (the
// pl.pallas_call in resize_argmax). There the H-interpolation is a dense
// [TH, h] x [h, C*TW] product on the matrix unit, after a W-interpolation
// that XLA writes to memory. Here each row of both interpolation operators
// has two non-zero taps, so the work is a two-tap stencil with an argmax.
//
// Bound on this card: bytes. For the slice's shape ([16,128,256,19] bf16
// -> [16,1024,2048] int32) the function must read 20 MB and write 134 MB
// (0.046 ms at 3.35 TB/s). Its operations, the two W-taps of each
// low-height value (4 flops) and then one FMA and a compare per pixel and
// class (3 flops), are 2.2 GFLOP (0.033 ms at 67 TFLOP/s fp32).
//
// Design: nothing but the logits and the predictions goes to memory. The
// host plan (fused_head.py::head_plan) cuts the output rows into bands that
// read the same two input rows (lo, hi), runs of bands into groups, and the
// output columns into tiles. A block takes one (batch, group, tile): it
// copies the window of input columns its tile reads, from every input row
// of the group and for all classes, into shared memory (one contiguous NHWC
// run a row, coalesced). Each thread owns an output column. For each band
// it W-interpolates the two input rows once, into 2*C float32 registers
// (u = row lo, d = row hi - row lo); then each output row of the band costs,
// per class, one FMA (u + a*d) and a running argmax with no loads. The
// argmax is a strict '>' over c in increasing order, so the lowest class
// wins an exact tie, like torch.argmax. The register arrays have a
// compile-time size NC, one of a few buckets (fused_head.py's REG_BUCKETS,
// 19 among them for Cityscapes); the window holds NC classes a pixel, the
// classes from C to NC NaN, which never win. A C above the buckets runs the same arithmetic a
// class at a time, reading its taps from x directly, so that any C runs
// without a window in shared memory. Arithmetic is float32 on bf16
// logits too. The grid is one dimension (tile fastest, then group, then
// batch).
//
// What bounds it in practice: the instructions issued per pixel and class.
// Beside the FMA, the argmax costs a compare and a max on the ALU pipe and
// a predicated FMA for the index (take_greater); a plain if/else compiles
// to a compare and two selects, all three on the ALU pipe, which issues at
// half the FMA rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

struct HeadArgs {
  // int32, unpacked in the order of HeadPlan.ints()
  const int* band_start;   // [nbands + 1]
  const int* band_lo;      // [nbands]
  const int* band_hi;      // [nbands]
  const int* group_start;  // [ngroups + 1]
  const int* col_lo;       // [W]
  const int* col_hi;       // [W]
  const int* tile_ws;      // [ntiles]
  const int* tile_nw;      // [ntiles]
  // float32, in the order of HeadPlan.floats() (row_a is a kernel argument)
  const float* col_wlo;    // [W]
  const float* col_whi;    // [W]
  int h, w, C, H, W, ngroups, ntiles, tile_w, win;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// W-interpolation of class c at one output column of an input row (in
// shared memory as float32, or in x); l and r are the offsets of the
// column's two taps, times C.
template <typename R>
__device__ __forceinline__ float w_tap(const R* row, int l, int r, float wl,
                                       float wr, int c) {
  return fmaf(wr, to_f32(row[r + c]), wl * to_f32(row[l + c]));
}

// idx = c where v > best (strict: the lower class keeps a tie), then
// best = max(best, v). The index is a float set by a predicated FMA
// (t * zero + c, zero a runtime 0 so that the compiler cannot turn it into
// a select): a class costs a compare and a max on the ALU pipe, which
// issues at half the FMA pipe's rate on this card, where an if/else costs
// a compare and two selects there.
__device__ __forceinline__ void take_greater(float v, float c, float t,
                                             float zero, float& best,
                                             float& idx) {
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.gt.f32 p, %2, %0;\n\t"
      "max.f32 %0, %0, %2;\n\t"
      "@p fma.rn.f32 %1, %3, %4, %5;\n\t"
      "}"
      : "+f"(best), "+f"(idx)
      : "f"(v), "f"(t), "f"(zero), "f"(c));
}

// NC > 0: C <= NC classes, the window in shared memory with NC classes a
// pixel, a band's two interpolated rows in registers. Classes C..NC-1 are
// NaN in the window, so every value computed from them is NaN, which never
// wins the strict '>' and which max.f32 passes over; class 0 is always
// real. NC == 0: any C, the taps read from x (through L1) and interpolated
// again for each output row, so no window has to fit.
template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads)
head_argmax_kernel(const T* __restrict__ x, const float* __restrict__ row_a,
                   int* __restrict__ out, float zero, HeadArgs a) {
  const int tile = blockIdx.x % a.ntiles;
  const int rest = blockIdx.x / a.ntiles;
  const int group = rest % a.ngroups;
  const int b = rest / a.ngroups;
  const int k0 = a.group_start[group];
  const int k1 = a.group_start[group + 1];
  const int col = tile * a.tile_w + threadIdx.x;
  const bool live = (int)threadIdx.x < a.tile_w && col < a.W;
  const int C = a.C;
  int* o = out + (size_t)b * a.H * a.W + col;

  if constexpr (NC > 0) {
    extern __shared__ float s[];
    const int r0 = a.band_lo[k0];
    const int ws = a.tile_ws[tile];
    const int stride = a.win * NC;  // floats of one input row in s
    // the window: input rows [r0, band_hi[k1 - 1]], columns [ws, ws + nw)
    {
      const int rows = a.band_hi[k1 - 1] - r0 + 1;
      const int n = a.tile_nw[tile] * NC;
      const size_t src_stride = (size_t)a.w * C;
      const T* src = x + (((size_t)b * a.h + r0) * a.w + ws) * C;
      if (C == NC) {
        for (int i = 0; i < rows; ++i, src += src_stride)
          for (int j = threadIdx.x; j < n; j += blockDim.x)
            s[i * stride + j] = to_f32(src[j]);
      } else {
        for (int i = 0; i < rows; ++i, src += src_stride)
          for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const int px = j / NC, c = j - px * NC;
            s[i * stride + j] = c < C ? to_f32(src[px * C + c]) : NAN;
          }
      }
    }
    __syncthreads();
    if (!live) return;
    const int l = (a.col_lo[col] - ws) * NC;
    const int r = (a.col_hi[col] - ws) * NC;
    const float wl = a.col_wlo[col];
    const float wr = a.col_whi[col];
    float u[NC], d[NC];  // row lo, and row hi - row lo
    for (int k = k0; k < k1; ++k) {
      const float* s0 = s + (a.band_lo[k] - r0) * stride;
      const float* s1 = s + (a.band_hi[k] - r0) * stride;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        u[c] = w_tap(s0, l, r, wl, wr, c);
        d[c] = w_tap(s1, l, r, wl, wr, c) - u[c];
      }
      const int y1 = a.band_start[k + 1];
      int y = a.band_start[k];
      for (int* p = o + (size_t)y * a.W; y < y1; ++y, p += a.W) {
        const float t = row_a[y];
        float best = fmaf(t, d[0], u[0]);
        float idx = 0.0f;
#pragma unroll
        for (int c = 1; c < NC; ++c) {
          take_greater(fmaf(t, d[c], u[c]), static_cast<float>(c), t, zero,
                       best, idx);
        }
        *p = static_cast<int>(idx);
      }
    }
  } else {
    if (!live) return;
    const int r = (a.col_hi[col] - a.col_lo[col]) * C;  // from the left tap
    const float wl = a.col_wlo[col];
    const float wr = a.col_whi[col];
    const T* img = x + ((size_t)b * a.h * a.w + a.col_lo[col]) * C;
    for (int k = k0; k < k1; ++k) {
      const T* s0 = img + (size_t)a.band_lo[k] * a.w * C;
      const T* s1 = img + (size_t)a.band_hi[k] * a.w * C;
      const int y1 = a.band_start[k + 1];
      int y = a.band_start[k];
      for (int* p = o + (size_t)y * a.W; y < y1; ++y, p += a.W) {
        const float t = row_a[y];
        float u = w_tap(s0, 0, r, wl, wr, 0);
        float best = fmaf(t, w_tap(s1, 0, r, wl, wr, 0) - u, u);
        int idx = 0;
        for (int c = 1; c < C; ++c) {
          u = w_tap(s0, 0, r, wl, wr, c);
          const float v = fmaf(t, w_tap(s1, 0, r, wl, wr, c) - u, u);
          if (v > best) {
            best = v;
            idx = c;
          }
        }
        *p = idx;
      }
    }
  }
}

struct Launch {
  const float* row_a;
  int* out;
  int blocks, threads, smem;
  cudaStream_t stream;
};

template <typename T, int NC>
int launch(const T* x, const HeadArgs& a, const Launch& g) {
  head_argmax_kernel<T, NC><<<g.blocks, g.threads, g.smem, g.stream>>>(
      x, g.row_a, g.out, 0.0f, a);
  return static_cast<int>(cudaGetLastError());
}

// The register instances: NC in fused_head.py's REG_BUCKETS, and 0 (any C)
template <typename T>
int dispatch(const T* x, const HeadArgs& a, const Launch& g, int nc) {
  switch (nc) {
    case 0: return launch<T, 0>(x, a, g);
    case 1: return launch<T, 1>(x, a, g);
    case 4: return launch<T, 4>(x, a, g);
    case 8: return launch<T, 8>(x, a, g);
    case 16: return launch<T, 16>(x, a, g);
    case 19: return launch<T, 19>(x, a, g);
    case 24: return launch<T, 24>(x, a, g);
    case 32: return launch<T, 32>(x, a, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [B, h, w, C] contiguous, bf16 (is_bf16 != 0) or f32. ints, floats: the
// plan's arrays (HeadPlan.ints(), HeadPlan.floats()). out: int32 [B, H, W].
// blocks = B * ngroups * ntiles; smem = HeadPlan.smem_bytes; nc =
// HeadPlan.reg_classes (the register instance; 0 and no window above
// REG_BUCKETS).
// Returns a cudaError_t as int (0: launched; cudaErrorInvalidValue for an
// nc with no instance).
extern "C" int rtseg_head_argmax(const void* x, const void* ints,
                                 const void* floats, void* out, int blocks,
                                 int h, int w, int C, int H, int W,
                                 int nbands, int ngroups, int ntiles,
                                 int tile_w, int win, int threads, int smem,
                                 int nc, int is_bf16, void* stream) {
  HeadArgs a;
  a.band_start = static_cast<const int*>(ints);
  a.band_lo = a.band_start + nbands + 1;
  a.band_hi = a.band_lo + nbands;
  a.group_start = a.band_hi + nbands;
  a.col_lo = a.group_start + ngroups + 1;
  a.col_hi = a.col_lo + W;
  a.tile_ws = a.col_hi + W;
  a.tile_nw = a.tile_ws + ntiles;
  const float* row_a = static_cast<const float*>(floats);
  a.col_wlo = row_a + H;
  a.col_whi = a.col_wlo + W;
  a.h = h;
  a.w = w;
  a.C = C;
  a.H = H;
  a.W = W;
  a.ngroups = ngroups;
  a.ntiles = ntiles;
  a.tile_w = tile_w;
  a.win = win;
  const Launch g{row_a, static_cast<int*>(out), blocks, threads, smem,
                 static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    return dispatch(static_cast<const __nv_bfloat16*>(x), a, g, nc);
  }
  return dispatch(static_cast<const float*>(x), a, g, nc);
}
