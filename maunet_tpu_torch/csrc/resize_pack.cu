// Align-corners bilinear resize of an NHWC tensor: (B, h, w, C) -> (B, oh, ow, C).
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/resize_pack.py::resize_pack
// (resize_pack.py:216, its pallas_call at :264; body `_make_kernel`, host tap
// plan `_row_plan`): an H-pass of <= 4 weighted rows out of a window of input
// rows held in VMEM for a block of output rows, then a W-pass (ow, w)
// interpolation matmul on the MXU.
//
// What bounds it on the H100: device-memory bytes at best.  Each output
// element needs 2x2 source taps and 8 FLOPs; the TPU's dense W-pass matmul
// existed only to feed the matrix unit and would spend w/2 useless FLOPs per
// output here, so the kernel evaluates the two-tap formula of ops/resize.py
// directly.  The first kernel gave each thread one output pixel and a
// 16-byte channel group: four 16-byte tap loads per 16-byte store, and the
// taps recomputed with integer and f32 divisions for every output.  On the
// card (NVIDIA H100 80GB HBM3, 700 W; `profile_port.py --resize`) it took
// 0.12 ms for the 128² x 128 -> 256² upsample at B = 8, above the 0.09 ms of a
// plain copy of the output (which moves 1.6x its bytes) and 2.8x the 0.044 ms
// of writing the output alone: the tap loads, four times the output's bytes
// through L1 and L2, bounded it, not the writes.
//
// The column walk (this kernel), as the TPU kernel walks a block of output
// rows out of one window of input rows:
//   * a thread owns one (b, ox, 16-byte channel group) column over a strip of
//     `rows` output rows; consecutive threads take consecutive channel
//     groups, then consecutive ox, so every store of a warp is coalesced;
//   * the column taps (x0, x1, fx) are computed once per thread; the row tap
//     is an integer accumulator walked down the strip (rem += h - 1, and lo
//     advances while rem >= oh - 1), so no output pays a division but the
//     correctly rounded f32 frac = rem / (oh - 1), the very value the first
//     kernel's axis_taps computed;
//   * the W-interpolated f32 vectors of the two source rows lo and hi stay in
//     registers, top = (1 - fx) x[lo, x0] + fx x[lo, x1] and the same for
//     hi, and a source row is loaded (two 16-byte loads) only when the walk
//     reaches it; a x2 upsample shares each source row between about two
//     output rows, so about one load per output instead of four;
//   * out = (1 - fy) top + fy bot, rounded once to the input dtype: the same
//     f32 expressions as the first kernel's, so the same bits;
//   * the host picks `rows` per shape (ops/kernels/resize_pack.py
//     `_strip_rows`) so that the smallest path shape still keeps several
//     blocks on every SM.
// Any (h, w) -> (oh, ow) is taken: a downsample's walk jumps several source
// rows at once, and oh == 1 or h == 1 walk row 0 only.  Index arithmetic is
// 32-bit: the entry point refuses 2^31 or more work items.
//
// Rounding: the four taps are summed in f32 and rounded once to the input
// dtype.  The JAX kernel rounds its H-pass to the input dtype before the
// W-pass, so in bf16 the two differ by about one bf16 ulp.
//
// The row window (maunet_resize_align_corners_rows, the spatial mesh axis:
// parallel/spatial.py).  A rank that holds a band of an image's rows computes
// output rows [out_row0, out_row0 + oh) of the global h_total -> oh_total
// resize from the source rows [src_row0, src_row0 + h) it holds (its own band
// and a halo row of each neighbour).  The row walk runs in global
// coordinates, the same integer arithmetic and the same f32 expressions as
// the whole resize, and only the loads subtract src_row0: so the window's
// rows are the whole resize's rows bit for bit.  The whole resize is the
// window (0, 0, h, oh), through the same kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

// Align-corners source taps of output index `o` on an axis n_in -> n_out:
// src = o * (n_in - 1) / (n_out - 1), split into floor, ceil and fraction.
// Integer arithmetic keeps `lo` exact; `frac` is one correctly rounded
// division, the f32 value of ops/resize.py::_interp_matrix's weights.  Sides
// are below 2^16, so the product fits 32 bits.
__device__ __forceinline__ void axis_taps(int o, int n_in, int n_out, int& lo,
                                          int& hi, float& frac) {
  if (n_out == 1 || n_in == 1) {
    lo = hi = 0;
    frac = 0.f;
    return;
  }
  const unsigned num = static_cast<unsigned>(o) * (n_in - 1);
  const unsigned q = num / (n_out - 1);
  lo = static_cast<int>(q);
  frac = static_cast<float>(num - q * (n_out - 1)) / static_cast<float>(n_out - 1);
  hi = min(lo + 1, n_in - 1);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }

// The W-interpolated f32 row (1 - fx) x[row, x0] + fx x[row, x1].
template <typename T, int V>
__device__ __forceinline__ void w_row(const T* col0, const T* col1, size_t offset,
                                      float fx, float (&out)[V]) {
  using Vt = Vec<T, V>;
  const Vt a = *reinterpret_cast<const Vt*>(col0 + offset);
  const Vt b = *reinterpret_cast<const Vt*>(col1 + offset);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = (1.f - fx) * to_f32(a.v[e]) + fx * to_f32(b.v[e]);
}

// V channels per thread (C % V == 0), `rows` output rows per thread.  `x`
// holds source rows [src_row0, src_row0 + h) and `y` output rows
// [out_row0, out_row0 + oh) of an h_total -> oh_total resize.
template <typename T, int V>
__global__ void __launch_bounds__(256) resize_align_corners_kernel(
    const T* __restrict__ x, T* __restrict__ y, int B, int h, int w, int C, int oh,
    int ow, int rows, int h_total, int oh_total, int src_row0, int out_row0) {
  using Vt = Vec<T, V>;
  const unsigned groups = static_cast<unsigned>(C / V);
  const unsigned strips = static_cast<unsigned>((oh + rows - 1) / rows);
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= static_cast<unsigned>(B) * strips * ow * groups) return;
  const unsigned cg = i % groups;
  unsigned r = i / groups;
  const int ox = static_cast<int>(r % ow);
  r /= ow;
  const int oy0 = static_cast<int>(r % strips) * rows;
  const unsigned b = r / strips;
  const int oy_end = min(oy0 + rows, oh);

  int x0, x1;
  float fx;
  axis_taps(ox, w, ow, x0, x1, fx);
  const T* src = x + static_cast<size_t>(b) * h * w * C + cg * V;
  const T* col0 = src + static_cast<size_t>(x0) * C;
  const T* col1 = src + static_cast<size_t>(x1) * C;
  const size_t src_row = static_cast<size_t>(w) * C;
  const size_t dst_row = static_cast<size_t>(ow) * C;
  T* dst = y + ((static_cast<size_t>(b) * oh + oy0) * ow + ox) * C + cg * V;

  // Row taps of the global output row o = out_row0 + oy: lo = floor(o
  // (h_total - 1) / (oh_total - 1)), rem the remainder; oh_total == 1 or
  // h_total == 1 keep lo = rem = 0.  lo and hi are global source rows.
  const unsigned den = oh_total > 1 ? static_cast<unsigned>(oh_total - 1) : 1u;
  const unsigned step = (oh_total > 1 && h_total > 1) ? static_cast<unsigned>(h_total - 1) : 0u;
  const unsigned num = static_cast<unsigned>(out_row0 + oy0) * step;
  int lo = static_cast<int>(num / den);
  unsigned rem = num - static_cast<unsigned>(lo) * den;

  float top[V], bot[V];  // W-interpolated source rows top_row and bot_row
  int top_row = -1, bot_row = -1;
  for (int oy = oy0; oy < oy_end; ++oy) {
    const int hi = min(lo + 1, h_total - 1);
    const float fy = static_cast<float>(rem) / static_cast<float>(den);
    if (lo != top_row) {
      if (lo == bot_row) {
#pragma unroll
        for (int e = 0; e < V; ++e) top[e] = bot[e];
      } else {
        w_row<T, V>(col0, col1, (lo - src_row0) * src_row, fx, top);
      }
      top_row = lo;
    }
    if (hi != bot_row) {
      if (hi == top_row) {
#pragma unroll
        for (int e = 0; e < V; ++e) bot[e] = top[e];
      } else {
        w_row<T, V>(col0, col1, (hi - src_row0) * src_row, fx, bot);
      }
      bot_row = hi;
    }
    Vt out;
#pragma unroll
    for (int e = 0; e < V; ++e) from_f32(out.v[e], (1.f - fy) * top[e] + fy * bot[e]);
    *reinterpret_cast<Vt*>(dst) = out;
    dst += dst_row;
    rem += step;
    while (rem >= den) {
      rem -= den;
      ++lo;
    }
  }
}

// The geometry of one launch: a window of h source rows from src_row0 and oh
// output rows from out_row0 of an h_total -> oh_total resize.
struct Rows {
  int h, oh, h_total, oh_total, src_row0, out_row0;
};

template <typename T, int V>
cudaError_t launch(const void* x, void* y, int B, Rows r, int w, int C, int ow,
                   int rows, cudaStream_t stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * r.oh * ow * (C / V) >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * ((r.oh + rows - 1) / rows) * ow * (C / V);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  resize_align_corners_kernel<T, V>
      <<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), B, r.h, w, C, r.oh, ow, rows,
          r.h_total, r.oh_total, r.src_row0, r.out_row0);
  return cudaGetLastError();
}

// Global source row of output row o's lower tap.
long long tap(long long o, const Rows& r) {
  return r.oh_total > 1 ? o * (r.h_total - 1) / (r.oh_total - 1) : 0;
}

int dispatch(const void* x, void* y, int dtype, int B, Rows r, int w, int C, int ow,
             int rows, void* stream) {
  if (r.h_total >= 65536 || w >= 65536 || r.oh_total >= 65536 || ow >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  // The window must lie in the image and hold every row its outputs read:
  // the lower tap of the first and min(lower + 1, h_total - 1) of the last.
  if (r.h < 1 || r.oh < 1 || r.src_row0 < 0 || r.out_row0 < 0 ||
      r.src_row0 + r.h > r.h_total || r.out_row0 + r.oh > r.oh_total ||
      tap(r.out_row0, r) < r.src_row0 ||
      std::min(tap(r.out_row0 + r.oh - 1, r) + 1, static_cast<long long>(r.h_total - 1)) >=
          r.src_row0 + r.h)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte accesses need 16-byte aligned base pointers (a view may not be).
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = (aligned && C % 4 == 0) ? launch<float, 4>(x, y, B, r, w, C, ow, rows, s)
                                  : launch<float, 1>(x, y, B, r, w, C, ow, rows, s);
  else if (dtype == 1)
    err = (aligned && C % 8 == 0)
              ? launch<__nv_bfloat16, 8>(x, y, B, r, w, C, ow, rows, s)
              : launch<__nv_bfloat16, 1>(x, y, B, r, w, C, ow, rows, s);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Sides must be below 2^16; `rows` >= 1
// output rows per thread.  Returns the launch's cudaError_t.
extern "C" int maunet_resize_align_corners(const void* x, void* y, int dtype,
                                           int B, int h, int w, int C, int oh,
                                           int ow, int rows, void* stream) {
  return dispatch(x, y, dtype, B, Rows{h, oh, h, oh, 0, 0}, w, C, ow, rows, stream);
}

// The row window: `x` is (B, h, w, C), global source rows [src_row0,
// src_row0 + h) of an h_total-row image; `y` is (B, oh, ow, C), output rows
// [out_row0, out_row0 + oh) of its resize to oh_total rows.  The window
// must hold every source row those outputs read.
extern "C" int maunet_resize_align_corners_rows(const void* x, void* y, int dtype,
                                                int B, int h, int w, int C, int oh,
                                                int ow, int rows, int h_total,
                                                int oh_total, int src_row0,
                                                int out_row0, void* stream) {
  return dispatch(x, y, dtype, B, Rows{h, oh, h_total, oh_total, src_row0, out_row0}, w,
                  C, ow, rows, stream);
}
