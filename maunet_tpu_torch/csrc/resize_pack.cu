// Align-corners bilinear resize of an NHWC tensor: (B, h, w, C) -> (B, oh, ow, C).
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/resize_pack.py::resize_pack
// (body `_make_kernel`, host tap plan `_row_plan`): an H-pass of <= 4 weighted
// rows followed by a W-pass (ow, w) interpolation matmul on the MXU.
//
// What bounds it on the H100: device-memory bytes.  Each output element needs
// at most 2x2 source taps and 8 FLOPs; the dense (ow, w) W-pass matmul of the
// TPU kernel existed only to feed the matrix unit and would spend w/2 useless
// FLOPs per output here.  So the kernel evaluates the two-tap formula of
// ops/resize.py directly.  One thread owns one output pixel and a group of 16
// bytes of channels (8 bf16 or 4 f32, when C allows; else one channel), so
// every load and store is a 16-byte access, consecutive threads touch
// consecutive bytes, and the four tap loads of neighbouring output pixels hit
// the same cache lines in L1/L2.  Index arithmetic is 32-bit: the entry point
// refuses a launch of 2^31 or more work items.  Any (h, w) -> (oh, ow) is
// taken, so the odd fix-up resizes of the decoder (e.g. 30 -> 31) run here too.
//
// Rounding: the four taps are summed in f32 and rounded once to the input
// dtype.  The JAX kernel rounds its H-pass to the input dtype before the
// W-pass, so in bf16 the two differ by about one bf16 ulp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// V channels per thread; C % V == 0.
template <typename T, int V>
__global__ void resize_align_corners_kernel(const T* __restrict__ x,
                                            T* __restrict__ y, int B, int h,
                                            int w, int C, int oh, int ow) {
  using Vt = Vec<T, V>;
  const unsigned groups = static_cast<unsigned>(C / V);
  const unsigned total = static_cast<unsigned>(B) * oh * ow * groups;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const unsigned cg = i % groups;
    unsigned r = i / groups;
    const int ox = static_cast<int>(r % ow);
    r /= ow;
    const int oy = static_cast<int>(r % oh);
    const unsigned b = r / oh;
    int y0, y1, x0, x1;
    float fy, fx;
    axis_taps(oy, h, oh, y0, y1, fy);
    axis_taps(ox, w, ow, x0, x1, fx);
    const T* src = x + static_cast<size_t>(b) * h * w * C + cg * V;
    const Vt v00 = *reinterpret_cast<const Vt*>(src + (static_cast<size_t>(y0) * w + x0) * C);
    const Vt v01 = *reinterpret_cast<const Vt*>(src + (static_cast<size_t>(y0) * w + x1) * C);
    const Vt v10 = *reinterpret_cast<const Vt*>(src + (static_cast<size_t>(y1) * w + x0) * C);
    const Vt v11 = *reinterpret_cast<const Vt*>(src + (static_cast<size_t>(y1) * w + x1) * C);
    Vt out;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float top = (1.f - fx) * to_f32(v00.v[e]) + fx * to_f32(v01.v[e]);
      const float bot = (1.f - fx) * to_f32(v10.v[e]) + fx * to_f32(v11.v[e]);
      from_f32(out.v[e], (1.f - fy) * top + fy * bot);
    }
    *reinterpret_cast<Vt*>(y + static_cast<size_t>(i) * V) = out;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* y, int B, int h, int w, int C, int oh,
                   int ow, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * oh * ow * (C / V);
  if (total == 0) return cudaSuccess;
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  resize_align_corners_kernel<T, V><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), B, h, w, C, oh, ow);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Sides must be below 2^16.  Returns the
// launch's cudaError_t.
extern "C" int maunet_resize_align_corners(const void* x, void* y, int dtype,
                                           int B, int h, int w, int C, int oh,
                                           int ow, void* stream) {
  if (h >= 65536 || w >= 65536 || oh >= 65536 || ow >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte accesses need 16-byte aligned base pointers (a view may not be).
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = (aligned && C % 4 == 0) ? launch<float, 4>(x, y, B, h, w, C, oh, ow, s)
                                  : launch<float, 1>(x, y, B, h, w, C, oh, ow, s);
  else if (dtype == 1)
    err = (aligned && C % 8 == 0)
              ? launch<__nv_bfloat16, 8>(x, y, B, h, w, C, oh, ow, s)
              : launch<__nv_bfloat16, 1>(x, y, B, h, w, C, oh, ow, s);
  return static_cast<int>(err);
}
