// Per-class masked error sums of the evaluator: for every sample and channel
// the sums of |err| and err^2 over the pixels of each of the 9 Dynamic World
// classes, and per sample the pixel count of each class, where
// err = float(pred - target) with the subtraction in the inputs' own type.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/masked_stats.py::
// masked_class_sums (body `_kernel`).  That kernel's grid of whole (sample,
// channel) images is a constraint of the TPU's compiler and is not carried
// over; what is kept is that no one-hot tensor exists in device memory.
//
// What bounds it on the H100: bytes.  Every input element is read once
// (B*H*W * (2*C*sizeof(T) + 4) bytes) for 5 FLOPs per element, far below the
// card's 20 f32 FLOPs per byte.  The design:
//   * a block of 256 threads owns 2,048 consecutive pixels of one sample (a
//     grid of chunks x samples fills the card at the evaluation batch: 512
//     blocks at (16, 256, 256, 2)); a thread reads its pixel's class once and
//     the pixel's C values of pred and target as one 4-, 8- or 16-byte vector
//     where C * sizeof(T) is such a size, and keeps 9 * (2C + 1) f32 partial
//     sums in registers, selected by compares (`cls == k`), so a class value
//     outside 0..8 counts nowhere and indexes nothing;
//   * warp shuffles, then a fixed-order sum over the block's 8 warps, give one
//     partial row per block; a second launch adds the blocks' rows in chunk
//     order.  No float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace {

constexpr int kClasses = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 8;   // pixels per block
constexpr int kMaxChannels = 4;

template <typename T> struct Sub;
template <> struct Sub<float> {
  static __device__ __forceinline__ float err(float p, float t) { return p - t; }
};
template <> struct Sub<__nv_bfloat16> {
  static __device__ __forceinline__ float err(__nv_bfloat16 p, __nv_bfloat16 t) {
    return __bfloat162float(__float2bfloat16_rn(__bfloat162float(p) - __bfloat162float(t)));
  }
};
template <> struct Sub<__half> {
  static __device__ __forceinline__ float err(__half p, __half t) {
    return __half2float(__float2half_rn(__half2float(p) - __half2float(t)));
  }
};

template <int BYTES> struct VecOf { using type = void; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// The C values of one pixel; one vector load where the pixel is 4, 8 or 16
// bytes and `aligned` says the tensor's base is aligned to that size.
template <typename T, int C>
__device__ __forceinline__ void load_pixel(const T* p, bool aligned, T (&v)[C]) {
  using V = typename VecOf<sizeof(T) * C>::type;
  if constexpr (!std::is_void<V>::value) {
    if (aligned) {
      const V vec = *reinterpret_cast<const V*>(p);
      memcpy(&v[0], &vec, sizeof(V));
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = p[c];
}

// partial: (B, nchunks, NV) with NV = 9 * (2C + 1): |err| sums [c][k], then
// err^2 sums [c][k], then counts [k].
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
masked_stats_partial_kernel(const T* __restrict__ pred, const T* __restrict__ target,
                            const int* __restrict__ dw, float* __restrict__ partial,
                            long long hw, int aligned) {
  constexpr int NV = kClasses * (2 * C + 1);
  __shared__ float warp_sums[kWarps][NV];

  const int b = blockIdx.y;
  const long long base = static_cast<long long>(b) * hw;
  const long long first = static_cast<long long>(blockIdx.x) * kChunk;
  const long long last = first + kChunk < hw ? first + kChunk : hw;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  for (long long p = first + threadIdx.x; p < last; p += kThreads) {
    const int cls = dw[base + p];
    T pv[C], tv[C];
    load_pixel<T, C>(pred + (base + p) * C, aligned != 0, pv);
    load_pixel<T, C>(target + (base + p) * C, aligned != 0, tv);
    float e[C];
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = Sub<T>::err(pv[c], tv[c]);
#pragma unroll
    for (int k = 0; k < kClasses; ++k) {
      const bool hit = cls == k;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c * kClasses + k] += hit ? fabsf(e[c]) : 0.f;
        acc[(C + c) * kClasses + k] += hit ? e[c] * e[c] : 0.f;
      }
      acc[2 * C * kClasses + k] += hit ? 1.f : 0.f;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    partial[(static_cast<long long>(b) * gridDim.x + blockIdx.x) * NV + threadIdx.x] = v;
  }
}

// One block per sample: thread i < NV adds the sample's chunk rows in order
// and writes its sum to its place in sum_abs / sum_sq (B, C, 9) or counts
// (B, 9).
__global__ void masked_stats_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ sum_abs,
                                           float* __restrict__ sum_sq,
                                           float* __restrict__ counts, int nchunks,
                                           int C) {
  const int nv = kClasses * (2 * C + 1);
  const int i = threadIdx.x;
  if (i >= nv) return;
  const int b = blockIdx.x;
  const float* rows = partial + static_cast<long long>(b) * nchunks * nv + i;
  float v = 0.f;
  for (int j = 0; j < nchunks; ++j) v += rows[static_cast<long long>(j) * nv];
  const int ck = C * kClasses;
  if (i < ck) {
    sum_abs[static_cast<long long>(b) * ck + i] = v;
  } else if (i < 2 * ck) {
    sum_sq[static_cast<long long>(b) * ck + i - ck] = v;
  } else {
    counts[static_cast<long long>(b) * kClasses + i - 2 * ck] = v;
  }
}

template <typename T, int C>
cudaError_t launch_partial(const void* pred, const void* target, const int* dw,
                           float* partial, int B, long long hw, int nchunks,
                           cudaStream_t stream) {
  constexpr uintptr_t pixel = sizeof(T) * C;
  const int aligned = reinterpret_cast<uintptr_t>(pred) % pixel == 0 &&
                      reinterpret_cast<uintptr_t>(target) % pixel == 0;
  masked_stats_partial_kernel<T, C><<<dim3(nchunks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(pred), static_cast<const T*>(target), dw, partial, hw,
      aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_partial_c(int C, const void* pred, const void* target,
                             const int* dw, float* partial, int B, long long hw,
                             int nchunks, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_partial<T, 1>(pred, target, dw, partial, B, hw, nchunks, stream);
    case 2: return launch_partial<T, 2>(pred, target, dw, partial, B, hw, nchunks, stream);
    case 3: return launch_partial<T, 3>(pred, target, dw, partial, B, hw, nchunks, stream);
    case 4: return launch_partial<T, 4>(pred, target, dw, partial, B, hw, nchunks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pred, target: (B, H*W, C) of dtype 0 = f32, 1 = bf16, 2 = f16, C in 1..4;
// dw: (B, H*W) int32; partial: (B, nchunks, 9 * (2C + 1)) f32 of scratch with
// nchunks = ceil(H*W / 2048).  Returns the first failing launch's cudaError_t.
extern "C" int maunet_masked_class_sums(const void* pred, const void* target,
                                        const void* dw, void* partial, void* sum_abs,
                                        void* sum_sq, void* counts, int B,
                                        long long hw, int nchunks, int C, int dtype,
                                        void* stream) {
  if (C < 1 || C > kMaxChannels || B < 0 || B > 65535 || hw < 1 ||
      nchunks != (hw + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dw);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_partial_c<float>(C, pred, target, d, part, B, hw, nchunks, s); break;
    case 1: err = launch_partial_c<__nv_bfloat16>(C, pred, target, d, part, B, hw, nchunks, s); break;
    case 2: err = launch_partial_c<__half>(C, pred, target, d, part, B, hw, nchunks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  masked_stats_reduce_kernel<<<B, 128, 0, s>>>(part, static_cast<float*>(sum_abs),
                                               static_cast<float*>(sum_sq),
                                               static_cast<float*>(counts), nchunks, C);
  return static_cast<int>(cudaGetLastError());
}
