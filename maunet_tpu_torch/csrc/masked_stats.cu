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
// (B*H*W * (2*C*sizeof(T) + 4) bytes, 21 MB at the evaluation batch (16, 256,
// 256, 2) f32, 0.0063 ms at 3.35 TB/s) for 5 FLOPs per element, far below the
// card's 20 f32 FLOPs per byte.  The first version was two launches, a
// partial kernel over 2,048-pixel chunks and a reduce of 16 blocks of 45
// threads summing 32 rows each in series, with one pixel (20 bytes) in flight
// per thread per iteration and a scratch tensor between them.  Now one
// launch on thread-block clusters, a Hopper feature:
//   * one cluster of kCluster = 8 blocks of 512 threads per sample, a grid of
//     (8, B): 128 blocks for the 132 SMs at the evaluation batch.  A thread
//     walks the sample in groups of 4 consecutive pixels (2 at 3 and 4
//     channels, whose sums need more registers) at a cluster-wide stride, so
//     a warp's loads are contiguous.  pred and target load as whole 16-byte
//     words (8- or 4-byte where a group is not a multiple of 16 bytes), the
//     classes as one int4 (int2), and every load of the next group goes out
//     before the compares of this one, so one group is always in flight.
//     The pixels before the first group boundary and after the last (fewer
//     than a group each) take one pixel a thread; where the tensors' base
//     addresses are not 16-byte aligned, every pixel does (load_pixel);
//   * each thread keeps 9 * (2C + 1) f32 partial sums in registers, chosen by
//     compares (`cls == k`, one predicated add per sum), so a class value
//     outside 0..8 counts nowhere and indexes nothing;
//   * a reduce-scatter over the warp's lanes (62 shuffles for 45 sums, where
//     a shuffle per sum and step takes 225), then a fixed-order sum over the
//     block's 16 warps in shared memory, give one row per block; after
//     cluster.sync() block rank 0 reads the 8 blocks' rows through
//     distributed shared memory (map_shared_rank) in rank order and writes
//     the sample's row of the output, (B, 9 * (2C + 1)): |err| sums [c][k],
//     err^2 sums [c][k], counts [k].  No atomics, no scratch and no second
//     launch: two runs give the same bits.
// On the H100 (NVIDIA H100 80GB HBM3, 700 W) it takes 0.0118 ms at the
// evaluation batch against the two launches' 0.0139, with the inputs in L2
// (they fit its 50 MB), 0.017 against 0.020 in an evaluation batch's trace.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kClasses = 9;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;   // blocks per sample
// Consecutive pixels whose loads a thread issues together: 4, or 2 at 3 and 4
// channels, whose 9 * (2C + 1) sums leave fewer registers for the loads.
template <int C> __host__ __device__ constexpr int group_pixels() { return C <= 2 ? 4 : 2; }
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

// A value of T from its bits in a 32-bit word (the upper half where `half`).
template <typename T> __device__ __forceinline__ T from_bits(uint32_t w, int half);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(uint32_t w, int half) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * half)));
}
template <> __device__ __forceinline__ __half from_bits<__half>(uint32_t w, int half) {
  return __ushort_as_half(static_cast<unsigned short>(w >> (16 * half)));
}

// The group_pixels<C>() * C values of one group of pixels, loaded as whole
// 16-byte words, or 8- or 4-byte ones where the group is not a multiple of 16
// bytes, and kept as 32-bit words.
template <typename T, int C>
struct Group {
  static constexpr int kPixels = group_pixels<C>();
  static constexpr int kBytes = kPixels * C * static_cast<int>(sizeof(T));
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values a 32-bit word
  uint32_t u[kBytes / 4];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        u[4 * i] = v.x, u[4 * i + 1] = v.y, u[4 * i + 2] = v.z, u[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 8; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[i];
        u[2 * i] = v.x, u[2 * i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) u[i] = reinterpret_cast<const uint32_t*>(p)[i];
    }
  }
  __device__ __forceinline__ T at(int i) const { return from_bits<T>(u[i / kPer], i % kPer); }
};

// The classes of N consecutive pixels (N = 2 or 4) as one 8- or 16-byte load.
template <int N>
__device__ __forceinline__ void load_classes(const int* p, int (&k)[N]) {
  if constexpr (N == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
  } else {
    const int2 v = *reinterpret_cast<const int2*>(p);
    k[0] = v.x, k[1] = v.y;
  }
}

// One step of warp_reduce_scatter: lanes that differ in bit `OFF` swap
// halves of their first M values and add, each keeping M / 2.
template <int N, int M, int OFF>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = upper ? v[i] : v[i + M / 2];
    const float keep = upper ? v[i + M / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums each of the NV values of acc over the warp's 32 lanes by halving
// exchanges (a reduce-scatter): M - M / 32 shuffles for M = NV rounded up to
// a power of two, where one shuffle per value and step would take 5 NV.
// Lane l ends with the sums of values l * (M / 32) + i, i < M / 32, and
// writes those below NV to warp_row.
template <int NV>
__device__ __forceinline__ void warp_reduce_scatter(const float (&acc)[NV], int lane,
                                                    float* warp_row) {
  constexpr int M = NV <= 32 ? 32 : NV <= 64 ? 64 : 128;
  float v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = i < NV ? acc[i] : 0.f;
  halve<M, M, 16>(v, lane);
  halve<M, M / 2, 8>(v, lane);
  halve<M, M / 4, 4>(v, lane);
  halve<M, M / 8, 2>(v, lane);
  halve<M, M / 16, 1>(v, lane);
#pragma unroll
  for (int i = 0; i < M / 32; ++i) {
    const int idx = lane * (M / 32) + i;
    if (idx < NV) warp_row[idx] = v[i];
  }
}

// acc: |err| sums [c][k], then err^2 sums [c][k], then counts [k].  One
// predicated add per sum: a pixel adds to its class's 2C + 1 sums only.
template <int C>
__device__ __forceinline__ void add_pixel(float (&acc)[kClasses * (2 * C + 1)], int cls,
                                          const float (&e)[C]) {
  float a[C], q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = fabsf(e[c]), q[c] = e[c] * e[c];
#pragma unroll
  for (int k = 0; k < kClasses; ++k) {
    if (cls == k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c * kClasses + k] += a[c];
        acc[(C + c) * kClasses + k] += q[c];
      }
      acc[2 * C * kClasses + k] += 1.f;
    }
  }
}

template <typename T, int C>
__device__ __forceinline__ void add_one(float (&acc)[kClasses * (2 * C + 1)], const T* pred,
                                        const T* target, const int* dw, long long p,
                                        bool aligned) {
  T pv[C], tv[C];
  load_pixel<T, C>(pred + p * C, aligned, pv);
  load_pixel<T, C>(target + p * C, aligned, tv);
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = Sub<T>::err(pv[c], tv[c]);
  add_pixel<C>(acc, dw[p], e);
}

// out: (B, 9 * (2C + 1)).  Grid (kCluster, B) in clusters of (kCluster, 1,
// 1): cluster b sums sample b.  VEC: pred, target and dw are 16-byte aligned,
// so a group that starts at a flat pixel index divisible by kGroup is aligned
// to its words.  `aligned`: the bases are aligned to one pixel (load_pixel).
template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
masked_stats_kernel(const T* __restrict__ pred, const T* __restrict__ target,
                    const int* __restrict__ dw, float* __restrict__ out, long long hw,
                    int aligned) {
  constexpr int NV = kClasses * (2 * C + 1);
  constexpr int kGroup = group_pixels<C>();
  constexpr long long kStride = static_cast<long long>(kCluster) * kThreads * kGroup;
  __shared__ float warp_sums[kWarps][NV];
  __shared__ float block_sums[NV];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int lane_c = rank * kThreads + threadIdx.x;  // the thread's place in the cluster
  const long long first = static_cast<long long>(b) * hw, last = first + hw;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  if (VEC) {
    const long long a0 = min((first + kGroup - 1) / kGroup * kGroup, last);
    const long long a1 = max(a0, last / kGroup * kGroup);
    // Software-pipelined: the next group's loads go out before this group's
    // compares, so every thread keeps one group in flight.
    long long p = a0 + static_cast<long long>(lane_c) * kGroup;
    Group<T, C> pg, tg;
    int cls[kGroup];
    if (p < a1) {
      pg.load(pred + p * C);
      tg.load(target + p * C);
      load_classes(dw + p, cls);
    }
    while (p < a1) {
      const long long q = p + kStride;
      Group<T, C> pn, tn;
      int cn[kGroup];
      if (q < a1) {
        pn.load(pred + q * C);
        tn.load(target + q * C);
        load_classes(dw + q, cn);
      }
#pragma unroll
      for (int px = 0; px < kGroup; ++px) {
        float e[C];
#pragma unroll
        for (int c = 0; c < C; ++c) e[c] = Sub<T>::err(pg.at(px * C + c), tg.at(px * C + c));
        add_pixel<C>(acc, cls[px], e);
      }
      pg = pn, tg = tn, p = q;
#pragma unroll
      for (int px = 0; px < kGroup; ++px) cls[px] = cn[px];
    }
    // The pixels before the first group boundary and after the last.
    const long long head = a0 - first, edges = head + (last - a1);
    if (lane_c < edges)
      add_one<T, C>(acc, pred, target, dw, lane_c < head ? first + lane_c : a1 + (lane_c - head),
                    true);
  } else {
    for (long long p = first + lane_c; p < last; p += kCluster * kThreads)
      add_one<T, C>(acc, pred, target, dw, p, aligned != 0);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_reduce_scatter<NV>(acc, lane, warp_sums[warp]);
  __syncthreads();
  if (threadIdx.x < NV) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += warp_sums[w][threadIdx.x];
    block_sums[threadIdx.x] = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < NV) {
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += cluster.map_shared_rank(block_sums, r)[threadIdx.x];
    out[static_cast<long long>(b) * NV + threadIdx.x] = v;
  }
  cluster.sync();  // every block keeps its shared memory until rank 0 has read it
}

template <typename T, int C, bool VEC>
cudaError_t launch(const void* pred, const void* target, const int* dw, float* out, int B,
                   long long hw, int aligned, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, masked_stats_kernel<T, C, VEC>, static_cast<const T*>(pred),
                            static_cast<const T*>(target), dw, out, hw, aligned);
}

template <typename T, int C>
cudaError_t launch_vec(bool vec, const void* pred, const void* target, const int* dw,
                       float* out, int B, long long hw, int aligned, cudaStream_t stream) {
  return vec ? launch<T, C, true>(pred, target, dw, out, B, hw, aligned, stream)
             : launch<T, C, false>(pred, target, dw, out, B, hw, aligned, stream);
}

template <typename T>
cudaError_t launch_c(int C, bool vec, const void* pred, const void* target, const int* dw,
                     float* out, int B, long long hw, cudaStream_t stream) {
  const uintptr_t pixel = sizeof(T) * C;
  const int aligned = reinterpret_cast<uintptr_t>(pred) % pixel == 0 &&
                      reinterpret_cast<uintptr_t>(target) % pixel == 0;
  switch (C) {
    case 1: return launch_vec<T, 1>(vec, pred, target, dw, out, B, hw, aligned, stream);
    case 2: return launch_vec<T, 2>(vec, pred, target, dw, out, B, hw, aligned, stream);
    case 3: return launch_vec<T, 3>(vec, pred, target, dw, out, B, hw, aligned, stream);
    case 4: return launch_vec<T, 4>(vec, pred, target, dw, out, B, hw, aligned, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pred, target: (B, H*W, C) of dtype 0 = f32, 1 = bf16, 2 = f16, C in 1..4;
// dw: (B, H*W) int32; out: (B, 9 * (2C + 1)) f32.  One launch; returns its
// cudaError_t (a refused cluster launch included).
extern "C" int maunet_masked_class_sums(const void* pred, const void* target,
                                        const void* dw, void* out, int B, long long hw,
                                        int C, int dtype, void* stream) {
  if (C < 1 || C > kMaxChannels || B < 0 || B > 65535 || hw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const bool vec = reinterpret_cast<uintptr_t>(pred) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(target) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(dw);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0: return static_cast<int>(launch_c<float>(C, vec, pred, target, d, o, B, hw, s));
    case 1: return static_cast<int>(launch_c<__nv_bfloat16>(C, vec, pred, target, d, o, B, hw, s));
    case 2: return static_cast<int>(launch_c<__half>(C, vec, pred, target, d, o, B, hw, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
