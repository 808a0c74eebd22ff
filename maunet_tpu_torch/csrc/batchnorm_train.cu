// Train-mode BatchNorm with ReLU after a conv: out = relu(BN(y + bias)),
// rounded to y's type, with batch statistics, and its backward.
//
// Replaces no TPU kernel: the JAX package computes this with flax's
// nn.BatchNorm and jax.nn.relu (maunet_tpu/models/blocks.py:506-521), which
// XLA fuses.  In plain torch (models/blocks.py batch_norm_train under
// autograd) it takes about thirty f32 passes a conv, forward and backward,
// and saves f32 copies of every activation for the backward.
//
// The arithmetic is the plain version's: yb = y + bias rounded to y's type;
// per channel the f32 sums of yb and yb^2 over every pixel of the batch;
// mean = S1 / n and the biased variance S2 / n - mean^2, clamped at 0;
// rstd = rsqrt(var + eps), scale = rstd * weight; z = (yb - mean) * scale +
// beta; out = relu(z).  The backward recomputes z from the same saved mean
// and scale with the same expression (bn_value), so its ReLU mask is the
// forward's bit for bit: g = dout where z > 0, else 0; per channel G1 = sum g
// and G2 = sum g (yb - mean) give beta's and weight's gradients (G1, G2 rstd);
// dy = scale ((g - G1 / n) - (yb - mean) rstd^2 G2 / n), the variance term cut
// where the unclamped variance was negative, as clamp_min's gradient is.
//
// What bounds it on the H100: bytes.  A few FLOPs an element against the
// card's 20 f32 FLOPs a byte.  Four passes: the statistics read y; the apply
// pass reads y again and writes out; the gradient statistics read y and dout;
// the dx pass reads both again and writes dy: 16 bytes an element in bf16,
// 2.44 ms over a U-Net64 train step's 511 M conv-output elements at 3.35 TB/s.
// The apply and dx passes find y in L2 where it fits (50 MB).
//
// Design:
//   * a block covers a slice of up to 64 channels (8 lanes of 16 bytes in
//     bf16, 8 lanes of 4 floats in f32; fewer lanes where C needs) over a
//     range of pixels; grid (pixel blocks, slices).  A thread keeps the same
//     16-byte group of channels for every pixel it visits, so its per-channel
//     constants and sums stay in registers, and starts kUnroll 16-byte loads
//     before using any, so each SM keeps tens of kB in flight.  The host
//     (batchnorm_train.py `plan`) picks lanes, slices and pixel blocks from
//     C, the pixel count and the SM count: about two blocks an SM;
//   * the statistics passes sum in registers, then over the lanes of a warp
//     that share channels (shuffles), then over the block's warps in shared
//     memory, in a fixed order, and write one row of partial sums a block.
//     The last block of a slice to finish (a ticket counter, reset by that
//     block for the next launch) sums the slice's rows in block order and
//     writes the result, so two runs give the same bits;
//   * the apply pass finalises the statistics in each block (a slice's few
//     divisions and one rsqrt), so under data parallelism the caller
//     all-reduces the sums [S1, S2, n] between the two launches and nothing
//     else changes; its first pixel block of each slice saves mean, rstd,
//     scale and the clamp flag for the backward and updates the running
//     statistics (flax's momentum update from the biased variance) and
//     num_batches_tracked in place, unless told not to (frozen statistics);
//   * y may be a batch-strided view (a spatial band's own rows cropped out of
//     its halo-extended conv output): pixel p of batch p / hw lies at p * C +
//     (p / hw) * gap; every other tensor is contiguous.
// Products and sums whose rounding the two sides share are written with the
// _rn intrinsics, so that nvcc contracts none of them into an FMA.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxSlice = 64;     // channels of a block
constexpr int kMaxSums = 128;     // a block's partial sums: 2 per channel

// 16 bytes of T as floats, and back.
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[N]) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float value(float x) { return x; }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float x) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(v[2 * i]) | (bits(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float value(__nv_bfloat16 x) { return __bfloat162float(x); }
};

// Where the pixels lie and how the grid splits them.
struct Layout {
  int pixels;      // B * H * W
  int hw;          // H * W
  int C;
  int lanes;       // threads a pixel, 16 bytes each: 1, 2, 4 or 8
  int chunk;       // pixels a block
  long long gap;   // y's batch stride less hw * C, in elements
};

__device__ __forceinline__ long long y_offset(const Layout& L, int p) {
  long long off = static_cast<long long>(p) * L.C;
  if (L.gap != 0) off += static_cast<long long>(p / L.hw) * L.gap;
  return off;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The normalised, affine value whose sign is the ReLU's mask, forward and
// backward alike.
__device__ __forceinline__ float bn_value(float yb, float mean, float scale, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(yb, mean), scale), beta);
}

// The thread's place: its lane (which V channels of the slice) and the first
// pixel it visits; the block's pixel range [start, end).
struct Place {
  int lane, first, end, stride, c0;
};

template <int V>
__device__ __forceinline__ Place place(const Layout& L) {
  Place q;
  q.lane = threadIdx.x & (L.lanes - 1);
  const int start = blockIdx.x * L.chunk;
  q.first = start + threadIdx.x / L.lanes;
  q.end = min(L.pixels, start + L.chunk);
  q.stride = kThreads / L.lanes;
  q.c0 = blockIdx.y * L.lanes * V + q.lane * V;   // the thread's first channel
  return q;
}

// Sums acc over the block's threads that share its lane, in a fixed order,
// and writes the block's row of partial sums ([lane][2V]).  The last block of
// the slice to get here sums the slice's rows in block order into `total`,
// resets the slice's ticket and returns true; every other block returns false.
template <int V>
__device__ bool reduce_slice(float (&acc)[2 * V], int lanes, float* __restrict__ partials,
                             int* __restrict__ tickets, float* total) {
  __shared__ float red[kWarps * kMaxSums];
  __shared__ int last;
  const int nv = 2 * V * lanes;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 2 * V; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (wl < lanes) {
#pragma unroll
    for (int i = 0; i < 2 * V; ++i) red[warp * kMaxSums + wl * 2 * V + i] = acc[i];
  }
  __syncthreads();
  const long long rows = gridDim.x;
  if (threadIdx.x < nv) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kMaxSums + threadIdx.x];
    partials[(blockIdx.y * rows + blockIdx.x) * nv + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const int groups = kThreads / nv;
  const int j = threadIdx.x % nv, g = threadIdx.x / nv;
  const float* base = partials + blockIdx.y * rows * nv;
  float v = 0.f;
#pragma unroll 8
  for (int r = g; r < rows; r += groups) v += __ldcg(base + r * nv + j);
  red[threadIdx.x] = v;   // group g's sum of value j at g * nv + j
  __syncthreads();
  if (threadIdx.x < nv) {
    float t = 0.f;
    for (int k = 0; k < groups; ++k) t += red[k * nv + threadIdx.x];
    total[threadIdx.x] = t;
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;   // ready for the next launch
  __syncthreads();
  return true;
}

// The channel and kind (0: the first sum, 1: the second) of value j of a
// slice's [lane][2V] sums.
template <int V>
__device__ __forceinline__ int sum_channel(int j, int lanes, int& kind) {
  const int i = j % (2 * V);
  kind = i / V;
  return blockIdx.y * lanes * V + (j / (2 * V)) * V + i % V;
}

// sums: [S1 (C), S2 (C), n].
template <typename T>
__global__ void __launch_bounds__(kThreads)
batchnorm_train_stats(const T* __restrict__ y, const T* __restrict__ bias,
                      float* __restrict__ partials, int* __restrict__ tickets,
                      float* __restrict__ sums, Layout L) {
  constexpr int V = Pack<T>::N;
  __shared__ float total[kMaxSums];
  const Place q = place<V>(L);
  float b[V], acc[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) b[i] = Pack<T>::value(bias[q.c0 + i]), acc[i] = acc[V + i] = 0.f;
  for (int p = q.first; p < q.end; p += kUnroll * q.stride) {
    uint4 raw[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * q.stride < q.end) raw[u] = load16(y + y_offset(L, p + u * q.stride) + q.c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * q.stride >= q.end) break;
      float v[V];
      Pack<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float yb = Pack<T>::round(v[i] + b[i]);
        acc[i] += yb;
        acc[V + i] += yb * yb;
      }
    }
  }
  if (!reduce_slice<V>(acc, L.lanes, partials, tickets, total)) return;
  if (threadIdx.x < 2 * V * L.lanes) {
    int kind;
    const int c = sum_channel<V>(threadIdx.x, L.lanes, kind);
    sums[kind * L.C + c] = total[threadIdx.x];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) sums[2 * L.C] = static_cast<float>(L.pixels);
}

// saved: [mean (C), rstd (C), scale (C), keep (C)], keep 0 where the
// unclamped variance was negative.  n = sums[2C] (all ranks' pixels).
template <typename T>
__global__ void __launch_bounds__(kThreads)
batchnorm_train_apply(const T* __restrict__ y, const T* __restrict__ bias,
                      const float* __restrict__ weight, const float* __restrict__ beta,
                      const float* __restrict__ sums, float* __restrict__ saved,
                      float* __restrict__ running_mean, float* __restrict__ running_var,
                      long long* __restrict__ batches, T* __restrict__ out, Layout L,
                      float momentum, float keep_running, float eps, int update) {
  constexpr int V = Pack<T>::N;
  __shared__ float s_mean[kMaxSlice], s_scale[kMaxSlice];
  const int slice_c = L.lanes * V, C = L.C;
  if (threadIdx.x < slice_c) {
    const int c = blockIdx.y * slice_c + threadIdx.x;
    const float n = sums[2 * C];
    const float mean = __fdiv_rn(sums[c], n);
    const float raw = __fsub_rn(__fdiv_rn(sums[C + c], n), __fmul_rn(mean, mean));
    const float var = raw < 0.f ? 0.f : raw;
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    const float scale = __fmul_rn(rstd, weight[c]);
    s_mean[threadIdx.x] = mean;
    s_scale[threadIdx.x] = scale;
    if (blockIdx.x == 0) {
      saved[c] = mean;
      saved[C + c] = rstd;
      saved[2 * C + c] = scale;
      saved[3 * C + c] = raw < 0.f ? 0.f : 1.f;
      if (update) {
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep_running),
                                    __fmul_rn(momentum, mean));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep_running),
                                   __fmul_rn(momentum, var));
      }
    }
  }
  if (update && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *batches += 1;
  __syncthreads();
  const Place q = place<V>(L);
  float b[V], mean[V], scale[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    b[i] = Pack<T>::value(bias[q.c0 + i]);
    mean[i] = s_mean[q.lane * V + i];
    scale[i] = s_scale[q.lane * V + i];
    sh[i] = beta[q.c0 + i];
  }
  for (int p = q.first; p < q.end; p += kUnroll * q.stride) {
    uint4 raw[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * q.stride < q.end) raw[u] = load16(y + y_offset(L, p + u * q.stride) + q.c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * q.stride;
      if (pu >= q.end) break;
      float v[V];
      Pack<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = bn_value(Pack<T>::round(v[i] + b[i]), mean[i], scale[i], sh[i]);
        v[i] = z > 0.f || z != z ? z : 0.f;   // relu, NaN kept as torch keeps it
      }
      *reinterpret_cast<uint4*>(out + static_cast<long long>(pu) * C + q.c0) = Pack<T>::pack(v);
    }
  }
}

// gsums: [G1 (C), G2 (C)] of this launch's pixels; dbias = G1, dweight = G2 rstd.
template <typename T>
__global__ void __launch_bounds__(kThreads)
batchnorm_train_grad_stats(const T* __restrict__ y, const T* __restrict__ bias,
                           const T* __restrict__ dout, const float* __restrict__ beta,
                           const float* __restrict__ saved, float* __restrict__ partials,
                           int* __restrict__ tickets, float* __restrict__ gsums,
                           float* __restrict__ dweight, float* __restrict__ dbias, Layout L) {
  constexpr int V = Pack<T>::N;
  __shared__ float total[kMaxSums];
  const int C = L.C;
  const Place q = place<V>(L);
  float b[V], mean[V], scale[V], sh[V], acc[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    b[i] = Pack<T>::value(bias[q.c0 + i]);
    mean[i] = saved[q.c0 + i];
    scale[i] = saved[2 * C + q.c0 + i];
    sh[i] = beta[q.c0 + i];
    acc[i] = acc[V + i] = 0.f;
  }
  for (int p = q.first; p < q.end; p += kUnroll * q.stride) {
    uint4 ry[kUnroll] = {}, rd[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * q.stride;
      if (pu < q.end) {
        ry[u] = load16(y + y_offset(L, pu) + q.c0);
        rd[u] = load16(dout + static_cast<long long>(pu) * C + q.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * q.stride >= q.end) break;
      float v[V], d[V];
      Pack<T>::unpack(ry[u], v);
      Pack<T>::unpack(rd[u], d);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float yb = Pack<T>::round(v[i] + b[i]);
        const float g = bn_value(yb, mean[i], scale[i], sh[i]) > 0.f ? d[i] : 0.f;
        acc[i] += g;
        acc[V + i] += g * __fsub_rn(yb, mean[i]);
      }
    }
  }
  if (!reduce_slice<V>(acc, L.lanes, partials, tickets, total)) return;
  if (threadIdx.x < 2 * V * L.lanes) {
    int kind;
    const int c = sum_channel<V>(threadIdx.x, L.lanes, kind);
    const float t = total[threadIdx.x];
    gsums[kind * C + c] = t;
    if (kind == 0) dbias[c] = t;
    else dweight[c] = __fmul_rn(t, saved[C + c]);
  }
}

// gsums: all ranks' [G1, G2]; n = sums[2C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
batchnorm_train_dx(const T* __restrict__ y, const T* __restrict__ bias,
                   const T* __restrict__ dout, const float* __restrict__ beta,
                   const float* __restrict__ saved, const float* __restrict__ sums,
                   const float* __restrict__ gsums, T* __restrict__ dx, Layout L) {
  constexpr int V = Pack<T>::N;
  __shared__ float s_a[kMaxSlice], s_k[kMaxSlice];
  const int slice_c = L.lanes * V, C = L.C;
  if (threadIdx.x < slice_c) {
    const int c = blockIdx.y * slice_c + threadIdx.x;
    const float n = sums[2 * C], rstd = saved[C + c];
    s_a[threadIdx.x] = __fdiv_rn(gsums[c], n);
    const float k = __fdiv_rn(__fmul_rn(__fmul_rn(rstd, rstd), gsums[C + c]), n);
    s_k[threadIdx.x] = __fmul_rn(k, saved[3 * C + c]);
  }
  __syncthreads();
  const Place q = place<V>(L);
  float b[V], mean[V], scale[V], sh[V], a[V], k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    b[i] = Pack<T>::value(bias[q.c0 + i]);
    mean[i] = saved[q.c0 + i];
    scale[i] = saved[2 * C + q.c0 + i];
    sh[i] = beta[q.c0 + i];
    a[i] = s_a[q.lane * V + i];
    k[i] = s_k[q.lane * V + i];
  }
  for (int p = q.first; p < q.end; p += kUnroll * q.stride) {
    uint4 ry[kUnroll] = {}, rd[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * q.stride;
      if (pu < q.end) {
        ry[u] = load16(y + y_offset(L, pu) + q.c0);
        rd[u] = load16(dout + static_cast<long long>(pu) * C + q.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * q.stride;
      if (pu >= q.end) break;
      float v[V], d[V];
      Pack<T>::unpack(ry[u], v);
      Pack<T>::unpack(rd[u], d);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float yb = Pack<T>::round(v[i] + b[i]);
        const float g = bn_value(yb, mean[i], scale[i], sh[i]) > 0.f ? d[i] : 0.f;
        const float centred = __fmul_rn(__fsub_rn(yb, mean[i]), k[i]);
        v[i] = __fmul_rn(scale[i], __fsub_rn(__fsub_rn(g, a[i]), centred));
      }
      *reinterpret_cast<uint4*>(dx + static_cast<long long>(pu) * C + q.c0) = Pack<T>::pack(v);
    }
  }
}

// The grid of a plan: (pixel blocks, slices), after checking that the plan
// covers the layout.  Returns false for a plan the kernels cannot run.
template <typename T>
bool grid_of(const Layout& L, int blocks, dim3& grid) {
  constexpr int V = Pack<T>::N;
  const int lanes = L.lanes;
  if (!(lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8)) return false;
  if (L.C < 1 || L.C % (lanes * V) != 0 || L.hw < 1 || L.pixels < 1 || L.pixels > (1 << 30))
    return false;
  if (L.pixels % L.hw != 0 || L.gap < 0 || L.gap % V != 0 || L.chunk < 1 || blocks < 1 ||
      static_cast<long long>(blocks) * L.chunk < L.pixels || blocks > (1 << 20))
    return false;
  const int slices = L.C / (lanes * V);
  if (slices > 65535) return false;
  grid = dim3(blocks, slices, 1);
  return true;
}

Layout layout(int pixels, int hw, int C, long long gap, int lanes, int chunk) {
  return Layout{pixels, hw, C, lanes, chunk, gap};
}

template <typename T>
cudaError_t stats(const void* y, const void* bias, void* partials, void* tickets, void* sums,
                  const Layout& L, int blocks, cudaStream_t s) {
  dim3 grid;
  if (!grid_of<T>(L, blocks, grid)) return cudaErrorInvalidValue;
  batchnorm_train_stats<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<float*>(partials),
      static_cast<int*>(tickets), static_cast<float*>(sums), L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* y, const void* bias, const void* weight, const void* beta,
                  const void* sums, void* saved, void* running_mean, void* running_var,
                  void* batches, void* out, const Layout& L, int blocks, float momentum,
                  float keep_running, float eps, int update, cudaStream_t s) {
  dim3 grid;
  if (!grid_of<T>(L, blocks, grid)) return cudaErrorInvalidValue;
  batchnorm_train_apply<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<const float*>(weight),
      static_cast<const float*>(beta), static_cast<const float*>(sums),
      static_cast<float*>(saved), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<long long*>(batches), static_cast<T*>(out),
      L, momentum, keep_running, eps, update);
  return cudaGetLastError();
}

template <typename T>
cudaError_t grad_stats(const void* y, const void* bias, const void* dout, const void* beta,
                       const void* saved, void* partials, void* tickets, void* gsums,
                       void* dweight, void* dbias, const Layout& L, int blocks,
                       cudaStream_t s) {
  dim3 grid;
  if (!grid_of<T>(L, blocks, grid)) return cudaErrorInvalidValue;
  batchnorm_train_grad_stats<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(beta), static_cast<const float*>(saved),
      static_cast<float*>(partials), static_cast<int*>(tickets), static_cast<float*>(gsums),
      static_cast<float*>(dweight), static_cast<float*>(dbias), L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dx(const void* y, const void* bias, const void* dout, const void* beta,
               const void* saved, const void* sums, const void* gsums, void* out,
               const Layout& L, int blocks, cudaStream_t s) {
  dim3 grid;
  if (!grid_of<T>(L, blocks, grid)) return cudaErrorInvalidValue;
  batchnorm_train_dx<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(beta), static_cast<const float*>(saved),
      static_cast<const float*>(sums), static_cast<const float*>(gsums), static_cast<T*>(out), L);
  return cudaGetLastError();
}

}  // namespace

// Every entry point: y (B, H, W, C) of dtype 0 = f32, 1 = bf16, batch-strided
// (its batch stride hw * C + gap elements), 16-byte aligned; bias (C) of y's
// dtype; the f32 per-channel tensors contiguous; pixels = B * H * W; the
// plan (lanes, chunk, blocks) from batchnorm_train.py `plan`; partials
// (blocks * 2C f32); tickets (C / (lanes * V) int32, zero, left zero).  One
// launch each; returns its cudaError_t.
extern "C" int maunet_bn_train_stats(const void* y, const void* bias, void* partials,
                                     void* tickets, void* sums, int pixels, int hw, int C,
                                     long long gap, int lanes, int chunk, int blocks, int dtype,
                                     void* stream) {
  const Layout L = layout(pixels, hw, C, gap, lanes, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(stats<float>(y, bias, partials, tickets, sums, L, blocks, s));
    case 1: return static_cast<int>(
        stats<__nv_bfloat16>(y, bias, partials, tickets, sums, L, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out: (B, H, W, C) contiguous, y's dtype; saved: 4C f32; batches: int64.
extern "C" int maunet_bn_train_apply(const void* y, const void* bias, const void* weight,
                                     const void* beta, const void* sums, void* saved,
                                     void* running_mean, void* running_var, void* batches,
                                     void* out, int pixels, int hw, int C, long long gap,
                                     int lanes, int chunk, int blocks, float momentum,
                                     float keep_running, float eps, int update, int dtype,
                                     void* stream) {
  const Layout L = layout(pixels, hw, C, gap, lanes, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(apply<float>(y, bias, weight, beta, sums, saved,
                                                 running_mean, running_var, batches, out, L,
                                                 blocks, momentum, keep_running, eps, update, s));
    case 1: return static_cast<int>(apply<__nv_bfloat16>(
        y, bias, weight, beta, sums, saved, running_mean, running_var, batches, out, L, blocks,
        momentum, keep_running, eps, update, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dout: (B, H, W, C) contiguous, y's dtype; gsums: 2C f32; dweight, dbias: C f32.
extern "C" int maunet_bn_train_grad_stats(const void* y, const void* bias, const void* dout,
                                          const void* beta, const void* saved, void* partials,
                                          void* tickets, void* gsums, void* dweight, void* dbias,
                                          int pixels, int hw, int C, long long gap, int lanes,
                                          int chunk, int blocks, int dtype, void* stream) {
  const Layout L = layout(pixels, hw, C, gap, lanes, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(grad_stats<float>(y, bias, dout, beta, saved, partials,
                                                      tickets, gsums, dweight, dbias, L, blocks,
                                                      s));
    case 1: return static_cast<int>(grad_stats<__nv_bfloat16>(
        y, bias, dout, beta, saved, partials, tickets, gsums, dweight, dbias, L, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dx: (B, H, W, C) contiguous, y's dtype.
extern "C" int maunet_bn_train_dx(const void* y, const void* bias, const void* dout,
                                  const void* beta, const void* saved, const void* sums,
                                  const void* gsums, void* dx_out, int pixels, int hw, int C,
                                  long long gap, int lanes, int chunk, int blocks, int dtype,
                                  void* stream) {
  const Layout L = layout(pixels, hw, C, gap, lanes, chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(
        dx<float>(y, bias, dout, beta, saved, sums, gsums, dx_out, L, blocks, s));
    case 1: return static_cast<int>(
        dx<__nv_bfloat16>(y, bias, dout, beta, saved, sums, gsums, dx_out, L, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
