// Full-sequence LSTM over pre-projected inputs: the inference forward, the
// training forward that stashes every step's state, the backward through
// time, and the recurrent-weight gradient.
//
// Replaces the TPU kernels of maunet_tpu/ops/pallas/lstm.py:
//   * _pallas_forward (body `_make_kernel`) -> lstm_last_hidden_kernel<false>;
//   * _pallas_forward_stash (body `_make_stash_kernel`) ->
//     lstm_last_hidden_kernel<true>;
//   * _pallas_backward (body `_make_bwd_kernel`) -> lstm_backward_kernel, plus
//     lstm_dw_partial_kernel and lstm_dw_reduce_kernel for its dW sum.
// x_proj (B, T, 4H) f32 already holds x.W_ih + b_ih + b_hh; W_hh is (H, 4H)
// f32; lengths (B,) i32.  Gate order (i, f, g, o); each sample's (h, c)
// freezes at t >= length.
//
// What bounds the forward and the backward on the H100: latency of the
// T-step recurrence.  One step is a (1, H) x (H, 4H) product per row,
// 73,728 FLOPs at H = 96, far too little to fill an SM, and the 828 steps
// are strictly sequential (the backward does two such products per step).
// The TPU walked the time axis as a sequential grid with (h, c) in scratch;
// here one block per batch row loops over all T steps itself, so nothing
// leaves the SM between steps:
//   * W_hh stays in dynamic shared memory for the whole sequence (above the
//     48 KB static limit, opted in with cudaFuncSetAttribute);
//   * forward: thread j owns gate column j: it reads h from shared memory (a
//     broadcast) and W_hh[:, j] (consecutive threads, consecutive words: no
//     bank conflicts), and adds x_proj[b, t, j], loaded one step ahead so the
//     device-memory latency hides behind the previous step's product; the
//     first H threads then own one unit of the state each, keep c in a
//     register and write h back to shared memory;
//   * the stash variant also writes h and c of every step, and the frozen
//     state for t >= length, so the backward never reads unwritten memory;
//   * backward: thread j recomputes gate column j from the stashed h_{t-1};
//     unit j < H forms the gate adjoints; then dh = dgates . W_hh^T reads
//     W_hh along its rows, with thread (q, k) summing gate block q of row k.
//     With a row stride of 4H = 384 words every thread of a warp would hit
//     one bank, so W_hh is stored with a padded stride of 4H + 1 (147,840 B
//     at H = 96): row k then starts in bank k mod 32 and both products are
//     conflict-free.  Steps t >= length write zero adjoints and pass (dh, dc)
//     through unchanged, so the loop starts at length - 1.
//
// dW: the TPU kernel accumulates dW += h_{t-1}^T . dgates in its body, which
// works because its grid runs in order on one core.  Blocks on the card run
// in no order and cannot share a sum, so dW is a second launch: a tiled
// (H x B*T) . (B*T x 4H) product, split over the B*T rows into a fixed number
// of slices (enough blocks for the 132 SMs), each slice writing its own
// partial tile, and a reduce that adds the slices in order.  No atomics: a
// repeated run gives the same bits.  At B = 16, T = 828, H = 96 it is 0.98
// GFLOP and takes 0.15-0.21 ms, about 5 TFLOP/s: a plain smem-tiled product,
// far from the FP32 pipes' peak, and 2-4% of the backward's time.  All sums
// are in full f32, as the TPU kernels and the plain versions compute them.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <bool STASH>
__global__ void lstm_last_hidden_kernel(const float* __restrict__ xp,
                                        const float* __restrict__ whh,
                                        const int* __restrict__ lengths,
                                        float* __restrict__ out,
                                        float* __restrict__ h_all,
                                        float* __restrict__ c_all, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* w_s = smem;         // (H, 4H)
  float* h_s = w_s + H * G;  // (H,)
  float* g_s = h_s + H;      // (4H,)
  const int j = threadIdx.x;  // gate column; blockDim.x == 4H
  const int b = blockIdx.x;
  const float* x_row = xp + static_cast<long long>(b) * T * G;
  float* h_row = STASH ? h_all + static_cast<long long>(b) * T * H : nullptr;
  float* c_row = STASH ? c_all + static_cast<long long>(b) * T * H : nullptr;

  for (int i = j; i < H * G; i += G) w_s[i] = whh[i];
  if (j < H) h_s[j] = 0.f;
  const int len = max(0, min(lengths[b], T));
  float c = 0.f;  // state of unit j, for j < H
  float x_next = len > 0 ? x_row[j] : 0.f;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    float acc = x_next;
    if (t + 1 < len) x_next = x_row[(t + 1) * G + j];
#pragma unroll 8
    for (int k = 0; k < H; ++k) acc = fmaf(h_s[k], w_s[k * G + j], acc);
    g_s[j] = acc;
    __syncthreads();
    if (j < H) {
      const float ig = sigmoid(g_s[j]);
      const float fg = sigmoid(g_s[H + j]);
      const float gg = tanhf(g_s[2 * H + j]);
      const float og = sigmoid(g_s[3 * H + j]);
      c = fg * c + ig * gg;
      const float h = og * tanhf(c);
      h_s[j] = h;
      if (STASH) {
        h_row[t * H + j] = h;
        c_row[t * H + j] = c;
      }
    }
    __syncthreads();
  }
  if (j < H) {
    const float h = h_s[j];
    out[b * H + j] = h;
    if (STASH) {
      for (int t = len; t < T; ++t) {  // the frozen state, as the TPU kernel writes it
        h_row[t * H + j] = h;
        c_row[t * H + j] = c;
      }
    }
  }
}

__global__ void lstm_backward_kernel(const float* __restrict__ xp,
                                     const float* __restrict__ whh,
                                     const int* __restrict__ lengths,
                                     const float* __restrict__ h_all,
                                     const float* __restrict__ c_all,
                                     const float* __restrict__ g,
                                     float* __restrict__ dxp, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int WS = G + 1;             // padded row stride of W_hh
  float* w_s = smem;                // (H, 4H + 1)
  float* hp_s = w_s + H * WS;       // (H,)  h_{t-1}
  float* gate_s = hp_s + H;         // (4H,) gate pre-activations at t
  float* dg_s = gate_s + G;         // (4H,) gate adjoints at t
  float* part_s = dg_s + G;         // (4H,) partial sums of dgates . W_hh^T
  const int j = threadIdx.x;        // blockDim.x == 4H
  const int b = blockIdx.x;
  const long long row = static_cast<long long>(b) * T;
  const float* x_row = xp + row * G;
  float* dx_row = dxp + row * G;
  const float* h_row = h_all + row * H;
  const float* c_row = c_all + row * H;
  const int q = j / H;              // gate block this thread sums for dh
  const int k = j - q * H;          // unit of dh this thread sums for

  for (int i = j; i < H * G; i += G) {
    const int r = i / G;
    w_s[r * WS + (i - r * G)] = whh[i];
  }
  const int len = max(0, min(lengths[b], T));
  for (int t = len; t < T; ++t) dx_row[static_cast<long long>(t) * G + j] = 0.f;
  float dh = 0.f, dc = 0.f;  // adjoints of unit j, for j < H
  if (j < H) {
    dh = g[b * H + j];
    hp_s[j] = len > 1 ? h_row[(len - 2) * H + j] : 0.f;
  }
  float x_next = len > 0 ? x_row[static_cast<long long>(len - 1) * G + j] : 0.f;
  __syncthreads();

  for (int t = len - 1; t >= 0; --t) {
    // Gate pre-activations at t from the stashed h_{t-1}.
    float acc = x_next;
    if (t > 0) x_next = x_row[static_cast<long long>(t - 1) * G + j];
#pragma unroll 8
    for (int r = 0; r < H; ++r) acc = fmaf(hp_s[r], w_s[r * WS + j], acc);
    gate_s[j] = acc;
    __syncthreads();
    if (j < H) {
      const float ig = sigmoid(gate_s[j]);
      const float fg = sigmoid(gate_s[H + j]);
      const float gg = tanhf(gate_s[2 * H + j]);
      const float og = sigmoid(gate_s[3 * H + j]);
      const float ct = c_row[t * H + j];
      const float cp = t > 0 ? c_row[(t - 1) * H + j] : 0.f;
      const float tc = tanhf(ct);
      const float d_o = dh * tc * og * (1.f - og);
      const float dct = dc + dh * og * (1.f - tc * tc);
      const float d_i = dct * gg * ig * (1.f - ig);
      const float d_f = dct * cp * fg * (1.f - fg);
      const float d_g = dct * ig * (1.f - gg * gg);
      dg_s[j] = d_i;
      dg_s[H + j] = d_f;
      dg_s[2 * H + j] = d_g;
      dg_s[3 * H + j] = d_o;
      float* dx_t = dx_row + static_cast<long long>(t) * G;
      dx_t[j] = d_i;
      dx_t[H + j] = d_f;
      dx_t[2 * H + j] = d_g;
      dx_t[3 * H + j] = d_o;
      dc = dct * fg;
      hp_s[j] = t > 1 ? h_row[(t - 2) * H + j] : 0.f;  // h_{t-2} for the next step
    }
    __syncthreads();
    // dh_{t-1}[k] = sum_j dgates[j] W_hh[k, j], gate block q by thread (q, k).
    const float* wk = w_s + k * WS + q * H;
    const float* dq = dg_s + q * H;
    float p = 0.f;
#pragma unroll 8
    for (int r = 0; r < H; ++r) p = fmaf(dq[r], wk[r], p);
    part_s[j] = p;
    __syncthreads();
    if (j < H) dh = part_s[j] + part_s[H + j] + part_s[2 * H + j] + part_s[3 * H + j];
  }
}

constexpr int DW_TILE = 32;  // output tile (units x gate columns) and row chunk
constexpr int DW_ROWS = 8;   // blockDim.y; each thread owns DW_TILE / DW_ROWS outputs

// partial[s, k, j] = sum over rows n of slice s of h_prev[n, k] * dx[n, j],
// n = b * T + t, with h_prev[n] = h_all[b, t - 1] for 1 <= t < length[b] and
// 0 elsewhere (dx is 0 for t >= length, and h_{-1} = 0).
__global__ void lstm_dw_partial_kernel(const float* __restrict__ h_all,
                                       const float* __restrict__ dxp,
                                       const int* __restrict__ lengths,
                                       float* __restrict__ partial, int B,
                                       int T, int H, int rows_per_slice) {
  __shared__ float a_s[DW_TILE][DW_TILE];  // [row][unit]
  __shared__ float b_s[DW_TILE][DW_TILE];  // [row][gate column]
  const int G = 4 * H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.y * DW_TILE, j0 = blockIdx.x * DW_TILE;
  const long long n_total = static_cast<long long>(B) * T;
  const long long n_begin = static_cast<long long>(blockIdx.z) * rows_per_slice;
  const long long n_end = min(n_begin + rows_per_slice, n_total);
  constexpr int PER = DW_TILE / DW_ROWS;
  float acc[PER] = {};

  for (long long n0 = n_begin; n0 < n_end; n0 += DW_TILE) {
#pragma unroll
    for (int rr = 0; rr < PER; ++rr) {
      const int r = ty + rr * DW_ROWS;
      const long long n = n0 + r;
      float a = 0.f, v = 0.f;
      if (n < n_end) {
        const int bi = static_cast<int>(n / T);
        const int t = static_cast<int>(n - static_cast<long long>(bi) * T);
        if (k0 + tx < H && t >= 1 && t < lengths[bi]) a = h_all[(n - 1) * H + k0 + tx];
        if (j0 + tx < G) v = dxp[n * G + j0 + tx];
      }
      a_s[r][tx] = a;
      b_s[r][tx] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < DW_TILE; ++r) {
      const float v = b_s[r][tx];
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(a_s[r][ty * PER + i], v, acc[i]);
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.z) * H * G;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int kk = k0 + ty * PER + i, jj = j0 + tx;
    if (kk < H && jj < G) out[kk * G + jj] = acc[i];
  }
}

__global__ void lstm_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int n, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += partial[static_cast<long long>(z) * n + i];
  dw[i] = s;
}

size_t forward_smem(int H) {
  return sizeof(float) * (static_cast<size_t>(H) * 4 * H + 5 * H);
}

}  // namespace

// Each entry point returns the launch's cudaError_t.  4H threads per block,
// so H <= 256; the shared-memory opt-in limit (227 KB) caps H at 119 for the
// forward and at 118 for the backward.

extern "C" int maunet_lstm_last_hidden(const void* x_proj, const void* w_hh,
                                       const void* lengths, void* out, int B,
                                       int T, int H, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = forward_smem(H);
  cudaError_t err = cudaFuncSetAttribute(lstm_last_hidden_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_last_hidden_kernel<false><<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<float*>(out), nullptr, nullptr,
      T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int maunet_lstm_forward_stash(const void* x_proj, const void* w_hh,
                                         const void* lengths, void* out,
                                         void* h_all, void* c_all, int B, int T,
                                         int H, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = forward_smem(H);
  cudaError_t err = cudaFuncSetAttribute(lstm_last_hidden_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_last_hidden_kernel<true><<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(h_all), static_cast<float*>(c_all), T, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int maunet_lstm_backward(const void* x_proj, const void* w_hh,
                                    const void* lengths, const void* h_all,
                                    const void* c_all, const void* g, void* dx_proj,
                                    int B, int T, int H, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (static_cast<size_t>(H) * (4 * H + 1) + 13 * H);
  cudaError_t err = cudaFuncSetAttribute(lstm_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_backward_kernel<<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<const float*>(h_all),
      static_cast<const float*>(c_all), static_cast<const float*>(g),
      static_cast<float*>(dx_proj), T, H);
  return static_cast<int>(cudaGetLastError());
}

// dW (H, 4H) from the stashed h and the backward's dx_proj.  ``partial`` is
// scratch of (slices, H, 4H) floats; each slice covers rows_per_slice of the
// B*T rows (a multiple of 32).
extern "C" int maunet_lstm_dw(const void* h_all, const void* dx_proj,
                              const void* lengths, void* partial, void* dw, int B,
                              int T, int H, int slices, int rows_per_slice,
                              void* stream) {
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((G + DW_TILE - 1) / DW_TILE, (H + DW_TILE - 1) / DW_TILE, slices);
  lstm_dw_partial_kernel<<<grid, dim3(DW_TILE, DW_ROWS), 0, s>>>(
      static_cast<const float*>(h_all), static_cast<const float*>(dx_proj),
      static_cast<const int*>(lengths), static_cast<float*>(partial), B, T, H,
      rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * G;
  lstm_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, slices);
  return static_cast<int>(cudaGetLastError());
}
