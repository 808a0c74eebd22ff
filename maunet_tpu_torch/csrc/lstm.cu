// Full-sequence LSTM over pre-projected inputs: the inference forward, the
// training forward that stashes every step's state, the backward through
// time, and the recurrent-weight gradient.
//
// Replaces the TPU kernels of maunet_tpu/ops/pallas/lstm.py:
//   * _pallas_forward (body `_make_kernel`) -> lstm_last_hidden_kernel<false, KS>;
//   * _pallas_forward_stash (body `_make_stash_kernel`) ->
//     lstm_last_hidden_kernel<true, KS>;
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
// leaves the SM between steps.  A step's time is then the SM's issue of its
// 36,864 FMAs (288 cycles on the SM's 128 f32 lanes at H = 96) plus the
// latency of the chain that follows them: the sum across threads, the
// activations, the cell and the hand-over of h to the next step.
//
// The forward (B and E), redesigned for the H100:
//   * W_hh lives in registers for the whole sequence.  The four lanes
//     4u .. 4u + 3 of a warp own unit u; lane s holds W_hh[k, g*H + u] for
//     the k of slice s (KS consecutive k, zero past H) and all four gates g:
//     4 * KS floats, 96 at H = 96.  Per step a lane runs four independent
//     KS-deep FMA chains, one per gate, on h read from shared memory as
//     float4 (lanes of one slice read the same address: a broadcast; the
//     four slices start KS or KS + 4 words apart, so they fall on distinct
//     banks), where W_hh in shared memory would cost two shared loads per FMA;
//   * the four lanes' partial sums are reduce-scattered in three shuffles,
//     so lane s ends with the whole pre-activation of gate s, adds its
//     x_proj element and applies its gate's activation (tanh as
//     2 sigmoid(2x) - 1, so the four lanes take one branch-free path with
//     the exact expf); four more shuffles give every lane of the unit all
//     four gates, and each lane computes the same c and h.  No thread idles
//     while others do the cell, and no gate values go through shared memory;
//   * h is double-buffered in shared memory, h_s[2][...]: step t reads
//     buffer t & 1 and writes the other, so one __syncthreads per step
//     orders both the reads and the writes;
//   * x_proj is read kAhead = 8 steps ahead into a ring of registers (one
//     element per lane and step: lane s of unit u reads gate s's column u),
//     far longer than a device-memory round trip at the new step time;
//   * units are padded to a multiple of 8 so every warp is whole; padding
//     lanes hold zero weights and write nothing.  KS = 4 * ceil(H / 16) is a
//     template argument (H <= 96, KS <= 24), which keeps every register
//     index static;
//   * the stash variant also writes h and c of every step (lanes 0 and 1 of
//     the unit), and the frozen state for t >= length, so the backward never
//     reads unwritten memory.
// The backward (F, not redesigned): thread j recomputes gate column j from
// the stashed h_{t-1}; unit j < H forms the gate adjoints; then
// dh = dgates . W_hh^T reads W_hh along its rows, with thread (q, k) summing
// gate block q of row k.  With a row stride of 4H = 384 words every thread
// of a warp would hit one bank, so W_hh is stored with a padded stride of
// 4H + 1 (147,840 B at H = 96): row k then starts in bank k mod 32 and both
// products are conflict-free.  Steps t >= length write zero adjoints and
// pass (dh, dc) through unchanged, so the loop starts at length - 1.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdMaxHidden = 96;
constexpr int kFwdMaxThreads = 4 * kFwdMaxHidden;
constexpr int kAhead = 8;  // steps of x_proj in flight ahead of the step that adds them

// The shared-memory word where slice `s` of h starts: KS words apart, or
// KS + 4 where KS is a multiple of 16 (which would put all four on one bank).
template <int KS>
__host__ __device__ constexpr int slice_stride() { return KS % 16 == 0 ? KS + 4 : KS; }

template <bool STASH, int KS>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
lstm_last_hidden_kernel(const float* __restrict__ xp, const float* __restrict__ whh,
                        const int* __restrict__ lengths, float* __restrict__ out,
                        float* __restrict__ h_all, float* __restrict__ c_all, int T, int H) {
  constexpr int SS = slice_stride<KS>();
  __shared__ __align__(16) float h_s[2][4 * SS];
  const int G = 4 * H;
  const int u = threadIdx.x >> 2;   // unit
  const int s = threadIdx.x & 3;    // k slice; after the reduction, gate
  const int base = threadIdx.x & 28;  // lane of slice 0 of this unit
  const bool real = u < H;
  const int b = blockIdx.x;
  const int slot = u / KS * SS + u % KS;  // where unit u's h lives in h_s

  float w[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int k = s * KS + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) w[j][g] = real && k < H ? whh[k * G + g * H + u] : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * 4 * SS; i += blockDim.x) (&h_s[0][0])[i] = 0.f;
  const int len = max(0, min(lengths[b], T));
  // Lane s of unit u adds x_proj[b, t, s*H + u]: gate s's column u.
  const float* x_col = xp + static_cast<long long>(b) * T * G + s * H + u;
  float xr[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) xr[i] = real && i < len ? x_col[static_cast<long long>(i) * G] : 0.f;
  float* h_row = STASH ? h_all + static_cast<long long>(b) * T * H + u : nullptr;
  float* c_row = STASH ? c_all + static_cast<long long>(b) * T * H + u : nullptr;
  float c = 0.f, h = 0.f;
  const bool hi2 = s & 2, hi1 = s & 1, is_g = s == 2;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t >= len) break;
      const float* hs = h_s[t & 1] + s * SS;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KS; j += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + j);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g] = fmaf(hv.x, w[j][g], acc[g]);
          acc[g] = fmaf(hv.y, w[j + 1][g], acc[g]);
          acc[g] = fmaf(hv.z, w[j + 2][g], acc[g]);
          acc[g] = fmaf(hv.w, w[j + 3][g], acc[g]);
        }
      }
      // Reduce-scatter over the unit's four lanes: across lane pairs s, s^2
      // keep gates (s & 2) and (s & 2) + 1, then across s, s^1 keep gate s.
      float keep0 = hi2 ? acc[2] : acc[0], keep1 = hi2 ? acc[3] : acc[1];
      keep0 += __shfl_xor_sync(kFull, hi2 ? acc[0] : acc[2], 2);
      keep1 += __shfl_xor_sync(kFull, hi2 ? acc[1] : acc[3], 2);
      float pre = (hi1 ? keep1 : keep0) + __shfl_xor_sync(kFull, hi1 ? keep0 : keep1, 1);
      pre += xr[i];
      if (real && t + kAhead < len) xr[i] = x_col[static_cast<long long>(t + kAhead) * G];
      const float sg = sigmoid(is_g ? 2.f * pre : pre);
      const float act = is_g ? 2.f * sg - 1.f : sg;
      const float ig = __shfl_sync(kFull, act, base);
      const float fg = __shfl_sync(kFull, act, base + 1);
      const float gg = __shfl_sync(kFull, act, base + 2);
      const float og = __shfl_sync(kFull, act, base + 3);
      c = fg * c + ig * gg;
      h = og * tanhf(c);
      if (real && s == 0) h_s[(t + 1) & 1][slot] = h;
      if (STASH && real) {
        if (s == 0) h_row[static_cast<long long>(t) * H] = h;
        if (s == 1) c_row[static_cast<long long>(t) * H] = c;
      }
      __syncthreads();
    }
  }
  if (!real) return;
  if (s == 0) out[b * H + u] = h;
  if (STASH) {  // the frozen state, as the TPU kernel writes it
    for (int t = len; t < T; ++t) {
      if (s == 0) h_row[static_cast<long long>(t) * H] = h;
      if (s == 1) c_row[static_cast<long long>(t) * H] = c;
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

template <bool STASH, int KS>
cudaError_t launch_forward_ks(const float* xp, const float* whh, const int* lengths,
                              float* out, float* h_all, float* c_all, int B, int T, int H,
                              cudaStream_t stream) {
  const int threads = 4 * ((H + 7) / 8 * 8);
  lstm_last_hidden_kernel<STASH, KS><<<B, threads, 0, stream>>>(xp, whh, lengths, out,
                                                               h_all, c_all, T, H);
  return cudaGetLastError();
}

template <bool STASH>
cudaError_t launch_forward(const void* x_proj, const void* w_hh, const void* lengths,
                           void* out, void* h_all, void* c_all, int B, int T, int H,
                           void* stream) {
  if (B == 0) return cudaSuccess;
  if (H < 1 || H > kFwdMaxHidden) return cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x_proj);
  const auto whh = static_cast<const float*>(w_hh);
  const auto lens = static_cast<const int*>(lengths);
  const auto o = static_cast<float*>(out);
  const auto ha = static_cast<float*>(h_all);
  const auto ca = static_cast<float*>(c_all);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((H + 15) / 16) {  // KS = 4 * ceil(H / 16)
    case 1: return launch_forward_ks<STASH, 4>(xp, whh, lens, o, ha, ca, B, T, H, st);
    case 2: return launch_forward_ks<STASH, 8>(xp, whh, lens, o, ha, ca, B, T, H, st);
    case 3: return launch_forward_ks<STASH, 12>(xp, whh, lens, o, ha, ca, B, T, H, st);
    case 4: return launch_forward_ks<STASH, 16>(xp, whh, lens, o, ha, ca, B, T, H, st);
    case 5: return launch_forward_ks<STASH, 20>(xp, whh, lens, o, ha, ca, B, T, H, st);
    default: return launch_forward_ks<STASH, 24>(xp, whh, lens, o, ha, ca, B, T, H, st);
  }
}

}  // namespace

// Each entry point returns the launch's cudaError_t.  The forward takes
// 1 <= H <= 96 (W_hh in registers: 4 * ceil(H / 16) * 4 floats a lane); the
// backward has 4H threads per block and holds W_hh in shared memory, which the
// 227 KB opt-in caps at H = 118.

extern "C" int maunet_lstm_last_hidden(const void* x_proj, const void* w_hh,
                                       const void* lengths, void* out, int B,
                                       int T, int H, void* stream) {
  return static_cast<int>(launch_forward<false>(x_proj, w_hh, lengths, out, nullptr,
                                                nullptr, B, T, H, stream));
}

extern "C" int maunet_lstm_forward_stash(const void* x_proj, const void* w_hh,
                                         const void* lengths, void* out,
                                         void* h_all, void* c_all, int B, int T,
                                         int H, void* stream) {
  return static_cast<int>(launch_forward<true>(x_proj, w_hh, lengths, out, h_all, c_all,
                                               B, T, H, stream));
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
