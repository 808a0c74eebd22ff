// Full-sequence LSTM over pre-projected inputs: the inference forward, the
// training forward that stashes every step's state, the backward through
// time, and the recurrent-weight gradient.
//
// Replaces the TPU kernels of maunet_tpu/ops/pallas/lstm.py:
//   * _pallas_forward (body `_make_kernel`) -> lstm_last_hidden_kernel<false, KS>;
//   * _pallas_forward_stash (body `_make_stash_kernel`) ->
//     lstm_last_hidden_kernel<true, KS>;
//   * _pallas_backward (body `_make_bwd_kernel`) -> lstm_gate_terms_kernel (the
//     gate recompute, lstm.py:247-248, for every step at once), then
//     lstm_backward_kernel<KS> (the reverse recurrence), plus
//     lstm_dw_partial_kernel<VEC_H> and lstm_dw_reduce_kernel for its dW sum.
// x_proj (B, T, 4H) f32 already holds x.W_ih + b_ih + b_hh; W_hh is (H, 4H)
// f32; lengths (B,) i32.  Gate order (i, f, g, o); each sample's (h, c)
// freezes at t >= length.
//
// What bounds the forward and the backward on the H100: latency of the
// T-step recurrence.  One step is a (1, H) x (H, 4H) product per row,
// 73,728 FLOPs at H = 96, far too little to fill an SM, and the 828 steps
// are strictly sequential (so is the backward's dh = dgates . W_hh^T).
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
// The backward (F), two launches:
//   * lstm_gate_terms_kernel.  The gate recompute needs only x_proj and the
//     stashed h_{t-1}, nothing the backward carries, so it leaves the serial
//     chain: pre = x_proj + h_{t-1} . W_hh for every (b, t < length) at once,
//     a (B*T x H) . (H x 4H) product (0.98 GFLOP at B = 16, T = 828), tiled
//     64 steps x 32 units (x 4 gates) per block over k chunks of 32 in shared
//     memory, hundreds of blocks for the 132 SMs.  Its epilogue writes the
//     step's coefficients, terms (B, T, 6H) = [g_i, g_f, g_g, g_o, a, f] with
//     tc = tanh(c_t): g_i = g i(1-i), g_f = c_{t-1} f(1-f), g_g = i(1-g^2),
//     g_o = tc o(1-o), a = o(1-tc^2), so that the recurrence is
//     dct = dc + dh a, d_o = dh g_o, d_{i,f,g} = dct g_{i,f,g}, dc = dct f.
//     Rows t >= length are neither read nor written.  Bound: about 0.015 ms
//     by operations, about 0.02 ms by the bytes it moves.
//   * lstm_backward_kernel<KS>, the recurrence on B's layout.  What bounds it
//     is the serial chain: 828 steps, each dh = dgates . W_hh^T, 36,864 FMAs
//     at H = 96 issued by one SM (288 cycles on its 128 f32 lanes: 828 x 288
//     cycles = 0.136 ms at 1.755 GHz), plus the chain's latency (the
//     shuffles, a multiply-add, the hand-over of dgates, the barrier).  The
//     old kernel also ran the gate recompute (a second 96-deep product), the
//     cell's transcendentals and three barriers on that chain.  Now B's
//     register layout, transposed: B's lane holds W_hh for four outputs (the
//     gates of its unit) over a slice of KS inputs (h); here lane l of a group
//     of 16 holds W_hh[4q + m, l*KS + v] for four outputs (units 4q..4q+3 of
//     dh) over slice l of the 4H inputs (dgates), KS = 4 * ceil(H / 16), 96
//     floats at H = 96, zero past H or 4H, for the whole sequence.  Each float
//     of dgates read from shared memory then feeds four FMAs, as each h does
//     in B.  With one unit per lane (a lane summing its unit's gate block)
//     each float fed one FMA, four times B's loads per FMA, and the
//     recurrence took 0.72 ms at the training batch, twice B's time (NVIDIA
//     H100 80GB HBM3, 700 W).  dgates of the step sit
//     in shared memory, double-buffered, in 16 slices at a stride that puts
//     eight lanes' float4 reads on distinct banks (dgate_slice_stride).  A
//     reduce-scatter over bits 3 and 2 of the lane (three shuffles) and a sum
//     over bits 1 and 0 (two) leave dh of unit 4q + m on lanes 4m..4m+3,
//     which are B's four lanes of that unit (u = tid / 4, s = tid % 4).  Each
//     then computes dct = dc + dh a as B's lanes compute c, forms the adjoint
//     of gate s and writes it to dx_proj and to the other buffer: one
//     __syncthreads a step.  The terms come from a register ring read kAhead
//     steps ahead.  Steps t >= length write zero adjoints and pass (dh, dc)
//     through unchanged, so the loop starts at length - 1.
//
// dW: the TPU kernel accumulates dW += h_{t-1}^T . dgates in its body, which
// works because its grid runs in order on one core.  Blocks on the card run
// in no order and cannot share a sum, so dW is a launch of its own: the
// (H x B*T) . (B*T x 4H) product, 0.98 GFLOP at B = 16, T = 828, H = 96, in
// full f32 (the plain versions and the TPU kernel are f32, so no TF32).
// What bounds it on the H100 is FMA issue: 0.0084 ms at the f32 peak for the
// rows the training lengths need.  The first kernel, 32 x 32 tiles over 8
// row slices (288 blocks), 5 shared loads per 4 FMAs and every row walked,
// took 0.137 ms on the device (NVIDIA H100 80GB HBM3, 700 W), slower than
// the plain einsum.  lstm_dw_partial_kernel is now a split-K,
// register-tiled SIMT product: a block computes a 96-unit x 128-column tile
// (4H in three) over one slice of the rows, a thread 6 x 8 outputs in
// registers, so each float read from shared memory feeds 6 or 8 FMAs; the
// slices are many (ops/kernels/lstm.py `_dw_plan`: about two blocks a SM);
// rows stage through a cp.async double buffer, 16 rows a stage; and a stage
// whose rows all lie at t = 0 or t >= length, which add exact zeros, is
// skipped (at the training lengths 42% of the rows), from the lengths read
// on the device.  lstm_dw_reduce_kernel adds the slices' partial tiles in
// slice order.  No atomics: a repeated run gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdMaxHidden = 96;
constexpr int kFwdMaxThreads = 4 * kFwdMaxHidden;
constexpr int kAhead = 8;  // steps of x_proj (or terms) in flight ahead of the step that uses them

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

constexpr int GT_ROWS = 64;   // steps per tile of the gate-terms product
constexpr int GT_UNITS = 32;  // units per tile (blockDim.x), each with its four gate columns
constexpr int GT_K = 32;      // k chunk held in shared memory
constexpr int GT_TY = 8;      // blockDim.y; a thread owns GT_ROWS / GT_TY steps x 4 gates of a unit

// terms[b, t] = [g_i, g_f, g_g, g_o, o(1 - tc^2), f] (6H) for t < length[b],
// from pre = x_proj[b, t] + h_{t-1} . W_hh (h_{-1} = 0).  Grid
// (ceil(T / GT_ROWS), B, ceil(H / GT_UNITS)); a tile past the row's length
// returns at once.
__global__ void __launch_bounds__(GT_UNITS * GT_TY)
lstm_gate_terms_kernel(const float* __restrict__ xp, const float* __restrict__ whh,
                       const int* __restrict__ lengths, const float* __restrict__ h_all,
                       const float* __restrict__ c_all, float* __restrict__ terms, int T,
                       int H) {
  __shared__ __align__(16) float h_s[GT_ROWS][GT_K];  // [step][k]: a warp reads one address
  __shared__ float w_s[GT_K][4][GT_UNITS];            // [k][gate][unit]
  constexpr int PER = GT_ROWS / GT_TY;
  constexpr int NT = GT_UNITS * GT_TY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * GT_UNITS + tx;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * GT_ROWS;
  const int len = max(0, min(lengths[b], T));
  if (t0 >= len) return;
  const int u0 = blockIdx.z * GT_UNITS;
  const int G = 4 * H;
  const long long row0 = static_cast<long long>(b) * T;
  float acc[PER][4] = {};

  for (int k0 = 0; k0 < H; k0 += GT_K) {
    for (int i = tid; i < GT_ROWS * GT_K; i += NT) {
      const int r = i / GT_K, kk = i % GT_K, t = t0 + r, k = k0 + kk;
      h_s[r][kk] = t >= 1 && t < len && k < H ? h_all[(row0 + t - 1) * H + k] : 0.f;
    }
    for (int i = tid; i < GT_K * 4 * GT_UNITS; i += NT) {
      const int kk = i / (4 * GT_UNITS), g = i / GT_UNITS % 4, j = i % GT_UNITS;
      const int k = k0 + kk, u = u0 + j;
      w_s[kk][g][j] = k < H && u < H ? whh[k * G + g * H + u] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GT_K; kk += 4) {
      float w[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int g = 0; g < 4; ++g) w[q][g] = w_s[kk + q][g][tx];
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(&h_s[ty + GT_TY * i][kk]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[i][g] = fmaf(hv.x, w[0][g], acc[i][g]);
          acc[i][g] = fmaf(hv.y, w[1][g], acc[i][g]);
          acc[i][g] = fmaf(hv.z, w[2][g], acc[i][g]);
          acc[i][g] = fmaf(hv.w, w[3][g], acc[i][g]);
        }
      }
    }
    __syncthreads();
  }

  const int u = u0 + tx;
  if (u >= H) return;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = t0 + ty + GT_TY * i;
    if (t >= len) continue;
    const long long n = row0 + t;
    const float* x = xp + n * G + u;
    const float ig = sigmoid(acc[i][0] + x[0]);
    const float fg = sigmoid(acc[i][1] + x[H]);
    const float gg = tanhf(acc[i][2] + x[2 * H]);
    const float og = sigmoid(acc[i][3] + x[3 * H]);
    const float tc = tanhf(c_all[n * H + u]);
    const float cp = t > 0 ? c_all[(n - 1) * H + u] : 0.f;
    float* out = terms + n * 6 * H + u;
    out[0] = gg * ig * (1.f - ig);
    out[H] = cp * fg * (1.f - fg);
    out[2 * H] = ig * (1.f - gg * gg);
    out[3 * H] = tc * og * (1.f - og);
    out[4 * H] = og * (1.f - tc * tc);
    out[5 * H] = fg;
  }
}

// dgates (4H) is cut into 16 slices of KS words, one per lane of a unit
// group; slice l starts at word l * SS, SS = KS or KS + 4 so that SS / 4 is
// odd: the float4 reads of eight consecutive lanes then start on distinct
// 16-byte bank groups and fill all 32 banks.
template <int KS>
__host__ __device__ constexpr int dgate_slice_stride() { return KS % 8 == 0 ? KS + 4 : KS; }

template <int KS>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
lstm_backward_kernel(const float* __restrict__ terms, const float* __restrict__ whh,
                     const int* __restrict__ lengths, const float* __restrict__ g,
                     float* __restrict__ dxp, int T, int H) {
  constexpr int SS = dgate_slice_stride<KS>();
  __shared__ __align__(16) float dg_s[2][16 * SS];
  const int G = 4 * H;
  // The product: lane l of group q sums slice l of dgates into units 4q..4q+3.
  const int l = threadIdx.x & 15, q = threadIdx.x >> 4;
  const bool hi3 = l & 8, hi2 = l & 4;
  // The cell: after the reduction lane 4m + s of group q holds dh of unit
  // u = 4q + m and forms the adjoint of gate s.
  const int u = threadIdx.x >> 2;
  const int s = threadIdx.x & 3;
  const bool real = u < H;
  const int b = blockIdx.x;

  float w[4][KS];  // W_hh[4q + m, l * KS + v], zero past H or 4H
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int v = 0; v < KS; ++v) {
      const int um = 4 * q + m, j = l * KS + v;
      w[m][v] = um < H && j < G ? whh[um * G + j] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 2 * 16 * SS; i += blockDim.x) (&dg_s[0][0])[i] = 0.f;
  const int len = max(0, min(lengths[b], T));
  const long long row = static_cast<long long>(b) * T;
  float* dx_row = dxp + row * G;
  for (long long i = static_cast<long long>(len) * G + threadIdx.x;
       i < static_cast<long long>(T) * G; i += blockDim.x)
    dx_row[i] = 0.f;
  // Lane s of unit u reads g_s (column s*H + u), a (4H + u) and f (5H + u),
  // and writes dgates[s*H + u] at its slice's word.
  const int j_out = s * H + u;
  const int slot = j_out / KS * SS + j_out % KS;
  const float* tm = terms + row * 6 * H + u;
  float gr[kAhead], ar[kAhead], fr[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const bool ok = real && i < len;
    const long long o = static_cast<long long>(len - 1 - i) * 6 * H;
    gr[i] = ok ? tm[o + s * H] : 0.f;
    ar[i] = ok ? tm[o + 4 * H] : 0.f;
    fr[i] = ok ? tm[o + 5 * H] : 0.f;
  }
  float* dx_col = dx_row + j_out;
  float dh = real ? g[b * H + u] : 0.f, dc = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = len - 1 - (k0 + i);
      if (t < 0) break;
      const float dct = fmaf(dh, ar[i], dc);
      const float d = (s == 3 ? dh : dct) * gr[i];
      dc = dct * fr[i];
      float* buf = dg_s[t & 1];
      if (real) {
        buf[slot] = d;
        dx_col[static_cast<long long>(t) * G] = d;
      }
      if (real && t >= kAhead) {
        const long long o = static_cast<long long>(t - kAhead) * 6 * H;
        gr[i] = tm[o + s * H];
        ar[i] = tm[o + 4 * H];
        fr[i] = tm[o + 5 * H];
      }
      if (t == 0) break;
      __syncthreads();
      // dh_{t-1}[4q + m] = sum_j dgates_t[j] W_hh[4q + m, j]: this lane's
      // slice for four units, then a reduce-scatter over the group's 16
      // lanes (bits 3 and 2 of l pick the unit), then a sum over bits 1, 0.
      const float* dq = buf + l * SS;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < KS; v += 4) {
        const float4 dv = *reinterpret_cast<const float4*>(dq + v);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m] = fmaf(dv.x, w[m][v], acc[m]);
          acc[m] = fmaf(dv.y, w[m][v + 1], acc[m]);
          acc[m] = fmaf(dv.z, w[m][v + 2], acc[m]);
          acc[m] = fmaf(dv.w, w[m][v + 3], acc[m]);
        }
      }
      float keep0 = hi3 ? acc[2] : acc[0], keep1 = hi3 ? acc[3] : acc[1];
      keep0 += __shfl_xor_sync(kFull, hi3 ? acc[0] : acc[2], 8);
      keep1 += __shfl_xor_sync(kFull, hi3 ? acc[1] : acc[3], 8);
      float p = (hi2 ? keep1 : keep0) + __shfl_xor_sync(kFull, hi2 ? keep0 : keep1, 4);
      p += __shfl_xor_sync(kFull, p, 1);
      p += __shfl_xor_sync(kFull, p, 2);
      dh = p;
    }
  }
}

constexpr int DW_UNITS = 96;     // block tile: units (rows of dW)
constexpr int DW_COLS = 128;     // block tile: gate columns
constexpr int DW_CHUNK = 16;     // rows of h and dx per shared-memory stage
constexpr int DW_THREADS = 256;  // 16 x 16: 6 units x 8 gate columns a thread

__device__ __forceinline__ void dw_cp_async16(float* smem, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void dw_cp_async4(float* smem, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void dw_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void dw_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Row n = b * T + t of dW's product carries h_prev[n] = h_all[n - 1] for
// 1 <= t < length[b], and zero elsewhere.
__device__ __forceinline__ bool dw_row_active(int n, int T, const int* lengths) {
  const int b = n / T, t = n - b * T;
  return t >= 1 && t < lengths[b];
}

// The first chunk in [c, c_end) with an active row, or c_end.  Every thread
// evaluates the same chunks, so the result is uniform across the block.
__device__ __forceinline__ int dw_next_active(int c, int c_end, int n_total, int T,
                                              const int* lengths) {
  for (; c < c_end; ++c) {
    const int n_end = min((c + 1) * DW_CHUNK, n_total);
    for (int n = c * DW_CHUNK; n < n_end;) {
      const int b = n / T, base = b * T;
      if (max(n, base + 1) < min(n_end, base + min(lengths[b], T))) return c;
      n = base + T;
    }
  }
  return c_end;
}

// partial[s, k, j] = sum over the rows n of slice s of h_prev[n, k] dx[n, j].
// A block computes a 96-unit x 128-column tile over its slice's chunks of 16
// rows; a thread keeps 6 units x 8 columns in registers (each h float read
// from shared memory feeds 8 FMAs, each dx float 6).  Chunks are staged by
// cp.async into a double buffer (zero-filled where h_prev is zero, past
// B*T and outside the tile), and a chunk with no active row is skipped.
// VEC_H: h_all's rows are 16-byte aligned (H % 4 == 0), so they are staged
// as float4s; else one float at a time.
template <bool VEC_H>
__global__ void __launch_bounds__(DW_THREADS, 2)
lstm_dw_partial_kernel(const float* __restrict__ h_all, const float* __restrict__ dxp,
                       const int* __restrict__ lengths, float* __restrict__ partial,
                       int B, int T, int H, int chunks_per_slice) {
  __shared__ __align__(16) float h_s[2][DW_CHUNK][DW_UNITS];
  __shared__ __align__(16) float d_s[2][DW_CHUNK][DW_COLS];
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int tc = tid % 16, tu = tid / 16;
  const int j0 = blockIdx.x * DW_COLS, k0 = blockIdx.y * DW_UNITS;
  const int n_total = B * T;
  const int n_chunks = (n_total + DW_CHUNK - 1) / DW_CHUNK;
  const int c_begin = blockIdx.z * chunks_per_slice;
  const int c_end = min(c_begin + chunks_per_slice, n_chunks);

  auto stage = [&](int c, int buf) {
    const int n0 = c * DW_CHUNK;
    for (int i = tid; i < DW_CHUNK * DW_COLS / 4; i += DW_THREADS) {
      const int r = i / (DW_COLS / 4), j = j0 + (i % (DW_COLS / 4)) * 4;
      const int n = n0 + r;
      const bool ok = n < n_total && j < G;
      dw_cp_async16(&d_s[buf][r][j - j0], ok ? dxp + static_cast<size_t>(n) * G + j : dxp, ok);
    }
    if (VEC_H) {
      for (int i = tid; i < DW_CHUNK * DW_UNITS / 4; i += DW_THREADS) {
        const int r = i / (DW_UNITS / 4), k = k0 + (i % (DW_UNITS / 4)) * 4;
        const int n = n0 + r;
        const bool ok = n < n_total && k < H && dw_row_active(n, T, lengths);
        dw_cp_async16(&h_s[buf][r][k - k0],
                      ok ? h_all + static_cast<size_t>(n - 1) * H + k : h_all, ok);
      }
    } else {
      for (int i = tid; i < DW_CHUNK * DW_UNITS; i += DW_THREADS) {
        const int r = i / DW_UNITS, k = k0 + i % DW_UNITS;
        const int n = n0 + r;
        const bool ok = n < n_total && k < H && dw_row_active(n, T, lengths);
        dw_cp_async4(&h_s[buf][r][k - k0],
                     ok ? h_all + static_cast<size_t>(n - 1) * H + k : h_all, ok);
      }
    }
  };

  float acc[6][8] = {};
  int c = dw_next_active(c_begin, c_end, n_total, T, lengths);
  if (c < c_end) stage(c, 0);
  dw_commit();
  int buf = 0;
  while (c < c_end) {
    const int next = dw_next_active(c + 1, c_end, n_total, T, lengths);
    if (next < c_end) stage(next, buf ^ 1);
    dw_commit();
    dw_wait_one();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < DW_CHUNK; ++r) {
      const float2 a01 = *reinterpret_cast<const float2*>(&h_s[buf][r][tu * 6]);
      const float2 a23 = *reinterpret_cast<const float2*>(&h_s[buf][r][tu * 6 + 2]);
      const float2 a45 = *reinterpret_cast<const float2*>(&h_s[buf][r][tu * 6 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&d_s[buf][r][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&d_s[buf][r][64 + tc * 4]);
      const float a[6] = {a01.x, a01.y, a23.x, a23.y, a45.x, a45.y};
      const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[u][q] = fmaf(a[u], v[q], acc[u][q]);
    }
    __syncthreads();
    buf ^= 1;
    c = next;
  }

  float* out = partial + static_cast<size_t>(blockIdx.z) * H * G;
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const int k = k0 + tu * 6 + u;
    if (k >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + half * 64 + tc * 4;
      if (j < G)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(k) * G + j) =
            make_float4(acc[u][4 * half], acc[u][4 * half + 1], acc[u][4 * half + 2],
                        acc[u][4 * half + 3]);
    }
  }
}

// dw[i] = the slices' partials added in slice order, one float a thread,
// eight loads in flight.
__global__ void lstm_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ dw, int n, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < slices; ++z) s += partial[static_cast<size_t>(z) * n + i];
  dw[i] = s;
}

// Calls f(std::integral_constant<int, KS>) with KS = 4 * ceil(H / 16), 1 <= H <= 96.
template <typename F>
cudaError_t with_slice(int H, F&& f) {
  switch ((H + 15) / 16) {
    case 1: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 8>{});
    case 3: return f(std::integral_constant<int, 12>{});
    case 4: return f(std::integral_constant<int, 16>{});
    case 5: return f(std::integral_constant<int, 20>{});
    default: return f(std::integral_constant<int, 24>{});
  }
}

int lstm_threads(int H) { return 4 * ((H + 7) / 8 * 8); }

template <bool STASH>
cudaError_t launch_forward(const void* x_proj, const void* w_hh, const void* lengths,
                           void* out, void* h_all, void* c_all, int B, int T, int H,
                           void* stream) {
  if (B == 0) return cudaSuccess;
  if (H < 1 || H > kFwdMaxHidden) return cudaErrorInvalidValue;
  return with_slice(H, [&](auto ks) {
    lstm_last_hidden_kernel<STASH, decltype(ks)::value>
        <<<B, lstm_threads(H), 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
            static_cast<const int*>(lengths), static_cast<float*>(out),
            static_cast<float*>(h_all), static_cast<float*>(c_all), T, H);
    return cudaGetLastError();
  });
}

}  // namespace

// Each entry point returns the launch's cudaError_t.  The forward and the
// backward's recurrence take 1 <= H <= 96 (W_hh in registers: 4 * ceil(H / 16)
// * 4 floats a lane); the gate terms take any H >= 1.

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

// F's first launch: terms (B, T, 6H) for t < length; the rest is not written.
extern "C" int maunet_lstm_gate_terms(const void* x_proj, const void* w_hh,
                                      const void* lengths, const void* h_all,
                                      const void* c_all, void* terms, int B, int T,
                                      int H, void* stream) {
  if (B == 0 || T == 0) return static_cast<int>(cudaSuccess);
  if (H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + GT_ROWS - 1) / GT_ROWS, B, (H + GT_UNITS - 1) / GT_UNITS);
  lstm_gate_terms_kernel<<<grid, dim3(GT_UNITS, GT_TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<const float*>(h_all),
      static_cast<const float*>(c_all), static_cast<float*>(terms), T, H);
  return static_cast<int>(cudaGetLastError());
}

// F's second launch: dx_proj (B, T, 4H) from the terms and the last hidden
// state's gradient g (B, H); zero at t >= length.
extern "C" int maunet_lstm_backward(const void* terms, const void* w_hh,
                                    const void* lengths, const void* g, void* dx_proj,
                                    int B, int T, int H, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (H < 1 || H > kFwdMaxHidden) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_slice(H, [&](auto ks) {
    lstm_backward_kernel<decltype(ks)::value>
        <<<B, lstm_threads(H), 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(terms), static_cast<const float*>(w_hh),
            static_cast<const int*>(lengths), static_cast<const float*>(g),
            static_cast<float*>(dx_proj), T, H);
    return cudaGetLastError();
  }));
}

// dW (H, 4H) from the stashed h and the backward's dx_proj.  ``partial`` is
// scratch of (slices, H, 4H) floats; each slice covers rows_per_slice of the
// B*T rows (a multiple of 16), and slices * rows_per_slice >= B*T.
extern "C" int maunet_lstm_dw(const void* h_all, const void* dx_proj,
                              const void* lengths, void* partial, void* dw, int B,
                              int T, int H, int slices, int rows_per_slice,
                              void* stream) {
  if (H < 1 || T < 1 || B < 1 || slices < 1 || rows_per_slice < DW_CHUNK ||
      rows_per_slice % DW_CHUNK != 0 ||
      static_cast<long long>(slices) * rows_per_slice < static_cast<long long>(B) * T ||
      static_cast<long long>(B) * T * 4 * H >= (1LL << 31) || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((G + DW_COLS - 1) / DW_COLS, (H + DW_UNITS - 1) / DW_UNITS, slices);
  const int chunks = rows_per_slice / DW_CHUNK;
  const bool vec_h = H % 4 == 0 && reinterpret_cast<uintptr_t>(h_all) % 16 == 0;
  const bool aligned = reinterpret_cast<uintptr_t>(dx_proj) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(partial) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  const float* h = static_cast<const float*>(h_all);
  const float* dx = static_cast<const float*>(dx_proj);
  const int* len = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(partial);
  if (vec_h)
    lstm_dw_partial_kernel<true><<<grid, DW_THREADS, 0, s>>>(h, dx, len, part, B, T, H, chunks);
  else
    lstm_dw_partial_kernel<false><<<grid, DW_THREADS, 0, s>>>(h, dx, len, part, B, T, H, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * G;
  lstm_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, slices);
  return static_cast<int>(cudaGetLastError());
}
