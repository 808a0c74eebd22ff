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
//     a (rows x H) . (H x 4H) product, whose epilogue writes the step's
//     coefficients, terms (B, T, 6H) = [g_i, g_f, g_g, g_o, a, f] with
//     tc = tanh(c_t): g_i = g i(1-i), g_f = c_{t-1} f(1-f), g_g = i(1-g^2),
//     g_o = tc o(1-o), a = o(1-tc^2), so that the recurrence is
//     dct = dc + dh a, d_o = dh g_o, d_{i,f,g} = dct g_{i,f,g}, dc = dct f.
//     Rows t >= length are neither read nor written.  At the training
//     lengths (7,648 of 13,248 rows) that is 0.564 GFLOP, 0.0084 ms at the
//     f32 peak, and 35 MB (x_proj 11.7, h 2.9, c 2.9, terms 17.6), 0.0105 ms
//     at 3.35 TB/s: bound by bytes, with the product close behind, so the
//     two have to overlap.  The first version (64-step x 32-unit tiles of
//     B x T, 624 blocks) reloaded its W_hh slice from L2 in every block,
//     about 30 MB for a 147 KB matrix, with scalar loads and a division per
//     element, never overlapped copies with products, computed the rows
//     past length of a tile that straddled it, and spilled.  Now persistent
//     blocks, one a SM, keep all of W_hh in shared memory as it lies in
//     device memory (147 KB at H = 96), loaded once with 16-byte cp.async
//     copies, and walk tiles of 32 consecutive active rows, found from a
//     prefix of the clamped lengths (warp_resolve_rows), so no row
//     t >= length is computed.  A thread keeps 4 rows x 3 units x 4 gates in
//     registers, at most 128 registers: each W_hh float read from shared
//     memory feeds 4 FMAs and each h float4 48, and a half-warp's W_hh reads
//     are 16 consecutive words.  The next tile's h_{t-1} rows and this
//     tile's x_proj come through cp.async, and c_t and c_{t-1} into
//     registers, while the product runs; the epilogue reads x_proj from
//     shared memory, a warp's lanes on consecutive units, so the reads and
//     the six stores are coalesced.  Each output is one fmaf chain over
//     k = 0, 1, ... from 0, then + x_proj, as the first version summed it:
//     the same bits.  On the H100 it takes 0.037 ms at the training batch
//     against the first version's 0.044 (NVIDIA H100 80GB HBM3, 700 W):
//     about 7 us of product a tile, 3 of the epilogue's transcendentals and
//     then its stores, one after the other on the SM's one block.  A layout
//     of W_hh as [k][unit][gate] (one float4 a unit) read fewer words but
//     took 4-byte copies with a division each to load, 6 us a block.
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

__device__ __forceinline__ void cp_async16(float* smem, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* src, bool ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

constexpr int GT_ROWS = 32;                 // active rows per tile
constexpr int GT_UNITS = kFwdMaxHidden;     // every unit in one tile
constexpr int GT_THREADS = 256;             // 4 row quarters x 2 unit halves of warps
constexpr int GT_RPT = 4;                   // rows a thread: r0, r0 + 2, r0 + 4, r0 + 6
constexpr int GT_UPT = 3;                   // units a thread: u0, u0 + 16, u0 + 32

// The gate-terms kernel's dynamic shared memory at hidden size H, in floats:
//   w_s [kp][4H]           W_hh as it lies in device memory, so that it loads
//                          as 16-byte copies; zero rows k >= H; kp = H
//                          rounded up to 4;
//   h_s [2][GT_ROWS][hs]   h_{t-1} of a tile's rows, zero at t = 0 and past
//                          the last active row; hs = kp, or kp + 4 where kp is
//                          a multiple of 32, so that the two rows a warp reads
//                          at once fall on distinct banks;
//   x_s [GT_ROWS][xs]      x_proj of the tile's rows; xs % 32 == 16, so the
//                          epilogue's reads of two rows fill all 32 banks;
//   then ints: row_s [2][GT_ROWS] (b * T + t of each row, or -1), t_s
//   [2][GT_ROWS] (t), and the number of active rows.
struct GateLayout {
  int kp, hs, xs, h_off, x_off, i_off, bytes;
};

__host__ __device__ inline GateLayout gate_layout(int H) {
  GateLayout L;
  L.kp = (H + 3) / 4 * 4;
  L.hs = L.kp % 32 == 0 ? L.kp + 4 : L.kp;
  L.xs = 4 * H + (48 - 4 * H % 32) % 32;
  L.h_off = L.kp * 4 * H;
  L.x_off = L.h_off + 2 * GT_ROWS * L.hs;
  L.i_off = L.x_off + GT_ROWS * L.xs;
  L.bytes = (L.i_off + 4 * GT_ROWS + 1) * 4;
  return L;
}

__device__ __forceinline__ int clamped_length(const int* lengths, int b, int B, int T) {
  return b < B ? max(0, min(lengths[b], T)) : 0;
}

// Called by a whole warp: the number of rows t < length over the batch.
__device__ int warp_active_rows(const int* __restrict__ lengths, int B, int T, int lane) {
  int n = 0;
  for (int b0 = 0; b0 < B; b0 += 32) n += clamped_length(lengths, b0 + lane, B, T);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  return n;
}

// Called by a whole warp: lane l finds active row a = first + l (the rows
// t < length of every sample, in order) and writes its b * T + t to row_s[l]
// and t to t_s[l], or -1 past the last active row.  A prefix of the clamped
// lengths, 32 samples at a time.
__device__ void warp_resolve_rows(const int* __restrict__ lengths, int B, int T, int first,
                                  int* row_s, int* t_s, int lane) {
  const int a = first + lane;
  int row = -1, t = 0, base = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int len = clamped_length(lengths, b0 + lane, B, T);
    int incl = len;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int j = 0;  // the samples of this chunk whose rows all lie before a
    for (int i = 0; i < 32; ++i) j += base + __shfl_sync(kFull, incl, i) <= a;
    const int incl_j = __shfl_sync(kFull, incl, j & 31);
    const int len_j = __shfl_sync(kFull, len, j & 31);
    if (a >= base && a < base + total) {
      t = a - base - (incl_j - len_j);
      row = (b0 + j) * T + t;
    }
    base += total;
  }
  row_s[lane] = row;
  t_s[lane] = t;
}

// Stage rows (GT_ROWS of them) of `width` floats into shared memory at a
// row stride `stride`: row r from src + (row_s[r] + shift) * width, or zeros
// where `zero(r)`.  VEC: 16-byte copies (width and src 16-byte aligned).
template <bool VEC, typename Zero>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* __restrict__ src,
                                           const int* row_s, int shift, int width, int padded,
                                           Zero zero) {
  if (VEC) {
    const int per = padded / 4;
    for (int i = threadIdx.x; i < GT_ROWS * per; i += GT_THREADS) {
      const int r = i / per, k = (i - r * per) * 4;
      const bool ok = !zero(r) && k < width;
      cp_async16(dst + r * stride + k,
                 ok ? src + (static_cast<long long>(row_s[r]) + shift) * width + k : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < GT_ROWS * padded; i += GT_THREADS) {
      const int r = i / padded, k = i - r * padded;
      const bool ok = !zero(r) && k < width;
      cp_async4(dst + r * stride + k,
                ok ? src + (static_cast<long long>(row_s[r]) + shift) * width + k : src, ok);
    }
  }
}

// terms[b, t] = [g_i, g_f, g_g, g_o, o(1 - tc^2), f] (6H) for t < length[b],
// from pre = x_proj[b, t] + h_{t-1} . W_hh (h_{-1} = 0).  Persistent blocks,
// at most one a SM, each with all of W_hh in shared memory, walk tiles of
// GT_ROWS consecutive active rows (gate_layout).  A thread owns 4 rows x 3
// units x 4 gates in registers: each W_hh float read feeds 4 FMAs, each h
// float4 48.  Each output is one fmaf chain over k = 0..kp-1 from 0, then
// + x_proj, as the first version of this kernel summed it, so the terms keep
// its bits.  VEC: H % 4 == 0 and x_proj, h_all, w_hh 16-byte aligned.
// __launch_bounds__(GT_THREADS, 2) holds the kernel to 128 registers a
// thread, though its shared memory admits one block a SM.
template <bool VEC>
__global__ void __launch_bounds__(GT_THREADS, 2)
lstm_gate_terms_kernel(const float* __restrict__ xp, const float* __restrict__ whh,
                       const int* __restrict__ lengths, const float* __restrict__ h_all,
                       const float* __restrict__ c_all, float* __restrict__ terms, int B,
                       int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const GateLayout L = gate_layout(H);
  float* w_s = smem;
  float* h_s = smem + L.h_off;
  float* x_s = smem + L.x_off;
  int* row_s = reinterpret_cast<int*>(smem + L.i_off);  // [2][GT_ROWS]
  int* t_s = row_s + 2 * GT_ROWS;                       // [2][GT_ROWS]
  int* n_s = t_s + 2 * GT_ROWS;
  const int G = 4 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) {
    const int n = warp_active_rows(lengths, B, T, lane);
    if (lane == 0) *n_s = n;
  }
  __syncthreads();
  const int n_tiles = (*n_s + GT_ROWS - 1) / GT_ROWS;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  if (warp == 0) warp_resolve_rows(lengths, B, T, tile * GT_ROWS, row_s, t_s, lane);
  __syncthreads();

  // W_hh once per block, with the first tile's h rows: the first group.
  // VEC: 16-byte copies (H % 4 == 0, so kp == H and every row is aligned).
  if (VEC) {
    for (int i = tid; i < H * G / 4; i += GT_THREADS) cp_async16(w_s + 4 * i, whh + 4 * i, true);
  } else {
    for (int i = tid; i < L.kp * G; i += GT_THREADS)
      cp_async4(w_s + i, i < H * G ? whh + i : whh, i < H * G);
  }
  auto stage_h = [&](int buf) {
    const int* rows = row_s + buf * GT_ROWS;
    const int* ts = t_s + buf * GT_ROWS;
    stage_rows<VEC>(h_s + buf * GT_ROWS * L.hs, L.hs, h_all, rows, -1, H, L.kp,
                    [&](int r) { return rows[r] < 0 || ts[r] == 0; });
  };
  stage_h(0);
  cp_async_commit();

  const int u0 = (warp & 1) * (GT_UNITS / 2) + (lane & 15);
  const int r0 = (warp >> 1) * 8 + (lane >> 4);
  // The W_hh columns of the thread's units; a unit past H reads unit H - 1
  // (its outputs are not stored).
  int uc[GT_UPT];
#pragma unroll
  for (int j = 0; j < GT_UPT; ++j) uc[j] = min(u0 + 16 * j, H - 1);
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int cur = it & 1, next = tile + gridDim.x;
    const int* rows = row_s + cur * GT_ROWS;
    // x_proj of this tile, in flight during the product.
    stage_rows<VEC>(x_s, L.xs, xp, rows, 0, G, G, [&](int r) { return rows[r] < 0; });
    cp_async_commit();
    // c_t and c_{t-1} of the thread's rows and units, in flight during the
    // product: loaded in the epilogue they cost one round trip each.
    float c_t[GT_RPT][GT_UPT], c_p[GT_RPT][GT_UPT];
#pragma unroll
    for (int i = 0; i < GT_RPT; ++i) {
      const long long n = rows[r0 + 2 * i];
      const bool prev = n >= 0 && t_s[cur * GT_ROWS + r0 + 2 * i] > 0;
#pragma unroll
      for (int j = 0; j < GT_UPT; ++j) {
        const int u = u0 + 16 * j;
        const bool ok = n >= 0 && u < H;
        c_t[i][j] = ok ? c_all[n * H + u] : 0.f;
        c_p[i][j] = ok && prev ? c_all[(n - 1) * H + u] : 0.f;
      }
    }
    if (warp == 0 && next < n_tiles)
      warp_resolve_rows(lengths, B, T, next * GT_ROWS, row_s + (cur ^ 1) * GT_ROWS,
                        t_s + (cur ^ 1) * GT_ROWS, lane);
    cp_async_wait_one();  // W_hh and this tile's h
    __syncthreads();

    float acc[GT_RPT][GT_UPT][4];
#pragma unroll
    for (int i = 0; i < GT_RPT; ++i)
#pragma unroll
      for (int j = 0; j < GT_UPT; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][j][g] = 0.f;
    const float* hb = h_s + cur * GT_ROWS * L.hs + r0 * L.hs;
    for (int k = 0; k < L.kp; k += 4) {
      float4 hv[GT_RPT];
#pragma unroll
      for (int i = 0; i < GT_RPT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hb + 2 * i * L.hs + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // Lanes of a half-warp read 16 consecutive units of one gate: no
        // bank conflicts; the two half-warps read the same words.
        const float* wr = w_s + (k + kk) * G;
        float wv[GT_UPT][4];
#pragma unroll
        for (int j = 0; j < GT_UPT; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) wv[j][g] = wr[g * H + uc[j]];
#pragma unroll
        for (int i = 0; i < GT_RPT; ++i) {
          const float hk = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
#pragma unroll
          for (int j = 0; j < GT_UPT; ++j)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[i][j][g] = fmaf(hk, wv[j][g], acc[i][j][g]);
        }
      }
    }
    __syncthreads();  // the next tile's rows are resolved; h buffer cur ^ 1 is free
    if (next < n_tiles) stage_h(cur ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile's x_proj
    __syncthreads();

#pragma unroll
    for (int i = 0; i < GT_RPT; ++i) {
      const int r = r0 + 2 * i;
      const long long n = rows[r];
      if (n < 0) continue;
      const float* xr = x_s + r * L.xs;
#pragma unroll
      for (int j = 0; j < GT_UPT; ++j) {
        const int u = u0 + 16 * j;
        if (u >= H) continue;
        const float ig = sigmoid(acc[i][j][0] + xr[u]);
        const float fg = sigmoid(acc[i][j][1] + xr[H + u]);
        const float gg = tanhf(acc[i][j][2] + xr[2 * H + u]);
        const float og = sigmoid(acc[i][j][3] + xr[3 * H + u]);
        const float tc = tanhf(c_t[i][j]);
        const float cp = c_p[i][j];
        float* out = terms + n * 6 * H + u;
        out[0] = gg * ig * (1.f - ig);
        out[H] = cp * fg * (1.f - fg);
        out[2 * H] = ig * (1.f - gg * gg);
        out[3 * H] = tc * og * (1.f - og);
        out[4 * H] = og * (1.f - tc * tc);
        out[5 * H] = fg;
      }
    }
    __syncthreads();  // x_s and this tile's rows are free
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
      cp_async16(&d_s[buf][r][j - j0], ok ? dxp + static_cast<size_t>(n) * G + j : dxp, ok);
    }
    if (VEC_H) {
      for (int i = tid; i < DW_CHUNK * DW_UNITS / 4; i += DW_THREADS) {
        const int r = i / (DW_UNITS / 4), k = k0 + (i % (DW_UNITS / 4)) * 4;
        const int n = n0 + r;
        const bool ok = n < n_total && k < H && dw_row_active(n, T, lengths);
        cp_async16(&h_s[buf][r][k - k0],
                      ok ? h_all + static_cast<size_t>(n - 1) * H + k : h_all, ok);
      }
    } else {
      for (int i = tid; i < DW_CHUNK * DW_UNITS; i += DW_THREADS) {
        const int r = i / DW_UNITS, k = k0 + i % DW_UNITS;
        const int n = n0 + r;
        const bool ok = n < n_total && k < H && dw_row_active(n, T, lengths);
        cp_async4(&h_s[buf][r][k - k0],
                     ok ? h_all + static_cast<size_t>(n - 1) * H + k : h_all, ok);
      }
    }
  };

  float acc[6][8] = {};
  int c = dw_next_active(c_begin, c_end, n_total, T, lengths);
  if (c < c_end) stage(c, 0);
  cp_async_commit();
  int buf = 0;
  while (c < c_end) {
    const int next = dw_next_active(c + 1, c_end, n_total, T, lengths);
    if (next < c_end) stage(next, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
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

// Each entry point returns the launch's cudaError_t.  The forward, the gate
// terms and the backward's recurrence take 1 <= H <= 96 (W_hh in registers:
// 4 * ceil(H / 16) * 4 floats a lane; or, for the gate terms, all of it in a
// block's shared memory).

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
  if (H < 1 || H > kFwdMaxHidden || B < 0 || T < 0 ||
      static_cast<long long>(B) * T >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GateLayout L = gate_layout(H);
  const long long tiles = (static_cast<long long>(B) * T + GT_ROWS - 1) / GT_ROWS;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const bool vec = H % 4 == 0 && reinterpret_cast<uintptr_t>(x_proj) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h_all) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w_hh) % 16 == 0;
  auto kernel = vec ? lstm_gate_terms_kernel<true> : lstm_gate_terms_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, GT_THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<const float*>(h_all),
      static_cast<const float*>(c_all), static_cast<float*>(terms), B, T, H);
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
