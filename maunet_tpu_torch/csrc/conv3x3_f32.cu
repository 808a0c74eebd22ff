// Kernels A and G in f32: the fused 3x3 conv over a virtual channel concat of
// 1-5 NHWC f32 parts (out = relu?(sum_p conv(x_p, w_p) + add * scale + bias)),
// and a whole VGGBlock (two such convs with ReLU, the mid kept on chip).
//
// Replaces the TPU kernels maunet_tpu/ops/pallas/packed_vgg.py::
// packed_conv3x3_fused and ::packed_pair_fused where they run in f32: both
// compute in the parts' dtype and return it, and the JAX model sends its f32
// convs through them as it sends its bf16 ones.  conv3x3_fused.cu and
// conv3x3_pair.cu take bf16 on the tensor cores; their 19-bit TF32 would not compute
// what the TPU kernels compute in f32, so this file runs FFMA on the CUDA
// cores and rounds nothing between the products and the output (the mid of
// the pair included).
//
//   * the weights come prepared (ops/kernels/packed_vgg.prepare_conv3x3 with
//     dtype=torch.float32): f32, the BatchNorm scale folded in, and for each
//     output-channel tile (64 wide; a last or only tile of at most 32
//     channels is 32 wide) and each K step (one BK-channel slice of one part,
//     in part order) the weights as [tap][BK channels][tile width], zero past
//     cout and past cin_p, so a step's weights are one contiguous slab;
//   * `add` is the compact (B, 3, W, cout) f32 term of the broadcast
//     embeddings (rows {y = 0, interior, y = H - 1} of the parts' H: under
//     the spatial mesh axis that is the band with its halo rows, as the bf16
//     kernels take it), multiplied here by `scale`; `bias` is (cout,).  The
//     epilogue rounds as the plain version does: (sum + add * scale) + bias,
//     each product and sum rounded once (no fused multiply-add there).
//
// Every output sums its products in one order: part, then channel, then tap
// 0..8 (tap = 3 dy + dx), one fmaf each, from zero.  Channels past cin_p add
// exact zeros, so the K step's width does not change the bits, and the pair
// kernel's mid equals A's output bit for bit: G gives two A launches' bits.
//
// What bounds it on the H100: the f32 multiply-adds.  At the U-Net's level 0
// (B = 8, 256²) a conv of 23 to 192 input channels to 64 outputs does 38 to
// 108 multiply-adds (76 to 216 FLOP) per byte of device memory it must move,
// far above the 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte where the plain
// f32 units, not the memory, become the limit.  Each of an SM's four
// schedulers issues one warp instruction a clock, and an FFMA fills one, so
// the design keeps other instructions off those slots and gives every
// scheduler the same work:
//   * a register window: a thread owns a segment of SEG output pixels x 8
//     output channels.  For each input channel it reads each of the three
//     staged rows its segment needs once, as three float4 (the SEG + 2
//     values it needs, from a 16-byte boundary), and applies that row's
//     three taps from registers: 9 float4 of halo and 18 of weights a
//     channel for 9 x 8 x SEG FFMA (about one load in 20 issue slots);
//   * conflict-free weight reads: a thread's channels are {4 cg .. 4 cg + 3}
//     and {BN / 2 + 4 cg .. + 3}, so the 8 lanes of a 128-bit phase read 128
//     contiguous bytes of the slab [tap][k][BN]; the lanes of one segment
//     read one halo address (a broadcast), and a warp's segments start on
//     distinct 16-byte bank groups (rows 20 or 24 floats apart);
//   * an asynchronous staging ring: S stages of cp.async (the halo 4 bytes
//     at a time, zero-filled outside the image and past cin_p, at slots
//     whose pixels a thread works out once per tile; the slab 16 bytes at a
//     time) and one barrier per K step, so the next steps are in flight
//     while step k multiplies; a staged plane is 4 floats longer than its
//     rows, so the copies of one pixel's eight channels hit eight banks;
//   * BK = 8 channels a step: the 23-channel input pads to 24 (not 32), and
//     a stage is 8 x 18 x 20 halo floats and 9 x 8 x BN weights (30,080
//     bytes at BN = 64): two blocks of 8 warps an SM at BN = 64, three of 4
//     at BN = 32.
// A block of A owns a 16 x 16 tile of output pixels of one sample and one
// output-channel tile (BN = 64 or 32), as 32 row segments of 8 (two a row,
// each starting on a 16-byte boundary of the 20-float staged row); ragged
// edges are masked, so any H and W run.
//
// The pair kernel's block owns a 14 x 16 output tile (rows x columns), so
// that each conv splits into 32 segments of equal work and every scheduler
// gets the same number of warps: conv1 computes the 16 x 18 mid (the tile
// and its one-pixel ring) as row segments of 9, from an 18 x 20 input halo
// staged as two 12-float windows a row (window h: input columns 9 h ..
// 9 h + 10), so that both segments of a row read from a 16-byte boundary
// through one code path; its epilogue (add, scale1, bias1, ReLU; zero at
// ring pixels outside the image, conv2's zero padding, and past cmid) writes
// the mid transposed, a staged row per mid column as two windows (window v:
// mid rows 7 v .. 7 v + 8), over the space conv1's ring used; conv2 computes
// the output as column segments of 7, each reading three transposed rows
// into registers, with only w2's slabs streaming in, through a ring of their
// own whose first stages load while conv1 runs.  One launch, the mid never
// written to device memory, as JAX's pair kernel keeps it in VMEM.  Widths
// up to 64 (one output tile per conv).  Shared memory follows cmid: 163 KB
// at 64 (one block of 8 warps an SM), 73 KB at 32 (three blocks of 4).
// Against two A launches G still multiplies more: conv1 computes 288 mid
// pixels for 224 outputs, and 14-row tiles cover a 256-row map with 266.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxParts = 5;
constexpr int BK = 8;              // input channels per K step
constexpr int TW = 16;             // output tile columns, A and G
constexpr int TH = 16;             // A's output tile rows
constexpr int GTH = 14;            // G's: its 16-row mid is 32 segments of 9
constexpr int kSeg = 8;            // A's row segment
constexpr int kSegMid = 9;         // conv1's row segment over the 18-wide mid
constexpr int kSegOut = 7;         // conv2's column segment over the 14-row tile
constexpr int kHaloRows = 18;      // A's halo (TH + 2) and G's conv1 input (GTH + 4)
constexpr int kPitch = 20;         // a staged row of A's 18-wide halo
constexpr int kWin = 12;           // a segment's window in registers: SEG + 2 <= 12
constexpr int kWinPitch = 2 * kWin;  // a staged row as two windows, one per segment
constexpr int kNoSlot = -2;        // a staging slot past the halo

struct F32In {
  const float* x[kMaxParts];   // (B, H, W, cin_p) f32
  int cin[kMaxParts];
  int nparts;
  int steps;                   // sum over parts of ceil(cin_p / BK)
};

struct F32Conv {
  F32In in;
  const float* wpk;            // this output-channel tile's slabs
  const float* add;            // (B, 3, W, cout) or null
  const float* scale;          // (cout,), multiplies add; or null
  const float* bias;           // (cout,) or null
  float* out;                  // (B, H, W, cout)
  int H, W, cout;
  int nbase;                   // first output channel of this tile
  int relu;
  int vec_out;                 // float4 stores: cout % 4 == 0, aligned
  int tiles_x, tiles_per_image, tile_rows;
};

struct F32Pair {
  F32Conv c;                   // conv1's parts; conv2's weights, bias, out
  const float* w1;             // conv1's prepared weights
  const float* add;            // (B, 3, W, cmid) or null
  const float* scale1;         // (cmid,), multiplies add; or null
  const float* bias1;          // (cmid,) or null
  int cmid;
};

__host__ __device__ constexpr int slab_elems(int bn) { return 9 * BK * bn; }
// A staged plane (one channel) of `rows` rows `pitch` floats apart; 4 floats
// longer, so the same slot of neighbouring planes falls on other banks.
__host__ __device__ constexpr int plane(int rows, int pitch) { return rows * pitch + 4; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kHaloPlane = plane(kHaloRows, kPitch);
constexpr int kWinPlane = plane(kHaloRows, kWinPitch);   // G's conv1 input and its mid
static_assert(TW + 2 == kHaloRows, "G's transposed mid stages a row per mid column");

// A: 32 segments x NT channel groups; S stages of halo and slab.
__host__ __device__ constexpr int conv_threads(int nt) { return 32 * nt; }
__host__ __device__ constexpr int conv_smem(int nt, int s) {
  return s * (BK * kHaloPlane + slab_elems(8 * nt)) * 4;
}
// G: 32 segments x the wider conv's channel groups.  The mid [8 NT1]
// [kWinPlane] over conv1's ring of S stages, then conv2's S slabs.
__host__ __device__ constexpr int pair_threads(int nt1, int nt2) { return 32 * cmax(nt1, nt2); }
__host__ __device__ constexpr int pair_ring1(int nt1, int s) {
  return cmax(8 * nt1 * kWinPlane, s * (BK * kWinPlane + slab_elems(8 * nt1)));
}
__host__ __device__ constexpr int pair_smem(int nt1, int nt2, int s) {
  return (pair_ring1(nt1, s) + s * slab_elems(8 * nt2)) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, zero-filled where src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest N has landed (in this thread's copies).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged halo of kHaloRows rows whose top-left pixel is image pixel (y0,
// x0), in one of two layouts: rows of kPitch floats holding halo columns
// 0 .. kPitch - 1 (SEG = 0), or rows of two kWin-float windows, window h
// holding the SEG + 2 columns from SEG * h on (each segment's window then
// starts on a 16-byte boundary).  The image pixel (y * W + x in its sample)
// that slot p reads; -1 where it holds zero (outside the image, or past the
// halo's WIDTH columns or the window's SEG + 2), kNoSlot past the halo.
template <int SEG>
__host__ __device__ constexpr int halo_pitch() { return SEG ? kWinPitch : kPitch; }

template <int WIDTH, int SEG>
__device__ __forceinline__ int halo_pixel(int p, int y0, int x0, int H, int W) {
  constexpr int P = halo_pitch<SEG>();
  if (p >= kHaloRows * P) return kNoSlot;
  const int q = p % P, y = y0 + p / P;
  const int col = SEG ? SEG * (q / kWin) + q % kWin : q;
  const bool real = SEG ? q % kWin < SEG + 2 : col < WIDTH;
  return real && y >= 0 && y < H && x0 + col >= 0 && x0 + col < W ? y * W + x0 + col : -1;
}

// One thread's share of staging a halo in every K step: channel
// threadIdx.x % BK of slots threadIdx.x / BK + i * kStride.  With KEEP their
// pixels are worked out once per tile and kept in registers, else again at
// each step.
template <int NTH, int WIDTH, int SEG, bool KEEP>
struct HaloStager {
  static constexpr int kStride = NTH / BK;
  static constexpr int kPlane = plane(kHaloRows, halo_pitch<SEG>());
  static constexpr int NE = (kHaloRows * halo_pitch<SEG>() + kStride - 1) / kStride;
  int pix[KEEP ? NE : 1];
  int y0, x0, H, W;

  __device__ __forceinline__ HaloStager(int y0_, int x0_, int H_, int W_)
      : y0(y0_), x0(x0_), H(H_), W(W_) {
    if constexpr (KEEP) {
#pragma unroll
      for (int i = 0; i < NE; ++i) pix[i] = halo_pixel<WIDTH, SEG>(slot(i), y0, x0, H, W);
    }
  }

  __device__ __forceinline__ int slot(int i) const {
    return static_cast<int>(threadIdx.x) / BK + i * kStride;
  }

  __device__ __forceinline__ int pixel(int i) const {
    if constexpr (KEEP) return pix[i];
    return halo_pixel<WIDTH, SEG>(slot(i), y0, x0, H, W);
  }

  // Channels c0 .. c0 + BK - 1 of xn (one sample of a part of cin channels)
  // into the stage's planes at x_s (a shared-memory address).
  __device__ __forceinline__ void issue(uint32_t x_s, const float* xn, int cin, int c0) const {
    const int k = threadIdx.x % BK;
    const bool real = c0 + k < cin;
    const float* src = xn + c0 + k;
    const uint32_t dst = x_s + (k * kPlane + slot(0)) * 4;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int pix_i = pixel(i);
      if (pix_i == kNoSlot) continue;
      const bool on = real && pix_i >= 0;
      cp_async4(dst + i * kStride * 4, on ? src + static_cast<long long>(pix_i) * cin : xn,
                on ? 4 : 0);
    }
  }
};

// One step's weight slab (9 x BK x BN floats) into shared memory at w_s.
template <int NTH, int BN>
__device__ __forceinline__ void issue_slab(uint32_t w_s, const float* slab) {
  constexpr int kVecs = slab_elems(BN) / 4;
#pragma unroll
  for (int i = 0; i < (kVecs + NTH - 1) / NTH; ++i) {
    const int v = static_cast<int>(threadIdx.x) + i * NTH;
    if (v < kVecs) cp_async16(w_s + v * 16, slab + v * 4);
  }
}

// The producer's place in a conv's K steps: part, its first channel, step.
struct StepCursor {
  int part = 0, c0 = 0, step = 0;

  __device__ __forceinline__ void advance(const F32In& in) {
    c0 += BK;
    ++step;
    if (c0 >= in.cin[part]) {
      c0 = 0;
      ++part;
    }
  }
};

// The 12 floats of a window from xp (16-byte aligned) into registers.
__device__ __forceinline__ void load_window(const float* xp, float (&xr)[kWin]) {
#pragma unroll
  for (int q = 0; q < kWin / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(xp)[q];
    xr[4 * q] = v.x;
    xr[4 * q + 1] = v.y;
    xr[4 * q + 2] = v.z;
    xr[4 * q + 3] = v.w;
  }
}

// acc[j][0..7] += v * the 8 weights of one tap and channel (lo: the thread's
// first four, hi: the four BN / 2 on).
__device__ __forceinline__ void ffma8(float (&acc)[8], float v, const float4& lo,
                                     const float4& hi) {
  acc[0] = fmaf(v, lo.x, acc[0]);
  acc[1] = fmaf(v, lo.y, acc[1]);
  acc[2] = fmaf(v, lo.z, acc[2]);
  acc[3] = fmaf(v, lo.w, acc[3]);
  acc[4] = fmaf(v, hi.x, acc[4]);
  acc[5] = fmaf(v, hi.y, acc[5]);
  acc[6] = fmaf(v, hi.z, acc[6]);
  acc[7] = fmaf(v, hi.w, acc[7]);
}

// acc[j][c] += the nine taps of the BK channels of one staged step, for a
// row segment: pixel j of the segment reads staged row dy, place j + dx of
// its window (xw: the window in the top row, 16-byte aligned; rows PITCH and
// planes PLANE apart).  ws: the stage's slab [9][BK][BN] at the thread's
// channel 4 cg.  Each row is read once a channel and serves its three taps
// from registers.  Per output: channel, then tap 0..8.
template <int SEG, int BN, int PLANE, int PITCH>
__device__ __forceinline__ void row_window_step(const float* xw, const float* ws,
                                                float (&acc)[SEG][8]) {
  static_assert(SEG + 2 <= kWin, "the window holds the segment's taps");
  // Two channels a loop iteration at BN = 64, one at BN = 32: the faster
  // on the H100 for each width.
#pragma unroll(BN == 64 ? 2 : 1)
  for (int k = 0; k < BK; ++k) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float xr[kWin];
      load_window(xw + k * PLANE + dy * PITCH, xr);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wt = ws + ((3 * dy + dx) * BK + k) * BN;
        const float4 lo = *reinterpret_cast<const float4*>(wt);
        const float4 hi = *reinterpret_cast<const float4*>(wt + BN / 2);
#pragma unroll
        for (int j = 0; j < SEG; ++j) ffma8(acc[j], xr[j + dx], lo, hi);
      }
    }
  }
}

// As row_window_step for a column segment over a transposed map (a staged
// row per image column): pixel i reads transposed row dx, place i + dy of
// its window, so the three rows of a channel are read first and the taps
// then run in their order.
template <int SEG, int BN, int PLANE, int PITCH>
__device__ __forceinline__ void column_window_step(const float* xw, const float* ws,
                                                   float (&acc)[SEG][8]) {
  static_assert(SEG + 2 <= kWin, "the window holds the segment's taps");
  // As in row_window_step.
#pragma unroll(BN == 64 ? 2 : 1)
  for (int k = 0; k < BK; ++k) {
    float xr[3][kWin];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) load_window(xw + k * PLANE + dx * PITCH, xr[dx]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* wt = ws + (tap * BK + k) * BN;
      const float4 lo = *reinterpret_cast<const float4*>(wt);
      const float4 hi = *reinterpret_cast<const float4*>(wt + BN / 2);
#pragma unroll
      for (int i = 0; i < SEG; ++i) ffma8(acc[i], xr[tap % 3][i + tap / 3], lo, hi);
    }
  }
}

// The output channel of accumulator column e of a thread whose first
// channel is c0: c0 + e, then BN / 2 on.
__device__ __forceinline__ int acc_channel(int c0, int half, int e) {
  return c0 + (e < 4 ? e : half + e - 4);
}

// The compact add term's row for image row y of an H-row map.
__device__ __forceinline__ int add_row(int y, int H) { return y == 0 ? 0 : (y == H - 1 ? 2 : 1); }

// (sum + add * scale) + bias, each rounded once, then ReLU.
__device__ __forceinline__ float epilogue_value(float s, const float* add, float scale,
                                                float bias, int relu) {
  if (add) s = __fadd_rn(s, __fmul_rn(__ldg(add), scale));
  s = __fadd_rn(s, bias);
  return relu ? fmaxf(s, 0.f) : s;
}

// A thread's epilogue constants: scale and bias of channels
// acc_channel(c0, half, 0..7), where they are below cout.
struct Epilogue {
  float sc[8], bi[8];

  __device__ __forceinline__ Epilogue(const float* scale, const float* bias, int c0, int half,
                                      int cout) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = acc_channel(c0, half, e);
      const bool real = ch < cout;
      sc[e] = real && scale ? __ldg(scale + ch) : 1.f;
      bi[e] = real && bias ? __ldg(bias + ch) : 0.f;
    }
  }
};

// One output pixel (y, x) of sample n, inside the image, through the
// epilogue into a.out: channels acc_channel(c0, half, 0..7).
__device__ __forceinline__ void store_pixel(const F32Conv& a, const Epilogue& ep, int n, int y,
                                            int x, int c0, int half, const float (&acc)[8]) {
  const int H = a.H, W = a.W, cout = a.cout;
  const float* add =
      a.add ? a.add + ((static_cast<long long>(n) * 3 + add_row(y, H)) * W + x) * cout : nullptr;
  float* o = a.out + ((static_cast<long long>(n) * H + y) * W + x) * cout;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = acc_channel(c0, half, 4 * q + e);
      v[e] = epilogue_value(acc[4 * q + e], add && ch < cout ? add + ch : nullptr,
                            ep.sc[4 * q + e], ep.bi[4 * q + e], a.relu);
    }
    const int ch = acc_channel(c0, half, 4 * q);
    if (a.vec_out && ch + 4 <= cout) {
      *reinterpret_cast<float4*>(o + ch) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ch + e < cout) o[ch + e] = v[e];
    }
  }
}

struct TileAt {
  int n, ty0, tx0;
};

__device__ __forceinline__ TileAt tile_at(const F32Conv& a) {
  TileAt t;
  t.n = blockIdx.x / a.tiles_per_image;
  const int r = blockIdx.x % a.tiles_per_image;
  t.ty0 = r / a.tiles_x * a.tile_rows;
  t.tx0 = r % a.tiles_x * TW;
  return t;
}

// Part `part` of `in` at sample n of an H x W map.
__device__ __forceinline__ const float* sample_of(const F32In& in, int part, int n, int H,
                                                  int W) {
  return in.x[part] + static_cast<long long>(n) * H * W * in.cin[part];
}

template <int NT, int S>
__global__ void __launch_bounds__(conv_threads(NT), NT == 8 ? 2 : 3)
    conv3x3_f32_kernel(const __grid_constant__ F32Conv a) {
  constexpr int BN = 8 * NT, NTH = conv_threads(NT);
  constexpr int XSTAGE = BK * kHaloPlane, STAGE = XSTAGE + slab_elems(BN);
  extern __shared__ __align__(16) float smem[];
  const TileAt t = tile_at(a);
  const HaloStager<NTH, TW + 2, 0, NT == 8> halo(t.ty0 - 1, t.tx0 - 1, a.H, a.W);
  const uint32_t s0 = smem_u32(smem);
  StepCursor next;
  auto stage = [&](int buf) {
    if (next.part < a.in.nparts) {
      const uint32_t x_s = s0 + buf * STAGE * 4;
      halo.issue(x_s, sample_of(a.in, next.part, t.n, a.H, a.W), a.in.cin[next.part], next.c0);
      issue_slab<NTH, BN>(x_s + XSTAGE * 4,
                          a.wpk + static_cast<long long>(next.step) * slab_elems(BN));
      next.advance(a.in);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) stage(i);

  // Segment (h, row): output row `row`, columns 8 h .. 8 h + 7; a warp's
  // segments share h.
  const int cg = threadIdx.x % NT, seg = threadIdx.x / NT;
  const int row = seg % TH, h = seg / TH;
  float acc[kSeg][8] = {};
  for (int step = 0; step < a.in.steps; ++step) {
    cp_async_wait<S - 2>();
    __syncthreads();   // the step has landed; every thread is done with step - 1
    stage((step + S - 1) % S);
    const float* x_s = smem + step % S * STAGE;
    row_window_step<kSeg, BN, kHaloPlane, kPitch>(x_s + row * kPitch + kSeg * h,
                                                  x_s + XSTAGE + 4 * cg, acc);
  }
  const int y = t.ty0 + row;
  if (y >= a.H) return;
  const Epilogue ep(a.scale, a.bias, a.nbase + 4 * cg, BN / 2, a.cout);
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int x = t.tx0 + kSeg * h + j;
    if (x < a.W) store_pixel(a, ep, t.n, y, x, a.nbase + 4 * cg, BN / 2, acc[j]);
  }
}

template <int NT1, int NT2, int S>
__global__ void __launch_bounds__(pair_threads(NT1, NT2), NT1 == 4 && NT2 == 4 ? 3 : 1)
    conv3x3_pair_f32_kernel(const __grid_constant__ F32Pair a) {
  constexpr int BN1 = 8 * NT1, BN2 = 8 * NT2, NTH = pair_threads(NT1, NT2);
  constexpr int ISTAGE = BK * kWinPlane + slab_elems(BN1);
  extern __shared__ __align__(16) float smem[];
  float* mid_s = smem;                                  // [BN1][kWinPlane], after conv1
  float* w2_s = smem + pair_ring1(NT1, S);              // conv2's S slabs
  const F32Conv& c = a.c;
  const TileAt t = tile_at(c);
  const int H = c.H, W = c.W;
  const uint32_t s0 = smem_u32(smem), w2_0 = smem_u32(w2_s);
  const int steps2 = (a.cmid + BK - 1) / BK;
  auto stage2 = [&](int step) {
    if (step < steps2)
      issue_slab<NTH, BN2>(w2_0 + step % S * slab_elems(BN2) * 4,
                           c.wpk + static_cast<long long>(step) * slab_elems(BN2));
    cp_async_commit();
  };
  // conv2's first slabs load while conv1 runs.
#pragma unroll
  for (int i = 0; i < S - 1; ++i) stage2(i);

  // conv1 over the 16 x 18 mid, from the 18 x 20 input halo staged as two
  // windows a row (window h: input columns 9 h .. 9 h + 10); its ring takes
  // the mid's space until the mid is written.
  {
    const HaloStager<NTH, TW + 4, kSegMid, true> halo(t.ty0 - 2, t.tx0 - 2, H, W);
    StepCursor next;
    auto stage = [&](int buf) {
      if (next.part < c.in.nparts) {
        const uint32_t x_s = s0 + buf * ISTAGE * 4;
        halo.issue(x_s, sample_of(c.in, next.part, t.n, H, W), c.in.cin[next.part], next.c0);
        issue_slab<NTH, BN1>(x_s + BK * kWinPlane * 4,
                             a.w1 + static_cast<long long>(next.step) * slab_elems(BN1));
        next.advance(c.in);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < S - 1; ++i) stage(i);

    // Segment (mrow, h): mid row mrow, mid columns 9 h .. 9 h + 8.
    const bool active = threadIdx.x < 32 * NT1;
    const int cg = threadIdx.x % NT1, seg = threadIdx.x / NT1;
    const int mrow = seg / 2, h = seg % 2;
    float acc[kSegMid][8] = {};
    for (int step = 0; step < c.in.steps; ++step) {
      cp_async_wait<S - 2>();
      __syncthreads();
      stage((step + S - 1) % S);
      const float* x_s = smem + step % S * ISTAGE;
      if (active)
        row_window_step<kSegMid, BN1, kWinPlane, kWinPitch>(
            x_s + mrow * kWinPitch + h * kWin, x_s + BK * kWinPlane + 4 * cg, acc);
    }
    __syncthreads();   // the ring is used up: the mid takes its place

    // conv1's epilogue into the mid, transposed: a row per mid column, as two
    // windows (window v: mid rows 7 v .. 7 v + 8), zero at ring pixels
    // outside the image (conv2's padding) and past cmid.
    if (active) {
      const int y = t.ty0 - 1 + mrow;
      const Epilogue ep(a.scale1, a.bias1, 4 * cg, BN1 / 2, a.cmid);
#pragma unroll
      for (int j = 0; j < kSegMid; ++j) {
        const int m = kSegMid * h + j, x = t.tx0 - 1 + m;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        const float* add =
            a.add && inside
                ? a.add + ((static_cast<long long>(t.n) * 3 + add_row(y, H)) * W + x) * a.cmid
                : nullptr;
        float* dst = mid_s + m * kWinPitch;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ch = acc_channel(4 * cg, BN1 / 2, e);
          const float v =
              inside && ch < a.cmid
                  ? epilogue_value(acc[j][e], add ? add + ch : nullptr, ep.sc[e], ep.bi[e], 1)
                  : 0.f;
          if (mrow <= kSegOut + 1) dst[ch * kWinPlane + mrow] = v;
          if (mrow >= kSegOut) dst[ch * kWinPlane + kWin + mrow - kSegOut] = v;
        }
      }
    }
  }

  // conv2 over the resident mid: only w2's slabs stream in.  Segment (col,
  // v): output column col, rows 7 v .. 7 v + 6.
  {
    const bool active = threadIdx.x < 32 * NT2;
    const int cg = threadIdx.x % NT2, seg = threadIdx.x / NT2;
    const int col = seg / 2, v = seg % 2;
    float acc[kSegOut][8] = {};
    for (int step = 0; step < steps2; ++step) {
      cp_async_wait<S - 2>();
      __syncthreads();   // the mid is written; the slab has landed; step - 1 is done
      stage2(step + S - 1);
      if (active)
        column_window_step<kSegOut, BN2, kWinPlane, kWinPitch>(
            mid_s + step * BK * kWinPlane + col * kWinPitch + v * kWin,
            w2_s + step % S * slab_elems(BN2) + 4 * cg, acc);
    }
    const int x = t.tx0 + col;
    if (!active || x >= W) return;
    const Epilogue ep(c.scale, c.bias, 4 * cg, BN2 / 2, c.cout);
#pragma unroll
    for (int i = 0; i < kSegOut; ++i) {
      const int y = t.ty0 + kSegOut * v + i;
      if (y < H) store_pixel(c, ep, t.n, y, x, 4 * cg, BN2 / 2, acc[i]);
    }
  }
}

// The stages of each kernel's ring: G's mid at cmid = 64 leaves one block
// an SM, with room for three; at 32 two stages leave three blocks an SM.
constexpr int kStages = 3;
constexpr int kStagesPair44 = 2;

// Shared memory above 48 KB is an opt-in of each function on each device,
// and two or three blocks an SM need the largest shared-memory carveout.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Set once per device, at its first launch there.
cudaError_t opt_in(bool pair) {
  constexpr int kMaxDevices = 64;
  static bool done[2][kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && done[pair][device]) return cudaSuccess;
  constexpr int S = kStages, S44 = kStagesPair44;
  if (pair) {
    if ((err = allow_smem(conv3x3_pair_f32_kernel<8, 8, S>, pair_smem(8, 8, S))) ||
        (err = allow_smem(conv3x3_pair_f32_kernel<8, 4, S>, pair_smem(8, 4, S))) ||
        (err = allow_smem(conv3x3_pair_f32_kernel<4, 8, S>, pair_smem(4, 8, S))) ||
        (err = allow_smem(conv3x3_pair_f32_kernel<4, 4, S44>, pair_smem(4, 4, S44))))
      return err;
  } else if ((err = allow_smem(conv3x3_f32_kernel<8, kStages>, conv_smem(8, kStages))) ||
             (err = allow_smem(conv3x3_f32_kernel<4, kStages>, conv_smem(4, kStages)))) {
    return err;
  }
  if (device >= 0 && device < kMaxDevices) done[pair][device] = true;
  return cudaSuccess;
}

cudaError_t fill_in(F32In& in, const void* xs, const void* cins, int nparts) {
  if (nparts < 1 || nparts > kMaxParts) return cudaErrorInvalidValue;
  const void* const* xp = static_cast<const void* const*>(xs);
  const int* cp = static_cast<const int*>(cins);
  in.steps = 0;
  for (int q = 0; q < kMaxParts; ++q) {
    in.x[q] = q < nparts ? static_cast<const float*>(xp[q]) : nullptr;
    in.cin[q] = q < nparts ? cp[q] : 0;
    if (q < nparts && in.cin[q] < 1) return cudaErrorInvalidValue;
    in.steps += (in.cin[q] + BK - 1) / BK;
  }
  in.nparts = nparts;
  return cudaSuccess;
}

// The output and tile geometry of `a` (tiles of `rows` x TW), and the number
// of tiles; an error where they overflow the grid's first dimension.
cudaError_t fill_out(F32Conv& a, void* out, int B, int H, int W, int cout, int rows,
                     long long& ntiles) {
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.vec_out = cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.tile_rows = rows;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_per_image = a.tiles_x * ((H + rows - 1) / rows);
  ntiles = static_cast<long long>(B) * a.tiles_per_image;
  return ntiles > 0x7fffffff ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// As maunet_conv3x3_fused (conv3x3_fused.cu), on f32 parts, f32 weights in
// the f32 layout, and an f32 output.  Returns the launch's cudaError_t.
extern "C" int maunet_conv3x3_fused_f32(const void* xs, const void* wpk, const void* cins,
                                        int nparts, const void* add, const void* bias,
                                        void* out, int B, int H, int W, int cout, int relu,
                                        const void* scale, void* stream) {
  F32Conv a;
  cudaError_t err = fill_in(a.in, xs, cins, nparts);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reinterpret_cast<uintptr_t>(wpk) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  a.add = static_cast<const float*>(add);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.relu = relu;
  long long ntiles = 0;
  if ((err = fill_out(a, out, B, H, W, cout, TH, ntiles)) != cudaSuccess)
    return static_cast<int>(err);
  if (ntiles == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  if ((err = opt_in(false)) != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(ntiles);
  const float* slabs = static_cast<const float*>(wpk);
  for (int nbase = 0; nbase < cout; nbase += 64) {
    a.nbase = nbase;
    a.wpk = slabs;
    if (cout - nbase > 32) {
      conv3x3_f32_kernel<8, kStages>
          <<<grid, conv_threads(8), conv_smem(8, kStages), s>>>(a);
      slabs += static_cast<long long>(a.in.steps) * slab_elems(64);
    } else {
      conv3x3_f32_kernel<4, kStages>
          <<<grid, conv_threads(4), conv_smem(4, kStages), s>>>(a);
      slabs += static_cast<long long>(a.in.steps) * slab_elems(32);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// As maunet_conv3x3_pair (conv3x3_pair.cu), in f32: cmid and cout at most 64,
// both convs' weights in the f32 layout.  Returns the launch's cudaError_t.
extern "C" int maunet_conv3x3_pair_f32(const void* xs, const void* w1pk, const void* cins,
                                       int nparts, const void* w2pk, const void* add,
                                       const void* bias1, const void* bias2, void* out, int B,
                                       int H, int W, int cmid, int cout, const void* scale1,
                                       void* stream) {
  F32Pair a;
  cudaError_t err = fill_in(a.c.in, xs, cins, nparts);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cmid < 1 || cmid > 64 || cout < 1 || cout > 64 ||
      reinterpret_cast<uintptr_t>(w1pk) % 16 != 0 || reinterpret_cast<uintptr_t>(w2pk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.w1 = static_cast<const float*>(w1pk);
  a.add = static_cast<const float*>(add);
  a.scale1 = static_cast<const float*>(scale1);
  a.bias1 = static_cast<const float*>(bias1);
  a.cmid = cmid;
  a.c.wpk = static_cast<const float*>(w2pk);
  a.c.add = nullptr;
  a.c.scale = nullptr;
  a.c.bias = static_cast<const float*>(bias2);
  a.c.nbase = 0;
  a.c.relu = 1;
  long long ntiles = 0;
  if ((err = fill_out(a.c, out, B, H, W, cout, GTH, ntiles)) != cudaSuccess)
    return static_cast<int>(err);
  if (ntiles == 0) return static_cast<int>(cudaSuccess);
  if ((err = opt_in(true)) != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(ntiles);
  constexpr int S = kStages, S44 = kStagesPair44;
  if (cmid > 32 && cout > 32)
    conv3x3_pair_f32_kernel<8, 8, S><<<grid, pair_threads(8, 8), pair_smem(8, 8, S), s>>>(a);
  else if (cmid > 32)
    conv3x3_pair_f32_kernel<8, 4, S><<<grid, pair_threads(8, 4), pair_smem(8, 4, S), s>>>(a);
  else if (cout > 32)
    conv3x3_pair_f32_kernel<4, 8, S><<<grid, pair_threads(4, 8), pair_smem(4, 8, S), s>>>(a);
  else
    conv3x3_pair_f32_kernel<4, 4, S44>
        <<<grid, pair_threads(4, 4), pair_smem(4, 4, S44), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
