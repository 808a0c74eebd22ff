// Kernels A and G in f32: the fused 3x3 conv over a virtual channel concat of
// 1-5 NHWC f32 parts (out = relu?(sum_p conv(x_p, w_p) + add * scale + bias)),
// and a whole VGGBlock (two such convs with ReLU, the mid kept on chip).
//
// Replaces the TPU kernels maunet_tpu/ops/pallas/packed_vgg.py::
// packed_conv3x3_fused and ::packed_pair_fused where they run in f32: both
// compute in the parts' dtype and return it, and the JAX model sends its f32
// convs through them as it sends its bf16 ones.  conv3x3_fused.cu and
// conv3x3_pair.cu take bf16 on the tensor cores; TF32 wgmma would not compute
// what the TPU kernels compute in f32, so this file runs FFMA on the CUDA
// cores and rounds nothing between the products and the output (the mid of
// the pair included).
//
//   * the weights come prepared (ops/kernels/packed_vgg.prepare_conv3x3 with
//     dtype=torch.float32): f32, the BatchNorm scale folded in, and for each
//     output-channel tile (64 wide; a last or only tile of at most 32
//     channels is 32 wide) and each K step (one 16-channel slice of one part,
//     in part order) the weights as [tap][16 channels][tile width], zero past
//     cout and past cin_p, so a step's weights are one contiguous slab;
//   * `add` is the compact (B, 3, W, cout) f32 term of the broadcast
//     embeddings (rows {y = 0, interior, y = H - 1} of the parts' H: under
//     the spatial mesh axis that is the band with its halo rows, as the bf16
//     kernels take it), multiplied here by `scale`; `bias` is (cout,).  The
//     epilogue rounds as the plain version does: (sum + add * scale) + bias,
//     each product and sum rounded once (no fused multiply-add there).
//
// What bounds it on the H100: the f32 multiply-adds.  At the U-Net's level 0
// (B = 8, 256²) a conv of 23 to 192 input channels to 64 outputs does 38 to
// 108 multiply-adds (76 to 216 FLOP) per byte of device memory it must move,
// far above the 67 TFLOP/s / 3.35 TB/s = 20 FLOP per byte where the plain
// f32 units, not the memory, become the limit.  The design is the simple
// SIMT tiling:
//   * a block owns a 16 x 16 tile of output pixels of one sample and one
//     output-channel tile (BN = 64 or 32); ragged edges are masked, so any H
//     and W run;
//   * per K step it stages the tile's 18 x 18 halo of 16 channels (k-major,
//     zero outside the image and past cin_p) and the step's weight slab in
//     shared memory, then every thread multiplies: each of the 256 threads
//     keeps NP pixels x 8 channels in registers (NP = 8 at BN = 64, 4 at
//     BN = 32), reads one halo value per pixel and two float4 of weights per
//     tap and channel, and runs NP * 8 FFMA on them;
//   * lanes of a warp take neighbouring pixels (conflict-free halo reads) and
//     the BN / 8 channel groups (broadcast weight reads);
//   * one staging buffer, two barriers per K step; two blocks share an SM
//     (57,600 bytes of shared memory each) and hide each other's staging.
// The pair kernel runs conv1 over the tile's 18 x 18 mid pixels (the tile and
// its one-pixel ring) from a 20 x 20 input halo, writes the mid with its
// epilogue (add, scale1, bias1, ReLU; zero at ring pixels outside the image,
// conv2's zero padding, and past cmid) into shared memory in the halo layout
// conv2 reads, then runs conv2 over it with only w2's slabs streaming in:
// one launch, the mid never written to device memory, as JAX's pair kernel
// keeps it in VMEM.  Widths up to 64 (one output tile per conv).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxParts = 5;
constexpr int kThreads = 256;
constexpr int TH = 16, TW = 16;             // output tile
constexpr int BK = 16;                      // input channels per K step
constexpr int HW = TW + 2, HH = TH + 2;     // A's halo, and the pair's mid tile: 18 x 18
constexpr int HPIX = HW * HH;               // 324
constexpr int IW = TW + 4, IH = TH + 4;     // the pair's conv1 input halo: 20 x 20
constexpr int IPIX = IW * IH;               // 400

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
  int tiles_x, tiles_per_image;
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
constexpr int kSmemConv64 = (BK * HPIX + slab_elems(64)) * 4;   // 57,600 bytes
constexpr int kSmemConv32 = (BK * HPIX + slab_elems(32)) * 4;   // 39,168 bytes
// mid [64][HPIX], conv1's input halo [BK][IPIX], one weight slab at BN = 64
constexpr int kSmemPair = (64 * HPIX + BK * IPIX + slab_elems(64)) * 4;   // 145,408 bytes

// Pixel q of a tile of rows RW wide reads its 3 x 3 window at halo index
// q / RW * XW + q % RW (+ tap offset), in a halo XW wide.  Pixels past the
// tile (q >= NPIX) read pixel 0 and are discarded.
template <int NP, int PG, int NPIX, int RW, int XW>
__device__ __forceinline__ void window_bases(int pg, int (&base)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int q = pg + PG * j;
    base[j] = q < NPIX ? q / RW * XW + q % RW : 0;
  }
}

// acc[j][c] += all nine taps of one staged K step: x_s is [BK][XPIX] (a
// halo XW wide, k-major), w_s is [9][BK][BN].  Thread (pg, cg) owns pixels
// pg + PG * j and channels 8 cg .. 8 cg + 7.
template <int NP, int BN, int XW, int XPIX>
__device__ __forceinline__ void ffma_step(const float* x_s, const float* w_s,
                                          const int (&base)[NP], int cg,
                                          float (&acc)[NP][8]) {
#pragma unroll 2
  for (int k = 0; k < BK; ++k) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xk = x_s + k * XPIX + tap / 3 * XW + tap % 3;
      const float4 w0 = *reinterpret_cast<const float4*>(w_s + (tap * BK + k) * BN + cg * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(w_s + (tap * BK + k) * BN + cg * 8 + 4);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const float v = xk[base[j]];
        acc[j][0] = fmaf(v, w0.x, acc[j][0]);
        acc[j][1] = fmaf(v, w0.y, acc[j][1]);
        acc[j][2] = fmaf(v, w0.z, acc[j][2]);
        acc[j][3] = fmaf(v, w0.w, acc[j][3]);
        acc[j][4] = fmaf(v, w1.x, acc[j][4]);
        acc[j][5] = fmaf(v, w1.y, acc[j][5]);
        acc[j][6] = fmaf(v, w1.z, acc[j][6]);
        acc[j][7] = fmaf(v, w1.w, acc[j][7]);
      }
    }
  }
}

// Channels c0 .. c0 + BK - 1 of part x over a halo XW x XH whose top-left
// pixel is image pixel (y0, x0) of sample n, into x_s [BK][XW * XH]: zero
// outside the image and past cin.  Neighbouring threads read neighbouring
// channels of one pixel.
template <int XW, int XH>
__device__ __forceinline__ void stage_halo(float* x_s, const float* x, int cin, int c0, int n,
                                           int y0, int x0, int H, int W) {
  for (int idx = threadIdx.x; idx < XW * XH * BK; idx += kThreads) {
    const int p = idx / BK, k = idx % BK;
    const int y = y0 + p / XW, xx = x0 + p % XW;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W && c0 + k < cin)
      v = __ldg(x + ((static_cast<long long>(n) * H + y) * W + xx) * cin + c0 + k);
    x_s[k * XW * XH + p] = v;
  }
}

template <int BN>
__device__ __forceinline__ void stage_slab(float* w_s, const float* slab) {
  const float4* src = reinterpret_cast<const float4*>(slab);
  float4* dst = reinterpret_cast<float4*>(w_s);
  for (int i = threadIdx.x; i < slab_elems(BN) / 4; i += kThreads) dst[i] = __ldg(src + i);
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

// The output tile of acc into a.out: pixel pg + PG * j of the 16 x 16 tile at
// (ty0, tx0), channels a.nbase + 8 cg ...
template <int NP, int PG>
__device__ __forceinline__ void store_tile(const F32Conv& a, int n, int ty0, int tx0, int pg,
                                           int cg, const float (&acc)[NP][8]) {
  const int H = a.H, W = a.W, cout = a.cout;
  const int c0 = a.nbase + cg * 8;
  float sc[8], bi[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool real = c0 + c < cout;
    sc[c] = real && a.scale ? __ldg(a.scale + c0 + c) : 1.f;
    bi[c] = real && a.bias ? __ldg(a.bias + c0 + c) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int q = pg + PG * j;
    if (q >= TH * TW) continue;
    const int y = ty0 + q / TW, x = tx0 + q % TW;
    if (y >= H || x >= W) continue;
    const float* add = a.add ? a.add + ((static_cast<long long>(n) * 3 + add_row(y, H)) * W + x) *
                                           cout + c0
                             : nullptr;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = epilogue_value(acc[j][c], add && c0 + c < cout ? add + c : nullptr, sc[c], bi[c],
                            a.relu);
    float* o = a.out + ((static_cast<long long>(n) * H + y) * W + x) * cout + c0;
    if (a.vec_out && c0 + 8 <= cout) {
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < cout) o[c] = v[c];
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
  t.ty0 = r / a.tiles_x * TH;
  t.tx0 = r % a.tiles_x * TW;
  return t;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_f32_kernel(const __grid_constant__ F32Conv a) {
  constexpr int BN = NT * 8, CG = NT, PG = kThreads / CG, NP = TH * TW / PG;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                 // [BK][HPIX]
  float* w_s = smem + BK * HPIX;     // [9][BK][BN]
  const int cg = threadIdx.x % CG, pg = threadIdx.x / CG;
  const TileAt t = tile_at(a);
  int base[NP];
  window_bases<NP, PG, TH * TW, TW, HW>(pg, base);
  float acc[NP][8] = {};
  int step = 0;
  for (int p = 0; p < a.in.nparts; ++p) {
    const int cin = a.in.cin[p];
    for (int c0 = 0; c0 < cin; c0 += BK, ++step) {
      __syncthreads();   // every thread is done with the previous step
      stage_halo<HW, HH>(x_s, a.in.x[p], cin, c0, t.n, t.ty0 - 1, t.tx0 - 1, a.H, a.W);
      stage_slab<BN>(w_s, a.wpk + static_cast<long long>(step) * slab_elems(BN));
      __syncthreads();
      ffma_step<NP, BN, HW, HPIX>(x_s, w_s, base, cg, acc);
    }
  }
  store_tile<NP, PG>(a, t.n, t.ty0, t.tx0, pg, cg, acc);
}

template <int NT1, int NT2>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_pair_f32_kernel(const __grid_constant__ F32Pair a) {
  constexpr int BN1 = NT1 * 8, PG1 = kThreads / NT1, NP1 = (HPIX + PG1 - 1) / PG1;
  constexpr int BN2 = NT2 * 8, PG2 = kThreads / NT2, NP2 = TH * TW / PG2;
  extern __shared__ __align__(16) float smem[];
  float* mid_s = smem;                  // [64][HPIX]: the mid tile with its ring, k-major
  float* x_s = smem + 64 * HPIX;        // [BK][IPIX]
  float* w_s = x_s + BK * IPIX;         // [9][BK][64]
  const F32Conv& c = a.c;
  const TileAt t = tile_at(c);
  const int H = c.H, W = c.W;

  // conv1 over the 18 x 18 mid pixels, from the 20 x 20 input halo.
  {
    const int cg = threadIdx.x % NT1, pg = threadIdx.x / NT1;
    int base[NP1];
    window_bases<NP1, PG1, HPIX, HW, IW>(pg, base);
    float acc[NP1][8] = {};
    int step = 0;
    for (int p = 0; p < c.in.nparts; ++p) {
      const int cin = c.in.cin[p];
      for (int c0 = 0; c0 < cin; c0 += BK, ++step) {
        __syncthreads();
        stage_halo<IW, IH>(x_s, c.in.x[p], cin, c0, t.n, t.ty0 - 2, t.tx0 - 2, H, W);
        stage_slab<BN1>(w_s, a.w1 + static_cast<long long>(step) * slab_elems(BN1));
        __syncthreads();
        ffma_step<NP1, BN1, IW, IPIX>(x_s, w_s, base, cg, acc);
      }
    }
    // conv1's epilogue into mid: zero at ring pixels outside the image
    // (conv2's padding) and past cmid.
    const int m0 = cg * 8;
    float sc[8], bi[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool real = m0 + k < a.cmid;
      sc[k] = real && a.scale1 ? __ldg(a.scale1 + m0 + k) : 1.f;
      bi[k] = real && a.bias1 ? __ldg(a.bias1 + m0 + k) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NP1; ++j) {
      const int q = pg + PG1 * j;
      if (q >= HPIX) continue;
      const int y = t.ty0 - 1 + q / HW, x = t.tx0 - 1 + q % HW;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const float* add =
          a.add && inside
              ? a.add + ((static_cast<long long>(t.n) * 3 + add_row(y, H)) * W + x) * a.cmid + m0
              : nullptr;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool real = m0 + k < a.cmid;
        const float v = epilogue_value(acc[j][k], add && real ? add + k : nullptr, sc[k], bi[k], 1);
        mid_s[(m0 + k) * HPIX + q] = inside && real ? v : 0.f;
      }
    }
  }

  // conv2 over the resident mid: only w2's slabs stream in.
  {
    const int cg = threadIdx.x % NT2, pg = threadIdx.x / NT2;
    int base[NP2];
    window_bases<NP2, PG2, TH * TW, TW, HW>(pg, base);
    float acc[NP2][8] = {};
    for (int step = 0, k0 = 0; k0 < a.cmid; k0 += BK, ++step) {
      __syncthreads();   // mid is written; the previous slab is used up
      stage_slab<BN2>(w_s, c.wpk + static_cast<long long>(step) * slab_elems(BN2));
      __syncthreads();
      ffma_step<NP2, BN2, HW, HPIX>(mid_s + k0 * HPIX, w_s, base, cg, acc);
    }
    store_tile<NP2, PG2>(c, t.n, t.ty0, t.tx0, pg, cg, acc);
  }
}

// Shared memory above 48 KB is an opt-in of each function on each device:
// set once per device, at its first launch there.
cudaError_t opt_in(bool pair) {
  constexpr int kMaxDevices = 64;
  static bool done[2][kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && done[pair][device]) return cudaSuccess;
  constexpr auto kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (pair) {
    if ((err = cudaFuncSetAttribute(conv3x3_pair_f32_kernel<8, 8>, kAttr, kSmemPair)) ||
        (err = cudaFuncSetAttribute(conv3x3_pair_f32_kernel<8, 4>, kAttr, kSmemPair)) ||
        (err = cudaFuncSetAttribute(conv3x3_pair_f32_kernel<4, 8>, kAttr, kSmemPair)) ||
        (err = cudaFuncSetAttribute(conv3x3_pair_f32_kernel<4, 4>, kAttr, kSmemPair)))
      return err;
  } else if ((err = cudaFuncSetAttribute(conv3x3_f32_kernel<8>, kAttr, kSmemConv64))) {
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

// The output and tile geometry of `a`, and the number of tiles; an error
// where they overflow the grid's first dimension.
cudaError_t fill_out(F32Conv& a, void* out, int B, int H, int W, int cout, long long& ntiles) {
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.vec_out = cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_per_image = a.tiles_x * ((H + TH - 1) / TH);
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
  if ((err = fill_out(a, out, B, H, W, cout, ntiles)) != cudaSuccess) return static_cast<int>(err);
  if (ntiles == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  if ((err = opt_in(false)) != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* slabs = static_cast<const float*>(wpk);
  for (int nbase = 0; nbase < cout; nbase += 64) {
    a.nbase = nbase;
    a.wpk = slabs;
    if (cout - nbase > 32) {
      conv3x3_f32_kernel<8><<<static_cast<unsigned>(ntiles), kThreads, kSmemConv64, s>>>(a);
      slabs += static_cast<long long>(a.in.steps) * slab_elems(64);
    } else {
      conv3x3_f32_kernel<4><<<static_cast<unsigned>(ntiles), kThreads, kSmemConv32, s>>>(a);
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
  if ((err = fill_out(a.c, out, B, H, W, cout, ntiles)) != cudaSuccess)
    return static_cast<int>(err);
  if (ntiles == 0) return static_cast<int>(cudaSuccess);
  if ((err = opt_in(true)) != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(ntiles);
  if (cmid > 32 && cout > 32)
    conv3x3_pair_f32_kernel<8, 8><<<grid, kThreads, kSmemPair, s>>>(a);
  else if (cmid > 32)
    conv3x3_pair_f32_kernel<8, 4><<<grid, kThreads, kSmemPair, s>>>(a);
  else if (cout > 32)
    conv3x3_pair_f32_kernel<4, 8><<<grid, kThreads, kSmemPair, s>>>(a);
  else
    conv3x3_pair_f32_kernel<4, 4><<<grid, kThreads, kSmemPair, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
