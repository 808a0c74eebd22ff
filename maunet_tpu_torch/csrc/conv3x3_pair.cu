// A whole VGGBlock in one launch: conv1 (3x3 SAME over a virtual concat of
// 1-5 NHWC bf16 parts, + add * scale1 + bias1, ReLU) -> mid in bf16 -> conv2
// (3x3 SAME, + bias2, ReLU) -> out in bf16.  The mid activation never reaches
// device memory.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/packed_vgg.py::
// packed_pair_fused (body `_make_pair_kernel`).  That kernel walks row blocks
// of a lane-packed image and recomputes two overlap rows of conv1 per block;
// lane packing is not carried over.  Here, on plain NHWC tensors:
//   * both convs' weights come prepared (ops/kernels/packed_vgg.
//     prepare_conv3x3, the layout of conv3x3_fused.cu: bf16 with the
//     BatchNorm scale folded in, wgmma's core matrices, one output-channel
//     tile each, since cmid and cout are at most 64); `add` is conv1's compact
//     (B, 3, W, cmid) f32 term of the broadcast embeddings (rows {y = 0,
//     interior, y = H - 1}), multiplied here by scale1; the biases are f32;
//   * mid is rounded to bf16 before conv2, as the TPU kernel rounds it
//     (packed_vgg.py:359-360), so the result equals two chained
//     conv3x3_fused launches up to the order of the f32 sums.
//
// What bounds it on the H100: the tensor cores and how they are fed, as for
// conv3x3_fused (at 64 -> 64 -> 64 a 16 x 16 tile does 2 x 256 x 64 x 576
// multiply-adds, 19 million, on a 51 KB input halo); what the pair saves over two launches
// is the mid tensor's write and read, 2 * B*H*W*cmid*2 bytes, and what it pays
// is conv1 on mid's one-pixel ring.  It runs A's loop (conv_tile.cuh):
//   * a block owns a 16 x 16 output tile.  conv1 runs over the tile's mid
//     with its ring, 18 x 18 = 324 pixels, from a 20 x 20 input halo staged
//     once per 32-channel slice: the 324 pixels are the rows of six m64
//     products, three per warpgroup (384 rows, 1.5x the tile's own 256: a
//     larger tile does not fit shared memory beside mid), and each lane
//     points ldmatrix at its row's pixel, so a tap is one address offset as
//     in A;
//   * conv1's epilogue adds `add` (its row chosen by the pixel's image row),
//     scale1 and bias1, applies ReLU, zeroes ring pixels outside the image
//     (conv2's zero padding) and channels past cmid, and stores bf16 into
//     shared memory in exactly A's halo layout, 324 rows at the 80-byte
//     stride, one slab per 32 channels;
//   * conv2 is then A's mma_stage with that resident mid tile as its halo;
//     only conv2's weights stream through the ring, as one stage of all its
//     K slices, and A's epilogue writes the output;
//   * the ring of conv_tile.cuh runs on across a tile's conv1 slices, its
//     conv2 stage and the next tile: blocks are persistent, one per SM (two
//     stages of 73,728 bytes at 64 channels, three of 50,432 at 32, beside
//     mid), so a tile's epilogues overlap the next tile's copies in flight.
#include "conv_tile.cuh"

namespace {

constexpr int MW = TW + 2;                 // mid tile with its ring: 18 x 18 = HPIX
constexpr int IH = TH + 4, IW = TW + 4;    // conv1's input halo: 20 x 20
using InHalo = HaloShape<IW, IH>;
constexpr int kMidSlab = kHaloElems;       // one 32-channel slice of mid, in A's halo layout
constexpr int kMidRows = 3;                // conv1's m64 products per warpgroup: 384 >= HPIX rows

static_assert(2 * kMidRows * 64 >= HPIX, "conv1's products must cover the mid tile");

// A ring stage: a conv1 K step (the input halo and one slab of w1) or the
// conv2 stage (every slab of w2, one per 32 channels of mid).
template <int NT1, int NT2>
__host__ __device__ constexpr int pair_stage_elems() {
  return InHalo::kElems + weight_slab_elems(NT1 * 8) > NT1 / 4 * weight_slab_elems(NT2 * 8)
             ? InHalo::kElems + weight_slab_elems(NT1 * 8)
             : NT1 / 4 * weight_slab_elems(NT2 * 8);
}

template <int NT1, int NT2, int NSTAGES>
__host__ __device__ constexpr int pair_smem_bytes() {
  return (NSTAGES * pair_stage_elems<NT1, NT2>() + NT1 / 4 * kMidSlab + kWarps * 8 * NT2 * 8) * 2 +
         (2 * NT1 * 8 + 2 * NT2 * 8) * 4;
}

struct PairArgs {
  ConvArgs c;            // conv1's parts, and conv2: wpk (its weights), bias, out, tiles
  const uint16_t* w1;    // conv1's prepared weights
  const float* add;      // (B, 3, W, cmid) or null
  const float* scale1;   // (cmid,), multiplies add; or null
  const float* bias1;    // (cmid,) or null
  int cmid;
};

// The mid pixel that row `p` of conv1's products computes: row 64 q + 16 i + r
// of product q = 3 * warpgroup + mt, warp i of the warpgroup, is pixel p.
__device__ __forceinline__ int mid_row(int warp, int mt, int r) {
  return ((warp >> 2) * kMidRows + mt) * 64 + (warp & 3) * 16 + r;
}

// acc += all nine taps of one staged slice of conv1 over the mid tile.  Lane l
// points ldmatrix at mid pixel mid_row(warp, mt, l % 16) in the 20 x 20 halo;
// rows past the mid tile read pixel 0 and are discarded.  Otherwise as
// mma_stage: a tap's products are in flight while the next tap's fragments
// load into the other register set.
template <int NT>
__device__ __forceinline__ void mma_mid(uint32_t halo_s, uint32_t w_s, int warp, int lane,
                                        float (&acc)[kMidRows][NT][4]) {
  constexpr int BN = NT * 8;
  uint32_t a_lane[kMidRows];
#pragma unroll
  for (int mt = 0; mt < kMidRows; ++mt) {
    const int p = mid_row(warp, mt, lane & 15);
    const int m = p < HPIX ? p : 0;
    a_lane[mt] = ((m / MW * IW + m % MW) * LDS + (lane >> 4) * 8) * 2;
  }
  uint32_t af[2][kMidRows][2][4];   // [tap parity][mt][k16 step]
  auto load_a = [&](int tap) {
#pragma unroll
    for (int mt = 0; mt < kMidRows; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(af[tap & 1][mt][ks],
                    halo_s + a_lane[mt] + ((tap / 3 * IW + tap % 3) * LDS + ks * 16) * 2);
  };
  load_a(0);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < kMidRows; ++mt)
        wgmma_bf16(acc[mt], af[tap & 1][mt][ks],
                   core_matrix_desc(w_s + (tap * 2 + ks) * BN * 32));
    wgmma_commit();
    if (tap + 1 < 9) load_a(tap + 1);
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < kMidRows; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[tap & 1][mt][ks][i]) :: "memory");
  }
}

// conv1's epilogue into mid: + add * scale1 + bias1, ReLU, bf16; zero at ring
// pixels outside the image and (through the weights and bias1) past cmid.
// Element e of product (mt, nt) is row g + 8 (e / 2) of the warp's 16 and
// channel nt * 8 + 2 t4 + e % 2.
template <int NT>
__device__ __forceinline__ void mid_epilogue(const PairArgs& a, const TilePos& t, int warp,
                                             int lane, const float (&acc)[kMidRows][NT][4],
                                             uint16_t* mid, const float* scale_s,
                                             const float* bias_s) {
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.c.H, W = a.c.W;
#pragma unroll
  for (int mt = 0; mt < kMidRows; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mid_row(warp, mt, half * 8 + g);
      if (p >= HPIX) continue;
      const int y = t.ty0 - 1 + p / MW, x = t.tx0 - 1 + p % MW;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const int sel = y == 0 ? 0 : (y == H - 1 ? 2 : 1);
      const float* add_row =
          a.add && inside ? a.add + ((static_cast<long long>(t.n) * 3 + sel) * W + x) * a.cmid
                          : nullptr;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + t4 * 2;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = acc[mt][nt][half * 2 + e];
          if (add_row && c + e < a.cmid) s += __ldg(add_row + c + e) * scale_s[c + e];
          s += bias_s[c + e];
          val[e] = inside ? fmaxf(s, 0.f) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(mid + c / BK * kMidSlab + p * LDS + c % BK) =
            __floats2bfloat162_rn(val[0], val[1]);
      }
    }
  }
}

template <int NT1, int NT2, int NSTAGES>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_pair_kernel(const __grid_constant__ PairArgs a) {
  constexpr int BN1 = NT1 * 8, BN2 = NT2 * 8;
  constexpr int S2 = BN1 / BK;   // conv2's K steps: mid's 32-channel slabs
  constexpr int kStage = pair_stage_elems<NT1, NT2>();
  // [NSTAGES][stage], mid [S2][HPIX][LDS], then for A's epilogue
  // [kWarps][8][BN2] bf16, and scale1, bias1 [BN1], scale2 (ones), bias2 [BN2] f32
  extern __shared__ __align__(128) uint16_t smem[];
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint16_t* mid = smem + NSTAGES * kStage;
  const uint32_t mid_s = smem_s + NSTAGES * kStage * 2;
  uint16_t* out_stage = mid + S2 * kMidSlab;
  float* scale1_s = reinterpret_cast<float*>(out_stage + kWarps * 8 * BN2);
  float* bias1_s = scale1_s + BN1;
  float* scale2_s = bias1_s + BN1;
  float* bias2_s = scale2_s + BN2;
  for (int i = threadIdx.x; i < BN1; i += kThreads) {
    const bool real = i < a.cmid;
    scale1_s[i] = real && a.scale1 ? a.scale1[i] : 1.f;
    bias1_s[i] = real && a.bias1 ? a.bias1[i] : 0.f;
  }
  for (int i = threadIdx.x; i < BN2; i += kThreads) {
    scale2_s[i] = 1.f;
    bias2_s[i] = i < a.c.cout && a.c.bias ? a.c.bias[i] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.c.H, W = a.c.W;
  const int s1 = a.c.in.steps;
  const int per_tile = s1 + 1;
  const int my_tiles = (a.c.ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * per_tile;

  // The producer's cursor: stage `issued` is step `p_step` of tile `p_tile`,
  // a conv1 K step (part `p_part`, channels `p_c0` ...) for p_step < s1, else
  // the conv2 stage.
  int issued = 0, p_tile = blockIdx.x, p_step = 0, p_part = 0, p_c0 = 0;
  uint32_t pairs[InHalo::kPairIters];

  auto start_stage = [&]() {
    const uint32_t buf = smem_s + (issued % NSTAGES) * kStage * 2;
    if (p_step == s1) {
      for (int idx = threadIdx.x; idx < S2 * weight_slab_elems(BN2) / 8; idx += kThreads)
        cp_async16(buf + idx * 16, a.c.wpk + idx * 8, 16);
      return false;
    }
    const TilePos t = tile_pos(a.c, p_tile);
    StageCopy s;
    s.x = a.c.in.x[p_part];
    s.slab = a.w1 + static_cast<long long>(p_step) * weight_slab_elems(BN1);
    s.halo_s = buf;
    s.w_s = buf + InHalo::kElems * 2;
    s.cin = a.c.in.cin[p_part];
    s.c0 = p_c0;
    s.n = t.n;
    s.ty0 = t.ty0 - 1;   // the input halo starts two pixels above and left of the tile
    s.tx0 = t.tx0 - 1;
    s.halo = a.c.in.vec[p_part] != 0;
    stage_async<BN1, IW, IH>(s, H, W);
    if (!s.halo) halo_load_pairs<IW, IH>(pairs, s.x, s.cin, s.c0, s.n, s.ty0, s.tx0, H, W);
    return !s.halo;
  };
  auto finish_stage = [&](bool stored_pairs) {
    if (stored_pairs) halo_store_pairs<IW, IH>(smem + (issued % NSTAGES) * kStage, pairs);
    ++issued;
    if (p_step < s1) {
      p_c0 += BK;
      if (p_c0 >= a.c.in.cin[p_part]) {
        p_c0 = 0;
        ++p_part;
      }
    }
    if (++p_step == per_tile) {
      p_step = p_part = p_c0 = 0;
      p_tile += gridDim.x;
    }
  };

  for (int j = 0; j < NSTAGES - 1; ++j) {
    if (issued < total) finish_stage(start_stage());
    cp_async_commit();
  }

  // Stage `it` has landed (this thread's copies, then everyone's), and every
  // warp is done with stage it - 1, whose buffer is refilled now, and with
  // what the previous epilogue read of mid.  Returns stage `it`'s buffer.
  int it = 0;
  bool more = false, stored_pairs = false;
  auto begin_stage = [&]() {
    cp_async_wait<NSTAGES - 2>();
    // wgmma reads shared memory through the async proxy: order this thread's
    // copies and stores before it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    more = issued < total;
    stored_pairs = more && start_stage();
    cp_async_commit();
    return smem_s + (it % NSTAGES) * kStage * 2;
  };
  auto end_stage = [&]() {
    if (more) finish_stage(stored_pairs);
    ++it;
  };

  for (int tile = blockIdx.x; tile < a.c.ntiles; tile += gridDim.x) {
    const TilePos t = tile_pos(a.c, tile);
    {
      float acc[kMidRows][NT1][4] = {};
      for (int k = 0; k < s1; ++k) {
        const uint32_t buf = begin_stage();
        mma_mid<NT1>(buf, buf + InHalo::kElems * 2, warp, lane, acc);
        end_stage();
      }
      mid_epilogue<NT1>(a, t, warp, lane, acc, mid, scale1_s, bias1_s);
    }
    // The conv2 stage; its barrier also puts every warp's mid before the reads.
    const uint32_t buf = begin_stage();
    float acc[2][NT2][4] = {};
#pragma unroll
    for (int k = 0; k < S2; ++k)
      mma_stage<NT2>(mid_s + k * kMidSlab * 2, buf + k * weight_slab_elems(BN2) * 2, warp, lane,
                     acc);
    end_stage();
    epilogue<NT2>(a.c, t, warp, lane, acc, out_stage + warp * 8 * BN2, scale2_s, bias2_s);
  }
}

constexpr int kSmem88 = pair_smem_bytes<8, 8, 2>();   // 208,000 bytes
constexpr int kSmem84 = pair_smem_bytes<8, 4, 2>();
constexpr int kSmem48 = pair_smem_bytes<4, 8, 3>();
constexpr int kSmem44 = pair_smem_bytes<4, 4, 3>();   // 181,568 bytes
static_assert(kSmem88 <= 232448 && kSmem84 <= 232448 && kSmem48 <= 232448 && kSmem44 <= 232448,
              "the ring and mid must fit the 227 KB opt-in");

// The shared-memory opt-in is a property of the function on one device, and
// the SM count one of the device: both are looked up at the first launch there.
cudaError_t pair_device_sms(int& sms) {
  constexpr int kMaxDevices = 64;
  static int known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && known[device] > 0) {
    sms = known[device];
    return cudaSuccess;
  }
  constexpr auto kAttr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(conv3x3_pair_kernel<8, 8, 2>, kAttr, kSmem88)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(conv3x3_pair_kernel<8, 4, 2>, kAttr, kSmem84)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(conv3x3_pair_kernel<4, 8, 3>, kAttr, kSmem48)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(conv3x3_pair_kernel<4, 4, 3>, kAttr, kSmem44)) != cudaSuccess)
    return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) known[device] = sms;
  return cudaSuccess;
}

}  // namespace

// xs: host array of `nparts` device pointers; cins: host array of ints; w1pk,
// w2pk: the two convs' prepared weights (one output-channel tile each: cmid
// and cout are at most 64); scale1: the factor of `add`.  Returns the
// launch's cudaError_t.
extern "C" int maunet_conv3x3_pair(const void* xs, const void* w1pk, const void* cins,
                                   int nparts, const void* w2pk, const void* add,
                                   const void* bias1, const void* bias2, void* out, int B,
                                   int H, int W, int cmid, int cout, const void* scale1,
                                   void* stream) {
  PairArgs a;
  cudaError_t err = fill_tile_in(a.c.in, xs, cins, nparts);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cmid < 1 || cmid > 64 || cout < 1 || cout > 64 ||
      reinterpret_cast<uintptr_t>(w1pk) % 16 != 0 || reinterpret_cast<uintptr_t>(w2pk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.w1 = static_cast<const uint16_t*>(w1pk);
  a.add = static_cast<const float*>(add);
  a.scale1 = static_cast<const float*>(scale1);
  a.bias1 = static_cast<const float*>(bias1);
  a.cmid = cmid;
  a.c.wpk = static_cast<const uint16_t*>(w2pk);
  a.c.add = nullptr;
  a.c.scale = nullptr;
  a.c.bias = static_cast<const float*>(bias2);
  a.c.out = static_cast<__nv_bfloat16*>(out);
  a.c.H = H;
  a.c.W = W;
  a.c.cout = cout;
  a.c.nbase = 0;
  a.c.relu = 1;
  a.c.vec_out = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.c.tiles_x = (W + TW - 1) / TW;
  a.c.tiles_per_image = a.c.tiles_x * ((H + TH - 1) / TH);
  const long long ntiles = static_cast<long long>(B) * a.c.tiles_per_image;
  if (ntiles == 0) return static_cast<int>(cudaSuccess);
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.c.ntiles = static_cast<int>(ntiles);
  int sms = 0;
  err = pair_device_sms(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(a.c.ntiles < sms ? a.c.ntiles : sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cmid > 32 && cout > 32)
    conv3x3_pair_kernel<8, 8, 2><<<grid, kThreads, kSmem88, s>>>(a);
  else if (cmid > 32)
    conv3x3_pair_kernel<8, 4, 2><<<grid, kThreads, kSmem84, s>>>(a);
  else if (cout > 32)
    conv3x3_pair_kernel<4, 8, 3><<<grid, kThreads, kSmem48, s>>>(a);
  else
    conv3x3_pair_kernel<4, 4, 3><<<grid, kThreads, kSmem44, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
