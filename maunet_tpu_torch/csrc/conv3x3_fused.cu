// 3x3 SAME convolution over a virtual channel concat of 1-5 NHWC parts, with
// a fused epilogue: out = relu?(sum_p conv(x_p, w_p) + add * scale + bias), in
// bf16.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/packed_vgg.py::
// packed_conv3x3_fused (body `_make_kernel` / `_conv_from_xh`).  The TPU
// kernel packs narrow channels into the 128-wide lanes of its matrix unit;
// that layout device is not carried over.  This kernel computes the same
// contraction on plain NHWC tensors:
//   * the weights come prepared (ops/kernels/packed_vgg.prepare_conv3x3):
//     bf16 with the BatchNorm scale folded in, and for each output-channel
//     tile (64 wide; a last or only tile of at most 32 channels is 32 wide)
//     and each K step (one 32-channel slice of one part, in part order) the
//     nine taps' weights as wgmma's core matrices,
//     [tap][k16 step][BN / 8][2][8 rows][8 channels], zero past cout and past
//     cin_p, so a step's weights are one contiguous slab;
//   * `add` is the compact (B, 3, W, cout) f32 term of the broadcast
//     embeddings (rows {y = 0, interior, y = H - 1}), multiplied here by the
//     f32 `scale`; `bias` is (cout,) f32.  All parts accumulate into one f32
//     sum, rounded once to bf16.
//
// What bounds it on the H100: at the U-Net's level-0 row K = 9 * cin reaches
// 1,728 for a 64-wide output, about 100 FLOPs per byte of device memory, so
// the wide convs are bound by the tensor cores and by how they are fed; the
// 23- and 32-channel convs move more bytes than they compute (their output
// is two to three times their input) and are bound by device memory.  The
// design (conv_tile.cuh has the main loop):
//   * a block owns a 16 x 16 tile of output pixels of one sample and one
//     output-channel tile; ragged edges are masked, so any H and W run.  Per
//     K step it stages the 18 x 18 halo once and runs all nine taps from it,
//     where the first version of this kernel fetched every operand once per
//     tap: operand traffic into the SM falls about sevenfold;
//   * the stages form a ring in dynamic shared memory filled by cp.async
//     (three stages of 62,784 bytes at BN = 64, four of 44,352 at BN = 32),
//     one barrier per stage;
//   * blocks are persistent: one per SM walks tiles blockIdx.x, + gridDim.x,
//     ..., and the ring runs on across tile boundaries, so a tile's epilogue
//     and the next tile's first products overlap copies already in flight.
//     A conv with one or two K steps per tile (cin 23 to 64) would otherwise
//     have nothing to overlap;
//   * the product is wgmma with A from registers and B from shared memory
//     (conv_tile.cuh says why), 36 ldmatrix.x4 per warp and stage where
//     mma.sync needed 108;
//   * a 32-wide instantiation, so cout <= 32 runs half the products;
//   * the epilogue reads scale and bias from shared memory and passes each
//     warp's values through shared memory into 16-byte stores of whole
//     128-byte lines.  (Reading bias from device memory inside the epilogue,
//     as the first version did, cost more than every store: 0.25 ms of a
//     0.58 ms launch at (16, 256, 256, 64) -> 64.)
//
// Tried on the H100 and set aside (times in PERF.md): the same loop
// on mma.sync.m16n8k16 with ldmatrix for both operands (as fast at BN = 32
// and with one K step, 5-12% slower at BN = 64 with two or more); two stages
// for three at BN = 64, three for four at BN = 32 (no change: the ring is
// deep enough); 16-channel stages with five- and six-stage rings (slower:
// twice the barriers); two blocks per SM, at BN = 32 with two stages or for
// both widths with 16-channel stages (5-10% faster on sums of launches, but
// 128 registers per thread spill and the ring shrinks to two stages);
// fragment-layout 4-byte stores in the epilogue (slower at B = 16); a
// stage's copies issued two per thread after each tap's products instead of
// in one burst before them (5-10% slower, and it spills).  What still holds
// it back: the block's phases (issue copies, multiply, epilogue) run one
// after the other on the same eight warps.  A producer warp that only
// copies (or TMA), with the products in warpgroups of their own, is the next
// step.
#include "conv_tile.cuh"

namespace {

template <int NT, int NSTAGES>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fused_kernel(const __grid_constant__ ConvArgs a) {
  constexpr int BN = NT * 8;
  constexpr int kStage = stage_elems(BN);
  // [NSTAGES][halo | weights], then for the epilogue [kWarps][8][BN] bf16 and
  // the tile's scale and bias, [2][BN] f32
  extern __shared__ __align__(128) uint16_t smem[];
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  uint16_t* out_stage = smem + NSTAGES * kStage;
  float* scale_s = reinterpret_cast<float*>(out_stage + kWarps * 8 * BN);
  float* bias_s = scale_s + BN;
  for (int i = threadIdx.x; i < BN; i += kThreads) {
    const bool real = a.nbase + i < a.cout;
    scale_s[i] = real && a.scale ? a.scale[a.nbase + i] : 1.f;
    bias_s[i] = real && a.bias ? a.bias[a.nbase + i] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.H, W = a.W;
  const int steps = a.in.steps;
  const int my_tiles = (a.ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * steps;

  // The producer's cursor: stage `issued` is K step `p_step` (part `p_part`,
  // channels `p_c0` ...) of tile `p_tile`.
  int issued = 0, p_tile = blockIdx.x, p_step = 0, p_part = 0, p_c0 = 0;
  uint32_t pairs[kPairIters];

  // Start the producer's stage: its asynchronous copies and, for a part that
  // cannot take 16-byte copies, its halo read into `pairs`.
  auto start_stage = [&]() {
    StageCopy s;
    const TilePos t = tile_pos(a, p_tile);
    s.x = a.in.x[p_part];
    s.slab = a.wpk + static_cast<long long>(p_step) * weight_slab_elems(BN);
    s.halo_s = smem_s + (issued % NSTAGES) * kStage * 2;
    s.w_s = s.halo_s + kHaloElems * 2;
    s.cin = a.in.cin[p_part];
    s.c0 = p_c0;
    s.n = t.n;
    s.ty0 = t.ty0;
    s.tx0 = t.tx0;
    s.halo = a.in.vec[p_part] != 0;
    stage_async<BN>(s, H, W);
    if (!s.halo) halo_load_pairs(pairs, s.x, s.cin, s.c0, s.n, s.ty0, s.tx0, H, W);
    return !s.halo;
  };
  auto finish_stage = [&](bool stored_pairs) {
    if (stored_pairs) halo_store_pairs(smem + (issued % NSTAGES) * kStage, pairs);
    ++issued;
    p_c0 += BK;
    if (p_c0 >= a.in.cin[p_part]) {
      p_c0 = 0;
      ++p_part;
    }
    if (++p_step == steps) {
      p_step = p_part = 0;
      p_tile += gridDim.x;
    }
  };

  for (int j = 0; j < NSTAGES - 1; ++j) {
    if (issued < total) finish_stage(start_stage());
    cp_async_commit();
  }

  float acc[2][NT][4] = {};
  int c_tile = blockIdx.x, c_step = 0;
  for (int it = 0; it < total; ++it) {
    // Stage `it` has landed (this thread's copies, then everyone's), and
    // every warp is done with stage it - 1, whose buffer is refilled now.
    cp_async_wait<NSTAGES - 2>();
    // wgmma reads shared memory through the async proxy: order this thread's
    // copies and stores before it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const bool more = issued < total;
    const bool stored_pairs = more && start_stage();
    cp_async_commit();

    const uint32_t halo_s = smem_s + (it % NSTAGES) * kStage * 2;
    mma_stage<NT>(halo_s, halo_s + kHaloElems * 2, warp, lane, acc);

    if (more) finish_stage(stored_pairs);
    if (++c_step == steps) {
      epilogue<NT>(a, tile_pos(a, c_tile), warp, lane, acc, out_stage + warp * 8 * BN,
                   scale_s, bias_s);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      c_step = 0;
      c_tile += gridDim.x;
    }
  }
}

constexpr int kStages64 = 3, kStages32 = 4;
constexpr int smem_bytes(int bn, int stages) {
  return (stages * stage_elems(bn) + kWarps * 8 * bn) * 2 + 2 * bn * 4;
}
constexpr int kSmem64 = smem_bytes(64, kStages64);   // 224,704 bytes
constexpr int kSmem32 = smem_bytes(32, kStages32);   // 200,192 bytes

// The shared-memory opt-in is a property of the function on one device, and
// the SM count one of the device: both are looked up at the first launch there.
cudaError_t device_sms(int& sms) {
  constexpr int kMaxDevices = 64;
  static int known[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && known[device] > 0) {
    sms = known[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(conv3x3_fused_kernel<8, kStages64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_fused_kernel<4, kStages32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem32);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) known[device] = sms;
  return cudaSuccess;
}

}  // namespace

// xs: host array of `nparts` device pointers; cins: host array of ints; wpk:
// the prepared weights of every output-channel tile, in order; scale: the
// factor of `add`.  Returns the launch's cudaError_t.
extern "C" int maunet_conv3x3_fused(const void* xs, const void* wpk, const void* cins,
                                    int nparts, const void* add, const void* bias,
                                    void* out, int B, int H, int W, int cout, int relu,
                                    const void* scale, void* stream) {
  ConvArgs a;
  cudaError_t err = fill_tile_in(a.in, xs, cins, nparts);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reinterpret_cast<uintptr_t>(wpk) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  a.add = static_cast<const float*>(add);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.relu = relu;
  a.vec_out = cout % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_per_image = a.tiles_x * ((H + TH - 1) / TH);
  const long long ntiles = static_cast<long long>(B) * a.tiles_per_image;
  if (ntiles == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  a.ntiles = static_cast<int>(ntiles);
  int sms = 0;
  err = device_sms(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(a.ntiles < sms ? a.ntiles : sms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* slabs = static_cast<const uint16_t*>(wpk);
  for (int nbase = 0; nbase < cout; nbase += 64) {
    a.nbase = nbase;
    a.wpk = slabs;
    if (cout - nbase > 32) {
      conv3x3_fused_kernel<8, kStages64><<<grid, kThreads, kSmem64, s>>>(a);
      slabs += static_cast<long long>(a.in.steps) * weight_slab_elems(64);
    } else {
      conv3x3_fused_kernel<4, kStages32><<<grid, kThreads, kSmem32, s>>>(a);
      slabs += static_cast<long long>(a.in.steps) * weight_slab_elems(32);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
