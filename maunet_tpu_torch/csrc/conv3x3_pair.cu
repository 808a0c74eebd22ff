// A whole VGGBlock in one launch: conv1 (3x3 SAME over a virtual concat of
// 1-5 NHWC bf16 parts, + add + bias1, ReLU) -> mid in bf16 -> conv2 (3x3 SAME,
// + bias2, ReLU) -> out in bf16.  The mid activation never reaches device
// memory.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/packed_vgg.py::
// packed_pair_fused (body `_make_pair_kernel`).  That kernel walks row blocks
// of a lane-packed image and recomputes two overlap rows of conv1 per block;
// lane packing is not carried over.  Here, on plain NHWC tensors:
//   * `w1_p` is (9, cmid, cin_p) and `w2` is (9, cout, cmid), bf16 with each
//     BatchNorm scale already folded in by the wrapper; `add` is conv1's
//     compact (B, 3, W, cmid) f32 term of the broadcast embeddings (rows
//     {y = 0, interior, y = H - 1}, pre-scaled); the biases are f32;
//   * mid is rounded to bf16 before conv2, as the TPU kernel rounds it
//     (packed_vgg.py:359-360), so the result equals two chained
//     conv3x3_fused launches up to the order of the f32 sums.
//
// What bounds it on the H100: tensor-core throughput, as conv3x3_fused (both
// convs are implicit GEMMs on mma.sync); what it saves over two launches is
// the mid tensor's write and read (2 * B*H*W*cmid*2 bytes) and what it pays
// is conv1 on the ring.  The design, right and simple first:
//   * a block owns a 16 x 32 tile of output pixels of one sample.  conv2 needs
//     mid on that tile plus a one-pixel ring, 18 x 34 = 612 pixels, which the
//     block computes in five passes of conv_mma.cuh's 128-pixel main loop (640
//     rows, 25% more conv1 work than the tile's 512 pixels; a 16 x 16 tile
//     would pay 50%: 324 ring pixels padded to 384 against 256).  The tile is
//     512 pixels, so conv2 runs in four passes with no padding when H and W
//     are multiples of 16 and 32;
//   * conv1's epilogue adds `add` (its row chosen by the pixel's image row, so
//     rows 0 and 2 of the compact form land wherever y = 0 and y = H - 1 fall
//     in the block) and bias1, applies ReLU, zeroes ring pixels outside the
//     image (they are conv2's zero padding, not data) and channels past cmid,
//     and stores bf16 into a shared [612][72] tile (88,128 bytes; rows padded
//     from 64 to 72 so fragment loads are free of bank conflicts);
//   * conv2 reads its A fragments straight from that tile, shifted per tap,
//     and stages only its weight slices through shared memory, prefetched
//     into registers one step ahead;
//   * 103,488 bytes of dynamic shared memory per block (opted in with
//     cudaFuncSetAttribute), so two blocks fit one SM.
#include "conv_mma.cuh"

namespace {

constexpr int TH = 16, TW = 32;            // output tile
constexpr int MH = TH + 2, MW = TW + 2;    // mid tile with its ring
constexpr int MPIX = MH * MW;              // 612
constexpr int kMidPasses = (MPIX + BM - 1) / BM;   // 5
constexpr int kOutPasses = TH * TW / BM;           // 4
constexpr int LDM = BN + 8;                // mid row stride in bf16
constexpr int kSmemBytes = (BM * LDS + BN * LDS + MPIX * LDM) * 2;

static_assert(TW == 32 && BM % TW == 0, "conv2's row decode assumes 32-wide tiles");

struct PairArgs {
  ConvIn in;                      // conv1: parts, (9, cmid, cin_p) weights
  const uint16_t* w2;             // (9, cout, cmid) bf16
  int vec2;                       // 16-byte loads of w2
  const float* add;               // (B, 3, W, cmid) or null
  const float* bias1;             // (cmid,) or null
  const float* bias2;             // (cout,) or null
  __nv_bfloat16* out;             // (B, H, W, cout)
  int H, W, cmid, cout;
  int tiles_x;
};

__global__ void __launch_bounds__(kThreads)
conv3x3_pair_kernel(const __grid_constant__ PairArgs a) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* As = smem;                  // [BM][LDS]
  uint16_t* Bs = As + BM * LDS;         // [BN][LDS]
  uint16_t* mid = Bs + BN * LDS;        // [MPIX][LDM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.H, W = a.W, cmid = a.cmid, cout = a.cout;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / a.tiles_x) * TH;
  const int tx0 = (blockIdx.x % a.tiles_x) * TW;

  float acc[2][8][4];

  // conv1 on the tile and its ring -> mid (bf16, shared).
  for (int pass = 0; pass < kMidPasses; ++pass) {
    int pn[4], py[4], px[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = pass * BM + s * 32 + (tid >> 2);
      py[s] = ty0 - 1 + m / MW;
      px[s] = tx0 - 1 + m % MW;
      const bool inside = m < MPIX && py[s] >= 0 && py[s] < H && px[s] >= 0 && px[s] < W;
      pn[s] = inside ? n : -1;
    }
    zero_acc(acc);
    conv_accumulate(a.in, H, W, cmid, 0, pn, py, px, As, Bs, acc);

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = pass * BM + warp * 32 + mt * 16 + half * 8 + g;
        if (m >= MPIX) continue;
        const int y = ty0 - 1 + m / MW, x = tx0 - 1 + m % MW;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        const int sel = y == 0 ? 0 : (y == H - 1 ? 2 : 1);
        const float* add_row =
            (a.add && inside)
                ? a.add + ((static_cast<long long>(n) * 3 + sel) * W + x) * cmid
                : nullptr;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int co = nt * 8 + t4 * 2;
          float val[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = acc[mt][nt][half * 2 + e];
            if (co + e < cmid) {
              if (add_row) s += add_row[co + e];
              if (a.bias1) s += a.bias1[co + e];
            } else {
              s = 0.f;
            }
            val[e] = inside ? fmaxf(s, 0.f) : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(mid + m * LDM + co) =
              __floats2bfloat162_rn(val[0], val[1]);
        }
      }
    }
  }
  __syncthreads();

  // conv2 from mid.  Output row r of a pass is tile pixel (r / 32, r % 32);
  // its tap (dy, dx) is mid pixel (r / 32 + 1 + dy, r % 32 + 1 + dx).
  const int ksteps = (cmid + BK - 1) / BK;
  const int nsteps = 9 * ksteps;
  for (int pass = 0; pass < kOutPasses; ++pass) {
    if (ty0 + pass * (BM / TW) >= H) break;   // the whole pass lies below the image
    const uint16_t* centre[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = pass * BM + warp * 32 + mt * 16 + half * 8 + g;
        centre[mt][half] = mid + ((r / TW + 1) * MW + (r % TW + 1)) * LDM;
      }
    zero_acc(acc);
    uint4 rb[2];
    int tap = 0, c0 = 0;
    load_weight_slice(a.w2, tap, c0, cmid, cout, 0, a.vec2 != 0, rb);
    for (int step = 0; step < nsteps; ++step) {
      store_weight_slice(Bs, rb);
      __syncthreads();
      const int shift = ((tap / 3 - 1) * MW + (tap % 3 - 1)) * LDM + c0;
      c0 += BK;
      if (c0 >= cmid) {
        c0 = 0;
        ++tap;
      }
      if (step + 1 < nsteps)
        load_weight_slice(a.w2, tap, c0, cmid, cout, 0, a.vec2 != 0, rb);
      const uint16_t* a0[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) a0[mt][half] = centre[mt][half] + shift;
      mma_slice(a0, Bs, g, t4, acc);
      __syncthreads();
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = pass * BM + warp * 32 + mt * 16 + half * 8 + g;
        const int y = ty0 + r / TW, x = tx0 + r % TW;
        if (y >= H || x >= W) continue;
        __nv_bfloat16* orow =
            a.out + ((static_cast<long long>(n) * H + y) * W + x) * cout;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int co = nt * 8 + t4 * 2;
          float val[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = acc[mt][nt][half * 2 + e];
            if (a.bias2 && co + e < cout) s += a.bias2[co + e];
            val[e] = fmaxf(s, 0.f);
          }
          if (co + 1 < cout && (cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + co) =
                __floats2bfloat162_rn(val[0], val[1]);
          } else {
            if (co < cout) orow[co] = __float2bfloat16_rn(val[0]);
            if (co + 1 < cout) orow[co + 1] = __float2bfloat16_rn(val[1]);
          }
        }
      }
    }
  }
}

}  // namespace

// xs, ws: host arrays of `nparts` device pointers (conv1's parts and weight
// slices); cins: host array of ints.  cmid and cout are at most 64.  Returns
// the launch's cudaError_t.
extern "C" int maunet_conv3x3_pair(const void* xs, const void* ws, const void* cins,
                                   int nparts, const void* w2, const void* add,
                                   const void* bias1, const void* bias2, void* out,
                                   int B, int H, int W, int cmid, int cout,
                                   void* stream) {
  PairArgs a;
  const cudaError_t bad = fill_conv_in(a.in, xs, ws, cins, nparts);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  if (cmid < 1 || cmid > BN || cout < 1 || cout > BN || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.w2 = static_cast<const uint16_t*>(w2);
  a.vec2 = cmid % 8 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  a.add = static_cast<const float*>(add);
  a.bias1 = static_cast<const float*>(bias1);
  a.bias2 = static_cast<const float*>(bias2);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.W = W;
  a.cmid = cmid;
  a.cout = cout;
  a.tiles_x = (W + TW - 1) / TW;
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  // The shared-memory opt-in is a property of the function on one device:
  // set it at the first launch there, not at every one.
  constexpr int kMaxDevices = 64;
  static bool opted[kMaxDevices] = {};
  int device = 0;
  cudaError_t opt = cudaGetDevice(&device);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  if (device < 0 || device >= kMaxDevices || !opted[device]) {
    opt = cudaFuncSetAttribute(conv3x3_pair_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    if (device >= 0 && device < kMaxDevices) opted[device] = true;
  }
  const dim3 grid(a.tiles_x * ((H + TH - 1) / TH), B);
  conv3x3_pair_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
