// The halo-tile main loop of the 3x3 SAME convolution over a virtual channel
// concat of 1-5 NHWC bf16 parts (conv3x3_fused.cu), its epilogue, and the
// halo copies in any size, which the pair kernel (conv3x3_pair.cu) also uses.
//
// A block of 256 threads (two warpgroups) owns a 16 x 16 rectangle of output
// pixels of one sample and accumulates it against BN = 64 or 32 output
// channels in f32 registers.  Pixels are the 64 rows of a wgmma product, 16
// to a warp, so warp i of warpgroup w holds tile rows 8w + i and 8w + 4 + i.
// One K step is one 32-channel slice of one part.  For it the block stages,
// once,
//   * the 18 x 18 halo of pixels (zero outside the image and past cin), rows
//     padded to 40 bf16 (80 bytes: eight 16-byte rows on distinct banks), and
//   * the nine taps' (BN x 32) weights, which the wrapper has laid out
//     contiguously as wgmma's 8 x 8 core matrices, zero-padded
//     (packed_vgg.prepare_conv3x3), so they are one linear run of 16-byte
//     copies with no masking,
// and then runs all nine taps from that halo by shifting the base address of
// the A fragments, which go through registers (ldmatrix.x4): a tap shift of
// one pixel moves A by one row, which a swizzled shared-memory operand would
// not survive.  B is read from shared memory through a descriptor.  The
// product is wgmma.mma_async m64n64k16 or m64n32k16 (bf16 in, f32
// accumulate).  Stages form a ring in shared memory filled by cp.async
// (16-byte copies whose source size gives the zero fill), one block-wide
// barrier per stage.
//
// A part whose channels are not a multiple of 8, or whose base is not 16-byte
// aligned, cannot take 16-byte copies: its halo is read with 2-byte loads into
// registers before the current stage's products and stored into the ring
// after them, once per slice and not once per tap.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 5;
constexpr int TH = 16, TW = 16;              // output tile
constexpr int HH = TH + 2, HW = TW + 2;      // halo
constexpr int HPIX = HH * HW;                // 324
constexpr int BK = 32;                       // input channels per stage
constexpr int LDS = BK + 8;                  // shared row stride in bf16 (80 bytes)
constexpr int kWarps = TH / 2;
constexpr int kThreads = kWarps * 32;        // 256

static_assert(TW == 16 && TH == 16 && BK == 32,
              "a warp's 16 product rows are one tile row; two k16 steps per stage");

// A halo of HWD x HHD pixels, staged at the LDS row stride; the 2-byte path
// moves its channel pairs, kPairIters per thread and stage.
template <int HWD, int HHD>
struct HaloShape {
  static constexpr int kPix = HWD * HHD;
  static constexpr int kElems = kPix * LDS;
  static constexpr int kPairs = kPix * (BK / 2);
  static constexpr int kPairIters = (kPairs + kThreads - 1) / kThreads;
};
// A's own: one pixel around its tile.
constexpr int kHaloElems = HaloShape<HW, HH>::kElems;
constexpr int kPairIters = HaloShape<HW, HH>::kPairIters;

__host__ __device__ constexpr int weight_slab_elems(int bn) { return 9 * bn * BK; }
__host__ __device__ constexpr int stage_elems(int bn) { return kHaloElems + weight_slab_elems(bn); }

struct TileIn {
  const uint16_t* x[kMaxParts];   // (B, H, W, cin_p) bf16
  int cin[kMaxParts];
  int vec[kMaxParts];             // 16-byte copies: cin % 8 == 0, aligned
  int nparts;
  int steps;                      // sum over parts of ceil(cin_p / BK)
};

// xs: host array of `nparts` device pointers; cins: host array of ints.
inline cudaError_t fill_tile_in(TileIn& in, const void* xs, const void* cins, int nparts) {
  if (nparts < 1 || nparts > kMaxParts) return cudaErrorInvalidValue;
  const void* const* xp = static_cast<const void* const*>(xs);
  const int* cp = static_cast<const int*>(cins);
  in.steps = 0;
  for (int q = 0; q < kMaxParts; ++q) {
    in.x[q] = q < nparts ? static_cast<const uint16_t*>(xp[q]) : nullptr;
    in.cin[q] = q < nparts ? cp[q] : 0;
    if (q < nparts && in.cin[q] < 1) return cudaErrorInvalidValue;
    in.vec[q] = q < nparts && in.cin[q] % 8 == 0 &&
                reinterpret_cast<uintptr_t>(in.x[q]) % 16 == 0;
    in.steps += (in.cin[q] + BK - 1) / BK;
  }
  in.nparts = nparts;
  return cudaSuccess;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The tile row of this warp's 16 rows of its warpgroup's 64-row product mt.
__device__ __forceinline__ int tile_row(int warp, int mt) {
  return (warp >> 2) * 8 + mt * 4 + (warp & 3);
}

// Which image pixel halo pixel `hp` of the tile at (ty0, tx0) is, for a halo
// HWD pixels wide that starts one pixel above and left of the tile.
template <int HWD = HW>
__device__ __forceinline__ bool halo_pixel(int hp, int ty0, int tx0, int H, int W,
                                           int& y, int& x) {
  y = ty0 - 1 + hp / HWD;
  x = tx0 - 1 + hp % HWD;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// What a stage's copies read and where they land.
struct StageCopy {
  const uint16_t* x;      // the part, (B, H, W, cin)
  const uint16_t* slab;   // the stage's weight slab
  uint32_t halo_s, w_s;   // shared-space addresses
  int cin, c0, n, ty0, tx0;
  bool halo;              // false: the halo goes by the 2-byte path
};

// A stage's 16-byte asynchronous copies: the weight slab, contiguous in
// device memory in the layout wgmma reads, as a linear run with no masking; and
// (if s.halo) channels c0 .. c0 + BK - 1 of the part on the halo of tile
// (n, ty0, tx0), zero outside the image and past cin (the source size gives
// the zero fill).
template <int BN, int HWD = HW, int HHD = HH>
__device__ __forceinline__ void stage_async(const StageCopy& s, int H, int W) {
  for (int idx = threadIdx.x; idx < weight_slab_elems(BN) / 8; idx += kThreads)
    cp_async16(s.w_s + idx * 16, s.slab + idx * 8, 16);
  if (!s.halo) return;
  for (int idx = threadIdx.x; idx < HaloShape<HWD, HHD>::kPix * (BK / 8); idx += kThreads) {
    const int hp = idx / (BK / 8), v = idx % (BK / 8);
    int y, xx;
    const bool ok = halo_pixel<HWD>(hp, s.ty0, s.tx0, H, W, y, xx) && s.c0 + v * 8 < s.cin;
    const uint16_t* src =
        ok ? s.x + ((static_cast<long long>(s.n) * H + y) * W + xx) * s.cin + s.c0 + v * 8
           : s.x;
    cp_async16(s.halo_s + (hp * LDS + v * 8) * 2, src, ok ? 16 : 0);
  }
}

// The same slice read two channels at a time with 2-byte loads, for a part
// that cannot take 16-byte copies; halo_store_pairs puts it into the ring.
template <int HWD = HW, int HHD = HH>
__device__ __forceinline__ void halo_load_pairs(
    uint32_t (&r)[HaloShape<HWD, HHD>::kPairIters], const uint16_t* x, int cin, int c0, int n,
    int ty0, int tx0, int H, int W) {
  using Halo = HaloShape<HWD, HHD>;
#pragma unroll
  for (int j = 0; j < Halo::kPairIters; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    const int hp = idx / (BK / 2), c = c0 + idx % (BK / 2) * 2;
    int y, xx;
    // Every lane loads, a masked one from the part's first element, so the
    // loads are straight-line code and all in flight together.
    const bool ok = idx < Halo::kPairs && halo_pixel<HWD>(hp, ty0, tx0, H, W, y, xx) && c < cin;
    const bool ok1 = ok && c + 1 < cin;
    const uint16_t* src =
        ok ? x + ((static_cast<long long>(n) * H + y) * W + xx) * cin + c : x;
    const uint32_t lo = __ldg(src), hi = __ldg(src + (ok1 ? 1 : 0));
    const uint32_t v = (ok ? lo : 0u) | (ok1 ? hi << 16 : 0u);
    r[j] = v;
  }
}

template <int HWD = HW, int HHD = HH>
__device__ __forceinline__ void halo_store_pairs(
    uint16_t* halo, const uint32_t (&r)[HaloShape<HWD, HHD>::kPairIters]) {
  using Halo = HaloShape<HWD, HHD>;
#pragma unroll
  for (int j = 0; j < Halo::kPairIters; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    if (idx < Halo::kPairs)
      *reinterpret_cast<uint32_t*>(halo + idx / (BK / 2) * LDS + idx % (BK / 2) * 2) = r[j];
  }
}

// wgmma reads B through a descriptor of the no-swizzle layout: 8 x 8 core
// matrices of 128 contiguous bytes (8 weight rows x 8 channels); the second
// eight channels of a k16 step follow the first (128 bytes on), the next
// eight rows come 256 bytes on.
__device__ __forceinline__ uint64_t core_matrix_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a (this warp's 16 x 16 fragment of a 64 x 16 A, from registers) x B
// (64 x 16 or 32 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc += all nine taps of one staged slice.  halo_s: [HPIX][LDS]; w_s:
// [tap][k16 step][BN / 8][2][8][8].  Accumulator element e of tile (mt, nt)
// is tile row tile_row(warp, mt), column g + 8 * (e / 2), channel
// nt * 8 + 2 * t4 + e % 2, with g = lane / 4 and t4 = lane % 4.  A
// fragment's ldmatrix.x4 has lane l point at pixel l % 16, channels
// 8 * (l / 16) ... of the k16 step.  A tap's four products are in flight
// while the next tap's fragments are loaded into the other register set.
template <int NT>
__device__ __forceinline__ void mma_stage(uint32_t halo_s, uint32_t w_s, int warp, int lane,
                                          float (&acc)[2][NT][4]) {
  constexpr int BN = NT * 8;
  const uint32_t a_lane = ((lane & 15) * LDS + (lane >> 4) * 8) * 2;
  uint32_t af[2][2][2][4];   // [tap parity][mt][k16 step]
  auto load_a = [&](int tap) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4(af[tap & 1][mt][ks], halo_s + a_lane +
                    (((tile_row(warp, mt) + tap / 3) * HW + tap % 3) * LDS + ks * 16) * 2);
  };
  load_a(0);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma_bf16(acc[mt], af[tap & 1][mt][ks],
                   core_matrix_desc(w_s + (tap * 2 + ks) * BN * 32));
    wgmma_commit();
    if (tap + 1 < 9) load_a(tap + 1);
    wgmma_wait_all();
    // The products read these registers until the wait: keep them alive.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[tap & 1][mt][ks][i]) :: "memory");
  }
}

struct ConvArgs {
  TileIn in;
  const uint16_t* wpk;            // this output-channel tile's slabs
  const float* add;               // (B, 3, W, cout) or null
  const float* scale;             // (cout,), multiplies add; or null
  const float* bias;              // (cout,) or null
  __nv_bfloat16* out;             // (B, H, W, cout)
  int H, W, cout;
  int nbase;                      // first output channel of this tile
  int relu;
  int vec_out;                    // 16-byte stores: cout % 8 == 0, aligned
  int tiles_x, tiles_per_image, ntiles;
};

struct TilePos {
  int n, ty0, tx0;
};

__device__ __forceinline__ TilePos tile_pos(const ConvArgs& a, int tile) {
  TilePos t;
  t.n = tile / a.tiles_per_image;
  const int r = tile % a.tiles_per_image;
  t.ty0 = r / a.tiles_x * TH;
  t.tx0 = r % a.tiles_x * TW;
  return t;
}

// add * scale + bias, ReLU and the rounding to bf16, eight tile pixels of one
// tile row at a time.  scale_s and bias_s: this output tile's BN values in
// shared memory (1 and 0 past cout): read from device memory inside this
// loop, between the stores, they cost a trip to L2 each.  Where the output
// rows take 16-byte stores (cout % 8 == 0), the warp passes the 8 x BN values through its own `stage` rows in
// shared memory (16-byte chunks swizzled by row, so neither side has bank
// conflicts) and writes whole 16-byte chunks, pixel after pixel: a store
// instruction then fills complete 128-byte lines where the fragment layout
// would touch eight lines with 16 bytes each.
template <int NT>
__device__ __forceinline__ void epilogue(const ConvArgs& a, const TilePos& t, int warp,
                                         int lane, const float (&acc)[2][NT][4],
                                         uint16_t* stage, const float* scale_s,
                                         const float* bias_s) {
  constexpr int BN = NT * 8;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.H, W = a.W, cout = a.cout;
  const float* add = a.add;
  auto swizzle = [](int row) { return NT == 8 ? (row & 7) : ((row >> 1) & 3); };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int yy = t.ty0 + tile_row(warp, mt);
    if (yy >= H) continue;
    const int sel = yy == 0 ? 0 : (yy == H - 1 ? 2 : 1);
    __nv_bfloat16* out_row = a.out + (static_cast<long long>(t.n) * H + yy) * W * cout;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x0 = t.tx0 + half * 8;
      const bool inside = x0 + g < W;
      const float* add_row =
          add && inside ? add + ((static_cast<long long>(t.n) * 3 + sel) * W + x0 + g) * cout
                        : nullptr;
      __nv_bfloat162 packed[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + t4 * 2;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = acc[mt][nt][half * 2 + e];
          if (add_row && a.nbase + c + e < cout)
            s += __ldg(add_row + a.nbase + c + e) * scale_s[c + e];
          s += bias_s[c + e];
          val[e] = a.relu ? fmaxf(s, 0.f) : s;
        }
        packed[nt] = __floats2bfloat162_rn(val[0], val[1]);
      }
      if (a.vec_out) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<__nv_bfloat162*>(stage + g * BN + (nt ^ swizzle(g)) * 8 + t4 * 2) =
              packed[nt];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8 * NT / 32; ++j) {
          const int row = (j * 32 + lane) / NT, chunk = (j * 32 + lane) % NT;
          const uint4 v =
              *reinterpret_cast<const uint4*>(stage + row * BN + (chunk ^ swizzle(row)) * 8);
          const int co = a.nbase + chunk * 8;
          if (x0 + row < W && co < cout)
            *reinterpret_cast<uint4*>(out_row + static_cast<long long>(x0 + row) * cout + co) = v;
        }
        __syncwarp();
      } else if (inside) {
        __nv_bfloat16* orow = out_row + static_cast<long long>(x0 + g) * cout;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = a.nbase + nt * 8 + t4 * 2;
          if (co + 1 < cout && (cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + co) = packed[nt];
          } else {
            if (co < cout) orow[co] = packed[nt].x;
            if (co + 1 < cout) orow[co + 1] = packed[nt].y;
          }
        }
      }
    }
  }
}

}  // namespace
