// Device code shared by the 3x3 conv kernels (conv3x3_fused.cu, one conv;
// conv3x3_pair.cu, a whole VGGBlock): the implicit-GEMM main loop of a 3x3
// SAME convolution over a virtual channel concat of 1-5 NHWC bf16 parts.
//
// A block of 128 threads (four warps) accumulates a tile of 128 pixels x 64
// output channels in f32 registers.  The K loop runs over parts x 9 taps x
// 32-channel slices of cin; each step stages the shifted input rows (zero
// outside the image or past cin, so any cin is taken; 16-byte loads where
// cin % 8 == 0 and the part is 16-byte aligned, 2-byte loads else) and the
// weight slice in shared memory, with rows padded to 40 bf16 so the fragment
// loads are free of bank conflicts.  The next step's global loads are issued
// into registers before the current step's mma.sync.m16n8k16 (bf16 in, f32
// accumulate) run, so their latency overlaps the tensor-core work.  Which 128
// pixels a block owns is the caller's choice: it hands in their (sample, y, x).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 5;
constexpr int BM = 128;       // pixels per accumulator tile
constexpr int BN = 64;        // output channels per accumulator tile
constexpr int BK = 32;        // input channels per K step
constexpr int LDS = BK + 8;   // shared row stride in bf16
constexpr int kThreads = 128;

struct ConvIn {
  const uint16_t* x[kMaxParts];   // (B, H, W, cin_p) bf16
  const uint16_t* w[kMaxParts];   // (9, cout, cin_p) bf16
  int cin[kMaxParts];
  int vec[kMaxParts];             // 16-byte loads: cin % 8 == 0, aligned
  int nparts;
};

// xs, ws: host arrays of `nparts` device pointers; cins: host array of ints.
inline cudaError_t fill_conv_in(ConvIn& in, const void* xs, const void* ws,
                                const void* cins, int nparts) {
  if (nparts < 1 || nparts > kMaxParts) return cudaErrorInvalidValue;
  const void* const* xp = static_cast<const void* const*>(xs);
  const void* const* wp = static_cast<const void* const*>(ws);
  const int* cp = static_cast<const int*>(cins);
  for (int q = 0; q < kMaxParts; ++q) {
    in.x[q] = q < nparts ? static_cast<const uint16_t*>(xp[q]) : nullptr;
    in.w[q] = q < nparts ? static_cast<const uint16_t*>(wp[q]) : nullptr;
    in.cin[q] = q < nparts ? cp[q] : 0;
    if (q < nparts && in.cin[q] < 1) return cudaErrorInvalidValue;
    in.vec[q] = q < nparts && in.cin[q] % 8 == 0 &&
                reinterpret_cast<uintptr_t>(in.x[q]) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(in.w[q]) % 16 == 0;
  }
  in.nparts = nparts;
  return cudaSuccess;
}

// Up to 8 consecutive bf16 from `src`; elements at or past `count` are zero.
// `vec` says the 16-byte load is aligned.
__device__ __forceinline__ uint4 load8(const uint16_t* src, int count, bool vec) {
  if (count >= 8 && vec) return *reinterpret_cast<const uint4*>(src);
  union {
    uint4 u;
    uint16_t h[8];
  } r;
  r.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < count) r.h[e] = src[e];
  return r.u;
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// One K slice (BK channels, already in shared memory) of the block's
// 128 x 64 product.  `a0[mt][half]` points at channel 0 of the slice for
// fragment row g + 8 * half of this warp's 16-pixel tile mt; Bs is [cout][k].
__device__ __forceinline__ void mma_slice(const uint16_t* (&a0)[2][2],
                                          const uint16_t* Bs, int g, int t4,
                                          float (&acc)[2][8][4]) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      af[mt][0] = lds32(a0[mt][0] + ks + t4 * 2);
      af[mt][1] = lds32(a0[mt][1] + ks + t4 * 2);
      af[mt][2] = lds32(a0[mt][0] + ks + t4 * 2 + 8);
      af[mt][3] = lds32(a0[mt][1] + ks + t4 * 2 + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = lds32(&Bs[n * LDS + ks + t4 * 2]);
      const uint32_t b1 = lds32(&Bs[n * LDS + ks + t4 * 2 + 8]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
    }
  }
}

// This thread's two 8-channel groups of the (BN x BK) weight slice of tap
// `tap`, channels c0.. of a (9, cout, cin) bf16 weight.
__device__ __forceinline__ void load_weight_slice(const uint16_t* w, int tap, int c0,
                                                  int cin, int cout, int nbase,
                                                  bool vec, uint4 (&rb)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    const int co = nbase + (idx >> 2);
    const int cw = c0 + (idx & 3) * 8;
    const bool ok = co < cout && cw < cin;
    const uint16_t* src =
        ok ? w + (static_cast<long long>(tap) * cout + co) * cin + cw : w;
    rb[s] = load8(src, ok ? cin - cw : 0, vec);
  }
}

__device__ __forceinline__ void store_weight_slice(uint16_t* Bs, const uint4 (&rb)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int idx = s * kThreads + threadIdx.x;
    *reinterpret_cast<uint4*>(&Bs[(idx >> 2) * LDS + (idx & 3) * 8]) = rb[s];
  }
}

// acc += conv3x3 of the virtual concat at this block's 128 pixels, output
// channels nbase .. nbase + 63.  Thread `tid` stages pixels s * 32 + tid / 4
// (s = 0..3), whose coordinates are (pn[s], py[s], px[s]); pn[s] < 0 marks a
// pixel that reads nothing (its accumulators stay 0).  py and px may lie one
// step outside the image: only the taps that land inside it are read.
// As: BM * LDS and Bs: BN * LDS bf16 of shared memory.  Ends on a barrier.
__device__ __forceinline__ void conv_accumulate(
    const ConvIn& in, int H, int W, int cout, int nbase, const int (&pn)[4],
    const int (&py)[4], const int (&px)[4], uint16_t* As, uint16_t* Bs,
    float (&acc)[2][8][4]) {
  const int tid = threadIdx.x;
  const int v = tid & 3;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  int nsteps = 0;
  for (int q = 0; q < in.nparts; ++q) nsteps += 9 * ((in.cin[q] + BK - 1) / BK);

  uint4 ra[4], rb[2];
  auto load_step = [&](int p, int tap, int c0) {
    const int cin = in.cin[p];
    const bool vec = in.vec[p] != 0;
    const int c = c0 + v * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint16_t* x = in.x[p];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ys = py[s] + dy, xs = px[s] + dx;
      const bool ok = pn[s] >= 0 && ys >= 0 && ys < H && xs >= 0 && xs < W && c < cin;
      const uint16_t* src =
          ok ? x + ((static_cast<long long>(pn[s]) * H + ys) * W + xs) * cin + c : x;
      ra[s] = load8(src, ok ? cin - c : 0, vec);
    }
    load_weight_slice(in.w[p], tap, c0, cin, cout, nbase, vec, rb);
  };

  const uint16_t* a0[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      a0[mt][half] = As + (warp * 32 + mt * 16 + half * 8 + g) * LDS;

  int p = 0, tap = 0, c0 = 0;
  load_step(p, tap, c0);
  for (int step = 0; step < nsteps; ++step) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint4*>(&As[(s * 32 + (tid >> 2)) * LDS + v * 8]) = ra[s];
    store_weight_slice(Bs, rb);
    __syncthreads();

    c0 += BK;
    if (c0 >= in.cin[p]) {
      c0 = 0;
      if (++tap == 9) {
        tap = 0;
        ++p;
      }
    }
    if (step + 1 < nsteps) load_step(p, tap, c0);

    mma_slice(a0, Bs, g, t4, acc);
    __syncthreads();
  }
}

}  // namespace
