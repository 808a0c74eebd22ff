// 3x3 SAME convolution over a virtual channel concat of 1-5 NHWC parts, with
// a fused epilogue: out = relu?(sum_p conv(x_p, w_p) + add + bias), in bf16.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/packed_vgg.py::
// packed_conv3x3_fused (body `_make_kernel` / `_conv_from_xh`).  The TPU
// kernel packs narrow channels into the 128-wide lanes of its matrix unit;
// that layout device is not carried over.  This kernel computes the same
// contraction on plain NHWC tensors:
//   * `w_p` is (9, cout, cin_p) bf16 with the BatchNorm scale already folded
//     in by the wrapper, `add` is the compact (B, 3, W, cout) f32 term of the
//     broadcast embeddings (rows {y = 0, interior, y = H - 1}, pre-scaled),
//     `bias` is (cout,) f32.  All parts accumulate into one f32 sum.
//
// What bounds it on the H100: tensor-core throughput (at the U-Net's level-0
// row, K = 9 * cin reaches 1,728 for a 64-wide output, about 100 FLOPs per
// byte moved), then the latency of feeding the tensor cores.  The design is a
// direct implicit GEMM, right and simple first:
//   * a block owns 128 output pixels (flattened over B*H*W, so any H and W,
//     odd ones included) x 64 output channels;
//   * the K loop runs over parts x 9 taps x 32-channel slices of cin; each
//     step stages the shifted input rows (zero outside the image or past
//     cin, so any cin is taken; 16-byte loads where cin % 8 == 0 and the
//     part is 16-byte aligned, 2-byte loads else) and the weight slice in
//     shared memory, with rows padded to 40 bf16 so the fragment loads are
//     free of bank conflicts;
//   * the next step's global loads are issued into registers before the
//     current step's mma.sync.m16n8k16 (bf16 in, f32 accumulate) run, so
//     their latency overlaps the tensor-core work;
//   * four warps each hold a 32 x 64 f32 accumulator tile in registers; the
//     epilogue adds `add` and `bias`, applies ReLU and stores bf16.
// No wgmma or TMA yet: a pipelined warp-specialised version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 5;
constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per K step
constexpr int LDS = BK + 8;   // shared row stride in bf16
constexpr int kThreads = 128;

struct ConvArgs {
  const uint16_t* x[kMaxParts];   // (B, H, W, cin_p) bf16
  const uint16_t* w[kMaxParts];   // (9, cout, cin_p) bf16
  int cin[kMaxParts];
  int vec[kMaxParts];             // 16-byte loads: cin % 8 == 0, aligned
  int nparts;
  const float* add;               // (B, 3, W, cout) or null
  const float* bias;              // (cout,) or null
  __nv_bfloat16* out;             // (B, H, W, cout)
  int B, H, W, cout;
  int relu;
};

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

__global__ void __launch_bounds__(kThreads)
conv3x3_fused_kernel(const __grid_constant__ ConvArgs a) {
  __shared__ __align__(16) uint16_t As[BM * LDS];   // [pixel][k]
  __shared__ __align__(16) uint16_t Bs[BN * LDS];   // [cout][k]

  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, cout = a.cout;
  const long long M = static_cast<long long>(a.B) * H * W;
  const long long mbase = static_cast<long long>(blockIdx.x) * BM;
  const int nbase = blockIdx.y * BN;

  // This thread stages 8 channels (slot v) of 4 pixels for A, and 8 channels
  // of 2 output channels for B.
  const int v = tid & 3;
  int pn[4], py[4], px[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const long long m = mbase + s * 32 + (tid >> 2);
    if (m < M) {
      px[s] = static_cast<int>(m % W);
      const long long r = m / W;
      py[s] = static_cast<int>(r % H);
      pn[s] = static_cast<int>(r / H);
    } else {
      pn[s] = -1;
      py[s] = px[s] = 0;
    }
  }

  int nsteps = 0;
  for (int q = 0; q < a.nparts; ++q) nsteps += 9 * ((a.cin[q] + BK - 1) / BK);

  uint4 ra[4], rb[2];
  auto load_step = [&](int p, int tap, int c0) {
    const int cin = a.cin[p];
    const bool vec = a.vec[p] != 0;
    const int c = c0 + v * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint16_t* x = a.x[p];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ys = py[s] + dy, xs = px[s] + dx;
      const bool ok = pn[s] >= 0 && ys >= 0 && ys < H && xs >= 0 && xs < W && c < cin;
      const uint16_t* src =
          ok ? x + ((static_cast<long long>(pn[s]) * H + ys) * W + xs) * cin + c : x;
      ra[s] = load8(src, ok ? cin - c : 0, vec);
    }
    const uint16_t* w = a.w[p];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = s * kThreads + tid;
      const int co = nbase + (idx >> 2);
      const int cw = c0 + (idx & 3) * 8;
      const bool ok = co < cout && cw < cin;
      const uint16_t* src =
          ok ? w + (static_cast<long long>(tap) * cout + co) * cin + cw : w;
      rb[s] = load8(src, ok ? cin - cw : 0, vec);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  int p = 0, tap = 0, c0 = 0;
  load_step(p, tap, c0);
  for (int step = 0; step < nsteps; ++step) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<uint4*>(&As[(s * 32 + (tid >> 2)) * LDS + v * 8]) = ra[s];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = s * kThreads + tid;
      *reinterpret_cast<uint4*>(&Bs[(idx >> 2) * LDS + (idx & 3) * 8]) = rb[s];
    }
    __syncthreads();

    c0 += BK;
    if (c0 >= a.cin[p]) {
      c0 = 0;
      if (++tap == 9) {
        tap = 0;
        ++p;
      }
    }
    if (step + 1 < nsteps) load_step(p, tap, c0);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = warp * 32 + mt * 16 + g;
        af[mt][0] = lds32(&As[r * LDS + ks + t4 * 2]);
        af[mt][1] = lds32(&As[(r + 8) * LDS + ks + t4 * 2]);
        af[mt][2] = lds32(&As[r * LDS + ks + t4 * 2 + 8]);
        af[mt][3] = lds32(&As[(r + 8) * LDS + ks + t4 * 2 + 8]);
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
    __syncthreads();
  }

  // Epilogue.  Accumulator element e of tile (mt, nt) sits at pixel row
  // g + 8 * (e / 2) and channel column 2 * t4 + e % 2 of the 16 x 8 tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = mbase + warp * 32 + mt * 16 + half * 8 + g;
      if (m >= M) continue;
      const int xx = static_cast<int>(m % W);
      const long long rest = m / W;
      const int yy = static_cast<int>(rest % H);
      const long long bb = rest / H;
      const int sel = yy == 0 ? 0 : (yy == H - 1 ? 2 : 1);
      const float* add_row =
          a.add ? a.add + ((bb * 3 + sel) * W + xx) * cout : nullptr;
      __nv_bfloat16* orow = a.out + m * cout;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = nbase + nt * 8 + t4 * 2;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = acc[mt][nt][half * 2 + e];
          if (co + e < cout) {
            if (add_row) s += add_row[co + e];
            if (a.bias) s += a.bias[co + e];
          }
          val[e] = a.relu ? fmaxf(s, 0.f) : s;
        }
        if (co + 1 < cout && (cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + co) = __floats2bfloat162_rn(val[0], val[1]);
        } else {
          if (co < cout) orow[co] = __float2bfloat16_rn(val[0]);
          if (co + 1 < cout) orow[co + 1] = __float2bfloat16_rn(val[1]);
        }
      }
    }
  }
}

}  // namespace

// xs, ws: host arrays of `nparts` device pointers; cins: host array of ints.
// Returns the launch's cudaError_t.
extern "C" int maunet_conv3x3_fused(const void* xs, const void* ws,
                                    const void* cins, int nparts,
                                    const void* add, const void* bias, void* out,
                                    int B, int H, int W, int cout, int relu,
                                    void* stream) {
  if (nparts < 1 || nparts > kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  const void* const* xp = static_cast<const void* const*>(xs);
  const void* const* wp = static_cast<const void* const*>(ws);
  const int* cp = static_cast<const int*>(cins);
  for (int q = 0; q < kMaxParts; ++q) {
    a.x[q] = q < nparts ? static_cast<const uint16_t*>(xp[q]) : nullptr;
    a.w[q] = q < nparts ? static_cast<const uint16_t*>(wp[q]) : nullptr;
    a.cin[q] = q < nparts ? cp[q] : 0;
    if (q < nparts && a.cin[q] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.vec[q] = q < nparts && a.cin[q] % 8 == 0 &&
               reinterpret_cast<uintptr_t>(a.x[q]) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(a.w[q]) % 16 == 0;
  }
  a.nparts = nparts;
  a.add = static_cast<const float*>(add);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.H = H;
  a.W = W;
  a.cout = cout;
  a.relu = relu;
  const long long M = static_cast<long long>(B) * H * W;
  if (M == 0 || cout == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (cout + BN - 1) / BN);
  conv3x3_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
