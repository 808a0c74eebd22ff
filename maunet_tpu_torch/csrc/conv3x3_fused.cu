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
//   * the K loop over parts x 9 taps x 32-channel slices of cin, staged
//     through shared memory into mma.sync.m16n8k16 (bf16 in, f32 accumulate),
//     is conv_mma.cuh's conv_accumulate, shared with the pair kernel;
//   * four warps each hold a 32 x 64 f32 accumulator tile in registers; the
//     epilogue adds `add` and `bias`, applies ReLU and stores bf16.
// No wgmma or TMA yet: a pipelined warp-specialised version is later work.
#include "conv_mma.cuh"

namespace {

struct ConvArgs {
  ConvIn in;
  const float* add;               // (B, 3, W, cout) or null
  const float* bias;              // (cout,) or null
  __nv_bfloat16* out;             // (B, H, W, cout)
  int B, H, W, cout;
  int relu;
};

__global__ void __launch_bounds__(kThreads)
conv3x3_fused_kernel(const __grid_constant__ ConvArgs a) {
  __shared__ __align__(16) uint16_t As[BM * LDS];   // [pixel][k]
  __shared__ __align__(16) uint16_t Bs[BN * LDS];   // [cout][k]

  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, cout = a.cout;
  const long long M = static_cast<long long>(a.B) * H * W;
  const long long mbase = static_cast<long long>(blockIdx.x) * BM;
  const int nbase = blockIdx.y * BN;

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

  float acc[2][8][4];
  zero_acc(acc);
  conv_accumulate(a.in, H, W, cout, nbase, pn, py, px, As, Bs, acc);

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

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
  ConvArgs a;
  const cudaError_t bad = fill_conv_in(a.in, xs, ws, cins, nparts);
  if (bad != cudaSuccess) return static_cast<int>(bad);
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
