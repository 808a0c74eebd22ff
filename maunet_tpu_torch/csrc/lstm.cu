// Full-sequence LSTM over pre-projected inputs, returning the last hidden state.
//
// Replaces the TPU kernel maunet_tpu/ops/pallas/lstm.py::_pallas_forward
// (body `_make_kernel`): x_proj (B, T, 4H) f32 already holding
// x.W_ih + b_ih + b_hh, W_hh (H, 4H) f32, lengths (B,) i32 -> h_T (B, H) f32.
// Gate order (i, f, g, o); each sample's (h, c) freezes at t >= length.
//
// What bounds it on the H100: latency of the T-step recurrence.  One step is a
// (1, H) x (H, 4H) product per row, 73,728 FLOPs at H = 96, far too little
// to fill an SM, and the 828 steps are strictly sequential.  The TPU walked the
// time axis as a sequential grid with (h, c) in scratch; here one block per
// batch row loops over all T steps itself, so nothing leaves the SM
// between steps:
//   * W_hh stays in shared memory for the whole sequence (H * 4H * 4 bytes,
//     147,456 B at H = 96: dynamic shared memory above the 48 KB static
//     limit, opted in with cudaFuncSetAttribute);
//   * thread j owns gate column j: it reads h from shared memory (a broadcast)
//     and W_hh[:, j] (consecutive threads, consecutive words: no bank
//     conflicts), and adds x_proj[b, t, j], which it loaded one step ahead so
//     the device-memory latency hides behind the previous step's product;
//   * the first H threads then own one unit of the state each, keep c in a
//     register and write h back to shared memory;
//   * the loop stops at the row's length, since its state freezes there.
// Two barriers per step remain; the product runs on the FP32 pipes in full
// f32, as the TPU kernel and the plain scan do.  The serving batch (B <= 8)
// leaves most SMs idle; that is inherent to the recurrence at this batch.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void lstm_last_hidden_kernel(const float* __restrict__ xp,
                                        const float* __restrict__ whh,
                                        const int* __restrict__ lengths,
                                        float* __restrict__ out, int T, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* w_s = smem;         // (H, 4H)
  float* h_s = w_s + H * G;  // (H,)
  float* g_s = h_s + H;      // (4H,)
  const int j = threadIdx.x;  // gate column; blockDim.x == 4H
  const int b = blockIdx.x;
  const float* x_row = xp + static_cast<long long>(b) * T * G;

  for (int i = j; i < H * G; i += G) w_s[i] = whh[i];
  if (j < H) h_s[j] = 0.f;
  const int len = max(0, min(lengths[b], T));
  float c = 0.f;  // state of unit j, for j < H
  float x_next = len > 0 ? x_row[j] : 0.f;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    float acc = x_next;
    if (t + 1 < len) x_next = x_row[(t + 1) * G + j];
#pragma unroll 8
    for (int k = 0; k < H; ++k) acc = fmaf(h_s[k], w_s[k * G + j], acc);
    g_s[j] = acc;
    __syncthreads();
    if (j < H) {
      const float ig = sigmoid(g_s[j]);
      const float fg = sigmoid(g_s[H + j]);
      const float gg = tanhf(g_s[2 * H + j]);
      const float og = sigmoid(g_s[3 * H + j]);
      c = fg * c + ig * gg;
      h_s[j] = og * tanhf(c);
    }
    __syncthreads();
  }
  if (j < H) out[b * H + j] = h_s[j];
}

}  // namespace

// Returns the launch's cudaError_t.  4H threads per block, so H <= 256; the
// shared-memory opt-in limit (227 KB) caps H at 119.
extern "C" int maunet_lstm_last_hidden(const void* x_proj, const void* w_hh,
                                       const void* lengths, void* out, int B,
                                       int T, int H, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (static_cast<size_t>(H) * 4 * H + 5 * H);
  cudaError_t err = cudaFuncSetAttribute(lstm_last_hidden_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_last_hidden_kernel<<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(w_hh),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, H);
  return static_cast<int>(cudaGetLastError());
}
