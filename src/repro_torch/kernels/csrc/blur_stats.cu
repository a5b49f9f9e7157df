// Streaming separable Gaussian blur + Eq. 12 statistics for Hopper
// (sm_90a): a batch of four-channel stacks [IWE, dIWE_x, dIWE_y, dIWE_z] in,
// the eight running sums [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz] of each blurred
// stack out, without writing a blurred image.
//
// Replaces src/repro/kernels/blur_stats.py::blur_stats_streaming (the
// row-block-grid Pallas TPU kernel with a line buffer carried from block to
// block). Plain C interface, built with nvcc and loaded through ctypes by
// repro_torch/kernels/_build.py; the Python wrapper and the plain PyTorch
// version of the same function live in repro_torch/kernels/blur_stats.py.
//
// Inputs (all on the device, row-major, contiguous):
//   ch        float [B, 4, H, W]   channel stacks (not padded)
//   fir       float [k]            Gaussian taps (odd k <= 15)
//   partial   float [B, n_blocks, 8]   scratch (per-row-block sums)
//   out       float [B, 8]
//
// Design.
//   * Grid (row block, window). A block owns `rb` output rows of one window.
//     The TPU kernel carries a (4, k-1, Wp) line buffer and the running sums
//     from grid step to grid step, which is legal only because TPU grid steps
//     run in order. CUDA blocks do not, so each block loads its rows plus the
//     k//2 halo rows above and below (zero outside [0, H)), blurs them in
//     shared memory, writes its partial sums, and a second kernel sums the
//     partials in row-block order. The blur and the sums are blur_sums.cuh,
//     the code the engine-pass megakernel uses.
//   * Determinism: every sum has a fixed order and there are no atomics, so
//     results are bitwise equal run to run and a window's sums do not depend
//     on its batch or slot.
//   * Shared memory per block: two [4][rb + k - 1][W] float planes (the
//     loaded rows and their horizontal FIR): 92,160 bytes at 240 x 180,
//     k = 9, rb = 16, so it is dynamic shared memory above the 48 KB default.
//   * What bounds it on the card: bytes. Per pixel it does 4 x 2k
//     multiply-adds and 12 operations for the sums; it reads each input
//     float once (plus (k-1)/rb halo rows) and writes 8 floats per block.
#include <cuda_runtime.h>

#include "blur_sums.cuh"

namespace {

using namespace cmax;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const float* __restrict__ ch,
                   const float* __restrict__ fir,
                   float* __restrict__ partial, int H, int W, int rb, int k,
                   int n_blocks) {
  extern __shared__ float smem[];
  __shared__ float taps[kMaxTaps];
  __shared__ float red[kWarps][kStats];

  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int rows = rb + k - 1;          // input rows, halo included
  const int plane = rows * W;
  float* in = smem;                     // [4][rows][W] channel rows
  float* hb = smem + 4 * plane;         // [4][rows][W] horizontal FIR
  const int r0 = blk * rb;              // first output row
  const int r_lo = r0 - k / 2;          // first input row
  const float* chb = ch + (size_t)b * 4 * H * W;

  if (threadIdx.x < k) taps[threadIdx.x] = fir[threadIdx.x];

  // ---- 1. load the block's rows of the four channels, zero beyond H ----
  for (int q = threadIdx.x; q < 4 * plane; q += kThreads) {
    const int c4 = q / plane;
    const int rem = q - c4 * plane;
    const int lr = rem / W;
    const int r = r_lo + lr;
    in[q] = (r >= 0 && r < H)
                ? chb[((size_t)c4 * H + r) * W + (rem - lr * W)]
                : 0.f;
  }
  __syncthreads();

  // ---- 2. horizontal FIR, zero beyond [0, W) ----
  fir_rows<kThreads>(in, hb, 4 * plane, W, k, taps);
  __syncthreads();

  // ---- 3. vertical FIR + Eq. 12 sums, 4. fixed-order block reduction ----
  float st[kStats];
  fir_cols_stats<kThreads>(hb, plane, min(rb, H - r0), W, k, taps, st);
  block_sums<kThreads>(st, &red[0][0],
                       partial + ((size_t)b * n_blocks + blk) * kStats);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (bytes).
long blur_stats_smem_bytes(int W, int rb, int k) {
  return 2L * 4L * (long)(rb + k - 1) * (long)W * (long)sizeof(float);
}

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
int blur_stats_launch(const float* ch, const float* fir, float* partial,
                      float* out, int B, int H, int W, int rb, int k,
                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || rb <= 0 || k < 1 || k > kMaxTaps ||
      (k % 2) == 0)
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (H + rb - 1) / rb;
  const long smem = blur_stats_smem_bytes(W, rb, k);
  cudaError_t err = cudaFuncSetAttribute(
      block_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  block_stats_kernel<<<dim3(n_blocks, B), kThreads, (size_t)smem, s>>>(
      ch, fir, partial, H, W, rb, k, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = B * kStats;
  part_sums_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(partial, out, B,
                                                       n_blocks);
  return (int)cudaGetLastError();
}

const char* blur_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
