// Batched CMAX engine pass for Hopper (sm_90a): warp -> bilinear vote ->
// separable Gaussian blur -> Eq. 12 eight-sum statistics, for a whole batch
// of event windows in one call.
//
// Replaces src/repro/kernels/megakernel.py::megakernel_stats (the fused
// (batch, slab)-grid Pallas TPU kernel). Plain C interface, built with nvcc
// and loaded through ctypes by repro_torch/kernels/_build.py; the Python
// wrapper and the plain PyTorch version of the same function live in
// repro_torch/kernels/megakernel.py.
//
// Inputs (all on the device, row-major, contiguous):
//   x, y, dt, pw   float [B, N]    event x, y, t - t_ref, polarity * weight
//   rec            int   [B, 4N]   tap records ordered by destination pixel:
//                                  record = tap * N + event, tap in 0..3 in
//                                  (dy, dx) order (0,0), (0,1), (1,0), (1,1)
//   pix_off        int   [B, H*W + 1]  CSR offsets of each pixel's records
//   omega          float [B, 3]    per-window rotation hypothesis
//   fir            float [k]       Gaussian taps (odd k <= 15)
//   partial        float [B, n_slabs, 8]   scratch (per-slab sums)
//   out            float [B, 8]    [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz]
//
// Design.
//   * Grid (slab, window). A block owns `rb` output rows of one window.
//     CUDA blocks run in no order, so the TPU kernel's line buffer carried
//     from slab to slab is not available: each block re-votes and
//     re-blurs the k-1 halo rows around its slab itself, writes its
//     partial sums to [B, n_slabs, 8], and a second kernel reduces them
//     in slab order. The blur and the sums are blur_sums.cuh, shared
//     with blur_stats.cu.
//   * No capacity, no spill. The prologue sorts the tap records by
//     destination pixel (stable, so a pixel's records stay in tap-major,
//     event order) and takes CSR offsets from the sorted keys. One
//     thread sums each pixel's run, so every pixel accumulates in a fixed
//     order: no float atomics anywhere, results are bitwise equal run to
//     run, and a window's result does not depend on the batch it is in.
//   * Warp rounding. A tap's pixel comes from the prologue's binning (the
//     CSR segment it sits in): x0 = col - dx, y0 = row - dy. The kernel
//     only recomputes the fractional parts ax, ay and the Jacobian rows,
//     so no tap can change pixel, whatever rounding the kernel's warp
//     gets. The file is also built with --fmad=false, so the arithmetic
//     is the plain version's op for op.
//   * Shared memory per block: two [4][rb + k - 1][W] float planes (the
//     vote and the horizontally blurred rows): 122,880 bytes at
//     240 x 180, k = 9, rb = 8, so it is dynamic shared memory above the
//     48 KB default.
//   * What bounds it on the card: bytes. The work is a few MFLOP per
//     window, far below the card's float32 rate; the inputs are ~1.5 MB per
//     40,000-event window. The design reads each record and offset once
//     per block (plus the halo rows' neighbours) and writes 8 floats per
//     slab; the gathers of x, y, dt, pw by event index hit L2.
#include <cuda_runtime.h>

#include "blur_sums.cuh"

namespace {

using namespace cmax;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Geometry {
  int N;        // events per window (row length of x, y, dt, pw)
  int H, W;     // stage grid
  int rb;       // output rows per block
  int k;        // FIR length (odd)
  int n_slabs;  // ceil(H / rb)
  float scale, fx, fy, cx, cy;
};

__global__ void __launch_bounds__(kThreads)
slab_stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ dt, const float* __restrict__ pw,
                  const int* __restrict__ rec,
                  const int* __restrict__ pix_off,
                  const float* __restrict__ omega,
                  const float* __restrict__ fir,
                  float* __restrict__ partial, Geometry g) {
  extern __shared__ float smem[];
  __shared__ float taps[kMaxTaps];
  __shared__ float red[kWarps][kStats];

  const int slab = blockIdx.x;
  const int b = blockIdx.y;
  const int W = g.W, H = g.H;
  const int half = g.k / 2;
  const int rows = g.rb + g.k - 1;       // vote rows, halo included
  const int plane = rows * W;
  float* acc = smem;                     // [4][rows][W] vote
  float* hb = smem + 4 * plane;          // [4][rows][W] horizontal FIR
  const int r0 = slab * g.rb;            // first output row
  const int r_lo = r0 - half;            // first vote row
  const int P = H * W;

  const float* xb = x + (size_t)b * g.N;
  const float* yb = y + (size_t)b * g.N;
  const float* dtb = dt + (size_t)b * g.N;
  const float* pwb = pw + (size_t)b * g.N;
  const int* recb = rec + (size_t)b * 4 * g.N;
  const int* offb = pix_off + (size_t)b * (P + 1);
  const float wx = omega[3 * b], wy = omega[3 * b + 1], wz = omega[3 * b + 2];

  if (threadIdx.x < g.k) taps[threadIdx.x] = fir[threadIdx.x];

  // ---- 1. vote: one thread per pixel sums its CSR run in record order ----
  for (int q = threadIdx.x; q < plane; q += kThreads) {
    const int lr = q / W;
    const int c = q - lr * W;
    const int r = r_lo + lr;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    if (r >= 0 && r < H) {
      const int p = r * W + c;
      const int end = offb[p + 1];
      for (int j = offb[p]; j < end; ++j) {
        const int code = recb[j];
        const int tap = code / g.N;
        const int e = code - tap * g.N;
        const int dy = tap >> 1, dx = tap & 1;
        const float ex = xb[e], ey = yb[e], edt = dtb[e], epw = pwb[e];
        // Alg. 2 warp, op for op as geometry.warp_events
        const float xn = (ex - g.cx) / g.fx;
        const float yn = (ey - g.cy) / g.fy;
        const float Bq = 1.0f + xn * xn;
        const float Dq = 1.0f + yn * yn;
        const float XY = xn * yn;
        const float u = g.fx * (XY * wx - Bq * wy + yn * wz);
        const float v = g.fy * (Dq * wx - XY * wy - xn * wz);
        const float xw = g.scale * (ex - edt * u);
        const float yw = g.scale * (ey - edt * v);
        // the pixel is the prologue's: only the fractions are recomputed
        const float ax = xw - (float)(c - dx);
        const float ay = yw - (float)(r - dy);
        const float sdt = g.scale * edt;
        const float rx0 = sdt * g.fx * XY, rx1 = -sdt * g.fx * Bq;
        const float rx2 = sdt * g.fx * yn;
        const float ry0 = sdt * g.fy * Dq, ry1 = -sdt * g.fy * XY;
        const float ry2 = -sdt * g.fy * xn;
        // bilinear weight and its derivative coefficients (iwe.py order)
        const float wxa = dx ? ax : (1.f - ax);
        const float wya = dy ? ay : (1.f - ay);
        const float wt = wxa * wya;
        const float cxc = dx ? -wya : wya;
        const float cyc = dy ? -wxa : wxa;
        s0 = s0 + epw * wt;
        s1 = s1 + epw * (cxc * rx0 + cyc * ry0);
        s2 = s2 + epw * (cxc * rx1 + cyc * ry1);
        s3 = s3 + epw * (cxc * rx2 + cyc * ry2);
      }
    }
    acc[q] = s0;
    acc[plane + q] = s1;
    acc[2 * plane + q] = s2;
    acc[3 * plane + q] = s3;
  }
  __syncthreads();

  // ---- 2. horizontal FIR, zero beyond [0, W) ----
  fir_rows<kThreads>(acc, hb, 4 * plane, W, g.k, taps);
  __syncthreads();

  // ---- 3. vertical FIR (vote rows outside [0, H) are zero) + Eq. 12 ----
  float st[kStats];
  fir_cols_stats<kThreads>(hb, plane, min(g.rb, H - r0), W, g.k, taps, st);

  // ---- 4. fixed-order block reduction -> partial[b, slab, :] ----
  block_sums<kThreads>(st, &red[0][0],
                       partial + ((size_t)b * g.n_slabs + slab) * kStats);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (bytes).
long megakernel_smem_bytes(int W, int rb, int k) {
  return 2L * 4L * (long)(rb + k - 1) * (long)W * (long)sizeof(float);
}

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
int megakernel_stats_launch(const float* x, const float* y, const float* dt,
                            const float* pw, const int* rec,
                            const int* pix_off, const float* omega,
                            const float* fir, float* partial, float* out,
                            int B, int N, int H, int W, int rb, int k,
                            float scale, float fx, float fy, float cx,
                            float cy, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || W <= 0 || rb <= 0 || k < 1 ||
      k > kMaxTaps || (k % 2) == 0)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.N = N; g.H = H; g.W = W; g.rb = rb; g.k = k;
  g.n_slabs = (H + rb - 1) / rb;
  g.scale = scale; g.fx = fx; g.fy = fy; g.cx = cx; g.cy = cy;
  const long smem = megakernel_smem_bytes(W, rb, k);
  cudaError_t err = cudaFuncSetAttribute(
      slab_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  slab_stats_kernel<<<dim3(g.n_slabs, B), kThreads, (size_t)smem, s>>>(
      x, y, dt, pw, rec, pix_off, omega, fir, partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = B * kStats;
  part_sums_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(partial, out, B,
                                                       g.n_slabs);
  return (int)cudaGetLastError();
}

const char* megakernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
