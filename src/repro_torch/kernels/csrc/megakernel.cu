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
//   key            int   [B, 4N]   each record's destination pixel (the
//                                  prologue's sorted keys; H*W past the
//                                  live records)
//   omega          float [B, 3]    per-window rotation hypothesis
//   fir            float [k]       Gaussian taps (odd k <= 15)
// Scratch, allocated by the wrapper:
//   ev4            float4 [B, N]   (x, y, dt, pw) of each event
//   img            float [B, 4, H, W]  the vote: IWE and its 3 derivatives
//   partial        float [B, n_slabs, 8]   per-slab sums
// Output:
//   out            float [B, 8]    [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz]
//
// Design: four launches on one stream, one call.
//   1. pack_events_kernel: (x, y, dt, pw) of every event into one float4,
//      so each record below gathers its event with one 16-byte load.
//   2. vote_kernel, grid (pixel range, window): a block owns `vote_pixels`
//      consecutive pixels of one window and so one contiguous range of the
//      pixel-sorted records, pix_off[p0] .. pix_off[p0 + vote_pixels].
//      In chunks of kChunk records:
//        record-parallel: consecutive threads take consecutive records,
//        read rec and key coalesced, gather the event, and write the
//        record's four deltas to shared memory; each thread has the loads
//        of its 8 records of the chunk in flight at once, where one thread
//        walking each pixel's run would wait on a chain of dependent
//        loads per record;
//        pixel-parallel: the thread of each pixel adds its part of the
//        chunk in record order, carrying its four sums in registers from
//        chunk to chunk.
//      Each pixel therefore sums its records in record order, as the plain
//      version does, and each pixel is voted once: the
//      vote goes to `img` (5.5 MB at B = 8, 240 x 180: it stays in L2), not
//      re-voted as a halo by every slab that needs it.
//   3. slab_stats_kernel, grid (slab, window): a block of 512 threads owns
//      `rb` output rows; it blurs the k-1 halo rows around them
//      horizontally straight from `img` into shared memory (one
//      [4][rb + k - 1][W] plane set; one warp per input row, and the
//      kernel is built for each odd k so that a lane's k loads are in
//      flight together), then runs the vertical FIR and the Eq. 12 sums of
//      blur_sums.cuh and writes its 8 partial sums.
//   4. part_sums_kernel sums each window's slab partials in slab order.
// No float atomics anywhere; every sum has a fixed order, so results are
// bitwise equal run to run, and neither the vote's pixel ranges nor the
// slabs depend on the batch: a window's stats do not depend on its batch
// or slot.
//
// Warp rounding. A tap's pixel is the prologue's (its key): x0 = col - dx,
// y0 = row - dy. The kernel only recomputes the fractional parts ax, ay and
// the Jacobian rows, so no tap can change pixel, whatever rounding the
// kernel's warp gets. The file is also built with --fmad=false, so the
// arithmetic is the plain version's op for op.
//
// What bounds it on the card: neither bytes nor operations at these sizes
// but latency: the record gathers (L2), the longest pixel run of a warp in
// the fold, and four dependent launches. The vote's shared memory is
// 33 KB per 256-thread block (up to 6 blocks per SM); the slab kernel's is
// 16 (rb + k - 1) W bytes (61,440 at 240 x 180, k = 9, rb = 8), and its
// registers are held to two blocks of 16 warps per SM.
#include <cuda_runtime.h>

#include "blur_sums.cuh"

namespace {

using namespace cmax;

constexpr int kThreads = 256;
constexpr int kChunk = 2048;          // records staged in shared memory
constexpr int kPerThread = kChunk / kThreads;
constexpr int kStatsThreads = 512;    // threads of a slab block
constexpr int kMaxVotePixels = kThreads;

struct Geometry {
  int N;        // events per window (row length of x, y, dt, pw)
  int H, W;     // stage grid
  int rb;       // output rows per slab
  int n_slabs;  // ceil(H / rb)
  int vote_pixels;   // pixels per vote block
  float inv_w;       // 1 / W
  float scale, fx, fy, cx, cy;
};

__global__ void pack_events_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ dt,
                                   const float* __restrict__ pw,
                                   float4* __restrict__ ev4, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ev4[i] = make_float4(x[i], y[i], dt[i], pw[i]);
}

// The four vote deltas [IWE, dIWE_x, dIWE_y, dIWE_z] of bilinear tap
// `tap` of event `ev` = (x, y, t - t_ref, polarity * weight), whose
// destination pixel is (row, col): the Alg. 2 warp, op for op as
// geometry.warp_events, then the bilinear weight and its derivative
// coefficients in iwe.py's order.
__device__ __forceinline__ float4 tap_delta(int tap, int row, int col,
                                            float4 ev, float wx, float wy,
                                            float wz, const Geometry& g) {
  const int dy = tap >> 1, dx = tap & 1;
  const float ex = ev.x, ey = ev.y, edt = ev.z, epw = ev.w;
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
  const float ax = xw - (float)(col - dx);
  const float ay = yw - (float)(row - dy);
  const float sdt = g.scale * edt;
  const float rx0 = sdt * g.fx * XY, rx1 = -sdt * g.fx * Bq;
  const float rx2 = sdt * g.fx * yn;
  const float ry0 = sdt * g.fy * Dq, ry1 = -sdt * g.fy * XY;
  const float ry2 = -sdt * g.fy * xn;
  const float wxa = dx ? ax : (1.f - ax);
  const float wya = dy ? ay : (1.f - ay);
  const float wt = wxa * wya;
  const float cxc = dx ? -wya : wya;
  const float cyc = dy ? -wxa : wxa;
  return make_float4(epw * wt, epw * (cxc * rx0 + cyc * ry0),
                     epw * (cxc * rx1 + cyc * ry1),
                     epw * (cxc * rx2 + cyc * ry2));
}

// key / W for a pixel key (< 2^24): a float reciprocal, corrected to the
// exact quotient.
__device__ __forceinline__ int div_w(int key, const Geometry& g) {
  int q = (int)((float)key * g.inv_w);
  if (q * g.W > key) --q;
  if ((q + 1) * g.W <= key) ++q;
  return q;
}

__global__ void __launch_bounds__(kThreads)
vote_kernel(const float4* __restrict__ ev4, const int* __restrict__ rec,
            const int* __restrict__ key, const int* __restrict__ pix_off,
            const float* __restrict__ omega, float* __restrict__ img,
            Geometry g) {
  __shared__ float4 s_d[kChunk];
  __shared__ int s_off[kMaxVotePixels + 1];

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int P = g.H * g.W;
  const int p0 = blockIdx.x * g.vote_pixels;
  const int npix = min(g.vote_pixels, P - p0);
  const float4* evb = ev4 + (size_t)b * g.N;
  const int* recb = rec + (size_t)b * 4 * g.N;
  const int* keyb = key + (size_t)b * 4 * g.N;
  const int* offb = pix_off + (size_t)b * (P + 1) + p0;
  const float wx = omega[3 * b], wy = omega[3 * b + 1], wz = omega[3 * b + 2];

  for (int i = t; i <= npix; i += kThreads) s_off[i] = offb[i];
  __syncthreads();
  const int j_lo = s_off[0], j_hi = s_off[npix];
  const int run_lo = t < npix ? s_off[t] : 0;
  const int run_hi = t < npix ? s_off[t + 1] : 0;

  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int c0 = j_lo; c0 < j_hi; c0 += kChunk) {
    const int n = min(kChunk, j_hi - c0);
    // record-parallel: the deltas of records c0 .. c0 + n, with every
    // load of a thread's kPerThread records in flight at once
    int kk[kPerThread], code[kPerThread];
    float4 ev[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = t + u * kThreads;
      kk[u] = i < n ? keyb[c0 + i] : 0;
      code[u] = i < n ? recb[c0 + i] : 0;
    }
    int tap[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      // code = tap * N + event with tap in 0..3: three compares, no divide
      tap[u] = (code[u] >= g.N) + (code[u] >= 2 * g.N) + (code[u] >= 3 * g.N);
      if (t + u * kThreads < n) ev[u] = evb[code[u] - tap[u] * g.N];
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = t + u * kThreads;
      if (i < n) {
        const int row = div_w(kk[u], g);
        s_d[i] = tap_delta(tap[u], row, kk[u] - row * g.W, ev[u], wx, wy, wz,
                           g);
      }
    }
    __syncthreads();
    // pixel-parallel: each pixel's part of the chunk, in record order
    const int hi = min(run_hi, c0 + n);
    for (int j = max(run_lo, c0); j < hi; ++j) {
      const float4 d = s_d[j - c0];
      s0 = s0 + d.x;
      s1 = s1 + d.y;
      s2 = s2 + d.z;
      s3 = s3 + d.w;
    }
    __syncthreads();   // the next chunk overwrites s_d
  }
  if (t < npix) {
    float* ib = img + (size_t)b * 4 * P + p0 + t;
    ib[0] = s0;
    ib[P] = s1;
    ib[2 * P] = s2;
    ib[3 * P] = s3;
  }
}

template <int K>
__global__ void __launch_bounds__(kStatsThreads, 2)
slab_stats_kernel(const float* __restrict__ img,
                  const float* __restrict__ fir,
                  float* __restrict__ partial, Geometry g) {
  extern __shared__ float hb[];          // [4][rb + K - 1][W]
  __shared__ float taps[kMaxTaps];
  __shared__ float red[kStatsThreads / 32][kStats];

  constexpr int half = K / 2;
  const int slab = blockIdx.x;
  const int b = blockIdx.y;
  const int W = g.W, H = g.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = g.rb + K - 1;         // input rows, halo included
  const int plane = rows * W;
  const int r0 = slab * g.rb;            // first output row
  const int r_lo = r0 - half;            // first input row
  const float* ib = img + (size_t)b * 4 * H * W;

  if (threadIdx.x < K) taps[threadIdx.x] = fir[threadIdx.x];
  __syncthreads();
  float tap[K];
#pragma unroll
  for (int j = 0; j < K; ++j) tap[j] = taps[j];

  // ---- 1. horizontal FIR of the input rows straight from the vote, zero
  //         beyond [0, W); rows outside [0, H) are zero. One warp per
  //         input row, lanes across its columns (fir_rows' sum, tap by
  //         tap) ----
  for (int rr = warp; rr < 4 * rows; rr += kStatsThreads / 32) {
    const int ch = rr / rows;
    const int r = r_lo + rr - ch * rows;
    float* dst = hb + rr * W;
    if (r < 0 || r >= H) {
      for (int c = lane; c < W; c += 32) dst[c] = 0.f;
      continue;
    }
    const float* row = ib + ((size_t)ch * H + r) * W;
#pragma unroll 2
    for (int c = lane; c < W; c += 32) {
      float v[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int cc = c + j - half;
        v[j] = cc >= 0 && cc < W ? row[cc] : 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int cc = c + j - half;
        if (cc >= 0 && cc < W) s = s + tap[j] * v[j];
      }
      dst[c] = s;
    }
  }
  __syncthreads();

  // ---- 2. vertical FIR + Eq. 12, 3. fixed-order block reduction ----
  float st[kStats];
  fir_cols_stats<kStatsThreads>(hb, plane, min(g.rb, H - r0), W, K, taps,
                                st);
  block_sums<kStatsThreads>(st, &red[0][0],
                            partial + ((size_t)b * g.n_slabs + slab) *
                                          kStats);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one slab block (bytes), and the largest pixel
// range of one vote block. The wrapper's launch_config chooses the grid and
// the launcher below rejects a range it cannot take; these two let a test
// hold launch_config to this file once, not every call.
long megakernel_smem_bytes(int W, int rb, int k) {
  return 4L * (long)(rb + k - 1) * (long)W * (long)sizeof(float);
}

int megakernel_max_vote_pixels() { return kMaxVotePixels; }

// Launches the four kernels on `stream`; returns the CUDA error code
// (0 = ok).
int megakernel_stats_launch(const float* x, const float* y, const float* dt,
                            const float* pw, const int* rec,
                            const int* pix_off, const int* key,
                            const float* omega, const float* fir,
                            void* ev4, float* img, float* partial,
                            float* out, int B, int N, int H, int W, int rb,
                            int k, int vote_pixels, float scale, float fx,
                            float fy, float cx, float cy, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || W <= 0 || rb <= 0 || k < 1 ||
      k > kMaxTaps || (k % 2) == 0 || vote_pixels <= 0 ||
      vote_pixels > kMaxVotePixels)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.N = N; g.H = H; g.W = W; g.rb = rb;
  g.n_slabs = (H + rb - 1) / rb;
  g.vote_pixels = vote_pixels;
  g.inv_w = 1.0f / (float)W;
  g.scale = scale; g.fx = fx; g.fy = fy; g.cx = cx; g.cy = cy;
  const long smem = megakernel_smem_bytes(W, rb, k);
  void (*slab_stats)(const float*, const float*, float*, Geometry) =
      k == 1 ? slab_stats_kernel<1> : k == 3 ? slab_stats_kernel<3>
      : k == 5 ? slab_stats_kernel<5> : k == 7 ? slab_stats_kernel<7>
      : k == 9 ? slab_stats_kernel<9> : k == 11 ? slab_stats_kernel<11>
      : k == 13 ? slab_stats_kernel<13> : slab_stats_kernel<15>;
  cudaError_t err = cudaFuncSetAttribute(
      slab_stats, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float4* ev = static_cast<float4*>(ev4);
  const long n_ev = (long)B * N;
  pack_events_kernel<<<(unsigned)((n_ev + 255) / 256), 256, 0, s>>>(
      x, y, dt, pw, ev, n_ev);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = H * W;
  vote_kernel<<<dim3((P + vote_pixels - 1) / vote_pixels, B), kThreads, 0,
                s>>>(ev, rec, key, pix_off, omega, img, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slab_stats<<<dim3(g.n_slabs, B), kStatsThreads, (size_t)smem, s>>>(
      img, fir, partial, g);
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
