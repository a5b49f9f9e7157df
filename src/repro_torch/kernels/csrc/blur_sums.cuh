// Separable Gaussian blur of four channel planes held in shared memory, and
// the eight Eq. 12 sums of the blurred pixels, for Hopper (sm_90a).
//
// Used by megakernel.cu's slab kernel (blur_stats.cu takes only the
// constants). A block owns a band of output rows; its planes hold those
// rows plus the k-1 halo rows around them, so no state passes from block
// to block and the per-block partial sums are reduced afterwards in block
// order (part_sums_kernel). Every sum has a fixed order: the results are
// bitwise equal run to run.
#pragma once

#include <cuda_runtime.h>

namespace cmax {

constexpr int kMaxTaps = 15;
constexpr int kStats = 8;   // [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz]

// The vertical k-tap FIR of four horizontally blurred planes (`plane`
// floats apart; output row r reads plane rows r .. r+k-1) over `out_rows`
// rows of W, folded into this thread's share of the eight sums.
template <int NT>
__device__ __forceinline__ void fir_cols_stats(const float* hb, int plane,
                                               int out_rows, int W, int k,
                                               const float* taps,
                                               float st[kStats]) {
#pragma unroll
  for (int i = 0; i < kStats; ++i) st[i] = 0.f;
  for (int q = threadIdx.x; q < out_rows * W; q += NT) {
    const int orow = q / W;
    const int c = q - orow * W;
    float v[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float* col = hb + ch * plane + orow * W + c;
      float s = 0.f;
      for (int j = 0; j < k; ++j) s = s + taps[j] * col[j * W];
      v[ch] = s;
    }
    const float I = v[0];
    st[0] += I;
    st[1] += I * I;
    st[2] += I * v[1];
    st[3] += I * v[2];
    st[4] += I * v[3];
    st[5] += v[1];
    st[6] += v[2];
    st[7] += v[3];
  }
}

// Fixed-order block sum of every thread's st: warp shuffles, then warps in
// order. `red` is shared scratch of (NT / 32) * kStats floats; thread
// i < kStats writes sum i to dst[i].
template <int NT>
__device__ __forceinline__ void block_sums(const float st[kStats],
                                           float* red, float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kStats; ++i) {
    float s = st[i];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * kStats + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * kStats + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// out[b, i] = sum over the n_parts partial sums of window b, in order.
__global__ void part_sums_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int B,
                                 int n_parts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * kStats) return;
  const int b = t / kStats, i = t - b * kStats;
  const float* p = partial + (size_t)b * n_parts * kStats + i;
  float s = 0.f;
  for (int part = 0; part < n_parts; ++part) s += p[part * kStats];
  out[t] = s;
}

}  // namespace cmax
