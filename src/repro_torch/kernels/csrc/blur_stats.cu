// Streaming separable Gaussian blur + Eq. 12 statistics for Hopper
// (sm_90a): a batch of four-channel stacks [IWE, dIWE_x, dIWE_y, dIWE_z] in,
// the eight running sums [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz] of each blurred
// stack out, without writing a blurred image.
//
// Replaces src/repro/kernels/blur_stats.py::blur_stats_streaming (the
// row-block-grid Pallas TPU kernel with a line buffer carried from block to
// block). Plain C interface, built with nvcc and loaded through ctypes by
// repro_torch/kernels/_build.py; the Python wrapper, the plain PyTorch
// version of the same function and the launch geometry (launch_config, its
// one owner) live in repro_torch/kernels/blur_stats.py.
//
// Inputs (all on the device, row-major, contiguous):
//   ch        float [B, 4, H, W]   channel stacks (not padded)
//   fir       float [k]            Gaussian taps (odd k <= 15)
//   partial   float [B, items, 8]  scratch: each item's sums
//   count     int   [>= B]         tickets, zero before and after a launch
//   out       float [B, 8]
//
// Design: column streaming with a register line buffer, one launch.
//   * Grid (item, window), one warp a block. A window's output is cut into
//     strips of 64 columns and bands of `band_rows` rows; block x of a
//     window owns item x: band x / n_strips, strip x % n_strips. Each lane
//     owns two adjacent output columns.
//   * Loads in flight. The warp stages its band's input rows (the band plus
//     k//2 halo rows above and below) of the four channels, 64 + 2 pad
//     columns each (pad = k//2 rounded up to 4), in shared memory, issuing
//     every copy at once: where W % 4 == 0 and the stack is 16-byte aligned
//     (every stage of the paper) one bulk copy (cp.async.bulk, the TMA's
//     1-D form) per row segment, completion counted on an mbarrier, and the
//     columns and rows outside the image zeroed with stores; otherwise
//     4-byte cp.async copies with zero fill. A band of kSplitRows input
//     rows or more comes in two parts, so the FIRs of the first part run
//     while the second is in flight.
//   * Register line buffer. Each lane runs the horizontal FIR at its columns
//     from the staged rows and keeps the results in a k-deep line buffer
//     of registers per channel and column (the TPU kernel's line buffer);
//     once k rows are in, each new row completes the vertical FIR of one
//     output row, folded straight into the lane's eight sums (columns past
//     W are not folded). k is a template parameter (every odd k <= 15), so
//     every tap loop unrolls, no division or bounds check is left in the
//     row loop, and the row loop unrolled k times turns the line buffer's
//     shifts into register renaming. The FIRs use fused multiply-adds
//     (__fmaf_rn), taps in order; everything else follows the file's
//     --fmad=false.
//   * One launch per call. Each block writes its item's sums to `partial`
//     and takes a ticket (an integer atomic, acquire-release); the last
//     block of a window adds every item's sums in a fixed order (lane l
//     items l, l + 32, ..., then a fixed shuffle tree) and puts the ticket
//     back to zero for the next call. The wrapper keeps one ticket buffer
//     per stream, so calls on two streams never share one.
//   * Determinism: no float atomics, every sum has a fixed order, and the
//     geometry is a function of (H, W, k) only, never of B: results are
//     bitwise equal run to run and a window's sums do not depend on its
//     batch or slot.
//   * What bounds it on the card: neither the function's bytes (the stack
//     once) nor its operations (16k + 12 per pixel) but latency: the
//     launch, one round trip for the staged rows, each warp's walk down its
//     band (a chain of dependent FIR steps per row), and the ticket's round
//     trips. Short bands (about 128 items a window) keep the walk short and
//     give B = 1 as many SMs as the halo allows; they cost staged bytes
//     (at 240 x 180, k = 9: bands of 6 rows stage 14, and 4 strips of 64
//     columns stage 4 x 72 for 240, 2.8x the stack, read from L2) and the
//     halo rows' horizontal FIR.
#include <cuda_runtime.h>

#include "blur_sums.cuh"

namespace {

using namespace cmax;

constexpr int kWarp = 32;
constexpr int kCols = 2;             // adjacent output columns of a lane
constexpr int kStrip = kWarp * kCols;
constexpr int kSplitRows = 12;       // bands this tall come in two parts

// Staged halo columns each side of a strip: k // 2 rounded up to 4, so
// that 16-byte copies stay aligned.
__host__ __device__ constexpr int pad_cols(int k) {
  return (k / 2 + 3) / 4 * 4;
}

// The launch geometry, chosen by launch_config in blur_stats.py.
struct Layout {
  int H, W;
  int n_strips, n_bands, band_rows;  // work items of a window
  int vec;   // 1: 16-byte copies (W % 4 == 0, 16-byte aligned stack)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 or 1) of this thread's copy groups are
// in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of bulk copies on `bar`.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of `bar` with parity `phase` has completed (a
// block uses each of its barriers once: phase 0).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage rows in0 + lo .. in0 + hi - 1 with bulk copies counted on `bar`
// (W % 4 == 0, 16-byte aligned stack): each (row, channel) segment's
// columns inside [0, W) are one copy, one lane a segment; the columns
// outside, and rows outside [0, H), are zeroed with plain stores.
template <int SEG>
__device__ __forceinline__ void stage_rows_bulk(float* dst, const float* chb,
                                                int in0, int lo, int hi,
                                                int x0, const Layout& g,
                                                int lane,
                                                unsigned long long* bar) {
  const int x_lo = max(x0, 0), x_hi = min(x0 + SEG, g.W);
  const int r_lo = max(in0 + lo, 0), r_hi = min(in0 + hi, g.H);
  if (lane == 0)
    mbar_expect(bar, (unsigned)(max(r_hi - r_lo, 0) * 4 * (x_hi - x_lo) * 4));
  __syncwarp();
  for (int q = lo * 4 + lane; q < hi * 4; q += kWarp) {
    const int r = in0 + (q >> 2), c4 = q & 3;
    float4* seg = reinterpret_cast<float4*>(dst + q * SEG);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && r < g.H) {
      bulk_copy(dst + q * SEG + (x_lo - x0),
                chb + ((size_t)c4 * g.H + r) * g.W + x_lo,
                (unsigned)(x_hi - x_lo) * 4, bar);
      // x_lo - x0 and x_hi - x0 are multiples of 4
      for (int c = 0; c < (x_lo - x0) / 4; ++c) seg[c] = zero;
      for (int c = (x_hi - x0) / 4; c < SEG / 4; ++c) seg[c] = zero;
    } else {
      for (int c = 0; c < SEG / 4; ++c) seg[c] = zero;
    }
  }
}

// Stage rows in0 + lo .. in0 + hi - 1 (zero outside [0, H)) of the four
// channels, columns [x0, x0 + SEG) (zero outside [0, W)), at dst + row *
// 4 * SEG, with 4-byte copies as one copy group of this thread (any W,
// any alignment).
template <int SEG>
__device__ __forceinline__ void stage_rows(float* dst, const float* chb,
                                           int in0, int lo, int hi, int x0,
                                           const Layout& g, int lane) {
  for (int q = lo * 4 * SEG + lane; q < hi * 4 * SEG; q += kWarp) {
    const int rc = q / SEG, x = x0 + (q - rc * SEG);
    const int r = in0 + (rc >> 2), c4 = rc & 3;
    const bool ok = r >= 0 && r < g.H && x >= 0 && x < g.W;
    cp_async4(dst + q, ok ? chb + ((size_t)c4 * g.H + r) * g.W + x : chb,
              ok ? 4 : 0);
  }
  cp_async_commit();
}

// One warp streams one (strip, band) item into this lane's sums `st`.
template <int K>
__device__ __forceinline__ void stream_item(const float* chb, float* band_smem,
                                            const float (&tap)[K], int strip,
                                            int band, const Layout& g,
                                            int lane, float (&st)[kStats],
                                            unsigned long long* bars) {
  constexpr int half = K / 2;
  constexpr int PAD = pad_cols(K);
  constexpr int SEG = kStrip + 2 * PAD;
  // a lane's inputs: staged columns 2 lane + PAD - half .. + K, read as
  // float2 pairs from the even column at or before the first
  constexpr int SKEW = (PAD - half) & 1;
  constexpr int NX = (SKEW + K + kCols - 1 + 1) / 2 * 2;   // floats read
  const int c0 = strip * kStrip;              // first output column
  const int r0 = band * g.band_rows;          // first output row
  const int n_in = min(g.band_rows, g.H - r0) + K - 1;
  const int in0 = r0 - half;                  // first input row
  const bool fold0 = c0 + kCols * lane < g.W;
  const bool fold1 = c0 + kCols * lane + 1 < g.W;

  // every copy of the band is issued now, in one or two parts of rows;
  // each part is waited for just before its first row is read
  const int n_parts = n_in >= kSplitRows ? 2 : 1;
  const int part = (n_in + n_parts - 1) / n_parts;
  for (int p = 0; p < n_parts; ++p) {
    const int lo = p * part, hi = min(lo + part, n_in);
    if (g.vec)
      stage_rows_bulk<SEG>(band_smem, chb, in0, lo, hi, c0 - PAD, g, lane,
                           bars + p);
    else
      stage_rows<SEG>(band_smem, chb, in0, lo, hi, c0 - PAD, g, lane);
  }

  // acc[n][c4][j]: the vertical FIR, so far, of column n's output row j
  // rows above the newest input row; each input row adds its term to all
  // K in tap order, so every output sums its taps j = 0 .. K-1 in order
  float acc[kCols][4][K];
#pragma unroll
  for (int n = 0; n < kCols; ++n)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
      for (int j = 0; j < K; ++j) acc[n][c4][j] = 0.f;
  const float* base = band_smem + kCols * lane + (PAD - half - SKEW);
  for (int p = 0; p < n_parts; ++p) {
    if (g.vec)
      mbar_wait(bars + p, 0);
    else
      cp_async_wait(n_parts - 1 - p);
    __syncwarp();   // every lane's copies and zeros of part p have landed
    const int i1 = min(p * part + part, n_in);
#pragma unroll (K)
    for (int i = p * part; i < i1; ++i) {
      float v[kCols][4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const float2* row =
            reinterpret_cast<const float2*>(base + (i * 4 + c4) * SEG);
        float x[NX];
#pragma unroll
        for (int m = 0; m < NX / 2; ++m) {
          const float2 q = row[m];
          x[2 * m] = q.x;
          x[2 * m + 1] = q.y;
        }
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          // horizontal FIR at column c0 + 2 lane + n, taps in order
          float h = tap[0] * x[SKEW + n];
#pragma unroll
          for (int j = 1; j < K; ++j)
            h = __fmaf_rn(tap[j], x[SKEW + n + j], h);
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc[n][c4][j] = __fmaf_rn(tap[K - 1 - j], h, acc[n][c4][j]);
          v[n][c4] = acc[n][c4][0];   // complete once K rows are in
#pragma unroll
          for (int j = 0; j < K - 1; ++j) acc[n][c4][j] = acc[n][c4][j + 1];
          acc[n][c4][K - 1] = 0.f;
        }
      }
      if (i >= K - 1) {
#pragma unroll
        for (int n = 0; n < kCols; ++n) {
          if (n == 0 ? fold0 : fold1) {
            const float I = v[n][0];
            st[0] += I;
            st[1] = __fmaf_rn(I, I, st[1]);
            st[2] = __fmaf_rn(I, v[n][1], st[2]);
            st[3] = __fmaf_rn(I, v[n][2], st[3]);
            st[4] = __fmaf_rn(I, v[n][3], st[4]);
            st[5] += v[n][1];
            st[6] += v[n][2];
            st[7] += v[n][3];
          }
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kWarp)
blur_stats_kernel(const float* __restrict__ ch, const float* __restrict__ fir,
                  float* __restrict__ partial, int* __restrict__ count,
                  float* __restrict__ out, Layout g) {
  extern __shared__ __align__(16) float smem[];   // [band rows][4][SEG]
  __shared__ unsigned long long bars[2];
  const int item = blockIdx.x, n_items = gridDim.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const float* chb = ch + (size_t)b * 4 * g.H * g.W;

  if (lane < 2) mbar_init(&bars[lane]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  float tap[K];
#pragma unroll
  for (int j = 0; j < K; ++j) tap[j] = __ldg(fir + j);
  float st[kStats];
#pragma unroll
  for (int i = 0; i < kStats; ++i) st[i] = 0.f;
  const int band = item / g.n_strips;
  stream_item<K>(chb, smem, tap, item - band * g.n_strips, band, g, lane, st,
                 bars);

  // the item's sums: lanes by a fixed shuffle tree
#pragma unroll
  for (int i = 0; i < kStats; ++i)
    for (int o = kWarp / 2; o > 0; o >>= 1)
      st[i] += __shfl_down_sync(0xffffffffu, st[i], o);
  float4* part4 = reinterpret_cast<float4*>(partial) +
                  ((size_t)b * n_items + item) * 2;
  int ticket = 0;
  if (lane == 0) {
    part4[0] = make_float4(st[0], st[1], st[2], st[3]);
    part4[1] = make_float4(st[4], st[5], st[6], st[7]);
    // release: the partial is visible before the ticket is taken;
    // acquire: the last item sees every other item's partial
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(count + b)
                 : "memory");
  }
  if (__shfl_sync(0xffffffffu, ticket, 0) != n_items - 1) return;

  // the window's last item adds every item's partial in a fixed order:
  // lane l takes items l, l + 32, ... in turn, then a fixed shuffle tree
  __syncwarp();
  const float4* win4 =
      reinterpret_cast<const float4*>(partial) + (size_t)b * n_items * 2;
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  for (int i = lane; i < n_items; i += kWarp) {
    const float4 a = __ldcg(win4 + 2 * i), c = __ldcg(win4 + 2 * i + 1);
    lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
    hi.x += c.x; hi.y += c.y; hi.z += c.z; hi.w += c.w;
  }
  float sum[kStats] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < kStats; ++i)
    for (int o = kWarp / 2; o > 0; o >>= 1)
      sum[i] += __shfl_down_sync(0xffffffffu, sum[i], o);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kStats; ++i) out[(size_t)b * kStats + i] = sum[i];
    count[b] = 0;   // ready for the next call on this stream
  }
}

template <int K>
cudaError_t launch(const float* ch, const float* fir, float* partial,
                   int* count, float* out, int B, int n_items,
                   const Layout& g, int smem, cudaStream_t s) {
  void (*kern)(const float*, const float*, float*, int*, float*, Layout) =
      blur_stats_kernel<K>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)n_items, (unsigned)B), kWarp, (size_t)smem, s>>>(
      ch, fir, partial, count, out, g);
  return cudaGetLastError();
}

cudaError_t launch_k(int k, const float* ch, const float* fir,
                     float* partial, int* count, float* out, int B,
                     int n_items, const Layout& g, int smem, cudaStream_t s) {
#define BLUR_CASE(K)                                                       \
  case K:                                                                  \
    return launch<K>(ch, fir, partial, count, out, B, n_items, g, smem, s);
  switch (k) {
    BLUR_CASE(1) BLUR_CASE(3) BLUR_CASE(5) BLUR_CASE(7)
    BLUR_CASE(9) BLUR_CASE(11) BLUR_CASE(13) BLUR_CASE(15)
    default: return cudaErrorInvalidValue;
  }
#undef BLUR_CASE
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with the geometry launch_config chose;
// returns the CUDA error code (0 = ok). The checks below only refuse a
// geometry under which the kernel would read or write out of bounds.
int blur_stats_launch(const float* ch, const float* fir, float* partial,
                      int* count, float* out, int B, int H, int W, int k,
                      int n_strips, int n_bands, int band_rows, int pad,
                      int seg, int smem, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || k < 1 || k > kMaxTaps || k % 2 == 0 ||
      band_rows < 1 || n_strips * kStrip < W || n_bands * band_rows < H ||
      pad != pad_cols(k) || seg != kStrip + 2 * pad ||
      (long)smem < (long)(band_rows + k - 1) * 4 * seg * (long)sizeof(float) ||
      (vec && (W % 4 != 0 || (reinterpret_cast<size_t>(ch) & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  Layout g;
  g.H = H; g.W = W;
  g.n_strips = n_strips; g.n_bands = n_bands; g.band_rows = band_rows;
  g.vec = vec;
  return (int)launch_k(k, ch, fir, partial, count, out, B,
                       n_strips * n_bands, g, smem, (cudaStream_t)stream);
}

const char* blur_stats_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
