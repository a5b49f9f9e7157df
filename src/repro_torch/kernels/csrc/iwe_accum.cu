// Tile-partitioned IWE / dIWE accumulation for Hopper (sm_90a): for every
// spatial tile of every window, the one-hot contraction
//
//     out[tile, p, c] = sum over slots e of
//                       [pix[tile, e] == p] * delta[tile, e, c]
//
// of the tile's packed tap records into a (P_TILE, 4) f32 partial image.
//
// Replaces src/repro/kernels/iwe_accum.py::tile_accumulate (one Pallas TPU
// grid step per tile, the contraction as an MXU dot). Plain C interface,
// built with nvcc and loaded through ctypes by repro_torch/kernels/_build.py;
// the Python wrapper and the plain PyTorch version of the same function live
// in repro_torch/kernels/iwe_accum.py.
//
// Inputs (all on the device, row-major, contiguous):
//   pix      int          [n_tiles, cap]      local pixel of each slot in
//                                             [0, p_tile); -1 = empty slot
//   deltas   float | bf16 [n_tiles, cap, 4]   [IWE, dIWE_x, dIWE_y, dIWE_z]
//   out      float        [n_tiles, p_tile, 4]
// n_tiles is windows x tiles: the wrapper folds the window axis in.
//
// Design.
//   * One block per tile. Thread t owns the kPix output pixels
//     [kPix t, kPix t + kPix) and keeps their 4 channels in registers.
//   * The contraction is the TPU kernel's one-hot product written as a
//     loop: the tile's slots are staged through shared memory in chunks of
//     kChunk, and every thread walks each chunk in slot order, adding the
//     records whose pixel it owns. Each output pixel is summed by one thread
//     in slot order: no atomics, bitwise equal run to run, and a window's
//     tiles do not depend on the batch they are in. Slots may hold any
//     order and empty slots anywhere, as the TPU kernel allows.
//   * A first pass finds the last occupied slot of the tile; the walk stops
//     there, so a tile that is far from full costs what it holds.
//   * bf16 deltas are widened to f32 as they are staged; accumulation is
//     always f32 (the TPU kernel's preferred_element_type).
//   * What bounds it on the card: neither bytes nor operations but the walk.
//     The function needs one read of each slot (4 + 16 bytes) and 4 adds per
//     record; the walk costs every thread of the block one shared-memory
//     read and compare per occupied slot (p_tile / kPix compares per slot).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;       // slots staged in shared memory at once
constexpr int kPix = 4;            // output pixels per thread
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float4 load_delta(const float* d, size_t slot) {
  return reinterpret_cast<const float4*>(d)[slot];
}

__device__ __forceinline__ float4 load_delta(const __nv_bfloat16* d,
                                             size_t slot) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(d) +
                            2 * slot;
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
tile_accumulate_kernel(const int* __restrict__ pix,
                       const T* __restrict__ deltas,
                       float* __restrict__ out, int cap, int p_tile) {
  __shared__ int s_pix[kChunk];
  __shared__ float4 s_delta[kChunk];
  __shared__ int s_last[kMaxThreads / 32];

  const size_t tile = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int* pt = pix + tile * cap;
  const size_t slot0 = tile * cap;

  // ---- 1. one past the last occupied slot (integer max: exact) ----
  int last = -1;
  for (int j = t; j < cap; j += nt)
    if (pt[j] >= 0) last = j;
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_down_sync(0xffffffffu, last, off));
  if ((t & 31) == 0) s_last[t >> 5] = last;
  __syncthreads();
  int used = -1;
  for (int w = 0; w < nt / 32; ++w) used = max(used, s_last[w]);
  used += 1;

  // ---- 2. the one-hot contraction, slot by slot ----
  float a[kPix][4];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
    a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
  for (int j0 = 0; j0 < used; j0 += kChunk) {
    const int n = min(kChunk, used - j0);
    __syncthreads();   // the previous chunk has been walked
    for (int j = t; j < n; j += nt) {
      s_pix[j] = pt[j0 + j];
      s_delta[j] = load_delta(deltas, slot0 + j0 + j);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const unsigned p = (unsigned)s_pix[j];   // an empty slot never matches
      if (p / kPix == (unsigned)t) {
        const float4 d = s_delta[j];
        const unsigned m = p % kPix;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (m == (unsigned)i) {
            a[i][0] = a[i][0] + d.x;
            a[i][1] = a[i][1] + d.y;
            a[i][2] = a[i][2] + d.z;
            a[i][3] = a[i][3] + d.w;
          }
        }
      }
    }
  }

  // ---- 3. write the owned pixels ----
  float* ot = out + tile * (size_t)p_tile * 4;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = t * kPix + i;
    if (p < p_tile)
      reinterpret_cast<float4*>(ot)[p] =
          make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
  }
}

template <typename T>
int launch(const int* pix, const T* deltas, float* out, int n_tiles, int cap,
           int p_tile, cudaStream_t s) {
  const int owners = (p_tile + kPix - 1) / kPix;
  const int nt = (owners + 31) / 32 * 32;
  tile_accumulate_kernel<T><<<n_tiles, nt, 0, s>>>(pix, deltas, out, cap,
                                                   p_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest tile (pixels) one block can own.
int tile_accumulate_max_pixels() { return kMaxThreads * kPix; }

// Launches the kernel on `stream`; `bf16` selects the delta type (0: f32,
// 1: bf16). Returns the CUDA error code (0 = ok).
int tile_accumulate_launch(const int* pix, const void* deltas, int bf16,
                           float* out, int n_tiles, int cap, int p_tile,
                           void* stream) {
  if (n_tiles <= 0 || cap <= 0 || p_tile <= 0 ||
      p_tile > kMaxThreads * kPix)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch(pix, static_cast<const __nv_bfloat16*>(deltas), out,
                  n_tiles, cap, p_tile, s);
  return launch(pix, static_cast<const float*>(deltas), out, n_tiles, cap,
                p_tile, s);
}

const char* tile_accumulate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
