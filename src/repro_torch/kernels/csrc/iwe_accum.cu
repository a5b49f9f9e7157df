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
// Design: a stable counting sort of each tile's slots by pixel in shared
// memory, then one thread per pixel folds its run. A tile's pixels are
// dealt to G blocks of 1024 threads (pixel p to block p % G),
// so that the coarse stages, which have few tiles, fill more of the card
// in their one wave (48 tiles at s = 1/4, B = 8, on 132 SMs: 96 blocks);
// dealt rather than cut into ranges, so that a feature's pixels, and its
// slots, spread over the blocks. Each pixel is summed by one thread
// whatever the split, so the result does not depend on it. G is a
// template parameter, so a launch with one block per tile (G = 1: the
// tiles fill a wave) carries none of the dealing's arithmetic.
// A block takes its tile's slots in chunks of kChunk; per chunk:
//   1. keys: coalesced loads of the slots' pixels (four per thread, all in
//      flight at once), then of the deltas of the slots on the block's
//      pixels (bf16 widened to f32), which land while the rank runs; those
//      slots are compacted, in slot order, with one ballot per warp and a
//      scan of the warps' counts. A chunk with none of them is skipped.
//   2. rank: the compacted slots are cut into `rw` strips, one per ranking
//      warp. Each warp walks its strip 32 slots at a time in slot order;
//      lanes on the same pixel find each other with one ballot per key
//      bit, a slot's rank is its warp's count so far for that pixel plus
//      the peers on lower lanes, and the lowest peer advances the count.
//      Each warp owns its row of counters [rw][pixels], so no two warps
//      touch one counter and no rank depends on the order in which threads
//      happen to run.
//   3. scan: per pixel, its warps' counts become an exclusive prefix in
//      warp order, and a block-wide exclusive scan of the pixels' totals
//      gives each pixel's first place in the sorted chunk.
//   4. scatter: each of the block's slots stores its deltas at place
//      start[pixel] + prefix[warp][pixel] + rank: the slots of a pixel land
//      in slot order.
//   5. fold: the thread of each pixel adds its contiguous run, in slot
//      order, to the four partial sums it carries in registers from chunk
//      to chunk.
// Each pixel is summed by one thread in slot order, as the plain version
// (a scatter-add in slot order) sums it: the result is bitwise equal to
// it, run to run and whatever batch a window is in. No float atomics; the
// only shared-memory writes that could meet are to distinct counters.
// Work per tile is O(slots x G + p_tile) per chunk (the keys are read
// by every block of the tile), where a walk in which every thread compares
// every slot would be O(slots x p_tile).
//
// What bounds it on the card: neither bytes nor operations. The function
// needs one read of each slot's pixel, one of each occupied slot's deltas
// and one write of the tile; the kernel adds ~7 block barriers per chunk,
// an `rw`-step column walk of the counters per pixel, two round trips to
// device memory (the second overlaps the rank), and the fold, whose time
// is the longest pixel run in a warp: one block's latency, with 32 warps
// issuing, sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;           // slots sorted in shared memory at once
constexpr int kSlotsPerThread = kChunk / kThreads;
constexpr int kMaxPpt = 4;             // output pixels per thread, at most
constexpr int kMaxPixels = kThreads * kMaxPpt;
constexpr int kCounters = 32768;       // [rw][p_tile] 16-bit counters
constexpr int kMaxRankWarps = 32;
constexpr int kKeyBits = 13;           // bits of a key in [0, kMaxPixels]
constexpr int kMaxGroups = 4;          // blocks per tile, at most
constexpr int kMinGroupPixels = 128;
constexpr int kSegments = kSlotsPerThread * kWarps;   // 32-slot segments

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

// The lanes of the warp whose key equals this lane's, for keys of `bits`
// bits: one ballot per bit (as CUB's radix rank does; __match_any_sync
// is a slow instruction, and the rank walk was most of a block's time).
__device__ __forceinline__ unsigned match_key(unsigned key, int bits) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kKeyBits; ++b) {
    if (b < bits) {
      const unsigned bit = (key >> b) & 1u;
      const unsigned vote = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? vote : ~vote;
    }
  }
  return peers;
}

// Ranking warps for a block of `pixels` pixels: as many as keep
// [rw][pixels] within kCounters.
__host__ __device__ inline int ranking_warps(int pixels) {
  int rw = kMaxRankWarps;
  while (rw * pixels > kCounters) rw /= 2;
  return rw;
}

__host__ __device__ inline size_t smem_bytes(int pixels) {
  return (size_t)kChunk * (sizeof(float4) + 2 * sizeof(unsigned short)) +
         (size_t)ranking_warps(pixels) * pixels * sizeof(unsigned short) +
         (size_t)pixels * sizeof(int);
}

// Blocks per tile: the most (up to kMaxGroups, each of at least
// kMinGroupPixels pixels, dividing p_tile) that still run in one wave. A
// block of 1024 threads at 64 registers takes a whole SM, so a second wave
// would add a block's full latency.
inline int pixel_groups(int n_tiles, int p_tile, int sms) {
  int g = 1;
  while (g < kMaxGroups && (long)n_tiles * 2 * g <= sms &&
         p_tile % (2 * g) == 0 && p_tile / (2 * g) >= kMinGroupPixels)
    g *= 2;
  return g;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
tile_accumulate_kernel(const int* __restrict__ pix,
                       const T* __restrict__ deltas,
                       float* __restrict__ out, int cap, int p_tile) {
  const int pg = p_tile / G;              // the block's pixels
  const int rw = ranking_warps(pg);
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_delta = reinterpret_cast<float4*>(smem);   // [kChunk], sorted
  unsigned short* s_key =                 // [kChunk], compacted slots' keys
      reinterpret_cast<unsigned short*>(s_delta + kChunk);
  unsigned short* s_rank = s_key + kChunk;             // [kChunk]
  unsigned short* s_cnt = s_rank + kChunk;             // [rw][pg]
  int* s_start = reinterpret_cast<int*>(s_cnt + rw * pg);   // [pg]
  __shared__ int s_seg[kSegments + 1];   // compacted offset of a segment
  __shared__ int s_warp[kWarps];

  const size_t tile = blockIdx.x / G;
  const unsigned group = blockIdx.x % G;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int* pt = pix + tile * cap;
  const size_t slot0 = tile * cap;
  const int bits = 32 - __clz(pg);        // a key in [0, pg] (pg: none)
  const int ppt = (pg + kThreads - 1) / kThreads;

  // thread t owns the block's pixels [t ppt, t ppt + ppt): its sums,
  // place and run
  float a[kMaxPpt][4];
  int start[kMaxPpt], run[kMaxPpt];
#pragma unroll
  for (int i = 0; i < kMaxPpt; ++i)
    a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;

  for (int j0 = 0; j0 < cap; j0 += kChunk) {
    const int n = min(kChunk, cap - j0);

    // ---- 1. the chunk's keys, compacted to the block's slots ----
    for (int i = t; i < rw * pg / 2; i += kThreads)
      reinterpret_cast<unsigned*>(s_cnt)[i] = 0u;
    int key[kSlotsPerThread];   // the block's local pixel, or -1
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      const int j = t + i * kThreads;
      // an empty slot (-1) is never < p_tile
      const unsigned p = j < n ? (unsigned)pt[j0 + j] : ~0u;
      key[i] = p < (unsigned)p_tile && p % G == group ? (int)(p / G) : -1;
    }
    // the block's slots' deltas are fetched now and land during the rank
    float4 d[kSlotsPerThread];
    unsigned mine[kSlotsPerThread];
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      if (key[i] >= 0)
        d[i] = load_delta(deltas, slot0 + j0 + t + i * kThreads);
      mine[i] = __ballot_sync(0xffffffffu, key[i] >= 0);
      if (lane == 0) s_seg[i * kWarps + warp] = __popc(mine[i]);
    }
    __syncthreads();
    if (warp == 0) {   // exclusive scan of the segments in slot order
      int v[kSlotsPerThread], sum = 0;
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        v[u] = s_seg[lane * kSlotsPerThread + u];
        sum += v[u];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      int base = incl - sum;
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        s_seg[lane * kSlotsPerThread + u] = base;
        base += v[u];
      }
      if (lane == 31) s_seg[kSegments] = incl;
    }
    __syncthreads();
    const int m = s_seg[kSegments];      // the block's slots in the chunk
    if (m == 0) continue;                // adds nothing
    int c[kSlotsPerThread];              // compacted index of a slot
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i) {
      c[i] = s_seg[i * kWarps + warp] + __popc(mine[i] & lower);
      if ((mine[i] >> lane) & 1u) s_key[c[i]] = (unsigned short)key[i];
    }
    __syncthreads();

    // ---- 2. stable rank of each slot within its warp's strip ----
    const int strip = (m + 32 * rw - 1) / (32 * rw) * 32;
    if (warp < rw) {
      unsigned short* cnt = s_cnt + warp * pg;
      for (int s = 0; s < strip && warp * strip + s < m; s += 32) {
        const int j = warp * strip + s + lane;
        const unsigned k = j < m ? s_key[j] : (unsigned)pg;
        const unsigned peers = match_key(k, bits);
        const unsigned below = __popc(peers & lower);
        unsigned before = 0;
        if (j < m) {
          before = cnt[k];
          s_rank[j] = (unsigned short)(before + below);
        }
        __syncwarp();
        if (j < m && below == 0)
          cnt[k] = (unsigned short)(before + __popc(peers));
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- 3. per-warp prefixes per pixel, block scan of pixel totals ----
    int total = 0;
#pragma unroll
    for (int i = 0; i < kMaxPpt; ++i) {
      const int p = t * ppt + i;
      int r = 0;
      if (i < ppt && p < pg) {
        unsigned short* cp = s_cnt + p;
        for (int w0 = 0; w0 < rw; w0 += 8) {   // rw is a multiple of 8
          int v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = cp[(w0 + u) * pg];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            cp[(w0 + u) * pg] = (unsigned short)r;
            r += v[u];
          }
        }
      }
      run[i] = r;
      total += r;
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w_incl = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w_incl, off);
        if (lane >= off) w_incl += v;
      }
      s_warp[lane] = w_incl;   // inclusive over warps
    }
    __syncthreads();
    int base = incl - total + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
    for (int i = 0; i < kMaxPpt; ++i) {
      const int p = t * ppt + i;
      start[i] = base;
      if (i < ppt && p < pg) s_start[p] = base;
      base += run[i];
    }
    __syncthreads();

    // ---- 4. each of the block's slots' deltas to its sorted place ----
#pragma unroll
    for (int i = 0; i < kSlotsPerThread; ++i)
      if (key[i] >= 0)
        s_delta[s_start[key[i]] + s_cnt[(c[i] / strip) * pg + key[i]] +
                s_rank[c[i]]] = d[i];
    __syncthreads();

    // ---- 5. fold each owned pixel's run in slot order ----
#pragma unroll
    for (int i = 0; i < kMaxPpt; ++i) {
      const float4* r = s_delta + start[i];
#pragma unroll 4
      for (int q = 0; q < run[i]; ++q) {
        const float4 v = r[q];
        a[i][0] = a[i][0] + v.x;
        a[i][1] = a[i][1] + v.y;
        a[i][2] = a[i][2] + v.z;
        a[i][3] = a[i][3] + v.w;
      }
    }
    __syncthreads();   // the next chunk restages what was folded
  }

  // ---- write the owned pixels ----
  float4* ot = reinterpret_cast<float4*>(out + tile * (size_t)p_tile * 4);
#pragma unroll
  for (int i = 0; i < kMaxPpt; ++i) {
    const int p = t * ppt + i;
    if (i < ppt && p < pg)
      ot[p * G + group] =
          make_float4(a[i][0], a[i][1], a[i][2], a[i][3]);
  }
}

template <typename T>
int launch(const int* pix, const T* deltas, float* out, int n_tiles, int cap,
           int p_tile, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int groups = pixel_groups(n_tiles, p_tile, sms);
  void (*kernel)(const int*, const T*, float*, int, int) =
      groups == 4 ? tile_accumulate_kernel<T, 4>
      : groups == 2 ? tile_accumulate_kernel<T, 2>
                    : tile_accumulate_kernel<T, 1>;
  const size_t smem = smem_bytes(p_tile / groups);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles * groups, kThreads, smem, s>>>(pix, deltas, out, cap,
                                                  p_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest tile (pixels) one block can own.
int tile_accumulate_max_pixels() { return kMaxPixels; }

// Dynamic shared memory of one block for a tile of p_tile pixels, whole
// (its largest, with one block per tile).
long tile_accumulate_smem_bytes(int p_tile) {
  return (long)smem_bytes(p_tile);
}

// Launches the kernel on `stream`; `bf16` selects the delta type (0: f32,
// 1: bf16). Returns the CUDA error code (0 = ok).
int tile_accumulate_launch(const int* pix, const void* deltas, int bf16,
                           float* out, int n_tiles, int cap, int p_tile,
                           void* stream) {
  if (n_tiles <= 0 || cap <= 0 || p_tile <= 0 || p_tile > kMaxPixels)
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
