// Right features gathered at per-pixel disparity samples (K4), and the
// group-wise correlation at those samples (K5), for Hopper, sm_90a.
//
// Replaces stereo_toolbox_tpu/ops/pallas/sample_gather.py::
// gather_right_by_samples_pallas (kernel body `_gather_kernel`) and
// gwc_volume_from_samples_pallas (kernel body `_gwc_kernel`).
//
//   d = (int) clamp(samples[b, s, h, w], 0, max_shift)    (NaN -> 0)
//   K4: out[b, s, h, w, c] = right[b, h, w - d, c]
//   K5: out[b, s, h, w, g] = mean_{c in group g} left[b, h, w, c] * right[b, h, w - d, c]
//   both 0 where w < d
//
// Layouts are channels-last: left/right [B, H, W, C], samples [B, S, H, W]
// float32 (integer-valued in CFNet, but any values are taken), out
// [B, S, H, W, C] (K4) or [B, S, H, W, G] (K5), float32 or bfloat16, K5
// accumulating in float32.
//
// What bounds both: bytes. K4 copies; K5 does C/G multiply-adds per output (4
// at both of CFNet's stages) against 4 or 2 bytes stored, far below the
// card's ridge point, and its output is S*G/(2*C) times its two inputs. So
// the point is to store each output once, in long contiguous runs, at the
// memory's rate; K5 never writes the gathered [B, S, H, W, C] tensor at all.
//
// The TPU kernels turn the gather into a one-hot [S*Wt, 2Wt] matmul on the
// MXU over a 128-lane-padded W, a TPU workaround for gathers. On Hopper the
// gather is a load.
//
// K4 design ("direct", plan ops/volume.py::gather_plan): a copy, so the
// kernel moves words and never looks at their type. A block owns `tw`
// pixels of one row (b, h) and a run of `sc` samples; a thread item is one
// pixel and one word of its row of channels, as wide as the row's bytes
// and the bases allow (16, 8, 4 or 2 bytes: CFNet's rows are 48 and 24
// bytes in float32, 24 and 12 in bfloat16, three words a pixel). An item
// loops over its samples: each step reads the sample (one float a pixel,
// shared by the pixel's lanes), then one word of right[b, h, w - d] straight
// from device memory through L1 (the right map of a CFNet stage, 0.9-1.8
// MB, sits in L2), and stores it, or zero where w < d. A step costs no
// division (an item divides once, for its pixel). Items run with the word
// fastest, so a warp's store at one sample covers whole pixels in one
// contiguous run. No shared memory: a block's window of right pixels, staged
// there, would be read 2.5-4 times over its halo at CFNet's shapes, and the
// copy made no store before the whole window had arrived.
//
// K5 design ("direct", plan ops/volume.py::sample_gwc_plan): a block owns
// `tw` pixels of one row (b, h) and every group (16 pixels in float32, 32 in
// bfloat16: 600-4800 short blocks, 4.5-36 an SM, at CFNet's stages). A thread
// item is one pixel and one slot of NG groups, as many as make one 8-byte
// store (2 in float32, 4 in bfloat16, where they divide G): it loads the
// slot's left values into registers as float32, scaled by 1/cpg, once, then
// loops over the S samples. Each step reads the sample (one float a pixel,
// shared by its lanes) and, where w >= d, the slot's right values at w - d
// straight from device memory through L1 (16-byte loads where the row
// allows): the lanes of one pixel read one contiguous run of the right row
// whatever d is, the rows a block reads over its samples stay in L1, and
// the right map of a CFNet stage (12-25 MB) fits the 50 MB L2. A step costs
// no division. Items run with the slot fastest, so a warp's store at one s
// covers whole pixels in one contiguous run. (Staging the block's right
// window in shared memory with cp.async first, the other way tried, was
// slower in float32 and no faster in bfloat16 on the H100: each block then
// waits for its window before its first store.) C/G of 1, 2, 3, 4, 6, 8, 12
// or 16 keeps the left values in registers at a compile-time count; any
// other C/G runs the same loop with the left values read at each step.
//
// The backward kernels (K4-bwd "sort", K5-bwd "staged"): see below.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// d of a sample: clamped to [0, max_shift] and truncated (NaN -> 0).
__device__ __forceinline__ int shift_of(float v, int max_shift) {
  return (int)fminf(fmaxf(v, 0.f), (float)max_shift);
}

// A word of `VB` bytes.
template <int VB> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = unsigned int; };
template <> struct WordOf<2> { using type = unsigned short; };

template <int VB>
__global__ void __launch_bounds__(kThreads)
gather_direct_kernel(const typename WordOf<VB>::type* __restrict__ right,
                     const float* __restrict__ samples,
                     typename WordOf<VB>::type* __restrict__ out, int H, int W, int S,
                     int max_shift, int wpp, int tw, int tiles, int sc) {
  using V = typename WordOf<VB>::type;
  const int w0 = (blockIdx.x % tiles) * tw;
  const int h = blockIdx.x / tiles;
  const int s0 = blockIdx.y * sc;
  const int s1 = min(s0 + sc, S);
  const int b = blockIdx.z;
  const int items = min(tw, W - w0) * wpp;
  const size_t plane = (size_t)H * W;                    // pixels of a sample plane
  const size_t px0 = (size_t)h * W + w0;                 // pixel (h, w0) of a plane
  const float* smp = samples + (size_t)b * S * plane + px0;
  const V* rrow = right + ((size_t)b * plane + px0) * wpp;  // word 0 of (b, h, w0)
  V* o = out + ((size_t)b * S * plane + px0) * wpp;

  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int p = item / wpp;
    const int w = w0 + p;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const int d = shift_of(__ldg(smp + s * plane + p), max_shift);
      V v;
      if (w >= d) {
        v = __ldg(rrow + item - d * wpp);
      } else {
        v = V{};
      }
      o[s * plane * wpp + item] = v;
    }
  }
}

template <int VB>
int launch_gather(const void* right, const void* samples, void* out, int B, int H, int W,
                  int S, int max_shift, int row_bytes, int tw, int threads, int sc,
                  cudaStream_t stream) {
  using V = typename WordOf<VB>::type;
  const uintptr_t a = reinterpret_cast<uintptr_t>(right) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % VB || a % VB) return (int)cudaErrorInvalidValue;
  const int tiles = (W + tw - 1) / tw;
  const dim3 grid(tiles * H, (S + sc - 1) / sc, B);
  gather_direct_kernel<VB><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(right), static_cast<const float*>(samples), static_cast<V*>(out),
      H, W, S, max_shift, row_bytes / VB, tw, tiles, sc);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K5

// N consecutive elements at p (device memory) as float32, read in `vb`-byte
// words (16, 8 or 4; anything else reads element by element). vb divides
// N * sizeof(T) and p's alignment.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, int vb, float (&dst)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (sizeof(T) == 4) {
    if (kBytes % 16 == 0 && vb == 16) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
        dst[4 * k] = v.x, dst[4 * k + 1] = v.y, dst[4 * k + 2] = v.z, dst[4 * k + 3] = v.w;
      }
      return;
    }
    if (kBytes % 8 == 0 && vb >= 8) {
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p) + k);
        dst[2 * k] = v.x, dst[2 * k + 1] = v.y;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = __ldg(p + k);
  } else {
    // bfloat16: two a 32-bit word, the first in its low half
    if (kBytes % 16 == 0 && vb == 16) {
#pragma unroll
      for (int k = 0; k < N / 8; ++k) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dst[8 * k + 2 * i] = __uint_as_float(w[i] << 16);
          dst[8 * k + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
      return;
    }
    if (kBytes % 4 == 0 && vb >= 4) {
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p) + k);
        dst[2 * k] = __uint_as_float(w << 16);
        dst[2 * k + 1] = __uint_as_float(w & 0xffff0000u);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = __bfloat162float(p[k]);
  }
}

// NG float32 results stored as T at p (NG * sizeof(T) bytes, aligned to it).
template <typename T, int NG>
__device__ __forceinline__ void store_groups(T* p, const float (&a)[NG]) {
  if constexpr (sizeof(T) == 4 && NG == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else if constexpr (sizeof(T) == 4) {
    *p = a[0];
  } else if constexpr (NG == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(mma::pack_bf16(a[0], a[1]), mma::pack_bf16(a[2], a[3]));
  } else if constexpr (NG == 2) {
    *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a[0], a[1]);
  } else {
    *p = __float2bfloat16(a[0]);
  }
}

// CPG > 0: C/G at compile time, the left values in registers. CPG == 0: C/G
// is `cpg`, and the left values are read at each step.
template <typename T, int CPG, int NG>
__global__ void __launch_bounds__(kThreads)
gwc_direct_kernel(const T* __restrict__ left, const T* __restrict__ right,
                  const float* __restrict__ samples, T* __restrict__ out, int H, int W, int C,
                  int S, int G, int max_shift, int tw, int tiles, int cpg, int vb) {
  constexpr int NV = (CPG > 0 ? CPG : 1) * NG;
  const int w0 = (blockIdx.x % tiles) * tw;
  const int h = blockIdx.x / tiles;
  const int b = blockIdx.y;
  const int nw = min(tw, W - w0);
  const int slots = G / NG;
  const int items = nw * slots;
  const float inv = 1.f / (float)cpg;
  const size_t plane = (size_t)H * W;                   // pixels of a sample plane
  const size_t row = ((size_t)b * H + h) * W;           // pixel (b, h, 0)
  const float* smp = samples + (size_t)b * S * plane + (size_t)h * W;
  T* o = out + ((size_t)b * S * plane + (size_t)h * W) * G;
  const T* rrow = right + row * C;

  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int p = item / slots;
    const int slot = item - p * slots;
    const int c0 = slot * NG * cpg;
    const int w = w0 + p;
    const T* lp = left + (row + w) * C + c0;
    float lf[NV];
    if constexpr (CPG > 0) {
      load_f32<T, NV>(lp, vb, lf);
#pragma unroll
      for (int e = 0; e < NV; ++e) lf[e] *= inv;
    }
    T* op = o + (size_t)w * G + slot * NG;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const int d = shift_of(__ldg(smp + s * plane + w), max_shift);
      float a[NG];
#pragma unroll
      for (int n = 0; n < NG; ++n) a[n] = 0.f;
      if (w >= d) {
        const T* rp = rrow + (size_t)(w - d) * C + c0;
        if constexpr (CPG > 0) {
          float rv[NV];
          load_f32<T, NV>(rp, vb, rv);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
#pragma unroll
            for (int e = 0; e < CPG; ++e) a[n] = fmaf(lf[n * CPG + e], rv[n * CPG + e], a[n]);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            for (int e = 0; e < cpg; ++e)
              a[n] = fmaf(to_f(lp[n * cpg + e]), to_f(rp[n * cpg + e]), a[n]);
            a[n] *= inv;
          }
        }
      }
      store_groups<T, NG>(op + s * plane * G, a);
    }
  }
}

template <typename T, int CPG, int NG>
int launch_gwc(const void* left, const void* right, const void* samples, void* out, int B,
               int H, int W, int C, int S, int G, int max_shift, int tw, int threads,
               cudaStream_t stream) {
  // the widest word that divides a slot's bytes, the row's and both bases
  const uintptr_t a = reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right);
  int vb = 0;
  for (int v = 16; v >= 4 && !vb; v /= 2)
    if ((NG * (C / G) * sizeof(T)) % v == 0 && (C * sizeof(T)) % v == 0 && a % v == 0) vb = v;
  const int tiles = (W + tw - 1) / tw;
  gwc_direct_kernel<T, CPG, NG><<<dim3(tiles * H, B), threads, 0, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(samples), static_cast<T*>(out), H, W, C, S, G, max_shift, tw,
      tiles, C / G, vb);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int gwc_by_cpg(const void* left, const void* right, const void* samples, void* out, int B,
               int H, int W, int C, int S, int G, int max_shift, int tw, int threads,
               cudaStream_t s) {
#define GWC_CASE(n)                                                                           \
  case n:                                                                                     \
    return launch_gwc<T, n, NG>(left, right, samples, out, B, H, W, C, S, G, max_shift, tw, \
                                threads, s);
  switch (C / G) {
    GWC_CASE(1)
    GWC_CASE(2)
    GWC_CASE(3)
    GWC_CASE(4)
    GWC_CASE(6)
    GWC_CASE(8)
    GWC_CASE(12)
    GWC_CASE(16)
    default:
      return launch_gwc<T, 0, NG>(left, right, samples, out, B, H, W, C, S, G, max_shift, tw,
                                  threads, s);
  }
#undef GWC_CASE
}


// ------------------------------------------------------------ the backward
//
// Replace the gradients that JAX takes through the XLA paths of
// ops/volume.py::gather_right_by_samples (take_along_axis, whose transpose
// is a scatter-add) and gwc_volume_from_samples (that gather and the
// group-wise correlation); the Pallas K4 and K5 have no reverse-mode rule.
// The samples get no gradient: JAX casts them to int32. With d = d(s, w) the
// clamped, truncated sample at (b, s, h, w), g the group of channel c and
// cpg = C / G, given the output's gradient gd:
//
//   K4-bwd: dright[b, h, u, c] = sum_{(s, w): w - d = u} gd[b, s, h, w, c]
//   K5-bwd: dl[b, h, w, c] = 1/cpg * sum_{s: d <= w} gd[b, s, h, w, g] * right[b, h, w - d, c]
//           dr[b, h, u, c] = 1/cpg * sum_{(s, w): w - d = u} gd[b, s, h, w, g] * left[b, h, w, c]
//
// What bounds them: bytes (gd, the features, the samples read once, the
// outputs written once). dl is a gather, like the forward. dright and dr
// are scatters: many (s, w) can read one right pixel u (every w of a row
// whose sample reaches back to it), and which do depends on the data.
//
// The lists (both kernels, `build_lists`): a block of kListThreads owns
// one row (b, h) and sorts the row's (s, w) by the right pixel u = w - d
// they read, into one list a pixel, each in (s, w) order. Its threads
// stage u (or -1 where w < d) of every (s, w) in shared memory, and the
// row's (s, w), in that order, are cut into one run a warp. Each warp
// takes its run 32 entries at a time: the lanes OR their bit into the
// warp's mask of their u (integer atomics on shared bookkeeping, whose
// result does not depend on their order), so each lane reads which lanes
// share its u, its rank among them and their count. A first pass counts
// each warp's entries a pixel; the block sums the warps' counts a pixel
// and scans them (warp shuffles, then over the warps' totals) into the
// lists' offsets, and each warp's place in each list is the offset plus
// the counts of the warps before it. A second pass fills every warp's run
// in order, the lanes of one u taking consecutive places by lane. So each
// list holds its entries in (s, w) order, whatever the scheduling.
// (With `__match_any_sync` finding the same lanes, K5-bwd's list kernel
// took 13 and 30 us at CFNet's two train launches on the H100; with the
// masks 10.5 and 18.5.) Shared memory: 4 bytes a u and an entry, 4 a
// pixel for the offsets and 8 a pixel and warp for the counts and masks.
//
// K4-bwd ("sort", plan ops/volume.py::sample_backward_plan): a block builds
// its row's lists, then each output (u, c) is one thread's: it walks its
// list and sums gd in float32 registers, and writes once.
//
// K5-bwd ("staged", same plan): a first kernel builds each row's lists once
// and writes them (offsets, entries) to scratch that the wrapper
// allocates. Then a block owns one row and a chunk of GC groups (as many
// as fit two blocks an SM): it copies the row's lists from scratch (L2),
// its samples, gd[b, :, h, :, chunk] and the chunk's left and right rows
// into shared memory with cp.async, and computes from there: dl, a thread
// an output's groups (pixel w, item_groups of them), sums over s; dr's
// lists of at most kLong entries, a thread an output's groups, walk their
// entries; a longer
// list (the skewed row whose every sample reads one pixel) is walked by a
// warp, its lanes over the entries, and summed in a fixed butterfly. So
// neither pass makes a dependent load from device memory, gd is read from
// it once, and no list serialises a row on one thread. No atomics on data:
// the same inputs give the same bits in every run.

constexpr int kListThreads = 256;       // threads (8 warps) of a block that builds lists
constexpr int kListWarps = kListThreads / 32;
constexpr int kLong = 32;               // entries of a list that one thread walks, at most

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared ints of a block that builds a row's lists: u [S * W], off [W + 1],
// list [S * W], counts and masks [kListWarps * W] each.
__host__ __device__ __forceinline__ int list_ints(int W, int S) {
  return 2 * S * W + W + 1 + 2 * kListWarps * W;
}

// Ints of a row's lists in scratch: off [W + 1], list [S * W], each padded
// to 16 bytes.
__host__ __device__ __forceinline__ int scratch_ints(int W, int S) {
  return round_up(W + 1, 4) + round_up(S * W, 4);
}

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// The lanes of this warp's batch whose u is this lane's (u >= 0), from the
// warp's masks `msk` (zero before and after: the batch's first lane of
// each u clears its mask once every lane has read it).
__device__ __forceinline__ unsigned batch_peers(int* msk, int u, int lane) {
  if (u >= 0) atomicOr(msk + u, 1 << lane);
  __syncwarp();
  const unsigned peers = u >= 0 ? (unsigned)msk[u] : 0u;
  __syncwarp();
  if (u >= 0 && lane == __ffs(peers) - 1) msk[u] = 0;
  return peers;
}

// The row's lists (blockDim.x == kListThreads): uof [S * W] the right pixel
// u that (s, w) reads or -1, off [W + 1] the lists' offsets into list
// [S * W], whose entries are s << 16 | w; cnt [2 * kListWarps * W] scratch
// (each warp's counts, then cursors, and masks). smp points at samples[b,
// 0, h, 0]; sample planes lie `plane` apart.
__device__ __forceinline__ void build_lists(const float* __restrict__ smp, size_t plane, int S,
                                            int W, int max_shift, int* uof, int* off, int* list,
                                            int* cnt) {
  __shared__ int warp_total[kListWarps];
  const int n = S * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 2 * kListWarps * W; i += blockDim.x) cnt[i] = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i / W, w = i - s * W;
    const int d = shift_of(__ldg(smp + s * plane + w), max_shift);
    uof[i] = d <= w ? w - d : -1;
  }
  __syncthreads();
  // each warp's run of the (s, w): [lo, hi)
  const int run = (n + kListWarps - 1) / kListWarps;
  const int lo = imin(n, warp * run), hi = imin(n, lo + run);
  int* mine = cnt + warp * W;
  int* msk = cnt + (kListWarps + warp) * W;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int u = i < hi ? uof[i] : -1;
    const unsigned peers = batch_peers(msk, u, lane);
    if (u >= 0 && lane == __ffs(peers) - 1) mine[u] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each thread sums the counts of a run of pixels [u0, u1) (into off), the
  // runs' sums are scanned over the block, and each pixel's offset and each
  // warp's cursor into its list follow
  const int per = (W + blockDim.x - 1) / blockDim.x;
  const int u0 = imin(W, threadIdx.x * per), u1 = imin(W, u0 + per);
  int local = 0;
  for (int u = u0; u < u1; ++u) {
    int t = 0;
    for (int k = 0; k < kListWarps; ++k) t += cnt[k * W + u];
    off[u] = t;
    local += t;
  }
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int at = incl - local;
  for (int k = 0; k < warp; ++k) at += warp_total[k];
  for (int u = u0; u < u1; ++u) {
    const int t = off[u];
    off[u] = at;
    int cur = at;
    for (int k = 0; k < kListWarps; ++k) {
      const int c = cnt[k * W + u];
      cnt[k * W + u] = cur;
      cur += c;
    }
    at += t;
  }
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kListWarps; ++k) total += warp_total[k];
    off[W] = total;
  }
  __syncthreads();
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int u = i < hi ? uof[i] : -1;
    const unsigned peers = batch_peers(msk, u, lane);
    if (u >= 0) {
      const int s = i / W;
      list[mine[u] + __popc(peers & ((1u << lane) - 1))] = s << 16 | (i - s * W);
    }
    __syncwarp();
    if (u >= 0 && lane == __ffs(peers) - 1) mine[u] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kListThreads)
gather_backward_kernel(const T* __restrict__ gd, const float* __restrict__ samples,
                       T* __restrict__ dright, int H, int W, int C, int S, int max_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* uof = reinterpret_cast<int*>(smem);
  int* off = uof + S * W;
  int* list = off + W + 1;
  int* cnt = list + S * W;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)H * W;                  // pixels of a sample plane
  build_lists(samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, max_shift, uof, off,
              list, cnt);
  const T* g = gd + ((size_t)b * S * plane + (size_t)h * W) * C;  // gd[b, 0, h, 0, 0]
  T* out = dright + ((size_t)b * H + h) * W * C;
  for (int i = threadIdx.x; i < W * C; i += blockDim.x) {
    const int u = i / C, c = i - u * C;
    float acc = 0.f;
    for (int p = off[u]; p < off[u + 1]; ++p) {
      const int e = list[p];
      acc += to_f(__ldg(g + ((e >> 16) * plane + (e & 0xffff)) * C + c));
    }
    from_f(acc, out + i);
  }
}

// K5-bwd's first kernel: each row's lists, written to scratch (rs ints a
// row: off, list, as scratch_ints lays them out).
__global__ void __launch_bounds__(kListThreads)
sample_lists_kernel(const float* __restrict__ samples, int* __restrict__ lists, int H, int W,
                    int S, int max_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* uof = reinterpret_cast<int*>(smem);
  int* off = uof + S * W;
  int* list = off + W + 1;
  int* cnt = list + S * W;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)H * W;
  build_lists(samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, max_shift, uof, off,
              list, cnt);
  int* out = lists + ((size_t)b * H + h) * scratch_ints(W, S);
  const int o1 = round_up(W + 1, 4);
  for (int i = threadIdx.x; i <= W; i += blockDim.x) out[i] = off[i];
  for (int i = threadIdx.x; i < S * W; i += blockDim.x) out[o1 + i] = list[i];
}

// cp.async of VB (16, 8 or 4) bytes
template <int VB>
__device__ __forceinline__ void cp_async_v(void* dst, const void* src) {
  if constexpr (VB == 16) {
    mma::cp_async16(mma::smem_addr(dst), src, true);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(mma::smem_addr(dst)),
                 "l"(src), "n"(VB));
  }
}

// `rows` rows of `len` elements of T from src (rows `stride` elements
// apart) to dst (rows `pitch` elements apart), VB bytes a copy (VB dividing
// both and len's bytes, both bases aligned to it; 0: one element at a time)
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* __restrict__ src,
                                           size_t stride, int rows, int len, int vb) {
  if (vb >= 4) {
    const int per = vb / (int)sizeof(T), words = len / per;
    for (int i = threadIdx.x; i < rows * words; i += blockDim.x) {
      const int r = i / words, k = i - r * words;
      T* q = dst + (size_t)r * pitch + k * per;
      const T* p = src + r * stride + k * per;
      if (vb == 16) {
        cp_async_v<16>(q, p);
      } else if (vb == 8) {
        cp_async_v<8>(q, p);
      } else {
        cp_async_v<4>(q, p);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * len; i += blockDim.x) {
      const int r = i / len, k = i - r * len;
      dst[(size_t)r * pitch + k] = src[r * stride + k];
    }
  }
}

// Shared bytes of a K5-bwd (row, chunk) block (ops/volume.py::
// sample_chunk_smem computes the same): the row's lists and samples
// [S * W], gd [S * W][GCP] padded to 16 bytes, the left and right rows of
// the chunk, [W][NCP] each, with GCP = GC rounded up to a thread item's
// groups NGI and NCP = GCP * cpg rounded up to 16 bytes.
template <typename T>
int staged_smem(int W, int S, int cpg, int GC, int NGI) {
  const int epc = 16 / (int)sizeof(T);
  const int GCP = round_up(GC, NGI);
  return 4 * (scratch_ints(W, S) + round_up(S * W, 4)) +
         round_up(S * W * GCP * (int)sizeof(T), 16) +
         2 * W * round_up(GCP * cpg, epc) * (int)sizeof(T);
}

// N float32 values to p as T: in `vb`-byte words (16, 8 or 4, dividing
// p's alignment; words wider than the N values are not used), else one
// value at a time.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, const float (&v)[N], int vb) {
  constexpr int B = N * (int)sizeof(T);
  if constexpr (B % 4 == 0) {
    constexpr int NW = B / 4;
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        w[i] = mma::pack_bf16(v[2 * i], v[2 * i + 1]);
      }
    }
    if constexpr (B % 16 == 0) {
      if (vb == 16) {
#pragma unroll
        for (int k = 0; k < NW / 4; ++k)
          reinterpret_cast<uint4*>(p)[k] =
              make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
        return;
      }
    }
    if constexpr (B % 8 == 0) {
      if (vb >= 8) {
#pragma unroll
        for (int k = 0; k < NW / 2; ++k)
          reinterpret_cast<uint2*>(p)[k] = make_uint2(w[2 * k], w[2 * k + 1]);
        return;
      }
    }
    if (vb >= 4) {
#pragma unroll
      for (int k = 0; k < NW; ++k) reinterpret_cast<uint32_t*>(p)[k] = w[k];
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) from_f(v[e], p + e);
}

// N elements of T in shared memory at p as float32: in the widest of 16-,
// 8- and 4-byte words that divides N * sizeof(T) (p aligned to it), else
// one at a time.
template <typename T, int N>
__device__ __forceinline__ void load_shared(const T* p, float (&dst)[N]) {
  constexpr int B = N * (int)sizeof(T);
  constexpr int VB = B % 16 == 0 ? 16 : B % 8 == 0 ? 8 : B % 4 == 0 ? 4 : 0;
  if constexpr (VB > 0) {
    constexpr int NW = B / 4, WPV = VB / 4;   // 32-bit words, words a load
    uint32_t w[NW];
#pragma unroll
    for (int k = 0; k < NW / WPV; ++k) {
      if constexpr (WPV == 4) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
      } else if constexpr (WPV == 2) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[k];
        w[2 * k] = v.x, w[2 * k + 1] = v.y;
      } else {
        w[k] = reinterpret_cast<const uint32_t*>(p)[k];
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        dst[i] = __uint_as_float(w[i]);
      } else {
        dst[2 * i] = __uint_as_float(w[i] << 16);
        dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = to_f(p[e]);
  }
}

// Groups of one thread item of K5-bwd at C/G = CPG (> 0) in T: one in
// float32, so that the 8 lanes of a quarter warp read consecutive 16-byte
// chunks of one gathered pixel's row (items of 4 groups read 4 pixels'
// rows at the same bank groups: 0.458 ms against 0.345 over CFNet's two
// launches on the H100); in bfloat16 as many as keep the item's sums
// within 16 float32 registers, at most 4 (0.255 ms against 0.265 for 2).
template <typename T, int CPG>
__host__ __device__ constexpr int item_groups() {
  if constexpr (sizeof(T) == 4) {
    return 1;
  } else {
    return CPG <= 4 ? 4 : CPG <= 8 ? 2 : 1;
  }
}

// Threads of a K5-bwd (row, chunk) block: 512 in float32, whose items need
// few registers, so that more warps hide shared memory's latency; 256 in
// bfloat16, whose items sum more channels.
template <typename T>
__host__ __device__ constexpr int staged_threads() {
  return sizeof(T) == 4 ? 512 : 256;
}

// CPG > 0: C/G at compile time, a thread item one pixel and NGI groups of
// the chunk (item_groups). CPG == 0: C/G is runtime, a thread item one
// pixel and one channel. vbg / vbf / vbs: bytes a copy of gd's, the
// features' and the samples' rows; vbo: bytes a store of dl and dr. The
// copies come in two groups: the lists, samples, gd and the right rows,
// which dl reads, then, once those have landed, the left rows, which only
// dr reads and which arrive while dl runs. Then the block turns each
// staged sample into the right pixel u it reads (-1 off the image), in
// place. dl's samples and dr's entries are taken UF at a time (4 where an
// item is one group, else 2), their loads issued before their products.
// (Two other ways to overlap the copies with the compute were slower on
// the H100, against 0.345 / 0.254 ms over CFNet's two launches: gd's
// sample planes taken a group at a time as they land, each thread holding
// two or four items of each pass, spilled registers (0.393 / 0.297); one
// block an SM walking units in two buffers idled at each barrier behind
// its slowest list (0.447 / 0.305).)
template <typename T, int CPG>
__global__ void __launch_bounds__(staged_threads<T>())
gwc_samples_backward_kernel(const T* __restrict__ left, const T* __restrict__ right,
                            const float* __restrict__ samples, const int* __restrict__ lists,
                            const T* __restrict__ gd, T* __restrict__ dl, T* __restrict__ dr,
                            int H, int W, int C, int S, int G, int max_shift, int GC, int chunks,
                            int vbg, int vbf, int vbs, int vbo) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int NGI = CPG > 0 ? item_groups<T, CPG>() : 1;
  constexpr int NV = NGI * (CPG > 0 ? CPG : 1);
  constexpr int UF = NGI == 1 ? 4 : 2;
  const int chunk = blockIdx.x % chunks, r = blockIdx.x / chunks;
  const int h = r % H, b = r / H;
  const int cpg = CPG > 0 ? CPG : C / G;
  const int g0 = chunk * GC, gc = imin(GC, G - g0), c0 = g0 * cpg, nc = gc * cpg;
  const int GCP = round_up(GC, NGI);
  const int NCP = round_up(GCP * cpg, EPC);
  const int rs = scratch_ints(W, S);
  int* si = reinterpret_cast<int*>(smem);                                   // off, list
  float* ss = reinterpret_cast<float*>(si + rs);                            // [S][W]
  T* sg = reinterpret_cast<T*>(ss + round_up(S * W, 4));                    // [S * W][GCP]
  T* sl = sg + round_up(S * W * GCP * (int)sizeof(T), 16) / (int)sizeof(T); // [W][NCP]
  T* sr = sl + (size_t)W * NCP;
  const size_t plane = (size_t)H * W;
  const size_t row = ((size_t)b * H + h) * W * C;      // left/right/dl/dr [b, h, 0, 0]

  stage_rows<int>(si, rs, lists + (size_t)r * rs, rs, 1, rs, 16);
  stage_rows<float>(ss, W, samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, vbs);
  for (int s = 0; s < S; ++s)
    stage_rows<T>(sg + (size_t)s * W * GCP, GCP,
                  gd + (((size_t)b * S + s) * plane + (size_t)h * W) * G + g0, G, W, gc, vbg);
  stage_rows<T>(sr, NCP, right + row + c0, C, W, nc, vbf);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  stage_rows<T>(sl, NCP, left + row + c0, C, W, nc, vbf);
  mma::cp_async_commit();
  int* su = reinterpret_cast<int*>(ss);                  // [S][W]: u, or -1
  for (int i = threadIdx.x; i < S * W; i += blockDim.x) {
    const int w = i % W, d = shift_of(ss[i], max_shift);
    su[i] = d <= w ? w - d : -1;
  }
  __syncthreads();
  const int* off = si;
  const int* list = si + round_up(W + 1, 4);
  const float inv = 1.f / (float)cpg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  if constexpr (CPG > 0) {
    const int nq = (gc + NGI - 1) / NGI;
    // the item's sums, scaled, to out (pixel row p) for its groups in the chunk
    auto store = [&](T* out, int p, int n0, const float (&acc)[NV]) {
#pragma unroll
      for (int n = 0; n < NGI; ++n) {
        if (n0 + n < gc) {
          float v[CPG];
#pragma unroll
          for (int e = 0; e < CPG; ++e) v[e] = acc[n * CPG + e] * inv;
          store_run<T, CPG>(out + row + (size_t)p * C + c0 + (n0 + n) * CPG, v, vbo);
        }
      }
    };
    // dl: a gather over the samples of pixel w
    for (int i = threadIdx.x; i < W * nq; i += blockDim.x) {
      const int w = i / nq, n0 = (i - w * nq) * NGI;
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.f;
      for (int s0 = 0; s0 < S; s0 += UF) {
        int u[UF];
        float gv[UF][NGI], v[UF][NV];
#pragma unroll
        for (int k = 0; k < UF; ++k) u[k] = s0 + k < S ? su[(s0 + k) * W + w] : -1;
#pragma unroll
        for (int k = 0; k < UF; ++k) {
          load_shared<T, NGI>(sg + ((s0 + (u[k] >= 0 ? k : 0)) * W + w) * GCP + n0, gv[k]);
          load_shared<T, NV>(sr + (u[k] >= 0 ? u[k] : 0) * NCP + n0 * CPG, v[k]);
        }
#pragma unroll
        for (int k = 0; k < UF; ++k) {
          if (u[k] >= 0) {
#pragma unroll
            for (int n = 0; n < NGI; ++n)
#pragma unroll
              for (int e = 0; e < CPG; ++e)
                acc[n * CPG + e] = fmaf(gv[k][n], v[k][n * CPG + e], acc[n * CPG + e]);
          }
        }
      }
      store(dl, w, n0, acc);
    }
    mma::cp_async_wait<0>();
    __syncthreads();
    // dr: a thread walks each list of at most kLong entries
    for (int i = threadIdx.x; i < W * nq; i += blockDim.x) {
      const int u = i / nq, n0 = (i - u * nq) * NGI;
      const int p0 = off[u], p1 = off[u + 1];
      if (p1 - p0 > kLong) continue;
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.f;
      for (int q = p0; q < p1; q += UF) {
        float gv[UF][NGI], v[UF][NV];
#pragma unroll
        for (int k = 0; k < UF; ++k) {
          const int e0 = list[q + k < p1 ? q + k : p0], w = e0 & 0xffff;
          load_shared<T, NGI>(sg + ((e0 >> 16) * W + w) * GCP + n0, gv[k]);
          load_shared<T, NV>(sl + w * NCP + n0 * CPG, v[k]);
        }
#pragma unroll
        for (int k = 0; k < UF; ++k) {
          if (q + k < p1) {
#pragma unroll
            for (int n = 0; n < NGI; ++n)
#pragma unroll
              for (int e = 0; e < CPG; ++e)
                acc[n * CPG + e] = fmaf(gv[k][n], v[k][n * CPG + e], acc[n * CPG + e]);
          }
        }
      }
      store(dr, u, n0, acc);
    }
    // dr: a warp walks each longer list, lane k its entries k, k + 32, ...,
    // and the lanes' sums meet in a fixed butterfly
    for (int u = warp; u < W; u += nwarps) {
      const int p0 = off[u], p1 = off[u + 1];
      if (p1 - p0 <= kLong) continue;
      for (int n0 = 0; n0 < gc; n0 += NGI) {
        float acc[NV];
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[e] = 0.f;
        for (int p = p0 + lane; p < p1; p += 32) {
          const int e0 = list[p], w = e0 & 0xffff;
          float gv[NGI], v[NV];
          load_shared<T, NGI>(sg + ((e0 >> 16) * W + w) * GCP + n0, gv);
          load_shared<T, NV>(sl + w * NCP + n0 * CPG, v);
#pragma unroll
          for (int n = 0; n < NGI; ++n)
#pragma unroll
            for (int e = 0; e < CPG; ++e)
              acc[n * CPG + e] = fmaf(gv[n], v[n * CPG + e], acc[n * CPG + e]);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
          for (int e = 0; e < NV; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m);
        }
        if (lane == 0) store(dr, u, n0, acc);
      }
    }
  } else {
    for (int i = threadIdx.x; i < W * nc; i += blockDim.x) {
      const int w = i / nc, k = i - w * nc, n = k / cpg;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const int u = su[s * W + w];
        if (u >= 0) acc = fmaf(to_f(sg[(s * W + w) * GCP + n]), to_f(sr[u * NCP + k]), acc);
      }
      from_f(acc * inv, dl + row + (size_t)w * C + c0 + k);
    }
    mma::cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < W * nc; i += blockDim.x) {
      const int u = i / nc, k = i - u * nc, n = k / cpg;
      const int p0 = off[u], p1 = off[u + 1];
      if (p1 - p0 > kLong) continue;
      float acc = 0.f;
      for (int p = p0; p < p1; ++p) {
        const int e0 = list[p], w = e0 & 0xffff;
        acc = fmaf(to_f(sg[((e0 >> 16) * W + w) * GCP + n]), to_f(sl[w * NCP + k]), acc);
      }
      from_f(acc * inv, dr + row + (size_t)u * C + c0 + k);
    }
    for (int u = warp; u < W; u += nwarps) {
      const int p0 = off[u], p1 = off[u + 1];
      if (p1 - p0 <= kLong) continue;
      for (int k = 0; k < nc; ++k) {
        const int n = k / cpg;
        float acc = 0.f;
        for (int p = p0 + lane; p < p1; p += 32) {
          const int e0 = list[p], w = e0 & 0xffff;
          acc = fmaf(to_f(sg[((e0 >> 16) * W + w) * GCP + n]), to_f(sl[w * NCP + k]), acc);
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
        if (lane == 0) from_f(acc * inv, dr + row + (size_t)u * C + c0 + k);
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The widest of 16, 8 and 4 bytes that divides every value of `bytes` (0:
// none does).
inline int widest_word(std::initializer_list<uintptr_t> bytes) {
  for (int v = 16; v >= 4; v /= 2) {
    bool ok = true;
    for (uintptr_t x : bytes) ok = ok && x % v == 0;
    if (ok) return v;
  }
  return 0;
}

template <typename T, int CPG>
int launch_gwc_backward(const void* left, const void* right, const void* samples,
                        const void* gd, void* lists, void* dl, void* dr, int B, int H, int W,
                        int C, int S, int G, int max_shift, int GC, int smem,
                        cudaStream_t stream) {
  const int cpg = C / G;
  constexpr int NGI = CPG > 0 ? item_groups<T, CPG>() : 1;
  if (smem != staged_smem<T>(W, S, cpg, GC, NGI)) return (int)cudaErrorInvalidValue;
  const int lsmem = 4 * list_ints(W, S);
  int err = set_smem(sample_lists_kernel, lsmem);
  if (err) return err;
  sample_lists_kernel<<<dim3(H, B), kListThreads, lsmem, stream>>>(
      static_cast<const float*>(samples), static_cast<int*>(lists), H, W, S, max_shift);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = set_smem(gwc_samples_backward_kernel<T, CPG>, smem);
  if (err) return err;
  const int size = (int)sizeof(T);
  const int vbg = widest_word({(uintptr_t)G * size, (uintptr_t)GC * size,
                               (uintptr_t)round_up(GC, NGI) * size, (uintptr_t)(G % GC) * size,
                               reinterpret_cast<uintptr_t>(gd)});
  const int vbf = widest_word({(uintptr_t)C * size, (uintptr_t)GC * cpg * size,
                               (uintptr_t)(G % GC) * cpg * size,
                               reinterpret_cast<uintptr_t>(left),
                               reinterpret_cast<uintptr_t>(right)});
  const int vbs = widest_word({(uintptr_t)W * 4, (uintptr_t)H * W * 4,
                               reinterpret_cast<uintptr_t>(samples)});
  const int vbo = widest_word({(uintptr_t)(CPG > 0 ? CPG : 1) * size, (uintptr_t)C * size,
                               reinterpret_cast<uintptr_t>(dl), reinterpret_cast<uintptr_t>(dr)});
  const int chunks = (G + GC - 1) / GC;
  gwc_samples_backward_kernel<T, CPG><<<B * H * chunks, staged_threads<T>(), smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(samples), static_cast<const int*>(lists),
      static_cast<const T*>(gd), static_cast<T*>(dl), static_cast<T*>(dr), H, W, C, S, G,
      max_shift, GC, chunks, vbg, vbf, vbs, vbo);
  return (int)cudaGetLastError();
}

template <typename T>
int gwc_backward_by_cpg(const void* left, const void* right, const void* samples,
                        const void* gd, void* lists, void* dl, void* dr, int B, int H, int W,
                        int C, int S, int G, int max_shift, int GC, int smem, cudaStream_t s) {
#define GWC_BWD_CASE(n)                                                                       \
  case n:                                                                                     \
    return launch_gwc_backward<T, n>(left, right, samples, gd, lists, dl, dr, B, H, W, C, S, \
                                     G, max_shift, GC, smem, s);
  switch (C / G) {
    GWC_BWD_CASE(1)
    GWC_BWD_CASE(2)
    GWC_BWD_CASE(3)
    GWC_BWD_CASE(4)
    GWC_BWD_CASE(6)
    GWC_BWD_CASE(8)
    GWC_BWD_CASE(12)
    GWC_BWD_CASE(16)
    default:
      return launch_gwc_backward<T, 0>(left, right, samples, gd, lists, dl, dr, B, H, W, C, S,
                                       G, max_shift, GC, smem, s);
  }
#undef GWC_BWD_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (right and out); samples are float32.
// The plan (pixels a block tw, threads a block, bytes a word vb: 16, 8, 4
// or 2, dividing the row's bytes C * size and both bases; samples a thread
// item sc) comes from ops/volume.py::gather_plan.
int gather_right_by_samples(const void* right, const void* samples, void* out, int B,
                            int H, int W, int C, int S, int max_shift, int dtype, int tw,
                            int threads, int vb, int sc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1 || S < 1 || tw < 1 || threads < 32 ||
      threads > kThreads || threads % 32 || max_shift < 0 || sc < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int row_bytes = C * (dtype == 0 ? 4 : 2);
#define GATHER_ARGS right, samples, out, B, H, W, S, max_shift, row_bytes, tw, threads, sc, s
  switch (vb) {
    case 16: return launch_gather<16>(GATHER_ARGS);
    case 8: return launch_gather<8>(GATHER_ARGS);
    case 4: return launch_gather<4>(GATHER_ARGS);
    case 2: return launch_gather<2>(GATHER_ARGS);
  }
#undef GATHER_ARGS
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (left, right and out); samples are float32.
// The plan (pixels a block tw, threads a block, groups a thread item ng: 1 or
// 2 in float32, 1, 2 or 4 in bfloat16, dividing G) comes from
// ops/volume.py::sample_gwc_plan.
int gwc_volume_from_samples(const void* left, const void* right, const void* samples,
                            void* out, int B, int H, int W, int C, int S, int G,
                            int max_shift, int dtype, int tw, int threads, int ng,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || S < 1 || G < 1 || C % G || tw < 1 || threads < 32 ||
      threads > kThreads || threads % 32 || max_shift < 0 || ng < 1 || G % ng)
    return (int)cudaErrorInvalidValue;
#define GWC_ARGS left, right, samples, out, B, H, W, C, S, G, max_shift, tw, threads, s
  if (dtype == 0 && ng == 1) return gwc_by_cpg<float, 1>(GWC_ARGS);
  if (dtype == 0 && ng == 2) return gwc_by_cpg<float, 2>(GWC_ARGS);
  if (dtype == 1 && ng == 1) return gwc_by_cpg<__nv_bfloat16, 1>(GWC_ARGS);
  if (dtype == 1 && ng == 2) return gwc_by_cpg<__nv_bfloat16, 2>(GWC_ARGS);
  if (dtype == 1 && ng == 4) return gwc_by_cpg<__nv_bfloat16, 4>(GWC_ARGS);
#undef GWC_ARGS
  return (int)cudaErrorInvalidValue;
}

// dright of gather_right_by_samples given its output's gradient gd ([B, S,
// H, W, C], in the features' type). dtype: 0 = float32, 1 = bfloat16;
// samples are float32. The plan (threads a block: kListThreads; shared
// bytes a block: 4 * list_ints) comes from ops/volume.py::sample_backward_plan.
int gather_right_by_samples_backward(const void* gd, const void* samples, void* dright, int B,
                                     int H, int W, int C, int S, int max_shift, int dtype,
                                     int threads, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || W > 0xffff || C < 1 || S < 1 || S > 0x7fff ||
      max_shift < 0 || threads != kListThreads || smem != 4 * list_ints(W, S) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  if (dtype == 0) {
    const int err = set_smem(gather_backward_kernel<float>, smem);
    if (err) return err;
    gather_backward_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(gd), static_cast<const float*>(samples),
        static_cast<float*>(dright), H, W, C, S, max_shift);
  } else {
    const int err = set_smem(gather_backward_kernel<__nv_bfloat16>, smem);
    if (err) return err;
    gather_backward_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(gd), static_cast<const float*>(samples),
        static_cast<__nv_bfloat16*>(dright), H, W, C, S, max_shift);
  }
  return (int)cudaGetLastError();
}

// dl, dr of gwc_volume_from_samples given its output's gradient gd ([B, S,
// H, W, G], in the features' type). dtype: 0 = float32, 1 = bfloat16;
// samples are float32; lists: int32 scratch of B * H * scratch_ints(W, S),
// 16-byte aligned. The plan (groups a chunk GC, shared bytes of a (row,
// chunk) block, which must be staged_smem's) comes from
// ops/volume.py::sample_backward_plan.
int gwc_volume_from_samples_backward(const void* left, const void* right, const void* samples,
                                     const void* gd, void* lists, void* dl, void* dr, int B,
                                     int H, int W, int C, int S, int G, int max_shift, int dtype,
                                     int groups, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || W > 0xffff || S < 1 || S > 0x7fff || G < 1 || C % G ||
      max_shift < 0 || groups < 1 || groups > G || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(lists) % 16)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gwc_backward_by_cpg<float>(left, right, samples, gd, lists, dl, dr, B, H, W, C, S, G,
                                      max_shift, groups, smem, s);
  return gwc_backward_by_cpg<__nv_bfloat16>(left, right, samples, gd, lists, dl, dr, B, H, W, C,
                                            S, G, max_shift, groups, smem, s);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
