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
// The backward kernels (K4-bwd, K5-bwd): see below.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// Design ("sort", plan ops/volume.py::sample_backward_plan): a block owns
// one row (b, h). It stages the row's shifts d[s][w] in shared memory and
// sorts the row's (s, w) by the right pixel u = w - d they read, into one
// list a pixel, in a fixed order: a counting sort whose counts are integer
// atomics on shared memory (the same in every run), whose offsets are an
// exclusive scan of the counts, and whose fill is one warp walking the
// entries in order, 32 at a time: the lanes that read one u find each
// other (__match_any_sync) and take consecutive places in its list by
// lane. So each list holds its entries in (s, w) order, whatever the
// scheduling. Then each output (u, c) is one thread's: it walks its list
// and sums gd (times left, for K5) in float32 registers, and writes once.
// No atomics on data: the same inputs give the same bits in every run.
// K5-bwd's dl items, a gather, read the staged shifts directly. Shared
// memory: 4 bytes a shift, 4 an entry, 8 a pixel for its list's offset and
// fill cursor (26 KB a row at CFNet's 1/2 stage in training).

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// The row's lists: d [S * W] shifts, off [W + 1] offsets into list [S * W]
// entries (s << 16 | w), cursor [W] scratch. smp points at samples[b, 0, h,
// 0]; sample planes lie `plane` apart. The fill's warp stride is the
// block's width up to 32 (a block of one thread, as a serial run of the
// kernel has, fills one entry at a time in the same order).
__device__ __forceinline__ void stage_lists(const float* __restrict__ smp, size_t plane, int S,
                                            int W, int max_shift, int* d, int* off, int* list,
                                            int* cursor) {
  for (int u = threadIdx.x; u <= W; u += blockDim.x) off[u] = 0;
  __syncthreads();
  const int n = S * W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i / W, w = i - s * W;
    const int v = shift_of(__ldg(smp + s * plane + w), max_shift);
    d[i] = v;
    if (v <= w) atomicAdd(off + w - v + 1, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int u = 0; u < W; ++u) off[u + 1] += off[u];
  __syncthreads();
  for (int u = threadIdx.x; u < W; u += blockDim.x) cursor[u] = off[u];
  __syncthreads();
  const int lanes = min(32, (int)blockDim.x);
  const int lane = threadIdx.x;
  if (lane < lanes) {
    for (int base = 0; base < n; base += lanes) {
      const int i = base + lane;
      const int s = i / W, w = i - s * W;
      const int u = i < n && d[i] <= w ? w - d[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu >> (32 - lanes), u);
      if (u >= 0) list[cursor[u] + __popc(peers & ((1u << lane) - 1))] = s << 16 | w;
      __syncwarp();
      if (u >= 0 && lane == __ffs(peers) - 1) cursor[u] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_backward_kernel(const T* __restrict__ gd, const float* __restrict__ samples,
                       T* __restrict__ dright, int H, int W, int C, int S, int max_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* d = reinterpret_cast<int*>(smem);
  int* off = d + S * W;
  int* list = off + W + 1;
  int* cursor = list + S * W;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)H * W;                  // pixels of a sample plane
  stage_lists(samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, max_shift, d, off,
              list, cursor);
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

// CPG > 0: C/G at compile time; a thread item is one pixel and one group:
// it reads the group's gd value once a term and the group's CPG feature
// values in `vb`-byte words (16, 8 or 4; else one at a time). CPG == 0: a
// thread item is one pixel and one channel. A block takes the groups [g0,
// g0 + gc) of its row (the blockIdx.z-th chunk), so that a launch has
// blocks enough to fill the card; each chunk builds the row's lists
// itself.
template <typename T, int CPG>
__global__ void __launch_bounds__(kThreads)
gwc_samples_backward_kernel(const T* __restrict__ left, const T* __restrict__ right,
                            const float* __restrict__ samples, const T* __restrict__ gd,
                            T* __restrict__ dl, T* __restrict__ dr, int H, int W, int C, int S,
                            int G, int max_shift, int gc, int vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* d = reinterpret_cast<int*>(smem);
  int* off = d + S * W;
  int* list = off + W + 1;
  int* cursor = list + S * W;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t plane = (size_t)H * W;                  // pixels of a sample plane
  stage_lists(samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, max_shift, d, off,
              list, cursor);
  const int cpg = C / G;
  const float inv = 1.f / (float)cpg;
  const int g0 = blockIdx.z * gc, ng = min(G, g0 + gc) - g0;
  const size_t row = ((size_t)b * H + h) * W * C;      // left/right/dl/dr [b, h, 0, 0]
  const T* g = gd + ((size_t)b * S * plane + (size_t)h * W) * G;  // gd[b, 0, h, 0, 0]
  if constexpr (CPG > 0) {
    // dl: a gather over the samples of pixel w
    for (int i = threadIdx.x; i < W * ng; i += blockDim.x) {
      const int w = i / ng, grp = g0 + (i - w * ng);
      float acc[CPG];
#pragma unroll
      for (int e = 0; e < CPG; ++e) acc[e] = 0.f;
      for (int s = 0; s < S; ++s) {
        const int sh = d[s * W + w];
        if (sh <= w) {
          const float gv = to_f(__ldg(g + (s * plane + w) * G + grp));
          float v[CPG];
          load_f32<T, CPG>(right + row + (size_t)(w - sh) * C + grp * CPG, vb, v);
#pragma unroll
          for (int e = 0; e < CPG; ++e) acc[e] = fmaf(gv, v[e], acc[e]);
        }
      }
      T* o = dl + row + (size_t)w * C + grp * CPG;
#pragma unroll
      for (int e = 0; e < CPG; ++e) from_f(acc[e] * inv, o + e);
    }
    // dr: a scatter, as the sum over the list of u
    for (int i = threadIdx.x; i < W * ng; i += blockDim.x) {
      const int u = i / ng, grp = g0 + (i - u * ng);
      float acc[CPG];
#pragma unroll
      for (int e = 0; e < CPG; ++e) acc[e] = 0.f;
      for (int p = off[u]; p < off[u + 1]; ++p) {
        const int e0 = list[p], w = e0 & 0xffff;
        const float gv = to_f(__ldg(g + ((e0 >> 16) * plane + w) * G + grp));
        float v[CPG];
        load_f32<T, CPG>(left + row + (size_t)w * C + grp * CPG, vb, v);
#pragma unroll
        for (int e = 0; e < CPG; ++e) acc[e] = fmaf(gv, v[e], acc[e]);
      }
      T* o = dr + row + (size_t)u * C + grp * CPG;
#pragma unroll
      for (int e = 0; e < CPG; ++e) from_f(acc[e] * inv, o + e);
    }
  } else {
    const int c0 = g0 * cpg, nc = ng * cpg;
    for (int i = threadIdx.x; i < W * nc; i += blockDim.x) {
      const int w = i / nc, c = c0 + (i - w * nc), grp = c / cpg;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const int sh = d[s * W + w];
        if (sh <= w)
          acc = fmaf(to_f(__ldg(g + (s * plane + w) * G + grp)),
                     to_f(__ldg(right + row + (size_t)(w - sh) * C + c)), acc);
      }
      from_f(acc * inv, dl + row + (size_t)w * C + c);
    }
    for (int i = threadIdx.x; i < W * nc; i += blockDim.x) {
      const int u = i / nc, c = c0 + (i - u * nc), grp = c / cpg;
      float acc = 0.f;
      for (int p = off[u]; p < off[u + 1]; ++p) {
        const int e = list[p], w = e & 0xffff;
        acc = fmaf(to_f(__ldg(g + ((e >> 16) * plane + w) * G + grp)),
                   to_f(__ldg(left + row + (size_t)w * C + c)), acc);
      }
      from_f(acc * inv, dr + row + (size_t)u * C + c);
    }
  }
}

// Shared bytes of a block: d, list [S * W], off [W + 1], cursor [W]
int backward_smem(int W, int S) { return 4 * (2 * S * W + 2 * W + 1); }

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int CPG>
int launch_gwc_backward(const void* left, const void* right, const void* samples,
                        const void* gd, void* dl, void* dr, int B, int H, int W, int C, int S,
                        int G, int max_shift, int threads, int smem, int gc, cudaStream_t stream) {
  const int err = set_smem(gwc_samples_backward_kernel<T, CPG>, smem);
  if (err) return err;
  // the widest word that divides a group's bytes, the row's and both bases
  const uintptr_t a = reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right);
  int vb = 0;
  for (int v = 16; v >= 4 && !vb; v /= 2)
    if ((CPG * sizeof(T)) % v == 0 && (C * sizeof(T)) % v == 0 && a % v == 0) vb = v;
  const dim3 grid(H, B, (G + gc - 1) / gc);
  gwc_samples_backward_kernel<T, CPG><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(samples), static_cast<const T*>(gd), static_cast<T*>(dl),
      static_cast<T*>(dr), H, W, C, S, G, max_shift, gc, vb);
  return (int)cudaGetLastError();
}

template <typename T>
int gwc_backward_by_cpg(const void* left, const void* right, const void* samples,
                        const void* gd, void* dl, void* dr, int B, int H, int W, int C, int S,
                        int G, int max_shift, int threads, int smem, int gc, cudaStream_t s) {
#define GWC_BWD_CASE(n)                                                                     \
  case n:                                                                                   \
    return launch_gwc_backward<T, n>(left, right, samples, gd, dl, dr, B, H, W, C, S, G,  \
                                     max_shift, threads, smem, gc, s);
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
      return launch_gwc_backward<T, 0>(left, right, samples, gd, dl, dr, B, H, W, C, S, G,
                                       max_shift, threads, smem, gc, s);
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
// samples are float32. The plan (threads a block, shared bytes a block)
// comes from ops/volume.py::sample_backward_plan.
int gather_right_by_samples_backward(const void* gd, const void* samples, void* dright, int B,
                                     int H, int W, int C, int S, int max_shift, int dtype,
                                     int threads, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || W > 0xffff || C < 1 || S < 1 || S > 0x7fff ||
      max_shift < 0 || threads < 32 || threads > kThreads || threads % 32 ||
      smem != backward_smem(W, S) || (dtype != 0 && dtype != 1))
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
// samples are float32. The plan (threads a block, shared bytes a block,
// groups a block) comes from ops/volume.py::sample_backward_plan.
int gwc_volume_from_samples_backward(const void* left, const void* right, const void* samples,
                                     const void* gd, void* dl, void* dr, int B, int H, int W,
                                     int C, int S, int G, int max_shift, int dtype, int threads,
                                     int smem, int gc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || W > 0xffff || S < 1 || S > 0x7fff || G < 1 || C % G ||
      max_shift < 0 || threads < 32 || threads > kThreads || threads % 32 || gc < 1 ||
      smem != backward_smem(W, S) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gwc_backward_by_cpg<float>(left, right, samples, gd, dl, dr, B, H, W, C, S, G,
                                      max_shift, threads, smem, gc, s);
  return gwc_backward_by_cpg<__nv_bfloat16>(left, right, samples, gd, dl, dr, B, H, W, C, S,
                                            G, max_shift, threads, smem, gc, s);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
