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
// The backward kernels (K4-bwd "staged", K5-bwd "staged"): see below.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
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
// K5-bwd's lists (`build_lists`): a block of kListThreads owns
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
// K4-bwd ("staged", plan ops/volume.py::gather_backward_plan): a block owns
// one row (b, h) and a chunk of `cc` of its channels (all C where that
// fits two blocks an SM, as at both of CFNet's stages). Its last warp
// copies, the others (the list threads) build the row's lists meanwhile, and
// then every thread walks them. The copy: one thread's bulk copies (the
// Tensor Memory Accelerator), first the row's S planes of samples, then
// gd[b, :, h, :, :] (S contiguous runs), each completing on an mbarrier;
// where the runs are not 16-byte multiples and bases, or the block takes a
// chunk, the warp's cp.async of each pixel's channels instead, after the
// list threads have loaded their samples (a copy in flight holds loads back).
// The build (`build_staged_lists`): each list thread holds up to kListLoads
// entries (s, w) in registers; one atomicAdd an entry on its (s, u)'s
// count, whose result is the entry's arrival; each u's prefix of the
// counts over s and a block scan into the offsets; each entry stored at
// its offset + (s, u)'s start + its arrival; and each (s, u) of two or
// more entries (one to three, typically) sorted by w in registers by the
// list thread of its second arrival, so that each list holds its entries in
// (s, w) order whatever the scheduling. Integer atomics on shared
// bookkeeping only, one an entry, and no per-warp counts: K5-bwd's
// `build_lists` needs 2 x warps x W ints of them beside the lists (7 KB at
// CFNet's 1/4 stage), which the float32 block there (112.5 KB) cannot take
// and still fit two blocks an SM. Where both fit, in K5-bwd's list kernel
// (256 threads a row), `build_lists` is the faster: 9.2 and 16.5 us at
// CFNet's two train launches on the H100 against 13-14 and 25-26 for this
// build (`chip_smoke.py`'s K5-bwd timer on a copy that calls it). The walk: a
// thread item (pixel u, NV channels, 4 or 8 bytes; the items of one u on
// neighbouring lanes, so that they share each list entry and read one
// pixel's contiguous channels) sums u's staged gd in float32 registers, UF
// entries' loads ahead of their adds, and stores once; a list of more than
// kLong entries (the skewed row whose every sample reads one pixel) is a
// warp's: lane k sums its entries k, k + 32, ..., and the lanes' sums meet
// in a fixed butterfly. So gd is read from device memory once, in wide
// copies, no load waits on device memory, and the same inputs give the
// same bits in every run. (On the H100: list masks, bit d of mask (s, u)
// for (s, u + d) built by one atomicOr pass, walked 8-18 us a block, their
// lanes' bit loops diverging; the build's first forms took 5-8 us a block,
// its sort and a second atomic pass most of it; ranks from __match_any_sync
// over warps owning whole planes took 3-5 us to count; copying gd in four
// stages that the walk waits for in turn, and walking stage by stage, were
// no faster. `chip_smoke.py --k4-bwd` reads the phases.)
//
// K5-bwd ("staged", plan ops/volume.py::sample_backward_plan): a first
// kernel builds each row's lists once
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
constexpr int kLong = 32;               // entries of a K4/K5-bwd list one thread walks, at most
constexpr int kStagedThreads = 512;     // threads of a K4-bwd block, at most

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Phase stamps of the K4-bwd kernel, compiled in only with
// -DSAMPLE_BWD_STAMPS (`chip_smoke.py --k4-bwd` builds such a copy to split
// a launch into its phases): thread 0 of each block writes %globaltimer (ns) at
// phase k to bwd_stamps[block][k] (0 start, 1 samples held, 2 scratch
// zeroed, 3 counted, 4 scanned, 5 placed, 6 sorted, 7 gd landed, 8
// walked), after a block barrier where `sync`, and its SM to [block][9].
// Without the flag a stamp is nothing.
#ifdef SAMPLE_BWD_STAMPS
constexpr int kStampBlocks = 1 << 16;
__device__ unsigned long long bwd_stamps[kStampBlocks][10];
__device__ __forceinline__ void bwd_stamp(int k, bool sync) {
  if (sync) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    bwd_stamps[blockIdx.x][k] = t;
    if (k == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      bwd_stamps[blockIdx.x][9] = sm;
    }
  }
}
#define BWD_STAMP(k, sync) bwd_stamp(k, sync)
#else
#define BWD_STAMP(k, sync)
#endif

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
// both and len's bytes, both bases aligned to it; 0: one element at a
// time), by threads t0, t0 + nt, ...
template <typename T>
__device__ __forceinline__ void stage_rows_by(T* dst, int pitch, const T* __restrict__ src,
                                              size_t stride, int rows, int len, int vb, int t0,
                                              int nt) {
  if (vb >= 4) {
    const int per = vb / (int)sizeof(T), words = len / per;
    for (int i = t0; i < rows * words; i += nt) {
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
    for (int i = t0; i < rows * len; i += nt) {
      const int r = i / len, k = i - r * len;
      dst[(size_t)r * pitch + k] = src[r * stride + k];
    }
  }
}

// stage_rows_by, by the block's threads
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* __restrict__ src,
                                           size_t stride, int rows, int len, int vb) {
  stage_rows_by<T>(dst, pitch, src, stride, rows, len, vb, threadIdx.x, blockDim.x);
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

// ------------------------------------------------------------ K4-bwd "staged"

// Shared bytes of a K4-bwd block (ops/volume.py::gather_backward_smem
// computes the same): gd [S][W][cc] padded to 16 bytes, then the lists:
// cum [S * W], off [W + 1] padded to 4 ints, list [S * W].
inline int staged_list_ints(int W, int S) { return S * W + round_up(W + 1, 4) + S * W; }
inline int gather_staged_smem(int W, int S, int cc, int size) {
  return round_up(S * W * cc * size, 16) + 4 * staged_list_ints(W, S);
}

// Entries of a K4-bwd list thread: a block's list threads hold all of its
// row's S * W, kListLoads each at most.
constexpr int kListLoads = 20;

// The list threads' barrier (named barrier 1: the first nt threads of the
// block, a multiple of 32), which the copying warp does not join.
__device__ __forceinline__ void lists_sync(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// List thread t's (of nt) entries i = t + k * nt of a row of W pixels, as (s,
// w) = divmod(i, W), stepped without division.
struct RowEntries {
  int s, w, ds, dw;
  __device__ __forceinline__ RowEntries(int t, int nt, int W)
      : s(t / W), w(t % W), ds(nt / W), dw(nt % W) {}
  __device__ __forceinline__ void next(int W) {
    s += ds;
    w += dw;
    if (w >= W) w -= W, ++s;
  }
};

// List thread t's right pixel u of each of its entries (-1 where w < d or past
// the row), from the row's samples at smp (samples[b, 0, h, 0] in device
// memory, or staged in shared memory; planes `plane` apart), every load in
// flight at once.
__device__ __forceinline__ void row_targets(const float* smp, size_t plane, int S, int W,
                                            int max_shift, int t, int nt, int (&u)[kListLoads]) {
  const int kl = (S * W + nt - 1) / nt;     // entries a list thread holds
  float v[kListLoads];
  RowEntries e(t, nt, W);
#pragma unroll
  for (int k = 0; k < kListLoads; ++k, e.next(W)) {
    if (k == kl) break;
    v[k] = e.s < S ? smp[e.s * plane + e.w] : 0.f;
  }
  e = RowEntries(t, nt, W);
#pragma unroll
  for (int k = 0; k < kListLoads; ++k, e.next(W)) {
    const int d = k < kl ? shift_of(v[k], max_shift) : 0;
    u[k] = k < kl && e.s < S && d <= e.w ? e.w - d : -1;
  }
}

// x[0 .. n) (n <= 4, the rest INT_MAX) in ascending order: a sorting
// network on registers.
__device__ __forceinline__ void sort4(int (&x)[4]) {
  const auto cs = [&](int i, int j) {
    const int a = min(x[i], x[j]), b = max(x[i], x[j]);
    x[i] = a, x[j] = b;
  };
  cs(0, 1), cs(2, 3), cs(0, 2), cs(1, 3), cs(1, 2);
}

// The row's lists, built by the block's first nt threads (lists_sync)
// from their targets u (row_targets): list[off[u] .. off[u + 1]) holds s *
// W + w of each (s, w) that reads u, in (s, w) order; cum [S * W] is
// scratch, zeroed by the caller. (1) One atomicAdd an entry on its (s,
// u)'s count, whose result (the entry's arrival among its (s, u)'s) stays
// in the entry's register beside u (u << 16 | arrival); (2) each u's
// prefix of the counts over s, and a block scan of the u's totals into the
// offsets; (3) each entry stored at its place, no atomics; (4) each (s, u)
// of two or more entries sorted by w (in registers for up to four), by the
// list thread of its entry that arrived second. So the lists do not depend on
// the atomics' order. Integer atomics on shared bookkeeping only.
__device__ __forceinline__ void build_staged_lists(int (&slot)[kListLoads], int S, int W, int nt,
                                                   int* cum, int* off, int* list) {
  __shared__ int warp_total[kStagedThreads / 32];
  const int t = threadIdx.x, kl = (S * W + nt - 1) / nt;   // entries a list thread holds
  RowEntries e(t, nt, W);
#pragma unroll
  for (int k = 0; k < kListLoads; ++k, e.next(W)) {
    if (k == kl) break;
    if (slot[k] >= 0) slot[k] = slot[k] << 16 | atomicAdd(cum + e.s * W + slot[k], 1);
  }
  lists_sync(nt);
  BWD_STAMP(3, false);
  // each list thread a run of pixels [u0, u1): their prefixes over s, their
  // totals' sum scanned over the list threads into the offsets
  const int lane = t & 31, warp = t >> 5;
  const int per = (W + nt - 1) / nt;
  const int u0 = imin(W, t * per), u1 = imin(W, u0 + per);
  int local = 0;
  for (int x = u0; x < u1; ++x) {
    int c = 0;
    for (int s = 0; s < S; ++s) {
      const int a = cum[s * W + x];
      cum[s * W + x] = c;
      c += a;
    }
    off[x] = c;
    local += c;
  }
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  lists_sync(nt);
  int at = incl - local;
  for (int k = 0; k < warp; ++k) at += warp_total[k];
  for (int x = u0; x < u1; ++x) {
    const int c = off[x];
    off[x] = at;
    at += c;
  }
  if (t == nt - 1) off[W] = at;
  lists_sync(nt);
  BWD_STAMP(4, false);
  e = RowEntries(t, nt, W);
#pragma unroll
  for (int k = 0; k < kListLoads; ++k, e.next(W)) {
    if (k == kl) break;
    const int u = slot[k] >> 16;
    if (slot[k] >= 0) list[off[u] + cum[e.s * W + u] + (slot[k] & 0xffff)] = e.s * W + e.w;
  }
  lists_sync(nt);
  BWD_STAMP(5, false);
  // each (s, u) of two or more entries sorted by the list thread of its entry
  // that arrived second; cum[s * W + u] starts (s, u)'s entries in u's list
  e = RowEntries(t, nt, W);
#pragma unroll
  for (int k = 0; k < kListLoads; ++k, e.next(W)) {
    if (k == kl) break;
    if (slot[k] < 0 || (slot[k] & 0xffff) != 1) continue;
    const int u = slot[k] >> 16, i = e.s * W + u;
    const int lo = cum[i], n = (e.s + 1 < S ? cum[i + W] : off[u + 1] - off[u]) - lo;
    int* l = list + off[u] + lo;
    if (n <= 4) {
      int x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = j < n ? l[j] : INT_MAX;
      sort4(x);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) l[j] = x[j];
    } else {
      for (int q = 1; q < n; ++q) {
        const int x = l[q];
        int r = q - 1;
        for (; r >= 0 && l[r] > x; --r) l[r + 1] = l[r];
        l[r + 1] = x;
      }
    }
  }
  lists_sync(nt);
  BWD_STAMP(6, false);
}

// One thread's bulk copies (the Tensor Memory Accelerator) of S planes of
// `bytes` bytes each (16-byte multiples and bases) from src (planes
// `stride` bytes apart) to dst (back to back), completing on the mbarrier
// bar (initialised for one arrival), which the thread arms with their
// bytes.
__device__ __forceinline__ void bulk_copy_planes(void* dst, const void* src, size_t stride,
                                                 int S, int bytes, uint64_t* bar) {
  const uint32_t b = mma::smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(S * bytes)
               : "memory");
  for (int s = 0; s < S; ++s)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(mma::smem_addr(static_cast<char*>(dst) + (size_t)s * bytes)),
        "l"(static_cast<const char*>(src) + s * stride), "r"(bytes), "r"(b)
        : "memory");
}

// Wait until the mbarrier `bar` completes its phase 0.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const uint32_t b = mma::smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
}

// A block: row blockIdx.x / chunks, its chunk blockIdx.x % chunks of cc
// channels, items of NV channels. Its last warp copies while the others
// (the list threads) build the lists. `bulk`: its lane 0's bulk copies, first
// the row's S sample-plane runs of samples (into the lists' entries, which
// are written only after every list thread has read its samples), then of gd
// (every channel; 16-byte multiples and bases), each completing on an
// mbarrier; the list threads wait for the samples'. Else the list threads load
// their samples from device memory first, and only then (named barrier 2:
// the copy would otherwise hold their loads back) the warp's lanes copy
// each pixel's cc channels of gd by cp.async of vbg bytes and arrive on
// gd's mbarrier once theirs have landed. Then every thread walks, once
// gd's mbarrier has completed. vbo: bytes a store of dright.
template <typename T, int NV>
__global__ void __launch_bounds__(kStagedThreads)
gather_staged_kernel(const T* __restrict__ gd, const float* __restrict__ samples,
                     T* __restrict__ dright, int H, int W, int C, int S, int max_shift, int cc,
                     int chunks, int bulk, int vbg, int vbo) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar[2];                 // gd's, the samples'
  BWD_STAMP(0, false);
  constexpr int UF = 4;                   // entries a thread loads before it sums them
  const int chunk = blockIdx.x % chunks, r = blockIdx.x / chunks;
  const int h = r % H, b = r / H, c0 = chunk * cc, nq = cc / NV;
  const size_t plane = (size_t)H * W;
  const int nt = blockDim.x - 32;                                           // list threads
  T* sg = reinterpret_cast<T*>(smem);                                       // [S * W][cc]
  int* cum = reinterpret_cast<int*>(smem + round_up(S * W * cc * (int)sizeof(T), 16));
  int* off = cum + S * W;
  int* list = off + round_up(W + 1, 4);
  const T* g = gd + ((size_t)b * S * plane + (size_t)h * W) * C + c0;      // gd[b, 0, h, 0, c0]
  const float* smp = samples + (size_t)b * S * plane + (size_t)h * W;      // samples[b, 0, h, 0]
  if (threadIdx.x >= nt) {
    if (threadIdx.x == nt) {
      for (int j = 0; j < 2; ++j)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(bar + j)),
                     "r"(bulk ? 1 : 32));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (bulk) {
      asm volatile("bar.arrive 2, %0;\n" ::"r"(blockDim.x) : "memory");
      if (threadIdx.x == nt) {
        bulk_copy_planes(list, smp, plane * 4, S, W * 4, bar + 1);
        bulk_copy_planes(sg, g, plane * C * sizeof(T), S, W * C * (int)sizeof(T), bar);
      }
    } else {
      asm volatile("bar.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
      for (int s = 0; s < S; ++s)
        stage_rows_by<T>(sg + (size_t)s * W * cc, cc, g + s * plane * C, C, W, cc, vbg,
                         threadIdx.x - nt, 32);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mma::smem_addr(bar))
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < S * W; i += nt) cum[i] = 0;
    int slot[kListLoads];
    if (bulk) {
      asm volatile("bar.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
      bulk_wait(bar + 1);
      row_targets(reinterpret_cast<const float*>(list), W, S, W, max_shift, threadIdx.x, nt,
                  slot);
    } else {
      row_targets(smp, plane, S, W, max_shift, threadIdx.x, nt, slot);
      asm volatile("bar.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
    }
    BWD_STAMP(1, false);
    lists_sync(nt);                        // cum zeroed
    BWD_STAMP(2, false);
    build_staged_lists(slot, S, W, nt, cum, off, list);
  }
  __syncthreads();
  bulk_wait(bar);
  BWD_STAMP(7, false);
  T* out = dright + (size_t)r * W * C + c0;                                // dright[b, h, 0, c0]
  // lists of at most kLong entries: a thread item (u, NV channels) each,
  // the items of one u on neighbouring lanes
  for (int i = threadIdx.x; i < W * nq; i += blockDim.x) {
    const int u = i / nq, c = (i - u * nq) * NV;
    const int p0 = off[u], p1 = off[u + 1];
    if (p1 - p0 > kLong) continue;
    float acc[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[e] = 0.f;
    for (int p = p0; p < p1; p += UF) {
      int x[UF];
#pragma unroll
      for (int k = 0; k < UF; ++k) x[k] = list[p + k < p1 ? p + k : p0];
      float v[UF][NV];
#pragma unroll
      for (int k = 0; k < UF; ++k) load_shared<T, NV>(sg + (size_t)x[k] * cc + c, v[k]);
#pragma unroll
      for (int k = 0; k < UF; ++k) {
        if (p + k < p1) {
#pragma unroll
          for (int e = 0; e < NV; ++e) acc[e] += v[k][e];
        }
      }
    }
    store_run<T, NV>(out + (size_t)u * C + c, acc, vbo);
  }
  // longer lists (the skewed row whose every sample reads one pixel): a
  // warp each, lane k its entries k, k + 32, ..., the lanes' sums meeting
  // in a fixed butterfly
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int u = warp; u < W; u += nwarps) {
    const int p0 = off[u], p1 = off[u + 1];
    if (p1 - p0 <= kLong) continue;
    for (int c = 0; c < cc; c += NV) {
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.f;
      for (int p = p0 + lane; p < p1; p += 32) {
        float v[NV];
        load_shared<T, NV>(sg + (size_t)list[p] * cc + c, v);
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[e] += v[e];
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m);
      }
      if (lane == 0) store_run<T, NV>(out + (size_t)u * C + c, acc, vbo);
    }
  }
  BWD_STAMP(8, true);
}

// K4-bwd's list build alone, to time it beside the whole kernel: the
// kernel's grid, threads and shared memory, each block's list threads loading
// its row's samples and building its lists (its last warp, which copies gd
// in the kernel, idle); the blocks of chunk 0 write the offsets to offs
// [B * H * (W + 1)].
__global__ void __launch_bounds__(kStagedThreads)
gather_staged_build_kernel(const float* __restrict__ samples, int* __restrict__ offs, int H,
                           int W, int S, int max_shift, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* cum = reinterpret_cast<int*>(smem);
  int* off = cum + S * W;
  int* list = off + round_up(W + 1, 4);
  const int r = blockIdx.x / chunks, h = r % H, b = r / H;
  const size_t plane = (size_t)H * W;
  const int nt = blockDim.x - 32;                    // the kernel's list threads
  if (threadIdx.x >= nt) return;
  for (int i = threadIdx.x; i < S * W; i += nt) cum[i] = 0;
  int slot[kListLoads];
  row_targets(samples + (size_t)b * S * plane + (size_t)h * W, plane, S, W, max_shift,
              threadIdx.x, nt, slot);
  lists_sync(nt);
  build_staged_lists(slot, S, W, nt, cum, off, list);
  if (blockIdx.x % chunks == 0)
    for (int u = threadIdx.x; u <= W; u += nt) offs[(size_t)r * (W + 1) + u] = off[u];
}

template <typename T, int NV>
int launch_gather_backward(const void* gd, const void* samples, void* dright, int B, int H,
                           int W, int C, int S, int max_shift, int threads, int cc, int smem,
                           cudaStream_t stream) {
  const uintptr_t size = sizeof(T), base = reinterpret_cast<uintptr_t>(gd);
  const int bulk = cc == C && widest_word({W * C * size, H * W * C * size, base}) == 16 &&
                   widest_word({W * 4u, reinterpret_cast<uintptr_t>(samples)}) == 16;
  const int vbg = widest_word({cc * size, C * size, base});
  const int vbo = widest_word({NV * size, C * size, cc * size,
                               reinterpret_cast<uintptr_t>(dright)});
  const int err = set_smem(gather_staged_kernel<T, NV>, smem);
  if (err) return err;
  gather_staged_kernel<T, NV><<<B * H * (C / cc), threads, smem, stream>>>(
      static_cast<const T*>(gd), static_cast<const float*>(samples), static_cast<T*>(dright), H,
      W, C, S, max_shift, cc, C / cc, bulk, vbg, vbo);
  return (int)cudaGetLastError();
}

template <typename T>
int gather_backward_by_item(const void* gd, const void* samples, void* dright, int B, int H,
                            int W, int C, int S, int max_shift, int threads, int cc, int item,
                            int smem, cudaStream_t s) {
#define STAGED_CASE(n)                                                                      \
  case n:                                                                                   \
    return launch_gather_backward<T, n>(gd, samples, dright, B, H, W, C, S, max_shift,    \
                                        threads, cc, smem, s);
  switch (item) {
    STAGED_CASE(1)
    STAGED_CASE(2)
    STAGED_CASE(4)
  }
#undef STAGED_CASE
  return (int)cudaErrorInvalidValue;
}

// The plan of a K4-bwd launch, checked: threads a block (a multiple of 32,
// at most kStagedThreads, all but the last warp holding the row's S * W
// entries, kListLoads each), channels a chunk cc (dividing C), channels an
// item (1, 2 or 4, dividing cc, at most 8 bytes) and shared bytes a block
// (gather_staged_smem's).
inline bool staged_plan_ok(int W, int C, int S, int max_shift, int dtype, int threads, int cc,
                           int item, int smem) {
  const int size = dtype == 0 ? 4 : 2;
  return W >= 1 && C >= 1 && S >= 1 && max_shift >= 0 && (dtype == 0 || dtype == 1) &&
         threads >= 64 && threads <= kStagedThreads && threads % 32 == 0 && W < 0x8000 &&
         S * W <= kListLoads * (threads - 32) && cc >= 1 && C % cc == 0 && item >= 1 &&
         cc % item == 0 && item * size <= 8 && smem == gather_staged_smem(W, S, cc, size);
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
// samples are float32. The plan (threads a block, channels a chunk and an
// item, shared bytes a block) comes from ops/volume.py::gather_backward_plan.
int gather_right_by_samples_backward(const void* gd, const void* samples, void* dright, int B,
                                     int H, int W, int C, int S, int max_shift, int dtype,
                                     int threads, int chunk, int item, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || !staged_plan_ok(W, C, S, max_shift, dtype, threads, chunk, item, smem))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gather_backward_by_item<float>(gd, samples, dright, B, H, W, C, S, max_shift, threads,
                                          chunk, item, smem, s);
  return gather_backward_by_item<__nv_bfloat16>(gd, samples, dright, B, H, W, C, S, max_shift,
                                                threads, chunk, item, smem, s);
}

// K4-bwd's list build alone, on the plan of gather_right_by_samples_backward
// (its grid, threads and shared bytes), writing each row's list offsets to
// offs (int32 [B, H, W + 1]); for timing the build beside the whole kernel.
int gather_right_by_samples_backward_build(const void* samples, void* offs, int B, int H, int W,
                                           int C, int S, int max_shift, int dtype, int threads,
                                           int chunk, int item, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || !staged_plan_ok(W, C, S, max_shift, dtype, threads, chunk, item, smem))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(gather_staged_build_kernel, smem);
  if (err) return err;
  gather_staged_build_kernel<<<B * H * (C / chunk), threads, smem, s>>>(
      static_cast<const float*>(samples), static_cast<int*>(offs), H, W, S, max_shift,
      C / chunk);
  return (int)cudaGetLastError();
}

// K5-bwd's first kernel alone (each row's lists to `lists`, as
// gwc_volume_from_samples_backward takes them); for timing the list build
// beside the whole backward.
int gwc_volume_from_samples_backward_lists(const void* samples, void* lists, int B, int H, int W,
                                           int S, int max_shift, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || W > 0xffff || S < 1 || S > 0x7fff || max_shift < 0 ||
      reinterpret_cast<uintptr_t>(lists) % 16)
    return (int)cudaErrorInvalidValue;
  const int lsmem = 4 * list_ints(W, S);
  const int err = set_smem(sample_lists_kernel, lsmem);
  if (err) return err;
  sample_lists_kernel<<<dim3(H, B), kListThreads, lsmem, s>>>(
      static_cast<const float*>(samples), static_cast<int*>(lists), H, W, S, max_shift);
  return (int)cudaGetLastError();
}

#ifdef SAMPLE_BWD_STAMPS
// The first `blocks` blocks' phase stamps of the last stamped launch into
// dst (host, 10 uint64 a block).
int bwd_stamps_read(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, bwd_stamps,
                                   (size_t)imin(blocks, kStampBlocks) * 10 * sizeof(uint64_t));
}
#endif

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
