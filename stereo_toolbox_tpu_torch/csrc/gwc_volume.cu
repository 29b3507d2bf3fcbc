// Group-wise correlation cost volume (GwcNet) for Hopper, sm_90a (K1).
//
// Replaces stereo_toolbox_tpu/ops/pallas/volume.py::build_gwc_volume_pallas
// (kernel body `_gwc_kernel`).
//
//   out[b, d, h, w, g] = mean_{c in group g} left[b, h, w, c] * right[b, h, w - d, c]
//   out = 0 where w < d
//
// Layouts are channels-last: left/right [B, H, W, C], out [B, D, H, W, G],
// all contiguous, float32 or bfloat16, accumulation in float32.
//
// What bounds it: bytes. Each output is a sum of C/G products (8 for
// GwcNet's C=320, G=40) and the output is D*G/(2*C) = 3x the two inputs
// together at GwcNet's D=48, so the goal is to stream the stores at the
// card's memory rate.
//
// Design ("stream"): a block owns one row h of one W tile of TW = 16 output
// pixels, one slice of GS groups (the whole row of groups where that fits in
// shared memory) and a chunk of the disparities [dlo, dhi). 16-byte cp.async
// copies (zero-filled off the image) stage the row's left tile [TW] and the
// right window [TW + dhi - dlo - 1] of the slice in shared memory, so each
// staged pixel is read from device memory once a block (the window's halo
// is re-read through L2). Loads overlap stores across blocks: a block is
// short and 2-4 of them share an SM. (A block walking several rows with a
// second buffer staged while the first is computed was slower at every
// shape tried on the H100.) A thread owns NG groups (1; 2 in bfloat16, stored as one bf16x2
// word) of a strip of S consecutive w and keeps the strip's left values in
// registers as float32 (scaled by 1/cpg). It steps d and slides a window of
// S right pixels through its registers: each step fetches one new right
// pixel's groups from shared memory and adds S * NG outputs, so a thread
// reads cpg / S values an output, and the loop has no division (the
// window's slot is a compile-time index of the d loop unrolled by S).
// Neighbouring lanes own neighbouring groups, so with the whole row of
// groups a warp's store covers whole pixels of one d plane (stores in runs
// under 32 bytes, from narrow slices, were several times slower); the w < d
// outputs of a strip are stored as zeros without products. The shared rows
// are swizzled by 16-byte chunk so that the lanes of a quarter warp read
// distinct banks. The wrapper (ops/volume.py::gwc_plan) halves the slice and
// then cuts D into chunks where the grid would have under 4 blocks an SM
// (CFNet's 1/8 to 1/32 volumes).
//
// C interface (loaded with ctypes): gwc_volume(...) launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 256;

// Pixels of a thread's strip: the largest power of two with S * NG * CPG
// <= 32 values (64 float registers for the left strip and the window), at
// most 8 (twice that was slower where measured). ops/volume.py::gwc_strip
// computes the same.
template <int CPG, int NG>
__host__ __device__ constexpr int strip_len() {
  int s = 8;
  while (s > 1 && s * NG * CPG > 32) s /= 2;
  return s;
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ void unpack(uint32_t u, float* dst) {
    dst[0] = __uint_as_float(u);
  }
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static constexpr int kPerWord = 1;
};
template <>
struct Elem<__nv_bfloat16> {
  // two bfloat16 a word, the first in its low half
  static __device__ __forceinline__ void unpack(uint32_t u, float* dst) {
    dst[0] = __uint_as_float(u << 16);
    dst[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static constexpr int kPerWord = 2;
};

// How a thread's NG * CPG values sit in shared memory, and how they are read.
template <typename T, int CPG, int NG>
struct Layout {
  static constexpr int kNV = NG * CPG;                   // values a thread owns
  static constexpr int kBytes = kNV * (int)sizeof(T);
  static constexpr int kEPC = 16 / (int)sizeof(T);       // elements a 16-byte chunk
  static constexpr int kChunks = kBytes % 16 == 0 ? kBytes / 16 : 0;
  // chunks of a slot swizzled (2 or 4 of them: a quarter warp's reads would
  // otherwise hit each bank group twice or four times)
  static constexpr bool kSwz = kChunks == 2 || kChunks == 4;

  static __device__ __forceinline__ int swz(int slot) {
    return kSwz ? (slot / (8 / kChunks)) % kChunks : 0;
  }
  // position in a shared pixel row of element e of the slice
  static __device__ __forceinline__ int elem(int e) {
    if constexpr (kSwz) {
      const int chunk = e / kEPC, r = e % kEPC;
      const int slot = chunk / kChunks, k = chunk % kChunks;
      return ((slot * kChunks + (k ^ swz(slot))) * kEPC) + r;
    } else {
      return e;
    }
  }
  // the position of chunk c (kEPC elements) of the slice
  static __device__ __forceinline__ int chunk(int c) {
    if constexpr (kSwz) {
      const int slot = c / kChunks, k = c % kChunks;
      return (slot * kChunks + (k ^ swz(slot))) * kEPC;
    } else {
      return c * kEPC;
    }
  }

  // the kNV values of thread slot `slot` in the pixel row `row`, as float32
  static __device__ __forceinline__ void load(const T* row, int slot, float (&dst)[kNV]) {
    const T* p = row + slot * kNV;
    if constexpr (kChunks > 0) {
      const int s = swz(slot);
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + (k ^ s) * kEPC);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) Elem<T>::unpack(w[i], dst + k * kEPC + i * Elem<T>::kPerWord);
      }
    } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
      for (int k = 0; k < kBytes / 8; ++k) {
        const uint2 v = *reinterpret_cast<const uint2*>(p + k * (8 / (int)sizeof(T)));
        Elem<T>::unpack(v.x, dst + k * (8 / (int)sizeof(T)));
        Elem<T>::unpack(v.y, dst + k * (8 / (int)sizeof(T)) + Elem<T>::kPerWord);
      }
    } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kBytes / 4; ++k)
        Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(p + k * (4 / (int)sizeof(T))),
                        dst + k * (4 / (int)sizeof(T)));
    } else {
#pragma unroll
      for (int k = 0; k < kNV; ++k) dst[k] = Elem<T>::to_f(p[k]);
    }
  }
};

template <typename T, int NG>
__device__ __forceinline__ void store(T* p, const float (&a)[NG]) {
  if constexpr (sizeof(T) == 4) {
    *p = a[0];
  } else if constexpr (NG == 2) {
    *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a[0], a[1]);
  } else {
    *p = __float2bfloat16(a[0]);
  }
}

// Stages one row's left tile (TW pixels from w0) and right window (nwin
// pixels from x0) of the slice [c0, c0 + scw) into `buf` ([TW + nwin][scp]),
// zeros off the image: 16-byte cp.async copies with `vec`, else plain loads.
template <typename T, int CPG, int NG>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ lrow,
                                      const T* __restrict__ rrow, int TW, int w0, int x0,
                                      int nwin, int W, int C, int c0, int scw, int scp, bool vec) {
  using L = Layout<T, CPG, NG>;
  const int np = TW + nwin;
  if (vec) {
    const int ch = scw / L::kEPC;
    for (int i = threadIdx.x; i < np * ch; i += blockDim.x) {
      const int p = i / ch, c = i - p * ch;
      const bool is_left = p < TW;
      const int x = is_left ? w0 + p : x0 + (p - TW);
      const bool ok = x >= 0 && x < W;
      const T* src = (is_left ? lrow : rrow) + (size_t)(ok ? x : 0) * C + c0 + c * L::kEPC;
      mma::cp_async16(mma::smem_addr(buf + p * scp + L::chunk(c)), src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < np * scw; i += blockDim.x) {
      const int p = i / scw, e = i - p * scw;
      const bool is_left = p < TW;
      const int x = is_left ? w0 + p : x0 + (p - TW);
      const bool ok = x >= 0 && x < W;
      buf[p * scp + L::elem(e)] =
          ok ? (is_left ? lrow : rrow)[(size_t)x * C + c0 + e] : T(0.f);
    }
  }
  mma::cp_async_commit();
}

template <typename T, int CPG, int NG, int S>
__global__ void __launch_bounds__(kMaxThreads)
gwc_stream_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
                  int H, int W, int C, int D, int G, int TW, int GS, int DC, int tiles,
                  int nchunks, int scp, int vec) {
  using L = Layout<T, CPG, NG>;
  constexpr int NV = L::kNV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int w0 = (blockIdx.x % tiles) * TW;
  const int g0 = (blockIdx.x / tiles) * GS;
  const int gs = min(GS, G - g0);
  const int h = blockIdx.y;
  const int b = blockIdx.z / nchunks;
  const int dlo = (blockIdx.z % nchunks) * DC, dhi = min(dlo + DC, D);
  const int nwin = TW + (dhi - dlo) - 1;   // right pixels x0 .. w0 + TW - 1 - dlo
  const int x0 = w0 - (dhi - 1);
  const int c0 = g0 * CPG, scw = gs * CPG;
  const int slots = gs / NG;
  const int items = slots * (TW / S);
  const float inv = 1.f / (float)CPG;
  const size_t dstride = (size_t)H * W * G;

  const size_t row = ((size_t)b * H + h) * W * C;
  stage<T, CPG, NG>(smem, left + row, right + row, TW, w0, x0, nwin, W, C, c0, scw, scp, vec);
  mma::cp_async_wait<0>();
  __syncthreads();
  const T* sl = smem;
  const T* sr = smem + TW * scp;

  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int slot = item % slots, strip = item / slots;
    const int ws = w0 + strip * S;
    if (ws >= W) continue;
    float lf[S][NV], rw[S][NV];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      L::load(sl + (strip * S + j) * scp, slot, lf[j]);
#pragma unroll
      for (int e = 0; e < NV; ++e) lf[j][e] *= inv;   // the mean's 1 / cpg
      // slot j of the window holds right pixel ws - dlo + j
      L::load(sr + (ws - dlo + j - x0) * scp, slot, rw[j]);
    }
    // from dz on, every output of the strip has w < d
    const int dz = min(max(ws + S, dlo), dhi);
    T* o = out + ((((size_t)b * D + dlo) * H + h) * W + ws) * G + g0 + slot * NG;
    for (int d0 = dlo; d0 < dz; d0 += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int d = d0 + u;
        if (d < dz) {
          // right pixel ws - d enters the window in place of ws - d + S
          if (u > 0 || d0 > dlo) L::load(sr + (ws - d - x0) * scp, slot, rw[(S - u) % S]);
          T* od = o + (size_t)(d - dlo) * dstride;
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const float* r = rw[(j - u + S) % S];   // right pixel ws + j - d
            float a[NG];
#pragma unroll
            for (int n = 0; n < NG; ++n) {
              float acc = 0.f;
#pragma unroll
              for (int e = 0; e < CPG; ++e) acc = fmaf(lf[j][n * CPG + e], r[n * CPG + e], acc);
              a[n] = acc;
            }
            if (ws + j < W) store<T, NG>(od + (size_t)j * G, a);
          }
        }
      }
    }
    float zero[NG];
#pragma unroll
    for (int n = 0; n < NG; ++n) zero[n] = 0.f;
    for (int d = dz; d < dhi; ++d) {
      T* od = o + (size_t)(d - dlo) * dstride;
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (ws + j < W) store<T, NG>(od + (size_t)j * G, zero);
    }
  }
}

template <typename T, int CPG, int NG, int S>
int launch(const void* left, const void* right, void* out, int B, int H, int W, int C, int D,
           int G, int TW, int GS, int DC, cudaStream_t stream) {
  constexpr int EPC = 16 / (int)sizeof(T);
  if (TW < S || TW % S || GS % NG || GS < NG || DC < 1) return (int)cudaErrorInvalidValue;
  const int scp = (GS * CPG + EPC - 1) / EPC * EPC;   // padded to 16 bytes
  const size_t smem = (size_t)(2 * TW + DC - 1) * scp * sizeof(T);
  const bool vec = (C * sizeof(T)) % 16 == 0 && (GS * CPG * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(left) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(right) % 16 == 0;
  // more than the card's 227 KB is refused here, and reported
  cudaError_t err = cudaFuncSetAttribute(gwc_stream_kernel<T, CPG, NG, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (W + TW - 1) / TW;
  const int slices = (G + GS - 1) / GS;
  const int nchunks = (D + DC - 1) / DC;
  const int items = (GS / NG) * (TW / S);
  int threads = (items + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(tiles * slices, H, B * nchunks);
  gwc_stream_kernel<T, CPG, NG, S><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<T*>(out), H, W, C,
      D, G, TW, GS, DC, tiles, nchunks, scp, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int by_cpg(const void* left, const void* right, void* out, int B, int H, int W, int C, int D,
           int G, int TW, int GS, int DC, int strip, cudaStream_t s) {
#define GWC_CASE(n)                                                                          \
  case n:                                                                                    \
    return strip == strip_len<n, NG>()                                                       \
               ? launch<T, n, NG, strip_len<n, NG>()>(left, right, out, B, H, W, C, D, G, TW, \
                                                      GS, DC, s)                             \
               : (int)cudaErrorInvalidValue;
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
      return (int)cudaErrorInvalidValue;
  }
#undef GWC_CASE
}

// ------------------------------------------------------------ the backward
//
// Replaces the gradient that JAX takes through the XLA path of
// ops/volume.py::build_gwc_volume (groupwise_correlation over
// shifted_right_stack); the Pallas K1 has no reverse-mode rule. With g the
// group of channel c and cpg = C / G, given the output's gradient gd:
//
//   dl[b, h, w, c] = 1/cpg * sum_{d <= min(D - 1, w)}         gd[b, d, h, w, g]     * right[b, h, w - d, c]
//   dr[b, h, u, c] = 1/cpg * sum_{d <= min(D - 1, W - 1 - u)} gd[b, d, h, u + d, g] * left[b, h, u + d, c]
//
// What bounds it: bytes. gd is D * G / (2 * C) = 3x the four feature maps
// together at GwcNet's D = 48, and only its entries with d <= w reach an
// output, so the goal is to read each of those once, and each feature
// value once, at the card's memory rate.
//
// Design ("rowpass", plan ops/volume.py::gwc_backward_plan): a block owns
// one row (b, h), a slice of GS groups (16 bytes of gd a pixel: 4 in
// float32, 8 in bfloat16) and, where the row's slice does not fit in
// shared memory, a W tile of TW pixels (GwcNet's and CFNet's train rows
// fit whole). It stages in shared memory, once, with cp.async:
//   - gd[b, :, h, :, slice] of the planes d < min(D, W), only the pixels
//     [max(w0, d), w0 + TW + d) that reach the tile's outputs (on a whole
//     row the triangle w >= d; a tile's dr side reaches D - 1 pixels past
//     it), from the plane's first such pixel rounded down to 8: one
//     16-byte copy a pixel, the pixels of each 8 permuted (pixel x at
//     x ^ ((x / 8) % S)) so that the lanes of a warp, 4 slots of 8
//     strips, read 32 distinct banks at any d;
//   - the slice of the right row [w0 - D + 1, w0 + TW) and of the left row
//     [w0, w0 + TW + D - 1), 16 bytes a copy, each pixel's row padded to
//     8k chunks and its chunks XOR-swizzled by (w / S) % 8, so that a
//     quarter warp, 4 slots of 2 strips, reads 8 distinct bank groups.
// The planes are copied a group of 8 at a time, at most two groups in
// flight, and the block's first round of thread items steps d a group at
// a time as the groups land, so that the blocks' loads spread over their
// compute (every block loading its whole row before any computed left the
// memory idle while 2 blocks an SM computed: 0.244 ms against 0.2215 at
// GwcNet_G's f32 launch on the H100). It computes both outputs from shared
// memory: with the row staged, dr is a gather too (gd[d, u + d] and
// left[u + d]), so nothing is scattered. A thread item is one output's NG
// groups (a 4-byte gd word: a float32, or a bf16x2 pair where G is even)
// of a strip of S pixels (the forward's, at most 4): its sums stay in
// float32 registers while it steps d, and a window of S feature pixels
// slides through its registers (one new pixel a step, right pixels
// leftwards for dl, left pixels rightwards for dr), so a feature value
// feeds S products. Lanes take the slots of a pixel, then consecutive
// strips. Every output is one thread's ordered float32 sum, written once,
// without atomics: the same inputs give the same bits in every run. gd,
// left and right are read from device memory once (a W tile's halo again
// through L2), dl and dr written once. A slice that is not 16 bytes of gd
// a pixel, a misaligned base or row (odd G in bfloat16) takes the same
// design with the plain layout: a pixel's words in order, copied a word
// at a time.

constexpr int kBwdThreads = 256;

// Pixels of a backward thread's strip: the forward's, at most 4 (8 left
// CFNet's C/G = 4 blocks at 64 threads, too few to hide shared memory's
// latency). ops/volume.py::gwc_backward_strip computes the same.
template <int CPG, int NG>
__host__ __device__ constexpr int bwd_strip_len() {
  return strip_len<CPG, NG>() < 4 ? strip_len<CPG, NG>() : 4;
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// cp.async of one 4-byte word, zero-filled when !pred (src must still be a
// valid address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// A staged gd word: the NG groups of one pixel of a slot (a float32 or a
// bf16x2 pair: 4 bytes; one bfloat16: 2).
template <typename T, int NG>
struct GdWord {
  using type = typename std::conditional<NG * sizeof(T) == 4, uint32_t, uint16_t>::type;
  static __device__ __forceinline__ void unpack(type w, float (&dst)[NG]) {
    if constexpr (sizeof(T) == 4) {
      dst[0] = __uint_as_float(w);
    } else if constexpr (NG == 2) {
      dst[0] = __uint_as_float(w << 16);
      dst[1] = __uint_as_float(w & 0xffff0000u);
    } else {
      dst[0] = __uint_as_float((uint32_t)w << 16);
    }
  }
};

// The pixels that planes d < w0 + m of a tile skip: sum_{k < m} A * (k / A)
// (plane d's rows start at its first pixel rounded down to A, tile-local).
__host__ __device__ __forceinline__ int skipped(int m, int A) {
  const int q = m / A, r = m % A;
  return A * (A * q * (q - 1) / 2 + r * q);
}

// Staged pixels of each gd row of a tile at w0 of tw pixels: its planes
// reach tw + DP - 1 pixels, the row's end at most.
__host__ __device__ __forceinline__ int plane_cap(int W, int w0, int tw, int DP, int A) {
  return round_up(imin(W - w0, tw + DP - 1), A);
}

// Words of a tile's staged gd: `slots` rows of cap - a_d words a plane.
__host__ __device__ __forceinline__ int tile_words(int slots, int W, int w0, int tw, int DP,
                                                   int A) {
  return slots * (DP * plane_cap(W, w0, tw, DP, A) - skipped(imax(0, DP - w0), A));
}

// A plane's staged rows start at its first pixel rounded down to kA.
constexpr int kA = 8;
// Planes a commit group of a block's gd copies.
constexpr int kPlanes = 8;
// Shared bytes of a rowpass block (ops/volume.py::gwc_backward_smem computes
// the same): the two feature windows of min(W, TW + DP - 1) pixel rows, then
// the largest tile's gd words.
template <typename T, int CPG, int NG>
size_t rowpass_smem(int W, int D, int TW, int GS) {
  using GW = typename GdWord<T, NG>::type;
  const int DP = imin(D, W);
  const int NR = imin(W, TW + DP - 1);
  const int RE = round_up((GS * CPG * (int)sizeof(T) + 15) / 16, 8) * (16 / (int)sizeof(T));
  int words = 0;
  for (int w0 = 0; w0 < W; w0 += TW)
    words = imax(words, tile_words(GS / NG, W, w0, imin(TW, W - w0), DP, kA));
  return (size_t)2 * NR * RE * sizeof(T) + round_up(words * (int)sizeof(GW), 16);
}

// Where pixel x of a staged gd plane row sits: with FAST (4 words a pixel)
// the pixels of each 8 permuted, x ^ ((x / 8) % S), else in order. A warp's
// lanes read 8 pixels S apart (8 strips) at any offset: their 16-byte
// chunks then fall on 8 distinct bank groups.
template <bool FAST, int S>
__device__ __forceinline__ int gd_pixel(int x) {
  if constexpr (FAST) {
    return x ^ ((x >> 3) & (S - 1));
  } else {
    return x;
  }
}

// N values of T at p as float32 written to p as T: with VEC, in vec_bytes
// words, else one at a time.
template <typename T, int N>
__host__ __device__ constexpr int vec_bytes() {
  constexpr int b = N * (int)sizeof(T);
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : b % 4 == 0 ? 4 : (int)sizeof(T);
}

template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[N]) {
  constexpr int VB = vec_bytes<T, N>();
  if constexpr (VEC && VB >= 4) {
    constexpr int WORDS = VB / 4, PER = 4 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < N * (int)sizeof(T) / VB; ++k) {
      uint32_t w[WORDS];
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        const float* s = v + (k * WORDS + i) * PER;
        if constexpr (sizeof(T) == 4) {
          w[i] = __float_as_uint(s[0]);
        } else {
          w[i] = mma::pack_bf16(s[0], s[1]);
        }
      }
      if constexpr (WORDS == 4) {
        reinterpret_cast<uint4*>(p)[k] = make_uint4(w[0], w[1], w[2], w[3]);
      } else if constexpr (WORDS == 2) {
        reinterpret_cast<uint2*>(p)[k] = make_uint2(w[0], w[1]);
      } else {
        reinterpret_cast<uint32_t*>(p)[k] = w[0];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (sizeof(T) == 4) {
        p[i] = v[i];
      } else {
        p[i] = __float2bfloat16(v[i]);
      }
    }
  }
}

// The NV values of thread slot `slot` in a staged feature row (chunks
// swizzled by `key`), as float32: 16-byte loads where a slot is whole
// chunks, else one value at a time.
template <typename T, int NV>
__device__ __forceinline__ void load_feat(const T* rowp, int slot, int key, float (&dst)[NV]) {
  constexpr int EPC = 16 / (int)sizeof(T);
  if constexpr ((NV * sizeof(T)) % 16 == 0) {
    constexpr int K = NV / EPC;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(rowp + ((slot * K + k) ^ key) * EPC);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) Elem<T>::unpack(w[i], dst + k * EPC + i * Elem<T>::kPerWord);
    }
  } else {
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int ee = slot * NV + e;
      dst[e] = Elem<T>::to_f(rowp[((ee / EPC) ^ key) * EPC + ee % EPC]);
    }
  }
}

// FAST: 16 bytes of gd a pixel, copied whole and permuted (gd_pixel), and
// the outputs stored in vector words; else the plain layout, a word a copy,
// and the outputs a value at a time.
template <typename T, int CPG, int NG, int S, bool FAST>
__global__ void __launch_bounds__(kBwdThreads, 2)
gwc_rowpass_kernel(const T* __restrict__ left, const T* __restrict__ right,
                   const T* __restrict__ gd, T* __restrict__ dl, T* __restrict__ dr, int H,
                   int W, int C, int D, int G, int TW, int GS, int slices, int vecf) {
  constexpr int NV = NG * CPG;
  constexpr int EPC = 16 / (int)sizeof(T);
  using GW = typename GdWord<T, NG>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int slice = blockIdx.x % slices, tile = blockIdx.x / slices;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g0 = slice * GS, gs = imin(GS, G - g0), slots = gs / NG;
  const int c0 = g0 * CPG, scw = gs * CPG;
  const int w0 = tile * TW, tw = imin(TW, W - w0);
  const int DP = imin(D, W);
  const int NR = imin(W, TW + DP - 1);
  const int RE = round_up((GS * CPG * (int)sizeof(T) + 15) / 16, 8) * EPC;
  const int cap = plane_cap(W, w0, tw, DP, kA);
  const int rlo = imax(0, w0 - (DP - 1)), rn = w0 + tw - rlo;  // right pixels [rlo, w0 + tw)
  const int lhi = imin(W, w0 + tw + DP - 1), ln = lhi - w0;    // left pixels [w0, lhi)
  T* sr = reinterpret_cast<T*>(smem_raw);
  T* sl = sr + (size_t)NR * RE;
  GW* sg = reinterpret_cast<GW*>(sl + (size_t)NR * RE);
  const size_t row = ((size_t)b * H + h) * W;  // pixel (b, h, 0)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;

  // the right and left slices, pixel rows swizzled by 16-byte chunk
  {
    const T* rrow = right + row * C + c0;
    const T* lrow = left + row * C + c0;
    if (vecf) {
      const int nch = scw / EPC;
      for (int i = threadIdx.x; i < (rn + ln) * nch; i += blockDim.x) {
        const int p = i / nch, q = i - p * nch;
        const bool is_r = p < rn;
        const int x = is_r ? rlo + p : w0 + (p - rn);
        T* dst = (is_r ? sr + (size_t)p * RE : sl + (size_t)(p - rn) * RE) +
                 (q ^ ((x / S) & 7)) * EPC;
        mma::cp_async16(mma::smem_addr(dst), (is_r ? rrow : lrow) + (size_t)x * C + q * EPC,
                        true);
      }
    } else {
      for (int i = threadIdx.x; i < (rn + ln) * scw; i += blockDim.x) {
        const int p = i / scw, e = i - p * scw;
        const bool is_r = p < rn;
        const int x = is_r ? rlo + p : w0 + (p - rn);
        T* dst = is_r ? sr + (size_t)p * RE : sl + (size_t)(p - rn) * RE;
        dst[((e / EPC) ^ ((x / S) & 7)) * EPC + e % EPC] =
            (is_r ? rrow : lrow)[(size_t)x * C + e];
      }
    }
  }
  // gd, a group of kPlanes planes a commit group, at most two groups in
  // flight: plane d's rows hold the tile-local pixels [a_d, cap) (slots
  // words a pixel), copies of [max(w0, d), w0 + tw + d) within the row,
  // zeros elsewhere
  const int groups = (DP + kPlanes - 1) / kPlanes;
  auto stage_group = [&](int k) {
    for (int d = k * kPlanes + warp; d < imin(DP, (k + 1) * kPlanes); d += nwarps) {
      const int m = imax(0, d - w0), a = m & ~(kA - 1), P = cap - a;
      const int lo = imax(w0, d), hi = imin(W, w0 + tw + d);
      const T* pd = gd + (((size_t)b * D + d) * H + h) * W * G + g0;
      GW* dst = sg + slots * (d * cap - skipped(m, kA));
      for (int i = lane; i < P * (FAST ? 1 : slots); i += 32) {
        const int x = FAST ? i : i / slots, k2 = FAST ? 0 : i - x * slots;
        const int xa = w0 + a + x;
        const bool ok = xa >= lo && xa < hi;
        const T* src = pd + (size_t)(ok ? xa : 0) * G + k2 * NG;
        if constexpr (FAST) {
          mma::cp_async16(mma::smem_addr(dst + gd_pixel<FAST, S>(x) * 4), src, ok);
        } else if constexpr (sizeof(GW) == 4) {
          cp_async4(mma::smem_addr(dst + x * slots + k2), src, ok);
        } else {
          dst[x * slots + k2] = ok ? *reinterpret_cast<const GW*>(src) : GW(0);
        }
      }
    }
    mma::cp_async_commit();
  };
  stage_group(0);
  stage_group(1);

  // Thread items in rounds of blockDim.x; the first round steps d a group
  // of planes at a time: once group k has landed, group k + 2 is issued and
  // the round's items take the planes of group k.
  const float inv = 1.f / (float)CPG;
  const int nstrips = (tw + S - 1) / S;
  const int n_items = slots * nstrips;
  const int rounds = (2 * n_items + blockDim.x - 1) / blockDim.x;
  for (int rd = 0; rd < rounds; ++rd) {
    const int item = rd * blockDim.x + threadIdx.x;
    const bool valid = item < 2 * n_items;
    const bool is_dr = item >= n_items;
    const int it = is_dr ? item - n_items : item;
    const int strip = it / slots, slot = it - strip * slots;
    const int ws = w0 + strip * S;
    // dl: slot j of the window holds right pixel ws + j at d = 0; pixel ws + j
    // takes right[ws + j - d] from slot (j - u) mod S, and right[ws - d]
    // enters in place of ws - d + S. dr: slot j holds left pixel ws + j at
    // d = 0; pixel ws + j takes left[ws + j + d] from slot (j + u) mod S, and
    // left[ws + d + S - 1] enters in place of ws + d - 1.
    const int dmax = is_dr ? imin(DP - 1, W - 1 - ws) : imin(DP - 1, ws + S - 1);
    float acc[S][NV], win[S][NV];
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[j][e] = win[j][e] = 0.f;
    }
    // plane d's words start at `base` (from 0, each plane adds slots * P_d)
    int base = 0;
    for (int k = 0; k < groups; ++k) {
      if (rd == 0) {
        mma::cp_async_wait<1>();
        __syncthreads();
        stage_group(k + 2);
      }
      if (!valid) continue;
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int x = ws + j;
          if (!is_dr && x < w0 + tw) {
            load_feat<T, NV>(sr + (size_t)(x - rlo) * RE, slot, (x / S) & 7, win[j]);
          } else if (is_dr && x < lhi) {
            load_feat<T, NV>(sl + (size_t)(x - w0) * RE, slot, (x / S) & 7, win[j]);
          }
        }
      }
      const int dend = imin(dmax + 1, (k + 1) * kPlanes);
      for (int d0 = k * kPlanes; d0 < dend; d0 += S) {
#pragma unroll
        for (int u = 0; u < S; ++u) {
          const int d = d0 + u;
          if (d < dend) {
            const int a = imax(0, d - w0) & ~(kA - 1), P = cap - a;
            const GW* gp = sg + base + slot;
            if (!is_dr) {
              if (d > 0) {
                const int x = ws - d;
                if (x >= 0) {
                  load_feat<T, NV>(sr + (size_t)(x - rlo) * RE, slot, (x / S) & 7,
                                   win[(S - u) % S]);
                } else {
#pragma unroll
                  for (int e = 0; e < NV; ++e) win[(S - u) % S][e] = 0.f;
                }
              }
              // the strip's S pixels x .. x + S - 1 (x a multiple of S) lie in
              // one 8 of the plane's row: their words sit at x + (j ^ key)
              const int x = ws - w0 - a;
              const int key = FAST ? (x >> 3) & (S - 1) : 0;
#pragma unroll
              for (int j = 0; j < S; ++j) {
                float g[NG];
                GdWord<T, NG>::unpack(gp[FAST ? (x + (j ^ key)) * 4 : (x + j) * slots], g);
                const float* r = win[(j - u + S) % S];
#pragma unroll
                for (int n = 0; n < NG; ++n)
#pragma unroll
                  for (int e = 0; e < CPG; ++e)
                    acc[j][n * CPG + e] = fmaf(g[n], r[n * CPG + e], acc[j][n * CPG + e]);
              }
            } else {
              if (d > 0) {
                const int x = ws + d + S - 1;
                if (x < lhi) {
                  load_feat<T, NV>(sl + (size_t)(x - w0) * RE, slot, (x / S) & 7,
                                   win[(u + S - 1) % S]);
                } else {
#pragma unroll
                  for (int e = 0; e < NV; ++e) win[(u + S - 1) % S][e] = 0.f;
                }
              }
#pragma unroll
              for (int j = 0; j < S; ++j) {
                // pixels past the row give no term; their reads stay in the plane
                const int x = imin(ws - w0 + d + j - a, P - 1);
                float g[NG];
                GdWord<T, NG>::unpack(gp[FAST ? gd_pixel<FAST, S>(x) * 4 : x * slots], g);
                const float* l = win[(j + u) % S];
#pragma unroll
                for (int n = 0; n < NG; ++n) {
                  const float gv = ws + j + d < W ? g[n] : 0.f;
#pragma unroll
                  for (int e = 0; e < CPG; ++e)
                    acc[j][n * CPG + e] = fmaf(gv, l[n * CPG + e], acc[j][n * CPG + e]);
                }
              }
            }
            base += slots * P;
          }
        }
      }
    }
    if (!valid) continue;
    T* outp = (is_dr ? dr : dl) + row * C + c0 + slot * NV;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (ws + j < w0 + tw) {
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[j][e] *= inv;
        store_vals<T, NV, FAST>(outp + (size_t)(ws + j) * C, acc[j]);
      }
    }
  }
}

template <typename T, int CPG, int NG, int S>
int launch_rowpass(const void* left, const void* right, const void* gd, void* dl, void* dr,
                   int B, int H, int W, int C, int D, int G, int TW, int GS, int threads,
                   int smem, cudaStream_t stream) {
  using GW = typename GdWord<T, NG>::type;
  if (TW < 1 || (TW < W && TW % kA) || GS < NG || GS % NG || G % NG || threads < 32 ||
      threads > kBwdThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (sizeof(GW) == 4 && reinterpret_cast<uintptr_t>(gd) % 4) return (int)cudaErrorInvalidValue;
  if ((size_t)smem != rowpass_smem<T, CPG, NG>(W, D, TW, GS)) return (int)cudaErrorInvalidValue;
  // FAST: every slice 16 bytes of gd a pixel on 16-byte boundaries, the
  // outputs' rows and bases on their vector words' boundaries; the feature
  // slices staged in 16-byte copies where every slice's channels, the rows
  // and both bases are
  constexpr int VF = vec_bytes<T, NG * CPG>();
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dl) | reinterpret_cast<uintptr_t>(dr);
  const bool fast = sizeof(GW) == 4 && GS * sizeof(T) == 16 && G % GS == 0 &&
                    (G * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(gd) % 16 == 0 &&
                    (C * (int)sizeof(T)) % VF == 0 && outs % VF == 0;
  const uintptr_t feats = reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right);
  const bool vecf = (C * sizeof(T)) % 16 == 0 && (GS * CPG * sizeof(T)) % 16 == 0 &&
                    ((G % GS) * CPG * sizeof(T)) % 16 == 0 && feats % 16 == 0;
  const int slices = (G + GS - 1) / GS, tiles = (W + TW - 1) / TW;
  const dim3 grid(slices * tiles, H, B);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  const T* g = static_cast<const T*>(gd);
  T* ol = static_cast<T*>(dl);
  T* orr = static_cast<T*>(dr);
  cudaError_t err;
  if (fast) {
    err = cudaFuncSetAttribute(gwc_rowpass_kernel<T, CPG, NG, S, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gwc_rowpass_kernel<T, CPG, NG, S, true><<<grid, threads, smem, stream>>>(
        l, r, g, ol, orr, H, W, C, D, G, TW, GS, slices, vecf ? 1 : 0);
  } else {
    err = cudaFuncSetAttribute(gwc_rowpass_kernel<T, CPG, NG, S, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gwc_rowpass_kernel<T, CPG, NG, S, false><<<grid, threads, smem, stream>>>(
        l, r, g, ol, orr, H, W, C, D, G, TW, GS, slices, vecf ? 1 : 0);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int backward_by_cpg(const void* left, const void* right, const void* gd, void* dl, void* dr,
                    int B, int H, int W, int C, int D, int G, int TW, int GS, int strip,
                    int threads, int smem, cudaStream_t s) {
#define GWC_BWD_CASE(n)                                                                      \
  case n:                                                                                    \
    return strip == bwd_strip_len<n, NG>()                                                   \
               ? launch_rowpass<T, n, NG, bwd_strip_len<n, NG>()>(left, right, gd, dl, dr, B, H, \
                                                              W, C, D, G, TW, GS, threads,   \
                                                              smem, s)                       \
               : (int)cudaErrorInvalidValue;
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
      return (int)cudaErrorInvalidValue;
  }
#undef GWC_BWD_CASE
}

}  // namespace


extern "C" {

// dtype: 0 = float32, 1 = bfloat16. The plan (tile TW, groups a slice GS,
// disparities a chunk DC, strip S) comes from ops/volume.py::gwc_plan; C / G
// must be 1, 2, 3, 4, 6, 8, 12 or 16.
int gwc_volume(const void* left, const void* right, void* out, int B, int H, int W, int C, int D,
               int G, int dtype, int TW, int GS, int DC, int strip, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || D < 1 || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_cpg<float, 1>(left, right, out, B, H, W, C, D, G, TW, GS, DC, strip, s);
  if (dtype == 1)
    return G % 2 == 0
               ? by_cpg<__nv_bfloat16, 2>(left, right, out, B, H, W, C, D, G, TW, GS, DC, strip,
                                          s)
               : by_cpg<__nv_bfloat16, 1>(left, right, out, B, H, W, C, D, G, TW, GS, DC, strip,
                                          s);
  return (int)cudaErrorInvalidValue;
}

// dl, dr of gwc_volume given its output's gradient gd ([B, D, H, W, G], in
// the features' type). dtype: 0 = float32, 1 = bfloat16. The plan (W tile
// TW, groups a slice GS, strip S, groups a thread NG: 2 only in bfloat16
// with G even and gd 4-byte aligned, threads a block, shared bytes a
// block, which must be rowpass_smem's) comes from
// ops/volume.py::gwc_backward_plan; C / G as for gwc_volume.
int gwc_volume_backward(const void* left, const void* right, const void* gd, void* dl, void* dr,
                        int B, int H, int W, int C, int D, int G, int dtype, int TW, int GS,
                        int strip, int ng, int threads, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || D < 1 || G < 1 || C % G || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && ng == 1)
    return backward_by_cpg<float, 1>(left, right, gd, dl, dr, B, H, W, C, D, G, TW, GS, strip,
                                     threads, smem, s);
  if (dtype == 1 && ng == 2)
    return backward_by_cpg<__nv_bfloat16, 2>(left, right, gd, dl, dr, B, H, W, C, D, G, TW, GS,
                                             strip, threads, smem, s);
  if (dtype == 1 && ng == 1)
    return backward_by_cpg<__nv_bfloat16, 1>(left, right, gd, dl, dr, B, H, W, C, D, G, TW, GS,
                                             strip, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
