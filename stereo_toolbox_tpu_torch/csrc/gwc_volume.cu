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
// together at GwcNet's D = 48, and each of its values feeds cpg products
// into each output, so the goal is to read gd once at the card's memory
// rate.
//
// Design ("window"): a block owns one row h of one W tile of TW pixels and
// one of the two outputs (blockIdx.z = 2 * b + output). A thread owns NG
// groups (1; 2 in bfloat16 where G is even, read as one bf16x2 word) of a
// strip of S consecutive pixels, keeps the strip's sums in registers as
// float32 and steps d from 0, as the forward does: a window of S feature
// pixels slides through its registers (one new pixel's groups a step, read
// through the read-only cache; the window's slot is a compile-time index of
// the d loop unrolled by S) and S gd values a step come straight from
// device memory. Neighbouring lanes own neighbouring groups, so a warp's gd
// loads and its stores cover whole pixels. dl's strip reads gd[d, ws + j]
// and right[ws + j - d]; dr's reads gd[d, ws + j + d] (the next tiles' gd,
// which their dl blocks read too, through L2) and left[ws + j + d]. No
// shared memory, no atomics: every output is written once, by one thread,
// and the result is the same in every run. The plan (tile, strip, groups a
// thread) comes from ops/volume.py::gwc_backward_plan.

template <typename T>
struct Word;
template <>
struct Word<float> {
  static __device__ __forceinline__ float get(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
};
template <>
struct Word<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// Bytes a vector access of N values of T: the widest of 16, 8 and 4 that
// divides N * sizeof(T), else one value at a time.
template <typename T, int N>
__host__ __device__ constexpr int vec_bytes() {
  constexpr int b = N * (int)sizeof(T);
  return b % 16 == 0 ? 16 : b % 8 == 0 ? 8 : b % 4 == 0 ? 4 : (int)sizeof(T);
}

// N values of T at p as float32: with VEC, in vec_bytes words (p aligned to
// them), else one value at a time.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float (&dst)[N]) {
  constexpr int VB = vec_bytes<T, N>();
  if constexpr (VEC && VB >= 4) {
    constexpr int WORDS = VB / 4, PER = 4 / (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < N * (int)sizeof(T) / VB; ++k) {
      uint32_t w[WORDS];
      if constexpr (WORDS == 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else if constexpr (WORDS == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
        w[0] = v.x, w[1] = v.y;
      } else {
        w[0] = __ldg(reinterpret_cast<const uint32_t*>(p) + k);
      }
#pragma unroll
      for (int i = 0; i < WORDS; ++i) Elem<T>::unpack(w[i], dst + (k * WORDS + i) * PER);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = Word<T>::get(p + i);
  }
}

// N float32 values to p as T: with VEC, in vec_bytes words, else one at a
// time.
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
    for (int i = 0; i < N; ++i) Word<T>::put(p + i, v[i]);
  }
}

template <typename T, int CPG, int NG, int S, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
gwc_backward_kernel(const T* __restrict__ left, const T* __restrict__ right,
                    const T* __restrict__ gd, T* __restrict__ dl, T* __restrict__ dr, int H,
                    int W, int C, int D, int G, int TW) {
  constexpr int NV = NG * CPG;
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool is_dr = blockIdx.z & 1;
  const int slots = G / NG;
  const int items = slots * (TW / S);
  const float inv = 1.f / (float)CPG;
  const size_t row = ((size_t)b * H + h) * W;          // pixel index of (b, h, 0)
  const size_t dstride = (size_t)H * W * G;            // gd's d planes
  const T* gdrow = gd + ((size_t)b * D * H + h) * W * G;
  // dl reads right, dr reads left
  const T* feat = (is_dr ? left : right) + row * C;
  T* outp = (is_dr ? dr : dl) + row * C;

  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int slot = item % slots, strip = item / slots;
    const int ws = w0 + strip * S;
    if (ws >= W) continue;
    const int c0 = slot * NV, g0 = slot * NG;
    float acc[S][NV], win[S][NV];
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[j][e] = 0.f;
      // slot j of the window holds feature pixel ws + j (d = 0)
      if (ws + j < W) {
        load_vals<T, NV, VEC>(feat + (size_t)(ws + j) * C + c0, win[j]);
      } else {
#pragma unroll
        for (int e = 0; e < NV; ++e) win[j][e] = 0.f;
      }
    }
    // the last d that reaches any pixel of the strip
    const int dmax = is_dr ? min(D - 1, W - 1 - ws) : min(D - 1, ws + S - 1);
    for (int d0 = 0; d0 <= dmax; d0 += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int d = d0 + u;
        if (d <= dmax) {
          const T* gdd = gdrow + (size_t)d * dstride + g0;
          if (!is_dr) {
            // dl: pixel ws + j takes right[ws + j - d], which sits in slot
            // (j - u) mod S; right[ws - d] enters in place of ws - d + S
            if (d > 0) {
              if (ws - d >= 0) {
                load_vals<T, NV, VEC>(feat + (size_t)(ws - d) * C + c0, win[(S - u) % S]);
              } else {
#pragma unroll
                for (int e = 0; e < NV; ++e) win[(S - u) % S][e] = 0.f;
              }
            }
#pragma unroll
            for (int j = 0; j < S; ++j) {
              const int w = ws + j;
              if (w < W && d <= w) {
                float g[NG];
                load_vals<T, NG, true>(gdd + (size_t)w * G, g);
                const float* r = win[(j - u + S) % S];
#pragma unroll
                for (int n = 0; n < NG; ++n)
#pragma unroll
                  for (int e = 0; e < CPG; ++e)
                    acc[j][n * CPG + e] = fmaf(g[n], r[n * CPG + e], acc[j][n * CPG + e]);
              }
            }
          } else {
            // dr: pixel ws + j takes left[ws + j + d], which sits in slot
            // (j + u) mod S; left[ws + d + S - 1] enters in place of ws + d - 1
            if (d > 0) {
              const int x = ws + d + S - 1;
              if (x < W) {
                load_vals<T, NV, VEC>(feat + (size_t)x * C + c0, win[(u + S - 1) % S]);
              } else {
#pragma unroll
                for (int e = 0; e < NV; ++e) win[(u + S - 1) % S][e] = 0.f;
              }
            }
#pragma unroll
            for (int j = 0; j < S; ++j) {
              const int x = ws + j + d;
              if (x < W) {
                float g[NG];
                load_vals<T, NG, true>(gdd + (size_t)x * G, g);
                const float* l = win[(j + u) % S];
#pragma unroll
                for (int n = 0; n < NG; ++n)
#pragma unroll
                  for (int e = 0; e < CPG; ++e)
                    acc[j][n * CPG + e] = fmaf(g[n], l[n * CPG + e], acc[j][n * CPG + e]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (ws + j < W) {
#pragma unroll
        for (int e = 0; e < NV; ++e) acc[j][e] *= inv;
        store_vals<T, NV, VEC>(outp + (size_t)(ws + j) * C + c0, acc[j]);
      }
    }
  }
}

template <typename T, int CPG, int NG, int S>
int launch_backward(const void* left, const void* right, const void* gd, void* dl, void* dr,
                    int B, int H, int W, int C, int D, int G, int TW, cudaStream_t stream) {
  if (TW < S || TW % S || G % NG) return (int)cudaErrorInvalidValue;
  // gd is read NG values a word (a bf16x2 word where NG = 2); the features
  // and outputs in vector words where every base and row is on their
  // boundaries, else one value at a time
  constexpr int VF = vec_bytes<T, NG * CPG>(), VG = vec_bytes<T, NG>();
  if (reinterpret_cast<uintptr_t>(gd) % VG) return (int)cudaErrorInvalidValue;
  const bool vec = (C * (int)sizeof(T)) % VF == 0 &&
                   reinterpret_cast<uintptr_t>(left) % VF == 0 &&
                   reinterpret_cast<uintptr_t>(right) % VF == 0 &&
                   reinterpret_cast<uintptr_t>(dl) % VF == 0 &&
                   reinterpret_cast<uintptr_t>(dr) % VF == 0;
  const int tiles = (W + TW - 1) / TW;
  const int items = (G / NG) * (TW / S);
  int threads = (items + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(tiles, H, 2 * B);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  const T* g = static_cast<const T*>(gd);
  T* ol = static_cast<T*>(dl);
  T* orr = static_cast<T*>(dr);
  if (vec) {
    gwc_backward_kernel<T, CPG, NG, S, true><<<grid, threads, 0, stream>>>(l, r, g, ol, orr, H, W, C, D, G, TW);
  } else {
    gwc_backward_kernel<T, CPG, NG, S, false><<<grid, threads, 0, stream>>>(l, r, g, ol, orr, H, W, C, D, G, TW);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int backward_by_cpg(const void* left, const void* right, const void* gd, void* dl, void* dr,
                    int B, int H, int W, int C, int D, int G, int TW, int strip,
                    cudaStream_t s) {
#define GWC_BWD_CASE(n)                                                                    \
  case n:                                                                                  \
    return strip == strip_len<n, NG>()                                                     \
               ? launch_backward<T, n, NG, strip_len<n, NG>()>(left, right, gd, dl, dr, B, \
                                                               H, W, C, D, G, TW, s)        \
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
// the features' type). dtype: 0 = float32, 1 = bfloat16. The plan (tile TW,
// strip S, groups a thread NG: 2 only in bfloat16 with G even) comes from
// ops/volume.py::gwc_backward_plan; C / G as for gwc_volume.
int gwc_volume_backward(const void* left, const void* right, const void* gd, void* dl, void* dr,
                        int B, int H, int W, int C, int D, int G, int dtype, int TW, int strip,
                        int ng, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || D < 1 || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && ng == 1)
    return backward_by_cpg<float, 1>(left, right, gd, dl, dr, B, H, W, C, D, G, TW, strip, s);
  if (dtype == 1 && ng == 2)
    return backward_by_cpg<__nv_bfloat16, 2>(left, right, gd, dl, dr, B, H, W, C, D, G, TW,
                                             strip, s);
  if (dtype == 1 && ng == 1)
    return backward_by_cpg<__nv_bfloat16, 1>(left, right, gd, dl, dr, B, H, W, C, D, G, TW,
                                             strip, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
