// Concatenation cost volume for Hopper, sm_90a (K6).
//
// Replaces stereo_toolbox_tpu/ops/pallas/volume.py::build_concat_volume_pallas
// (kernel body `_concat_kernel`), the volume of
// ops/volume.py::build_concat_volume, with the left half masked or not:
//
//   out[b, d, h, w, 0:C]  = left[b, h, w, :]       where w >= d or !mask_left,
//                                                  else 0
//   out[b, d, h, w, C:2C] = right[b, h, w - d, :]  where w >= d, else 0
//
// Layouts are channels-last: left/right [B, H, W, C], out [B, D, H, W, 2C],
// contiguous, float32 or bfloat16. With mask_left, planes with d >= W are all
// zero; without it (ACVNet, IGEV), only their right halves are.
//
// What bounds it: bytes. It is a copy: the output is 2 * D times the size of
// one input, and it is written once.
//
// Design ("rows", plan ops/volume.py::concat_plan): the row out[b, d, h, :, :]
// is W * 2C contiguous elements whatever C is, so a block owns one row (b, h)
// (or a W tile of it, where the two staged rows would pass the plan's
// shared-memory cap) and a run of disparities [dlo, dhi). It stages the left
// row and the right pixels its disparities reach in shared memory once (a
// run of one plane, in CFNet's smallest volumes, reads them straight from
// device memory instead: its launch is bound by latency, and the staging's
// wait and barrier would only add to it), then
// writes each d plane's row as VB-byte stores over the flat row: 16 bytes
// where the row's bytes allow, else 8 or 4 (a row whose length is not a
// multiple of 16 bytes, such as bfloat16 with W * C odd). A store may
// straddle pixels and the two halves: it is assembled from SB-byte words,
// SB the widest that divides a half pixel (C's bytes), so that each word is
// one shared load, masked as a whole (bfloat16 C = 12: 24-byte halves, two
// 8-byte words a 16-byte store). A thread keeps its store's (pixel,
// channel) position and steps it by constants of the block (no division a
// store), loads its left words once and writes its store in every plane of
// the run, one store instruction a plane, so a warp writes 512 contiguous
// bytes of one plane at a time.
//
// The backward (K6-bwd, concat_volume_backward): see below.
//
// C interface (loaded with ctypes): concat_volume(...) and
// concat_volume_backward(...) launch on the given stream, allocate nothing,
// synchronise nothing and return cudaGetLastError() (cudaErrorInvalidValue
// for a plan they do not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int VB>
struct Vec;
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<4> {
  using type = uint32_t;
};
template <>
struct Vec<2> {
  using type = uint16_t;
};

// `bytes` from src to shared dst in `word`-byte units (16: cp.async; 4 or
// 2: plain loads); word divides bytes and both addresses.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes, int word) {
  if (word == 16) {
    for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      mma::cp_async16(mma::smem_addr(static_cast<uint4*>(dst) + i),
                      static_cast<const uint4*>(src) + i, true);
    mma::cp_async_commit();
  } else if (word == 4) {
    for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x)
      static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < bytes / 2; i += blockDim.x)
      static_cast<uint16_t*>(dst)[i] = static_cast<const uint16_t*>(src)[i];
  }
}

// E: the element's bits (uint32_t for float32, uint16_t for bfloat16). A
// VB-byte store is assembled from VB / SB words of SB bytes; SB divides C's
// bytes, so each word lies in one half of one pixel and is one load, from
// the staged rows (kStaged) or straight from device memory.
template <typename E, int VB, int SB, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
concat_rows_kernel(const E* __restrict__ left, const E* __restrict__ right, E* __restrict__ out,
                   int H, int W, int C, int D, int mask_left, int tw, int dr, int tiles,
                   int word) {
  using V = typename Vec<VB>::type;
  using SW = typename Vec<SB>::type;
  constexpr int EPV = VB / (int)sizeof(E);   // elements a store
  constexpr int EPS = SB / (int)sizeof(E);   // elements a word
  constexpr int NS = VB / SB;                // words a store
  union Pack {
    V v;
    SW w[NS];
  };
  extern __shared__ __align__(16) unsigned char smem[];

  const int w0 = (blockIdx.x % tiles) * tw;
  const int h = blockIdx.x / tiles;
  const int dlo = blockIdx.y * dr, dhi = min(dlo + dr, D);
  const int b = blockIdx.z;
  const int nw = min(tw, W - w0);
  // right pixels w - d the run reaches: [x0, w0 + nw - dlo), at most nw + dr - 1
  const int x0 = max(w0 - (dhi - 1), 0);
  const int nr = max(w0 + nw - dlo - x0, 0);
  const size_t row = ((size_t)b * H + h) * W;
  const E* sl = left + (row + w0) * C;    // [nw][C]
  const E* sr = right + (row + x0) * C;   // [nr][C]
  if constexpr (kStaged) {
    E* dst_l = reinterpret_cast<E*>(smem);
    E* dst_r = dst_l + ((nw * C * (int)sizeof(E) + 15) / 16 * 16) / (int)sizeof(E);
    stage(dst_l, sl, nw * C * (int)sizeof(E), word);
    stage(dst_r, sr, nr * C * (int)sizeof(E), word);
    mma::cp_async_wait<0>();
    __syncthreads();
    sl = dst_l;
    sr = dst_r;
  }

  const int c2 = 2 * C;
  const int nvec = nw * c2 / EPV;
  const int step = blockDim.x * EPV;            // elements a round moves on
  const int sq = step / c2, sm = step - sq * c2;
  int pw = threadIdx.x * EPV / c2;              // the store's first pixel (from w0)
  int pk = threadIdx.x * EPV - pw * c2;         // and its channel of 2C
  const size_t dstride = (size_t)H * W * c2;
  E* o = out + ((((size_t)b * D + dlo) * H + h) * W + w0) * c2;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    // each word's pixel, and its left value or its right offset at d = 0
    int xw[NS], ro[NS];
    bool is_left[NS];
    SW lv[NS];
    int x = w0 + pw, k = pk;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      xw[j] = x;
      is_left[j] = k < C;
      lv[j] = is_left[j] ? *reinterpret_cast<const SW*>(sl + (x - w0) * C + k) : SW{};
      ro[j] = (x - x0) * C + k - C;
      k += EPS;
      if (k == c2) k = 0, ++x;
    }
    E* ov = o + (size_t)v * EPV;
    for (int d = dlo; d < dhi; ++d) {
      Pack p;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        p.w[j] = is_left[j] ? (mask_left && xw[j] < d ? SW{} : lv[j])
                            : (xw[j] >= d ? *reinterpret_cast<const SW*>(sr + ro[j] - d * C)
                                          : SW{});
      *reinterpret_cast<V*>(ov + (d - dlo) * dstride) = p.v;
    }
    pk += sm;
    pw += sq;
    if (pk >= c2) pk -= c2, ++pw;
  }
}

template <typename E, int VB, int SB, bool kStaged>
int launch_rows(const void* left, const void* right, void* out, int B, int H, int W, int C,
                int D, int mask_left, int tw, int dr, int threads, int word, cudaStream_t stream) {
  const int size = (int)sizeof(E);
  const int nr = min(W, tw + dr - 1);
  const size_t smem =
      kStaged ? (size_t)((tw * C * size + 15) / 16 * 16) + (size_t)nr * C * size : 0;
  cudaError_t err = cudaFuncSetAttribute(concat_rows_kernel<E, VB, SB, kStaged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (W + tw - 1) / tw;
  const dim3 grid(tiles * H, (D + dr - 1) / dr, B);
  concat_rows_kernel<E, VB, SB, kStaged><<<grid, threads, smem, stream>>>(
      static_cast<const E*>(left), static_cast<const E*>(right), static_cast<E*>(out), H, W, C,
      D, mask_left, tw, dr, tiles, word);
  return (int)cudaGetLastError();
}

// A run of one plane reads its words straight from device memory, where the
// feature bases allow SB-byte words; longer runs stage the rows they share.
template <typename E, int VB, int SB>
int launch(const void* left, const void* right, void* out, int B, int H, int W, int C, int D,
           int mask_left, int tw, int dr, int threads, cudaStream_t stream) {
  const int size = (int)sizeof(E);
  // the widest word that divides a staged pixel and both bases
  const uintptr_t a = reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right);
  const int word = (C * size) % 16 == 0 && a % 16 == 0  ? 16
                   : (C * size) % 4 == 0 && a % 4 == 0 ? 4
                                                        : 2;
  if ((W * 2 * C * size) % VB || (tw * 2 * C * size) % VB || (C * size) % SB ||
      reinterpret_cast<uintptr_t>(out) % VB || (word == 2 && (size != 2 || a % 2)))
    return (int)cudaErrorInvalidValue;
  if (dr == 1 && a % SB == 0)
    return launch_rows<E, VB, SB, false>(left, right, out, B, H, W, C, D, mask_left, tw, dr,
                                         threads, word, stream);
  return launch_rows<E, VB, SB, true>(left, right, out, B, H, W, C, D, mask_left, tw, dr,
                                      threads, word, stream);
}

template <typename E>
int by_vector(const void* left, const void* right, void* out, int B, int H, int W, int C,
              int D, int mask_left, int vb, int sb, int tw, int dr, int threads,
              cudaStream_t s) {
#define CONCAT_CASE(V, S)                                                                   \
  if (vb == V && sb == S)                                                                   \
    return launch<E, V, S>(left, right, out, B, H, W, C, D, mask_left, tw, dr, threads, s);
  CONCAT_CASE(16, 16)
  CONCAT_CASE(16, 8)
  CONCAT_CASE(16, 4)
  CONCAT_CASE(8, 8)
  CONCAT_CASE(8, 4)
  CONCAT_CASE(4, 4)
  if constexpr (sizeof(E) == 2) {
    CONCAT_CASE(16, 2)
    CONCAT_CASE(8, 2)
    CONCAT_CASE(4, 2)
  }
#undef CONCAT_CASE
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------------------ the backward
//
// Replaces the gradient that JAX takes through the XLA path of
// ops/volume.py::build_concat_volume (a broadcast, a mask, the shifted
// right stack and a concatenation); the Pallas K6 has no reverse-mode
// rule. Given the volume's gradient gd [B, D, H, W, 2C]:
//
//   dl[b, h, w, c] = sum_{d < D, d <= w or !mask_left} gd[b, d, h, w, c]
//   dr[b, h, u, c] = sum_{d < D, u + d < W}            gd[b, d, h, u + d, C + c]
//
// What bounds it: bytes. gd is 2 * D times the two outputs together, every
// one of its values feeds exactly one output, so the goal is to read gd
// once at the card's memory rate.
//
// Design ("direct", plan ops/volume.py::concat_backward_plan): a thread
// item is VEC channels of one output pixel, and it owns them: it reads the
// matching word of gd in each of its planes (down the d axis for dl, down
// the diagonal w = u + d for dr), sums in float32 registers and writes its
// word once. No shared memory, no atomics: the result is the same in every
// run. Items run with the channel word fastest, a row's dl items before its
// dr items, so a warp takes one branch and, at one d, reads whole pixels'
// halves of one gd plane (dr's reach one pixel further each d); each gd
// value is read by one item. The d loop is unrolled for loads in flight.

// The float32 value of E's bits (E: uint32_t for float32, uint16_t for
// bfloat16), and back, rounded to nearest even.
__device__ __forceinline__ float bits_to_f(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float bits_to_f(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ void f_to_bits(float v, uint32_t* p) { *p = __float_as_uint(v); }
__device__ __forceinline__ void f_to_bits(float v, uint16_t* p) {
  const __nv_bfloat16 r = __float2bfloat16(v);
  *p = *reinterpret_cast<const uint16_t*>(&r);
}

// acc[i] += the N values of E at p (aligned to their bytes), read as one
// word of N * sizeof(E) bytes (16, 8, 4 or 2).
template <typename E, int N>
__device__ __forceinline__ void add_word(const E* __restrict__ p, float (&acc)[N]) {
  using V = typename Vec<N * (int)sizeof(E)>::type;
  union {
    V v;
    E e[N];
  } u;
  u.v = __ldg(reinterpret_cast<const V*>(p));
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += bits_to_f(u.e[i]);
}

template <typename E, int N>
__device__ __forceinline__ void store_word(E* p, const float (&acc)[N]) {
  using V = typename Vec<N * (int)sizeof(E)>::type;
  union {
    V v;
    E e[N];
  } u;
#pragma unroll
  for (int i = 0; i < N; ++i) f_to_bits(acc[i], &u.e[i]);
  *reinterpret_cast<V*>(p) = u.v;
}

template <typename E, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
concat_backward_kernel(const E* __restrict__ gd, E* __restrict__ dl, E* __restrict__ dr, int H,
                       int W, int C, int D, int mask_left, long long items) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= items) return;
  const int half = W * (C / VEC);               // one output's items of a row
  const long long row = item / (2 * half);      // b * H + h
  int i = (int)(item - row * 2 * half);
  const bool is_dr = i >= half;
  if (is_dr) i -= half;
  const int w = i / (C / VEC);                  // the output pixel
  const int c = (i - w * (C / VEC)) * VEC;      // its first channel
  const long long b = row / H;
  const long long h = row - b * H;
  const size_t c2 = 2 * (size_t)C;
  const size_t plane = (size_t)H * W * c2;      // gd's d planes
  // gd[b, 0, h, w, c] (dl) or gd[b, 0, h, w, C + c] (dr: its d-th term sits
  // d planes and d pixels further)
  const E* g = gd + (((size_t)b * D * H + h) * W + w) * c2 + c + (is_dr ? C : 0);
  const size_t step = is_dr ? plane + c2 : plane;
  const int dend = is_dr ? min(D, W - w) : (mask_left ? min(D, w + 1) : D);
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int d = 0; d < dend; ++d) add_word<E, VEC>(g + d * step, acc);
  store_word<E, VEC>((is_dr ? dr : dl) + (size_t)(row * W + w) * C + c, acc);
}

template <typename E, int VEC>
int launch_backward(const void* gd, void* dl, void* dr, int B, int H, int W, int C, int D,
                    int mask_left, int threads, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(gd) | reinterpret_cast<uintptr_t>(dl) |
                      reinterpret_cast<uintptr_t>(dr);
  if (C % VEC || a % (VEC * sizeof(E))) return (int)cudaErrorInvalidValue;
  const long long items = 2LL * B * H * W * (C / VEC);
  const long long blocks = (items + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  concat_backward_kernel<E, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const E*>(gd), static_cast<E*>(dl), static_cast<E*>(dr), H, W, C, D,
      mask_left, items);
  return (int)cudaGetLastError();
}

template <typename E>
int backward_by_vec(const void* gd, void* dl, void* dr, int B, int H, int W, int C, int D,
                    int mask_left, int vec, int threads, cudaStream_t s) {
#define CONCAT_BWD_CASE(N)                                                                      \
  if (vec == N)                                                                                 \
    return launch_backward<E, N>(gd, dl, dr, B, H, W, C, D, mask_left, threads, s);
  CONCAT_BWD_CASE(1)
  CONCAT_BWD_CASE(2)
  CONCAT_BWD_CASE(4)
  if constexpr (sizeof(E) == 2) {
    CONCAT_BWD_CASE(8)
  }
#undef CONCAT_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; mask_left: 0 or 1. The plan (bytes a
// store vb, bytes a shared word sb, W tile tw, disparities a run dr, threads
// a block) comes from ops/volume.py::concat_plan. B * D * H * W must be
// positive.
int concat_volume(const void* left, const void* right, void* out, int B, int H, int W, int C,
                  int D, int mask_left, int dtype, int vb, int sb, int tw, int dr, int threads,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || tw < 1 || tw > W || dr < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return by_vector<uint32_t>(left, right, out, B, H, W, C, D, mask_left, vb, sb, tw, dr,
                               threads, s);
  if (dtype == 1)
    return by_vector<uint16_t>(left, right, out, B, H, W, C, D, mask_left, vb, sb, tw, dr,
                               threads, s);
  return (int)cudaErrorInvalidValue;
}

// dl, dr of concat_volume given its output's gradient gd ([B, D, H, W, 2C],
// in the features' type). dtype: 0 = float32, 1 = bfloat16; mask_left: 0
// or 1. The plan (channels a thread item vec: 1, 2, 4, or 8 in bfloat16,
// dividing C and the bases' alignment in elements; threads a block) comes
// from ops/volume.py::concat_backward_plan.
int concat_volume_backward(const void* gd, void* dl, void* dr, int B, int H, int W, int C,
                           int D, int mask_left, int dtype, int vec, int threads,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return backward_by_vec<uint32_t>(gd, dl, dr, B, H, W, C, D, mask_left, vec, threads, s);
  if (dtype == 1)
    return backward_by_vec<uint16_t>(gd, dl, dr, B, H, W, C, D, mask_left, vec, threads, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
