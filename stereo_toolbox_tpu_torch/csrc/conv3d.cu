// Plain 3x3x3 convolution (stride 1, zero padding 1, no bias) for Hopper,
// sm_90a (K3).
//
// Replaces stereo_toolbox_tpu/ops/pallas/conv3d.py::conv3d_pallas (kernel body
// `_kernel`).
//
//   out[b, d, h, w, o] = sum_{kd, kh, kw, c} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                            * wgt[kd, kh, kw, c, o]
//
// x [B, D, H, W, Ci], out [B, D, H, W, Co] (channels-last, contiguous, float32
// or bfloat16); wgt [3, 3, 3, Ci, Co] in the same type. Outside the volume x
// reads as zero. Accumulation in float32; the output is stored in x's type.
//
// What bounds it: bytes, at the shapes that run it. The cost-volume
// classifiers have Co = 1: 27 * Ci multiply-adds per output voxel against Ci
// input values read, so at (1, 48, 120, 160, 32 -> 1) the 121.6 MB moved (f32)
// take 0.036 ms at 3.35 TB/s and the 1.59 GFLOP 0.024 ms at 67 TFLOP/s.
//
// Design: a block owns a 16x32 (Co = 1) or 8x32 (Co > 1) H-W tile, CO_T
// output channels (1, or 8 for any Co > 1, so that Co = 1 issues no
// multiply-add for a padded channel) and a run of output planes d. It walks
// the input planes z of that run once each (one halo plane more on each side),
// staging each plane's (tile + halo) slab 8 input channels at a time in shared
// memory, as float32. The staging goes through registers, 16 bytes a load
// where Ci allows, and the next chunk's loads are issued before the current
// chunk is computed, so that their latency hides behind the multiply-adds.
// Plane z feeds output planes z+1, z and z-1 through kd = 0, 1, 2, so a
// thread keeps three rolling sets of accumulators in registers
// and stores plane z-1 once plane z has been added: every input value is
// read from device memory about once (the halo and the two extra planes of a
// run come from the L2 cache). A warp covers 32 columns, each thread R rows
// of one column: a float4 of 4 channels read from shared memory (rows padded
// to 12 floats, so a quarter warp's float4 reads hit all 32 banks once) feeds
// up to 3 kh x 3 kd accumulators, and each weight (a broadcast) feeds R rows.
// The run of planes is cut so that the grid has ~4 blocks for each SM; only
// the taps whose output plane lies in the run are computed.
//
// C interface (loaded with ctypes): conv3d(...) launches on the given stream,
// allocates nothing, synchronises nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileW = 32;         // one column per lane
constexpr int kCiChunk = 8;        // input channels staged per step
constexpr int kCs = 12;            // staged floats per pixel (8 used; no bank conflicts)
constexpr int kSw = kTileW + 2;    // staged columns (halo of 1 on each side)
constexpr long long kTargetBlocks = 4 * 132;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Adds one staged chunk of one input plane to the accumulators whose bit is
// set in MASK (bit kd: accumulator set kd, the output plane z + 1 - kd).
template <int CO_T, int R, int MASK>
__device__ __forceinline__ void accumulate(const float* in_s, const float* w_s, int ty, int tx,
                                           float (&acc)[3][R][CO_T]) {
#pragma unroll 1
  for (int c4 = 0; c4 < kCiChunk / 4; ++c4) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      float4 xv[R + 2];
#pragma unroll
      for (int y = 0; y < R + 2; ++y)
        xv[y] = *reinterpret_cast<const float4*>(in_s + ((ty * R + y) * kSw + tx + kw) * kCs +
                                                 4 * c4);
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if (!(MASK & (1 << kd))) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          if constexpr (CO_T == 1) {
            const float4 wv = *reinterpret_cast<const float4*>(w_s + tap * kCiChunk + 4 * c4);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 v = xv[r + kh];
              float a = acc[kd][r][0];
              a = fmaf(v.x, wv.x, a);
              a = fmaf(v.y, wv.y, a);
              a = fmaf(v.z, wv.z, a);
              a = fmaf(v.w, wv.w, a);
              acc[kd][r][0] = a;
            }
          } else {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float* wp = w_s + (tap * kCiChunk + 4 * c4 + cc) * CO_T;
              float wv[CO_T];
#pragma unroll
              for (int o = 0; o < CO_T; o += 4) {
                const float4 t = *reinterpret_cast<const float4*>(wp + o);
                wv[o] = t.x;
                wv[o + 1] = t.y;
                wv[o + 2] = t.z;
                wv[o + 3] = t.w;
              }
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float v = part(xv[r + kh], cc);
#pragma unroll
                for (int o = 0; o < CO_T; ++o) acc[kd][r][o] = fmaf(v, wv[o], acc[kd][r][o]);
              }
            }
          }
        }
      }
    }
  }
}

// The staging of one chunk (8 input channels of one input plane, the tile
// and its halo, and the chunk's weights) through registers: `load` issues
// the chunk's global loads, `store` converts to float32 and writes shared
// memory. VEC loads 16 bytes (4 float32 or 8 bfloat16 channels) at a time
// (Ci a multiple of 8, x 16-byte aligned); otherwise one element at a time.
template <typename T, int CO_T, int R, bool VEC>
struct Stager {
  static constexpr int kPix = (kWarps * R + 2) * kSw;
  static constexpr int kPer = VEC ? 16 / (int)sizeof(T) : 1;  // channels per load
  static constexpr int kLoads = kCiChunk / kPer;               // loads per pixel
  static constexpr int kK = (kPix * kLoads + kThreads - 1) / kThreads;
  static constexpr int kWts = 27 * kCiChunk * CO_T;
  static constexpr int kKW = (kWts + kThreads - 1) / kThreads;
  using Item = typename std::conditional<VEC, uint4, float>::type;

  Item xr[kK];
  float wr[kKW];

  __device__ __forceinline__ void load(const T* __restrict__ plane, const T* __restrict__ wgt,
                                       int h0, int w0, int H, int W, int Ci, int Co, int c0,
                                       int co0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int p = i / kLoads, c = c0 + (i % kLoads) * kPer;
      const int gy = h0 + p / kSw - 1, gx = w0 + p % kSw - 1;
      const bool in = i < kPix * kLoads && gy >= 0 && gy < H && gx >= 0 && gx < W && c < Ci;
      const T* src = plane + ((size_t)gy * W + gx) * Ci + c;
      if constexpr (VEC) {
        xr[k] = in ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
      } else {
        xr[k] = in ? to_f(__ldg(src)) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kKW; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int o = i % CO_T, c = c0 + (i / CO_T) % kCiChunk, tap = i / (CO_T * kCiChunk);
      wr[k] = (i < kWts && c < Ci && co0 + o < Co)
                  ? to_f(__ldg(wgt + ((size_t)tap * Ci + c) * Co + co0 + o))
                  : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* in_s, float* w_s) const {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= kPix * kLoads) continue;
      float* dst = in_s + (i / kLoads) * kCs + (i % kLoads) * kPer;
      if constexpr (!VEC) {
        *dst = xr[k];
      } else if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(dst) = xr[k];
      } else {  // 8 bfloat16: each 32-bit word holds two, the first in its low half
        const uint4 u = xr[k];
        *reinterpret_cast<float4*>(dst) =
            make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                        __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                        __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    }
#pragma unroll
    for (int k = 0; k < kKW; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kWts) w_s[i] = wr[k];
    }
  }
};

template <typename T, int CO_T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out, int D,
              int H, int W, int Ci, int Co, int tiles_w, int dch, int co_tiles) {
  constexpr int kTileH = kWarps * R;
  __shared__ __align__(16) float in_s[(kTileH + 2) * kSw * kCs];  // [y][x][c]
  __shared__ __align__(16) float w_s[27 * kCiChunk * CO_T];      // [tap][c][o]

  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int d0 = blockIdx.y * dch;
  const int d1 = min(d0 + dch, D);
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * CO_T;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;

  // acc[kd]: the output plane z + 1 - kd while input plane z is added
  float acc[3][R][CO_T];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int o = 0; o < CO_T; ++o) acc[s][r][o] = 0.f;

  // The chunks, in order: input planes zlo..zhi, 8 channels at a time. The
  // next chunk's loads are in flight while the current one is computed.
  const int zlo = max(d0 - 1, 0), zhi = min(d1, D - 1);
  const int nc = (Ci + kCiChunk - 1) / kCiChunk;
  const int nchunks = (zhi - zlo + 1) * nc;
  const T* xb = x + (size_t)b * D * H * W * Ci;
  Stager<T, CO_T, R, VEC> st;
  if (nchunks > 0) st.load(xb + (size_t)zlo * H * W * Ci, wgt, h0, w0, H, W, Ci, Co, 0, co0);

  int n = 0;
  for (int z = d0 - 1; z <= d1; ++z) {
    const int mask = (z + 1 < d1 ? 1 : 0) | (z >= d0 && z < d1 ? 2 : 0) | (z - 1 >= d0 ? 4 : 0);
    if (z >= 0 && z < D) {
      for (int c = 0; c < nc; ++c, ++n) {
        __syncthreads();  // the previous chunk is no longer read
        st.store(in_s, w_s);
        __syncthreads();
        if (n + 1 < nchunks) {
          const int zn = zlo + (n + 1) / nc;
          st.load(xb + (size_t)zn * H * W * Ci, wgt, h0, w0, H, W, Ci, Co,
                  ((n + 1) % nc) * kCiChunk, co0);
        }
        switch (mask) {
          case 1: accumulate<CO_T, R, 1>(in_s, w_s, ty, tx, acc); break;
          case 2: accumulate<CO_T, R, 2>(in_s, w_s, ty, tx, acc); break;
          case 3: accumulate<CO_T, R, 3>(in_s, w_s, ty, tx, acc); break;
          case 4: accumulate<CO_T, R, 4>(in_s, w_s, ty, tx, acc); break;
          case 6: accumulate<CO_T, R, 6>(in_s, w_s, ty, tx, acc); break;
          default: accumulate<CO_T, R, 7>(in_s, w_s, ty, tx, acc); break;
        }
      }
    }
    if (z - 1 >= d0) {  // output plane z - 1 is complete
      const int d = z - 1;
      const int xo = w0 + tx;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int y = h0 + ty * R + r;
        if (y >= H || xo >= W) continue;
        const size_t base = ((((size_t)b * D + d) * H + y) * W + xo) * Co;
#pragma unroll
        for (int o = 0; o < CO_T; ++o)
          if (co0 + o < Co) out[base + co0 + o] = from_f<T>(acc[2][r][o]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int o = 0; o < CO_T; ++o) {
        acc[2][r][o] = acc[1][r][o];
        acc[1][r][o] = acc[0][r][o];
        acc[0][r][o] = 0.f;
      }
  }
}

template <typename T, int CO_T, int R>
int launch(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci, int Co,
           cudaStream_t stream) {
  const bool vec = Ci % kCiChunk == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  constexpr int kTileH = kWarps * R;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int co_tiles = (Co + CO_T - 1) / CO_T;
  const long long plane_blocks = (long long)tiles_w * tiles_h * B * co_tiles;
  long long runs = (kTargetBlocks + plane_blocks - 1) / plane_blocks;
  if (runs > D) runs = D;
  const int dch = (int)((D + runs - 1) / runs);
  const dim3 grid(tiles_w * tiles_h, (D + dch - 1) / dch, B * co_tiles);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    conv3d_kernel<T, CO_T, R, true><<<grid, kThreads, 0, stream>>>(
        xt, wt, static_cast<T*>(out), D, H, W, Ci, Co, tiles_w, dch, co_tiles);
  else
    conv3d_kernel<T, CO_T, R, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, static_cast<T*>(out), D, H, W, Ci, Co, tiles_w, dch, co_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. B, D, H, W, Ci and Co must be positive.
int conv3d(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci, int Co,
           int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return Co == 1 ? launch<float, 1, 4>(x, w, out, B, D, H, W, Ci, Co, s)
                   : launch<float, 8, 2>(x, w, out, B, D, H, W, Ci, Co, s);
  if (dtype == 1)
    return Co == 1 ? launch<__nv_bfloat16, 1, 4>(x, w, out, B, D, H, W, Ci, Co, s)
                   : launch<__nv_bfloat16, 8, 2>(x, w, out, B, D, H, W, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
