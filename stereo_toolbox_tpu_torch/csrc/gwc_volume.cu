// Group-wise correlation cost volume (GwcNet) for Hopper, sm_90a.
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
// GwcNet's C=320, G=40), and the output is D*G/(2*C) = 3x larger than the two
// inputs together at GwcNet's D=48, so the card's memory rate is the limit.
//
// Design: one block per (b, h, W-tile of kTileW pixels). The block stages the
// left tile [kTileW, C] and the right window [kTileW + D - 1, C] (the pixels
// w - d can reach) in dynamic shared memory, zero-filled off the image, so
// each input row is read from device memory once and every shifted read
// resolves in shared memory. Threads then walk the (d, w, g) outputs with g
// fastest: for a fixed d the block's (w, g) outputs are one contiguous run of
// kTileW * G elements, so consecutive threads store consecutive addresses.
// Group dot products read 4 channels at a time when C/G allows it.
//
// C interface (loaded with ctypes): gwc_volume(...) launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 16;  // pixels of W per block

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

// Dot product of 4 consecutive elements (16-byte / 8-byte aligned).
__device__ __forceinline__ float dot4(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}
__device__ __forceinline__ float dot4(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint2 x = *reinterpret_cast<const uint2*>(a);
  const uint2 y = *reinterpret_cast<const uint2*>(b);
  const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  const float2 y0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.x));
  const float2 y1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y.y));
  return x0.x * y0.x + x0.y * y0.y + x1.x * y1.x + x1.y * y1.y;
}

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right,
                  T* __restrict__ out, int H, int W, int C, int D, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sl = reinterpret_cast<T*>(smem_raw);  // [kTileW][C]
  T* sr = sl + (size_t)kTileW * C;         // [kTileW + D - 1][C]

  const int w0 = blockIdx.x * kTileW;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = ((size_t)b * H + h) * W;  // pixel index of (b, h, 0)
  const T zero = from_f<T>(0.f);

  for (int i = threadIdx.x; i < kTileW * C; i += kThreads) {
    const int w = w0 + i / C;
    sl[i] = w < W ? left[(row + w0) * C + i] : zero;
  }
  // right window: pixel x = w0 - (D - 1) + i / C
  const int win = kTileW + D - 1;
  const long long r0 = (long long)w0 - (D - 1);
  for (int i = threadIdx.x; i < win * C; i += kThreads) {
    const long long x = r0 + i / C;
    sr[i] = (x >= 0 && x < W) ? right[(long long)(row * C) + r0 * C + i] : zero;
  }
  __syncthreads();

  const int cpg = C / G;
  const float inv_cpg = 1.f / (float)cpg;
  const int per_d = kTileW * G;
  for (int i = threadIdx.x; i < D * per_d; i += kThreads) {
    const int d = i / per_d;
    const int r = i - d * per_d;
    const int w = r / G;
    const int g = r - w * G;
    const int wg = w0 + w;
    if (wg >= W) continue;
    float acc = 0.f;
    if (wg >= d) {
      const T* a = sl + (size_t)w * C + g * cpg;
      const T* c = sr + (size_t)(w - d + D - 1) * C + g * cpg;
      if constexpr (kVec4) {
        for (int k = 0; k < cpg; k += 4) acc += dot4(a + k, c + k);
      } else {
        for (int k = 0; k < cpg; ++k) acc += to_f(a[k]) * to_f(c[k]);
      }
    }
    out[((((size_t)b * D + d) * H + h) * W + wg) * G + g] = from_f<T>(acc * inv_cpg);
  }
}

template <typename T, bool kVec4>
int launch(const void* left, const void* right, void* out, int B, int H, int W,
           int C, int D, int G, cudaStream_t stream) {
  // more than the card's 227 KB (large C * D) is refused here, and reported
  const size_t smem = (size_t)(2 * kTileW + D - 1) * C * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(gwc_volume_kernel<T, kVec4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B);
  gwc_volume_kernel<T, kVec4><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<T*>(out),
      H, W, C, D, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int gwc_volume(const void* left, const void* right, void* out, int B, int H, int W,
               int C, int D, int G, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (C / G) % 4 == 0;
  if (dtype == 0)
    return vec4 ? launch<float, true>(left, right, out, B, H, W, C, D, G, s)
                : launch<float, false>(left, right, out, B, H, W, C, D, G, s);
  if (dtype == 1)
    return vec4 ? launch<__nv_bfloat16, true>(left, right, out, B, H, W, C, D, G, s)
                : launch<__nv_bfloat16, false>(left, right, out, B, H, W, C, D, G, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
