// Right features gathered at per-pixel disparity samples (K4), and the
// group-wise correlation at those samples (K5), for Hopper, sm_90a.
//
// Replaces stereo_toolbox_tpu/ops/pallas/sample_gather.py::
// gather_right_by_samples_pallas (kernel body `_gather_kernel`) and
// gwc_volume_from_samples_pallas (kernel body `_gwc_kernel`).
//
//   d = (int) clamp(samples[b, s, h, w], 0, max_shift)
//   K4: out[b, s, h, w, c] = right[b, h, w - d, c]
//   K5: out[b, s, h, w, g] = mean_{c in group g} left[b, h, w, c] * right[b, h, w - d, c]
//   both 0 where w < d
//
// Layouts are channels-last: left/right [B, H, W, C], samples [B, S, H, W]
// float32 (integer-valued in CFNet), out [B, S, H, W, C] (K4) or
// [B, S, H, W, G] (K5), float32 or bfloat16, K5 accumulating in float32.
//
// What bounds it: bytes. K4 copies; K5 does C/G multiply-adds per output (4
// at both of CFNet's stages) against 4 or 2 bytes stored, far below the
// card's ridge point. So the point is to store each output once, in long
// contiguous runs, and to read each input row from device memory once; K5
// never writes the gathered [B, S, H, W, C] tensor at all.
//
// Design: the TPU kernel turns the gather into a one-hot [S*Wt, 2Wt] matmul
// on the MXU over a 128-lane-padded W, a TPU workaround for gathers. On
// Hopper the gather is a load from shared memory. One block per (b, h, W-tile
// of kTileW pixels, channel chunk) stages the right window
// [kTileW + max_shift, Cc] (pixels w0 - max_shift .. w0 + kTileW - 1, zero
// off the image, as K1 does) and the tile's [S, kTileW] samples, clamped and
// truncated to int; K5 also stages the left tile [kTileW, Cc]. Threads walk
// the (s, w, c) outputs (K5: (s, w, g)) with the channel fastest, so for each
// sample the block's stores are one contiguous run. Where the window would
// pass the 227 KB a block may have, the channels are split into chunks (whole
// groups for K5, since groups are independent) over grid.z.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;                  // pixels of W per block
constexpr size_t kSmemLimit = 232448;       // 227 KB, a block's most on sm_90

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

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of a block's shared arrays for a chunk of cc channels: right
// window [kTileW + max_shift][cc], left tile [kTileW][cc] (K5 only), samples
// [S][kTileW] int.
struct Layout {
  size_t left, samples, total;
};
__host__ __device__ inline Layout layout(int cc, int max_shift, int S, size_t elem,
                                         bool with_left) {
  Layout l;
  l.left = align16((size_t)(kTileW + max_shift) * cc * elem);
  l.samples = l.left + (with_left ? align16((size_t)kTileW * cc * elem) : 0);
  l.total = l.samples + (size_t)S * kTileW * sizeof(int);
  return l;
}

// dst[p][c] = src[b, h, x0 + p, c0 + c] for p < n_px, c < cc; 0 off the image.
// `row` is the pixel index of (b, h, 0).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, T* dst, size_t row,
                                           long long x0, int n_px, int W, int C, int c0,
                                           int cc) {
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < n_px * cc; i += kThreads) {
    const int p = i / cc;
    const long long x = x0 + p;
    dst[i] = (x >= 0 && x < W) ? src[((long long)row + x) * C + c0 + (i - p * cc)] : zero;
  }
}

// dst[s][w] = (int) clamp(samples[b, s, h, w0 + w], 0, max_shift); 0 past W.
__device__ __forceinline__ void stage_samples(const float* __restrict__ samples, int* dst,
                                              int b, int h, int w0, int H, int W, int S,
                                              int max_shift) {
  for (int i = threadIdx.x; i < S * kTileW; i += kThreads) {
    const int s = i / kTileW;
    const int w = w0 + i - s * kTileW;
    int d = 0;
    if (w < W) {
      const float v = samples[(((size_t)b * S + s) * H + h) * W + w];
      d = (int)fminf(fmaxf(v, 0.f), (float)max_shift);  // NaN -> 0
    }
    dst[i] = d;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ right, const float* __restrict__ samples,
              T* __restrict__ out, int H, int W, int C, int S, int max_shift, int cc,
              int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w0 = blockIdx.x * kTileW;
  const int h = blockIdx.y;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z % chunks) * cc;
  const int n = min(cc, C - c0);  // channels of this chunk
  const Layout l = layout(cc, max_shift, S, sizeof(T), false);
  T* sr = reinterpret_cast<T*>(smem);                  // [kTileW + max_shift][n]
  int* sd = reinterpret_cast<int*>(smem + l.samples);  // [S][kTileW]

  const size_t row = ((size_t)b * H + h) * W;
  stage_rows(right, sr, row, (long long)w0 - max_shift, kTileW + max_shift, W, C, c0, n);
  stage_samples(samples, sd, b, h, w0, H, W, S, max_shift);
  __syncthreads();

  const int per_s = kTileW * n;
  for (int i = threadIdx.x; i < S * per_s; i += kThreads) {
    const int s = i / per_s;
    const int r = i - s * per_s;
    const int w = r / n;
    const int c = r - w * n;
    if (w0 + w >= W) continue;
    // window row of pixel w0 + w - d: (w - d) + max_shift
    const int j = w + max_shift - sd[s * kTileW + w];
    out[((((size_t)b * S + s) * H + h) * W + w0 + w) * C + c0 + c] = sr[j * n + c];
  }
}

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
gwc_kernel(const T* __restrict__ left, const T* __restrict__ right,
           const float* __restrict__ samples, T* __restrict__ out, int H, int W, int C,
           int S, int G, int max_shift, int gc, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpg = C / G;
  const int w0 = blockIdx.x * kTileW;
  const int h = blockIdx.y;
  const int b = blockIdx.z / chunks;
  const int g0 = (blockIdx.z % chunks) * gc;
  const int ng = min(gc, G - g0);  // groups of this chunk
  const int n = ng * cpg;          // channels of this chunk
  const Layout l = layout(gc * cpg, max_shift, S, sizeof(T), true);
  T* sr = reinterpret_cast<T*>(smem);                  // [kTileW + max_shift][n]
  T* sl = reinterpret_cast<T*>(smem + l.left);         // [kTileW][n]
  int* sd = reinterpret_cast<int*>(smem + l.samples);  // [S][kTileW]

  const size_t row = ((size_t)b * H + h) * W;
  stage_rows(right, sr, row, (long long)w0 - max_shift, kTileW + max_shift, W, C,
             g0 * cpg, n);
  stage_rows(left, sl, row, (long long)w0, kTileW, W, C, g0 * cpg, n);
  stage_samples(samples, sd, b, h, w0, H, W, S, max_shift);
  __syncthreads();

  const float inv_cpg = 1.f / (float)cpg;
  const int per_s = kTileW * ng;
  for (int i = threadIdx.x; i < S * per_s; i += kThreads) {
    const int s = i / per_s;
    const int r = i - s * per_s;
    const int w = r / ng;
    const int g = r - w * ng;
    if (w0 + w >= W) continue;
    const int j = w + max_shift - sd[s * kTileW + w];
    const T* a = sl + w * n + g * cpg;
    const T* c = sr + j * n + g * cpg;
    float acc = 0.f;
    if constexpr (kVec4) {
      for (int k = 0; k < cpg; k += 4) acc += dot4(a + k, c + k);
    } else {
      for (int k = 0; k < cpg; ++k) acc += to_f(a[k]) * to_f(c[k]);
    }
    out[((((size_t)b * S + s) * H + h) * W + w0 + w) * G + g0 + g] =
        from_f<T>(acc * inv_cpg);
  }
}

// The most units (channels for K4, groups for K5) of `unit` channels that one
// block can stage, spread evenly over the fewest chunks; 0 if one unit does
// not fit.
inline int chunk_units(int units, int unit, int max_shift, int S, size_t elem,
                       bool with_left, int* chunks) {
  int fit = units;
  while (fit > 0 && layout(fit * unit, max_shift, S, elem, with_left).total > kSmemLimit)
    --fit;
  if (fit == 0) return 0;
  *chunks = (units + fit - 1) / fit;
  const int per = (units + *chunks - 1) / *chunks;
  *chunks = (units + per - 1) / per;  // every chunk holds at least one unit
  return per;
}

template <typename T>
int launch_gather(const void* right, const void* samples, void* out, int B, int H, int W,
                  int C, int S, int max_shift, cudaStream_t stream) {
  int chunks = 1;
  const int cc = chunk_units(C, 1, max_shift, S, sizeof(T), false, &chunks);
  if (cc == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(cc, max_shift, S, sizeof(T), false).total;
  cudaError_t err = cudaFuncSetAttribute(
      gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B * chunks);
  gather_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(right), static_cast<const float*>(samples),
      static_cast<T*>(out), H, W, C, S, max_shift, cc, chunks);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec4>
int launch_gwc(const void* left, const void* right, const void* samples, void* out, int B,
               int H, int W, int C, int S, int G, int max_shift, cudaStream_t stream) {
  int chunks = 1;
  const int gc = chunk_units(G, C / G, max_shift, S, sizeof(T), true, &chunks);
  if (gc == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(gc * (C / G), max_shift, S, sizeof(T), true).total;
  cudaError_t err = cudaFuncSetAttribute(
      gwc_kernel<T, kVec4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, H, B * chunks);
  gwc_kernel<T, kVec4><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(samples), static_cast<T*>(out), H, W, C, S, G, max_shift,
      gc, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (right and out); samples are float32.
int gather_right_by_samples(const void* right, const void* samples, void* out, int B,
                            int H, int W, int C, int S, int max_shift, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gather<float>(right, samples, out, B, H, W, C, S, max_shift, s);
  if (dtype == 1)
    return launch_gather<__nv_bfloat16>(right, samples, out, B, H, W, C, S, max_shift, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (left, right and out); samples are float32.
int gwc_volume_from_samples(const void* left, const void* right, const void* samples,
                            void* out, int B, int H, int W, int C, int S, int G,
                            int max_shift, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (C / G) % 4 == 0;
  if (dtype == 0)
    return vec4 ? launch_gwc<float, true>(left, right, samples, out, B, H, W, C, S, G,
                                          max_shift, s)
                : launch_gwc<float, false>(left, right, samples, out, B, H, W, C, S, G,
                                           max_shift, s);
  if (dtype == 1)
    return vec4 ? launch_gwc<__nv_bfloat16, true>(left, right, samples, out, B, H, W, C,
                                                  S, G, max_shift, s)
                : launch_gwc<__nv_bfloat16, false>(left, right, samples, out, B, H, W, C,
                                                   S, G, max_shift, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
