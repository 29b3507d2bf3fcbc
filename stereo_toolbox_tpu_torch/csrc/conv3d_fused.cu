// Fused 3x3x3 convolution + eval-mode BatchNorm affine (+ residual) (+ ReLU)
// for Hopper, sm_90a.
//
// Replaces stereo_toolbox_tpu/ops/pallas/conv3d_fused.py::conv3d_fused
// (kernel body `_kernel`).
//
//   out = relu?(conv3d_3x3x3_same(x, w) * scale + bias + residual?)
//
// x [B, D, H, W, Ci], residual and out [B, D, H, W, Co] (channels-last,
// contiguous, float32 or bfloat16); w [Ci, 3, 3, 3, Co] in the same type;
// scale, bias [Co] float32. Stride 1, zero padding 1. Accumulation in float32.
//
// What bounds it: operations. 2*27*Ci*Co multiply-adds per voxel against
// (Ci + Co) values moved; at the cost-volume shapes of GwcNet (Ci, Co >= 32)
// that is hundreds of operations per byte, above the card's ridge point.
//
// Design (a direct convolution on the CUDA cores; tensor cores are later
// work): one block per (b, d, 4x32 H-W tile, 32 output channels); 128
// threads, one warp per group of 8 output channels, each lane 4 voxels of one
// row (x = tx + 8j) x 8 channels = 32 float32 accumulators in registers.
// Input channels are walked in chunks of 8: the block stages the chunk's
// 3 x 6 x 34 input halo (zero outside the volume, which replaces the padded
// copy of the TPU version) and the chunk's 27 x 8 x 32 weights in shared
// memory. For each (channel, kd, kh) a lane reads 12 inputs (conflict-free:
// row stride 40 floats) and 3x8 weights (one address per warp, broadcast) and
// does 96 multiply-adds. The epilogue applies scale, bias, residual and ReLU
// in float32 and stores once.
//
// C interface (loaded with ctypes): conv3d_fused(...) launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kCoBlock = 32;    // output channels per block
constexpr int kCoThread = 8;    // output channels per thread
constexpr int kCiChunk = 8;     // input channels staged per step
constexpr int kVox = 4;         // voxels per thread, x = tx + 8 * j
constexpr int kRow = 40;        // padded shared row (kTileW + 2 = 34 used)
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = 128;   // 4 warps = 4 groups of 8 output channels
constexpr int kInFloats = kCiChunk * 3 * kHaloH * kRow;
constexpr int kWFloats = kCiChunk * 27 * kCoBlock;
constexpr size_t kSmemBytes = (size_t)(kInFloats + kWFloats) * sizeof(float);

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3d_fused_kernel(const T* __restrict__ x, const T* __restrict__ wgt,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const T* __restrict__ res, T* __restrict__ out, int D, int H,
                    int W, int Ci, int Co, int relu, int tiles_w, int co_blocks) {
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;              // [kCiChunk][3][kHaloH][kRow]
  float* w_s = smem + kInFloats;   // [kCiChunk][27][kCoBlock]

  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int d = blockIdx.y;
  const int b = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kCoBlock;
  const int lane = threadIdx.x & 31;
  const int cg = threadIdx.x >> 5;
  const int tx = lane & 7;
  const int ty = lane >> 3;

  float acc[kVox][kCoThread];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int o = 0; o < kCoThread; ++o) acc[j][o] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += kCiChunk) {
    // input halo, channel fastest in the walk so global reads run along Ci
    for (int i = threadIdx.x; i < kCiChunk * 3 * kHaloH * kHaloW; i += kThreads) {
      const int c = i % kCiChunk;
      int p = i / kCiChunk;
      const int xx = p % kHaloW;
      p /= kHaloW;
      const int yy = p % kHaloH;
      const int zz = p / kHaloH;
      const int gz = d + zz - 1, gy = h0 + yy - 1, gx = w0 + xx - 1, gc = c0 + c;
      float v = 0.f;
      if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Ci)
        v = to_f(x[((((size_t)b * D + gz) * H + gy) * W + gx) * Ci + gc]);
      in_s[((c * 3 + zz) * kHaloH + yy) * kRow + xx] = v;
    }
    // weights [c][tap][o], output channel fastest
    for (int i = threadIdx.x; i < kWFloats; i += kThreads) {
      const int o = i % kCoBlock;
      const int p = i / kCoBlock;
      const int tap = p % 27;
      const int c = p / 27;
      const int gc = c0 + c, go = co0 + o;
      w_s[i] = (gc < Ci && go < Co) ? to_f(wgt[((size_t)gc * 27 + tap) * Co + go]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < kCiChunk; ++c) {
#pragma unroll
      for (int kz = 0; kz < 3; ++kz) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float* ip = in_s + ((c * 3 + kz) * kHaloH + ty + ky) * kRow + tx;
          float v[kVox][3];
#pragma unroll
          for (int j = 0; j < kVox; ++j)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) v[j][kx] = ip[8 * j + kx];
          const float* wp = w_s + (c * 27 + kz * 9 + ky * 3) * kCoBlock + cg * kCoThread;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float4 wa = *reinterpret_cast<const float4*>(wp + kx * kCoBlock);
            const float4 wb = *reinterpret_cast<const float4*>(wp + kx * kCoBlock + 4);
            const float wv[kCoThread] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kVox; ++j)
#pragma unroll
              for (int o = 0; o < kCoThread; ++o) acc[j][o] = fmaf(v[j][kx], wv[o], acc[j][o]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int y = h0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int j = 0; j < kVox; ++j) {
    const int xo = w0 + tx + 8 * j;
    if (xo >= W) continue;
    const size_t base = ((((size_t)b * D + d) * H + y) * W + xo) * Co;
#pragma unroll
    for (int o = 0; o < kCoThread; ++o) {
      const int co = co0 + cg * kCoThread + o;
      if (co >= Co) continue;
      float v = acc[j][o] * scale[co] + bias[co];
      if (res != nullptr) v += to_f(res[base + co]);
      if (relu) v = fmaxf(v, 0.f);
      out[base + co] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* scale, const float* bias,
           const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
           int relu, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3d_fused_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int co_blocks = (Co + kCoBlock - 1) / kCoBlock;
  const dim3 grid(tiles_h * tiles_w, D, B * co_blocks);
  conv3d_fused_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias,
      static_cast<const T*>(res), static_cast<T*>(out), D, H, W, Ci, Co, relu, tiles_w,
      co_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. res may be null.
int conv3d_fused(const void* x, const void* w, const void* scale, const void* bias,
                 const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
                 int relu, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) return launch<float>(x, w, sc, bi, res, out, B, D, H, W, Ci, Co, relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, sc, bi, res, out, B, D, H, W, Ci, Co, relu, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
