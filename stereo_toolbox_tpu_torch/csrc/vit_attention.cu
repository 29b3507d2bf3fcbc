// Non-causal softmax attention of the ViT blocks (DINOv2 in DepthAnythingV2)
// for Hopper, sm_90a.
//
// Replaces the library Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention, which
// stereo_toolbox_tpu/models/depth_anything_v2.py::_vit_attention_fn calls
// (N padded to a multiple of 1024 and masked by segment ids there).
//
//   out[bh, i, :] = sum_j softmax_j(scale * q[bh, i, :] . k[bh, j, :]) * v[bh, j, :]
//
// q, k, v, out: contiguous [B * heads, N, 64], float32 or bfloat16. The
// products, the softmax and the sums are float32; out is stored in the input
// type.
//
// What bounds it: operations. A head does 4 * N^2 * 64 FLOP on 4 * N * 64
// elements, ~340 FLOP per element at DepthAnythingV2's N = 1370, far above
// what the card's memory rate would limit. The products run as float32 FMAs
// on the CUDA cores for both types (the float32 result has to hold 1e-5 of
// the plain version, which TF32 tensor cores would not); tensor cores
// (mma / wgmma in bf16) are later work.
//
// Design: FlashAttention's online softmax, on the CUDA cores. One block of
// 256 threads per (b * head, 64-query tile). The block stages its query tile
// once, then walks the keys in tiles of 64, staging K and V in shared memory
// as float32 (bf16 is widened on the way in). The threads form a 16 x 16
// grid: thread (ty, tx) owns the scores of query rows ty + 16 i and keys
// tx + 16 j (i, j < 4), and the output of rows ty + 16 i, dims 4 tx .. 4 tx + 3,
// so each inner step reads eight 16-byte vectors of shared memory for 64
// FMAs. Per key tile: S = Q K^T scaled into log2 units; the row max over the
// 16 threads of a row by warp shuffles; P = exp2(S - max) through shared
// memory; O = O * exp2(old max - new max) + P V. Each thread keeps its part
// of the row sums and the parts are added once at the end.
//
// Ragged N is handled by bounds, not padding: rows past N stage as zeros,
// keys past N get a score of -inf (so they enter neither the max nor the
// sum), and rows past N are not stored. Every key tile holds at least one
// real key, so the running max is finite from the first tile on.
//
// C interface (loaded with ctypes): vit_attention(...) launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // queries per block, keys per step
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kLd = kD + 4;    // staged row in floats: 16-byte rows, rows 4 banks apart
constexpr int kSmemBytes = 4 * kTile * kLd * (int)sizeof(float);  // Q, K, V, P

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [row0, row0 + kTile) of one head's [N, kD] matrix into s, as float32
// [kTile][kLd], zero past N.
template <typename T>
__device__ __forceinline__ void stage(float* s, const T* __restrict__ src, int row0, int N) {
  for (int i = threadIdx.x; i < kTile * kD / 4; i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) v = load4(src + (size_t)(row0 + r) * kD + c);
    store4(s + r * kLd + c, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
vit_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int N,
                     float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;               // [kTile][kLd] queries
  float* sk = sq + kTile * kLd;   // keys of the current tile
  float* sv = sk + kTile * kLd;   // values of the current tile
  float* sp = sv + kTile * kLd;   // P [query][key] of the current tile

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  stage(sq, q + head, q0, N);

  float o[4][4];   // output of rows ty + 16 i, dims 4 tx + c (unnormalised)
  float m[4];      // running row max, log2 units
  float l[4];      // this thread's part of the running row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    stage(sk, k + head, k0, N);
    stage(sv, v + head, k0, N);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(sq + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = load4(sk + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax: new row max, rescale, P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < N) ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes that differ in their low 4 bits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);  // 0 for keys past N
        l[i] += p;
        sp[(ty + 16 * i) * kLd + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, dims 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = load4(sp + (ty + 16 * i) * kLd + kk);
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = load4(sv + (kk + r) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[i][0] = fmaf(pr[r], w[r].x, o[i][0]);
          o[i][1] = fmaf(pr[r], w[r].y, o[i][1]);
          o[i][2] = fmaf(pr[r], w[r].z, o[i][2]);
          o[i][3] = fmaf(pr[r], w[r].w, o[i][3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites K, V and P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ty + 16 * i;
    if (row < N) {
      const float inv = 1.f / sum;
      store4(out + head + (size_t)row * kD + 4 * tx,
             make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int N,
           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vit_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), N, scale * 1.4426950408889634f);  // scale * log2(e)
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [BH, N, 64]; dtype: 0 = float32, 1 = bfloat16.
int vit_attention(const void* q, const void* k, const void* v, void* out, int BH,
                  int N, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(q, k, v, out, BH, N, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, BH, N, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
