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
// q, k, v, out: contiguous [B * heads, N, 64]. The softmax and the sums are
// float32; out is stored in the input type.
//
// What bounds it: operations. A head does 4 * N^2 * 64 FLOP on 4 * N * 64
// elements, ~340 FLOP per element at DepthAnythingV2's N = 1370, far above
// what the card's memory rate would limit.
//
// Two designs, one per type. Neither falls back to the other. Both use
// FlashAttention's online softmax in log2 units and handle ragged N by
// bounds, not padding: rows past N stage as zeros, keys past N get a score of
// -inf (so they enter neither the max nor the sum), and rows past N are not
// stored. Every key tile holds at least one real key, so the running max is
// finite from the first tile on.
//
// bfloat16: FlashAttention-2 on the tensor cores (vit_attention_mma). One
// block of 4 warps per (b * head, 64 queries), 16 query rows a warp. The
// block stages its query tile once and each warp keeps its Q fragments in
// registers (ldmatrix). Keys and values are walked in tiles of 64 (8 KB
// each), double-buffered by cp.async. Per tile: S = Q K^T by mma.sync
// m16n8k16 (bf16 in, float32 sums); the online softmax in registers, the row
// max and sum across the 4 lanes of a row by shuffles; P rounded to bf16 in
// registers, where the accumulator layout of S is the A operand layout of
// P V, so P never goes through shared memory; O += P V with V read by
// ldmatrix.trans. 128-byte rows are stored as 8 chunks of 16 bytes, chunk
// XORed with the row's low 3 bits, so ldmatrix is free of bank conflicts.
// The output is divided by the row sum once and stored as bf16.
//
// float32: on the CUDA cores (vit_attention_simt). The float32 result has to
// hold 1e-5 of the plain version, which TF32 tensor cores would not, so this
// is the float32 design and not a fallback. One block of 256 threads per
// (b * head, 64-query tile). The block stages its query tile once, then walks
// the keys in tiles of 64, staging K and V in shared memory. The threads form
// a 16 x 16 grid: thread (ty, tx) owns the scores of query rows ty + 16 i and
// keys tx + 16 j (i, j < 4), and the output of rows ty + 16 i, dims 4 tx ..
// 4 tx + 3, so each inner step reads eight 16-byte vectors of shared memory
// for 64 FMAs. Per key tile: S = Q K^T scaled into log2 units; the row max
// over the 16 threads of a row by warp shuffles; P = exp2(S - max) through
// shared memory; O = O * exp2(old max - new max) + P V. Each thread keeps its
// part of the row sums and the parts are added once at the end.
//
// C interface (loaded with ctypes): vit_attention_mma(...) and
// vit_attention_simt(...) launch on the given stream, allocate nothing,
// synchronise nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // queries per block, keys per step
constexpr float kLog2e = 1.4426950408889634f;

// ----------------------------------------------------------------- float32

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kLd = kD + 4;    // staged row in floats: 16-byte rows, rows 4 banks apart
constexpr int kSmemBytes = 4 * kTile * kLd * (int)sizeof(float);  // Q, K, V, P

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [row0, row0 + kTile) of one head's [N, kD] matrix into s, as
// [kTile][kLd], zero past N.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ src, int row0,
                                      int N) {
  for (int i = threadIdx.x; i < kTile * kD / 4; i += kThreads) {
    const int r = i / (kD / 4);
    const int c = (i % (kD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) v = load4(src + (size_t)(row0 + r) * kD + c);
    store4(s + r * kLd + c, v);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
vit_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int N,
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

// ---------------------------------------------------------------- bfloat16

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;             // 4 warps x 16 query rows
constexpr int kTileBytes = kTile * kD * 2;   // 8 KB: 64 rows of 128 bytes
constexpr int kMmaSmem = 5 * kTileBytes;     // Q, K[2], V[2]

// byte offset of 16-byte chunk c (0..7) of 128-byte row r, swizzled
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Rows [row0, row0 + 64) of one head's [N, 64] matrix into the tile at dst,
// zero-filled past N.
__device__ __forceinline__ void stage_async(uint32_t dst, const bf16* __restrict__ src, int row0,
                                            int N) {
  for (int i = threadIdx.x; i < kTile * 8; i += kMmaThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = row0 + r < N;
    mma::cp_async16(dst + swz(r, c), ok ? src + (size_t)(row0 + r) * kD + c * 8 : src, ok);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
vit_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int N,
                         float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  const uint32_t sq = mma::smem_addr(smem_bytes);
  const uint32_t sk = sq + kTileBytes;       // K[2]
  const uint32_t sv = sq + 3 * kTileBytes;   // V[2]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_async(sq, q + head, q0, N);
  stage_async(sk, k + head, 0, N);
  stage_async(sv, v + head, 0, N);
  mma::cp_async_commit();

  uint32_t qf[4][4];   // Q fragments, 16 rows x 64 dims (4 k-steps)
  float o[8][4];       // O, 16 rows x 64 dims (8 n8 tiles), unnormalised
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8 (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of their running sums
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_async(sk + (buf ^ 1) * kTileBytes, k + head, (it + 1) * kTile, N);
      stage_async(sv + (buf ^ 1) * kTileBytes, v + head, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();   // tile it (and Q) landed
    __syncthreads();

    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma::ldmatrix_x4(qf[kk], sq + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }

    // S = Q K^T: 16 rows x 64 keys (8 n8 tiles)
    const uint32_t kt = sk + buf * kTileBytes;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        mma::ldmatrix_x4(b, kt + swz(key, 2 * kk + ((lane >> 3) & 1)));
        mma::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax; lane holds keys 8j + 2tq + {0, 1} of rows g (e < 2)
    // and g + 8 (e >= 2)
    const int k0 = it * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[j][e] * scale_log2;
        if (k0 + 8 * j + 2 * tq + (e & 1) >= N) t = -INFINITY;
        s[j][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);   // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);   // 0 for keys past N
        s[j][e] = p;
        l[e >> 1] += p;
        o[j][e] *= alpha[e >> 1];
      }

    // O += P V: P from the S accumulators (k-step kk = keys 16kk .. 16kk + 15)
    const uint32_t vt = sv + buf * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        mma::ldmatrix_x4_trans(b, vt + swz(key, 2 * dp + (lane >> 4)));
        mma::mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma::mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // the next iteration's copies overwrite this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + head + (size_t)row * kD + 2 * tq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[4 * j] = mma::pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// bfloat16, tensor cores. q, k, v, out: [BH, N, 64], 16-byte aligned.
int vit_attention_mma(const void* q, const void* k, const void* v, void* out, int BH, int N,
                      float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_attention_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_mma_kernel<<<grid, kMmaThreads, kMmaSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), N, scale * kLog2e);
  return (int)cudaGetLastError();
}

// float32, CUDA cores. q, k, v, out: [BH, N, 64].
int vit_attention_simt(const void* q, const void* k, const void* v, void* out, int BH, int N,
                       float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, scale * kLog2e);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
