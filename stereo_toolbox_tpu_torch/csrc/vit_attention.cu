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
// Two designs, one per type, both on the tensor cores. Neither falls back
// to the other or to anything. Both use
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
// float32: FlashAttention-2 on the tensor cores through 3xTF32
// (vit_attention_tf32x3). Each operand is split into a tf32 high part and a
// tf32 remainder (round to nearest) and S = Q K^T and O += P V each sum
// lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 in float32: a product error of
// about 2^-22 of |a*b|, which holds the 1e-5 gate of the float32 plain
// version with TF32 off (one tf32 product misses it by ~60x). One block of 4
// warps per (b * head, 64 queries), 16 query rows a warp, whose Q fragments
// stay in registers (split once a key tile). Keys and values are walked in
// tiles of 64: cp.async copies the raw tile into shared memory (overlapping
// the previous tile's products), then the block splits it once into high
// and remainder planes of K and V (72-float rows, so the fragment loads of
// a warp hit distinct banks); no warp splits K or V itself. The sums over
// the head dim and over a tile's keys may run in any order: S's k step
// pairs k = t with dim 2t and k = t + 4 with dim 2t + 1 of its 8 (Q and K
// fragments are 8-byte loads), and S's n8 tile pairs its columns 2t, 2t + 1
// with keys t, t + 4 (K's rows stored permuted to match), which makes the
// accumulator layout of S the A layout of P V with V's rows in order: P
// stays in registers, split after the online softmax, with no exchange
// across lanes and no transposed copy of V. mma.sync truncates the float32
// sums it writes, so each key tile's P V goes into a fresh register tile
// that is added to O once, rounded to nearest (three truncations a key step
// into O drift past 1e-5 of max|ref| over 1370 keys). The online softmax in
// float32 as in the bfloat16 kernel; the output is divided by the row sum
// once and stored as float32. What bounds it on this card: the tf32
// products (3 x 4 N^2 64 FLOP a head at 495 TF/s), then the fragment loads
// from shared memory (16 query rows a warp read the high and remainder
// planes of every K and V tile).
//
// C interface (loaded with ctypes): vit_attention_mma(...) and
// vit_attention_tf32x3(...) launch on the given stream, allocate nothing,
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

constexpr int kTfThreads = 128;            // 4 warps x 16 query rows
constexpr int kRawLd = kD + 4;             // raw staged row, floats (rows 16 bytes apart in banks)
constexpr int kLd = kD + 8;                // split planes' rows, floats
constexpr int kRawFloats = kTile * kRawLd;
constexpr int kPlaneFloats = kTile * kLd;
// raw K, raw V; K high, K remainder, V high, V remainder
constexpr int kTfSmem = (2 * kRawFloats + 4 * kPlaneFloats) * (int)sizeof(float);

// Rows [row0, row0 + 64) of one head's [N, 64] float32 matrix into
// [64][kRawLd] at dst, zero-filled past N.
__device__ __forceinline__ void stage_raw(uint32_t dst, const float* __restrict__ src, int row0,
                                          int N) {
  for (int i = threadIdx.x; i < kTile * 16; i += kTfThreads) {
    const int r = i >> 4, c = i & 15;
    const bool ok = row0 + r < N;
    const float* from = ok ? src + (size_t)(row0 + r) * kD + c * 4 : src;
    mma::cp_async16(dst + (r * kRawLd + c * 4) * 4, from, ok);
  }
}

// x split into tf32 high parts and remainders by cvt.rna (mma::to_tf32),
// the same values as mma::split_tf32, whose two-instruction form ran this
// kernel slower on the H100 (K2 takes it)
__device__ __forceinline__ void split_cvt(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = mma::to_tf32(__uint_as_float(x[i]));
    lo[i] = mma::to_tf32(__uint_as_float(x[i]) - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void split4(const float4 x, float4& hi, float4& lo) {
  const uint32_t in[4] = {__float_as_uint(x.x), __float_as_uint(x.y), __float_as_uint(x.z),
                          __float_as_uint(x.w)};
  uint32_t h[4], l[4];
  split_cvt(in, h, l);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// The n8 tile of S = Q K^T pairs its column c with key sigma(c) =
// (c >> 1) + 4 (c & 1) of the tile's 8, so that a lane's two accumulator
// columns 2t, 2t + 1 hold keys t and t + 4: the A fragment of P V with V's
// rows in their own order. K's rows are stored permuted to match, key r of
// each 8 at row sigma^-1(r) = 2 (r & 3) + (r >> 2).
__device__ __forceinline__ int k_row(int r) { return (r & ~7) + 2 * (r & 3) + ((r >> 2) & 1); }

__global__ void __launch_bounds__(kTfThreads, 2)
vit_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int N,
                            float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* raw_k = smem;                      // [64][kRawLd]
  float* raw_v = raw_k + kRawFloats;
  float* kh = raw_v + kRawFloats;           // [64][kLd], rows permuted (k_row)
  float* kl = kh + kPlaneFloats;
  float* vh = kl + kPlaneFloats;            // [64][kLd]
  float* vl = vh + kPlaneFloats;
  const uint32_t raw_k_s = mma::smem_addr(raw_k), raw_v_s = mma::smem_addr(raw_v);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_raw(raw_k_s, k + head, 0, N);
  stage_raw(raw_v_s, v + head, 0, N);
  mma::cp_async_commit();

  // Q fragments of rows g, g + 8 of this warp, float32 (split per tile):
  // k step kk pairs k = t with dim 8kk + 2t and k = t + 4 with dim 8kk + 2t
  // + 1
  uint32_t qf[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float* src = q + head + (size_t)min(row, N - 1) * kD + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float2 x = make_float2(0.f, 0.f);
      if (row < N) x = *reinterpret_cast<const float2*>(src + 8 * kk);
      qf[kk][r] = __float_as_uint(x.x);
      qf[kk][2 + r] = __float_as_uint(x.y);
    }
  }

  float o[8][4];       // O, 16 rows x 64 dims (8 n8 tiles), unnormalised
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8 (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of their running sums
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    mma::cp_async_wait<0>();   // tile it landed (this thread's copies)
    __syncthreads();           // ... everyone's; and tile it - 1's planes are consumed
    // split the raw tile once; consecutive threads take consecutive 16-byte
    // pieces of a row
    for (int i = threadIdx.x; i < kTile * 16; i += kTfThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      float4 h, lo;
      split4(*reinterpret_cast<const float4*>(raw_k + r * kRawLd + c), h, lo);
      *reinterpret_cast<float4*>(kh + k_row(r) * kLd + c) = h;
      *reinterpret_cast<float4*>(kl + k_row(r) * kLd + c) = lo;
      split4(*reinterpret_cast<const float4*>(raw_v + r * kRawLd + c), h, lo);
      *reinterpret_cast<float4*>(vh + r * kLd + c) = h;
      *reinterpret_cast<float4*>(vl + r * kLd + c) = lo;
    }
    __syncthreads();           // planes ready; the raw buffers are free
    if (it + 1 < ntiles) {
      stage_raw(raw_k_s, k + head, (it + 1) * kTile, N);
      stage_raw(raw_v_s, v + head, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();

    // S = Q K^T: 16 rows x 64 keys (8 n8 tiles); lane column 2t + e of tile
    // j is key 8j + t + 4e
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split_cvt(qf[kk], ah, al);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (8 * j + g) * kLd + 8 * kk + 2 * tq;
        const float2 bh = *reinterpret_cast<const float2*>(kh + at);
        const float2 bl = *reinterpret_cast<const float2*>(kl + at);
        mma::mma_tf32(s[j], al, __float_as_uint(bh.x), __float_as_uint(bh.y));
        mma::mma_tf32(s[j], ah, __float_as_uint(bl.x), __float_as_uint(bl.y));
        mma::mma_tf32(s[j], ah, __float_as_uint(bh.x), __float_as_uint(bh.y));
      }
    }

    // online softmax; lane holds keys 8j + tq + 4 (e & 1) of rows g (e < 2)
    // and g + 8 (e >= 2)
    const int k0 = it * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[j][e] * scale_log2;
        if (k0 + 8 * j + tq + 4 * (e & 1) >= N) t = -INFINITY;
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
      }

    // this tile's P V: k step j = keys 8j .. 8j + 7 in order, so P's A
    // fragment (rows g, g + 8; keys t, t + 4) is s[j] as it lies; summed
    // into a fresh register tile (mma truncates the float32 sums it writes)
    // and added to O once, rounded to nearest
    float pv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t p[4] = {__float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                             __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
      uint32_t ph[4], pl[4];
      split_cvt(p, ph, pl);
      const float* vh0 = vh + (8 * j + tq) * kLd + g;
      const float* vl0 = vl + (8 * j + tq) * kLd + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t bh0 = __float_as_uint(vh0[8 * n]), bh1 = __float_as_uint(vh0[4 * kLd + 8 * n]);
        const uint32_t bl0 = __float_as_uint(vl0[8 * n]), bl1 = __float_as_uint(vl0[4 * kLd + 8 * n]);
        mma::mma_tf32(pv[n], pl, bh0, bh1);
        mma::mma_tf32(pv[n], ph, bl0, bl1);
        mma::mma_tf32(pv[n], ph, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    float* dst = out + head + (size_t)row * kD + 2 * tq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
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

// float32, 3xTF32 on the tensor cores. q, k, v, out: [BH, N, 64], 16-byte
// aligned.
int vit_attention_tf32x3(const void* q, const void* k, const void* v, void* out, int BH, int N,
                         float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_attention_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_tf32x3_kernel<<<grid, kTfThreads, kTfSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, scale * kLog2e);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
