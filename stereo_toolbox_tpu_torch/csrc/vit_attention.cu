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
// Either forward also writes each row's log-sum-exp of the scaled logits,
// float32 [B * heads, N] in natural-log units, where the caller passes an
// `lse` pointer (a train step saves it for the backward); with a null
// pointer (eval) nothing else changes.
//
// Backward (K7-bwd): the counterparts of the library's two backward Pallas
// kernels (_flash_attention_bwd_dkv and _flash_attention_bwd_dq in
// jax/experimental/pallas/ops/tpu/flash_attention.py). Both recompute
// P = exp2(S * scale * log2e - lse * log2e) from the saved lse and form
// dS = P * (dO V^T - di), di = rowsum(dO * O) (given, float32 [BH, N]), in
// float32 whatever the input type:
//   vit_attention_bwd_dkv: a block owns 64 keys and walks the query tiles:
//     dV += P^T dO, dK += scale * dS^T Q;
//   vit_attention_bwd_dq: a block owns 64 queries and walks the key tiles:
//     dQ += scale * dS K.
// Design "simt": 256 threads a block, float32 FMA on the CUDA cores from
// float32 tiles in shared memory (bf16 inputs widened as they are staged;
// rows of 65 floats, so the column reads of a warp hit distinct banks). Per
// tile, a thread computes a 4x4 patch of S and of dO V^T (rows r + 16i,
// columns c + 16j), writes P and dS to shared memory, and after a barrier a
// 4x4 patch of its accumulators (dK and dV, or dQ) from them. Rows past N
// stage as zeros and get P = 0; rows past N are not stored. The gradients
// are stored in the input type. What bounds it on this card: operations
// (the two kernels do 14 N^2 64 FLOP a head against the 10 N^2 64 that the
// S recompute, dV, dP, dQ and dK need, at the 67 TF/s float32 peak), then
// the shared-memory loads (one load a FMA in the S and dP patches, half a
// load in the accumulations).
//
// C interface (loaded with ctypes): vit_attention_mma(...),
// vit_attention_tf32x3(...), vit_attention_bwd_dkv(...) and
// vit_attention_bwd_dq(...) launch on the given stream, allocate nothing,
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
constexpr float kLn2 = 0.6931471805599453f;

// The log-sum-exp (natural log) of a row from its running max `m` (log2
// units) and its full sum `l`, where the caller asked for it.
__device__ __forceinline__ void store_lse(float* lse, int row, float m, float l) {
  if (lse != nullptr) lse[row] = (m + log2f(l)) * kLn2;
}

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
                            const float* __restrict__ v, float* __restrict__ out,
                            float* __restrict__ lse, int N, float scale_log2) {
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
    if (tq == 0) store_lse(lse, blockIdx.y * N + row, m[r], l[r]);
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
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         float* __restrict__ lse, int N, float scale_log2) {
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
    if (tq == 0) store_lse(lse, blockIdx.y * N + row, m[r], l[r]);
    const float inv = 1.f / l[r];
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + head + (size_t)row * kD + 2 * tq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[4 * j] = mma::pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------- backward

constexpr int kBwdThreads = 256;       // 16 x 16 threads, a 4 x 4 patch each
constexpr int kBLd = kD + 1;           // staged rows (65 floats)
constexpr int kBTile = kTile * kBLd;   // floats of one staged 64-row tile

// 16 bytes of a row as float32: four floats, or eight bf16 (a bf16 is the
// high half of its float32)
__device__ __forceinline__ void unpack(const uint4 w, float* to, float) {
  to[0] = __uint_as_float(w.x);
  to[1] = __uint_as_float(w.y);
  to[2] = __uint_as_float(w.z);
  to[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4 w, float* to, bf16) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    to[2 * i] = __uint_as_float(words[i] << 16);
    to[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(bf16* p, float x) { *p = __float2bfloat16(x); }

// Rows [row0, row0 + 64) of one head's [N, 64] matrix into [64][kBLd]
// float32 at dst, zero-filled past N; 16-byte loads (4 floats or 8 bf16).
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* __restrict__ src, int row0,
                                          int N) {
  constexpr int kVec = 16 / sizeof(T);        // elements a 16-byte load
  constexpr int kPer = kD / kVec;             // loads a row
  for (int i = threadIdx.x; i < kTile * kPer; i += kBwdThreads) {
    const int r = i / kPer, c = (i % kPer) * kVec;
    float* to = dst + r * kBLd + c;
    if (row0 + r < N) {
      unpack(*reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD + c), to, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) to[e] = 0.f;
    }
  }
}

// S = A B^T and dP = C D^T of one 64 x 64 tile pair, the 4 x 4 patch of
// rows r + 16i, columns c + 16j, from [64][kBLd] tiles.
__device__ __forceinline__ void two_products(const float* a, const float* b, const float* c,
                                             const float* d, int r, int cc, float (&s)[4][4],
                                             float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kD; ++k) {
    float av[4], bv[4], cv[4], dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(r + 16 * i) * kBLd + k];
      cv[i] = c[(r + 16 * i) * kBLd + k];
      bv[i] = b[(cc + 16 * i) * kBLd + k];
      dv[i] = d[(cc + 16 * i) * kBLd + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], dv[j], dp[i][j]);
      }
  }
}

// dK and dV of 64 keys: the block of (key tile blockIdx.x, head blockIdx.y)
// walks every query tile. lse2 = lse * log2e, rows past N get P = 0.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
vit_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             T* __restrict__ dk, T* __restrict__ dv, int N, float scale_log2,
                             float scale) {
  extern __shared__ __align__(16) float bsm[];
  float* ks = bsm;                 // this block's keys, [64][kBLd]
  float* vs = ks + kBTile;         // their values
  float* qs = vs + kBTile;         // the query tile
  float* dos = qs + kBTile;        // its output gradient
  float* ps = dos + kBTile;        // P [query][key]
  float* dss = ps + kBTile;        // dS [query][key]
  float* rows = dss + kBTile;      // lse2 [64], di [64] of the query tile

  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const int k0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const float* lse_h = lse + (size_t)blockIdx.y * N;
  const float* di_h = di + (size_t)blockIdx.y * N;
  stage_f32(ks, k + head, k0, N);
  stage_f32(vs, v + head, k0, N);

  float acc_k[4][4], acc_v[4][4];  // keys hi + 16j, dims lo + 16i
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();               // the previous tile's P, dS, Q, dO are consumed
    stage_f32(qs, q + head, q0, N);
    stage_f32(dos, dout + head, q0, N);
    if (tid < kTile) {
      const bool ok = q0 + tid < N;
      rows[tid] = ok ? lse_h[q0 + tid] * kLog2e : 0.f;
      rows[kTile + tid] = ok ? di_h[q0 + tid] : 0.f;
    }
    __syncthreads();

    // S (queries hi + 16i, keys lo + 16j) and dP = dO V^T
    float s[4][4], dp[4][4];
    two_products(qs, ks, dos, vs, hi, lo, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = hi + 16 * i;
      const bool qok = q0 + qi < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = lo + 16 * j;
        const float p =
            (qok && k0 + kj < N) ? exp2f(fmaf(s[i][j], scale_log2, -rows[qi])) : 0.f;
        ps[qi * kBLd + kj] = p;
        dss[qi * kBLd + kj] = p * (dp[i][j] - rows[kTile + qi]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's real queries
    const int nq = min(kTile, N - q0);
    for (int qi = 0; qi < nq; ++qi) {
      float pv[4], dsv[4], ov[4], qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = ps[qi * kBLd + hi + 16 * j];
        dsv[j] = dss[qi * kBLd + hi + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ov[i] = dos[qi * kBLd + lo + 16 * i];
        qv[i] = qs[qi * kBLd + lo + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[j][i] = fmaf(pv[j], ov[i], acc_v[j][i]);
          acc_k[j][i] = fmaf(dsv[j], qv[i], acc_k[j][i]);
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + hi + 16 * j;
    if (key >= N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t at = head + (size_t)key * kD + lo + 16 * i;
      narrow(dk + at, acc_k[j][i] * scale);
      narrow(dv + at, acc_v[j][i]);
    }
  }
}

// dQ of 64 queries: the block of (query tile blockIdx.x, head blockIdx.y)
// walks every key tile.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
vit_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            T* __restrict__ dq, int N, float scale_log2, float scale) {
  extern __shared__ __align__(16) float bsm[];
  float* qs = bsm;                 // this block's queries, [64][kBLd]
  float* dos = qs + kBTile;        // their output gradient
  float* ks = dos + kBTile;        // the key tile
  float* vs = ks + kBTile;         // its values
  float* dss = vs + kBTile;        // dS [query][key]

  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  stage_f32(qs, q + head, q0, N);
  stage_f32(dos, dout + head, q0, N);
  float lse2[4], dii[4];           // of queries hi + 16i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + hi + 16 * i;
    const bool ok = row < N;
    lse2[i] = ok ? lse[(size_t)blockIdx.y * N + row] * kLog2e : 0.f;
    dii[i] = ok ? di[(size_t)blockIdx.y * N + row] : 0.f;
  }

  float acc[4][4];                 // queries hi + 16i, dims lo + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();               // the previous tile's K, V, dS are consumed
    stage_f32(ks, k + head, k0, N);
    stage_f32(vs, v + head, k0, N);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products(qs, ks, dos, vs, hi, lo, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = hi + 16 * i;
      const bool qok = q0 + qi < N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = lo + 16 * j;
        const float p =
            (qok && k0 + kj < N) ? exp2f(fmaf(s[i][j], scale_log2, -lse2[i])) : 0.f;
        dss[qi * kBLd + kj] = p * (dp[i][j] - dii[i]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's real keys
    const int nk = min(kTile, N - k0);
    for (int kj = 0; kj < nk; ++kj) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(hi + 16 * i) * kBLd + kj];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[kj * kBLd + lo + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + hi + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      narrow(dq + head + (size_t)row * kD + lo + 16 * j, acc[i][j] * scale);
  }
}

constexpr int kDkvSmem = (6 * kBTile + 2 * kTile) * (int)sizeof(float);
constexpr int kDqSmem = 5 * kBTile * (int)sizeof(float);

template <typename T>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, void* dk, void* dv, int BH, int N,
                           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vit_attention_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_bwd_dkv_kernel<T><<<grid, kBwdThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), N,
      scale * kLog2e, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* di, void* dq, int BH, int N,
                          float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vit_attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_bwd_dq_kernel<T><<<grid, kBwdThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), N, scale * kLog2e, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// bfloat16, tensor cores. q, k, v, out: [BH, N, 64], 16-byte aligned; lse:
// float32 [BH, N] or null.
int vit_attention_mma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                      int N, float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_attention_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_mma_kernel<<<grid, kMmaThreads, kMmaSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), N, scale * kLog2e);
  return (int)cudaGetLastError();
}

// float32, 3xTF32 on the tensor cores. q, k, v, out: [BH, N, 64], 16-byte
// aligned; lse: float32 [BH, N] or null.
int vit_attention_tf32x3(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int N, float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(vit_attention_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  vit_attention_tf32x3_kernel<<<grid, kTfThreads, kTfSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), N, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The backward, design "simt". q, k, v, dout and the gradients: [BH, N, 64]
// of the input type (dtype 0 float32, 1 bfloat16), 16-byte aligned; lse, di:
// float32 [BH, N].
int vit_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dk, void* dv, int BH, int N,
                          float scale, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || (dtype != 0 && dtype != 1) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  return (int)(dtype == 0 ? launch_bwd_dkv<float>(q, k, v, dout, l, d, dk, dv, BH, N, scale, s)
                          : launch_bwd_dkv<bf16>(q, k, v, dout, l, d, dk, dv, BH, N, scale, s));
}

int vit_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* di, void* dq, int BH, int N, float scale,
                         int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || (dtype != 0 && dtype != 1) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  return (int)(dtype == 0 ? launch_bwd_dq<float>(q, k, v, dout, l, d, dq, BH, N, scale, s)
                          : launch_bwd_dq<bf16>(q, k, v, dout, l, d, dq, BH, N, scale, s));
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
