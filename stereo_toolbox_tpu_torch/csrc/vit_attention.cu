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
// S = Q K^T and P = exp2(S * scale * log2e - lse * log2e) from the saved lse
// and form dS = P * (dO V^T - di), di = rowsum(dO * O) (given, float32
// [BH, N]), in float32 whatever the input type:
//   vit_attention_bwd_dkv: a block owns 64 keys (4 warps x 16) and walks
//     the query tiles: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//     dK += scale * dS^T Q;
//   vit_attention_bwd_dq: a block owns 64 queries (4 warps x 16) and walks
//     the key tiles: S = Q K^T, dP = dO V^T, dQ += scale * dS K.
// Each output element is written by one block, no atomics: the same bits
// every run. The walked tiles (with, in dkv, their lse * log2e and di)
// stream through shared memory by cp.async, double-buffered, zero-filled
// past N; the block's own tiles stay resident. P and dS never leave
// registers: the accumulator fragments of the score products are the A
// fragments of the gradient products. Queries past N get P = 0 (lse taken
// as +inf), keys past N are masked in dq, rows past N are not stored.
// What bounds them on this card: operations (dK, dV 8 N^2 64 and dQ
// 6 N^2 64 FLOP a head), then the fragment loads from shared memory.
//
// bfloat16 ("mma"): mma.sync m16n8k16 with float32 sums; the resident
// tiles' fragments (Q, dO or K, V) stay in registers (ldmatrix), the
// walked tiles are read by ldmatrix (score products) and ldmatrix.trans
// (gradient products) from the swizzled tiles of the forward. P and dS
// are rounded to bfloat16 as the A operands of dV, dK and dQ, where the
// library rounds them; the gradients are stored as bfloat16.
//
// float32 ("tf32x3"): every product 3xTF32 on mma.sync m16n8k8, each
// operand split into its tf32 high part and remainder as its fragment is
// loaded from the raw float32 tiles in shared memory (rows of 72 floats;
// none is held split in registers, which would spill). The n8 tiles of S
// pair their columns with the tokens of the gradient product's k step
// (tok()), so that the C fragments are the A fragments in place and both
// kinds of fragment load hit distinct banks. mma.sync truncates the
// float32 sums it writes: each k8 step of S and dP sums into fresh
// registers added once, rounded to nearest, and each walked tile's share
// of dQ, dK and dV likewise (the forward's 24 truncations into S bias a
// logit of ~30 by ~2e-5, which exp would carry into P past the 1e-5 gate).
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
// [64][Ld] at dst, zero-filled past N.
template <int Ld = kRawLd>
__device__ __forceinline__ void stage_raw(uint32_t dst, const float* __restrict__ src, int row0,
                                          int N) {
  for (int i = threadIdx.x; i < kTile * 16; i += kTfThreads) {
    const int r = i >> 4, c = i & 15;
    const bool ok = row0 + r < N;
    const float* from = ok ? src + (size_t)(row0 + r) * kD + c * 4 : src;
    mma::cp_async16(dst + (r * Ld + c * 4) * 4, from, ok);
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

constexpr int kBwdThreads = 128;           // 4 warps x 16 rows (queries or keys)
constexpr int kBLd = kD + 8;               // float32 staged rows, floats
constexpr int kBTile = kTile * kBLd;       // floats of one float32 staged tile

// Column c of an n8 tile of the float32 S (S^T) holds token tok(c) of its 8
// (keys in dq, queries in dkv), so that a lane's accumulator columns 2t,
// 2t + 1 hold the tokens of k = t and k = t + 4 of the A fragment that
// reuses them, and that both the row loads of the score products (tokens
// tok(g)) and the column loads of the gradient products (tokens tok(2t),
// tok(2t + 1)) of a warp hit distinct banks in rows of kBLd floats.
__device__ __forceinline__ int tok(int c) { return c ^ ((c >> 2) & 1); }

// d += a b over one k8 step in 3xTF32: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma::mma_tf32(d, al, bh0, bh1);
  mma::mma_tf32(d, ah, bl0, bl1);
  mma::mma_tf32(d, ah, bh0, bh1);
}

// The split A fragment of rows r, r + 8 at `at` (row r, dim 8kk + 2t) of a
// float32 [64][kBLd] tile: k = t and t + 4 are dims 2t and 2t + 1 of the
// step's 8
__device__ __forceinline__ void a_rows(const float* at, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(at);
  const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * kBLd);
  const uint32_t x[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x), __float_as_uint(x0.y),
                         __float_as_uint(x1.y)};
  mma::split_tf32(x, hi, lo);
}

// S (or S^T) += A B^T over the 64 dims of 16 rows x 64 tokens: a at row
// g, dim 2t of the A tile, b at the B tile; each k8 step's three products
// go into a fresh register tile that is added once, rounded to nearest
// (mma.sync truncates the float32 sums it writes; 24 truncations into one
// tile bias a logit of ~30 by ~2e-5, which exp carries into P)
__device__ __forceinline__ void scores_3xtf32(float (&s)[8][4], const float* a, const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    a_rows(a + 8 * kk, ah, al);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(b + (8 * j + tok(g)) * kBLd + 8 * kk + 2 * tq);
      uint32_t bh0, bh1, bl0, bl1;
      mma::split_tf32(x.x, bh0, bl0);
      mma::split_tf32(x.y, bh1, bl1);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(t, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += t[e];
    }
  }
}

// acc += C B over one 64-token tile, C the accumulator tiles of a score
// product (16 rows x 64 tokens, column c of tile j token 8j + tok(c)), B
// the [64 tokens][64 dims] tile at b: k step j takes C's tile j as its A
// fragment as it lies (k = t, t + 4: tokens tok(2t), tok(2t + 1)); summed
// into a fresh register tile, added once
__device__ __forceinline__ void grads_3xtf32(float (&acc)[8][4], const float (&c)[8][4],
                                             const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  float t[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t x[4] = {__float_as_uint(c[j][0]), __float_as_uint(c[j][2]),
                           __float_as_uint(c[j][1]), __float_as_uint(c[j][3])};
    uint32_t ah[4], al[4];
    mma::split_tf32(x, ah, al);
    const float* b0 = b + (8 * j + tok(2 * tq)) * kBLd + g;
    const float* b1 = b + (8 * j + tok(2 * tq + 1)) * kBLd + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bh0, bh1, bl0, bl1;
      mma::split_tf32(b0[8 * n], bh0, bl0);
      mma::split_tf32(b1[8 * n], bh1, bl1);
      mma_3xtf32(t[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
}

// bfloat16: S (or S^T) = A B^T of 16 rows x 64 tokens over the 64 dims, A
// as resident fragments, B a swizzled [64 tokens][64 dims] tile (column 2t
// + e of tile j: token 8j + 2t + e)
__device__ __forceinline__ void scores_mma(float (&s)[8][4], const uint32_t (&a)[4][4],
                                           uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t f[4];
      const int row = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
      mma::ldmatrix_x4(f, b + swz(row, 2 * kk + ((lane >> 3) & 1)));
      mma::mma_bf16(s[2 * jp], a[kk], f[0], f[1]);
      mma::mma_bf16(s[2 * jp + 1], a[kk], f[2], f[3]);
    }
  }
}

// bfloat16: acc += C B over one 64-token tile, C rounded to bfloat16 as the
// A fragments (k step kk: tokens 16kk .. 16kk + 15), B the swizzled [64
// tokens][64 dims] tile at b (ldmatrix.trans)
__device__ __forceinline__ void grads_mma(float (&acc)[8][4], const float (&c)[8][4], uint32_t b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {mma::pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           mma::pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           mma::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           mma::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t f[4];
      const int row = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      mma::ldmatrix_x4_trans(f, b + swz(row, 2 * dp + (lane >> 4)));
      mma::mma_bf16(acc[2 * dp], a, f[0], f[1]);
      mma::mma_bf16(acc[2 * dp + 1], a, f[2], f[3]);
    }
  }
}

// Rows r (0: g, 1: g + 8) of a 16 x 64 accumulator, times `mul`, at dst
// (the row's dim 2t), in the output type
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[8][4], int r, float mul) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
    *reinterpret_cast<float2*>(dst + 8 * n) =
        make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
}
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[8][4], int r, float mul) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int n = 0; n < 8; ++n) d[4 * n] = mma::pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
}

// dK = scale * acc_k and dV = acc_v of this warp's 16 keys of the tile at
// k0 (of one head's [N, 64] gradients), keys past N not stored
template <typename T>
__device__ __forceinline__ void store_dkv(T* dk, T* dv, const float (&acc_k)[8][4],
                                          const float (&acc_v)[8][4], int k0, int N, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= N) continue;
    store_row(dk + (size_t)key * kD + 2 * tq, acc_k, r, scale);
    store_row(dv + (size_t)key * kD + 2 * tq, acc_v, r, 1.f);
  }
}

// dQ = scale * acc of this warp's 16 queries of the tile at q0
template <typename T>
__device__ __forceinline__ void store_dq(T* dq, const float (&acc)[8][4], int q0, int N,
                                         float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < N) store_row(dq + (size_t)row * kD + 2 * tq, acc, r, scale);
  }
}

// lse * log2e (+inf past N, so that P = 0 there) and di of the 64 queries
// at row0 into st[0, 64) and st[64, 128)
__device__ __forceinline__ void stage_stats(float* st, const float* __restrict__ lse,
                                            const float* __restrict__ di, int row0, int N) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    const bool ok = row < N;
    st[threadIdx.x] = ok ? lse[row] * kLog2e : INFINITY;
    st[kTile + threadIdx.x] = ok ? di[row] : 0.f;
  }
}

// dS = P * (dP - di), P = exp2(S * scale_log2 - lse2), in place of dp;
// P in place of s. Element e of tile j is row e >> 1, token col(j, e & 1)
// of the tile; `keep` says whether that token is real; lse2 and di by
// (row, token): rows of the dq kernel, tokens (queries) of the dkv kernel.
template <typename Col, typename Stat>
__device__ __forceinline__ void softmax_grad(float (&s)[8][4], float (&dp)[8][4], float scale_log2,
                                             Col keep, Stat stat) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lse2, d;
      stat(j, e, lse2, d);
      const float p = keep(j, e) ? exp2f(fmaf(s[j][e], scale_log2, -lse2)) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - d);
    }
}

// dQ of 64 queries, float32 ("tf32x3"): the block of (query tile
// blockIdx.x, head blockIdx.y) keeps its Q and dO tiles in shared memory
// and walks the key tiles, double-buffered by cp.async.
__global__ void __launch_bounds__(kBwdThreads, 2)
vit_attention_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ di,
                                   float* __restrict__ dq, int N, float scale_log2, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // [64][kBLd]
  float* dos = qs + kBTile;
  float* ks = dos + kBTile;         // [2][64][kBLd]
  float* vs = ks + 2 * kBTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_raw<kBLd>(mma::smem_addr(qs), q + head, q0, N);
  stage_raw<kBLd>(mma::smem_addr(dos), dout + head, q0, N);
  stage_raw<kBLd>(mma::smem_addr(ks), k + head, 0, N);
  stage_raw<kBLd>(mma::smem_addr(vs), v + head, 0, N);
  mma::cp_async_commit();

  float lse2[2], dii[2];            // rows g, g + 8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < N ? lse[(size_t)blockIdx.y * N + row] * kLog2e : INFINITY;
    dii[r] = row < N ? di[(size_t)blockIdx.y * N + row] : 0.f;
  }
  const int c0 = tok(2 * tq), c1 = tok(2 * tq + 1);
  const float* qa = qs + (warp * 16 + g) * kBLd + 2 * tq;
  const float* oa = dos + (warp * 16 + g) * kBLd + 2 * tq;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_raw<kBLd>(mma::smem_addr(ks + (buf ^ 1) * kBTile), k + head, (it + 1) * kTile, N);
      stage_raw<kBLd>(mma::smem_addr(vs + (buf ^ 1) * kBTile), v + head, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();        // tile it (and Q, dO) landed
    __syncthreads();
    const float* kt = ks + buf * kBTile;
    const float* vt = vs + buf * kBTile;
    const int k0 = it * kTile;

    float s[8][4], dp[8][4];
    scores_3xtf32(s, qa, kt);
    scores_3xtf32(dp, oa, vt);
    softmax_grad(
        s, dp, scale_log2,
        [&](int j, int e) { return k0 + 8 * j + ((e & 1) ? c1 : c0) < N; },
        [&](int, int e, float& l, float& d) { l = lse2[e >> 1]; d = dii[e >> 1]; });
    grads_3xtf32(acc, dp, kt);      // dQ += dS K
    __syncthreads();                // the next iteration's copies overwrite this buffer
  }
  store_dq(dq + head, acc, q0, N, scale);
}

// dK and dV of 64 keys, float32 ("tf32x3"): the block of (key tile
// blockIdx.x, head blockIdx.y) keeps its K and V tiles in shared memory
// and walks the query tiles (with their lse * log2e and di),
// double-buffered by cp.async.
__global__ void __launch_bounds__(kBwdThreads, 2)
vit_attention_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ lse, const float* __restrict__ di,
                                    float* __restrict__ dk, float* __restrict__ dv, int N,
                                    float scale_log2, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                  // [64][kBLd]
  float* vs = ks + kBTile;
  float* qs = vs + kBTile;          // [2][64][kBLd]
  float* dos = qs + 2 * kBTile;
  float* st = dos + 2 * kBTile;     // [2][lse2 64, di 64]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const float* lse_h = lse + (size_t)blockIdx.y * N;
  const float* di_h = di + (size_t)blockIdx.y * N;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_raw<kBLd>(mma::smem_addr(ks), k + head, k0, N);
  stage_raw<kBLd>(mma::smem_addr(vs), v + head, k0, N);
  stage_raw<kBLd>(mma::smem_addr(qs), q + head, 0, N);
  stage_raw<kBLd>(mma::smem_addr(dos), dout + head, 0, N);
  mma::cp_async_commit();
  stage_stats(st, lse_h, di_h, 0, N);
  const int c0 = tok(2 * tq), c1 = tok(2 * tq + 1);
  const float* ka = ks + (warp * 16 + g) * kBLd + 2 * tq;
  const float* va = vs + (warp * 16 + g) * kBLd + 2 * tq;

  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_raw<kBLd>(mma::smem_addr(qs + (buf ^ 1) * kBTile), q + head, (it + 1) * kTile, N);
      stage_raw<kBLd>(mma::smem_addr(dos + (buf ^ 1) * kBTile), dout + head, (it + 1) * kTile,
                      N);
      stage_stats(st + (buf ^ 1) * 2 * kTile, lse_h, di_h, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();        // tile it (and K, V) landed
    __syncthreads();
    const float* qt = qs + buf * kBTile;
    const float* ot = dos + buf * kBTile;
    const float* stt = st + buf * 2 * kTile;

    // S^T = K Q^T, dP^T = V dO^T: 16 keys x 64 queries (query 8j + tok(c)
    // in column c of tile j)
    float s[8][4], dp[8][4];
    scores_3xtf32(s, ka, qt);
    scores_3xtf32(dp, va, ot);
    softmax_grad(
        s, dp, scale_log2, [](int, int) { return true; },
        [&](int j, int e, float& l, float& d) {
          const int col = 8 * j + ((e & 1) ? c1 : c0);
          l = stt[col];
          d = stt[kTile + col];
        });
    grads_3xtf32(acc_v, s, ot);     // dV += P^T dO
    grads_3xtf32(acc_k, dp, qt);    // dK += dS^T Q
    __syncthreads();
  }
  store_dkv(dk + head, dv + head, acc_k, acc_v, k0, N, scale);
}

// dQ of 64 queries, bfloat16 ("mma"): as the float32 kernel, with Q and dO
// as resident A fragments and bf16 products on m16n8k16.
__global__ void __launch_bounds__(kBwdThreads, 2)
vit_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ di,
                                bf16* __restrict__ dq, int N, float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  const uint32_t sq = mma::smem_addr(smem_bytes);
  const uint32_t sdo = sq + kTileBytes;
  const uint32_t sk = sq + 2 * kTileBytes;   // K[2]
  const uint32_t sv = sq + 4 * kTileBytes;   // V[2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_async(sq, q + head, q0, N);
  stage_async(sdo, dout + head, q0, N);
  stage_async(sk, k + head, 0, N);
  stage_async(sv, v + head, 0, N);
  mma::cp_async_commit();

  float lse2[2], dii[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < N ? lse[(size_t)blockIdx.y * N + row] * kLog2e : INFINITY;
    dii[r] = row < N ? di[(size_t)blockIdx.y * N + row] : 0.f;
  }
  uint32_t qf[4][4], of[4][4];      // Q and dO fragments, 16 rows x 64 dims
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_async(sk + (buf ^ 1) * kTileBytes, k + head, (it + 1) * kTile, N);
      stage_async(sv + (buf ^ 1) * kTileBytes, v + head, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int at = swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
        mma::ldmatrix_x4(qf[kk], sq + at);
        mma::ldmatrix_x4(of[kk], sdo + at);
      }
    }
    const uint32_t kt = sk + buf * kTileBytes;
    const int k0 = it * kTile;

    float s[8][4], dp[8][4];
    scores_mma(s, qf, kt);
    scores_mma(dp, of, sv + buf * kTileBytes);
    softmax_grad(
        s, dp, scale_log2, [&](int j, int e) { return k0 + 8 * j + 2 * tq + (e & 1) < N; },
        [&](int, int e, float& l, float& d) { l = lse2[e >> 1]; d = dii[e >> 1]; });
    grads_mma(acc, dp, kt);         // dQ += dS K, dS rounded to bf16
    __syncthreads();
  }
  store_dq(dq + head, acc, q0, N, scale);
}

// dK and dV of 64 keys, bfloat16 ("mma"): as the float32 kernel, with K
// and V as resident A fragments and bf16 products on m16n8k16.
__global__ void __launch_bounds__(kBwdThreads, 2)
vit_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ di,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                                 float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  const uint32_t sk = mma::smem_addr(smem_bytes);
  const uint32_t sv = sk + kTileBytes;
  const uint32_t sq = sk + 2 * kTileBytes;   // Q[2]
  const uint32_t sdo = sk + 4 * kTileBytes;  // dO[2]
  float* st = reinterpret_cast<float*>(smem_bytes + 6 * kTileBytes);   // [2][128]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const size_t head = (size_t)blockIdx.y * N * kD;
  const float* lse_h = lse + (size_t)blockIdx.y * N;
  const float* di_h = di + (size_t)blockIdx.y * N;
  const int ntiles = (N + kTile - 1) / kTile;

  stage_async(sk, k + head, k0, N);
  stage_async(sv, v + head, k0, N);
  stage_async(sq, q + head, 0, N);
  stage_async(sdo, dout + head, 0, N);
  mma::cp_async_commit();
  stage_stats(st, lse_h, di_h, 0, N);

  uint32_t kf[4][4], vf[4][4];      // K and V fragments, 16 keys x 64 dims
  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage_async(sq + (buf ^ 1) * kTileBytes, q + head, (it + 1) * kTile, N);
      stage_async(sdo + (buf ^ 1) * kTileBytes, dout + head, (it + 1) * kTile, N);
      stage_stats(st + (buf ^ 1) * 2 * kTile, lse_h, di_h, (it + 1) * kTile, N);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int at = swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
        mma::ldmatrix_x4(kf[kk], sk + at);
        mma::ldmatrix_x4(vf[kk], sv + at);
      }
    }
    const uint32_t qt = sq + buf * kTileBytes;
    const uint32_t ot = sdo + buf * kTileBytes;
    const float* stt = st + buf * 2 * kTile;

    float s[8][4], dp[8][4];        // S^T, dP^T: 16 keys x 64 queries
    scores_mma(s, kf, qt);
    scores_mma(dp, vf, ot);
    softmax_grad(
        s, dp, scale_log2, [](int, int) { return true; },
        [&](int j, int e, float& l, float& d) {
          const int col = 8 * j + 2 * tq + (e & 1);
          l = stt[col];
          d = stt[kTile + col];
        });
    grads_mma(acc_v, s, ot);        // dV += P^T dO, P rounded to bf16
    grads_mma(acc_k, dp, qt);       // dK += dS^T Q, dS rounded to bf16
    __syncthreads();
  }
  store_dkv(dk + head, dv + head, acc_k, acc_v, k0, N, scale);
}

constexpr int kDqF32Smem = 6 * kBTile * (int)sizeof(float);
constexpr int kDkvF32Smem = (6 * kBTile + 4 * kTile) * (int)sizeof(float);
constexpr int kDqMmaSmem = 6 * kTileBytes;
constexpr int kDkvMmaSmem = 6 * kTileBytes + 4 * kTile * (int)sizeof(float);

// Sets the kernel's dynamic shared memory and launches it on (N / 64
// tiles, BH) blocks of kBwdThreads.
template <typename Kernel, typename... Args>
cudaError_t launch_bwd(Kernel kernel, int smem, int BH, int N, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, BH);
  kernel<<<grid, kBwdThreads, smem, stream>>>(args...);
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

// The backward: bfloat16 "mma" (dtype 1), float32 "tf32x3" (dtype 0). q, k,
// v, dout and the gradients: [BH, N, 64] of the input type, 16-byte
// aligned; lse, di: float32 [BH, N].
int vit_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* di, void* dk, void* dv, int BH, int N,
                          float scale, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || N < 1 || (dtype != 0 && dtype != 1) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  if (dtype == 0)
    return (int)launch_bwd(vit_attention_bwd_dkv_tf32x3_kernel, kDkvF32Smem, BH, N, s,
                           static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
                           static_cast<float*>(dk), static_cast<float*>(dv), N, scale * kLog2e,
                           scale);
  return (int)launch_bwd(vit_attention_bwd_dkv_mma_kernel, kDkvMmaSmem, BH, N, s,
                         static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, scale * kLog2e,
                         scale);
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
  if (dtype == 0)
    return (int)launch_bwd(vit_attention_bwd_dq_tf32x3_kernel, kDqF32Smem, BH, N, s,
                           static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
                           static_cast<float*>(dq), N, scale * kLog2e, scale);
  return (int)launch_bwd(vit_attention_bwd_dq_mma_kernel, kDqMmaSmem, BH, N, s,
                         static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, d,
                         static_cast<bf16*>(dq), N, scale * kLog2e, scale);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
