// Fused 3x3x3 convolution + eval-mode BatchNorm affine (+ residual) (+ ReLU)
// for Hopper, sm_90a.
//
// Replaces stereo_toolbox_tpu/ops/pallas/conv3d_fused.py::conv3d_fused
// (kernel body `_kernel`).
//
//   out = relu?(conv3d_3x3x3_same(x, w) * scale + bias + residual?)
//
// x [B, D, H, W, Ci], residual and out [B, D, H, W, Co] (channels-last,
// contiguous); w packed as [27][Co_pad][Ci_pad] (tap = kd*9 + kh*3 + kw;
// Co_pad a multiple of 64, Ci_pad of the type's channel chunk, zero padding:
// ops/conv3d_fused.py::pack_conv3d_weight): bfloat16 one plane of x's type,
// float32 two planes, the weight's tf32 high part and its tf32 remainder;
// scale, bias [Co] float32. Stride 1, zero padding 1. Accumulation in
// float32.
//
// What bounds it: operations. 2*27*Ci*Co multiply-adds per voxel against
// (Ci + Co) values moved; at the cost-volume shapes of GwcNet (Ci, Co >= 32)
// that is hundreds of operations per byte, above the card's ridge point.
//
// One design for both types, an implicit GEMM on the tensor cores
// (conv3d_fused_mma, conv3d_fused_tf32x3); neither falls back to anything.
// M = the output voxels of a block's tile at one (b, d): TH rows x 32 W; N =
// TN output channels; K = 3 kd x 9 (kh, kw) x Ci. The K loop walks (kd, one
// 32-byte chunk of input channels: 16 bf16 or 8 float32); a stage holds one
// z-plane of the input halo, [TH+2][34] pixels x the chunk, and the chunk's
// 9 taps of weights, [9][TN][chunk], in a 3-stage cp.async ring. The 9 taps
// of a stage read A from the same halo at shifted pixel addresses, so each
// input element enters shared memory once per kd and not 27 times. 32-byte
// pixel (and weight) rows are stored as two 16-byte chunks, the chunk index
// XORed with bit 2 of the row, so the 8 rows an ldmatrix phase reads fall on
// 8 distinct 16-byte bank groups. Each warp owns a (TH*32/WM) x (TN/WN)
// slice of the tile.
//
// bfloat16: mma.sync m16n8k16, A and B by ldmatrix.
//
// float32: 3xTF32 on mma.sync m16n8k8. Each operand is split into a tf32 high
// part and a tf32 remainder (round to nearest, ties away, as cvt.rna) and the
// products lo*hi + hi*lo + hi*hi are summed in float32: the dropped lo*lo and
// the remainders' rounding leave a product error of about 2^-22 of |a*b|,
// near float32's own, which holds the 1e-4 gate of the float32 plain version
// with TF32 off (one tf32 product, hi*hi, misses it by ~3x). On 32-bit data
// an ldmatrix .x4 gives each lane the element at (row lane/4, word lane%4) of
// each 8-row x 16-byte block, which is the tf32 A fragment of (voxel,
// channel) and the B fragment of the [Co][Ci] weight rows, so the bfloat16
// layout, swizzle and addressing serve unchanged with 8 channels to a 32-byte
// row. The weights are split once, at pack time (both planes staged a stage);
// the halo is split in registers after each fragment load, two integer
// instructions a part (mma::split_tf32; each halo element is split at each of
// its 9 taps), which beat splitting each landed halo plane once in shared
// memory (one more barrier a stage, twice the A fragment loads) at every
// launch shape of the five stereo forwards: chip_k2_halo_split.py. mma.sync
// truncates the float32 sum it writes, so each stage (kd, 8 channels) sums
// its 27 products into fresh registers and adds them to the accumulators
// rounded to nearest: three truncating mmas a step straight into the
// accumulators drift by ~4e-5 of max|ref| at 192 input channels. To hold both
// sets of sums a thread's warp tile is 32 voxels x 32 (16) channels, 8 warps
// a block (4 on the 64 x 32 tile). What bounds it on this card: the tf32
// products, three per multiply-add (3 * 2*27*Ci*Co a voxel at 495 TF/s
// dense).
//
// The epilogue stages the float32 sums through shared memory and applies
// scale, bias, residual and ReLU in float32 with 16-byte loads and stores,
// rounding once to x's type. Tiles (chosen by the wrapper,
// ops/conv3d_fused.py::mma_tile): 128 voxels x 64 Co (bfloat16), 256 x 32,
// 256 x 16, and 64 x 32 for grids under two blocks an SM. Ragged shapes: Ci
// not a multiple of the chunk reads zero-filled lanes in its last chunk;
// where 16-byte copies of x cannot be aligned (Ci % 8 != 0 in bf16, Ci % 4 !=
// 0 in float32) the halo is staged with plain predicated loads through
// registers, issued before the current stage's products and stored after
// them; Co past the tile's end has zero weights and masked stores; H, W
// ragged and D < 3 read zeros.
//
// C interface (loaded with ctypes): conv3d_fused_mma(...) (bfloat16) and
// conv3d_fused_tf32x3(...) (float32) launch on the given stream, allocate
// nothing, synchronise nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHaloW32 = 34;       // 32 W + 2 halo columns

// Shapes and shared-memory plan of one tile: TH rows x 32 W voxels, TN
// output channels, warps WM along the voxels x WN along the channels;
// kPlanes weight planes a stage (1 bf16, 2 float32: high and remainder).
template <int TH, int TN, int WM, int WN, int kPlanes>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kM = TH * 32;
  static constexpr int kWarpM = kM / WM, kWarpN = TN / WN;
  static constexpr int MT = kWarpM / 16, NT = kWarpN / 8;   // m16 and n8 tiles a warp
  static constexpr int kHaloPix = (TH + 2) * kHaloW32;
  static constexpr int kHaloChunks = kHaloPix * 2;          // 16-byte chunks
  static constexpr int kHaloPerThread = (kHaloChunks + kThreads - 1) / kThreads;
  static constexpr int kHaloBytes = kHaloPix * 32;
  static constexpr int kPlaneBytes = 9 * TN * 32;           // one weight plane
  static constexpr int kWBytes = kPlanes * kPlaneBytes;
  static constexpr int kStageBytes = kHaloBytes + kWBytes;
  static constexpr int kStages = 3;
  static constexpr int kLdo = TN + 8;                       // staged output row, floats
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = kM * kLdo * 4;
  static constexpr int kSmem = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  static_assert(WM * WN == 4 || WM * WN == 8, "4 or 8 warps");
  static_assert(kWarpM % 16 == 0 && MT >= 1 && NT % 2 == 0, "warp tile");
  static_assert(kHaloBytes % 128 == 0 && kStageBytes % 128 == 0, "alignment");
};

// byte offset of 16-byte chunk q (0, 1) of 32-byte row r, swizzled
__device__ __forceinline__ int swz(int r, int q) { return r * 32 + ((q ^ ((r >> 2) & 1)) << 4); }

template <typename T>
struct ConvArgs {
  const T* x;
  const T* w;      // [kPlanes][27][co_pad][ci_pad]
  const float* scale;
  const float* bias;
  const T* res;
  T* out;
  int D, H, W, Ci, Co, ci_pad, co_pad, relu, tiles_w, co_blocks, vec;
};

// 8 float32 sums of one voxel into x's type at dst (16 or 32 bytes)
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]),
                 mma::pack_bf16(v[4], v[5]), mma::pack_bf16(v[6], v[7]));
}
// v += 8 values of x's type at src
__device__ __forceinline__ void add8(float (&v)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  const float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] += r[k];
}
__device__ __forceinline__ void add8(float (&v)[8], const bf16* src) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[k]));
    v[2 * k] += f.x;
    v[2 * k + 1] += f.y;
  }
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int TH, int TN, int WM, int WN, bool kAsyncX>
__global__ void __launch_bounds__(32 * WM * WN)
conv3d_fused_mma_kernel(const ConvArgs<T> args) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kPlanes = kF32 ? 2 : 1;
  constexpr int kChunk = 32 / sizeof(T);   // input channels a stage
  constexpr int kHalf = kChunk / 2;        // channels a 16-byte chunk
  using Tl = Tile<TH, TN, WM, WN, kPlanes>;
  constexpr int MT = Tl::MT, NT = Tl::NT;
  constexpr int kThreads = Tl::kThreads;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* smem = smem_bytes;
  const uint32_t smem0 = mma::smem_addr(smem);

  const int D = args.D, H = args.H, W = args.W, Ci = args.Ci, Co = args.Co;
  const int h0 = (blockIdx.x / args.tiles_w) * TH;
  const int w0 = (blockIdx.x % args.tiles_w) * 32;
  const int d = blockIdx.y;
  const int b = blockIdx.z / args.co_blocks;
  const int co0 = (blockIdx.z % args.co_blocks) * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int nchunks = args.ci_pad / kChunk;
  const int nstages = 3 * nchunks;   // (kd, channel chunk)
  const size_t plane = (size_t)27 * args.co_pad * args.ci_pad;

  // halo pixel (r, c) of this stage: input (d + kd - 1, h0 + r - 1, w0 + c - 1)
  auto halo_src = [&](int s, int i, bool& ok) -> const T* {
    const int kd = s / nchunks;
    const int gc = (s - kd * nchunks) * kChunk + (i & 1) * kHalf;
    const int p = i >> 1;
    const int yy = p / kHaloW32, xx = p - yy * kHaloW32;
    const int gz = d + kd - 1, gy = h0 - 1 + yy, gx = w0 - 1 + xx;
    ok = gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Ci;
    return ok ? args.x + ((((size_t)b * D + gz) * H + gy) * W + gx) * Ci + gc : args.x;
  };
  auto load_weights = [&](int s, uint32_t dst) {
    const int kd = s / nchunks;
    const int c0 = (s - kd * nchunks) * kChunk;
    constexpr int kPer = 9 * TN * 2;    // 16-byte chunks of one plane
    for (int i = threadIdx.x; i < kPlanes * kPer; i += kThreads) {
      const int pl = kPlanes > 1 && i >= kPer;
      const int j = i - pl * kPer;
      const int r = j >> 1;               // tap * TN + n
      const int t = r / TN, n = r - t * TN;
      const T* src = args.w + pl * plane +
                     ((size_t)(kd * 9 + t) * args.co_pad + co0 + n) * args.ci_pad + c0 +
                     (j & 1) * kHalf;
      mma::cp_async16(dst + pl * Tl::kPlaneBytes + swz(r, j & 1), src, true);
    }
  };
  auto load_halo_async = [&](int s, uint32_t dst) {
    for (int i = threadIdx.x; i < Tl::kHaloChunks; i += kThreads) {
      bool ok;
      const T* src = halo_src(s, i, ok);
      mma::cp_async16(dst + swz(i >> 1, i & 1), src, ok);
    }
  };
  // plain loads (x rows not 16-byte aligned): predicated element loads, a
  // 16-byte chunk at a time
  uint4 held[Tl::kHaloPerThread];
  auto load_halo_regs = [&](int s) {
#pragma unroll
    for (int k = 0; k < Tl::kHaloPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (i < Tl::kHaloChunks) {
        bool ok;
        const T* src = halo_src(s, i, ok);
        if (ok) {
          const int left = Ci - ((s % nchunks) * kChunk + (i & 1) * kHalf);
          if constexpr (kF32) {
            const uint32_t* p = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
            for (int j = 0; j < 4; ++j) e[j] = j < left ? p[j] : 0u;
          } else {
            const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
            for (int j = 0; j < 8; ++j) e[j] = j < left ? p[j] : 0u;
          }
        }
      }
      if constexpr (kF32)
        held[k] = make_uint4(e[0], e[1], e[2], e[3]);
      else
        held[k] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                             e[6] | (e[7] << 16));
    }
  };
  auto store_halo_regs = [&](unsigned char* dst) {
#pragma unroll
    for (int k = 0; k < Tl::kHaloPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < Tl::kHaloChunks) *reinterpret_cast<uint4*>(dst + swz(i >> 1, i & 1)) = held[k];
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this lane's ldmatrix rows: A pixel of tap (0, 0) per m16 tile, B channel
  // per pair of n8 tiles
  int pa[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = wm * Tl::kWarpM + i * 16 + (lane & 15);
    pa[i] = (m >> 5) * kHaloW32 + (m & 31);
  }
  const int qa = lane >> 4;
  int nb[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j)
    nb[j] = wn * Tl::kWarpN + j * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int qb = (lane >> 3) & 1;

  // prologue: stages 0 and 1
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nstages) {
      const uint32_t dst = smem0 + s * Tl::kStageBytes;
      load_weights(s, dst + Tl::kHaloBytes);
      if (kAsyncX) {
        load_halo_async(s, dst);
      } else {
        load_halo_regs(s);
        store_halo_regs(smem + s * Tl::kStageBytes);
      }
    }
    mma::cp_async_commit();
  }

  for (int s = 0; s < nstages; ++s) {
    mma::cp_async_wait<1>();   // stage s has landed (this thread's copies)
    __syncthreads();           // ... everyone's; and stage s - 1 is consumed
    const int sn = s + 2;
    const int slot_n = sn % 3;
    const bool more = sn < nstages;
    if (more) {
      load_weights(sn, smem0 + slot_n * Tl::kStageBytes + Tl::kHaloBytes);
      if (kAsyncX)
        load_halo_async(sn, smem0 + slot_n * Tl::kStageBytes);
      else
        load_halo_regs(sn);
    }
    mma::cp_async_commit();

    const uint32_t halo = smem0 + (s % 3) * Tl::kStageBytes;
    const uint32_t wts = halo + Tl::kHaloBytes;
    // float32: this stage's sums, added to acc once (see the header)
    float st[MT][NT][4];
    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][j][e] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * kHaloW32 + (t % 3);
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::ldmatrix_x4(a[i], halo + swz(pa[i] + off, qa));
      uint32_t bq[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) mma::ldmatrix_x4(bq[j], wts + swz(t * TN + nb[j], qb));
      if constexpr (kF32) {
        uint32_t bl[NT / 2][4];   // the weights' tf32 remainders
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          mma::ldmatrix_x4(bl[j], wts + Tl::kPlaneBytes + swz(t * TN + nb[j], qb));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ah[4], al[4];
          mma::split_tf32(a[i], ah, al);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int jp = j >> 1, e = (j & 1) * 2;
            mma::mma_tf32(st[i][j], al, bq[jp][e], bq[jp][e + 1]);
            mma::mma_tf32(st[i][j], ah, bl[jp][e], bl[jp][e + 1]);
            mma::mma_tf32(st[i][j], ah, bq[jp][e], bq[jp][e + 1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma::mma_bf16(acc[i][j], a[i], bq[j >> 1][(j & 1) * 2], bq[j >> 1][(j & 1) * 2 + 1]);
      }
    }

    if constexpr (kF32) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += st[i][j][e];
    }
    if (!kAsyncX && more) store_halo_regs(smem + slot_n * Tl::kStageBytes);
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // epilogue: float32 sums into shared memory [kM][kLdo] ...
  float* staged = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = wm * Tl::kWarpM + i * 16 + g;
      const int n = wn * Tl::kWarpN + j * 8 + tq * 2;
      *reinterpret_cast<float2*>(staged + m * Tl::kLdo + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(staged + (m + 8) * Tl::kLdo + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  // ... then 8 channels of one voxel per step: scale, bias, residual, ReLU
  // in float32, one rounding to x's type, 16-byte loads and stores where Co
  // allows them
  for (int e = threadIdx.x; e < Tl::kM * (TN / 8); e += kThreads) {
    const int m = e / (TN / 8), q = e % (TN / 8);
    const int y = h0 + (m >> 5), xw = w0 + (m & 31), co = co0 + q * 8;
    if (y >= H || xw >= W || co >= Co) continue;
    const size_t base = ((((size_t)b * D + d) * H + y) * W + xw) * Co + co;
    const float4 lo = *reinterpret_cast<const float4*>(staged + m * Tl::kLdo + q * 8);
    const float4 hi = *reinterpret_cast<const float4*>(staged + m * Tl::kLdo + q * 8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int nvalid = min(8, Co - co);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nvalid) v[k] = v[k] * __ldg(args.scale + co + k) + __ldg(args.bias + co + k);
    if (args.vec) {
      if (args.res != nullptr) add8(v, args.res + base);
      if (args.relu)
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.f);
      store8(args.out + base, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= nvalid) break;
        float o = v[k];
        if (args.res != nullptr) o += to_float(args.res[base + k]);
        if (args.relu) o = fmaxf(o, 0.f);
        from_float(args.out + base + k, o);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int TH, int TN, int WM, int WN>
int launch_tile(ConvArgs<T> args, int B, bool async_x, cudaStream_t stream) {
  using Tl = Tile<TH, TN, WM, WN, std::is_same<T, float>::value ? 2 : 1>;
  void (*kernel)(const ConvArgs<T>) = async_x
                                          ? &conv3d_fused_mma_kernel<T, TH, TN, WM, WN, true>
                                          : &conv3d_fused_mma_kernel<T, TH, TN, WM, WN, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (args.H + TH - 1) / TH;
  args.tiles_w = (args.W + 31) / 32;
  args.co_blocks = (args.Co + TN - 1) / TN;
  const dim3 grid(tiles_h * args.tiles_w, args.D, B * args.co_blocks);
  kernel<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(args);
  return (int)cudaGetLastError();
}

// tile: 0 = 128 voxels x 64 Co, 1 = 256 x 32, 2 = 256 x 16, 3 = 64 x 32
// (ops/conv3d_fused.py::MMA_TILES). bfloat16: 4 warps; float32: 8 warps of
// 32 voxels x 32 (16) channels, 4 on the 64 x 32 tile, so that a thread
// holds its stage sums beside its accumulators.
template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias, const void* res,
           void* out, int B, int D, int H, int W, int Ci, int Co, int ci_pad, int co_pad,
           int relu, int tile, void* stream) {
  constexpr int kChunk = 32 / sizeof(T);
  if (ci_pad % kChunk != 0 || ci_pad < Ci || co_pad % 64 != 0 || co_pad < Co ||
      !aligned16(w) || B < 1 || D < 1 || D > 65535 || H < 1 || W < 1 || Ci < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const T*>(res);
  a.out = static_cast<T*>(out);
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co, a.ci_pad = ci_pad, a.co_pad = co_pad;
  a.relu = relu;
  a.tiles_w = a.co_blocks = 0;
  a.vec = Co % 8 == 0 && aligned16(out) && (res == nullptr || aligned16(res));
  const bool async_x = Ci % (kChunk / 2) == 0 && aligned16(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    switch (tile) {
      case 0: return launch_tile<T, 4, 64, 4, 2>(a, B, async_x, s);
      case 1: return launch_tile<T, 8, 32, 8, 1>(a, B, async_x, s);
      case 2: return launch_tile<T, 8, 16, 8, 1>(a, B, async_x, s);
      case 3: return launch_tile<T, 2, 32, 4, 1>(a, B, async_x, s);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (tile) {
      case 0: return launch_tile<T, 4, 64, 2, 2>(a, B, async_x, s);
      case 1: return launch_tile<T, 8, 32, 4, 1>(a, B, async_x, s);
      case 2: return launch_tile<T, 8, 16, 4, 1>(a, B, async_x, s);
      case 3: return launch_tile<T, 2, 32, 4, 1>(a, B, async_x, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

extern "C" {

// bfloat16, mma.sync m16n8k16. w packed [27][co_pad][ci_pad] bf16 (ci_pad a
// multiple of 16); res may be null.
int conv3d_fused_mma(const void* x, const void* w, const void* scale, const void* bias,
                     const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
                     int ci_pad, int co_pad, int relu, int tile, void* stream) {
  return launch<bf16>(x, w, scale, bias, res, out, B, D, H, W, Ci, Co, ci_pad, co_pad, relu,
                      tile, stream);
}

// float32, 3xTF32 on mma.sync m16n8k8. w packed [2][27][co_pad][ci_pad]
// float32: the tf32 high parts, then the tf32 remainders (ci_pad a multiple
// of 8); res may be null.
int conv3d_fused_tf32x3(const void* x, const void* w, const void* scale, const void* bias,
                        const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
                        int ci_pad, int co_pad, int relu, int tile, void* stream) {
  return launch<float>(x, w, scale, bias, res, out, B, D, H, W, Ci, Co, ci_pad, co_pad, relu,
                       tile, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
