// Fused 3x3x3 convolution + eval-mode BatchNorm affine (+ residual) (+ ReLU)
// for Hopper, sm_90a.
//
// Replaces stereo_toolbox_tpu/ops/pallas/conv3d_fused.py::conv3d_fused
// (kernel body `_kernel`).
//
//   out = relu?(conv3d_3x3x3_same(x, w) * scale + bias + residual?)
//
// x [B, D, H, W, Ci], residual and out [B, D, H, W, Co] (channels-last,
// contiguous); w packed as [27][Co_pad][Ci_pad] in x's type (tap = kd*9 +
// kh*3 + kw, Ci_pad a multiple of 16, Co_pad of 64, zero padding:
// ops/conv3d_fused.py::pack_conv3d_weight); scale, bias [Co] float32.
// Stride 1, zero padding 1. Accumulation in float32.
//
// What bounds it: operations. 2*27*Ci*Co multiply-adds per voxel against
// (Ci + Co) values moved; at the cost-volume shapes of GwcNet (Ci, Co >= 32)
// that is hundreds of operations per byte, above the card's ridge point.
//
// Two designs, one per type. Neither falls back to the other.
//
// bfloat16: an implicit GEMM on the tensor cores (conv3d_fused_mma). M = the
// output voxels of a block's tile at one (b, d): TH rows x 32 W; N = TN
// output channels; K = 3 kd x 9 (kh, kw) x Ci. The K loop walks (kd, 16
// input channels); a stage holds one z-plane of the input halo, [TH+2][34]
// pixels x 16 channels, and the chunk's 9 taps of weights, [9][TN][16], in a
// 3-stage cp.async ring. The 9 taps of a stage read A from the same halo at
// shifted pixel addresses, so each input element enters shared memory once
// per kd and not 27 times. 32-byte pixel (and weight) rows are stored as two
// 16-byte chunks, the chunk index XORed with bit 2 of the row, so the 8 rows
// an ldmatrix phase reads fall on 8 distinct 16-byte bank groups. 4 warps
// each own a (TH*32/WM) x (TN/WN) slice of the tile; mma.sync m16n8k16 with
// float32 accumulators. The epilogue stages the float32 sums through shared
// memory and applies scale, bias, residual and ReLU in float32 with 16-byte
// loads and stores, rounding once to bf16. Tiles (chosen by the wrapper,
// ops/conv3d_fused.py::mma_tile): 128 voxels x 64 Co, 256 x 32, 256 x 16,
// and 64 x 32 for grids under two waves. Ragged shapes: Ci not a multiple of
// 16 reads zero-filled lanes in its last chunk; where 16-byte copies of x
// cannot be aligned (Ci % 8 != 0) the halo is staged with plain predicated
// loads through registers, issued before the current stage's products and
// stored after them; Co past the tile's end has zero weights and masked
// stores; H, W ragged and D < 3 read zeros.
//
// float32: a direct convolution on the CUDA cores (conv3d_fused_simt). The
// float32 result is held to 1e-4 of the plain version with TF32 off, which
// TF32 tensor cores would not meet, so this is the float32 design and not a
// fallback. One block per (b, d, 4x32 H-W tile, 32 output channels); 128
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
// C interface (loaded with ctypes): conv3d_fused_mma(...) and
// conv3d_fused_simt(...) launch on the given stream, allocate nothing,
// synchronise nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ----------------------------------------------------------------- float32

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
// weights of one input channel, [27][kCoBlock], padded by 4 floats so that
// the staging stores of 8 channels x 4 outputs hit 32 banks
constexpr int kWStride = 27 * kCoBlock + 4;
constexpr int kWFloats = kCiChunk * kWStride;
constexpr size_t kSmemBytes = (size_t)(kInFloats + kWFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
conv3d_fused_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const float* __restrict__ res, float* __restrict__ out, int D, int H,
                    int W, int Ci, int Co, int ci_pad, int co_pad, int relu, int tiles_w,
                    int co_blocks) {
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;              // [kCiChunk][3][kHaloH][kRow]
  float* w_s = smem + kInFloats;   // [kCiChunk][kWStride]: [27][kCoBlock] used

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
        v = x[((((size_t)b * D + gz) * H + gy) * W + gx) * Ci + gc];
      in_s[((c * 3 + zz) * kHaloH + yy) * kRow + xx] = v;
    }
    // weights from the packed [27][co_pad][ci_pad] layout, input channel
    // fastest in the walk (8 contiguous floats a row), into [c][tap][o]
    for (int i = threadIdx.x; i < kCiChunk * 27 * kCoBlock; i += kThreads) {
      const int c = i % kCiChunk;
      const int p = i / kCiChunk;
      const int o = p % kCoBlock;
      const int tap = p / kCoBlock;
      const int gc = c0 + c, go = co0 + o;
      w_s[c * kWStride + tap * kCoBlock + o] =
          (gc < Ci && go < Co) ? wgt[((size_t)tap * co_pad + go) * ci_pad + gc] : 0.f;
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
          const float* wp = w_s + c * kWStride + (kz * 9 + ky * 3) * kCoBlock + cg * kCoThread;
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
      if (res != nullptr) v += res[base + co];
      if (relu) v = fmaxf(v, 0.f);
      out[base + co] = v;
    }
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kHaloW32 = 34;       // 32 W + 2 halo columns

// Shapes and shared-memory plan of one tile: TH rows x 32 W voxels, TN
// output channels, warps WM along the voxels x WN along the channels.
template <int TH, int TN, int WM, int WN>
struct Tile {
  static constexpr int kM = TH * 32;
  static constexpr int kWarpM = kM / WM, kWarpN = TN / WN;
  static constexpr int MT = kWarpM / 16, NT = kWarpN / 8;   // m16 and n8 tiles a warp
  static constexpr int kHaloPix = (TH + 2) * kHaloW32;
  static constexpr int kHaloChunks = kHaloPix * 2;          // 16-byte chunks
  static constexpr int kHaloPerThread = (kHaloChunks + kMmaThreads - 1) / kMmaThreads;
  static constexpr int kHaloBytes = kHaloPix * 32;
  static constexpr int kWBytes = 9 * TN * 32;
  static constexpr int kStageBytes = kHaloBytes + kWBytes;
  static constexpr int kStages = 3;
  static constexpr int kLdo = TN + 8;                       // staged output row, floats
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = kM * kLdo * 4;
  static constexpr int kSmem = kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  static_assert(WM * WN == 4, "4 warps");
  static_assert(kWarpM % 16 == 0 && MT >= 1 && NT % 2 == 0, "warp tile");
  static_assert(kHaloBytes % 128 == 0 && kStageBytes % 128 == 0, "alignment");
};

// byte offset of 16-byte chunk q (0, 1) of 32-byte row r, swizzled
__device__ __forceinline__ int swz(int r, int q) { return r * 32 + ((q ^ ((r >> 2) & 1)) << 4); }

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  const float* scale;
  const float* bias;
  const bf16* res;
  bf16* out;
  int D, H, W, Ci, Co, ci_pad, co_pad, relu, tiles_w, co_blocks, vec;
};

template <int TH, int TN, int WM, int WN, bool kAsyncX>
__global__ void __launch_bounds__(kMmaThreads)
conv3d_fused_mma_kernel(const ConvArgs args) {
  using T = Tile<TH, TN, WM, WN>;
  constexpr int MT = T::MT, NT = T::NT;
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
  const int nchunks = args.ci_pad / 16;
  const int nstages = 3 * nchunks;   // (kd, 16-channel chunk)

  // halo pixel (r, c) of this stage: input (d + kd - 1, h0 + r - 1, w0 + c - 1)
  auto halo_src = [&](int s, int i, bool& ok) -> const bf16* {
    const int kd = s / nchunks;
    const int gc = (s - kd * nchunks) * 16 + (i & 1) * 8;
    const int p = i >> 1;
    const int yy = p / kHaloW32, xx = p - yy * kHaloW32;
    const int gz = d + kd - 1, gy = h0 - 1 + yy, gx = w0 - 1 + xx;
    ok = gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Ci;
    return ok ? args.x + ((((size_t)b * D + gz) * H + gy) * W + gx) * Ci + gc : args.x;
  };
  auto load_weights = [&](int s, uint32_t dst) {
    const int kd = s / nchunks;
    const int c0 = (s - kd * nchunks) * 16;
    for (int i = threadIdx.x; i < 9 * TN * 2; i += kMmaThreads) {
      const int r = i >> 1;               // tap * TN + n
      const int t = r / TN, n = r - t * TN;
      const bf16* src =
          args.w + ((size_t)(kd * 9 + t) * args.co_pad + co0 + n) * args.ci_pad + c0 + (i & 1) * 8;
      mma::cp_async16(dst + swz(r, i & 1), src, true);
    }
  };
  auto load_halo_async = [&](int s, uint32_t dst) {
    for (int i = threadIdx.x; i < T::kHaloChunks; i += kMmaThreads) {
      bool ok;
      const bf16* src = halo_src(s, i, ok);
      mma::cp_async16(dst + swz(i >> 1, i & 1), src, ok);
    }
  };
  // plain loads (x rows not 16-byte aligned): 8 predicated 2-byte loads a chunk
  uint4 held[T::kHaloPerThread];
  auto load_halo_regs = [&](int s) {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(args.x);
#pragma unroll
    for (int k = 0; k < T::kHaloPerThread; ++k) {
      const int i = threadIdx.x + k * kMmaThreads;
      uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (i < T::kHaloChunks) {
        bool ok;
        const bf16* src = halo_src(s, i, ok);
        if (ok) {
          const unsigned short* p = xs + (src - args.x);
          const int left = Ci - ((s % nchunks) * 16 + (i & 1) * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = j < left ? p[j] : 0u;
        }
      }
      held[k] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                           e[6] | (e[7] << 16));
    }
  };
  auto store_halo_regs = [&](unsigned char* dst) {
#pragma unroll
    for (int k = 0; k < T::kHaloPerThread; ++k) {
      const int i = threadIdx.x + k * kMmaThreads;
      if (i < T::kHaloChunks) *reinterpret_cast<uint4*>(dst + swz(i >> 1, i & 1)) = held[k];
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
    const int m = wm * T::kWarpM + i * 16 + (lane & 15);
    pa[i] = (m >> 5) * kHaloW32 + (m & 31);
  }
  const int qa = lane >> 4;
  int nb[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) nb[j] = wn * T::kWarpN + j * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int qb = (lane >> 3) & 1;

  // prologue: stages 0 and 1
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < nstages) {
      const uint32_t dst = smem0 + s * T::kStageBytes;
      load_weights(s, dst + T::kHaloBytes);
      if (kAsyncX) {
        load_halo_async(s, dst);
      } else {
        load_halo_regs(s);
        store_halo_regs(smem + s * T::kStageBytes);
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
      load_weights(sn, smem0 + slot_n * T::kStageBytes + T::kHaloBytes);
      if (kAsyncX)
        load_halo_async(sn, smem0 + slot_n * T::kStageBytes);
      else
        load_halo_regs(sn);
    }
    mma::cp_async_commit();

    const uint32_t halo = smem0 + (s % 3) * T::kStageBytes;
    const uint32_t wts = halo + T::kHaloBytes;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * kHaloW32 + (t % 3);
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::ldmatrix_x4(a[i], halo + swz(pa[i] + off, qa));
      uint32_t bq[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) mma::ldmatrix_x4(bq[j], wts + swz(t * TN + nb[j], qb));
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma::mma_bf16(acc[i][j], a[i], bq[j >> 1][(j & 1) * 2], bq[j >> 1][(j & 1) * 2 + 1]);
    }

    if (!kAsyncX && more) store_halo_regs(smem + slot_n * T::kStageBytes);
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
      const int m = wm * T::kWarpM + i * 16 + g;
      const int n = wn * T::kWarpN + j * 8 + tq * 2;
      *reinterpret_cast<float2*>(staged + m * T::kLdo + n) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(staged + (m + 8) * T::kLdo + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  // ... then 8 channels of one voxel per step: scale, bias, residual, ReLU
  // in float32, one rounding to bf16, 16-byte loads and stores where Co
  // allows them
  for (int e = threadIdx.x; e < T::kM * (TN / 8); e += kMmaThreads) {
    const int m = e / (TN / 8), q = e % (TN / 8);
    const int y = h0 + (m >> 5), xw = w0 + (m & 31), co = co0 + q * 8;
    if (y >= H || xw >= W || co >= Co) continue;
    const size_t base = ((((size_t)b * D + d) * H + y) * W + xw) * Co + co;
    const float4 lo = *reinterpret_cast<const float4*>(staged + m * T::kLdo + q * 8);
    const float4 hi = *reinterpret_cast<const float4*>(staged + m * T::kLdo + q * 8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int nvalid = min(8, Co - co);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nvalid) v[k] = v[k] * __ldg(args.scale + co + k) + __ldg(args.bias + co + k);
    if (args.vec) {
      if (args.res != nullptr) {
        const uint4 r = *reinterpret_cast<const uint4*>(args.res + base);
        const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[k]));
          v[2 * k] += f.x;
          v[2 * k + 1] += f.y;
        }
      }
      if (args.relu)
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.f);
      *reinterpret_cast<uint4*>(args.out + base) =
          make_uint4(mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]),
                     mma::pack_bf16(v[4], v[5]), mma::pack_bf16(v[6], v[7]));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= nvalid) break;
        float o = v[k];
        if (args.res != nullptr) o += __bfloat162float(args.res[base + k]);
        if (args.relu) o = fmaxf(o, 0.f);
        args.out[base + k] = __float2bfloat16(o);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int TH, int TN, int WM, int WN>
int launch_mma(ConvArgs args, int B, bool async_x, cudaStream_t stream) {
  using T = Tile<TH, TN, WM, WN>;
  void (*kernel)(const ConvArgs) = async_x ? &conv3d_fused_mma_kernel<TH, TN, WM, WN, true>
                                           : &conv3d_fused_mma_kernel<TH, TN, WM, WN, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (args.H + TH - 1) / TH;
  args.tiles_w = (args.W + 31) / 32;
  args.co_blocks = (args.Co + TN - 1) / TN;
  const dim3 grid(tiles_h * args.tiles_w, args.D, B * args.co_blocks);
  kernel<<<grid, kMmaThreads, T::kSmem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16, tensor cores. w packed [27][co_pad][ci_pad]; res may be null.
// tile: 0 = 128 voxels x 64 Co, 1 = 256 x 32, 2 = 256 x 16, 3 = 64 x 32
// (ops/conv3d_fused.py::MMA_TILES).
int conv3d_fused_mma(const void* x, const void* w, const void* scale, const void* bias,
                     const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
                     int ci_pad, int co_pad, int relu, int tile, void* stream) {
  if (ci_pad % 16 != 0 || ci_pad < Ci || co_pad % 64 != 0 || co_pad < Co || !aligned16(w) ||
      B < 1 || D < 1 || D > 65535 || H < 1 || W < 1 || Ci < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.out = static_cast<bf16*>(out);
  a.D = D, a.H = H, a.W = W, a.Ci = Ci, a.Co = Co, a.ci_pad = ci_pad, a.co_pad = co_pad;
  a.relu = relu;
  a.tiles_w = a.co_blocks = 0;
  a.vec = Co % 8 == 0 && aligned16(out) && (res == nullptr || aligned16(res));
  const bool async_x = Ci % 8 == 0 && aligned16(x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_mma<4, 64, 2, 2>(a, B, async_x, s);
    case 1: return launch_mma<8, 32, 4, 1>(a, B, async_x, s);
    case 2: return launch_mma<8, 16, 4, 1>(a, B, async_x, s);
    case 3: return launch_mma<2, 32, 4, 1>(a, B, async_x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32, CUDA cores. w packed [27][co_pad][ci_pad]; res may be null.
int conv3d_fused_simt(const void* x, const void* w, const void* scale, const void* bias,
                      const void* res, void* out, int B, int D, int H, int W, int Ci, int Co,
                      int ci_pad, int co_pad, int relu, void* stream) {
  if (ci_pad < Ci || co_pad < Co) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3d_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int co_blocks = (Co + kCoBlock - 1) / kCoBlock;
  const dim3 grid(tiles_h * tiles_w, D, B * co_blocks);
  conv3d_fused_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), D, H, W, Ci, Co, ci_pad, co_pad,
      relu, tiles_w, co_blocks);
  return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
