// Plain 3x3x3 convolution (stride 1, zero padding 1, no bias) for Hopper,
// sm_90a (K3).
//
// Replaces stereo_toolbox_tpu/ops/pallas/conv3d.py::conv3d_pallas (kernel body
// `_kernel`).
//
//   out[b, d, h, w, o] = sum_{kd, kh, kw, c} x[b, d+kd-1, h+kh-1, w+kw-1, c]
//                                            * wgt[kd, kh, kw, c, o]
//
// x [B, D, H, W, Ci], out [B, D, H, W, Co] (channels-last, contiguous, float32
// or bfloat16); wgt [3, 3, 3, Ci, Co] in the same type. Outside the volume x
// reads as zero. Accumulation in float32; the output is stored in x's type.
//
// What bounds it: bytes, at the shapes that run it. Every launch in the
// forwards is a cost-volume classifier with Co = 1: 27 * Ci multiply-adds
// per output voxel against Ci input values read, so at (1, 48, 120, 160, 32 ->
// 1) the 121.6 MB moved (float32) take 0.036 ms at 3.35 TB/s and the 1.59
// GFLOP 0.024 ms at 67 TFLOP/s.
//
// Co = 1, the "stencil" design (conv3d_stencil). The taps are the product's
// N: for every input voxel p the 27 partials P[p, t] = sum_c x[p, c] * w[t, c]
// (a [voxels x Ci] x [Ci x 27 -> 32] product on the tensor cores), then
// out[q] = sum_t P[q + off(t), t], a 27-point stencil over the partials.
// Each input element enters one product once, and the stencil is 27
// shared-memory reads an output. A block owns an 8 x 32 H-W tile and walks
// a run of D planes: a ring of three cp.async stages brings each input
// plane of the tile and its halo in from device memory once (zero-filled
// off the volume), two planes ahead of the one computed, so a plane's
// products overlap the next planes' loads. The partials of the current
// plane go to shared memory as [tap][voxel] (row stride = 4 mod 32 words:
// the fragment stores and the stencil's reads are conflict-free), and each
// thread adds the 9 (kh, kw) taps of each kd at its voxel to the three
// output planes the input plane feeds (kept in registers), storing one
// finished output plane per input plane. The wrapper (ops/conv3d.py::
// stencil_run) picks the run length whose grid ends soonest when the
// card's block slots take the blocks in launch order (a run re-stages its
// two neighbour planes, and a short last run fills the last wave). The
// product (340 staged voxels -> 22 row tiles of 16)
// runs with mma.sync (csrc/mma.cuh), each warp its 3 row tiles together:
// bfloat16 m16n8k16, A the staged plane's rows through ldmatrix (16-byte
// chunks swizzled by row), B the weights [32 taps][Ci16] (taps 27..31
// zero); float32 3xTF32 m16n8k8 (each operand split into a tf32 high part
// and a tf32 remainder, hi*hi + hi*lo + lo*hi: about float32 accuracy,
// held to 1e-4 of the plain version; TF32 alone would not be; the weights'
// fragments are split once a block and stay in registers). The float32
// product as FMAs on the CUDA cores, tried first, was no faster. Row
// strides, chunk counts and swizzles are compile-time (from the K steps):
// runtime divisions in the staging and ldmatrix address math, and one row
// tile a warp at a time, had dominated the bfloat16 kernel's time.
//
// Co > 1, the "direct" design (conv3d_direct; no launch in any forward): a
// block owns an 8x32 H-W tile, 8 output channels and a run of output planes
// d. It walks the input planes z of that run once each (one halo plane more
// on each side), staging each plane's (tile + halo) slab 8 input channels at a
// time in shared memory, as float32, through registers, the next chunk's loads
// issued before the current chunk is computed. Plane z feeds output planes
// z+1, z and z-1 through kd = 0, 1, 2, so a thread keeps three rolling sets of
// accumulators in registers and stores plane z-1 once plane z has been added.
// A warp covers 32 columns, each thread R rows of one column; a float4 of 4
// channels read from shared memory (rows padded to 12 floats) feeds up to 3 kh
// x 3 kd accumulators, and each weight (a broadcast) feeds R rows. The run of
// planes is cut so that the grid has ~4 blocks for each SM.
//
// C interface (loaded with ctypes): conv3d_stencil(...) and conv3d_direct(...)
// launch on the given stream, allocate nothing, synchronise nothing and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileW = 32;         // one column per lane
constexpr int kCiChunk = 8;        // input channels staged per step
constexpr int kCs = 12;            // staged floats per pixel (8 used; no bank conflicts)
constexpr int kSw = kTileW + 2;    // staged columns (halo of 1 on each side)
constexpr long long kTargetBlocks = 4 * 132;

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

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ------------------------------------------------------------------ Co = 1
// The "stencil" design: products of every staged voxel with the 27 taps,
// then a 27-point stencil over the products.

constexpr int kSTH = 8;                          // output rows of a tile
constexpr int kSTW = 32;                         // output columns of a tile
constexpr int kSThreads = 256;                   // one output voxel a thread
constexpr int kHW = kSTW + 2;                    // staged columns (halo 1)
constexpr int kNPos = (kSTH + 2) * kHW;          // staged voxels of a plane: 340
constexpr int kPS = (kNPos - 4 + 31) / 32 * 32 + 4;  // product row stride, = 4 mod 32
constexpr int kMTiles = (kNPos + 15) / 16;       // 16-voxel row tiles of the product: 22
constexpr int kWarpTiles = (kMTiles + 7) / 8;    // row tiles a warp: 3
constexpr int kStages = 3;                       // staged planes: the current one, 2 in flight

// Shared memory of the stencil kernels (bytes): kStages staged planes, the
// products [27][kPS] in float32, the weights. ops/conv3d.py::stencil_smem
// computes the same.
template <typename T>
struct StencilSmem {
  // staged row (elements): float32 Ci rounded up to 8 (the tf32 mma's K),
  // + 4 (the 8 rows x 4 columns of a fragment load hit distinct banks);
  // bfloat16 Ci rounded up to 16 (the mma's K), rows swizzled by 16-byte
  // chunk for ldmatrix
  static __host__ __device__ int row(int ci) {
    return sizeof(T) == 4 ? (ci + 7) / 8 * 8 + 4 : (ci + 15) / 16 * 16;
  }
  // weights [32 taps][row] (taps 27..31 zero), rows as the staged ones
  static __host__ __device__ int wrow(int ci) { return row(ci); }
  static __host__ __device__ int plane_bytes(int ci) { return kNPos * row(ci) * (int)sizeof(T); }
  static __host__ __device__ int p_offset(int ci) { return kStages * plane_bytes(ci); }
  static __host__ __device__ int w_offset(int ci) { return p_offset(ci) + 27 * kPS * 4; }
  static __host__ __device__ int bytes(int ci) {
    return w_offset(ci) + 32 * wrow(ci) * (int)sizeof(T);
  }
};

// bfloat16 rows of `chunks` 16-byte chunks: chunk c of row r is stored at
// c ^ swz(r), so that the 8 rows an ldmatrix phase reads fall on 8 distinct
// bank groups (identity where the chunk count is not a power of two).
__device__ __forceinline__ int chunk_swz(int r, int chunks) {
  if (chunks & (chunks - 1)) return 0;
  return chunks >= 8 ? r % 8 : (r / (8 / chunks)) % chunks;
}

// Stages plane z of x (the tile's (kSTH + 2) x kHW voxels, zeros outside
// the volume and past Ci) into `buf`: 16-byte cp.async copies with `vec`,
// plain loads otherwise.
template <typename T, int KS>
__device__ __forceinline__ void stage_plane(T* buf, const T* __restrict__ plane, int h0, int w0,
                                            int H, int W, int Ci, bool vec) {
  constexpr int row = sizeof(T) == 4 ? 8 * KS + 4 : 16 * KS;   // StencilSmem<T>::row(Ci)
  constexpr int kEPC = 16 / (int)sizeof(T);
  constexpr int chunks = 2 * KS;   // 16-byte chunks a row reads (and bf16 swizzles)
  constexpr int rchunks = chunks;
  if (vec) {
    for (int i = threadIdx.x; i < kNPos * chunks; i += kSThreads) {
      const int p = i / chunks, c = i - p * chunks;
      const int gy = h0 + p / kHW - 1, gx = w0 + p % kHW - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c * kEPC < Ci;
      const T* src = plane + (ok ? ((size_t)gy * W + gx) * Ci + c * kEPC : 0);
      const int cs = sizeof(T) == 4 ? c : c ^ chunk_swz(p, rchunks);
      mma::cp_async16(mma::smem_addr(buf + p * row + cs * kEPC), src, ok);
    }
  } else {
    constexpr int n = chunks * kEPC;
    for (int i = threadIdx.x; i < kNPos * n; i += kSThreads) {
      const int p = i / n, e = i - p * n;
      const int gy = h0 + p / kHW - 1, gx = w0 + p % kHW - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && e < Ci;
      const int es = sizeof(T) == 4 ? e : (e / kEPC ^ chunk_swz(p, rchunks)) * kEPC + e % kEPC;
      buf[p * row + es] = ok ? plane[((size_t)gy * W + gx) * Ci + e] : T(0.f);
    }
  }
  mma::cp_async_commit();
}

// The product's C fragments to prod[tap][voxel], taps < 27, voxels <
// kNPos (row stride = 4 mod 32 words: a warp's stores hit 32 banks).
__device__ __forceinline__ void store_products(const float (&acc)[kWarpTiles][4][4],
                                               float* prod) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kWarpTiles; ++m) {
    const int mt = warp + 8 * m;
    if (mt >= kMTiles) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = mt * 16 + g + (i >> 1) * 8, tap = n * 8 + 2 * t + (i & 1);
        if (p < kNPos && tap < 27) prod[tap * kPS + p] = acc[m][n][i];
      }
  }
}

// The [kNPos x K] x [K x 32] product of one staged plane on the tensor cores,
// float32 sums to prod[tap][voxel] (taps < 27). A warp owns row tiles w,
// w + 8, w + 16 and runs them together, B loaded once a K step for all
// three. KS = K steps.
//
// bfloat16: m16n8k16, A through ldmatrix from the staged rows, B (the
// weights [32 taps][Ci16]) through ldmatrix.
template <int KS>
__device__ __forceinline__ void products_mma(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                             float* prod) {
  constexpr int row = 16 * KS;     // StencilSmem<__nv_bfloat16>::row(Ci)
  constexpr int chunks = 2 * KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3, mr = lane & 7;
  float acc[kWarpTiles][4][4];
#pragma unroll
  for (int m = 0; m < kWarpTiles; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[2][4];   // n tiles 0-1 and 2-3: (taps +0/+8, k lo/hi)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int br = np * 16 + mr + (mi >> 1) * 8, bc = 2 * ks + (mi & 1);
      mma::ldmatrix_x4(b[np], mma::smem_addr(ws + br * row + (bc ^ chunk_swz(br, chunks)) * 8));
    }
#pragma unroll
    for (int m = 0; m < kWarpTiles; ++m) {
      const int mt = warp + 8 * m;
      if (mt >= kMTiles) continue;
      // this lane's A row: matrices (rows +0/+8, k lo/hi)
      const int ar = min(mt * 16 + mr + (mi & 1) * 8, kNPos - 1);
      const int ac = 2 * ks + (mi >> 1);
      uint32_t a[4];
      mma::ldmatrix_x4(a, mma::smem_addr(xs + ar * row + (ac ^ chunk_swz(ar, chunks)) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma::mma_bf16(acc[m][2 * np], a, b[np][0], b[np][1]);
        mma::mma_bf16(acc[m][2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
  }
  store_products(acc, prod);
}

// float32: 3xTF32 m16n8k8 (each operand split into a tf32 high part and a
// tf32 remainder; hi*hi + hi*lo + lo*hi keeps about float32 accuracy, held
// to 1e-4 of the plain version), A fragments read from the staged float32
// rows with scalar loads; the weights' fragments, split once a block
// (tf32_weights), stay in registers.
template <int KS>
__device__ __forceinline__ void tf32_weights(const float* ws, uint32_t (&bh)[KS][4][2],
                                             uint32_t (&bl)[KS][4][2]) {
  constexpr int row = 8 * KS + 4;  // StencilSmem<float>::row(Ci)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = ws[(n * 8 + g) * row + ks * 8 + t + 4 * j];
        bh[ks][n][j] = mma::to_tf32(v);
        bl[ks][n][j] = mma::to_tf32(v - __uint_as_float(bh[ks][n][j]));
      }
}

template <int KS>
__device__ __forceinline__ void products_tf32(const float* xs, const uint32_t (&bh)[KS][4][2],
                                              const uint32_t (&bl)[KS][4][2], float* prod) {
  constexpr int row = 8 * KS + 4;  // StencilSmem<float>::row(Ci)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[kWarpTiles][4][4];
#pragma unroll
  for (int m = 0; m < kWarpTiles; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int m = 0; m < kWarpTiles; ++m) {
      const int mt = warp + 8 * m;
      if (mt >= kMTiles) continue;
      const int r0 = min(mt * 16 + g, kNPos - 1), r1 = min(mt * 16 + g + 8, kNPos - 1);
      const float av[4] = {xs[r0 * row + ks * 8 + t], xs[r1 * row + ks * 8 + t],
                           xs[r0 * row + ks * 8 + t + 4], xs[r1 * row + ks * 8 + t + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = mma::to_tf32(av[i]);
        al[i] = mma::to_tf32(av[i] - __uint_as_float(ah[i]));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mma::mma_tf32(acc[m][n], al, bh[ks][n][0], bh[ks][n][1]);
        mma::mma_tf32(acc[m][n], ah, bl[ks][n][0], bl[ks][n][1]);
        mma::mma_tf32(acc[m][n], ah, bh[ks][n][0], bh[ks][n][1]);
      }
    }
  }
  store_products(acc, prod);
}

// One block: a kSTH x kSTW H-W tile of one b and the run of output planes
// [d0, d0 + L). It walks the input planes z = d0 - 1 .. d0 + L (within the
// volume) once each: planes z + 1 and z + 2 are staged by cp.async while
// plane z's products are computed; then each thread adds the 9 (kh, kw) taps of each
// kd at its voxel to the three output planes z + 1, z and z - 1 that plane z
// feeds, kept in registers, and stores plane z - 1, now complete.
template <typename T, int KS>
__global__ void __launch_bounds__(kSThreads)
conv3d_stencil_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out,
                      int D, int H, int W, int Ci, int tiles_w, int L, int vec) {
  using Sm = StencilSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* planes = reinterpret_cast<T*>(smem_raw);
  float* prod = reinterpret_cast<float*>(smem_raw + Sm::p_offset(Ci));
  T* ws = reinterpret_cast<T*>(smem_raw + Sm::w_offset(Ci));
  const int plane_elems = kNPos * Sm::row(Ci);

  const int h0 = (blockIdx.x / tiles_w) * kSTH;
  const int w0 = (blockIdx.x % tiles_w) * kSTW;
  const int d0 = blockIdx.y * L, d1 = min(d0 + L, D);
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * D * H * W * Ci;

  // the weights, [32 taps][c] (zero past tap 27 and Ci; bfloat16 swizzled)
  {
    const int wrow = Sm::wrow(Ci);
    for (int i = threadIdx.x; i < 32 * wrow; i += blockDim.x) {
      const int tap = i / wrow, c = i - tap * wrow;
      const T v = tap < 27 && c < Ci ? wgt[(size_t)tap * Ci + c] : T(0.f);
      if constexpr (sizeof(T) == 4)
        ws[i] = v;
      else
        ws[tap * wrow + ((c / 8) ^ chunk_swz(tap, wrow / 8)) * 8 + c % 8] = v;
    }
  }

  // float32: the weights' tf32 fragments, split once, in registers
  uint32_t bh[KS][4][2], bl[KS][4][2];
  if constexpr (sizeof(T) == 4) {
    __syncthreads();
    tf32_weights<KS>(ws, bh, bl);
  }

  const int zlo = max(d0 - 1, 0), zhi = min(d1, D - 1);
  // a ring of kStages planes: kStages - 1 in flight while one is computed
  // (one group committed per plane, empty past the run, so that the wait
  // below counts planes)
  for (int i = 0; i < kStages - 1; ++i) {
    if (zlo + i <= zhi)
      stage_plane<T, KS>(planes + i * plane_elems, xb + (size_t)(zlo + i) * H * W * Ci, h0, w0, H, W,
                     Ci, vec);
    else
      mma::cp_async_commit();
  }
  const int ty = threadIdx.x / kSTW, tx = threadIdx.x % kSTW;
  const int oy = h0 + ty, ox = w0 + tx;
  const bool in = oy < H && ox < W;
  const size_t plane_out = (size_t)H * W;
  T* ob = out + (size_t)b * D * plane_out + (size_t)oy * W + ox;
  float prev = 0.f, cur = 0.f, next = 0.f;   // output planes z - 1, z, z + 1
  for (int z = zlo; z <= zhi; ++z) {
    const T* xs = planes + ((z - zlo) % kStages) * plane_elems;
    const int zn = z + kStages - 1;   // into the slot plane z - 1 took
    if (zn <= zhi)
      stage_plane<T, KS>(planes + ((zn - zlo) % kStages) * plane_elems,
                     xb + (size_t)zn * H * W * Ci, h0, w0, H, W, Ci, vec);
    else
      mma::cp_async_commit();
    mma::cp_async_wait<kStages - 1>();
    __syncthreads();   // plane z staged; the last plane's stencil is done
    if constexpr (sizeof(T) == 4)
      products_tf32<KS>(xs, bh, bl, prod);
    else
      products_mma<KS>(xs, ws, prod);
    __syncthreads();
    float v[3];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      float s = 0.f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          s += prod[(kd * 9 + kh * 3 + kw) * kPS + (ty + kh) * kHW + tx + kw];
      v[kd] = s;
    }
    next += v[0];
    cur += v[1];
    prev += v[2];
    if (in && z - 1 >= d0 && z - 1 < d1) ob[(size_t)(z - 1) * plane_out] = T(prev);
    prev = cur;
    cur = next;
    next = 0.f;
  }
  if (in && zhi < d1) ob[(size_t)zhi * plane_out] = T(prev);   // zhi = D - 1
}

template <typename T, int KS>
int launch_stencil(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci,
                   int L, cudaStream_t stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const int smem = StencilSmem<T>::bytes(Ci);
  // more than the card's 227 KB is refused here, and reported
  cudaError_t err = cudaFuncSetAttribute(conv3d_stencil_kernel<T, KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kEPC = 16 / (int)sizeof(T);
  const bool vec = Ci % kEPC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int tiles_w = (W + kSTW - 1) / kSTW;
  const dim3 grid(tiles_w * ((H + kSTH - 1) / kSTH), (D + L - 1) / L, B);
  conv3d_stencil_kernel<T, KS><<<grid, kSThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), D, H, W, Ci,
      tiles_w, L, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

// K steps of the product: bfloat16 Ci / 16, float32 Ci / 8 (Ci rounded up;
// Ci <= 64, ops/conv3d.py::STENCIL_MAX_CI).
template <typename T>
int stencil_by_ci(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci,
                  int L, cudaStream_t s) {
  const int ks = sizeof(T) == 4 ? (Ci + 7) / 8 : (Ci + 15) / 16;
  switch (ks) {
    case 1: return launch_stencil<T, 1>(x, w, out, B, D, H, W, Ci, L, s);
    case 2: return launch_stencil<T, 2>(x, w, out, B, D, H, W, Ci, L, s);
    case 3: return launch_stencil<T, 3>(x, w, out, B, D, H, W, Ci, L, s);
    case 4: return launch_stencil<T, 4>(x, w, out, B, D, H, W, Ci, L, s);
    default:
      if constexpr (sizeof(T) == 4) {
        switch (ks) {
          case 5: return launch_stencil<T, 5>(x, w, out, B, D, H, W, Ci, L, s);
          case 6: return launch_stencil<T, 6>(x, w, out, B, D, H, W, Ci, L, s);
          case 7: return launch_stencil<T, 7>(x, w, out, B, D, H, W, Ci, L, s);
          case 8: return launch_stencil<T, 8>(x, w, out, B, D, H, W, Ci, L, s);
        }
      }
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ Co > 1
// The "direct" design.

template <int CO_T, int R, int MASK>
__device__ __forceinline__ void accumulate(const float* in_s, const float* w_s, int ty, int tx,
                                           float (&acc)[3][R][CO_T]) {
#pragma unroll 1
  for (int c4 = 0; c4 < kCiChunk / 4; ++c4) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      float4 xv[R + 2];
#pragma unroll
      for (int y = 0; y < R + 2; ++y)
        xv[y] = *reinterpret_cast<const float4*>(in_s + ((ty * R + y) * kSw + tx + kw) * kCs +
                                                 4 * c4);
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if (!(MASK & (1 << kd))) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float* wp = w_s + (tap * kCiChunk + 4 * c4 + cc) * CO_T;
              float wv[CO_T];
#pragma unroll
              for (int o = 0; o < CO_T; o += 4) {
                const float4 t = *reinterpret_cast<const float4*>(wp + o);
                wv[o] = t.x;
                wv[o + 1] = t.y;
                wv[o + 2] = t.z;
                wv[o + 3] = t.w;
              }
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float v = part(xv[r + kh], cc);
#pragma unroll
                for (int o = 0; o < CO_T; ++o) acc[kd][r][o] = fmaf(v, wv[o], acc[kd][r][o]);
              }
            }
          }
        }
      }
    }
  }
}

// The staging of one chunk (8 input channels of one input plane, the tile
// and its halo, and the chunk's weights) through registers: `load` issues
// the chunk's global loads, `store` converts to float32 and writes shared
// memory. VEC loads 16 bytes (4 float32 or 8 bfloat16 channels) at a time
// (Ci a multiple of 8, x 16-byte aligned); otherwise one element at a time.
template <typename T, int CO_T, int R, bool VEC>
struct Stager {
  static constexpr int kPix = (kWarps * R + 2) * kSw;
  static constexpr int kPer = VEC ? 16 / (int)sizeof(T) : 1;  // channels per load
  static constexpr int kLoads = kCiChunk / kPer;               // loads per pixel
  static constexpr int kK = (kPix * kLoads + kThreads - 1) / kThreads;
  static constexpr int kWts = 27 * kCiChunk * CO_T;
  static constexpr int kKW = (kWts + kThreads - 1) / kThreads;
  using Item = typename std::conditional<VEC, uint4, float>::type;

  Item xr[kK];
  float wr[kKW];

  __device__ __forceinline__ void load(const T* __restrict__ plane, const T* __restrict__ wgt,
                                       int h0, int w0, int H, int W, int Ci, int Co, int c0,
                                       int co0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int p = i / kLoads, c = c0 + (i % kLoads) * kPer;
      const int gy = h0 + p / kSw - 1, gx = w0 + p % kSw - 1;
      const bool in = i < kPix * kLoads && gy >= 0 && gy < H && gx >= 0 && gx < W && c < Ci;
      const T* src = plane + ((size_t)gy * W + gx) * Ci + c;
      if constexpr (VEC) {
        xr[k] = in ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
      } else {
        xr[k] = in ? to_f(__ldg(src)) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kKW; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int o = i % CO_T, c = c0 + (i / CO_T) % kCiChunk, tap = i / (CO_T * kCiChunk);
      wr[k] = (i < kWts && c < Ci && co0 + o < Co)
                  ? to_f(__ldg(wgt + ((size_t)tap * Ci + c) * Co + co0 + o))
                  : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* in_s, float* w_s) const {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= kPix * kLoads) continue;
      float* dst = in_s + (i / kLoads) * kCs + (i % kLoads) * kPer;
      if constexpr (!VEC) {
        *dst = xr[k];
      } else if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<uint4*>(dst) = xr[k];
      } else {  // 8 bfloat16: each 32-bit word holds two, the first in its low half
        const uint4 u = xr[k];
        *reinterpret_cast<float4*>(dst) =
            make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                        __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                        __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    }
#pragma unroll
    for (int k = 0; k < kKW; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kWts) w_s[i] = wr[k];
    }
  }
};

template <typename T, int CO_T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out, int D,
              int H, int W, int Ci, int Co, int tiles_w, int dch, int co_tiles) {
  constexpr int kTileH = kWarps * R;
  __shared__ __align__(16) float in_s[(kTileH + 2) * kSw * kCs];  // [y][x][c]
  __shared__ __align__(16) float w_s[27 * kCiChunk * CO_T];      // [tap][c][o]

  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int d0 = blockIdx.y * dch;
  const int d1 = min(d0 + dch, D);
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * CO_T;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;

  // acc[kd]: the output plane z + 1 - kd while input plane z is added
  float acc[3][R][CO_T];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int o = 0; o < CO_T; ++o) acc[s][r][o] = 0.f;

  // The chunks, in order: input planes zlo..zhi, 8 channels at a time. The
  // next chunk's loads are in flight while the current one is computed.
  const int zlo = max(d0 - 1, 0), zhi = min(d1, D - 1);
  const int nc = (Ci + kCiChunk - 1) / kCiChunk;
  const int nchunks = (zhi - zlo + 1) * nc;
  const T* xb = x + (size_t)b * D * H * W * Ci;
  Stager<T, CO_T, R, VEC> st;
  if (nchunks > 0) st.load(xb + (size_t)zlo * H * W * Ci, wgt, h0, w0, H, W, Ci, Co, 0, co0);

  int n = 0;
  for (int z = d0 - 1; z <= d1; ++z) {
    const int mask = (z + 1 < d1 ? 1 : 0) | (z >= d0 && z < d1 ? 2 : 0) | (z - 1 >= d0 ? 4 : 0);
    if (z >= 0 && z < D) {
      for (int c = 0; c < nc; ++c, ++n) {
        __syncthreads();  // the previous chunk is no longer read
        st.store(in_s, w_s);
        __syncthreads();
        if (n + 1 < nchunks) {
          const int zn = zlo + (n + 1) / nc;
          st.load(xb + (size_t)zn * H * W * Ci, wgt, h0, w0, H, W, Ci, Co,
                  ((n + 1) % nc) * kCiChunk, co0);
        }
        switch (mask) {
          case 1: accumulate<CO_T, R, 1>(in_s, w_s, ty, tx, acc); break;
          case 2: accumulate<CO_T, R, 2>(in_s, w_s, ty, tx, acc); break;
          case 3: accumulate<CO_T, R, 3>(in_s, w_s, ty, tx, acc); break;
          case 4: accumulate<CO_T, R, 4>(in_s, w_s, ty, tx, acc); break;
          case 6: accumulate<CO_T, R, 6>(in_s, w_s, ty, tx, acc); break;
          default: accumulate<CO_T, R, 7>(in_s, w_s, ty, tx, acc); break;
        }
      }
    }
    if (z - 1 >= d0) {  // output plane z - 1 is complete
      const int d = z - 1;
      const int xo = w0 + tx;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int y = h0 + ty * R + r;
        if (y >= H || xo >= W) continue;
        const size_t base = ((((size_t)b * D + d) * H + y) * W + xo) * Co;
#pragma unroll
        for (int o = 0; o < CO_T; ++o)
          if (co0 + o < Co) out[base + co0 + o] = from_f<T>(acc[2][r][o]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int o = 0; o < CO_T; ++o) {
        acc[2][r][o] = acc[1][r][o];
        acc[1][r][o] = acc[0][r][o];
        acc[0][r][o] = 0.f;
      }
  }
}

template <typename T, int CO_T, int R>
int launch_direct(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci, int Co,
           cudaStream_t stream) {
  const bool vec = Ci % kCiChunk == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  constexpr int kTileH = kWarps * R;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int co_tiles = (Co + CO_T - 1) / CO_T;
  const long long plane_blocks = (long long)tiles_w * tiles_h * B * co_tiles;
  long long runs = (kTargetBlocks + plane_blocks - 1) / plane_blocks;
  if (runs > D) runs = D;
  const int dch = (int)((D + runs - 1) / runs);
  const dim3 grid(tiles_w * tiles_h, (D + dch - 1) / dch, B * co_tiles);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    conv3d_kernel<T, CO_T, R, true><<<grid, kThreads, 0, stream>>>(
        xt, wt, static_cast<T*>(out), D, H, W, Ci, Co, tiles_w, dch, co_tiles);
  else
    conv3d_kernel<T, CO_T, R, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, static_cast<T*>(out), D, H, W, Ci, Co, tiles_w, dch, co_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. B, D, H, W and Ci (at most 64) must be
// positive; L (output planes a block) from ops/conv3d.py::stencil_run.
int conv3d_stencil(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci,
                   int dtype, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stencil_by_ci<float>(x, w, out, B, D, H, W, Ci, L, s);
  if (dtype == 1) return stencil_by_ci<__nv_bfloat16>(x, w, out, B, D, H, W, Ci, L, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. B, D, H, W, Ci and Co must be positive.
int conv3d_direct(const void* x, const void* w, void* out, int B, int D, int H, int W, int Ci,
                  int Co, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_direct<float, 8, 2>(x, w, out, B, D, H, W, Ci, Co, s);
  if (dtype == 1) return launch_direct<__nv_bfloat16, 8, 2>(x, w, out, B, D, H, W, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
