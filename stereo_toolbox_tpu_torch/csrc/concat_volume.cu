// Concatenation cost volume for Hopper, sm_90a (K6).
//
// Replaces stereo_toolbox_tpu/ops/pallas/volume.py::build_concat_volume_pallas
// (kernel body `_concat_kernel`), the volume of
// ops/volume.py::build_concat_volume, with the left half masked or not:
//
//   out[b, d, h, w, 0:C]  = left[b, h, w, :]       where w >= d or !mask_left,
//                                                  else 0
//   out[b, d, h, w, C:2C] = right[b, h, w - d, :]  where w >= d, else 0
//
// Layouts are channels-last: left/right [B, H, W, C], out [B, D, H, W, 2C],
// contiguous, float32 or bfloat16. With mask_left, planes with d >= W are all
// zero; without it (ACVNet, IGEV), only their right halves are.
//
// What bounds it: bytes. It is a copy: the output is 2 * D times the size of
// one input, and it is written once.
//
// Design: a grid-stride copy in which each thread stores one vector of the
// output, 16 bytes where C allows it (C a multiple of 4 in float32, of 8 in
// bfloat16), else 8, 4 or 2, so that no vector straddles the left and right
// halves. Consecutive threads store consecutive vectors; the reads of `left`
// and `right` repeat over d and are served by the L2 cache. The element type
// does not matter to a copy, so the kernel is typed by its vector alone.
//
// C interface (loaded with ctypes): concat_volume(...) launches on the given
// stream, allocates nothing, synchronises nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // 32 blocks for each of the 132 SMs

// cv: vectors of V in C channels.
template <typename V>
__global__ void __launch_bounds__(kThreads)
concat_volume_kernel(const V* __restrict__ left, const V* __restrict__ right,
                     V* __restrict__ out, int D, int H, int W, int cv, int mask_left,
                     long long total) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int v = (int)(i % (2 * cv));
    long long p = i / (2 * cv);  // voxel (b, d, h, w)
    const int w = (int)(p % W);
    p /= W;
    const int h = (int)(p % H);
    p /= H;
    const int d = (int)(p % D);
    const long long b = p / D;
    const long long px = (b * H + h) * W + w;  // pixel (b, h, w)
    V val = {};
    if (v < cv) {
      if (w >= d || !mask_left) val = left[px * cv + v];
    } else if (w >= d) {
      val = right[(px - d) * cv + v - cv];
    }
    out[i] = val;
  }
}

template <typename V>
int launch(const void* left, const void* right, void* out, int B, int H, int W, int cv,
           int D, int mask_left, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W * 2 * cv;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  concat_volume_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(left), static_cast<const V*>(right), static_cast<V*>(out), D, H,
      W, cv, mask_left, total);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; mask_left: 0 or 1. B * D * H * W must be
// positive.
int concat_volume(const void* left, const void* right, void* out, int B, int H, int W,
                  int C, int D, int mask_left, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)C * (dtype == 0 ? 4 : 2);  // bytes of one pixel's C
  for (size_t vb = 16; vb >= 2; vb /= 2) {
    if (row % vb || !aligned(left, vb) || !aligned(right, vb) || !aligned(out, vb)) continue;
    const int cv = (int)(row / vb);
    switch (vb) {
      case 16: return launch<uint4>(left, right, out, B, H, W, cv, D, mask_left, s);
      case 8: return launch<uint2>(left, right, out, B, H, W, cv, D, mask_left, s);
      case 4: return launch<unsigned int>(left, right, out, B, H, W, cv, D, mask_left, s);
      default: return launch<unsigned short>(left, right, out, B, H, W, cv, D, mask_left, s);
    }
  }
  return (int)cudaErrorMisalignedAddress;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
