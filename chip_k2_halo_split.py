"""Where the float32 K2 kernel splits its input halo into TF32 parts, timed
on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_k2_halo_split.py

The float32 design of ``stereo_toolbox_tpu_torch/csrc/conv3d_fused.cu``
("tf32x3") splits each A fragment of the halo into its TF32 high part and
remainder in registers, after every ldmatrix: each halo element is split
at each of the 9 (kh, kw) taps that read it. The alternative splits each
landed halo plane once, in place in shared memory, into a high plane and a
remainder plane (one more barrier a stage, twice the A fragment loads, no
splitting in the tap loop). This script writes that variant from the
kernel's own source (text edits that must each match once, so it fails
rather than measure something else after the kernel changes), builds both
with the port's nvcc flags, checks both against the plain version (1e-4 x
max|ref|) and times both at every K2 launch shape of the five stereo
forwards (``chip_smoke.MIXES``) on the tile the plan picks, in the order
kernel, variant, variant, kernel. It prints per-shape and per-mix times and
exits non-zero if either build or check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.exit("chip_k2_halo_split: torch.cuda.is_available() is false; this "
             "script needs an NVIDIA GPU")

import chip_smoke  # noqa: E402
from stereo_toolbox_tpu_torch.ops import _cuda  # noqa: E402
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (  # noqa: E402
    MMA_TILES, conv3d_fused_reference, mma_tile, pack_conv3d_weight)

# (old, new) edits from the kernel to the variant
EDITS = [
    ("  static constexpr int kStageBytes = kHaloBytes + kWBytes;",
     "  static constexpr int kHaloLoBytes = kPlanes == 2 ? kHaloBytes : 0;\n"
     "  static constexpr int kStageBytes = kHaloBytes + kHaloLoBytes + "
     "kWBytes;"),
    ("      load_weights(s, dst + Tl::kHaloBytes);",
     "      load_weights(s, dst + Tl::kHaloBytes + Tl::kHaloLoBytes);"),
    ("      load_weights(sn, smem0 + slot_n * Tl::kStageBytes + "
     "Tl::kHaloBytes);",
     "      load_weights(sn, smem0 + slot_n * Tl::kStageBytes + "
     "Tl::kHaloBytes + Tl::kHaloLoBytes);"),
    ("    const uint32_t wts = halo + Tl::kHaloBytes;\n",
     "    const uint32_t halo_lo = halo + Tl::kHaloBytes;\n"
     "    const uint32_t wts = halo_lo + Tl::kHaloLoBytes;\n"
     "    if constexpr (kF32) {\n"
     "      float* hp = reinterpret_cast<float*>(smem + (s % 3) * "
     "Tl::kStageBytes);\n"
     "      float* lp = hp + Tl::kHaloBytes / 4;\n"
     "      for (int i = threadIdx.x; i < Tl::kHaloBytes / 4; "
     "i += kThreads) {\n"
     "        const float v = hp[i];\n"
     "        const float h = __uint_as_float(mma::to_tf32(v));\n"
     "        hp[i] = h;\n"
     "        lp[i] = __uint_as_float(mma::to_tf32(v - h));\n"
     "      }\n"
     "      __syncthreads();\n"
     "    }\n"),
    ("          uint32_t ah[4], al[4];\n"
     "          mma::split_tf32(a[i], ah, al);\n",
     "          uint32_t al[4];\n"
     "          const uint32_t (&ah)[4] = a[i];\n"
     "          mma::ldmatrix_x4(al, halo_lo + swz(pa[i] + off, qa));\n"),
]


def variant_source(src: str) -> str:
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has, once: {old!r}")
        src = src.replace(old, new)
    return src


def build() -> dict:
    """The kernel's library and the variant's, built side by side (under
    the port's build directory)."""
    out = _cuda.BUILD_DIR / "halo_split"
    out.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "conv3d_fused.cu").read_text()
    sources = {"registers": src, "shared": variant_source(src)}
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o",
             str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} split:\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).conv3d_fused_tf32x3
        fn.argtypes = _cuda.SIGNATURES["conv3d_fused"]["conv3d_fused_tf32x3"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    fns = build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    shapes = {}
    for model, mixes in chip_smoke.MIXES.items():
        for key, n in mixes.get("K2", {}).items():
            shapes.setdefault(key, {})[model] = n
    times = {}
    for key in sorted(shapes):
        b, d, h, w, ci, co, res, relu = key
        x, k, scale, bias, r = chip_smoke.k2_inputs(ci, co, d, h, w, res,
                                                    torch.float32, gen, b)
        packed = pack_conv3d_weight(k)
        tile = mma_tile(b, d, h, w, co, sms, torch.float32)
        want = conv3d_fused_reference(x, k, scale, bias, r, relu)
        out = torch.empty_like(want)
        calls = {}
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(x.data_ptr(), packed.split.data_ptr(),
                        scale.data_ptr(), bias.data_ptr(),
                        None if r is None else r.data_ptr(), out.data_ptr(),
                        b, d, h, w, ci, co, packed.data.shape[2],
                        packed.data.shape[1], int(relu), tile,
                        _cuda.stream_of(x))
                if rc != 0:
                    raise RuntimeError(f"launch failed: {rc}")
            call()
            err = (out - want).abs().max().item()
            chip_smoke.require(err <= 1e-4 * want.abs().max().item(),
                               f"{name} split at {key}: max|err| {err}")
            calls[name] = call
        ms = {name: [] for name in fns}
        for name in ("registers", "shared", "shared", "registers"):
            ms[name].append(chip_smoke.device_ms(calls[name], 5))
        times[key] = {name: min(v) for name, v in ms.items()}
        rows, n = MMA_TILES[tile]
        print(f"{key} tile {rows * 32}x{n} {shapes[key]}: " + ", ".join(
            f"{name} {v[0]:.4f} / {v[1]:.4f} ms" for name, v in ms.items()),
            flush=True)
    for model, mixes in chip_smoke.MIXES.items():
        mix = mixes.get("K2")
        if mix:
            total = {name: sum(c * times[key][name] for key, c in mix.items())
                     for name in fns}
            print(f"{model} mix: " + ", ".join(
                f"halo split in {name} {t:.3f} ms" for name, t in
                total.items()))


if __name__ == "__main__":
    main()
