"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. require CUDA; print the card and its power limit (nvidia-smi);
2. build the CUDA kernels from ``stereo_toolbox_tpu_torch/csrc`` (nvcc);
3. hold the gwc-volume kernel against its plain PyTorch version;
4. hold the fused 3x3x3 conv kernel against its plain PyTorch version;
5. GwcNet_G (max_disp 192, seeded random weights, settled and perturbed
   BatchNorm statistics): the card against the port's CPU paths at 256x512,
   then the slice's 480x640 forward in float32 and bfloat16, with the launch
   counts of both kernels read around each forward;
6. time the whole forward and each of its stages with CUDA events recorded
   at the stage boundaries (one timed pass), sum the device time of each
   kernel family over a ``torch.profiler`` trace of the same forward, and
   time each kernel, its plain version and the library yardstick at the
   shapes and launch counts that the 480x640 forward of phase 5 recorded;
7. print one ``{"forward": {...}}`` line and one ``{"kernels": [...]}`` line;
8. print ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter, defaultdict

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
             "needs an NVIDIA GPU")

from stereo_toolbox_tpu_torch.models import create_model  # noqa: E402
from stereo_toolbox_tpu_torch.nn.layers import ConvBNAct  # noqa: E402
from stereo_toolbox_tpu_torch.ops import _cuda  # noqa: E402
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (  # noqa: E402
    conv3d_fused, conv3d_fused_reference)
from stereo_toolbox_tpu_torch.ops.volume import (  # noqa: E402
    build_gwc_volume, gwc_volume_reference)

DEV = torch.device("cuda")
MAX_DISP = 192
H, W = 480, 640
CHECK_H, CHECK_W = 256, 512                    # card vs CPU comparison
F32, BF16 = torch.float32, torch.bfloat16
DTYPE_NAME = {F32: "float32", BF16: "bfloat16"}

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W):
# memory bytes/s, float32 FLOP/s outside the tensor cores, bfloat16 FLOP/s
PEAK = (3.35e12, 67e12, 989e12)

# Launches expected in one GwcNet_G eval forward at 480x640, max_disp 192
# (1/4-res volume 48x120x160), keyed as the wrappers count them. Phase 5
# requires the forward's counts to equal these; phase 6 weights its times by
# the counts the forward recorded.
# K1: (B, H, W, C, D, G)
K1_MIX = {(1, 120, 160, 320, 48, 40): 1}
# K2: (B, D, H, W, Ci, Co, residual, relu)
K2_MIX = {
    (1, 48, 120, 160, 40, 32, False, True): 1,   # dres0[0]
    (1, 48, 120, 160, 32, 32, False, True): 3,   # dres0[1], dres1[0], classif3
    (1, 48, 120, 160, 32, 32, True, False): 1,   # dres1[1] (+ cost0)
    (1, 24, 60, 80, 64, 64, False, True): 3,     # hourglass conv2 x3
    (1, 12, 30, 40, 128, 128, False, True): 3,   # hourglass conv4 x3
}

# Stages of the forward, as (stage, first module, last module, label of the
# work between the previous stage and this one)
STAGES = [
    ("2D trunk", "feature_extraction", "feature_extraction",
     "input cast + view batching"),
    ("dres0", "dres0", "dres0", "cost volume (K1)"),
    ("dres1", "dres1.0", "dres1.2", "glue"),
    ("dres2", "dres2", "dres2", "glue"),
    ("dres3", "dres3", "dres3", "glue"),
    ("dres4", "dres4", "dres4", "glue"),
    ("classif3", "classif3.0", "classif3.2", "glue"),
]
HEAD = "head (upsample, softmax, regression)"
GAP = "between forwards (host)"
FWD_ITERS, FWD_WARMUP = 10, 3


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts() -> None:
    for fn in (build_gwc_volume, conv3d_fused):
        fn.launches = 0
        fn.shapes.clear()


def randn(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(DEV, dtype)


# ---------------------------------------------------------------- phase 3
def check_gwc(gen) -> dict:
    errs = {}
    cases = [*K1_MIX, (2, 5, 37, 48, 48, 16)]   # ragged: W % 16, W < D, C/G=3
    for dtype in (F32, BF16):
        worst = 0.0
        for b, h, w, c, d, g in cases:
            left = randn((b, h, w, c), dtype, gen)
            right = randn((b, h, w, c), dtype, gen)
            got = build_gwc_volume(left, right, d, g).float()
            want = gwc_volume_reference(left.float(), right.float(), d, g)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ref = want.abs().max().item()
            tol = (1e-5 if dtype == F32 else 1e-2) * ref
            print(f"  gwc_volume {DTYPE_NAME[dtype]} {(b, h, w, c)} D={d} "
                  f"G={g}: max|err| {err:.3e} (tol {tol:.3e})")
            require(err <= tol, f"gwc_volume {dtype} {(b, h, w, c)}")
            if (b, h, w, c, d, g) in K1_MIX:
                worst = max(worst, err)
        errs[dtype] = (worst, 1e-5 if dtype == F32 else 1e-2)
    return errs


# ---------------------------------------------------------------- phase 4
def k2_inputs(ci, co, d, h, w, residual, dtype, gen, b=1):
    x = randn((b, d, h, w, ci), dtype, gen)
    k = randn((3, 3, 3, ci, co), dtype, gen, (2.0 / (27 * ci)) ** 0.5)
    scale = (torch.rand(co, generator=gen) + 0.5).to(DEV)
    bias = randn((co,), F32, gen)
    res = randn((b, d, h, w, co), dtype, gen) if residual else None
    return x, k, scale, bias, res


def check_conv(gen) -> dict:
    """Every launch shape of the forward, each of its four volume shapes
    also with both epilogue options on and off, and a ragged case."""
    errs = {}
    cases = dict.fromkeys(K2_MIX)
    for key in K2_MIX:
        for res, relu in ((False, False), (True, True)):
            cases[key[:6] + (res, relu)] = None
    cases[(2, 5, 7, 19, 12, 40, True, True)] = None  # ragged tiles, chunks
    for dtype in (F32, BF16):
        worst = 0.0
        for b, d, h, w, ci, co, res, relu in cases:
            x, k, scale, bias, r = k2_inputs(ci, co, d, h, w, res, dtype, gen,
                                             b)
            got = conv3d_fused(x, k, scale, bias, r, relu).float()
            want = conv3d_fused_reference(
                x.float(), k.float(), scale, bias,
                None if r is None else r.float(), relu)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ref = want.abs().max().item()
            rel = 1e-4 if dtype == F32 else 2e-2
            print(f"  conv3d_fused {DTYPE_NAME[dtype]} Ci={ci} Co={co} "
                  f"{(b, d, h, w)} res={res} relu={relu}: max|err| "
                  f"{err:.3e} (tol {rel * ref:.3e})")
            require(err <= rel * ref, f"conv3d_fused {dtype} {ci}->{co}")
            worst = max(worst, err)
        errs[dtype] = (worst, 1e-4 if dtype == F32 else 2e-2)
    return errs


# ---------------------------------------------------------------- phase 5
def stereo_pair(b, h, w, seed, shift=24):
    """ImageNet-normalised [B, H, W, 3] pair with a constant disparity."""
    gen = torch.Generator().manual_seed(seed)
    wide = w + 2 * shift
    base = torch.rand(b, 3, h // 8, wide // 8, generator=gen)
    tex = F.interpolate(base, size=(h, wide), mode="bilinear",
                        align_corners=False)
    tex = tex + 0.1 * torch.rand(b, 3, h, wide, generator=gen)
    left, right = tex[..., shift:shift + w], tex[..., 2 * shift:]
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    return [((t - mean) / std).permute(0, 2, 3, 1).contiguous()
            for t in (left, right)]


def settle_and_perturb_bn(model, left, right, gen) -> None:
    """Running statistics = one pass's batch statistics (so the random
    stack keeps O(1) activations), then perturbed by 0.1·|N(0, 1)|."""
    bns = [m for m in model.modules()
           if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None              # cumulative: first batch is exact
    for m in model.modules():
        if isinstance(m, ConvBNAct) or m in bns:
            m.train()                  # conv → batch-stat BN; model stays eval
    with torch.no_grad():
        model(left, right)
    model.eval()
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.1
            for buf in (m.running_mean, m.running_var):
                buf += 0.1 * torch.randn(buf.shape, generator=gen).abs().to(
                    buf.device)


def forward_counted(model, left, right, mix=None):
    """One forward with the counts set to 0 just before it; returns the
    output and the launches by shape of each kernel. With `mix`, requires
    the launches to be exactly K1_MIX and K2_MIX."""
    reset_counts()
    with torch.no_grad():
        out = model(left, right)
    torch.cuda.synchronize()
    counts = (build_gwc_volume.launches, conv3d_fused.launches)
    shapes = (Counter(build_gwc_volume.shapes), Counter(conv3d_fused.shapes))
    require(counts == (1, 11), f"launches per forward {counts} != (1, 11)")
    if mix:
        require(shapes == (Counter(K1_MIX), Counter(K2_MIX)),
                f"launches by shape {shapes} differ from K1_MIX, K2_MIX")
    return out, shapes


def check_model(gen):
    model = create_model("GwcNet_G", max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    l_small, r_small = stereo_pair(1, CHECK_H, CHECK_W, seed=1)
    settle_and_perturb_bn(model, l_small.to(DEV), r_small.to(DEV), gen)

    cpu = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    cpu.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(l_small, r_small)
    print(f"  CPU reference forward at {CHECK_H}x{CHECK_W}: "
          f"{time.perf_counter() - t0:.1f} s")
    got, _ = forward_counted(model, l_small.to(DEV), r_small.to(DEV))
    d = (got.cpu() - want).abs()
    print(f"  GwcNet_G {CHECK_H}x{CHECK_W} f32, card vs CPU: mean |d| "
          f"{d.mean().item():.3e} px, max {d.max().item():.3e} px "
          f"(disparity range {want.min().item():.2f}..{want.max().item():.2f})")
    require(d.mean().item() < 5e-3 and d.max().item() < 0.1,
            "GwcNet_G card output differs from the CPU port")

    runs = {}
    for dtype in (F32, BF16):
        m = model if dtype == F32 else create_model(
            "GwcNet_G", max_disp=MAX_DISP).to(dtype)
        if dtype != F32:
            m.load_state_dict(model.state_dict())
        for seed in (2, 3):
            left, right = (t.to(DEV, dtype) for t in stereo_pair(1, H, W,
                                                                 seed))
            out, shapes = forward_counted(m, left, right, mix=True)
            require(out.shape == (1, H, W), f"output shape {out.shape}")
            require(bool(torch.isfinite(out).all()), "non-finite output")
            lo, hi = out.min().item(), out.max().item()
            require(0 <= lo and hi < MAX_DISP, f"output range {lo}..{hi}")
            print(f"  GwcNet_G {H}x{W} {DTYPE_NAME[dtype]} pair {seed}: "
                  f"disparity {lo:.2f}..{hi:.2f}, mean {out.mean().item():.2f}"
                  f", launches gwc_volume={shapes[0].total()} "
                  f"conv3d_fused={shapes[1].total()}")
        runs[dtype] = (m, left, right, shapes)
    return runs


# ---------------------------------------------------------------- phase 6
def forward_breakdown(model, left, right) -> dict:
    """Forward ms, peak memory and ms per stage, from CUDA events that hooks
    record on the stream at the stage boundaries: FWD_ITERS forwards after
    FWD_WARMUP. The stages, with the gaps between forwards, add up to the
    forward's time."""
    marks: list = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hooks = [model.register_forward_pre_hook(lambda *a: mark(GAP)),
             model.register_forward_hook(lambda *a: mark(HEAD))]
    for stage, first, last, before in STAGES:
        hooks.append(model.get_submodule(first).register_forward_pre_hook(
            lambda *a, lb=before: mark(lb)))
        hooks.append(model.get_submodule(last).register_forward_hook(
            lambda *a, lb=stage: mark(lb)))
    try:
        with torch.no_grad():
            for _ in range(FWD_WARMUP):
                model(left, right)
            torch.cuda.synchronize()
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(FWD_ITERS):
                model(left, right)
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    stages: dict = defaultdict(float)
    for (_, a), (label, b) in zip(marks, marks[1:]):
        stages[label] += a.elapsed_time(b) / FWD_ITERS
    return {"ms": marks[0][1].elapsed_time(marks[-1][1]) / FWD_ITERS,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "stages_ms": dict(stages)}


def kernel_family(name: str) -> str:
    if "conv3d_fused_kernel" in name:
        return "K2 conv3d_fused"
    if "gwc_volume_kernel" in name:
        return "K1 gwc_volume"
    low = name.lower()
    if "bn_fw" in low or "batch_norm" in low:
        return "BatchNorm (cuDNN or ATen)"
    if "nhwctonchw" in low or "nchwtonhwc" in low:
        return "cuDNN layout transposes"
    if any(s in low for s in ("conv", "xmma", "implicit", "dgrad",
                              "winograd", "fft", "gemm")):
        return "cuDNN/cuBLAS conv"
    return "other (elementwise, copies, reductions)"


def kernel_times(model, left, right) -> dict:
    """Device ms and launches per forward of each kernel, from a
    torch.profiler trace of FWD_ITERS forwards."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(FWD_ITERS):
                model(left, right)
            torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.self_device_time_total > 0:
            out[evt.key] = (evt.self_device_time_total / 1e3 / FWD_ITERS,
                            evt.count / FWD_ITERS)
    return out


def profile_forward(model, left, right, dtype) -> dict:
    fwd = forward_breakdown(model, left, right)
    kernels = kernel_times(model, left, right)
    families: dict = defaultdict(float)
    for key, (ms, _) in kernels.items():
        families[kernel_family(key)] += ms
    busy = sum(families.values())
    print(f"  GwcNet_G forward {H}x{W} {DTYPE_NAME[dtype]}: {fwd['ms']:.3f} "
          f"ms, peak memory {fwd['peak_bytes'] / 2**20:.1f} MiB")
    for label, ms in sorted(fwd["stages_ms"].items(), key=lambda kv: -kv[1]):
        print(f"    stage {label:40s} {ms:8.3f} ms "
              f"{100 * ms / fwd['ms']:5.1f}%")
    if busy == 0:
        print("    torch.profiler saw no device time: kernel times not "
              "measured")
    else:
        print(f"    device busy {busy:.3f} ms of {fwd['ms']:.3f} ms "
              f"({100 * busy / fwd['ms']:.1f}%)")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"    family {fam:40s} {ms:8.3f} ms")
        for key, (ms, n) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"    kernel {ms:8.3f} ms x{n:g}  {key[:100]}")
    fwd.update(device_busy_ms=busy or None, kernel_families_ms=dict(families))
    return fwd


def time_gwc(mix, dtype, gen):
    """Times and work of the forward's K1 launches, weighted by `mix`."""
    ms = plain = 0.0
    nbytes = flops = 0
    for (b, h, w, c, d, g), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        t = cuda_ms(lambda: build_gwc_volume(left, right, d, g), 20)
        tp = cuda_ms(lambda: gwc_volume_reference(left, right, d, g), 5)
        ms, plain = ms + n * t, plain + n * tp
        nbytes += n * (2 * b * h * w * c + b * d * h * w * g) * \
            left.element_size()
        # this data's work: the w < d outputs are zero and need no products
        flops += n * 2 * c * b * h * sum(max(w - dd, 0) for dd in range(d))
    return ms, plain, None, nbytes, flops


def time_conv(mix, dtype, gen):
    """Times and work of the forward's K2 launches, weighted by `mix`."""
    ms = plain = lib = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, d, h, w, ci, co, res, relu), n in mix.items():
        x, k, scale, bias, r = k2_inputs(ci, co, d, h, w, res, dtype, gen, b)
        t = cuda_ms(lambda: conv3d_fused(x, k, scale, bias, r, relu), 5)
        tp = cuda_ms(lambda: conv3d_fused_reference(x, k, scale, bias, r,
                                                    relu), 5)
        xv, kv = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        tl = cuda_ms(lambda: F.conv3d(xv, kv, padding=1), 5)
        vox = b * d * h * w
        nbytes += n * ((vox * (ci + co * (2 if res else 1)) + 27 * ci * co)
                       * x.element_size() + 2 * co * 4)
        flops += n * 2 * 27 * ci * co * vox
        ms, plain, lib = ms + n * t, plain + n * tp, lib + n * tl
        shapes.append({"b": b, "dhw": [d, h, w], "ci": ci, "co": co,
                       "residual": res, "relu": relu, "launches": n,
                       "ms": t, "plain_ms": tp, "library_ms": tl})
    return ms, plain, lib, nbytes, flops, shapes


def bound(nbytes, flops, dtype):
    mem, f32, bf16 = PEAK
    t_bytes = nbytes / mem * 1e3
    t_ops = flops / (f32 if dtype == F32 else bf16) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"phase 1: device {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi[0] if smi else "nvidia-smi: no output")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _cuda.build()
    for lib in _cuda.SIGNATURES:
        _cuda.library(lib)
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}")

    gen = torch.Generator().manual_seed(1234)
    print("phase 3: gwc_volume kernel vs plain")
    gwc_err = check_gwc(gen)
    print("phase 4: conv3d_fused kernel vs plain")
    conv_err = check_conv(gen)
    print("phase 5: GwcNet_G")
    runs = check_model(gen)

    print("phase 6: timing")
    kernels = []
    forward = {"shape": [1, H, W, 3], "max_disp": MAX_DISP,
               "iters": FWD_ITERS, "warmup": FWD_WARMUP}
    for dtype in (F32, BF16):
        m, left, right, (k1_mix, k2_mix) = runs[dtype]
        forward[DTYPE_NAME[dtype]] = profile_forward(m, left, right, dtype)

        ms, plain, lib, nbytes, flops = time_gwc(k1_mix, dtype, gen)
        b_ms, b_by = bound(nbytes, flops, dtype)
        kernels.append({
            "name": f"gwc_volume ({DTYPE_NAME[dtype]})", "route": "cuda",
            "source": "stereo_toolbox_tpu_torch/csrc/gwc_volume.cu",
            "replaces": "stereo_toolbox_tpu/ops/pallas/volume.py:87",
            "launches": k1_mix.total(), "max_abs_err": gwc_err[dtype][0],
            "tolerance": f"{gwc_err[dtype][1]}*max|ref|",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "shapes": [
                {"bhwc": list(key[:4]), "d": key[4], "g": key[5],
                 "launches": n} for key, n in k1_mix.items()]})
        ms, plain, lib, nbytes, flops, shapes = time_conv(k2_mix, dtype, gen)
        b_ms, b_by = bound(nbytes, flops, dtype)
        kernels.append({
            "name": f"conv3d_fused ({DTYPE_NAME[dtype]})", "route": "cuda",
            "source": "stereo_toolbox_tpu_torch/csrc/conv3d_fused.cu",
            "replaces": "stereo_toolbox_tpu/ops/pallas/conv3d_fused.py:159",
            "launches": k2_mix.total(), "max_abs_err": conv_err[dtype][0],
            "tolerance": f"{conv_err[dtype][1]}*max|ref|",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "gflop": flops / 1e9, "shapes": shapes})
        for k in kernels[-2:]:
            print(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}"
                  f", library {k['library_ms']}, bound {k['bound_ms']:.4f} "
                  f"by {k['bound_by']})")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"forward": forward}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
