"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library under ``csrc/build/``
(named by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds) and loaded with ``ctypes``.
Nothing here runs at import time: a machine without ``nvcc`` can import
every module of the package and use the plain PyTorch paths on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each launch function, by library (named like its source)
SIGNATURES = {
    "gwc_volume": {
        # left, right, out, B, H, W, C, D, G, dtype, tw, gs, dc, strip,
        # stream
        "gwc_volume": [_P, _P, _P] + [_I] * 11 + [_P],
        # left, right, grad, dl, dr, B, H, W, C, D, G, dtype, tw, gs, strip,
        # ng, threads, smem, stream
        "gwc_volume_backward": [_P] * 5 + [_I] * 13 + [_P]},
    "conv3d_fused": {
        # x, w, scale, bias, res, out, B, D, H, W, Ci, Co, ci_pad, co_pad,
        # relu, tile, stream
        "conv3d_fused_mma": [_P] * 6 + [_I] * 10 + [_P],
        "conv3d_fused_tf32x3": [_P] * 6 + [_I] * 10 + [_P]},
    "sample_gather": {
        # right, samples, out, B, H, W, C, S, max_shift, dtype, tw, threads,
        # vb, sc, stream
        "gather_right_by_samples": [_P] * 3 + [_I] * 11 + [_P],
        # left, right, samples, out, B, H, W, C, S, G, max_shift, dtype, tw,
        # threads, ng, stream
        "gwc_volume_from_samples": [_P] * 4 + [_I] * 11 + [_P],
        # grad, samples, dright, B, H, W, C, S, max_shift, dtype, threads,
        # chunk, item, smem, stream
        "gather_right_by_samples_backward": [_P] * 3 + [_I] * 11 + [_P],
        # samples, offs, B, H, W, C, S, max_shift, dtype, threads, chunk,
        # item, smem, stream: its list build alone
        "gather_right_by_samples_backward_build": [_P] * 2 + [_I] * 11 + [_P],
        # left, right, samples, grad, lists, dl, dr, B, H, W, C, S, G,
        # max_shift, dtype, groups, smem, stream
        "gwc_volume_from_samples_backward": [_P] * 7 + [_I] * 10 + [_P],
        # samples, lists, B, H, W, S, max_shift, stream: its list build alone
        "gwc_volume_from_samples_backward_lists": [_P] * 2 + [_I] * 5 + [_P]},
    "concat_volume": {
        # left, right, out, B, H, W, C, D, mask_left, dtype, vb, sb, tw, dr,
        # threads, stream
        "concat_volume": [_P] * 3 + [_I] * 12 + [_P],
        # grad, dl, dr, B, H, W, C, D, mask_left, dtype, vec, threads, stream
        "concat_volume_backward": [_P] * 3 + [_I] * 9 + [_P]},
    "conv3d": {
        # x, w, out, B, D, H, W, Ci, dtype, run, stream
        "conv3d_stencil": [_P] * 3 + [_I] * 7 + [_P],
        # x, w, out, B, D, H, W, Ci, Co, dtype, stream
        "conv3d_direct": [_P] * 3 + [_I] * 7 + [_P]},
    "vit_attention": {
        # q, k, v, out, lse (or null), B*heads, N, scale, stream
        "vit_attention_mma": [_P] * 5 + [_I] * 2 + [_F, _P],
        "vit_attention_tf32x3": [_P] * 5 + [_I] * 2 + [_F, _P],
        # q, k, v, dout, lse, di, dk, dv, B*heads, N, scale, dtype, stream
        "vit_attention_bwd_dkv": [_P] * 8 + [_I] * 2 + [_F, _I, _P],
        # q, k, v, dout, lse, di, dq, B*heads, N, scale, dtype, stream
        "vit_attention_bwd_dq": [_P] * 7 + [_I] * 2 + [_F, _I, _P]},
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a hash of
    the source, every ``csrc/*.cuh`` header (a source may include any of
    them) and the flags, so an edit to any of them rebuilds."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every missing library of `names`, one ``nvcc`` each, all
    started together. Returns the compiler's messages by name (empty for a
    library that was already built); raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def _load(path: Path, name: str) -> ctypes.CDLL:
    """The library at `path`, its launch functions typed as ``csrc/<name>.cu``
    declares them."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build((name,))
        _libs[name] = _load(library_path(name), name)
    return _libs[name]


def variant(name: str, tag: str, subs=(), flags=()) -> ctypes.CDLL:
    """A copy of ``csrc/<name>.cu`` with each ``(old, new)`` of `subs`
    replaced (each `old` must occur once), built with the port's flags and
    `flags` into ``csrc/build/<tag>/`` beside copies of the headers, and
    loaded like `library`'s. For phase stamps and planted faults: the
    wrappers launch it only inside `loaded_as`."""
    text = (CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} is not in {name}.cu once")
        text = text.replace(old, new)
    out = BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    target = out / f"{name}.so"
    run = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(target),
                          str(out / f"{name}.cu")], capture_output=True,
                         text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{run.stdout}{run.stderr}")
    return _load(target, name)


@contextlib.contextmanager
def loaded_as(name: str, lib: ctypes.CDLL):
    """Within it, the wrappers of ``csrc/<name>.cu`` launch `lib`'s kernels
    (a `variant`)."""
    old = library(name)
    _libs[name] = lib
    try:
        yield lib
    finally:
        _libs[name] = old


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a launch refused for its
    shared memory or block size never runs and reports only here)."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc}: {lib.error_string(rc).decode()}")


def on_cpu(t) -> bool:
    """Whether a wrapper takes its plain version for `t`: only a tensor on
    the CPU does; any other goes to the kernel or raises."""
    return t.device.type == "cpu"


def refuse_grad(what: str, instead: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop a gradient: its
    output is a fresh tensor with no ``grad_fn``, so with autograd on an
    input that requires grad would lose its gradient without an error.
    `instead` names the path that trains through cuDNN or autograd."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: its CUDA kernel has no backward, and an input requires "
            f"grad. {instead}. Run an eval forward under torch.no_grad()")


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
