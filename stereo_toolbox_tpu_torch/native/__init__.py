"""ctypes bindings of the port's native IO runtime (``csrc/stereo_io.cpp``).

The C++ library replaces the hot host-side path of the original toolbox's
data layer (a PIL decode in every dataset ``__getitem__`` plus the
torchvision normalize of datasets/utils.py:62-69) with libpng/libjpeg
decoders and a fused uint8 → ImageNet-normalized float32 pass. ctypes drops
the GIL for each foreign call, so the thread-pool `DataLoader` decodes in
parallel. It is an optional host-side speed-up: every decoder has a
bit-identical NumPy/PIL path in `datasets.io` (the fused normaliser rounds
within 2 ulp of it), and no device path depends on it.

Nothing is built at import. At the first read of `available` (the first
decode), the library is compiled with ``g++ -O3 -fPIC -shared ... -lpng
-ljpeg`` into ``csrc/build/`` under a name hashed from the source and the
flags, through a temporary file renamed into place, so that processes that
build at once each load a whole library, and loaded. The library records
an rpath to each directory where the linker found libpng and libjpeg, so
that it loads where the linker searches a directory (``LIBRARY_PATH``, a
toolchain's own) that the runtime loader does not. Where that fails,
`available` is False and `build_error` says why; ``STEREO_TPU_NATIVE_IO=0``
(the JAX package's switch, which governs both packages) turns it off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "stereo_io.cpp"
BUILD_DIR = CSRC / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
LINK = ("-lpng", "-ljpeg")
SWITCH = "STEREO_TPU_NATIVE_IO"

_lock = threading.Lock()
_lib = None


class NativeIOError(RuntimeError):
    pass


def link_flags(cxx: str) -> tuple[str, ...]:
    """`LINK`, and ``-Wl,-rpath,DIR`` for each directory in which `cxx`'s
    linker finds a library that `LINK` names (``-print-file-name`` names
    the file the linker would take, or echoes the bare name when it finds
    none), as a DT_RPATH, which, unlike a DT_RUNPATH, the loader also
    searches for the dependencies of those libraries."""
    rpaths = []
    for flag in LINK:
        found = subprocess.run([cxx, f"-print-file-name=lib{flag[2:]}.so"],
                               capture_output=True, text=True,
                               timeout=60).stdout.strip()
        if os.path.isabs(found):
            d = os.path.dirname(os.path.normpath(found))
            if d not in rpaths:
                rpaths.append(d)
    if not rpaths:
        return LINK
    return LINK + ("-Wl,--disable-new-dtags",
                   *(f"-Wl,-rpath,{d}" for d in rpaths))


def library_path(cxx: str) -> Path:
    """Where the library is built: named by a hash of the source and the
    flags, so an edit to either, or another library directory, rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + link_flags(cxx)).encode())
    return BUILD_DIR / f"stereo_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing, into a temporary file in
    `BUILD_DIR` renamed onto `library_path` (atomic, so a process never loads
    a library another is still writing). Raises `NativeIOError` with the
    compiler's message when it fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeIOError("g++ not found")
    try:
        target = library_path(cxx)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeIOError(f"g++ could not run: {e}") from e
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        run = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE),
                              *link_flags(cxx), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if run.returncode:
            raise NativeIOError(f"g++ failed ({run.returncode}): "
                                f"{(run.stderr or run.stdout).strip()}")
        os.replace(tmp, target)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeIOError(f"g++ could not run: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    c_char_p, c_int, c_ll = ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
    intp = ctypes.POINTER(c_int)
    lib.sio_last_error.restype = c_char_p
    lib.sio_image_info.argtypes = [c_char_p, intp, intp, intp, intp]
    lib.sio_decode_pfm.argtypes = [c_char_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.sio_decode_rgb8.argtypes = [c_char_p, ctypes.c_void_p]
    lib.sio_decode_raw.argtypes = [c_char_p, ctypes.c_void_p]
    lib.sio_normalize_imagenet.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           c_ll]
    lib.sio_load_image_normalized.argtypes = [c_char_p, ctypes.c_void_p,
                                              ctypes.c_void_p]
    return lib


def _load() -> None:
    """Build and bind the library once; set `available` and
    `build_error`."""
    global _lib, available, build_error
    with _lock:
        if "available" in globals():
            return
        error = None
        if os.environ.get(SWITCH, "1") == "0":
            error = f"turned off by {SWITCH}=0"
        else:
            try:
                _lib = _bind(build())
            except (NativeIOError, OSError, AttributeError) as e:
                error = str(e)
        build_error = error
        available = _lib is not None


def __getattr__(name: str):
    # `available` and `build_error` come into being at their first read
    if name in ("available", "build_error"):
        _load()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _library() -> ctypes.CDLL:
    if _lib is None:
        _load()
        if _lib is None:
            raise NativeIOError(
                f"native IO library unavailable: {build_error}")
    return _lib


def _check(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        raise NativeIOError(lib.sio_last_error().decode("utf-8", "replace"))


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def image_info(path: str) -> tuple[int, int, int, int]:
    """(width, height, channels, bitdepth) without decoding the raster."""
    lib = _library()
    w, h, c, d = (ctypes.c_int() for _ in range(4))
    _check(lib, lib.sio_image_info(path.encode(), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(c),
                                   ctypes.byref(d)))
    return w.value, h.value, c.value, d.value


def decode_pfm(path: str) -> tuple[np.ndarray, float]:
    """PFM → (top-down float32 HxW[x3], |scale|). Parity: pfm_imread."""
    lib = _library()
    w, h, c, _ = image_info(path)
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.float32)
    scale = ctypes.c_float()
    _check(lib, lib.sio_decode_pfm(path.encode(), _ptr(out),
                                   ctypes.byref(scale)))
    return out, scale.value


def decode_rgb(path: str) -> np.ndarray:
    """PNG/JPEG → uint8 HxWx3 RGB (alpha dropped, palette/gray expanded)."""
    lib = _library()
    w, h, _, _ = image_info(path)
    out = np.empty((h, w, 3), np.uint8)
    _check(lib, lib.sio_decode_rgb8(path.encode(), _ptr(out)))
    return out


def decode_raw(path: str) -> np.ndarray:
    """PNG preserving stored bit depth: uint8/uint16, HxW[xC]."""
    lib = _library()
    w, h, c, depth = image_info(path)
    out = np.empty((h, w) if c == 1 else (h, w, c),
                   np.uint16 if depth == 16 else np.uint8)
    _check(lib, lib.sio_decode_raw(path.encode(), _ptr(out)))
    return out


def imagenet_normalize_u8(img: np.ndarray) -> np.ndarray:
    """uint8 HxWx3 → float32 (x/255 - mean)/std, fused single pass."""
    lib = _library()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected HxWx3 uint8, got {img.shape}")
    out = np.empty(img.shape, np.float32)
    _check(lib, lib.sio_normalize_imagenet(
        _ptr(img), _ptr(out), ctypes.c_longlong(img.shape[0] * img.shape[1])))
    return out


def load_image_normalized(path: str) -> np.ndarray:
    """Decode PNG/JPEG and ImageNet-normalize in one native call."""
    lib = _library()
    w, h, _, _ = image_info(path)
    out = np.empty((h, w, 3), np.float32)
    scratch = np.empty((h, w, 3), np.uint8)
    _check(lib, lib.sio_load_image_normalized(path.encode(), _ptr(out),
                                              _ptr(scratch)))
    return out
