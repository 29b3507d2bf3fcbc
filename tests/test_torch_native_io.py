"""The port's native IO library (``csrc/stereo_io.cpp``, bound in
``stereo_toolbox_tpu_torch.native``) against the port's NumPy/PIL paths and
the JAX package's decoders: the cases of ``tests/test_native_io.py``, with
bit-identical decodes and the fused normaliser within 2e-6.

The library is built at its first use, race-free: six processes building
into one fresh directory at once each load a whole library. These tests
skip only where ``g++``, the libpng / libjpeg headers or the libraries
themselves are missing: where a trivial library that calls both, linked
with the port's own link flags, builds and loads, the port's library that
did not build fails them, with the reason (`native.build_error`).
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import pytest
from PIL import Image

from stereo_toolbox_tpu.datasets import io as jio
from stereo_toolbox_tpu_torch import native as nio
from stereo_toolbox_tpu_torch.datasets import io
from stereo_toolbox_tpu_torch.datasets.fixtures import write_pfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PROBE = """#include <cstdio>
#include <png.h>
extern "C" {
#include <jpeglib.h>
}
extern "C" unsigned long probe() {
    struct jpeg_error_mgr err;
    jpeg_std_error(&err);
    return png_access_version_number();
}
"""


def _toolchain_missing() -> str | None:
    """Why the library cannot be built here, or None: a shared library
    that calls libpng and libjpeg, built with g++ and the port's flags,
    must compile, link and load."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found"
    with tempfile.TemporaryDirectory() as d:
        so = os.path.join(d, "probe.so")
        probe = subprocess.run(
            [cxx, *nio.CXX_FLAGS, "-x", "c++", "-", "-x", "none",
             *nio.link_flags(cxx), "-o", so], capture_output=True, text=True,
            input=PROBE)
        if probe.returncode:
            return probe.stderr.strip() or "the probe does not build"
        try:
            ctypes.CDLL(so).probe()
        except OSError as e:
            return f"the probe does not load: {e}"
    return None


MISSING = _toolchain_missing()
pytestmark = pytest.mark.skipif(
    MISSING is not None, reason=f"no toolchain for the native IO library: "
                                f"{MISSING}")


@pytest.fixture(scope="module", autouse=True)
def built():
    assert nio.available, f"the native IO library did not build: " \
                          f"{nio.build_error}"


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(42)


def _png(tmp_path, name, arr, mode=None):
    p = str(tmp_path / name)
    Image.fromarray(arr, mode).save(p)
    return p


def _plain(call, *args):
    """`call` on the port's NumPy/PIL path (the native library off)."""
    saved = nio.available
    nio.available = False
    try:
        return call(*args)
    finally:
        nio.available = saved


def test_decode_rgb8_png(tmp_path, rng):
    img = rng.randint(0, 256, (37, 53, 3), np.uint8)
    p = _png(tmp_path, "rgb.png", img)
    got = nio.decode_rgb(p)
    assert np.array_equal(got, img)
    assert np.array_equal(got, _plain(io.load_image_rgb, p))
    assert np.array_equal(got, jio.load_image_rgb(p))


def test_decode_rgb8_gray_png_expands(tmp_path, rng):
    p = _png(tmp_path, "g.png", rng.randint(0, 256, (21, 17), np.uint8))
    got = nio.decode_rgb(p)
    assert np.array_equal(got, np.asarray(Image.open(p).convert("RGB")))
    assert np.array_equal(got, _plain(io.load_image_rgb, p))
    assert np.array_equal(got, jio.load_image_rgb(p))


def test_decode_rgb8_rgba_drops_alpha(tmp_path, rng):
    img = rng.randint(0, 256, (19, 23, 4), np.uint8)
    p = _png(tmp_path, "rgba.png", img, "RGBA")
    got = nio.decode_rgb(p)
    assert np.array_equal(got, img[..., :3])
    assert np.array_equal(got, _plain(io.load_image_rgb, p))


def test_decode_rgb8_jpeg_matches_pil(tmp_path, rng):
    p = str(tmp_path / "img.jpg")
    Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(
        p, quality=92)
    got = nio.decode_rgb(p)
    # both decode through libjpeg: bit-identical
    assert np.array_equal(got, _plain(io.load_image_rgb, p))
    assert np.array_equal(got, jio.load_image_rgb(p))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_decode_raw(tmp_path, rng, dtype):
    d = rng.randint(0, np.iinfo(dtype).max + 1, (31, 29)).astype(dtype)
    p = _png(tmp_path, "d.png", d)
    got = nio.decode_raw(p)
    assert got.dtype == dtype
    assert np.array_equal(got, d)
    plain = _plain(io.load_png_raw, p)
    assert plain.dtype == dtype and np.array_equal(got, plain)
    assert np.array_equal(got, jio.load_png_raw(p))


@pytest.mark.parametrize("scale", [-1.0, 2.5])
@pytest.mark.parametrize("color", [False, True])
def test_decode_pfm_endianness(tmp_path, rng, scale, color):
    arr = rng.randn(*((13, 17, 3) if color else (13, 17))).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    write_pfm(p, arr, scale)
    out, sc = nio.decode_pfm(p)
    assert sc == abs(scale)
    assert np.array_equal(out, arr)
    for ref, rsc in (_plain(io.pfm_imread, p), jio.pfm_imread(p)):
        assert np.array_equal(out, ref) and sc == rsc


def test_normalize_fused_matches_numpy(rng):
    img = rng.randint(0, 256, (65, 77, 3), np.uint8)
    ref = io.imagenet_normalize(io.to_float01(img))
    got = nio.imagenet_normalize_u8(img)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    # the dispatching helper takes the native path, and the plain one the
    # numpy path, the JAX package's bit for bit
    assert np.array_equal(io.normalize_u8(img), got)
    assert np.array_equal(_plain(io.normalize_u8, img),
                          jio.imagenet_normalize(jio.to_float01(img)))


def test_load_image_normalized_fused(tmp_path, rng):
    img = rng.randint(0, 256, (40, 56, 3), np.uint8)
    p = _png(tmp_path, "x.png", img)
    ref = io.imagenet_normalize(io.to_float01(img))
    got = nio.load_image_normalized(p)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert np.array_equal(got, nio.imagenet_normalize_u8(img))


def test_image_info(tmp_path, rng):
    p = _png(tmp_path, "i.png", rng.randint(0, 65536, (12, 34)).astype(
        np.uint16))
    assert nio.image_info(p) == (34, 12, 1, 16)


def test_error_reporting(tmp_path):
    p = str(tmp_path / "nope.png")
    with pytest.raises(nio.NativeIOError):
        nio.decode_rgb(p)
    with open(p, "wb") as f:
        f.write(b"garbage here")
    with pytest.raises(nio.NativeIOError):
        nio.decode_raw(p)


def test_io_dispatch_matches_plain(tmp_path, rng):
    """The port's io front-ends give the same bits with the native library
    on and off, and the JAX package's."""
    img = rng.randint(0, 256, (24, 36, 3), np.uint8)
    d16 = rng.randint(0, 30000, (24, 36)).astype(np.uint16)
    pi, pd = _png(tmp_path, "img.png", img), _png(tmp_path, "d.png", d16)
    for call, arg in ((io.load_image_rgb, pi), (io.load_png_raw, pd),
                      (io.disp_from_png_scaled, pd)):
        args = (arg, 256.0) if call is io.disp_from_png_scaled else (arg,)
        got = call(*args)
        assert np.array_equal(got, _plain(call, *args))
        assert np.array_equal(got, getattr(jio, call.__name__)(*args))


def test_non_png_falls_back_per_file(tmp_path, rng):
    """A format the native decoder refuses (BMP) goes to PIL for that
    file."""
    img = rng.randint(0, 256, (10, 12, 3), np.uint8)
    p = str(tmp_path / "x.bmp")
    Image.fromarray(img).save(p)
    with pytest.raises(nio.NativeIOError):
        nio.decode_rgb(p)
    assert np.array_equal(io.load_image_rgb(p), img)


def _child(code: str, env=None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(env or {})})


def test_six_concurrent_first_builds_each_load_a_whole_library(tmp_path,
                                                              rng):
    """Six processes build into one fresh directory at the same moment;
    each loads the library and decodes with it."""
    img = rng.randint(0, 256, (33, 41, 3), np.uint8)
    png = _png(tmp_path, "probe.png", img)
    build, sync = tmp_path / "build", tmp_path / "sync"
    sync.mkdir()
    code = f"""
        import os, shutil, time
        from pathlib import Path
        import numpy as np
        from PIL import Image
        import stereo_toolbox_tpu_torch.native as nio
        nio.BUILD_DIR = Path({str(build)!r})
        Path({str(sync)!r}, str(os.getpid())).touch()
        while not Path({str(sync)!r}, "go").exists():
            time.sleep(0.005)
        assert nio.available, nio.build_error
        got = nio.decode_rgb({png!r})
        ref = np.asarray(Image.open({png!r}).convert("RGB"))
        assert np.array_equal(got, ref)
        print("loaded", nio.library_path(shutil.which("g++")))
    """
    procs = [_child(code) for _ in range(6)]
    deadline = time.time() + 60
    while len(list(sync.iterdir())) < 6 and time.time() < deadline:
        time.sleep(0.01)
    (sync / "go").touch()
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "loaded" in out, out
    # one library, no temporary file left behind
    assert [f.name for f in build.iterdir()] == [
        nio.library_path(shutil.which("g++")).name]


def test_library_the_linker_finds_off_the_loader_path_loads(tmp_path):
    """A library that the linker finds only through ``LIBRARY_PATH``, in a
    directory the runtime loader does not search, does not keep the port's
    library from loading: the build records an rpath to that directory."""
    libdir = tmp_path / "lib"
    libdir.mkdir()
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", "-", "-o",
                    str(libdir / "libsioextra.so")], check=True, text=True,
                   input='extern "C" int sio_extra() { return 7; }\n')
    src = tmp_path / "stereo_io.cpp"
    src.write_text(nio.SOURCE.read_text() + textwrap.dedent("""
        extern "C" int sio_extra();
        extern "C" int sio_call_extra() { return sio_extra(); }
    """))
    code = f"""
        from pathlib import Path
        import stereo_toolbox_tpu_torch.native as nio
        nio.SOURCE = Path({str(src)!r})
        nio.BUILD_DIR = Path({str(tmp_path / "build")!r})
        nio.LINK = nio.LINK + ("-lsioextra",)
        assert nio.available, nio.build_error
        assert nio._lib.sio_call_extra() == 7
        print("loaded")
    """
    env = {"LIBRARY_PATH": str(libdir)}
    assert str(libdir) not in os.environ.get("LD_LIBRARY_PATH", "")
    p = _child(code, env)
    out = p.communicate(timeout=120)[0]
    assert p.returncode == 0 and "loaded" in out, out


def test_failed_build_and_switch_keep_the_reason(tmp_path):
    """A source that does not compile leaves `available` False and the
    compiler's message in `build_error`; STEREO_TPU_NATIVE_IO=0 names
    itself."""
    bad = tmp_path / "stereo_io.cpp"
    bad.write_text("this is not C++\n")
    code = f"""
        from pathlib import Path
        import numpy as np
        import stereo_toolbox_tpu_torch.native as nio
        from stereo_toolbox_tpu_torch.datasets import io
        nio.SOURCE = Path({str(bad)!r})
        nio.BUILD_DIR = Path({str(tmp_path / "build")!r})
        assert not nio.available
        print("error:", nio.build_error)
        img = np.zeros((2, 2, 3), np.uint8)
        assert io.normalize_u8(img).shape == (2, 2, 3)   # the numpy path
    """
    p = _child(code)
    out = p.communicate(timeout=120)[0]
    assert p.returncode == 0, out
    assert "error: g++ failed" in out, out
    p = _child("""
        import stereo_toolbox_tpu_torch.native as nio
        assert not nio.available
        print("error:", nio.build_error)
    """, env={"STEREO_TPU_NATIVE_IO": "0"})
    out = p.communicate(timeout=120)[0]
    assert p.returncode == 0 and "STEREO_TPU_NATIVE_IO=0" in out, out


def test_first_use_from_many_threads_loads_once():
    """Sixteen loader threads read `available` at once on a fresh module
    (short switch interval): each sees the library, bound once."""
    p = _child("""
        import sys, threading
        import stereo_toolbox_tpu_torch.native as nio
        sys.setswitchinterval(1e-6)
        binds, seen = [], []
        bind = nio._bind
        nio._bind = lambda path: binds.append(path) or bind(path)
        threads = [threading.Thread(target=lambda: seen.append(
            nio.available)) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert seen == [True] * 16 and len(binds) == 1, (seen, binds)
        print("ok")
    """)
    out = p.communicate(timeout=120)[0]
    assert p.returncode == 0 and "ok" in out, out
