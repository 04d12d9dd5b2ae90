"""ctypes bindings for the native frame writer (port of raytracing_cuda_tpu/
utils/frameio.py over native/frameio/frameio.cpp).

The writer keeps PNG output off the render loop: libframeio encodes at
memcpy speed (stored deflate, level 0) or with zlib (levels 1-9) on
background threads behind a bounded ring. `build` compiles it with g++ and
native/Makefile's flags (zlib when /usr/include/zlib.h exists) into the
port's `_build/`, hash-named and file-locked as the CUDA kernels are.

Where the library cannot be built (no g++, no source), `write_png` goes
through `utils.images.save_png` (zlib + numpy) and says so once on stderr;
`AsyncFrameWriter` needs the library.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import time
from pathlib import Path

import numpy as np

from raytracing_cuda_tpu_torch import _build
from raytracing_cuda_tpu_torch.utils.images import save_png

SOURCE = (Path(__file__).resolve().parents[2] / "native" / "frameio"
          / "frameio.cpp")
ZLIB_HEADER = Path("/usr/include/zlib.h")

_lib = None
_fallback_level = 0        # save_png's level where the library is absent
_warned = False


def _flags():
    """native/Makefile:11-19 → (compiler flags, link libraries)."""
    flags = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
             "-pthread"]
    if ZLIB_HEADER.exists():
        return flags + ["-DFIO_HAVE_ZLIB"], ["-lz"]
    return flags, []


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.fio_write_png.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.fio_write_png.restype = ctypes.c_int
    lib.fio_writer_create.argtypes = [ctypes.c_int]
    lib.fio_writer_create.restype = ctypes.c_void_p
    lib.fio_writer_create2.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fio_writer_create2.restype = ctypes.c_void_p
    lib.fio_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.fio_writer_written.argtypes = [ctypes.c_void_p]
    lib.fio_writer_written.restype = ctypes.c_long
    lib.fio_writer_failed.argtypes = [ctypes.c_void_p]
    lib.fio_writer_failed.restype = ctypes.c_long
    lib.fio_set_png_level.argtypes = [ctypes.c_int]
    lib.fio_set_png_level.restype = ctypes.c_int
    lib.fio_writer_drain.argtypes = [ctypes.c_void_p]
    lib.fio_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.fio_now_ns.restype = ctypes.c_longlong
    return lib


def available() -> bool:
    """True once the library is loaded, or built already and loadable."""
    global _lib
    if _lib is None and SOURCE.exists():
        flags, libs = _flags()
        path = _build.lib_path("frameio", SOURCE, [*flags, *libs])
        if path.exists():
            _lib = _bind(path)
    return _lib is not None


def build(build_dir: Path = _build.BUILD_DIR) -> bool:
    """Compile and load libframeio with g++ → False where it cannot be
    built (no g++, no source, or the compiler fails)."""
    global _lib
    if not SOURCE.exists() or shutil.which("g++") is None:
        return False
    flags, libs = _flags()
    try:
        path = _build.build("frameio", SOURCE, lambda: "g++", flags, libs,
                            Path(build_dir))
    except RuntimeError as e:
        print(f"frameio: build failed: {e}", file=sys.stderr)
        return False
    _lib = _bind(path)
    return True


def set_png_level(level: int) -> int:
    """PNG encode level for all frameio writes: 0 = stored deflate
    (memcpy speed, default), 1-9 = Sub-filtered zlib. Returns the level in
    effect: clamped to 0-9, and 0 on a library built without zlib."""
    global _fallback_level
    level = max(0, min(9, int(level)))
    _fallback_level = level
    if available():
        return int(_lib.fio_set_png_level(level))
    return level


def _as_rgb_bytes(img: np.ndarray):
    img = np.ascontiguousarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(
            f"frameio needs (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return img, img.ctypes.data_as(ctypes.c_char_p)


def write_png(img: np.ndarray, path: str) -> None:
    """Synchronous PNG write through the native encoder (save_png where
    the library is absent)."""
    global _warned
    if not available():
        if not _warned:
            print("frameio: native writer unavailable, writing PNGs with "
                  "utils.images.save_png", file=sys.stderr)
            _warned = True
        save_png(img, path, _fallback_level)
        return
    img, ptr = _as_rgb_bytes(img)
    rc = _lib.fio_write_png(path.encode(), ptr, img.shape[1], img.shape[0])
    if rc != 0:
        raise OSError(f"fio_write_png({path}) failed: {rc}")


class AsyncFrameWriter:
    """Bounded-ring background PNG writer (native threads).

    submit() copies the frame into a ring slot and returns; the workers
    encode and write. drain() blocks until the queue is empty.
    """

    def __init__(self, ring: int = 4, threads: int = 1):
        if not available():
            raise RuntimeError("libframeio is not built: call "
                               "frameio.build() first")
        self._lib = _lib
        self._h = self._lib.fio_writer_create2(ring, threads)

    def _handle(self):
        if not self._h:
            raise RuntimeError("AsyncFrameWriter used after close()")
        return self._h

    def submit(self, img: np.ndarray, path: str) -> None:
        img, ptr = _as_rgb_bytes(img)
        self._lib.fio_writer_submit(self._handle(), path.encode(), ptr,
                                    img.shape[1], img.shape[0])

    @property
    def written(self) -> int:
        return int(self._lib.fio_writer_written(self._handle()))

    @property
    def failed(self) -> int:
        """Frames dropped by the workers (unwritable path / disk full)."""
        return int(self._lib.fio_writer_failed(self._handle()))

    def drain(self) -> None:
        self._lib.fio_writer_drain(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.fio_writer_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        self.close()


def now_ns() -> int:
    """Monotonic clock (native when available)."""
    if not available():
        return time.monotonic_ns()
    return int(_lib.fio_now_ns())
