"""Build and load the CUDA kernels under csrc/ at first use.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ctypes. Libraries go to `_build/` beside this file, named by a
hash of the source, the headers it may include (`csrc/*.cuh`) and the
flags, so an edited source or header builds anew and an unchanged one is
reused. A lock file per library serialises builds of it
between processes and threads; different libraries build in parallel.
`build` is the same scheme for any compiler (utils/frameio.py uses it with
g++ for the native PNG writer).

Nothing here runs at import: the first launch of a kernel on a CUDA tensor
calls `load`. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false keeps every multiply and add separately rounded, as on the
# CPU reference; no fast-math flags (powf, division and sqrt stay IEEE).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises when absent."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH); "
                           "the CUDA kernels cannot be built")
    return found


def nvcc_version() -> str:
    return subprocess.run([nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()


def lib_path(name: str, source: Path, flags, build_dir: Path = BUILD_DIR,
             deps=()) -> Path:
    """Where `source` built with `flags` lives: lib<name>-<hash>.so, the
    hash over the source, the files in `deps` it includes and the flags."""
    data = b"".join(p.read_bytes() for p in (source, *deps))
    key = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"lib{name}-{key}.so"


def build(name: str, source: Path, compiler: Callable[[], str], flags,
          libs=(), build_dir: Path = BUILD_DIR, deps=()) -> Path:
    """Compile `source` into a shared library under build_dir (once per
    source and flags; the library's lock file serialises its builders) →
    its path. `compiler()` names the compiler and is asked only when a build
    is needed. The compiler's output is kept beside the library (.log) and
    read into BUILD_LOG; a library without it is built again, so BUILD_LOG
    always holds the output of the build that made the library. Raises
    RuntimeError when the compiler fails."""
    out = lib_path(name, source, (*flags, *libs), build_dir, deps)
    saved = out.with_suffix(".log")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out.exists() and saved.exists()):
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [compiler(), *flags, "-o", str(tmp), str(source),
                       *libs]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{cmd[0]} failed for {source.name} (rc "
                        f"{proc.returncode}):\n{' '.join(cmd)}\n"
                        f"{proc.stdout}\n{proc.stderr}")
                log = proc.stderr.strip()
                saved.write_text(log)
                os.replace(tmp, out)
                BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                                   "ptxas": log}
            else:
                BUILD_LOG.setdefault(name, {"seconds": 0.0,
                                            "ptxas": saved.read_text()})
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu → ctypes library."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build(name, CSRC / f"{name}.cu", nvcc_path,
                                NVCC_FLAGS, deps=sorted(CSRC.glob("*.cuh")))))
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")
