"""Build and load the port's CUDA kernel library.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``_build/<hash>/`` beside this file, keyed by a hash
of the sources and the compiler flags, so a changed source rebuilds and an
unchanged one loads at once. Building is set-up: it happens at the first
``load()``, never at import. A missing compiler or a failed build raises
``KernelLibraryError`` with the compiler's output; nothing falls back.
``build_log`` keeps the compiler's register and spill report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")
SOURCES = ("point.cu", "window.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdipkernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_size_t
# name -> argument types, the trailing _P of each being the CUDA stream.
SIGNATURES = {
    "dip_copy_u8": (_P, _P, _N, _P),
    "dip_inversion_u8": (_P, _P, _N, _P),
    "dip_threshold_u8": (_P, _P, _N, _I, _I, _P),
    "dip_grayscale_u8": (_P, _P, _N, _I, _I, _I, _I, _P),
    "dip_erosion_rect_u8": (_P, _P, _I, _I, _I, _P),
    "dip_erosion_plus_u8": (_P, _P, _I, _I, _I, _P),
    "dip_erosion_sep_u8": (_P, _P, _I, _I, _I, _P),
    "dip_blur3x3_u8": (_P, _P, _I, _I, _I, _P),
    "dip_conv_dense_u8": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P),
    "dip_conv_sep_u8": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _P),
}


class KernelLibraryError(RuntimeError):
    """The CUDA kernel library could not be built or loaded."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output from the last build in this process


def nvcc_path() -> str:
    """$NVCC if set, else $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    if os.environ.get("NVCC"):
        return os.environ["NVCC"]
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    return shutil.which("nvcc") or "nvcc"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, source_hash(), LIB_NAME)


def build() -> str:
    """Compile the library if it is not built yet; return its path."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = nvcc_path()
    if shutil.which(nvcc) is None:
        raise KernelLibraryError(
            f"no CUDA compiler: {nvcc!r} not found (set NVCC or CUDA_HOME)")
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    # Compile to a private name, then rename: another process that loads
    # the library never sees a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise KernelLibraryError(
            f"cannot run the CUDA compiler {nvcc!r}: {e}") from e
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelLibraryError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{build_log}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelLibraryError(f"cannot load {path}: {e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.dip_error_string.argtypes = [ctypes.c_int]
            lib.dip_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib

