"""ctypes binding for the port's native C++ oracle (``dipnative.cpp``).

The port's own copy of ``dip_benchmark_tpu/native``: the same source, the
same public surface (``available``, ``build_error``, ``monotonic_ns``, the
op functions and ``image_ops``) and the same rule for ``--verify``: the
uint8 model checks against these ops when the library is available and
against the NumPy oracle (``oracle.IMAGE_OPS``) otherwise.

The library is built with g++ (with OpenMP, else without) at the first
call that needs it, never at import, so the package imports on a box with
no compiler. It lands in ``_build/<hash>/`` beside this file, keyed by a
hash of the source, the flags and the CPU that ``-march=native`` resolves
to, so a changed source, or a checkout copied to another host, rebuilds.
The compiler writes a private file name in that directory, which is then
renamed into place: processes that build at once each load a whole
library. A failed build or a library that will not load (after one
rebuild) makes ``available()`` False; nothing here raises for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "dipnative.cpp")
BUILD_ROOT = os.path.join(_HERE, "_build")
LIB_NAME = "libdipnative.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _target() -> bytes:
    """The machine options ``-march=native`` stands for on this host, as
    g++ passes them on to its compiler proper (``-###`` runs nothing)."""
    proc = subprocess.run(
        [CXX, "-march=native", "-###", "-x", "c++", "-c", os.devnull,
         "-o", os.devnull], capture_output=True, text=True, timeout=60)
    lines = [ln for ln in proc.stderr.splitlines() if "cc1plus" in ln]
    return " ".join(t for ln in lines for t in ln.split()
                    if t.strip("'\"").startswith("-m")).encode()


def library_path() -> str:
    """Where this host's build of the library lives (not built here)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + _target())
    with open(SRC, "rb") as f:
        h.update(b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _build(path: str) -> str | None:
    """Compile the library to ``path``; None, or what went wrong."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".so.tmp")
    os.close(fd)
    try:
        for omp in (["-fopenmp"], []):
            cmd = [CXX, *CXX_FLAGS, *omp, SRC, "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                return f"{type(e).__name__}: {e}"
            if proc.returncode == 0:
                os.replace(tmp, path)
                return None
        return proc.stderr[-500:]
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
        except (OSError, subprocess.TimeoutExpired) as e:
            _build_error = f"no C++ compiler: {type(e).__name__}: {e}"
            return None
        if not os.path.exists(path):
            _build_error = _build(path)
            if _build_error is not None:
                return None
        try:
            lib = _bind(ctypes.CDLL(path))
        except (OSError, AttributeError):
            # A corrupt or partial library (an interrupted build): rebuild
            # once, and if it still will not load, fall back to the NumPy
            # oracle — available() must return False, never raise.
            _build_error = _build(path)
            if _build_error is not None:
                return None
            try:
                lib = _bind(ctypes.CDLL(path))
            except (OSError, AttributeError) as e:
                _build_error = f"load failed after rebuild: {e}"
                return None
        _lib = lib
        return _lib


def _bind(lib):
    lib.dip_monotonic_ns.restype = ctypes.c_uint64
    lib.dip_monotonic_ns.argtypes = []
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    ci = ctypes.c_int
    for name in ("dip_copy", "dip_inversion", "dip_threshold",
                 "dip_grayscale"):
        getattr(lib, name).argtypes = [u8p, u8p, ci, ci, ci]
        getattr(lib, name).restype = None
    lib.dip_erosion.argtypes = [u8p, u8p, ci, ci, ci, u8p, ci, ci]
    lib.dip_erosion.restype = None
    lib.dip_convolution.argtypes = [u8p, u8p, ci, ci, ci, i32p, ci, ci, ci]
    lib.dip_convolution.restype = None
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is unavailable, or None."""
    _load()
    return _build_error


def monotonic_ns() -> int:
    """The library's steady-clock nanoseconds (``time.perf_counter_ns``
    when the library is unavailable)."""
    lib = _load()
    if lib is None:
        import time
        return time.perf_counter_ns()
    return lib.dip_monotonic_ns()


def _run(name: str, image: np.ndarray, *extra) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        # ValueError, not assert (python -O strips asserts) — and the C
        # kernels hard-code 3 channels (dip_grayscale reads px[1]/px[2]),
        # so anything else would be a heap over-read, not a wrong answer.
        raise ValueError(
            f"native ops take uint8 HWC RGB arrays, got "
            f"dtype={image.dtype} shape={image.shape}")
    image = np.ascontiguousarray(image)
    out = np.empty_like(image)
    h, w, c = image.shape
    getattr(lib, name)(image, out, h, w, c, *extra)
    return out


def copy(image):
    return _run("dip_copy", image)


def inversion(image):
    return _run("dip_inversion", image)


def threshold(image):
    return _run("dip_threshold", image)


def grayscale(image):
    return _run("dip_grayscale", image)


def erosion(image, mask: np.ndarray):
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    return _run("dip_erosion", image, mask, mask.shape[0], mask.shape[1])


def convolution(image, int_mask: np.ndarray, shift: int):
    m = np.ascontiguousarray(int_mask.astype(np.int32))
    return _run("dip_convolution", image, m, m.shape[0], m.shape[1], shift)


def image_ops() -> dict:
    """CSV-column-keyed native oracle, mirroring ``oracle.IMAGE_OPS``: the
    separable ops run two passes, each rounded to uint8."""
    from .. import spec

    def erosion_separated(im):
        return erosion(erosion(im, spec.SQUARE_MASK_1X3), spec.SQUARE_MASK_3X1)

    def conv_sep(im, m1, m2, shift):
        return convolution(convolution(im, m1, shift), m2, shift)

    return {
        "Copy": copy,
        "Inversion": inversion,
        "Grayscale": grayscale,
        "Threshold": threshold,
        "Erosion-3x3-Cross": lambda im: erosion(im, spec.CROSS_MASK_3X3),
        "Erosion-3x3-Square": lambda im: erosion(im, spec.SQUARE_MASK_3X3),
        "Erosion-1x3+3x1-Square": erosion_separated,
        "Convolution-3x3": lambda im: convolution(
            im, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
        "Convolution-1x3+3x1": lambda im: conv_sep(
            im, spec.BLUR_1X3_INT, spec.BLUR_3X1_INT, spec.BLUR_SEP3_SHIFT),
        "Convolution-5x5": lambda im: convolution(
            im, spec.BLUR_5X5_INT, spec.BLUR_5X5_SHIFT),
        "Convolution-1x5+5x1": lambda im: conv_sep(
            im, spec.BLUR_1X5_INT, spec.BLUR_5X1_INT, spec.BLUR_SEP5_SHIFT),
        "Gaussian-Blur-3x3": lambda im: convolution(
            im, spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
        "Fused-Pipeline": lambda im: convolution(
            erosion(threshold(grayscale(im)), spec.SQUARE_MASK_3X3),
            spec.BLUR_3X3_INT, spec.BLUR_3X3_SHIFT),
    }
