"""Build and load the port's CUDA kernel library.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper (``sm_90a``),
one compiler process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``.
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
SOURCES = ("point.cu", "window.cu", "pipeline.cu", "f32.cu", "chain.cu",
           "conv.cu", "layout.cu")
HEADERS = ("common.cuh", "words.cuh", "taps.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdipkernels.so"
BUILD_TIMEOUT_S = 900

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_size_t
_F = ctypes.c_float
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
    "dip_conv_rank1_u8": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P),
    "dip_conv_sep_u8": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _P),
    "dip_pipeline_u8": (_P, _P, _I, _I, _I, _P),
    "dip_dilation_rect_u8": (_P, _P, _I, _I, _I, _P),
    "dip_dilation_plus_u8": (_P, _P, _I, _I, _I, _P),
    "dip_erosion_taps_u8": (_P, _P, _I, _I, _I, _P, _I, _P),
    "dip_dilation_taps_u8": (_P, _P, _I, _I, _I, _P, _I, _P),
    "dip_copy_f32": (_P, _P, _N, _P),
    "dip_inversion_f32": (_P, _P, _N, _P),
    "dip_threshold_f32": (_P, _P, _N, _P),
    "dip_grayscale_f32": (_P, _P, _N, _F, _F, _F, _P),
    "dip_erosion_rect_f32": (_P, _P, _I, _I, _I, _P),
    "dip_erosion_plus_f32": (_P, _P, _I, _I, _I, _P),
    "dip_erosion_sep_f32": (_P, _P, _I, _I, _I, _P),
    "dip_blur3x3_f32": (_P, _P, _I, _I, _I, _P),
    "dip_conv_dense_f32": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "dip_conv_sep_f32": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "dip_pipeline_f32": (_P, _P, _I, _I, _I, _F, _F, _F, _P),
    "dip_erosion_taps_f32": (_P, _P, _I, _I, _I, _P, _I, _P),
    "dip_chain_u8": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    "dip_chain_f32": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _F, _F, _F, _P),
    "dip_conv_tile_dense_u8": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    "dip_conv_tile_dense_mma_u8": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _I,
                                   _P),
    "dip_conv_tile_two_pass_u8": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                  _I, _I, _P),
    "dip_conv_tile_dense_f32": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    "dip_conv_tile_sep_f32": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    "dip_bake_u8": (_P, _P, _I, _I, _I, _I, _I, _P),
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


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands at once; (exit code, output) of each. Every
    process is waited for, or killed at the timeout, before this returns."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        results = []
        for p in procs:
            out = p.communicate(timeout=BUILD_TIMEOUT_S)[0]
            results.append((p.returncode, out))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> str:
    """Compile the library if it is not built yet; return its path. One
    nvcc process per source, all started together, then one link."""
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
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o,
                         os.path.join(CSRC, s)]
                        for s, o in zip(SOURCES, objs)]
        # Link to a private name, then rename: another process that loads
        # the library never sees a half-written file.
        tmp = os.path.join(work, LIB_NAME)
        link_cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", tmp, *objs]
        log = []
        try:
            for cmds in (compile_cmds, [link_cmd]):
                for cmd, (rc, out) in zip(cmds, _run_all(cmds)):
                    log.append(f"$ {' '.join(cmd)}\n{out}")
                    if rc != 0:
                        build_log = "\n".join(log)
                        raise KernelLibraryError(
                            f"nvcc failed (exit {rc}): {' '.join(cmd)}\n"
                            f"{out}")
        except (OSError, subprocess.TimeoutExpired) as e:
            raise KernelLibraryError(
                f"cannot run the CUDA compiler {nvcc!r}: {e}") from e
        build_log = "\n".join(log)
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

