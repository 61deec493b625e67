"""Build and bind the port's CUDA kernels (`dafs_tpu_torch/csrc/*.cu`).

All kernel sources compile, one nvcc process each and all at once, into one
shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so the build takes seconds).  The build happens at first use, from
the sources in the checkout only, into `build/dafs_tpu_torch/` beside the
package; the file name carries a hash of the sources and flags, so an edited
source is rebuilt.

Flags: `sm_90a` (Hopper) and `-fmad=false`.  The ProbCons LOG_ADD and EXP
polynomials must round every multiply and add separately, as the plain
PyTorch versions and the JAX reference do; `-fmad=false` stops nvcc from
contracting them into fused multiply-adds anywhere in the library.

Every exported launcher takes the stream last and returns
`cudaGetLastError()` after its launch; `CudaKernel` raises on a non-zero
return and counts the launches it made (a launcher that loops over a
scan's steps in C launches once a step, and its caller says how many).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "dafs_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
_COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"]

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the library if its hashed file is missing; return its path."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        with open(p, "rb") as fh:
            h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"libdafs_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        objects = [f"{tmp}.{os.path.basename(p)}.o" for p in sources]
        procs = [
            subprocess.Popen([_nvcc(), *_COMPILE_FLAGS, "-I", CSRC_DIR, "-c", "-o", o, p])
            for p, o in zip(sources, objects)
        ]
        failed = [p for p, proc in zip(sources, procs) if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objects], check=True)
        for o in objects:
            os.remove(o)
        os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.dafs_error_string.argtypes = [ctypes.c_int]
        lib.dafs_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CudaKernel:
    """One exported launcher of the library, with its launch count.

    `argtypes` lists the ctypes of the arguments before the stream.
    `loader` returns the library; the tests replace it to show that a
    failing launch raises.
    """

    def __init__(self, symbol: str, argtypes: list, loader=library):
        self.symbol = symbol
        self.argtypes = argtypes
        self.loader = loader
        self.launches = 0
        self._fn = None

    def __call__(self, *args, launches: int = 1) -> None:
        if self._fn is None:
            lib = self.loader()
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        lib, fn = self._fn
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err}: "
                f"{lib.dafs_error_string(err).decode()}"
            )
        self.launches += launches


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape
    on `device`."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
