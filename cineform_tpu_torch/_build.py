"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` holds one kernel with a plain C entry point.  At
first use it is compiled by nvcc for Hopper (`sm_90a`) into a shared
library under `build/cineform_tpu_torch/` at the checkout's root, keyed by
a hash of the source and the flags, and loaded with ctypes.  No PyTorch
headers are included, so a build takes seconds.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.  A build holds its library's lock (`build_lock`),
so that threads that reach a kernel together (the pools' batcher and
decode threads) build it once, while different libraries build at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from functools import lru_cache

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cineform_tpu_torch")

_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build_lock(so_path: str) -> threading.Lock:
    """The lock that a build of the library `so_path`, CUDA or host C++,
    holds."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(so_path, threading.Lock())


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu, building it if needed.

    nvcc's output (with `-Xptxas -v`: registers, shared memory, spills per
    kernel) is kept beside the library as `<library>.log`."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    with build_lock(so_path):
        if os.path.exists(so_path):
            return so_path
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, f"{name}.so")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp_so, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            with open(so_path + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp_so, so_path)
    return so_path


def uses_kernel(name: str, t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for `t`: True on a CUDA
    device, False on the CPU (the wrapper runs its plain version); any
    other device raises, so nothing falls back off the CPU."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


@lru_cache(maxsize=None)
def _entry(source: str, symbol: str, argtypes: tuple):
    fn = getattr(ctypes.CDLL(library_path(source)), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]      # ..., cudaStream_t
    return fn


def launch(wrapper, source: str, symbol: str, argtypes: tuple, *args) -> None:
    """Call the C entry point `symbol` of csrc/<source>.cu on the current
    stream of its tensors' device and count the launch in
    `wrapper.launches`.

    Tensor arguments must be contiguous and on one CUDA device; they are
    passed as pointers, the others as `argtypes` says.  The entry point
    returns cudaGetLastError() after the launch; a nonzero code raises."""
    name = wrapper.__name__
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
    fn = _entry(source, symbol, argtypes)
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else a for a in args]
    with torch.cuda.device(dev):
        rc = fn(*c_args,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    wrapper.launches += 1
