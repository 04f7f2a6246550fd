"""The host-side C++ libraries (`entropy.cpp`, `samplewalk.cpp`), built on
first use with g++.

Each library is compiled with `-march=native` into
`build/cineform_tpu_torch/` at the checkout's root, keyed by a hash of its
source and of the host's instruction-set flags (a library built on one
machine can raise SIGILL on another), and loaded with ctypes at the first
call that needs it, never at import.  The build
writes into a temporary directory beside the target and renames the result
into place, so that parallel test workers can build at once, and holds
the library's `_build.build_lock`, so that threads of one process build
it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

from cineform_tpu_torch._build import BUILD_DIR, build_lock

_DIR = os.path.dirname(os.path.abspath(__file__))


def _machine_key() -> bytes:
    """The host's CPU feature flags, hashed."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(
                        " ".join(sorted(line.split())).encode()).digest()
    except OSError:
        pass
    return platform.machine().encode()


def library_path(name: str) -> str:
    """Path of the built library for `<name>.cpp`, building it if needed."""
    src = os.path.join(_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + _machine_key()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"host_{name}_{digest}.so")
    with build_lock(so_path):
        if os.path.exists(so_path):
            return so_path
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = os.path.join(tmp, f"{name}.so")
            subprocess.run(["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", "-o", tmp_so, src], check=True,
                           capture_output=True)
            os.replace(tmp_so, so_path)
    return so_path


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load `<name>.cpp`, declaring each function of
    `signatures` ({name: (restype, argtypes)})."""
    lib = ctypes.CDLL(library_path(name))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib
