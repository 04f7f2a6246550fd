"""The BYR4 decode's log-to-linear table, on the host.

A copy of `log2lin_lut` from the JAX package's `ref/demosaic.py`, the one
piece of that module the port's BYR4 output needs.
"""

from __future__ import annotations

import numpy as np


def log2lin_lut() -> np.ndarray:
    """BYR4LinearRestore: 16384-entry log-to-linear LUT of the LOG-90
    curve (decoder.c:10742-10785 with CURVE_LOG2LIN's float truncation)."""
    curve_base = 90.0
    j = np.arange(16384, dtype=np.float64)
    i32 = (j.astype(np.float32) / np.float32(16384.0)).astype(np.float64)
    lin = (np.power(curve_base, i32) - 1.0) / (curve_base - 1.0)
    val = (lin.astype(np.float32) * np.float32(65535.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), 0, 65535).astype(np.uint16)
