"""The frames of a configuration, made from the seed.

A configuration's `content` names a generator, `content/<content>.py`,
whose `make(cfg, seed)` gives the configuration's `frames` distinct
frames as one (N, H, row bytes) uint8 array in host memory, as a capture
or render source holds them.  Every seed gives the same set of frames up
to their noise, in another order, so the work of a run does not depend on
its seed.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of `seed` (any whole number) for one use `stream`."""
    return np.random.default_rng([seed & (2**64 - 1), *stream])


def noise(g: np.random.Generator, shape, dtype, mask: int) -> np.ndarray:
    """Uniform noise under `mask`, drawn in one call."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.frombuffer(g.bytes(n), dtype).reshape(shape) & mask
