"""Keyframed Active Metadata: the linear interpolation of develop
parameters between control points.

A copy of the JAX package's `utils/keyframes.py`, trimmed to what
`models.active_metadata.develop_params_at` uses: a `Track` of (frame,
value) keyframes sampled with linear interpolation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Track:
    """Keyframes: sorted (frame, value) pairs; value is a scalar or a
    fixed-shape array."""

    frames: list
    values: list

    def __post_init__(self) -> None:
        order = np.argsort(self.frames)
        self.frames = [self.frames[i] for i in order]
        self.values = [np.asarray(self.values[i], dtype=np.float64)
                       for i in order]

    def sample(self, frame: float):
        f = self.frames
        v = self.values
        if frame <= f[0]:
            return v[0]
        if frame >= f[-1]:
            return v[-1]
        i = int(np.searchsorted(f, frame, side="right") - 1)
        t = (frame - f[i]) / (f[i + 1] - f[i])
        return v[i] * (1 - t) + v[i + 1] * t
