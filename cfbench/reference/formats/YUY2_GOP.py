"""The reference of 8-bit YUY2 frame pairs encoded as 2-frame GOP groups
(`CFHD_ENCODING_FLAGS_YUV_2FRAME_GOP`, progressive) at the encoder's
10-bit precision, each frame of a group decoded to V210, YU64 or YUY2:
`reference/gop.py`.  The cells that use it check decodes only, so it
writes no GROUP sample."""

import numpy as np

from cfbench.reference import gop, tags, transform


def planes(cfg: dict, frame: np.ndarray):
    """A YUY2 frame (H, row bytes) -> its [Y, V, U] int32 planes."""
    raw = np.ascontiguousarray(frame).reshape(-1)
    return transform.unpack_yuy2(raw, cfg["width"], cfg["height"],
                                 tags.PRECISION_10BIT)


def decode_output(cfg: dict, pair: np.ndarray, output: str,
                  lossy: bool = False, frame: int = 0,
                  window: int = 0) -> np.ndarray:
    """Frame `frame` of the group of `pair` (2, H, row bytes), decoded to
    `output` as the `window`-th frame a decoder emits (the YUY2 dither's),
    as (H, row bytes) uint8."""
    out = gop.decode_pair(planes(cfg, pair[0]), planes(cfg, pair[1]),
                          cfg["quality"], frame, output, lossy, window)
    return np.frombuffer(out, np.uint8).reshape(cfg["height"], -1)
