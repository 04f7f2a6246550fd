"""The reference of 8-bit YUY2 4:2:2 frames at the encoder's 10-bit
precision, decoded back to YUY2."""

import numpy as np

from cfbench.reference import codec, transform
from cfbench.reference.production import IntraParams


def params(cfg: dict) -> IntraParams:
    return IntraParams(width=cfg["width"], height=cfg["height"],
                       quality=cfg["quality"])


def planes(cfg: dict, frame: np.ndarray):
    raw = np.ascontiguousarray(frame).reshape(-1)
    return transform.unpack_yuy2(raw, cfg["width"], cfg["height"],
                                 params(cfg).precision)


def encode_sample(cfg: dict, frame: np.ndarray, frame_number: int,
                  lossy: bool = False) -> bytes:
    return codec.encode(params(cfg), planes(cfg, frame), frame_number, lossy)


def decode_output(cfg: dict, frame: np.ndarray, output: str,
                  lossy: bool = False) -> np.ndarray:
    if output != "YUY2":
        raise codec.unsupported(cfg, output)
    return codec.yuv422_output(params(cfg), planes(cfg, frame),
                               cfg["height"], lossy)
