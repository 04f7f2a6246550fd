"""The reference of BYR4 Bayer mosaics (16-bit little-endian, rows R G /
G B): four quarter-size planes at 12 bits with the RGB gains of
`rgb_quality` 3 that the encoder forces (`Codec/encoder.c:2637`),
decoded to RG48 through the raw DemosaicRAW chain."""

import numpy as np

from cfbench.reference import codec, tags, transform
from cfbench.reference.production import IntraParams


def params(cfg: dict) -> IntraParams:
    return IntraParams(width=cfg["width"] // 2, height=cfg["height"] // 2,
                       quality=cfg["quality"],
                       precision=tags.PRECISION_12BIT, chroma_full_res=True,
                       rgb_quality=3)


def planes(cfg: dict, frame: np.ndarray):
    raw = np.ascontiguousarray(frame).reshape(-1)
    return transform.unpack_byr4(raw.view("<u2"), cfg["width"],
                                 cfg["height"])


def encode_sample(cfg: dict, frame: np.ndarray, frame_number: int,
                  lossy: bool = False) -> bytes:
    return codec.encode(params(cfg), planes(cfg, frame), frame_number, lossy,
                        input_format=104,
                        encoded_format=tags.ENCODED_FORMAT_BAYER,
                        colorspace=None)


def decode_output(cfg: dict, frame: np.ndarray, output: str,
                  lossy: bool = False) -> np.ndarray:
    if output != "RG48":
        raise codec.unsupported(cfg, output)
    return codec.bayer_rg48_output(params(cfg), planes(cfg, frame),
                                   cfg["height"], lossy)
