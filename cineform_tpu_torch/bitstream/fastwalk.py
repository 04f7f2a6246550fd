"""ctypes bindings for the native sample header walk (native/samplewalk.cpp).

A copy of the JAX package's `bitstream/fastwalk.py`, whose walker sends
every stereo eye to the parser; this one walks an eye already split from
its stereo sample (`models.stereo.split_3d`) like a one-eye sample.

The decode hot path's host tail: one C pass per sample emits band
records (offsets into the sample buffer — no payload copies) and the
lowpass plane locations; `fill_rows` then memcpy's payloads straight
into the padded device row tensor and `lowpass_i32` expands the
big-endian lowpass pixels with the decoder's channel offset folded in.
The Python parser (bitstream/parser.py) remains the full-fidelity
oracle for anything the walker flags as complex (stereo samples,
truncated chunks).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from cineform_tpu_torch import native
from cineform_tpu_torch.utils import timing


class _Header(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("nchannels", ctypes.c_int32),
        ("transform_type", ctypes.c_int32),
        ("num_frames", ctypes.c_int32),
        ("sample_type", ctypes.c_int32),
        ("complex_flag", ctypes.c_int32),
        ("nbands", ctypes.c_int32),
        ("lowpass_off", ctypes.c_int64 * 4),
        ("lowpass_w", ctypes.c_int32 * 4),
        ("lowpass_h", ctypes.c_int32 * 4),
    ]


class _BandRec(ctypes.Structure):
    _fields_ = [
        ("channel", ctypes.c_int32),
        ("band", ctypes.c_int32),
        ("subband", ctypes.c_int32),
        ("quant", ctypes.c_int32),
        ("coding_flags", ctypes.c_int32),
        ("encoding", ctypes.c_int32),
        ("data_off", ctypes.c_int64),
        ("data_len", ctypes.c_int64),
        ("flags", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
    ]


_SIGNATURES = {
    "walk_sample": (ctypes.c_int64, [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(_Header), ctypes.POINTER(_BandRec), ctypes.c_int64,
    ]),
    "fill_rows": (None, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]),
    "lowpass_i32": (None, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]),
}


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return native.load("samplewalk", _SIGNATURES)


_MAX_BANDS = 64


@dataclass
class WalkResult:
    width: int
    height: int
    nchannels: int
    transform_type: int
    num_frames: int
    sample_type: int
    lowpass_off: tuple[int, ...]
    lowpass_w: tuple[int, ...]
    lowpass_h: tuple[int, ...]
    #: (channel, band, subband) -> (data_off, data_len, quant, lin, flags)
    bands: dict[tuple[int, int, int], tuple[int, int, int, int, int]]


def walk(sample: bytes) -> WalkResult | None:
    """Walk one sample's headers; None if the oracle parser is needed."""
    with timing.span("fastwalk.walk", 1):
        hdr = _Header()
        recs = (_BandRec * _MAX_BANDS)()
        n = _lib().walk_sample(sample, len(sample), ctypes.byref(hdr),
                             recs, _MAX_BANDS)
        if n < 0 or hdr.complex_flag:
            return None
        bands = {}
        for i in range(n):
            r = recs[i]
            bands[(r.channel, r.band, r.subband)] = (
                r.data_off, r.data_len, r.quant,
                1 if r.coding_flags == 18 else 0, r.flags)
        nch = hdr.nchannels
        return WalkResult(
            width=hdr.width, height=hdr.height, nchannels=nch,
            transform_type=hdr.transform_type, num_frames=hdr.num_frames,
            sample_type=hdr.sample_type,
            lowpass_off=tuple(hdr.lowpass_off[:nch]),
            lowpass_w=tuple(hdr.lowpass_w[:nch]),
            lowpass_h=tuple(hdr.lowpass_h[:nch]),
            bands=bands)


def fill_rows(dst: np.ndarray, sample: bytes, offs: np.ndarray,
              lens: np.ndarray, rows: np.ndarray) -> None:
    """dst[rows[i], :lens[i]] = sample[offs[i]:offs[i]+lens[i]] per i."""
    assert dst.dtype == np.uint8 and dst.flags.c_contiguous
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    _lib().fill_rows(dst.ctypes.data, dst.shape[1], sample, len(rows),
                   offs.ctypes.data, lens.ctypes.data, rows.ctypes.data)


def lowpass_i32(sample: bytes, off_bytes: int, h: int, w: int,
                bias: int, out: np.ndarray) -> None:
    """out[:] = big-endian int16 pixels at off_bytes (+ bias), int32."""
    assert out.dtype == np.int32 and out.flags.c_contiguous
    assert out.shape == (h, w)
    base = ctypes.cast(ctypes.c_char_p(sample), ctypes.c_void_p).value
    _lib().lowpass_i32(base + off_bytes, h * w, bias, out.ctypes.data)
