"""ctypes bindings for the native band entropy codec (native/entropy.cpp).

Encodes and decodes whole bands on the host, byte for byte as the
reference does.  The tables come from `spec.codebooks`, so the format
constants have one source in this package.  A copy of the JAX package's
`entropy/native.py`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from cineform_tpu_torch import native
from cineform_tpu_torch.spec import codebooks as cb

_SIGNATURES = {
    "encode_band": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_int64,                     # values, n
        ctypes.c_void_p, ctypes.c_void_p,                    # valuebook
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # runbook
        ctypes.c_uint32, ctypes.c_int,                       # band end
        ctypes.c_void_p, ctypes.c_int64,                     # out
    ]),
    "decode_band_ex": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int,
    ]),
}


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return native.load("entropy", _SIGNATURES)


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


@lru_cache(maxsize=None)
class _EncodeTables:
    def __init__(self, codeset: int) -> None:
        cs = cb.get_codeset(codeset)
        vb_size, vb_bits = cb.build_valuebook(codeset)
        rb_size, rb_count, rb_bits = cb.build_runbook(codeset)
        self.vb_size = np.ascontiguousarray(vb_size, dtype=np.int32)
        self.vb_bits = np.ascontiguousarray(vb_bits, dtype=np.uint32)
        self.rb_size = np.ascontiguousarray(rb_size, dtype=np.int32)
        self.rb_count = np.ascontiguousarray(rb_count, dtype=np.int32)
        self.rb_bits = np.ascontiguousarray(rb_bits, dtype=np.uint32)
        self.bandend_bits = cs.bandend_bits
        self.bandend_size = cs.bandend_size


@lru_cache(maxsize=None)
class _DecodeTables:
    LUT_BITS = 12

    def __init__(self, codeset: int) -> None:
        cs = cb.get_codeset(codeset)
        n = 1 << self.LUT_BITS
        lut_size = np.zeros(n, dtype=np.int32)
        lut_count = np.zeros(n, dtype=np.int32)
        lut_value = np.zeros(n, dtype=np.int32)
        longs: list[tuple[int, int, int, int]] = []
        for size, bits, count, value in cs.rlv.tolist():
            ev = cb.expand_code(value, cs.flags)
            if size <= self.LUT_BITS:
                lo = bits << (self.LUT_BITS - size)
                hi = (bits + 1) << (self.LUT_BITS - size)
                if lut_size[lo] == 0:
                    lut_size[lo:hi] = size
                    lut_count[lo:hi] = count
                    lut_value[lo:hi] = ev
            else:
                longs.append((size, bits, count, ev))
        longs.sort()
        self.lut_size = lut_size
        self.lut_count = lut_count
        self.lut_value = lut_value
        self.long_size = np.array([x[0] for x in longs], dtype=np.int32)
        self.long_bits = np.array([x[1] for x in longs], dtype=np.uint32)
        self.long_count = np.array([x[2] for x in longs], dtype=np.int32)
        self.long_value = np.array([x[3] for x in longs], dtype=np.int32)
        self.bandend_bits = cs.bandend_bits
        self.bandend_size = cs.bandend_size


def encode_band_bytes(values: np.ndarray, codeset: int = 17) -> bytes:
    """Encode a (pitch-padded) quantized band straight to packed bytes
    (byte-aligned; caller pads to 32-bit)."""
    t = _EncodeTables(codeset)
    flat = np.ascontiguousarray(values.ravel(), dtype=np.int32)
    cap = flat.size * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = _lib().encode_band(
        _ptr(flat), flat.size,
        _ptr(t.vb_size), _ptr(t.vb_bits),
        _ptr(t.rb_size), _ptr(t.rb_count), _ptr(t.rb_bits),
        t.bandend_bits, t.bandend_size,
        _ptr(out), cap)
    if n < 0:
        raise ValueError("entropy encode overflow")
    return out[:n].tobytes()


def decode_band(data: bytes, num_coeffs: int, codeset: int = 17,
                quant: int = 1, start_bit: int = 0,
                tolerant: bool = True) -> tuple[np.ndarray, int]:
    """Decode one band; returns (int32 dequantized coefficients, end bit).

    Dequantization uses the int16-wrapping multiply of DeQuantFSM
    (`Codec/decoder.c:20551`).  By default the decode is error-tolerant
    like the reference's ERROR_TOLERANT=1 build (decoder.c:128): a
    corrupt payload returns the reference's exact partial decode (the
    caller's band boundaries come from the trailer-tag scan, our
    SkipSubband equivalent) instead of raising.  Pass tolerant=False
    for the strict mode used by encoder self-checks."""
    t = _DecodeTables(codeset)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(num_coeffs, dtype=np.int32)
    end = _lib().decode_band_ex(
        _ptr(buf), buf.size, start_bit, num_coeffs,
        _ptr(t.lut_size), _ptr(t.lut_count), _ptr(t.lut_value), t.LUT_BITS,
        _ptr(t.long_size), _ptr(t.long_bits), _ptr(t.long_count),
        _ptr(t.long_value), len(t.long_size),
        t.bandend_bits, t.bandend_size,
        quant, _ptr(out), 1 if tolerant else 0)
    if end < 0:
        raise ValueError("entropy decode error")
    return out, int(end)
