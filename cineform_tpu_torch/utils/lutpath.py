"""CFHD look-LUT database, the reader: `.cflook` files resolved by CRC, the
`Codec/lutpath.cpp` + `DemoasicFrames.cpp:4988` (LoadCube64_3DLUT) analog.

A copy of the reading half of the JAX package's `utils/lutpath.py`.  A
look is a 3D LUT (size 8..65 per axis, float32 RGB) stored as:

    CFLook_Header (AVIExtendedHeader.h:427, little-endian on disk with a
    byte-swapped 'CFLK' magic marking big-endian files):
      u32 'CFLK' | u32 version (2) | u32 hdrsize | u32 lutsize
      u32 input_curve | u32 output_curve | char displayname[40]
    then lutsize^3 * 3 float32s at hdrsize.

Files live in a LUTs directory named '%08X.cflook' by the look CRC
(DemoasicFrames.cpp:5101); the Bayer decode resolves TAG_LOOK_CRC
metadata against it (`models.active_metadata.resolve_look`).  The reader
only reads: it creates no directory.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

_MAGIC = int.from_bytes(b"CFLK", "little")
_HDR_FMT = "<6I40s"
_HDR_SIZE = struct.calcsize(_HDR_FMT)


@dataclass
class Look:
    lut: np.ndarray                 # (N, N, N, 3) float32, R-fastest
    name: str = ""
    input_curve: int = 0
    output_curve: int = 0

    @property
    def size(self) -> int:
        return self.lut.shape[0]


def read_cflook(path: str) -> Look:
    with open(path, "rb") as f:
        buf = f.read()
    magic, version, hdrsize, lutsize, ic, oc, name = struct.unpack_from(
        _HDR_FMT, buf, 0)
    if magic == _MAGIC:
        e = "<"
    elif magic == int.from_bytes(b"CFLK", "big"):
        e = ">"
        version, hdrsize, lutsize, ic, oc = (
            int.from_bytes(x.to_bytes(4, "little"), "big")
            for x in (version, hdrsize, lutsize, ic, oc))
    else:
        raise ValueError("not a CFLook file")
    if not 8 <= lutsize <= 65:
        raise ValueError(f"bad lut size {lutsize}")
    lut = np.frombuffer(buf, dtype=e + "f4", count=lutsize ** 3 * 3,
                        offset=hdrsize).reshape(lutsize, lutsize, lutsize, 3)
    return Look(lut=np.asarray(lut), name=name.rstrip(b"\0").decode(),
                input_curve=ic, output_curve=oc)


class LookDatabase:
    """Directory of %08X.cflook files, resolved by CRC like the reference's
    LUTs path (decoder->LUTsPathStr)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._cache: dict[int, Look] = {}

    def path_for(self, crc: int) -> str:
        return os.path.join(self.directory, "%08X.cflook" % (crc & 0xFFFFFFFF))

    def load(self, crc: int) -> Look | None:
        """Resolve a TAG_LOOK_CRC value; cached like decoder->LUTcache."""
        if crc in self._cache:
            return self._cache[crc]
        path = self.path_for(crc)
        if not os.path.exists(path):
            return None
        look = read_cflook(path)
        self._cache[crc] = look
        return look


def default_lut_dir() -> str:
    """The decoder's LUTs directory: <LUTPath>/LUTs with LUTPath from
    $HOME/.cineform/dbsettings (`Codec/lutpath.cpp:130-233`; the
    reference appends "/LUTs" to the configured base), else
    $HOME/.cineform/LUTs.

    NOTE: the reference's prefs scanner does not NUL-terminate the
    parsed path over the compiled-in default "/var/cineform/public"
    (20 chars), so bases SHORTER than 20 characters are corrupted by
    the binary (e.g. "/home/u/.cineform" reads back as
    "/home/u/.cineformlic"); use a base of at least 20 characters for
    interop with the reference decoder."""
    home = os.environ.get("HOME", ".")
    prefs = os.path.join(home, ".cineform", "dbsettings")
    try:
        with open(prefs, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line.startswith("#"):
                    continue
                if line.startswith("LUTPath"):
                    val = line[len("LUTPath"):].strip().strip('"').strip()
                    if val:
                        return os.path.join(val, "LUTs")
    except OSError:
        pass
    return os.path.join(home, ".cineform", "LUTs")
