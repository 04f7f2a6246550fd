"""Encoder override database: disk .colr blocks + metadata-tag overrides.

A copy of the JAX package's `utils/override_db.py` trimmed to the reading
of the overrides (`default_paths`, `load_disk_blocks`, `iter_tuples`,
`parse_overrides`): the API decides its encode route from them as the
JAX API does.

The reference encoder re-reads two metadata blocks from disk around every
EncodeSample and lets their tags (and the attached metadata block) change
encoder behavior (`Codec/encoder.c:8792` OverrideEncoderSettings,
`encoder.c:9044` UpdateEncoderOverrides, call order `encoder.c:2070-2078`):

  1. the attached (local) metadata block,
  2. ``<LUTPath>/<DBPath>/defaults.colr``  (base data),
  3. ``<OverridePath>/override.colr``      (force data, highest priority).

On Linux the paths are fixed (`Codec/lutpath.h:39-41`):
OverridePath=/var/cineform/public, LUTPath=/var/cineform/public/LUTs,
DBPath=db; the user-prefs file parse is a stub (`lutpath.cpp:743-751`).
CINEFORM_OVERRIDE_PATH / CINEFORM_LUT_PATH / CINEFORM_DB_PATH override
them here (tests point them at temp dirs).

Hidden ('H') tuples drive the encoder but are stripped from the metadata
written into samples (`encoder.c:8906` RemoveHiddenMetadata) — confirmed
against the reference binary: an override.colr with LYUV=1 changes the
encoded pixel data while the sample's metadata chunks stay identical.
"""

from __future__ import annotations

import os
import struct

# tags handled by UpdateEncoderOverrides (`Codec/encoder.c:9056-9094`)
OVERRIDE_TAGS = {
    "LYUV": "limit_yuv",          # full-range 0-255 -> 16-235 (10-bit)
    "CV67": "conv_601_709",       # Canon DSLR 601 -> 709 fix
    "CLSY": "colorspace_yuv",     # 1 = 601, 2 = 709
    "ECRV": "encode_curve",
    "PCRV": "encode_curve_preset",
    "BFMT": "bayer_format",
    "VDCH": "video_channels",
    "VDCG": "video_channel_gap",
    "IGND": "ignore_database",
}


def default_paths() -> tuple[str, str, str]:
    """(override_path, luts_path, db_path) per the reference's Linux
    defaults, overridable via environment for tests."""
    return (os.environ.get("CINEFORM_OVERRIDE_PATH", "/var/cineform/public"),
            os.environ.get("CINEFORM_LUT_PATH", "/var/cineform/public/LUTs"),
            os.environ.get("CINEFORM_DB_PATH", "db"))


def load_disk_blocks() -> tuple[bytes, bytes]:
    """(base defaults.colr, force override.colr) metadata blocks; empty
    bytes when absent (`encoder.c:8820-8884`)."""
    override_path, luts_path, db_path = default_paths()
    out = []
    for path in (os.path.join(luts_path, db_path, "defaults.colr"),
                 os.path.join(override_path, "override.colr")):
        try:
            with open(path, "rb") as f:
                out.append(f.read())
        except OSError:
            out.append(b"")
    return out[0], out[1]


def iter_tuples(block: bytes):
    """Yield (tag fourcc bytes, type, payload) from a metadata block
    (`encoder.c:9052-9095` walk: entries padded to 4 bytes)."""
    pos = 0
    n = len(block)
    while pos + 8 <= n:
        tag = block[pos:pos + 4]
        if tag == b"\0\0\0\0":
            return
        size = (block[pos + 4] | (block[pos + 5] << 8)
                | (block[pos + 6] << 16))
        typ = block[pos + 7]
        payload = block[pos + 8:pos + 8 + size]
        yield tag, typ, payload
        pos += (8 + size + 3) & ~3


def parse_overrides(*blocks: bytes) -> dict[str, int]:
    """Apply blocks in priority order (later wins) and return the
    recognized override fields as a dict."""
    out: dict[str, int] = {}
    for block in blocks:
        if not block:
            continue
        for tag, typ, payload in iter_tuples(block):
            name = OVERRIDE_TAGS.get(tag.decode("latin1"))
            if name and len(payload) >= 4:
                out[name] = struct.unpack("<I", payload[:4])[0]
            if tag == b"PRXY":    # TAG_PROXY_COPY: do not apply twice
                out["limit_yuv"] = 0
                out["conv_601_709"] = 0
    return out
