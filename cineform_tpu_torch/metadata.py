"""The decoder-side CFHD metadata reader, on the host.

A copy of the reader half of the JAX package's `metadata.py`
(`MetadataItem`, `read_metadata`; `DecoderSDK/CFHDMetadata.cpp:640`): the
tuples of a sample's METADATA chunks, each a FOURCC tag, a 24-bit size, a
1-char type and a payload padded to 4 bytes (`CFHDMetadataTags.h:79-85`).
"""

from __future__ import annotations

from dataclasses import dataclass

from cineform_tpu_torch.bitstream import parse_sample


@dataclass
class MetadataItem:
    tag: str
    typ: bytes
    payload: bytes


def parse_block(blob: bytes) -> list[MetadataItem]:
    """The tuples of one METADATA chunk, in order."""
    items = []
    pos = 0
    while pos + 8 <= len(blob):
        tag = blob[pos:pos + 4].decode("latin1")
        size = int.from_bytes(blob[pos + 4:pos + 7], "little")
        typ = blob[pos + 7:pos + 8]
        payload = blob[pos + 8:pos + 8 + size]
        items.append(MetadataItem(tag, typ, payload))
        pos += 8 + size + ((-size) % 4)
    return items


def read_metadata(sample: bytes, parsed=None) -> list[MetadataItem]:
    """All metadata tuples from every METADATA chunk in a sample
    (CFHD_ReadMetadataFromSample, `DecoderSDK/CFHDMetadata.cpp:640`).
    `parsed` is the sample as `parse_sample` gives it, where the caller
    has it."""
    if parsed is None:
        parsed = parse_sample(sample)
    return [item for blob in parsed.metadata for item in parse_block(blob)]
