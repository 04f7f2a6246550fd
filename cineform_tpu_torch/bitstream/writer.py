"""CFHD sample writer: tag/value syntax + chunk size patching.

A copy of the JAX package's `bitstream/writer.py`.

Byte-level contract: 16-bit BE tag + 16-bit BE value segments
(`Codec/bitstream.c:1234` PutTagPair over MSB-first PutBits), optional tags
negated (`OPTIONALTAG`), chunk sizes patched in place after the payload is
written (`Codec/bitstream.c` SizeTagPush/SizeTagPop: size in 32-bit words,
excluding the tag pair itself; 0x2000-class tags carry the top 8 size bits
in the tag's low byte).
"""

from __future__ import annotations

import struct

from cineform_tpu_torch.spec import tags


class SampleWriter:
    """Append-only byte buffer with tag helpers and chunk patching."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self._chunk_stack: list[int] = []
        self._bitacc = 0
        self._bitcnt = 0

    # --- raw bit/word output -------------------------------------------------

    def put_bits(self, bits: int, size: int) -> None:
        """MSB-first bit packing (`Codec/bitstream.c:996`)."""
        self._bitacc = (self._bitacc << size) | (bits & ((1 << size) - 1))
        self._bitcnt += size
        while self._bitcnt >= 8:
            self._bitcnt -= 8
            self.buf.append((self._bitacc >> self._bitcnt) & 0xFF)
        self._bitacc &= (1 << self._bitcnt) - 1

    def pad_to_tag(self) -> None:
        """PadBitsTag: zero-fill to the next 32-bit boundary."""
        if self._bitcnt:
            self.put_bits(0, 8 - self._bitcnt)
        while len(self.buf) % 4:
            self.buf.append(0)

    def put_bytes(self, data: bytes) -> None:
        assert self._bitcnt == 0
        self.buf += data

    # --- tag/value pairs -----------------------------------------------------

    def put_tag(self, tag: int, value: int) -> None:
        assert self._bitcnt == 0 and len(self.buf) % 2 == 0
        self.buf += struct.pack(">HH", tag & 0xFFFF, value & 0xFFFF)

    def put_tag_optional(self, tag: int, value: int) -> None:
        self.put_tag((-tag) & 0xFFFF, value)

    def put_marker(self, code: int) -> None:
        """PutTagMarker: a required MARKER pair (`Codec/bitstream.c`)."""
        self.put_tag(tags.MARKER, code)

    def patch_tag_value(self, offset: int, value: int) -> None:
        """Rewrite the 16-bit value of the tag pair at byte `offset`
        (the reference patches peak-table offsets the same way,
        `Codec/encoder.c:6560-6567`)."""
        self.buf[offset + 2:offset + 4] = struct.pack(">H", value & 0xFFFF)

    # --- chunk handling -------------------------------------------------------

    def push_chunk(self, tag: int) -> None:
        """SizeTagPush: write a placeholder pair, patch on pop."""
        self._chunk_stack.append(len(self.buf))
        self.put_tag(tag, 0)

    def pop_chunk(self) -> None:
        """SizeTagPop (`Codec/bitstream.c:1553-1608`)."""
        off = self._chunk_stack.pop()
        tag = struct.unpack(">H", self.buf[off:off + 2])[0]
        size = len(self.buf) - off
        size = (size >> 2) - 1 if size >= 4 else 0
        if tag & 0x2000 and not tag & 0x4000:
            tag |= (size >> 16) & 0xFF
            size &= 0xFFFF
        else:
            size &= 0xFFFF
        tag = (-tag) & 0xFFFF  # chunks are always emitted optional
        self.buf[off:off + 4] = struct.pack(">HH", tag, size)

    # --- index patching -------------------------------------------------------

    def put_index_placeholder(self, count: int) -> int:
        """PutGroupIndex with empty entries (`Codec/codec.c:1107-1135`).

        Returns the byte offset of the entry vector for later patching.
        """
        self.put_tag(tags.INDEX, count)
        off = len(self.buf)
        for i in range(count):
            self.put_tag(tags.ENTRY, i)
        return off

    def patch_index(self, off: int, sizes: list[int]) -> None:
        """Overwrite index entries with 32-bit BE channel sizes."""
        for i, size in enumerate(sizes):
            self.buf[off + 4 * i: off + 4 * i + 4] = struct.pack(">I", size)

    def getvalue(self) -> bytes:
        assert not self._chunk_stack and self._bitcnt == 0
        return bytes(self.buf)
