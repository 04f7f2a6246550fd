"""Stereo 3D dual-channel samples: two eyes in one CFHD sample, on the
port's `IntraCodec`.

Port of the device route of `cineform_tpu.models.stereo` (`split_3d`,
`decode_batch_device_3d`) and of its encoder's sample layout
(`encode_sample_3d`), here on the codec's own transform.  The reference
encodes 3D by looping EncodeSample over the video channels, appending each
eye's complete bitstream 16-byte aligned into one sample
(`Codec/encoder.c:3407-3438`), with ENCODED_CHANNELS and
ENCODED_CHANNEL_NUMBER tags in each eye's header (`Codec/encoder.c:
7548-7556`) and a VCHN metadata tuple; the decoder picks an eye by its
TAG_CHANNELS_ACTIVE mask (`Codec/decoder.c:10086-10104`).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from cineform_tpu_torch.bitstream import parse_sample
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.models.intra_host import EncoderMetadata


def _align16(data: bytes) -> bytes:
    return data + b"\0" * (-len(data) % 16)


def encode_batch_3d(codec: IntraCodec, left: np.ndarray, right: np.ndarray,
                    first_frame_number: int = 1,
                    metadata: EncoderMetadata | None = None) -> list[bytes]:
    """Encode left/right batches of frames (`codec.encode_batch`'s input)
    into dual-channel 3D samples, one a frame pair."""
    meta = replace(metadata or EncoderMetadata(), video_channels=2)
    eyes = [codec.encode_batch(frames, first_frame_number, meta, eye=eye)
            for eye, frames in enumerate((left, right))]
    return [_align16(_align16(a) + b) for a, b in zip(*eyes)]


def split_3d(sample: bytes) -> list[bytes]:
    """Split a dual-channel sample into its per-eye bitstreams."""
    s = parse_sample(sample)
    if s.encoded_channels < 2 or not s.sample_end:
        return [sample]
    end = (s.sample_end + 15) & ~15
    return [sample[:end], sample[end:]]


def decode_batch_device_3d(samples: list[bytes], eye: int,
                           codec: IntraCodec):
    """Decode one eye (0 = left, 1 = right) of a batch of 3D samples on the
    device: split each sample into its per-eye bitstreams on the host and
    decode the eye's complete sub-samples with `codec.decode_batch_device`.
    Either eye takes the decoder's first dither window, as a fresh decoder
    decoding that eye does.  Returns `decode_batch_device`'s (frames,
    fallback)."""
    eye_samples = []
    for sample in samples:
        eyes = split_3d(sample)
        if eye >= len(eyes):
            raise ValueError(f"sample has {len(eyes)} video channels")
        eye_samples.append(eyes[eye])
    return codec.decode_batch_device(eye_samples)
