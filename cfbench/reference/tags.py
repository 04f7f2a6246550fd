"""CFHD bitstream tag/value syntax constants.

A copy of the JAX package's `spec/tags.py`.

The CFHD sample is a sequence of 32-bit segments: a 16-bit big-endian tag
followed by a 16-bit big-endian value (`Codec/codec.h:182-199`).  A negative
tag (sign bit set) marks the pair as optional — decoders may skip unknown
optional tags (`Codec/codec.h:185`, NEG()).  Tags >= 0x2000 are chunk tags
whose value (plus, for the 0x2000/0x6000 classes, the low 8 bits of the tag)
gives the chunk payload size in 32-bit words so whole chunks can be skipped
(`Codec/codec.h:372-417`).

Tag numbers from the CODEC_TAG enumeration (`Codec/codec.h:201-359`).
"""

from __future__ import annotations

# --- small (non-chunk) tags ------------------------------------------------
ZERO = 0
SAMPLE = 1
INDEX = 2
ENTRY = 3
MARKER = 4
VERSION_MAJOR = 5
VERSION_MINOR = 6
VERSION_REVISION = 7
VERSION_EDIT = 8
SEQUENCE_FLAGS = 9
TRANSFORM_TYPE = 10
NUM_FRAMES = 11
NUM_CHANNELS = 12
NUM_WAVELETS = 13
NUM_SUBBANDS = 14
NUM_SPATIAL = 15
FIRST_WAVELET = 16
CHANNEL_SIZE = 17
GROUP_TRAILER = 18
FRAME_TYPE = 19
FRAME_WIDTH = 20
FRAME_HEIGHT = 21
FRAME_FORMAT = 22
FRAME_INDEX = 23
FRAME_TRAILER = 24
LOWPASS_SUBBAND = 25
NUM_LEVELS = 26
LOWPASS_WIDTH = 27
LOWPASS_HEIGHT = 28
MARGIN_TOP = 29
MARGIN_BOTTOM = 30
MARGIN_LEFT = 31
MARGIN_RIGHT = 32
PIXEL_OFFSET = 33
QUANTIZATION = 34
PIXEL_DEPTH = 35
LOWPASS_TRAILER = 36
WAVELET_TYPE = 37
WAVELET_NUMBER = 38
WAVELET_LEVEL = 39
NUM_BANDS = 40
HIGHPASS_WIDTH = 41
HIGHPASS_HEIGHT = 42
LOWPASS_BORDER = 43
HIGHPASS_BORDER = 44
LOWPASS_SCALE = 45
LOWPASS_DIVISOR = 46
HIGHPASS_TRAILER = 47
BAND_NUMBER = 48
BAND_WIDTH = 49
BAND_HEIGHT = 50
BAND_SUBBAND = 51
BAND_ENCODING = 52
BAND_QUANTIZATION = 53
BAND_SCALE = 54
BAND_HEADER = 55
BAND_TRAILER = 56
NUM_ZEROVALUES = 57
NUM_ZEROTREES = 58
NUM_POSITIVES = 59
NUM_NEGATIVES = 60
NUM_ZERONODES = 61
CHANNEL = 62
INTERLACED_FLAGS = 63
PROTECTION_FLAGS = 64
PICTURE_ASPECT_X = 65
PICTURE_ASPECT_Y = 66
SUBBAND = 67
SAMPLE_FLAGS = 68
FRAME_NUMBER = 69
PRECISION = 70
INPUT_FORMAT = 71
BAND_CODING_FLAGS = 72
INPUT_COLORSPACE = 73
PEAK_LEVEL = 74
PEAK_TABLE_OFFSET_L = 75
PEAK_TABLE_OFFSET_H = 76
SAMPLE_END = 77
VERSION = 79
QUALITY_L = 80
QUALITY_H = 81
BAND_SECONDPASS = 82
PRESCALE_TABLE = 83
ENCODED_FORMAT = 84
FRAME_DISPLAY_HEIGHT = 85
FRAME_DISPLAY_WIDTH = 86
ENCODED_COLORSPACE = 91
ENCODED_CHANNELS = 92
ENCODED_CHANNEL_NUMBER = 93
ENCODED_CHANNEL_QUALITY = 94
SKIP = 95
PRESENTATION_HEIGHT = 96
PRESENTATION_WIDTH = 97
NOP = 128

# --- chunk tag classes (`codec.h:372-417`) ----------------------------------
CHUNK24BIT = 0x2000         # 24-bit size: (tag & 0xFF) << 16 | value
SUBBAND_SIZE = 0x2000
LEVEL_SIZE = 0x2100
SAMPLE_SIZE = 0x2200
UNCOMPRESSED = 0x2300
CHUNK = 0x4000              # 16-bit size in the value
PEAK_TABLE = 0x4001
METADATA_CHUNK = 0x4002
CUSTOM_CHUNK24BIT = 0x6000  # 24-bit size; skip if unrecognized
METADATA_LARGE = 0x6000

TAG_NAMES = {
    v: k for k, v in list(globals().items())
    if isinstance(v, int) and k.isupper() and not k.startswith("_")
}

# --- bitstream markers (`Codec/codec.c:118-147`) -----------------------------
FRAME_START_CODE = 0x0A0A
FRAME_END_CODE = 0x0B0B
LOWPASS_START_CODE = 0x1A4A
LOWPASS_END_CODE = 0x1B4B
HIGHPASS_START_CODE = 0x0D0D
HIGHPASS_END_CODE = 0x0C0C
BAND_START_CODE = 0x0E0E
SAMPLE_STOP_CODE = 0x1E1E
COEFFICIENT_START_CODE = 0x0F0F
CHANNEL_START_CODE = 0x1F0F

# --- sample types (`Codec/codec.h:937-961`) ---------------------------------
SAMPLE_TYPE_NONE = 0
SAMPLE_TYPE_FRAME = 1
SAMPLE_TYPE_GROUP = 2
SAMPLE_TYPE_CHANNEL = 3
SAMPLE_TYPE_GROUP_TRAILER = 6
SAMPLE_TYPE_SEQUENCE_HEADER = 7
SAMPLE_TYPE_SEQUENCE_TRAILER = 8
SAMPLE_TYPE_IFRAME = 9

# --- transform / wavelet types (`Codec/wavelet.h:74-131`) --------------------
TRANSFORM_TYPE_SPATIAL = 0
TRANSFORM_TYPE_FIELD = 1
TRANSFORM_TYPE_FIELDPLUS = 2
TRANSFORM_TYPE_FRAME = 3
TRANSFORM_TYPE_INTERLACED = 4

WAVELET_TYPE_HORIZONTAL = 1
WAVELET_TYPE_VERTICAL = 2
WAVELET_TYPE_SPATIAL = 3    # horizontal-vertical
WAVELET_TYPE_TEMPORAL = 4
WAVELET_TYPE_HORZTEMP = 5
WAVELET_TYPE_VERTTEMP = 6

# --- band encoding methods (`Codec/codec.h:172-178`) -------------------------
BAND_ENCODING_ZEROTREE = 1
BAND_ENCODING_CODEBOOK = 2
BAND_ENCODING_RUNLENGTHS = 3
BAND_ENCODING_16BIT = 4
BAND_ENCODING_LOSSLESS = 5

# --- sample flags (`Codec/codec.h:432+`) -------------------------------------
SAMPLE_FLAGS_PROGRESSIVE = 1

# --- precision (`Codec/codec.h:163-168`) -------------------------------------
PRECISION_8BIT = 8
PRECISION_10BIT = 10
PRECISION_12BIT = 12
PRECISION_DEFAULT = 8

# --- encoded formats (CFHDTypes.h:233-240 / codec.h ENCODED_FORMAT) ----------
ENCODED_FORMAT_YUV_422 = 1
ENCODED_FORMAT_BAYER = 2
ENCODED_FORMAT_RGB_444 = 3
ENCODED_FORMAT_RGBA_4444 = 4

# --- color spaces (`Codec/color.h` COLOR_SPACE bits) -------------------------
COLOR_SPACE_BT_601 = 1
COLOR_SPACE_BT_709 = 2
COLOR_SPACE_VS_RGB = 4

# --- internal color formats (`Codec/color.h` COLOR_FORMAT) -------------------
COLOR_FORMAT_YUYV = 2       # the YUY2 internal input-format code
COLOR_FORMAT_UYVY = 3

# --- encoder version stamped into CODEC_TAG_VERSION --------------------------
# (FILE_VERSION_NUMERIC {10,1,0,...}: value 0xA100 observed from the
# reference build; ver<<12 | subver<<8 | subsubver, `codec.c:982-991`)
FILE_VERSION_CODE = 0xA100
