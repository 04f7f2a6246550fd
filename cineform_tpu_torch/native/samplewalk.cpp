// Native CFHD sample header walk for the device-decode hot path.
//
// Re-expresses the tag/value walk of the reference decoder's
// ParseSampleHeader + DecodeSampleIntraFrame tag loop
// (`Codec/decoder.c:2140`, `Codec/decoder.c:11584`) as a single pass
// that emits band records (offsets/lengths into the caller's buffer,
// no payload copies) plus the per-channel lowpass locations.  The
// Python parser (bitstream/parser.py) stays the full-fidelity oracle;
// this walker covers the common intra fast path and reports anything
// unusual (stereo dual-channel samples, truncated chunks) through the
// `complex` flag so the caller can fall back to the oracle.  One eye's
// bitstream already split from a stereo sample (`models/stereo.split_3d`:
// the eye, then at most 15 bytes of alignment) walks as a one-eye sample.
//
// fill_rows then memcpy's the band payloads straight from the sample
// buffer into the caller's padded row tensor — the one copy the host
// tail actually needs (the Python path sliced every payload into a
// bytes object and copied again into the tensor).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// tag numbers (`Codec/codec.h:201-359`)
enum {
    TAG_SAMPLE = 1,
    TAG_INDEX = 2,
    TAG_TRANSFORM_TYPE = 10,
    TAG_NUM_FRAMES = 11,
    TAG_NUM_CHANNELS = 12,
    TAG_FRAME_WIDTH = 20,
    TAG_FRAME_HEIGHT = 21,
    TAG_FRAME_TRAILER = 24,
    TAG_LOWPASS_SUBBAND = 25,
    TAG_LOWPASS_WIDTH = 27,
    TAG_LOWPASS_HEIGHT = 28,
    TAG_BAND_NUMBER = 48,
    TAG_BAND_WIDTH = 49,
    TAG_BAND_HEIGHT = 50,
    TAG_BAND_SUBBAND = 51,
    TAG_BAND_ENCODING = 52,
    TAG_BAND_QUANTIZATION = 53,
    TAG_CHANNEL = 62,
    TAG_SAMPLE_FLAGS = 68,
    TAG_BAND_CODING_FLAGS = 72,
    TAG_PEAK_LEVEL = 74,
    TAG_ENCODED_CHANNELS = 92,
};
enum {
    CHUNK24BIT = 0x2000,
    SUBBAND_SIZE = 0x2000,
    LEVEL_SIZE = 0x2100,
    SAMPLE_SIZE = 0x2200,
    CHUNK = 0x4000,
    PEAK_TABLE = 0x4001,
    CUSTOM_CHUNK24BIT = 0x6000,
};

struct BandRec {
    int32_t channel;
    int32_t band;
    int32_t subband;
    int32_t quant;
    int32_t coding_flags;
    int32_t encoding;
    int64_t data_off;
    int64_t data_len;
    int32_t flags;  // bit0: peaks/peak_level present
    int32_t pad_;
};

struct Header {
    int32_t width;
    int32_t height;
    int32_t nchannels;      // CHANNEL/SAMPLE_FLAGS sections seen
    int32_t transform_type;
    int32_t num_frames;
    int32_t sample_type;
    int32_t complex_flag;   // caller must use the Python oracle parser
    int32_t nbands;
    int64_t lowpass_off[4]; // byte offset of raw >i2 lowpass pixels
    int32_t lowpass_w[4];
    int32_t lowpass_h[4];
};

}  // namespace

extern "C" {

// Walk one sample; fill hdr and up to max_bands band records.
// Returns the number of bands, or -1 if the walk ran off the end /
// overflowed max_bands (hdr->complex_flag is also set in that case).
int64_t walk_sample(const uint8_t* data, int64_t n, Header* hdr,
                    BandRec* bands, int64_t max_bands) {
    memset(hdr, 0, sizeof(*hdr));
    hdr->num_frames = 1;
    int64_t pos = 0;
    int64_t nbands = 0;
    int chan = -1;          // current channel index (list order)
    int pending_lowpass = 0;
    int stereo = 0;         // ENCODED_CHANNELS > 1 seen
    BandRec cur;            // staged band fields ahead of its chunk
    memset(&cur, 0, sizeof(cur));
    cur.quant = 1;

    while (pos + 4 <= n) {
        int tag = (int16_t)((data[pos] << 8) | data[pos + 1]);
        unsigned value = (data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        int at = tag < 0 ? -tag : tag;

        if (at >= CUSTOM_CHUNK24BIT) {
            pos += (int64_t)(((at & 0xFF) << 16) | value) * 4;
            continue;
        }
        if (at >= CHUNK) {
            if (at == PEAK_TABLE && nbands > 0)
                bands[nbands - 1].flags |= 1;
            pos += (int64_t)value * 4;
            continue;
        }
        if (at >= CHUNK24BIT) {
            int64_t size = (int64_t)(((at & 0xFF) << 16) | value) * 4;
            int kind = at & 0xFF00;
            if (kind == SUBBAND_SIZE) {
                if (pos + size > n) { hdr->complex_flag = 1; return -1; }
                if (pending_lowpass) {
                    if (chan >= 0 && chan < 4)
                        hdr->lowpass_off[chan] = pos + 4;
                    pending_lowpass = 0;
                } else {
                    if (nbands >= max_bands) {
                        hdr->complex_flag = 1;
                        return -1;
                    }
                    cur.channel = chan;
                    cur.data_off = pos + 4;
                    cur.data_len = size - 4;
                    bands[nbands++] = cur;
                    memset(&cur, 0, sizeof(cur));
                    cur.quant = 1;
                }
                pos += size;
            } else if (kind == SAMPLE_SIZE || kind == LEVEL_SIZE) {
                // spans content parsed inline; no skip
            } else {
                pos += size;  // unknown sized chunk (e.g. UNCOMPRESSED)
            }
            continue;
        }

        switch (at) {
            case TAG_SAMPLE:
                if (!hdr->sample_type) hdr->sample_type = (int32_t)value;
                break;
            case TAG_INDEX:
                pos += (int64_t)value * 4;
                break;
            case TAG_TRANSFORM_TYPE:
                hdr->transform_type = (int32_t)value;
                break;
            case TAG_NUM_FRAMES:
                hdr->num_frames = (int32_t)value;
                break;
            case TAG_FRAME_WIDTH:
                hdr->width = (int32_t)value;
                break;
            case TAG_FRAME_HEIGHT:
                hdr->height = (int32_t)value;
                break;
            case TAG_SAMPLE_FLAGS:
            case TAG_CHANNEL:
                if (++chan >= 4) { hdr->complex_flag = 1; return -1; }
                hdr->nchannels = chan + 1;
                break;
            case TAG_LOWPASS_SUBBAND:
                if (chan < 0) {  // sample without SAMPLE_FLAGS
                    chan = 0;
                    hdr->nchannels = 1;
                }
                pending_lowpass = 1;
                break;
            case TAG_LOWPASS_WIDTH:
                if (chan >= 0 && chan < 4) hdr->lowpass_w[chan] = value;
                break;
            case TAG_LOWPASS_HEIGHT:
                if (chan >= 0 && chan < 4) hdr->lowpass_h[chan] = value;
                break;
            case TAG_BAND_NUMBER:
                cur.band = (int32_t)value;
                break;
            case TAG_BAND_SUBBAND:
                cur.subband = (int32_t)value;
                break;
            case TAG_BAND_ENCODING:
                cur.encoding = (int32_t)value;
                break;
            case TAG_BAND_QUANTIZATION:
                cur.quant = (int32_t)value;
                break;
            case TAG_BAND_CODING_FLAGS:
                cur.coding_flags = (int32_t)value;
                break;
            case TAG_PEAK_LEVEL:
                if (value) cur.flags |= 1;
                break;
            case TAG_ENCODED_CHANNELS:
                stereo = value > 1;
                break;
            case TAG_FRAME_TRAILER:
                // a whole stereo sample (another eye follows): oracle
                if (stereo && n - pos >= 16) hdr->complex_flag = 1;
                return nbands;
            default:
                break;
        }
        if (hdr->complex_flag) return nbands;
    }
    return nbands;
}

// Copy n band payloads from src into rows of a padded (R, row_bytes)
// uint8 tensor: dst[rows[i], :lens[i]] = src[offs[i] : offs[i]+lens[i]].
void fill_rows(uint8_t* dst, int64_t row_bytes, const uint8_t* src,
               int64_t nrows, const int64_t* offs, const int64_t* lens,
               const int64_t* rows) {
    for (int64_t i = 0; i < nrows; i++) {
        int64_t len = lens[i] < row_bytes ? lens[i] : row_bytes;
        if (len > 0) memcpy(dst + rows[i] * row_bytes, src + offs[i],
                            (size_t)len);
    }
}

// Lowpass pixels: big-endian int16 -> int32 plane + offset, the
// per-channel DC bias the decoder folds in (`Codec/decoder.c:12479`).
void lowpass_i32(const uint8_t* src, int64_t count, int32_t off,
                 int32_t* dst) {
    for (int64_t i = 0; i < count; i++) {
        int16_t v = (int16_t)((src[2 * i] << 8) | src[2 * i + 1]);
        dst[i] = (int32_t)v + off;
    }
}

}  // extern "C"
