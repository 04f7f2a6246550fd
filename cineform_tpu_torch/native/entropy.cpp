/* Native CFHD band entropy codec (host side).
 *
 * The serial bit-packing / prefix-decoding stage of the codec -- the part
 * the reference implements as hand-tuned C (`Codec/vlc.c`, the FSM decoder
 * `Codec/decoder.c:19532`) -- reimplemented as a small C++ library driven
 * from Python via ctypes.  All codebook tables are passed in from Python
 * (cineform_tpu_torch.spec.codebooks), so the byte-exact contract lives in one
 * place.
 *
 * Encode contract: `Codec/encoder.c:5702` EncodeQuantLongRuns +
 *   `Codec/vlc.c:366` PutZeroRun (greedy composite run codes) +
 *   `FinishEncodeBand` band-end codeword, MSB-first bit packing
 *   (`Codec/bitstream.c:996` PutBits).
 * Decode contract: prefix decode of the RLV codebook with magnitude sign
 *   bits, companding expansion and int16-wrapping dequantization folded in
 *   (`Codec/codebooks.c:1345` ScaleFSM, `Codec/decoder.c:20551` DeQuantFSM).
 */

#include <cstdint>
#include <cstring>

extern "C" {

/* MSB-first bit writer over a byte buffer. */
struct BitWriter {
    uint8_t *buf;
    int64_t cap;       /* bytes */
    uint64_t acc;
    int nbits;         /* bits in acc */
    int64_t pos;       /* bytes written */
    int overflow;
};

static inline void bw_put(BitWriter *w, uint32_t bits, int size)
{
    w->acc = (w->acc << size) | (bits & ((size < 32) ? ((1u << size) - 1u) : 0xFFFFFFFFu));
    w->nbits += size;
    if (w->nbits >= 32) {
        w->nbits -= 32;
        if (w->pos + 4 > w->cap) { w->overflow = 1; return; }
        uint32_t word = (uint32_t)(w->acc >> w->nbits);
        w->buf[w->pos] = (uint8_t)(word >> 24);
        w->buf[w->pos + 1] = (uint8_t)(word >> 16);
        w->buf[w->pos + 2] = (uint8_t)(word >> 8);
        w->buf[w->pos + 3] = (uint8_t)word;
        w->pos += 4;
    }
}

/* Drain any remaining whole/partial bytes (zero-padded to a byte). */
static inline void bw_finish(BitWriter *w)
{
    if (w->nbits & 7)
        bw_put(w, 0, 8 - (w->nbits & 7));
    while (w->nbits >= 8) {
        w->nbits -= 8;
        if (w->pos >= w->cap) { w->overflow = 1; return; }
        w->buf[w->pos++] = (uint8_t)(w->acc >> w->nbits);
    }
}

/* Encode one quantized band (values scanned flat, already pitch-padded).
 *
 * vb_size/vb_bits: 2048-entry valuebook (index = value & 2047).
 * rb_size/rb_count/rb_bits: 3072-entry composite runbook.
 * Returns the number of bytes written (padded with zero bits to a byte),
 * or -1 on overflow.  The caller pads to a 32-bit boundary. */
int64_t encode_band(const int32_t *values, int64_t n,
                    const int32_t *vb_size, const uint32_t *vb_bits,
                    const int32_t *rb_size, const int32_t *rb_count,
                    const uint32_t *rb_bits,
                    uint32_t bandend_bits, int bandend_size,
                    uint8_t *out, int64_t out_cap)
{
    BitWriter w = {out, out_cap, 0, 0, 0, 0};
    int64_t run = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t v = values[i];
        if (v == 0) {
            /* fast zero skip: bands are mostly zeros; consume 8 at a time */
            run++; i++;
            while (i + 8 <= n) {
                uint64_t a, b, c, d;
                memcpy(&a, values + i, 8);
                memcpy(&b, values + i + 2, 8);
                memcpy(&c, values + i + 4, 8);
                memcpy(&d, values + i + 6, 8);
                if ((a | b | c | d) != 0) break;
                run += 8; i += 8;
            }
            while (i < n && values[i] == 0) { run++; i++; }
            i--;   /* loop increment re-advances */
            continue;
        }
        while (run > 0) {
            int64_t idx = run < 3072 ? run : 3071;
            bw_put(&w, rb_bits[idx], rb_size[idx]);
            run -= rb_count[idx];
        }
        /* clamp to the valuebook's signed 11-bit domain (encoder.c:5556) */
        if (v > 1023) v = 1023;
        if (v < -1023) v = -1023;
        uint32_t index = (uint32_t)v & 2047u;
        bw_put(&w, vb_bits[index], vb_size[index]);
        if (w.overflow) return -1;
    }
    while (run > 0) {
        int64_t idx = run < 3072 ? run : 3071;
        bw_put(&w, rb_bits[idx], rb_size[idx]);
        run -= rb_count[idx];
    }
    bw_put(&w, bandend_bits, bandend_size);
    bw_finish(&w);
    if (w.overflow) return -1;
    return w.pos;
}

/* Decode one band.
 *
 * lut_*: (1 << lut_bits) first-level tables: consumed bits (0 = long code),
 *   run count, signed value (companding expansion already applied).
 * long_*: fallback table of nlong codes sorted by size (size, bits, count,
 *   value with expansion applied).
 * quant: dequantizer; the multiply wraps to int16 (DeQuantFSM semantics).
 * out: num_coeffs int32 results.
 * Returns the bit position just after the band-end code, or -1 on error.
 *
 * With tolerant != 0 this replicates the reference's ERROR_TOLERANT FSM
 * loop (`DecodeBandFSM16sNoGap`, Codec/decoder.c:19649-19806, built with
 * ERROR_TOLERANT=1): decoding stops when the write cursor passes the
 * band end (`while (bandendptr >= rowptr)`) or the stream is exhausted,
 * writes beyond the band are dropped while the cursor still advances,
 * zero runs are not clamped, and the partial result is returned with
 * the caller resynchronizing on the band trailer tag (SkipSubband) --
 * so a corrupt payload yields the reference's exact garbage instead of
 * an error. */
int64_t decode_band_ex(const uint8_t *data, int64_t nbytes, int64_t start_bit,
                       int64_t num_coeffs,
                       const int32_t *lut_size, const int32_t *lut_count,
                       const int32_t *lut_value, int lut_bits,
                       const int32_t *long_size, const uint32_t *long_bits,
                       const int32_t *long_count, const int32_t *long_value,
                       int nlong,
                       uint32_t bandend_bits, int bandend_size,
                       int32_t quant, int32_t *out, int tolerant)
{
    memset(out, 0, (size_t)num_coeffs * sizeof(int32_t));
    int64_t bitpos = start_bit;
    int64_t pos = 0;
    const int64_t total_bits = nbytes * 8;
    const int window_bits = 26; /* >= longest code + sign bit */

    while (true) {
        if (tolerant && pos >= num_coeffs) return total_bits;
        if (bitpos + bandend_size > total_bits)
            return tolerant ? total_bits : -1;
        /* load a 26-bit window at bitpos (over a 48-bit read) */
        int64_t byte0 = bitpos >> 3;
        uint64_t window = 0;
        for (int j = 0; j < 6; j++) {
            uint64_t b = (byte0 + j < nbytes) ? data[byte0 + j] : 0;
            window = (window << 8) | b;
        }
        window >>= (48 - window_bits - (bitpos & 7));
        window &= (1ull << window_bits) - 1;

        if ((uint32_t)(window >> (window_bits - bandend_size)) == bandend_bits) {
            bitpos += bandend_size;
            break;
        }
        uint32_t idx = (uint32_t)(window >> (window_bits - lut_bits));
        int size = lut_size[idx];
        int32_t count, value;
        if (size > 0) {
            count = lut_count[idx];
            value = lut_value[idx];
            bitpos += size;
        } else {
            int k = 0;
            for (; k < nlong; k++) {
                if ((uint32_t)(window >> (window_bits - long_size[k])) == long_bits[k]) {
                    count = long_count[k];
                    value = long_value[k];
                    bitpos += long_size[k];
                    break;
                }
            }
            if (k == nlong) return tolerant ? total_bits : -1;
        }
        if (value == 0) {
            /* zero runs advance the cursor unclamped, like the FSM's
             * rowptr skips (writes past the band are dropped below) */
            pos += count;
            if (!tolerant && pos > num_coeffs) pos = num_coeffs;
        } else {
            /* sign bit follows a nonzero magnitude */
            int64_t sb = bitpos >> 3;
            int sign = (sb < nbytes) ? ((data[sb] >> (7 - (bitpos & 7))) & 1) : 0;
            bitpos += 1;
            int32_t v = sign ? -value : value;
            /* DeQuantFSM: int16-wrapping multiply */
            int32_t dq = (int32_t)(int16_t)((int32_t)v * quant);
            if (pos < num_coeffs) out[pos] = dq;
            pos++;
        }
        if (!tolerant && pos > num_coeffs + 4096) return -1;
    }
    return bitpos;
}

} /* extern "C" */
