"""gop_inverse_roofline: the GOP inverse's (`GopCodec.inverse_to`, the
program's `gop.inverse_to` spans) share of its bandwidth roofline, in
percent, in the profiled sub-window: the bytes a frame's inverse must
move (`inverse_bytes`) at the card's peak bandwidth, over the device time
a frame of the kernels launched in those spans (`gop_inverse_device_ms`).
Each call of the cell inverts the one frame it delivers."""

from cfbench import program, roofline

#: bytes an output format writes a row of W pixels
ROW_BYTES = {"V210": lambda w: (w + 47) // 48 * 128}


def inverse_bytes(cfg: dict, output: str) -> int:
    """The least bytes `GopCodec.inverse_to` moves for one frame: its int32
    inputs read once (each channel's lowpass and the bands of w5, w4, w3
    and the frame's own level-1 wavelet, at their band sizes) and the
    frame in `output` written once."""
    w, h = cfg["width"], cfg["height"]
    coeffs = 0
    for cw in (w, w // 2, w // 2):
        coeffs += 4 * (h >> 3) * (cw >> 3)        # lowpass and w5's bands
        coeffs += 7 * (h >> 2) * (cw >> 2)        # w4's 3 and w3's 4
        coeffs += 3 * (h >> 1) * (cw >> 1)        # w0's or w1's
    return 4 * coeffs + h * ROW_BYTES[output](w)


def read(ctx):
    ms = program.device_ms(ctx, "gop.inverse_to", "api.decode_sample")
    if ms is None or ctx.mix["output"] not in ROW_BYTES:
        return None
    return roofline.share_pct(inverse_bytes(ctx.cfg, ctx.mix["output"]),
                              ms / 1e3)
