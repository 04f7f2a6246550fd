"""cfhd_tool -- the TestCFHD command line on the port.

The JAX package's `tools/cfhd_tool.py` on `cineform_tpu_torch.api` and
`cineform_tpu_torch.pool`, with the same subcommands, arguments, defaults
and printed lines; the reference example's workflows
(`Example/TestCFHD.cpp`):

    encode    raw frame file -> CFHD sample        (TestCFHD encode)
    decode    CFHD sample -> raw frame file        (TestCFHD file decode)
    roundtrip encode + decode + PSNR report        (TestCFHD -D)
    pool      async-pool throughput test           (TestCFHD -E)
    fuzz      bit-flip robustness sweep            (TestCFHD fuzzer)
    info      parse a sample header                (ParseSampleHeader)

Every subcommand takes `--device` (default `cuda`; `cpu` runs the plain
PyTorch versions of the kernels).  Run `python -m
cineform_tpu_torch.cfhd_tool <cmd> -h` for options.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np

from cineform_tpu_torch import api
from cineform_tpu_torch.pool import EncoderPool
from cineform_tpu_torch.testframes import yuy2_frame


def _fmt(name: str) -> api.PixelFormat:
    return api.PixelFormat[name.upper() if name != "b64a" else "B64A"]


def cmd_encode(a) -> int:
    enc = api.Encoder(a.device)
    enc.prepare_to_encode(a.width, a.height, _fmt(a.format),
                          quality=api.EncodingQuality(a.quality))
    with open(a.input, "rb") as f:
        frame = f.read()
    enc.encode_sample(frame)
    sample = enc.get_sample_data()
    with open(a.output, "wb") as f:
        f.write(sample)
    print(f"encoded {a.width}x{a.height} {a.format} -> {len(sample)} bytes")
    return 0


def cmd_decode(a) -> int:
    with open(a.input, "rb") as f:
        sample = f.read()
    dec = api.Decoder(a.device)
    w, h, _ = dec.prepare_to_decode(
        a.width, a.height, _fmt(a.format),
        resolution=api.DecodedResolution(a.resolution), sample=sample)
    out = dec.decode_sample(sample)
    with open(a.output, "wb") as f:
        f.write(out.tobytes())
    print(f"decoded {w}x{h} {a.format} -> {out.size} bytes")
    return 0


def cmd_roundtrip(a) -> int:
    frame = yuy2_frame(a.width, a.height, 1)
    enc = api.Encoder(a.device)
    enc.prepare_to_encode(a.width, a.height, api.PixelFormat.YUY2,
                          quality=api.EncodingQuality(a.quality))
    enc.encode_sample(frame)
    sample = enc.get_sample_data()
    dec = api.Decoder(a.device)
    dec.prepare_to_decode(0, 0, sample=sample)
    out = dec.decode_sample(sample).ravel()
    src = np.frombuffer(frame, np.uint8).astype(np.float64)
    mse = ((src - out.astype(np.float64)) ** 2).mean()
    psnr = 10 * np.log10(255 ** 2 / mse)
    ratio = len(frame) / len(sample)
    print(f"{a.width}x{a.height} q{a.quality}: sample {len(sample)} bytes "
          f"({ratio:.2f}:1), PSNR {psnr:.2f} dB")
    return 0


def cmd_pool(a) -> int:
    pool = EncoderPool(a.threads, a.threads * 2, a.device)
    pool.prepare_to_encode(a.width, a.height, api.PixelFormat.YUY2,
                           quality=api.EncodingQuality(a.quality))
    pool.start()
    frame = yuy2_frame(a.width, a.height, 1)
    t0 = time.perf_counter()
    done = 0
    for i in range(a.frames):
        pool.encode_async_sample(i, frame)
    for i in range(a.frames):
        pool.wait_for_sample()
        done += 1
    dt = time.perf_counter() - t0
    pool.stop()
    print(f"{done} frames in {dt:.2f}s = {done / dt:.1f} fps "
          f"({a.threads} threads)")
    return 0


def cmd_fuzz(a) -> int:
    enc = api.Encoder(a.device)
    enc.prepare_to_encode(a.width, a.height, api.PixelFormat.YUY2)
    enc.encode_sample(yuy2_frame(a.width, a.height, 1))
    sample = enc.get_sample_data()
    rng = random.Random(7)
    survived = errored = 0
    for trial in range(a.trials):
        corrupt = bytearray(sample)
        for _ in range(a.flips):
            pos = rng.randrange(len(corrupt))
            corrupt[pos] ^= 1 << rng.randrange(8)
        dec = api.Decoder(a.device)
        try:
            dec.prepare_to_decode(0, 0, sample=bytes(corrupt))
            dec.decode_sample(bytes(corrupt))
            survived += 1
        except api.CFHDError:
            errored += 1          # clean, typed failure is a pass
        except Exception as exc:  # noqa: BLE001 - the fuzz gate itself
            print(f"trial {trial}: UNCLEAN {type(exc).__name__}: {exc}")
            return 1
    print(f"fuzz: {survived} decoded, {errored} rejected cleanly, 0 crashes")
    return 0


def cmd_info(a) -> int:
    from cineform_tpu_torch.bitstream import parse_sample

    with open(a.input, "rb") as f:
        s = parse_sample(f.read())
    print(f"sample type {s.sample_type}, {s.width}x{s.height}, "
          f"precision {s.precision}, quality {s.quality & 0xFF}, "
          f"{len(s.channels)} channels, "
          f"{sum(len(c.bands) for c in s.channels)} coded bands")
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cineform_tpu_torch.cfhd_tool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for the "
                             "plain versions of the kernels)")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", parents=[common])
    e.add_argument("input"), e.add_argument("output")
    e.add_argument("--width", type=int, required=True)
    e.add_argument("--height", type=int, required=True)
    e.add_argument("--format", default="YUY2")
    e.add_argument("--quality", type=int, default=4)

    d = sub.add_parser("decode", parents=[common])
    d.add_argument("input"), d.add_argument("output")
    d.add_argument("--format", default="YUY2")
    d.add_argument("--resolution", type=int, default=1)
    d.add_argument("--width", type=int, default=0,
                   help="explicit output width (Lanczos scaling)")
    d.add_argument("--height", type=int, default=0)

    r = sub.add_parser("roundtrip", parents=[common])
    r.add_argument("--width", type=int, default=1920)
    r.add_argument("--height", type=int, default=1080)
    r.add_argument("--quality", type=int, default=4)

    w = sub.add_parser("pool", parents=[common])
    w.add_argument("--width", type=int, default=1920)
    w.add_argument("--height", type=int, default=1080)
    w.add_argument("--threads", type=int, default=4)
    w.add_argument("--frames", type=int, default=32)
    w.add_argument("--quality", type=int, default=4)

    f = sub.add_parser("fuzz", parents=[common])
    f.add_argument("--width", type=int, default=320)
    f.add_argument("--height", type=int, default=240)
    f.add_argument("--trials", type=int, default=50)
    f.add_argument("--flips", type=int, default=8)

    i = sub.add_parser("info", parents=[common])
    i.add_argument("input")
    return p


def main(argv: list[str] | None = None) -> int:
    a = parser().parse_args(argv)
    return {"encode": cmd_encode, "decode": cmd_decode,
            "roundtrip": cmd_roundtrip, "pool": cmd_pool,
            "fuzz": cmd_fuzz, "info": cmd_info}[a.cmd](a)


if __name__ == "__main__":
    sys.exit(main())
