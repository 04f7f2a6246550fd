#!/usr/bin/env python3
"""The port's EncoderPool on one input format, route by route, on the card.

    python3 tools/bench_pool_routes.py [--root DIR] [--format DPX0]
        [--quality 4] [--frames 32] [--threads 1 2] [--reps 3]

Submits `--frames` 1920x1080 frames of `--format` (the probe's raw fill,
`testframes.raw_fill` pattern 1, rolled one row a frame) to
`EncoderPool(threads, frames)` prepared with the default `use_device`,
then harvests them all: the host clock from the first submission to the
last harvest, `--reps` runs after a warm-up run, for each `--threads`.
Prints one line a thread count and, last, a JSON object: the route the
pool took (`use_device`, None for a pool that has only its batcher; the
batcher's batch sizes), the frames/s of each run and their median, and
the SHA-256 of the samples, with the card's name and power limit.

`--root` runs the `cineform_tpu_torch` package of another tree (a `git
archive` of an older commit), so that the routes of two trees are
compared in one chip call, each in its own process: the same samples
give the same SHA-256.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT = 1920, 1080


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose cineform_tpu_torch is timed")
    ap.add_argument("--format", default="DPX0")
    ap.add_argument("--quality", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from cineform_tpu_torch import api
    from cineform_tpu_torch.testframes import raw_fill

    if not torch.cuda.is_available():
        print("bench_pool_routes: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    fmt = api.PixelFormat[args.format]
    probe = api.Encoder(dev)
    probe.prepare_to_encode(WIDTH, HEIGHT, fmt,
                            quality=api.EncodingQuality(args.quality))
    rb = probe.row_bytes
    one = np.frombuffer(raw_fill(HEIGHT * rb, 1), np.uint8).reshape(HEIGHT,
                                                                   rb)
    frames = [np.roll(one, i, axis=0).tobytes() for i in range(args.frames)]

    def run(threads):
        """One pool run -> (samples, frames/s, use_device, batches)."""
        p = api.CFHD_CreateEncoderPool(threads, len(frames), device=dev)
        p.prepare_to_encode(WIDTH, HEIGHT, fmt,
                            quality=api.EncodingQuality(args.quality))
        p.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            p.encode_async_sample(i + 1, f)
        got = [p.wait_for_sample(timeout=600) for _ in frames]
        rate = len(frames) / (time.perf_counter() - t0)
        p.stop()
        if [b.frame_number for b in got] != list(range(1, len(frames) + 1)):
            raise AssertionError("the pool delivered out of order")
        # a pool with no `use_device` has only the batcher
        return ([b.get_encoded_sample() for b in got], rate,
                getattr(p, "use_device", None), list(p.batches))

    result = {"root": os.path.abspath(args.root), "card": card,
              "format": args.format, "quality": args.quality,
              "size": [WIDTH, HEIGHT], "frames": args.frames, "runs": {}}
    for threads in args.threads:
        samples, _, use_device, _ = run(threads)       # warm-up
        rates, digests = [], set()
        for _ in range(args.reps):
            got, rate, use_device, batches = run(threads)
            rates.append(rate)
            digests.add(hashlib.sha256(b"".join(got)).hexdigest())
        if digests != {hashlib.sha256(b"".join(samples)).hexdigest()}:
            raise AssertionError("the runs gave different samples")
        result["runs"][threads] = {
            "use_device": use_device, "batches": batches,
            "frames_per_s": rates,
            "median_frames_per_s": statistics.median(rates),
            "sample_bytes": sum(map(len, samples)),
            "sha256": digests.pop()}
        print(f"{args.format} {WIDTH}x{HEIGHT} q{args.quality}, "
              f"{threads} thread(s): use_device {use_device}, batches "
              f"{batches}, frames/s {rates} ({card})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
