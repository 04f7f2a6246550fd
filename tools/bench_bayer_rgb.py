#!/usr/bin/env python3
"""The port's Bayer decodes at 4K on the card, output by output.

    python3 tools/bench_bayer_rgb.py [--root DIR] [--reps N]

Encodes `chip_smoke.py`'s BYR4 batch (8 frames of `testframes.byr4_frame`
pattern 1 at 3840x2160, rolled one row a frame, quality 4) with
`IntraCodec.encode_batch_device`, then times `decode_batch_device` of the
batch to BYR4, RG48, YUY2 and RG48 through a white-balance develop matrix:
the host clock from a synchronize to the end of the call (which downloads
the frames), `--reps` calls after a warm-up, per frame.  Prints one line
a decode and, last, a JSON object of the medians with the card's name and
power limit.

`--root` runs the `cineform_tpu_torch` package of another tree (a `git
archive` of an older commit), so that two trees are compared in one chip
call, each in its own process.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, BATCH, QUALITY = 3840, 2160, 8, 4
#: a white-balance develop matrix (R and B gains), the (3, 4) form
#: `ref.demosaic.compose_develop_matrix` gives, a develop plan's `matrix`
WB_MATRIX = np.array([[1.6, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.3, 0.0]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose cineform_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.ops.demosaic import DevelopPlan
    from cineform_tpu_torch.testframes import byr4_frame

    if not torch.cuda.is_available():
        print("bench_bayer_rgb: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    codec = IntraCodec(WIDTH, HEIGHT, QUALITY, device=dev,
                       input_format="BYR4")
    one = np.frombuffer(byr4_frame(WIDTH, HEIGHT, 1), np.uint8).reshape(
        HEIGHT, codec.row_bytes)
    frames = np.stack([np.roll(one, i, axis=0) for i in range(BATCH)])
    samples = codec.encode_batch_device(frames)
    matrices = [DevelopPlan(matrix=WB_MATRIX)] * BATCH
    result = {"root": os.path.abspath(args.root), "card": card,
              "reps": args.reps, "ms_per_frame": {}}
    for label, output, develop in (("BYR4", "BYR4", None),
                                   ("RG48", "RG48", None),
                                   ("YUY2", "YUY2", None),
                                   ("RG48 WB matrix", "RG48", matrices)):
        times = []
        for rep in range(args.reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, fallback = codec.decode_batch_device(samples, output=output,
                                                    develop=develop)
            ms = (time.perf_counter() - t0) * 1e3
            if fallback:
                raise AssertionError(f"{label}: fallback frames {fallback}")
            if rep:
                times.append(ms / BATCH)
        med = statistics.median(times)
        result["ms_per_frame"][label] = med
        print(f"{label}: decode_batch_device {med:.4f} ms/frame (median of "
              f"{args.reps}; {', '.join(f'{t:.4f}' for t in times)})",
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
