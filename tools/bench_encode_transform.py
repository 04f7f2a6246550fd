#!/usr/bin/env python3
"""Where the encode's transform stage spends its time on the card.

    python3 tools/bench_encode_transform.py [--out FILE]

On the batch-8 1080p quality-4 content of `bench.py` (`yuy2_frame`
pattern 1 rolled by one row a frame), on one card, it times the encode's
transform stage, from the uploaded frames to the band tensors the entropy
coder reads, call by call.  For each call, over REPS calls back to back:

- the wall time of a call, by the host clock, ended by a synchronize (the
  wrappers' host path and the device work overlap, so this is the larger
  of the two);
- the device time of each kernel the call runs (memsets and copies
  included), from `torch.profiler` over another REPS calls, and their sum.

The calls, on a tree whose `IntraCodec` has `forward_levels`: the upload
(`IntraCodec._upload`), level 1 (`dwt_forward_yuy2`, from the frames'
bytes), levels 2 and 3 (`dwt_forward_groups`), the 6 `group_bands`
(reshapes of the kernels' buffers), and the whole stage
(`forward_levels` and the 6 `group_bands`).  On an older tree: the upload,
`unpack_yuy2` with its `.contiguous()`, the 9 `dwt_forward_level` calls,
the 6 `group_bands` (stacks and pads), and the whole stage (`forward` and
the 6 `group_bands`).

It runs against the package found beside it, so the same file, copied
into a `git archive` of an older tree, measures that tree.  It ends with
the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, BATCH, QUALITY = 1920, 1080, 8, 4
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("bench_encode_transform: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.ops import intra_transform as ops
    from cineform_tpu_torch.testframes import yuy2_frame

    lines = []
    out_dir = os.path.join(ROOT, "out")
    os.makedirs(out_dir, exist_ok=True)

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    dev = torch.device("cuda", 0)
    codec = IntraCodec(WIDTH, HEIGHT, QUALITY, device=dev)
    base = np.frombuffer(yuy2_frame(WIDTH, HEIGHT, 1), np.uint8).reshape(
        HEIGHT, 2 * WIDTH)
    frames = np.stack([np.roll(base, i, axis=0) for i in range(BATCH)])
    x = codec._upload(frames)
    t = codec.tables()

    def measure(what, fn):
        """(wall ms, device ms) of one call of `fn`."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / REPS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = collections.Counter()
        launches = collections.Counter()
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
                kernels[e["name"][:60]] += e["dur"] / 1e3 / REPS
                launches[e["name"][:60]] += 1
        device = sum(kernels.values())
        log(f"{what}: wall {wall:.4f} ms/call, device {device:.4f} ms/call: "
            + ", ".join(f"{k} x{launches[k] // REPS} {v:.4f}"
                        for k, v in kernels.most_common()))
        return wall, device

    log(f"encode transform stage, batch {BATCH} at {WIDTH}x{HEIGHT} "
        f"q{QUALITY}, {REPS} calls each")
    measure("upload (pageable host frames to the card)",
            lambda: codec._upload(frames))
    if hasattr(codec, "forward_levels"):
        from cineform_tpu_torch.ops.dwt_forward import (dwt_forward_groups,
                                                        dwt_forward_yuy2)

        def quants(k):
            return [t.band_quant[ch][k] for ch in range(3)]

        levels = codec.forward_levels(x)
        measure("level 1: dwt_forward_yuy2 (1 launch)",
                lambda: dwt_forward_yuy2(x, codec.params.precision,
                                         t.prescale[0], quants(0)))
        for k in (1, 2):
            measure(f"level {k + 1}: dwt_forward_groups (1 launch)",
                    lambda k=k: dwt_forward_groups(levels[k - 1][0],
                                                   t.prescale[k], quants(k)))
        measure("group_bands, the 6 (reshapes)",
                lambda: [codec.group_bands(bands) for _, highs in levels
                         for bands in highs])

        def stage():
            return [codec.group_bands(bands)
                    for _, highs in codec.forward_levels(x)
                    for bands in highs]
    else:
        from cineform_tpu_torch.ops.dwt_forward import dwt_forward_level

        planes = [p.contiguous()
                  for p in ops.unpack_yuy2(x, codec.params.precision)]
        measure("unpack_yuy2 with .contiguous()",
                lambda: [p.contiguous() for p in ops.unpack_yuy2(
                    x, codec.params.precision)])

        def nine():
            for ch, plane in enumerate(planes):
                ll = plane
                for k in range(3):
                    ll, _ = dwt_forward_level(ll, t.prescale[k],
                                              t.band_quant[ch][k])

        measure("dwt_forward_level, the 9 (3 channels x 3 levels)", nine)
        coeffs = codec.forward(x)
        groups = codec._band_groups(coeffs)
        measure("group_bands, the 6 (stacks and pads)",
                lambda: [codec.group_bands(coeffs, k, grp)
                         for k in range(3) for grp in groups])

        def stage():
            co = codec.forward(x)
            return [codec.group_bands(co, k, grp) for k in range(3)
                    for grp in codec._band_groups(co)]
    measure("the whole stage, uploaded frames to the coder's band tensors",
            stage)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
