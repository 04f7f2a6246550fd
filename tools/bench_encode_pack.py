#!/usr/bin/env python3
"""Where the encoder's packing stage spends its time on the card.

    python3 tools/bench_encode_pack.py [--noise] [--out FILE]

For every `chunk_pack` and `merge_network` call of one batch-8 1080p
quality-4 encode (the content of `bench.py`; with `--noise`, frame 7 is
seeded noise, as in `chip_smoke.py`'s kernel checks), each chunk packed at
the encoder's schedule (`entropy.device.chunk_schedule`), on one card:

- the wall time of a call, by the host clock over REPS calls back to back
  ended by a synchronize (the wrapper's host path and the device work
  overlap, so this is the larger of the two);
- the device time of each kernel a call launches (memset included), from
  `torch.profiler` over those REPS calls;
- the rows that failed the merge guard and the chunks that took the tree,
  where the wrappers count them.

It runs against the package found beside it; an older tree is measured
by that tree's own copy of this file.  Needs a CUDA card.
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
    ap.add_argument("--noise", action="store_true",
                    help="make frame 7 seeded noise")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("bench_encode_pack: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from cineform_tpu_torch.entropy import device as edev
    from cineform_tpu_torch.models.intra import IntraCodec
    from cineform_tpu_torch.ops.chunk_pack import chunk_pack
    from cineform_tpu_torch.ops.merge_network import merge_network
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
    if args.noise:
        frames[-1] = np.random.default_rng(0).integers(0, 256, base.shape,
                                                       dtype=np.uint8)
    levels = codec.forward_levels(codec._upload(frames))
    codes = edev.encode_tables(17)
    schedule = edev.chunk_schedule(codes)

    def pack(bits, sizes):
        return chunk_pack(bits, sizes, *schedule)

    def counter(wrapper, name):
        t = getattr(wrapper, name, {}).get(dev)
        return None if t is None else int(t.item())

    def measure(what, fn, wrapper, count_name):
        fn()
        torch.cuda.synchronize()
        before = counter(wrapper, count_name)
        fn()
        torch.cuda.synchronize()
        after = counter(wrapper, count_name)
        counted = None if before is None else after - before
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
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
                kernels[e["name"][:48]] += e["dur"] / 1e3 / REPS
        device = sum(kernels.values())
        log(f"{what}: wall {wall:.4f} ms/call, device {device:.4f} ms/call "
            f"({count_name} {counted}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in kernels.most_common()))
        return wall, device

    totals = collections.defaultdict(lambda: [0.0, 0.0])
    for lev in range(3):
        for grp, bands in zip(codec.groups, levels[lev][1]):
            bits, sizes = edev.chunk_codes(codec.group_bands(bands), codes)
            what = f"level {lev + 1} channels {grp}"
            w, d = measure(f"chunk_pack {what} {tuple(bits.shape)}",
                           lambda: pack(bits, sizes), chunk_pack,
                           "tree_chunks")
            totals["chunk_pack"][0] += w
            totals["chunk_pack"][1] += d
            packed = pack(bits, sizes)
            val, rem, _ = edev._concat_slots(packed[0], packed[1])
            failing = int((~edev._concat_guard(rem)).sum())
            w, d = measure(f"merge_network {what} {tuple(val.shape)}, "
                           f"{failing} rows fail the guard",
                           lambda: merge_network(val, rem), merge_network,
                           "flagged")
            totals["merge_network"][0] += w
            totals["merge_network"][1] += d
    for name, (w, d) in totals.items():
        log(f"{name}, the 6 calls: wall {w:.4f} ms, device {d:.4f} ms")
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
