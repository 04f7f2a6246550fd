#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's batch encode and decode goes.

    python3 tools/profile_port.py [--out out/profile_port.txt]

Run from the root of a checkout on a machine with one CUDA card.  It runs
the content of `chip_smoke.py`'s batch phase (8 frames of 1920x1080 YUY2,
`yuy2_frame` pattern 1 rolled by one row per frame, quality 4, cap_bits 8)
through `cineform_tpu_torch.models.intra.IntraCodec` and prints:

- per stage, the wall ms per batch of 8 (median of 5, host clock, ended by
  a device synchronize): encode device (upload + `forward_packed`), encode
  host tail (`write_samples`), decode host tail (`host_entropy_decode`),
  decode device (`inverse` + download);
- within the host tails, the seconds spent in each host function they call
  (parsing, the C++ band decoder, the host re-encode of frames with an
  overflowed band, the C++ band encoder, the sample writer), over the same
  5 runs;
- for the two device stages under torch.profiler (3 runs after a warm-up):
  the profiled wall ms per batch, the device's busy ms (the union of its
  kernel, copy and memset intervals) and its share of the wall, and the
  operators and kernels with the most device time.

It ends with the card's name and power limit, and writes everything it
printed to --out as well.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, BATCH, QUALITY = 1920, 1080, 8, 4
REPS, PROFILED = 5, 3

_lines: list[str] = []


def log(msg: str) -> None:
    _lines.append(msg)
    print(msg, flush=True)


class Timed:
    """Replaces `module.name` by a wrapper that sums its seconds and calls,
    for the duration of a `with` block."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def device_busy_ms(prof, out_dir: str) -> float:
    """Milliseconds in which the device ran a kernel, copy or memset: the
    union of those intervals in the profiler's trace."""
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "out",
                                                  "profile_port.txt"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from cineform_tpu.entropy import native
    from cineform_tpu.models import intra_host
    from cineform_tpu_torch.models import intra as port_intra
    from cineform_tpu_torch.testframes import yuy2_frame

    dev = torch.device("cuda", 0)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    codec = port_intra.IntraCodec(WIDTH, HEIGHT, QUALITY, device=dev)
    base = np.frombuffer(yuy2_frame(WIDTH, HEIGHT, 1), np.uint8).reshape(
        HEIGHT, 2 * WIDTH)
    frames = np.stack([np.roll(base, i, axis=0) for i in range(BATCH)])

    def enc_dev():
        return codec.forward_packed(codec._upload(frames))

    packed = enc_dev()
    samples = codec.write_samples(frames, packed)
    co = codec.host_entropy_decode(samples)

    def dec_dev():
        return codec.inverse(co).cpu().numpy()

    stages = {
        "encode device (upload + forward_packed)": enc_dev,
        "encode host tail (write_samples)":
            lambda: codec.write_samples(frames, packed),
        "decode host tail (host_entropy_decode)":
            lambda: codec.host_entropy_decode(samples),
        "decode device (inverse + download)": dec_dev,
    }
    host_fns = [
        (port_intra, "parse_sample", "decode: bitstream.parse_sample"),
        (native, "decode_band", "decode: entropy.native.decode_band (C++)"),
        (intra_host, "transform_channel",
         "encode: host re-encode transform (intra_host.transform_channel)"),
        (intra_host, "encode_band_payload",
         "encode: C++ band encoder (intra_host.encode_band_payload)"),
        (intra_host, "write_sample", "encode: intra_host.write_sample"),
    ]
    overflowed = sum(int(o.sum()) for _, levels in packed
                     for _, _, o in levels)
    log(f"{BATCH} frames of {WIDTH}x{HEIGHT} YUY2 at quality {QUALITY}, "
        f"cap_bits 8: {overflowed} of {BATCH * 27} bands overflowed; "
        f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")

    timers = [Timed(m, n) for m, n, _ in host_fns]
    for t in timers:
        t.__enter__()
    try:
        for name, fn in stages.items():
            fn()
            ms = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            log(f"{name}: median {statistics.median(ms)} ms per batch of "
                f"{BATCH}, {statistics.median(ms) / BATCH} ms per frame "
                f"(runs: {ms})")
    finally:
        for t in timers:
            t.__exit__()
    # each host function ran in the warm-up and the REPS timed runs of its
    # stage
    for t, (_, _, what) in zip(timers, host_fns):
        per_frame = t.seconds * 1e3 / ((REPS + 1) * BATCH)
        log(f"  {what}: {per_frame} ms per frame ({t.calls} calls)")

    for name in ("encode device (upload + forward_packed)",
                 "decode device (inverse + download)"):
        fn = stages[name]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        busy = device_busy_ms(prof, out_dir) / PROFILED
        log(f"== {name}, profiled: wall {wall} ms per batch of {BATCH}, "
            f"device busy {busy} ms ({100 * busy / wall}% of wall)")
        log(prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=20, max_name_column_width=60))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    with open(args.out, "w") as f:
        f.write("\n".join(_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
