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
  decode device (`inverse` + download), and the parts of the device
  decode route (`decode_batch_device`): header walk and fill, upload,
  device entropy decode, inverse with pack, download;
- the program's own spans over those runs, from its tracer
  (`cineform_tpu_torch.utils.timing.report()`: calls and total, mean, min
  and max host ms a span name, and the band counters), which split the
  host tails (the fetch, each frame's sample, the C++ re-encode of the
  overflowed bands) and the device decode route (header walk, upload, each
  band decoder stage, download);
- for the device stages under torch.profiler (3 runs after a warm-up):
  the profiled wall ms per batch, the device's busy ms (the union of its
  kernel, copy and memset intervals) and its share of the wall, and the
  operators and kernels with the most device time; for the device decode
  route also the device ms per batch of each band decoder stage
  (`entropy.device_decode`: classify, chunk_transfers, scan_entries_rows,
  final_walk, emit_slots, compact_rows, spread_rows), the profiler's
  `key_averages()` row of the tracer's `entropy.*` range.

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
    from cineform_tpu_torch.entropy import device_decode as ddec
    from cineform_tpu_torch.models import intra as port_intra
    from cineform_tpu_torch.testframes import yuy2_frame
    from cineform_tpu_torch.utils import timing

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

    rows = codec._decode_rows_host(samples)
    dev_rows = ddec.upload_rows(rows, dev)
    dev_co = codec.decode_coefficients(*dev_rows[:5])[0]
    dev_out = codec.inverse(dev_co)

    def dec_route():
        return codec.decode_batch_device(samples)[0]

    stages = {
        "encode device (upload + forward_packed)": enc_dev,
        "encode host tail (write_samples)":
            lambda: codec.write_samples(frames, packed),
        "decode host tail (host_entropy_decode)":
            lambda: codec.host_entropy_decode(samples),
        "decode device (inverse + download)": dec_dev,
        "device decode route: header walk and fill (_decode_rows_host)":
            lambda: codec._decode_rows_host(samples),
        "device decode route: upload (upload_rows)":
            lambda: ddec.upload_rows(rows, dev),
        "device decode route: entropy decode (decode_coefficients)":
            lambda: codec.decode_coefficients(*dev_rows[:5]),
        "device decode route: inverse with pack (inverse)":
            lambda: codec.inverse(dev_co),
        "device decode route: download": lambda: dev_out.cpu().numpy(),
        "device decode route, whole (decode_batch_device)": dec_route,
    }
    overflowed = sum(int(o.sum()) for _, levels in packed
                     for _, _, o, _ in levels)
    log(f"{BATCH} frames of {WIDTH}x{HEIGHT} YUY2 at quality {QUALITY}, "
        f"cap_bits 8: {overflowed} of {BATCH * 27} bands overflowed; "
        f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")

    timing.enable()
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
        # each stage ran once to warm up and REPS times timed
        log(f"== the program's spans over those runs ({REPS + 1} of each "
            f"stage; host ms, a span's device work not waited for):")
        log(timing.report().rstrip())
    finally:
        timing.disable()

    for name in ("encode device (upload + forward_packed)",
                 "decode device (inverse + download)",
                 "device decode route, whole (decode_batch_device)"):
        fn = stages[name]
        fn()
        torch.cuda.synchronize()
        timing.enable()     # the spans' ranges name the decoder's stages
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / PROFILED
        finally:
            timing.disable()
        busy = device_busy_ms(prof, out_dir) / PROFILED
        log(f"== {name}, profiled: wall {wall} ms per batch of {BATCH}, "
            f"device busy {busy} ms ({100 * busy / wall}% of wall)")
        rows = prof.key_averages()
        for row in sorted(rows, key=lambda r: r.key):
            if row.key.startswith("entropy."):
                ms = row.device_time_total / 1e3 / PROFILED
                log(f"  band decoder stage {row.key}: device {ms} ms per "
                    f"batch, {ms / BATCH} ms per frame ({row.count} ranges)")
        log(rows.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    with open(args.out, "w") as f:
        f.write("\n".join(_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
