#!/usr/bin/env python3
"""What the port's tracer (`cineform_tpu_torch.utils.timing`) costs, and
whether its clock agrees with the profiler's, on one CUDA card.

    python3 tools/check_tracer.py [--out out/check_tracer.json]

Run from the root of a checkout on a machine with a CUDA card.  On the
benchmark's two paths, at their sizes (a batch of 8 1920x1080 YUY2 frames
through `IntraCodec.encode_batch_device`; 3840x2160 BYR4 samples through
`api.Decoder` to RG48), with the test frames of pattern 1, it gives:

- `off_ns_per_span`, `on_ns_per_span`: host ns a `with timing.span(...)`
  takes with the tracer off, and on with no profiler running (the median of
  5 loops of 200,000);
- `spans_per_frame`: the spans the tracer records a frame on each path;
- `per_frame`: under `torch.profiler`, with the tracer off and then on, the
  device-to-host copies, the CUDA synchronize calls (`cuda*Synchronize`)
  and the copy calls (`cudaMemcpy*`) a frame: the tracer adds none;
- `clock`, `clock_gc_off`: for each span that is also a `record_function`
  range of the profiler's trace, its start less the range's, on the host's
  clock through the offset that a `cfbench.window_start` range gives (as
  `cfbench/trace.load` maps a traced run): the count, the median, 99th
  percentile and largest absolute difference in ms, the share within 0.1
  ms, the drift (ms a second since the mark, least squares), and the five
  largest with whether a garbage collection ran between the two readings;
  `clock_gc_off` with the collector off while profiling.

It prints one JSON object, with the card's name and power limit, and
writes it to --out as well.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOPS, REPS = 200_000, 5
ENCODE = (1920, 1080, 8)          # width, height, batch
DECODE = (3840, 2160, 4)          # width, height, samples
PROFILED = 3                      # encode batches or decode passes profiled


def span_ns(timing) -> float:
    """Host ns of one `with timing.span(...)`: the median of REPS loops."""
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter_ns()
        for _ in range(LOOPS):
            with timing.span("intra.fetch"):
                pass
        runs.append((time.perf_counter_ns() - t0) / LOOPS)
    return statistics.median(runs)


def trace_events(prof, tmp: str) -> list:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def digest(outputs) -> str:
    """One hash of a run's samples or frames."""
    h = hashlib.sha256()
    for x in outputs:
        h.update(x if isinstance(x, bytes) else np.ascontiguousarray(x))
    return h.hexdigest()


def counts(events, frames: int) -> dict:
    """Device-to-host copies, synchronize calls and copy calls a frame."""
    def n(pred):
        return sum(1 for e in events if pred(e)) / frames

    return {
        "dtoh_copies": n(lambda e: e.get("cat") == "gpu_memcpy"
                         and "DtoH" in e.get("name", "")),
        "synchronize_calls": n(lambda e: e.get("cat") in (
            "cuda_runtime", "cuda_driver")
            and "Synchronize" in e.get("name", "")),
        "memcpy_calls": n(lambda e: e.get("cat") in (
            "cuda_runtime", "cuda_driver")
            and "Memcpy" in e.get("name", "")),
    }


def clock_pairs(events, host_start: float, snap) -> list[tuple]:
    """(name, span start, range start) of each span, in host seconds."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    mark = next(e["ts"] for e in ranges
                if e["name"] == "cfbench.window_start")
    offset = mark / 1e6 - host_start
    pairs = []
    for name in {s.name for s in snap.spans}:
        rs = sorted(e["ts"] for e in ranges if e["name"] == name)
        ss = sorted(s.start for s in snap.spans if s.name == name)
        if len(rs) != len(ss):
            raise RuntimeError(f"{name}: {len(rs)} ranges, {len(ss)} spans")
        pairs += [(name, s / 1e9, r / 1e6 - offset) for r, s in zip(rs, ss)]
    return pairs


def clock_summary(pairs: dict, marks: dict, collections: list) -> dict:
    """The differences of `clock_pairs` of each path (`pairs[path]`, marked
    at `marks[path]`), in ms; `collections`: (start, end) of each garbage
    collection, host seconds."""
    rows = []
    for key, ps in pairs.items():
        for name, span, rng in ps:
            lo, hi = min(span, rng), max(span, rng)
            rows.append((name, span - marks[key], 1e3 * (span - rng), any(
                a <= hi and b >= lo for a, b in collections)))
    d = [r[2] for r in rows]
    absd = sorted(abs(x) for x in d)
    t = [r[1] for r in rows]
    mt, md = statistics.fmean(t), statistics.fmean(d)
    var = sum((x - mt) ** 2 for x in t)
    worst = sorted(rows, key=lambda r: -abs(r[2]))[:5]
    return {"spans": len(d), "median_ms": statistics.median(d),
            "median_abs_ms": statistics.median(absd),
            "p99_abs_ms": absd[int(0.99 * (len(absd) - 1))],
            "max_abs_ms": absd[-1],
            "within_0.1ms": sum(x <= 0.1 for x in absd) / len(absd),
            "drift_ms_per_s": sum((x - mt) * (y - md) for x, y in zip(t, d))
            / var if var else 0.0,
            "largest": [{"span": n, "s_after_mark": a, "ms": b,
                         "gc_between": g} for n, a, b, g in worst]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "out",
                                                  "check_tracer.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise SystemExit("check_tracer: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from cineform_tpu_torch import api, testframes
    from cineform_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    w, h, batch = ENCODE
    base = np.frombuffer(testframes.yuy2_frame(w, h, 1), np.uint8).reshape(
        h, 2 * w)
    frames = np.stack([np.roll(base, i, axis=0) for i in range(batch)])
    encoder = api.intra_codec(w, h, 4, "YUY2", dev)
    dw, dh, nd = DECODE
    mosaic = np.frombuffer(testframes.byr4_frame(dw, dh, 1), np.uint8)
    mosaics = np.stack([np.roll(mosaic.reshape(dh, -1), 2 * i, axis=0)
                        for i in range(nd)])
    samples = api.intra_codec(dw, dh, 4, "BYR4", dev).encode_batch_device(
        mosaics)
    decoder = api.Decoder(dev)
    decoder.prepare_to_decode(dw, dh, api.PixelFormat.RG48)

    def encode():
        return encoder.encode_batch_device(frames)

    def decode():
        return [decoder.decode_sample(s) for s in samples]

    paths = {"encode": (encode, batch), "decode": (decode, nd)}
    out = {"off_ns_per_span": span_ns(timing)}
    timing.enable()
    out["on_ns_per_span"] = span_ns(timing)
    timing.disable()

    collections, gc_start = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_start.append(time.perf_counter())
        elif gc_start:
            collections.append((gc_start.pop(), time.perf_counter()))

    gc.callbacks.append(on_gc)
    results = {name: [] for name in paths}
    pairs = {"on": {}, "on_gc_off": {}}
    marks = {"on": {}, "on_gc_off": {}}
    out["per_frame"], out["spans_per_frame"] = {}, {}
    for name, (fn, n) in paths.items():
        results[name].append(fn())             # warm-up, tracer off
        torch.cuda.synchronize()
        for mode in ("off", "on", "on_gc_off"):
            if mode != "off":
                timing.enable()
            if mode == "on_gc_off":
                gc.disable()
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        with record_function("cfbench.window_start"):
                            host_start = time.perf_counter()
                        for _ in range(PROFILED):
                            results[name].append(fn())
                        torch.cuda.synchronize()
                    events = trace_events(prof, tmp)
            finally:
                gc.enable()
            if mode == "off" or mode == "on":
                out["per_frame"][f"{name}.{mode}"] = counts(
                    events, PROFILED * n)
            if mode != "off":
                snap = timing.snapshot()
                timing.disable()
                timing.reset()
                out["spans_per_frame"][name] = len(snap.spans) / (
                    PROFILED * n)
                pairs[mode][name] = clock_pairs(events, host_start, snap)
                marks[mode][name] = host_start
    gc.callbacks.remove(on_gc)
    out["outputs_equal_on_and_off"] = all(
        len({digest(r) for r in runs}) == 1 for runs in results.values())
    out["clock"] = clock_summary(pairs["on"], marks["on"], collections)
    out["clock_gc_off"] = clock_summary(pairs["on_gc_off"],
                                        marks["on_gc_off"], collections)
    out["collections"] = len(collections)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out["card"] = smi.splitlines()[0] if smi else ""
    out["torch"] = torch.__version__
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
