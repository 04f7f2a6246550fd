#!/usr/bin/env python3
"""Run one cell of the benchmark of `cineform_tpu_torch` once, on one CUDA
card, from the root of a checkout:

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

`BENCHMARK.json` names the cell's configuration and traffic mix and its
metrics; `plugins` finds each by its name as a file of its own: the
configuration `cfbench/configs/<config>.json` with its content generator
and reference format, the mix `cfbench/traffic/<mix>.json` with its
driver, each end-to-end metric's reader `cfbench/e2e/<metric>.py` and
each per-layer metric's `cfbench/metrics/<metric>.py`.  This file holds
what every cell shares:

- the seed: the frames (`content`), which outputs are kept and which are
  checked all come from it;
- the set-up: the frames, the driver's inputs (the decoders' samples,
  encoded by the program), and the warm-up, the mix's loops run until
  every library is built and the pools are full; `setup_s` runs from
  the process's start to the window's;
- the timed window of `--seconds`, in which the loops run on;
- with `--trace 1`, the spans around the program's functions that the
  per-layer metrics ask for, read over the whole window, and then, with
  the load running on, `torch.profiler` over a sub-window of
  `PROFILE_SECONDS` that starts once the profiler has started (that
  takes 10-20 s on the card, with the load's threads running);
- the check of the window's outputs against the plain reference
  (`check`), after the window, the peak memory read and the program's
  state freed;
- the last line: one JSON object with `correct`, `attempted`, `failed`,
  `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
  per-layer ones), `device`, with `--trace 1` `breakdown`, and last
  `compared`, each number compared beside its limit.  Those numbers are
  also the last lines on standard error.

A run that finds no CUDA card, or fewer than the cell asks for, exits 1
with no result; one that finds JAX or the JAX package loaded once the
window has closed exits 2 with no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cfbench import check, plugins, spans, stats, trace  # noqa: E402

#: modules that may not be loaded once the window has closed, by their
#: whole top-level name: JAX and the JAX package (the port's own name
#: starts with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cineform_tpu")
#: the length of the profiled sub-window of a traced run, which follows
#: the window
PROFILE_SECONDS = 4.0
#: the longest a warm-up may take (the first run of a checkout builds
#: the program's CUDA and C++ libraries in it)
WARMUP_LIMIT_S = 900.0


@dataclass
class Context:
    """What a metric's reader gets."""

    cell: str
    cfg: dict
    mix: dict
    start: float                  # the window, perf_counter seconds
    end: float
    records: list
    setup_s: float
    spans: list = field(default_factory=list)
    call_bytes: list = field(default_factory=list)
    trace: object = None          # trace.Trace of the profiled sub-window
    batches: list = field(default_factory=list)   # pool batches in window
    fallback_frames: int | None = None
    #: the end of the timed window, before the profiler starts: the host
    #: spans' metrics read [start, quiet_end]
    quiet_end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def finished(self):
        """The window's requests that finished in it and succeeded."""
        return [r for r in self.records
                if r.ok and self.start <= r.end <= self.end]


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name and power limit, as nvidia-smi reports them, and
    the host's CPU model and core count: the host-bound cells' rates
    follow the host."""
    host = {"cpus": os.cpu_count()}
    try:
        with open("/proc/cpuinfo") as f:
            host["cpu"] = next((line.split(":", 1)[1].strip() for line in f
                                if line.startswith("model name")), "")
    except OSError:
        pass
    if device.type != "cuda":
        return host
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi: {exc}"
    return {"nvidia_smi": smi.splitlines()[0] if smi else "", **host}


def _sleep_until(t: float) -> None:
    while (left := t - time.perf_counter()) > 0:
        time.sleep(min(left, 0.05))


def run_cell(root: str, bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float = T_START,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)):
    """One run of `cell` on `device` -> its result line's object.  `root`
    holds BENCHMARK.json and the benchmark's data."""
    import torch

    parts = plugins.parts(root, cell)
    cfg, mix = parts.cfg, parts.mix
    name = cell["name"]

    frames = parts.frames(seed)
    inputs = parts.driver.prepare(cfg, mix, frames, device, log)

    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    readers = {m["name"]: plugins.find(
        root, "metrics" if traced else "e2e", m["name"])
        for m in (per_layer if traced else
                  [m for m in bench["end_to_end"] if applies(m, name)])}
    recorder = spans.Recorder()
    if traced:
        recorder.install(s for r in readers.values()
                         for s in getattr(r, "SPANS", ()))
        log(f"{name}: spans installed: {', '.join(recorder.installed)}")
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)

    load = parts.driver.Load(cfg, mix, frames, inputs, device, seed)
    slots = load.slots
    load.start()
    warm = time.perf_counter()
    while load.completed < mix["warmup_items"] or \
            time.perf_counter() - warm < mix["warmup_seconds"]:
        if time.perf_counter() - warm > WARMUP_LIMIT_S:
            load.stop()
            raise RuntimeError(f"warm-up unfinished after {WARMUP_LIMIT_S} s")
        time.sleep(0.01)

    t0 = time.perf_counter()
    c0 = load.counters()
    u0 = resource.getrusage(resource.RUSAGE_SELF)
    setup_s = t0 - t_start
    prof = tr = None
    _sleep_until(t0 + seconds)
    quiet_end = time.perf_counter()
    if traced:
        # the profiler's start loads and sets up CUPTI, which takes
        # seconds: the host spans are read before it, and the profiled
        # sub-window is timed from its end, however long it took
        prof = profile(activities=acts)
        prof.start()
        with record_function("cfbench.window_start"):
            h_start = time.perf_counter()
        log(f"{name}: the profiler took {h_start - quiet_end:.3f} s to start")
        _sleep_until(h_start + PROFILE_SECONDS)
        with record_function("cfbench.window_end"):
            pass
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
    t1 = time.perf_counter()
    c1 = load.counters()
    u1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"{name}: the window's host use: user {u1.ru_utime - u0.ru_utime:.3f}"
        f" s, system {u1.ru_stime - u0.ru_stime:.3f} s, minor faults "
        f"{u1.ru_minflt - u0.ru_minflt}, context switches voluntary "
        f"{u1.ru_nvcsw - u0.ru_nvcsw}, involuntary "
        f"{u1.ru_nivcsw - u0.ru_nivcsw}")
    load.stop()
    recorder.remove()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    batches = load.batches_between(c0, c1)
    fallback = (c1["fallback_frames"] - c0["fallback_frames"]
                if c0.get("fallback_frames") is not None else None)
    records = load.records
    del load                                # the program's state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            tr = trace.load(path, h_start, recorder.threads)
        inside = trace.launched_in(tr, spans.in_window(
            recorder.spans, tr.start, tr.end))
        log(f"{name}: profiled {tr.seconds:.3f} s: {len(tr.kernels)} kernels "
            f"({tr.launches_found} with their launch, {len(inside)} launched "
            f"inside a span), {len(tr.device)} device operations")
        for span_name in recorder.installed:
            sub = spans.in_window(recorder.spans, tr.start, tr.end, span_name)
            ks = trace.launched_in(tr, sub)
            log(f"{name}:   span {span_name}: {len(sub)} calls on threads "
                f"{sorted({s.thread for s in sub})}, {len(ks)} kernels "
                f"launched in them, {1e3 * sum(k.dur for k in ks):.3f} ms")

    ctx = Context(name, cfg, mix, t0, t1, records, setup_s,
                  recorder.spans, recorder.call_bytes, tr, batches, fallback,
                  quiet_end)
    metrics = {}
    for m in (per_layer if traced else bench["end_to_end"]):
        if m["name"] not in readers:
            continue
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    started = [r for r in records if t0 <= r.start <= t1]
    numbers, checked = check.compare(parts, frames, records, t0, t1, seed,
                                     slots)
    log(f"{name}: checked {len(checked)} outputs, (client, slot of "
        f"{slots}): {sorted({(r.client, r.k % slots) for r in checked})}")
    times = [1e3 * (r.end - r.start) for r in ctx.finished()]
    if times:
        log(f"{name}: {len(times)} requests finished in the window, wall ms "
            f"p10 {stats.percentile(times, 10):.2f} p50 "
            f"{stats.percentile(times, 50):.2f} p90 "
            f"{stats.percentile(times, 90):.2f}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": check.verdict(numbers, len(checked)),
              "attempted": len(started),
              "failed": sum(not r.ok for r in started),
              "metrics": metrics, "device": dev}
    if tr is not None:
        if device.type == "cuda" and tr.busy_seconds() <= 0:
            raise RuntimeError(f"the profiled {tr.seconds:.3f} s hold no "
                               "device operation")
        dev["busy_s"] = tr.busy_seconds()
        dev["window_s"] = tr.seconds
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(tr),
            "idle_gaps": trace.idle_gaps(tr, spans.in_window(
                recorder.spans, tr.start, tr.end))}
    result["card"] = card(device)
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in numbers.items()}
    result["compared"]["checked_outputs"] = {"value": len(checked),
                                             "limit": "at least 1"}
    errors = sorted({r.error for r in records if not r.ok})
    if errors:
        log(f"{name}: errors: {errors[:5]}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"run.py: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = run_cell(ROOT, bench, cell, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 2
    for k, v in result["compared"].items():
        print(f"compared: {k} {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
