#!/usr/bin/env python3
"""The control of the check: the plain reference put in the program's
place at the cell's own size, computed a step below the codec's stated
precision (its lowpass coefficients held in float16,
`reference.codec`'s `lossy`), and compared as a run compares the
program's outputs.  It has to read above every limit.

    python3 cfbench/control.py --workload <cell> --seeds 1 2 3

For each seed it draws the cell's frames and, as many as a run checks,
the requests whose answers it compares (request k of client c for item
c * stream_offset + k, one from each block of `keep_every`, as a run's
clients keep them), and prints one JSON line a seed with
`differing_bytes` (the number the check compares) and, last, the
smallest reading over the seeds: the upper reading of the limit.  The
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from cfbench import check, content, plugins  # noqa: E402
from cfbench.drive import Record  # noqa: E402


def readings(parts, seed: int, slots: int = 8) -> dict:
    mix = parts.mix
    frames = parts.frames(seed)
    every = mix.get("keep_every", 1)
    g = content.rng(seed, 3)
    # the requests a run's kept outputs would be, a block each
    records = []
    for c in range(mix.get("clients", 1)):
        for block in range(mix["check"]):
            k = block * every + int(g.integers(every))
            item = (c * mix.get("stream_offset", 0) + k) % len(frames)
            records.append(Record(c, k, item, 0.0, 0.0, True, output=True))
    chosen = check.choose(records, 0.0, 1.0, mix["check"], seed, slots)
    diff = sum(check.differing(parts.answer(frames, r, lossy=True),
                               parts.answer(frames, r)) for r in chosen)
    return {"seed": seed, "checked": len(chosen), "differing_bytes": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = {c["name"]: c for c in json.load(f)["workloads"]}[
            args.workload]
    parts = plugins.parts(ROOT, cell)
    got = []
    for seed in args.seeds:
        got.append(readings(parts, seed))
        print(json.dumps({"workload": args.workload, **got[-1]}), flush=True)
    print(json.dumps({"workload": args.workload, "control_min_differing_bytes":
                      min(g["differing_bytes"] for g in got),
                      "limit": check.LIMITS["differing_bytes"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
