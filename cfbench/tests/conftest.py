"""Shared helpers of the benchmark's CPU tests: a copy of the benchmark's
pieces found by name (BENCHMARK.json, configurations, mixes, content
generators, drivers, reference formats, metric readers) under a temporary
root, cut to a size the CPU runs in seconds, and a run of one cell there
on the CPU, past the harness's look for a card."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the rehearsal sizes: width, height, frames
TINY = {"yuy2_1080": (96, 64, 8), "byr4_uhd": (192, 96, 4)}
#: the directories of pieces found by name
PIECES = ("configs", "traffic", "metrics", "e2e", "content", "drivers",
          os.path.join("reference", "formats"))
#: cells whose mixes are there for later (PERF.md's open questions),
#: rehearsed as well: cell -> (configuration, mix)
LATER = {"yuy2_1080.pool_decode": ("yuy2_1080", "pool_decode"),
         "yuy2_1080.multicam_decode": ("yuy2_1080", "multicam_decode")}


def make_root(dest: str) -> dict:
    """Copy the benchmark's pieces to `dest`, cut to the rehearsal sizes:
    every output kept and checked, short warm-ups, pools of 2 in flight,
    and the `LATER` cells added.  Returns the BENCHMARK.json dict."""
    for d in PIECES:
        shutil.copytree(os.path.join(ROOT, "cfbench", d),
                        os.path.join(dest, "cfbench", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (config, mix) in LATER.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "a later cell"})
        for m in bench["end_to_end"]:
            if m["name"] == "decode_fps":
                m["workloads"].append(cell)
    write_json(os.path.join(dest, "BENCHMARK.json"), bench)
    for name, (w, h, n) in TINY.items():
        edit_json(os.path.join(dest, "cfbench", "configs", f"{name}.json"),
                  width=w, height=h, frames=n)
    for mix in os.listdir(os.path.join(dest, "cfbench", "traffic")):
        path = os.path.join(dest, "cfbench", "traffic", mix)
        with open(path) as f:
            m = json.load(f)
        edit_json(path, warmup_items=2, warmup_seconds=0.2, keep_every=1,
                  check=1000, in_flight=min(m["in_flight"], 2))
    return bench


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def edit_json(path: str, **changes) -> None:
    with open(path) as f:
        obj = json.load(f)
    obj.update(changes)
    write_json(path, obj)


def rehearse(root: str, bench: dict, cell: str, seed: int = 2**31 + 11,
             seconds: float = 4.0, traced: bool = False) -> dict:
    """One run of `cell` on the CPU from `root` -> its result."""
    import torch

    from cfbench import run

    cells = {c["name"]: c for c in bench["workloads"]}
    return run.run_cell(root, bench, cells[cell], seed, seconds, traced,
                        torch.device("cpu"), t_start=time.perf_counter(),
                        log=lambda msg: None)


@pytest.fixture
def tiny(tmp_path):
    """(root, BENCHMARK.json dict) of a rehearsal-size copy."""
    root = str(tmp_path / "bench")
    return root, make_root(root)
