"""Stage timing and codec counters: the reference's TIMER/COUNTER analog.

Port of `cineform_tpu.utils.timing`.  The reference instruments its
pipeline with `TIMER`/`COUNTER` macros (`Codec/timing.h:88-115`) and prints
CSV statistics (`PrintStatistics`, `timing.h:42`).

Here: a context-manager stage timer that waits for the device work of the
tensors it is given (`torch.cuda.synchronize` of each CUDA device they lie
on), so a device stage measures its compute and not its launch; counters;
and a CSV report.  For device profiles use `torch.profiler` alongside.
"""

from __future__ import annotations

import io
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)


def _devices(tree, out: set) -> set:
    """The devices of the tensors in nested lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _devices(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _devices(t, out)
    else:
        raise TypeError(f"Timing.stage: cannot wait for a {type(tree)}; "
                        "sync takes tensors in lists, tuples and dicts")
    return out


def wait_for(tree) -> None:
    """Wait until the device work behind the tensors of `tree` is done: a
    CUDA device is synchronized; a CPU tensor is complete when it is
    returned."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elif dev.type != "cpu":
            raise ValueError(f"Timing.stage: no way to wait for {dev}")


@dataclass
class Timing:
    """Collects per-stage wall times and event counters."""

    stages: dict = field(default_factory=lambda: defaultdict(StageStats))
    counters: dict = field(default_factory=lambda: defaultdict(int))

    @contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass its tensors as `sync` (or set
        `result["sync"]` on the yielded dict) to wait for their device work
        before the clock stops."""
        t0 = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            if sync is not None:
                wait_for(sync)
            elif "sync" in result:
                wait_for(result["sync"])
            self.stages[name].add(time.perf_counter() - t0)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def report(self) -> str:
        out = io.StringIO()
        out.write("stage,calls,total_ms,mean_ms,min_ms,max_ms\n")
        for name, s in sorted(self.stages.items()):
            out.write(f"{name},{s.calls},{s.total_s*1e3:.3f},"
                      f"{s.total_s/max(s.calls,1)*1e3:.3f},"
                      f"{s.min_s*1e3:.3f},{s.max_s*1e3:.3f}\n")
        for name, v in sorted(self.counters.items()):
            out.write(f"counter:{name},{v}\n")
        return out.getvalue()
