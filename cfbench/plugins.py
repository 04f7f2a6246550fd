"""Find a piece of the benchmark by its name: each configuration, traffic
mix, content generator, driver, reference format and metric is a file of
its own under the checkout's `cfbench/`, named in `BENCHMARK.json` or in
a configuration's or a mix's file.

- `configs/<config>.json`: a configuration; its `content` names
  `content/<content>.py`, its `format` `reference/formats/<format>.py`;
- `traffic/<mix>.json`: a mix's parameters; its `entry` names
  `drivers/<entry>.py`;
- `e2e/<metric>.py`, `metrics/<metric>.py`: the readers of the end-to-end
  and the per-layer metrics.

A later change adds a piece by adding its file, and edits none that is
there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass


def load_module(path: str, tag: str):
    """The Python file at `path`, loaded as its own module."""
    name = "cfbench_" + "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(root: str, kind: str, name: str):
    """The module `cfbench/<kind>/<name>.py` under `root`."""
    path = os.path.join(root, "cfbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    return load_module(path, f"{kind}.{name}")


def read_json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, "cfbench", kind, f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Parts:
    """A cell's pieces: its configuration and mix, and the modules that
    make its frames, drive the program and work out the reference's
    answers."""

    cfg: dict
    mix: dict
    content: object
    driver: object
    reference: object

    def frames(self, seed: int):
        return self.content.make(self.cfg, seed)

    def answer(self, frames, rec, lossy: bool = False):
        """The reference's answer to the request `rec` (`drive.Record`);
        `lossy` computes it as the control does."""
        return self.driver.expected(self.reference, self.cfg, self.mix,
                                    frames[rec.item], rec, lossy)


def parts(root: str, cell: dict) -> Parts:
    cfg = read_json(root, "configs", cell["config"])
    mix = read_json(root, "traffic", cell["traffic"])
    return Parts(cfg, mix, find(root, "content", cfg["content"]),
                 find(root, "drivers", mix["entry"]),
                 find(root, "reference/formats", cfg["format"]))
