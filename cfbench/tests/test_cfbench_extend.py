"""A later change adds a configuration with a new pixel format and a new
content generator, a traffic mix with a new driver, and a per-layer
metric, as new files and new BENCHMARK.json entries, and the harness
finds and runs them, with no file that is there changed."""

import json
import os

from conftest import rehearse, write_json

CONTENT = '''"""UYVY frames: a diagonal ramp plus 2 bits of seeded noise."""

import numpy as np

from cfbench.content import noise, rng


def make(cfg, seed):
    w, h, n = cfg["width"], cfg["height"], cfg["frames"]
    ramp = (np.add.outer(np.arange(h), np.arange(2 * w)) & 0xFF)
    g = rng(seed)
    return (ramp[None].astype(np.uint8)
            + noise(g, (n, h, 2 * w), np.uint8, 3))
'''

FORMAT = '''"""UYVY 4:2:2: the YUY2 reference of the frame with each pair of bytes
swapped, its sample tagged with the UYVY input format (1, the SDK's
COLOR_FORMAT_UYVY)."""

import numpy as np

from cfbench.reference import codec, transform
from cfbench.reference.production import IntraParams


def params(cfg):
    return IntraParams(width=cfg["width"], height=cfg["height"],
                       quality=cfg["quality"])


def planes(cfg, frame):
    yuy2 = np.ascontiguousarray(frame).reshape(-1, 4)[:, [1, 0, 3, 2]]
    return transform.unpack_yuy2(yuy2.reshape(-1), cfg["width"],
                                 cfg["height"], params(cfg).precision)


def encode_sample(cfg, frame, frame_number, lossy=False):
    return codec.encode(params(cfg), planes(cfg, frame), frame_number, lossy,
                        input_format=1)


def decode_output(cfg, frame, output, lossy=False):
    if output != "YUY2":
        raise codec.unsupported(cfg, output)
    return codec.yuv422_output(params(cfg), planes(cfg, frame),
                               cfg["height"], lossy)
'''

DRIVER = '''"""Frames through `api.Encoder.encode_sample`, one call at a time a
client, each client its own encoder."""

import time

from cfbench import drive


def prepare(cfg, mix, frames, device, log):
    return None


class Load(drive.Load):
    def client(self, c):
        api = self.api
        enc = api.Encoder(self.device)
        enc.prepare_to_encode(self.cfg["width"], self.cfg["height"],
                              api.PixelFormat[self.cfg["format"]],
                              quality=api.EncodingQuality(self.cfg["quality"]))
        k = 0
        while not self.stopping:
            item = self.item(c, k)
            t0 = time.perf_counter()
            enc.encode_sample(self.frames[item])
            self.record(c, k, item, t0, True, enc.get_sample_data())
            k += 1


def expected(ref, cfg, mix, frame, rec, lossy):
    return ref.encode_sample(cfg, frame, rec.k + 1, lossy)
'''

METRIC = '''"""samples_seen: the window's finished requests (a test metric)."""


def read(ctx):
    return float(len(ctx.finished()))
'''


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_new_files_are_found_and_run(tiny):
    root, bench = tiny
    here = os.path.join(root, "cfbench")
    before = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(here) for f in fs}
    with open(os.path.join(here, "configs", "yuy2_1080.json")) as f:
        cfg = json.load(f)
    cfg.update(name="uyvy_small", width=64, height=48, frames=4,
               format="UYVY", content="ramp_uyvy", reduced=[])
    write_json(os.path.join(here, "configs", "uyvy_small.json"), cfg)
    _write(os.path.join(here, "content", "ramp_uyvy.py"), CONTENT)
    _write(os.path.join(here, "reference", "formats", "UYVY.py"), FORMAT)
    _write(os.path.join(here, "drivers", "encoder_sync.py"), DRIVER)
    write_json(os.path.join(here, "traffic", "sync_encode.json"), {
        "entry": "encoder_sync", "clients": 2, "stream_offset": 1,
        "warmup_items": 2, "warmup_seconds": 0.2, "keep_every": 2,
        "check": 100})
    _write(os.path.join(here, "metrics", "samples_seen.py"), METRIC)
    bench["configs"].append({"name": "uyvy_small", "source": "a test",
                             "file": "cfbench/configs/uyvy_small.json",
                             "reduced": [], "why": "a test"})
    cell = "uyvy_small.sync_encode"
    bench["workloads"].append({"name": cell, "config": "uyvy_small",
                               "traffic": "sync_encode", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_fps":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "samples_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "api", "moves": "encode_fps",
                               "workloads": [cell]})
    write_json(os.path.join(root, "BENCHMARK.json"), bench)
    # no file that was there changed
    assert {p: os.path.getmtime(p) for p in before} == before

    res = rehearse(root, bench, cell)
    assert res["correct"], res
    assert set(res["metrics"]) == {"encode_fps", "setup_s"}
    assert res["compared"]["checked_outputs"]["value"] >= 2
    traced = rehearse(root, bench, cell, traced=True)
    assert traced["correct"], traced
    assert traced["metrics"]["samples_seen"]["value"] >= 1
