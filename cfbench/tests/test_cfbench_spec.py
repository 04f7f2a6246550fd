"""BENCHMARK.json as the benchmark's contract reads it: the keys, the
names' and units' characters, the lengths, every configuration used and
its file under the benchmark's paths, and each per-layer metric's
end-to-end metric reported in every cell it lists; every name found as a
file by the harness."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _applies(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # the full check of 24 cells fits its allowance
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_configs():
    used = {c["config"] for c in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] == f"cfbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        # its content generator and reference format, found by name
        for kind, key in (("content", "content"),
                          ("reference/formats", "format")):
            assert os.path.isfile(os.path.join(
                ROOT, "cfbench", kind, f"{cfg[key]}.py")), (c["name"], key)
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    names = set()
    pairs = set()
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert w["name"] not in names
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["config"] in configs and w["chips"] == 1
        assert _line(w["why"])
        mix = os.path.join(ROOT, "cfbench", "traffic", f"{w['traffic']}.json")
        with open(mix) as f:
            entry = json.load(f)["entry"]
        # its driver, found by name
        assert os.path.isfile(os.path.join(ROOT, "cfbench", "drivers",
                                           f"{entry}.py")), (w["name"], entry)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = set()
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert os.path.exists(os.path.join(ROOT, "cfbench", "e2e",
                                           f"{m['name']}.py"))
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _applies(e2e[m["moves"]], cell), (m["name"], cell)
        assert os.path.exists(os.path.join(ROOT, "cfbench", "metrics",
                                           f"{m['name']}.py"))
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for cell in cells:
        got = [m["name"] for m in BENCH["end_to_end"] if _applies(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(_applies(m, cell) for m in BENCH["per_layer"])


def test_paths_hold_only_the_benchmark():
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    for part in BENCH["command"][1:]:
        if "/" in part:
            assert part.split("/")[0] in BENCH["paths"]
