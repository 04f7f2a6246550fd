"""The port's command line (`python -m cineform_tpu_torch.cfhd_tool`) against
the JAX package's `tools/cfhd_tool.py`: each subcommand run in-process
with the same arguments at a small size, the port's with `--device cpu`
and the JAX tool on its API's host route (`CINEFORM_API_DEVICE=0`).
They write the same sample and frame bytes and print the same lines;
`fuzz` counts the same outcomes and decodes the same bytes trial by trial.
The `pool` subcommand is in `tests/test_torch_cfhd_tool_pool.py`."""

import importlib.util
import os
import sys

import pytest

from cineform_tpu import api as japi
from cineform_tpu_torch import api, cfhd_tool, testframes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(REPO, "tests", "golden", "samples")


def jax_tool():
    """`tools/cfhd_tool.py`, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_cfhd_tool", os.path.join(REPO, "tools", "cfhd_tool.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_both(args, monkeypatch, capsys):
    """Both tools on `args`: [(exit code, printed lines)] JAX's, port's."""
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    tool = jax_tool()
    monkeypatch.setattr(sys, "argv", ["cfhd_tool.py", *args])
    out = [(tool.main(), capsys.readouterr().out)]
    out.append((cfhd_tool.main([*args, "--device", "cpu"]),
                capsys.readouterr().out))
    return out


@pytest.mark.parametrize("fmt,frame", [
    ("YUY2", testframes.yuy2_frame), ("RG48", testframes.rg48_frame),
    ("b64a", testframes.b64a_frame)])
def test_encode(fmt, frame, tmp_path, monkeypatch, capsys):
    raw = tmp_path / "in.raw"
    raw.write_bytes(frame(64, 48, 1))
    outs = [tmp_path / "jax.cfhd", tmp_path / "port.cfhd"]
    args = ["--width", "64", "--height", "48", "--format", fmt]
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    tool = jax_tool()
    monkeypatch.setattr(sys, "argv", ["cfhd_tool.py", "encode", str(raw),
                                      str(outs[0]), *args])
    want = (tool.main(), capsys.readouterr().out)
    got = (cfhd_tool.main(["encode", str(raw), str(outs[1]), *args,
                           "--device", "cpu"]), capsys.readouterr().out)
    assert got == want and want[0] == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()


@pytest.mark.parametrize("name,extra", [
    ("s_128x96_q4_p1.cfhd", []),
    ("s_128x96_q4_p1.cfhd", ["--resolution", "2"]),
    ("s_128x96_q4_p1.cfhd", ["--format", "YU64"]),
    ("s_128x96_q4_p1.cfhd", ["--width", "96", "--height", "72"]),
    ("rg48_320x240_q4_p1.cfhd", ["--format", "RG48"]),
])
def test_decode(name, extra, tmp_path, monkeypatch, capsys):
    src = os.path.join(SAMPLES, name)
    outs = [tmp_path / "jax.raw", tmp_path / "port.raw"]
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    tool = jax_tool()
    monkeypatch.setattr(sys, "argv",
                        ["cfhd_tool.py", "decode", src, str(outs[0]), *extra])
    want = (tool.main(), capsys.readouterr().out)
    got = (cfhd_tool.main(["decode", src, str(outs[1]), *extra,
                           "--device", "cpu"]), capsys.readouterr().out)
    assert got == want and want[0] == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()


@pytest.mark.parametrize("quality", [4, 6])
def test_roundtrip(quality, monkeypatch, capsys):
    (rc_j, line_j), (rc_t, line_t) = run_both(
        ["roundtrip", "--width", "160", "--height", "120", "--quality",
         str(quality)], monkeypatch, capsys)
    assert (rc_t, line_t) == (rc_j, line_j) and rc_j == 0
    assert "PSNR" in line_t


@pytest.mark.parametrize("name", ["s_128x96_q4_p1.cfhd",
                                  "rg48_320x240_q4_p1.cfhd",
                                  "byr4_320x240_q4_p1.cfhd"])
def test_info(name, monkeypatch, capsys):
    (rc_j, line_j), (rc_t, line_t) = run_both(
        ["info", os.path.join(SAMPLES, name)], monkeypatch, capsys)
    assert (rc_t, line_t) == (rc_j, line_j) and rc_j == 0


def _recording(monkeypatch, decoder_class, log):
    """Record each decode_sample's outcome of `decoder_class`: the frame's
    bytes, or the exception's type name."""
    real = decoder_class.decode_sample

    def decode_sample(self, sample):
        try:
            out = real(self, sample)
        except Exception as exc:
            log.append(type(exc).__name__)
            raise
        log.append(None if out is None else out.tobytes())
        return out

    monkeypatch.setattr(decoder_class, "decode_sample", decode_sample)


def test_fuzz_at_its_defaults(monkeypatch, capsys):
    """`fuzz` at 320x240, 50 trials of 8 flips from `random.Random(7)`:
    the same counts as the JAX tool, and trial by trial the same outcome
    (the frame's bytes, or a CFHDError)."""
    logs = {"jax": [], "port": []}
    _recording(monkeypatch, japi.Decoder, logs["jax"])
    _recording(monkeypatch, api.Decoder, logs["port"])
    (rc_j, line_j), (rc_t, line_t) = run_both(["fuzz"], monkeypatch, capsys)
    assert (rc_t, line_t) == (rc_j, line_j) and rc_j == 0
    # chip_smoke.py's phase 15 holds the card's line to these counts
    assert line_j.strip() == \
        "fuzz: 44 decoded, 6 rejected cleanly, 0 crashes"
    assert len(logs["port"]) == len(logs["jax"]) == 50
    for trial, (got, want) in enumerate(zip(logs["port"], logs["jax"])):
        assert got == want, trial
    decoded = sum(x != "CFHDError" for x in logs["port"])
    assert line_t.strip() == (f"fuzz: {decoded} decoded, {50 - decoded} "
                              f"rejected cleanly, 0 crashes")
    assert 0 < decoded < 50
