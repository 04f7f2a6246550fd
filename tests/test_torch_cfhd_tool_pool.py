"""The port's `cfhd_tool pool` against the JAX package's `tools/cfhd_tool.py
pool` at a small size: the same printed count, and the same samples in
the same order (the JAX pool's device batcher compiles its program on the
CPU here, about 20 s)."""

import sys

from cineform_tpu import pool as jpool
from cineform_tpu_torch import cfhd_tool, pool
from test_torch_cfhd_tool import jax_tool


def _recording(monkeypatch, pool_class, log):
    real = pool_class.wait_for_sample

    def wait_for_sample(self, *args, **kw):
        out = real(self, *args, **kw)
        log.append(bytes(out.data) if hasattr(out, "data") else bytes(out))
        return out

    monkeypatch.setattr(pool_class, "wait_for_sample", wait_for_sample)


def test_pool(monkeypatch, capsys):
    args = ["pool", "--width", "64", "--height", "48", "--threads", "1",
            "--frames", "3"]
    logs = {"jax": [], "port": []}
    _recording(monkeypatch, jpool.EncoderPool, logs["jax"])
    _recording(monkeypatch, pool.EncoderPool, logs["port"])
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")
    tool = jax_tool()
    monkeypatch.setattr(sys, "argv", ["cfhd_tool.py", *args])
    assert tool.main() == 0
    want = capsys.readouterr().out
    assert cfhd_tool.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.split(" in ")[0] == want.split(" in ")[0] == "3 frames"
    assert got.strip().endswith("fps (1 threads)")
    assert len(logs["port"]) == 3 and logs["port"] == logs["jax"]
