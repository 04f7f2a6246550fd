"""A run, past the harness's look for a card, with the timed path broken
underneath, reads `correct` false: for each fault a cell of this codec
can have, an answer altered where it is produced and half of a batch left
out (these cells hold no state across steps and span one chip, so the
other faults of the contract have no place here).  The unbroken run reads
true."""

import numpy as np
import pytest

from conftest import rehearse


def _flip(out):
    """One byte of every answer changed."""
    if isinstance(out, list):
        return [s[:len(s) // 2] + bytes([s[len(s) // 2] ^ 1])
                + s[len(s) // 2 + 1:] for s in out]
    out = np.array(out)
    flat = out.reshape(out.shape[0], -1).view(np.uint8)
    flat[:, flat.shape[1] // 2] ^= 1
    return out


def _half(out):
    """The second half of the batch (rounded up) left out."""
    if isinstance(out, list):
        n = len(out)
        return out[:n // 2] + [bytes(len(s)) for s in out[n // 2:]]
    out = np.array(out)
    out[out.shape[0] // 2:] = 0
    return out


def _break(monkeypatch, method, fault):
    from cineform_tpu_torch.models.intra import IntraCodec

    orig = getattr(IntraCodec, method)

    def broken(self, *args, **kwargs):
        got = orig(self, *args, **kwargs)
        if method == "write_samples":
            return fault(got)
        out, fallback = got
        return fault(out), fallback

    monkeypatch.setattr(IntraCodec, method, broken)


CASES = [("yuy2_1080.pool_encode", "write_samples"),
         ("yuy2_1080.pool_decode", "decode_checked"),
         ("byr4_uhd.export_rg48", "decode_batch_device"),
         ("yuy2_1080.multicam_decode", "decode_batch_device")]


@pytest.mark.parametrize("cell,method", CASES, ids=[c for c, _ in CASES])
def test_sound_run_is_correct(tiny, cell, method):
    root, bench = tiny
    res = rehearse(root, bench, cell)
    assert res["correct"], res
    assert res["compared"]["checked_outputs"]["value"] >= 1


@pytest.mark.parametrize("fault", [_flip, _half], ids=["altered", "half"])
@pytest.mark.parametrize("cell,method", CASES, ids=[c for c, _ in CASES])
def test_broken_path_is_not_correct(tiny, monkeypatch, cell, method, fault):
    root, bench = tiny
    _break(monkeypatch, method, fault)
    res = rehearse(root, bench, cell)
    assert not res["correct"], res
