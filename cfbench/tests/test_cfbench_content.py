"""The seeded frame generators repeat for a seed and differ between
seeds, at every size a seed may take; every seed gives the same frames
up to their noise, in another order."""

import numpy as np
import pytest

from cfbench import plugins
from conftest import ROOT


def make_frames(cfg, seed):
    return plugins.find(ROOT, "content", cfg["content"]).make(cfg, seed)

CFGS = [dict(width=96, height=64, frames=3, noise_bits=3,
             content="plasma_noise_yuy2"),
        dict(width=64, height=32, frames=2, noise_bits=11,
             content="plasma_noise_byr4")]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["content"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
def test_frames_repeat_and_differ_by_seed(cfg, seed):
    a = make_frames(cfg, seed)
    assert a.shape == (cfg["frames"], cfg["height"], 2 * cfg["width"])
    assert a.dtype == np.uint8
    assert np.array_equal(a, make_frames(cfg, seed))
    assert not np.array_equal(a, make_frames(cfg, seed + 1))
    # each frame its own roll and noise
    assert not np.array_equal(a[0], a[1])


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["content"])
def test_seeds_give_the_same_frames_in_another_order(cfg):
    """Without their noise, the frames are the same set for every seed, so
    the work of a run does not depend on its seed; the noise stays in its
    bits."""
    flat = dict(cfg, noise_bits=0)
    a, b = make_frames(flat, 5), make_frames(flat, 2**32 + 9)
    assert sorted(f.tobytes() for f in a) == sorted(f.tobytes() for f in b)
    dtype, mod = (np.uint8, 256) if cfg["content"].endswith("yuy2") \
        else ("<u2", 65536)
    noisy = make_frames(cfg, 5).view(dtype).astype(np.int64)
    clean = a.view(dtype).astype(np.int64)
    assert np.all((noisy - clean) % mod < 1 << cfg["noise_bits"])


def test_noise_stays_in_its_bits():
    cfg = CFGS[1]
    a = make_frames(cfg, 3).view("<u2").astype(np.int64)
    w, h = cfg["width"], cfg["height"]
    xg, yg = np.meshgrid(np.arange(w), np.arange(h))
    base = ((xg * 9 + yg * 13) << 5) & 0xFFFF
    # some even roll of the gradient, plus noise under 2**11
    for frame in a:
        assert any(np.all(((frame - np.roll(base, r, 0)) & 0xFFFF) < 2048)
                   for r in range(0, h, 2))
