"""The port's forward DWT in its channel groups
(`cineform_tpu_torch.ops.dwt_forward`: level 1 from the YUY2 bytes, then
one call a level for the three channels) against the JAX package's
`unpack_yuy2` and `dwt2d_forward`, against the Pallas kernel in interpret
mode, and against the stack/pad layout the entropy coder read before; and
`IntraCodec.forward` and `forward_packed` against the JAX
`IntraCodec.forward`.

On the CPU the wrappers run their plain versions; the card's kernels are
held against those in tests/test_torch_kernels.py.  Inputs are made with
numpy from a seed; every comparison is exact (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cineform_tpu.models.intra import IntraCodec as JaxIntraCodec
from cineform_tpu.ops import intra_transform as jops
from cineform_tpu.ops.pallas_dwt2 import dwt2d_forward_pallas2
from cineform_tpu.spec.production import IntraParams
from cineform_tpu_torch.entropy import device as edev
from cineform_tpu_torch.models import intra_host
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.ops import dwt_forward as dwt
from cineform_tpu_torch.ops import intra_transform as tops

torch.set_num_threads(1)

CPU = torch.device("cpu")

#: (width, height, levels): the small goldens' sizes (112x48: band pitch
#: above the width, e.g. chroma level 1 28 -> 32), 320x240, and the
#: narrow-row quirk (32x24: level 1 chroma and level 2 luma 16 wide, with
#: the previous row's pixels; 48x24: level 3 luma 12 wide, without them,
#: and the minimum 6x6 chroma plane)
SIZES = [(64, 48, 3), (112, 48, 3), (320, 240, 3), (32, 24, 2), (48, 24, 3)]


def _frames(seed, batch, h, w) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (batch, h, 2 * w)).astype(np.uint8)


def _quants(params, k):
    return [tuple(params.band_quant(ch)[k]) for ch in range(3)]


def _jax_levels(frames, params, levels):
    """JAX `unpack_yuy2`, then `dwt2d_forward` level by level (one jitted
    program): per level, per channel, (ll, [lh, hl, hh]) as numpy."""
    def program(f):
        planes = jops.unpack_yuy2(f, params.precision)
        out = []
        for k in range(levels):
            res = [jops.dwt2d_forward(planes[ch], params.prescale[k],
                                      _quants(params, k)[ch])
                   for ch in range(3)]
            planes = [ll for ll, _ in res]
            out.append(res)
        return out

    return [[(np.asarray(ll), [np.asarray(b) for b in bands])
             for ll, bands in level]
            for level in jax.jit(program)(jnp.asarray(frames))]


def _grouped(per_channel):
    """Per-channel (ll, [lh, hl, hh]) -> (lows, highs) by group, as numpy:
    (B, G, h, w) and (B, G, 3, h, pitch) with zero pad columns."""
    lows, highs = [], []
    for grp in dwt.GROUPS:
        lows.append(np.stack([per_channel[ch][0] for ch in grp], 1))
        t = np.stack([np.stack(per_channel[ch][1], 1) for ch in grp], 1)
        w = t.shape[-1]
        highs.append(np.pad(t, [(0, 0)] * 4
                            + [(0, intra_host.align16_pixels(w) - w)]))
    return lows, highs


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _eq_groups(got, want):
    for g_parts, w_parts in zip(got, want, strict=True):
        for g, w in zip(g_parts, w_parts, strict=True):
            assert g.dtype == torch.int32
            _eq(g, w)


def _stack_pad(per_channel_bands, grp):
    """The band layout the entropy coder read before the group buffers:
    `torch.stack` of each channel's (LH, HL, HH), `F.pad` to the pitch."""
    h, w = per_channel_bands[grp[0]][0].shape[-2:]
    pitch = intra_host.align16_pixels(w)
    trios = torch.stack([torch.stack(tuple(per_channel_bands[ch]), dim=1)
                         for ch in grp], dim=1)
    trios = F.pad(trios, (0, pitch - w))
    return trios.reshape(trios.shape[0], len(grp), 3, h * pitch)


@pytest.mark.parametrize("w,h,levels", SIZES)
def test_fused_levels_match_jax(w, h, levels):
    """Level 1 from the bytes and the three-channel levels after it, on
    the port's own outputs, against JAX level by level."""
    params = IntraParams(width=w, height=h, quality=4)
    frames = _frames(w + h, 2, h, w)
    want = _jax_levels(frames, params, levels)
    got = dwt.dwt_forward_yuy2(torch.from_numpy(frames), params.precision,
                               params.prescale[0], _quants(params, 0))
    _eq_groups(got, _grouped(want[0]))
    for k in range(1, levels):
        got = dwt.dwt_forward_groups(got[0], params.prescale[k],
                                     _quants(params, k))
        _eq_groups(got, _grouped(want[k]))


@pytest.mark.parametrize("prescale", [0, 2])
def test_fused_level1_matches_pallas_interpret(prescale):
    """The fused level 1 against `dwt2d_forward_pallas2` in interpret mode
    (as tests/test_pallas_dwt.py runs it) on the JAX unpack's planes; the
    planes are wider than 16, where the Pallas kernel skips no quirk."""
    w, h = 128, 64
    quants = [(24, 24, 36), (6, 6, 3), (12, 12, 6)]
    frames = _frames(7 + prescale, 2, h, w)
    planes = jops.unpack_yuy2(jnp.asarray(frames), 10)
    want = []
    for ch in range(3):
        ll, bands = dwt2d_forward_pallas2(planes[ch], prescale, quants[ch],
                                          tile_out=32, interpret=True)
        want.append((np.asarray(ll), [np.asarray(b) for b in bands]))
    got = dwt.dwt_forward_yuy2(torch.from_numpy(frames), 10, prescale,
                               quants)
    _eq_groups(got, _grouped(want))


def test_group_buffers_equal_the_stack_pad_layout():
    """`forward_levels`' band buffers, flattened by `group_bands`, equal
    the stack/pad layout built from each channel's own transform
    (`forward_channel`), pad columns included (112x48: chroma pitch 32
    for width 28 at level 1)."""
    w, h = 112, 48
    codec = IntraCodec(w, h, 4, device=CPU)
    frames = torch.from_numpy(_frames(3, 2, h, w))
    t = codec.tables()
    planes = tops.unpack_yuy2(frames, codec.params.precision)
    per_channel = [tops.forward_channel(planes[ch], t.band_quant[ch],
                                        t.prescale)[1] for ch in range(3)]
    levels = codec.forward_levels(frames)
    assert any(highs[1].shape[-1] > lows[1].shape[-1]
               for lows, highs in levels)                  # a pad column
    for k, (_, highs) in enumerate(levels):
        for grp, bands in zip(dwt.GROUPS, highs):
            got = codec.group_bands(bands)
            want = _stack_pad({ch: per_channel[ch][k] for ch in grp}, grp)
            assert torch.equal(got, want)


@pytest.mark.parametrize("w,h", [(64, 48), (112, 48)])
def test_intra_forward_and_forward_packed_match_jax(w, h):
    """`IntraCodec.forward` and `forward_packed` on the CPU against the
    JAX `IntraCodec.forward`: the lowpass and band coefficients, and the
    packed bands against the port's entropy coder on the JAX bands in the
    stack/pad layout."""
    frames = _frames(w * h, 2, h, w)
    want = JaxIntraCodec(width=w, height=h, quality=4).forward(
        jnp.asarray(frames))
    codec = IntraCodec(w, h, 4, device=CPU)
    got = codec.forward(torch.from_numpy(frames))
    packed = codec.forward_packed(torch.from_numpy(frames))
    for ch in range(3):
        _eq(got[ch][0], want[ch][0])
        _eq(packed[ch][0], want[ch][0])
        for k in range(3):
            for b in range(3):
                _eq(got[ch][1][k][b], want[ch][1][k][b])
                _eq(packed[ch][1][k][3][b], want[ch][1][k][b])
    jax_bands = [[tuple(torch.from_numpy(np.array(b)) for b in bands)
                  for bands in want[ch][1]] for ch in range(3)]
    for k in range(3):
        for grp in dwt.GROUPS:
            words, nbits, ovf = edev.encode_band_arrays(
                _stack_pad({ch: jax_bands[ch][k] for ch in grp}, grp),
                codeset=17, cap_bits_per_elem=8)
            for gi, ch in enumerate(grp):
                for g, w_ in zip(packed[ch][1][k][:3],
                                 (words[:, gi], nbits[:, gi], ovf[:, gi])):
                    assert torch.equal(g, w_)
