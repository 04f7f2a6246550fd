"""The port's keyframed develop parameters (`models.active_metadata.
parse_control_points`, `develop_params_at`) against the JAX package's on
the CP3D/CPPR items of `tests/test_active_metadata.py`'s keyframe test,
and on a set that adds GAMT keyframes and a TIMC trigger between them.
"""

import dataclasses

import numpy as np
import pytest

from cineform_tpu import metadata as jmd
from cineform_tpu.models import active_metadata as jam
from cineform_tpu.models.intra_host import encode_sample
from cineform_tpu.utils.testframes import yuy2_frame
from cineform_tpu_torch import metadata as tmd
from cineform_tpu_torch.models import active_metadata as tam

FLAGS = jam.PROCESSING_ACTIVE | jam.PROCESSING_WHITEBALANCE


def _inner(wb=None, gamma=None) -> bytes:
    inner = jmd.Metadata()
    if wb is not None:
        inner.add("WBAL", np.asarray(wb, "<f4").tobytes(), typ=b"f")
    if gamma is not None:
        inner.add("GAMT", np.asarray([gamma], "<f4").tobytes(), typ=b"f")
    return inner.block()


def _ufrm(frame: int, **values) -> bytes:
    return (b"CP3D" + (0).to_bytes(4, "little") + b"UFRM"
            + (4).to_bytes(3, "little") + b"L"
            + frame.to_bytes(4, "little") + _inner(**values))


def _timc(tc: bytes, **values) -> bytes:
    return (b"CPPR" + (0).to_bytes(4, "little") + b"TIMC"
            + len(tc).to_bytes(3, "little") + b"c" + tc + _inner(**values))


#: name -> (PRCS flags, [(tag, control point payload)])
SETS = {
    # tests/test_active_metadata.py::test_keyframed_control_points
    "wbal": (FLAGS, [("CP3D", _ufrm(0, wb=(1.0, 1.0, 1.0))),
                     ("CP3D", _ufrm(10, wb=(2.0, 1.0, 0.5)))]),
    "timc": (FLAGS, [("CPPR", _timc(b"00:00:01:00\0", wb=(3.0, 1.0, 1.0)))]),
    "wbal_gamt": (FLAGS | jam.PROCESSING_GAMMA_TWEAKS, [
        ("CP3D", _ufrm(10, wb=(2.0, 1.0, 0.5), gamma=2.0)),
        ("CPPR", _timc(b"00:00:00:05\0", gamma=0.5)),
        ("CP3D", _ufrm(0, wb=(1.0, 1.0, 1.0), gamma=1.0)),
        ("CPPR", _timc(b"bad\0", gamma=3.0))]),
    "gated_off": (jam.PROCESSING_ACTIVE, [
        ("CP3D", _ufrm(0, wb=(1.0, 1.0, 1.0), gamma=1.0)),
        ("CP3D", _ufrm(10, wb=(2.0, 1.0, 0.5), gamma=2.0))]),
}


def _items(name):
    flags, points = SETS[name]
    meta = jmd.Metadata()
    meta.add("PRCS", flags.to_bytes(4, "little"), typ=b"L")
    for tag, payload in points:
        meta.add(tag, payload, typ=b"c")
    block = meta.block()
    return jmd.Metadata.parse_block(block), tmd.parse_block(block)


def _plain(items):
    return [(i.tag, i.typ, i.payload) for i in items]


def _params(p):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(p).items()}


@pytest.mark.parametrize("name", sorted(SETS))
def test_control_points_match(name):
    jitems, titems = _items(name)
    want = jam.parse_control_points(jitems)
    got = tam.parse_control_points(titems)
    assert [(f, _plain(inner)) for f, inner in got] == \
        [(f, _plain(inner)) for f, inner in want]
    assert got


@pytest.mark.parametrize("frame", [0, 3, 5, 10, 24, 30])
@pytest.mark.parametrize("name", sorted(SETS))
def test_develop_params_at_match(name, frame):
    sample = encode_sample(yuy2_frame(64, 48, 1), 64, 48, 4)
    jitems, titems = _items(name)
    want = jam.develop_params_at(sample, frame, database=jitems)
    got = tam.develop_params_at(sample, frame, database=titems)
    assert _params(got) == _params(want)
    if name == "wbal" and frame == 5:
        assert abs(got.wb[0] - 1.5) < 1e-6 and abs(got.wb[2] - 0.75) < 1e-6


def test_no_control_points_is_develop_params():
    sample = encode_sample(yuy2_frame(64, 48, 1), 64, 48, 4)
    assert _params(tam.develop_params_at(sample, 3)) == \
        _params(tam.develop_params(sample)) == \
        _params(jam.develop_params_at(sample, 3))
