"""The port's decoder on corrupt samples against the JAX API's host route.

`tools/diff_fuzz.py`'s corpus (its seeds and sizes from
`tests/test_diff_fuzz.py`) through `cineform_tpu_torch.diff_fuzz`:
every mutated sample is decoded by the port's `api.Decoder` on the CPU and
by the JAX API's host route (`CINEFORM_API_DEVICE=0`, the byte-exact
oracle that the JAX package holds against the reference binary), and the
outcomes must agree in every class: both reject, or both give the same
bytes.  A rejection of the port names as its cause nothing, or the JAX
host decoder's own error for the same case (a BadSampleError, a parse
error); never a KeyError, IndexError or RuntimeError.

Seed 7's cases are in `tests/test_torch_diff_fuzz_seed7.py`, the RG48
and BYR4 goldens' corpora and the targeted rules in
`tests/test_torch_diff_fuzz_rules.py`.
"""

import os

import numpy as np
import pytest

from cineform_tpu import api as japi
from cineform_tpu.models import intra_host as jhost
from cineform_tpu_torch import api
from cineform_tpu_torch import diff_fuzz
from cineform_tpu_torch.models import intra_host
from cineform_tpu_torch.testframes import yuy2_frame

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "samples")


@pytest.fixture(autouse=True)
def _jax_host_route(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def yuy2_sample():
    """The corpus sample of `tools/diff_fuzz.py`: 160x120 YUY2 at q4."""
    return jhost.encode_sample(yuy2_frame(160, 120, 1), 160, 120, 4)


def _outcome(mod, dec, sample, output):
    """(bytes or None, the CFHDError or None) of one decode."""
    fmt = mod.PixelFormat.YUY2 if output is None else mod.PixelFormat[output]
    try:
        dec.prepare_to_decode(0, 0, fmt, sample=sample)
        out = dec.decode_sample(sample)
    except mod.CFHDError as exc:
        return None, exc
    return (None if out is None else np.ascontiguousarray(out).tobytes(),
            None)


def check_case(case, cls, mutated, output=None):
    """Hold one case's port outcome against the JAX API's."""
    want, jerr = _outcome(japi, japi.Decoder(), mutated, output)
    got, err = _outcome(api, api.Decoder("cpu"), mutated, output)
    assert (got is None) == (want is None), (case, cls, jerr, err)
    assert got == want, (case, cls, "bytes differ")
    if err is not None:
        cause = err.__cause__
        assert not isinstance(cause, (KeyError, IndexError, RuntimeError))
        if cause is not None and not isinstance(
                cause, intra_host.BadSampleError):
            # a parse error: the JAX decoder's, for the same case
            assert str(err) == str(jerr), (case, cls)


def run_corpus(sample, cases, seed, output=None):
    counts = {}
    for case, cls, mutated in diff_fuzz.corpus(sample, cases, seed):
        check_case(case, cls, mutated, output)
        counts[cls] = counts.get(cls, 0) + 1
    return counts


def test_corpus_seed0():
    counts = run_corpus(yuy2_sample(), 200, 0)
    assert sum(counts.values()) == 200 and counts["header"] > 0


#: the SHA-256 of the corpus sample, which `chip_smoke.py` encodes on the
#: card to draw the same cases
CORPUS_SHA256 = ("0c32dd698e8d9df2af21fbd8355c561f"
                 "e9d42bec85961aa3971f2aebd685a222")


def test_corpus_sample_is_the_ports_encode():
    import hashlib

    from cineform_tpu_torch.models.intra import IntraCodec

    frame = np.frombuffer(yuy2_frame(160, 120, 1), np.uint8).reshape(
        1, 120, 320)
    sample = IntraCodec(160, 120, 4, device="cpu").encode_batch_device(
        frame)[0]
    assert sample == yuy2_sample()
    assert hashlib.sha256(sample).hexdigest() == CORPUS_SHA256


def test_chip_smoke_draws_the_same_corpus():
    """`chip_smoke.py`'s phase 15 checks its 160x120 sample by this hash,
    and `cfhd_tool fuzz`'s line by the JAX tool's counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(GOLDEN), "..", "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CORPUS_SHA256 == CORPUS_SHA256
    assert smoke.FUZZ_LINE == "fuzz: 44 decoded, 6 rejected cleanly, 0 crashes"
