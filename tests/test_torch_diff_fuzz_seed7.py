"""The port's decoder on seed 7's corrupt samples against the JAX API's
host route (`tests/test_torch_diff_fuzz.py` holds the harness and seed 0),
and the three cases of seed 7 where the port once disagreed with it."""

import pytest

from cineform_tpu_torch import api
from cineform_tpu_torch import diff_fuzz
from cineform_tpu_torch.models import intra_host
from test_torch_diff_fuzz import check_case, run_corpus, yuy2_sample


@pytest.fixture(autouse=True)
def _jax_host_route(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def test_corpus_seed7():
    counts = run_corpus(yuy2_sample(), 150, 7)
    assert sum(counts.values()) == 150 and counts["payload"] > 0


@pytest.mark.parametrize("case,cls,outcome", [
    # the JAX API rejects a broken band trailer that the device route
    # never read; the port decoded the sample
    (7, "header", "subband 1 band trailer"),
    # a band slot the sample lacks: the JAX API decodes it zero, the
    # port's host route raised KeyError: 2 (relabelled BADSAMPLE)
    (51, "header", None),
    # a payload bit flip that breaks subband 8's trailer
    (162, "payload", "subband 8 band trailer"),
])
def test_seed7_cases(case, cls, outcome):
    got_case, got_cls, mutated = diff_fuzz.corpus(yuy2_sample(), case + 1,
                                                  7)[case]
    assert (got_case, got_cls) == (case, cls)
    check_case(case, cls, mutated)
    dec = api.Decoder("cpu")
    dec.prepare_to_decode(0, 0, sample=mutated)
    if outcome is None:
        assert dec.decode_sample(mutated).shape == (120, 320)
        return
    with pytest.raises(api.CFHDError) as e:
        dec.decode_sample(mutated)
    assert e.value.code == api.ErrorCode.BADSAMPLE
    assert isinstance(e.value.__cause__, intra_host.BadSampleError)
    assert outcome in str(e.value)
