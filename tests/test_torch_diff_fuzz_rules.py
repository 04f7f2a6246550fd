"""The port's decoder against the JAX API's host route on the RG48 and
BYR4 goldens' corpora (40 cases each, seed 3, as decoded to RG48 and
BYR4), and on one tag value changed for each rule of the decoder
(`diff_fuzz.targeted`) in 4:2:2, RGB, RGBA and Bayer samples
(`tests/test_torch_diff_fuzz.py` holds the harness)."""

import os

import pytest

from cineform_tpu_torch import diff_fuzz
from test_torch_diff_fuzz import GOLDEN, check_case, run_corpus, yuy2_sample


@pytest.fixture(autouse=True)
def _jax_host_route(monkeypatch):
    monkeypatch.setenv("CINEFORM_API_DEVICE", "0")


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,output", [
    ("rg48_320x240_q4_p1.cfhd", "RG48"),
    ("byr4_320x240_q4_p1.cfhd", "BYR4"),
])
def test_corpus_goldens(name, output):
    sample = _golden(name)
    counts = run_corpus(sample, 40, 3, output)
    assert sum(counts.values()) == 40


TARGETS = {"yuy2": (yuy2_sample, None),
           "rg48": (lambda: _golden("rg48_320x240_q4_p1.cfhd"), "RG48"),
           "b64a": (lambda: _golden("rgba4444_320x240_q4.cfhd"), "B64A"),
           "byr4": (lambda: _golden("byr4_320x240_q4_p1.cfhd"), "BYR4")}
RULES = [rule for rule, _ in diff_fuzz.targeted(yuy2_sample())]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", list(TARGETS))
def test_targeted_rules(kind, rule):
    """One tag value changed for each rule of the decoder: the port's
    outcome is the JAX API's."""
    make, output = TARGETS[kind]
    mutated = dict(diff_fuzz.targeted(make()))[rule]
    check_case(rule, "header", mutated, output)
