"""Golden-output parity — the backbone test strategy inherited from the
reference (tests/test_meterelf.py:39-96, tolerance 0.00 = byte-exact).

The DEFAULT suite proves all 304 images of both sample sets byte-exact
(~25 s on CPU), in both precision modes for sample set 1: exact=True
(full f64 statistics) and exact=False (f32 bulk data — the discrete
decisions are integer-exact in both, so the printed lines must still be
identical; this backs docs/parity.md's claim). A small subset test
remains as a fast smoke check for targeted runs.
"""
import io
import os
import contextlib
from glob import glob

import pytest

from meterelf_jax.cli import main

pytestmark = pytest.mark.needs_samples

SAMPLE1 = "/root/reference/sample-images1"
SAMPLE2 = "/root/reference/sample-images2"
GOLDEN1 = "/root/reference/integration-tests/test_all_sample_images.expected_stdout"
GOLDEN2 = "/root/reference/tests/sample-images2_stdout.txt"

SUBSET1 = [
    "20180814021309-01-e01.jpg",        # corrupt: match val = 0.0
    "20180814021310-00-e02.jpg",        # corrupt: match val = 17495704.0
    "20180814021357-00-e01.jpg",        # 905.126
    "20180814023853-00-e08.jpg",        # 932.800
    "20180814030000-e01-snapshot.jpg",  # snapshot frame, 932.831
    "20180814215230-01-e136.jpg",       # debug-test frame, 253.623
    "20180815012802-00-e150.jpg",       # 294.051
    "20180819195956-01-e700.jpg",       # 344.243
]


def golden_lines(path):
    with open(path) as fp:
        return dict(
            line.split(": ", 1) for line in fp.read().splitlines())


def run_cli(sample_dir, files):
    old = os.getcwd()
    os.chdir(sample_dir)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["meterelf", "params.yml"] + files)
        return buf.getvalue().splitlines()
    finally:
        os.chdir(old)


def test_golden_subset_sample1():
    golden = golden_lines(GOLDEN1)
    got = run_cli(SAMPLE1, SUBSET1)
    assert len(got) == len(SUBSET1)
    for line, fn in zip(got, SUBSET1):
        assert line == f"{fn}: {golden[fn]}"


@pytest.mark.parametrize("sample_dir,golden_file", [
    (SAMPLE1, GOLDEN1),
    (SAMPLE2, GOLDEN2),
])
def test_golden_full(sample_dir, golden_file):
    files = sorted(
        os.path.basename(p) for p in glob(os.path.join(sample_dir, "*.jpg")))
    got = run_cli(sample_dir, files)
    expected = open(golden_file).read().splitlines()
    assert got == expected


def test_golden_full_fast_mode(monkeypatch):
    """exact=False (METERELF_EXACT=0) must print byte-identical lines
    on the full sample-set-1 corpus through the real CLI path (f32 bulk
    statistics; discrete decisions are integer-exact by construction —
    see ops/angles.py). Backs docs/parity.md's both-modes claim."""
    monkeypatch.setenv("METERELF_EXACT", "0")
    files = sorted(
        os.path.basename(p) for p in glob(os.path.join(SAMPLE1, "*.jpg")))
    got = run_cli(SAMPLE1, files)
    expected = open(GOLDEN1).read().splitlines()
    assert got == expected
