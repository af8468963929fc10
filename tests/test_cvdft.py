"""ops/cvdft.py: the cv2-free bit-exact TM_CCOEFF replica.

Two layers of proof:
- oracle equality: bit-exact against cv2's plain (IPP-off) path on
  random inputs across the DFT stack and full matchTemplate (skipped
  when cv2 is absent);
- independence: with cv2 import BLOCKED, the product path still
  reproduces the two golden-pinned match-val strings (reference
  tests/test_meterelf.py:164-167).
"""
import builtins
import subprocess
import sys

import numpy as np
import pytest

from meterelf_jax.ops import cvdft

F = np.float32
SAMPLE1 = "/root/reference/sample-images1"


# ---------------------------------------------------------------------------
# oracle equality (development invariant; requires cv2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cv2_plain():
    cv2 = pytest.importorskip("cv2")
    prev = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield cv2
    cv2.ipp.setUseIPP(prev)


@pytest.mark.parametrize("n", [2, 4, 8, 32, 3, 9, 27, 5, 25, 125,
                               6, 15, 20, 45, 250])
def test_cdft_bit_exact(cv2_plain, n):
    cv2 = cv2_plain
    rng = np.random.default_rng(n)
    re = rng.uniform(-100, 100, (64, n)).astype(F)
    im = rng.uniform(-100, 100, (64, n)).astype(F)
    want = cv2.dft(np.stack([re, im], -1),
                   flags=cv2.DFT_COMPLEX_OUTPUT | cv2.DFT_ROWS)
    gre, gim = cvdft.cdft(re, im)
    assert np.array_equal(gre, want[..., 0])
    assert np.array_equal(gim, want[..., 1])
    want = cv2.dft(np.stack([re, im], -1),
                   flags=(cv2.DFT_COMPLEX_OUTPUT | cv2.DFT_ROWS
                          | cv2.DFT_INVERSE))
    gre, gim = cvdft.cdft(re, im, inv=True)
    assert np.array_equal(gre, want[..., 0])
    assert np.array_equal(gim, want[..., 1])


@pytest.mark.parametrize("n", [4, 8, 10, 50, 250, 5, 15, 135])
def test_rdft_and_inverse_bit_exact(cv2_plain, n):
    cv2 = cv2_plain
    rng = np.random.default_rng(n)
    x = rng.uniform(-100, 100, (64, n)).astype(F)
    want = cv2.dft(x, flags=cv2.DFT_ROWS)
    assert np.array_equal(cvdft.rdft_rows(x), want)
    ccs = rng.uniform(-100, 100, (64, n)).astype(F)
    want = cv2.dft(ccs, flags=(cv2.DFT_INVERSE | cv2.DFT_ROWS
                               | cv2.DFT_REAL_OUTPUT | cv2.DFT_SCALE))
    got = cvdft.ccsidft_rows(ccs, scale=1.0 / n)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hw", [(4, 6), (8, 10), (16, 50), (250, 250),
                                (9, 10), (8, 15), (9, 15), (125, 54)])
def test_2d_stack_bit_exact(cv2_plain, hw):
    cv2 = cv2_plain
    h, w = hw
    rng = np.random.default_rng(h * 1000 + w)
    a = rng.uniform(-100, 100, (h, w)).astype(F)
    assert np.array_equal(cvdft.rdft2(a), cv2.dft(a))
    ccs = rng.uniform(-100, 100, (h, w)).astype(F)
    want = cv2.dft(ccs, flags=(cv2.DFT_INVERSE | cv2.DFT_SCALE
                               | cv2.DFT_REAL_OUTPUT))
    assert np.array_equal(cvdft.ccsidft2(ccs), want)
    b = rng.uniform(-100, 100, (h, w)).astype(F)
    want = cv2.mulSpectrums(a, b, 0, conjB=True)
    assert np.array_equal(cvdft.mul_spectrums_conj(a, b), want)


def test_optimal_dft_size(cv2_plain):
    cv2 = cv2_plain
    for n in list(range(1, 600)) + [1021, 4099]:
        assert cvdft.get_optimal_dft_size(n) == cv2.getOptimalDFTSize(n)


@pytest.mark.parametrize("case", [
    (250, 250, 119, 188),   # the shipped camera geometry (one block)
    (200, 210, 90, 141),    # ALT_CAMERA-ish geometry
    (480, 640, 119, 188),   # full frame: multi-block path
    (100, 100, 7, 9),       # small template (minBlockSize clamp)
])
def test_match_template_bit_exact(cv2_plain, case):
    cv2 = cv2_plain
    ih, iw, th, tw = case
    rng = np.random.default_rng(sum(case))
    img = rng.integers(0, 256, (ih, iw), np.uint8)
    tpl = rng.integers(0, 256, (th, tw), np.uint8)
    want = cv2.matchTemplate(img, tpl, cv2.TM_CCOEFF)
    got = cvdft.match_template_ccoeff(img, tpl)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# independence: the golden strings come out with cv2 UNIMPORTABLE
# ---------------------------------------------------------------------------

@pytest.fixture
def block_cv2(monkeypatch):
    """Make `import cv2` raise ImportError for the duration."""
    monkeypatch.delitem(sys.modules, "cv2", raising=False)
    real_import = builtins.__import__

    def guard(name, *a, **k):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("cv2 blocked by test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guard)


@pytest.mark.needs_samples
def test_golden_match_vals_without_cv2(block_cv2, params1):
    """The two pinned strings (reference tests/test_meterelf.py:164-167)
    from our own DFT replica, cv2 blocked."""
    from meterelf_jax.api import _parity_match_val

    assert str(_parity_match_val(
        f"{SAMPLE1}/20180814021309-01-e01.jpg", params1)) == "0.0"
    assert str(_parity_match_val(
        f"{SAMPLE1}/20180814021310-00-e02.jpg", params1)) == "17495704.0"


@pytest.mark.needs_samples
def test_cli_error_frames_without_cv2(params1):
    """Full CLI on the two corrupt frames in a subprocess whose cv2
    import is poisoned: byte-exact golden error lines, proving the
    product path needs no OpenCV."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None  # poisons any import attempt\n"
        "from meterelf_jax.cli import main\n"
        "main(['meterelf-jax', %r,\n"
        "      %r,\n"
        "      %r])\n"
        % (f"{SAMPLE1}/params.yml",
           f"{SAMPLE1}/20180814021309-01-e01.jpg",
           f"{SAMPLE1}/20180814021310-00-e02.jpg")
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True)
    lines = out.stdout.splitlines()
    assert lines == [
        f"{SAMPLE1}/20180814021309-01-e01.jpg: UNKNOWN "
        "Dials not found (match val = 0.0)",
        f"{SAMPLE1}/20180814021310-00-e02.jpg: UNKNOWN "
        "Dials not found (match val = 17495704.0)",
    ]


def test_no_static_cv2_imports_in_package():
    """No module under meterelf_jax/ may import cv2 (runtime
    independence is a product guarantee, not an accident)."""
    import pathlib

    import meterelf_jax

    pkg = pathlib.Path(meterelf_jax.__file__).parent
    offenders = []
    for py in pkg.rglob("*.py"):
        text = py.read_text()
        if "import cv2" in text:
            offenders.append(str(py))
    assert not offenders, offenders
