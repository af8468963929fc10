"""Calibration parity (reference: tests/test_meterelf.py:119-144) plus
unit tests for the ellipse fit and border tracing."""
import os

import numpy as np
import pytest

from meterelf_jax import calibration

pytestmark = pytest.mark.needs_samples

EXPECTED_CENTER_DATA = [
    (37.4, 63.5, 14),
    (94.5, 86.3, 15),
    (135.6, 71.5, 13),
    (161.0, 36.5, 13),
]


def test_fit_ellipse_recovers_circle():
    t = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    pts = np.stack([10 + 4.0 * np.cos(t), 20 + 4.0 * np.sin(t)], axis=1)
    (cx, cy), (w, h) = calibration.fit_ellipse(pts)
    assert abs(cx - 10) < 1e-6 and abs(cy - 20) < 1e-6
    assert abs(w - 8.0) < 1e-6 and abs(h - 8.0) < 1e-6


def test_fit_ellipse_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for _ in range(6):
        m = np.zeros((48, 48), np.uint8)
        yy, xx = np.mgrid[:48, :48]
        cy, cx = rng.integers(16, 32, 2)
        a, b = rng.integers(5, 12, 2)
        m[((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0] = 255
        cs, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        (ecx, ecy), (ew, eh), _ = cv2.fitEllipse(cs[0])
        pts = cs[0][:, 0, :].astype(np.float64)
        (gcx, gcy), (gw, gh) = calibration.fit_ellipse(pts)
        assert abs(gcx - ecx) < 0.02 and abs(gcy - ecy) < 0.02
        assert abs(sorted([gw, gh])[0] - sorted([ew, eh])[0]) < 0.35
        assert abs((gw + gh) / 2 - (ew + eh) / 2) < 0.2


def test_boundary_trace_matches_cv2_points():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    m = np.zeros((40, 40), bool)
    yy, xx = np.mgrid[:40, :40]
    m[((yy - 20) / 7) ** 2 + ((xx - 18) / 9) ** 2 <= 1.0] = True
    m[12, 30] = True  # attach nothing; separate speck ignored below
    comp = m.copy()
    comp[12, 30] = False
    cs, _ = cv2.findContours(
        comp.astype(np.uint8) * 255, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    pts_cv = sorted(map(tuple, cs[0][:, 0, :].tolist()))
    pts_my = sorted(map(tuple, calibration._boundary_points(comp).astype(int).tolist()))
    assert pts_cv == pts_my


def test_find_dial_centers_full():
    """Full reference-parity calibration over all 79 good sample-images1
    frames (reference tests/test_meterelf.py:119-144): 4 centers within
    0.05 px, exact diameters, sorted by x. ~25 s — in the default
    suite."""
    from meterelf_jax.params import Params

    old = os.getcwd()
    os.chdir("/root/reference/sample-images1")
    try:
        params = Params.load("params.yml")
        files = calibration.get_image_filenames(params)
        assert len(files) == 79  # 81 minus the two excluded corrupt frames
        result = calibration.find_dial_centers(params, files)
    finally:
        os.chdir(old)
    assert len(result) == 4
    assert result == sorted(result, key=lambda c: c.center[0])
    for got, (ex, ey, ed) in zip(result, EXPECTED_CENTER_DATA):
        assert got.diameter == ed
        assert abs(got.center[0] - ex) < 0.05
        assert abs(got.center[1] - ey) < 0.05


def test_calibration_cli(capsys):
    """`python -m meterelf_jax.calibration` prints YAML-pasteable
    center/diameter fields for each dial (new-camera bring-up)."""
    from glob import glob

    from meterelf_jax import calibration

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:34]
    if not files:
        pytest.skip("sample corpus not mounted")
    calibration.main(
        ["/root/reference/sample-images1/params.yml", *files])
    out = capsys.readouterr().out
    assert out.count("center: [") == 4
    assert out.count("diameter: ") == 4
    # x-sorted, near the shipped params values (loose: 32-frame average)
    import re
    xs = [float(m.group(1))
          for m in re.finditer(r"center: \[([0-9.]+),", out)]
    assert xs == sorted(xs)
    assert abs(xs[0] - 37.3) < 2.0 and abs(xs[3] - 160.9) < 2.0


def test_calibration_cli_usage_error(capsys):
    from meterelf_jax import calibration

    with pytest.raises(SystemExit):
        calibration.main([])
    assert "usage" in capsys.readouterr().err
