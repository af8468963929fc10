"""Params loading / validation / derived-array tests
(reference schema: meterelf/_params.py)."""
import numpy as np
import pytest

from meterelf_jax.params import (
    DIAL_WIN, LoadError, Params, angle_by_vector, make_dial_masks,
)

pytestmark = pytest.mark.needs_samples


def test_load_sample1(params1):
    assert params1.meter_rect.top_left == (50, 160)
    assert params1.meter_rect.bottom_right == (300, 410)
    assert params1.dials_match_threshold == 20000000
    assert params1.dials_template_size == (119, 188)  # (h, w) after swap
    assert params1.hue_shift == 128
    assert params1.dial_names == ["0.0001", "0.001", "0.01", "0.1"]
    assert params1.negative_momentum_dials == {"0.001"}
    assert params1.needle_angles_of_zero["0.1"] == -4.5


def test_load_missing_file(tmp_path):
    with pytest.raises(LoadError, match="Cannot load YAML data"):
        Params.load(str(tmp_path / "nope.yml"))


def test_load_not_a_dict(tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text("- just\n- a list\n")
    with pytest.raises(LoadError, match="Not a valid parameters file"):
        Params.load(str(p))


def test_arrays_shapes(params1):
    pa = params1.arrays()
    D = 4
    assert pa.template_zm.shape == (119, 188)
    assert abs(float(pa.template_zm.sum())) < 0.1  # zero-mean (f32 storage)
    assert pa.mask_full.shape == (D, DIAL_WIN, DIAL_WIN)
    assert pa.color_range.shape == (D, 3)
    # annulus is a subset of the full disk
    assert not (pa.mask_circle & ~pa.mask_full).any()
    # name-sorted permutation: names already sorted for these configs
    assert list(pa.value_perm) == [0, 1, 2, 3]


def test_masks_match_cv2(params1):
    cv2 = pytest.importorskip("cv2")
    for name in params1.dial_names:
        dc = params1.dial_centers[name]
        full_mine, circ_mine = make_dial_masks(
            dc.center, dc.diameter,
            params1.needle_dists_from_dial_center[name],
            params1.needle_circle_mask_thickness[name], (119, 188))
        mask = np.zeros((119, 188), np.uint8)
        radius = int(round(dc.diameter / 2.0))
        c = (int(round(dc.center[0])), int(round(dc.center[1])))
        r0 = radius + params1.needle_dists_from_dial_center[name]
        for i in (0, params1.needle_circle_mask_thickness[name] - 1):
            cv2.circle(mask, c, r0 + i, 255)
        fill = np.zeros((121, 190), np.uint8)
        cv2.floodFill(mask, fill, (c[0] + r0 + 1, c[1]), 255)
        circle_cv = mask.copy()
        cv2.floodFill(mask, fill, c, 255)
        assert np.array_equal(mask, full_mine), name
        assert np.array_equal(circle_cv, circ_mine), name


def test_angle_by_vector_doctest_cases():
    # the reference's doctest (meterelf/_utils.py:32-36)
    cases = {
        (0, -1): 0.0, (1, -1): 0.125, (1, 0): 0.25, (1, 1): 0.375,
        (0, 1): 0.5, (-1, 1): 0.625, (-1, 0): 0.75, (-1, -1): 0.875,
    }
    for (x, y), expected in cases.items():
        assert angle_by_vector(x, y) == expected
    assert angle_by_vector(0, 0) is None


def test_static_geometry_is_reference_rounded(params1):
    pa = params1.arrays()
    # angles precomputed for annulus slots must match a direct host calc
    d = 0
    valid = pa.ann_valid[d]
    for j in np.nonzero(valid)[0][:16]:
        x, y = pa.ann_x[d, j], pa.ann_y[d, j]
        assert pa.ann_angle[d, j] == angle_by_vector(x, y)
        assert pa.ann_sqd[d, j] == x ** 2 + y ** 2
