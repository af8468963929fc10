"""Shared adversarial-frame generator for the fuzz suites.

Used by tests/test_oracle_fuzz.py (CPU: the decode graph vs the shimmed
reference executed as an oracle) and chip_smoke.py (the graph on the GPU
vs the same graph on the CPU). Keeping ONE generator guarantees the
on-chip check covers the same input space the reference-oracle run
validated.
"""
import numpy as np


def assert_results_equal(a, b, label):
    """Bit-identical decode semantics: error codes, locations, per-dial
    positions, readability, values. match_val may differ in f32 rounding
    between score formulations (documented); its THRESHOLD DECISION is
    part of err and argmax is pinned via match_x/match_y.

    Shared by chip_smoke.py's GPU-vs-CPU phase and the tests."""
    from meterelf_jax.errors import ErrCode

    np.testing.assert_array_equal(a.err, b.err, err_msg=f"{label}: err")
    np.testing.assert_array_equal(a.match_x, b.match_x,
                                  err_msg=f"{label}: match_x")
    np.testing.assert_array_equal(a.match_y, b.match_y,
                                  err_msg=f"{label}: match_y")
    np.testing.assert_array_equal(a.readable, b.readable,
                                  err_msg=f"{label}: readable")
    # positions: bitwise where the dial read (unreadable slots carry
    # an unconsumed placeholder)
    rd = a.readable
    np.testing.assert_array_equal(
        np.where(rd, a.dial_pos, 0), np.where(rd, b.dial_pos, 0),
        err_msg=f"{label}: dial_pos")
    okrow = a.err == int(ErrCode.OK)
    np.testing.assert_array_equal(
        np.where(okrow, a.value, 0), np.where(okrow, b.value, 0),
        err_msg=f"{label}: value")
    nc = a.err == int(ErrCode.NEEDLE_CONTOURS)
    np.testing.assert_array_equal(
        np.where(nc, a.first_bad_dial, 0),
        np.where(nc, b.first_bad_dial, 0),
        err_msg=f"{label}: first_bad_dial")
    da = a.err == int(ErrCode.DIAL_ANGLE)
    np.testing.assert_array_equal(
        np.where(da, a.unreadable_bits, 0),
        np.where(da, b.unreadable_bits, 0),
        err_msg=f"{label}: unreadable_bits")
    assert np.allclose(a.match_val, b.match_val, rtol=1e-4), (
        f"{label}: match_val drifted beyond f32 formulation noise")


def fuzz_frames(camera, n, seed):
    """Adversarial frame mix: random angles, carry-correction
    boundaries, stub needles, sparse/dense speckle, and speckle
    clusters painted near the dials (near-threshold contour areas,
    largest-component ties, hole closures)."""
    rng = np.random.default_rng(seed)
    (x0, y0), (x1, y1) = camera.meter_rect
    max_ox = (x1 - x0) - camera.template_w - 1
    max_oy = (y1 - y0) - camera.template_h - 1
    frames = []
    for i in range(n):
        pos = [float(p) for p in rng.uniform(0, 10, 4)]
        if i % 5 == 1:
            # carry-correction boundary: fractions near .45/.55 with
            # next-lower digit near the 2/8 thresholds
            pos = [rng.uniform(0, 10),
                   float(int(rng.uniform(0, 10)) + rng.choice([0.44, 0.56])),
                   rng.choice([1.9, 2.1, 7.9, 8.1]),
                   rng.uniform(0, 10)]
            pos = [float(p) for p in pos]
        stub = (2,) if i % 7 == 3 else ()
        off = (int(rng.integers(5, max_ox)), int(rng.integers(5, max_oy)))
        f = camera.render_frame(pos, offset=off, stub_dials=stub)
        if i % 4 == 2:
            # sparse speckle noise (stresses CCL + largest-component)
            m = rng.random(f.shape[:2]) < 0.001
            f[m] = (40, 40, 200)
        if i % 6 == 5:
            # denser speckle: clustered blobs, merged components, holes
            m = rng.random(f.shape[:2]) < 0.004
            f[m] = (40, 40, 200)
        if i % 9 == 4:
            # needle-colored blobs near the dial centers: near-threshold
            # contour areas and largest-selection ties
            ox = x0 + off[0]
            oy = y0 + off[1]
            for _ in range(rng.integers(2, 7)):
                name, (cx, cy), diam = camera.dial_specs[
                    rng.integers(0, len(camera.dial_specs))]
                bx = ox + int(cx) + int(rng.integers(-diam - 9, diam + 9))
                by = oy + int(cy) + int(rng.integers(-diam - 9, diam + 9))
                r = int(rng.integers(1, 4))
                f[max(by - r, 0):by + r + 1, max(bx - r, 0):bx + r + 1] = (
                    40, 40, 200)
        frames.append(f)
    return frames
