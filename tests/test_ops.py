"""Kernel-level parity tests vs OpenCV semantics and independent numpy /
scipy oracles (the unit coverage the reference lacks; SURVEY.md §4)."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from meterelf_jax.ops import color as color_ops
from meterelf_jax.ops import components as comp_ops
from meterelf_jax.ops import morphology as morph_ops
from meterelf_jax.ops import template as template_ops


def test_hls_matches_host_reference():
    """jnp conversion == the float-path formula (validated byte-exact
    against the goldens end-to-end)."""
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (64, 64, 3), np.uint8)
    out = np.asarray(color_ops.bgr_to_hls_full(jnp.asarray(bgr), 128))

    from meterelf_jax.api import _host_hls

    expected = _host_hls(bgr, 128)
    assert np.array_equal(out, expected.astype(np.int32))


def test_hls_close_to_cv2():
    """Sanity: within +-1 LSB of modern cv2 (old-cv2 float path differs
    from modern cv2 by design)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (64, 64, 3), np.uint8)
    ours = np.asarray(color_ops.bgr_to_hls_full(jnp.asarray(bgr), 0))
    cvs = cv2.cvtColor(bgr, cv2.COLOR_BGR2HLS_FULL).astype(np.int32)
    assert np.abs(ours - cvs).max() <= 1


def test_morphology_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    m = (rng.random((40, 52)) < 0.35)
    k = np.ones((3, 3), np.uint8)
    d_cv = cv2.dilate(m.astype(np.uint8) * 255, k) > 0
    e_cv = cv2.erode(m.astype(np.uint8) * 255, k) > 0
    assert np.array_equal(np.asarray(morph_ops.dilate3(jnp.asarray(m))), d_cv)
    assert np.array_equal(np.asarray(morph_ops.erode3(jnp.asarray(m))), e_cv)


def test_template_locate_first_max_tiebreak():
    scores = jnp.zeros((1, 5, 7)).at[0, 2, 3].set(9.0).at[0, 4, 1].set(9.0)
    mv, x, y = template_ops.locate(scores)
    assert float(mv[0]) == 9.0
    assert (int(x[0]), int(y[0])) == (3, 2)  # first in row-major order


def test_matmul_scorer_matches_conv_scorer():
    rng = np.random.default_rng(3)
    L = rng.integers(0, 256, (2, 150, 160)).astype(np.float32)
    T = rng.integers(0, 256, (40, 60)).astype(np.uint8)
    tz = (T.astype(np.float64) - T.astype(np.float64).mean()).astype(np.float32)
    s_conv = np.asarray(template_ops.match_template_scores(
        jnp.asarray(L), jnp.asarray(tz)))
    s_mm = np.asarray(template_ops.match_template_scores_matmul(
        jnp.asarray(L), jnp.asarray(T), float(T.mean())))
    assert s_conv.shape == s_mm.shape == (2, 111, 101)
    rel = np.abs(s_conv - s_mm).max() / max(1.0, np.abs(s_conv).max())
    assert rel < 1e-4
    assert (s_conv.reshape(2, -1).argmax(1) == s_mm.reshape(2, -1).argmax(1)).all()


def _cv2_needle_region(masked, closed):
    """Reference semantics via cv2 (the oracle)."""
    import cv2

    contours, _ = cv2.findContours(
        masked.astype(np.uint8) * 255, cv2.RETR_EXTERNAL,
        cv2.CHAIN_APPROX_NONE)
    if not contours:
        return None
    contour = sorted(contours, key=cv2.contourArea)[-1]
    if cv2.contourArea(contour) > 100:
        out = np.zeros_like(masked, np.uint8)
        cv2.drawContours(out, [contour], -1, 255, -1)
        return out > 0
    return closed


@pytest.mark.parametrize("seed", range(8))
def test_components_match_cv2_on_random_blobs(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    W = 64
    # synthesize blobby masks: a few filled ellipses + speckle, inside a disk
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    closed = np.zeros((W, W), bool)
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.integers(16, 48, 2)
        a, b = rng.integers(3, 14, 2)
        closed |= ((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0
    closed |= rng.random((W, W)) < 0.02
    masked = closed & disk

    expected = _cv2_needle_region(masked, closed)
    res = comp_ops.analyze(
        jnp.asarray(masked), jnp.asarray(closed), jnp.asarray(disk))
    assert bool(res.has_any) == bool(masked.any())
    if expected is None:
        return
    got = np.asarray(res.needle_region)
    assert np.array_equal(got, expected), f"seed {seed}"


def _random_disk_masks(rng, K, W, density, blobs=True):
    yy, xx = np.mgrid[:W, :W]
    c = W // 2
    disk = (yy - c) ** 2 + (xx - c) ** 2 <= (W * 23 // 64) ** 2
    closed = rng.random((K, W, W)) < density
    if blobs:
        for k in range(K // 2):  # half the windows get a real blob
            cy, cx = rng.integers(W // 4, 3 * W // 4, 2)
            closed[k] |= ((yy - cy) ** 2 + (xx - cx) ** 2) <= (W // 8) ** 2
    return closed & disk, closed, np.broadcast_to(disk, (K, W, W)).copy()


@pytest.mark.parametrize("density", [0.1, 0.3, 0.5])
def test_propagation_matches_scipy_label(density):
    """The XLA label propagation (components._propagate_xla) against
    scipy.ndimage: each masked pixel's owner is the min flat index of
    its 8-connected component, the support is the mask plus the
    background not 4-connected to the outside of the disk, and the
    boundary bit marks masked pixels 8-adjacent to that outside — on
    dense noise too, under the rescue caps that guarantee a fixpoint."""
    from scipy import ndimage

    rng = np.random.default_rng(int(density * 100))
    K, W = 12, 64
    masked, _closed, disk = _random_disk_masks(rng, K, W, density)
    okey, conv = jax.jit(
        comp_ops._propagate_xla, static_argnames=("caps",))(
            jnp.asarray(masked), jnp.asarray(disk),
            caps=comp_ops.RESCUE_CAPS)
    okey, conv = np.asarray(okey), np.asarray(conv)
    assert conv.all()
    N = W * W
    flat = np.arange(N).reshape(W, W)
    for k in range(K):
        owner = okey[k] >> 2
        lab8, n = ndimage.label(masked[k], structure=np.ones((3, 3)))
        want = np.full((W, W), -1)
        for c in range(1, n + 1):
            want[lab8 == c] = flat[lab8 == c].min()
        np.testing.assert_array_equal(owner[masked[k]], want[masked[k]])
        bg = ~masked[k]
        lab4, _ = ndimage.label(bg)
        outside = bg & np.isin(lab4, np.unique(lab4[bg & ~disk[k]]))
        np.testing.assert_array_equal(owner < N, masked[k] | (bg & ~outside))
        touch = ndimage.binary_dilation(outside, structure=np.ones((3, 3)))
        np.testing.assert_array_equal((okey[k] & 1) != 0, masked[k] & touch)


def _stats_oracle(ol, pb, pc, sent):
    """Largest-component selection by a plain per-label groupby."""
    out = []
    for k in range(ol.shape[0]):
        best = None
        for o in np.unique(ol[k][ol[k] < sent]):
            sel = ol[k] == o
            bc, a2 = int(pb[k][sel].sum()), int(pc[k][sel].sum())
            if bc > 0 and (best is None or (a2, o) > best[:2]):
                best = (a2, int(o))
        out.append(best)
    return out


@pytest.mark.parametrize("density", [0.08, 0.3])
def test_sort_stats_match_numpy(density):
    """components._stats_sort (one narrow sort + prefix scans) selects
    the same component, with the same doubled area, as a per-label numpy
    groupby — on the u16-key path (48x48 stats box) and the i32 path
    (full 64x64 window), including windows with no candidate."""
    rng = np.random.default_rng(int(density * 1000))
    K = 18
    for W in (48, 64):
        masked, _closed, disk = _random_disk_masks(rng, K, W, density)
        masked[-1] = False                      # no candidate at all
        okey, _ = comp_ops._propagate_xla(jnp.asarray(masked),
                                          jnp.asarray(disk))
        N = W * W
        owner = okey >> 2
        contrib = comp_ops._cell_contrib(owner, N)
        ol, pb, pc = (np.asarray(a).reshape(K, N)
                      for a in (owner, okey & 1, contrib))
        sel, area2, valid = (np.asarray(a) for a in jax.jit(
            comp_ops._stats_sort, static_argnums=3)(ol, pb, pc, N))
        for k, best in enumerate(_stats_oracle(ol, pb, pc, N)):
            assert bool(valid[k]) == (best is not None), (W, k)
            if best is not None:
                assert (int(area2[k]), int(sel[k])) == best, (W, k)


@pytest.mark.parametrize("camera_name", ["default", "alt"])
def test_matmul_scorer_matches_numpy_correlation(camera_name):
    """match_template_scores_matmul against a float64 numpy TM_CCOEFF on
    both synthetic camera geometries: same first-max location, scores
    within 5e-5 of the peak. The u8 products are exact; the f32
    accumulation of ~1e9-scale correlation sums, minus the mean times
    the box sum, leaves a few ulps of 1e9 (1.2e-5 of the peak
    measured)."""
    from meterelf_jax import synthetic
    from meterelf_jax.api import _host_hls

    camera = getattr(synthetic, f"{camera_name.upper()}_CAMERA")
    crops = camera.render_crops([[1.0, 3.5, 7.2, 9.9], [6.1, 0.4, 2.8, 5.5]])
    L = _host_hls(crops, 0)[..., 1].astype(np.float64)
    np.testing.assert_array_equal(
        np.asarray(color_ops.lightness_channel(jnp.asarray(crops))), L)
    T = camera.make_template()
    th, tw = T.shape
    tmean = np.float32(np.float32(T.astype(np.int64).sum())
                       / np.float32(T.size))
    got = np.asarray(template_ops.match_template_scores_matmul(
        jnp.asarray(L, jnp.float32), jnp.asarray(T), tmean))
    view = np.lib.stride_tricks.sliding_window_view(L, (th, tw), (1, 2))
    want = np.einsum("byxij,ij->byx", view, T.astype(np.float64)
                     - np.float64(tmean))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.reshape(2, -1).argmax(1),
                                  want.reshape(2, -1).argmax(1))


def test_block_backhalf_unaligned_window_matches_pixel_decode():
    """The block-layout back-half on a window with an odd crop origin
    (oy=13), a plane width that is no multiple of 128 and an odd-sized
    frame reproduces the native pixel decode byte for byte."""
    import io as _io

    from PIL import Image

    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.ops import jpegdec
    from meterelf_jax.types import Rect

    rng = np.random.default_rng(20260820)
    w, h = 127, 95
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0)
    img = np.clip(base[..., None] + rng.integers(-60, 60, (h, w, 3)),
                  0, 255).astype(np.uint8)
    buf = _io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "JPEG", quality=90, subsampling=2)
    data = buf.getvalue()
    rect = Rect((9, 13), (9 + 61, 13 + 59))
    win = jpegdec.coef_window(rect, w, h)
    assert win.oy % 8 != 0 and (8 * win.lbw) % 128 != 0
    cy, cb, cr, qt, ok = jio.read_coefs_batch([data], win, (w, h))
    assert ok[0]
    got = np.asarray(jax.jit(
        lambda a, b, c, q: jpegdec.backhalf_to_packed(a, b, c, q, win))(
            cy, cb, cr, qt))
    want, ok_px = jio.load_packed_crops_from_bytes(
        [data], rect)
    assert ok_px[0]
    np.testing.assert_array_equal(got, want)

@pytest.mark.parametrize("seed", range(4))
def test_stats_hist_matches_sort(seed):
    """The MXU-histogram largest-component selection must be
    bit-identical to the u16-sort path (including empty windows and
    area ties)."""
    rng = np.random.default_rng(seed)
    W = 64
    K = 12
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    closed = np.zeros((K, W, W), bool)
    for k in range(K):
        for _ in range(rng.integers(0, 4)):
            cy, cx = rng.integers(12, 52, 2)
            a, b = rng.integers(2, 14, 2)
            closed[k] |= ((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1.0
        closed[k] |= rng.random((W, W)) < rng.choice([0.0, 0.02, 0.3])
    masked = closed & disk
    diskb = np.broadcast_to(disk, (K, W, W)).copy()

    run = jax.jit(comp_ops.analyze_batch, static_argnames=("stats",))
    r_s = run(jnp.asarray(masked), jnp.asarray(closed), jnp.asarray(diskb),
              stats="sort")
    r_h = run(jnp.asarray(masked), jnp.asarray(closed), jnp.asarray(diskb),
              stats="hist")
    assert np.array_equal(np.asarray(r_s.needle_region),
                          np.asarray(r_h.needle_region))
    assert np.array_equal(np.asarray(r_s.has_any), np.asarray(r_h.has_any))


def test_rescue_caps_converge_on_adversarial_noise():
    """Dense noise (seed 0, p=0.35, window 0) defeats the corpus-tuned
    caps: the default run must FLAG it (not silently mislabel);
    RESCUE_CAPS must converge and match the cv2 oracle."""
    cv2 = pytest.importorskip("cv2")
    W = 64
    yy, xx = np.mgrid[:W, :W]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 <= 23 ** 2
    rng = np.random.default_rng(0)
    closed = (rng.random((8, W, W)) < 0.35)[0]
    masked = closed & disk

    run = jax.jit(comp_ops.analyze_batch,
                  static_argnames=("stats", "caps"))
    r_def = run(jnp.asarray(masked[None]), jnp.asarray(closed[None]),
                jnp.asarray(disk[None]))
    assert not bool(r_def.converged[0])  # honest flag, not silence

    r_resc = run(jnp.asarray(masked[None]), jnp.asarray(closed[None]),
                 jnp.asarray(disk[None]),
                 caps=comp_ops.RESCUE_CAPS)
    assert bool(r_resc.converged[0])
    expected = _cv2_needle_region(masked, closed)
    assert np.array_equal(np.asarray(r_resc.needle_region[0]), expected)


def test_decoder_rescue_path_end_to_end():
    """With the default caps sabotaged to 1 pass, decode_numpy must
    detect the non-convergence and transparently re-decode through the
    rescue graph, matching an unsabotaged decode exactly."""
    import tempfile
    from unittest import mock
    from meterelf_jax import synthetic
    from meterelf_jax.pipeline.decode import MeterDecoder

    params = synthetic.make_params(tempfile.mkdtemp())
    crops = synthetic.render_crops(
        [[1.0, 3.5, 7.2, 9.9], [0.0, 2.5, 5.0, 7.5]])

    good = MeterDecoder(params).decode_numpy(crops)
    assert bool(good.converged.all())

    with mock.patch.object(comp_ops, "K_LABEL_HYBRID", 1), \
            mock.patch.object(comp_ops, "K_OUTSIDE_HYBRID", 1), \
            mock.patch.object(comp_ops, "K_FILL", 1):
        weak = MeterDecoder(params)
        res = weak.decode_numpy(crops)
    assert bool(res.converged.all())
    assert np.array_equal(res.value, good.value)
    assert np.array_equal(res.err, good.err)
    assert np.array_equal(res.dial_pos, good.dial_pos)


def _angle_turns(x, y):
    """The reference's angle convention: turns in [0, 1), 0 = up,
    clockwise (meterelf/_utils.py:18-42)."""
    return (math.atan2(x, -y) / (2 * math.pi)) % 1.0


def _region_oracle(masked, closed, disk):
    """Needle region per the reference (RETR_EXTERNAL contours, largest
    contourArea, drawContours fill, else the closed mask) with scipy
    labels and hole filling; the area is Q4 + Q3/2 over the filled
    component's 2x2 cells."""
    from scipy import ndimage

    W = masked.shape[0]
    lab8, n = ndimage.label(masked, structure=np.ones((3, 3)))
    bg = ~masked
    lab4, _ = ndimage.label(bg)
    outside = bg & np.isin(lab4, np.unique(lab4[bg & ~disk]))
    touch = ndimage.binary_dilation(outside, structure=np.ones((3, 3)))
    flat = np.arange(W * W).reshape(W, W)
    best = None
    for c in range(1, n + 1):
        comp = lab8 == c
        if not (comp & touch).any():
            continue                          # nested: not RETR_EXTERNAL
        filled = ndimage.binary_fill_holes(comp)
        assert not (filled & masked & ~comp).any(), "nested components"
        corners = (filled[:-1, :-1].astype(int) + filled[:-1, 1:]
                   + filled[1:, :-1] + filled[1:, 1:])
        area2 = 2 * int((corners == 4).sum()) + int((corners == 3).sum())
        key = (area2, int(flat[comp].min()))
        if best is None or key > best[0]:
            best = (key, filled)
    if best is not None and best[0][0] > 200:
        return best[1]
    return closed


def _reading_oracle(region, d, pa, center):
    """Dial position per the reference's momentum / tip / trimmed
    weighted-mean rules, on the dial's window geometry."""
    ox, oy = (int(v) for v in pa.win_origin[d])
    cx, cy = center
    ys, xs = np.nonzero(region & pa.mask_full[d])
    x = xs + ox - cx
    y = ys + oy - cy
    sign = int(pa.neg_sign[d])
    mx = sign * float(np.sum(np.sign(x) * x ** 2))
    my = sign * float(np.sum(np.sign(y) * y ** 2))
    m_ang = _angle_turns(mx, my)
    tips = []
    for ty, tx in zip(*np.nonzero(region & pa.mask_circle[d])):
        px, py = tx + ox - cx, ty + oy - cy
        a = _angle_turns(px, py)
        dist = abs(a - m_ang) % 1.0
        if min(dist, 1.0 - dist) < 0.25 and (mx, my) != (0.0, 0.0):
            tips.append((a, px * px + py * py))
    if not tips:
        return False, None
    lo = min(a for a, _ in tips)
    tips = sorted((a - 1.0 if a - lo >= 0.75 else a, s) for a, s in tips)
    n = len(tips)
    cut = min(2, (n - 3) // 2) if n >= 5 else 0
    kept = tips[cut:n - cut]
    angle = sum(a * s for a, s in kept) / sum(s for _, s in kept)
    return True, (10.0 * (angle - float(pa.zero_turn[d]))) % 10.0


@pytest.mark.parametrize("speckle", [0.0, 0.01, 0.03])
def test_window_stats_angle_chain_matches_numpy(speckle, fixture_camera):
    """Component stats -> needle region -> dial reading (analyze_batch +
    angles.read_dial, the decode graph's chain) against a numpy/scipy
    port of the reference's rules, on needle-like masks drawn in each
    dial's window of a committed synthetic camera."""
    from meterelf_jax.ops import angles as angles_ops

    _name, _d, params = fixture_camera
    pa = params.arrays()
    pa_centers = [params.dial_centers[n].center for n in params.dial_names]
    rng = np.random.default_rng(int(speckle * 1000) + 7)
    W = pa.mask_full.shape[-1]
    yy, xx = np.mgrid[:W, :W]
    D = len(params.dial_names)
    closed = np.zeros((3 * D, W, W), bool)
    for k in range(3 * D):
        d = k % D
        ox, oy = (int(v) for v in pa.win_origin[d])
        cx, cy = pa_centers[d][0] - ox, pa_centers[d][1] - oy
        theta = rng.uniform(0, 2 * np.pi)
        reach = rng.uniform(6, 24)
        for t in np.linspace(0, reach, 40):
            px, py = cx + t * np.sin(theta), cy - t * np.cos(theta)
            closed[k] |= (yy - py) ** 2 + (xx - px) ** 2 <= 4.0
        closed[k] |= rng.random((W, W)) < speckle
    disk = np.stack([pa.mask_full[k % D] for k in range(3 * D)])
    masked = closed & disk
    comp = jax.jit(comp_ops.analyze_batch)(
        jnp.asarray(masked), jnp.asarray(closed), jnp.asarray(disk))
    region = np.asarray(comp.needle_region)
    for k in range(3 * D):
        d = k % D
        np.testing.assert_array_equal(
            region[k], _region_oracle(masked[k], closed[k], disk[k]),
            err_msg=f"region {k}")
        got = jax.jit(angles_ops.read_dial)(
            jnp.asarray(region[k].reshape(-1)),
            pa.disk_idx[d], pa.disk_valid[d],
            pa.disk_sx2[d], pa.disk_sy2[d],
            pa.ann_idx[d], pa.ann_valid[d], pa.ann_x[d], pa.ann_y[d],
            pa.ann_angle[d], pa.ann_sqd[d], pa.neg_sign[d],
            pa.zero_turn[d])
        readable, pos = _reading_oracle(region[k], d, pa, pa_centers[d])
        assert bool(got.readable) == readable, k
        if readable:
            assert abs(float(got.position) - pos) < 1e-9, k
